"""FIR prototype design + band transforms.

Replaces ``spuce::design_fir`` / ``design_complex_fir`` as used by the
reference FIR designer (filter/FIRDesigner.cpp:449-453). Filter types:
SINC (windowed-sinc ideal response), MAXFLAT (Herrmann maximally-flat),
GAUSSIAN, REMEZ (Parks-McClellan, design/remez.py), RAISED_COSINE,
ROOT_RAISED_COSINE. Band types: LOW_PASS, HIGH_PASS, BAND_PASS, BAND_STOP,
COMPLEX_BAND_PASS, COMPLEX_BAND_STOP.

All frequencies are normalized to the sample rate (cycles/sample,
Nyquist = 0.5). The verification contract is the reference's
frequency-domain test (filter/TestFIRDesigner.cpp:191-230): pass-band
midpoints above -30 dB, stop-band midpoints below -80 dB.
"""

from __future__ import annotations

import numpy as np

from pothoscomms_tpu_torch.design.remez import remez


def _centered_time(num_taps: int) -> np.ndarray:
    return np.arange(num_taps) - (num_taps - 1) / 2.0


def _sinc_lowpass(num_taps: int, cutoff: float) -> np.ndarray:
    """Ideal lowpass impulse response, unit DC gain before windowing."""
    t = _centered_time(num_taps)
    return 2.0 * cutoff * np.sinc(2.0 * cutoff * t)


def _maxflat_lowpass(num_taps: int, cutoff: float) -> np.ndarray:
    """Herrmann maximally-flat symmetric FIR lowpass.

    H(w) = (cos^2 w/2)^p * sum_{k<q} C(p-1+k, k) (sin^2 w/2)^k — p flatness
    constraints at Nyquist, q at DC; the half-amplitude point sits near
    sin^2(w0/2) = q/(p+q). Taps recovered exactly by sampling H on a DFT
    grid (H is a cosine polynomial of degree < num_taps/2).
    """
    if num_taps % 2 == 0:
        num_taps -= 1  # maxflat prototype is odd-length symmetric
    total = (num_taps - 1) // 2  # p + q - 1 <= total
    # choose the DC/Nyquist split so the transition lands on the cutoff
    s2 = np.sin(np.pi * cutoff) ** 2
    q = int(np.clip(round((total + 1) * s2), 1, total))
    p = total + 1 - q
    n_fft = 2 * num_taps  # oversampled grid, exact for this degree
    w = 2 * np.pi * np.arange(n_fft) / n_fft
    c2, s2w = np.cos(w / 2.0) ** 2, np.sin(w / 2.0) ** 2
    acc = np.zeros(n_fft)
    coeff = 1.0
    for k in range(q):
        if k > 0:
            coeff *= (p - 1 + k) / k
        acc += coeff * s2w ** k
    H = (c2 ** p) * acc
    h_full = np.real(np.fft.ifft(H))
    # H is zero-phase: impulse response is symmetric about 0; re-center
    m = (num_taps - 1) // 2
    h = np.concatenate([h_full[-m:], h_full[: m + 1]])
    return h


def _gaussian_lowpass(num_taps: int, cutoff: float) -> np.ndarray:
    """Gaussian pulse with -3 dB point at the cutoff frequency."""
    # |H(f)| = exp(-(pi f sigma_t)^2 ...): choose sigma so |H(fc)|^2 = 1/2
    t = _centered_time(num_taps)
    sigma = np.sqrt(np.log(2.0) / 2.0) / (2.0 * np.pi * max(cutoff, 1e-12))
    h = np.exp(-0.5 * (t / sigma) ** 2)
    return h / h.sum()


def _raised_cosine(num_taps: int, cutoff: float, alpha: float) -> np.ndarray:
    """Raised-cosine pulse; symbol rate = 2*cutoff (unit DC gain)."""
    alpha = min(max(alpha, 1e-6), 1.0)
    T = 1.0 / (2.0 * max(cutoff, 1e-12))  # symbol period in samples
    t = _centered_time(num_taps)
    x = t / T
    denom = 1.0 - (2.0 * alpha * x) ** 2
    h = np.where(
        np.abs(denom) < 1e-9,
        (np.pi / 4.0) * np.sinc(1.0 / (2.0 * alpha)),
        np.sinc(x) * np.cos(np.pi * alpha * x) / np.where(
            np.abs(denom) < 1e-9, 1.0, denom
        ),
    )
    return h / h.sum()


def _root_raised_cosine(num_taps: int, cutoff: float, alpha: float) -> np.ndarray:
    """Root-raised-cosine pulse; symbol rate = 2*cutoff (unit DC gain)."""
    alpha = min(max(alpha, 1e-6), 1.0)
    T = 1.0 / (2.0 * max(cutoff, 1e-12))
    t = _centered_time(num_taps)
    h = np.empty(num_taps)
    for i, ti in enumerate(t):
        x = ti / T
        if abs(ti) < 1e-9:
            h[i] = 1.0 - alpha + 4.0 * alpha / np.pi
        elif abs(abs(x) - 1.0 / (4.0 * alpha)) < 1e-9:
            h[i] = (alpha / np.sqrt(2.0)) * (
                (1.0 + 2.0 / np.pi) * np.sin(np.pi / (4.0 * alpha))
                + (1.0 - 2.0 / np.pi) * np.cos(np.pi / (4.0 * alpha))
            )
        else:
            num = np.sin(np.pi * x * (1.0 - alpha)) + 4.0 * alpha * x * np.cos(
                np.pi * x * (1.0 + alpha)
            )
            den = np.pi * x * (1.0 - (4.0 * alpha * x) ** 2)
            h[i] = num / den
    return h / h.sum()


def _lowpass_prototype(filt_type: str, num_taps: int, cutoff: float,
                       alpha: float, weight: float) -> np.ndarray:
    ft = filt_type.lower()
    if ft == "sinc":
        return _sinc_lowpass(num_taps, cutoff)
    if ft == "maxflat":
        h = _maxflat_lowpass(num_taps, cutoff)
        if len(h) < num_taps:  # even request: pad to length with zero
            h = np.append(h, 0.0)
        return h
    if ft == "gaussian":
        return _gaussian_lowpass(num_taps, cutoff)
    if ft == "raised_cosine":
        return _raised_cosine(num_taps, cutoff, alpha)
    if ft == "root_raised_cosine":
        return _root_raised_cosine(num_taps, cutoff, alpha)
    if ft == "remez":
        # alpha carries the normalized transition bandwidth
        # (filter/FIRDesigner.cpp:424), weight the pass/stop error ratio
        trans = max(alpha, 1e-4)
        stop_edge = min(cutoff + trans, 0.4999)
        return remez(
            num_taps,
            bands=[(0.0, cutoff), (stop_edge, 0.5)],
            desired=[1.0, 0.0],
            weights=[1.0, weight],
        )
    raise ValueError(f"unknown filter type {filt_type!r}")


def _spectral_invert(h: np.ndarray) -> np.ndarray:
    """delta - h: flips pass/stop (requires odd symmetric, unit DC design)."""
    out = -h
    out[(len(h) - 1) // 2] += 1.0
    return out


def design_fir(filt_type: str, band_type: str, num_taps: int,
               freq_lower: float, freq_upper: float = 0.0,
               alpha: float = 0.5, weight: float = 1.0) -> np.ndarray:
    """Real-tap FIR design (reference call: filter/FIRDesigner.cpp:452).

    Frequencies normalized to the sample rate.
    """
    bt = band_type.upper()
    t = _centered_time(num_taps)
    if bt == "LOW_PASS":
        return _lowpass_prototype(filt_type, num_taps, freq_lower, alpha, weight)
    if bt == "HIGH_PASS":
        # spectral inversion of the complementary lowpass
        lp = _lowpass_prototype(filt_type, num_taps, freq_lower, alpha, weight)
        return _spectral_invert(lp)
    if bt == "BAND_PASS":
        half_bw = (freq_upper - freq_lower) / 2.0
        center = (freq_upper + freq_lower) / 2.0
        lp = _lowpass_prototype(filt_type, num_taps, half_bw, alpha, weight)
        return 2.0 * lp * np.cos(2.0 * np.pi * center * t)
    if bt == "BAND_STOP":
        return _spectral_invert(
            design_fir(filt_type, "BAND_PASS", num_taps, freq_lower,
                       freq_upper, alpha, weight)
        )
    raise ValueError(f"unknown band type {band_type!r}")


def design_complex_fir(filt_type: str, band_type: str, num_taps: int,
                       freq_lower: float, freq_upper: float,
                       alpha: float = 0.5, weight: float = 1.0) -> np.ndarray:
    """Complex-tap FIR design (reference call: filter/FIRDesigner.cpp:450).

    The pass (or stop) band spans [freq_lower, freq_upper], which may be
    asymmetric around DC (freq_lower may be negative).
    """
    bt = band_type.upper()
    t = _centered_time(num_taps)
    half_bw = (freq_upper - freq_lower) / 2.0
    center = (freq_upper + freq_lower) / 2.0
    lp = _lowpass_prototype(filt_type, num_taps, half_bw, alpha, weight)
    bp = lp * np.exp(2j * np.pi * center * t)
    if bt == "COMPLEX_BAND_PASS":
        return bp
    if bt == "COMPLEX_BAND_STOP":
        out = -bp
        out[(num_taps - 1) // 2] += 1.0
        return out
    raise ValueError(f"unknown band type {band_type!r}")
