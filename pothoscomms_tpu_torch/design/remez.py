"""Parks-McClellan (Remez exchange) equiripple FIR design + order estimates.

Replaces spuce's remez_fir / remez_estimate_* used by the reference
(filter/FIRDesigner.cpp:420-439). Implemented from the standard algorithm
(Parks & McClellan 1972; Herrmann/Rabiner/Chan order estimate): dense-grid
Chebyshev approximation with barycentric Lagrange interpolation and
alternation-set exchange.

Frequencies normalized to the sample rate (Nyquist = 0.5).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def _build_grid(bands, desired, weights, num_coeffs, grid_density=16):
    grid, des, wts = [], [], []
    total_width = sum(b[1] - b[0] for b in bands)
    n_points = max(num_coeffs * grid_density, 64)
    for (lo, hi), d, w in zip(bands, desired, weights):
        n = max(int(round(n_points * (hi - lo) / total_width)), 8)
        f = np.linspace(lo, hi, n)
        grid.append(f)
        des.append(np.full(n, float(d)))
        wts.append(np.full(n, float(w)))
    return np.concatenate(grid), np.concatenate(des), np.concatenate(wts)


def _remez_exchange(grid, des, wts, r, max_iter=40, tol=1e-7):
    """Find the degree-(r-1) cosine polynomial minimizing the weighted
    Chebyshev error on the grid. Returns A(f) samples on the grid and the
    final extremal indices."""
    n_grid = len(grid)
    # initial extremal guess: evenly spaced grid indices
    ext = np.linspace(0, n_grid - 1, r + 1).round().astype(int)
    x_grid = np.cos(2 * np.pi * grid)

    last_delta = None
    for _ in range(max_iter):
        xe = x_grid[ext]
        de = des[ext]
        we = wts[ext]
        # barycentric weights over the r+1 extremal points
        diff = xe[:, None] - xe[None, :]
        np.fill_diagonal(diff, 1.0)
        # scale to avoid overflow: product of many small terms
        a = 1.0 / np.prod(np.sign(diff), axis=1) / np.exp(
            np.sum(np.log(np.abs(diff)), axis=1)
        )
        signs = (-1.0) ** np.arange(r + 1)
        delta = np.dot(a, de) / np.dot(a, signs / we)

        # interpolate A through first r extremal points with target values
        c = de[:r] - signs[:r] * delta / we[:r]
        xk = xe[:r]
        bw = a[:r] * (xe[:r] - xe[r])  # barycentric weights for r-pt subset

        # evaluate A on the whole grid (barycentric form)
        dx = x_grid[:, None] - xk[None, :]
        exact = np.abs(dx) < 1e-14
        dx = np.where(exact, 1.0, dx)
        terms = bw[None, :] / dx
        A = (terms @ c) / terms.sum(axis=1)
        # patch exact hits
        hit_rows, hit_cols = np.nonzero(exact)
        A[hit_rows] = c[hit_cols]

        err = wts * (A - des)

        # find new extremal set: local extrema of err with alternating signs
        ext_new = _find_extrema(err, r + 1)
        if ext_new is None:
            break
        if last_delta is not None and abs(abs(delta) - last_delta) <= tol * abs(delta):
            ext = ext_new
            break
        last_delta = abs(delta)
        ext = ext_new

    return A, ext


def _find_extrema(err, n_needed):
    """Alternation set selection: local extrema of the error, pruned to the
    n_needed largest while preserving sign alternation."""
    n = len(err)
    # candidate local extrema (including endpoints)
    cand = [0]
    for i in range(1, n - 1):
        if (err[i] - err[i - 1]) * (err[i + 1] - err[i]) <= 0:
            cand.append(i)
    cand.append(n - 1)
    # collapse runs of same-sign candidates to the largest |err|
    sel: List[int] = []
    for i in cand:
        if sel and np.sign(err[i]) == np.sign(err[sel[-1]]):
            if abs(err[i]) > abs(err[sel[-1]]):
                sel[-1] = i
        else:
            sel.append(i)
    if len(sel) < n_needed:
        return None
    # drop smallest extrema until the count matches, keeping alternation
    while len(sel) > n_needed:
        if len(sel) - n_needed == 1:
            # drop the smaller endpoint extremum
            if abs(err[sel[0]]) < abs(err[sel[-1]]):
                sel.pop(0)
            else:
                sel.pop()
        else:
            mags = [abs(err[i]) for i in sel]
            k = int(np.argmin(mags))
            sel.pop(k)
            # re-merge neighbors that now share a sign
            merged: List[int] = []
            for i in sel:
                if merged and np.sign(err[i]) == np.sign(err[merged[-1]]):
                    if abs(err[i]) > abs(err[merged[-1]]):
                        merged[-1] = i
                else:
                    merged.append(i)
            sel = merged
            if len(sel) < n_needed:
                return None
    return np.asarray(sel, dtype=int)


def remez(num_taps: int, bands: Sequence[Tuple[float, float]],
          desired: Sequence[float], weights: Sequence[float] | None = None,
          grid_density: int = 16) -> np.ndarray:
    """Equiripple linear-phase FIR (type I/II symmetric).

    bands: list of (lo, hi) normalized frequency pairs; desired: one target
    amplitude per band; weights: one error weight per band.
    """
    if weights is None:
        weights = [1.0] * len(bands)
    odd = num_taps % 2 == 1
    r = (num_taps + 1) // 2 if odd else num_taps // 2

    grid, des, wts = _build_grid(bands, desired, weights, r, grid_density)
    if not odd:
        # type-II transform: A(f) = cos(pi f) P(f)
        cosf = np.cos(np.pi * grid)
        keep = np.abs(cosf) > 1e-9
        grid, des, wts, cosf = grid[keep], des[keep], wts[keep], cosf[keep]
        des = des / cosf
        wts = wts * np.abs(cosf)

    A, _ = _remez_exchange(grid, des, wts, r)

    if not odd:
        A = A * cosf

    # recover taps: sample A(f) on a uniform DFT grid via interpolation,
    # then inverse-DFT the (linear-phase) response
    n_fft = 1
    while n_fft < 16 * num_taps:
        n_fft *= 2
    f_uniform = np.arange(n_fft // 2 + 1) / n_fft
    A_uniform = np.interp(f_uniform, grid, A)
    if not odd:
        # enforce the forced zero at Nyquist for type II
        A_uniform[-1] = 0.0
    # zero-phase spectrum -> symmetric impulse response
    full = np.concatenate([A_uniform, A_uniform[-2:0:-1]])
    h_zero_phase = np.real(np.fft.ifft(full))
    if odd:
        m = (num_taps - 1) // 2
        h = np.concatenate([h_zero_phase[-m:], h_zero_phase[: m + 1]])
    else:
        # half-sample delay: interpolate via frequency-domain phase shift
        k = np.fft.fftfreq(n_fft) * n_fft
        phase = np.exp(-2j * np.pi * k * 0.5 / n_fft * 1.0)
        # simpler: shift by half sample using the DFT of the zero-phase resp
        spec = np.fft.fft(h_zero_phase) * np.exp(
            -1j * np.pi * np.fft.fftfreq(n_fft) )
        h_shift = np.real(np.fft.ifft(spec))
        m = num_taps // 2
        h = np.concatenate([h_shift[-m:], h_shift[:m]])
    return h


# ---------------------------------------------------------------------- #
# Order estimates (Herrmann/Rabiner/Chan approximation — the formulas
# behind spuce's remez_estimate_* used at filter/FIRDesigner.cpp:426-438)
# ---------------------------------------------------------------------- #
def _ripples(pass_db: float, stop_db: float) -> Tuple[float, float]:
    dp = (10.0 ** (pass_db / 20.0) - 1.0) / (10.0 ** (pass_db / 20.0) + 1.0)
    ds = 10.0 ** (-stop_db / 20.0)
    return dp, ds


def _herrmann_d(dp: float, ds: float) -> Tuple[float, float]:
    a1, a2, a3 = 5.309e-3, 7.114e-2, -4.761e-1
    a4, a5, a6 = -2.66e-3, -5.941e-1, -4.278e-1
    b1, b2 = 11.01217, 0.51244
    lp, ls = np.log10(dp), np.log10(ds)
    d_inf = (a1 * lp * lp + a2 * lp + a3) * ls + (a4 * lp * lp + a5 * lp + a6)
    f = b1 + b2 * (lp - ls)
    return d_inf, f


def remez_estimate_num_taps(trans_bw: float, pass_db: float,
                            stop_db: float) -> int:
    """Estimated taps to meet the spec (normalized transition bandwidth)."""
    dp, ds = _ripples(pass_db, stop_db)
    d_inf, f = _herrmann_d(dp, ds)
    n = d_inf / trans_bw - f * trans_bw + 1.0
    return max(int(np.ceil(n)), 3)


def remez_estimate_atten(num_taps: int, trans_bw: float,
                         pass_db: float) -> float:
    """Max stopband attenuation (dB) achievable at this order (bisection)."""
    lo, hi = 1.0, 200.0
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        if remez_estimate_num_taps(trans_bw, pass_db, mid) <= num_taps:
            lo = mid
        else:
            hi = mid
    return lo


def remez_estimate_bw(num_taps: int, pass_db: float, stop_db: float) -> float:
    """Min normalized transition bandwidth achievable at this order."""
    lo, hi = 1e-6, 0.5
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        if remez_estimate_num_taps(mid, pass_db, stop_db) <= num_taps:
            hi = mid
        else:
            lo = mid
    return hi


def remez_estimate_weight(pass_db: float, stop_db: float) -> float:
    """Stopband/passband error weight ratio (dp/ds)."""
    dp, ds = _ripples(pass_db, stop_db)
    return dp / ds
