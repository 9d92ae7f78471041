"""IIR design: butterworth / chebyshev / chebyshev2 / elliptic prototypes
with LP/HP/BP/BS transforms and bilinear mapping.

Replaces ``spuce::design_iir`` as used by the reference IIR designer
(filter/IIRDesigner.cpp:210-223). Returns (b, a) with a[0] == 1.

API mirrors the reference call: iir_type in {"butterworth", "chebyshev",
"chebyshev2", "elliptic"}; filter_type in {"LOW_PASS", "HIGH_PASS",
"BAND_PASS", "BAND_STOP"}; frequencies normalized to the sample rate
(Nyquist = 0.5). The elliptic prototype follows the Landen/Jacobi
formulation (Orfanidis, "Lecture Notes on Elliptic Filter Design").
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


# ---------------------------------------------------------------------- #
# Jacobi elliptic helpers (Landen transformations)
# ---------------------------------------------------------------------- #
def _landen(k: float, tol: float = 1e-16) -> list:
    ks = []
    while k > tol:
        k = (k / (1.0 + np.sqrt(1.0 - k * k))) ** 2
        ks.append(k)
        if len(ks) > 64:
            break
    return ks


def _ellipk(k: float) -> float:
    """Complete elliptic integral of the first kind K(k)."""
    return float(np.prod([1.0 + ki for ki in _landen(k)])) * np.pi / 2.0


def _cde(u, k: float):
    """cd(u*K(k), k) for real or complex normalized argument u."""
    ks = _landen(k)
    w = np.cos(np.asarray(u, dtype=complex) * np.pi / 2.0)
    for ki in reversed(ks):
        w = (1.0 + ki) * w / (1.0 + ki * w * w)
    return w


def _sne(u, k: float):
    """sn(u*K(k), k) via sn(u) = cd(K - u)."""
    return _cde(1.0 - np.asarray(u, dtype=complex), k)


def _acde(w, k: float):
    """Inverse cd: u with cd(u*K, k) = w (principal branch)."""
    ks = _landen(k)
    w = np.asarray(w, dtype=complex)
    kprev = k
    for ki in ks:
        w = 2.0 * w / ((1.0 + ki) * (1.0 + np.sqrt(1.0 - (kprev * w) ** 2)))
        kprev = ki
    return 2.0 / np.pi * np.arccos(w)


def _asne(w, k: float):
    return 1.0 - _acde(w, k)


def _ellipdeg(n: int, k1: float) -> float:
    """Solve the degree equation for the transition-band modulus k."""
    L = n // 2
    ui = (2.0 * np.arange(1, L + 1) - 1.0) / n
    kc = np.sqrt(1.0 - k1 * k1)  # complement of ripple modulus
    if kc == 1.0:
        return 0.0
    w = np.real(_sne(ui, kc))
    kp = kc ** n * np.prod(w) ** 4
    return float(np.sqrt(1.0 - kp * kp))


# ---------------------------------------------------------------------- #
# Analog lowpass prototypes (zeros, poles, gain) at cutoff 1 rad/s
# ---------------------------------------------------------------------- #
def _butter_ap(n: int):
    k = np.arange(1, n + 1)
    poles = np.exp(1j * np.pi * (2 * k + n - 1) / (2 * n))
    return np.array([]), poles, 1.0


def _cheby1_ap(n: int, ripple_db: float):
    eps = np.sqrt(10.0 ** (ripple_db / 10.0) - 1.0)
    mu = np.arcsinh(1.0 / eps) / n
    k = np.arange(1, n + 1)
    theta = np.pi * (2 * k - 1) / (2 * n)
    poles = -np.sinh(mu) * np.sin(theta) + 1j * np.cosh(mu) * np.cos(theta)
    gain = np.real(np.prod(-poles))
    if n % 2 == 0:
        gain /= np.sqrt(1.0 + eps * eps)
    return np.array([]), poles, float(gain)


def _cheby2_ap(n: int, atten_db: float):
    eps = 1.0 / np.sqrt(10.0 ** (atten_db / 10.0) - 1.0)
    mu = np.arcsinh(1.0 / eps) / n
    k = np.arange(1, n + 1)
    theta = np.pi * (2 * k - 1) / (2 * n)
    # poles: reciprocal of the type-1 poles
    p1 = -np.sinh(mu) * np.sin(theta) + 1j * np.cosh(mu) * np.cos(theta)
    poles = 1.0 / p1
    # zeros on the imaginary axis (skip the one at infinity for odd n)
    kz = k[np.abs(np.cos(theta)) > 1e-12] if n % 2 else k
    thz = np.pi * (2 * kz - 1) / (2 * n)
    zeros = 1j / np.cos(thz)
    gain = np.real(np.prod(-poles) / np.prod(-zeros))
    return zeros, poles, float(gain)


def _ellip_ap(n: int, ripple_db: float, atten_db: float):
    if n == 1:
        # degenerates to chebyshev1
        return _cheby1_ap(1, ripple_db)
    ep = np.sqrt(10.0 ** (ripple_db / 10.0) - 1.0)
    es = np.sqrt(10.0 ** (atten_db / 10.0) - 1.0)
    k1 = ep / es
    k = _ellipdeg(n, k1)
    L, r = n // 2, n % 2
    ui = (2.0 * np.arange(1, L + 1) - 1.0) / n
    zeta = np.real(_cde(ui, k))  # in (0, 1)
    zeros_half = 1j / (k * zeta)
    v0 = np.real(-1j * _asne(1j / ep, k1) / n)
    poles_half = 1j * _cde(ui - 1j * v0, k)
    pole_r = 1j * _sne(1j * v0, k) if r else None

    zeros = np.concatenate([zeros_half, np.conj(zeros_half)])
    poles = np.concatenate([poles_half, np.conj(poles_half)])
    if r:
        poles = np.append(poles, np.real(pole_r) + 0j)
    gain = np.real(np.prod(-poles) / np.prod(-zeros))
    if r == 0:
        gain /= np.sqrt(1.0 + ep * ep)
    return zeros, poles, float(gain)


# ---------------------------------------------------------------------- #
# s-plane band transforms + bilinear mapping (zpk form)
# ---------------------------------------------------------------------- #
def _lp2lp(z, p, k, wo):
    degree = len(p) - len(z)
    return z * wo, p * wo, k * wo ** degree


def _lp2hp(z, p, k, wo):
    degree = len(p) - len(z)
    zh = wo / z if len(z) else np.array([])
    ph = wo / p
    zh = np.append(zh, np.zeros(degree))
    k = k * np.real(np.prod(-z) / np.prod(-p)) if len(z) else k * np.real(
        1.0 / np.prod(-p)
    )
    return zh, ph, k


def _lp2bp(z, p, k, wo, bw):
    degree = len(p) - len(z)
    zl = z * bw / 2.0
    pl = p * bw / 2.0
    zb = np.concatenate([
        zl + np.sqrt(zl ** 2 - wo ** 2),
        zl - np.sqrt(zl ** 2 - wo ** 2),
    ]) if len(z) else np.array([])
    pb = np.concatenate([
        pl + np.sqrt(pl ** 2 - wo ** 2),
        pl - np.sqrt(pl ** 2 - wo ** 2),
    ])
    zb = np.append(zb, np.zeros(degree))
    return zb, pb, k * bw ** degree


def _lp2bs(z, p, k, wo, bw):
    degree = len(p) - len(z)
    zh = (bw / 2.0) / z if len(z) else np.array([])
    ph = (bw / 2.0) / p
    zb = np.concatenate([
        zh + np.sqrt(zh ** 2 - wo ** 2),
        zh - np.sqrt(zh ** 2 - wo ** 2),
    ]) if len(z) else np.array([])
    pb = np.concatenate([
        ph + np.sqrt(ph ** 2 - wo ** 2),
        ph - np.sqrt(ph ** 2 - wo ** 2),
    ])
    zb = np.append(zb, np.full(degree, 1j * wo))
    zb = np.append(zb, np.full(degree, -1j * wo))
    k = k * np.real(np.prod(-z) / np.prod(-p)) if len(z) else k * np.real(
        1.0 / np.prod(-p)
    )
    return zb, pb, k


def _bilinear(z, p, k, fs: float):
    degree = len(p) - len(z)
    fs2 = 2.0 * fs
    zd = (fs2 + z) / (fs2 - z) if len(z) else np.array([])
    pd = (fs2 + p) / (fs2 - p)
    zd = np.append(zd, -np.ones(degree))
    k = k * np.real(np.prod(fs2 - z) / np.prod(fs2 - p)) if len(z) else (
        k * np.real(1.0 / np.prod(fs2 - p))
    )
    return zd, pd, k


def _zpk2tf(z, p, k) -> Tuple[np.ndarray, np.ndarray]:
    b = np.real(np.poly(z)) * k if len(z) else np.array([k])
    a = np.real(np.poly(p))
    return b, a


_PROTOTYPES = {
    "butterworth": lambda n, rp, rs: _butter_ap(n),
    "chebyshev": lambda n, rp, rs: _cheby1_ap(n, rp),
    "chebyshev1": lambda n, rp, rs: _cheby1_ap(n, rp),
    "chebyshev2": lambda n, rp, rs: _cheby2_ap(n, rs),
    "elliptic": lambda n, rp, rs: _ellip_ap(n, rp, rs),
}


def design_iir(iir_type: str, filter_type: str, order: int,
               cutoff: float, ripple_db: float = 0.1,
               stop_atten_db: float = 60.0,
               center_freq: float = 0.25) -> Tuple[np.ndarray, np.ndarray]:
    """Digital IIR design; returns (b, a), a[0] normalized to 1.

    For LOW/HIGH_PASS ``cutoff`` is the edge; for BAND_PASS/BAND_STOP
    ``cutoff`` is the half-bandwidth and ``center_freq`` the band center
    (matching the reference call shape, filter/IIRDesigner.cpp:194-211).
    """
    key = iir_type.lower()
    if key not in _PROTOTYPES:
        raise ValueError(f"unknown IIR type {iir_type!r}")
    if order < 1:
        raise ValueError("order must be positive")
    band = filter_type.upper()
    if band not in ("LOW_PASS", "HIGH_PASS", "BAND_PASS", "BAND_STOP"):
        raise ValueError(f"unknown filter type {filter_type!r}")
    if not (0.0 < cutoff < 0.5):
        raise ValueError("cutoff must be within (0, 0.5) of sample rate")

    z, p, k = _PROTOTYPES[key](order, ripple_db, stop_atten_db)
    fs = 2.0  # bilinear sample rate (Nyquist = 1), scipy convention

    warped = 2.0 * fs * np.tan(np.pi * 2.0 * cutoff / 2.0)
    if band == "LOW_PASS":
        z, p, k = _lp2lp(z, p, k, warped)
    elif band == "HIGH_PASS":
        z, p, k = _lp2hp(z, p, k, warped)
    else:
        lo = 2.0 * (center_freq - cutoff)
        hi = 2.0 * (center_freq + cutoff)
        w1 = 2.0 * fs * np.tan(np.pi * lo / 2.0)
        w2 = 2.0 * fs * np.tan(np.pi * hi / 2.0)
        bw_w = w2 - w1
        wo = np.sqrt(w1 * w2)
        if band == "BAND_PASS":
            z, p, k = _lp2bp(z, p, k, wo, bw_w)
        else:
            z, p, k = _lp2bs(z, p, k, wo, bw_w)

    z, p, k = _bilinear(z, p, k, fs)
    b, a = _zpk2tf(z, p, k)
    b = b / a[0]
    a = a / a[0]
    return b, a
