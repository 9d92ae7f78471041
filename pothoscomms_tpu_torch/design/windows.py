"""Window functions (reference: window/WindowDesigner.cpp options list and
filter/FIRDesigner.cpp:56-75 — rectangular, hann, hamming, blackman,
bartlett, flattop, kaiser(beta), chebyshev(attenuation dB)).

All windows are symmetric (filter-design convention).
"""

from __future__ import annotations

import numpy as np


def _cosine_sum(n: int, coeffs) -> np.ndarray:
    if n == 1:
        return np.ones(1)
    k = np.arange(n)
    w = np.zeros(n)
    for i, a in enumerate(coeffs):
        w += ((-1) ** i) * a * np.cos(2 * np.pi * i * k / (n - 1))
    return w


def rectangular(n: int) -> np.ndarray:
    return np.ones(n)


def hann(n: int) -> np.ndarray:
    return _cosine_sum(n, [0.5, 0.5])


def hamming(n: int) -> np.ndarray:
    return _cosine_sum(n, [0.54, 0.46])


def blackman(n: int) -> np.ndarray:
    return _cosine_sum(n, [0.42, 0.5, 0.08])


def bartlett(n: int) -> np.ndarray:
    if n == 1:
        return np.ones(1)
    k = np.arange(n)
    return 1.0 - np.abs(2.0 * k / (n - 1) - 1.0)


def flattop(n: int) -> np.ndarray:
    # 5-term flattop (ISO 18431-2 coefficients, peak-normalized)
    w = _cosine_sum(
        n, [0.21557895, 0.41663158, 0.277263158, 0.083578947, 0.006947368]
    )
    return w


def kaiser(n: int, beta: float) -> np.ndarray:
    return np.kaiser(n, beta)


def chebyshev(n: int, atten_db: float = 100.0) -> np.ndarray:
    """Dolph-Chebyshev window with given sidelobe attenuation in dB."""
    if n == 1:
        return np.ones(1)
    if atten_db <= 0:
        atten_db = 100.0
    r = 10.0 ** (atten_db / 20.0)
    order = n - 1
    beta = np.cosh(np.arccosh(r) / order)
    # sample the Chebyshev polynomial response on the unit circle
    k = np.arange(n)
    x = beta * np.cos(np.pi * k / n)
    # T_order(x) with stable evaluation for |x| inside/outside [-1, 1]
    p = np.where(
        np.abs(x) <= 1.0,
        np.cos(order * np.arccos(np.clip(x, -1.0, 1.0))),
        np.cosh(order * np.arccosh(np.maximum(np.abs(x), 1.0)))
        * np.where(x < 0, (-1.0) ** (order % 2), 1.0),
    )
    if n % 2:
        w = np.real(np.fft.fft(p))
        m = (n + 1) // 2
        w = w[:m]
        w = np.concatenate([w[m - 1:0:-1], w])
    else:
        p = p * np.exp(1j * np.pi * k / n)
        w = np.real(np.fft.fft(p))
        m = n // 2 + 1
        w = np.concatenate([w[m - 1:0:-1], w[1:m]])
    return w / w.max()


_WINDOWS = {
    "rectangular": lambda n, a: rectangular(n),
    "hann": lambda n, a: hann(n),
    "hamming": lambda n, a: hamming(n),
    "blackman": lambda n, a: blackman(n),
    "bartlett": lambda n, a: bartlett(n),
    "flattop": lambda n, a: flattop(n),
    "kaiser": lambda n, a: kaiser(n, a if a else 6.0),
    "chebyshev": lambda n, a: chebyshev(n, a if a else 100.0),
}


def design_window(name: str, num_taps: int, arg: float = 0.0) -> np.ndarray:
    """Window taps by name (reference: spuce::design_window used at
    filter/FIRDesigner.cpp:467, window/WindowDesigner.cpp:121-132)."""
    key = name.lower()
    if key not in _WINDOWS:
        raise ValueError(f"unknown window type {name!r}")
    if num_taps < 1:
        raise ValueError("window length must be positive")
    return _WINDOWS[key](int(num_taps), float(arg))
