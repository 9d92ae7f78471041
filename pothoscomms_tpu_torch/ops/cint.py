"""Complex-integer arithmetic (the port of the JAX package's ``ops/cint.py``).

The reference supports complex integer streams via ``std::complex<intN>``
(e.g. math/Arithmetic.cpp:272-281's complex factory entries, fft's
complex<int16>). torch has no complex-int dtype, so these streams are
integer tensors with a trailing (re, im) axis of size 2, and complex
arithmetic is written out with C++-style modular wraparound (torch's
integer products and sums wrap, and its narrowing casts truncate).
Integer streams stay on the host.
"""

from __future__ import annotations

import numpy as np
import torch


def re(x):
    return x[..., 0]


def im(x):
    return x[..., 1]


def make(r, i):
    return torch.stack([r, i], dim=-1)


def add(a, b):
    return a + b


def sub(a, b):
    return a - b


def _promote(x):
    """C integer promotion: sub-int widths compute in 32-bit int; int32/
    int64 arithmetic stays in-type (wrapping per op), exactly as C++
    evaluates std::complex<_Tp> member expressions."""
    if x.element_size() < 4:
        return x.to(torch.int32)
    return x


def mul(a, b):
    """std::complex<int> multiply: products evaluated in the promoted type,
    narrowed once on assignment (libstdc++ operator*= shape)."""
    out_dt = a.dtype
    ar, ai = _promote(re(a)), _promote(im(a))
    br, bi = _promote(re(b)), _promote(im(b))
    return make((ar * br - ai * bi).to(out_dt), (ar * bi + ai * br).to(out_dt))


def _idiv(a, b):
    """C-style truncating integer division (torch's ``//`` floors),
    guarded against /0 (UB in the reference; tests avoid it)."""
    b_safe = torch.where(b == 0, torch.ones_like(b), b)
    return torch.div(a, b_safe, rounding_mode="trunc")


def div(a, b):
    """std::complex<int> division (libstdc++ operator/= shape): numerators
    in the promoted type; norm(z) narrowed to the element type before the
    truncating division; quotient narrowed on assignment."""
    out_dt = a.dtype
    ar, ai = _promote(re(a)), _promote(im(a))
    br, bi = _promote(re(b)), _promote(im(b))
    n = (br * br + bi * bi).to(out_dt)  # __n = std::norm(__z) in _Tp
    n_p = _promote(n)
    return make(_idiv(ar * br + ai * bi, n_p).to(out_dt),
                _idiv(ai * br - ar * bi, n_p).to(out_dt))


def conj(x):
    return make(re(x), -im(x))


def abs_int(x, out_np_dtype):
    """Fixed-point complex magnitude: sqrt(float(re^2+im^2)) cast to int
    (reference: functions/FxptHelpers.hpp:42-49 getAbs)."""
    r = re(x)
    i = im(x)
    mag2 = (r * r + i * i).to(torch.float32)
    out = torch.from_numpy(np.zeros(0, out_np_dtype)).dtype
    return torch.sqrt(mag2).to(out)
