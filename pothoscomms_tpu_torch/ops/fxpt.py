"""Fixed-point helper kernels (the port of the JAX package's ``ops/fxpt.py``).

Re-implementations (math-level, vectorized) of the reference's fixed-point
helpers:

- ``fxpt_atan2``: Q15 four-quadrant arctangent returning uint16
  fraction-of-turn units (reference: functions/fxpt_atan2.cpp:108-138 —
  octant decomposition with a linear polynomial correction, unbiased-rounding
  Q15 multiplies, truncating Q15 division). Bit-exact with the reference for
  all int16 inputs.
- ``q_rsqrt_f32``: the float32 fast inverse square root variant used by the
  rsqrt block (reference: math/RSqrt.hpp:13-26, constants 0x5F1FFFF9,
  0.703952253, 2.38924456 from rrrola's optimized Quake rsqrt).

torch has no ``&``, ``+`` or ``>>`` on uint16/uint32, so the int16 and
uint16 values of the reference are carried in int32 (and the uint32
bit patterns of ``q_rsqrt_f32`` in int64), masked, and cast once at the
end. Division truncates toward zero, as C does (``torch.div(...,
rounding_mode="trunc")``; torch's ``//`` floors).
"""

from __future__ import annotations

import numpy as np
import torch

# q15_from_double(0.273 * M_1_PI) and q15_from_double(0.25 + 0.273 * M_1_PI)
# (reference: functions/fxpt_atan2.cpp:121-122, lround semantics :36-38)
_C_CORR = 2847
_C_BASE = 11039


def _i16(v):
    """Wrap int32 values to int16 (C narrowing), kept in int32."""
    return v.to(torch.int16).to(torch.int32)


def _as_i16(v):
    """int16 values of a tensor or array (wrapping), kept in int32."""
    t = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
    return _i16(t.to(torch.int32))


def _nabs16(j):
    """Negative absolute value of int16 values (defined for INT16_MIN)."""
    return torch.where(j < 0, j, -j)


def _q15_mul(j32, k16):
    """Q15 multiply with unbiased rounding (fxpt_atan2.cpp:68-77)."""
    inter = j32 * k16
    round_add = torch.where((inter & 0x7FFF) == 0x4000, 0, 0x4000)
    return _i16((inter + round_add) >> 15)


def _q15_div(numer16, denom16):
    """Q15 truncating division (fxpt_atan2.cpp:88-90)."""
    d_safe = torch.where(denom16 == 0, 1, denom16)  # inactive-branch guard
    return _i16(torch.div(numer16 << 15, d_safe, rounding_mode="trunc"))


def fxpt_atan2(y, x):
    """Vectorized Q15 atan2: int16 (y, x) -> uint16 fraction-of-turn."""
    y = _as_i16(y)
    x = _as_i16(x)

    nabs_y = _nabs16(y)
    nabs_x = _nabs16(x)

    # octants 1, 4, 5, 8: |x| > |y|
    y_over_x = _q15_div(y, x)
    corr1 = _q15_mul(_C_CORR, _nabs16(y_over_x))
    unrot1 = _q15_mul(_i16(_C_BASE + corr1), y_over_x)
    branch1 = torch.where(x > 0, unrot1 & 0xFFFF, (32768 + unrot1) & 0xFFFF)

    # octants 2, 3, 6, 7: |y| >= |x|
    x_over_y = _q15_div(x, y)
    corr2 = _q15_mul(_C_CORR, _nabs16(x_over_y))
    unrot2 = _q15_mul(_i16(_C_BASE + corr2), x_over_y)
    branch2 = torch.where(y > 0, (16384 - unrot2) & 0xFFFF,
                          (49152 - unrot2) & 0xFFFF)

    result = torch.where(nabs_x < nabs_y, branch1, branch2)

    # x == y special cases (fxpt_atan2.cpp:109-117)
    special = torch.where(y > 0, 8192, torch.where(y < 0, 40960, 0))
    result = torch.where(x == y, special, result)
    return result.to(torch.uint16)


def q_rsqrt_f32(x):
    """Float32 fast inverse sqrt, bit-identical math to
    math/RSqrt.hpp:13-26."""
    x = torch.as_tensor(x, dtype=torch.float32)
    u = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF  # the uint32 bits
    u = (0x5F1FFFF9 - (u >> 1)) & 0xFFFFFFFF
    u = torch.where(u >= 1 << 31, u - (1 << 32), u)
    f2 = u.to(torch.int32).view(torch.float32)
    c1 = torch.tensor(0.703952253, dtype=torch.float32)
    c2 = torch.tensor(2.38924456, dtype=torch.float32)
    return c1 * f2 * (c2 - x * f2 * f2)
