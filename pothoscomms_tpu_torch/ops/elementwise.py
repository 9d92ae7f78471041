"""Elementwise math op tables (the port of the JAX package's
``ops/elementwise.py``).

The behavioral contract of the reference's math module: the exact op list
of math/SIMD/MathBlocks.json over the full dtype matrix, with C++ scalar
semantics (integer wraparound, truncating integer division, C-style
float→int casts). The whole SIMD dispatch layer of the reference
(math/SIMD/*, runtime CPU-feature dispatch) collapses into these tables of
torch ops, which run where their tensors lie.

Every function takes and returns tensors in *storage* representation:
complex-int dtypes are integer tensors with a trailing (re, im) axis (see
core/dtypes.py).

torch has no ``+``, ``>``, ``//`` or ``>>`` on uint16, uint32 and uint64
(only casts, ``*`` and ``==``). Those three scalar kinds, alone or complex,
take the numpy twins at the end of this module (:func:`host_numpy`,
:func:`binary_arith_np`, :func:`comparator_np`, :func:`cint_mul_np`),
which keep the same C semantics on the host: an int64 detour would wrap
add, sub and mul correctly, but not uint64 division or comparison above
2^63.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pothoscomms_tpu_torch.core.dtypes import DType
from pothoscomms_tpu_torch.ops import cint
from pothoscomms_tpu_torch.ops.fxpt import fxpt_atan2, q_rsqrt_f32


# --------------------------------------------------------------------- #
# C-semantics helpers
# --------------------------------------------------------------------- #
def c_idiv(a, b):
    """C++ integer division: truncation toward zero (torch's ``//``
    floors), guarded against division by zero (returns 0 — the
    reference's behavior is UB there; tests avoid it)."""
    b_safe = torch.where(b == 0, torch.ones_like(b), b)
    q = torch.div(a, b_safe, rounding_mode="trunc")
    return torch.where(b == 0, torch.zeros_like(q), q)


def c_cast(x, dtype: torch.dtype):
    """C-style float→int conversion: truncate toward zero. For float
    targets a plain cast."""
    if dtype.is_floating_point or dtype.is_complex:
        return x.to(dtype)
    if x.is_floating_point():
        return torch.trunc(x).to(dtype)
    return x.to(dtype)


# --------------------------------------------------------------------- #
# Binary arithmetic (reference: math/Arithmetic.cpp kernels + SIMD add/sub/
# mul/div) — N-ary chains are folds over these.
# --------------------------------------------------------------------- #
def binary_arith_fn(dtype: DType, op: str):
    dtype = DType.parse(dtype)
    op = op.upper()
    if dtype.is_complex_int:
        table = {"ADD": cint.add, "SUB": cint.sub, "MUL": cint.mul,
                 "DIV": cint.div}
        return table[op]
    if op == "ADD":
        return lambda a, b: a + b
    if op == "SUB":
        return lambda a, b: a - b
    if op == "MUL":
        return lambda a, b: a * b
    if op == "DIV":
        if dtype.is_integer:
            return c_idiv
        return lambda a, b: a / b
    raise ValueError(f"unknown arithmetic op {op}")


# --------------------------------------------------------------------- #
# Const arithmetic (reference: math/ConstArithmetic.cpp, SIMD XPlusK etc.)
# --------------------------------------------------------------------- #
_CONST_BASE = {"X_PLUS_K": "ADD", "X_MINUS_K": "SUB", "K_MINUS_X": "SUB",
               "X_MULT_K": "MUL", "X_DIV_K": "DIV", "K_DIV_X": "DIV"}
CONST_ARITH_OPS = list(_CONST_BASE)


def const_arith_fn(dtype: DType, op: str):
    base = binary_arith_fn(dtype, _CONST_BASE[op])
    if op in ("X_PLUS_K", "X_MINUS_K", "X_MULT_K", "X_DIV_K"):
        return lambda x, k: base(x, k)
    return lambda x, k: base(k, x)  # K_MINUS_X, K_DIV_X


# --------------------------------------------------------------------- #
# Comparators → char 0/1 (reference: math/Comparator.cpp:151,
# math/ConstComparator.cpp:176)
# --------------------------------------------------------------------- #
_CMP = {
    ">": torch.gt,
    "<": torch.lt,
    ">=": torch.ge,
    "<=": torch.le,
    "==": torch.eq,
    "!=": torch.ne,
}
COMPARATOR_OPS = list(_CMP)


def comparator_fn(op: str):
    cmp = _CMP[op]
    return lambda a, b: cmp(a, b).to(torch.int8)


# --------------------------------------------------------------------- #
# Unary float functions (reference: math/Trigonometric.cpp:176-385 +
# Log/Exp/Root/Gamma/ErrorFunction/Sigmoid/Sinc kernels)
# --------------------------------------------------------------------- #
def _sinc(x):
    # reference math/Sinc.cpp:36-37: |x| < 1e-6 -> 1 else sin(x)/x
    small = torch.abs(x) < 1e-6
    safe = torch.where(small, torch.ones_like(x), x)
    return torch.where(small, torch.ones_like(x), torch.sin(safe) / safe)


def _cbrt(x):
    """std::cbrt: torch has none. |x|^(1/3) with its sign, then one
    Newton step (exact cubes come back exact)."""
    y = torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)
    nz = y != 0
    y2 = torch.where(nz, y, torch.ones_like(y))
    return torch.where(nz, y - (y2 * y2 * y2 - x) / (3.0 * y2 * y2), y)


def _recip(f):
    return lambda x: 1.0 / f(x)


def _of_recip(f):
    return lambda x: f(1.0 / x)


TRIG_OPS = {
    "COS": torch.cos,
    "SIN": torch.sin,
    "TAN": torch.tan,
    "SEC": _recip(torch.cos),
    "CSC": _recip(torch.sin),
    "COT": _recip(torch.tan),
    "ACOS": torch.arccos,
    "ASIN": torch.arcsin,
    "ATAN": torch.arctan,
    "ASEC": _of_recip(torch.arccos),
    "ACSC": _of_recip(torch.arcsin),
    "ACOT": _of_recip(torch.arctan),
    "COSH": torch.cosh,
    "SINH": torch.sinh,
    "TANH": torch.tanh,
    "SECH": _recip(torch.cosh),
    "CSCH": _recip(torch.sinh),
    "COTH": _recip(torch.tanh),
    "ACOSH": torch.arccosh,
    "ASINH": torch.arcsinh,
    "ATANH": torch.arctanh,
    "ASECH": _of_recip(torch.arccosh),
    "ACSCH": _of_recip(torch.arcsinh),
    "ACOTH": _of_recip(torch.arctanh),
}


def tgamma_sign(x):
    """The sign of Γ(x): negative on the intervals (-2k-1, -2k)."""
    return torch.where((x < 0) & (torch.remainder(torch.floor(x), 2) == 0),
                       -1.0, 1.0).to(x.dtype)


def tgamma(x):
    """std::tgamma: true gamma with sign (lgamma gives log|Γ|)."""
    return tgamma_sign(x) * torch.exp(torch.lgamma(x))


UNARY_FLOAT_OPS = {
    "log": torch.log,
    "log2": torch.log2,
    "log10": torch.log10,
    "log1p": torch.log1p,
    "exp": torch.exp,
    "exp2": torch.exp2,
    "exp10": lambda x: torch.pow(10.0, x),  # math/Exp10.hpp.in:6-7
    "expm1": torch.expm1,
    "sqrt": torch.sqrt,
    "cbrt": _cbrt,
    "sigmoid": lambda x: 1.0 / (1.0 + torch.exp(-x)),
    "sinc": _sinc,
    "gamma": tgamma,
    "lngamma": torch.lgamma,
    "erf": torch.erf,
    "erfc": torch.erfc,
}


def unary_fn(dtype: DType, name: str):
    """Unary op for a dtype with reference cast semantics: integer dtypes
    evaluate in float64 then C-cast back (e.g. math/Log.cpp:82 std::log
    on an int operand promotes to double, then Type() truncates)."""
    dtype = DType.parse(dtype)
    f = UNARY_FLOAT_OPS[name] if name in UNARY_FLOAT_OPS else TRIG_OPS[name]
    if dtype.is_float:
        return f
    tdt = dtype.scalar.torch
    return lambda x: c_cast(f(x.to(torch.float64)), tdt)


def logn_fn(dtype: DType, base: float):
    dtype = DType.parse(dtype)
    ln_base = math.log(base)

    def f(x):
        return torch.log(x) / ln_base

    if dtype.is_float:
        return f
    tdt = dtype.scalar.torch
    return lambda x: c_cast(f(x.to(torch.float64)), tdt)


def expn_fn(dtype: DType, base: float):
    dtype = DType.parse(dtype)
    if dtype.is_float:
        return lambda x: torch.pow(base, x)
    tdt = dtype.scalar.torch
    return lambda x: c_cast(torch.pow(base, x.to(torch.float64)), tdt)


def pow_fn(dtype: DType):
    """x^k with runtime exponent (reference math/Pow.cpp:35-42:
    Type(std::pow(in, exponent)) — evaluate in double, C-cast back)."""
    dtype = DType.parse(dtype)
    if dtype.is_float:
        return lambda x, k: torch.pow(x, k)
    tdt = dtype.scalar.torch
    return lambda x, k: c_cast(torch.pow(x.to(torch.float64), float(k)), tdt)


def root_fn(dtype: DType, which: str):
    """sqrt/cbrt/nth_root (reference math/Root.cpp). nth root = x**(1/n)."""
    dtype = DType.parse(dtype)
    tdt = dtype.scalar.torch
    if which == "nth":
        if dtype.is_float:
            return lambda x, n: torch.pow(x, 1.0 / n)
        return lambda x, n: c_cast(
            torch.pow(x.to(torch.float64), 1.0 / float(n)), tdt)
    f = torch.sqrt if which == "sqrt" else _cbrt
    if dtype.is_float:
        return f
    return lambda x: c_cast(f(x.to(torch.float64)), tdt)


def rsqrt_fn(dtype: DType):
    """Reference math/RSqrt.hpp: float32 uses the fast-inverse-sqrt
    approximation; float64 uses 1/sqrt (the reference only registers
    float/double)."""
    dtype = DType.parse(dtype)
    if dtype.name == "float32":
        return q_rsqrt_f32
    return lambda x: 1.0 / torch.sqrt(x)


def beta_fn(dtype: DType):
    """B(x, y) = Γ(x)Γ(y)/Γ(x+y) (reference math/Beta.cpp — float only)."""

    def f(x, y):
        sign = tgamma_sign(x) * tgamma_sign(y) * tgamma_sign(x + y)
        mag = torch.exp(torch.lgamma(x) + torch.lgamma(y)
                        - torch.lgamma(x + y))
        return sign * mag

    return f


def abs_fn(dtype: DType):
    """|x| (reference math/Abs.cpp: signed types; complex → magnitude;
    fixed-point complex via functions/FxptHelpers.hpp getAbs)."""
    dtype = DType.parse(dtype)
    if dtype.is_complex_int:
        npdt = dtype.scalar.np
        return lambda x: cint.abs_int(x, npdt)
    return torch.abs


def angle_fn(dtype: DType):
    """arg(x) (reference math/Angle.cpp; integer path via fxpt_atan2 —
    functions/FxptHelpers.hpp:14-29)."""
    dtype = DType.parse(dtype)
    if dtype.is_complex_int:
        tdt = dtype.scalar.torch

        def f(x):
            # fraction-of-turn uint16, narrowed to the element type
            return fxpt_atan2(x[..., 1], x[..., 0]).to(torch.int32).to(tdt)

        return f
    return torch.angle


def conjugate_fn(dtype: DType):
    dtype = DType.parse(dtype)
    if dtype.is_complex_int:
        return cint.conj
    return torch.conj_physical


def modf_fn(dtype: DType):
    """Split into integral and fractional parts, both carrying the sign
    (std::modf semantics; reference math/ModF.cpp:17-40)."""

    def f(x):
        integral = torch.trunc(x)
        return integral, x - integral

    return f


# --------------------------------------------------------------------- #
# numpy twins for uint16 / uint32 / uint64 (alone or complex)
# --------------------------------------------------------------------- #
def host_numpy(dtype: DType) -> bool:
    """True for the element kinds torch has no arithmetic for: their
    binary ops, comparators and Q-format products run on the host in
    numpy."""
    s = DType.parse(dtype).scalar
    return s.kind == "uint" and s.bits > 8


def _np_promote(x):
    """C integer promotion (as ops/cint): sub-int widths compute in int32,
    wider types stay in-type and wrap."""
    return x.astype(np.int32) if x.dtype.itemsize < 4 else x


def _np_tdiv(a, b):
    """C truncating division of integer arrays, 0 where b == 0."""
    b_safe = np.where(b == 0, np.ones_like(b), b)
    q = np.abs(a) // np.abs(b_safe) if a.dtype.kind == "i" else a // b_safe
    if a.dtype.kind == "i":
        q = np.where((a < 0) != (b_safe < 0), -q, q)
    return np.where(b == 0, np.zeros_like(q), q)


def cint_mul_np(a, b):
    """numpy twin of :func:`cint.mul`."""
    out = a.dtype
    ar, ai = _np_promote(a[..., 0]), _np_promote(a[..., 1])
    br, bi = _np_promote(b[..., 0]), _np_promote(b[..., 1])
    with np.errstate(over="ignore"):
        return np.stack([(ar * br - ai * bi).astype(out),
                         (ar * bi + ai * br).astype(out)], -1)


def _cint_div_np(a, b):
    """numpy twin of :func:`cint.div`."""
    out = a.dtype
    ar, ai = _np_promote(a[..., 0]), _np_promote(a[..., 1])
    br, bi = _np_promote(b[..., 0]), _np_promote(b[..., 1])
    with np.errstate(over="ignore"):
        n = _np_promote((br * br + bi * bi).astype(out))
        return np.stack([_np_tdiv(ar * br + ai * bi, n).astype(out),
                         _np_tdiv(ai * br - ar * bi, n).astype(out)], -1)


def binary_arith_np(dtype: DType, op: str):
    """numpy twin of :func:`binary_arith_fn` (wrapping, truncating)."""
    dtype = DType.parse(dtype)
    op = op.upper()
    if dtype.is_complex_int and op == "MUL":
        return cint_mul_np
    if dtype.is_complex_int and op == "DIV":
        return _cint_div_np
    ops = {"ADD": np.add, "SUB": np.subtract, "MUL": np.multiply,
           "DIV": _np_tdiv}

    def f(a, b):
        with np.errstate(over="ignore"):
            return ops[op](a, b).astype(a.dtype)

    return f


def const_arith_np(dtype: DType, op: str):
    base = binary_arith_np(dtype, _CONST_BASE[op])
    if op in ("X_PLUS_K", "X_MINUS_K", "X_MULT_K", "X_DIV_K"):
        return lambda x, k: base(x, np.broadcast_to(k, x.shape))
    return lambda x, k: base(np.ascontiguousarray(np.broadcast_to(
        k, x.shape)), x)


_CMP_NP = {">": np.greater, "<": np.less, ">=": np.greater_equal,
           "<=": np.less_equal, "==": np.equal, "!=": np.not_equal}


def comparator_np(op: str):
    cmp = _CMP_NP[op]
    return lambda a, b: cmp(a, b).astype(np.int8)
