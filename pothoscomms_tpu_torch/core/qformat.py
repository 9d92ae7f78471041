"""Q-format fixed-point helpers.

The port's ``Pothos::Util::QFormat`` (used by the reference's
fixed-point paths: math/Scale.cpp:15-23, math/Rotate.cpp, filter/FIRFilter.cpp
:295-300, utility/SignalProbe.cpp:141-157).

Semantics (matching the reference):

- ``float_to_q(value, qdtype)``: for integer Q types, scale by
  ``2**(bits/2)`` (ldexp by half the width) and truncate toward zero; for
  float Q types, a plain cast.
- ``from_q(arr, out_dtype)``: for integer inputs, arithmetic shift right by
  half the *input* type's width, then cast (with C-style wraparound); for
  float inputs, a plain cast.

Both work elementwise on numpy arrays, ``from_q`` on tensors too. Complex
integer values are handled componentwise (trailing re/im axis of 2 — see
core/dtypes.py).

The standard Q-accumulator widening per data type mirrors the reference's
factory tables (filter/FIRFilter.cpp:369-383, math/Scale.cpp factory):
int8→int16, int16→int32, int32→int64, int64→int64, float→float.
"""

from __future__ import annotations

import numpy as np
import torch

from pothoscomms_tpu_torch.core.dtypes import DType

# Widening map: data dtype name -> Q accumulator dtype name
# (reference: filter/FIRFilter.cpp:377-382).
Q_ACCUMULATOR = {
    "int8": "int16",
    "int16": "int32",
    "int32": "int64",
    "int64": "int64",
    "uint8": "uint16",
    "uint16": "uint32",
    "uint32": "uint64",
    "uint64": "uint64",
    "float32": "float32",
    "float64": "float64",
}


def q_dtype_for(dtype: DType) -> DType:
    """The Q accumulator dtype used for a given data dtype."""
    base = Q_ACCUMULATOR[dtype.scalar.name]
    return DType.parse(("complex_" + base) if dtype.is_complex else base)


def float_to_q(value, qdtype: DType):
    """Convert a python/numpy float (or complex) scalar/array to Q format.

    For integer Q types: ``trunc(value * 2**(bits/2))`` with wraparound cast.
    For float Q types: plain cast.
    """
    qdtype = DType.parse(qdtype)
    sdt = qdtype.scalar
    if sdt.is_float:
        if qdtype.is_complex:
            return np.asarray(value, dtype=qdtype.np)
        return np.asarray(value, dtype=sdt.np)
    shift = sdt.bits // 2
    value = np.asarray(value)
    if qdtype.is_complex or np.iscomplexobj(value):
        v = np.asarray(value, dtype=np.complex128) * (2.0 ** shift)
        # represent as trailing (re, im) int pair (np.trunc has no complex path)
        out = np.stack([np.trunc(v.real), np.trunc(v.imag)], axis=-1)
        return _wrap_cast(out, sdt.np)
    scaled = np.trunc(np.asarray(value, dtype=np.float64) * (2.0 ** shift))
    return _wrap_cast(scaled, sdt.np)


def _wrap_cast(float_arr, int_np_dtype):
    """C-style float→int cast with modular wraparound on overflow."""
    info = np.iinfo(int_np_dtype)
    span = float(info.max) - float(info.min) + 1.0
    a = np.asarray(float_arr, dtype=np.float64)
    a = np.mod(a - float(info.min), span) + float(info.min)
    return a.astype(int_np_dtype)


def from_q(arr, out_dtype: DType, in_bits: int | None = None):
    """Extract a value from Q format.

    ``arr`` is a numpy array or tensor in Q format (integer: scaled by
    2**(in_bits/2)). For integer arrays, arithmetic shift right by half the
    input width, then cast with wraparound. For float arrays, plain cast.
    """
    out_dtype = DType.parse(out_dtype)
    if isinstance(arr, torch.Tensor):
        if arr.is_floating_point() or arr.is_complex():
            return arr.to(out_dtype.torch)
        bits = in_bits if in_bits is not None else arr.element_size() * 8
        return (arr >> (bits // 2)).to(out_dtype.torch)
    kind = np.dtype(arr.dtype).kind
    if kind in "fc":
        return arr.astype(out_dtype.np)
    bits = in_bits if in_bits is not None else np.dtype(arr.dtype).itemsize * 8
    shifted = np.right_shift(arr, bits // 2)
    return shifted.astype(out_dtype.np)
