"""Element data types.

The port's ``Pothos::DType``, as the JAX package's ``core/dtypes.py``
(reference: used by every block factory, e.g.
math/Arithmetic.cpp:259-283). A DType names an element kind
(signed/unsigned integer of 8..64 bits, float of 32/64 bits), an optional
complex flag, and a vector ``dimension`` (number of scalars per element —
arithmetic blocks treat a dimension-D stream as D× more scalars, see
math/Arithmetic.cpp:207 ``minElements * dimension``).

Representation notes:

- float / complex-float dtypes map directly onto numpy and torch dtypes
  (:attr:`DType.np`, :attr:`DType.torch`).
- **complex-integer** dtypes (``complex_int16`` etc. — the reference supports
  the full complex integer matrix via ``std::complex<intN>``) have no native
  numpy dtype. We represent them as integer arrays with a trailing axis of
  size 2 (re, im): such a stream's buffers have shape ``[..., n, 2]``.
  Complex arithmetic on them keeps C++ integer wraparound.
- uint16/uint32/uint64 map to torch's limited unsigned dtypes, which
  have no ``+``, ``>>`` or ``//``: arithmetic on them needs an int64
  detour with masking, or the host numpy path.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np
import torch

_NAME_RE = re.compile(
    r"^(complex_)?(int|uint|float)(8|16|32|64)$"
)

# Pothos-style aliases accepted by the parser.
_ALIASES = {
    "complex64": "complex_float32",
    "complex128": "complex_float64",
    "cfloat32": "complex_float32",
    "cfloat64": "complex_float64",
    "cfloat": "complex_float32",
    "float": "float32",
    "double": "float64",
    "complex_float": "complex_float32",
    "complex_double": "complex_float64",
}


@dataclasses.dataclass(frozen=True)
class DType:
    """An element type: kind × bits × complex? × vector dimension."""

    kind: str  # 'int' | 'uint' | 'float'
    bits: int
    is_complex: bool = False
    dimension: int = 1

    # ------------------------------------------------------------------ #
    # Construction
    # ------------------------------------------------------------------ #
    @staticmethod
    def parse(spec: "DType | str | np.dtype", dimension: int | None = None) -> "DType":
        """Parse ``"int16"``, ``"complex_float32"``, numpy dtypes, etc."""
        if isinstance(spec, DType):
            if dimension is not None and dimension != spec.dimension:
                return dataclasses.replace(spec, dimension=dimension)
            return spec
        if isinstance(spec, (np.dtype, type)):
            nd = np.dtype(spec)
            if nd.kind == "c":
                name = "complex_float%d" % (nd.itemsize * 4)
            elif nd.kind == "f":
                name = "float%d" % (nd.itemsize * 8)
            elif nd.kind == "i":
                name = "int%d" % (nd.itemsize * 8)
            elif nd.kind == "u":
                name = "uint%d" % (nd.itemsize * 8)
            else:
                raise ValueError(f"unsupported numpy dtype {nd}")
            spec = name
        spec = str(spec).strip()
        if "," in spec:  # "float32, 2" vector form
            base, _, dim = spec.partition(",")
            return DType.parse(base.strip(), int(dim.strip()))
        spec = _ALIASES.get(spec, spec)
        m = _NAME_RE.match(spec)
        if not m:
            raise ValueError(f"cannot parse DType {spec!r}")
        cplx, kind, bits = bool(m.group(1)), m.group(2), int(m.group(3))
        if kind == "float" and bits < 32:
            raise ValueError(f"unsupported float width {bits}")
        return DType(kind, bits, cplx, dimension or 1)

    # ------------------------------------------------------------------ #
    # Queries
    # ------------------------------------------------------------------ #
    @property
    def name(self) -> str:
        base = f"{self.kind}{self.bits}"
        return f"complex_{base}" if self.is_complex else base

    @property
    def is_float(self) -> bool:
        return self.kind == "float"

    @property
    def is_integer(self) -> bool:
        return self.kind in ("int", "uint")

    @property
    def is_signed(self) -> bool:
        return self.kind in ("int", "float")

    @property
    def is_complex_int(self) -> bool:
        return self.is_complex and self.is_integer

    @property
    def scalar(self) -> "DType":
        """The real scalar dtype underlying this (possibly complex) dtype."""
        return DType(self.kind, self.bits, False, self.dimension)

    @property
    def np(self) -> np.dtype:
        """Storage numpy dtype. Complex-int returns the scalar int dtype
        (data carried with a trailing re/im axis of 2)."""
        if self.is_complex and self.is_float:
            return np.dtype(f"complex{self.bits * 2}")
        return np.dtype(f"{self.kind}{self.bits}")

    @property
    def torch(self) -> torch.dtype:
        """Storage torch dtype (complex-int: the scalar int dtype, as
        :attr:`np`)."""
        return _TORCH[self.np]

    @property
    def storage_shape_suffix(self) -> tuple:
        """Trailing array axes implied per element."""
        suffix = ()
        if self.dimension != 1:
            suffix = suffix + (self.dimension,)
        if self.is_complex_int:
            suffix = suffix + (2,)
        return suffix

    @property
    def itemsize(self) -> int:
        n = self.bits // 8 * self.dimension
        return n * 2 if self.is_complex else n

    def __str__(self) -> str:
        if self.dimension != 1:
            return f"{self.name}, {self.dimension}"
        return self.name

    def __repr__(self) -> str:
        return f"DType({self!s})"


_TORCH = {np.dtype(n): getattr(torch, n) for n in (
    "int8", "int16", "int32", "int64", "uint8", "uint16", "uint32", "uint64",
    "float32", "float64", "complex64", "complex128")}


# ---------------------------------------------------------------------- #
# Canonical factory matrices (reference: math/Arithmetic.cpp:259-283 — 10
# scalar + 10 complex entries)
# ---------------------------------------------------------------------- #
INT_NAMES = ["int8", "int16", "int32", "int64"]
UINT_NAMES = ["uint8", "uint16", "uint32", "uint64"]
FLOAT_NAMES = ["float32", "float64"]
SCALAR_NAMES = INT_NAMES + UINT_NAMES + FLOAT_NAMES
COMPLEX_NAMES = ["complex_" + n for n in SCALAR_NAMES]
ALL_NAMES = SCALAR_NAMES + COMPLEX_NAMES

SCALAR_TYPES = [DType.parse(n) for n in SCALAR_NAMES]
COMPLEX_TYPES = [DType.parse(n) for n in COMPLEX_NAMES]
ALL_TYPES = SCALAR_TYPES + COMPLEX_TYPES
COMPLEX_FLOAT_TYPES = [DType.parse(n) for n in ("complex_float32", "complex_float64")]
FLOAT_TYPES = [DType.parse(n) for n in FLOAT_NAMES]
