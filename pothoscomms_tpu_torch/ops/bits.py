"""Vectorized bit/symbol/byte (de)serialization.

Replaces the reference's unrolled per-width pack loops
(digital/SymbolHelpers.hpp) with one general formulation: every
conversion is serialize-to-bitstream + regroup, where the bit order
within a symbol/byte is MSB-first ("MSBit") or LSB-first ("LSBit").
Verified bit-exact against the reference loop structure by the
round-trip and golden tests (tests/test_digital.py).

All functions are numpy (uint8 streams are control-plane width; the
device path for the full digital link carries symbols as float32 planes).
"""

from __future__ import annotations

import numpy as np

_ORDERS = ("LSBit", "MSBit")


def _check(width: int, order: str):
    if not (1 <= width <= 8):
        raise ValueError("Modulus must be between 1 and 8 inclusive")
    if order not in _ORDERS:
        raise ValueError("Order must be LSBit or MSBit")


def unpack_to_bits(data: np.ndarray, width: int, order: str) -> np.ndarray:
    """[n] unsigned values -> [n*width] bit stream in the given order."""
    _check(width, order)
    data = np.asarray(data, np.uint8)
    shifts = np.arange(width - 1, -1, -1) if order == "MSBit" else \
        np.arange(width)
    bits = (data[:, None] >> shifts[None, :]) & 1
    return bits.reshape(-1).astype(np.uint8)


def pack_from_bits(bits: np.ndarray, width: int, order: str) -> np.ndarray:
    """[n*width] bit stream -> [n] packed values in the given order."""
    _check(width, order)
    bits = np.asarray(bits, np.uint8)
    n = (bits.size // width) * width
    bits = bits[:n].reshape(-1, width) & 1
    weights = 1 << (np.arange(width - 1, -1, -1) if order == "MSBit"
                    else np.arange(width))
    return (bits * weights[None, :].astype(np.uint8)).sum(
        axis=1, dtype=np.uint16
    ).astype(np.uint8)


def bits_to_symbols(bits: np.ndarray, width: int, order: str) -> np.ndarray:
    """{0, nonzero} bit stream -> width-bit symbols (reference:
    digital/SymbolHelpers.hpp:13-41; nonzero input counts as a 1 bit)."""
    b = (np.asarray(bits) != 0).astype(np.uint8)
    return pack_from_bits(b, width, order)


def symbols_to_bits(syms: np.ndarray, width: int, order: str) -> np.ndarray:
    """width-bit symbols -> 0/1 bytes (reference: SymbolHelpers.hpp:46-72)."""
    return unpack_to_bits(syms, width, order)


def symbols_to_bytes(syms: np.ndarray, width: int, order: str) -> np.ndarray:
    """width-bit symbols -> packed bytes: serialize symbols to a bitstream
    in the given order, fill bytes in the same order
    (reference: SymbolHelpers.hpp:77-228)."""
    bits = unpack_to_bits(syms, width, order)
    n_bytes = bits.size // 8
    return pack_from_bits(bits[: n_bytes * 8], 8, order)


def bytes_to_symbols(data: np.ndarray, width: int, order: str) -> np.ndarray:
    """bytes -> width-bit symbols (reference: SymbolHelpers.hpp:233-414)."""
    bits = unpack_to_bits(data, 8, order)
    n_syms = bits.size // width
    return pack_from_bits(bits[: n_syms * width], width, order)


def group_bytes(width: int) -> int:
    """Input-byte granularity so symbol groups align with byte boundaries
    (reference: digital/BytesToSymbols.cpp:69-76)."""
    return {7: 7, 5: 5, 3: 3, 6: 3}.get(width, 1)


def group_symbols(width: int) -> int:
    """Symbol granularity for symbols->bytes: lcm(8, width)/width."""
    return np.lcm(8, width) // width
