"""Device cores of the digital symbol-coding blocks (the port of the JAX
package's ``ops/digital_device.py``).

The reference gives every digital block an unrolled SIMD pack/unpack loop
(reference: digital/SymbolHelpers.hpp:13-414). A fused segment carries
uint8 and int16 streams as integer-valued float32 planes
(``core/fusion.to_planar``); every core here takes such planes, computes
in int64 with torch's native shifts, masks and bitwise operators, and
returns integer-valued float32 planes again. Values below 2^24 are exact
in float32, so the round trip is exact. (The JAX package spells every
operation as exact float32 arithmetic, ``floor(x / 2^k) mod 2`` and the
like, because the TPU backend has no integer operations; the card has
them. The int64 detour also covers torch's missing ``+``, ``>>`` and
``//`` on uint16, uint32 and uint64.)

Cores are shape-polymorphic over [C, T] planes (complex mapper outputs and
slicer inputs [C, T, 2]); the fusion executor calls them eagerly on the
topology's device.
"""

from __future__ import annotations

import numpy as np
import torch


def _ints(x: torch.Tensor) -> torch.Tensor:
    """Integer-valued float32 planes -> int64 (rounded: a float32
    3.9999997 must not truncate to 3)."""
    return torch.round(x).to(torch.int64)


def _planes(v: torch.Tensor) -> torch.Tensor:
    return v.to(torch.float32)


def _shifts(width: int, order: str) -> list:
    return list(range(width - 1, -1, -1)) if order == "MSBit" \
        else list(range(width))


def pack_core(width: int, order: str):
    """[C, T] bit plane (nonzero counts as 1, reference
    SymbolHelpers.hpp:13-41) -> [C, T/width] symbols."""
    weights = torch.tensor([1 << s for s in _shifts(width, order)],
                           dtype=torch.int64)

    def core(x):
        C, T = x.shape
        bits = (x.reshape(C, T // width, width) != 0).to(torch.int64)
        return _planes((bits * weights.to(x.device)).sum(dim=-1))

    return core


def unpack_core(width: int, order: str):
    """[C, T] symbols -> [C, T*width] 0/1 bits."""
    shifts = torch.tensor(_shifts(width, order), dtype=torch.int64)

    def core(x):
        bits = (_ints(x)[..., None] >> shifts.to(x.device)) & 1
        return _planes(bits.reshape(x.shape[0], x.shape[1] * width))

    return core


def repack_core(in_width: int, out_width: int, order: str):
    """width-A symbols -> width-B symbols through the common bitstream
    (symbols_to_bytes: B = 8; bytes_to_symbols: A = 8)."""
    unpack = unpack_core(in_width, order)
    pack = pack_core(out_width, order)

    def core(x):
        return pack(unpack(x))

    return core


def mapper_core(table: np.ndarray, complex_out: bool):
    """[C, T] symbol indices -> constellation points (reference:
    digital/SymbolMapper.cpp), the index masked mod K (K a power of two):
    a lookup in the float32 table, which gives what the JAX package's
    K-term one-hot sum gives."""
    K = len(table)
    if complex_out:
        lut = np.stack([np.real(table), np.imag(table)], -1)
    else:
        lut = np.real(table)
    lut = torch.from_numpy(np.ascontiguousarray(lut, np.float32))

    def core(x):
        return lut.to(x.device)[_ints(x) & (K - 1)]

    return core


def slicer_core(points: np.ndarray, complex_in: bool):
    """Nearest constellation index, the earliest index winning ties
    (reference SymbolSlicer.cpp:78-100 keeps the first strict minimum).
    Squared distances in float32, in the JAX package's order of
    operations."""
    pre = np.real(points).astype(np.float32)
    pim = np.imag(points).astype(np.float32)

    def core(x):
        xr, xi = (x[..., 0], x[..., 1]) if complex_in else (x, None)
        best = dmin = None
        for k in range(len(points)):
            dr = xr - float(pre[k])
            d = dr * dr
            if xi is not None:
                di = xi - float(pim[k])
                d = d + di * di
            if dmin is None:
                dmin = d
                best = torch.zeros(d.shape, dtype=torch.int64,
                                   device=d.device)
            else:
                closer = d < dmin
                best = torch.where(closer, k, best)
                dmin = torch.minimum(dmin, d)
        return _planes(best)

    return core


def diff_encode_core(symbols: int):
    """out[i] = (in[i] + out[i-1]) mod N telescoped to a cumulative sum
    mod N (reference digital/DifferentialEncoder.cpp), exact in int64.
    The carry is [C, 1]: each channel's last output. (The JAX core adds
    ``carry[:, None, None]`` to [C, B, Lb] rows, which broadcasts right
    only for C = 1; here every channel carries its own.)"""
    N = int(symbols)

    def core(carry, x):
        y = (torch.cumsum(_ints(x), dim=1) + _ints(carry)) % N
        y = _planes(y)
        return y[:, -1:], y

    return core


def diff_decode_core(symbols: int):
    """out[i] = ((in[i] - in[i-1] + N) mod 2^32) mod N, the C uint32
    semantics of the reference (DifferentialDecoder.cpp:62-65); the carry
    is each channel's last input, [C, 1]."""
    N = int(symbols)

    def core(carry, x):
        xi = _ints(x)
        prev = torch.cat([_ints(carry), xi[:, :-1]], dim=1)
        y = ((xi - prev + N) & 0xFFFFFFFF) % N
        return x[:, -1:], _planes(y)

    return core


def signed_wrap(core, bits: int, nargs: int = 1):
    """Run an unsigned core on SIGNED streams: two's complement maps
    v < 0 to v + 2^bits, and the result maps back (y >= 2^(bits-1) ->
    y - 2^bits)."""
    span = float(1 << bits)
    half = float(1 << (bits - 1))

    def wrapped(*xs):
        us = [torch.where(x < 0, x + span, x) for x in xs[:nargs]]
        y = core(*us)
        return torch.where(y >= half, y - span, y)

    return wrapped


def bitwise_not_core(bits: int):
    mask = (1 << bits) - 1

    def core(x):
        return _planes(~_ints(x) & mask)

    return core


_BINARY = {"AND": torch.bitwise_and, "OR": torch.bitwise_or,
           "XOR": torch.bitwise_xor}


def bitwise_binary_core(op: str, bits: int):
    """Elementwise AND / OR / XOR of two unsigned ``bits``-wide planes."""
    fn = _BINARY[op]

    def core(a, b):
        return _planes(fn(_ints(a), _ints(b)))

    return core


def bitshift_core(left: bool, shift: int, bits: int):
    """Left shift modulo 2^bits, or right shift (arithmetic on signed
    values, as numpy's ``>>``)."""
    mask = (1 << bits) - 1

    def core(x):
        if left:
            return _planes((_ints(x) << shift) & mask)
        return _planes(_ints(x) >> shift)

    return core


def byteswap16_core():
    """uint16 endian swap."""

    def core(x):
        xi = _ints(x)
        return _planes(((xi & 0xFF) << 8) | (xi >> 8))

    return core
