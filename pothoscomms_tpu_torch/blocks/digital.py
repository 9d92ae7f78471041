"""Digital symbol-coding blocks (reference: digital/ module, SURVEY.md §2.4),
the port of the JAX package's ``blocks/digital.py``.

Conversion blocks (bits/symbols/bytes), mapper/slicer, differential
coding, scrambler/descrambler (Galois LFSR), bitwise ops, byte order.
Framing/sync blocks live in blocks/framing.py.

Streaming runs on the host in numpy (the scramblers on the C++ LFSR of
:mod:`pothoscomms_tpu_torch.native`); every block also has a fused device
core (``ops/digital_device.py``, the scramblers ``ops/gf2.py``) that a
fused segment runs on its topology's device, bit for bit equal to the
streaming path. Each core's ``fuse_label_adjust`` is the index rescale of
its streaming path, so a run of these blocks is label-transparent
(``core/fusion.py``).
"""

from __future__ import annotations

import sys
import numpy as np
import torch

from pothoscomms_tpu_torch.core.block import Block
from pothoscomms_tpu_torch.core.dtypes import DType
from pothoscomms_tpu_torch.core.packet import Packet
from pothoscomms_tpu_torch.core.registry import register_block
from pothoscomms_tpu_torch.ops import bits as bops
from pothoscomms_tpu_torch.ops import digital_device as dd


class _ConversionBlock(Block):
    """Shared shape of the four uchar conversion blocks: width ('modulus')
    in [1,8], bit order, stream work in aligned groups, packet msgWork,
    label index rescale (reference: digital/BitsToSymbols.cpp et al.)."""

    in_unit = 1   # input elements per conversion unit
    out_unit = 1  # output elements per conversion unit
    label_mul = 1
    label_div = 1

    def __init__(self):
        super().__init__()
        self.setup_input(0, DType.parse("uint8"))
        self.setup_output(0, DType.parse("uint8"))
        self._mod = 1
        self._order = "LSBit"

    def get_modulus(self) -> int:
        return self._mod

    def set_modulus(self, mod: int):
        if not (1 <= mod <= 8):
            raise ValueError("Modulus must be between 1 and 8 inclusive")
        self._mod = int(mod)
        self._update_units()
        self._bump_fuse_epoch()

    def get_bit_order(self) -> str:
        return self._order

    def set_bit_order(self, order: str):
        if order not in ("LSBit", "MSBit"):
            raise ValueError("Order must be LSBit or MSBit")
        self._order = order
        self._bump_fuse_epoch()

    def _update_units(self):
        pass

    def _convert(self, data: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    # -- auto-fusion protocol (core/fusion.py): stateless regroup ------- #
    # The pack/unpack loops are pure shift/mask arithmetic
    # (reference digital/SymbolHelpers.hpp:13-414); the device core
    # carries the uint8 stream as integer-valued f32 planes
    # (ops/digital_device.py). Labels pass through with the same
    # mul/div index rescale as the streaming path, so fused segments
    # carry them instead of disengaging (label-transparent).
    def _device_core(self):  # override per direction
        raise NotImplementedError

    def fuse_ready(self) -> bool:
        return True

    def fuse_granule(self) -> int:
        return self.in_unit

    def fuse_ratio(self):
        return (self.out_unit, self.in_unit)

    def fuse_label_adjust(self, lb):
        return lb.to_adjusted(self.label_mul, self.label_div)

    def fuse_export(self, channels: int):
        core = self._device_core()

        def step(carry, x):
            return carry, core(x)

        return (), step

    def fuse_import(self, carry) -> None:
        pass

    def _packet_units(self, payload_len: int) -> int:
        """Units to process for a packet payload (rounded up)."""
        return (payload_len + self.in_unit - 1) // self.in_unit

    def work(self):
        port = self.input(0)
        out = self.output(0)
        port.set_reserve(self.in_unit)
        if port.has_message():
            msg = port.pop_message()
            if isinstance(msg, Packet):
                units = self._packet_units(len(msg.payload))
                data = np.zeros(units * self.in_unit, np.uint8)
                data[: len(msg.payload)] = np.asarray(msg.payload, np.uint8)
                result = self._convert(data)
                labels = [lb.to_adjusted(self.label_mul, self.label_div)
                          for lb in msg.labels]
                out.post_message(
                    Packet(result, labels=labels, metadata=dict(msg.metadata))
                )
            else:
                out.post_message(msg)
            return
        n_units = port.elements() // self.in_unit
        if n_units == 0:
            return
        data = np.asarray(port.buffer(n_units * self.in_unit))
        result = self._convert(data)
        port.consume(n_units * self.in_unit)
        out.post(result)

    def propagate_labels(self, port, labels):
        out = self.output(0)
        for lb in labels:
            out.post_label(lb.to_adjusted(self.label_mul, self.label_div))


class _ConversionDoc:
    DOC = {
        "category": "/Digital",
        "keywords": ["bits", "symbols", "bytes", "pack", "unpack"],
        "params": {
            "mod": {"label": "Modulus", "default": 2,
                    "desc": "Symbol modulus 2^N (N bits per symbol)."},
            "bit_order": {
                "label": "Bit Order",
                "options": [{"label": "MSBit", "value": "MSBit"},
                            {"label": "LSBit", "value": "LSBit"}],
                "default": "MSBit",
            },
        },
    }


@register_block("/comms/bits_to_symbols", "/blocks/bits_to_symbols")
class BitsToSymbols(_ConversionDoc, _ConversionBlock):
    """Pack bits into width-N symbols (reference: digital/BitsToSymbols.cpp)."""

    def __init__(self, mod: int = 1, order: str = "LSBit"):
        super().__init__()
        self.set_modulus(mod)
        self.set_bit_order(order)

    def _update_units(self):
        self.in_unit = self._mod
        self.out_unit = 1
        self.label_mul, self.label_div = 1, self._mod

    def _convert(self, data):
        return bops.bits_to_symbols(data, self._mod, self._order)

    def _device_core(self):
        return dd.pack_core(self._mod, self._order)


@register_block("/comms/symbols_to_bits", "/blocks/symbols_to_bits")
class SymbolsToBits(_ConversionDoc, _ConversionBlock):
    """Unpack width-N symbols into bits (reference: digital/SymbolsToBits.cpp)."""

    def __init__(self, mod: int = 1, order: str = "LSBit"):
        super().__init__()
        self.set_modulus(mod)
        self.set_bit_order(order)

    def _update_units(self):
        self.in_unit = 1
        self.out_unit = self._mod
        self.label_mul, self.label_div = self._mod, 1

    def _convert(self, data):
        return bops.symbols_to_bits(data, self._mod, self._order)

    def _device_core(self):
        return dd.unpack_core(self._mod, self._order)


@register_block("/comms/symbols_to_bytes", "/blocks/symbols_to_bytes")
class SymbolsToBytes(_ConversionDoc, _ConversionBlock):
    """Pack width-N symbols into bytes (reference: digital/SymbolsToBytes.cpp;
    group granularity :74-78)."""

    def __init__(self, mod: int = 1, order: str = "LSBit"):
        super().__init__()
        self.set_modulus(mod)
        self.set_bit_order(order)

    def _update_units(self):
        self.in_unit = bops.group_symbols(self._mod)
        self.out_unit = (self.in_unit * self._mod) // 8
        self.label_mul, self.label_div = self._mod, 8

    def _convert(self, data):
        return bops.symbols_to_bytes(data, self._mod, self._order)

    def _device_core(self):
        return dd.repack_core(self._mod, 8, self._order)


@register_block("/comms/bytes_to_symbols", "/blocks/bytes_to_symbols")
class BytesToSymbols(_ConversionDoc, _ConversionBlock):
    """Unpack bytes into width-N symbols (reference:
    digital/BytesToSymbols.cpp; reserve groups :69-76)."""

    def __init__(self, mod: int = 1, order: str = "LSBit"):
        super().__init__()
        self.set_modulus(mod)
        self.set_bit_order(order)

    def _update_units(self):
        self.in_unit = bops.group_bytes(self._mod)
        self.out_unit = (self.in_unit * 8) // self._mod
        self.label_mul, self.label_div = 8, self._mod

    def _convert(self, data):
        return bops.bytes_to_symbols(data, self._mod, self._order)

    def _device_core(self):
        return dd.repack_core(8, self._mod, self._order)


# ---------------------------------------------------------------------- #
# Symbol mapper / slicer (reference: digital/SymbolMapper.cpp,
# digital/SymbolSlicer.cpp)
# ---------------------------------------------------------------------- #
class _SymbolMapDoc:
    DOC = {
        "category": "/Digital",
        "keywords": ["symbol", "constellation", "mapper", "slicer"],
        "params": {
            "map": {"label": "Symbol Map", "default": [-1.0, 1.0],
                    "desc": "Power-of-2-length constellation points."},
        },
    }


@register_block("/comms/symbol_mapper", "/blocks/symbol_mapper")
class SymbolMapper(_SymbolMapDoc, Block):
    """uchar symbol index -> constellation point via power-of-2 LUT."""

    def __init__(self, dtype="complex_float32"):
        super().__init__()
        self.dtype = DType.parse(dtype)
        self.setup_input(0, DType.parse("uint8"))
        self.setup_output(0, self.dtype)
        self.set_map([1])

    def get_map(self):
        return self._map

    def set_map(self, symbol_map):
        symbol_map = np.asarray(symbol_map)
        if symbol_map.size == 0:
            raise ValueError("Map must be nonzero size")
        nbits = np.log2(symbol_map.size)
        if nbits != int(nbits):
            raise ValueError("Map must be a power of two in length")
        if self.dtype.is_complex_int:
            table = np.stack(
                [np.real(symbol_map), np.imag(symbol_map)], axis=-1
            ).astype(self.dtype.scalar.np)
        elif self.dtype.is_complex:
            table = symbol_map.astype(self.dtype.np)
        else:
            table = np.real(symbol_map).astype(self.dtype.np)
        self._map = symbol_map
        self._table = table
        self._mask = symbol_map.size - 1
        self._bump_fuse_epoch()

    def work(self):
        port = self.input(0)
        n = port.elements()
        if n == 0:
            return
        idx = np.asarray(port.buffer(n)) & self._mask
        port.consume(n)
        self.output(0).post(self._table[idx])

    # -- auto-fusion: table lookup on integer-valued f32 planes --------- #
    def fuse_ready(self) -> bool:
        return (self._map.size <= 32 and self.dtype.is_float
                and self.dtype.scalar.bits == 32)

    def fuse_label_adjust(self, lb):
        return lb

    def fuse_export(self, channels: int):
        core = dd.mapper_core(np.asarray(self._map, np.complex128)
                              if self.dtype.is_complex
                              else np.real(self._map),
                              self.dtype.is_complex)

        def step(carry, x):
            return carry, core(x)

        return (), step

    def fuse_import(self, carry) -> None:
        pass


@register_block("/comms/symbol_slicer", "/blocks/symbol_slicer")
class SymbolSlicer(_SymbolMapDoc, Block):
    """Nearest-neighbor constellation decision -> uchar index
    (squared-euclidean brute force, reference: SymbolSlicer.cpp:78-100)."""

    def __init__(self, dtype="complex_float32"):
        super().__init__()
        self.dtype = DType.parse(dtype)
        self.setup_input(0, self.dtype)
        self.setup_output(0, DType.parse("uint8"))
        self.set_map([1])

    def get_map(self):
        return self._map

    def set_map(self, symbol_map):
        symbol_map = np.asarray(symbol_map)
        if symbol_map.size == 0:
            raise ValueError("Map must be nonzero size")
        self._map = symbol_map
        self._points = symbol_map.astype(np.complex128) if \
            np.iscomplexobj(symbol_map) or self.dtype.is_complex else \
            symbol_map.astype(np.float64)
        self._bump_fuse_epoch()

    def work(self):
        port = self.input(0)
        n = port.elements()
        if n == 0:
            return
        buf = np.asarray(port.buffer(n))
        if self.dtype.is_complex_int:
            x = buf[..., 0].astype(np.float64) + 1j * buf[..., 1].astype(np.float64)
        elif self.dtype.is_complex:
            x = buf.astype(np.complex128)
        else:
            x = buf.astype(np.float64)
        d = np.abs(x[:, None] - np.asarray(self._points)[None, :]) ** 2
        out = np.argmin(d, axis=1).astype(np.uint8)
        port.consume(n)
        self.output(0).post(out)

    # -- auto-fusion: K-term earliest-argmin on f32 planes -------------- #
    # Distances compute in f32 on device vs f64 on the streaming path:
    # for points/samples away from decision boundaries the argmin is
    # identical; exact boundary ties keep the earliest index in both.
    def fuse_ready(self) -> bool:
        return (self._map.size <= 32 and self.dtype.is_float
                and self.dtype.scalar.bits == 32)

    def fuse_label_adjust(self, lb):
        return lb

    def fuse_export(self, channels: int):
        core = dd.slicer_core(np.asarray(self._points),
                              self.dtype.is_complex)

        def step(carry, x):
            return carry, core(x)

        return (), step

    def fuse_import(self, carry) -> None:
        pass


# ---------------------------------------------------------------------- #
# Differential coding (reference: digital/DifferentialEncoder.cpp,
# digital/DifferentialDecoder.cpp)
# ---------------------------------------------------------------------- #
class _DiffDoc:
    DOC = {
        "category": "/Digital",
        "keywords": ["differential", "encoder", "decoder", "symbols"],
        "params": {
            "symbols": {"label": "Symbols", "default": 2,
                        "desc": "Modulus N: out = (in +- last) mod N.",
                        "widget": "SpinBox(minimum=2)"},
        },
    }


@register_block("/comms/differential_encoder", "/blocks/differential_encoder")
class DifferentialEncoder(_DiffDoc, Block):
    def __init__(self):
        super().__init__()
        self.setup_input(0, DType.parse("uint8"))
        self.setup_output(0, DType.parse("uint8"))
        self._last = 0
        self._symbols = 2

    def set_symbols(self, symbols: int):
        self._symbols = int(symbols)
        self._bump_fuse_epoch()

    def work(self):
        port = self.input(0)
        n = port.elements()
        if n == 0:
            return
        x = np.asarray(port.buffer(n)).astype(np.int64)
        # recursion out[i] = (in[i] + out[i-1]) % N telescopes to a
        # cumulative sum mod N — exact, vectorized
        out = (np.cumsum(x) + self._last) % self._symbols
        self._last = int(out[-1])
        port.consume(n)
        self.output(0).post(out.astype(np.uint8))

    # -- auto-fusion: blocked exact cumsum-mod-N ------------------------ #
    def fuse_ready(self) -> bool:
        return self._symbols <= 256

    def fuse_label_adjust(self, lb):
        return lb

    def fuse_export(self, channels: int):
        carry = torch.full((channels, 1), float(self._last % self._symbols),
                           dtype=torch.float32, device=self.device)
        return carry, dd.diff_encode_core(self._symbols)

    def fuse_import(self, carry) -> None:
        self._last = int(np.rint(carry[0, 0].item()))


@register_block("/comms/differential_decoder", "/blocks/differential_decoder")
class DifferentialDecoder(_DiffDoc, Block):
    def __init__(self):
        super().__init__()
        self.setup_input(0, DType.parse("uint8"))
        self.setup_output(0, DType.parse("uint8"))
        self._last = 0
        self._symbols = 2

    def set_symbols(self, symbols: int):
        self._symbols = int(symbols)
        self._bump_fuse_epoch()

    def work(self):
        port = self.input(0)
        n = port.elements()
        if n == 0:
            return
        x = np.asarray(port.buffer(n)).astype(np.int64)
        prev = np.concatenate([[self._last], x[:-1]])
        # C semantics: (recv - last + N) evaluated in uint32
        # (reference DifferentialDecoder.cpp:62-65)
        out = ((x - prev + self._symbols) % (1 << 32)) % self._symbols
        self._last = int(x[-1])
        port.consume(n)
        self.output(0).post(out.astype(np.uint8))

    # -- auto-fusion: one-sample-carry elementwise ---------------------- #
    def fuse_ready(self) -> bool:
        return self._symbols <= 256

    def fuse_label_adjust(self, lb):
        return lb

    def fuse_export(self, channels: int):
        carry = torch.full((channels, 1), float(self._last),
                           dtype=torch.float32, device=self.device)
        return carry, dd.diff_decode_core(self._symbols)

    def fuse_import(self, carry) -> None:
        self._last = int(np.rint(carry[0, 0].item()))


# ---------------------------------------------------------------------- #
# Galois LFSR scrambler/descrambler (reference: digital/Scrambler.cpp,
# digital/Descrambler.cpp, vendored digital/lfsr.h)
# ---------------------------------------------------------------------- #
class GaloisLFSR:
    """Galois LFSR (reference digital/lfsr.h:64-100): mask = highest set
    bit of the polynomial; each step shifts left and xors the polynomial
    (with implicit +1 term) when the mask bit fires."""

    MASK64 = (1 << 64) - 1

    def __init__(self, polynomial: int, seed: int):
        self.poly = (polynomial | 1) & self.MASK64
        self.mask = 0
        p = polynomial & self.MASK64
        for shift in range(63, -1, -1):
            if p & (1 << shift):
                self.mask = 1 << shift
                break
        self.data = seed & self.MASK64

    def next(self) -> int:
        self.data = (self.data << 1) & self.MASK64
        if self.data & self.mask:
            self.data ^= self.poly
            return 1
        return 0

    def keystream(self, n: int) -> np.ndarray:
        out = np.empty(n, np.uint8)
        data, mask, poly = self.data, self.mask, self.poly
        for i in range(n):
            data = (data << 1) & self.MASK64
            if data & mask:
                data ^= poly
                out[i] = 1
            else:
                out[i] = 0
        self.data = data
        return out

    def scramble_mult(self, bits: np.ndarray) -> np.ndarray:
        out = np.empty(len(bits), np.uint8)
        for i in range(len(bits)):
            o = (int(bits[i]) & 1) ^ self.next()
            self.data = (self.data & ~1) | o
            out[i] = o
        return out

    def descramble_mult(self, bits: np.ndarray) -> np.ndarray:
        out = np.empty(len(bits), np.uint8)
        for i in range(len(bits)):
            b = int(bits[i]) & 1
            out[i] = b ^ self.next()
            self.data = (self.data & ~1) | b
        return out


def _make_lfsr(polynomial: int, seed: int):
    """The C++ LFSR of :mod:`pothoscomms_tpu_torch.native` (the Galois
    semantics of :class:`GaloisLFSR`, which the tests hold it to). There
    is no fallback: a failed build raises."""
    from pothoscomms_tpu_torch import native

    return native.NativeLfsr(polynomial, seed)


class _ScramblerBase(Block):
    DOC = {
        "category": "/Digital",
        "keywords": ["scrambler", "lfsr", "whitening"],
        "params": {
            "poly": {"label": "Polynomial", "default": 1,
                     "widget": "LineEdit",
                     "desc": "Galois LFSR generator polynomial."},
            "seed": {"label": "Seed", "default": 1},
            "mode": {
                "label": "Mode",
                "options": [
                    {"label": "Additive", "value": "additive"},
                    {"label": "Multiplicative", "value": "multiplicative"},
                ],
                "default": "multiplicative",
            },
            "sync": {"label": "Sync Word", "default": "",
                     "desc": "Bit string inserted/detected for "
                             "additive-mode alignment."},
        },
    }

    def __init__(self):
        super().__init__()
        self.setup_input(0, DType.parse("uint8"))
        self.setup_output(0, DType.parse("uint8"))
        self._poly = 1
        self._seed = 1
        self._mode = "multiplicative"
        self._sync_word = ""
        self._lfsr = _make_lfsr(1, 1)
        self.set_mode("multiplicative")
        self.set_sync("")
        self.set_poly(0x19)

    def set_poly(self, polynomial: int):
        self._poly = int(polynomial)
        self._lfsr = _make_lfsr(self._poly, self._seed)
        self._lfsr_gen = getattr(self, "_lfsr_gen", 0) + 1
        self._bump_fuse_epoch()

    def poly(self) -> int:
        return self._poly

    def set_seed(self, seed: int):
        self._seed = int(seed)
        self._lfsr = _make_lfsr(self._poly, self._seed)
        self._lfsr_gen = getattr(self, "_lfsr_gen", 0) + 1
        self._bump_fuse_epoch()

    def seed(self) -> int:
        return self._seed

    def set_mode(self, mode: str):
        if mode not in ("additive", "multiplicative"):
            raise ValueError(f"unknown mode: {mode}")
        self._mode = mode
        self._bump_fuse_epoch()

    def mode(self) -> str:
        return self._mode

    # -- auto-fusion: blocked GF(2) affine state-space (ops/gf2.py) ----- #
    # The bit-serial Galois recursion becomes exact mod-2 linear
    # algebra per Lb-sample block — the GF(2) sibling of the blocked
    # state-space IIR. Carry = the 64 LFSR state bits as f32 planes.
    _GF2_BLOCK = 1024
    _gf2_mode = "scramble"  # overridden by Descrambler

    def fuse_ready(self) -> bool:
        return True

    def fuse_granule(self) -> int:
        return self._GF2_BLOCK

    def fuse_label_adjust(self, lb):
        return lb

    def fuse_export(self, channels: int):
        from pothoscomms_tpu_torch.ops import gf2

        mode = ("additive" if self._mode == "additive"
                else self._gf2_mode)
        # (V, Lst, G, Ab^(2^j)) on the device, uploaded once per engage
        params, auto = gf2.step_operators(self._poly, mode, self._GF2_BLOCK,
                                          self.device)
        carry = torch.from_numpy(
            np.broadcast_to(gf2.export_state(self._lfsr.data),
                            (channels, gf2.NBITS)).copy()).to(self.device)
        self._fuse_lfsr_gen = getattr(self, "_lfsr_gen", 0)

        def step(carry, x, V, Lst, G, Ab_pows):
            x = x - 2.0 * torch.floor(x * 0.5)  # streaming path takes x & 1
            return gf2.lfsr_blocked_step(carry, x, V, Lst, G, Ab_pows, auto)

        return carry, step, params

    def fuse_import(self, carry) -> None:
        from pothoscomms_tpu_torch.ops import gf2

        # a set_poly/set_seed while engaged re-seeds the LFSR; the old
        # device state must not clobber the fresh seed
        if getattr(self, "_fuse_lfsr_gen", None) == getattr(
                self, "_lfsr_gen", 0):
            self._lfsr.data = gf2.import_state(carry[0].cpu().numpy())

    def set_sync(self, sync_word: str):
        if len(sync_word) > 64:
            raise ValueError("sync word max len 64 bits")
        if any(c not in "01" for c in sync_word):
            raise ValueError("sync word must be 0s and 1s: " + sync_word)
        self._sync_word = sync_word

    def sync(self) -> str:
        return self._sync_word


@register_block("/comms/scrambler", "/blocks/scrambler")
class Scrambler(_ScramblerBase):
    def work(self):
        port = self.input(0)
        n = port.elements()
        if n == 0:
            return
        x = (np.asarray(port.buffer(n)) & 1).astype(np.uint8)
        if self._mode == "additive":
            ks = self._lfsr.keystream(n)
            out = x ^ ks
        else:
            # multiplicative: output bit becomes lfsr bit0 (recursive;
            # native C++ kernel when available)
            out = self._lfsr.scramble_mult(x)
        port.consume(n)
        self.output(0).post(out)


@register_block("/comms/descrambler", "/blocks/descrambler")
class Descrambler(_ScramblerBase):
    _gf2_mode = "descramble"

    def work(self):
        port = self.input(0)
        n = port.elements()
        if n == 0:
            return
        x = (np.asarray(port.buffer(n)) & 1).astype(np.uint8)
        if self._mode == "additive":
            ks = self._lfsr.keystream(n)
            out = x ^ ks
        else:
            # multiplicative descrambler: INPUT bit becomes lfsr bit0 —
            # self-synchronizing (reference Descrambler.cpp:141-151;
            # native C++ kernel when available)
            out = self._lfsr.descramble_mult(x)
        port.consume(n)
        self.output(0).post(out)


# ---------------------------------------------------------------------- #
# Bitwise ops (reference: digital/Bitwise.cpp)
# ---------------------------------------------------------------------- #
def _int_dtype(dtype) -> DType:
    dt = DType.parse(dtype)
    if not dt.is_integer or dt.is_complex:
        raise ValueError("bitwise blocks support integer dtypes only")
    return dt


@register_block("/comms/bitwise_unary")
def bitwise_unary_factory(dtype, operation: str = "NOT"):
    dt = _int_dtype(dtype)
    if operation != "NOT":
        raise ValueError(f"unknown unary operation {operation}")

    class _Not(Block):
        def __init__(self):
            super().__init__()
            self.dtype = dt
            self.setup_input(0, dt)
            self.setup_output(0, dt)

        # <= 16-bit streams ride f32 planes exactly (signed via
        # two's-complement offset wrap)
        def fuse_ready(self):
            return dt.bits <= 16

        def fuse_label_adjust(self, lb):
            return lb

        def fuse_export(self, channels):
            core = dd.bitwise_not_core(dt.bits)
            if dt.is_signed:
                core = dd.signed_wrap(core, dt.bits)

            def step(carry, x):
                return carry, core(x)

            return (), step

        def fuse_import(self, carry):
            pass

        def work(self):
            port = self.input(0)
            n = port.elements()
            if n == 0:
                return
            out = ~np.asarray(port.buffer(n))
            port.consume(n)
            self.output(0).post(out)

    return _Not()


_BITWISE_BINOPS = {
    "AND": np.bitwise_and,
    "OR": np.bitwise_or,
    "XOR": np.bitwise_xor,
}


@register_block("/comms/bitwise_binary")
def bitwise_binary_factory(dtype, operation: str = "AND", num_channels: int = 2):
    dt = _int_dtype(dtype)
    if operation not in _BITWISE_BINOPS:
        raise ValueError(f"unknown binary operation {operation}")
    if num_channels < 2:
        raise ValueError("numChannels must be >= 2")
    fcn = _BITWISE_BINOPS[operation]

    class _Bin(Block):
        def __init__(self):
            super().__init__()
            self.dtype = dt
            for i in range(num_channels):
                self.setup_input(i, dt)
            self.setup_output(0, dt)

        # -- auto-fusion: N-ary fan-in HEAD on integer-valued planes --- #
        def fuse_ready(self):
            return dt.bits <= 16

        def fuse_export(self, channels):
            core = dd.bitwise_binary_core(operation, dt.bits)
            if dt.is_signed:
                core = dd.signed_wrap(core, dt.bits, nargs=2)

            def step(carry, xs):
                acc = xs[0]
                for x in xs[1:]:
                    acc = core(acc, x)
                return carry, acc

            return (), step

        def fuse_import(self, carry):
            pass

        def work(self):
            ports = list(self.inputs.values())
            n = min(p.elements() for p in ports)
            if n == 0:
                return
            acc = np.asarray(ports[0].buffer(n))
            for p in ports[1:]:
                acc = fcn(acc, np.asarray(p.buffer(n)))
            for p in ports:
                p.consume(n)
            self.output(0).post(acc)

    return _Bin()


@register_block("/comms/const_bitwise_binary")
def const_bitwise_binary_factory(dtype, constant=0, operation: str = "AND"):
    dt = _int_dtype(dtype)
    if operation not in _BITWISE_BINOPS:
        raise ValueError(f"unknown binary operation {operation}")
    fcn = _BITWISE_BINOPS[operation]

    class _ConstBin(Block):
        def __init__(self):
            super().__init__()
            self.dtype = dt
            self.setup_input(0, dt)
            self.setup_output(0, dt)
            self.set_constant(constant)

        def set_constant(self, c):
            self._const = np.asarray(c, dt.np)
            self._bump_fuse_epoch()

        def constant(self):
            return self._const[()]

        def fuse_ready(self):
            return dt.bits <= 16

        def fuse_label_adjust(self, lb):
            return lb

        def fuse_export(self, channels):
            core = dd.bitwise_binary_core(operation, dt.bits)
            if dt.is_signed:
                core = dd.signed_wrap(core, dt.bits, nargs=2)
            cval = np.float32(int(self._const))

            def step(carry, x):
                return carry, core(x, torch.full_like(x, cval))

            return (), step

        def fuse_import(self, carry):
            pass

        def work(self):
            port = self.input(0)
            n = port.elements()
            if n == 0:
                return
            out = fcn(np.asarray(port.buffer(n)), self._const)
            port.consume(n)
            self.output(0).post(out)

    return _ConstBin()


@register_block("/comms/bitshift")
def bitshift_factory(dtype, operation: str = "LEFTSHIFT", shift_size: int = 0):
    dt = _int_dtype(dtype)
    if operation not in ("LEFTSHIFT", "RIGHTSHIFT"):
        raise ValueError(f"unknown shift operation {operation}")
    left = operation == "LEFTSHIFT"

    class _Shift(Block):
        def __init__(self):
            super().__init__()
            self.dtype = dt
            self.setup_input(0, dt)
            self.setup_output(0, dt)
            self.set_shift_size(shift_size)

        def set_shift_size(self, s: int):
            if s >= dt.bits:
                raise ValueError("shift size must be < dtype width")
            self._shift = int(s)
            self._bump_fuse_epoch()

        def shift_size(self) -> int:
            return self._shift

        def fuse_ready(self):
            return dt.bits <= 16

        def fuse_label_adjust(self, lb):
            return lb

        def fuse_export(self, channels):
            core = dd.bitshift_core(left, self._shift, dt.bits)
            if dt.is_signed and left:
                # numpy signed << wraps two's complement; >> is
                # arithmetic shift == floor division (already exact)
                core = dd.signed_wrap(core, dt.bits)

            def step(carry, x):
                return carry, core(x)

            return (), step

        def fuse_import(self, carry):
            pass

        def work(self):
            port = self.input(0)
            n = port.elements()
            if n == 0:
                return
            x = np.asarray(port.buffer(n))
            out = (x << self._shift) if left else (x >> self._shift)
            port.consume(n)
            self.output(0).post(out.astype(dt.np))

    return _Shift()


# ---------------------------------------------------------------------- #
# Byte order (reference: digital/ByteOrder.cpp + ByteOrder.hpp)
# ---------------------------------------------------------------------- #
_BYTE_ORDER_OPTS = ("Swap Order", "Big Endian", "Little Endian",
                    "Network to Host", "Host to Network")


@register_block("/comms/byte_order")
class ByteOrderBlock(Block):
    DOC = {
        "category": "/Digital",
        "keywords": ["byte", "order", "endian", "swap"],
        "params": {
            "byte_order": {
                "label": "Byte Order",
                "options": [
                    {"label": "Swap", "value": "SWAP"},
                    {"label": "Native", "value": "NATIVE"},
                    {"label": "Big Endian", "value": "BIG"},
                    {"label": "Little Endian", "value": "LITTLE"},
                ],
                "default": "SWAP",
            },
        },
    }

    """Endian swap of each element; float/double via uint reinterpret,
    complex componentwise (reference: digital/ByteOrder.hpp:25-115)."""

    def __init__(self, dtype="uint32"):
        super().__init__()
        self.dtype = DType.parse(dtype)
        if self.dtype.bits == 8 and not self.dtype.is_complex:
            raise ValueError("byte_order requires multi-byte elements")
        self.setup_input(0, self.dtype)
        self.setup_output(0, self.dtype)
        self._order = "Swap Order"

    def set_byte_order(self, order: str):
        if order not in _BYTE_ORDER_OPTS:
            raise ValueError(f"invalid byte order {order!r}")
        self._order = order
        self._bump_fuse_epoch()

    def get_byte_order(self) -> str:
        return self._order

    def _should_swap(self) -> bool:
        host_le = sys.byteorder == "little"
        o = self._order
        if o == "Swap Order":
            return True
        if o == "Big Endian":
            return host_le
        if o == "Little Endian":
            return not host_le
        # network order is big endian
        return host_le

    def work(self):
        port = self.input(0)
        n = port.elements()
        if n == 0:
            return
        buf = np.asarray(port.buffer(n))
        out = buf.byteswap() if self._should_swap() else buf.copy()
        port.consume(n)
        self.output(0).post(out)

    # -- auto-fusion: 16-bit endian swap on integer-f32 planes ---------- #
    # (32/64-bit elements exceed f32 integer exactness and stream on
    # the host instead; complex_int16 swaps each plane.)
    def fuse_ready(self) -> bool:
        return self.dtype.is_integer and self.dtype.scalar.bits == 16

    def fuse_label_adjust(self, lb):
        return lb

    def fuse_export(self, channels: int):
        swap = self._should_swap()
        core = dd.byteswap16_core()
        if self.dtype.is_signed:
            core = dd.signed_wrap(core, 16)

        def step(carry, x):
            return carry, (core(x) if swap else x)

        return (), step

    def fuse_import(self, carry) -> None:
        pass
