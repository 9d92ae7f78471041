"""The port's digital symbol layer — the conversion blocks, mapper and
slicer, differential coding, scrambler and descrambler, the bitwise family,
byte order, the C++ LFSR, the GF(2) blocked scrambler and label-transparent
fusion — against the JAX package on the same feeds (the cases of
tests/test_digital.py, tests/test_gf2.py and the digital-only cases of
tests/test_digital_fusion.py).

Inputs are explicit uint8 / int8 / int16 / uint16 / float32 / complex64
arrays from numpy.random.default_rng(seed) (JAX x64 is on in the tests).
Every comparison is bit-exact: the streaming paths are the same numpy
code, and the device cores are exact integer arithmetic (ops/
digital_device.py) or exact 0/1 float32 products (ops/gf2.py); the
slicer's float32 distances are those of the JAX core on the same inputs.
"""

import numpy as np
import pytest
import torch

import pothoscomms_tpu as jpkg
import pothoscomms_tpu.core.fixtures as jfix
import pothoscomms_tpu_torch as pkg
import pothoscomms_tpu_torch.core.fixtures as fix
from pothoscomms_tpu.ops import digital_device as jdd
from pothoscomms_tpu.ops import gf2 as jgf2
from pothoscomms_tpu_torch import native
from pothoscomms_tpu_torch.ops import bits as bops
from pothoscomms_tpu_torch.ops import digital_device as dd
from pothoscomms_tpu_torch.ops import gf2
from tests.test_digital import (bits_to_symbols_oracle, lfsr_oracle,
                                symbols_to_bits_oracle)

torch.set_num_threads(1)

PACKAGES = {"port": (pkg, fix), "jax": (jpkg, jfix)}
THRESH = 4096  # low fuse threshold so the fused tests engage on small data
QPSK = np.array([1 + 1j, -1 + 1j, -1 - 1j, 1 - 1j]) / np.sqrt(2)


def run_chain(which, build, feeds, dtype_in="uint8", dtype_out="uint8",
              fuse=False, threshold=THRESH):
    """feeder -> build(package) -> collector in one package; each feed is
    an array or (array, labels). Returns (sink, topology)."""
    p, fx = PACKAGES[which]
    blocks = build(p)
    feed = fx.FeederSource(dtype_in)
    sink = fx.CollectorSink(dtype_out)
    topo = p.Topology(device="cpu") if p is pkg else p.Topology()
    topo.auto_fuse = fuse
    topo.fuse_threshold = threshold
    chain = [feed] + blocks + [sink]
    for a, b in zip(chain[:-1], chain[1:]):
        topo.connect(a, 0, b, 0)
    for item in feeds:
        if isinstance(item, tuple):
            lbs = [(p.Label(lb.id, lb.data, lb.index, lb.width))
                   for lb in item[1]]
            feed.feed_buffer(item[0], lbs)
        else:
            feed.feed_buffer(item)
    topo.commit()
    assert topo.wait_inactive(timeout=60.0)
    return sink, topo


def _labels(sink):
    return [(lb.id, lb.data, lb.index, lb.width) for lb in sink.get_labels()]


def both(build, feeds, **kw):
    """The port's and the JAX package's outputs, equal bit for bit with
    equal labels; returns (port sink, port topology)."""
    got, topo = run_chain("port", build, feeds, **kw)
    exp, _ = run_chain("jax", build, feeds, **kw)
    g, e = got.get_buffer(), exp.get_buffer()
    assert g.dtype == e.dtype and g.shape == e.shape
    np.testing.assert_array_equal(g, e)
    assert _labels(got) == _labels(exp)
    return got, topo


def blocks(*specs):
    """build(p) from (path, args, setters) triples."""
    def build(p):
        out = []
        for path, args, sets in specs:
            b = p.BlockRegistry.make(path, *args)
            for name, value in sets:
                getattr(b, name)(value)
            out.append(b)
        return out
    return build


def test_digital_blocks_registered_under_jax_names():
    paths = [p for p in jpkg.BlockRegistry.paths()
             if p.split("/")[-1] in {
                 "bits_to_symbols", "symbols_to_bits", "symbols_to_bytes",
                 "bytes_to_symbols", "symbol_mapper", "symbol_slicer",
                 "differential_encoder", "differential_decoder",
                 "scrambler", "descrambler", "bitwise_unary",
                 "bitwise_binary", "const_bitwise_binary", "bitshift",
                 "byte_order"}]
    assert len([p for p in paths if p.startswith("/comms/")]) == 15
    for path in paths:
        assert pkg.BlockRegistry.exists(path), path


# ---------------------------------------------------------------------- #
# conversions (tests/test_digital.py:72-166)
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("order", ["LSBit", "MSBit"])
@pytest.mark.parametrize("width", range(1, 9))
def test_pack_kernels_match_reference_loops(width, order):
    rng = np.random.default_rng(width)
    bits = rng.integers(0, 2, 24 * 8).astype(np.uint8)
    syms = bops.bits_to_symbols(bits, width, order)
    np.testing.assert_array_equal(
        syms, bits_to_symbols_oracle(width, bits, order))
    back = bops.symbols_to_bits(syms, width, order)
    np.testing.assert_array_equal(
        back, symbols_to_bits_oracle(width, syms, order))


@pytest.mark.parametrize("order", ["LSBit", "MSBit"])
@pytest.mark.parametrize("width", range(1, 9))
def test_bytes_symbols_roundtrip(width, order):
    rng = np.random.default_rng(width + 10)
    data = rng.integers(0, 256, bops.group_bytes(width) * 24).astype(np.uint8)
    syms = bops.bytes_to_symbols(data, width, order)
    assert np.all(syms < (1 << width))
    back = bops.symbols_to_bytes(syms, width, order)
    np.testing.assert_array_equal(data[: len(back)], back)


@pytest.mark.parametrize("order", ["LSBit", "MSBit"])
@pytest.mark.parametrize("width", range(1, 9))
def test_bit_symbol_block_roundtrip(width, order):
    bits = np.random.default_rng(width + 20).integers(
        0, 2, width * 50).astype(np.uint8)
    sink, _ = both(blocks(("/comms/bits_to_symbols", (width, order), ()),
                          ("/comms/symbols_to_bits", (width, order), ())),
                   [bits])
    np.testing.assert_array_equal(sink.get_buffer(), bits)


@pytest.mark.parametrize("order", ["LSBit", "MSBit"])
@pytest.mark.parametrize("width", range(1, 9))
def test_symbol_byte_block_roundtrip(width, order):
    syms = np.random.default_rng(width + 30).integers(
        0, 1 << width, bops.group_symbols(width) * 24).astype(np.uint8)
    sink, _ = both(blocks(("/comms/symbols_to_bytes", (width, order), ()),
                          ("/comms/bytes_to_symbols", (width, order), ())),
                   [syms])
    np.testing.assert_array_equal(sink.get_buffer(), syms)


def test_three_stage_loop():
    bits = np.random.default_rng(42).integers(0, 2, 24 * 8).astype(np.uint8)
    a = (3, "MSBit")
    sink, _ = both(blocks(("/comms/bits_to_symbols", a, ()),
                          ("/comms/symbols_to_bytes", a, ()),
                          ("/comms/bytes_to_symbols", a, ()),
                          ("/comms/symbols_to_bits", a, ())), [bits])
    np.testing.assert_array_equal(sink.get_buffer(), bits)


def test_conversion_label_rescale():
    sink, _ = both(blocks(("/comms/bits_to_symbols", (4, "MSBit"), ())),
                   [(np.ones(32, np.uint8), [pkg.Label("mark", None, 8)])])
    assert sink.get_labels()[0].index == 2  # 8 bits / 4 per symbol


def test_conversion_packet_mode():
    payload = np.array([1, 0, 1, 1, 0, 1, 0, 0], np.uint8)
    outs = []
    for p, fx in (PACKAGES["port"], PACKAGES["jax"]):
        feed = fx.FeederSource("uint8")
        feed.feed_packet(p.Packet(payload, labels=[p.Label("x", None, 4)]))
        b2s = p.BlockRegistry.make("/comms/bits_to_symbols", 2, "MSBit")
        sink = fx.CollectorSink("uint8")
        topo = p.Topology(device="cpu") if p is pkg else p.Topology()
        topo.connect(feed, 0, b2s, 0)
        topo.connect(b2s, 0, sink, 0)
        topo.commit()
        assert topo.wait_inactive()
        assert len(sink.packets) == 1
        outs.append(sink.packets[0])
    np.testing.assert_array_equal(outs[0].payload,
                                  bops.bits_to_symbols(payload, 2, "MSBit"))
    np.testing.assert_array_equal(outs[0].payload, outs[1].payload)
    assert outs[0].labels[0].index == outs[1].labels[0].index == 2


# ---------------------------------------------------------------------- #
# mapper / slicer (tests/test_digital.py:172-216)
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype,table", [
    ("float32", [-1, 1]),
    ("complex_float32", [-1 - 1j, -1 + 1j, 1 + 1j, 1 - 1j])])
def test_mapper_slicer_roundtrip(dtype, table):
    syms = np.random.default_rng(len(table)).integers(
        0, len(table), 128).astype(np.uint8)
    sink, _ = both(blocks(("/comms/symbol_mapper", (dtype,),
                           (("set_map", table),)),
                          ("/comms/symbol_slicer", (dtype,),
                           (("set_map", table),))), [syms])
    np.testing.assert_array_equal(sink.get_buffer(), syms)


def test_mapper_validation():
    mapper = pkg.BlockRegistry.make("/comms/symbol_mapper", "float32")
    with pytest.raises(ValueError):
        mapper.set_map([])
    with pytest.raises(ValueError):
        mapper.set_map([1, 2, 3])  # not a power of two


# ---------------------------------------------------------------------- #
# differential coding (tests/test_digital.py:222-265)
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("symbols", [2, 4, 8, 256])
def test_differential_roundtrip(symbols):
    data = np.random.default_rng(symbols).integers(
        0, symbols, 200).astype(np.uint8)
    sets = (("set_symbols", symbols),)
    sink, _ = both(blocks(("/comms/differential_encoder", (), sets),
                          ("/comms/differential_decoder", (), sets)),
                   [data[:33], data[33:66], data[66:]])
    np.testing.assert_array_equal(sink.get_buffer(), data)


def test_differential_encoder_oracle():
    data = np.array([1, 0, 1, 1, 1, 0], np.uint8)
    sink, _ = both(blocks(("/comms/differential_encoder", (),
                           (("set_symbols", 2),))), [data])
    last, exp = 0, []
    for v in data:
        last = (int(v) + last + 2) % 2
        exp.append(last)
    np.testing.assert_array_equal(sink.get_buffer(), np.array(exp, np.uint8))


# ---------------------------------------------------------------------- #
# scrambler / descrambler on the C++ LFSR (tests/test_digital.py:292-334)
# ---------------------------------------------------------------------- #
def test_additive_scrambler_keystream_oracle():
    data = np.random.default_rng(4).integers(0, 2, 300).astype(np.uint8)
    sink, _ = both(blocks(("/comms/scrambler", (),
                           (("set_mode", "additive"), ("set_poly", 0x19),
                            ("set_seed", 1)))), [data])
    np.testing.assert_array_equal(sink.get_buffer(),
                                  data ^ lfsr_oracle(0x19, 1, len(data)))


@pytest.mark.parametrize("mode", ["additive", "multiplicative"])
@pytest.mark.parametrize("poly", [0x19, 0x83, 0x20001])
def test_scrambler_descrambler_roundtrip(mode, poly):
    data = np.random.default_rng(poly).integers(0, 2, 400).astype(np.uint8)
    sets = (("set_mode", mode), ("set_poly", poly), ("set_seed", 0x5A))
    sink, _ = both(blocks(("/comms/scrambler", (), sets),
                          ("/comms/descrambler", (), sets)), [data])
    skip = 0 if mode == "additive" else 64  # self-synchronising flush
    np.testing.assert_array_equal(sink.get_buffer()[skip:], data[skip:])


def test_scrambler_validation():
    scr = pkg.BlockRegistry.make("/comms/scrambler")
    with pytest.raises(ValueError):
        scr.set_mode("bogus")
    with pytest.raises(ValueError):
        scr.set_sync("01x")
    with pytest.raises(ValueError):
        scr.set_sync("0" * 65)


def test_scrambler_state_carried_from_jax_mid_stream():
    """A JAX scrambler's integer LFSR state, carried into the port's block
    in the middle of a stream through the bit-plane export, makes the two
    go on producing equal output."""
    data = np.random.default_rng(8).integers(0, 2, 700).astype(np.uint8)
    for mode in ("additive", "multiplicative"):
        jscr = jpkg.BlockRegistry.make("/comms/scrambler")
        pscr = pkg.BlockRegistry.make("/comms/scrambler")
        for b in (jscr, pscr):
            b.set_mode(mode)
            b.set_poly(0x8E)
            b.set_seed(0x6F)
        first = (jscr._lfsr.keystream(300) if mode == "additive"
                 else jscr._lfsr.scramble_mult(data[:300]))
        assert first.shape == (300,)
        pscr._lfsr.data = gf2.import_state(
            jgf2.export_state(jscr._lfsr.data))
        if mode == "additive":
            got, exp = pscr._lfsr.keystream(400), jscr._lfsr.keystream(400)
        else:
            got = pscr._lfsr.scramble_mult(data[300:])
            exp = jscr._lfsr.scramble_mult(data[300:])
        np.testing.assert_array_equal(got, exp)
        assert pscr._lfsr.data == jscr._lfsr.data


# ---------------------------------------------------------------------- #
# bitwise and byte order (tests/test_digital.py:340-483)
# ---------------------------------------------------------------------- #
def test_bitwise_unary_not():
    data = np.array([0x0F, 0xF0, 0xAA], np.uint8)
    sink, _ = both(blocks(("/comms/bitwise_unary", ("uint8", "NOT"), ())),
                   [data])
    np.testing.assert_array_equal(sink.get_buffer(), ~data)


@pytest.mark.parametrize("op,fcn", [("AND", np.bitwise_and),
                                    ("OR", np.bitwise_or),
                                    ("XOR", np.bitwise_xor)])
def test_bitwise_binary_three_port(op, fcn):
    rng = np.random.default_rng(5)
    a, b, c = (rng.integers(0, 1 << 15, 64).astype(np.int16)
               for _ in range(3))
    outs = []
    for p, fx in PACKAGES.values():
        blk = p.BlockRegistry.make("/comms/bitwise_binary", "int16", op, 3)
        topo = p.Topology(device="cpu") if p is pkg else p.Topology()
        for i, arr in enumerate((a, b, c)):
            f = fx.FeederSource("int16")
            f.feed_buffer(arr)
            topo.connect(f, 0, blk, i)
        sink = fx.CollectorSink("int16")
        topo.connect(blk, 0, sink, 0)
        topo.commit()
        assert topo.wait_inactive()
        outs.append(sink.get_buffer())
    np.testing.assert_array_equal(outs[0], fcn(fcn(a, b), c))
    np.testing.assert_array_equal(outs[0], outs[1])


def test_const_bitwise_and_bitshift():
    data = np.arange(16, dtype=np.uint16)
    sink, _ = both(blocks(("/comms/const_bitwise_binary",
                           ("uint16", 0x3, "AND"), ())), [data],
                   dtype_in="uint16", dtype_out="uint16")
    np.testing.assert_array_equal(sink.get_buffer(), data & 0x3)
    sink, _ = both(blocks(("/comms/bitshift", ("uint16", "LEFTSHIFT", 3),
                           ())), [data], dtype_in="uint16",
                   dtype_out="uint16")
    np.testing.assert_array_equal(sink.get_buffer(),
                                  (data << 3).astype(np.uint16))
    with pytest.raises(ValueError):
        pkg.BlockRegistry.make("/comms/bitshift", "uint16", "LEFTSHIFT", 16)
    with pytest.raises(ValueError):
        pkg.BlockRegistry.make("/comms/bitwise_binary", "float32", "AND", 2)


def test_arithmetic_right_shift_signed():
    data = np.array([-64, -8, 8, 64], np.int8)
    sink, _ = both(blocks(("/comms/bitshift", ("int8", "RIGHTSHIFT", 2),
                           ())), [data], dtype_in="int8", dtype_out="int8")
    np.testing.assert_array_equal(sink.get_buffer(), data >> 2)


@pytest.mark.parametrize("dtype,np_dtype", [("uint16", np.uint16),
                                            ("uint32", np.uint32),
                                            ("int64", np.int64),
                                            ("float32", np.float32),
                                            ("float64", np.float64)])
def test_byte_order_swap(dtype, np_dtype):
    rng = np.random.default_rng(6)
    if np.issubdtype(np_dtype, np.floating):
        data = rng.normal(size=32).astype(np_dtype)
    else:
        data = rng.integers(0, 1 << 15, 32).astype(np_dtype)
    sink, _ = both(blocks(("/comms/byte_order", (dtype,),
                           (("set_byte_order", "Swap Order"),))), [data],
                   dtype_in=dtype, dtype_out=dtype)
    np.testing.assert_array_equal(sink.get_buffer(), data.byteswap())


def test_byte_order_host_modes():
    import sys

    data = np.arange(8, dtype=np.uint32)
    sink, _ = both(blocks(("/comms/byte_order", ("uint32",),
                           (("set_byte_order", "Little Endian"),))), [data],
                   dtype_in="uint32", dtype_out="uint32")
    exp = data if sys.byteorder == "little" else data.byteswap()
    np.testing.assert_array_equal(sink.get_buffer(), exp)
    blk = pkg.BlockRegistry.make("/comms/byte_order", "uint32")
    with pytest.raises(ValueError):
        blk.set_byte_order("bogus")
    with pytest.raises(ValueError):
        pkg.BlockRegistry.make("/comms/byte_order", "uint8")


def test_byte_order_roundtrip_complex():
    rng = np.random.default_rng(7)
    data = (rng.normal(size=16) + 1j * rng.normal(size=16)).astype(
        np.complex64)
    bo = ("/comms/byte_order", ("complex_float32",), ())
    sink, _ = both(blocks(bo, bo), [data], dtype_in="complex_float32",
                   dtype_out="complex_float32")
    np.testing.assert_array_equal(sink.get_buffer(), data)


# ---------------------------------------------------------------------- #
# the C++ host kernels (tests/test_digital.py:489-525)
# ---------------------------------------------------------------------- #
def test_native_lfsr_matches_python():
    from pothoscomms_tpu_torch.blocks.digital import GaloisLFSR

    rng = np.random.default_rng(12)
    for poly, seed in [(0x19, 1), (0x20001, 0x5A), (0x83, 0xFFFF)]:
        np.testing.assert_array_equal(
            native.NativeLfsr(poly, seed).keystream(500),
            GaloisLFSR(poly, seed).keystream(500))
        bits = rng.integers(0, 2, 300).astype(np.uint8)
        for name in ("scramble_mult", "descramble_mult"):
            nat, py = native.NativeLfsr(poly, seed), GaloisLFSR(poly, seed)
            np.testing.assert_array_equal(getattr(nat, name)(bits),
                                          getattr(py, name)(bits))
            assert nat.data == py.data


def test_native_crc8_and_checksum8():
    from pothoscomms_tpu.blocks.framing import checksum8

    rng = np.random.default_rng(13)
    for n in (1, 7, 100, 1000):
        data = rng.integers(0, 256, n).astype(np.uint8)
        crc = 0
        for b in data:
            crc ^= int(b) << 8
            for _ in range(8):
                if crc & 0x8000:
                    crc ^= 0x1070 << 3
                crc = (crc << 1) & 0xFFFFFF
        assert native.crc8(data) == (crc >> 8) & 0xFF
        assert native.checksum8(data) == checksum8(data)


# ---------------------------------------------------------------------- #
# GF(2) blocked scrambler and the device cores (tests/test_gf2.py)
# ---------------------------------------------------------------------- #
def _jax_blocked(poly, mode, Lb, s0, x):
    import jax.numpy as jnp

    V, Lst, G, Ab, auto = jgf2.lfsr_blocked_operators(poly, mode, Lb)
    f32 = [jnp.asarray(a, jnp.float32) for a in (V, Lst, G, Ab)]
    s1, o = jgf2.lfsr_blocked_step(jnp.asarray(s0), jnp.asarray(x), *f32,
                                   auto)
    return np.asarray(s1), np.asarray(o)


@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("mode", ["additive", "scramble", "descramble"])
@pytest.mark.parametrize("poly,seed", [(0x19, 1), (0x8E, 0x6F),
                                       ((1 << 31) | (1 << 3) | 1, 12345)])
def test_blocked_lfsr_equals_jax_and_streaming(C, mode, poly, seed):
    """lfsr_blocked_step's doubling scan equals the JAX associative scan
    bit for bit, and the bit-serial LFSR, per channel."""
    Lb, B = 64, 7
    rng = np.random.default_rng(poly + C)
    x = rng.integers(0, 2, (C, Lb * B)).astype(np.float32)
    seeds = [seed + 977 * c for c in range(C)]
    s0 = np.stack([gf2.export_state(s) for s in seeds])
    ops, auto = gf2.step_operators(poly, mode, Lb, "cpu")
    s1, o = gf2.lfsr_blocked_step(torch.from_numpy(s0), torch.from_numpy(x),
                                  *ops, auto)
    js1, jo = _jax_blocked(poly, mode, Lb, s0, x)
    np.testing.assert_array_equal(o.numpy(), jo)
    np.testing.assert_array_equal(s1.numpy(), js1)
    from pothoscomms_tpu_torch.blocks.digital import GaloisLFSR

    for c in range(C):
        lf = GaloisLFSR(poly, seeds[c])
        xb = x[c].astype(np.uint8)
        ref = (xb ^ lf.keystream(len(xb)) if mode == "additive" else
               getattr(lf, f"{mode}_mult")(xb))
        np.testing.assert_array_equal(o[c].numpy().astype(np.uint8), ref)
        assert gf2.import_state(s1[c].numpy()) == lf.data


def test_blocked_operators_equal_jax():
    for mode in ("additive", "scramble", "descramble"):
        for a, b in zip(gf2.lfsr_blocked_operators(0x8E, mode, 32),
                        jgf2.lfsr_blocked_operators(0x8E, mode, 32)):
            np.testing.assert_array_equal(a, b)


def _f32(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def test_signed_bitwise_wrap_exact():
    import jax.numpy as jnp

    rng = np.random.default_rng(11)
    a = rng.integers(-128, 128, 500).astype(np.int8)
    b = rng.integers(-128, 128, 500).astype(np.int8)
    af, bf = a[None].astype(np.float32), b[None].astype(np.float32)
    cases = [(dd.signed_wrap(dd.bitwise_binary_core(op, 8), 8, nargs=2),
              jdd.signed_wrap(jdd.bitwise_binary_core(op, 8), 8, nargs=2),
              (af, bf)) for op in ("AND", "OR", "XOR")]
    cases += [(dd.signed_wrap(dd.bitwise_not_core(8), 8),
               jdd.signed_wrap(jdd.bitwise_not_core(8), 8), (af,)),
              (dd.signed_wrap(dd.bitshift_core(True, 3, 8), 8),
               jdd.signed_wrap(jdd.bitshift_core(True, 3, 8), 8), (af,)),
              (dd.bitshift_core(False, 2, 8), jdd.bitshift_core(False, 2, 8),
               (af,))]
    for core, jcore, args in cases:
        got = core(*[_f32(v) for v in args]).numpy()
        exp = np.asarray(jcore(*[jnp.asarray(v) for v in args]))
        np.testing.assert_array_equal(got, exp)
    np.testing.assert_array_equal(cases[0][0](_f32(af), _f32(bf)).numpy()
                                  .astype(np.int8)[0], a & b)


def test_diff_decode_uint32_wrap_semantics():
    import jax.numpy as jnp

    N, last = 3, 250
    x = np.array([0, 255, 0, 7, 200], np.uint8)
    c, y = dd.diff_decode_core(N)(torch.full((1, 1), float(last)),
                                  _f32(x[None]))
    _, jy = jdd.diff_decode_core(N)(jnp.full((1, 1), float(last),
                                             jnp.float32),
                                    jnp.asarray(x[None].astype(np.float32)))
    prev = np.concatenate([[last], x[:-1]]).astype(np.int64)
    ref = ((x.astype(np.int64) - prev + N) % (1 << 32)) % N
    np.testing.assert_array_equal(y[0].numpy().astype(np.int64), ref)
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    assert c.item() == 200


def test_diff_encode_core_carries_each_channel():
    """C = 3 channels, each with its own carry: the port's core against a
    per-channel numpy oracle (the JAX core broadcasts its [C, 1] carry
    right only for C = 1; at C = 1 it is held to the JAX core too)."""
    import jax.numpy as jnp

    N = 5
    rng = np.random.default_rng(21)
    x = rng.integers(0, N, (3, 5000)).astype(np.float32)
    carry = np.array([[1.0], [4.0], [0.0]], np.float32)
    c, y = dd.diff_encode_core(N)(_f32(carry), _f32(x))
    ref = (np.cumsum(x.astype(np.int64), axis=1)
           + carry.astype(np.int64)) % N
    np.testing.assert_array_equal(y.numpy().astype(np.int64), ref)
    np.testing.assert_array_equal(c.numpy()[:, 0], ref[:, -1])
    _, jy = jdd.diff_encode_core(N)(jnp.asarray(carry[:1]),
                                    jnp.asarray(x[:1]))
    np.testing.assert_array_equal(y[:1].numpy(), np.asarray(jy))


@pytest.mark.parametrize("width,order", [(1, "LSBit"), (3, "MSBit"),
                                         (8, "LSBit"), (5, "MSBit")])
def test_pack_unpack_mapper_slicer_cores_equal_jax(width, order):
    import jax.numpy as jnp

    rng = np.random.default_rng(width)
    bits = rng.integers(0, 2, (2, width * 96)).astype(np.float32)
    syms = dd.pack_core(width, order)(_f32(bits))
    jsyms = jdd.pack_core(width, order)(jnp.asarray(bits))
    np.testing.assert_array_equal(syms.numpy(), np.asarray(jsyms))
    np.testing.assert_array_equal(
        dd.unpack_core(width, order)(syms).numpy(),
        np.asarray(jdd.unpack_core(width, order)(jsyms)))
    np.testing.assert_array_equal(
        dd.repack_core(width, 8, order)(syms[:, :8 * (96 // 8)]).numpy(),
        np.asarray(jdd.repack_core(width, 8, order)(jsyms[:, :96])))
    table = np.exp(1j * rng.uniform(0, 6, 1 << min(width, 5)))
    idx = rng.integers(0, 256, (2, 300)).astype(np.float32)
    pts = dd.mapper_core(table, True)(_f32(idx))
    np.testing.assert_array_equal(
        pts.numpy(), np.asarray(jdd.mapper_core(table, True)(
            jnp.asarray(idx))))
    noisy = pts.numpy() + rng.normal(0, 0.3, pts.shape).astype(np.float32)
    np.testing.assert_array_equal(
        dd.slicer_core(table, True)(_f32(noisy)).numpy(),
        np.asarray(jdd.slicer_core(table, True)(jnp.asarray(noisy))))


# ---------------------------------------------------------------------- #
# fused segments, labels included (tests/test_digital_fusion.py)
# ---------------------------------------------------------------------- #
def fused_parity(build, feeds, dtype_in="uint8", dtype_out="uint8"):
    """The port's fused segment equals its streaming path and the JAX
    package's fused segment, output and labels; returns (sink, topology)
    of the port's fused run."""
    kw = dict(dtype_in=dtype_in, dtype_out=dtype_out, fuse=True)
    sink, topo = both(build, feeds, **kw)
    stream, _ = run_chain("port", build, feeds, dtype_in=dtype_in,
                          dtype_out=dtype_out, fuse=False)
    np.testing.assert_array_equal(sink.get_buffer(), stream.get_buffer())
    assert _labels(sink) == _labels(stream)
    assert topo._segments and topo._segments[0].fused_elements > 0, \
        "segment never engaged (fused path untested)"
    return sink, topo


rng = np.random.default_rng(99)


@pytest.mark.parametrize("mod", [1, 2, 3, 7, 8])
@pytest.mark.parametrize("order", ["LSBit", "MSBit"])
def test_bits_to_symbols_fused(mod, order):
    bits = np.random.default_rng(mod).integers(0, 2, mod * 8192).astype(
        np.uint8)
    fused_parity(blocks(("/comms/bits_to_symbols", (mod, order), ()),
                        ("/comms/symbols_to_bits", (mod, order), ())), [bits])


@pytest.mark.parametrize("mod", [2, 3, 5, 8])
def test_symbols_bytes_roundtrip_fused(mod):
    syms = np.random.default_rng(mod).integers(
        0, 1 << mod, bops.group_symbols(mod) * 8192).astype(np.uint8)
    fused_parity(blocks(("/comms/symbols_to_bytes", (mod, "MSBit"), ()),
                        ("/comms/bytes_to_symbols", (mod, "MSBit"), ())),
                 [syms])


def test_mapper_slicer_fused():
    idx = np.random.default_rng(3).integers(0, 4, 32768).astype(np.uint8)
    sets = (("set_map", QPSK),)
    fused_parity(blocks(("/comms/symbol_mapper", ("complex_float32",), sets),
                        ("/comms/symbol_slicer", ("complex_float32",), sets)),
                 [idx])


@pytest.mark.parametrize("N", [2, 4, 7])
def test_differential_roundtrip_fused(N):
    x = np.random.default_rng(N).integers(0, N, 40000).astype(np.uint8)
    sets = (("set_symbols", N),)
    # several feeds: engage/disengage cycling must keep the carry exact
    fused_parity(blocks(("/comms/differential_encoder", (), sets),
                        ("/comms/differential_decoder", (), sets)),
                 [x[:17000], x[17000:17003], x[17003:]])


@pytest.mark.parametrize("mode", ["additive", "multiplicative"])
@pytest.mark.parametrize("poly", [0x19, 0x8E, (1 << 31) | (1 << 3) | 1])
def test_scrambler_descrambler_fused(mode, poly):
    bits = np.random.default_rng(poly).integers(
        0, 2, 3 * THRESH + 1024).astype(np.uint8)
    sets = (("set_mode", mode), ("set_poly", poly), ("set_seed", 0x5A5A))
    sink, _ = fused_parity(blocks(("/comms/scrambler", (), sets),
                                  ("/comms/descrambler", (), sets)), [bits])
    got = sink.get_buffer()
    skip = 64 if mode == "multiplicative" else 0
    np.testing.assert_array_equal(got[skip:], bits[skip:len(got)])


def test_scrambler_state_continuity_across_engagements():
    bits = np.random.default_rng(30).integers(0, 2, 30000).astype(np.uint8)
    fused_parity(blocks(("/comms/scrambler", (),
                         (("set_mode", "multiplicative"),
                          ("set_poly", 0x19))),
                        ("/comms/scrambler", (),
                         (("set_mode", "additive"), ("set_poly", 0x8E),
                          ("set_seed", 0x77)))),
                 [bits[:9000], bits[9000:9100], bits[9100:21000],
                  bits[21000:]])


def test_const_bitwise_and_shift_fused():
    x = np.random.default_rng(31).integers(0, 256, 30000).astype(np.uint8)
    fused_parity(blocks(("/comms/const_bitwise_binary",
                         ("uint8", 0x5C, "XOR"), ()),
                        ("/comms/bitshift", ("uint8", "RIGHTSHIFT", 2), ()),
                        ("/comms/bitwise_unary", ("uint8", "NOT"), ())), [x])


def test_int16_byte_order_chain_fused():
    x = np.random.default_rng(32).integers(0, 1 << 16, 30000).astype(
        np.uint16)
    fused_parity(blocks(("/comms/byte_order", ("uint16",),
                         (("set_byte_order", "Swap Order"),)),
                        ("/comms/bitshift", ("uint16", "RIGHTSHIFT", 3), ())),
                 [x], dtype_in="uint16", dtype_out="uint16")


def test_labels_carried_through_fused_digital_segment():
    bits = np.random.default_rng(33).integers(0, 2, 3 * THRESH * 4).astype(
        np.uint8)
    labels = [pkg.Label("frame", data=i, index=3000 * i + 16, width=4)
              for i in range(8)]
    sink, topo = fused_parity(
        blocks(("/comms/scrambler", (), (("set_mode", "additive"),
                                         ("set_poly", 0x8E))),
               ("/comms/bits_to_symbols", (4, "MSBit"), ())),
        [(bits, labels)])
    assert len(sink.get_labels()) == 8
    seg = topo._segments[0]
    assert seg.label_transparent
    assert seg.fused_elements >= 3 * THRESH * 4 - THRESH, \
        "labels should not bound the fused pulls"


def test_label_opaque_segment_still_stops_at_labels():
    """A run with a block that has no label rescale (the FIR) is not
    label-transparent: the fused pulls stop at the label."""
    def build(p):
        fir = p.BlockRegistry.make("/comms/fir_filter", "float32")
        fir.set_taps([0.5, 0.25])
        dcr = p.BlockRegistry.make("/comms/dc_removal", "float32")
        return [fir, dcr]

    x = np.random.default_rng(34).normal(size=3 * THRESH).astype(np.float32)
    _, topo = run_chain("port", build, [(x, [pkg.Label("f", 0.5, 5000)])],
                        dtype_in="float32", dtype_out="float32", fuse=True)
    seg = topo._segments[0]
    assert not seg.label_transparent
    assert seg.fused_elements <= 5000


def test_full_modem_chain_fused_bit_exact():
    bits = np.random.default_rng(35).integers(0, 2, 8 * THRESH).astype(
        np.uint8)
    scr = (("set_mode", "additive"), ("set_poly", 0x8E))
    sets = (("set_map", QPSK),)
    sink, topo = fused_parity(blocks(
        ("/comms/scrambler", (), scr),
        ("/comms/bits_to_symbols", (2, "MSBit"), ()),
        ("/comms/symbol_mapper", ("complex_float32",), sets),
        ("/comms/symbol_slicer", ("complex_float32",), sets),
        ("/comms/symbols_to_bits", (2, "MSBit"), ()),
        ("/comms/descrambler", (), scr)), [bits])
    np.testing.assert_array_equal(sink.get_buffer(), bits)
    assert len(topo._segments) == 1 and len(topo._segments[0].blocks) == 6


def test_bitwise_binary_fanin_fused():
    n = 4 * THRESH
    a = rng.integers(0, 256, n).astype(np.uint8)
    b = rng.integers(0, 256, n).astype(np.uint8)
    outs = []
    for which, fuse in (("port", True), ("port", False), ("jax", True)):
        p, fx = PACKAGES[which]
        f1, f2 = fx.FeederSource("uint8"), fx.FeederSource("uint8")
        bw = p.BlockRegistry.make("/comms/bitwise_binary", "uint8", "XOR", 2)
        nt = p.BlockRegistry.make("/comms/bitwise_unary", "uint8", "NOT")
        sink = fx.CollectorSink("uint8")
        topo = p.Topology(device="cpu") if p is pkg else p.Topology()
        topo.auto_fuse = fuse
        topo.fuse_threshold = THRESH
        topo.connect(f1, 0, bw, 0)
        topo.connect(f2, 0, bw, 1)
        topo.connect(bw, 0, nt, 0)
        topo.connect(nt, 0, sink, 0)
        f1.feed_buffer(a)
        f2.feed_buffer(b)
        topo.commit()
        assert topo.wait_inactive(timeout=30.0)
        if fuse:
            assert topo._segments and topo._segments[0].fused_elements > 0
        outs.append(sink.get_buffer())
    for o in outs[1:]:
        np.testing.assert_array_equal(outs[0], o)
    np.testing.assert_array_equal(outs[0], (~(a ^ b)).astype(np.uint8))
