"""Fused math blocks in the port against the JAX package: the cases of
tests/test_digital_fusion.py that waited for the math catalog — a
label-opaque Scale run, the fan-in Arithmetic -> FFT and Comparator
segments, ModF's two-output tail and the complex_int16 FFT under fusion —
and every fusable math block engaged on the CPU against its streaming
path.

Inputs are explicit float32/complex64/int16 arrays from
numpy.random.default_rng(seed). Integer and comparator outputs are held
bit for bit (fused against streaming, and against the JAX package; the
int16 FFT's ties are the one exception, explained at its test); float
spectra within 2e-4 absolute of unit-variance input (the JAX test's
bound); each fused float core within the bound the CPU parity tests of
tests/test_torch_math.py hold its streaming path to.
"""

import zlib

import numpy as np
import pytest
import torch

import pothoscomms_tpu as jpkg
import pothoscomms_tpu.core.fixtures as jfix
import pothoscomms_tpu_torch as pkg
import pothoscomms_tpu_torch.core.fixtures as fix
from pothoscomms_tpu_torch.core.testing import (FUSED_MATH_CASES,
                                                fused_math_agree,
                                                fused_math_feeds,
                                                fused_math_run)

torch.set_num_threads(1)

THRESH = 4096
PACKAGES = {"port": (pkg, fix), "jax": (jpkg, jfix)}


def run(which, build, feeds, fuse, dtype_in, dtype_out, outs=(0,)):
    """feeders (one per feed list) -> build(package) -> collectors (one per
    output in ``outs``); returns ([buffers], topology)."""
    p, fx = PACKAGES[which]
    blocks = build(p)
    topo = p.Topology(device="cpu") if p is pkg else p.Topology()
    topo.auto_fuse = fuse
    topo.fuse_threshold = THRESH
    for i, feed in enumerate(feeds):
        f = fx.FeederSource(dtype_in)
        for item in feed:
            if isinstance(item, tuple):
                f.feed_buffer(item[0], [p.Label(*lb) for lb in item[1]])
            else:
                f.feed_buffer(item)
        topo.connect(f, 0, blocks[0], i)
    for a, b in zip(blocks[:-1], blocks[1:]):
        topo.connect(a, 0, b, 0)
    sinks = []
    for o in outs:
        s = fx.CollectorSink(dtype_out)
        topo.connect(blocks[-1], o, s, 0)
        sinks.append(s)
    topo.commit()
    assert topo.wait_inactive(timeout=30.0)
    return [s.get_buffer() for s in sinks], topo


def parity(build, feeds, dtype_in, dtype_out, atol=None, outs=(0,)):
    """Port fused == port streaming == JAX fused == JAX streaming (bit
    for bit, or within ``atol``); returns the port's fused topology."""
    got, topo = run("port", build, feeds, True, dtype_in, dtype_out, outs)
    refs = [run("port", build, feeds, False, dtype_in, dtype_out, outs)[0],
            run("jax", build, feeds, True, dtype_in, dtype_out, outs)[0],
            run("jax", build, feeds, False, dtype_in, dtype_out, outs)[0]]
    for ref in refs:
        for g, r in zip(got, ref):
            assert g.shape == r.shape
            if atol is None:
                np.testing.assert_array_equal(g, r)
            else:
                np.testing.assert_allclose(g, r, atol=atol)
    assert topo._segments and topo._segments[0].fused_elements > 0
    return topo


rng = np.random.default_rng(99)


def test_label_opaque_segment_still_disengages():
    """A Scale-bearing run (label-driven factor) is NOT label
    transparent: it fuses up to the label and streams the labeled
    region, as the JAX package does."""
    def build(p):
        sc = p.BlockRegistry.make("/comms/scale", "float32")
        sc.set_factor(2.0)
        return [sc, p.BlockRegistry.make("/comms/abs", "float32")]

    x = rng.normal(size=3 * THRESH).astype(np.float32)
    topo = parity(build, [[(x, [("f", 0.5, 5000)])]], "float32", "float32",
                  atol=0.0)
    assert not topo._segments[0].label_transparent


def test_fanin_arithmetic_fft_single_segment():
    nb = 256

    def build(p):
        return [p.BlockRegistry.make("/comms/arithmetic", "complex_float32",
                                     "ADD"),
                p.BlockRegistry.make("/comms/fft", "complex_float32", nb,
                                     False)]

    n = 4 * THRESH
    a = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
    b = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
    topo = parity(build, [[a], [b]], "complex_float32", "complex_float32",
                  atol=2e-4)
    seg = topo._segments[0]
    assert len(seg.blocks) == 2 and len(seg.heads) == 2


@pytest.mark.parametrize("op", ["SUB", "MUL", "DIV"])
def test_fanin_complex_arithmetic_ops(op):
    def build(p):
        return [p.BlockRegistry.make("/comms/arithmetic", "complex_float32",
                                     op),
                p.BlockRegistry.make("/comms/conjugate", "complex_float32")]

    n = 3 * THRESH
    a = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
    b = (rng.normal(size=n) + 1j * rng.normal(size=n) + 3).astype(
        np.complex64)
    parity(build, [[a], [b]], "complex_float32", "complex_float32",
           atol=1e-5)


def test_fanin_comparator_segment():
    def build(p):
        return [p.BlockRegistry.make("/comms/comparator", "float32", ">"),
                p.BlockRegistry.make("/comms/bitwise_unary", "int8", "NOT")]

    n = 4 * THRESH
    a = rng.normal(size=n).astype(np.float32)
    b = rng.normal(size=n).astype(np.float32)
    (got,), _ = run("port", build, [[a], [b]], True, "float32", "int8")
    parity(build, [[a], [b]], "float32", "int8")
    np.testing.assert_array_equal(got, (~(a > b).astype(np.int8)))


def test_modf_fused_two_output_tail():
    def build(p):
        return [p.BlockRegistry.make("/comms/abs", "float32"),
                p.BlockRegistry.make("/comms/modf", "float32")]

    x = (rng.normal(size=4 * THRESH) * 10).astype(np.float32)
    topo = parity(build, [[x]], "float32", "float32", atol=1e-6,
                  outs=("int", "frac"))
    seg = topo._segments[0]
    assert [o.name for o in seg.tail_outs] == ["int", "frac"]


def test_int16_fft_chain_fused_bit_exact():
    """complex_int16 byte_order -> FFT engages as a fused segment; the
    int16 FFT rounds a complex64 FFT per the kiss FIXED_POINT contract on
    the host in both paths, so fused and streaming are bit-identical, in
    the port as in the JAX package. Between the two packages the complex64
    FFTs are different libraries (torch's pocketfft, XLA's DUCC): a value
    within float32 error of a half-integer may round either way, and does
    at 9 of 65536 outputs here. Every such point is held: off by one, and
    within 1e-3 of a tie by the float64 FFT."""
    nb = 64

    def build(p):
        bo = p.BlockRegistry.make("/comms/byte_order", "complex_int16")
        bo.set_byte_order("Swap Order")
        return [bo, p.BlockRegistry.make("/comms/fft", "complex_int16", nb,
                                         False)]

    x = rng.integers(-500, 500, (8 * THRESH, 2)).astype(np.int16)
    outs = {(w, f): run(w, build, [[x]], f, "complex_int16",
                        "complex_int16")[0][0]
            for w in ("port", "jax") for f in (True, False)}
    for w in ("port", "jax"):
        np.testing.assert_array_equal(outs[(w, True)], outs[(w, False)])
    got, exp = outs[("port", True)], outs[("jax", False)]
    swapped = x.view(np.uint8).reshape(-1, 2, 2)[..., ::-1].copy() \
        .view(np.int16).reshape(-1, 2)
    z = (swapped[:, 0] + 1j * swapped[:, 1].astype(np.float64)).reshape(
        -1, nb)
    y = np.fft.fft(z, axis=-1) / nb
    f64 = np.stack([y.real, y.imag], -1).reshape(-1, 2)
    off = got != exp
    assert off.sum() <= 16
    assert np.all(np.abs(got[off].astype(int) - exp[off]) == 1)
    assert np.all(np.abs(np.abs(f64[off] - np.floor(f64[off])) - 0.5)
                  < 1e-3)


# ------------------------------------------------------------------ #
# every fusable math block, engaged, against its streaming path
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("name", list(FUSED_MATH_CASES))
def test_fusable_block_engaged_matches_streaming(name, record_property):
    """core/testing.py's case: the block and an exact hop as a fused run
    on the CPU, against the same topology streaming (bit for bit where
    the case says so, else within its bound)."""
    feeds = fused_math_feeds(name, 3 * THRESH + 17,
                             zlib.crc32(name.encode()))
    got, topo = fused_math_run(name, feeds, fuse=True, threshold=THRESH)
    ref, _ = fused_math_run(name, feeds, fuse=False, threshold=THRESH)
    assert topo._segments[0].fused_elements >= 2 * THRESH
    record_property("max_abs_diff", fused_math_agree(name, got, ref))


def test_fusable_catalog_is_complete():
    """Every math path whose block fuses at float32 or complex_float32
    has a case in core/testing.FUSED_MATH_CASES."""
    from pothoscomms_tpu_torch.core import registry as preg

    fusable = set()
    for path, factory in preg._REGISTRY.items():
        if getattr(factory, "__module__", "") \
                != "pothoscomms_tpu_torch.blocks.math" \
                or not path.startswith("/comms/"):
            continue
        name = path.split("/")[-1]
        args = {"arithmetic": ("ADD",), "comparator": (">",),
                "const_comparator": (">", 0.0),
                "const_arithmetic": ("X+K", 0.0),
                "trigonometric": ("SIN",)}.get(name, ())
        for dt in ("float32", "complex_float32"):
            try:
                blk = pkg.BlockRegistry.make(path, dt, *args)
            except ValueError:
                continue
            if blk.fuse_ready():
                fusable.add(name)
    assert fusable == set(FUSED_MATH_CASES)
