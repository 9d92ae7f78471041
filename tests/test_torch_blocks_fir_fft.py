"""The port's /comms/fir_filter and /comms/fft blocks, streaming, against
the JAX package's blocks on the same feeds (the cases of
tests/test_filter.py and tests/test_sources_fft.py for these blocks).

Inputs are made with numpy.random.default_rng(seed). Tolerances:
integer and Q-format outputs bit-exact (complex_int16 FFT included);
float64 outputs within 1e-9 of max |y|; float32 outputs within 1e-5 of
max |y| (float32 sums and FFTs taken in another order); the FFT golden
vectors of the reference (fft/TestFFT.cpp) at 0.01 absolute.
"""

import numpy as np
import pytest
import torch

import pothoscomms_tpu as jpkg
import pothoscomms_tpu.core.fixtures as jfix
import pothoscomms_tpu_torch as pkg
import pothoscomms_tpu_torch.core.fixtures as fix
from pothoscomms_tpu_torch import Label
from pothoscomms_tpu_torch.core.fusion import DeviceChunk
from pothoscomms_tpu_torch.core.testing import (from_complex_int,
                                                 to_complex_int)

torch.set_num_threads(1)

PACKAGES = {"port": (pkg, fix), "jax": (jpkg, jfix)}


def _on_cpu(blk):
    """A lone block placed on a CPU topology (the port's default device is
    the card)."""
    pkg.Topology(device="cpu")._register(blk)
    return blk


def run_fir(which, dtype, feeds, taps, M=1, L=1, complex_taps=False,
            frame_start="", frame_end=""):
    """feeder -> fir_filter -> collector in one package; ``feeds`` is a
    list of (array, [(id, data, index)]). Returns (buffer, labels)."""
    p, fx = PACKAGES[which]
    feed = fx.FeederSource(dtype)
    for arr, labels in feeds:
        feed.feed_buffer(arr, [p.Label(*lb) for lb in labels])
    fir = p.BlockRegistry.make("/comms/fir_filter", dtype,
                               "COMPLEX" if complex_taps else "REAL")
    fir.set_taps(taps)
    fir.set_decimation(M)
    fir.set_interpolation(L)
    fir.set_frame_start_id(frame_start)
    fir.set_frame_end_id(frame_end)
    sink = fx.CollectorSink(dtype)
    topo = p.Topology(device="cpu") if p is pkg else p.Topology()
    topo.connect(feed, 0, fir, 0)
    topo.connect(fir, 0, sink, 0)
    topo.commit()
    assert topo.wait_inactive()
    return sink.get_buffer(), sink.get_labels()


def both_fir(dtype, feeds, taps, **kw):
    got, glabels = run_fir("port", dtype, feeds, taps, **kw)
    exp, elabels = run_fir("jax", dtype, feeds, taps, **kw)
    assert got.dtype == exp.dtype and got.shape == exp.shape
    assert [(lb.id, lb.index, lb.data) for lb in glabels] == \
        [(lb.id, lb.index, lb.data) for lb in elabels]
    return got, exp


def _close(got, exp, tol):
    assert got.shape == exp.shape
    assert np.max(np.abs(got - exp)) <= tol * max(np.max(np.abs(exp)), 1e-30)


def _cplx(rng, n, dtype=np.complex128):
    return (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(dtype)


def test_fir_identity_passthrough():
    x = np.arange(100, dtype=np.float32)
    got, exp = both_fir("float32", [(x, [])], [1.0])
    np.testing.assert_array_equal(got, x)
    np.testing.assert_array_equal(exp, x)


@pytest.mark.parametrize("M,L", [(1, 1), (2, 1), (1, 2), (3, 2), (2, 3)])
def test_fir_float64_real_taps(M, L):
    rng = np.random.default_rng(5)
    x = rng.normal(size=257)
    _close(*both_fir("float64", [(x, [])], rng.normal(size=11), M=M, L=L),
           1e-9)


@pytest.mark.parametrize("M,L", [(1, 1), (2, 3)])
def test_fir_complex_float64_real_taps(M, L):
    rng = np.random.default_rng(6)
    _close(*both_fir("complex_float64", [(_cplx(rng, 130), [])],
                     rng.normal(size=7), M=M, L=L), 1e-9)


def test_fir_complex_taps_complex_float64():
    rng = np.random.default_rng(7)
    _close(*both_fir("complex_float64", [(_cplx(rng, 120), [])],
                     _cplx(rng, 9), complex_taps=True), 1e-9)


@pytest.mark.parametrize("M,L,complex_taps", [(1, 1, True), (1, 1, False),
                                              (2, 3, True), (3, 1, False)])
def test_fir_complex_float32_device_path(M, L, complex_taps):
    """complex_float32 streams on the topology's device (the CPU here)
    in planar float32."""
    rng = np.random.default_rng(8)
    taps = _cplx(rng, 13) if complex_taps else rng.normal(size=13)
    _close(*both_fir("complex_float32",
                     [(_cplx(rng, 300, np.complex64), [])], taps, M=M, L=L,
                     complex_taps=complex_taps), 1e-5)


def test_fir_float32_real_taps():
    rng = np.random.default_rng(9)
    x = rng.normal(size=400).astype(np.float32)
    _close(*both_fir("float32", [(x, [])], rng.normal(size=21)), 1e-5)


@pytest.mark.parametrize("M,L", [(1, 1), (2, 1), (1, 3)])
def test_fir_int16_qformat_exact(M, L):
    rng = np.random.default_rng(10)
    x = rng.integers(-1000, 1000, 150).astype(np.int16)
    got, exp = both_fir("int16", [(x, [])], rng.normal(size=8) * 0.5, M=M,
                        L=L)
    np.testing.assert_array_equal(got, exp)


@pytest.mark.parametrize("complex_taps", [False, True])
def test_fir_complex_int16_exact(complex_taps):
    rng = np.random.default_rng(11)
    vals = rng.integers(-500, 500, 90) + 1j * rng.integers(-500, 500, 90)
    taps = (_cplx(rng, 5) * 0.3) if complex_taps else rng.normal(size=5)
    got, exp = both_fir("complex_int16",
                        [(to_complex_int(vals, "complex_int16"), [])], taps,
                        complex_taps=complex_taps)
    np.testing.assert_array_equal(got, exp)


def test_fir_int8_and_int32_qformat_exact():
    rng = np.random.default_rng(12)
    for dtype, hi in (("int8", 100), ("int32", 1 << 20)):
        x = rng.integers(-hi, hi, 120).astype(dtype)
        got, exp = both_fir(dtype, [(x, [])], rng.normal(size=6) * 0.4)
        np.testing.assert_array_equal(got, exp)


def test_fir_history_carry_across_works():
    """Two feeds give the single feed's output: the K-1 history stays
    queued on the port between works."""
    rng = np.random.default_rng(13)
    x, taps = rng.normal(size=200), rng.normal(size=15)
    two, exp = both_fir("float64", [(x[:90], []), (x[90:], [])], taps)
    _close(two, exp, 1e-9)
    one, _ = run_fir("port", "float64", [(x, [])], taps)
    _close(two, one, 1e-12)


def test_fir_label_rescale():
    x = np.ones(64, np.float64)
    both_fir("float64", [(x, [("mark", None, 20), ("rxRate", 1000.0, 0)])],
             [1.0, 0.0], M=2)  # labels equal the JAX block's
    _, labels = run_fir("port", "float64",
                        [(x, [("mark", None, 20), ("rxRate", 1000.0, 0)])],
                        [1.0, 0.0], M=2)
    got = {lb.id: lb for lb in labels}
    assert got["mark"].index == 10  # index * L / M
    assert got["rxRate"].data == 500.0  # rate * L / M


def test_fir_burst_flush():
    rng = np.random.default_rng(14)
    data = rng.normal(size=70)
    _close(*both_fir("float64", [(data, [("frameStart", 40, 0)])],
                     rng.normal(size=9), frame_start="frameStart"), 1e-9)


def test_fir_wait_taps_gates_until_set():
    x = np.ones(32, np.float32)
    feed = fix.FeederSource("float32")
    feed.feed_buffer(x)
    fir = pkg.BlockRegistry.make("/comms/fir_filter", "float32", "REAL")
    fir.set_wait_taps(True)
    sink = fix.CollectorSink("float32")
    topo = pkg.Topology(device="cpu")
    topo.connect(feed, 0, fir, 0)
    topo.connect(fir, 0, sink, 0)
    topo.commit()
    assert topo.wait_inactive()
    assert sink.get_buffer().shape[0] == 0  # gated
    fir.set_taps([2.0])  # slot call un-arms the gate
    assert topo.wait_inactive()
    np.testing.assert_array_equal(sink.get_buffer(), x * 2.0)


def test_fir_validation():
    fir = pkg.BlockRegistry.make("/comms/fir_filter", "float32", "REAL")
    with pytest.raises(ValueError):
        fir.set_taps([])
    with pytest.raises(ValueError):
        fir.set_decimation(0)
    with pytest.raises(ValueError):
        fir.set_interpolation(0)
    with pytest.raises(ValueError):
        pkg.BlockRegistry.make("/comms/fir_filter", "float32", "COMPLEX")
    with pytest.raises(ValueError):
        pkg.BlockRegistry.make("/comms/fir_filter", "uint16", "REAL")


# ---------------------------------------------------------------------- #
# /comms/fft
# ---------------------------------------------------------------------- #
FFT_IN = np.array([0.4 + 0.6j, -0.7 + 0.6j, -0.2 + 0.8j, 0.9 + 0.2j])
FFT_OUT = np.array([0.4 + 2.2j, 1.0 + 1.4j, 0.0 + 0.6j, 0.2 - 1.8j])


def run_fft(which, dtype, x, nb, inverse, device="cpu"):
    p, fx = PACKAGES[which]
    feed = fx.FeederSource(dtype)
    feed.feed_buffer(x)
    fft = p.BlockRegistry.make("/comms/fft", dtype, nb, inverse)
    sink = fx.CollectorSink(dtype)
    topo = p.Topology(device=device) if which == "port" else p.Topology()
    topo.connect(feed, 0, fft, 0)
    topo.connect(fft, 0, sink, 0)
    topo.commit()
    assert topo.wait_inactive()
    return sink.get_buffer(), fft


def test_fft_float32_golden_and_jax():
    got, _ = run_fft("port", "complex_float32", FFT_IN.astype(np.complex64),
                     4, False)
    np.testing.assert_allclose(got, FFT_OUT, atol=0.01)
    got2, _ = run_fft("port", "complex_float32",
                      FFT_OUT.astype(np.complex64), 4, True)
    np.testing.assert_allclose(got2, FFT_IN * 4, atol=0.01)
    rng = np.random.default_rng(15)
    for nb, inverse in ((64, False), (1024, True), (8192, False)):
        x = _cplx(rng, 3 * nb + 5, np.complex64)
        got, _ = run_fft("port", "complex_float32", x, nb, inverse)
        exp, _ = run_fft("jax", "complex_float32", x, nb, inverse)
        assert got.dtype == exp.dtype == np.complex64
        _close(got, exp, 1e-5)


def test_fft_float64_batched():
    rng = np.random.default_rng(16)
    k, nb = 5, 64
    x = _cplx(rng, k * nb)
    got, _ = run_fft("port", "complex_float64", x, nb, False)
    exp = np.fft.fft(x.reshape(k, nb), axis=-1).reshape(-1)
    np.testing.assert_allclose(got, exp, atol=1e-9)
    for inverse in (False, True):
        _close(run_fft("port", "complex_float64", x, nb, inverse)[0],
               run_fft("jax", "complex_float64", x, nb, inverse)[0], 1e-12)


@pytest.mark.parametrize("inverse", [False, True])
def test_fft_int16_bit_exact(inverse):
    """The kiss FIXED_POINT contract (1/N forward, normalized inverse),
    golden vectors of fft/TestFFT.cpp, and bit-exact with the JAX block
    over random int16 windows."""
    src = FFT_OUT if inverse else FFT_IN
    x = to_complex_int(src * 1000, "complex_int16")
    got, _ = run_fft("port", "complex_int16", x, 4, inverse)
    want = FFT_IN * 1000 if inverse else FFT_OUT * 1000 / 4
    np.testing.assert_allclose(from_complex_int(got), want, atol=0.01)
    rng = np.random.default_rng(17 + inverse)
    for nb in (4, 64, 1024):
        vals = rng.integers(-3000, 3000, (3 * nb, 2)).astype(np.int16)
        got, _ = run_fft("port", "complex_int16", vals, nb, inverse)
        exp, _ = run_fft("jax", "complex_int16", vals, nb, inverse)
        assert got.dtype == exp.dtype == np.int16
        np.testing.assert_array_equal(got, exp)


def test_fft_reserve_partial_window():
    got, fft = run_fft("port", "complex_float32", np.ones(7, np.complex64), 8,
                       False)
    assert got.shape == (0,)
    assert fft.input(0).elements() == 7


def test_fft_rejects_bad_dtypes():
    with pytest.raises(ValueError):
        pkg.BlockRegistry.make("/comms/fft", "float32", 8, False)
    with pytest.raises(ValueError):
        pkg.BlockRegistry.make("/comms/fft", "complex_int32", 8, False)


def test_labels_pass_through_fft():
    """Default label propagation: same relative index on the output."""
    feed = fix.FeederSource("complex_float32")
    feed.feed_buffer(np.ones(64, np.complex64), [Label("m", 1, 17)])
    fft = pkg.BlockRegistry.make("/comms/fft", "complex_float32", 16, False)
    sink = fix.CollectorSink("complex_float32")
    topo = pkg.Topology(device="cpu")
    topo.connect(feed, 0, fft, 0)
    topo.connect(fft, 0, sink, 0)
    assert topo.wait_inactive()
    assert [(lb.id, lb.index) for lb in sink.get_labels()] == [("m", 17)]


@pytest.mark.parametrize("dtype,inverse", [("complex_float32", False),
                                           ("complex_float32", True),
                                           ("complex_int16", False),
                                           ("complex_int16", True)])
def test_fft_device_core_matches_streaming(dtype, inverse):
    """The fused core (fuse_export's step, with a sub-frame leftover in
    the carry) gives the streaming block's windows: complex_int16 bit
    for bit, complex_float32 within 1e-5."""
    rng = np.random.default_rng(18)
    nb, lead = 64, 23
    vals = rng.integers(-3000, 3000, (5 * nb + lead, 2)).astype(np.int16)
    if dtype == "complex_int16":
        x = vals
    else:
        x = (vals[:, 0] + 1j * vals[:, 1]).astype(np.complex64)
    ref, _ = run_fft("port", dtype, x, nb, inverse)
    fft = _on_cpu(pkg.BlockRegistry.make("/comms/fft", dtype, nb, inverse))
    fft.input(0).push_buffer(x[:lead])
    assert fft.fuse_ready()
    carry, step = fft.fuse_export(1)
    assert carry.shape == (1, lead, 2)
    xp = torch.from_numpy(vals[lead:].astype(np.float32))[None]
    carry, spec = step(carry, xp)
    assert carry.shape == (1, lead, 2)  # (lead + 5 nb) mod nb stays
    got = np.asarray(DeviceChunk(spec.reshape(-1, 2), dtype))
    if dtype == "complex_int16":
        np.testing.assert_array_equal(got, ref)
    else:
        _close(got, ref, 1e-5)
