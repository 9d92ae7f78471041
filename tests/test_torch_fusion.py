"""Auto-fusion in the port (pothoscomms_tpu_torch.core.fusion): the
FIR -> FFT cases of tests/test_fusion.py run against the port, and the
same feeds through the JAX and the port topology, fused and not.

Inputs are made with numpy.random.default_rng(seed). Tolerances: fused
against streaming in one package as tests/test_fusion.py (2e-2 absolute
on spectra of unit-variance input, 1e-3 on FIR output); the port against
the JAX package within 1e-4 of max |output| (the chain contract); the
numpy oracle within 2e-2 absolute as the JAX test.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import pothoscomms_tpu as jpkg
import pothoscomms_tpu.core.fixtures as jfix
import pothoscomms_tpu_torch as pkg
import pothoscomms_tpu_torch.core.fixtures as fix
from pothoscomms_tpu_torch import Label, Topology
from pothoscomms_tpu_torch.core.fixtures import CollectorSink, FeederSource
from pothoscomms_tpu_torch.core.fusion import DeviceChunk
from pothoscomms_tpu_torch.kernels.cgemm import cgemm
from pothoscomms_tpu_torch.kernels.fft import fft_c2c
from pothoscomms_tpu_torch.kernels.fir_fft_fused import fir_fft_fused
from pothoscomms_tpu_torch.parallel.chain import fir_fft_form

torch.set_num_threads(1)

THRESH = 4096  # low threshold so tests engage with small data
PACKAGES = {"port": (pkg, fix), "jax": (jpkg, jfix)}


def run_chain(build, feeds, fuse: bool, threshold=THRESH, which="port"):
    """feeder -> chain -> collector in one package, feeds (with optional
    labels) queued, run to quiescence; returns (collector, topology)."""
    p, fx = PACKAGES[which]
    blocks, dtype_in, dtype_out = build(p)
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
            feed.feed_buffer(item[0], [p.Label(*lb) for lb in item[1]])
        else:
            feed.feed_buffer(item)
    topo.commit()
    assert topo.wait_inactive(timeout=30.0)
    return sink, topo


def mk_fir_fft(nb=256, k=33, seed=7, dtype="complex_float32",
               taps_type="COMPLEX"):
    rng = np.random.default_rng(seed)
    taps = (rng.normal(size=k) + 1j * rng.normal(size=k)) / k
    if taps_type == "REAL":
        taps = np.hamming(k) / (k / 2)

    def build(p):
        fir = p.BlockRegistry.make("/comms/fir_filter", dtype, taps_type)
        fir.set_taps(taps)
        fft = p.BlockRegistry.make("/comms/fft", dtype, nb, False)
        return [fir, fft], dtype, dtype

    return build


def cplx(rng, n):
    return (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(
        np.complex64)


def assert_engaged(topo, times=1):
    segs = topo._segments
    assert segs, "no fused segment detected"
    assert sum(s.engage_count for s in segs) >= times, (
        f"segment never engaged: {[s.engage_count for s in segs]}")


def _rel(got, exp):
    return np.max(np.abs(got - exp)) / np.max(np.abs(exp))


def test_fir_fft_fused_matches_streaming():
    rng = np.random.default_rng(0)
    feeds = [cplx(rng, 3 * THRESH), cplx(rng, 2 * THRESH + 511)]
    s_fused, topo = run_chain(mk_fir_fft(), feeds, fuse=True)
    s_ref, _ = run_chain(mk_fir_fft(), feeds, fuse=False)
    assert_engaged(topo)
    a, b = s_fused.get_buffer(), s_ref.get_buffer()
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, atol=2e-2)


@pytest.mark.parametrize("nb,k,form", [(256, 17, "combined"),
                                       (1024, 33, "one_pass")])
def test_fir_fft_pair_takes_the_rules_form(nb, k, form):
    """The FIR->FFT peephole engages as one FirFftChain step in the form
    that fir_fft_form picks for its taps and bins (its span
    pc.fir_fft.<form>: K1's combined product at 256 bins, K3's one-pass
    step at 1024), and the output matches the numpy oracle."""
    rng = np.random.default_rng(1)
    build = mk_fir_fft(nb=nb, k=k, seed=1)
    trng = np.random.default_rng(1)  # the taps mk_fir_fft made
    taps = (trng.normal(size=k) + 1j * trng.normal(size=k)) / k
    x = cplx(rng, 4 * THRESH)
    before = (cgemm.launches, fft_c2c.launches, fir_fft_fused.launches)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sink, topo = run_chain(build, [x], fuse=True)
    assert_engaged(topo)
    assert topo._segments[0].pair_engaged
    assert fir_fft_form(k, nb, 1, nb) == form
    assert {e.name for e in prof.events()
            if e.name.startswith("pc.fir_fft.")} == {"pc.fir_fft." + form}
    # CPU: no launch
    assert (cgemm.launches, fft_c2c.launches,
            fir_fft_fused.launches) == before
    got = sink.get_buffer()
    # streaming FIR primes with the first K-1 samples (reference :305)
    y = np.convolve(x, taps, mode="full")[k - 1: len(x)]
    m = len(y) // nb
    exp = np.fft.fft(y[: m * nb].reshape(m, nb), axis=-1).reshape(-1)
    np.testing.assert_allclose(got[: len(exp)], exp, atol=2e-2)


def test_label_disengages_and_reengages():
    """A label mid-stream disengages (streaming semantics for the labeled
    region), then the segment re-engages on the next backlog; output
    identical either way and the label reaches the collector at the
    right index. (tests/test_fusion.py runs this through scale -> FIR;
    the port has no scale block yet, so here it is FIR -> FIR.)"""
    def build(p):
        a = p.BlockRegistry.make("/comms/fir_filter", "float32", "REAL")
        a.set_taps([2.0])
        b = p.BlockRegistry.make("/comms/fir_filter", "float32", "REAL")
        b.set_taps(np.hamming(21) / 10)
        return [a, b], "float32", "float32"

    rng = np.random.default_rng(3)
    primer = rng.normal(size=THRESH).astype(np.float32)
    big1 = rng.normal(size=3 * THRESH).astype(np.float32)
    small = rng.normal(size=500).astype(np.float32)
    big2 = rng.normal(size=3 * THRESH).astype(np.float32)
    big3 = rng.normal(size=3 * THRESH).astype(np.float32)

    def run(fuse):
        blocks, _, _ = build(pkg)
        feed = FeederSource("float32")
        sink = CollectorSink("float32")
        topo = Topology(device="cpu")
        topo.auto_fuse = fuse
        topo.fuse_threshold = THRESH
        for a, b in zip([feed] + blocks, blocks + [sink]):
            topo.connect(a, 0, b, 0)
        feed.feed_buffer(primer)
        feed.feed_buffer(big1)
        topo.commit()
        assert topo.wait_inactive(timeout=30.0)
        feed.feed_buffer(small, [Label("mark", 1, 100)])
        feed.feed_buffer(big2)
        assert topo.wait_inactive(timeout=30.0)
        feed.feed_buffer(big3)
        assert topo.wait_inactive(timeout=30.0)
        return sink, topo

    s_fused, topo = run(True)
    s_ref, _ = run(False)
    assert_engaged(topo, times=2)  # engaged, disengaged on label, again
    np.testing.assert_allclose(s_fused.get_buffer(), s_ref.get_buffer(),
                               atol=1e-3)
    lf = [lb for lb in s_fused.get_labels() if lb.id == "mark"]
    lr = [lb for lb in s_ref.get_labels() if lb.id == "mark"]
    assert len(lf) == len(lr) == 1
    assert lf[0].index == lr[0].index


def test_reconfig_mid_stream_rebuilds_cores():
    """set_taps between feeds bumps the fuse epoch: the segment rebuilds
    and applies the new taps from the exact boundary."""
    rng = np.random.default_rng(4)
    x0 = cplx(rng, THRESH)
    x1 = cplx(rng, 3 * THRESH)
    x2 = cplx(rng, 3 * THRESH)

    def run(fuse):
        blocks, _, _ = mk_fir_fft(nb=128, k=9)(pkg)
        feed = FeederSource("complex_float32")
        sink = CollectorSink("complex_float32")
        topo = Topology(device="cpu")
        topo.auto_fuse = fuse
        topo.fuse_threshold = THRESH
        for a, b in zip([feed] + blocks, blocks + [sink]):
            topo.connect(a, 0, b, 0)
        feed.feed_buffer(x0)
        feed.feed_buffer(x1)
        topo.commit()
        assert topo.wait_inactive(timeout=30.0)
        blocks[0].set_taps(np.hamming(9) / 5)
        feed.feed_buffer(x2)
        assert topo.wait_inactive(timeout=30.0)
        return sink.get_buffer(), topo

    got, topo = run(True)
    ref, _ = run(False)
    assert_engaged(topo, times=2)
    np.testing.assert_allclose(got, ref, atol=2e-2)


def test_fft_leftover_phase_preserved():
    """Feeds not frame-aligned: the FFT's sub-frame leftover carries
    through engage/disengage without frame-phase drift."""
    rng = np.random.default_rng(5)
    feeds = [cplx(rng, 2 * THRESH + 37), cplx(rng, 2 * THRESH + 91),
             cplx(rng, 300)]
    s_fused, topo = run_chain(mk_fir_fft(nb=128, k=9), feeds, fuse=True)
    s_ref, _ = run_chain(mk_fir_fft(nb=128, k=9), feeds, fuse=False)
    assert_engaged(topo)
    np.testing.assert_allclose(s_fused.get_buffer(), s_ref.get_buffer(),
                               atol=2e-2)


def test_device_chunk_protocol():
    p = torch.from_numpy(np.stack([np.arange(8.0), -np.arange(8.0)],
                                  -1).astype(np.float32))
    ch = DeviceChunk(p, "complex_float32")
    assert ch.shape == (8,)
    assert len(ch) == 8
    arr = np.asarray(ch)
    assert arr.dtype == np.complex64
    np.testing.assert_allclose(arr.real, np.arange(8))
    arr[0] = 99  # a copy: the tensor is untouched
    assert p[0, 0] == 0
    sl = ch[2:5]
    assert isinstance(sl, DeviceChunk) and len(sl) == 3
    np.testing.assert_allclose(np.asarray(sl).imag, [-2, -3, -4])
    ints = DeviceChunk(torch.tensor([[3.9999997, -1.0]]), "complex_int16")
    np.testing.assert_array_equal(np.asarray(ints), [[4, -1]])


def test_no_fusion_for_unsupported_dtype():
    """complex128 members never fuse (float32 cores would downcast)."""
    rng = np.random.default_rng(9)
    x = (rng.normal(size=2 * THRESH)
         + 1j * rng.normal(size=2 * THRESH)).astype(np.complex128)
    build = mk_fir_fft(nb=128, k=9, dtype="complex_float64",
                       taps_type="REAL")
    sink, topo = run_chain(build, [x], fuse=True)
    assert all(s.engage_count == 0 for s in topo._segments)
    jsink, _ = run_chain(build, [x], fuse=True, which="jax")
    got, exp = sink.get_buffer(), jsink.get_buffer()
    assert got.dtype == np.complex128 and got.shape == exp.shape
    assert _rel(got, exp) < 1e-12


def test_many_small_feeds_concat_pull():
    """Pulls spanning many queued parts (the torch.cat pull) match
    streaming; feeds deliberately misalign part boundaries."""
    build = mk_fir_fft(nb=64, k=11, taps_type="REAL")
    rng = np.random.default_rng(11)
    feeds = [cplx(rng, int(n)) for n in rng.integers(300, 900, size=40)]

    def run(fuse):
        blocks, _, do = build(pkg)
        sink = CollectorSink(do)
        topo = Topology(device="cpu")
        topo.auto_fuse = fuse
        topo.fuse_threshold = 2048
        for a, b in zip(blocks, blocks[1:] + [sink]):
            topo.connect(a, 0, b, 0)
        # queue ALL parts up-front (a burst backlog): the engage pull
        # then spans dozens of parts
        for part in feeds:
            blocks[0].input(0).push_buffer(part)
        topo.commit()
        assert topo.wait_inactive(timeout=30.0)
        return sink, topo

    s_fused, topo = run(True)
    s_ref, _ = run(False)
    assert_engaged(topo)
    np.testing.assert_allclose(s_fused.get_buffer(), s_ref.get_buffer(),
                               atol=2e-2)


@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("nb,k,taps_type", [(256, 33, "COMPLEX"),
                                            (128, 9, "REAL"),
                                            (64, 100, "COMPLEX")])
def test_port_topology_matches_jax_topology(fuse, nb, k, taps_type):
    """The same feeds through both packages' FIR -> FFT topologies. Fused,
    33 and 9 taps take the pair core; 100 taps at 64 bins exceed the
    pair's prev_pad (min(128, nbins)) and take the single cores."""
    rng = np.random.default_rng(12 + k)
    feeds = [cplx(rng, 3 * THRESH + 5), cplx(rng, THRESH + 77),
             cplx(rng, 2 * THRESH)]
    build = mk_fir_fft(nb=nb, k=k, seed=k, taps_type=taps_type)
    sink, topo = run_chain(build, feeds, fuse=fuse)
    jsink, jtopo = run_chain(build, feeds, fuse=fuse, which="jax")
    if fuse:
        assert_engaged(topo)
        assert_engaged(jtopo)
        assert topo._segments[0].pair_engaged == (k - 1 <= min(128, nb))
    got, exp = sink.get_buffer(), jsink.get_buffer()
    assert got.dtype == exp.dtype == np.complex64
    assert got.shape == exp.shape
    assert _rel(got, exp) < 1e-4


def test_disengage_restores_streaming_state_exactly():
    """Export then import is lossless: after a drain the FIR holds its
    K-1 history and the FFT its sub-frame leftover, as streaming
    would."""
    rng = np.random.default_rng(13)
    x = cplx(rng, 3 * THRESH + 100)
    s_fused, topo = run_chain(mk_fir_fft(nb=256, k=33), [x], fuse=True)
    s_ref, ref_topo = run_chain(mk_fir_fft(nb=256, k=33), [x], fuse=False)
    assert_engaged(topo)
    for blk, ref in zip(topo.blocks, ref_topo.blocks):
        for name, port in blk.inputs.items():
            np.testing.assert_array_equal(
                np.asarray(port.buffer()),
                np.asarray(ref.inputs[name].buffer()))
