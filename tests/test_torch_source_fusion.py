"""Source-headed fused segments, cold-start engagement, the pending-pair
cycle, multi-output tails and fused elementwise hops in the port
(core/fusion.py), against the JAX package: the cases of
tests/test_fusion_breadth.py:58-235 (the probe-tap case waits for the
utility blocks), tests/test_soak.py with its bounded queues, and the
waveform-fed filter cases of tests/test_filter.py:320-346 and :606-616
(each RMS read from a SignalProbe, as there, the port's against the JAX
package's within rel 1e-6).

Tolerances are the JAX tests' own, fused against streaming in one
package (1e-4 or 1e-5 absolute, 2e-2 on spectra); the port against the
JAX package's streaming path within the same bound. The noise-headed FM
chain is held statistically, as in the JAX test (fast-mode noise has no
sequence contract between the fused and streaming paths).

Two corners of the JAX package's source-headed segments are not its
behavior to hold the port to, and each is pinned here against the
streaming path instead (ROADMAP Queue 3, reference-side):
- a cold FIR -> FFT segment re-engages for the pair and then runs its
  stale cached single cores, so its spectra after the first quantum are
  wrong;
- the first quantum after a cold engage sizes its sub-floor rung from the
  quota before the over-pull, so the source can emit up to K-1 samples
  past its quota.
"""

import numpy as np
import pytest
import torch

import pothoscomms_tpu as jpkg
import pothoscomms_tpu.core.fixtures as jfix
import pothoscomms_tpu_torch as pkg
import pothoscomms_tpu_torch.core.fixtures as fix

torch.set_num_threads(1)

THRESH = 4096
PACKAGES = {"port": (pkg, fix), "jax": (jpkg, jfix)}


def _cplx(rng, n):
    return (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(
        np.complex64)


def _topology(p, fuse, threshold=THRESH):
    topo = p.Topology(device="cpu") if p is pkg else p.Topology()
    topo.auto_fuse = fuse
    topo.fuse_threshold = threshold
    return topo


def run_feed(which, mk, dtype_in, dtype_out, feeds, fuse):
    """feeder -> mk(package) -> collector; returns (collector, topology)."""
    p, fx = PACKAGES[which]
    feed = fx.FeederSource(dtype_in)
    sink = fx.CollectorSink(dtype_out)
    topo = _topology(p, fuse)
    chain = [feed] + mk(p) + [sink]
    for a, b in zip(chain[:-1], chain[1:]):
        topo.connect(a, 0, b, 0)
    for f in feeds:
        feed.feed_buffer(f)
    topo.commit()
    assert topo.wait_inactive(timeout=30.0)
    return sink, topo


def run_source(which, mk, dtype_out, n, fuse, grants=1):
    """mk(package) -> (source, blocks) -> collector, ``grants`` quotas of
    n; returns (collector, topology, source)."""
    p, fx = PACKAGES[which]
    src, blocks = mk(p)
    sink = fx.CollectorSink(dtype_out)
    topo = _topology(p, fuse)
    chain = [src] + blocks + [sink]
    for a, b in zip(chain[:-1], chain[1:]):
        topo.connect(a, 0, b, 0)
    topo.commit()
    for _ in range(grants):
        topo.run_source_elements(n)
    return sink, topo, src


def hold(mk_run, atol, jax_fused=True):
    """The port fused against the port streaming, and against the JAX
    package streaming (and fused, where the JAX package is right);
    returns the port's fused topology."""
    (pf, topo), (ps, _) = mk_run("port", True), mk_run("port", False)
    (js, _) = mk_run("jax", False)
    a, b, c = pf.get_buffer(), ps.get_buffer(), js.get_buffer()
    assert a.shape == b.shape == c.shape
    np.testing.assert_allclose(a, b, atol=atol)
    np.testing.assert_allclose(a, c, atol=atol)
    if jax_fused:
        (jf, _) = mk_run("jax", True)
        np.testing.assert_allclose(a, jf.get_buffer(), atol=atol)
    assert sum(s.engage_count for s in topo._segments) >= 1
    return topo


# ------------------------------------------------------------------ #
# elementwise hops fuse (tests/test_fusion_breadth.py:58-145)
# ------------------------------------------------------------------ #
def test_rotate_abs_chain_fuses():
    """rotate -> abs (complex -> real transition inside the segment)."""
    def mk(p):
        rot = p.BlockRegistry.make("/comms/rotate", "complex_float32")
        rot.set_phase(0.7)
        return [rot, p.BlockRegistry.make("/comms/abs", "complex_float32")]

    rng = np.random.default_rng(0)
    feeds = [_cplx(rng, 3 * THRESH), _cplx(rng, THRESH + 137)]
    hold(lambda w, f: run_feed(w, mk, "complex_float32", "float32", feeds,
                               f), 1e-4)


def test_const_arith_trig_chain_fuses():
    def mk(p):
        ca = p.BlockRegistry.make("/comms/const_arithmetic", "float32",
                                  "X*K", 0.25)
        tr = p.BlockRegistry.make("/comms/trigonometric", "float32", "SIN")
        return [ca, tr]

    rng = np.random.default_rng(1)
    feeds = [rng.normal(size=4 * THRESH).astype(np.float32)]
    hold(lambda w, f: run_feed(w, mk, "float32", "float32", feeds, f),
         1e-5)


@pytest.mark.parametrize("op", ["X*K", "X+K", "K/X", "X-K", "K-X", "X/K"])
def test_complex_const_arith_fused_parity(op):
    def mk(p):
        ca = p.BlockRegistry.make("/comms/const_arithmetic",
                                  "complex_float32", op, 0.5 - 0.25j)
        return [ca, p.BlockRegistry.make("/comms/conjugate",
                                         "complex_float32")]

    rng = np.random.default_rng(2)
    feeds = [_cplx(rng, 3 * THRESH)]
    hold(lambda w, f: run_feed(w, mk, "complex_float32", "complex_float32",
                               feeds, f), 1e-4)


def test_scale_rotate_fir_fft_single_segment():
    """scale -> rotate -> fir -> fft engages as ONE segment with the
    FIR*DFT pair inside."""
    rng = np.random.default_rng(3)
    k, nb = 17, 256
    taps = (rng.normal(size=k) + 1j * rng.normal(size=k)) / k

    def mk(p):
        sc = p.BlockRegistry.make("/comms/scale", "complex_float32")
        sc.set_factor(1.5)
        rot = p.BlockRegistry.make("/comms/rotate", "complex_float32")
        rot.set_phase(-0.3)
        fir = p.BlockRegistry.make("/comms/fir_filter", "complex_float32",
                                   "COMPLEX")
        fir.set_taps(taps)
        return [sc, rot, fir,
                p.BlockRegistry.make("/comms/fft", "complex_float32", nb,
                                     False)]

    feeds = [_cplx(rng, 4 * THRESH), _cplx(rng, 2 * THRESH + 300)]
    topo = hold(lambda w, f: run_feed(w, mk, "complex_float32",
                                      "complex_float32", feeds, f), 2e-2)
    segs = topo._segments
    assert len(segs) == 1 and len(segs[0].blocks) == 4


# ------------------------------------------------------------------ #
# source-headed segments (tests/test_fusion_breadth.py:150-235)
# ------------------------------------------------------------------ #
def _wave(p, freq=1000.0, rate=48000.0, dtype="complex_float32",
          wave="SINE"):
    src = p.BlockRegistry.make("/comms/waveform_source", dtype)
    src.set_waveform(wave)
    src.set_frequency(freq)
    src.set_sample_rate(rate)
    return src


def test_waveform_source_headed_segment_exact():
    def mk(p):
        sc = p.BlockRegistry.make("/comms/scale", "complex_float32")
        sc.set_factor(0.5)
        rot = p.BlockRegistry.make("/comms/rotate", "complex_float32")
        rot.set_phase(0.2)
        return _wave(p), [sc, rot]

    n = 6 * THRESH
    topo = hold(lambda w, f: run_source(w, mk, "complex_float32", n, f)[:2],
                1e-5)
    seg = topo._segments[0]
    assert seg.source is topo.blocks[0] and seg.head is None
    assert seg.cold_engages == 0  # nothing cold: no FIR in the run


def test_waveform_source_index_continuity():
    """Quota granted in two batches: engage/disengage across batches keeps
    the table index exact (export/import round trip)."""
    def mk(p):
        sc = p.BlockRegistry.make("/comms/scale", "complex_float32")
        sc.set_factor(2.0)
        return _wave(p, 3172.0), [sc]

    pf, topo, src = run_source("port", mk, "complex_float32",
                               3 * THRESH + 77, True, grants=1)
    topo.run_source_elements(2 * THRESH + 13)
    got = pf.get_buffer()
    js, _, jsrc = run_source("jax", mk, "complex_float32", len(got), False)
    np.testing.assert_allclose(got, js.get_buffer(), atol=1e-5)
    assert topo._segments[0].engage_count >= 1


def _fm(p, seed=11, src="noise"):
    if src == "noise":
        s = p.BlockRegistry.make("/comms/noise_source", "complex_float32",
                                 seed)
        s.set_waveform("NORMAL")
        s.set_fast(True)
    else:
        s = _wave(p, 0.013, 1.0)
    demod = p.BlockRegistry.make("/comms/freq_demod", "complex_float32")
    dc = p.BlockRegistry.make("/comms/dc_removal", "float32")
    dc.set_average_size(32)
    dc.set_cascade_size(2)
    env = p.BlockRegistry.make("/comms/envelope_detector", "float32")
    env.set_attack(4.0)
    env.set_release(16.0)
    return s, [demod, dc, env]


def test_fm_chain_source_headed_single_segment():
    """BASELINE config #4: noise -> freq_demod -> dc_removal -> envelope
    as ONE four-block source-headed segment; statistical parity with the
    streaming path and with the JAX package's fused segment."""
    n = 8 * THRESH
    pf, topo, _ = run_source("port", _fm, "float32", n, True)
    seg = topo._segments[0]
    assert seg.source is topo.blocks[0] and len(seg.blocks) == 4
    assert seg.engage_count >= 1
    ps, _, _ = run_source("port", _fm, "float32", n, False)
    jf, _, _ = run_source("jax", _fm, "float32", n, True)
    a, b, c = pf.get_buffer(), ps.get_buffer(), jf.get_buffer()
    assert a.shape == b.shape == c.shape == (n,)
    for ref in (b, c):
        assert np.mean(a) == pytest.approx(np.mean(ref), rel=0.05)
        assert np.sqrt(np.mean(a * a)) == pytest.approx(
            np.sqrt(np.mean(ref * ref)), rel=0.05)


def test_fm_chain_fused_walk_equals_jax_fused_walk():
    """Same seed, same quanta: the fused noise walk is the JAX package's
    bit for bit, so the two fused FM segments agree as closely as their
    FM cores do (the chain's 2e-3 gate)."""
    n = 8 * THRESH
    pf, _, _ = run_source("port", _fm, "float32", n, True)
    jf, _, _ = run_source("jax", _fm, "float32", n, True)
    np.testing.assert_allclose(pf.get_buffer(), jf.get_buffer(), atol=2e-3)


def test_fm_waveform_headed_matches_streaming():
    """The deterministic source through the FM segment: fused == the
    streaming path of both packages."""
    hold(lambda w, f: run_source(w, lambda p: _fm(p, src="wave"),
                                 "float32", 6 * THRESH + 5, f)[:2], 1e-4)


# ------------------------------------------------------------------ #
# cold start, the pending-pair cycle, the quota
# ------------------------------------------------------------------ #
def _wave_fir_fft(p, k=17, nb=256):
    rng = np.random.default_rng(3)
    taps = (rng.normal(size=k) + 1j * rng.normal(size=k)) / k
    fir = p.BlockRegistry.make("/comms/fir_filter", "complex_float32",
                               "COMPLEX")
    fir.set_taps(taps)
    return _wave(p), [fir, p.BlockRegistry.make("/comms/fft",
                                                "complex_float32", nb,
                                                False)]


def test_cold_engage_then_pair_cycle():
    """waveform -> FIR -> FFT engages COLD on round one (the FIR's port
    empty), its first quantum over-pulls K-1, then the segment re-engages
    as the K1 pair; spectra equal the streaming path of both packages.
    (The JAX package's fused spectra go wrong after its first quantum:
    see the module docstring.)"""
    n = 6 * 16384
    quanta = []

    def run(w, f):
        sink, topo, src = run_source(w, _wave_fir_fft, "complex_float32", n,
                                     f)
        return sink, topo

    import pothoscomms_tpu_torch.core.fusion as fusion

    saved = fusion.FusedSegment._work_source

    def noting(self):
        before = self.source._source_quota
        saved(self)
        quanta.append(before - self.source._source_quota)

    fusion.FusedSegment._work_source = noting
    try:
        topo = hold(run, 2e-4, jax_fused=False)
    finally:
        fusion.FusedSegment._work_source = saved
    seg = topo._segments[0]
    assert len(seg.blocks) == 3 and seg.cold_engages == 1
    assert seg.engage_count == 2 and seg.pair_engaged
    assert quanta[0] == 65536 + 16  # one ladder rung plus K-1
    assert sum(quanta) == seg.fused_elements <= n


def test_quota_never_overshot_after_cold_engage():
    """The ADVICE.md:3 corner: quota 4096 = the fuse floor, K = 17,
    granule 256. The pull is sized from the quota left after the K-1
    over-pull (q + extra <= cap): the port's source emits exactly its
    4096 samples, 15 windows as the streaming path gives. The JAX
    package sizes its sub-floor rung from the whole quota and emits 4112
    (q = 4096 plus K-1 = 16): 16 windows."""
    n = 4096
    pf, topo, src = run_source("port", _wave_fir_fft, "complex_float32", n,
                               True)
    ps, _, _ = run_source("port", _wave_fir_fft, "complex_float32", n,
                          False)
    jf, jtopo, _ = run_source("jax", _wave_fir_fft, "complex_float32", n,
                              True)
    seg = topo._segments[0]
    assert seg.cold_engages == 1
    # samples generated: fused quanta plus the streaming remainder
    assert seg.fused_elements == 1024 + 16
    assert seg.fused_elements + src.output(0).total_produced == n
    assert src._source_quota == 0
    assert len(pf.get_buffer()) == len(ps.get_buffer()) == 15 * 256
    np.testing.assert_allclose(pf.get_buffer(), ps.get_buffer(), atol=2e-4)
    # the reference's count, and why it differs
    jseg = jtopo._segments[0]
    assert jseg.fused_elements == 4096 + 16
    assert jseg.fused_elements + jtopo.blocks[0].output(0).total_produced \
        == n + 16
    assert len(jf.get_buffer()) == 16 * 256


def test_two_cold_members_do_not_engage_cold():
    """At most one cold member: waveform -> FIR -> FIR stays streaming
    until the second FIR has its history, then engages warm."""
    rng = np.random.default_rng(5)

    def mk(p):
        firs = []
        for _ in range(2):
            fir = p.BlockRegistry.make("/comms/fir_filter",
                                       "complex_float32", "COMPLEX")
            fir.set_taps((rng.normal(size=9) + 0j) / 9)
            firs.append(fir)
        return _wave(p), firs

    sink, topo, _ = run_source("port", mk, "complex_float32", 8 * THRESH,
                               True)
    seg = topo._segments[0]
    assert seg.cold_engages == 0 and seg.engage_count >= 1
    rng = np.random.default_rng(5)
    ref, _, _ = run_source("port", mk, "complex_float32", 8 * THRESH, False)
    np.testing.assert_allclose(sink.get_buffer(), ref.get_buffer(),
                               atol=1e-5)


def test_modf_two_output_tail_source_headed():
    """waveform (float32 RAMP) -> scale -> modf: the multi-output tail
    joins the source-headed segment and posts one chunk per port."""
    def build(p, fuse):
        src = _wave(p, 0.003, 1.0, "float32", "RAMP")
        sc = p.BlockRegistry.make("/comms/scale", "float32")
        sc.set_factor(7.5)
        mf = p.BlockRegistry.make("/comms/modf", "float32")
        _, fx = PACKAGES["port" if p is pkg else "jax"]
        si, sf = fx.CollectorSink("float32"), fx.CollectorSink("float32")
        topo = _topology(p, fuse)
        topo.connect(src, 0, sc, 0)
        topo.connect(sc, 0, mf, 0)
        topo.connect(mf, "int", si, 0)
        topo.connect(mf, "frac", sf, 0)
        topo.run_source_elements(5 * THRESH + 3)
        return topo, si.get_buffer(), sf.get_buffer()

    topo, i_f, f_f = build(pkg, True)
    seg = topo._segments[0]
    assert len(seg.blocks) == 3 and len(seg.tail_outs) == 2
    assert seg.fused_elements > 0
    for p in (pkg, jpkg):
        _, i_s, f_s = build(p, False)
        np.testing.assert_array_equal(i_f, i_s)
        np.testing.assert_allclose(f_f, f_s, atol=1e-6)


# ------------------------------------------------------------------ #
# the soak (tests/test_soak.py): bounded queues under a slow consumer
# ------------------------------------------------------------------ #
class _SlowSink(fix.CollectorSink):
    """Consumes in small bites to force upstream backlog."""

    def __init__(self, dtype, bite=256):
        super().__init__(dtype)
        self._bite = bite
        self.high_water = 0
        self._checksum = 0.0

    def work(self):
        port = self.input(0)
        depth = port.elements()
        self.high_water = max(self.high_water, depth)
        assert port.capacity is None or depth <= port.capacity
        n = min(depth, self._bite)
        if n == 0:
            return
        self._checksum += float(np.asarray(port.buffer(n)).sum())
        port.consume(n)


def test_fm_chain_soak_bounded_queues():
    from pothoscomms_tpu_torch.core.block import DEFAULT_EDGE_CAPACITY_BYTES

    src, blocks = _fm(pkg, src="wave")
    sink = _SlowSink("float32")
    topo = pkg.Topology(device="cpu")
    chain = [src] + blocks + [sink]
    for a, b in zip(chain[:-1], chain[1:]):
        topo.connect(a, 0, b, 0)
    topo.commit()
    ports = [b.input(0) for b in blocks + [sink]]
    high_water_bytes = 0
    total, chunk, fed = 1 << 21, 1 << 16, 0
    while fed < total:
        topo.run_source_elements(chunk)
        assert topo.wait_inactive(timeout=60.0)
        fed += chunk
        for p in ports:
            high_water_bytes = max(high_water_bytes,
                                   p.elements() * p.dtype.itemsize)
            assert p.capacity is None or p.elements() <= p.capacity
    assert high_water_bytes <= DEFAULT_EDGE_CAPACITY_BYTES
    assert sink.high_water * 4 <= DEFAULT_EDGE_CAPACITY_BYTES
    assert sink.high_water > 0 and np.isfinite(sink._checksum)
    assert topo._segments[0].fused_elements > 0


# ------------------------------------------------------------------ #
# waveform-fed filters (tests/test_filter.py:320-346, :606-616)
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("dtype_name", ["complex_float64", "complex_int16"])
@pytest.mark.parametrize("decim,interp", [(1, 1), (2, 3), (3, 2)])
def test_fir_filter_tone_rms(dtype_name, decim, interp):
    amplitude, rate, freq = 1000.0, 1e6, 30e3

    def run(which):
        p, fx = PACKAGES[which]
        src = p.BlockRegistry.make("/comms/waveform_source", dtype_name)
        src.set_amplitude(amplitude)
        src.set_waveform("SINE")
        src.set_frequency(freq)
        src.set_sample_rate(rate)
        release = p.BlockRegistry.make("/blocks/finite_release")
        release.set_total_elements(4096)
        fir = p.BlockRegistry.make("/comms/fir_filter", dtype_name,
                                   "COMPLEX")
        fir.set_decimation(decim)
        fir.set_interpolation(interp)
        fir.set_wait_taps(True)
        designer = p.BlockRegistry.make("/comms/fir_designer")
        designer.set_sample_rate(rate * interp / decim)
        designer.set_filter_type("SINC")
        designer.set_band_type("COMPLEX_BAND_PASS")
        designer.set_frequency_lower(freq - 0.1 * rate)
        designer.set_frequency_upper(freq + 0.1 * rate)
        designer.set_bandwidth_trans(freq + 0.1 * rate)
        designer.set_num_taps(101)
        sink = fx.CollectorSink(dtype_name)
        probe = p.BlockRegistry.make("/comms/signal_probe", dtype_name)
        probe.set_mode("RMS")
        topo = p.Topology(device="cpu") if p is pkg else p.Topology()
        topo.connect(designer, "tapsChanged", fir, "setTaps")
        topo.connect(src, 0, release, 0)
        topo.connect(release, 0, fir, 0)
        topo.connect(fir, 0, sink, 0)
        topo.connect(fir, 0, probe, 0)
        topo.run_source_elements(4096)
        return sink.get_buffer(), probe.value()

    (got, rms), (exp, jrms) = run("port"), run("jax")
    assert got.shape == exp.shape and len(got) > 0
    if dtype_name == "complex_int16":
        np.testing.assert_array_equal(got, exp)
    else:
        np.testing.assert_allclose(got, exp, rtol=0,
                                   atol=1e-9 * amplitude)
    assert rms > 0.1 * amplitude
    assert rms == pytest.approx(jrms, rel=1e-6)


def test_iir_smoke_with_waveform():
    """A tone through the default lowpass keeps most of its power
    (reference filter/TestIIRFilter.cpp:16-51)."""
    def run(which):
        p, fx = PACKAGES[which]
        src = p.BlockRegistry.make("/comms/waveform_source", "float64")
        src.set_waveform("SINE")
        src.set_frequency(0.01)
        src.set_sample_rate(1.0)
        iir = p.BlockRegistry.make("/comms/iir_filter", "float64")
        sink = fx.CollectorSink("float64")
        probe = p.BlockRegistry.make("/comms/signal_probe", "float64")
        probe.set_mode("RMS")
        topo = p.Topology(device="cpu") if p is pkg else p.Topology()
        topo.connect(src, 0, iir, 0)
        topo.connect(iir, 0, sink, 0)
        topo.connect(iir, 0, probe, 0)
        topo.run_source_elements(4096)
        return sink.get_buffer(), probe.value()

    (got, rms), (exp, jrms) = run("port"), run("jax")
    np.testing.assert_allclose(got, exp, rtol=0, atol=1e-12)
    assert rms > 0.5  # sine RMS ~0.707 through the DC-gain-1 lowpass
    assert rms == pytest.approx(jrms, rel=1e-6)
