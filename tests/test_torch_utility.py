"""The utility blocks of the port (blocks/utility.py) against the JAX
package: every case of tests/test_wave_trigger.py, the utility cases of
tests/test_framing.py (:348, :371), tests/test_digital_fusion.py (:308,
:414, :438, :461) and tests/test_fusion_breadth.py (:238), and
SignalProbe in each mode on real, complex and complex_int16 streams,
from host parts and from device chunks.

Inputs are explicit float32/complex64/int16 arrays from
numpy.random.default_rng(seed). Tolerances:
- WaveTrigger packets (payload, labels, metadata), Threshold labels and
  state, split/combine planes: equal, bit for bit;
- a fused float32 path against the streaming one: 1e-5 absolute (the
  JAX tests' bound), 1e-3 where a FIR is in the path;
- SignalProbe on host parts: equal to the JAX package's (float64 numpy in
  both); on device chunks (a float64 reduction in torch, in another
  order): rel 1e-12; through a fused segment against streaming: rel 1e-3
  (tests/test_fusion_breadth.py:287).
"""

import numpy as np
import pytest
import torch

import pothoscomms_tpu as jpkg
import pothoscomms_tpu.core.fixtures as jfix
import pothoscomms_tpu_torch as pkg
import pothoscomms_tpu_torch.core.fixtures as fix
from pothoscomms_tpu_torch.core.fusion import DeviceChunk

torch.set_num_threads(1)

THRESH = 4096
PACKAGES = {"port": (pkg, fix), "jax": (jpkg, jfix)}


def _topo(p):
    return p.Topology(device="cpu") if p is pkg else p.Topology()


def _labels(labels):
    return [(lb.id, lb.index, lb.data, lb.width) for lb in labels]


# ------------------------------------------------------------------ #
# WaveTrigger (tests/test_wave_trigger.py)
# ------------------------------------------------------------------ #
def make_trigger(p, **kw):
    t = p.BlockRegistry.make("/comms/wave_trigger")
    t.set_num_points(kw.get("num_points", 32))
    t.set_num_windows(kw.get("num_windows", 1))
    t.set_hold_off(kw.get("hold_off", 0))
    t.set_position(kw.get("position", 4))
    t.set_level(kw.get("level", 0.5))
    t.set_slope(kw.get("slope", "POS"))
    t.set_mode(kw.get("mode", "NORMAL"))
    # high event rate so pacing (1/rate) never gates the search within
    # the microseconds-scale test run
    t.set_event_rate(kw.get("event_rate", 1e6))
    return t


def run_trigger(which, data, labels=None, dtype="float32", label_id=None,
                **kw):
    """feeder -> wave_trigger -> collector in one package; returns the
    packets as (payload, labels, metadata)."""
    p, fx = PACKAGES[which]
    trig = make_trigger(p, **kw)
    if label_id is not None:
        trig.set_label_id(label_id)
    feed = fx.FeederSource(dtype)
    feed.feed_buffer(np.asarray(data),
                     [p.Label(*lb) for lb in labels] if labels else None)
    sink = fx.CollectorSink(dtype)
    topo = _topo(p)
    topo.connect(feed, 0, trig, 0)
    topo.connect(trig, 0, sink, 0)
    topo.commit()
    assert topo.wait_inactive()
    return [(pk.payload, _labels(pk.labels), dict(pk.metadata))
            for pk in sink.packets]


def trigger_parity(data, **kw):
    """The port's packets, after checking they equal the JAX package's:
    payloads bit for bit, labels and metadata exactly."""
    got = run_trigger("port", data, **kw)
    exp = run_trigger("jax", data, **kw)
    assert len(got) == len(exp)
    for (gp, gl, gm), (ep, el, em) in zip(got, exp):
        assert gp.dtype == ep.dtype
        np.testing.assert_array_equal(gp, ep)
        assert gl == el
        assert gm == em
    return got


def test_level_trigger_capture_and_metadata():
    # step from 0 to 1 at sample 50; position=4 pre-trigger samples
    x = np.zeros(200, np.float32)
    x[50:] = 1.0
    pkts = trigger_parity(x, num_points=16, position=4, level=0.5,
                          slope="POS")
    assert len(pkts) == 1
    payload, labels, meta = pkts[0]
    assert payload.shape[0] == 16
    t_labels = [lb for lb in labels if lb[0] == "T"]
    assert len(t_labels) == 1 and t_labels[0][1] == 4
    assert meta["level"] == 0.5 and meta["index"] == 0
    assert 4.0 <= meta["position"] < 6.0
    assert np.all(payload[:5] == 0.0) and np.all(payload[6:] == 1.0)


def test_neg_slope_trigger():
    x = np.ones(200, np.float32)
    x[80:] = 0.0
    pkts = trigger_parity(x, num_points=8, position=2, level=0.5,
                          slope="NEG")
    assert len(pkts) == 1
    assert np.all(pkts[0][0][:2] == 1.0) and np.all(pkts[0][0][3:] == 0.0)


def test_normal_mode_no_trigger_no_packet():
    x = np.zeros(300, np.float32)  # never crosses level
    assert trigger_parity(x, num_points=16, level=0.5, mode="NORMAL") == []


def test_label_id_trigger():
    x = np.zeros(200, np.float32)
    pkts = trigger_parity(x, labels=[("mark", None, 60)], label_id="mark",
                          num_points=8, position=2, mode="NORMAL")
    assert len(pkts) == 1
    # no "T" label for label-id triggers (only level triggers)
    assert not [lb for lb in pkts[0][1] if lb[0] == "T"]


def test_multi_window_capture():
    x = np.zeros(600, np.float32)
    for k in range(3):
        x[100 + 100 * k] = 1.0  # spikes trigger each window
    pkts = trigger_parity(x, num_points=12, num_windows=2, position=2,
                          level=0.5, slope="POS", hold_off=0)
    assert len(pkts) == 1 and pkts[0][0].shape[0] == 12


def test_periodic_mode():
    x = np.zeros(2000, np.float32)
    pkts = trigger_parity(x, num_points=8, position=0, mode="PERIODIC",
                          hold_off=0, event_rate=1e6)
    assert len(pkts) >= 1 and all(p[0].shape[0] == 8 for p in pkts)


def test_complex_abs_trigger():
    x = np.zeros(200, np.complex64)
    x[70:] = 0.6 + 0.6j  # |x| ~ 0.85 crosses 0.5
    pkts = trigger_parity(x, dtype="complex_float32", num_points=8,
                          position=2, level=0.5, slope="POS")
    assert len(pkts) == 1 and np.all(np.abs(pkts[0][0][3:]) > 0.5)


def test_two_port_aligned_capture():
    n = 300
    a = np.zeros(n, np.float32)
    a[100:] = 1.0
    b = np.arange(n, dtype=np.float32)
    res = {}
    for which, (p, fx) in PACKAGES.items():
        trig = make_trigger(p, num_points=8, position=2, level=0.5)
        trig.set_num_ports(2)
        feed_a, feed_b = fx.FeederSource("float32"), fx.FeederSource(
            "float32")
        feed_a.feed_buffer(a)
        feed_b.feed_buffer(b)
        sink = fx.CollectorSink("float32")
        topo = _topo(p)
        topo.connect(feed_a, 0, trig, 0)
        topo.connect(feed_b, 0, trig, 1)
        topo.connect(trig, 0, sink, 0)
        topo.commit()
        assert topo.wait_inactive()
        res[which] = {pk.metadata["index"]: (pk.payload, _labels(pk.labels),
                                             dict(pk.metadata))
                      for pk in sink.packets}
    assert set(res["port"]) == {0, 1}
    for i in (0, 1):
        gp, gl, gm = res["port"][i]
        ep, el, em = res["jax"][i]
        assert gp.shape == (8,)
        np.testing.assert_array_equal(gp, ep)
        assert (gl, gm) == (el, em)
    # aligned: the crossing is at 99.5, so with 2 samples before it both
    # windows start at sample 97
    np.testing.assert_array_equal(res["port"][0][0], a[97:105])
    np.testing.assert_array_equal(res["port"][1][0], b[97:105])


def test_wave_trigger_validation():
    for p, _ in PACKAGES.values():
        t = p.BlockRegistry.make("/comms/wave_trigger")
        with pytest.raises(ValueError):
            t.set_num_points(0)
        with pytest.raises(ValueError):
            t.set_slope("bogus")
        with pytest.raises(ValueError):
            t.set_mode("bogus")
        with pytest.raises(ValueError):
            t.set_event_rate(0.0)
        with pytest.raises(ValueError):
            t.set_source(5)


def test_wave_trigger_reads_device_chunks():
    """A fused segment's device chunks reach the trigger through
    ``__array__``: the packets equal those of the same stream fed as
    host arrays."""
    rng = np.random.default_rng(5)
    x = np.zeros(6 * THRESH, np.float32)
    x[1000::3000] = 1.0
    x += rng.normal(size=x.size).astype(np.float32) * 0.01
    outs = []
    for chunked in (True, False):
        trig = make_trigger(pkg, num_points=64, num_windows=2, position=8)
        feed = fix.FeederSource("float32")
        sink = fix.CollectorSink("float32")
        topo = pkg.Topology(device="cpu")
        if chunked:
            for part in np.split(x, 6):
                trig.input(0).push_buffer(DeviceChunk(
                    torch.from_numpy(part.copy()), "float32"))
        else:
            feed.feed_buffer(x)
        topo.connect(feed, 0, trig, 0)
        topo.connect(trig, 0, sink, 0)
        topo.commit()
        assert topo.wait_inactive()
        outs.append([(pk.payload, _labels(pk.labels), pk.metadata)
                     for pk in sink.packets])
    assert len(outs[0]) == len(outs[1]) > 1
    for (gp, gl, gm), (ep, el, em) in zip(*outs):
        np.testing.assert_array_equal(gp, ep)
        assert (gl, gm) == (el, em)


# ------------------------------------------------------------------ #
# Threshold, SplitComplex, CombineComplex (tests/test_framing.py)
# ------------------------------------------------------------------ #
def test_threshold_hysteresis_labels():
    x = np.array([0, 1, 5, 6, 5, 3, 0, -1, 5, 6, 0], np.float32)
    res = {}
    for which, (p, fx) in PACKAGES.items():
        blk = p.BlockRegistry.make("/comms/threshold", "float32")
        blk.set_activation_level(4.0)
        blk.set_deactivation_level(2.0)
        blk.set_activation_id("on")
        blk.set_deactivation_id("off")
        feed = fx.FeederSource("float32")
        feed.feed_buffer(x)
        sink = fx.CollectorSink("float32")
        topo = _topo(p)
        topo.connect(feed, 0, blk, 0)
        topo.connect(blk, 0, sink, 0)
        topo.commit()
        assert topo.wait_inactive()
        res[which] = (sink.get_buffer(),
                      [(lb.id, lb.index) for lb in sink.get_labels()])
    np.testing.assert_array_equal(res["port"][0], x)
    assert res["port"][1] == [("on", 2), ("off", 6), ("on", 8), ("off", 10)]
    assert res["port"][1] == res["jax"][1]


@pytest.mark.parametrize("dtype", ["float32", "complex_int16"])
def test_split_combine_roundtrip(dtype):
    rng = np.random.default_rng(9)
    if dtype == "float32":
        x = (rng.normal(size=64) + 1j * rng.normal(size=64)).astype(
            np.complex64)
        cdt = "complex_float32"
    else:
        x = rng.integers(-1000, 1000, (64, 2)).astype(np.int16)
        cdt = "complex_int16"
    for p, fx in PACKAGES.values():
        split = p.BlockRegistry.make("/comms/split_complex", dtype)
        comb = p.BlockRegistry.make("/comms/combine_complex", dtype)
        feed = fx.FeederSource(cdt)
        feed.feed_buffer(x)
        sink = fx.CollectorSink(cdt)
        topo = _topo(p)
        topo.connect(feed, 0, split, 0)
        topo.connect(split, "re", comb, "re")
        topo.connect(split, "im", comb, "im")
        topo.connect(comb, 0, sink, 0)
        topo.commit()
        assert topo.wait_inactive()
        np.testing.assert_array_equal(sink.get_buffer(), x)


def test_threshold_rejects_unsigned_and_complex():
    for p, _ in PACKAGES.values():
        for dt in ("uint8", "complex_float32"):
            with pytest.raises(ValueError):
                p.BlockRegistry.make("/comms/threshold", dt)


# ------------------------------------------------------------------ #
# fused utility blocks (tests/test_digital_fusion.py)
# ------------------------------------------------------------------ #
def run_topo(which, build, fuse):
    """build(package, fixtures) -> (topology, feeders, sinks, blocks); fed
    and run with the test threshold; returns (buffers, topology,
    blocks)."""
    p, fx = PACKAGES[which]
    topo, feeds, sinks, blocks = build(p, fx)
    topo.auto_fuse = fuse
    topo.fuse_threshold = THRESH
    topo.commit()
    assert topo.wait_inactive(timeout=30.0)
    return [s.get_buffer() for s in sinks], topo, blocks, sinks


def test_fanin_combine_complex_segment():
    rng = np.random.default_rng(308)
    n = 4 * THRESH
    a = rng.normal(size=n).astype(np.float32)
    b = rng.normal(size=n).astype(np.float32)

    def build(p, fx):
        f1, f2 = fx.FeederSource("float32"), fx.FeederSource("float32")
        cc = p.BlockRegistry.make("/comms/combine_complex", "float32")
        rot = p.BlockRegistry.make("/comms/rotate", "complex_float32")
        rot.set_phase(0.7)
        sink = fx.CollectorSink("complex_float32")
        topo = _topo(p)
        topo.connect(f1, 0, cc, "re")
        topo.connect(f2, 0, cc, "im")
        topo.connect(cc, 0, rot, 0)
        topo.connect(rot, 0, sink, 0)
        f1.feed_buffer(a)
        f2.feed_buffer(b)
        return topo, (f1, f2), [sink], [cc, rot]

    got, topo, _, _ = run_topo("port", build, True)
    seg = topo._segments[0]
    assert len(seg.heads) == 2 and seg.fused_elements > 0
    exp = (a.astype(np.float64) + 1j * b) * np.exp(0.7j)
    for which, fuse in (("port", False), ("jax", True), ("jax", False)):
        ref = run_topo(which, build, fuse)[0]
        np.testing.assert_allclose(got[0], ref[0], atol=1e-5)
    np.testing.assert_allclose(got[0], exp, atol=1e-5)


def _threshold_walk(x, act, deact, state=False):
    for v in x:
        if not state and v > act:
            state = True
        elif state and v < deact:
            state = False
    return state


def test_threshold_fused_passthrough_and_state():
    rng = np.random.default_rng(414)
    x = rng.normal(size=3 * THRESH).astype(np.float32)

    def build(p, fx):
        th = p.BlockRegistry.make("/comms/threshold", "float32")
        th.set_activation_level(0.5)
        th.set_deactivation_level(-0.5)
        ab = p.BlockRegistry.make("/comms/abs", "float32")
        feed = fx.FeederSource("float32")
        sink = fx.CollectorSink("float32")
        topo = _topo(p)
        topo.connect(feed, 0, th, 0)
        topo.connect(th, 0, ab, 0)
        topo.connect(ab, 0, sink, 0)
        feed.feed_buffer(x[:10000])
        feed.feed_buffer(x[10000:])
        return topo, (feed,), [sink], [th, ab]

    got, topo, (th, _), _ = run_topo("port", build, True)
    seg = topo._segments[0]
    assert seg.fused_elements > 0
    seg.disengage()
    assert th._active_state == _threshold_walk(x, 0.5, -0.5)
    for which, fuse in (("port", False), ("jax", True), ("jax", False)):
        ref, rtopo, (rth, _), _ = run_topo(which, build, fuse)
        for s in rtopo._segments:
            s.disengage()
        np.testing.assert_array_equal(got[0], ref[0])
        assert rth._active_state == th._active_state
    np.testing.assert_array_equal(got[0], np.abs(x))


@pytest.mark.parametrize("act,deact", [(0.5, -0.5), (0.0, 0.0),
                                       (2.0, -2.0), (10.0, -10.0)])
def test_threshold_core_state_equals_the_walk(act, deact):
    """The fused core's last-crossing rule against the host walk, from
    both starting states, over pulls whose last crossing falls anywhere
    (ties at one index go to activation)."""
    rng = np.random.default_rng(int(act * 10) + 7)
    for t in (1, 2, 17, 4096):
        x = rng.normal(size=(3, t)).astype(np.float32)
        x[1, -1] = act + 1.0  # a channel whose last sample activates
        for start in (False, True):
            th = pkg.BlockRegistry.make("/comms/threshold", "float32")
            pkg.Topology(device="cpu")._register(th)
            th.set_activation_level(act)
            th.set_deactivation_level(deact)
            th._active_state = start
            carry, step = th.fuse_export(3)
            xt = torch.from_numpy(x)
            new, y = step(carry, xt)
            assert y is xt  # the stream passes through untouched
            for c in range(3):
                exp = _threshold_walk(x[c], np.float32(act),
                                      np.float32(deact), start)
                assert bool(new[c, 0] > 0.5) == exp, (t, c, start)


def test_threshold_with_label_ids_streams():
    rng = np.random.default_rng(438)
    x = rng.normal(size=3 * THRESH).astype(np.float32)

    def build(p, fx):
        th = p.BlockRegistry.make("/comms/threshold", "float32")
        th.set_activation_level(0.5)
        th.set_deactivation_level(-0.5)
        th.set_activation_id("up")
        ab = p.BlockRegistry.make("/comms/abs", "float32")
        feed = fx.FeederSource("float32")
        sink = fx.CollectorSink("float32")
        topo = _topo(p)
        topo.connect(feed, 0, th, 0)
        topo.connect(th, 0, ab, 0)
        topo.connect(ab, 0, sink, 0)
        feed.feed_buffer(x)
        return topo, (feed,), [sink], [th, ab]

    res = {}
    for which in PACKAGES:
        for fuse in (True, False):
            bufs, _, _, sinks = run_topo(which, build, fuse)
            res[which, fuse] = (bufs[0], [(lb.id, lb.index)
                                          for lb in sinks[0].get_labels()])
    ref = res["port", True]
    assert len(ref[1]) > 0
    for key, (buf, labels) in res.items():
        np.testing.assert_array_equal(buf, ref[0])
        assert labels == ref[1], key


def test_split_complex_fused_tail():
    rng = np.random.default_rng(461)
    n = 4 * THRESH
    x = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)

    def build(p, fx):
        feed = fx.FeederSource("complex_float32")
        rot = p.BlockRegistry.make("/comms/rotate", "complex_float32")
        rot.set_phase(0.3)
        sp = p.BlockRegistry.make("/comms/split_complex", "float32")
        s_re, s_im = fx.CollectorSink("float32"), fx.CollectorSink("float32")
        topo = _topo(p)
        topo.connect(feed, 0, rot, 0)
        topo.connect(rot, 0, sp, 0)
        topo.connect(sp, "re", s_re, 0)
        topo.connect(sp, "im", s_im, 0)
        feed.feed_buffer(x)
        return topo, (feed,), [s_re, s_im], [rot, sp]

    got, topo, _, _ = run_topo("port", build, True)
    seg = topo._segments[0]
    assert len(seg.blocks) == 2 and len(seg.tail_outs) == 2
    assert seg.fused_elements > 0, "split tail never engaged"
    for which, fuse in (("port", False), ("jax", True), ("jax", False)):
        ref = run_topo(which, build, fuse)[0]
        np.testing.assert_allclose(got[0], ref[0], atol=1e-5)
        np.testing.assert_allclose(got[1], ref[1], atol=1e-5)


def test_split_planes_feed_a_fused_segment_dense():
    """Each plane the split tail posts is a dense tensor, and a second
    segment headed by a threshold takes it fused."""
    rng = np.random.default_rng(462)
    n = 8 * THRESH
    x = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
    posted = []
    rot = pkg.BlockRegistry.make("/comms/rotate", "complex_float32")
    rot.set_phase(0.3)
    sp = pkg.BlockRegistry.make("/comms/split_complex", "float32")
    th = pkg.BlockRegistry.make("/comms/threshold", "float32")
    th.set_activation_level(0.5)
    th.set_deactivation_level(-0.5)
    ab = pkg.BlockRegistry.make("/comms/abs", "float32")
    feed = fix.FeederSource("complex_float32")
    s_re, s_im = fix.CollectorSink("float32"), fix.CollectorSink("float32")
    topo = pkg.Topology(device="cpu")
    topo.fuse_threshold = THRESH
    topo.connect(feed, 0, rot, 0)
    topo.connect(rot, 0, sp, 0)
    topo.connect(sp, "re", th, 0)
    topo.connect(th, 0, ab, 0)
    topo.connect(ab, 0, s_re, 0)
    topo.connect(sp, "im", s_im, 0)
    post = sp.output("re").post

    def noting(arr, labels=None):
        posted.append(arr)
        post(arr, labels)

    sp.output("re").post = noting
    feed.feed_buffer(x)
    topo.commit()
    assert topo.wait_inactive(timeout=30.0)
    chunks = [c for c in posted if isinstance(c, DeviceChunk)]
    assert chunks and all(c.planar.is_contiguous() for c in chunks)
    segs = {len(s.blocks): s for s in topo._segments}
    assert segs[2].fused_elements > 0 and len(topo._segments) == 2
    assert all(s.fused_elements > 0 for s in topo._segments)
    y = x * np.complex64(np.exp(0.3j))
    np.testing.assert_allclose(s_re.get_buffer(), np.abs(y.real), atol=1e-5)
    np.testing.assert_allclose(s_im.get_buffer(), y.imag, atol=1e-5)


# ------------------------------------------------------------------ #
# SignalProbe
# ------------------------------------------------------------------ #
def _probe_input(dtype, n, seed):
    rng = np.random.default_rng(seed)
    if dtype == "float32":
        return rng.normal(size=n).astype(np.float32) + np.float32(0.25)
    if dtype == "complex_float32":
        return (rng.normal(size=n) + 1j * rng.normal(size=n) + 0.5
                ).astype(np.complex64)
    return rng.integers(-3000, 3000, (n, 2)).astype(np.int16)


def _host_probe(which, dtype, mode, window, x):
    p, fx = PACKAGES[which]
    probe = p.BlockRegistry.make("/comms/signal_probe", dtype)
    probe.set_mode(mode)
    probe.set_window(window)
    feed = fx.FeederSource(dtype)
    feed.feed_buffer(x)
    topo = _topo(p)
    topo.connect(feed, 0, probe, 0)
    assert topo.wait_inactive()
    return probe.value()


def _planar(x, dtype):
    if dtype == "complex_float32":
        return torch.from_numpy(np.ascontiguousarray(x).view(
            np.float32).reshape(-1, 2))
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


@pytest.mark.parametrize("dtype", ["float32", "complex_float32",
                                   "complex_int16"])
@pytest.mark.parametrize("mode", ["VALUE", "RMS", "MEAN"])
def test_signal_probe_modes(dtype, mode):
    """Host parts equal the JAX package's probe exactly; device chunks
    (and a mix of host parts and device chunks) agree to rel 1e-12."""
    window = 1000
    x = _probe_input(dtype, 3000, seed=len(dtype) + len(mode))
    got = _host_probe("port", dtype, mode, window, x)
    exp = _host_probe("jax", dtype, mode, window, x)
    assert got == exp
    tail = x[-window:]
    if dtype == "complex_int16":
        tail = tail[:, 0].astype(np.float64) + 1j * tail[:, 1]
    oracle = {"VALUE": tail[-1], "RMS": np.sqrt(np.mean(np.abs(
        tail.astype(np.complex128)) ** 2)), "MEAN": tail.astype(
        np.complex128 if dtype != "float32" else np.float64).mean()}[mode]
    assert got == pytest.approx(oracle, rel=1e-12)
    for mixed in (False, True):
        probe = pkg.BlockRegistry.make("/comms/signal_probe", dtype)
        pkg.Topology(device="cpu")._register(probe)
        probe.set_mode(mode)
        probe.set_window(window)
        called = []
        device_path = probe._probe_device
        probe._probe_device = lambda tail: called.append(1) or \
            device_path(tail)
        port = probe.input(0)
        for i, part in enumerate(np.array_split(x, 4)):
            if mixed and i % 2 == 0:
                port.push_buffer(part)
            else:
                port.push_buffer(DeviceChunk(_planar(part, dtype), dtype))
        probe.work()
        assert called == [1]
        assert probe.value() == pytest.approx(got, rel=1e-12, abs=1e-12)


def test_signal_probe_rate_gate_and_signal():
    """A rate-limited probe still drains its input, but recalculates at
    most once a period; every calculation emits valueChanged."""
    for p, fx in PACKAGES.values():
        probe = p.BlockRegistry.make("/comms/signal_probe", "float32")
        probe.set_rate(1e-6)  # one calculation, then gated for days

        class Seen(p.Block):
            def __init__(self):
                super().__init__()
                self.values = []

            def got(self, v):
                self.values.append(v)

        seen = Seen()
        feed = fx.FeederSource("float32")
        topo = _topo(p)
        topo.connect(feed, 0, probe, 0)
        topo.connect(probe, "valueChanged", seen, "got")
        feed.feed_buffer(np.full(10, 3.0, np.float32))
        assert topo.wait_inactive()
        feed.feed_buffer(np.full(10, 5.0, np.float32))
        assert topo.wait_inactive()
        assert probe.value() == 3.0 and seen.values == [3.0]
        assert probe.input(0).elements() == 0
        assert probe.probe("value") == 3.0


def test_probe_tap_at_tail_stays_fused():
    """scale -> fir with a SignalProbe tapped off the FIR output next to
    the sink (tests/test_fusion_breadth.py:238): the segment stays fused
    and the probe's RMS matches the streaming value, and the JAX
    package's, within rel 1e-3; the outputs within 1e-3."""
    rng = np.random.default_rng(4)
    k = 9
    taps = (rng.normal(size=k) + 1j * rng.normal(size=k)) / k

    def cplx(n):
        return (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(
            np.complex64)

    feeds = [cplx(4 * THRESH), cplx(4 * THRESH)]

    def build(p, fx):
        sc = p.BlockRegistry.make("/comms/scale", "complex_float32")
        sc.set_factor(1.2)
        fir = p.BlockRegistry.make("/comms/fir_filter", "complex_float32",
                                   "COMPLEX")
        fir.set_taps(taps)
        feed = fx.FeederSource("complex_float32")
        sink = fx.CollectorSink("complex_float32")
        probe = p.BlockRegistry.make("/comms/signal_probe",
                                     "complex_float32")
        probe.set_mode("RMS")
        probe.set_window(1 << 20)
        topo = _topo(p)
        topo.connect(feed, 0, sc, 0)
        topo.connect(sc, 0, fir, 0)
        topo.connect(fir, 0, sink, 0)
        topo.connect(fir, 0, probe, 0)
        for f in feeds:
            feed.feed_buffer(f)
        return topo, (feed,), [sink], [probe]

    got, topo, (probe,), _ = run_topo("port", build, True)
    segs = topo._segments
    assert len(segs) == 1 and len(segs[0].blocks) == 2
    assert segs[0].engage_count >= 1
    for which, fuse in (("port", False), ("jax", True), ("jax", False)):
        ref, _, (rprobe,), _ = run_topo(which, build, fuse)
        np.testing.assert_allclose(got[0], ref[0], atol=1e-3)
        assert probe.value() == pytest.approx(rprobe.value(), rel=1e-3)


def test_utility_blocks_registered_under_jax_names():
    paths = ["/comms/signal_probe", "/blocks/stream_probe",
             "/comms/threshold", "/blocks/threshold",
             "/comms/split_complex", "/comms/wave_trigger",
             "/blocks/wave_trigger", "/comms/combine_complex"]
    for path in paths:
        assert pkg.BlockRegistry.exists(path)
        assert jpkg.BlockRegistry.exists(path)
