"""The port's streaming runtime (pothoscomms_tpu_torch.core) against the
fixture-only behaviour of tests/test_runtime.py, and against the JAX
package's runtime on the same feeds: feeder/collector buffers and
labels, the copier's re-chunking, signals/slots, probes, the registry,
test plans, backpressure on element and message edges, and the
amortized input queue. Every comparison here is exact (the runtime only
moves data).
"""

import numpy as np
import pytest
import torch

import pothoscomms_tpu as jpkg
import pothoscomms_tpu.core.fixtures as jfix
import pothoscomms_tpu_torch as pkg
import pothoscomms_tpu_torch.core.fixtures as fix
from pothoscomms_tpu_torch import Block, BlockRegistry, Topology
from pothoscomms_tpu_torch.core.block import InputPort
from pothoscomms_tpu_torch.core.dtypes import ALL_NAMES, DType
from pothoscomms_tpu_torch.core.packet import Packet

torch.set_num_threads(1)

PACKAGES = [(pkg, fix), (jpkg, jfix)]


def _feed_collect(p, fx, dtype, feeds, copier_seed=None):
    """feeder (-> copier) -> collector in package ``p``; returns
    (buffer, [(label id, index, data)])."""
    feeder = fx.FeederSource(dtype)
    collector = fx.CollectorSink(dtype)
    topo = p.Topology(device="cpu") if p is pkg else p.Topology()
    if copier_seed is None:
        topo.connect(feeder, 0, collector, 0)
    else:
        copier = fx.Copier(seed=copier_seed)
        topo.connect(feeder, 0, copier, 0)
        topo.connect(copier, 0, collector, 0)
    for arr, labels in feeds:
        feeder.feed_buffer(arr, [p.Label(*lb) for lb in labels])
    assert topo.wait_inactive()
    return collector.get_buffer(), [(lb.id, lb.index, lb.data)
                                    for lb in collector.get_labels()]


def test_feeder_to_collector_buffers_and_labels():
    a = np.arange(10, dtype=np.float32)
    b = np.arange(10, 20, dtype=np.float32)
    feeds = [(a, [("start", None, 0)]), (b, [("mid", 42, 3)])]
    buf, labels = _feed_collect(pkg, fix, "float32", feeds)
    np.testing.assert_array_equal(buf, np.concatenate([a, b]))
    assert labels == [("start", 0, None), ("mid", 13, 42)]
    jbuf, jlabels = _feed_collect(jpkg, jfix, "float32", feeds)
    np.testing.assert_array_equal(buf, jbuf)
    assert labels == jlabels


def test_copier_rechunks_but_preserves_stream_and_labels():
    data = np.arange(1000, dtype=np.int32)
    feeds = [(data[:400], [("L0", None, 5)]),
             (data[400:], [("L1", None, 100)])]
    buf, labels = _feed_collect(pkg, fix, "int32", feeds, copier_seed=123)
    np.testing.assert_array_equal(buf, data)
    assert {lb[0]: lb[1] for lb in labels} == {"L0": 5, "L1": 500}
    jbuf, jlabels = _feed_collect(jpkg, jfix, "int32", feeds, copier_seed=123)
    np.testing.assert_array_equal(buf, jbuf)
    assert sorted(labels) == sorted(jlabels)


def test_signal_slot_wiring():
    class Designer(Block):
        def __init__(self):
            super().__init__()
            self.register_signal("tapsChanged")

        def set_num_taps(self, n):
            self.emit_signal("tapsChanged", list(range(n)))

    class Filter(Block):
        def __init__(self):
            super().__init__()
            self.taps = None

        def set_taps(self, taps):
            self.taps = taps

    d, f = Designer(), Filter()
    topo = Topology(device="cpu")
    topo.connect(d, "tapsChanged", f, "setTaps")
    d.call("setNumTaps", 5)
    assert f.taps == [0, 1, 2, 3, 4]


def test_probe_emits_triggered_signal():
    class Probed(Block):
        def __init__(self):
            super().__init__()
            self.register_probe("value")
            self._v = 7

        def value(self):
            return self._v

    class Sink(Block):
        def __init__(self):
            super().__init__()
            self.seen = []

        def got(self, v):
            self.seen.append(v)

    p, s = Probed(), Sink()
    p.connect_signal("valueTriggered", s, "got")
    assert p.probe("value") == 7
    assert s.seen == [7]


def test_registry_make_and_paths():
    blk = BlockRegistry.make("/comms/fir_filter", "float32", "REAL")
    assert blk is not None and blk.name.startswith("/comms/fir_filter#")
    assert BlockRegistry.exists("/blocks/fir_filter")
    assert BlockRegistry.exists("/comms/fft")
    with pytest.raises(KeyError):
        BlockRegistry.make("/comms/nonexistent")
    # its own registry: the JAX package's other blocks are not in it
    assert set(BlockRegistry.paths()) < set(jpkg.BlockRegistry.paths())
    assert not BlockRegistry.exists("/comms/signal_probe")


def test_feed_test_plan_roundtrip_equals_jax():
    plan = {"seed": 7, "minBuffers": 3, "maxBuffers": 6}
    for dtype in ("float64", "complex_float32", "int16"):
        outs = []
        for p, fx in PACKAGES:
            feeder = fx.FeederSource(dtype)
            collector = fx.CollectorSink(dtype)
            topo = p.Topology(device="cpu") if p is pkg else p.Topology()
            topo.connect(feeder, 0, collector, 0)
            expected = feeder.feed_test_plan(plan)["expected"]
            assert topo.wait_inactive()
            np.testing.assert_array_equal(collector.get_buffer(), expected)
            outs.append(expected)
        np.testing.assert_array_equal(outs[0], outs[1])


class _ClampedPass(Block):
    """A volume-aware pass-through: posts no more than the downstream
    queue can take (Block.clamp_work_size)."""

    def __init__(self):
        super().__init__()
        self.setup_input(0, "float32")
        self.setup_output(0, "float32")

    def work(self):
        port = self.input(0)
        n = self.clamp_work_size(port.elements())
        self.output(0).post(np.array(port.buffer(n), copy=True))
        port.consume(n)


def test_bounded_backpressure_gates_producer():
    """A fast producer ahead of a slow consumer must not grow the edge
    queue beyond its capacity: the producer is skipped by the scheduler
    while the downstream queue is at capacity."""

    class SlowSink(Block):
        def __init__(self):
            super().__init__()
            self.setup_input(0, "float32")
            self.got = 0

        def work(self):
            port = self.input(0)
            n = min(port.elements(), 100)  # drains slowly
            port.consume(n)
            self.got += n

    feeder = fix.FeederSource("float32")
    mid = _ClampedPass()
    sink = SlowSink()
    sink.input(0).set_capacity(256)
    total = 50_000
    for _ in range(50):
        feeder.feed_buffer(np.ones(total // 50, np.float32))
    topo = Topology(device="cpu")
    topo.connect(feeder, 0, mid, 0)
    topo.connect(mid, 0, sink, 0)
    topo.commit()
    max_queue = 0
    for _ in range(10_000):
        if not topo._run_once():
            break
        max_queue = max(max_queue, sink.input(0).elements())
    assert sink.got == total
    assert max_queue <= 256, max_queue


def test_backpressure_message_queue_bound():
    """Message edges are bounded too: a packet flood is gated."""

    class PacketSource(Block):
        def __init__(self, count):
            super().__init__()
            self.setup_output(0)
            self.left = count

        def wants_work(self):
            return self.left > 0

        def work(self):
            if self.left > 0:
                self.output(0).post_message(Packet(np.zeros(8, np.uint8)))
                self.left -= 1

    class SlowPacketSink(Block):
        def __init__(self):
            super().__init__()
            self.setup_input(0)
            self.got = 0

        def work(self):
            if self.input(0).has_message():
                self.input(0).pop_message()
                self.got += 1

    src = PacketSource(500)
    sink = SlowPacketSink()
    sink.input(0).set_capacity(None, messages=16)
    topo = Topology(device="cpu")
    topo.connect(src, 0, sink, 0)
    topo.commit()
    max_q = 0
    for _ in range(5000):
        if not topo._run_once():
            break
        max_q = max(max_q, len(sink.input(0)._messages))
    assert sink.got == 500
    assert max_q <= 17, max_q


def test_input_queue_amortized_copies():
    """Repeated buffer()/consume() cycles over a stream of small parts
    cost amortized O(1) copies per element, not a re-concatenation of
    the whole queue each work call."""
    blk = Block("probe")
    port = blk.setup_input(0, "float32")
    assert isinstance(port, InputPort)
    part = np.arange(256, dtype=np.float32)
    total = 0
    for i in range(2000):
        port.push_buffer(part + i)
        total += 256
        port.buffer()
        port.consume(128)
    assert port.copied_elements < 8 * total, (
        f"copied {port.copied_elements} for {total} streamed elements")
    got = port.buffer()
    assert got.shape[0] == port.elements() == total - 2000 * 128
    np.testing.assert_array_equal(got[:256], part + 1000)


def test_packet_to_stream_to_packet_loopback():
    """Packets framed into a labeled stream and cut back out by MTU."""
    p2s = fix.PacketToStream()
    p2s.set_frame_start_id("fs")
    s2p = fix.StreamToPacket()
    s2p.set_frame_start_id("fs")
    s2p.setMTU(6)
    feeder = fix.FeederSource("uint8")
    sink = fix.CollectorSink("uint8")
    topo = Topology(device="cpu")
    topo.connect(feeder, 0, p2s, 0)
    topo.connect(p2s, 0, s2p, 0)
    topo.connect(s2p, 0, sink, 0)
    payloads = [np.arange(6, dtype=np.uint8) + 10 * i for i in range(3)]
    for pl in payloads:
        feeder.feed_packet(Packet(pl))
    assert topo.wait_inactive()
    assert len(sink.packets) == 3
    for got, exp in zip(sink.packets, payloads):
        np.testing.assert_array_equal(got.payload, exp)


def test_dtype_matrix_maps_to_numpy_and_torch():
    for name in ALL_NAMES:
        d = DType.parse(name)
        assert torch.empty(0, dtype=d.torch).numpy().dtype == d.np
        assert str(d) == str(jpkg.DType.parse(name))
        assert d.storage_shape_suffix == \
            jpkg.DType.parse(name).storage_shape_suffix
    assert DType.parse("complex_int16").torch == torch.int16
    assert DType.parse("complex64").torch == torch.complex64
    assert DType.parse("float, 3").itemsize == 12


def test_topology_takes_an_explicit_device():
    assert Topology().device == torch.device("cuda")
    assert Topology(device="cpu:0").device == torch.device("cpu:0")
    blk = fix.CollectorSink("float32")
    assert blk.device == torch.device("cuda")  # outside any topology


@pytest.mark.parametrize("qname", ["int16", "int32", "complex_int16",
                                   "complex_int64", "float32"])
def test_qformat_equals_jax(qname):
    """float_to_q and from_q (numpy and tensor) equal the JAX package's
    bit for bit, wraparound included."""
    from pothoscomms_tpu.core import qformat as jq
    from pothoscomms_tpu_torch.core import qformat as q

    vals = np.random.default_rng(19).normal(size=33) * 300
    if qname.startswith("complex"):
        vals = vals + 1j * vals[::-1]
    got, exp = q.float_to_q(vals, qname), jq.float_to_q(vals, qname)
    assert got.dtype == exp.dtype
    np.testing.assert_array_equal(got, exp)
    out = "int8" if "int" in qname else "float64"
    np.testing.assert_array_equal(q.from_q(got, out), jq.from_q(exp, out))
    np.testing.assert_array_equal(
        q.from_q(torch.from_numpy(got), out).numpy(), jq.from_q(exp, out))
    assert q.q_dtype_for(DType.parse("int16")) == DType.parse("int32")


def test_vector_source_repeat_under_source_quota():
    src = fix.VectorSource("int16")
    src.set_elements([1, 2, 3])
    src.set_mode("REPEAT")
    sink = fix.CollectorSink("int16")
    topo = Topology(device="cpu")
    topo.connect(src, 0, sink, 0)
    topo.run_source_elements(10)
    np.testing.assert_array_equal(sink.get_buffer(), [1, 2, 3] * 4)
