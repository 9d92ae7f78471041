"""The MAC/LLC layer of the port (blocks/mac.py) against the JAX package:
every case of tests/test_mac.py, with the frames each MAC puts on its
phyOut recorded and compared between the packages byte for byte.

The LLCs draw their nonces from ``random.Random(seed)`` in both packages,
so the same seed puts the same bytes on the wire:
- without loss, the frames in the order of their first transmission are
  equal (a resend repeats a frame byte for byte, so timing, which decides
  whether a timer resends, does not enter the comparison);
- with loss, which frames a dropper drops depends on the resends in
  flight, so the data frames (the PSH frames, each payload's bytes with
  its MAC and LLC headers) are compared as sets; every payload arrives
  intact and in order in both.
Payloads are bytes from numpy.random.default_rng(seed); CRC8 is held
bit for bit to the JAX package's on random data.
"""

import time

import numpy as np
import pytest
import torch

import pothoscomms_tpu as jpkg
import pothoscomms_tpu.blocks.mac as jmac
import pothoscomms_tpu.core.fixtures as jfix
import pothoscomms_tpu_torch as pkg
import pothoscomms_tpu_torch.core.fixtures as fix
from pothoscomms_tpu_torch.blocks.mac import crc8

torch.set_num_threads(1)

PACKAGES = {"port": (pkg, fix), "jax": (jpkg, jfix)}
_PSH = 0x1


def recorder(p, drop=()):
    """A PHY link that records the bytes of every frame it is handed and
    drops the ones whose position is in ``drop`` (the JAX test's
    deterministic PacketDropper)."""

    class Link(p.Block):
        def __init__(self):
            super().__init__()
            self.setup_input(0)
            self.setup_output(0)
            self.frames = []
            self._drop = set(drop)

        def work(self):
            port = self.input(0)
            while port.has_message():
                msg = port.pop_message()
                self.frames.append(bytes(np.asarray(msg.payload, np.uint8)))
                if len(self.frames) - 1 not in self._drop:
                    self.output(0).post_message(msg)

    return Link()


def build_two_stacks(which, links=None, seed=1):
    """Two LLC+MAC stacks back to back (tests/test_mac.py:76); each
    direction goes through a recording link (or the given lossy links,
    whose input frames are recorded)."""
    p, fx = PACKAGES[which]
    port = 123
    feed_a, feed_b = fx.FeederSource("uint8"), fx.FeederSource("uint8")
    coll_a, coll_b = fx.CollectorSink("uint8"), fx.CollectorSink("uint8")
    llc_a = p.BlockRegistry.make("/comms/simple_llc", seed)
    llc_a.set_recipient(0xB)
    llc_a.set_port(port)
    llc_b = p.BlockRegistry.make("/comms/simple_llc", seed + 1)
    llc_b.set_recipient(0xA)
    llc_b.set_port(port)
    mac_a = p.BlockRegistry.make("/comms/simple_mac")
    mac_a.set_mac_id(0xA)
    mac_b = p.BlockRegistry.make("/comms/simple_mac")
    mac_b.set_mac_id(0xB)
    topo = p.Topology(device="cpu") if p is pkg else p.Topology()
    topo.connect(feed_a, 0, llc_a, "dataIn")
    topo.connect(llc_a, "dataOut", coll_a, 0)
    topo.connect(llc_a, "macOut", mac_a, "macIn")
    topo.connect(mac_a, "macOut", llc_a, "macIn")
    topo.connect(feed_b, 0, llc_b, "dataIn")
    topo.connect(llc_b, "dataOut", coll_b, 0)
    topo.connect(llc_b, "macOut", mac_b, "macIn")
    topo.connect(mac_b, "macOut", llc_b, "macIn")
    a2b, b2a = links if links is not None else (recorder(p), recorder(p))
    wire = [recorder(p), recorder(p)]  # phyOut of A, of B
    topo.connect(mac_a, "phyOut", wire[0], 0)
    topo.connect(wire[0], 0, a2b, 0)
    topo.connect(a2b, 0, mac_b, "phyIn")
    topo.connect(mac_b, "phyOut", wire[1], 0)
    topo.connect(wire[1], 0, b2a, 0)
    topo.connect(b2a, 0, mac_a, "phyIn")
    return (topo, (feed_a, feed_b), (coll_a, coll_b), (llc_a, llc_b),
            (mac_a, mac_b), wire)


def first_seen(frames):
    """The frames in the order of their first transmission."""
    return list(dict.fromkeys(frames))


def data_frames(frames):
    """The distinct PSH frames (MAC header of 7 bytes, then the LLC's
    PORT NONCE16 CTRL)."""
    return {f for f in frames if len(f) >= 11 and f[10] & _PSH}


def test_crc8_equals_jax():
    assert crc8([0]) == 0
    assert crc8([1, 2, 3]) == crc8(np.array([1, 2, 3], np.uint8))
    base = crc8([0x55, 0xAA, 0x12])
    assert crc8([0x55, 0xAA, 0x13]) != base
    rng = np.random.default_rng(28)
    for n in (1, 7, 100, 4096):
        data = rng.integers(0, 256, n).astype(np.uint8)
        assert crc8(data) == jmac.crc8(data)


def test_simple_mac_roundtrip():
    payload = np.arange(50, dtype=np.uint8)
    res = {}
    for which, (p, fx) in PACKAGES.items():
        tx = p.BlockRegistry.make("/comms/simple_mac")
        tx.set_mac_id(0xA)
        rx = p.BlockRegistry.make("/comms/simple_mac")
        rx.set_mac_id(0xB)
        feed = fx.FeederSource("uint8")
        feed.feed_packet(p.Packet(payload.copy(), metadata={"recipient": 0xB}))
        sink = fx.CollectorSink("uint8")
        wire = recorder(p)
        topo = p.Topology(device="cpu") if p is pkg else p.Topology()
        topo.connect(feed, 0, tx, "macIn")
        topo.connect(tx, "phyOut", wire, 0)
        topo.connect(wire, 0, rx, "phyIn")
        topo.connect(rx, "macOut", sink, 0)
        topo.commit()
        assert topo.wait_inactive()
        assert rx.get_error_count() == 0
        assert len(sink.packets) == 1
        np.testing.assert_array_equal(sink.packets[0].payload, payload)
        # reply-to semantics: metadata recipient = the sender's id
        assert sink.packets[0].metadata["recipient"] == 0xA
        res[which] = wire.frames
    assert res["port"] == res["jax"] and len(res["port"]) == 1


def test_simple_mac_drops_bad():
    counts = {}
    for which, (p, fx) in PACKAGES.items():
        rx = p.BlockRegistry.make("/comms/simple_mac")
        rx.set_mac_id(0xB)
        feed = fx.FeederSource("uint8")
        feed.feed_packet(p.Packet(np.zeros(3, np.uint8)))  # short
        frame = np.zeros(12, np.uint8)  # wrong recipient
        frame[3:5] = [0, 0xC]
        frame[5:7] = [0, 12]
        frame[0] = crc8(frame[1:12])
        feed.feed_packet(p.Packet(frame.copy()))
        frame2 = frame.copy()  # corrupted CRC
        frame2[3:5] = [0, 0xB]
        frame2[0] = crc8(frame2[1:12]) ^ 0xFF
        feed.feed_packet(p.Packet(frame2))
        sink = fx.CollectorSink("uint8")
        topo = p.Topology(device="cpu") if p is pkg else p.Topology()
        topo.connect(feed, 0, rx, "phyIn")
        topo.connect(rx, "macOut", sink, 0)
        topo.commit()
        assert topo.wait_inactive()
        assert len(sink.packets) == 0
        counts[which] = rx.get_error_count()
    assert counts == {"port": 3, "jax": 3}


def test_two_stack_bidirectional_loopback():
    rng = np.random.default_rng(2)
    pkt_a2b = rng.integers(0, 256, 100).astype(np.uint8)
    pkt_b2a = rng.integers(0, 256, 100).astype(np.uint8)
    wires = {}
    for which in PACKAGES:
        p = PACKAGES[which][0]
        topo, (feed_a, feed_b), (coll_a, coll_b), _, macs, wire = \
            build_two_stacks(which)
        feed_a.feed_packet(p.Packet(pkt_a2b.copy()))
        feed_b.feed_packet(p.Packet(pkt_b2a.copy()))
        topo.commit()
        assert topo.wait_inactive(timeout=5.0)
        assert macs[0].get_error_count() == 0
        assert macs[1].get_error_count() == 0
        assert len(coll_b.packets) == 1 and len(coll_a.packets) == 1
        np.testing.assert_array_equal(coll_b.packets[0].payload, pkt_a2b)
        np.testing.assert_array_equal(coll_a.packets[0].payload, pkt_b2a)
        wires[which] = [first_seen(w.frames) for w in wire]
    assert wires["port"] == wires["jax"]
    assert all(len(w) >= 2 for w in wires["port"])


def test_multi_packet_in_order_delivery():
    rng = np.random.default_rng(3)
    payloads = [rng.integers(0, 256, 20 + i).astype(np.uint8)
                for i in range(10)]
    wires = {}
    for which in PACKAGES:
        p = PACKAGES[which][0]
        topo, (feed_a, _), (_, coll_b), _, _, wire = build_two_stacks(
            which, seed=5)
        for x in payloads:
            feed_a.feed_packet(p.Packet(x.copy()))
        topo.commit()
        assert topo.wait_inactive(timeout=5.0)
        assert len(coll_b.packets) == len(payloads)
        for got, exp in zip(coll_b.packets, payloads):
            np.testing.assert_array_equal(got.payload, exp)
        wires[which] = [first_seen(w.frames) for w in wire]
    assert wires["port"] == wires["jax"]
    assert len(data_frames(wires["port"][0])) == len(payloads)


def test_arq_recovers_from_loss():
    rng = np.random.default_rng(4)
    payloads = [rng.integers(0, 256, 30).astype(np.uint8) for _ in range(5)]
    sent = {}
    for which in PACKAGES:
        p = PACKAGES[which][0]
        links = (recorder(p, {1, 3}), recorder(p, {2}))
        topo, (feed_a, _), (_, coll_b), (llc_a, llc_b), _, wire = \
            build_two_stacks(which, links, seed=7)
        for llc in (llc_a, llc_b):
            llc.set_resend_timeout(0.005)
            llc.set_expire_timeout(2.0)
        for x in payloads:
            feed_a.feed_packet(p.Packet(x.copy()))
        topo.commit()
        assert topo.wait_inactive(timeout=10.0)
        assert llc_a.getExpiredCount() == 0
        assert len(coll_b.packets) == len(payloads)
        for got, exp in zip(coll_b.packets, payloads):
            np.testing.assert_array_equal(got.payload, exp)
        assert llc_a.getResendCount() > 0  # recovery actually exercised
        sent[which] = data_frames(wire[0].frames)
    assert sent["port"] == sent["jax"] and len(sent["port"]) == 5


def test_llc_probes_registered():
    for p, _ in PACKAGES.values():
        llc = p.BlockRegistry.make("/comms/simple_llc", 0)
        assert llc.probe("getResendCount") == 0
        assert llc.probe("getExpiredCount") == 0
        mac = p.BlockRegistry.make("/comms/simple_mac")
        assert mac.probe("getErrorCount") == 0


def _droppers(p, seeds, prob):
    out = []
    for s in seeds:
        d = p.BlockRegistry.make("/blocks/sporadic_dropper", s)
        d.set_probability(prob)
        out.append(d)
    return tuple(out)


def test_arq_with_sporadic_dropper():
    rng = np.random.default_rng(9)
    payloads = [rng.integers(0, 256, 25).astype(np.uint8) for _ in range(8)]
    sent = {}
    for which in PACKAGES:
        p = PACKAGES[which][0]
        topo, (feed_a, _), (_, coll_b), (llc_a, llc_b), _, wire = \
            build_two_stacks(which, _droppers(p, (42, 43), 0.2), seed=11)
        for llc in (llc_a, llc_b):
            llc.set_resend_timeout(0.005)
            llc.set_expire_timeout(5.0)
        for x in payloads:
            feed_a.feed_packet(p.Packet(x.copy()))
        topo.commit()
        assert topo.wait_inactive(timeout=20.0)
        assert llc_a.getExpiredCount() == 0
        assert len(coll_b.packets) == len(payloads)
        for got, exp in zip(coll_b.packets, payloads):
            np.testing.assert_array_equal(got.payload, exp)
        sent[which] = data_frames(wire[0].frames)
    assert sent["port"] == sent["jax"] and len(sent["port"]) == 8


@pytest.mark.parametrize("drop,window,count", [
    (0.2, 8, 40),
    (0.35, 8, 30),
    (0.5, 4, 15),
])
def test_arq_zero_loss_under_heavy_drop(drop, window, count):
    rng = np.random.default_rng(int(drop * 100) + window)
    a2b = [rng.integers(0, 256, 25).astype(np.uint8) for _ in range(count)]
    b2a = [rng.integers(0, 256, 25).astype(np.uint8) for _ in range(count)]
    sent = {}
    for which in PACKAGES:
        p = PACKAGES[which][0]
        topo, (feed_a, feed_b), (coll_a, coll_b), (llc_a, llc_b), _, wire = \
            build_two_stacks(which, _droppers(p, (1000 + window,
                                                  2000 + window), drop),
                             seed=31 + window)
        for llc in (llc_a, llc_b):
            llc.set_resend_timeout(0.002)
            llc.set_expire_timeout(30.0)
            llc.set_window_size(window)
        for x in a2b:
            feed_a.feed_packet(p.Packet(x.copy()))
        for x in b2a:
            feed_b.feed_packet(p.Packet(x.copy()))
        topo.commit()
        assert topo.wait_inactive(timeout=30.0)
        assert llc_a.getExpiredCount() == 0 and llc_b.getExpiredCount() == 0
        assert len(coll_b.packets) == count and len(coll_a.packets) == count
        for got, exp in zip(coll_b.packets, a2b):
            np.testing.assert_array_equal(got.payload, exp)
        for got, exp in zip(coll_a.packets, b2a):
            np.testing.assert_array_equal(got.payload, exp)
        assert llc_a.getResendCount() > 0 and llc_b.getResendCount() > 0
        sent[which] = [data_frames(w.frames) for w in wire]
    assert sent["port"] == sent["jax"]
    assert [len(s) for s in sent["port"]] == [count, count]


def test_timer_fires_under_sustained_load():
    """The LLC's resend timer fires every scheduling round, not only at
    quiescence (tests/test_mac.py:260): a busy side stream keeps every
    round progressing, the first data frame is dropped, and the resend
    must land within 2x the resend timeout + 50 ms, the JAX test's own
    bound. The resent frame equals the JAX package's byte for byte."""
    rng = np.random.default_rng(21)
    payload = rng.integers(0, 256, 40).astype(np.uint8)
    resend = 0.05
    delivered = {}
    for which in PACKAGES:
        p, fx = PACKAGES[which]
        links = (recorder(p, {0}), recorder(p))  # first data frame lost
        topo, (feed_a, _), (_, coll_b), (llc_a, _), _, wire = \
            build_two_stacks(which, links, seed=13)
        llc_a.set_resend_timeout(resend)
        llc_a.set_expire_timeout(10.0)
        feed_a.feed_packet(p.Packet(payload.copy()))
        busy_feed = fx.FeederSource("float32")
        busy_sink = fx.CollectorSink("float32")
        topo.connect(busy_feed, 0, busy_sink, 0)
        topo.commit()
        t0 = time.monotonic()
        delivered_at = None
        while time.monotonic() - t0 < 3.0:
            busy_feed.feed_buffer(np.zeros(256, np.float32))
            topo._run_once()
            if coll_b.packets:
                delivered_at = time.monotonic() - t0
                break
        assert delivered_at is not None, \
            f"{which}: retransmission starved under sustained load"
        assert delivered_at <= 2 * resend + 0.05, (which, delivered_at)
        assert llc_a.getResendCount() >= 1
        np.testing.assert_array_equal(coll_b.packets[0].payload, payload)
        delivered[which] = data_frames(wire[0].frames)
    assert delivered["port"] == delivered["jax"]
    assert len(delivered["port"]) == 1


def test_mac_blocks_registered_under_jax_names():
    for path in ("/comms/simple_mac", "/blocks/simple_mac",
                 "/comms/simple_llc", "/blocks/simple_llc"):
        assert pkg.BlockRegistry.exists(path)
        assert jpkg.BlockRegistry.exists(path)
