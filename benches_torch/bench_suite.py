#!/usr/bin/env python3
"""The BASELINE bench suite on the PyTorch + CUDA port: one JSON line a
workload, {"metric", "value", "unit", ...}.

    python -m pothoscomms_tpu_torch bench [--device DEV] [name ...]
    python benches_torch/bench_suite.py [--device DEV] [name ...]

The port of ``benches/bench_suite.py``: the same seven workloads
(BASELINE configs #1-#5), the same ``metric`` and ``unit`` strings and the
same extra keys on each line, at the same sizes by default:

- fir_1ch: FIRDesigner taps (SINC low-pass, 51) on a float32 sine from
  /comms/waveform_source through /comms/fir_filter into a sink that keeps
  the parts on the device: one source-headed segment (K1's Toeplitz
  product); the whole timed output against np.convolve of the source's
  table walk;
- fft_64ch_1024: ``fft_planar`` on 64 x 32 frames of 1024 points (K2);
- resampler_3_2: the 3:2 rational resampler as one product a step
  (``rational_fir_mm``, K1), 16 channels of 2^19 samples, chained with its
  history;
- fm_chain_256ch: ``compile_chain`` of freq_demod -> dc_removal ->
  envelope_detector over 256 channels of 16384 samples (E1);
- digital_link: packet_to_stream -> preamble_framer ->
  preamble_correlator -> stream_to_packet on the host, 2 x 20 frames;
- digital_modem_bulk: scrambler -> bits_to_symbols -> mapper -> slicer ->
  symbols_to_bits -> descrambler as one fused segment, 2^22 bits;
- digital_link_sharded: ``run_sharded_link`` over the ranks of the
  process group (one rank, NCCL on the card or gloo on the CPU, when
  none is up; S1).

Each workload takes its sizes and ``device`` (None: the card) as keyword
arguments, and the ``build_*`` functions return a workload's step and
inputs untimed. A loop is timed as the JAX suite times it, one warm call
and then ``iters`` calls, between two synchronizations of the device.

A workload that raises, or fails a gate (``parity``, ``bit_exact``,
``quiesced`` or ``all_exact`` false, or a digital link that delivers
fewer frames than it sent), still prints its line and the others still
run; :func:`main` then returns 1. An unknown name returns 2 before
anything runs.
"""

from __future__ import annotations

import json
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from pothoscomms_tpu_torch import (  # noqa: E402
    Block, BlockRegistry, DType, Packet, Topology)
from pothoscomms_tpu_torch.core import placement  # noqa: E402
from pothoscomms_tpu_torch.core.fixtures import (  # noqa: E402
    CollectorSink, FeederSource)

QPSK = np.array([1 + 1j, -1 + 1j, -1 - 1j, 1 - 1j]) / np.sqrt(2)
GATES = ("parity", "bit_exact", "quiesced", "all_exact")


def _sync(dev: torch.device) -> None:
    """Wait for the device's queued work (the card's; the CPU has none)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timeit_chained(fn, x0, dev, iters=8):
    """Seconds a call of ``fn``, whose output is its next input."""
    z = fn(x0)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        z = fn(z)
    _sync(dev)
    return (time.perf_counter() - t0) / iters


def _timeit_pool(fn, pool, dev, iters=8):
    """Seconds a call of ``fn``, cycling the inputs of ``pool``."""
    for p in pool:
        fn(p)
    _sync(dev)
    t0 = time.perf_counter()
    for i in range(iters):
        fn(pool[i % len(pool)])
    _sync(dev)
    return (time.perf_counter() - t0) / iters


class KeepSink(Block):
    """Keeps every part as it arrives: a fused segment's device chunks
    stay on the device until :meth:`get_buffer` copies them out."""

    def __init__(self, dtype):
        super().__init__()
        self.dtype = DType.parse(dtype)
        self.setup_input(0, self.dtype)
        self.input(0).set_capacity(None)
        self.parts = []

    def work(self):
        port = self.input(0)
        n = port.elements()
        if n:
            self.parts.extend(port.take(n))

    def get_buffer(self) -> np.ndarray:
        return np.concatenate([np.asarray(p) for p in self.parts])


# ---------------------------------------------------------------------- #
# config #2: the batched FFT
# ---------------------------------------------------------------------- #
def build_fft_64ch_1024(channels=64, frames=32, nbins=1024, iters=8,
                        device=None):
    """(step, hosts, xs): ``step(x)`` is the forward ``fft_planar`` of x
    [channels * frames, nbins, 2]; ``iters + 1`` distinct inputs as numpy
    (``hosts``, seed 0) and on the device (``xs``)."""
    from pothoscomms_tpu_torch.parallel.fft import fft_planar

    dev = placement.resolve(device)
    rng = np.random.default_rng(0)
    hosts = [rng.normal(size=(channels * frames, nbins, 2)).astype(np.float32)
             for _ in range(iters + 1)]
    xs = [torch.from_numpy(h).to(dev) for h in hosts]
    return (lambda z: fft_planar(z, nbins, False)), hosts, xs


def bench_fft_64ch_1024(channels=64, frames=32, nbins=1024, iters=8,
                        device=None):
    """BASELINE config #2. ``value``: the FFT of ``iters`` distinct inputs
    on the device between two synchronizations, after one untimed pass
    over them (which also leaves the allocator holding their outputs'
    blocks); ``ingest_msamp_s``: one host upload, the FFT and a
    synchronization."""
    dev = placement.resolve(device)
    step, hosts, xs = build_fft_64ch_1024(channels, frames, nbins, iters, dev)
    outs = [step(z) for z in xs[:iters]]
    del outs
    _sync(dev)
    t0 = time.perf_counter()
    outs = [step(z) for z in xs[:iters]]
    _sync(dev)
    dt = (time.perf_counter() - t0) / iters
    if not all(bool(torch.isfinite(o).all()) for o in outs):
        raise FloatingPointError("fft_64ch_1024: non-finite spectra")
    del outs
    fresh = hosts[-1] * np.float32(1.000001)
    t0 = time.perf_counter()
    step(torch.from_numpy(fresh).to(dev))
    _sync(dev)
    ingest_dt = time.perf_counter() - t0
    samples = channels * frames * nbins
    return {"metric": "fft_64ch_1024pt",
            "value": round(samples / dt / 1e6, 2), "unit": "Msamples/s",
            "ingest_msamp_s": round(samples / ingest_dt / 1e6, 2)}


# ---------------------------------------------------------------------- #
# config #1: the single-channel FIR through the block API
# ---------------------------------------------------------------------- #
def fir_1ch_taps(num_taps=51) -> np.ndarray:
    """The taps FIRDesigner emits for a SINC low-pass at 0.1 of the rate."""
    captured = {}

    class _Catch:
        def call(self, name, *args):
            captured["taps"] = np.asarray(args[0])

    designer = BlockRegistry.make("/comms/fir_designer")
    designer.connect_signal("tapsChanged", _Catch(), "setTaps")
    designer.set_filter_type("SINC")
    designer.set_band_type("LOW_PASS")
    designer.set_num_taps(num_taps)
    designer.set_frequency_lower(0.1)
    designer.set_sample_rate(1.0)
    designer._active = True
    designer.recalculate()
    return np.asarray(captured["taps"], np.float64)


def build_fir_1ch(num_taps=51, device=None):
    """(topo, src, sink, taps): waveform_source (float32 SINE at 0.02 of
    the rate) -> fir_filter (the designer's taps) -> KeepSink, committed
    on Topology(device)."""
    taps = fir_1ch_taps(num_taps)
    src = BlockRegistry.make("/comms/waveform_source", "float32")
    src.set_waveform("SINE")
    src.set_frequency(0.02)
    src.set_sample_rate(1.0)
    fir = BlockRegistry.make("/comms/fir_filter", "float32")
    fir.set_taps(taps)
    sink = KeepSink("float32")
    topo = Topology(device=device)
    topo.connect(src, 0, fir, 0)
    topo.connect(fir, 0, sink, 0)
    topo.commit()
    return topo, src, sink, taps


def fir_1ch_oracle(src, taps, start: int, n_out: int) -> np.ndarray:
    """np.convolve of the source's exact table walk, in float64: the
    ``n_out`` outputs whose newest inputs are stream samples ``start``,
    ``start + 1``, ... (the K-1 samples before ``start`` are their
    history)."""
    k1 = len(taps) - 1
    idx = ((start - k1 + np.arange(n_out + k1, dtype=np.int64))
           * src._step) % (src._mask + 1)
    raw = src._table[idx].astype(np.float64)
    return np.convolve(raw, taps)[k1: k1 + n_out]


def bench_fir_1ch(n=1 << 20, reps=4, num_taps=51, device=None):
    """BASELINE config #1: a cold run, a warm run, then ``reps`` timed runs
    of ``n`` samples granted to the source with the output kept on the
    device and one synchronization at the end; the timed output against
    :func:`fir_1ch_oracle` after timing."""
    dev = placement.resolve(device)
    topo, src, sink, taps = build_fir_1ch(num_taps, dev)
    t0 = time.perf_counter()
    topo.run_source_elements(n)
    _sync(dev)
    cold_s = time.perf_counter() - t0
    topo.run_source_elements(n)
    _sync(dev)
    sink.parts.clear()

    t0 = time.perf_counter()
    ok = True
    for _ in range(reps):
        topo.run_source_elements(n)
        ok = topo.wait_inactive(timeout=60.0) and ok
    _sync(dev)
    dt = time.perf_counter() - t0

    t0 = time.perf_counter()
    out = sink.get_buffer()
    host_s = time.perf_counter() - t0
    # the stream's first K-1 samples only filled the FIR's history, so the
    # first timed output's newest input is sample 2n
    exp = fir_1ch_oracle(src, taps, 2 * n, len(out))
    err = float(np.max(np.abs(out - exp.astype(np.float32))))
    seg = topo._segments[0] if topo._segments else None
    return {"metric": "fir_1ch_lowpass",
            "value": round(reps * n / dt / 1e6, 2),
            "unit": "Msamples/s", "max_err": err, "parity": err < 1e-3,
            "quiesced": bool(ok), "cold_s": round(cold_s, 2),
            "host_delivery_msamp_s": round(len(out) / host_s / 1e6, 2),
            "engaged": seg.engage_count if seg else 0}


# ---------------------------------------------------------------------- #
# config #3: the 3:2 rational resampler
# ---------------------------------------------------------------------- #
def build_resampler_3_2(channels=16, n=1 << 19, device=None):
    """(step, x0, hist0, taps): ``step(x, hist) -> (y, hist')`` is one
    product of the blocked-Toeplitz resampler (M = 2, L = 3, 60 complex
    taps, seed 1) over x [channels, n, 2]; ``hist0`` is zero."""
    from pothoscomms_tpu_torch.ops.filter import (
        rational_fir_mm, rational_fir_operators, stack_rational_operators)

    dev = placement.resolve(device)
    M, L, K_TAPS = 2, 3, 60
    rng = np.random.default_rng(1)
    taps = (rng.normal(size=K_TAPS) + 1j * rng.normal(size=K_TAPS)) / K_TAPS
    t0, t1, b_in, b_out = rational_fir_operators(taps, M, L)
    gr, gi = (g.to(dev) for g in stack_rational_operators(t0, t1))
    x0 = torch.from_numpy(
        rng.normal(size=(channels, n, 2)).astype(np.float32)).to(dev)
    hist0 = torch.zeros((channels, K_TAPS // L - 1, 2), device=dev)

    def step(z, h):
        return rational_fir_mm(z, h, gr, gi, b_in, b_out)

    return step, x0, hist0, taps


def bench_resampler_3_2(channels=16, n=1 << 19, iters=8, device=None):
    """BASELINE config #3: each output cut back to ``n`` samples and
    halved is the next input; the history flows from step to step."""
    dev = placement.resolve(device)
    step, x0, hist0, _ = build_resampler_3_2(channels, n, dev)
    state = {"h": hist0}

    def g(z):
        y, state["h"] = step(z, state["h"])
        return y[:, :n] * np.float32(0.5)

    dt = _timeit_chained(g, x0, dev, iters)
    return {"metric": "resampler_3to2_1ch",
            "value": round(channels * n / dt / 1e6, 2),
            "unit": "Msamples/s", "channels": channels}


# ---------------------------------------------------------------------- #
# config #4: the FM receive chain
# ---------------------------------------------------------------------- #
def build_fm_chain_256ch(channels=256, t=16384, pool=4, device=None):
    """(step, carry0, hosts, xs): ``compile_chain`` of freq_demod ->
    dc_removal(64, 2) -> envelope_detector(10, 40) over ``channels``;
    ``pool`` inputs [channels, t, 2] (seed 2) as numpy and on the
    device."""
    from pothoscomms_tpu_torch.parallel.compiler import compile_chain

    dev = placement.resolve(device)
    rng = np.random.default_rng(2)
    demod = BlockRegistry.make("/comms/freq_demod", "complex_float32")
    dc = BlockRegistry.make("/comms/dc_removal", "float32")
    dc.set_average_size(64)
    dc.set_cascade_size(2)
    env = BlockRegistry.make("/comms/envelope_detector", "float32")
    env.set_attack(10.0)
    env.set_release(40.0)
    step, carry0 = compile_chain([demod, dc, env], channels=channels,
                                 device=dev)
    hosts = [rng.normal(size=(channels, t, 2)).astype(np.float32)
             for _ in range(pool)]
    return step, carry0, hosts, [torch.from_numpy(h).to(dev) for h in hosts]


def bench_fm_chain_256ch(channels=256, t=16384, pool=4, iters=8,
                         device=None):
    """BASELINE config #4: the step over a pool of inputs, its carry
    flowing from call to call."""
    dev = placement.resolve(device)
    step, carry0, _, xs = build_fm_chain_256ch(channels, t, pool, dev)
    state = {"carry": carry0}

    def run(x):
        y, state["carry"] = step(x, state["carry"])
        return y

    dt = _timeit_pool(run, xs, dev, iters)
    return {"metric": "fm_chain_256ch",
            "value": round(channels * t / dt / 1e6, 2),
            "unit": "Msamples/s"}


# ---------------------------------------------------------------------- #
# config #5: the framed link (control path), the modem (fast path) and the
# sharded link
# ---------------------------------------------------------------------- #
def build_digital_link(preamble, mtu=256, device=None):
    """(topo, feeder, sink): packet_to_stream -> preamble_framer ->
    preamble_correlator -> stream_to_packet between a uint8 feeder and a
    collector, committed on Topology(device)."""
    feeder = FeederSource("uint8")
    generator = BlockRegistry.make("/blocks/packet_to_stream")
    generator.set_frame_start_id("txStart")
    generator.set_frame_end_id("txEnd")
    framer = BlockRegistry.make("/comms/preamble_framer")
    framer.set_preamble(preamble)
    framer.set_frame_start_id("txStart")
    framer.set_frame_end_id("txEnd")
    framer.set_padding_size(8)
    corr = BlockRegistry.make("/comms/preamble_correlator")
    corr.set_preamble(preamble)
    corr.set_threshold(0)
    corr.set_frame_start_id("rxStart")
    deframer = BlockRegistry.make("/blocks/stream_to_packet")
    deframer.set_frame_start_id("rxStart")
    deframer.set_mtu(mtu)
    sink = CollectorSink("uint8")
    topo = Topology(device=device)
    chain = [feeder, generator, framer, corr, deframer, sink]
    for a, b in zip(chain[:-1], chain[1:]):
        topo.connect(a, 0, b, 0)
    topo.commit()
    return topo, feeder, sink


def bench_digital_link(n_frames=20, mtu=256, device=None):
    """BASELINE config #5, control path: a cold batch of ``n_frames``
    payloads (and a flush packet), then a warm batch behind a sacrificial
    lead frame, which the first batch's flush packet becomes once new
    data arrives; ``value`` counts the payloads delivered bit-exact."""
    rng = np.random.default_rng(3)
    preamble = rng.integers(0, 2, 32).astype(np.uint8)
    payloads = [rng.integers(0, 2, mtu).astype(np.uint8)
                for _ in range(n_frames)]

    t0 = time.perf_counter()
    topo, feeder, sink = build_digital_link(preamble, mtu, device)
    for p in payloads:
        feeder.feed_packet(Packet(p))
    feeder.feed_packet(Packet(np.zeros(len(preamble), np.uint8)))
    ok = topo.wait_inactive(timeout=30.0)
    dt = time.perf_counter() - t0
    delivered = sum(1 for pkt, exp in zip(sink.packets, payloads)
                    if np.array_equal(pkt.payload, exp))
    bits = n_frames * mtu

    payloads2 = [rng.integers(0, 2, mtu).astype(np.uint8)
                 for _ in range(n_frames)]
    first = len(sink.packets)
    t0 = time.perf_counter()
    feeder.feed_packet(Packet(np.zeros(mtu, np.uint8)))
    for p in payloads2:
        feeder.feed_packet(Packet(p))
    feeder.feed_packet(Packet(np.zeros(len(preamble), np.uint8)))
    ok2 = topo.wait_inactive(timeout=30.0)
    dt2 = time.perf_counter() - t0
    # in order, skipping the artifact frames between payloads
    delivered2, ei = 0, 0
    for pkt in sink.packets[first:]:
        for j in range(ei, len(payloads2)):
            if np.array_equal(pkt.payload, payloads2[j]):
                delivered2 += 1
                ei = j + 1
                break
    return {"metric": "digital_link_frames",
            "value": delivered + delivered2,
            "unit": f"bit-exact frames of {2 * n_frames}",
            "kbit_per_s": round(bits / dt2 / 1e3, 1),
            "cold_kbit_per_s": round(bits / dt / 1e3, 1),
            "quiesced": bool(ok and ok2)}


def build_digital_modem_bulk(device=None):
    """(topo, feeder, sink): feeder -> scrambler (additive, 0x8E) ->
    bits_to_symbols(2, MSBit) -> QPSK mapper -> slicer -> symbols_to_bits
    -> descrambler -> KeepSink, committed on Topology(device)."""
    feeder = FeederSource("uint8")
    scr = BlockRegistry.make("/comms/scrambler")
    scr.set_mode("additive")
    scr.set_poly(0x8E)
    b2s = BlockRegistry.make("/comms/bits_to_symbols", 2, "MSBit")
    mapper = BlockRegistry.make("/comms/symbol_mapper", "complex_float32")
    mapper.set_map(QPSK)
    slicer = BlockRegistry.make("/comms/symbol_slicer", "complex_float32")
    slicer.set_map(QPSK)
    s2b = BlockRegistry.make("/comms/symbols_to_bits", 2, "MSBit")
    dsc = BlockRegistry.make("/comms/descrambler")
    dsc.set_mode("additive")
    dsc.set_poly(0x8E)
    sink = KeepSink("uint8")
    topo = Topology(device=device)
    chain = [feeder, scr, b2s, mapper, slicer, s2b, dsc, sink]
    for a, b in zip(chain[:-1], chain[1:]):
        topo.connect(a, 0, b, 0)
    topo.commit()
    return topo, feeder, sink


def bench_digital_modem_bulk(n_bits=1 << 22, device=None):
    """BASELINE config #5, fast path: a cold and a warm batch of
    ``n_bits`` random bits, then a timed one, which must come out bit for
    bit."""
    dev = placement.resolve(device)
    topo, feeder, sink = build_digital_modem_bulk(dev)
    rng = np.random.default_rng(7)
    t0 = time.perf_counter()
    feeder.feed_buffer(rng.integers(0, 2, n_bits).astype(np.uint8))
    topo.wait_inactive(timeout=120.0)
    _sync(dev)
    cold_s = time.perf_counter() - t0
    feeder.feed_buffer(rng.integers(0, 2, n_bits).astype(np.uint8))
    topo.wait_inactive(timeout=120.0)
    _sync(dev)
    sink.parts.clear()

    bits = rng.integers(0, 2, n_bits).astype(np.uint8)
    t0 = time.perf_counter()
    feeder.feed_buffer(bits)
    ok = topo.wait_inactive(timeout=120.0)
    _sync(dev)
    dt = time.perf_counter() - t0

    out = sink.get_buffer()
    exact = len(out) == n_bits and np.array_equal(out, bits)
    seg = topo._segments[0] if topo._segments else None
    return {"metric": "digital_modem_bulk",
            "value": round(n_bits / dt / 1e6, 2), "unit": "Mbit/s",
            "bit_exact": bool(exact), "quiesced": bool(ok),
            "cold_s": round(cold_s, 2),
            "seg_blocks": len(seg.blocks) if seg else 0,
            "fused_bits": seg.fused_elements if seg else 0}


def run_digital_link_sharded(n_bits=64, device=None):
    """(result, seconds) of ``run_sharded_link`` over 2 channels a rank of
    the process group (seed 17, noise 0.01). Without a group, one of this
    process alone is brought up for the run (NCCL on the card, gloo on the
    CPU) and taken down after it."""
    import torch.distributed as dist

    from pothoscomms_tpu_torch.parallel import distributed
    from pothoscomms_tpu_torch.parallel.link import run_sharded_link
    from pothoscomms_tpu_torch.parallel.mesh import make_mesh

    own = not dist.is_initialized()
    with tempfile.TemporaryDirectory() as store:
        if own:
            distributed.initialize(f"file://{store}/store", world_size=1,
                                   rank=0, device=device)
        try:
            mesh = make_mesh(device=device)
            t0 = time.perf_counter()
            res = run_sharded_link(mesh, n_channels=2 * mesh.size,
                                   n_bits=n_bits, seed=17, noise=0.01)
            return res, time.perf_counter() - t0
        finally:
            if own:
                dist.destroy_process_group()


def bench_digital_link_sharded(n_bits=64, device=None):
    """BASELINE config #5: the link with its sync search sharded over the
    ranks (:func:`run_digital_link_sharded`)."""
    res, dt = run_digital_link_sharded(n_bits, device)
    return {"metric": "digital_link_sharded",
            "value": sum(res["bit_exact"]),
            "unit": f"bit-exact channels of {res['channels']}",
            "devices": res["devices"], "all_exact": res["all_exact"],
            "seconds": round(dt, 2)}


ALL = {
    "fir_1ch": bench_fir_1ch,
    "fft_64ch_1024": bench_fft_64ch_1024,
    "resampler_3_2": bench_resampler_3_2,
    "fm_chain_256ch": bench_fm_chain_256ch,
    "digital_link": bench_digital_link,
    "digital_modem_bulk": bench_digital_modem_bulk,
    "digital_link_sharded": bench_digital_link_sharded,
}


def passed(line: dict) -> bool:
    """A line's gates: no error, no gate false, and every frame the
    digital link sent delivered bit-exact (as the JAX package delivers
    them all)."""
    if "error" in line or any(line.get(k) is False for k in GATES):
        return False
    if line["metric"] == "digital_link_frames":
        return line["value"] == int(line["unit"].rsplit(" ", 1)[1])
    return True


USAGE = "usage: bench [--device DEV] [name ...]; names: " + ", ".join(ALL)


def main(argv=None) -> int:
    """Run the named workloads (all by default) on ``--device`` (the card
    by default), one JSON line each. Returns 0, 1 when a workload raised
    or failed a gate, 2 for a bad argument."""
    argv = list(sys.argv[1:] if argv is None else argv)
    device = None
    if "--device" in argv:
        i = argv.index("--device")
        if i + 1 == len(argv):
            print(USAGE, file=sys.stderr)
            return 2
        device = argv.pop(i + 1)
        del argv[i]
        try:
            torch.device(device)
        except RuntimeError as exc:
            print(f"bench: {exc}", file=sys.stderr)
            return 2
    unknown = [a for a in argv if a not in ALL]
    if unknown:
        print(f"bench: unknown workload {', '.join(unknown)}; {USAGE}",
              file=sys.stderr)
        return 2
    rc = 0
    for name in argv or list(ALL):
        try:
            line = ALL[name](device=device)
        except Exception as exc:  # report it, run the other workloads
            traceback.print_exc()
            line = {"metric": name,
                    "error": f"{type(exc).__name__}: {exc}"[:200]}
        print(json.dumps(line), flush=True)
        if not passed(line):
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
