#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (pothoscomms_tpu_torch) on one GPU.

    python3 chip_smoke.py        # from the root of a checkout, one CUDA card

Phases, one or more lines each:
  1. device, versions, TF32 flags (both set False); every entry point of
     the port called with no device (Topology, a lone block's device,
     fir_fft_chain, make_fused_chain, compile_chain, the *_from_numpy
     converters, a scrambler's fused core, make_sync_search,
     make_hamming_profile, make_channel_search) lands on the card;
  2. nvcc build of the port's eight kernels from
     pothoscomms_tpu_torch/csrc/, one nvcc per source, all started
     together;
  3. K1 (cgemm) against its plain PyTorch version on the card, at shapes
     that take each of its two variants (tensor cores, SIMT; the SIMT one
     also at the main path's shape, through an `a` off a 16-byte
     boundary), and at the main path's shape with the chain's own 64-tap
     operator also against a float64 product, beside the plain version's
     error; the variant each launch took; the tensor-core variant's
     operator kernel equal to its plain version bit for bit at that
     operator;
  4. K2 (fft_c2c) against its plain version and a float64 numpy oracle
     (both below 2e-5 of max |reference|), forward and inverse, 37 rows,
     at every power of two from 2 to 4096, the 3-, 5- and 7-smooth sizes
     48, 100, 384, 1000, 1536, 2187, 2401, 3000 and the prime 4093; and
     fft_planar's split for rows above K2's 4096 (8192, 16384);
  5. path "chain", the function-level main path at full width:
     fir_fft_chain(64 complex taps, 1024 bins, 256 channels, 131072
     samples per step), which takes its one-pass form (one K3 launch a
     step, no K1), for three chained steps, against the plain path on
     the card, a float64 numpy oracle, and the carry contract;
  6. the conv branch (200 taps), which reaches K2;
  7. CUDA-event timings of the kernel and plain paths: the main path's
     step, K1
     beside its plain version and one complex64 torch.matmul (and its
     operator build and SIMT variant apart, with K1's 3xTF32 bound, its
     share of it, and the SIMT bound for comparison; K1 and the matmul
     also on the card by torch.profiler), K2 beside
     its plain version and cuFFT at [32768, 1024] and, through
     benches_torch/probe_fft_layout.py's run(), at 32 Mi samples for n in
     256, 1024, 4096, 384, 1000, each of those shapes first held against
     the plain version (below 2e-5 of max |plain|); device times by
     torch.profiler where it kept every event and read no less than the
     bound, else "not measured";
  8. K3 (fir_fft_fused) against its plain version at [32768, 1024] with
     u_w [32768, 64] and the chain's gt [64, 64], and without u_w;
  9. path "one_pass", the one-pass chain make_fused_chain at the same
     width for three chained steps: the float64 oracle, the spectra of
     the combined step (K1, the form fir_fft_chain takes at other
     shapes), the carry, K3's launches; K3's time with and without
     u_w (CUDA events, and on the card by torch.profiler), the step's
     time against the combined step's and, for information, the same
     step composed of library calls (cuFFT, the H multiply, one complex64
     torch.matmul for u_w Gc);
 10. path "block_api": feeder -> /comms/fir_filter (64 complex taps) ->
     /comms/fft (1024) -> collector on Topology(device="cuda:0") with the
     default fuse_threshold, fed 2 x 2^25 samples plus 3*1024+17: the
     fused pair runs the form parallel/chain.fir_fft_form picks (one_pass:
     one K3 launch a quantum, no K1), the drain streams through K2. The
     float64 oracle on windows at the start, at a row and at quantum
     boundaries and at the end, the output length, and the wall time
     from commit() to wait_inactive() with where it went;
 11. path "stream_ceiling": benches_torch/probe_stream_ceiling.py's run()
     (P1, stream_scale, at [32768, 1024] for tb 128, 256, 512; its ms and
     GB/s, the plain version's, one torch._foreach_mul's and copy_'s),
     then P1 equal to its plain version bit for bit at each tb;
 12. path "layout": benches_torch/probe_layout.py's run() (P2,
     layout_move A-D at [4096, 1024]; ms and GB/s per mode beside its
     one-call permute and P1's), then each mode equal to its plain
     version and to the probe's numpy oracle on a host copy, bit for bit;
 13. E1 (envelope_rows) against its plain version, rtol 1e-5 / atol 1e-6
     and bit for bit, at every shape that phases 14 and 15 launch it at,
     derived from the envelope block's own rule: [256, 131072] and
     [256, 16384] blocked at L = Wr = ENVELOPE_BLOCK and [256, 3000]
     unblocked (attack 10, release 40: the FM chain), [1, 2^24] blocked
     and the [1, 17] drain (attack 4, release 16: the FM block API); and
     at two shapes kept from before the redesign, [256, 131072] at
     L = Wr = 8192 and [256, 16384] unblocked. Every case timed, by CUDA
     events and on the card, the plain version at the first. Phases 14
     and 15 note the shape of every E1 launch they make: the FM chain's
     must be exactly the first three, the block API's must include the
     pull's, and a shape not foreseen here (another drain length) is
     held against the plain version there;
 14. path "fm_chain": compile_chain([freq_demod, dc_removal(64, 2),
     envelope(10, 40)], 256) at T = 131072 for three chained steps, two
     at T = 16384 (both blocked envelopes) and two at T = 3000 (not whole
     blocks: the unblocked scan): a phase random walk
     with a carrier offset; the discriminator and DC removal as one F1
     launch a step (fm_demod_dc), F1 held against its plain version at
     every shape the chain launched it at (8 float32 ulps of max |y|,
     the last sample exact) and timed alone at [256, 131072] beside its
     bound (bytes) and its plain version; channels 0 and 255 of step 2
     against a float64 numpy oracle seeded with step 1's tail (atol
     2e-3), every step against the same chain on E1's plain version, two
     half-steps against one step, and the step's time;
 15. path "fm_block_api": feeder -> /comms/freq_demod ->
     /comms/dc_removal (32, 2) -> /comms/envelope_detector (4, 16) ->
     collector on Topology(device="cuda:0"), fed 2^26 + 17 samples (a
     phase random walk with a carrier offset): the segment engages and
     launches E1, the output length is exact, windows
     at the start, across pull boundaries and at the end match a float64
     oracle run from W + 2 D + 1 samples earlier (atol 2e-3), and the wall
     time from commit() to wait_inactive() with where it went;
 16. a summary of the oracle errors of the paths (printed last);
 17. path "split_step": make_split_step(64 complex taps, 1024 bins, R,
     pp = 64) for R in 4, 8, 16, three chained steps each on phase 5's
     inputs (C = 256, T = 131072): R K1 launches a step, each on the
     tensor cores at [32768, 64 + 1024/R] x [64 + 1024/R, 1024/R]; the
     spectra within 1e-4 of the main path's and of the float64
     oracle on two channels, the carry exact; every stream's K1 launch
     of a step against its plain version (1e-5 of max |plain|); the
     step's time by CUDA events and on the card beside the combined and
     one-pass steps, and K1's at each R's shape;
 18. path "resampler_chain": compile_chain([FIR 3:2 (60 complex taps),
     IIR (default biquad)], 16) at T = 2^19 for three steps, and at
     T = 768 for two (the IIR then blocks at 128, not 256): one K1
     launch a step at [32768, 288] x [288, 384]; every step against the
     same chain on K1's plain version (1e-5 of max), two channels of the
     three steps against a float64 oracle (the polyphase sum, then
     scipy's lfilter: resampler 1e-4 of max |y|, IIR output 2e-4
     absolute); the step's time and Msamples/s, the FIR and IIR cores
     alone and the IIR's block scan's share;
 19. path "resampler_block_api": FIRDesigner -> FIR 3:2 -> IIR <-
     IIRDesigner (tapsChanged -> setTaps) with feeder and collector on
     Topology(device="cuda:0"), fed 2^24 + 12345 samples: the segment
     engages for one 2^24 pull (one K1 launch), the rest drains
     streaming; the output length, windows at the start, inside the
     pull, at its boundary and at the end against the float64 oracle
     (atol 2e-4), and the wall time from commit() to wait_inactive();
 20. path "modem_block_api": benches/bench_suite.py bench_digital_modem_bulk's
     chain, feeder -> /comms/scrambler (additive, 0x8E) ->
     bits_to_symbols(2, MSBit) -> QPSK symbol_mapper -> symbol_slicer ->
     symbols_to_bits -> descrambler -> a sink keeping every buffer and
     label, on Topology() (the card), 2^22 random bits: one engaged
     six-block segment (the scramblers as the blocked GF(2) step) returns
     the input bit for bit; again with both scramblers multiplicative, and
     with a label every 65536 bits, which must come out index-adjusted as
     the streaming path adjusts them while the segment stays engaged; the
     wall time from commit() to wait_inactive() with where it went;
 21. path "link": parallel/link.run_link at 256 channels x 4000-bit frames
     (run_sharded_link's per-channel impairments, noise 0.001): every
     channel bit-exact; S1 (sync_search, the frame-sync search) launched
     once for the [256, 32768] batch and held against its plain version
     and a float64 oracle of its formulas on 8 channels; the TX, search
     and RX decode times, S1 alone by events and on the card beside its
     plain version and its bound (the search's least work, 806 float32
     operations an offset: kernels/sync_search.ops_per_offset);
 22. path "frame_sync_block_api": 64 frames of 4000 bits (tx_waveform,
     apply_channel) through /comms/frame_sync (TIMING) -> collector on
     Topology(): 64 frame starts, every frame's payload exact after
     slicing and descrambling with the link's pilot alignment, every S1
     launch shape held to the oracle on that launch's input and timed
     there (events, on the card) beside its bound, the same
     stream on Topology(device="cpu") (the plain search) equal in labels
     and within 1e-5 in symbols; then bench_digital_link's loopback,
     packet_to_stream -> preamble_framer -> preamble_correlator ->
     stream_to_packet, 2 x 20 packets of 256 bits, all 40 exact;
 23. path "wave_chain_block_api": benches/bench_wave_chain.py's chain,
     /comms/waveform_source (SINE, 1.217 MHz at 30.72 MSps) -> scale(0.5)
     -> rotate(0.3) -> FIR (64 complex taps) -> FFT(1024) -> a sink that
     keeps only the checked windows, on the card, on Topology(): runs of
     2^25, 2^25 and 2^27 samples. One source-headed segment of five
     blocks, engaged cold (its first quantum q + 63, before any FIR
     streaming round), cycling to the pair in the form
     parallel/chain.fir_fft_form picks (one_pass: one K3 launch a pair
     quantum); every K1 launch (the FIR singles') on the tensor cores;
     floor((N - 63) / 1024) windows over the N samples
     granted, no sample past the quota; the timed run's host-to-device
     bytes from a torch.profiler trace below one quantum of stream data;
     three windows (the first after the cold start, one across the timed
     run's first quantum boundary, the last) within 1e-4 of max
     |spectrum| of a float64 oracle of the same table walk; wall times
     and Msamples/s;
 24. path "fm_source_block_api": benches/bench_fm_topology.py's chain,
     /comms/noise_source (seed 11, NORMAL, fast) -> freq_demod ->
     dc_removal(32, 2) -> envelope(4, 16) -> a counting sink, runs of 2^25
     and 2^27: one source-headed segment of four blocks launching E1 (each
     launch shape held to E1's plain version, as in [13]); the first 2^22
     outputs against the float64 FM oracle of [14]/[15] on the input
     rebuilt on the host from the pool and the walk's offsets
     (blocks/sources.noise_walk_plain), atol 2e-3; the output count fused
     and streaming (auto_fuse False) at 2^20 + 12345; wall times and
     Msamples/s;
 25. the math catalog on the card: (a) every math block that fuses at
     float32 or complex_float32 (core/testing.FUSED_MATH_CASES), with an
     exact hop, engaged on Topology() at 2^18 + 17 samples, its fused
     cores posting on the card, against the same topology streaming on
     the CPU (comparators, conjugate, rsqrt and ModF bit for bit, the rest
     within their bounds); (b) path "math_fanin_block_api": fan-in
     arithmetic(ADD) -> FFT(1024) at 2^24 + 3089 samples an input, one
     segment with two heads on K2, four windows within 1e-4 of max
     |spectrum| of float64; (c) abs -> modf engaged with its two-output
     tail, equal to the CPU bit for bit;
 26. the control plane on the card (phase_26), each sub-path at the block
     API's full pull of 2^24 samples: (a) path "control_plane_split":
     feeder -> FIR (64 complex taps; K1) -> split_complex; re ->
     threshold(0.5, -0.5) -> abs -> collector, im -> collector and a
     signal_probe (RMS, 2^20): the FIR and split one engaged segment, the
     threshold heading a second (a multi-output tail ends a run), both
     planes within 1e-5 of max |y| of a float64 numpy oracle, the
     threshold's state equal to the host walk over the oracle, the probe
     on its device path within rel 1e-3 of numpy, and its reduction timed;
     (b) path "control_plane_fanin": two float32 feeders ->
     combine_complex -> FFT(1024; K2) with a complex probe on the
     spectra, held to float64 numpy (abs err < 0.01); (c) path
     "control_plane_trigger": FIR (64 taps of 1/64, dyadic data) ->
     split_complex -> a two-port wave_trigger (POS, 1024 points, 4
     windows), its packets' positions, labels and metadata equal to a
     Topology(device="cpu") run; (d) path "control_plane_mac": two MAC +
     LLC stacks, 8 payloads of 64 bytes, lossless and through sporadic
     droppers; (e) query_stats after (a) (every edge conserves its
     samples), path "checkpoint": FIR -> envelope (K1, E1) checkpointed
     with save_state while engaged, resumed by load_state in a fresh
     topology on the card, within 1e-3 of an uninterrupted run, and the
     catalog of all 116 paths without JAX. K1 is held against its plain
     version at every shape these paths launched;
 27. the scale-out layer on the card (phase_27): a one-rank NCCL process
     group (parallel/distributed.initialize on a file:// store under
     build/), make_mesh() with no device on the card, then (a) path
     "sharded_fir_fft": channel_sharded_fir_fft at C=256, T=131072, K=64,
     NBINS=1024, two steps, in fir_fft_chain's form (one_pass: one K3
     launch a step, no K1), the spectra equal to fir_fft_chain's step bit
     for bit, K3 within 1e-5 of its plain version, two channels within
     1e-4 of a float64 oracle, the carry exact, no collective, timed
     beside the unsharded step; (b) path
     "sharded_fir_fft_conv": the same at decim 2 (the polyphase form: K4
     once a step, then K2), K2 at [16384, 1024] held to its plain version
     and the oracle; (c) paths
     "time_sharded_fir" and "grid_sharded_fir" on make_mesh(1, "t") and
     make_2d_mesh(1, 1) at [256, 131072], within 1e-4 of fir_multichannel
     on one device, the carry through an NCCL broadcast, P2P operations
     (0) and collectives (1) counted; (d) path "time_sharded_resampler"
     at config #3's 16 channels (3/2, 60 taps, T = 2^19) against the
     one-device polyphase; (e) path "fm_chain_sharded":
     compile_chain_sharded on the FM chain at [256, 131072], F1 and E1
     (blocked) once a step, equal to compile_chain bit for bit; (f) path "sharded_link":
     run_sharded_link at 256 channels x 4000-bit frames (noise 0.001),
     S1 once at [256, 32768], every channel exact, the arrays equal to
     [21]'s run_link bit for bit and within the float64 oracle's bounds;
     (g) path "dryrun_multichip": dryrun_multichip(1) on the card;
 28. the BASELINE bench suite (phase_28): benches_torch/bench_suite.py in
     this process on the card, every workload at its defaults (the JAX
     suite's sizes), each a path "bench_<name>": fir_1ch (K1, the
     Toeplitz FIR of a source-headed segment), fft_64ch_1024 (K2 at
     [2048, 1024]), resampler_3_2 (K1 at [32768, 288] x [288, 384]),
     fm_chain_256ch (E1 at [256, 16384]), digital_link, digital_modem_bulk
     and digital_link_sharded (a one-rank NCCL group; S1 at [2, L]); each
     line printed, with no error and every gate passed, and K1 on the
     tensor cores; each launch shape no earlier phase held is held against
     its plain version here (K1 through k1_at, K2 below 2e-5 of max
     |plain|, S1 and its plain version within the float64 oracle's
     bounds); then `python -m pothoscomms_tpu_torch bench fft_64ch_1024`
     as a subprocess: exit 0 and its one line.
Then a JSON line of per-kernel results (with each kernel's bound_ms and
bound_by, from this run's shapes and the H100's published peaks, and
library_ms, one PyTorch call computing the same function, or null) and,
last, {"ok": true, "device": {...}}. A failed check exits non-zero without
that last line, and so does a run without CUDA.

Each path is driven with every launch count set to 0 just before it and
read just after. A kernel's ``launches`` in the JSON line is the sum over
the paths, ``launches_by_path`` gives each; the conv branch's are
reported apart, as ``conv_branch_launches``. K1's entry adds
``launches_by_variant`` (per path) and ``operator_launches`` (per path:
each tensor-core launch also launches the operator kernel,
``tf32_operator``) and ``by_shape`` (K1 at the split step's and the
resampler's shapes: its ms, on the card, its plain version's, one complex64
torch.matmul's and its bound); S1's entry adds ``by_shape`` (the link's,
FrameSync's and [28]'s sharded link's launch shapes: launches, the
compiled kernel's plan, ms, on the card, bound); F1's entry
(fm_demod_dc) adds ``device_ms`` and ``launch_shapes`` (C, T, D, cascade
of each launch of [14]); every K1 launch of the
main path, the block API, the split step, the resampler paths and the
bench suite must go to its tensor-core variant.
"""

import contextlib
import functools
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np


# published peaks of one H100 SXM at 700 W (the on-chip measurement
# table): HBM bytes per second, float32 operations per second off the
# tensor cores, dense TF32 operations per second on them
HBM = 3.35e12
F32_OPS = 67e12
TF32_OPS = 495e12


def bound(nbytes: float, ops: float, peak: float = F32_OPS):
    """(ms, "bytes" or "operations"): the least time the card could take
    to move ``nbytes`` (each input read once, each output written once)
    and do ``ops`` operations at ``peak`` per second."""
    t_bytes, t_ops = nbytes / HBM * 1e3, ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def share(bound_ms: float, ms) -> str:
    """The bound's share of a measured time, or "not measured"."""
    return "not measured" if ms is None else f"{bound_ms / ms:.1%}"


def check(cond: bool, msg: str) -> None:
    """Stop the run, exit code 1 and no result line, unless ``cond``."""
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


N26 = 1 << 24  # the block API's full pull (the ladder's top with 1024 bins)


def phase_26(c, n=N26):
    """[26] the control plane on the card, at the block API's full pull.

    ``c`` holds what main() set up: the device and the card's name and
    power limit, ``check``, the launch counters, ``watched``, ``k1_at``
    and the E1 shape notes, the timing helpers and the modules that bind
    K1. Returns the launch counts of each sub-path and the errors held.
    """
    import pickle

    import scipy.signal
    import torch

    from pothoscomms_tpu_torch import BlockRegistry, Packet, Topology
    from pothoscomms_tpu_torch.blocks import utility
    from pothoscomms_tpu_torch.core.fixtures import (CollectorSink,
                                                     FeederSource)
    from pothoscomms_tpu_torch.core.fusion import DeviceChunk
    from pothoscomms_tpu_torch.core.introspect import catalog

    dev, card, check = c.dev, c.card, c.check
    rng = np.random.default_rng(26)
    K, NB = 64, 1024
    launches, errs26 = {}, {}

    def drive(topo, what, timeout=600.0):
        """Unbounded edges (so the pull is the whole backlog), then the
        wall from commit() to wait_inactive()."""
        for b in topo.blocks:
            for p in b.inputs.values():
                p.set_capacity(None)
        t0 = time.perf_counter()
        topo.commit()
        check(topo.wait_inactive(timeout=timeout), f"{what} did not finish")
        c.sync()
        return time.perf_counter() - t0

    def named(blk, name):
        blk.name = name
        return blk

    k1_calls = {}

    def note_k1(path):
        def note(args, out):
            key = (tuple(args[0].shape[:2]), tuple(args[1].shape))
            k1_calls.setdefault(key, [0, args[:3], path])[0] += 1
        return note

    @contextlib.contextmanager
    def k1_watched(path):
        with contextlib.ExitStack() as stack:
            for mod in c.k1_modules:
                stack.enter_context(c.watched(mod, "cgemm", note_k1(path)))
            yield

    # -- (a) FIR -> split_complex; re -> threshold -> abs; im -> a probe --
    taps = (rng.normal(size=K) + 1j * rng.normal(size=K)) / K
    xa = rng.standard_normal(2 * (n + K - 1), dtype=np.float32).view(
        np.complex64)
    fir = named(BlockRegistry.make("/comms/fir_filter", "complex_float32",
                                   "COMPLEX"), "fir")
    fir.set_taps(taps)
    split = named(BlockRegistry.make("/comms/split_complex", "float32"),
                  "split_complex")
    th = named(BlockRegistry.make("/comms/threshold", "float32"),
               "threshold")
    th.set_activation_level(0.5)
    th.set_deactivation_level(-0.5)
    ab = named(BlockRegistry.make("/comms/abs", "float32"), "abs")
    probe = named(BlockRegistry.make("/comms/signal_probe", "float32"),
                  "probe")
    probe.set_mode("RMS")
    probe.set_window(1 << 20)
    feed = named(FeederSource("complex_float32"), "feeder")
    s_re = named(CollectorSink("float32"), "collector_re")
    s_im = named(CollectorSink("float32"), "collector_im")
    topo_a = Topology()
    for a_, ap, b_, bp in ((feed, 0, fir, 0), (fir, 0, split, 0),
                           (split, "re", th, 0), (th, 0, ab, 0),
                           (ab, 0, s_re, 0), (split, "im", s_im, 0),
                           (split, "im", probe, 0)):
        topo_a.connect(a_, ap, b_, bp)
    feed.feed_buffer(xa)
    probe_calls = []

    def note_probe(args, out):
        probe_calls.append(({p.planar.device.type for p in args[1]
                             if isinstance(p, DeviceChunk)},
                            sum(len(p) for p in args[1])))

    c.zero_counts()
    with c.watched(utility.SignalProbe, "_probe_device", note_probe), \
            k1_watched("control_plane_split"):
        wall_a = drive(topo_a, "[26](a)")
    launches["control_plane_split"] = c.read_counts()
    seg_of = {id(s.blocks[0]): s for s in topo_a._segments}
    seg1, seg2 = seg_of.get(id(fir)), seg_of.get(id(th))
    print(f"[26](a) feeder -> FIR({K} complex taps) -> split_complex; re -> "
          f"threshold(0.5, -0.5) -> abs -> collector; im -> collector and "
          f"signal_probe(RMS, 2^20) on {topo_a.device}, {n + K - 1} samples:"
          f" launches {launches['control_plane_split']}; segments "
          + ", ".join(f"{[type(b).__name__ for b in s.blocks]} "
                      f"({s.fused_elements} fused)" for s in topo_a._segments)
          + f"; {wall_a:.3f} s from commit() to wait_inactive() on {card}")
    # a multi-output tail ends a run (both packages): the threshold heads
    # a second segment, fed the split's re plane on the card
    check(seg1 is not None and [type(b).__name__ for b in seg1.blocks]
          == ["FIRFilter", "SplitComplex"] and seg1.fused_elements == n,
          "the FIR and split did not run as one engaged segment")
    check(seg2 is not None and seg2.fused_elements == n,
          "the threshold did not run engaged on the split's re plane")
    check(launches["control_plane_split"]["cgemm"] >= 1,
          "[26](a) did not launch K1")
    y = scipy.signal.fftconvolve(xa.astype(np.complex128), taps, "valid")
    scale_a = np.max(np.abs(y))
    got_re, got_im = s_re.get_buffer(), s_im.get_buffer()
    check(got_re.shape == got_im.shape == (n,),
          f"[26](a) planes of {got_re.shape}, {got_im.shape}")
    errs26["split_re"] = np.max(np.abs(got_re - np.abs(y.real))) / scale_a
    errs26["split_im"] = np.max(np.abs(got_im - y.imag)) / scale_a
    print(f"[26](a) |re| and im planes against the float64 numpy oracle: "
          f"/max|y| {errs26['split_re']:.3e} and {errs26['split_im']:.3e} "
          f"(limit 1e-5), on {card}")
    check(max(errs26["split_re"], errs26["split_im"]) < 1e-5,
          "[26](a) planes disagree with the float64 oracle")
    # query_stats while the segments are engaged: every edge conserves its
    # samples (produced = consumed + queued downstream); the interior edge
    # of an engaged segment counts only what streamed, as in the JAX
    # package
    stats = topo_a.query_stats()
    edges = []
    for blk in topo_a.blocks:
        for oname, out in blk.outputs.items():
            for port in out.downstream:
                produced = stats[blk.name]["outputs"][oname]["produced"]
                down = stats[port.block.name]["inputs"][port.name]
                edges.append((f"{blk.name}[{oname}]->{port.block.name}",
                              produced, down["consumed"], down["queued"]))
    print(f"[26](e) query_stats after (a), (produced, consumed, queued) an "
          f"edge: " + ", ".join(f"{e[0]} {e[1:]}" for e in edges)
          + f"; on {card}")
    check(all(p == cs + q for _, p, cs, q in edges),
          "[26](e) an edge's produced count is not its consumed + queued")
    expect = {"feeder": ("outputs", "0", "produced", n + K - 1),
              "fir": ("inputs", "0", "consumed", n + K - 1),
              "threshold": ("inputs", "0", "consumed", n),
              "collector_re": ("inputs", "0", "consumed", n),
              "collector_im": ("inputs", "0", "consumed", n),
              "probe": ("inputs", "0", "consumed", n)}
    for name, (side, port, key, want) in expect.items():
        check(stats[name][side][port][key] == want,
              f"[26](e) {name} {key} {stats[name][side][port][key]}, "
              f"expected {want}")
    check(stats["split_complex"]["outputs"]["re"]["produced"] == n
          and stats["abs"]["outputs"]["0"]["produced"] == n,
          "[26](e) the segment tails did not count their outputs")
    # the threshold's state comes home from its carry on disengage
    seg2.disengage()
    walk = False
    re64 = y.real
    for i in np.nonzero((re64 > 0.5) | (re64 < -0.5))[0]:
        if not walk and re64[i] > 0.5:
            walk = True
        elif walk and re64[i] < -0.5:
            walk = False
    print(f"[26](a) threshold state after {n} samples: {th._active_state}; "
          f"the host walk over the oracle's re plane: {walk}; on {card}")
    check(th._active_state == walk,
          "[26](a) the threshold's state differs from the host walk")
    rms_ref = float(np.sqrt(np.mean(y.imag[-(1 << 20):] ** 2)))
    print(f"[26](a) probe RMS {probe.value():.9f}, numpy over the oracle's "
          f"last 2^20 im samples {rms_ref:.9f} (rel "
          f"{abs(probe.value() / rms_ref - 1):.2e}, limit 1e-3); probe "
          f"device-path calls {probe_calls}, on {card}")
    check(abs(probe.value() / rms_ref - 1) < 1e-3,
          "[26](a) the probe's RMS disagrees with numpy")
    check(bool(probe_calls) and all(d == {dev.type} for d, _ in probe_calls),
          "[26](a) the probe did not take its device path on the card")
    chunk = DeviceChunk(torch.from_numpy(y.imag[-(1 << 20):].astype(
        np.float32)).to(dev), "float32")
    probe_ms = c.event_ms(lambda: probe._probe_device([chunk]), [()])
    # six device events a call: the cast to float64, the square, the mean
    # (a memset and the reduction), the scalar's copy to the host
    probe_dev_ms = c.device_ms(lambda: probe._probe_device([chunk]), [()],
                               per_call=6)
    print(f"[26](a) the probe's reduction of 2^20 samples on the card: "
          f"{probe_ms:.4f} ms by events (with the scalar's copy to the host)"
          f", {c.f4(probe_dev_ms)} ms of device time, on {card}")
    del topo_a, s_re, s_im, y, xa

    # -- (b) fan-in: two float32 planes -> combine_complex -> FFT(1024) --
    pa = rng.standard_normal(n, dtype=np.float32)
    pb = rng.standard_normal(n, dtype=np.float32)
    cc = BlockRegistry.make("/comms/combine_complex", "float32")
    fft = BlockRegistry.make("/comms/fft", "complex_float32", NB, False)
    sink_b = CollectorSink("complex_float32")
    probe_b = BlockRegistry.make("/comms/signal_probe", "complex_float32")
    probe_b.set_mode("RMS")
    probe_b.set_window(1 << 20)
    f1, f2 = FeederSource("float32"), FeederSource("float32")
    topo_b = Topology()
    for a_, ap, b_, bp in ((f1, 0, cc, "re"), (f2, 0, cc, "im"),
                           (cc, 0, fft, 0), (fft, 0, sink_b, 0),
                           (fft, 0, probe_b, 0)):
        topo_b.connect(a_, ap, b_, bp)
    f1.feed_buffer(pa)
    f2.feed_buffer(pb)
    probe_calls.clear()
    c.zero_counts()
    with c.watched(utility.SignalProbe, "_probe_device", note_probe):
        wall_b = drive(topo_b, "[26](b)")
    launches["control_plane_fanin"] = c.read_counts()
    seg_b = topo_b._segments[0] if topo_b._segments else None
    print(f"[26](b) two float32 feeders -> combine_complex -> FFT({NB}) -> "
          f"collector and signal_probe(RMS) on {topo_b.device}, 2 x {n} "
          f"samples: launches {launches['control_plane_fanin']}; segment of "
          f"{len(seg_b.blocks) if seg_b else 0} blocks with "
          f"{len(seg_b.heads) if seg_b else 0} heads, "
          f"{seg_b.fused_elements if seg_b else 0} fused; {wall_b:.3f} s "
          f"from commit() to wait_inactive() on {card}")
    check(seg_b is not None and len(seg_b.heads) == 2
          and seg_b.fused_elements == n,
          "[26](b) combine_complex -> FFT did not run as one fan-in segment")
    check(launches["control_plane_fanin"]["fft_c2c"] >= 1,
          "[26](b) did not launch K2")
    spec = np.fft.fft((pa.astype(np.float64) + 1j * pb).reshape(-1, NB),
                      axis=1).reshape(-1)
    got_b = sink_b.get_buffer()
    check(got_b.shape == spec.shape, f"[26](b) {got_b.shape} outputs")
    errs26["fanin_fft_abs"] = float(np.max(np.abs(got_b - spec)))
    rms_b = float(np.sqrt(np.mean(np.abs(spec[-(1 << 20):]) ** 2)))
    print(f"[26](b) spectra against float64 numpy: max abs err "
          f"{errs26['fanin_fft_abs']:.3e} (the FFT contract: < 0.01); probe "
          f"RMS {probe_b.value():.6f} against {rms_b:.6f} (rel "
          f"{abs(probe_b.value() / rms_b - 1):.2e}, limit 1e-3), device-path"
          f" calls {probe_calls}, on {card}")
    check(errs26["fanin_fft_abs"] < 0.01,
          "[26](b) spectra breach the FFT contract")
    check(abs(probe_b.value() / rms_b - 1) < 1e-3 and bool(probe_calls)
          and all(d == {dev.type} for d, _ in probe_calls),
          "[26](b) the complex probe disagrees or missed its device path")
    del topo_b, sink_b, spec, got_b, pa, pb

    # -- (c) scope trigger: FIR -> split (fused, on the card) -> a 2-port
    # wave_trigger. The stream and the taps are dyadic (multiples of 1/8,
    # taps 1/64), so the FIR's sums are exact on the card and on the CPU
    # alike and the trigger positions can be held equal.
    nc = n + K - 1
    # a square wave of period 2^21: 8 rising edges, two events of 4 windows
    edge = np.where((np.arange(nc) >> 20) & 1, 1.0, -1.0)
    xc = (edge + rng.integers(-2, 3, nc) / 8
          + 1j * rng.integers(-8, 9, nc) / 8).astype(np.complex64)

    def scope(where):
        fir_c = BlockRegistry.make("/comms/fir_filter", "complex_float32",
                                   "COMPLEX")
        fir_c.set_taps(np.full(K, 1 / K, np.complex128))
        split_c = BlockRegistry.make("/comms/split_complex", "float32")
        trig = BlockRegistry.make("/comms/wave_trigger")
        trig.set_num_ports(2)
        trig.set_slope("POS")
        trig.set_level(0.5)
        trig.set_num_points(1024)
        trig.set_num_windows(4)
        trig.set_hold_off(0)
        trig.set_mode("NORMAL")
        trig.set_event_rate(1e6)
        feed_c = FeederSource("complex_float32")
        pk = CollectorSink("float32")
        topo = Topology(device=where)
        for a_, ap, b_, bp in ((feed_c, 0, fir_c, 0), (fir_c, 0, split_c, 0),
                               (split_c, "re", trig, 0),
                               (split_c, "im", trig, 1), (trig, 0, pk, 0)):
            topo.connect(a_, ap, b_, bp)
        feed_c.feed_buffer(xc)
        wall = drive(topo, f"[26](c) on {where}")
        seg = topo._segments[0] if topo._segments else None
        return pk.packets, seg, wall

    c.zero_counts()
    with k1_watched("control_plane_trigger"):
        pk_card, seg_c, wall_c = scope(dev)
    launches["control_plane_trigger"] = c.read_counts()
    pk_cpu, _, wall_c_cpu = scope("cpu")
    print(f"[26](c) feeder -> FIR({K} taps of 1/{K}) -> split_complex -> "
          f"wave_trigger(2 ports, POS 0.5, 1024 points, 4 windows, NORMAL) "
          f"on the card, {nc} samples: launches "
          f"{launches['control_plane_trigger']}; segment "
          f"{[type(b).__name__ for b in seg_c.blocks] if seg_c else None} "
          f"({seg_c.fused_elements if seg_c else 0} fused); {len(pk_card)} "
          f"packets; {wall_c:.3f} s from commit() to wait_inactive() on "
          f"{card} ({wall_c_cpu:.3f} s on Topology(device='cpu'))")
    check(seg_c is not None and seg_c.fused_elements == n,
          "[26](c) the FIR and split did not run engaged on the card")
    check(launches["control_plane_trigger"]["cgemm"] >= 1,
          "[26](c) did not launch K1")
    check(len(pk_card) == len(pk_cpu) >= 4,
          f"[26](c) {len(pk_card)} packets on the card, {len(pk_cpu)} on the "
          f"CPU")
    worst_c = 0.0
    for p_card, p_cpu in zip(pk_card, pk_cpu):
        same = (p_card.metadata == p_cpu.metadata
                and [(lb.id, lb.index) for lb in p_card.labels]
                == [(lb.id, lb.index) for lb in p_cpu.labels])
        check(same and p_card.payload.shape == p_cpu.payload.shape == (1024,),
              f"[26](c) packet {p_card.metadata} differs from the CPU's "
              f"{p_cpu.metadata}")
        worst_c = max(worst_c, float(np.max(np.abs(
            p_card.payload - p_cpu.payload))))
    errs26["trigger_samples_abs"] = worst_c
    print(f"[26](c) packets on the card against Topology(device='cpu'): "
          f"positions, labels and metadata equal; samples max |d| "
          f"{worst_c:.3e} (limit 1e-5; the FIR's sums are exact here); "
          f"trigger positions "
          f"{[round(float(p.metadata['position']), 4) for p in pk_card if p.metadata['index'] == 0]}"
          f", on {card}")
    check(worst_c <= 1e-5, "[26](c) captured samples differ from the CPU's")

    # -- (d) two MAC + LLC stacks back to back, lossless then lossy -----
    def stacks(droppers):
        feed_a, feed_b = FeederSource("uint8"), FeederSource("uint8")
        coll_b = CollectorSink("uint8")
        llcs, macs = [], []
        for i, (me, peer) in enumerate(((0xA, 0xB), (0xB, 0xA))):
            llc = BlockRegistry.make("/comms/simple_llc", 11 + i)
            llc.set_recipient(peer)
            llc.set_port(123)
            llc.set_resend_timeout(0.005)
            llc.set_expire_timeout(5.0)
            mac = BlockRegistry.make("/comms/simple_mac")
            mac.set_mac_id(me)
            llcs.append(llc)
            macs.append(mac)
        topo = Topology()
        for a_, ap, b_, bp in (
                (feed_a, 0, llcs[0], "dataIn"), (feed_b, 0, llcs[1], "dataIn"),
                (llcs[1], "dataOut", coll_b, 0),
                (llcs[0], "macOut", macs[0], "macIn"),
                (macs[0], "macOut", llcs[0], "macIn"),
                (llcs[1], "macOut", macs[1], "macIn"),
                (macs[1], "macOut", llcs[1], "macIn")):
            topo.connect(a_, ap, b_, bp)
        if droppers is None:
            topo.connect(macs[0], "phyOut", macs[1], "phyIn")
            topo.connect(macs[1], "phyOut", macs[0], "phyIn")
        else:
            topo.connect(macs[0], "phyOut", droppers[0], 0)
            topo.connect(droppers[0], 0, macs[1], "phyIn")
            topo.connect(macs[1], "phyOut", droppers[1], 0)
            topo.connect(droppers[1], 0, macs[0], "phyIn")
        return topo, feed_a, coll_b, llcs, macs

    payloads = [rng.integers(0, 256, 64).astype(np.uint8) for _ in range(8)]
    c.zero_counts()
    for lossy in (False, True):
        droppers = None
        if lossy:
            droppers = []
            for s in (42, 43):
                d = BlockRegistry.make("/blocks/sporadic_dropper", s)
                d.set_probability(0.2)
                droppers.append(d)
        topo_d, feed_a, coll_b, llcs, macs = stacks(droppers)
        for p in payloads:
            feed_a.feed_packet(Packet(p.copy()))
        t0 = time.perf_counter()
        topo_d.commit()
        check(topo_d.wait_inactive(timeout=20.0), "[26](d) did not finish")
        wall_d = time.perf_counter() - t0
        exact = len(coll_b.packets) == len(payloads) and all(
            np.array_equal(g.payload, e)
            for g, e in zip(coll_b.packets, payloads))
        print(f"[26](d) MAC + LLC back to back "
              f"{'through sporadic droppers (0.2, seeds 42, 43)' if lossy else 'lossless'}"
              f": {len(coll_b.packets)} of {len(payloads)} payloads of 64 "
              f"bytes delivered in order and exact: {exact}; MAC errors "
              f"{[m.get_error_count() for m in macs]}, LLC resends "
              f"{[l_.getResendCount() for l_ in llcs]}, expired "
              f"{[l_.getExpiredCount() for l_ in llcs]}; {wall_d:.3f} s on "
              f"the host of {card}")
        check(exact and llcs[0].getExpiredCount() == 0,
              "[26](d) a payload was lost, reordered or changed")
        if lossy:
            check(llcs[0].getResendCount() >= 1,
                  "[26](d) the lossy link never made the LLC resend")
        else:
            check(all(m.get_error_count() == 0 for m in macs),
                  "[26](d) MAC errors on the lossless link")
    launches["control_plane_mac"] = c.read_counts()

    # -- (e) a checkpoint taken while FIR -> envelope is engaged ----------
    xe = rng.standard_normal(n, dtype=np.float32)
    # the FIR's 12 samples of history, then whole pulls: the head drains
    # and the segment stays engaged
    half = 12 + n // 2

    def fir_env():
        fir_e = BlockRegistry.make("/comms/fir_filter", "float32", "REAL")
        fir_e.set_taps(np.hamming(13) / 7)
        env = BlockRegistry.make("/comms/envelope_detector", "float32")
        feed_e = FeederSource("float32")
        sink_e = CollectorSink("float32")
        topo = Topology()
        for a_, b_ in ((feed_e, fir_e), (fir_e, env), (env, sink_e)):
            topo.connect(a_, 0, b_, 0)
        return topo, feed_e, sink_e

    ckpt = Path(__file__).resolve().parent / "build" / "chip_smoke_26.pkl"
    ckpt.parent.mkdir(parents=True, exist_ok=True)
    since = len(c.e1_launched)
    c.zero_counts()
    with c.watched(c.fops, "envelope_rows", c.note_e1), \
            k1_watched("checkpoint"):
        topo1, feed1, sink1 = fir_env()
        feed1.feed_buffer(xe[:half])
        wall_e1 = drive(topo1, "[26](e) first half")
        seg_e = topo1._segments[0] if topo1._segments else None
        check(seg_e is not None and seg_e.engaged,
              "[26](e) the FIR -> envelope segment is not engaged at the "
              "checkpoint")
        t0 = time.perf_counter()
        topo1.save_state(str(ckpt))
        t_save = time.perf_counter() - t0
        size = ckpt.stat().st_size
        with open(ckpt, "rb") as f:
            blob = pickle.load(f)

        def tensors(obj):
            if isinstance(obj, torch.Tensor):
                return 1
            if isinstance(obj, dict):
                return sum(tensors(v) for v in obj.values())
            if isinstance(obj, (list, tuple, set)):
                return sum(tensors(v) for v in obj)
            return 0

        check(tensors(blob) == 0, "[26](e) the checkpoint holds a tensor")
        del blob
        first = sink1.get_buffer()
        topo2, feed2, sink2 = fir_env()
        topo2.commit()
        t0 = time.perf_counter()
        topo2.load_state(str(ckpt))
        t_load = time.perf_counter() - t0
        sink2.clear()  # the collector's restored state holds the first half
        feed2.feed_buffer(xe[half:])
        wall_e2 = drive(topo2, "[26](e) second half")
    launches["checkpoint"] = c.read_counts()
    ckpt.unlink()
    c.hold_e1_launches("checkpoint", since)
    topo3, feed3, sink3 = fir_env()
    feed3.feed_buffer(xe)
    wall_e3 = drive(topo3, "[26](e) uninterrupted")
    resumed = np.concatenate([first, sink2.get_buffer()])
    full = sink3.get_buffer()
    check(resumed.shape == full.shape,
          f"[26](e) resumed {resumed.shape}, uninterrupted {full.shape}")
    errs26["checkpoint_abs"] = float(np.max(np.abs(resumed - full)))
    print(f"[26](e) feeder -> FIR(13 real taps) -> envelope -> collector on "
          f"the card, {n} samples: checkpoint taken engaged after {half} "
          f"({wall_e1:.3f} s), {size} bytes, save {t_save:.3f} s, load into "
          f"a fresh topology on the card {t_load:.3f} s, second half "
          f"{wall_e2:.3f} s (uninterrupted run {wall_e3:.3f} s), all on "
          f"{card}; launches {launches['checkpoint']}; resumed against "
          f"uninterrupted: max |d| {errs26['checkpoint_abs']:.3e} (limit "
          f"1e-3)")
    check(errs26["checkpoint_abs"] <= 1e-3,
          "[26](e) the resumed stream differs from the uninterrupted run")
    check(launches["checkpoint"]["cgemm"] >= 1
          and launches["checkpoint"]["envelope"] >= 1,
          "[26](e) the checkpointed path did not launch K1 and E1")
    del topo1, topo2, topo3, sink1, sink2, sink3, first, resumed, full

    # the catalog, where JAX is not installed
    paths = BlockRegistry.paths()
    cat = catalog()
    comms = [p for p in paths if p.startswith("/comms/")]
    broken = [p for p, d in cat.items() if d.get("type") == "?"]
    print(f"[26](e) registry {len(paths)} paths; catalog() {len(cat)} "
          f"entries for the {len(comms)} /comms/ paths, unconstructible "
          f"{broken}; jax imported: {'jax' in sys.modules}; on {card}")
    check(len(paths) == 116 and sorted(cat) == comms and not broken
          and "jax" not in sys.modules,
          "[26](e) the registry or the catalog is incomplete")

    # K1 against its plain version at each new shape these paths launched
    for count, args, path in k1_calls.values():
        c.k1_by_shape.append(c.k1_at(26, *args, path))
    k1_noted = sum(v[0] for v in k1_calls.values())
    k1_counted = sum(launches[p]["cgemm"] for p in
                     ("control_plane_split", "control_plane_trigger",
                      "checkpoint"))
    check(k1_noted == k1_counted,
          f"[26] K1 calls noted ({k1_noted}) and launches counted "
          f"({k1_counted}) differ")
    return launches, errs26


N27 = 131072  # the north-star step's samples a channel (bench.py)


def phase_27(c, T=N27, CL=256):
    """[27] the scale-out layer on the card: one rank, NCCL at world size
    1, at the north-star width (C=256, K=64, NBINS=1024, ``T`` samples a
    channel a step).

    ``c`` holds what main() set up: as phase_26's, and ``normal`` and
    ``on_card`` (the main generator's float32 draws), ``median_ms``,
    phase 14's ``fm_blocks`` and ``fm_steps``, and [21]'s search arrays
    as ``link_arrays``. Returns the launch counts of each sub-path and a
    summary of what it held and timed.
    """
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    from pothoscomms_tpu_torch.kernels.fft import fft_c2c_plain
    from pothoscomms_tpu_torch.kernels.fir_fft_fused import (
        correction_operand, fir_fft_fused_plain)
    from pothoscomms_tpu_torch.kernels.sync_search import sync_search
    from pothoscomms_tpu_torch.core.testing import (search_agreement,
                                                    sync_search_f64)
    from pothoscomms_tpu_torch.ops import filter as fops
    from pothoscomms_tpu_torch.ops import framing as framing_ops
    from pothoscomms_tpu_torch.parallel import distributed
    from pothoscomms_tpu_torch.parallel.chain import (
        complex_fir_kernel, fir_fft_chain, fir_multichannel)
    from pothoscomms_tpu_torch.parallel.compiler import (
        compile_chain, compile_chain_sharded)
    from pothoscomms_tpu_torch.parallel.dryrun import dryrun_multichip
    from pothoscomms_tpu_torch.parallel.link import run_sharded_link
    from pothoscomms_tpu_torch.parallel.mesh import (
        channel_sharded_fir_fft, gather, grid_sharded_fir, make_mesh, shard,
        time_sharded_fir, time_sharded_resampler)

    dev, card, check = c.dev, c.card, c.check
    rng = np.random.default_rng(27)
    C, K, NB = 256, 64, 1024
    launches, summary = {}, {}

    def wall(fn):
        c.sync()
        t0 = time.perf_counter()
        out = fn()
        c.sync()
        return out, time.perf_counter() - t0

    def rel(got, ref):
        return ((got - ref).abs().max() / ref.abs().max()).item()

    def oracle_rel(spec, x_prev, x_cur, ch, decim):
        """One channel's spectra against float64 numpy: the FIR over the
        previous step's last K-1 samples and this step's, decimated, then
        a 1024-point FFT a window; the error over max |spectrum|."""
        seq = np.concatenate([x_prev[ch, -(K - 1):], x_cur[ch]])
        seq = seq[:, 0].astype(np.float64) + 1j * seq[:, 1]
        y = np.convolve(seq, taps)[K - 1: K - 1 + T: decim]
        exp = np.fft.fft(y.reshape(-1, NB), axis=-1)
        got = spec[ch].cpu().numpy()
        return float(np.max(np.abs(got[..., 0] + 1j * got[..., 1] - exp))
                     / np.max(np.abs(exp)))

    store_dir = tempfile.mkdtemp(prefix="nccl_store_",
                                 dir=Path(__file__).resolve().parent / "build")
    try:
        t0 = time.perf_counter()
        rank_dev = distributed.initialize(f"file://{store_dir}/store",
                                          world_size=1, rank=0)
        mesh = make_mesh()  # no device: the card of this rank, over NCCL
        wall_init = time.perf_counter() - t0
        print(f"[27] process group: {dist.get_backend()} at world size "
              f"{dist.get_world_size()}, rank device {rank_dev}, make_mesh() "
              f"with no device on {mesh.device}, shape {mesh.shape}; "
              f"initialize and make_mesh {wall_init:.3f} s")
        check(dist.get_backend() == "nccl" and mesh.device == dev
              and rank_dev == dev, "[27] the mesh is not on the card over NCCL")

        # -- (a) channel_sharded_fir_fft, in fir_fft_chain's form --------
        taps = (rng.normal(size=K) + 1j * rng.normal(size=K)) / K
        run_a, init_a = channel_sharded_fir_fft(mesh, taps, NB)
        run_ref, _ = fir_fft_chain(taps, NB, C, T, device=dev)
        check(run_a.form == run_ref.form == "one_pass",
              f"[27](a) the sharded step took {run_a.form}, fir_fft_chain "
              f"{run_ref.form}")
        xh = [c.normal(C, T, 2) for _ in range(2)]
        xs = [shard(x, mesh, ("ch",)) for x in xh]
        h0 = init_a(C)
        c.sync()
        mesh.p2p_ops = mesh.collectives = 0
        c.zero_counts()

        def drive_a():
            hs, out = [h0], []
            for x in xs:
                spec, h = run_a(x, hs[-1])
                out.append(spec)
                hs.append(h)
            return out, hs

        (specs, hs), wall_a = wall(drive_a)
        launches["sharded_fir_fft"] = c.read_counts()
        coll_a = (mesh.p2p_ops, mesh.collectives)
        errs_a = []
        h_ref = torch.zeros_like(h0)
        for s, x in enumerate(xs):
            ref, h_ref = run_ref(x, h_ref)
            same = torch.equal(specs[s], ref)
            uw = correction_operand(x, hs[s], NB, K, run_ref.gt.shape[0])
            plain = fir_fft_fused_plain(
                x.reshape(-1, NB, 2), uw, run_ref.H,
                run_ref.gt).reshape(specs[s].shape)
            r_plain = rel(specs[s], plain)
            exact = torch.equal(hs[s + 1], x[:, T - (K - 1):])
            errs_a.append(r_plain)
            print(f"[27](a) step {s}: spectra {tuple(specs[s].shape)} equal "
                  f"to fir_fft_chain's step bit for bit {same}; K3 "
                  f"/max|plain| {r_plain:.3e} (limit 1e-5); carry the last "
                  f"K-1 inputs {exact}")
            check(same and r_plain < 1e-5 and exact
                  and bool(torch.isfinite(specs[s]).all()),
                  f"[27](a) step {s} disagrees with fir_fft_chain's step, "
                  f"K3's plain version or the carry contract")
        ora = [oracle_rel(specs[1], xh[0], xh[1], ch, 1) for ch in (0, C - 1)]
        ms_a = c.median_ms(lambda: run_a(xs[0], h0))
        ms_a1 = c.median_ms(lambda: run_ref(xs[0], h0))
        print(f"[27](a) channel_sharded_fir_fft C={C} T={T} K={K} NBINS={NB}"
              f" ({run_a.form}) on {card}: 2 steps {wall_a:.4f} s; a step "
              f"{ms_a:.3f} ms sharded, {ms_a1:.3f} ms unsharded "
              f"({C * T / ms_a / 1e3:.1f} Msamples/s); float64 oracle, "
              f"channels 0 and {C - 1} of step 1: /max|spectrum| "
              f"{max(ora):.3e} (limit 1e-4); P2P {coll_a[0]}, collectives "
              f"{coll_a[1]}; launches {launches['sharded_fir_fft']}")
        check(max(ora) < 1e-4, "[27](a) disagrees with the float64 oracle")
        check(launches["sharded_fir_fft"]["fir_fft_fused"] == 2
              and launches["sharded_fir_fft"]["cgemm"] == 0
              and coll_a == (0, 0),
              "[27](a) did not launch K3 once a step (and no K1), or "
              "communicated")
        summary["a"] = {"init_s": wall_init, "oracle_rel": max(ora),
                        "k3_rel_plain": max(errs_a), "step_ms": ms_a,
                        "unsharded_ms": ms_a1}
        del specs, hs, h_ref, ref, plain, uw

        # -- (b) decim 2, the polyphase form: K4, then K2 ---------------
        run_b, init_b = channel_sharded_fir_fft(mesh, taps, NB, decim=2)
        kern = complex_fir_kernel(taps).to(dev)
        c.zero_counts()

        def drive_b():
            _, h = run_b(xs[0], init_b(C))
            return run_b(xs[1], h)[0], h

        (spec_b1, h_b), wall_b = wall(drive_b)
        launches["sharded_fir_fft_conv"] = c.read_counts()
        y_b, _ = fir_multichannel(xs[1], h_b, kern, 2)
        frames_b = y_b.reshape(-1, NB, 2)
        r_b = rel(spec_b1.reshape(-1, NB, 2), fft_c2c_plain(frames_b))
        ora_b = max(oracle_rel(spec_b1, xh[0], xh[1], ch, 2)
                    for ch in (0, C - 1))
        ms_b = c.median_ms(lambda: run_b(xs[0], h0))
        print(f"[27](b) channel_sharded_fir_fft decim=2 ({run_b.form}) on "
              f"{card}: spectra {tuple(spec_b1.shape)}, K2 at "
              f"{list(frames_b.shape[:2])}: /max|plain| {r_b:.3e} (limit "
              f"1e-5); float64 oracle /max|spectrum| {ora_b:.3e} (limit "
              f"1e-4); 2 steps {wall_b:.4f} s, a step {ms_b:.3f} ms; "
              f"launches {launches['sharded_fir_fft_conv']}")
        check(r_b < 1e-5 and ora_b < 1e-4,
              "[27](b) disagrees with K2's plain version or the oracle")
        check(launches["sharded_fir_fft_conv"]["fft_c2c"] == 2
              and launches["sharded_fir_fft_conv"]["fir_decim"] == 2,
              "[27](b) did not launch K4 and K2 once a step")
        summary["b"] = {"oracle_rel": ora_b, "k2_rel_plain": r_b,
                        "step_ms": ms_b}
        del spec_b1, y_b, frames_b

        # -- (c) time_sharded_fir and grid_sharded_fir -------------------
        x_c = xs[0]
        carry_c = c.on_card(c.normal(C, K - 1, 2))
        ref_c, tail_c = fir_multichannel(x_c, carry_c, kern)
        ms_c1 = c.median_ms(lambda: fir_multichannel(x_c, carry_c, kern))
        summary["c"] = {}
        for name, m, fn in (
                ("time_sharded_fir", make_mesh(1, "t"), time_sharded_fir),
                ("grid_sharded_fir", distributed.make_2d_mesh(1, 1),
                 grid_sharded_fir)):
            run_c = fn(m, taps)
            c.zero_counts()
            (y_c, carry2), wall_c = wall(lambda: run_c(x_c, carry_c))
            launches[name] = c.read_counts()
            counts = (m.p2p_ops, m.collectives)
            d_c = (y_c - ref_c).abs().max().item()
            same = torch.equal(y_c, ref_c)
            ms_c = c.median_ms(lambda: run_c(x_c, carry_c))
            print(f"[27](c) {name} on mesh {m.shape}, [{C},{T},2] K={K} on "
                  f"{card}: max|d| from fir_multichannel on one device "
                  f"{d_c:.3e} (atol 1e-4; bit for bit {same}); carry through "
                  f"an NCCL broadcast equal to the last K-1 inputs "
                  f"{torch.equal(carry2, tail_c)}; P2P operations "
                  f"{counts[0]}, collectives {counts[1]}; {wall_c:.4f} s "
                  f"first call, {ms_c:.3f} ms a step against "
                  f"{ms_c1:.3f} ms unsharded")
            check(d_c <= 1e-4 and torch.equal(carry2, tail_c)
                  and counts == (0, 1), f"[27](c) {name} disagrees with one "
                  f"device, or sent, or skipped the carry's broadcast")
            summary["c"][name] = {"max_abs": d_c, "p2p": counts[0],
                                  "collectives": counts[1], "ms": ms_c,
                                  "unsharded_ms": ms_c1}
        del y_c, ref_c, tail_c, carry2

        # -- (d) time_sharded_resampler at config #3's 16 channels -------
        M, L, CR = 2, 3, 16
        TR = M * round((1 << 19) / M)  # the multiple of M nearest 2^19
        taps_r = (rng.normal(size=60) + 1j * rng.normal(size=60)) / 60
        phases, KR = fops._polyphase_matrix(taps_r, L)
        tq = c.on_card(np.stack([phases.real, phases.imag], -1))
        x_d = c.on_card(c.normal(CR, TR, 2))
        carry_d = c.on_card(c.normal(CR, KR - 1, 2))
        run_d = time_sharded_resampler(make_mesh(1, "t"), taps_r, M, L)
        c.zero_counts()
        (y_d, carry_d2), wall_d = wall(lambda: run_d(x_d, carry_d))
        launches["time_sharded_resampler"] = c.read_counts()
        xd_h = torch.cat([carry_d, x_d], dim=1)
        ref_d = torch.stack([fops.polyphase_fir(s, tq, M, L, KR, "planar", 0)
                             for s in xd_h])
        ms_d = c.median_ms(lambda: run_d(x_d, carry_d))
        d_d = (y_d - ref_d).abs().max().item()
        r_d = d_d / ref_d.abs().max().item()
        print(f"[27](d) time_sharded_resampler {L}/{M}, 60 taps, [{CR},{TR},"
              f"2] -> {list(y_d.shape)} on {card}: against the one-device "
              f"polyphase max|d| {d_d:.3e}, /max|y| {r_d:.3e} (limit 1e-4; "
              f"bit for bit {torch.equal(y_d, ref_d)}); carry exact "
              f"{torch.equal(carry_d2, x_d[:, TR - (KR - 1):])}; "
              f"first call {wall_d:.4f} s, a step {ms_d:.3f} ms "
              f"({CR * TR / ms_d / 1e3:.1f} Msamples/s in)")
        check(r_d < 1e-4 and torch.equal(carry_d2, x_d[:, TR - (KR - 1):]),
              "[27](d) the resampler disagrees with one device")
        summary["d"] = {"rel": r_d, "first_call_s": wall_d, "step_ms": ms_d}
        del x_d, y_d, ref_d, xd_h

        # -- (e) compile_chain_sharded on the FM chain (E1) --------------
        xf = c.fm_steps(C, T, 2, 27)
        step_s, carry_s = compile_chain_sharded(c.fm_blocks(64, 2, 10.0, 40.0),
                                                C, mesh)
        step_1, carry_1 = compile_chain(c.fm_blocks(64, 2, 10.0, 40.0), C,
                                        device=dev)
        since = len(c.e1_launched)
        c.zero_counts()
        with c.watched(fops, "envelope_rows", c.note_e1):
            ys_e, wall_e = wall(lambda: _fm_run(step_s, carry_s, xf))
        launches["fm_chain_sharded"] = c.read_counts()
        c.hold_e1_launches("fm_chain_sharded", since)
        ys_1 = _fm_run(step_1, carry_1, xf)
        same_e = all(torch.equal(a, b) for a, b in zip(ys_e, ys_1))
        ms_e = c.median_ms(lambda: step_s(xf[0], carry_s))
        print(f"[27](e) compile_chain_sharded FM (freq_demod, dc_removal(64, "
              f"2), envelope(10, 40)) at [{C},{T}] on {card}: 2 steps "
              f"{wall_e:.4f} s, a step {ms_e:.3f} ms; equal to compile_chain "
              f"bit for bit {same_e}; launches "
              f"{launches['fm_chain_sharded']}")
        check(same_e and launches["fm_chain_sharded"]["envelope"] == 2
              and launches["fm_chain_sharded"]["fm_demod_dc"] == 2,
              "[27](e) the sharded FM chain differs from compile_chain or "
              "did not launch F1 and E1 once a step")
        summary["e"] = {"bit_for_bit": same_e, "step_ms": ms_e}
        del xf, ys_e, ys_1

        # -- (f) run_sharded_link at 256 channels x 4000-bit frames (S1) -
        shapes_f = []
        c.zero_counts()
        with c.watched(framing_ops, "sync_search",
                       lambda args, out: shapes_f.append(
                           tuple(args[0].shape))):
            res_f, wall_f = wall(lambda: run_sharded_link(mesh, CL, 4000,
                                                          seed=21,
                                                          noise=0.001))
        launches["sharded_link"] = c.read_counts()
        same_f = all(np.array_equal(a, b) for a, b in
                     zip(res_f["arrays"], c.link_arrays))
        chans = [0, 1, 37, 96, 128, 200, 254, 255]
        n_f = res_f["n_pad"]
        agree = search_agreement(
            [a[chans] for a in res_f["arrays"]],
            sync_search_f64(res_f["x"][chans].cpu().numpy(), [1.0], 0.01,
                            80, 80, 4, 1, n_f))
        sec = res_f["seconds"]
        print(f"[27](f) run_sharded_link {CL} channels x 4000-bit frames "
              f"(noise 0.001) on {card}: {sum(res_f['bit_exact'])} of {CL} "
              f"exact, devices {res_f['devices']}; S1 at {shapes_f}; arrays "
              f"equal to [21]'s run_link bit for bit {same_f}; against the "
              f"float64 oracle on channels {chans}: {agree}; wall "
              f"{wall_f:.3f} s (TX {sec['tx']:.3f}, upload "
              f"{sec['upload']:.3f}, search {sec['search'] * 1e3:.3f} ms, "
              f"RX decode {sec['rx_decode']:.3f}); launches "
              f"{launches['sharded_link']}")
        check(res_f["all_exact"] and res_f["devices"] == 1 and same_f,
              "[27](f) the sharded link is not exact or differs from run_link")
        check(agree["scale_zero_mismatch"] == 0 and agree["peak_mismatch"]
              == 0 and agree["scale_rel"] <= 1e-5 and agree["delta_fc_abs"]
              <= 1e-5 and agree["phase_abs"] <= 2e-3,
              "[27](f) S1 disagrees with the float64 oracle")
        check(launches["sharded_link"]["sync_search"] == 1
              and shapes_f == [(CL, res_f["lp"], 2)],
              "[27](f) did not launch S1 once for the rank's channels")
        summary["f"] = {"exact": sum(res_f["bit_exact"]), "wall_s": wall_f,
                        **sec}
        del res_f

        # -- (g) dryrun_multichip(1) on the card --------------------------
        since = len(c.e1_launched)
        c.zero_counts()
        with c.watched(fops, "envelope_rows", c.note_e1):
            dr, wall_g = wall(lambda: dryrun_multichip(1))
        launches["dryrun_multichip"] = c.read_counts()
        c.hold_e1_launches("dryrun_multichip", since)
        print(f"[27](g) dryrun_multichip(1) on {card}: {dr}, {wall_g:.3f} s; "
              f"launches {launches['dryrun_multichip']}")
        check(dr["channel_fir_fft"][1] < 1e-4 and dr["time_fir"][1] <= 1e-4,
              "[27](g) the dry run disagrees with one device")
        summary["g"] = dr
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(store_dir, ignore_errors=True)
    return launches, summary



def phase_28(c):
    """[28] the BASELINE bench suite of ``benches_torch/bench_suite.py``
    in this process on the card, every workload at its defaults (the JAX
    suite's sizes), each a path with the launch counts set to 0 just
    before it and read just after; then ``python -m pothoscomms_tpu_torch
    bench fft_64ch_1024`` once as a subprocess.

    ``c`` holds what main() set up: as phase_26's, and ``s1_by_shape``
    with S1's ``card_plan`` and ``work``. Every workload's line must carry
    no error and pass its gates; K1 must launch on the tensor cores in
    fir_1ch and resampler_3_2, K2 in fft_64ch_1024, E1 in fm_chain_256ch
    and S1 in digital_link_sharded. One launch of each shape the suite
    launched that an earlier phase did not hold is held against its plain
    version here. Returns the launch counts of each workload's path."""
    import torch

    import bench_suite
    from pothoscomms_tpu_torch.core.testing import (search_agreement,
                                                    sync_search_f64)
    from pothoscomms_tpu_torch.kernels.cgemm import TENSOR_CORES
    from pothoscomms_tpu_torch.kernels.fft import fft_c2c, fft_c2c_plain
    from pothoscomms_tpu_torch.kernels.sync_search import (sync_search,
                                                           sync_search_plain)
    from pothoscomms_tpu_torch.ops import framing as framing_ops
    from pothoscomms_tpu_torch.parallel import fft as pfft_mod

    dev, card, check = c.dev, c.card, c.check
    launches, lines = {}, {}
    k1_calls, k2_calls, s1_calls = {}, {}, {}

    def first_call(calls, key):
        """Notes a call by its key, keeping the first call's inputs."""
        def note(args, out):
            k = key(args)
            if k not in calls:
                calls[k] = [a.clone() if isinstance(a, torch.Tensor) else a
                            for a in args]
        return note

    k1_key = lambda a: (tuple(a[0].shape[:2]), tuple(a[1].shape))  # noqa
    t_phase = time.perf_counter()
    for name, workload in bench_suite.ALL.items():
        since = len(c.e1_launched)
        c.zero_counts()
        with contextlib.ExitStack() as stack:
            for mod in c.k1_modules:
                stack.enter_context(c.watched(mod, "cgemm", first_call(
                    k1_calls.setdefault(name, {}), k1_key)))
            stack.enter_context(c.watched(pfft_mod, "fft_c2c", first_call(
                k2_calls, lambda a: tuple(a[0].shape))))
            stack.enter_context(c.watched(framing_ops, "sync_search",
                                          first_call(s1_calls, lambda a: (
                                              tuple(a[0].shape), a[-1]))))
            stack.enter_context(c.watched(c.fops, "envelope_rows", c.note_e1))
            line = workload(device=dev)
        launches[f"bench_{name}"] = counts = c.read_counts()
        lines[name] = line
        print(f"[28] {name} on {card}: {json.dumps(line)}; launches {counts}")
        check(bench_suite.passed(line), f"[28] {name} failed: {line}")
        check(counts["cgemm_by_variant"][TENSOR_CORES] == counts["cgemm"],
              f"[28] a cgemm launch of {name} missed the tensor cores")
        if name == "fm_chain_256ch":
            c.hold_e1_launches(f"bench_{name}", since)
    want = {"fir_1ch": "cgemm", "resampler_3_2": "cgemm",
            "fft_64ch_1024": "fft_c2c", "fm_chain_256ch": "envelope",
            "digital_link_sharded": "sync_search"}
    for name, kernel in want.items():
        check(launches[f"bench_{name}"][kernel] >= 1,
              f"[28] {name} did not launch {kernel}")

    # K1 at each shape no earlier phase held
    held = {r["shape"] for r in c.k1_by_shape}
    for name, calls in k1_calls.items():
        for (ab, g), args in calls.items():
            if f"[{ab[0]},{ab[1]}]x[{g[0]},{g[1]}]" not in held:
                c.k1_by_shape.append(c.k1_at(28, *args[:3],
                                             f"bench_{name}"))
                held.add(c.k1_by_shape[-1]["shape"])
    print(f"[28] K1 shapes by workload: "
          f"{ {n: sorted(v) for n, v in k1_calls.items() if v} }")
    # K2 at the suite's shape, against its plain version
    for shape, args in k2_calls.items():
        got, ref = fft_c2c(*args), fft_c2c_plain(*args)
        c.sync()
        rel = ((got - ref).abs().max() / ref.abs().max()).item()
        print(f"[28] fft_c2c {list(shape[:2])}: /max|plain| {rel:.3e} "
              f"(limit 2e-5)")
        check(rel < 2e-5, f"[28] fft_c2c at {shape} disagrees with its "
                          f"plain version")
    # S1 at the sharded link's shape, against its plain version, both
    # within the float64 oracle's bounds (as in [21])
    for (shape, n), args in s1_calls.items():
        got, ref = sync_search(*args), sync_search_plain(*args)
        c.sync()
        d_scale = (got[0] - ref[0]).abs().max().item()
        oracle = sync_search_f64(args[0].cpu().numpy(), [1.0], *args[2:])
        for label, arrays in (("S1", got), ("plain", ref)):
            agree = search_agreement([a.cpu().numpy() for a in arrays],
                                     oracle)
            print(f"[28] sync_search {list(shape)} n={n}, {label} vs float64 "
                  f"oracle: {agree}")
            check(agree["scale_zero_mismatch"] == 0
                  and agree["peak_mismatch"] == 0
                  and agree["scale_rel"] <= 1e-5
                  and agree["delta_fc_abs"] <= 1e-5
                  and agree["phase_abs"] <= 2e-3,
                  f"[28] {label} at {shape} disagrees with the float64 oracle")
        b = bound(*c.work(shape[0], shape[1], n, *args[3:7]))
        fn = lambda x: sync_search(x, *args[1:])  # noqa: E731
        ms = c.event_ms(fn, [(args[0],)], calls=20)
        dev_ms = c.device_ms(fn, [(args[0],)], calls=20, per_call=1,
                             floor_ms=b[0])
        c.s1_by_shape[f"{shape[0]}x{shape[1]}"] = {
            "path": "bench_digital_link_sharded", "launches": launches[
                "bench_digital_link_sharded"]["sync_search"],
            "plan": c.card_plan(shape[0], n, args[3]), "ms": ms,
            "device_ms": dev_ms, "bound_ms": b[0], "bound_by": b[1]}
        print(f"[28] on {card}: sync_search {list(shape)} n={n}: max|d scale| "
              f"{d_scale:.3e} against its plain version; {ms:.4f} ms by "
              f"events, {c.f4(dev_ms)} on the card; bound {b[0]:.5f} ms by "
              f"{b[1]}")
    check(bool(s1_calls), "[28] the sharded link made no S1 call")

    # the CLI, as a user runs it
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pothoscomms_tpu_torch", "bench",
         "fft_64ch_1024"], cwd=Path(__file__).resolve().parent,
        capture_output=True, text=True, timeout=600)
    out = proc.stdout.strip().splitlines()
    print(f"[28] python -m pothoscomms_tpu_torch bench fft_64ch_1024: exit "
          f"{proc.returncode} in {time.perf_counter() - t0:.1f} s: {out}")
    check(proc.returncode == 0 and len(out) == 1
          and json.loads(out[0])["metric"] == "fft_64ch_1024pt",
          f"[28] the CLI's bench failed: {proc.stderr[-2000:]}")
    print(f"[28] the phase took {time.perf_counter() - t_phase:.1f} s")
    print(f"[28] summary on {card}: " + json.dumps(
        {n: {k: v for k, v in line.items() if k != "metric"}
         for n, line in lines.items()}))
    return launches


def _fm_run(step, carry, xs):
    ys = []
    for x in xs:
        y, carry = step(x, carry)
        ys.append(y)
    return ys


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: no CUDA card, "
              "nothing run", file=sys.stderr)
        return 1

    sys.path.insert(0, str(Path(__file__).resolve().parent / "benches_torch"))
    import probe_fft_layout
    import probe_layout
    import probe_stream_ceiling
    from probe_stream_ceiling import device_ms, event_ms, median_ms

    from pothoscomms_tpu_torch import BlockRegistry, Topology
    from pothoscomms_tpu_torch.kernels import build
    from pothoscomms_tpu_torch.kernels.cgemm import (
        TENSOR_CORES, cgemm, cgemm_plain, tf32_operator, tf32_operator_plain,
        variant)
    from pothoscomms_tpu_torch.kernels.envelope import (envelope_rows,
                                                        envelope_rows_plain)
    from pothoscomms_tpu_torch.kernels.fir_decim import fir_decim
    from pothoscomms_tpu_torch.kernels.fm_demod_dc import (fm_demod_dc,
                                                           fm_demod_dc_plain)
    from pothoscomms_tpu_torch.kernels.sync_search import (
        card_plan, ops_per_offset, sync_search, sync_search_plain, work)
    from pothoscomms_tpu_torch.kernels.layout_move import (
        MODES, layout_move, layout_move_plain)
    from pothoscomms_tpu_torch.kernels.stream_scale import (
        stream_scale, stream_scale_plain)
    from pothoscomms_tpu_torch.kernels.fft import fft_c2c, fft_c2c_plain
    from pothoscomms_tpu_torch.kernels.fir_fft_fused import (
        fir_fft_fused, fir_fft_fused_plain, make_fused_chain)
    from pothoscomms_tpu_torch.kernels.fir_fft_fused import (
        correction_operand, correction_spectrum, fused_consts_from_numpy)
    from pothoscomms_tpu_torch.parallel.chain import (
        carry_from_numpy, combined_fir_fft_operators, fir_fft_chain,
        fir_fft_combined_step, fir_fft_form, fir_multichannel,
        make_split_step, operators_from_numpy, split_operand,
        stack_combined_operators)
    from pothoscomms_tpu_torch.parallel import compiler as compiler_mod
    from pothoscomms_tpu_torch.parallel.compiler import (
        chain_carry_from_numpy, compile_chain)
    from pothoscomms_tpu_torch.parallel.fft import fft_planar
    from pothoscomms_tpu_torch.ops.framing import (make_hamming_profile,
                                                   make_sync_search)
    from pothoscomms_tpu_torch.parallel.link import make_channel_search

    dev = torch.device("cuda:0")
    rng = np.random.default_rng(0)

    def on_card(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    def normal(*shape):
        return rng.standard_normal(shape, dtype=np.float32)

    def errs(got, ref):
        """(max |got - ref|, that over max |ref|)"""
        d = (got - ref).abs().max().item()
        return d, d / ref.abs().max().item()

    def f4(v):
        """A device time from the profiler, or "not measured" (None)."""
        return "not measured" if v is None else f"{v:.4f}"

    # -- 1. device ------------------------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    def smi(fields):
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
            capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]

    card = smi("name,power.limit")
    print(card)
    print(f"[1] device {torch.cuda.get_device_name(0)} "
          f"(count {torch.cuda.device_count()}), torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, python {sys.version.split()[0]}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    def device_types(obj):
        """The device types of every tensor in obj (tensors, modules,
        nested tuples, the tensors a closure holds)."""
        if isinstance(obj, torch.Tensor):
            return {obj.device.type}
        if isinstance(obj, torch.nn.Module):
            return {b.device.type for b in obj.buffers()}
        if isinstance(obj, (tuple, list)):
            return set().union(*(device_types(o) for o in obj))
        if callable(obj) and getattr(obj, "__closure__", None):
            return set().union(*(device_types(c.cell_contents)
                                 for c in obj.__closure__
                                 if isinstance(c.cell_contents,
                                               torch.Tensor)))
        return set()

    def active(blk):
        blk._active = True  # as a committed topology leaves it
        return blk

    z = np.zeros
    lone = BlockRegistry.make("/comms/dc_removal", "float32")
    defaults = {  # each entry point called with no device
        "Topology()": {Topology().device.type},
        "Block.device (no topology)": {lone.device.type},
        "fir_fft_chain": device_types(fir_fft_chain(np.ones(8) / 8, 64, 2,
                                                    256)),
        "make_fused_chain": device_types(make_fused_chain(np.ones(8) / 8,
                                                          1024)),
        "compile_chain": device_types(compile_chain([lone], 2)[1]),
        "make_split_step": device_types(make_split_step(np.ones(8) / 8, 256,
                                                        4, 16)),
        "operators_from_numpy": device_types(operators_from_numpy(
            (z((3, 4), np.float32),))),
        "carry_from_numpy": device_types(carry_from_numpy(
            z((2, 7, 2), np.float32))),
        "chain_carry_from_numpy": device_types(chain_carry_from_numpy(
            (z((2, 1, 2), np.float32),))),
        "fused_consts_from_numpy": device_types(fused_consts_from_numpy(
            (None, None, None, (z((8, 128), np.float32),) * 2,
             (z((64, 1024), np.float32),) * 2))),
        "scrambler fuse_export": device_types(BlockRegistry.make(
            "/comms/scrambler").fuse_export(1)),
        "waveform_source fuse_source_export": device_types(
            active(BlockRegistry.make("/comms/waveform_source",
                                      "complex_float32")).fuse_source_export(
                1)),
        "make_sync_search": device_types(make_sync_search([1.0], 20, 4,
                                                          0.01)),
        "make_hamming_profile": device_types(make_hamming_profile([1, 0])),
        "make_channel_search": device_types(make_channel_search(
            [1.0], 20, 4, 0.01, 100)[0])}
    print("[1] entry points with no device land on: "
          + ", ".join(f"{k} {sorted(v)}" for k, v in defaults.items()))
    for name, kinds in defaults.items():
        check(kinds == {"cuda"}, f"{name} with no device landed on {kinds}")

    # -- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    sources = ("cgemm", "fft", "fir_fft_fused", "stream_scale",
               "layout_move", "envelope", "sync_search", "fm_demod_dc",
               "fir_decim")
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(build.load, sources))
    print(f"[2] built {', '.join(s + '.cu' for s in sources)} with "
          f"{build.find_nvcc()} in {time.perf_counter() - t0:.2f} s")
    for log in sorted(build.BUILD_DIR.glob("lib*.log")):
        for line in log.read_text().splitlines():
            if ("registers" in line or "Compiling entry" in line
                    or "spill" in line):
                print(f"    {log.stem.split('-')[0]}: {line.strip()}")

    # -- 3. K1 against its plain version, both variants ------------------
    k1_abs = 0.0
    a_main = on_card(normal(32768, 1152, 2))
    gr, gi = on_card(normal(1152, 1024)), on_card(normal(1152, 1024))
    # the same `a` 8 bytes off a 16-byte boundary, which TMA cannot
    # address: the SIMT variant at the main path's shape
    a_simt = torch.empty(a_main.numel() + 2, device=dev)[2:].view(
        a_main.shape).copy_(a_main)
    for label, a, g in (
            ("[32768,1152]x[1152,1024]", a_main, (gr, gi)),
            ("[32768,1152]x[1152,1024], `a` unaligned", a_simt, (gr, gi)),
            ("[37,100]x[100,77]", on_card(normal(37, 100, 2)),
             (on_card(normal(100, 77)), on_card(normal(100, 77)))),
            ("[130,17]x[17,200]", on_card(normal(130, 17, 2)),
             (on_card(normal(17, 200)), on_card(normal(17, 200)))),
            ("[4096,63]x[63,1024]", on_card(normal(4096, 63, 2)),
             (on_card(normal(63, 1024)), on_card(normal(63, 1024))))):
        before = dict(cgemm.launches_by_variant)
        got = cgemm(a, *g)
        ref = cgemm_plain(a, *g)
        torch.cuda.synchronize()
        took = [k for k, v in cgemm.launches_by_variant.items()
                if v != before[k]]
        d, rel = errs(got, ref)
        k1_abs = max(k1_abs, d)
        print(f"[3] cgemm {label} ({took}): max|d| {d:.3e}, /max|ref| "
              f"{rel:.3e} (limit 1e-5)")
        check(rel < 1e-5, f"cgemm {label} disagrees with its plain version")
        check(took == [variant(a.shape[1], g[0].shape[1],
                               a.data_ptr() % 16 == 0)],
              f"cgemm {label} took {took}")
    # the main path's product with the chain's own operator (64 taps,
    # 1024 bins, stacked [G1; G0]), kernel and plain against float64
    taps3 = (rng.normal(size=64) + 1j * rng.normal(size=64)) / 64
    gr3, gi3 = (g.to(dev) for g in stack_combined_operators(
        *combined_fir_fft_operators(taps3, 1024, 128)))
    got = cgemm(a_main, gr3, gi3)
    ref = cgemm_plain(a_main, gr3, gi3)
    exp = torch.view_as_real(torch.view_as_complex(a_main).to(
        torch.complex128) @ torch.complex(gr3.double(), gi3.double()))
    torch.cuda.synchronize()
    d, rel = errs(got, ref)
    k1_abs = max(k1_abs, d)
    _, rel64 = errs(got.double(), exp)
    _, plain64 = errs(ref.double(), exp)
    print(f"[3] cgemm [32768,1152]x[1152,1024], the chain's 64-tap operator: "
          f"/max|plain| {rel:.3e} (limit 1e-5); against float64 "
          f"/max|y|: kernel (3xTF32) {rel64:.3e}, plain (float32) "
          f"{plain64:.3e}; variants {cgemm.launches_by_variant}")
    check(rel < 1e-5 and rel64 < 1e-5,
          "cgemm with the chain's operator disagrees with its plain version "
          "or float64")
    # the operator kernel that every tensor-core launch runs first, at
    # that operator
    hi, lo = tf32_operator(gr3, gi3)
    phi, plo = tf32_operator_plain(gr3, gi3)
    torch.cuda.synchronize()
    same = torch.equal(hi, phi) and torch.equal(lo, plo)
    print(f"[3] tf32_operator [1152,1024] -> 2 x [2048,2304], the chain's "
          f"operator: equal to its plain version {same}")
    check(same, "tf32_operator differs from its plain version")
    del got, ref, exp, gr3, gi3, hi, lo, phi, plo

    # -- 4. K2 against its plain version and a float64 numpy oracle, at
    # every power of two, 3-, 5- and 7-smooth sizes (the Stockham plan's
    # mixed radices) and a prime (the direct DFT); 37 rows, so that a block
    # of several rows is ragged --------------------------------------------
    k2_abs = 0.0
    k2_sizes = [2 ** k for k in range(1, 13)] + [48, 100, 384, 1000, 1536,
                                                 2187, 2401, 3000, 4093]
    for n in k2_sizes:
        for inverse in (False, True):
            xh = normal(37, n, 2)
            x = on_card(xh)
            got = fft_c2c(x, inverse)
            ref = fft_c2c_plain(x, inverse)
            torch.cuda.synchronize()
            d, rel = errs(got, ref)
            xc = xh[..., 0].astype(np.float64) + 1j * xh[..., 1]
            exp = np.fft.ifft(xc, axis=-1) * n if inverse \
                else np.fft.fft(xc, axis=-1)
            g = got.cpu().numpy()
            rel64 = np.max(np.abs(g[..., 0] + 1j * g[..., 1] - exp)) \
                / np.max(np.abs(exp))
            k2_abs = max(k2_abs, d)
            print(f"[4] fft_c2c n={n} {'inv' if inverse else 'fwd'}: "
                  f"/max|plain| {rel:.3e} (limit 2e-5), /max|float64 "
                  f"numpy| {rel64:.3e} (limit 2e-5)")
            check(rel < 2e-5 and rel64 < 2e-5, f"fft_c2c n={n} inverse="
                  f"{inverse} disagrees with its plain version or numpy")
    for n in (8192, 16384):  # above K2's 4096: the two-factor split
        for inverse in (False, True):
            x = on_card(normal(64, n, 2))
            before = fft_c2c.launches
            got = fft_planar(x, n, inverse)
            ref = fft_c2c_plain(x, inverse)
            torch.cuda.synchronize()
            d, rel = errs(got, ref)
            k2_abs = max(k2_abs, d)
            print(f"[4] fft_planar n={n} {'inv' if inverse else 'fwd'}: "
                  f"{fft_c2c.launches - before} fft_c2c launches, "
                  f"/max|plain| {rel:.3e} (limit 2e-5)")
            check(fft_c2c.launches - before == 2,
                  f"fft_planar n={n} did not run both factors on K2")
            check(rel < 2e-5, f"fft_planar n={n} inverse={inverse} "
                              f"disagrees with its plain version")

    # -- 5 + 6. drive the main path, then the conv branch, each with the
    # launch counts set to 0 just before it and read just after ----------
    C, T, K, NB = 256, 131072, 64, 1024
    taps = (rng.normal(size=K) + 1j * rng.normal(size=K)) / K
    run, carry0 = fir_fft_chain(taps, NB, C, T, device=dev)
    check(run.form == "one_pass", f"main path took the {run.form} branch")
    xs_host = [normal(C, T, 2) for _ in range(3)]
    xs = [on_card(x) for x in xs_host]
    C6, T6, K6 = 16, 16384, 200
    taps6 = (rng.normal(size=K6) + 1j * rng.normal(size=K6)) / K6
    run6, carry6 = fir_fft_chain(taps6, NB, C6, T6, device=dev)
    check(run6.form == "conv", f"200 taps took the {run6.form} branch")
    xs6 = [on_card(normal(C6, T6, 2)) for _ in range(2)]
    torch.cuda.synchronize()

    wrappers = {"cgemm": cgemm, "tf32_operator": tf32_operator,
                "fft_c2c": fft_c2c,
                "fir_fft_fused": fir_fft_fused, "stream_scale": stream_scale,
                "layout_move": layout_move, "envelope": envelope_rows,
                "sync_search": sync_search, "fm_demod_dc": fm_demod_dc,
                "fir_decim": fir_decim}

    def zero_counts():
        for w in wrappers.values():
            w.launches = 0
        for k in cgemm.launches_by_variant:
            cgemm.launches_by_variant[k] = 0

    def read_counts():
        torch.cuda.synchronize()
        counts = {name: w.launches for name, w in wrappers.items()}
        counts["cgemm_by_variant"] = dict(cgemm.launches_by_variant)
        return counts

    zero_counts()
    carries, specs = [carry0], []
    for x in xs:
        spec, carry = run(x, carries[-1])
        specs.append(spec)
        carries.append(carry)
    launches = read_counts()
    zero_counts()
    carries6, specs6 = [carry6], []
    for x in xs6:
        spec, carry = run6(x, carries6[-1])
        specs6.append(spec)
        carries6.append(carry)
    conv_launches = read_counts()

    # -- 5. checks of the main path ---------------------------------------
    print(f"[5] main path fir_fft_chain C={C} T={T} K={K} NBINS={NB} "
          f"({run.form}): launches fir_fft_fused {launches['fir_fft_fused']}"
          f", cgemm {launches['cgemm']}, fft_c2c {launches['fft_c2c']}")
    check(launches["fir_fft_fused"] == len(xs),
          "main path did not launch fir_fft_fused once a step")
    check(launches["cgemm"] == launches["tf32_operator"] == 0,
          "main path launched cgemm")
    # the plain path: K3's plain version on the same correction operand,
    # its Gc planes built once
    pp5, gc5 = run.gt.shape[0], correction_spectrum(run.gt, NB)

    def plain_step(x, carry):
        return fir_fft_fused_plain(
            x.reshape(-1, NB, 2), correction_operand(x, carry, NB, K, pp5),
            run.H, run.gt, gc5)

    for s, x in enumerate(xs):
        spec = specs[s]
        check(spec.shape == (C, T // NB, NB, 2), f"step {s} shape "
                                                 f"{tuple(spec.shape)}")
        check(bool(torch.isfinite(spec).all()), f"step {s} not finite")
        ref = plain_step(x, carries[s]).reshape(spec.shape)
        _, rel = errs(spec, ref)
        exact = torch.equal(carries[s + 1], x[:, T - (K - 1):])
        print(f"[5] step {s}: /max|plain| {rel:.3e} (limit 1e-5), carry "
              f"exact {exact}")
        check(rel < 1e-5, f"step {s} disagrees with the plain path")
        check(exact, f"step {s} carry is not the last K-1 inputs")
    for ch in (0, C - 1):
        prev, cur = xs_host[1][ch], xs_host[2][ch]
        seq = np.concatenate([prev[T - (K - 1):], cur])
        seq = seq[:, 0].astype(np.float64) + 1j * seq[:, 1]
        y = np.convolve(seq, taps)[K - 1: K - 1 + T]
        exp = np.fft.fft(y.reshape(T // NB, NB), axis=-1)
        got = specs[2][ch].cpu().numpy()
        rel = np.max(np.abs(got[..., 0] + 1j * got[..., 1] - exp)) \
            / np.max(np.abs(exp))
        print(f"[5] step 2 channel {ch} vs float64 numpy oracle: "
              f"/max|spectrum| {rel:.3e} (limit 1e-4)")
        check(rel < 1e-4, f"channel {ch} disagrees with the numpy oracle")

    # -- 6. checks of the conv branch -------------------------------------
    print(f"[6] conv branch C={C6} T={T6} K={K6} NBINS={NB}: launches "
          f"cgemm {conv_launches['cgemm']}, "
          f"fft_c2c {conv_launches['fft_c2c']}")
    check(conv_launches["fft_c2c"] >= len(xs6),
          "conv branch did not launch fft_c2c")
    for s, x in enumerate(xs6):
        y, _ = fir_multichannel(x, carries6[s], run6.kernel)
        ref = fft_c2c_plain(y.reshape(-1, NB, 2)).reshape(specs6[s].shape)
        _, rel = errs(specs6[s], ref)
        exact = torch.equal(carries6[s + 1], x[:, T6 - (K6 - 1):])
        print(f"[6] step {s}: /max|plain| {rel:.3e} (limit 1e-5), carry "
              f"exact {exact}")
        check(rel < 1e-5, f"conv step {s} disagrees with the plain path")
        check(exact, f"conv step {s} carry is not the last K-1 inputs")

    # -- 7. timings (CUDA events, median of 5 after a quarter second of
    # warm-up); the plain step builds the same operand against the same
    # stacked operator buffers as the kernel step ----------------------
    x0 = xs[0]
    step_ms = median_ms(lambda: run(x0, carry0))
    step_plain_ms = median_ms(lambda: plain_step(x0, carry0))
    k1_ms = median_ms(lambda: cgemm(a_main, gr, gi))
    k1_plain_ms = median_ms(lambda: cgemm_plain(a_main, gr, gi))
    # K1's tensor-core variant rebuilds its operator on each call: that
    # build alone, and the SIMT variant at the same shape (phase 3's
    # unaligned `a`)
    k1_operator_ms = median_ms(lambda: tf32_operator(gr, gi))
    k1_simt_ms = median_ms(lambda: cgemm(a_simt, gr, gi))
    del a_simt
    # one complex64 torch.matmul computes K1's product: its library yardstick
    a_c, g_c = torch.view_as_complex(a_main), torch.complex(gr, gi)
    k1_lib_ms = median_ms(lambda: torch.matmul(a_c, g_c))
    # on the card (torch.profiler): K1's two kernels (operator build and
    # product) a call, screened by K1's own bound, and the library call's,
    # by the bytes
    k1_bytes = 4 * (32768 * 1152 * 2 + 2 * 1152 * 1024 + 32768 * 1024 * 2)
    k1_floor = probe_stream_ceiling.bytes_bound_ms(k1_bytes)
    k1_flops = 8 * 32768 * 1152 * 1024
    # the tensor-core variant's work: three TF32 passes on the tensor cores
    k1_bound = bound(k1_bytes, 3 * k1_flops, TF32_OPS)
    k1_device_ms = device_ms(cgemm, [(a_main, gr, gi)], per_call=2,
                             floor_ms=k1_bound[0])
    k1_lib_device_ms = device_ms(torch.matmul, [(a_c, g_c)],
                                 floor_ms=k1_floor)
    del a_c, g_c
    frames = specs[0].reshape(-1, NB, 2)
    k2_ms = median_ms(lambda: fft_c2c(frames))
    k2_plain_ms = median_ms(lambda: fft_c2c_plain(frames))
    k2_cufft_ms = median_ms(lambda: probe_fft_layout.cufft(frames))
    # the kernels' own time on the card (torch.profiler), without the
    # host's enqueue, which CUDA events around one call include; None
    # where the profiler lost events or read below the bound
    k2_floor = probe_stream_ceiling.bytes_bound_ms(2 * frames.numel() * 4)
    k2_device_ms = device_ms(fft_c2c, [(frames,)], per_call=1,
                             floor_ms=k2_floor)
    k2_cufft_device_ms = device_ms(probe_fft_layout.cufft, [(frames,)],
                                   floor_ms=k2_floor)
    # K2, its plain version and cuFFT at 32 Mi samples, each shape's
    # output first held against the plain version's
    k2_by_n = probe_fft_layout.run()
    print(f"[7] clocks.sm, power.draw after timing: "
          f"{smi('clocks.sm,power.draw')}")
    print(f"[7] on {card}: main path step {step_ms:.3f} ms "
          f"({C * T / step_ms / 1e3:.1f} Msamples/s), plain step "
          f"{step_plain_ms:.3f} ms")
    k1_simt_bound = bound(k1_bytes, k1_flops)
    print(f"[7] cgemm [32768,1152]x[1152,1024] {k1_ms:.3f} ms (tensor "
          f"cores, its operator build {k1_operator_ms:.4f} ms of it; "
          f"{f4(k1_device_ms)} ms on the card; SIMT variant "
          f"{k1_simt_ms:.3f} ms), plain (4 x torch.matmul) "
          f"{k1_plain_ms:.3f} ms, one complex64 torch.matmul "
          f"{k1_lib_ms:.3f} ms ({f4(k1_lib_device_ms)} on the card); bound {k1_bound[0]:.3f} ms by "
          f"{k1_bound[1]} (3xTF32 at {TF32_OPS / 1e12:.0f} TFLOP/s; "
          f"{k1_bound[0] / k1_ms:.1%} of it, "
          f"{3 * k1_flops / k1_ms / 1e9:.1f} TFLOP/s of TF32 passes), "
          f"SIMT bound {k1_simt_bound[0]:.3f} ms by {k1_simt_bound[1]}")
    print(f"[7] fft_c2c [32768,1024] {k2_ms:.4f} ms ({f4(k2_device_ms)} "
          f"ms on the card), plain (DFT matmuls) {k2_plain_ms:.3f} ms, cuFFT "
          f"{k2_cufft_ms:.4f} ms ({f4(k2_cufft_device_ms)} on the card)")
    for n, r in k2_by_n.items():
        print(f"[7] fft_c2c n={n} at 32 Mi samples: /max|plain| "
              f"{r['max_rel']:.3e} (limit 2e-5); {r['ms']:.4f} ms "
              f"({f4(r['device_ms'])} on the card), plain "
              f"{r['plain_ms']:.3f} ms, cuFFT {r['library_ms']:.4f} ms "
              f"({f4(r['library_device_ms'])} on the card; bound "
              f"{r['bound_ms']:.4f} ms)")
        check(r["max_rel"] < 2e-5, f"fft_c2c n={n} at 32 Mi samples "
                                   f"disagrees with its plain version")

    # -- 8. K3 against its plain version at full width --------------------
    run3 = make_fused_chain(taps, NB, device=dev)
    x8, uw8 = on_card(normal(C * T // NB, NB, 2)), on_card(normal(C * T // NB,
                                                                  64, 2))
    got = fir_fft_fused(x8, uw8, run3.H, run3.gt)
    ref = fir_fft_fused_plain(x8, uw8, run3.H, run3.gt)
    got_nc = fir_fft_fused(x8, None, run3.H, run3.gt)
    ref_nc = fir_fft_fused_plain(x8, None, run3.H, run3.gt)
    torch.cuda.synchronize()
    k3_abs, k3_rel = errs(got, ref)
    d_nc, rel_nc = errs(got_nc, ref_nc)
    k3_abs = max(k3_abs, d_nc)
    print(f"[8] fir_fft_fused [{C * T // NB},{NB}] + u_w [{C * T // NB},64], "
          f"gt {list(run3.gt.shape[:2])}: "
          f"max|d| {k3_abs:.3e}, /max|plain| {k3_rel:.3e}; without u_w "
          f"{rel_nc:.3e} (limit 1e-5)")
    check(k3_rel < 1e-5 and rel_nc < 1e-5,
          "fir_fft_fused disagrees with its plain version")

    # -- 9. path "one_pass": make_fused_chain, three chained steps --------
    zero_counts()
    carries3, specs3 = [carry0], []
    for x in xs:
        spec, carry = run3.run(x, carries3[-1])
        specs3.append(spec)
        carries3.append(carry)
    launches3 = read_counts()
    print(f"[9] one-pass chain C={C} T={T} K={K}: launches "
          f"{launches3}")
    check(launches3["fir_fft_fused"] >= 3,
          "the one-pass chain did not launch fir_fft_fused each step")
    # the combined step (K1) on the same taps, for comparison
    gr9, gi9 = (g.to(dev) for g in stack_combined_operators(
        *combined_fir_fft_operators(taps, NB, 128)))

    def combined_step(x, carry):
        return fir_fft_combined_step(x, carry, gr9, gi9, NB, K, 128)

    for s, x in enumerate(xs):
        check(specs3[s].shape == (C, T // NB, NB, 2)
              and bool(torch.isfinite(specs3[s]).all()),
              f"one-pass step {s}: shape or non-finite values")
        _, rel = errs(specs3[s], combined_step(x, carries3[s])[0])
        exact = torch.equal(carries3[s + 1], x[:, T - (K - 1):])
        print(f"[9] step {s}: /max|combined step| {rel:.3e} (limit 1e-4), "
              f"carry exact {exact}")
        check(rel < 1e-4, f"one-pass step {s} disagrees with the combined "
                          f"step")
        check(exact, f"one-pass step {s} carry is not the last K-1 inputs")
    for ch in (0, C - 1):
        prev, cur = xs_host[1][ch], xs_host[2][ch]
        seq = np.concatenate([prev[T - (K - 1):], cur])
        seq = seq[:, 0].astype(np.float64) + 1j * seq[:, 1]
        y = np.convolve(seq, taps)[K - 1: K - 1 + T]
        exp = np.fft.fft(y.reshape(T // NB, NB), axis=-1)
        got = specs3[2][ch].cpu().numpy()
        rel = np.max(np.abs(got[..., 0] + 1j * got[..., 1] - exp)) \
            / np.max(np.abs(exp))
        print(f"[9] step 2 channel {ch} vs float64 numpy oracle: "
              f"/max|spectrum| {rel:.3e} (limit 1e-4)")
        check(rel < 1e-4, f"one-pass channel {ch} disagrees with the oracle")
    k3_ms = median_ms(lambda: fir_fft_fused(x8, uw8, run3.H, run3.gt))
    # the plain version's Gc planes are built once, outside its time
    gc8 = correction_spectrum(run3.gt, NB)
    k3_plain_ms = median_ms(lambda: fir_fft_fused_plain(
        x8, uw8, run3.H, run3.gt, gc8))
    k3_nc_ms = median_ms(lambda: fir_fft_fused(x8, None, run3.H, run3.gt))
    one_pass_ms = median_ms(lambda: run3.run(x0, carry0))
    combined_ms = median_ms(lambda: combined_step(x0, carry0))
    # K3's bound: the bytes of x, u_w, H, gt and y, and the operations of
    # the function in its cheapest form: x's FFT, the pp S products of
    # c_w = u_w gt, c_w's FFT without the first pass (a copy when S <=
    # n / 16), the H product and the sum
    rows3, pp3, s3 = x8.shape[0], run3.gt.shape[0], run3.gt.shape[1]
    k3_bytes = 4 * (2 * rows3 * NB * 2 + rows3 * pp3 * 2 + NB * 2
                    + pp3 * s3 * 2)
    k3_bound = bound(k3_bytes, rows3 * (
        5 * NB * np.log2(NB) + 8 * pp3 * s3 + 5 * NB * (np.log2(NB) - 4)
        + 8 * NB))
    k3_nc_bound = bound(k3_bytes - 4 * rows3 * pp3 * 2,
                        rows3 * (5 * NB * np.log2(NB) + 6 * NB))
    k3_device_ms = device_ms(fir_fft_fused, [(x8, uw8, run3.H, run3.gt)],
                             per_call=1, floor_ms=k3_bound[0])
    k3_nc_device_ms = device_ms(fir_fft_fused,
                                [(x8, None, run3.H, run3.gt)], per_call=1,
                                floor_ms=k3_nc_bound[0])
    # for information: the same step composed of library calls; no single
    # call computes it, so K3's library_ms stays null
    h_c = torch.view_as_complex(run3.H)
    gc_c = torch.complex(*gc8)
    x8_c, uw8_c = torch.view_as_complex(x8), torch.view_as_complex(uw8)
    k3_composed_ms = median_ms(
        lambda: torch.fft.fft(x8_c) * h_c + torch.matmul(uw8_c, gc_c))
    _, rel_c = errs(torch.view_as_real(
        torch.fft.fft(x8_c) * h_c + torch.matmul(uw8_c, gc_c)), ref)
    check(rel_c < 1e-5, "the library composition disagrees with K3's plain "
                        "version")
    print(f"[9] on {card}: fir_fft_fused [{C * T // NB},{NB}] {k3_ms:.3f} ms "
          f"({f4(k3_device_ms)} on the card; bound {k3_bound[0]:.3f} ms by "
          f"{k3_bound[1]}), {k3_nc_ms:.3f} ms without u_w "
          f"({f4(k3_nc_device_ms)} on the card; bound {k3_nc_bound[0]:.3f} "
          f"ms by {k3_nc_bound[1]}), plain (DFT matmuls + cuBLAS) "
          f"{k3_plain_ms:.3f} ms; composed of library calls (cuFFT, * H, "
          f"one complex64 matmul) {k3_composed_ms:.3f} ms "
          f"(/max|plain| {rel_c:.3e})")
    print(f"[9] on {card}: one-pass step {one_pass_ms:.3f} ms "
          f"({C * T / one_pass_ms / 1e3:.1f} Msamples/s), combined step "
          f"{combined_ms:.3f} ms")
    del x8, uw8, got, ref, got_nc, ref_nc, specs3, carries3
    del x8_c, uw8_c, gc_c, gc8, gr9, gi9

    # -- 10. path "block_api": FIR -> FFT through Topology(device) -------
    from pothoscomms_tpu_torch.core import fusion
    from pothoscomms_tpu_torch.core.fixtures import (CollectorSink,
                                                     FeederSource)

    QB = fusion.MAX_QUANTUM
    n_in = 2 * QB + 3 * NB + 17
    xb = rng.standard_normal(2 * n_in, dtype=np.float32).view(np.complex64)
    n_frames = (n_in - (K - 1)) // NB

    def block_api_run():
        """One run of the path; returns (output, segment, seconds by
        piece). The fused step and the pull synchronize the card, so
        each piece's host time includes its device work."""
        fir = BlockRegistry.make("/comms/fir_filter", "complex_float32",
                                 "COMPLEX")
        fir.set_taps(taps)
        fft = BlockRegistry.make("/comms/fft", "complex_float32", NB, False)
        feed = FeederSource("complex_float32")
        sink = CollectorSink("complex_float32")
        topo = Topology(device=dev)
        for a, b in ((feed, fir), (fir, fft), (fft, sink)):
            topo.connect(a, 0, b, 0)
        # edge sizing for the high-rate lane (benches/bench_topology.py
        # sizes the JAX package's edges the same way); default capacity
        # would cap every pull at 2^18
        fir.input(0).set_capacity(4 * QB)
        fft.input(0).set_capacity(2 * QB)
        sink.input(0).set_capacity(2 * QB)
        for part in (xb[:QB], xb[QB:2 * QB], xb[2 * QB:]):
            feed.feed_buffer(part)
        secs = {"engage": 0.0, "pull": 0.0, "fused": 0.0}

        def timed(fn, key):
            def call(*args):
                t = time.perf_counter()
                out = fn(*args)
                torch.cuda.synchronize()
                secs[key] += time.perf_counter() - t
                return out
            return call

        t0 = time.perf_counter()
        topo.commit()
        seg = topo._segments[0]
        seg.try_engage = timed(seg.try_engage, "engage")
        seg._pull = timed(seg._pull, "pull")
        seg.work = timed(seg.work, "fused")
        check(topo.wait_inactive(timeout=300.0), "block path did not finish")
        secs["wall"] = time.perf_counter() - t0
        secs["collect"] = sink._work_time
        secs["drain"] = fir._work_time + fft._work_time - secs["fused"]
        secs["step"] = secs["fused"] - secs["pull"]
        out = sink.get_buffer()
        return out, seg, secs

    zero_counts()
    out_b, seg_b, secs_b = block_api_run()
    launches_b = read_counts()
    print(f"[10] block API FIR(64 taps) -> FFT(1024) on {dev}, "
          f"{n_in} samples: launches {launches_b}; segment engaged "
          f"{seg_b.engage_count}x, pair core {seg_b.pair_engaged}, "
          f"{seg_b.fused_elements} samples fused")
    check(seg_b.engage_count >= 1 and seg_b.pair_engaged,
          "the block path did not engage the pair core")
    form_b = fir_fft_form(K, NB, 1, NB)
    check(form_b == "one_pass" and launches_b["fir_fft_fused"] >= 2
          and launches_b["fft_c2c"] >= 1,
          f"the block path's pair ({form_b}) did not launch fir_fft_fused "
          f">= 2 and fft_c2c >= 1")
    check(launches_b["cgemm_by_variant"][TENSOR_CORES]
          == launches_b["cgemm"],
          "a block-API cgemm launch missed the tensor-core variant")
    check(launches_b["tf32_operator"] == launches_b["cgemm"],
          "a block-API tensor-core launch did not build its operator")
    check(out_b.shape == (n_frames * NB,) and out_b.dtype == np.complex64,
          f"block path output {out_b.shape} {out_b.dtype}, expected "
          f"({n_frames * NB},) complex64")
    check(bool(np.isfinite(out_b.view(np.float32)).all()),
          "block path output not finite")
    row = fusion.PAIR_ROW // NB
    windows = {"start": 0, "row boundary": row - 1, "row boundary +1": row,
               "quantum boundary": QB // 2 // NB,
               "2^25 boundary": QB // NB - 1, "2^25 boundary +1": QB // NB,
               "last fused": 2 * QB // NB - 1, "drain": n_frames - 2,
               "end": n_frames - 1}
    for what, f in windows.items():
        seq = xb[f * NB: f * NB + NB + K - 1].astype(np.complex128)
        exp = np.fft.fft(np.convolve(seq, taps, "valid"))
        rel = np.max(np.abs(out_b[f * NB: (f + 1) * NB] - exp)) \
            / np.max(np.abs(exp))
        print(f"[10] window {f} ({what}) vs float64 numpy oracle: "
              f"/max|spectrum| {rel:.3e} (limit 1e-4)")
        check(rel < 1e-4, f"block path window {f} disagrees with the oracle")
    del out_b
    out_b2, _, secs_b2 = block_api_run()
    check(out_b2.shape == (n_frames * NB,), "second block path run length")
    for label, sb in (("first (cold)", secs_b), ("second", secs_b2)):
        rest = sb["wall"] - sb["engage"] - sb["fused"] - sb["collect"] \
            - sb["drain"]
        print(f"[10] on {card}: {label} run {sb['wall']:.3f} s from commit() "
              f"to wait_inactive(), {n_in / sb['wall'] / 1e6:.1f} "
              f"Msamples/s; engage {sb['engage']:.3f} s, pulls (H2D) "
              f"{sb['pull']:.3f} s, fused steps {sb['step']:.3f} s, collect "
              f"{sb['collect']:.3f} s, drain {sb['drain']:.3f} s, rest "
              f"{rest:.3f} s")

    del out_b2

    # -- 11. path "stream_ceiling": the P1 probe's entry point ------------
    zero_counts()
    p1 = probe_stream_ceiling.run()
    launches_p1 = read_counts()
    print(f"[11] probe_stream_ceiling on {p1['card']}: launches "
          f"{launches_p1}")
    print(f"[11] {json.dumps(p1)}")
    check(launches_p1["stream_scale"] >= 3,
          "the P1 probe did not launch stream_scale")
    xr11, xi11 = on_card(normal(32768, 1024)), on_card(normal(32768, 1024))
    pr, pi = stream_scale_plain(xr11, xi11)
    for tb in probe_stream_ceiling.TILES:
        yr, yi = stream_scale(xr11, xi11, tb)
        torch.cuda.synchronize()
        same = torch.equal(yr, pr) and torch.equal(yi, pi)
        print(f"[11] stream_scale [32768,1024] tb={tb}: equal to its plain "
              f"version {same}; {p1[f'tb{tb}_ms']:.4f} ms, "
              f"{p1[f'tb{tb}_GBs']:.1f} GB/s (plain {p1['plain_GBs']:.1f}, "
              f"one torch._foreach_mul {p1['library_GBs']:.1f}, copy_ "
              f"{p1['copy_GBs']:.1f})")
        check(same, f"stream_scale tb={tb} differs from its plain version")
    p1_abs = 0.0
    del xr11, xi11, pr, pi, yr, yi

    # -- 12. path "layout": the P2 probe's entry point --------------------
    zero_counts()
    p2 = probe_layout.run()
    launches_p2 = read_counts()
    print(f"[12] probe_layout on {p2['card']}: launches {launches_p2}")
    print(f"[12] {json.dumps(p2)}")
    check(launches_p2["layout_move"] >= 4 * 3,
          "the P2 probe did not launch layout_move for every mode")
    x12 = on_card(normal(4096, 1024))
    x12_host = x12.cpu().numpy()
    oracles = {  # benches/probe_mosaic.py:56, 62, 69-70, 76
        "A": lambda x: np.swapaxes(x.reshape(-1, 8, 128), 1, 2)
        .reshape(-1, 1024),
        "B": lambda x: np.swapaxes(x.reshape(-1, 128, 8), 1, 2)
        .reshape(-1, 1024),
        "C": lambda x: np.transpose(x.reshape(-1, 8, 16, 8), (0, 3, 2, 1))
        .reshape(-1, 1024),
        "D": lambda x: np.concatenate([x[:, m::8] for m in range(8)], axis=1)}
    for mode in MODES:
        got = layout_move(x12, mode)
        ref = layout_move_plain(x12, mode)
        torch.cuda.synchronize()
        same = torch.equal(got, ref)
        same_np = np.array_equal(got.cpu().numpy(), oracles[mode](x12_host))
        one_call = p2[("B" if mode == "D" else mode) + "_plain_ms"]
        print(f"[12] layout_move {mode} [4096,1024]: equal to its plain "
              f"version {same}, to the probe's numpy oracle {same_np}; "
              f"{p2[f'{mode}_ms']:.4f} ms, {p2[f'{mode}_GBs']:.1f} GB/s, "
              f"{f4(p2[f'{mode}_device_ms'])} ms on the card "
              f"(plain version {p2[f'{mode}_plain_ms']:.4f} ms, "
              f"{f4(p2[f'{mode}_plain_device_ms'])} on the card, one "
              f"permute call {one_call:.4f} ms, bound "
              f"{p2['bound_ms']:.4f} ms; P1 at this size, "
              f"tb={p2['P1_tb']}, {p2['P1_GBs']:.1f} GB/s, copy_ "
              f"{p2['copy_GBs']:.1f})")
        check(same and same_np and p2[f"{mode}_ok"],
              f"layout_move {mode} differs from its plain version")
    p2_abs = 0.0
    del x12, got, ref

    # -- 13. E1 against its plain version ---------------------------------
    from pothoscomms_tpu_torch.ops import filter as fops

    from pothoscomms_tpu_torch.blocks.filter import ENVELOPE_BLOCK

    def e1_launch(p, t, attack, release):
        """(P, T, L, Wr, ga, gr) of the E1 launch that the envelope block's
        fused core makes for [p, t] magnitudes (blocks/filter.py
        ``device_core``): blocked at ENVELOPE_BLOCK when t is at least
        four whole blocks and the warm-up at most two, else one row a
        channel."""
        ga, gr = (float(np.float32(np.exp(-1.0 / v)))
                  for v in (attack, release))
        w = fops.envelope_warmup(attack, release)
        blk = ENVELOPE_BLOCK
        if t % blk == 0 and t >= 4 * blk and w <= 2 * blk:
            return p, t, blk, -(-w // blk) * blk, ga, gr
        return p, t, t, 0, ga, gr

    TU = 3000  # phase 14's third length: not whole blocks, so unblocked
    # the shapes that the paths of phases 14 and 15 launch, then two kept
    # from before the redesign (the block length the JAX package takes,
    # and a long unblocked row); the first is the FM chain's at T = 131072
    e1_cases = [
        ("fm_chain T=131072", e1_launch(256, 131072, 10.0, 40.0)),
        ("fm_chain T=16384", e1_launch(256, 16384, 10.0, 40.0)),
        (f"fm_chain T={TU}", e1_launch(256, TU, 10.0, 40.0)),
        ("fm_block_api pull", e1_launch(1, 1 << 24, 4.0, 16.0)),
        ("fm_block_api drain", e1_launch(1, 17, 4.0, 16.0)),
        ("kept: blocked at 8192",
         (256, 131072, 8192, 8192) + e1_launch(1, 1, 10.0, 40.0)[4:]),
        ("kept: unblocked",
         (256, 16384, 16384, 0) + e1_launch(1, 1, 10.0, 40.0)[4:])]
    check(e1_cases[0][1][2:4] == (ENVELOPE_BLOCK, ENVELOPE_BLOCK)
          and e1_cases[1][1][2] == ENVELOPE_BLOCK
          and e1_cases[2][1][2:4] == (TU, 0)
          and e1_cases[3][1][2] == ENVELOPE_BLOCK,
          f"the envelope core's blocking is not the one expected: "
          f"{[c[1][:4] for c in e1_cases[:4]]}")
    e1_abs, e1_times, e1_device, e1_held = 0.0, {}, {}, {}
    e1_bound = bound(4 * (2 * 256 * 131072 + 2 * 256), 4 * 256 * 131072)

    def hold_e1(label, shape, plain_time=False):
        """E1 at ``shape`` = (P, T, L, Wr, ga, gr) against its plain
        version on the same random magnitudes: rtol 1e-5 / atol 1e-6 and
        bit for bit; then its time. Returns the plain version's ms when
        asked for it."""
        nonlocal e1_abs
        p13, t13, l13, w13 = shape[:4]
        ga, gr = np.float32(shape[4]), np.float32(shape[5])
        mag = torch.from_numpy(np.abs(normal(p13, t13))).to(dev)
        env0 = torch.from_numpy(np.abs(normal(p13))).to(dev)
        y, ef = envelope_rows(mag, env0, ga, gr, l13, w13)
        yp, efp = envelope_rows_plain(mag, env0, ga, gr, l13, w13)
        torch.cuda.synchronize()
        d = max((y - yp).abs().max().item(), (ef - efp).abs().max().item())
        ok = bool(torch.allclose(y, yp, rtol=1e-5, atol=1e-6)
                  and torch.allclose(ef, efp, rtol=1e-5, atol=1e-6))
        same = torch.equal(y, yp) and torch.equal(ef, efp)
        e1_abs = max(e1_abs, d)
        print(f"[13] envelope_rows {label} [{p13},{t13}] (L={l13}, "
              f"Wr={w13}, gains {ga:.6f} / {gr:.6f}): max|d| {d:.3e} "
              f"(rtol 1e-5, atol 1e-6): {ok}; bit for bit: {same}")
        check(ok and same,
              f"envelope_rows {label} disagrees with its plain version")
        e1_held[shape] = label
        e1_times[label] = median_ms(lambda: envelope_rows(mag, env0, ga, gr,
                                                          l13, w13))
        # each case's own bytes screen its reading from the profiler
        e1_device[label] = device_ms(
            envelope_rows, [(mag, env0, ga, gr, l13, w13)], per_call=1,
            floor_ms=bound(4 * (2 * p13 * t13 + 2 * p13), 0)[0])
        if plain_time:
            return median_ms(lambda: envelope_rows_plain(
                mag, env0, ga, gr, l13, w13), reps=2, warmup_s=0.0)
        return None

    for i, (label, shape) in enumerate(e1_cases):
        t_plain = hold_e1(label, shape, plain_time=i == 0)
        if i == 0:
            e1_plain_ms = t_plain
    e1_ms = e1_times[e1_cases[0][0]]
    e1_device_ms = e1_device[e1_cases[0][0]]

    times = ", ".join(f"{k} {v:.3f} ms ({f4(e1_device[k])} on the card)"
                      for k, v in e1_times.items())
    print(f"[13] on {card}: envelope_rows {times}; "
          f"{e1_cases[0][0]}: bound {e1_bound[0]:.3f} ms by {e1_bound[1]}, "
          f"plain (a Python loop of {sum(e1_cases[0][1][2:4])} steps) "
          f"{e1_plain_ms:.3f} ms")

    e1_launched = []

    @contextlib.contextmanager
    def swapped(module, name, fn):
        """``module.name`` is ``fn`` while a path is driven."""
        saved = getattr(module, name)
        setattr(module, name, fn)
        try:
            yield saved
        finally:
            setattr(module, name, saved)

    @contextlib.contextmanager
    def watched(module, name, note):
        """While a path is driven, ``note(args, result)`` after every call
        of ``module.name``; the call itself is the original's, and the
        original's attributes (its counters) are the wrapper's too."""
        original = getattr(module, name)

        @functools.wraps(original)
        def noting(*args, **kwargs):
            out = original(*args, **kwargs)
            note(args, out)
            return out

        with swapped(module, name, noting):
            yield

    def note_e1(args, out):
        """Notes (P, T, L, Wr, ga, gr) of an E1 call made through
        ops/filter."""
        mag, _, ga, gr, L, Wr = args
        e1_launched.append((mag.shape[0], mag.shape[1], int(L), int(Wr),
                            float(ga), float(gr)))

    def hold_e1_launches(path, since):
        """Every E1 shape that ``path`` launched (``e1_launched[since:]``)
        must have been held against the plain version: one that phase 13
        did not foresee is held now."""
        shapes = sorted(set(e1_launched[since:]))
        for shape in shapes:
            if shape not in e1_held:
                hold_e1(f"{path} launch", shape)
        print(f"[13] {path} launched E1 at "
              f"{[(s[:4], e1_held[s]) for s in shapes]}: each held against "
              f"its plain version")
        check(bool(shapes), f"{path} made no E1 call through ops/filter")


    # -- 14. path "fm_chain": compile_chain on the card -------------------
    CF, TF, DF, CASC, ATT, REL = 256, 131072, 64, 2, 10.0, 40.0
    TS = 16384  # the shape of benches/bench_suite.py's fm_chain_256ch

    def fm_blocks(d, casc, attack, release):
        demod = BlockRegistry.make("/comms/freq_demod", "complex_float32")
        dcr = BlockRegistry.make("/comms/dc_removal", "float32")
        dcr.set_average_size(d)
        dcr.set_cascade_size(casc)
        env = BlockRegistry.make("/comms/envelope_detector", "float32")
        env.set_attack(attack)
        env.set_release(release)
        return [demod, dcr, env]

    def fm_steps(c, t, n, seed):
        """n steps of a phase random walk with a carrier offset (0.25 rad
        per sample), made on the card in float64: [n][c, t, 2] f32."""
        g = torch.Generator(device=dev).manual_seed(seed)
        inc = torch.rand((c, n * t), generator=g, device=dev,
                         dtype=torch.float64) - 0.5 + 0.25
        phase = torch.cumsum(inc, dim=1)
        x = torch.stack([torch.cos(phase), torch.sin(phase)], -1).float()
        return [x[:, s * t:(s + 1) * t].contiguous() for s in range(n)]

    def fm_oracle(xc, d, casc, attack, release):
        """Float64 FM chain on one channel from a zero state (the oracle
        of tests/test_tpu_lane.py:222-243)."""
        prev = np.concatenate([[0], xc[:-1]])
        cur = np.angle(xc * np.conj(prev))
        delayed = np.concatenate([np.zeros(d), cur])[1:1 + len(xc)]
        for _ in range(casc):
            cs = np.cumsum(np.concatenate([np.zeros(d), cur]))
            cur = (cs[d:] - cs[:-d]) / d
        mag = np.abs(delayed - cur).tolist()
        ga64, gr64 = np.exp(-1.0 / attack), np.exp(-1.0 / release)
        e, out = 0.0, []
        for v in mag:
            g = ga64 if v > e else gr64
            e = g * e + (1.0 - g) * v
            out.append(e)
        return np.array(out)

    step_fm, carry_fm = compile_chain(fm_blocks(DF, CASC, ATT, REL), CF,
                                      device=dev)
    xf = fm_steps(CF, TF, 3, 14)
    xs16 = fm_steps(CF, TS, 2, 15)
    step16, carry16 = compile_chain(fm_blocks(DF, CASC, ATT, REL), CF,
                                    device=dev)
    xsu = fm_steps(CF, TU, 2, 16)
    stepu, carryu = compile_chain(fm_blocks(DF, CASC, ATT, REL), CF,
                                  device=dev)
    f1_launched = []

    def note_f1(args, out):
        """Notes (C, T, D, cascade) of an F1 call made by compile_chain."""
        x, _, _, d, casc = args
        f1_launched.append((x.shape[0], x.shape[1], int(d), int(casc)))

    torch.cuda.synchronize()
    zero_counts()
    with watched(fops, "envelope_rows", note_e1), \
            watched(compiler_mod, "fm_demod_dc", note_f1):
        carries_fm, ys_fm = [carry_fm], []
        for x in xf:
            y, c = step_fm(x, carries_fm[-1])
            ys_fm.append(y)
            carries_fm.append(c)
        carries16, ys16 = [carry16], []
        for x in xs16:
            y, c = step16(x, carries16[-1])
            ys16.append(y)
            carries16.append(c)
        carriesu, ysu = [carryu], []
        for x in xsu:
            y, c = stepu(x, carriesu[-1])
            ysu.append(y)
            carriesu.append(c)
    launches_fm = read_counts()
    print(f"[14] fm_chain C={CF} T={TF} (3 steps), T={TS} (2 steps) and "
          f"T={TU} (2 steps, unblocked), D={DF} x{CASC}, attack {ATT} "
          f"release {REL}: launches {launches_fm}")
    check(launches_fm["envelope"] >= 7,
          "the FM chain did not launch envelope_rows each step")
    check(launches_fm["fm_demod_dc"] == 7 and len(f1_launched) == 7,
          f"the FM chain launched F1 {launches_fm['fm_demod_dc']} times "
          f"({len(f1_launched)} noted), not once a step")
    # F1 at every shape the chain launched it at, against its plain
    # version (the two cores' ops) on fresh inputs and nonzero carries:
    # within 8 float32 ulps of max |y| (window sums from float64 sums in
    # another order), the discriminator's carry exact
    f1_abs, f1_tol = 0.0, 8 * 2.0 ** -24
    for n_f1, shape in enumerate(sorted(set(f1_launched))):
        c_, t_, d_, casc_ = shape
        x_ = fm_steps(c_, t_, 1, 40 + n_f1)[0]
        last_ = x_[:, -1:].flip(1).contiguous()
        hists_ = torch.from_numpy(np.random.default_rng(40 + n_f1).normal(
            0.0, 0.1, (casc_, c_, d_)).astype(np.float32)).to(dev)
        yk, lk, hk = fm_demod_dc(x_, last_, hists_, d_, casc_)
        yp, lp, hp = fm_demod_dc_plain(x_, last_, hists_, d_, casc_)
        torch.cuda.synchronize()
        d = (yk - yp).abs().max().item()
        dh = (hk - hp).abs().max().item()
        f1_abs = max(f1_abs, d)
        ok = (d <= f1_tol * yp.abs().max().item() and torch.equal(lk, lp)
              and dh <= f1_tol * hp.abs().max().item())
        print(f"[14] fm_demod_dc at [{c_},{t_}] D={d_} x{casc_} vs its "
              f"plain version: max|d| {d:.3e}, histories {dh:.3e} (8 ulps "
              f"of max), last sample exact: {ok}")
        check(ok, f"fm_demod_dc at {shape} disagrees with its plain version")
    check(len(e1_launched) == launches_fm["envelope"],
          f"{len(e1_launched)} E1 calls noted, {launches_fm['envelope']} "
          f"launches counted")
    hold_e1_launches("fm_chain", 0)
    check(set(e1_launched) == {c[1] for c in e1_cases[:3]},
          f"fm_chain launched E1 at {sorted(set(e1_launched))}, phase 13 "
          f"expected {[c[1] for c in e1_cases[:3]]}")
    fm_err = 0.0
    for label, xs_, ys_, cs_, stp in (
            (f"T={TF}", xf, ys_fm, carries_fm, step_fm),
            (f"T={TS}", xs16, ys16, carries16, step16),
            (f"T={TU}", xsu, ysu, carriesu, stepu)):
        for s, x in enumerate(xs_):
            check(ys_[s].shape == x.shape[:2]
                  and bool(torch.isfinite(ys_[s]).all()),
                  f"fm_chain {label} step {s}: shape or non-finite values")
            with swapped(fops, "envelope_rows", envelope_rows_plain):
                yp, cp = stp(x, cs_[s])
            d = (ys_[s] - yp).abs().max().item()
            dc_ = max((a - b).abs().max().item()
                      for a, b in zip(cs_[s + 1], cp))
            ok = bool(torch.allclose(ys_[s], yp, rtol=1e-5, atol=1e-6))
            print(f"[14] {label} step {s} vs the chain on E1's plain "
                  f"version: max|d| {d:.3e}, carries {dc_:.3e} (rtol 1e-5, "
                  f"atol 1e-6): {ok}")
            check(ok and dc_ <= 1e-5, f"fm_chain {label} step {s} disagrees "
                                      f"with the plain chain")
    lead = 4096
    for ch in (0, CF - 1):
        seq = torch.cat([xf[1][ch, TF - lead:], xf[2][ch]]).double().cpu()
        seq = seq[:, 0].numpy() + 1j * seq[:, 1].numpy()
        exp = fm_oracle(seq, DF, CASC, ATT, REL)[lead:]
        d = np.max(np.abs(ys_fm[2][ch].cpu().numpy() - exp))
        fm_err = max(fm_err, d)
        print(f"[14] T={TF} step 2 channel {ch} vs float64 numpy oracle "
              f"(seeded with step 1's last {lead} samples): max|d| {d:.3e} "
              f"(atol 2e-3)")
        check(d <= 2e-3, f"fm_chain channel {ch} disagrees with the oracle")
    half = TF // 2
    c = carries_fm[1]
    parts = []
    for h in range(2):
        yh, c = step_fm(xf[1][:, h * half:(h + 1) * half].contiguous(), c)
        parts.append(yh)
    d = (torch.cat(parts, dim=1) - ys_fm[1]).abs().max().item()
    dc_ = max((a - b).abs().max().item() for a, b in zip(c, carries_fm[2]))
    print(f"[14] two half-steps of {half} vs one step: max|d| {d:.3e}, "
          f"carries {dc_:.3e} (atol 2e-3)")
    check(d <= 2e-3 and dc_ <= 2e-3, "two half-steps differ from one step")
    fm_ms = median_ms(lambda: step_fm(xf[0], carry_fm))
    fm16_ms = median_ms(lambda: step16(xs16[0], carry16))
    # F1 alone at the chain's main launch, beside its bound and the plain
    # version; the histories read and written once too
    f1_pool = [(x, carry_fm[0], carry_fm[1], DF, CASC) for x in xf]
    f1_bound = bound(CF * TF * (8 + 4) + 2 * CF * (8 + CASC * DF * 4), 0)
    f1_ms = event_ms(fm_demod_dc, f1_pool)
    f1_device_ms = device_ms(fm_demod_dc, f1_pool, per_call=1,
                             floor_ms=f1_bound[0])
    f1_plain_ms = median_ms(lambda: fm_demod_dc_plain(*f1_pool[0]))
    print(f"[14] on {card}: fm_demod_dc [{CF},{TF}] D={DF} x{CASC} "
          f"{f1_ms:.4f} ms ({f4(f1_device_ms)} on the card), bound "
          f"{f1_bound[0]:.4f} ms by {f1_bound[1]} "
          f"({share(f1_bound[0], f1_device_ms)} of it), plain version "
          f"{f1_plain_ms:.3f} ms")
    fm_bytes = CF * TF * (8 + 4)
    p1_best = max(p1[f"tb{tb}_GBs"] for tb in probe_stream_ceiling.TILES)
    print(f"[14] on {card}: fm_chain step T={TF} {fm_ms:.3f} ms "
          f"({CF * TF / fm_ms / 1e3:.1f} Msamples/s, "
          f"{fm_bytes / fm_ms / 1e6:.1f} GB/s of input and output against "
          f"P1's best {p1_best:.1f}); T={TS} {fm16_ms:.3f} ms "
          f"({CF * TS / fm16_ms / 1e3:.1f} Msamples/s)")
    del xf, xs16, xsu, ys_fm, ys16, ysu, carries_fm, carries16, carriesu
    del parts, f1_pool

    # -- 15. path "fm_block_api": the FM blocks on Topology(device) -------
    DB, CASCB, ATTB, RELB = 32, 2, 4.0, 16.0
    WB = fops.envelope_warmup(ATTB, RELB)
    n_fm = 2 * QB + 17
    rng15 = np.random.default_rng(15)
    # a phase random walk with a carrier offset of 0.25 rad per sample:
    # the DC removal's prefix sums over a 2^24 pull grow to ~4e6
    xb15 = np.exp(1j * np.cumsum(rng15.normal(size=n_fm) * 0.2 + 0.25)
                  ).astype(np.complex64)

    def fm_block_run():
        blocks = fm_blocks(DB, CASCB, ATTB, RELB)
        feed = FeederSource("complex_float32")
        sink = CollectorSink("float32")
        topo = Topology(device=dev)
        chain = [feed] + blocks + [sink]
        for a, b in zip(chain[:-1], chain[1:]):
            topo.connect(a, 0, b, 0)
        # edges sized as in phase 10
        blocks[0].input(0).set_capacity(4 * QB)
        sink.input(0).set_capacity(2 * QB)
        for part in (xb15[:QB], xb15[QB:2 * QB], xb15[2 * QB:]):
            feed.feed_buffer(part)
        secs = {"engage": 0.0, "pull": 0.0, "fused": 0.0}

        def timed(fn, key):
            def call(*args):
                t = time.perf_counter()
                out = fn(*args)
                torch.cuda.synchronize()
                secs[key] += time.perf_counter() - t
                return out
            return call

        t0 = time.perf_counter()
        topo.commit()
        seg = topo._segments[0]
        seg.try_engage = timed(seg.try_engage, "engage")
        seg._pull = timed(seg._pull, "pull")
        seg.work = timed(seg.work, "fused")
        check(topo.wait_inactive(timeout=300.0), "FM block path did not "
                                                 "finish")
        secs["wall"] = time.perf_counter() - t0
        secs["collect"] = sink._work_time
        secs["drain"] = sum(b._work_time for b in blocks) - secs["fused"]
        secs["step"] = secs["fused"] - secs["pull"]
        return sink.get_buffer(), seg, secs

    zero_counts()
    n_noted = len(e1_launched)
    with watched(fops, "envelope_rows", note_e1):
        out15, seg15, secs15 = fm_block_run()
    launches15 = read_counts()
    print(f"[15] block API freq_demod -> dc_removal({DB}, {CASCB}) -> "
          f"envelope({ATTB}, {RELB}) on {dev}, {n_fm} samples: launches "
          f"{launches15}; segment of {len(seg15.blocks)} blocks engaged "
          f"{seg15.engage_count}x, {seg15.fused_elements} samples fused")
    check(seg15.engage_count >= 1 and len(seg15.blocks) == 3
          and seg15.fused_elements >= QB, "the FM segment did not engage")
    check(launches15["envelope"] >= 2, "the FM block path did not launch "
                                       "envelope_rows")
    check(len(e1_launched) - n_noted == launches15["envelope"],
          f"{len(e1_launched) - n_noted} E1 calls noted, "
          f"{launches15['envelope']} launches counted")
    hold_e1_launches("fm_block_api", n_noted)
    check(e1_cases[3][1] in e1_launched[n_noted:],
          f"fm_block_api did not launch E1 at {e1_cases[3][1]}")
    check(out15.shape == (n_fm,) and out15.dtype == np.float32,
          f"FM block path output {out15.shape} {out15.dtype}, expected "
          f"({n_fm},) float32")
    check(bool(np.isfinite(out15).all()), "FM block path output not finite")
    pull = 1 << (2 * ((QB.bit_length() - 1) // 2))  # top of the 4^k ladder
    n_pulls = 2 * QB // pull
    check(seg15.fused_elements == n_pulls * pull,
          f"{seg15.fused_elements} samples fused, expected {n_pulls} pulls "
          f"of {pull}")
    lead15 = WB + 2 * DB + 1
    win = 256
    fm_block_err = 0.0
    for what, s0 in (("start", 0), ("pull boundary", pull - win // 2),
                     ("feed boundary", QB - win // 2),
                     ("last pull boundary", (n_pulls - 1) * pull - win // 2),
                     ("drain", n_pulls * pull - win // 2),
                     ("end", n_fm - win)):
        a = max(0, s0 - lead15)
        exp = fm_oracle(xb15[a:s0 + win].astype(np.complex128), DB, CASCB,
                        ATTB, RELB)[s0 - a:]
        d = np.max(np.abs(out15[s0:s0 + win] - exp))
        fm_block_err = max(fm_block_err, d)
        print(f"[15] window [{s0}, {s0 + win}) ({what}) vs float64 numpy "
              f"oracle from {s0 - a} samples earlier: max|d| {d:.3e} "
              f"(atol 2e-3)")
        check(d <= 2e-3, f"FM block path window at {s0} disagrees with the "
                         f"oracle")
    del out15
    out15b, _, secs15b = fm_block_run()
    check(out15b.shape == (n_fm,), "second FM block path run length")
    del out15b
    for label, sb in (("first (cold)", secs15), ("second", secs15b)):
        rest = sb["wall"] - sb["engage"] - sb["fused"] - sb["collect"] \
            - sb["drain"]
        print(f"[15] on {card}: {label} run {sb['wall']:.3f} s from commit() "
              f"to wait_inactive(), {n_fm / sb['wall'] / 1e6:.1f} "
              f"Msamples/s; engage {sb['engage']:.3f} s, pulls (H2D) "
              f"{sb['pull']:.3f} s, fused steps {sb['step']:.3f} s, collect "
              f"{sb['collect']:.3f} s, drain {sb['drain']:.3f} s, rest "
              f"{rest:.3f} s")

    def k1_at(phase, a, g_r, g_i, path):
        """K1 at one of the new paths' shapes: held against its plain
        version (below 1e-5 of max |plain|) and timed beside it, one
        complex64 torch.matmul and its 3xTF32 bound. Returns the record
        for the kernels line."""
        nonlocal k1_abs
        got = cgemm(a, g_r, g_i)
        ref = cgemm_plain(a, g_r, g_i)
        torch.cuda.synchronize()
        d, rel = errs(got, ref)
        k1_abs = max(k1_abs, d)
        b_, n_ = a.shape[:2]
        m_ = g_r.shape[1]
        took = variant(n_, m_, a.data_ptr() % 16 == 0)
        check(rel < 1e-5 and took == TENSOR_CORES,
              f"cgemm at {path}'s {tuple(a.shape[:2])} disagrees with its plain version ({rel:.3e}) "
              f"or took {took}")
        a_c, g_c = torch.view_as_complex(a), torch.complex(g_r, g_i)
        nbytes = 4 * (b_ * n_ * 2 + 2 * n_ * m_ + b_ * m_ * 2)
        bnd = bound(nbytes, 3 * 8 * b_ * n_ * m_, TF32_OPS)
        rec = {"path": path, "shape": f"[{b_},{n_}]x[{n_},{m_}]",
               "max_rel_to_plain": rel,
               "ms": median_ms(lambda: cgemm(a, g_r, g_i)),
               "device_ms": device_ms(cgemm, [(a, g_r, g_i)], per_call=2,
                                      floor_ms=bnd[0]),
               "plain_ms": median_ms(lambda: cgemm_plain(a, g_r, g_i)),
               "library_ms": median_ms(lambda: torch.matmul(a_c, g_c)),
               "bound_ms": bnd[0], "bound_by": bnd[1]}
        print(f"[{phase}] cgemm {rec['shape']} ({path}): "
              f"/max|plain| {rel:.3e} (limit 1e-5), {took}; {rec['ms']:.4f} "
              f"ms ({f4(rec['device_ms'])} on the card), plain "
              f"{rec['plain_ms']:.4f} ms, one complex64 torch.matmul "
              f"{rec['library_ms']:.4f} ms; bound {bnd[0]:.4f} ms by "
              f"{bnd[1]} ({bnd[0] / rec['ms']:.1%} of it)")
        return rec

    k1_by_shape = []

    # -- 17. path "split_step": the split-stream FIR -> FFT step ---------
    from pothoscomms_tpu_torch.parallel import chain as chain_mod

    PP, SPLIT_R = 64, (4, 8, 16)
    split_runs = {R: make_split_step(taps, NB, R, PP, device=dev)[0]
                  for R in SPLIT_R}
    k1_shapes17 = []
    zero_counts()
    with watched(chain_mod, "cgemm", lambda args, out: k1_shapes17.append(
            (tuple(args[0].shape[:2]), tuple(args[1].shape)))):
        split_specs, split_carries = {}, {}
        for R, srun in split_runs.items():
            cs, ss = [carry0], []
            for x in xs:
                spec, c = srun(x, cs[-1])
                ss.append(spec)
                cs.append(c)
            split_specs[R], split_carries[R] = ss, cs
    launches17 = read_counts()
    print(f"[17] split step C={C} T={T} K={K} NBINS={NB} pp={PP}, R in "
          f"{SPLIT_R}, 3 steps each: launches {launches17}")
    want17 = sum(3 * R for R in SPLIT_R)
    check(launches17["cgemm"] == want17
          and launches17["cgemm_by_variant"][TENSOR_CORES] == want17
          and launches17["tf32_operator"] == want17,
          f"the split step launched cgemm {launches17['cgemm']} times, "
          f"{want17} on the tensor cores expected")
    check(sorted(set(k1_shapes17)) == sorted(
        ((C * T // NB, PP + NB // R), (PP + NB // R, NB // R))
        for R in SPLIT_R), f"split-step K1 shapes {sorted(set(k1_shapes17))}")
    oracle17 = {}
    for ch in (0, C - 1):
        seq = np.concatenate([xs_host[1][ch][T - (K - 1):], xs_host[2][ch]])
        seq = seq[:, 0].astype(np.float64) + 1j * seq[:, 1]
        y = np.convolve(seq, taps)[K - 1: K - 1 + T]
        oracle17[ch] = np.fft.fft(y.reshape(T // NB, NB), axis=-1)
    split_err = 0.0
    for R in SPLIT_R:
        for s, x in enumerate(xs):
            spec = split_specs[R][s]
            check(spec.shape == (C, T // NB, NB, 2)
                  and bool(torch.isfinite(spec).all()),
                  f"split R={R} step {s}: shape or non-finite values")
            _, rel = errs(spec, specs[s])
            exact = torch.equal(split_carries[R][s + 1], x[:, T - (K - 1):])
            print(f"[17] R={R} step {s}: /max|main path| {rel:.3e} "
                  f"(limit 1e-4), carry exact {exact}")
            check(rel < 1e-4 and exact, f"split R={R} step {s} disagrees "
                                        f"with the main path or carry")
        for ch, exp in oracle17.items():
            got = split_specs[R][2][ch].cpu().numpy()
            rel = np.max(np.abs(got[..., 0] + 1j * got[..., 1] - exp)) \
                / np.max(np.abs(exp))
            split_err = max(split_err, rel)
            print(f"[17] R={R} step 2 channel {ch} vs float64 numpy oracle: "
                  f"/max|spectrum| {rel:.3e} (limit 1e-4)")
            check(rel < 1e-4, f"split R={R} channel {ch} disagrees with the "
                              f"oracle")
    del split_specs, split_carries
    # every K1 launch of the step, at its shape, against the plain version
    for R, srun in split_runs.items():
        a17 = split_operand(x0, carry0, srun.wr, NB, K, PP)
        for r in range(R):
            got = cgemm(a17[r], srun.gr[r], srun.gi[r])
            ref = cgemm_plain(a17[r], srun.gr[r], srun.gi[r])
            torch.cuda.synchronize()
            d, rel = errs(got, ref)
            k1_abs = max(k1_abs, d)
            check(rel < 1e-5, f"cgemm, split R={R} stream {r}: {rel:.3e}")
        print(f"[17] R={R}: each of the {R} K1 launches of a step "
              f"[{C * T // NB},{PP + NB // R}]x[{PP + NB // R},{NB // R}] "
              f"within 1e-5 of max|plain|")
        k1_by_shape.append(k1_at(17, a17[0], srun.gr[0],
                                 srun.gi[0], "split_step"))
        del a17, got, ref
    split_ms, split_dev_ms, split_operand_ms = {}, {}, {}
    step_floor = probe_stream_ceiling.bytes_bound_ms(2 * C * T * 8)
    for R, srun in split_runs.items():
        split_ms[R] = median_ms(lambda: srun(x0, carry0))
        split_dev_ms[R] = device_ms(srun, [(x0, carry0)], floor_ms=step_floor)
        split_operand_ms[R] = median_ms(lambda: split_operand(
            x0, carry0, srun.wr, NB, K, PP))
        print(f"[17] on {card}: split step R={R} {split_ms[R]:.3f} ms "
              f"({C * T / split_ms[R] / 1e3:.1f} Msamples/s; "
              f"{f4(split_dev_ms[R])} ms on the card), its operand build "
              f"{split_operand_ms[R]:.3f} ms; combined step {combined_ms:.3f} "
              f"ms, one-pass step {one_pass_ms:.3f} ms")
    del split_runs

    # -- 18. path "resampler_chain": BASELINE config #3 through
    # compile_chain ------------------------------------------------------
    from scipy.signal import lfilter

    CR, TR, TRS, MR, LR = 16, 1 << 19, 768, 2, 3
    taps18 = (rng.normal(size=60) + 1j * rng.normal(size=60)) / 60

    def config3_blocks(taps_):
        fir = BlockRegistry.make("/comms/fir_filter", "complex_float32",
                                 "COMPLEX")
        fir.set_taps(taps_)
        fir.set_decimation(MR)
        fir.set_interpolation(LR)
        return [fir, BlockRegistry.make("/comms/iir_filter",
                                        "complex_float32")]

    def unit_complex(*shape):
        """complex normal of unit variance as planar float32 on the card"""
        return on_card(normal(*shape, 2) / np.float32(np.sqrt(2.0)))

    def resampled(xh, taps_, t_idx):
        """float64 resampler outputs at indices ``t_idx`` over ``xh``,
        whose first K-1 samples are the history (the polyphase sum of
        ops/filter.py: y[t] = sum_k taps[u%L + kL] xh[u//L + K-1 - k],
        u = t M + M - 1)."""
        kk = len(taps_) // LR
        u = np.asarray(t_idx) * MR + (MR - 1)
        y = np.zeros(len(u), np.complex128)
        for k in range(kk):
            y += taps_[u % LR + k * LR] * xh[u // LR + kk - 1 - k]
        return y

    blocks18 = config3_blocks(taps18)
    K18 = blocks18[0]._K - 1  # the resampler's input history, 19 samples
    iir_ba = (blocks18[1]._b / blocks18[1]._a[0],
              blocks18[1]._a / blocks18[1]._a[0])
    step18, carry18 = compile_chain(blocks18, CR, device=dev)
    step18s, carry18s = compile_chain(config3_blocks(taps18), CR, device=dev)
    xs18 = [unit_complex(CR, TR) for _ in range(3)]
    xs18s = [unit_complex(CR, TRS) for _ in range(2)]
    iir_ls, fir_out18 = [], []

    def note_fir(args, out):
        if args[0].shape[1] == TR:
            fir_out18.append(out[0][[0, CR - 1]].cpu())

    torch.cuda.synchronize()
    zero_counts()
    with watched(fops, "iir_blocked_step", lambda args, out: iir_ls.append(
            (tuple(args[0].shape), args[6]))), \
            watched(fops, "rational_fir_mm", note_fir):
        carries18, ys18 = [carry18], []
        for x in xs18:
            y, c = step18(x, carries18[-1])
            ys18.append(y)
            carries18.append(c)
        carries18s, ys18s = [carry18s], []
        for x in xs18s:
            y, c = step18s(x, carries18s[-1])
            ys18s.append(y)
            carries18s.append(c)
    launches18 = read_counts()
    print(f"[18] resampler chain compile_chain([FIR 3:2 (60 complex taps), "
          f"IIR (default biquad)], {CR}) at T={TR} (3 steps) and T={TRS} "
          f"(2 steps): launches {launches18}; the IIR's blocked steps "
          f"(planes x samples, block length): {sorted(set(iir_ls))}")
    check(launches18["cgemm"] == 5
          and launches18["cgemm_by_variant"][TENSOR_CORES] == 5
          and launches18["tf32_operator"] == 5,
          "the resampler chain did not launch cgemm once a step on the "
          "tensor cores")
    check(sorted(set(iir_ls)) == [((2 * CR, TRS * LR // MR), 128),
                                  ((2 * CR, TR * LR // MR), 256)],
          f"the IIR took blocks {sorted(set(iir_ls))}")
    for label, xs_, ys_, cs_, stp, t_ in (
            (f"T={TR}", xs18, ys18, carries18, step18, TR),
            (f"T={TRS}", xs18s, ys18s, carries18s, step18s, TRS)):
        for s, x in enumerate(xs_):
            check(ys_[s].shape == (CR, t_ * LR // MR, 2)
                  and bool(torch.isfinite(ys_[s]).all()),
                  f"resampler {label} step {s}: shape or non-finite values")
            # the resampler's core with K1's plain version in place of K1
            with swapped(fops, "cgemm", cgemm_plain):
                yp, cp = stp(x, cs_[s])
            _, rel = errs(ys_[s], yp)
            dc_ = max((a - b).abs().max().item()
                      for a, b in zip(cs_[s + 1], cp))
            exact = torch.equal(cs_[s + 1][0], x[:, t_ - K18:])
            print(f"[18] {label} step {s} vs the chain on K1's plain "
                  f"version: /max|y| {rel:.3e} (limit 1e-5), carries "
                  f"{dc_:.3e}; FIR carry the last {K18} inputs: {exact}")
            check(rel < 1e-5 and dc_ <= 1e-5 and exact,
                  f"resampler {label} step {s} disagrees with the plain "
                  f"chain")
    xh18 = torch.cat(xs18, dim=1)[[0, CR - 1]].double().cpu().numpy()
    fir18 = torch.cat(fir_out18, dim=1).double().numpy()
    out18 = torch.cat(ys18, dim=1)[[0, CR - 1]].double().cpu().numpy()
    n18 = 3 * TR * LR // MR
    res_err, iir_err = 0.0, 0.0
    for i, ch in enumerate((0, CR - 1)):
        xc = xh18[i, :, 0] + 1j * xh18[i, :, 1]
        ref = resampled(np.concatenate([np.zeros(K18), xc]), taps18,
                        np.arange(n18))
        got = fir18[i, :, 0] + 1j * fir18[i, :, 1]
        rel = np.max(np.abs(got - ref)) / np.max(np.abs(ref))
        out = lfilter(*iir_ba, ref)
        d = np.max(np.abs(out18[i, :, 0] + 1j * out18[i, :, 1] - out))
        res_err, iir_err = max(res_err, rel), max(iir_err, d)
        print(f"[18] channel {ch}, 3 steps vs float64 oracle (polyphase "
              f"sum, then lfilter): resampler /max|y| {rel:.3e} (limit "
              f"1e-4), IIR output max|d| {d:.3e} (atol 2e-4)")
        check(rel < 1e-4 and d < 2e-4,
              f"resampler chain channel {ch} disagrees with the oracle")
    del fir_out18, fir18, out18, xh18
    # where a step's time goes: the step, the FIR core and the IIR core
    # alone, and the IIR's block scan at the step's shapes
    step18_ms = median_ms(lambda: step18(xs18[0], carry18))
    step18_dev_ms = device_ms(step18, [(xs18[0], carry18)],
                              floor_ms=probe_stream_ceiling.bytes_bound_ms(
                                  CR * TR * 8 * (1 + LR / MR)))
    _, fir_core = blocks18[0].device_core(CR, device=dev)
    iir_carry, iir_core = blocks18[1].device_core(CR, device=dev)
    y_fir = fir_core(carry18[0], xs18[0])[1]
    fir_core_ms = median_ms(lambda: fir_core(carry18[0], xs18[0]))
    iir_core_ms = median_ms(lambda: iir_core(iir_carry, y_fir))
    ops18 = fops.iir_blocked_operators(*iir_ba, 256)
    nb18 = TR * LR // MR // 256
    u18 = on_card(normal(nb18, 2, 2 * CR))
    z18 = on_card(normal(2, 2 * CR))
    m18 = on_card(ops18[2].astype(np.float32))
    p18 = on_card(fops.iir_scan_powers(ops18[2], nb18).astype(np.float32))
    scan_ms = median_ms(lambda: fops.iir_block_scan(u18, z18, m18, p18))
    scan_dev_ms = device_ms(fops.iir_block_scan, [(u18, z18, m18, p18)])
    iir_dev_ms = device_ms(iir_core, [(iir_carry, y_fir)])
    rows18 = CR * TR // 256
    a18 = fops.rational_operand(xs18[0], carry18[0], 256, 32)
    gr18, gi18 = fops.stack_rational_operators(
        *fops.rational_fir_operators(taps18, MR, LR)[:2])
    k1_by_shape.append(k1_at(18, a18, gr18.to(dev), gi18.to(dev),
                             "resampler_chain"))
    check(a18.shape == (rows18, 288, 2), f"resampler operand {a18.shape}")
    print(f"[18] on {card}: resampler chain step C={CR} T={TR} "
          f"{step18_ms:.3f} ms ({CR * TR / step18_ms / 1e3:.1f} Msamples/s "
          f"in, {f4(step18_dev_ms)} ms on the card); FIR core "
          f"{fir_core_ms:.3f} ms, IIR core {iir_core_ms:.3f} ms "
          f"({f4(iir_dev_ms)} on the card); the IIR's block scan alone "
          f"({nb18} blocks, {int(np.ceil(np.log2(nb18)))} rounds) "
          f"{scan_ms:.3f} ms by events ({f4(scan_dev_ms)} on the card)")
    # the scan's share of the step, from one trace of three steps: its
    # kernels are those launched inside its range
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    scan18 = fops.iir_block_scan

    def scan_ranged(*args):
        with record_function("iir_block_scan"):
            return scan18(*args)

    torch.cuda.synchronize()
    with swapped(fops, "iir_block_scan", scan_ranged), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        c = carry18
        for _ in range(3):
            _, c = step18(xs18[0], c)
        torch.cuda.synchronize()
        trace_ms = (time.perf_counter() - t0) * 1e3 / 3
    evs = prof.events()
    ranges18 = [e for e in evs if e.name == "iir_block_scan"
                and e.device_type == DeviceType.CPU]
    step_card_ms = sum(e.device_time_total for e in evs
                       if e.device_type == DeviceType.CUDA
                       and e.name != "iir_block_scan") / 3e3
    scan_card_ms = sum(e.device_time_total for e in ranges18) / 3e3
    scan_host_ms = sum(e.cpu_time_total for e in ranges18) / 3e3
    check(len(ranges18) == 3 and step_card_ms > 0,
          f"the trace holds {len(ranges18)} scans (3 expected) and "
          f"{step_card_ms} ms of kernels")
    of_core = "not measured" if iir_dev_ms is None \
        else f"{scan_card_ms / iir_dev_ms:.1%}"
    print(f"[18] on {card}: trace of 3 resampler steps, per step: "
          f"{trace_ms:.3f} ms of wall (profiler on), {step_card_ms:.4f} ms "
          f"of kernels ({step_card_ms / trace_ms:.1%} busy); the block "
          f"scan's kernels {scan_card_ms:.4f} ms "
          f"({scan_card_ms / step_card_ms:.1%} of the step's device time, "
          f"{of_core} of the IIR core's on the card), its host time "
          f"{scan_host_ms:.3f} ms ({scan_host_ms / trace_ms:.1%} of the "
          f"step's wall)")
    del xs18, xs18s, ys18, ys18s, carries18, carries18s, y_fir, a18, u18

    # -- 19. path "resampler_block_api": config #3 through the block API -
    n19 = (1 << 24) + 12345
    rng19 = np.random.default_rng(19)
    x19 = ((rng19.standard_normal(n19, dtype=np.float32)
            + 1j * rng19.standard_normal(n19, dtype=np.float32))
           / np.float32(np.sqrt(2.0))).astype(np.complex64)

    def config3_block_run():
        fird = BlockRegistry.make("/comms/fir_designer")
        fird.set_band_type("LOW_PASS")
        fird.set_filter_type("SINC")
        fird.set_sample_rate(1.0)
        fird.set_frequency_lower(0.2)
        fird.set_num_taps(60)
        iird = BlockRegistry.make("/comms/iir_designer")
        iird.set_order(4)
        iird.set_frequency_lower(0.25)
        fir, iir = config3_blocks([1.0])
        fir.set_wait_taps(True)
        iir.set_wait_taps(True)
        feed = FeederSource("complex_float32")
        sink = CollectorSink("complex_float32")
        topo = Topology(device=dev)
        topo.connect(fird, "tapsChanged", fir, "setTaps")
        topo.connect(iird, "tapsChanged", iir, "setTaps")
        for a, b in ((feed, fir), (fir, iir), (iir, sink)):
            topo.connect(a, 0, b, 0)
        # edges sized as in phase 10, for the 1.5x output
        fir.input(0).set_capacity(2 * n19)
        sink.input(0).set_capacity(2 * n19)
        feed.feed_buffer(x19)
        secs = {"engage": 0.0, "pull": 0.0, "fused": 0.0}

        def timed(fn, key):
            def call(*args):
                t = time.perf_counter()
                out = fn(*args)
                torch.cuda.synchronize()
                secs[key] += time.perf_counter() - t
                return out
            return call

        t0 = time.perf_counter()
        topo.commit()
        seg = topo._segments[0]
        seg.try_engage = timed(seg.try_engage, "engage")
        seg._pull = timed(seg._pull, "pull")
        seg.work = timed(seg.work, "fused")
        check(topo.wait_inactive(timeout=300.0), "config #3 block path did "
                                                 "not finish")
        secs["wall"] = time.perf_counter() - t0
        secs["collect"] = sink._work_time
        secs["drain"] = fir._work_time + iir._work_time - secs["fused"]
        secs["step"] = secs["fused"] - secs["pull"]
        return sink.get_buffer(), seg, secs, fir.get_taps(), iir.get_taps()

    k1_calls19 = []
    zero_counts()
    with watched(fops, "cgemm", lambda args, out: k1_calls19.append(args)):
        out19, seg19, secs19, taps19, iir_taps19 = config3_block_run()
    launches19 = read_counts()
    n_out19 = (n19 - 19) // MR * LR
    print(f"[19] block API FIRDesigner -> FIR 3:2 ({len(taps19)} taps) -> "
          f"IIR ({len(iir_taps19)} taps) <- IIRDesigner on {dev}, {n19} "
          f"samples: launches {launches19}; segment of "
          f"{len(seg19.blocks)} blocks engaged {seg19.engage_count}x, "
          f"{seg19.fused_elements} samples fused")
    check(len(taps19) == 60 and len(iir_taps19) == 10,
          "the designers did not set the filters' taps")
    check(seg19.engage_count >= 1 and len(seg19.blocks) == 2
          and seg19.fused_elements == 1 << 24,
          "the config #3 segment did not engage for one 2^24 pull")
    shapes19 = [(tuple(a.shape[:2]), tuple(g.shape)) for a, g, _ in
                k1_calls19]
    print(f"[19] K1 launches (operand, operator planes): {shapes19}")
    check(launches19["cgemm"] == 1
          and launches19["cgemm_by_variant"][TENSOR_CORES] == 1
          and shapes19 == [(((1 << 24) // 256, 288), (288, 384))],
          "the config #3 block path did not launch cgemm once on the "
          "tensor cores for its 2^24 pull")
    # K1 against its plain version on the pull's own operand
    k1_by_shape.append(k1_at(19, *k1_calls19[0], "resampler_block_api"))
    del k1_calls19
    check(out19.shape == (n_out19,) and out19.dtype == np.complex64
          and bool(np.isfinite(out19.view(np.float32)).all()),
          f"config #3 block path output {out19.shape} {out19.dtype}, "
          f"expected ({n_out19},) complex64, finite")
    half19 = len(iir_taps19) // 2
    ba19 = (iir_taps19[:half19] / iir_taps19[half19],
            iir_taps19[half19:] / iir_taps19[half19])
    x19d = x19.astype(np.complex128)
    lead19, win19 = 4096, 512
    pull_out = (1 << 24) // MR * LR
    block_err = 0.0
    for what, s0 in (("start", 0), ("inside the pull", pull_out // 2),
                     ("pull boundary", pull_out - win19 // 2),
                     ("end", n_out19 - win19)):
        a = max(0, s0 - lead19)
        ref = lfilter(*ba19, resampled(x19d, taps19, np.arange(
            a, s0 + win19)))[s0 - a:]
        d = np.max(np.abs(out19[s0:s0 + win19] - ref))
        block_err = max(block_err, d)
        print(f"[19] window [{s0}, {s0 + win19}) ({what}) vs float64 "
              f"oracle from {s0 - a} outputs earlier: max|d| {d:.3e} "
              f"(atol 2e-4)")
        check(d < 2e-4, f"config #3 block path window at {s0} disagrees "
                        f"with the oracle")
    del out19
    out19b, _, secs19b, _, _ = config3_block_run()
    check(out19b.shape == (n_out19,), "second config #3 block path run length")
    del out19b
    for label, sb in (("first (cold)", secs19), ("second", secs19b)):
        rest = sb["wall"] - sb["engage"] - sb["fused"] - sb["collect"] \
            - sb["drain"]
        print(f"[19] on {card}: {label} run {sb['wall']:.3f} s from commit() "
              f"to wait_inactive(), {n19 / sb['wall'] / 1e6:.1f} "
              f"Msamples/s in; engage {sb['engage']:.3f} s, pulls (H2D) "
              f"{sb['pull']:.3f} s, fused steps {sb['step']:.3f} s, collect "
              f"{sb['collect']:.3f} s, drain {sb['drain']:.3f} s, rest "
              f"{rest:.3f} s")

    # -- 20. path "modem_block_api": the scrambled modem chain -----------
    from pothoscomms_tpu_torch.core.block import Block
    from pothoscomms_tpu_torch.core.dtypes import DType
    from pothoscomms_tpu_torch.core.labels import Label

    class KeepSink(Block):
        """Keeps every buffer it gets (device chunks as they come) and
        every label, at its index in the collected stream."""

        def __init__(self):
            super().__init__()
            self.setup_input(0, DType.parse("uint8"))
            self.input(0).set_capacity(None)
            self.parts, self.labels, self.count = [], [], 0

        def work(self):
            port = self.input(0)
            n = port.elements()
            if n:
                self.labels += [lb.shifted(self.count) for lb in port.labels
                                if lb.index < n]
                port.labels = [lb for lb in port.labels if lb.index >= n]
                self.parts.extend(port.take(n))
                self.count += n

        def get_buffer(self):
            return np.concatenate([np.asarray(p) for p in self.parts])

    QPSK = np.array([1 + 1j, -1 + 1j, -1 - 1j, 1 - 1j]) / np.sqrt(2)
    NM, EVERY = 1 << 22, 65536
    bits20 = np.random.default_rng(20).integers(0, 2, NM).astype(np.uint8)
    labels20 = [Label("frame", i, EVERY * i + 5, 1) for i in range(NM // EVERY)]

    def modem_run(mode, labels=None):
        """benches/bench_suite.py bench_digital_modem_bulk's chain on
        Topology() (the card), fed the 2^22 bits in one buffer."""
        blocks = [BlockRegistry.make("/comms/scrambler"),
                  BlockRegistry.make("/comms/bits_to_symbols", 2, "MSBit"),
                  BlockRegistry.make("/comms/symbol_mapper",
                                     "complex_float32"),
                  BlockRegistry.make("/comms/symbol_slicer",
                                     "complex_float32"),
                  BlockRegistry.make("/comms/symbols_to_bits", 2, "MSBit"),
                  BlockRegistry.make("/comms/descrambler")]
        for b in (blocks[0], blocks[-1]):
            b.set_mode(mode)
            b.set_poly(0x8E)
        blocks[2].set_map(QPSK)
        blocks[3].set_map(QPSK)
        feed, sink = FeederSource("uint8"), KeepSink()
        topo = Topology()
        chain = [feed] + blocks + [sink]
        for a, b in zip(chain[:-1], chain[1:]):
            topo.connect(a, 0, b, 0)
        feed.feed_buffer(bits20, labels)
        secs = {"engage": 0.0, "pull": 0.0, "fused": 0.0}

        def timed(fn, key):
            def call(*args):
                t = time.perf_counter()
                out = fn(*args)
                torch.cuda.synchronize()
                secs[key] += time.perf_counter() - t
                return out
            return call

        t0 = time.perf_counter()
        topo.commit()
        seg = topo._segments[0]
        seg.try_engage = timed(seg.try_engage, "engage")
        seg._pull = timed(seg._pull, "pull")
        seg.work = timed(seg.work, "fused")
        check(topo.wait_inactive(timeout=300.0), "modem block path did not "
                                                 "finish")
        secs["wall"] = time.perf_counter() - t0
        secs["collect"] = sink._work_time
        secs["drain"] = sum(b._work_time for b in blocks) - secs["fused"]
        secs["step"] = secs["fused"] - secs["pull"]
        return sink.get_buffer(), sink.labels, topo._segments, secs

    zero_counts()
    runs20 = {"additive": modem_run("additive"),
              "multiplicative": modem_run("multiplicative"),
              "additive, labels": modem_run("additive", labels20)}
    launches20 = read_counts()
    for label, (out, lbs, segs, sb) in runs20.items():
        seg = segs[0]
        print(f"[20] block API scrambler -> bits_to_symbols(2) -> QPSK "
              f"mapper -> slicer -> symbols_to_bits -> descrambler "
              f"({label}) on {seg.topology.device}, {NM} bits: "
              f"{len(segs)} segment of {len(seg.blocks)} blocks engaged "
              f"{seg.engage_count}x, fused_elements {seg.fused_elements}, "
              f"{len(lbs)} labels out")
        check(len(segs) == 1 and len(seg.blocks) == 6
              and seg.engage_count == 1 and seg.fused_elements == NM,
              f"the modem segment ({label}) did not run as one engaged "
              f"six-block segment")
        check(seg.topology.device.type == "cuda", "Topology() is not on "
                                                  "the card")
        check(out.shape == bits20.shape and np.array_equal(out, bits20),
              f"the modem chain ({label}) did not return its input bit "
              f"for bit")
    # the streaming path's adjustment: bits_to_symbols(2) takes index // 2
    # and width // 2 (at least 1), symbols_to_bits(2) doubles both
    exp20 = [(lb.id, lb.data, lb.index // 2 * 2, 2) for lb in labels20]
    got20 = [(lb.id, lb.data, lb.index, lb.width)
             for lb in runs20["additive, labels"][1]]
    check(got20 == exp20, f"labels came out as {got20[:3]}..., expected "
                          f"{exp20[:3]}...")
    print(f"[20] {len(got20)} labels (every {EVERY} bits) carried through "
          f"the engaged segment, index-adjusted as the streaming path "
          f"adjusts them; launches {launches20}")
    for label, (_, _, _, sb) in runs20.items():
        rest = sb["wall"] - sb["engage"] - sb["fused"] - sb["collect"] \
            - sb["drain"]
        print(f"[20] on {card}: {label} run {sb['wall']:.3f} s from "
              f"commit() to wait_inactive(), {NM / sb['wall'] / 1e6:.1f} "
              f"Mbit/s; engage {sb['engage']:.3f} s, pulls (H2D) "
              f"{sb['pull']:.3f} s, fused steps {sb['step']:.3f} s, collect "
              f"{sb['collect']:.3f} s, drain {sb['drain']:.3f} s, rest "
              f"{rest:.3f} s")
    del runs20

    # -- 21. path "link": run_link at 256 channels x 4000-bit frames ------
    from pothoscomms_tpu_torch.core.testing import (search_agreement,
                                                    sync_search_f64)
    from pothoscomms_tpu_torch.ops import framing as framing_ops
    from pothoscomms_tpu_torch.parallel.link import (align_payload,
                                                     apply_channel, run_link,
                                                     tx_waveform)

    # noise 0.001: at 0.01 the preamble's frequency estimate is too coarse
    # for 16064-sample payloads, in the JAX link as here (channels 0, 2, 3
    # of 8 fail in both); at 0.003 channel 96 of 256 fails
    CL, NBL, NOISE = 256, 4000, 0.001
    s1_shapes21 = []
    zero_counts()
    with watched(framing_ops, "sync_search",
                 lambda args, out: s1_shapes21.append(tuple(args[0].shape))):
        res21 = run_link(CL, NBL, seed=21, noise=NOISE)
    launches21 = read_counts()
    sec21 = res21["seconds"]
    n21, x21 = res21["n_pad"], res21["x"]
    print(f"[21] run_link {CL} channels x {NBL}-bit frames (noise {NOISE}) "
          f"on {x21.device}: {sum(res21['bit_exact'])} of {CL} channels "
          f"bit-exact; S1 launches {launches21['sync_search']} at "
          f"{s1_shapes21}; launches {launches21}")
    check(res21["all_exact"], f"link channels not exact: "
          f"{[c for c, ok in enumerate(res21['bit_exact']) if not ok]}")
    check(launches21["sync_search"] == 1
          and s1_shapes21 == [(CL, res21["lp"], 2)],
          "the link did not launch S1 once for the whole batch")
    pre21 = torch.tensor([[1.0, 0.0]], device=dev)
    args21 = (0.01, 80, 80, 4, 1, n21)
    got21 = sync_search(x21, pre21, *args21)
    plain21 = sync_search_plain(x21, pre21, *args21)
    torch.cuda.synchronize()
    # S1's max |d| is that of scale against its plain version over every
    # offset (the other arrays' are held to the oracle below)
    s1_abs = (got21[0] - plain21[0]).abs().max().item()
    d_peak = (got21[3] != plain21[3]).sum().item()
    chans21 = [0, 1, 37, 96, 128, 200, 254, 255]
    ref21 = sync_search_f64(x21[chans21].cpu().numpy(), [1.0], *args21)
    s1_oracle = {}
    for label, arrays in (("S1", got21), ("plain", plain21)):
        agree = search_agreement([a[chans21].cpu().numpy() for a in arrays],
                                 ref21)
        s1_oracle[label] = agree
        print(f"[21] {label} vs float64 oracle on channels {chans21}: "
              f"{agree}")
        check(agree["scale_zero_mismatch"] == 0 and agree["peak_mismatch"]
              == 0 and agree["scale_rel"] <= 1e-5
              and agree["delta_fc_abs"] <= 1e-5 and agree["phase_abs"]
              <= 2e-3, f"{label} disagrees with the float64 oracle")
    print(f"[21] S1 vs its plain version at [{CL}, {res21['lp']}, 2], "
          f"n={n21}: max|d scale| {s1_abs:.3e}, corr_peak differs at "
          f"{d_peak} of {CL * n21} offsets")
    # the bound: the search's least work, 806 operations an offset here
    # (ops_per_offset: one complex multiply-add a correlation tap, which no
    # formulation can do without, the preamble applied once a symbol; K's
    # product and |x| once a sample, direct window and K sums), x read
    # once, four [C, n] float32 outputs
    s1_bound = bound(*work(CL, res21["lp"], n21, *args21[1:5]))
    pool21 = [(x21,)]
    s1_ms = event_ms(lambda x: sync_search(x, pre21, *args21), pool21,
                     calls=20)
    s1_device_ms = device_ms(lambda x: sync_search(x, pre21, *args21),
                             pool21, calls=20, per_call=1,
                             floor_ms=s1_bound[0])
    s1_plain_ms = event_ms(lambda x: sync_search_plain(x, pre21, *args21),
                           pool21, calls=3)
    print(f"[21] on {card}: TX {sec21['tx']:.3f} s ({CL} topologies on the "
          f"host), upload {sec21['upload']:.3f} s, search "
          f"{sec21['search'] * 1e3:.3f} ms (one S1 launch and the arrays' "
          f"copy back), RX decode on the host {sec21['rx_decode']:.3f} s; "
          f"S1 alone {s1_ms:.4f} ms ({f4(s1_device_ms)} on the card), bound "
          f"{s1_bound[0]:.4f} ms by {s1_bound[1]} "
          f"({ops_per_offset(*args21[1:5])} operations an offset; "
          f"{s1_bound[0] / s1_ms:.1%} of it by events, "
          f"{share(s1_bound[0], s1_device_ms)} on the card), plain version "
          f"{s1_plain_ms:.3f} ms ({s1_plain_ms / s1_ms:.1f}x S1); plan "
          f"(k, threads) {card_plan(CL, n21, 80)}")
    s1_by_shape = {f"{CL}x{res21['lp']}": {
        "path": "link", "launches": launches21["sync_search"],
        "plan": card_plan(CL, n21, 80), "ms": s1_ms,
        "device_ms": s1_device_ms, "bound_ms": s1_bound[0],
        "bound_by": s1_bound[1]}}
    arrays21 = res21["arrays"]  # held against the sharded link in [27]
    del got21, plain21, res21, x21

    # -- 22. path "frame_sync_block_api": FrameSync and the loopback ------
    NF22 = 64
    rng22 = np.random.default_rng(22)
    bits22 = [rng22.integers(0, 2, NBL).astype(np.uint8) for _ in range(NF22)]
    frames22 = [apply_channel(
        tx_waveform(b), gap_pre=300 + 40 * f, gap_post=500 - 40 * (f % 8),
        attenuation=0.4 + 0.05 * (f % 8), phase=0.3 * f,
        freq_offset=1e-4 * ((f % 5) - 2), noise=NOISE,
        rng=np.random.default_rng(122 + f)) for f, b in enumerate(bits22)]
    stream22 = np.concatenate(frames22)
    s1_first22, s1_shapes22 = {}, []

    def note_s1(args, out):
        """Notes each S1 launch's shape, and keeps the first input of each
        shape to hold it against the oracle after the run."""
        key = tuple(args[0].shape)
        if key not in s1_first22:
            s1_first22[key] = [args[0].clone(), args[1].clone()] \
                + list(args[2:])
        s1_shapes22.append(key)

    def frame_sync_run(device=None):
        fs = BlockRegistry.make("/comms/frame_sync", "complex_float32")
        fs.set_output_mode("TIMING")
        fs.set_preamble([1.0])
        fs.set_symbol_width(20)
        fs.set_data_width(4)
        fs.set_frame_start_id("rxStart")
        fs.set_frame_end_id("")
        fs.set_input_threshold(0.01)
        feed = FeederSource("complex_float32")
        sink = CollectorSink("complex_float32")
        topo = Topology(device=device)  # None: the card, by default
        topo.connect(feed, 0, fs, 0)
        topo.connect(fs, 0, sink, 0)
        # the feeder gets ahead of the search by at most one frame: each
        # search sees one or two frames (a search over the whole stream
        # would take minutes on the CPU)
        fs.input(0).set_capacity(20000)
        for fr in frames22:
            feed.feed_buffer(fr)
        t0 = time.perf_counter()
        topo.commit()
        check(topo.wait_inactive(timeout=300.0), "frame sync path did not "
                                                 "finish")
        return sink.get_buffer(), sink.get_labels(), \
            time.perf_counter() - t0, topo.device

    zero_counts()
    with watched(framing_ops, "sync_search", note_s1):
        out22, lbs22, wall22, dev22 = frame_sync_run()
    launches22 = read_counts()
    starts22 = [lb for lb in lbs22 if lb.id == "rxStart"]
    shapes22 = sorted(set(s1_shapes22))
    print(f"[22] block API feeder -> /comms/frame_sync (TIMING) -> collector "
          f"on {dev22}, {NF22} frames of {NBL} bits ({len(stream22)} "
          f"samples): {len(starts22)} frame starts; S1 launches "
          f"{launches22['sync_search']} at shapes {shapes22}; launches "
          f"{launches22}")
    check(dev22.type == "cuda", "Topology() is not on the card")
    check(len(starts22) == NF22 and launches22["sync_search"]
          == len(s1_shapes22) >= NF22,
          "frame sync did not find every frame through S1")
    exact22 = 0
    for f, lb in enumerate(starts22):
        syms = out22[lb.index: lb.index + lb.data]
        rec = align_payload((syms.real > 0).astype(np.uint8), NBL)
        exact22 += int(lb.data == NBL + 16 and rec is not None
                        and np.array_equal(rec, bits22[f]))
    print(f"[22] {exact22} of {NF22} frames' payloads exact after slicing "
          f"and per-frame descrambling")
    check(exact22 == NF22, "frame sync payloads not exact")
    for key in shapes22:
        x_, pre_, *rest = s1_first22[key]
        ref_ = sync_search_f64(x_.cpu().numpy(), [1.0], *rest)
        for label, fn in (("S1", sync_search), ("plain", sync_search_plain)):
            agree = search_agreement(
                [a.cpu().numpy() for a in fn(x_, pre_, *rest)], ref_)
            check(agree["scale_zero_mismatch"] == 0 and agree["peak_mismatch"]
                  == 0 and agree["scale_rel"] <= 1e-5
                  and agree["delta_fc_abs"] <= 1e-5
                  and agree["phase_abs"] <= 2e-3,
                  f"{label} at {key} disagrees with the float64 oracle")
        print(f"[22] S1 launch shape {key}: S1 and its plain version held "
              f"to the float64 oracle on that launch's input ({agree})")
        # S1 timed at this launch's shape, beside its bound
        C_, L_ = key[0], key[1]
        b_ = bound(*work(C_, L_, rest[-1], *rest[1:5]))
        fn_ = lambda x, rest=rest: sync_search(x, pre_, *rest)  # noqa: E731
        ms_ = event_ms(fn_, [(x_,)], calls=20)
        dev_ = device_ms(fn_, [(x_,)], calls=20, per_call=1, floor_ms=b_[0])
        s1_by_shape[f"{C_}x{L_}"] = {
            "path": "frame_sync_block_api",
            "launches": s1_shapes22.count(key),
            "plan": card_plan(C_, rest[-1], rest[2]), "ms": ms_,
            "device_ms": dev_, "bound_ms": b_[0], "bound_by": b_[1]}
        print(f"[22] on {card}: S1 at {key}, plan (k, threads) "
              f"{card_plan(C_, rest[-1], rest[2])}: {ms_:.4f} ms by events "
              f"(the host's enqueue included), {f4(dev_)} on the card; "
              f"bound {b_[0]:.5f} ms by {b_[1]} ({share(b_[0], dev_)} of it "
              f"on the card)")
    del s1_first22
    out22c, lbs22c, wall22c, _ = frame_sync_run("cpu")
    same = [(lb.id, lb.data, lb.index, lb.width) for lb in lbs22] == \
        [(lb.id, lb.data, lb.index, lb.width) for lb in lbs22c]
    d22 = float(np.max(np.abs(out22 - out22c))) if out22.shape == \
        out22c.shape else float("inf")
    print(f"[22] the same stream on Topology(device='cpu') (the plain "
          f"search): labels equal {same}, symbols max|d| {d22:.3e} (atol "
          f"1e-5)")
    check(same and d22 <= 1e-5, "frame sync on the card disagrees with the "
                                "CPU")
    print(f"[22] on {card}: {wall22:.3f} s from commit() to wait_inactive() "
          f"({len(stream22) / wall22 / 1e6:.2f} Msamples/s, "
          f"{NF22 / wall22:.1f} frames/s); on the CPU {wall22c:.3f} s")

    # the loopback of benches/bench_suite.py bench_digital_link: 2 x 20
    # packets of 256 bits through framer and correlator on Topology()
    from pothoscomms_tpu_torch import Packet

    rngl = np.random.default_rng(3)
    preamble_l = rngl.integers(0, 2, 32).astype(np.uint8)
    batches = [[rngl.integers(0, 2, 256).astype(np.uint8) for _ in range(20)]
               for _ in range(2)]
    feeder = FeederSource("uint8")
    gen = BlockRegistry.make("/blocks/packet_to_stream")
    gen.set_frame_start_id("txStart")
    gen.set_frame_end_id("txEnd")
    framer = BlockRegistry.make("/comms/preamble_framer")
    framer.set_preamble(preamble_l)
    framer.set_frame_start_id("txStart")
    framer.set_frame_end_id("txEnd")
    framer.set_padding_size(8)
    corr = BlockRegistry.make("/comms/preamble_correlator")
    corr.set_preamble(preamble_l)
    corr.set_threshold(0)
    corr.set_frame_start_id("rxStart")
    deframer = BlockRegistry.make("/blocks/stream_to_packet")
    deframer.set_frame_start_id("rxStart")
    deframer.set_mtu(256)
    sinkl = CollectorSink("uint8")
    topol = Topology()
    chainl = [feeder, gen, framer, corr, deframer, sinkl]
    for a, b in zip(chainl[:-1], chainl[1:]):
        topol.connect(a, 0, b, 0)
    delivered, walls = 0, []
    for k, payloads in enumerate(batches):
        first = len(sinkl.packets)
        if k:  # a sacrificial lead frame for the first batch's flush
            feeder.feed_packet(Packet(np.zeros(256, np.uint8)))
        for p in payloads:
            feeder.feed_packet(Packet(p))
        feeder.feed_packet(Packet(np.zeros(len(preamble_l), np.uint8)))
        t0 = time.perf_counter()
        check(topol.wait_inactive(timeout=120.0), "loopback did not finish")
        walls.append(time.perf_counter() - t0)
        j = 0
        for pkt in sinkl.packets[first:]:  # in order, skipping artifacts
            for i in range(j, len(payloads)):
                if np.array_equal(pkt.payload, payloads[i]):
                    delivered += 1
                    j = i + 1
                    break
    print(f"[22] loopback packet_to_stream -> preamble_framer -> "
          f"preamble_correlator -> stream_to_packet on {topol.device}: "
          f"{delivered} of 40 payloads bit-exact; on {card}: "
          f"{walls[0]:.3f} s and {walls[1]:.3f} s a batch of 20 "
          f"({20 * 256 / walls[1] / 1e3:.1f} kbit/s warm)")
    check(delivered == 40, "loopback payloads not delivered bit-exact")

    # -- 23. path "wave_chain_block_api": waveform_source -> scale ->
    # rotate -> FIR -> FFT, one source-headed segment engaged cold ---------
    from pothoscomms_tpu_torch import Block, DType
    from pothoscomms_tpu_torch.blocks.sources import noise_walk_plain
    from pothoscomms_tpu_torch.core.fusion import DeviceChunk
    from pothoscomms_tpu_torch.core.testing import (
        FUSED_MATH_CASES, fused_math_agree, fused_math_feeds, fused_math_run)
    from pothoscomms_tpu_torch.parallel import cplx as cplx_mod
    from pothoscomms_tpu_torch.parallel import fft as pfft_mod

    class RangeSink(Block):
        """Counts what arrives and keeps, on the card, only the sample
        ranges in ``keep`` ({key: (start, length)}): no copy of the
        stream."""

        def __init__(self, dtype, keep):
            super().__init__()
            self.setup_input(0, DType.parse(dtype))
            self.input(0).set_capacity(None)
            self.count, self.host_parts, self.ranges = 0, 0, keep
            self.pieces = {k: [] for k in keep}

        def work(self):
            port = self.input(0)
            n = port.elements()
            if not n:
                return
            for part in port.take(n):
                m = len(part)
                if isinstance(part, DeviceChunk):
                    planar = part.planar
                else:  # the streamed drain posts host arrays
                    self.host_parts += 1
                    arr = np.ascontiguousarray(part)
                    planar = torch.from_numpy(arr.view(np.float32).reshape(
                        (m, 2) if np.iscomplexobj(arr) else (m,)))
                for k, (start, length) in self.ranges.items():
                    lo = max(start, self.count)
                    hi = min(start + length, self.count + m)
                    if lo < hi:
                        self.pieces[k].append(
                            planar[lo - self.count:hi - self.count]
                            .to(dev, copy=True))
                self.count += m

        def kept(self, k):
            y = torch.cat(self.pieces[k]).cpu().numpy()
            return y.view(np.complex64)[:, 0] if y.ndim == 2 else y

    def watch_quanta(seg, fir=None):
        """Notes each fused quantum of a source-headed segment: (samples
        generated, pair core engaged, the FIR's streaming work calls and
        consumed samples before it)."""
        quanta = []
        work_source = seg._work_source

        def noting():
            before = seg.source._source_quota
            streamed = (fir._work_calls, fir.input(0).total_consumed) \
                if fir is not None else None
            pair = seg.pair_engaged
            work_source()
            if seg.source._source_quota < before:  # a quantum ran
                quanta.append((before - seg.source._source_quota, pair,
                               streamed))

        seg._work_source = noting
        return quanta

    def trace_summary(prof):
        """(host-to-device bytes, seconds of kernels, the six kernels that
        took longest with their seconds) of a torch.profiler trace: its
        chrome trace's memcpy and kernel events."""
        path = build.BUILD_DIR / "h2d_trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text()).get("traceEvents", [])
        path.unlink()
        h2d = sum(int(e.get("args", {}).get("bytes", 0)) for e in events
                  if "HtoD" in str(e.get("name", "")))
        by_name = {}
        for e in events:
            if e.get("cat") == "kernel":
                name = str(e.get("name", ""))[:60]
                by_name[name] = by_name.get(name, 0.0) + float(
                    e.get("dur", 0)) * 1e-6
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        return h2d, sum(by_name.values()), top

    K23, NB23, RUNS23 = 64, 1024, (1 << 25, 1 << 25, 1 << 27, 1 << 27)
    N23 = sum(RUNS23)
    rng23 = np.random.default_rng(3)
    taps23 = (rng23.normal(size=K23) + 1j * rng23.normal(size=K23)) / K23
    src23 = BlockRegistry.make("/comms/waveform_source", "complex_float32")
    src23.set_waveform("SINE")
    src23.set_frequency(1.217e6)
    src23.set_sample_rate(30.72e6)
    sc23 = BlockRegistry.make("/comms/scale", "complex_float32")
    sc23.set_factor(0.5)
    rot23 = BlockRegistry.make("/comms/rotate", "complex_float32")
    rot23.set_phase(0.3)
    fir23 = BlockRegistry.make("/comms/fir_filter", "complex_float32",
                               "COMPLEX")
    fir23.set_taps(taps23)
    fft23 = BlockRegistry.make("/comms/fft", "complex_float32", NB23, False)
    nwin23 = (N23 - (K23 - 1)) // NB23
    # the first window after the cold start; the window holding the FIR
    # output where the timed run's second quantum starts (not a window
    # boundary: the first run's drain left a sub-window leftover); the last
    q23 = 1 << 24
    straddle = (RUNS23[0] + RUNS23[1] + q23 - (K23 - 1)) // NB23
    keep23 = {0: "first after the cold start",
              straddle: "across the timed run's first quantum boundary",
              nwin23 - 1: "last"}
    sink23 = RangeSink("complex_float32",
                      {w: (w * NB23, NB23) for w in keep23})
    topo23 = Topology()
    chain23 = [src23, sc23, rot23, fir23, fft23, sink23]
    for a, b in zip(chain23[:-1], chain23[1:]):
        topo23.connect(a, 0, b, 0)
    topo23.commit()
    check(len(topo23._segments) == 1
          and topo23._segments[0].blocks == chain23[:-1],
          f"the wave chain is not one source-headed segment of five blocks: "
          f"{[len(s.blocks) for s in topo23._segments]}")
    seg23 = topo23._segments[0]
    quanta23 = watch_quanta(seg23, fir23)
    # every K1 call of the path, by (operand, operator) shape: its count
    # and the first call's operands, held against the plain version below
    k1_calls23 = {}

    def note_k1_23(args, out):
        key = (tuple(args[0].shape[:2]), tuple(args[1].shape))
        k1_calls23.setdefault(key, [0, args[:3]])[0] += 1

    walls23, ends23 = [], []
    zero_counts()
    with contextlib.ExitStack() as stack:
        for mod in (cplx_mod, chain_mod, fops, pfft_mod):
            stack.enter_context(watched(mod, "cgemm", note_k1_23))
        for i, n in enumerate(RUNS23):
            # the last run repeats the timed one under torch.profiler, for
            # its host-to-device bytes and kernel time
            prof23 = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) \
                if i == len(RUNS23) - 1 else contextlib.nullcontext()
            with prof23:
                t0 = time.perf_counter()
                topo23.run_source_elements(n)
                torch.cuda.synchronize()
                walls23.append(time.perf_counter() - t0)
            ends23.append(len(quanta23))
    launches23 = read_counts()
    bytes23, busy23, top23 = trace_summary(prof23)
    first23 = quanta23[0]
    runs23 = [quanta23[lo:hi] for lo, hi in zip([0] + ends23, ends23)]
    pairs23 = [(sum(1 for q in r if q[1]), sum(1 for q in r if not q[1]))
               for r in runs23]
    print(f"[23] wave chain waveform_source(SINE 1.217 MHz at 30.72 MSps) -> "
          f"scale(0.5) -> rotate(0.3) -> FIR({K23} taps) -> FFT({NB23}) on "
          f"{topo23.device}, runs of {RUNS23}: launches {launches23}; one "
          f"segment of {len(seg23.blocks)} blocks, engaged "
          f"{seg23.engage_count}x ({seg23.cold_engages} cold), "
          f"{len(quanta23)} fused quanta, {seg23.fused_elements} samples "
          f"fused, the first {first23[0]} (FIR streaming calls and samples "
          f"before it: {first23[2]}); the drains streamed "
          f"{src23.output(0).total_produced} samples")
    print(f"[23] fused quanta a run (on the FIR->FFT pair core, on the FIR "
          f"and FFT singles): "
          + ", ".join(f"run {i + 1} ({n}) {p} pair / {s1} single"
                      for i, (n, (p, s1)) in enumerate(zip(RUNS23, pairs23)))
          + " (after run 1 the FFT keeps a sub-window leftover, which the "
            "pair cannot take: later runs go through the singles)")
    check(seg23.cold_engages >= 1 and first23[2] == (0, 0)
          and first23[0] == q23 + K23 - 1,
          "the wave chain did not engage cold before any FIR streaming round")
    check(not runs23[0][0][1] and any(q[1] for q in runs23[0][1:]),
          "the wave chain did not cycle from its cold singles to the pair "
          "in run 1")
    form23 = fir_fft_form(K23, NB23, 1, NB23)
    n_pair23 = sum(p for p, _ in pairs23)
    print(f"[23] the pair's form: {form23}; {n_pair23} pair quanta, "
          f"fir_fft_fused launches {launches23['fir_fft_fused']}")
    check(form23 == "one_pass"
          and launches23["fir_fft_fused"] == n_pair23,
          "the wave chain's pair did not launch fir_fft_fused once a pair "
          "quantum")
    check(launches23["cgemm"] >= 1 and launches23["fft_c2c"] >= 1,
          "the wave chain did not launch cgemm and fft_c2c")
    check(launches23["cgemm_by_variant"][TENSOR_CORES]
          == launches23["cgemm"],
          "a wave chain cgemm launch missed the tensor-core variant")
    check(sum(c[0] for c in k1_calls23.values()) == launches23["cgemm"],
          f"K1 calls noted ({sum(c[0] for c in k1_calls23.values())}) and "
          f"launches counted ({launches23['cgemm']}) differ on the wave chain")
    print(f"[23] K1 launches by (operand, operator planes): "
          f"{ {k: c[0] for k, c in k1_calls23.items()} }")
    # K1 against its plain version at each shape the path launched
    for c in k1_calls23.values():
        k1_by_shape.append(k1_at(23, *c[1], "wave_chain_block_api"))
    del k1_calls23
    generated = sum(q[0] for q in quanta23) + src23.output(0).total_produced
    check(src23._source_quota == 0 and generated == N23,
          f"the source generated {generated} samples for {N23} granted")
    check(sink23.count == nwin23 * NB23,
          f"{sink23.count // NB23} windows, expected {nwin23}")
    print(f"[23] {sink23.count // NB23} windows = floor(({N23} - "
          f"{K23 - 1}) / {NB23}); {generated} samples generated for {N23} "
          f"granted; host-to-device bytes in the traced run (torch.profiler): "
          f"{bytes23} (one quantum of stream data: {q23 * 8})")
    check(bytes23 < q23 * 8, "the traced wave chain run moved a quantum of "
                             "stream data from the host")
    tab23 = src23._table.astype(np.complex128)
    wave_err = 0.0
    for w, what in keep23.items():
        j = np.arange(w * NB23, w * NB23 + NB23 + K23 - 1)
        seq = tab23[(j * src23._step) & src23._mask] * 0.5 * np.exp(0.3j)
        exp = np.fft.fft(np.convolve(seq, taps23, "valid"))
        rel = np.max(np.abs(sink23.kept(w) - exp)) / np.max(np.abs(exp))
        wave_err = max(wave_err, rel)
        print(f"[23] window {w} ({what}) vs float64 numpy oracle: "
              f"/max|spectrum| {rel:.3e} (limit 1e-4)")
        check(rel < 1e-4, f"wave chain window {w} disagrees with the oracle")
    print(f"[23] on {card}: runs of {RUNS23[0]}, {RUNS23[1]} (warm-up) "
          f"{walls23[0]:.3f} s and {walls23[1]:.3f} s; timed run of "
          f"{RUNS23[2]} samples {walls23[2]:.4f} s, "
          f"{RUNS23[2] / walls23[2] / 1e6:.1f} Msamples/s (on the FIR and "
          f"FFT singles: {pairs23[2][0]} pair quanta); the same run again "
          f"under torch.profiler {walls23[3]:.4f} s, kernels {busy23:.4f} s "
          f"of it (the card idle {1 - busy23 / walls23[3]:.1%} of the traced "
          f"run), the longest: "
          + "; ".join(f"{k} {v:.4f} s" for k, v in top23))
    del topo23, sink23, prof23

    # -- 24. path "fm_source_block_api": noise_source -> freq_demod ->
    # dc_removal -> envelope_detector, one source-headed segment ----------
    HEAD24 = 1 << 22
    RUNS24 = (1 << 25, 1 << 27)

    def fm_source_topology(fuse, head=0):
        src = BlockRegistry.make("/comms/noise_source", "complex_float32", 11)
        src.set_waveform("NORMAL")
        src.set_fast(True)
        blocks = fm_blocks(DB, CASCB, ATTB, RELB)
        sink = RangeSink("float32", {0: (0, head)} if head else {})
        topo = Topology()
        topo.auto_fuse = fuse
        chain = [src] + blocks + [sink]
        for a, b in zip(chain[:-1], chain[1:]):
            topo.connect(a, 0, b, 0)
        topo.commit()
        return topo, src, sink

    topo24, src24, sink24 = fm_source_topology(True, HEAD24)
    check(len(topo24._segments) == 1 and len(topo24._segments[0].blocks) == 4
          and topo24._segments[0].source is src24,
          "the FM chain is not one source-headed segment of four blocks")
    seg24 = topo24._segments[0]
    walk24 = []  # (carry, t) of every fused generation step, in order
    export24 = src24.fuse_source_export

    def noting_export(channels):
        carry, step, params = export24(channels)
        check(params[0].device.type == "cuda", "the noise pool is not on "
                                               "the card")

        def noted(c, t, table):
            walk24.append((c, t, src24.output(0).total_produced))
            return step(c, t, table)

        return carry, noted, params

    src24.fuse_source_export = noting_export
    quanta24 = watch_quanta(seg24)
    walls24 = []
    zero_counts()
    n_noted = len(e1_launched)
    with watched(fops, "envelope_rows", note_e1):
        for n in RUNS24:
            t0 = time.perf_counter()
            topo24.run_source_elements(n)
            torch.cuda.synchronize()
            walls24.append(time.perf_counter() - t0)
    launches24 = read_counts()
    print(f"[24] FM chain noise_source(seed 11, NORMAL, fast) -> freq_demod "
          f"-> dc_removal({DB}, {CASCB}) -> envelope({ATTB}, {RELB}) on "
          f"{topo24.device}, runs of {RUNS24}: launches {launches24}; one "
          f"segment of {len(seg24.blocks)} blocks, engaged "
          f"{seg24.engage_count}x, {len(quanta24)} fused quanta, "
          f"{seg24.fused_elements} samples fused, "
          f"{src24.output(0).total_produced} streamed")
    check(launches24["envelope"] >= 1, "the FM source path did not launch E1")
    check(len(e1_launched) - n_noted == launches24["envelope"],
          "E1 calls noted and launches counted differ on the FM source path")
    hold_e1_launches("fm_source_block_api", n_noted)
    check(sink24.count == sum(RUNS24), f"FM source path: {sink24.count} "
                                       f"outputs for {sum(RUNS24)} samples")
    # the oracle's input: the plain version of the fused walk, from the
    # pool and the walk's offsets, from the stream's first sample
    check(walk24 and walk24[0][2] == 0,
          "the FM source path streamed before its first fused quantum")
    pool24 = np.ascontiguousarray(src24._table).view(np.float32).reshape(
        -1, 2)
    parts24, have = [], 0
    for c, t, _ in walk24:
        if have >= HEAD24:
            break
        c2, y = noise_walk_plain(pool24, c, t)
        parts24.append(y)
        have += t
    x24 = np.concatenate(parts24)[:HEAD24]
    x24 = x24[:, 0].astype(np.float64) + 1j * x24[:, 1]
    exp24 = fm_oracle(x24, DB, CASCB, ATTB, RELB)
    got24 = sink24.kept(0)
    fm_src_err = float(np.max(np.abs(got24 - exp24)))
    print(f"[24] the first {HEAD24} outputs vs the float64 FM oracle on the "
          f"input rebuilt on the host from the pool and the walk's offsets "
          f"(noise_walk_plain): max|d| {fm_src_err:.3e} (atol 2e-3)")
    check(fm_src_err <= 2e-3, "the FM source path disagrees with the oracle")
    counts24 = {}
    for fuse in (True, False):
        topo, _, sink = fm_source_topology(fuse)
        topo.run_source_elements((1 << 20) + 12345)
        counts24[fuse] = sink.count
    print(f"[24] output count at {(1 << 20) + 12345} samples, fused "
          f"{counts24[True]}, streaming (auto_fuse False) {counts24[False]}")
    check(counts24[True] == counts24[False] == (1 << 20) + 12345,
          "the FM source path's output count differs from streaming")
    print(f"[24] on {card}: warm-up run of {RUNS24[0]} samples "
          f"{walls24[0]:.3f} s; timed run of {RUNS24[1]} samples "
          f"{walls24[1]:.3f} s, {RUNS24[1] / walls24[1] / 1e6:.1f} "
          f"Msamples/s")
    del topo24, sink24

    # -- 25. the math catalog on the card --------------------------------
    chunk_devices = []

    def note_post(args, out):
        ys = args[1] if isinstance(args[1], tuple) else (args[1],)
        chunk_devices.extend(y.device.type for y in ys)

    n25 = (1 << 18) + 17
    math_err = {}
    for name in FUSED_MATH_CASES:
        feeds = fused_math_feeds(name, n25, 25)
        n_chunks = len(chunk_devices)
        with watched(fusion.FusedSegment, "_post", note_post):
            got, topo = fused_math_run(name, feeds, device=dev)
        ref, _ = fused_math_run(name, feeds, device="cpu", fuse=False)
        seg = topo._segments[0]
        check(seg.fused_elements >= 1 << 18,
              f"{name} did not engage on the card")
        check(set(chunk_devices[n_chunks:]) == {"cuda"},
              f"{name}'s fused core posted on {set(chunk_devices[n_chunks:])}")
        try:
            math_err[name] = fused_math_agree(name, got, ref)
        except AssertionError as e:
            check(False, f"math block on the card vs the CPU: {e}")
    exact = [n for n in FUSED_MATH_CASES if FUSED_MATH_CASES[n][7] is None]
    print(f"[25](a) {len(math_err)} fusable math blocks engaged on the card "
          f"at {n25} samples (each with an exact hop), against the streaming "
          f"path on device='cpu': bit for bit {exact}; the rest within their "
          f"bounds, max|d| "
          + ", ".join(f"{k} {v:.2e}" for k, v in math_err.items()
                      if k not in exact))

    # (b) fan-in Arithmetic(ADD) -> FFT(1024), one segment on K2
    n25b = (1 << 24) + 3089
    rng25 = np.random.default_rng(25)
    xa = rng25.standard_normal(2 * n25b, dtype=np.float32).view(np.complex64)
    xb25 = rng25.standard_normal(2 * n25b, dtype=np.float32).view(
        np.complex64)
    nw25 = n25b // NB
    keep25 = {0: "start", (1 << 14) - 1: "last of the fused pull",
              1 << 14: "first streamed", nw25 - 1: "end"}
    arith = BlockRegistry.make("/comms/arithmetic", "complex_float32", "ADD")
    fft25 = BlockRegistry.make("/comms/fft", "complex_float32", NB, False)
    sink25 = RangeSink("complex_float32",
                      {w: (w * NB, NB) for w in keep25})
    topo25 = Topology()
    feeds25 = [FeederSource("complex_float32") for _ in range(2)]
    for i, (f, x) in enumerate(zip(feeds25, (xa, xb25))):
        topo25.connect(f, 0, arith, i)
        arith.input(i).set_capacity(4 * QB)
        f.feed_buffer(x)
    topo25.connect(arith, 0, fft25, 0)
    topo25.connect(fft25, 0, sink25, 0)
    fft25.input(0).set_capacity(2 * QB)
    zero_counts()
    t0 = time.perf_counter()
    topo25.commit()
    check(topo25.wait_inactive(timeout=300.0), "fan-in path did not finish")
    wall25 = time.perf_counter() - t0
    launches25 = read_counts()
    seg25 = topo25._segments[0] if topo25._segments else None
    print(f"[25](b) fan-in arithmetic(ADD) -> FFT({NB}) on {topo25.device}, "
          f"2 x {n25b} samples: launches {launches25}; segment of "
          f"{len(seg25.blocks) if seg25 else 0} blocks, "
          f"{len(seg25.heads) if seg25 else 0} heads, "
          f"{seg25.fused_elements if seg25 else 0} samples fused; on {card} "
          f"{wall25:.3f} s from commit() to wait_inactive()")
    check(seg25 is not None and len(seg25.blocks) == 2
          and len(seg25.heads) == 2 and seg25.fused_elements == 1 << 24,
          "the fan-in segment did not run as one engaged segment")
    check(launches25["fft_c2c"] >= 1, "the fan-in path did not launch K2")
    check(sink25.count == nw25 * NB, f"fan-in path: {sink25.count} outputs")
    fanin_err = 0.0
    for w, what in keep25.items():
        s = slice(w * NB, (w + 1) * NB)
        exp = np.fft.fft(xa[s].astype(np.complex128) + xb25[s])
        rel = np.max(np.abs(sink25.kept(w) - exp)) / np.max(np.abs(exp))
        fanin_err = max(fanin_err, rel)
        print(f"[25](b) window {w} ({what}) vs float64 numpy oracle: "
              f"/max|spectrum| {rel:.3e} (limit 1e-4)")
        check(rel < 1e-4, f"fan-in window {w} disagrees with the oracle")
    del topo25, sink25, xa, xb25

    # (c) abs -> modf: the two-output tail on the card
    x25c = (rng25.normal(size=n25) * 8).astype(np.float32)
    outs25c = {}
    for where in (dev, "cpu"):
        ab = BlockRegistry.make("/comms/abs", "float32")
        mf = BlockRegistry.make("/comms/modf", "float32")
        f = FeederSource("float32")
        si, sf = CollectorSink("float32"), CollectorSink("float32")
        topo = Topology(device=where)
        topo.connect(f, 0, ab, 0)
        topo.connect(ab, 0, mf, 0)
        topo.connect(mf, "int", si, 0)
        topo.connect(mf, "frac", sf, 0)
        f.feed_buffer(x25c)
        topo.commit()
        check(topo.wait_inactive(timeout=120.0), "abs -> modf did not finish")
        outs25c[str(where)] = (si.get_buffer(), sf.get_buffer(),
                               topo._segments[0])
    seg25c = outs25c[str(dev)][2]
    print(f"[25](c) abs -> modf on the card: segment of {len(seg25c.blocks)} "
          f"blocks with {len(seg25c.tail_outs)} tail ports, "
          f"{seg25c.fused_elements} samples fused; int and frac planes equal "
          f"to the same topology on the CPU bit for bit: "
          f"{all(np.array_equal(a, b) for a, b in zip(outs25c[str(dev)][:2], outs25c['cpu'][:2]))}")
    check(seg25c.fused_elements >= 1 << 18 and len(seg25c.tail_outs) == 2,
          "abs -> modf did not engage with its two-output tail")
    check(all(np.array_equal(a, b) for a, b in
              zip(outs25c[str(dev)][:2], outs25c["cpu"][:2])),
          "abs -> modf on the card differs from the CPU")

    # -- 26. the control plane on the card (phase_26) ---------------------
    from types import SimpleNamespace

    launches26, errs26 = phase_26(SimpleNamespace(
        dev=dev, card=card, check=check, sync=torch.cuda.synchronize,
        zero_counts=zero_counts, read_counts=read_counts, watched=watched,
        k1_at=k1_at, k1_by_shape=k1_by_shape,
        k1_modules=(cplx_mod, chain_mod, fops, pfft_mod), fops=fops,
        e1_launched=e1_launched, note_e1=note_e1,
        hold_e1_launches=hold_e1_launches, event_ms=event_ms,
        device_ms=device_ms, f4=f4))

    # -- 27. the scale-out layer on the card (phase_27) -------------------
    launches27, summary27 = phase_27(SimpleNamespace(
        dev=dev, card=card, check=check, sync=torch.cuda.synchronize,
        zero_counts=zero_counts, read_counts=read_counts, watched=watched,
        e1_launched=e1_launched, note_e1=note_e1,
        hold_e1_launches=hold_e1_launches, median_ms=median_ms,
        normal=normal, on_card=on_card, fm_blocks=fm_blocks,
        fm_steps=fm_steps, link_arrays=arrays21))
    del arrays21
    print(f"[27] summary on {card}: {json.dumps(summary27)}")

    # -- 28. the BASELINE bench suite (phase_28) ---------------------------
    launches28 = phase_28(SimpleNamespace(
        dev=dev, card=card, check=check, sync=torch.cuda.synchronize,
        zero_counts=zero_counts, read_counts=read_counts, watched=watched,
        k1_at=k1_at, k1_by_shape=k1_by_shape,
        k1_modules=(cplx_mod, chain_mod, fops, pfft_mod), fops=fops,
        e1_launched=e1_launched, note_e1=note_e1,
        hold_e1_launches=hold_e1_launches, event_ms=event_ms,
        device_ms=device_ms, f4=f4, s1_by_shape=s1_by_shape,
        card_plan=card_plan, work=work))

    by_path = {"chain": launches, "one_pass": launches3,
               "block_api": launches_b, "stream_ceiling": launches_p1,
               "layout": launches_p2, "fm_chain": launches_fm,
               "fm_block_api": launches15, "split_step": launches17,
               "resampler_chain": launches18,
               "resampler_block_api": launches19,
               "modem_block_api": launches20, "link": launches21,
               "frame_sync_block_api": launches22,
               "wave_chain_block_api": launches23,
               "fm_source_block_api": launches24,
               "math_fanin_block_api": launches25, **launches26,
               **launches27, **launches28}
    par = "pothoscomms_tpu/parallel/pallas_kernels.py"
    # the bound of each kernel at the shape its ms was taken: bytes of its
    # inputs and outputs, and the float32 operations of its function
    bounds = {
        "cgemm": k1_bound,
        "fft_c2c": bound(2 * frames.numel() * 4,
                         5 * frames.shape[0] * NB * np.log2(NB)),
        "fir_fft_fused": k3_bound,
        "stream_scale": bound(4 * 32768 * 1024 * 4, 2 * 32768 * 1024),
        "layout_move": bound(2 * 4096 * 1024 * 4, 0),
        "envelope": e1_bound,
        "sync_search": s1_bound,
        "fm_demod_dc": f1_bound}
    # name: (source, TPU kernel, max |d|, ms, plain ms, one library call's
    # ms or None where no single PyTorch call computes the function)
    measured = {
        "cgemm": ("cgemm.cu", f"{par}:58", k1_abs, k1_ms, k1_plain_ms,
                  k1_lib_ms),
        "fft_c2c": ("fft.cu", f"{par}:156", k2_abs, k2_ms, k2_plain_ms,
                    k2_cufft_ms),
        "fir_fft_fused": ("fir_fft_fused.cu", f"{par}:325", k3_abs, k3_ms,
                          k3_plain_ms, None),
        "stream_scale": ("stream_scale.cu", "benches/probe_pallas_ceiling"
                         ".py:23", p1_abs, p1["tb256_ms"], p1["plain_ms"],
                         p1["library_ms"]),
        "layout_move": ("layout_move.cu", "benches/probe_mosaic.py:24",
                        p2_abs, p2["A_ms"], p2["A_plain_ms"],
                        p2["A_plain_ms"]),
        "envelope": ("envelope.cu", "pothoscomms_tpu/ops/filter.py:403 "
                     "(an XLA scan, not a Pallas kernel)", e1_abs, e1_ms,
                     e1_plain_ms, None),
        "sync_search": ("sync_search.cu", "pothoscomms_tpu/ops/framing.py:37"
                        " (an XLA program, not a Pallas kernel)", s1_abs,
                        s1_ms, s1_plain_ms, None),
        "fm_demod_dc": ("fm_demod_dc.cu", "pothoscomms_tpu/parallel/chain.py"
                        " freq_demod_planar and the DC core of pothoscomms_tpu"
                        "/blocks/filter.py DCRemoval.device_core (XLA ops, "
                        "not a Pallas kernel)", f1_abs, f1_ms, f1_plain_ms,
                        None)}
    kernels = []
    for name, (src, where, err, ms, plain_ms, lib_ms) in measured.items():
        paths = {p: c[name] for p, c in by_path.items()}
        check(sum(paths.values()) > 0, f"{name} was launched on no path")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"pothoscomms_tpu_torch/csrc/{src}",
            "replaces": where,
            "launches": sum(paths.values()), "launches_by_path": paths,
            "conv_branch_launches": conv_launches[name],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
            "library_ms": lib_ms})
    kernels[0]["launches_by_variant"] = {
        p: c["cgemm_by_variant"] for p, c in by_path.items()}
    kernels[0]["operator_ms"] = k1_operator_ms
    kernels[0]["device_ms"] = k1_device_ms
    kernels[0]["library_device_ms"] = k1_lib_device_ms
    kernels[0]["operator_launches"] = {
        p: c["tf32_operator"] for p, c in by_path.items()}
    kernels[0]["simt_ms"] = k1_simt_ms
    # K1 at the shapes of the split step (one record per R, stream 0's
    # operands), of the resampler and of the wave chain, each held against
    # its plain version
    kernels[0]["by_shape"] = k1_by_shape
    # CUDA events around one call also hold the host's enqueue, which
    # weighs on K2 and P2 (~0.2 ms and ~10 us), so their time on the card
    # is given too, as K1's is above
    kernels[2]["device_ms"] = k3_device_ms
    kernels[2]["without_uw_ms"] = k3_nc_ms
    kernels[2]["without_uw_device_ms"] = k3_nc_device_ms
    kernels[2]["without_uw_bound_ms"] = k3_nc_bound[0]
    kernels[2]["composed_of_library_calls_ms"] = k3_composed_ms
    kernels[5]["device_ms"] = e1_device_ms
    kernels[5]["ms_by_case"] = e1_times
    kernels[5]["device_ms_by_case"] = e1_device
    kernels[6]["device_ms"] = s1_device_ms
    kernels[7]["device_ms"] = f1_device_ms
    kernels[7]["launch_shapes"] = sorted(set(f1_launched))
    kernels[6]["oracle_agreement"] = s1_oracle
    # S1 at the link's and FrameSync's launch shapes
    kernels[6]["by_shape"] = s1_by_shape
    kernels[1]["device_ms"] = k2_device_ms
    kernels[1]["library_device_ms"] = k2_cufft_device_ms
    kernels[1]["by_n_at_32Mi_samples"] = k2_by_n
    kernels[4]["device_ms"] = p2["A_device_ms"]
    kernels[4]["plain_device_ms"] = p2["A_plain_device_ms"]
    kernels[4]["device_ms_by_mode"] = {m: p2[f"{m}_device_ms"]
                                       for m in MODES}
    kernels[4]["plain_device_ms_by_mode"] = {
        m: p2[f"{m}_plain_device_ms"] for m in MODES}
    # P2: each mode's plain version is one permute copy; D's map is B's,
    # so B's permute is D's one library call
    kernels[4]["ms_by_mode"] = {m: p2[f"{m}_ms"] for m in MODES}
    kernels[4]["plain_ms_by_mode"] = {m: p2[f"{m}_plain_ms"] for m in MODES}
    kernels[4]["library_ms_by_mode"] = {
        m: p2[f"{'B' if m == 'D' else m}_plain_ms"] for m in MODES}
    print(f"[16] oracle errors: fm_chain {fm_err:.3e}, fm_block_api "
          f"{fm_block_err:.3e} (atol 2e-3); split step {split_err:.3e} of "
          f"max|spectrum| (limit 1e-4); resampler chain {res_err:.3e} of "
          f"max|y| (limit 1e-4), its IIR output {iir_err:.3e}, config #3 "
          f"block API {block_err:.3e} (atol 2e-4); wave chain {wave_err:.3e} "
          f"and fan-in {fanin_err:.3e} of max|spectrum| (limit 1e-4); FM "
          f"source path {fm_src_err:.3e} (atol 2e-3); control plane "
          f"split {errs26['split_re']:.3e} / {errs26['split_im']:.3e} of "
          f"max|y| (limit 1e-5), fan-in FFT {errs26['fanin_fft_abs']:.3e} "
          f"(abs, limit 0.01), trigger samples "
          f"{errs26['trigger_samples_abs']:.3e} (limit 1e-5), checkpoint "
          f"resume {errs26['checkpoint_abs']:.3e} (atol 1e-3)")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
