#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (pothoscomms_tpu_torch) on one GPU.

    python3 chip_smoke.py        # from the root of a checkout, one CUDA card

Phases, one or more lines each:
  1. device, versions, TF32 flags (both set False);
  2. nvcc build of the port's kernels from pothoscomms_tpu_torch/csrc/,
     one nvcc per source, all started together;
  3. K1 (cgemm) against its plain PyTorch version on the card;
  4. K2 (fft_c2c) against its plain version (and, for information, cuFFT),
     and fft_planar's split for rows above K2's 4096 (8192, 16384);
  5. path "chain", the function-level main path at full width:
     fir_fft_chain(64 complex taps, 1024 bins, 256 channels, 131072
     samples per step) for three chained steps, against the plain path on
     the card, a float64 numpy oracle, and the carry contract;
  6. the conv branch (200 taps), which reaches K2;
  7. CUDA-event timings of the kernel and plain paths;
  8. K3 (fir_fft_fused) against its plain version at [32768, 1024] with
     u_w [32768, 64];
  9. path "one_pass", the one-pass chain make_fused_chain at the same
     width for three chained steps: the float64 oracle, the combined
     step's spectra, the carry, K3's launches, and the step's time
     against the combined step's;
 10. path "block_api": feeder -> /comms/fir_filter (64 complex taps) ->
     /comms/fft (1024) -> collector on Topology(device="cuda:0") with the
     default fuse_threshold, fed 2 x 2^25 samples plus 3*1024+17: the
     fused pair runs K1 per quantum, the drain streams through K2. The
     float64 oracle on windows at the start, at a row and at quantum
     boundaries and at the end, the output length, and the wall time
     from commit() to wait_inactive() with where it went.
Then a JSON line of per-kernel results and, last, {"ok": true, "device":
{...}}. A failed check exits non-zero without that last line, and so does
a run without CUDA.

Each path is driven with every launch count set to 0 just before it and
read just after. A kernel's ``launches`` in the JSON line is the sum over
the three paths, ``launches_by_path`` gives each; the conv branch's are
reported apart, as ``conv_branch_launches``.
"""

import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def check(cond: bool, msg: str) -> None:
    """Stop the run, exit code 1 and no result line, unless ``cond``."""
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: no CUDA card, "
              "nothing run", file=sys.stderr)
        return 1

    from pothoscomms_tpu_torch.kernels import build
    from pothoscomms_tpu_torch.kernels.cgemm import cgemm, cgemm_plain
    from pothoscomms_tpu_torch.kernels.fft import fft_c2c, fft_c2c_plain
    from pothoscomms_tpu_torch.kernels.fir_fft_fused import (
        fir_fft_fused, fir_fft_fused_plain, make_fused_chain)
    from pothoscomms_tpu_torch.parallel.chain import (
        combined_operand, fir_fft_chain, fir_fft_combined_step,
        fir_multichannel)
    from pothoscomms_tpu_torch.parallel.fft import fft_planar

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

    def median_ms(fn, reps=5):
        # warm up for a quarter second, so the clocks have left idle
        t_end = time.perf_counter() + 0.25
        while time.perf_counter() < t_end:
            fn()
            torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

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

    # -- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    sources = ("cgemm", "fft", "fir_fft_fused")
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(build.load, sources))
    print(f"[2] built {', '.join(s + '.cu' for s in sources)} with "
          f"{build.find_nvcc()} in {time.perf_counter() - t0:.2f} s")
    for log in sorted(build.BUILD_DIR.glob("lib*.log")):
        for line in log.read_text().splitlines():
            if "registers" in line or "Compiling entry" in line:
                print(f"    {log.stem.split('-')[0]}: {line.strip()}")

    # -- 3. K1 against its plain version ----------------------------------
    k1_abs = 0.0
    a_main = on_card(normal(32768, 1152, 2))
    gr, gi = on_card(normal(1152, 1024)), on_card(normal(1152, 1024))
    for label, a, g in (
            ("[32768,1152]x[1152,1024]", a_main, (gr, gi)),
            ("[37,100]x[100,77]", on_card(normal(37, 100, 2)),
             (on_card(normal(100, 77)), on_card(normal(100, 77))))):
        got = cgemm(a, *g)
        ref = cgemm_plain(a, *g)
        torch.cuda.synchronize()
        d, rel = errs(got, ref)
        k1_abs = max(k1_abs, d)
        print(f"[3] cgemm {label}: max|d| {d:.3e}, /max|ref| {rel:.3e} "
              f"(limit 1e-5)")
        check(rel < 1e-5, f"cgemm {label} disagrees with its plain version")

    # -- 4. K2 against its plain version (cuFFT for information) ---------
    k2_abs = 0.0
    for n in (16, 64, 100, 384, 1024, 4096):
        for inverse in (False, True):
            x = on_card(normal(64, n, 2))
            got = fft_c2c(x, inverse)
            ref = fft_c2c_plain(x, inverse)
            xc = torch.view_as_complex(x)
            lib = torch.fft.ifft(xc) * n if inverse else torch.fft.fft(xc)
            torch.cuda.synchronize()
            d, rel = errs(got, ref)
            _, rel_lib = errs(got, torch.view_as_real(lib))
            k2_abs = max(k2_abs, d)
            print(f"[4] fft_c2c n={n} {'inv' if inverse else 'fwd'}: "
                  f"/max|plain| {rel:.3e} (limit 2e-5); "
                  f"/max|cuFFT| {rel_lib:.3e} (information)")
            check(rel < 2e-5, f"fft_c2c n={n} inverse={inverse} disagrees "
                              f"with its plain version")
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
    check(run.form == "combined", f"main path took the {run.form} branch")
    xs_host = [normal(C, T, 2) for _ in range(3)]
    xs = [on_card(x) for x in xs_host]
    C6, T6, K6 = 16, 16384, 200
    taps6 = (rng.normal(size=K6) + 1j * rng.normal(size=K6)) / K6
    run6, carry6 = fir_fft_chain(taps6, NB, C6, T6, device=dev)
    check(run6.form == "conv", f"200 taps took the {run6.form} branch")
    xs6 = [on_card(normal(C6, T6, 2)) for _ in range(2)]
    torch.cuda.synchronize()

    wrappers = {"cgemm": cgemm, "fft_c2c": fft_c2c,
                "fir_fft_fused": fir_fft_fused}

    def zero_counts():
        for w in wrappers.values():
            w.launches = 0

    def read_counts():
        torch.cuda.synchronize()
        return {name: w.launches for name, w in wrappers.items()}

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
          f"({run.form}): launches cgemm {launches['cgemm']}, "
          f"fft_c2c {launches['fft_c2c']}")
    check(launches["cgemm"] >= 3, "main path did not launch cgemm each step")
    for s, x in enumerate(xs):
        spec = specs[s]
        check(spec.shape == (C, T // NB, NB, 2), f"step {s} shape "
                                                 f"{tuple(spec.shape)}")
        check(bool(torch.isfinite(spec).all()), f"step {s} not finite")
        ref = cgemm_plain(combined_operand(x, carries[s], NB, K, run.prev_pad),
                          run.gr, run.gi).reshape(spec.shape)
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
    step_plain_ms = median_ms(lambda: cgemm_plain(
        combined_operand(x0, carry0, NB, K, run.prev_pad), run.gr, run.gi))
    k1_ms = median_ms(lambda: cgemm(a_main, gr, gi))
    k1_plain_ms = median_ms(lambda: cgemm_plain(a_main, gr, gi))
    frames = specs[0].reshape(-1, NB, 2)
    k2_ms = median_ms(lambda: fft_c2c(frames))
    k2_plain_ms = median_ms(lambda: fft_c2c_plain(frames))
    k2_cufft_ms = median_ms(lambda: torch.fft.fft(
        torch.view_as_complex(frames)))
    print(f"[7] clocks.sm, power.draw after timing: "
          f"{smi('clocks.sm,power.draw')}")
    print(f"[7] on {card}: main path step {step_ms:.3f} ms "
          f"({C * T / step_ms / 1e3:.1f} Msamples/s), plain step "
          f"{step_plain_ms:.3f} ms")
    print(f"[7] cgemm [32768,1152]x[1152,1024] {k1_ms:.3f} ms, "
          f"plain (torch.matmul) {k1_plain_ms:.3f} ms")
    print(f"[7] fft_c2c [32768,1024] {k2_ms:.3f} ms, plain (DFT matmuls) "
          f"{k2_plain_ms:.3f} ms, cuFFT {k2_cufft_ms:.3f} ms (information)")

    # -- 8. K3 against its plain version at full width --------------------
    run3 = make_fused_chain(taps, NB, device=dev)
    x8, uw8 = on_card(normal(C * T // NB, NB, 2)), on_card(normal(C * T // NB,
                                                                  64, 2))
    got = fir_fft_fused(x8, uw8, run3.H, run3.gcr, run3.gci)
    ref = fir_fft_fused_plain(x8, uw8, run3.H, run3.gcr, run3.gci)
    got_nc = fir_fft_fused(x8, None, run3.H, run3.gcr, run3.gci)
    ref_nc = fir_fft_fused_plain(x8, None, run3.H, run3.gcr, run3.gci)
    torch.cuda.synchronize()
    k3_abs, k3_rel = errs(got, ref)
    d_nc, rel_nc = errs(got_nc, ref_nc)
    k3_abs = max(k3_abs, d_nc)
    print(f"[8] fir_fft_fused [{C * T // NB},{NB}] + u_w [{C * T // NB},64]: "
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
    for s, x in enumerate(xs):
        check(specs3[s].shape == (C, T // NB, NB, 2)
              and bool(torch.isfinite(specs3[s]).all()),
              f"one-pass step {s}: shape or non-finite values")
        _, rel = errs(specs3[s], specs[s])
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
    k3_ms = median_ms(lambda: fir_fft_fused(x8, uw8, run3.H, run3.gcr,
                                            run3.gci))
    k3_plain_ms = median_ms(lambda: fir_fft_fused_plain(
        x8, uw8, run3.H, run3.gcr, run3.gci))
    k3_nc_ms = median_ms(lambda: fir_fft_fused(x8, None, run3.H, run3.gcr,
                                               run3.gci))
    one_pass_ms = median_ms(lambda: run3.run(x0, carry0))
    combined_ms = median_ms(lambda: run(x0, carry0))
    print(f"[9] on {card}: fir_fft_fused [{C * T // NB},{NB}] {k3_ms:.3f} ms "
          f"({k3_nc_ms:.3f} ms without u_w), plain (DFT matmuls + cuBLAS) "
          f"{k3_plain_ms:.3f} ms")
    print(f"[9] on {card}: one-pass step {one_pass_ms:.3f} ms "
          f"({C * T / one_pass_ms / 1e3:.1f} Msamples/s), combined step "
          f"{combined_ms:.3f} ms")
    del x8, uw8, got, ref, got_nc, ref_nc, specs3, carries3

    # -- 10. path "block_api": FIR -> FFT through Topology(device) -------
    from pothoscomms_tpu_torch import BlockRegistry, Topology
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
    check(launches_b["cgemm"] >= 2 and launches_b["fft_c2c"] >= 1,
          "the block path did not launch cgemm >= 2 and fft_c2c >= 1")
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
    del out_b2
    for label, sb in (("first (cold)", secs_b), ("second", secs_b2)):
        rest = sb["wall"] - sb["engage"] - sb["fused"] - sb["collect"] \
            - sb["drain"]
        print(f"[10] on {card}: {label} run {sb['wall']:.3f} s from commit() "
              f"to wait_inactive(), {n_in / sb['wall'] / 1e6:.1f} "
              f"Msamples/s; engage {sb['engage']:.3f} s, pulls (H2D) "
              f"{sb['pull']:.3f} s, fused steps {sb['step']:.3f} s, collect "
              f"{sb['collect']:.3f} s, drain {sb['drain']:.3f} s, rest "
              f"{rest:.3f} s")

    by_path = {"chain": launches, "one_pass": launches3,
               "block_api": launches_b}
    measured = {
        "cgemm": ("cgemm.cu", "pallas_kernels.py:58", k1_abs, k1_ms,
                  k1_plain_ms),
        "fft_c2c": ("fft.cu", "pallas_kernels.py:156", k2_abs, k2_ms,
                    k2_plain_ms),
        "fir_fft_fused": ("fir_fft_fused.cu", "pallas_kernels.py:325",
                          k3_abs, k3_ms, k3_plain_ms)}
    kernels = []
    for name, (src, where, err, ms, plain_ms) in measured.items():
        paths = {p: c[name] for p, c in by_path.items()}
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"pothoscomms_tpu_torch/csrc/{src}",
            "replaces": f"pothoscomms_tpu/parallel/{where}",
            "launches": sum(paths.values()), "launches_by_path": paths,
            "conv_branch_launches": conv_launches[name],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
