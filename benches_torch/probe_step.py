#!/usr/bin/env python3
"""Where a main-path step of the PyTorch + CUDA port spends its time.

    python3 benches_torch/probe_step.py [--tag NAME] [--out DIR]

Needs one CUDA card; run from the root of a checkout. At the north-star
shape (C=256, T=131072, K=64, NBINS=1024) it times, with CUDA events
(3 repetitions, each the median of 10 calls after a quarter second of
warm-up):

- one step ``run(x, carry)`` of ``fir_fft_chain`` (its one-pass form at
  this shape);
- ``combined_operand``, the combined step's operand build;
- K1 ``cgemm`` and its plain version at the combined step's product,
  [32768, 1152] x [1152, 1024];
- K2 ``fft_c2c``, its plain version and cuFFT at 32 Mi samples for
  n in 256, 1024, 4096, 384 and 1000;
- one step of the one-pass chain ``make_fused_chain`` and its
  ``correction_operand``; K3 ``fir_fft_fused`` at the step's shape,
  [32768, 1024] + u_w [32768, 64], with and without u_w, and its plain
  version;
- one step of the split-stream chain ``make_split_step`` (pp = 64) at
  R = 4, 8 and 16, its ``split_operand`` and one of its R K1 products,
  [32768, 64 + 1024/R] x [64 + 1024/R, 1024/R].

Then it traces three steps of each chain with ``torch.profiler`` (device
time per kernel name, K3's share of the one-pass step among them; the
split step at R = 8) and reads the peak device memory of one step. It
prints a summary and writes everything to ``<out>/probe_step_<tag>.json``.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tag", default="probe")
    ap.add_argument("--out", default="chiprun_out")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("probe_step: no CUDA card", file=sys.stderr)
        return 1
    from pothoscomms_tpu_torch.kernels.cgemm import cgemm, cgemm_plain
    from pothoscomms_tpu_torch.kernels.fft import fft_c2c, fft_c2c_plain
    from pothoscomms_tpu_torch.kernels.fir_fft_fused import (
        correction_operand, correction_spectrum, fir_fft_fused,
        fir_fft_fused_plain, make_fused_chain)
    from pothoscomms_tpu_torch.parallel.chain import (
        combined_operand, fir_fft_chain, make_split_step, split_operand)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    rng = np.random.default_rng(0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()

    def normal(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape, dtype=np.float32)).to(dev)

    def timed(fn, reps=3, calls=10):
        """[median ms of ``calls`` calls] x ``reps``, after warm-up."""
        t_end = time.perf_counter() + 0.25
        while time.perf_counter() < t_end:
            fn()
            torch.cuda.synchronize()
        out = []
        for _ in range(reps):
            times = []
            for _ in range(calls):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            out.append(statistics.median(times))
        return out

    C, T, K, NB = 256, 131072, 64, 1024
    taps = (rng.normal(size=K) + 1j * rng.normal(size=K)) / K
    run, carry = fir_fft_chain(taps, NB, C, T, device=dev)
    x = normal(C, T, 2)
    a = combined_operand(x, carry, NB, K, run.prev_pad)
    gr, gi = normal(a.shape[1], NB), normal(a.shape[1], NB)
    res = {"card": card, "torch": torch.__version__,
           "cuda": torch.version.cuda, "shape": [C, T, K, NB],
           "form": run.form}
    res["step_ms"] = timed(lambda: run(x, carry))
    res["combined_operand_ms"] = timed(
        lambda: combined_operand(x, carry, NB, K, run.prev_pad))
    res["cgemm_ms"] = timed(lambda: cgemm(a, gr, gi))
    res["cgemm_plain_ms"] = timed(lambda: cgemm_plain(a, gr, gi))
    res["fft"] = {}
    for n in (256, 1024, 4096, 384, 1000):
        f = normal(32 * 2 ** 20 // n, n, 2)
        res["fft"][n] = {
            "kernel_ms": timed(lambda: fft_c2c(f)),
            "plain_ms": timed(lambda: fft_c2c_plain(f), reps=1),
            "cufft_ms": timed(
                lambda: torch.fft.fft(torch.view_as_complex(f)), reps=1)}
        del f

    fused = make_fused_chain(taps, NB, device=dev)
    xw = x.reshape(-1, NB, 2)
    uw = correction_operand(x, carry, NB, K, fused.pp)
    res["one_pass_step_ms"] = timed(lambda: fused.run(x, carry))
    res["correction_operand_ms"] = timed(
        lambda: correction_operand(x, carry, NB, K, fused.pp))
    res["fir_fft_fused_ms"] = timed(
        lambda: fir_fft_fused(xw, uw, fused.H, fused.gt))
    res["fir_fft_fused_without_uw_ms"] = timed(
        lambda: fir_fft_fused(xw, None, fused.H, fused.gt))
    gc = correction_spectrum(fused.gt, NB)  # built once, outside the time
    res["fir_fft_fused_plain_ms"] = timed(
        lambda: fir_fft_fused_plain(xw, uw, fused.H, fused.gt, gc), reps=1)
    del xw, uw, gc
    res["split"] = {}
    splits = {}
    for R in (4, 8, 16):
        srun, _ = make_split_step(taps, NB, R, 64, device=dev)
        splits[R] = srun
        sa = split_operand(x, carry, srun.wr, NB, K, 64)
        res["split"][R] = {
            "step_ms": timed(lambda: srun(x, carry)),
            "split_operand_ms": timed(
                lambda: split_operand(x, carry, srun.wr, NB, K, 64)),
            "cgemm_one_stream_ms": timed(
                lambda: cgemm(sa[0], srun.gr[0], srun.gi[0]))}
        del sa

    def trace(step):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            c = carry
            for _ in range(3):
                _, c = step(x, c)
            torch.cuda.synchronize()
        dev_us = {e.key: e.device_time_total for e in prof.key_averages()
                  if e.device_time_total > 0}
        total = sum(dev_us.values())
        return {k: {"us": v, "share": v / total}
                for k, v in sorted(dev_us.items(), key=lambda kv: -kv[1])}

    res["trace_3_steps"] = trace(run)
    res["trace_3_one_pass_steps"] = trace(fused.run)
    res["trace_3_split_steps_R8"] = trace(splits[8])
    torch.cuda.reset_peak_memory_stats()
    run(x, carry)
    torch.cuda.synchronize()
    res["peak_bytes_one_step"] = torch.cuda.max_memory_allocated()

    print(card)
    for key in ("step_ms", "combined_operand_ms", "cgemm_ms",
                "cgemm_plain_ms", "one_pass_step_ms",
                "correction_operand_ms", "fir_fft_fused_ms",
                "fir_fft_fused_without_uw_ms", "fir_fft_fused_plain_ms"):
        print(f"{key}: {res[key]}")
    for n, r in res["fft"].items():
        print(f"fft n={n}: {r}")
    for k, v in list(res["trace_3_steps"].items())[:6]:
        print(f"trace {v['share']:.4f} {v['us']:.0f} us  {k}")
    for k, v in list(res["trace_3_one_pass_steps"].items())[:6]:
        print(f"one-pass trace {v['share']:.4f} {v['us']:.0f} us  {k}")
    for R, r in res["split"].items():
        print(f"split R={R}: {r}")
    for k, v in list(res["trace_3_split_steps_R8"].items())[:6]:
        print(f"split R=8 trace {v['share']:.4f} {v['us']:.0f} us  {k}")
    print(f"peak_bytes_one_step: {res['peak_bytes_one_step']}")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / f"probe_step_{args.tag}.json").write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
