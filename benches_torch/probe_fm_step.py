#!/usr/bin/env python3
"""Where a step of the FM receive chain spends its time on one CUDA card.

    python3 benches_torch/probe_fm_step.py [--tag NAME] [--out DIR]
        [--envelope-blocks 1024,2048,8192]

(``--out`` defaults to the git-ignored ``build/probes``.)

Needs one CUDA card; run from the root of a checkout. The chain is
``compile_chain([freq_demod, dc_removal(64, 2), envelope(10, 40)], 256)``
(BASELINE config #4, as chip_smoke.py phase 14 drives it) at T = 131072
and T = 16384 (both blocked at ``blocks.filter.ENVELOPE_BLOCK``). For each T it times, with
CUDA events (3 repetitions, each the median of 10 calls after a quarter
second of warm-up):

- one chain step (the discriminator and DC removal as one F1 launch,
  ``kernels/fm_demod_dc``, where the pairing rule takes them);
- F1 alone on the chain's input and carries, beside its plain version
  (the two single cores' torch ops), in turns (F1, plain, plain, F1),
  and F1's device time from ``torch.profiler``;
- the plain version with the DC removal's prefix sums in float32, the
  JAX package's formulation, in turns with the float64 one (float64,
  float32, float32, float64): what the port's accuracy repair costs
  there;
- each block's single core alone on the input the chain gives it;
- only with ``--envelope-blocks``, the measurement that chose
  ``ENVELOPE_BLOCK``: the step and the envelope block's core with that
  constant set to each length given, in turns (up the list, then down),
  beside E1's launch shape (L, Wr, rows).

Then it traces three steps with ``torch.profiler`` (device time per
kernel name, and the kernels' share of the traced wall time: the
device's busy share, kernels assumed not to overlap) and reads the peak
device memory of one step. It prints a summary and writes everything to
``<out>/probe_fm_step_<tag>.json``.
"""

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tag", default="probe")
    ap.add_argument("--out", default="build/probes")
    ap.add_argument("--envelope-blocks", default="",
                    help="comma-separated envelope block lengths to time "
                         "the step at (default: none)")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("probe_fm_step: no CUDA card", file=sys.stderr)
        return 1
    from pothoscomms_tpu_torch import BlockRegistry
    from pothoscomms_tpu_torch.blocks import filter as bfilter
    from pothoscomms_tpu_torch.kernels.fm_demod_dc import (fm_demod_dc,
                                                           fm_demod_dc_plain)
    from pothoscomms_tpu_torch.ops import filter as fops
    from pothoscomms_tpu_torch.parallel.compiler import compile_chain

    dev = torch.device("cuda:0")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()

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

    def window_sum_f32(ext, depth, dim):
        """The JAX package's rolling sums: float32 prefix sums."""
        csum = torch.cumsum(ext, dim=dim)
        n = ext.shape[dim] - depth
        return csum.narrow(dim, depth, n) - csum.narrow(dim, 0, n)

    @contextlib.contextmanager
    def f32_prefix_sums():
        saved = fops.window_sum
        fops.window_sum = window_sum_f32
        try:
            yield
        finally:
            fops.window_sum = saved

    def fm_blocks():
        demod = BlockRegistry.make("/comms/freq_demod", "complex_float32")
        dcr = BlockRegistry.make("/comms/dc_removal", "float32")
        dcr.set_average_size(64)
        dcr.set_cascade_size(2)
        env = BlockRegistry.make("/comms/envelope_detector", "float32")
        env.set_attack(10.0)
        env.set_release(40.0)
        return [demod, dcr, env]

    C = 256
    sweep = [int(v) for v in args.envelope_blocks.split(",") if v]
    res = {"card": card, "torch": torch.__version__,
           "cuda": torch.version.cuda, "channels": C, "by_T": {}}
    g = torch.Generator(device=dev).manual_seed(0)
    for T in (131072, 16384):
        inc = torch.rand((C, T), generator=g, device=dev,
                         dtype=torch.float64) - 0.25
        phase = torch.cumsum(inc, dim=1)
        x = torch.stack([torch.cos(phase), torch.sin(phase)], -1).float()
        del inc, phase
        blocks = fm_blocks()
        step, carry = compile_chain(blocks, C, device=dev)
        cores = [b.device_core(C, device=dev) for b in blocks]
        r = {}
        r["step_ms"] = timed(lambda: step(x, carry))
        pair = (x, carry[0], carry[1], 64, 2)
        f1_ab = {"F1": [], "plain": []}
        for which in ("F1", "plain", "plain", "F1"):
            fn = fm_demod_dc if which == "F1" else fm_demod_dc_plain
            f1_ab[which] += timed(lambda: fn(*pair), reps=1)
        r["pair_ab_ms"] = f1_ab
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fm_demod_dc(*pair)
            torch.cuda.synchronize()
        r["f1_device_ms"] = sum(
            e.device_time_total for e in prof.key_averages()
            if "fm_demod_dc" in e.key) / 10 / 1e3
        r["f1_bound_ms"] = C * T * 12 / 3.35e9
        ab = {"float64": [], "float32": []}
        for which in ("float64", "float32", "float32", "float64"):
            ctx = f32_prefix_sums() if which == "float32" \
                else contextlib.nullcontext()
            with ctx:
                ab[which] += timed(lambda: fm_demod_dc_plain(*pair), reps=1)
        r["plain_prefix_sums_ab_ms"] = ab
        xin = x
        r["cores_ms"] = {}
        for blk, (c0, core) in zip(blocks, cores):
            r["cores_ms"][type(blk).__name__] = timed(
                lambda: core(c0, xin), reps=1)
            mag = xin            # what the envelope's core was given
            _, xin = core(c0, xin)
        # the envelope block length: the step and E1's share at each
        default_blk = bfilter.ENVELOPE_BLOCK
        W = fops.envelope_warmup(10.0, 40.0)
        by_blk = {}
        for blk_len in sweep + sweep[::-1]:
            bfilter.ENVELOPE_BLOCK = blk_len
            try:
                blocks_b = fm_blocks()
                step_b, carry_b = compile_chain(blocks_b, C, device=dev)
                c0, env_core = blocks_b[2].device_core(C, device=dev)
                blocked = T % blk_len == 0 and T >= 4 * blk_len \
                    and W <= 2 * blk_len
                e = by_blk.setdefault(blk_len, {
                    "L": blk_len if blocked else T,
                    "Wr": -(-W // blk_len) * blk_len if blocked else 0,
                    "rows": C * (T // blk_len if blocked else 1),
                    "step_ms": [], "envelope_core_ms": []})
                e["step_ms"] += timed(lambda: step_b(x, carry_b), reps=1)
                e["envelope_core_ms"] += timed(lambda: env_core(c0, mag),
                                               reps=1)
            finally:
                bfilter.ENVELOPE_BLOCK = default_blk
        r["by_envelope_block"] = by_blk
        r["envelope_block"] = default_blk
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            c = carry
            for _ in range(3):
                _, c = step(x, c)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        dev_us = {e.key: e.device_time_total for e in prof.key_averages()
                  if e.device_time_total > 0}
        total = sum(dev_us.values())
        r["trace_3_steps"] = {
            k: {"us": v, "share": v / total}
            for k, v in sorted(dev_us.items(), key=lambda kv: -kv[1])}
        r["trace_wall_us"] = wall_us
        r["device_busy_share"] = total / wall_us
        torch.cuda.reset_peak_memory_stats()
        step(x, carry)
        torch.cuda.synchronize()
        r["peak_bytes_one_step"] = torch.cuda.max_memory_allocated()
        res["by_T"][T] = r
        del x, xin, mag, carry, c, cores

    print(card)
    for T, r in res["by_T"].items():
        print(f"T={T} step_ms {r['step_ms']}, F1 / plain pair "
              f"{r['pair_ab_ms']}, F1 on the card {r['f1_device_ms']:.4f} "
              f"ms (bound {r['f1_bound_ms']:.4f}), plain prefix sums A/B "
              f"{r['plain_prefix_sums_ab_ms']}, cores {r['cores_ms']}, device "
              f"busy {r['device_busy_share']:.3f} of {r['trace_wall_us']:.0f}"
              f" us, peak {r['peak_bytes_one_step']} B")
        for blk_len, e in r["by_envelope_block"].items():
            print(f"  envelope block {blk_len} (L={e['L']} Wr={e['Wr']} rows="
                  f"{e['rows']}): step_ms {e['step_ms']}, envelope core "
                  f"{e['envelope_core_ms']}")
        for k, v in list(r["trace_3_steps"].items())[:8]:
            print(f"  trace {v['share']:.4f} {v['us']:.0f} us  {k[:90]}")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / f"probe_fm_step_{args.tag}.json").write_text(
        json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
