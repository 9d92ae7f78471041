#!/usr/bin/env python3
"""K4, the decimating FIR (``kernels/fir_decim``), on one CUDA card.

    python3 benches_torch/probe_fir_decim.py [--tag NAME] [--out DIR]

(``--out`` defaults to the git-ignored ``build/probes``.)

Needs one CUDA card; run from the root of a checkout. At the decimating
channelizer's step (C = 256, T = 131072, K = 64, D = 2, 1024 bins) it
times, with CUDA events over calls that cycle through 4 inputs of 268 MB
(each call writes a fresh buffer, so neither side reads its last output
from L2), in turns (K4, plain, plain, K4 and so on):

- K4 alone, and its device time from ``torch.profiler``;
- its plain version on the card (``cat``, ``F.conv1d`` with stride 2 and
  TF32 off, the permutes and the carry);
- ``F.conv1d`` alone on the formed operand, TF32 off: the one library
  call that computes the same function;
- the chain's step in the polyphase form (K4, then K2) and in the conv
  form (``fir_fft_step``: the plain version's ops, then K2).

It holds K4 against its plain version (max |d| / max |plain|) and the
carry bit for bit, and prints the compiler's register and shared-memory
report for the kernel and, where ``cuobjdump`` is installed, the count
of FFMA, LDS and MOV instructions in its SASS. The bounds are the
benchmark's: 402.9 MB over 3.35 TB/s and 4.29 G FMAs over 67 TFLOP/s.
It prints a summary and writes everything to
``<out>/probe_fir_decim_<tag>.json``.
"""

import argparse
import json
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

C, T, K, D, NBINS = 256, 131072, 64, 2, 1024
BYTES = C * T * 8 + C * (T // D) * 8 + 2 * C * (K - 1) * 8 + K * 8
FMAS = C * (T // D) * K * 4


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tag", default="probe")
    ap.add_argument("--out", default="build/probes")
    args = ap.parse_args()

    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("probe_fir_decim: no CUDA card", file=sys.stderr)
        return 1
    from probe_stream_ceiling import device_ms, event_ms

    from pothoscomms_tpu_torch.kernels import build
    from pothoscomms_tpu_torch.kernels import fir_decim as k4
    from pothoscomms_tpu_torch.parallel import chain

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    g = torch.Generator(device=dev).manual_seed(0)
    xs = [torch.randn((C, T, 2), generator=g, device=dev) for _ in range(4)]
    carry = torch.randn((C, K - 1, 2), generator=g, device=dev)
    rng = np.random.default_rng(0)
    h = (rng.normal(size=K) + 1j * rng.normal(size=K)) / K
    taps = torch.from_numpy(np.stack([h.real, h.imag], -1).astype(
        np.float32)).to(dev)
    pool = [(x, carry, taps, D) for x in xs]

    y, new = k4.fir_decim(*pool[0])
    y_p, new_p = k4.fir_decim_plain(*pool[0])
    torch.cuda.synchronize()
    res = {"card": card, "torch": torch.__version__,
           "cuda": torch.version.cuda, "shape": [C, T, K, D],
           "plan": list(k4.plan(K, D)),
           "rel_err_vs_plain": float((y - y_p).abs().max()
                                     / y_p.abs().max()),
           "carry_exact": bool(torch.equal(new, new_p)
                               and torch.equal(new, xs[0][:, T - K + 1:])),
           "bound_ms": {"bytes": BYTES / 3.35e9, "fma": 2 * FMAS / 67e9}}
    del y, new, y_p, new_p

    xin = torch.cat([carry, xs[0]], 1).permute(0, 2, 1)
    w = chain.complex_fir_kernel(h).to(dev)
    conv_pool = [(xin,)] * 4
    run, carry0 = chain.fir_fft_chain(h, NBINS, C, T, decim=D, device=dev)
    assert run.form == "polyphase"
    step_pool = [(x, carry0) for x in xs]

    def conv_step(x, c):
        return chain.fir_fft_step(x, c, w, NBINS, D)

    sides = {"k4": (k4.fir_decim, pool),
             "plain": (k4.fir_decim_plain, pool),
             "conv1d": (lambda a: F.conv1d(a, w, stride=D), conv_pool),
             "step_polyphase": (run, step_pool),
             "step_conv": (conv_step, step_pool)}
    ms = {name: [] for name in sides}
    for order in (("k4", "plain", "conv1d", "step_polyphase", "step_conv"),
                  ("step_conv", "step_polyphase", "conv1d", "plain", "k4")) \
            * 2:
        for name in order:
            fn, p = sides[name]
            ms[name].append(event_ms(fn, p, calls=20))
    res["event_ms"] = ms
    res["median_ms"] = {n: statistics.median(v) for n, v in ms.items()}
    res["k4_device_ms"] = device_ms(k4.fir_decim, pool, calls=20,
                                    per_call=1,
                                    floor_ms=0.5 * res["bound_ms"]["bytes"])

    report = []
    for log in sorted(build.BUILD_DIR.glob("libfir_decim-*.log")):
        report += [ln.strip() for ln in log.read_text().splitlines()
                   if "registers" in ln or "spill" in ln
                   or "Compiling entry" in ln]
    res["ptxas"] = report
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    libs = sorted(build.BUILD_DIR.glob("libfir_decim-*.so"))
    if libs and Path(cuobjdump).exists():
        sass = subprocess.run([cuobjdump, "-sass", str(libs[-1])],
                              capture_output=True, text=True).stdout
        by_kernel = {}
        name = None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                name = m.group(1)
                by_kernel[name] = {}
            elif name:
                op = re.search(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)",
                               line)
                if op:
                    base = op.group(1).split(".")[0]
                    by_kernel[name][base] = by_kernel[name].get(base, 0) + 1
        res["sass_ops"] = {
            n: {k: c.get(k, 0) for k in ("FFMA", "LDS", "MOV", "LDG", "STS",
                                         "STG", "BRA", "IMAD", "IADD3")}
            for n, c in by_kernel.items()}
    k4_ms = res["median_ms"]["k4"]
    res["k4_roofline_pct"] = 100 * res["bound_ms"]["bytes"] / k4_ms
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / f"probe_fir_decim_{args.tag}.json").write_text(
        json.dumps(res, indent=1))
    print(json.dumps({k: v for k, v in res.items() if k != "event_ms"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
