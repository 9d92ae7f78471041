#!/usr/bin/env python3
"""K2 (batched FFT) and P2 (layout moves) on one CUDA card, beside their
plain versions and one library call each.

    python3 benches_torch/probe_fft_layout.py [--tag NAME] [--out DIR]

Run from the root of a checkout: it imports the package of the tree it
sits in, so for an A/B of two trees, unpack the other one (``git
archive``) under ``build/``, copy this file into its ``benches_torch/``
and run old, new, new, old in one call.

- :func:`run`: K2 ``fft_c2c``, its plain version (DFT matmuls) and cuFFT
  (``torch.fft.fft``) at 32 Mi complex samples for n in 256, 1024, 4096,
  384 and 1000. First K2's output against its plain version's
  (``max_rel``, over max |plain|), then CUDA-event times (the median of 5
  calls after a quarter second of warm-up; the plain version: of 2), and
  the kernel's and cuFFT's device time by ``torch.profiler`` (the mean
  over 20 calls of the kernels' own durations, without the host's
  enqueue gaps; null where the profiler lost events or read below the
  bound). The bound is 16 bytes per sample (one read, one write) at
  3.35 TB/s. ``chip_smoke.py`` phase 7 calls it.
- P2 ``layout_move`` A-D at [4096, 1024] beside its plain version, P1
  and ``copy_``: ``probe_layout.run()``.

Prints a summary and one JSON line with the card's name and power
limit, and writes the JSON to ``<out>/probe_fft_layout_<tag>.json``.
Needs a CUDA card; exits non-zero without one.
"""

import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from probe_stream_ceiling import (  # noqa: E402
    bytes_bound_ms, card, device_ms, median_ms)

from pothoscomms_tpu_torch.kernels.fft import (  # noqa: E402
    fft_c2c, fft_c2c_plain)

SAMPLES = 32 * 2 ** 20
SIZES = (256, 1024, 4096, 384, 1000)


def cufft(x):
    """One library call computing K2's function: cuFFT on x [B, n, 2]."""
    return torch.fft.fft(torch.view_as_complex(x))


def run(sizes=SIZES, samples: int = SAMPLES, seed: int = 7) -> dict:
    """{n: {max_rel, ms, plain_ms, library_ms, device_ms,
    library_device_ms, bound_ms}} for K2 at ``samples`` complex samples
    in rows of n, inputs from ``torch.randn`` on the card."""
    if not torch.cuda.is_available():
        raise SystemExit("probe_fft_layout: no CUDA card")
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(seed)
    floor = bytes_bound_ms(samples * 16)
    res = {}
    for n in sizes:
        f = torch.randn((samples // n, n, 2), generator=gen, device=dev)
        got, ref = fft_c2c(f), fft_c2c_plain(f)
        max_rel = ((got - ref).abs().max() / ref.abs().max()).item()
        del got, ref
        res[n] = {
            "max_rel": max_rel,
            "ms": median_ms(lambda: fft_c2c(f)),
            "plain_ms": median_ms(lambda: fft_c2c_plain(f), reps=2),
            "library_ms": median_ms(lambda: cufft(f)),
            "device_ms": device_ms(fft_c2c, [(f,)], per_call=1,
                                   floor_ms=floor),
            "library_device_ms": device_ms(cufft, [(f,)], floor_ms=floor),
            "bound_ms": floor}
        del f
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tag", default="probe")
    ap.add_argument("--out", default="chiprun_out")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("probe_fft_layout: no CUDA card", file=sys.stderr)
        return 1
    import probe_layout

    torch.backends.cuda.matmul.allow_tf32 = False
    res = {"card": card(), "device": torch.cuda.get_device_name(0),
           "torch": torch.__version__, "tag": args.tag, "fft": run(),
           "layout": probe_layout.run()}

    def f4(v):
        return "null" if v is None else f"{v:.4f}"

    print(res["card"])
    for n, r in res["fft"].items():
        print(f"fft n={n}: /max|plain| {r['max_rel']:.3e}; kernel "
              f"{r['ms']:.4f} plain {r['plain_ms']:.3f} cuFFT "
              f"{r['library_ms']:.4f} ms; device time kernel "
              f"{f4(r['device_ms'])} cuFFT {f4(r['library_device_ms'])} "
              f"(bound {r['bound_ms']:.4f})")
    lay = res["layout"]
    print("layout " + ", ".join(
        f"{m} {lay[f'{m}_ms']:.4f} (plain {lay[f'{m}_plain_ms']:.4f}; device "
        f"{f4(lay[f'{m}_device_ms'])}, plain "
        f"{f4(lay[f'{m}_plain_device_ms'])})"
        for m in "ABCD") + f"; copy_ device {f4(lay['copy_device_ms'])}")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / f"probe_fft_layout_{args.tag}.json").write_text(
        json.dumps(res, indent=1))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
