"""S1, the frame-sync search (csrc/sync_search.cu), on the card at the
shapes the port's paths launch it at: the link's [256, 32768] (one launch
for the channel batch) and FrameSync's [1, 32768] and [1, 65536] (one
launch a search), sw = w = 80, dw = 4, one preamble symbol.

    python3 benches_torch/probe_sync_search.py [--tag NAME] [--out DIR]

Each shape's input is link data: ``parallel/link.channel_waves`` (4000-bit
frames, noise 0.001, seed 21) zero-padded to the bucket. Each shape is
first held to the float64 oracle (``core/testing.sync_search_f64``,
``search_agreement``) on up to two channels at the bounds of
tests/test_torch_framing.py; then timed by CUDA events (mean of 20 calls)
and on the card (``probe_stream_ceiling.device_ms``), beside its bound:
the larger of the bytes (x read once, four [C, n] float32 outputs) over
3.35 TB/s and ``kernels/sync_search.ops_per_offset`` operations an offset
over 67 TFLOP/s (float32 off the tensor cores), and with the launch's
plan (k offsets a thread, threads a block: ``card_plan``). Writes
``DIR/probe_sync_search_NAME.json`` (DIR defaults to build/probes) and
prints it as one line, with the card's name and power limit. It imports
the package of the tree it sits in, so for an A/B unpack the other tree
(``git archive``) under ``build/``, copy this file into its
``benches_torch/`` and run both in one call; a tree whose package has no
``work`` or ``card_plan`` gets no bound and no plan. Needs a CUDA card; exits non-zero without one.
"""

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from probe_stream_ceiling import card, device_ms, event_ms  # noqa: E402

from pothoscomms_tpu_torch.core.testing import (  # noqa: E402
    search_agreement, sync_search_f64)
from pothoscomms_tpu_torch.kernels import sync_search as ss  # noqa: E402
from pothoscomms_tpu_torch.parallel.link import channel_waves  # noqa: E402

HBM = 3.35e12     # bytes a second, one H100 SXM, published
F32_OPS = 67e12   # float32 operations a second off the tensor cores
SHAPES = {"link": (256, 32768), "frame_sync_32768": (1, 32768),
          "frame_sync_65536": (1, 65536)}
ARGS = (0.01, 80, 80, 4, 1)  # thr, sw, w, dw, npre
TOL = {"scale_rel": 1e-5, "delta_fc_abs": 1e-5, "phase_abs": 2e-3}


def bound(nbytes: float, ops: float):
    """(ms, "bytes" or "operations"): the least time for the work."""
    t_bytes, t_ops = nbytes / HBM * 1e3, ops / F32_OPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def link_input(C: int, L: int, dev, seed: int = 21) -> torch.Tensor:
    """[C, L, 2] float32 on ``dev``: each channel's 4000-bit frame after
    the link's channel schedule (noise 0.001), zero-padded to L."""
    _, waves = channel_waves(C, 4000, seed, 0.001, device="cpu")
    x = np.zeros((C, L, 2), np.float32)
    for c, wv in enumerate(waves):
        m = min(len(wv), L)
        x[c, :m, 0], x[c, :m, 1] = wv[:m].real, wv[:m].imag
    return torch.from_numpy(x).to(dev)


def run() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("probe_sync_search: no CUDA card")
    dev = torch.device("cuda:0")
    pre = torch.tensor([[1.0, 0.0]], device=dev)
    thr, sw, w, dw, npre = ARGS
    res = {"device": torch.cuda.get_device_name(0), "card": card(),
           "shapes": {}}
    # a tree from before the search's work was counted has neither
    count, plan = getattr(ss, "work", None), getattr(ss, "card_plan", None)
    if count:
        res["ops_per_offset"] = ss.ops_per_offset(sw, w, dw, npre)
    for name, (C, L) in SHAPES.items():
        x = link_input(C, L, dev)
        n = L - sw - 58 * dw + 1
        args = (thr, sw, w, dw, npre, n)
        chans = sorted({0, C - 1})
        agree = search_agreement(
            [a[chans].cpu().numpy() for a in ss.sync_search(x, pre, *args)],
            sync_search_f64(x[chans].cpu().numpy(), [1.0], *args))
        held = all(agree[k] <= v for k, v in TOL.items()) \
            and agree["scale_zero_mismatch"] == 0 \
            and agree["peak_mismatch"] == 0
        b_ms, b_by = bound(*count(C, L, n, sw, w, dw, npre)) if count \
            else (0.0, None)
        pool = [(x,)]
        rec = {"shape": [C, L], "n": n, "oracle": agree, "held": held,
               "bound_ms": b_ms if count else None, "bound_by": b_by}
        fn = lambda x_: ss.sync_search(x_, pre, *args)  # noqa: E731
        rec["ms"] = event_ms(fn, pool, calls=20)
        rec["device_ms"] = device_ms(fn, pool, calls=20, per_call=1,
                                     floor_ms=b_ms)
        if plan:
            rec["plan"] = list(plan(C, n, w))
        res["shapes"][name] = rec
        del x
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tag", default="run")
    ap.add_argument("--out", default="build/probes")
    args = ap.parse_args()
    res = run()
    res["tag"] = args.tag
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / f"probe_sync_search_{args.tag}.json").write_text(
        json.dumps(res, indent=1))
    print(json.dumps(res))
    held = all(r["held"] for r in res["shapes"].values())
    return 0 if held else 1


if __name__ == "__main__":
    sys.exit(main())
