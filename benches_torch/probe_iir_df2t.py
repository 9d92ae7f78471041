#!/usr/bin/env python3
"""I1, the DF-II-T IIR recurrence (``kernels/iir_df2t``), on one CUDA card.

    python3 benches_torch/probe_iir_df2t.py [--tag NAME] [--out DIR]
        [--check-only]

(``--out`` defaults to the git-ignored ``build/probes``.) It reports the
time the kernel's library takes to build (all 16 orders and widths), or
to load where it is built.

Needs one CUDA card; run from the root of a checkout. It holds I1 against
its plain version on the card (the blocked state-space form) and against
scipy's float64 ``lfilter``, outputs and states, at the resampler bank's
IIR launch (R = 256 rows of T = 196608 complex samples, the elliptic
order-6 low-pass of ``benchmark/configs/resampler_fir99_3to2_ellip6``), at
[16, 768, 2], at a real [64, 4099] row, at orders 1, 2 and 8 on rows
whose length is no multiple of a tile (Butterworth low-passes at half
Nyquist), and on one and two long rows (cut into segments); every launch
from a nonzero state. The same elliptic design at orders 7 and 8, on
which I1's algorithm strays (``iir_df2t.stray``): the wrapper must refuse
the taps, and ``compile_chain`` run the blocked form, complex and real,
within 3e-5 of ``lfilter``; and a real float32 ``compile_chain`` at order
6, which must launch I1.
Then, unless ``--check-only``, at the cell's launch it times with CUDA
events, over calls that cycle through 4 inputs of 403 MB (each call
writes a fresh buffer), I1 and its device time from ``torch.profiler``,
the plain version, and one ``clone`` of the input (a read and a write of
the same bytes: the copy roof). The bound is 805 MB over 3.35 TB/s. It
prints a summary and writes everything to
``<out>/probe_iir_df2t_<tag>.json``.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

R, T, ORDER = 256, 131072 * 3 // 2, 6
BYTES = 2 * R * T * 8 + 2 * R * ORDER * 8 + 2 * (ORDER + 1) * 4
HBM = 3.35e12


def ellip(order, always=False):
    """The cell's elliptic low-pass at order 6 (0.1 dB, 60 dB, 0.3 of
    Nyquist), normalised, and at any order with ``always``; else a
    Butterworth low-pass at half Nyquist (the elliptic designs of order 7
    and 8 are refused by I1)."""
    import numpy as np
    import scipy.signal

    if order != 6 and not always:
        return scipy.signal.butter(order, 0.5)
    b, a = scipy.signal.ellip(order, 0.1, 60, 0.3)
    return np.asarray(b / a[0]), np.asarray(a / a[0])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tag", default="probe")
    ap.add_argument("--out", default="build/probes")
    ap.add_argument("--check-only", action="store_true")
    args = ap.parse_args()

    import numpy as np
    import scipy.signal
    import torch

    if not torch.cuda.is_available():
        print("probe_iir_df2t: no CUDA card", file=sys.stderr)
        return 1
    from probe_stream_ceiling import device_ms, event_ms

    from pothoscomms_tpu_torch.kernels import build
    from pothoscomms_tpu_torch.kernels import iir_df2t as i1

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    out = {"card": card, "torch": torch.__version__,
           "cuda": torch.version.cuda, "shape": [R, T, 2], "order": ORDER,
           "bound_ms": BYTES / HBM * 1e3}
    print(card, torch.__version__, torch.version.cuda)
    t0 = time.perf_counter()
    i1._entry()
    out["load_s"] = time.perf_counter() - t0
    print(f"[build] iir_df2t.cu (16 kernels) built or loaded in "
          f"{out['load_s']:.2f} s")
    for log in sorted(build.BUILD_DIR.glob("libiir_df2t-*.log")):
        lines = [ln.strip() for ln in log.read_text().splitlines()
                 if "registers" in ln or "spill" in ln or "error" in ln]
        out.setdefault("ptxas", []).extend(lines)
        for ln in lines:
            if "registers" in ln:
                print("   ", ln)
    g = torch.Generator(device=dev).manual_seed(0)

    def held(r, t, w, order, rows=(0,), taps=None):
        """I1 against the plain version and scipy at [r, t, w], order."""
        b, a = taps if taps is not None else ellip(order)
        x = torch.randn((r, t, w), generator=g, device=dev)
        z = 0.1 * torch.randn((order, r, w), generator=g, device=dev)
        y, zo = i1.iir_df2t(x, z, b, a)
        yp, zp = i1.iir_df2t_plain(x, z, b, a)
        torch.cuda.synchronize()
        scale = yp.abs().max().item()
        rec = {"shape": [r, t, w], "order": order,
               "vs_plain": (y - yp).abs().max().item() / scale,
               "state_vs_plain": (zo - zp).abs().max().item()
               / zp.abs().max().item()}
        xo, zi = x.double().cpu().numpy(), z.double().cpu().numpy()
        yo, zz = y.double().cpu().numpy(), zo.double().cpu().numpy()
        e, es = 0.0, 0.0
        for row in rows:
            for p in range(w):
                ye, ze = scipy.signal.lfilter(b, a, xo[row, :, p],
                                              zi=zi[:, row, p])
                e = max(e, np.abs(yo[row, :, p] - ye).max()
                        / np.abs(ye).max())
                es = max(es, np.abs(zz[:, row, p] - ze).max()
                         / np.abs(ze).max())
        rec["vs_lfilter"], rec["state_vs_lfilter"] = e, es
        rec["finite"] = bool(torch.isfinite(y).all())
        print(f"[check] {rec}")
        return rec

    def chained(order, dtype):
        """The elliptic design at ``order`` through compile_chain on the
        card: whether it launched I1, whether I1's wrapper refuses the
        taps, and the output against lfilter."""
        import pothoscomms_tpu_torch as pkg
        from pothoscomms_tpu_torch.parallel.compiler import compile_chain

        b, a = ellip(order, always=True)
        blk = pkg.BlockRegistry.make("/comms/iir_filter", dtype)
        blk.set_taps(np.concatenate([b, a]))
        step, carry = compile_chain([blk], 4, device=dev)
        cplx = dtype.startswith("complex")
        x = torch.randn((4, 8192, 2) if cplx else (4, 8192), generator=g,
                        device=dev)
        before = i1.iir_df2t.launches
        y, _ = step(x, carry)
        torch.cuda.synchronize()
        try:
            i1.iir_df2t(x[..., None] if not cplx else x,
                        torch.zeros((order, 4, 2 if cplx else 1),
                                    device=dev), b, a)
            refused = False
        except ValueError:
            refused = True
        xo, yo = x.double().cpu().numpy(), y.double().cpu().numpy()
        if cplx:
            xo, yo = xo[..., 0] + 1j * xo[..., 1], yo[..., 0] + 1j * yo[..., 1]
        ye = scipy.signal.lfilter(b, a, xo, axis=1)
        rec = {"order": order, "dtype": dtype, "stray": i1.stray(b, a),
               "i1": i1.iir_df2t.launches > before, "refused": refused,
               "vs_lfilter": float(np.abs(yo - ye).max()
                                   / np.abs(ye).max())}
        print(f"[chain] {rec}")
        return rec

    checks = [held(R, T, 2, ORDER, rows=(0, R - 1)),
              held(16, 768, 2, ORDER, rows=(0, 15)),
              held(64, 4099, 1, ORDER, rows=(0, 63)),
              held(8, 4096 * 2 + 37, 2, 1, rows=(0, 7)),
              held(8, 4096 + 1, 2, 2, rows=(0, 7), taps=(
                  np.array([0.0676, 0.135, 0.0676]),
                  np.array([1.0, -1.142, 0.412]))),
              held(8, 3 * 4096 - 5, 2, 8, rows=(0, 7)),
              held(3, 1, 2, ORDER, rows=(0, 2)),
              held(3, 4097, 1, ORDER, rows=(0, 2)),
              held(1, (1 << 22) + 256, 2, ORDER, rows=(0,)),
              held(2, 3 * 4096 * 40 + 32, 1, ORDER, rows=(0, 1))]
    out["checks"] = checks
    out["chains"] = chains = [chained(order, dtype) for order in (6, 7, 8)
                              for dtype in ("complex_float32", "float32")]
    ok = all(c["finite"] and c["vs_plain"] < 3e-5 and c["vs_lfilter"] < 3e-5
             and c["state_vs_lfilter"] < 1e-4 for c in checks) and all(
        c["vs_lfilter"] < 3e-5 and c["i1"] == (c["order"] == 6)
        and c["refused"] == (c["order"] != 6) for c in chains)
    out["checks_ok"] = ok
    print(f"[check] all within 3e-5 of the plain version and lfilter, "
          f"I1 refusing orders 7 and 8: {ok}")
    if args.check_only or not ok:
        return finish(out, args, 0 if ok else 1)

    b, a = ellip(ORDER)
    xs = [torch.randn((R, T, 2), generator=g, device=dev) for _ in range(4)]
    z = 0.1 * torch.randn((ORDER, R, 2), generator=g, device=dev)
    pool = [(x, z, b, a) for x in xs]
    bound = out["bound_ms"]
    t = {"i1_ms": event_ms(i1.iir_df2t, pool, calls=20),
         "i1_device_ms": device_ms(i1.iir_df2t, pool, per_call=1,
                                   floor_ms=bound),
         "clone_ms": event_ms(lambda x, *_: x.clone(), pool, calls=20),
         "plain_ms": event_ms(i1.iir_df2t_plain, pool, calls=4)}
    t["i1_ms_again"] = event_ms(i1.iir_df2t, pool, calls=20)
    out.update(t)
    print(f"[time] {card}: I1 {t['i1_ms']:.4f} / {t['i1_ms_again']:.4f} ms "
          f"by events ({t['i1_device_ms']} on the card), bound "
          f"{bound:.4f} ms ({bound / t['i1_ms']:.1%}); clone "
          f"{t['clone_ms']:.4f} ms; plain version {t['plain_ms']:.3f} ms")

    return finish(out, args, 0)


def finish(out, args, rc):
    path = Path(args.out)
    path.mkdir(parents=True, exist_ok=True)
    (path / f"probe_iir_df2t_{args.tag}.json").write_text(
        json.dumps(out, indent=1))
    return rc


if __name__ == "__main__":
    sys.exit(main())
