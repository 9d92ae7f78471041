"""Where S1's time goes, and what its launch plan buys: csrc/sync_search.cu
built as it is and with one part of its work taken out at a time, each
timed on the card at the link's launch [256, 32768], and as it is at every
plan at the port's three launch shapes (sw = w = 80, dw = 4, one preamble
symbol).

    python3 benches_torch/probe_sync_search_parts.py [--tag NAME] [--out DIR]

The variants, each a copy of the source edited as named, built with the
port's nvcc flags into build/probe_sync_search_parts/ (one nvcc each, all
started together): ``base`` (as it is); ``no_correlation`` (the Horner
blocks skipped); ``no_K`` (K's sum over no terms); ``no_windows`` (both
window sums over no terms); ``fast_math`` (built with -use_fast_math: the
divisions, atan2f and sincosf approximate); ``one_store`` (the four outputs
summed into one store). Each copy gets an entry of its own,
``probe_sync_search_at``, that launches the kernel at the plan it is given
(k = 1, 2 or 4 offsets a thread, 64 to 256 threads a block; the source's
launch bound raised to 256 threads, the same 128 registers a thread). A
part's cost is base's time less the variant's; the variants' outputs are
wrong by design and are not checked.

Times: CUDA events (the mean of 20 launches, two rounds) for each variant
at the link's shape, at the plan ``card_plan`` reads there and at
k = 4, 256 threads; and for ``base`` at each of the nine plans at each
shape of probe_sync_search.py, on the card (``device_ms``, the mean of 20
launches) and by events. Writes ``DIR/probe_sync_search_parts_NAME.json``
(DIR defaults to build/probes) and prints it as one line, with the card's
name and power limit. Needs nvcc and a CUDA card.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "benches_torch"))

from probe_stream_ceiling import card, device_ms  # noqa: E402
from probe_sync_search import ARGS, SHAPES, bound, link_input  # noqa: E402

from pothoscomms_tpu_torch.kernels import build  # noqa: E402
from pothoscomms_tpu_torch.kernels.sync_search import (  # noqa: E402
    card_plan, work)

OUT = ROOT / "build" / "probe_sync_search_parts"
PLANS = [(k, t) for k in (1, 2, 4) for t in (64, 128, 256)]

# appended to each copy of the source: a launch at a plan the caller names
ENTRY = """
extern "C" int probe_sync_search_at(const void* x, const void* pre,
                                    void* out, long long C, long long L,
                                    long long n, long long sw, long long w,
                                    long long dw, long long npre, float thr,
                                    int k, int threads, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (threads < 32 || threads > 256 || threads % 32 || (w / 2) % k)
    return (int)cudaErrorInvalidValue;
  switch (k) {
    case 1: return launch<1>(x, pre, out, C, L, n, sw, w, dw, npre, thr,
                             threads, st);
    case 2: return launch<2>(x, pre, out, C, L, n, sw, w, dw, npre, thr,
                             threads, st);
    case 4: return launch<4>(x, pre, out, C, L, n, sw, w, dw, npre, thr,
                             threads, st);
  }
  return (int)cudaErrorInvalidValue;
}
"""


def edit(text, pairs):
    for a, b in pairs:
        if a not in text:
            raise SystemExit(f"probe_sync_search_parts: {a!r} is not in the "
                             f"source")
        text = text.replace(a, b)
    return text


def variants(src: str) -> dict:
    """name: (source text, extra nvcc flags)."""
    src = edit(src, [("__launch_bounds__(kThreads, 4)",
                      "__launch_bounds__(256, 2)")]) + ENTRY
    return {
        "base": (src, []),
        "no_correlation": (edit(src, [(
            "for (int s = npre - 1; s >= 0; --s) {",
            "for (int s = npre - 1; s >= 0 && thr < -1e30f; --s) {")]), []),
        "no_K": (edit(src, [("slide<K>(klo, klo + half - 2 * dw, S,",
                             "slide<K>(klo, klo, S,")]), []),
        "no_windows": (edit(src, [
            ("slide<K>(dw, half, S, A,", "slide<K>(dw, dw, S, A,"),
            ("slide<K>(sw - half, sw - dw, S, A,",
             "slide<K>(sw - half, sw - half, S, A,")]), []),
        "fast_math": (src, ["-use_fast_math"]),
        "one_store": (edit(src, [
            ("      out[o] = scale[q];\n",
             "      out[o] = scale[q] + dfc[q] - atan2f(li, lr) + "
             "(scale[q] != 0.f ? floorf(mag) : 0.f);\n"),
            ("      out[plane + o] = dfc[q];\n", ""),
            ("      out[2 * plane + o] = -atan2f(li, lr);\n", ""),
            ("      out[3 * plane + o] = scale[q] != 0.f ? floorf(mag) : "
             "0.f;\n", "")]), []),
    }


def compile_variant(item):
    name, (text, extra) = item
    cu, so = OUT / f"{name}.cu", OUT / f"lib{name}.so"
    cu.write_text(text)
    proc = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, *extra,
                           "-o", str(so), str(cu)], capture_output=True,
                          text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed on {name}:\n{proc.stderr[-3000:]}")
    return name, ctypes.CDLL(str(so))


def entry(lib):
    fn = lib.probe_sync_search_at
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 7 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def run() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("probe_sync_search_parts: no CUDA card")
    OUT.mkdir(parents=True, exist_ok=True)
    src = (ROOT / "pothoscomms_tpu_torch" / "csrc" /
           "sync_search.cu").read_text()
    vs = variants(src)
    with ThreadPoolExecutor(len(vs)) as pool:
        libs = dict(pool.map(compile_variant, vs.items()))
    dev = torch.device("cuda:0")
    pre = torch.tensor([[1.0, 0.0]], device=dev)
    thr, sw, w, dw, npre = ARGS

    def launcher(lib, x, k, threads):
        fn = entry(lib)
        C, L = x.shape[0], x.shape[1]
        n = L - sw - 58 * dw + 1

        def call(x_):
            out = torch.empty((4, C, n), device=dev)
            err = fn(x_.data_ptr(), pre.data_ptr(), out.data_ptr(), C, L, n,
                     sw, w, dw, npre, thr, k, threads,
                     torch.cuda.current_stream().cuda_stream)
            build.check(err, "probe_sync_search_at")
            return out
        return call

    def event_mean(call, x):
        for _ in range(5):
            call(x)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            call(x)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 20

    res = {"device": torch.cuda.get_device_name(0), "card": card(),
           "ms": {}, "plans": {}}
    C, L = SHAPES["link"]
    x = link_input(C, L, dev)
    n = L - sw - 58 * dw + 1
    link_plans = [card_plan(C, n, w), (4, 256)]
    res["link"] = {"shape": [C, L], "n": n, "plan": link_plans[0]}
    for _ in range(2):
        for name, lib in libs.items():
            for k, threads in link_plans:
                res["ms"].setdefault(f"{name} k{k} t{threads}", []).append(
                    event_mean(launcher(lib, x, k, threads), x))
    del x
    for shape, (C, L) in SHAPES.items():
        x = link_input(C, L, dev)
        n = L - sw - 58 * dw + 1
        b_ms, b_by = bound(*work(C, L, n, sw, w, dw, npre))
        rec = {"shape": [C, L], "n": n, "plan": card_plan(C, n, w),
               "bound_ms": b_ms, "bound_by": b_by, "by_plan": {}}
        for k, threads in PLANS:
            call = launcher(libs["base"], x, k, threads)
            rec["by_plan"][f"k{k}_t{threads}"] = {
                "ms": event_mean(call, x),
                "device_ms": device_ms(call, [(x,)], calls=20, per_call=1,
                                       floor_ms=b_ms)}
        res["plans"][shape] = rec
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
    (out / f"probe_sync_search_parts_{args.tag}.json").write_text(
        json.dumps(res, indent=1))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
