"""The link's receive entry (``parallel/link.make_link_receiver``) held
steady on the card: one receiver at 256 channels x 32768 samples, called
again and again for ``--seconds`` on the same window batch, with the
process's resident memory, threads, the card's allocated memory and the
live ``Topology`` objects read every ``--every`` calls.

    python3 benches_torch/probe_link_receiver.py [--seconds 30] \\
        [--every 10] [--tag NAME] [--out DIR]

The batch is ``parallel/link.channel_waves`` (4000-bit frames, noise
0.001, seed 21, run_sharded_link's channel schedule) zero-padded to the
window. Each call's payloads are held to the transmitted bits. Writes
``DIR/probe_link_receiver_NAME.json`` (DIR defaults to build/probes) and
prints its summary as one line with the card's name and power limit: the
calls, the seconds a call (first, median, last), the receiver's counters
gained, and the readings at the first and last sample. Needs a CUDA
card; exits non-zero without one.
"""

import argparse
import gc
import json
import sys
import threading
import time
import warnings
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from probe_stream_ceiling import card  # noqa: E402

from pothoscomms_tpu_torch.core.topology import Topology  # noqa: E402
from pothoscomms_tpu_torch.parallel import link  # noqa: E402

C, WINDOW, BITS = 256, 32768, 4000
COUNTERS = ("search_s", "decode_s", "d2h_bytes", "frames", "frames_found",
            "header_rejects")


def rss_mb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024
    return float("nan")


def topologies() -> int:
    gc.collect()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return sum(isinstance(o, Topology) for o in gc.get_objects())


def reading(calls: int, t0: float) -> dict:
    return {"calls": calls, "t_s": time.perf_counter() - t0,
            "rss_mb": rss_mb(), "threads": threading.active_count(),
            "cuda_allocated": torch.cuda.memory_allocated(),
            "topologies": topologies()}


def run(seconds: float, every: int) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("probe_link_receiver: no CUDA card")
    dev = torch.device("cuda:0")
    tx_bits, waves = link.channel_waves(C, BITS, 21, 0.001, device="cpu")
    x = np.zeros((C, WINDOW, 2), np.float32)
    for c, wv in enumerate(waves):
        x[c, :len(wv), 0], x[c, :len(wv), 1] = wv.real, wv.imag
    xd = torch.from_numpy(x).to(dev)
    lengths = np.full(C, WINDOW)
    receive = link.make_link_receiver(C, WINDOW, BITS, device=dev)
    receive(xd, lengths)  # builds S1 and the native LFSR
    before = {k: getattr(link, k) for k in COUNTERS}
    t0 = time.perf_counter()
    readings, times, exact = [reading(0, t0)], [], True
    calls = 0
    while time.perf_counter() - t0 < seconds:
        t = time.perf_counter()
        got = receive(xd, lengths)
        times.append(time.perf_counter() - t)
        exact &= bool(got.found.all()) and all(
            np.array_equal(got.bits[c], tx_bits[c]) for c in range(C))
        calls += 1
        if calls % every == 0:
            readings.append(reading(calls, t0))
    readings.append(reading(calls, t0))
    gained = {k: getattr(link, k) - before[k] for k in COUNTERS}
    first, last = readings[0], readings[-1]
    return {"device": torch.cuda.get_device_name(0), "card": card(),
            "calls": calls, "seconds": time.perf_counter() - t0,
            "all_exact": exact,
            "call_s": {"first": times[0], "median": float(np.median(times)),
                       "last": times[-1], "max": max(times)},
            "counters": gained,
            "growth": {k: last[k] - first[k] for k in
                       ("rss_mb", "threads", "cuda_allocated",
                        "topologies")},
            "readings": readings}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--every", type=int, default=10)
    ap.add_argument("--tag", default="run")
    ap.add_argument("--out", default="build/probes")
    args = ap.parse_args()
    res = run(args.seconds, args.every)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / f"probe_link_receiver_{args.tag}.json").write_text(
        json.dumps(res, indent=1))
    print(json.dumps({k: v for k, v in res.items() if k != "readings"}),
          flush=True)


if __name__ == "__main__":
    main()
