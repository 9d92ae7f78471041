#!/usr/bin/env python3
"""Where a benchmark cell's set-up goes: the harness's pieces beside the
program's build record.

    python3 benches_torch/probe_setup.py --workload <cell> --seed <n> \\
        [--out DIR] [--cost] [--cpu]

Runs the cell's set-up as ``benchmark/run.py`` does (imports, the card,
the driver's ``setup``: inputs, build, first step, warm-up), then writes
``DIR/probe_setup_<cell>.json`` (DIR defaults to build/probes) and prints
one line: the seconds of each piece, ``setup_s``, the program's build
record (``parallel/profiling.build_record()``: each ``pc.build.*`` name's
first builds and rebuilds, with their host seconds, and the libraries
compiled in the process) and the two readings ``setup.kernels_s`` and
``setup.build_s``. With ``--cost`` it also times the record itself: the
host microseconds of a build entry (first and again) and the
nanoseconds a launch pays for the first-launch test. ``--cpu`` runs on
the CPU (no card needed; for trying the probe at a benchmark copy's
tiny sizes).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import timeit  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark import harness  # noqa: E402
from pothoscomms_tpu_torch.parallel import profiling  # noqa: E402

T_IMPORTS = time.perf_counter()
KERNELS = ("pc.build.library.", "pc.build.first_launch.")


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        return "not read"


def cost() -> dict:
    """The record's own cost on this host: a build entry's microseconds
    (a new key each time, and one key again and again) and the
    nanoseconds of the first-launch test a warm launch pays (the counter
    read and compared, beside an empty loop)."""
    n = 20000
    keys = iter(range(10 ** 9))

    def fresh():
        with profiling.build("pc.build.probe.fresh", key=next(keys)):
            pass

    def again():
        with profiling.build("pc.build.probe.again"):
            pass

    def launch():
        pass

    launch.launches = 1
    launching = profiling.launching
    g = {"launch": launch, "launching": launching}
    test = timeit.timeit(
        "if not launch.launches and launch not in launching: pass",
        number=10 ** 7, globals=g)
    empty = timeit.timeit("pass", number=10 ** 7)
    return {"entry_first_us": timeit.timeit(fresh, number=n) / n * 1e6,
            "entry_again_us": timeit.timeit(again, number=n) / n * 1e6,
            "launch_test_ns": (test - empty) / 10 ** 7 * 1e9}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--out", default=str(ROOT / "build" / "probes"))
    ap.add_argument("--cost", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--root", default=str(ROOT),
                    help="the checkout whose benchmark files to run")
    args = ap.parse_args()
    root = Path(args.root)
    cell = harness.Cell(harness.load_json(root / "BENCHMARK.json"),
                        args.workload, root)
    dev = torch.device("cpu") if args.cpu else harness.find_card(cell.chips)
    t_card = time.perf_counter()
    ctx = harness.Context(cell, args.seed, dev, T_START)
    state = cell.driver.setup(ctx)
    harness.sync(dev)
    setup_s = time.perf_counter() - T_START
    marks = state.marks
    pieces = {"imports": T_IMPORTS - T_START, "card": t_card - T_IMPORTS,
              "before": marks[0][1] - T_START}
    pieces.update({name: t - t0 for (_, t0), (name, t)
                   in zip(marks, marks[1:])})
    record = profiling.build_record()
    builds = record["builds"]
    firsts = {n: r["first_s"] for n, r in builds.items()
              if n.startswith("pc.build.")}
    out = {"workload": args.workload, "seed": args.seed,
           "device": torch.cuda.get_device_name(0) if dev.type == "cuda"
           else "cpu", "card": card() if dev.type == "cuda" else "cpu",
           "setup_s": setup_s, "pieces": pieces,
           "setup.kernels_s": sum(s for n, s in firsts.items()
                                  if n.startswith(KERNELS)),
           "setup.build_s": sum(s for n, s in firsts.items()
                                if not n.startswith(KERNELS)),
           "rebuild_s": sum(r["again_s"] for r in builds.values()),
           "builds": builds, "compiled": record["compiled"]}
    if args.cost:
        out["cost"] = cost()
    path = Path(args.out)
    path.mkdir(parents=True, exist_ok=True)
    (path / f"probe_setup_{args.workload}.json").write_text(
        json.dumps(out, indent=1))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
