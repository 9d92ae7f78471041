#!/usr/bin/env python3
"""The readings a cell's limits are set from, on the card at the cell's
own size (not run by the benchmark's runs):

    python3 benchmark/control.py --workload <cell> --seeds <a,b,...> \\
        [--control-seeds <a,b,c>] [--seconds 2] [--steps 2]

For each of ``--seeds`` it builds the program as a run does, runs a short
window of ``--seconds`` and prints the numbers the check compares (the
program's readings). For each of ``--control-seeds`` it puts the control,
the reference in the nearest precision below the configuration's, in the
program's place for ``--steps`` steps of the cell's inputs and prints the
same numbers (the control's readings). All in one process; the last line
of standard output is a JSON summary: for each number, the largest
program reading and the smallest control reading.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402


def main(argv=None, root: Path = ROOT, require_card: bool = True,
         device=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--steps", type=int, default=2)
    args = ap.parse_args(argv)
    ints = (lambda s: [int(v) for v in s.split(",") if v])
    cell = harness.Cell(harness.load_json(Path(root) / "BENCHMARK.json"),
                        args.workload, root)
    import torch

    if require_card:
        device = harness.find_card(cell.chips)
        print(f"control: {cell.name} on {torch.cuda.get_device_name(0)}; "
              f"nvidia-smi: {harness.power_limit()}", flush=True)
    else:
        device = torch.device("cpu") if device is None else device
    program, control = {}, {}
    for seed in ints(args.seeds):
        ctx = harness.Context(cell, seed, device, time.perf_counter())
        st = cell.driver.setup(ctx)
        cell.driver.measure(st, args.seconds, False)
        checks, attempted, failed = cell.driver.check(st)
        del st
        vals = {k: v for k, (v, _) in checks.items()}
        print(json.dumps({"seed": seed, "side": "program", "steps": attempted,
                          "failed": failed, **vals}), flush=True)
        for k, v in vals.items():
            program.setdefault(k, []).append(v)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    for seed in ints(args.control_seeds):
        ctx = harness.Context(cell, seed, device, time.perf_counter())
        for vals in cell.driver.control(ctx, args.steps):
            print(json.dumps({"seed": seed, "side": "control", **vals}),
                  flush=True)
            for k, v in vals.items():
                control.setdefault(k, []).append(v)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    summary = {"workload": cell.name,
               "program_max": {k: max(v) for k, v in program.items()},
               "control_min": {k: min(v) for k, v in control.items()},
               "seconds": time.perf_counter() - T_START}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
