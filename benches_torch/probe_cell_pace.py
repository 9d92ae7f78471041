"""A benchmark cell run again and again in a row, each run a child
process, with what each run cost its host: page faults, peak resident
memory and CPU time (``os.wait4``'s rusage), beside the run's end-to-end
metrics. It tells a cell whose pace drifts from run to run apart from one
whose runs merely scatter, and shows whether the drift follows the host's
cost (faults and system time a step).

    python3 benches_torch/probe_cell_pace.py --workload link_rx_ch256 \\
        [--runs 8] [--seconds 10] [--seed 1000000007] [--log-dir DIR] \\
        [LABEL=CHECKOUT ...]

Each ``LABEL=CHECKOUT`` names a checkout whose ``benchmark/run.py`` runs
(``run=`` this one where none is given); the checkouts take turns, and
round ``i`` gives each of them seed ``--seed + 7919 i``. One line a run,
then for each checkout the quartile spread of each reading (the
interquartile range over the median). ``--log-dir`` keeps each run's
output.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import resource
import statistics
import subprocess
import sys
import time
from pathlib import Path


def run_once(root: Path, workload: str, seed: int, seconds: int):
    """One run of the cell: (rc, its output, its rusage, wall seconds)."""
    cmd = [sys.executable, "benchmark/run.py", "--workload", workload,
           "--seed", str(seed), "--seconds", str(seconds), "--trace", "0"]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=root, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    out = proc.stdout.read()
    _, status, usage = os.wait4(proc.pid, 0)
    proc.returncode = os.waitstatus_to_exitcode(status)
    return proc.returncode, out, usage, time.perf_counter() - t0


def spread(values):
    """The interquartile range over the median (Python's quartiles)."""
    if len(values) < 2:
        return float("nan")
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2 if q2 else float("nan")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--runs", type=int, default=8)
    ap.add_argument("--seconds", type=int, default=10)
    ap.add_argument("--seed", type=int, default=1000000007)
    ap.add_argument("--log-dir", type=Path)
    ap.add_argument("checkouts", nargs="*", metavar="LABEL=CHECKOUT")
    args = ap.parse_args()
    roots = [tuple(a.split("=", 1)) for a in args.checkouts] or [
        ("run", Path(__file__).resolve().parents[1])]
    if args.log_dir:
        args.log_dir.mkdir(parents=True, exist_ok=True)
    page = resource.getpagesize()
    rows = []
    for i, (label, root) in ((i, r) for i in range(args.runs)
                             for r in roots):
        seed = args.seed + 7919 * i
        rc, out, ru, wall = run_once(Path(root), args.workload, seed,
                                     args.seconds)
        if args.log_dir:
            (args.log_dir / f"{label}_{i}_{seed}.txt").write_text(out)
        line = next((json.loads(t) for t in reversed(out.splitlines())
                     if t.startswith('{"correct"')), None)
        steps = re.search(r"steps (\d+)", out)
        steps = int(steps.group(1)) if steps else 0
        row = {"label": label, "run": i, "seed": seed, "rc": rc,
               "correct": None if line is None else line["correct"],
               "steps": steps, "minflt": ru.ru_minflt,
               "majflt": ru.ru_majflt, "maxrss_mb": ru.ru_maxrss / 1024,
               "utime_s": ru.ru_utime, "stime_s": ru.ru_stime,
               "wall_s": wall, "page_bytes": page}
        if steps:  # set-up included: the trend counts, not the level
            row["minflt_per_step"] = ru.ru_minflt / steps
            row["stime_ms_per_step"] = ru.ru_stime / steps * 1e3
        if line is not None:
            row.update({k: v["value"] for k, v in line["metrics"].items()})
        rows.append(row)
        print(json.dumps(row), flush=True)
    for label, _ in roots:
        mine = [r for r in rows if r["label"] == label]
        for key in sorted({k for r in mine for k in r}
                          - {"label", "run", "seed", "rc", "correct",
                             "page_bytes"}):
            vals = [r[key] for r in mine
                    if isinstance(r.get(key), (int, float))]
            if vals:
                print(f"{label} {key}: median "
                      f"{statistics.median(vals)!r}, spread "
                      f"{spread(vals):.4f}, first {vals[0]!r}, last "
                      f"{vals[-1]!r}")
    return 0 if all(r["rc"] == 0 and r["correct"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
