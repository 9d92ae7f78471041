"""Helpers of the benchmark's CPU tests: a copy of the benchmark at sizes
a CPU run holds, and one run of a cell from such a copy."""

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

# sizes a CPU run holds; each still engages the paths the cell times
TINY = {
    "ch256_t131072_pool4": {"channels": 3, "samples_per_step": 4096},
    "fm_ch256_t131072_pool4": {"channels": 3, "samples_per_step": 8192},
    "fm_ch256_t16384_pool4": {"channels": 2, "samples_per_step": 4096},
    "wideband_host_2p25x2": {"buffer_samples": 1 << 18, "profile_steps": 2},
}
QUICK = {"warmup_s": 0.05, "warmup_steps": 2, "profile_s": 0.05}


def make_tiny_root(dest: Path) -> Path:
    """A copy of the benchmark (``BENCHMARK.json`` and ``benchmark/``)
    under ``dest`` with every traffic file cut to :data:`TINY`."""
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", dest / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name, over in TINY.items():
        p = dest / "benchmark" / "traffic" / f"{name}.json"
        t = json.loads(p.read_text())
        t.update(QUICK)
        t.update(over)
        p.write_text(json.dumps(t))
    return dest


def run_cell(root: Path, cell: str, capsys, seed: int = 3000000019,
             trace: int = 0, seconds: float = 0.3):
    """One run of ``cell`` on the CPU from ``root``; (exit code, result or
    None, standard error)."""
    from benchmark import harness

    capsys.readouterr()
    rc = harness.main(["--workload", cell, "--seed", str(seed), "--seconds",
                       str(seconds), "--trace", str(trace)], root=root,
                      require_card=False)
    out = capsys.readouterr()
    lines = out.out.strip().splitlines()
    result = json.loads(lines[-1]) if rc == 0 and lines else None
    return rc, result, out.err
