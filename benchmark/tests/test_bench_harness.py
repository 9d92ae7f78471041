"""Whole runs of the harness on the CPU at tiny sizes: each cell correct;
the timed path broken underneath (a step that returns its state
unchanged, half of the batch left out, an answer altered where it is
produced) and ``correct`` false; a throwaway cell, configuration, driver
and metric taken from added files alone; no result without a card."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from bench_helpers import ROOT, run_cell
from benchmark import harness

CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def manifest(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_cpu(tiny_root, capsys, cell, trace):
    rc, res, err = run_cell(tiny_root, cell, capsys, trace=trace)
    assert rc == 0, err
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "checks"
    assert res["device"]["platform"] == "cpu"
    cellobj = harness.Cell(manifest(tiny_root), cell, tiny_root)
    # device metrics stay out of a CPU run: the trace holds no device event
    want = {m["name"] for m in cellobj.metrics(bool(trace))
            if m["source"] != "device_trace"}
    assert want <= set(res["metrics"]), (want, res["metrics"])
    for k, c in res["checks"].items():
        assert f"check {k}: " in err


# ---------------------------------------------------------------------- #
# faults planted under the timed path
# ---------------------------------------------------------------------- #
def stale_state(step):
    def broken(x, carry):
        y, _ = step(x, carry)
        return y, carry
    return broken


def half_batch(step):
    def broken(x, carry):
        y, carry = step(x, carry)
        y = y.clone()
        y[y.shape[0] // 2:] = 0
        return y, carry
    return broken


def altered_answer(step):
    def broken(x, carry):
        y, carry = step(x, carry)
        y = y.clone()
        y.view(-1)[y.numel() // 3] += 1.0
        return y, carry
    return broken


FAULTS = {"stale_state": stale_state, "half_batch": half_batch,
          "altered_answer": altered_answer}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", ["spectrum_ch256", "fm_rx_ch256",
                                  "fm_rx_ch256_t16k"])
def test_closed_loop_fault_is_caught(tiny_root, capsys, monkeypatch, cell,
                                     fault):
    c = harness.Cell(manifest(tiny_root), cell, tiny_root)
    entry = c.config_module.step_entry

    def broken_entry(*a, **k):
        step, carry = entry(*a, **k)
        return FAULTS[fault](step), carry

    monkeypatch.setattr(c.config_module, "step_entry", broken_entry)
    rc, res, err = run_cell(tiny_root, cell, capsys)
    assert rc == 0, err
    assert res["correct"] is False and res["failed"] > 0


def test_topology_faults_are_caught(tiny_root, capsys, monkeypatch):
    """The block API's fused segment broken where it computes and posts:
    each fault alone makes the run incorrect. The stream cycles through
    two buffers, so a carry left as it was at an even step's start is
    right again at every even step: the window needs two steps or more,
    hence a window of a second."""
    from pothoscomms_tpu_torch.core import fusion

    seg = fusion.FusedSegment
    work, post = seg.work, seg._post

    def stale_work(self):
        before = self.carries
        work(self)
        if self.engaged and before is not None:
            self.carries = before

    def cut_post(fn):
        def patched(self, y, labels=None):
            y = y.clone()
            fn(y)
            return post(self, y, labels)
        return patched

    def zero_half(y):
        y.view(-1)[y.numel() // 2:] = 0

    def alter(y):
        y.view(-1)[y.numel() // 3] += 1.0

    for name, attr, patch in (("stale_state", "work", stale_work),
                              ("half_batch", "_post", cut_post(zero_half)),
                              ("altered_answer", "_post", cut_post(alter))):
        with monkeypatch.context() as m:
            m.setattr(seg, attr, patch)
            rc, res, err = run_cell(tiny_root, "spectrum_wideband_topology",
                                    capsys, seconds=1.0)
        assert rc == 0, (name, err)
        assert res["correct"] is False, name


def test_unbroken_topology_stays_fused(tiny_root, capsys):
    rc, res, err = run_cell(tiny_root, "spectrum_wideband_topology", capsys,
                            trace=1)
    assert rc == 0 and res["correct"], err
    assert res["metrics"]["runtime.fused_pct"]["value"] > 50


# ---------------------------------------------------------------------- #
# a cell, a configuration, a driver and a metric from added files alone
# ---------------------------------------------------------------------- #
def test_throwaway_cell_from_added_files(tiny_root, capsys):
    bench = tiny_root / "benchmark"
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    # a configuration: its sizes, its build, its reference and its count
    cfg = json.loads((bench / "configs" / "spectrum_fir64_fft1024.json")
                     .read_text())
    cfg.update(name="tiny_fir8_fft256", taps=8, nbins=256)
    (bench / "configs" / "tiny_fir8_fft256.json").write_text(json.dumps(cfg))
    for kind in ("configs", "reference", "counts"):
        shutil.copy(bench / kind / "spectrum_fir64_fft1024.py",
                    bench / kind / "tiny_fir8_fft256.py")
    # a driver: the closed loop with one step in flight
    (bench / "drivers" / "one_in_flight.py").write_text(
        "from benchmark import harness\n"
        "from pathlib import Path\n"
        "here = Path(__file__).parent\n"
        "base = harness.load_module(here / 'closed_loop.py')\n"
        "setup, measure, check = base.setup, base.measure, base.check\n")
    # a traffic mix
    (bench / "traffic" / "tiny_c2_t2048.json").write_text(json.dumps({
        "driver": "one_in_flight", "channels": 2, "samples_per_step": 2048,
        "pool": 3, "in_flight": 1, "warmup_s": 0.05, "warmup_steps": 2,
        "profile_s": 0.05, "check_steps": 2,
        "signal": {"kind": "complex_normal"}}))
    # a per-layer metric
    (bench / "metrics" / "loop.steps_done.py").write_text(
        "def read(m):\n    return float(m['steps'])\n")
    man = manifest(tiny_root)
    for m in man["end_to_end"]:
        if m["name"] in ("throughput", "step_p95"):
            m["workloads"].append("tiny_cell")
    man["configs"].append({"name": "tiny_fir8_fft256", "source": "a test",
                           "file": "benchmark/configs/tiny_fir8_fft256.json",
                           "reduced": [], "why": "a throwaway"})
    man["workloads"].append({"name": "tiny_cell", "config":
                             "tiny_fir8_fft256", "traffic": "tiny_c2_t2048",
                             "chips": 1, "why": "a throwaway"})
    man["per_layer"].append({"name": "loop.steps_done", "unit": "steps",
                             "better": "higher", "source": "host_clock",
                             "layer": "function entry", "moves": "throughput",
                             "workloads": ["tiny_cell"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(man))
    for p, data in before.items():  # nothing that was there changed
        assert p.read_bytes() == data
    rc, res, err = run_cell(tiny_root, "tiny_cell", capsys, trace=0)
    assert rc == 0 and res["correct"], err
    assert set(res["metrics"]) == {"throughput", "step_p95", "setup_s"}
    rc, res, err = run_cell(tiny_root, "tiny_cell", capsys, trace=1)
    assert rc == 0 and res["correct"], err
    assert res["metrics"]["loop.steps_done"]["value"] > 0
    assert "entry.enqueue_ms" not in res["metrics"]


# ---------------------------------------------------------------------- #
# the card
# ---------------------------------------------------------------------- #
def test_no_card_no_result():
    """Without a CUDA card a run exits 2 and prints nothing on stdout."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload",
         "spectrum_ch256", "--seed", "3000000029", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 2
    assert proc.stdout == ""
    assert "no card" in proc.stderr


def test_no_result_without_the_program(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's files
    cannot run: the program is missing."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "spectrum_ch256",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""


@pytest.mark.cuda
def test_cell_on_card():
    """One short run of the first cell on the card, correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "spectrum_ch256",
         "--seed", "3000000031", "--seconds", "2", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
