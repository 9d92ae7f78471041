"""The readers of the program's set-up, ``setup.kernels_s`` and
``setup.build_s``, on the CPU: a number of seconds at least 0 in every
cell of a tiny copy; none from a program that keeps no build record; and
no first build inside any cell's measured window, so that both read
set-up alone."""

import json
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from bench_helpers import TINY, make_tiny_root, run_cell
from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
READERS = ("setup.kernels_s", "setup.build_s")
# the tiny cells, and the link cut as its own tests cut it
CELLS = [w["name"] for w in MANIFEST["workloads"]
         if w["traffic"] in TINY] + ["link_rx_ch256"]
LINK_TINY = {"channels": 3, "samples_per_step": 4096, "gap_min": 300,
             "gap_max": 1500, "warmup_s": 0.05, "warmup_steps": 1,
             "profile_steps": 1}


@pytest.fixture
def root(tmp_path):
    """:func:`make_tiny_root`'s copy with the link cell cut as well."""
    root = make_tiny_root(tmp_path)
    p = root / "benchmark" / "traffic" / "link_ch256_b4000_pool4.json"
    p.write_text(json.dumps({**json.loads(p.read_text()), **LINK_TINY}))
    p = root / "benchmark" / "configs" / "digital_link_bpsk_4000b.json"
    p.write_text(json.dumps({**json.loads(p.read_text()),
                             "payload_bits": 512}))
    return root


@pytest.mark.parametrize("cell", CELLS)
def test_readers_give_seconds_in_every_cell(root, capsys, cell):
    rc, res, err = run_cell(root, cell, capsys, trace=1)
    assert rc == 0, err
    for name in READERS:
        got = res["metrics"][name]
        assert got["unit"] == "s" and got["value"] >= 0, (name, got)


@pytest.mark.parametrize("cell", CELLS)
def test_the_window_adds_no_first_build(root, cell):
    from pothoscomms_tpu_torch.parallel import profiling

    c = harness.Cell(json.loads((root / "BENCHMARK.json").read_text()),
                     cell, root)
    ctx = harness.Context(c, 3000000019, torch.device("cpu"),
                          time.perf_counter())
    state = c.driver.setup(ctx)
    snap = profiling.build_record()
    meas = c.driver.measure(state, 0.2, False)
    assert meas["steps"] > 0
    diff = profiling.build_record(since=snap)
    assert {n: r["first_n"] for n, r in diff["builds"].items()
            if r["first_n"]} == {}
    assert diff["compiled"] == {}


def test_readers_read_nothing_without_a_build_record(monkeypatch):
    from pothoscomms_tpu_torch.parallel import profiling

    monkeypatch.delattr(profiling, "build_record")
    bench = ROOT / "benchmark"
    for name in READERS:
        reader = harness.load_module(harness.reader_path(bench, name))
        assert reader.read({}) is None


def test_readers_split_the_record(monkeypatch):
    """The kernels' names to ``setup.kernels_s``, every other ``pc.build.``
    name to ``setup.build_s``; rebuilds and other names to neither."""
    from pothoscomms_tpu_torch.parallel import profiling

    def row(first_s, again_s=5.0):
        return {"first_n": 1, "first_s": first_s, "again_n": 1,
                "again_s": again_s}

    record = {"builds": {"pc.build.library.fft": row(0.5),
                         "pc.build.first_launch.fft_c2c": row(0.25),
                         "pc.build.core.FIRFilter": row(0.125),
                         "pc.build.fir_fft.one_pass": row(1.0),
                         "other.name": row(7.0)},
              "compiled": {"fft": 11.0}}
    monkeypatch.setattr(profiling, "build_record", lambda: record)
    bench = ROOT / "benchmark"
    got = {n: harness.load_module(harness.reader_path(bench, n)).read(
        SimpleNamespace()) for n in READERS}
    assert got == {"setup.kernels_s": 0.75, "setup.build_s": 1.125}
