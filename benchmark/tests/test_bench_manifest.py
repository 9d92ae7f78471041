"""BENCHMARK.json against the benchmark's contract, and every name in it
against the files the harness finds by that name."""

import json
import re
from pathlib import Path

import pytest

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
CELLS = [w["name"] for w in MANIFEST["workloads"]]
METRICS = MANIFEST["end_to_end"] + MANIFEST["per_layer"]


def short_line(s: str) -> bool:
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_size():
    assert set(MANIFEST) == KEYS
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_command_and_paths():
    cmd, paths = MANIFEST["command"], MANIFEST["paths"]
    assert 1 <= len(cmd) <= 32 and all(short_line(w) for w in cmd)
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    for word in cmd[1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in paths), word
            assert (ROOT / word).is_file()


def test_run_seconds_fits_a_full_check():
    s = MANIFEST["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    runs = 2 + 14 * 24
    assert runs * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", MANIFEST["configs"],
                         ids=lambda e: e["name"])
def test_config_entry(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"])
    assert short_line(entry["source"]) and short_line(entry["why"])
    assert entry["reduced"] == []
    f = ROOT / entry["file"]
    assert f.is_file() and entry["file"].startswith("benchmark/")
    cfg = json.loads(f.read_text())
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert "assumed" in cfg and "limits" in cfg
    for kind in ("configs", "reference", "counts"):
        assert (BENCH / kind / f"{entry['name']}.py").is_file()
    assert any(w["config"] == entry["name"] for w in MANIFEST["workloads"])


@pytest.mark.parametrize("cell", MANIFEST["workloads"],
                         ids=lambda w: w["name"])
def test_cell_entry(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    for k in ("name", "config", "traffic"):
        assert NAME.match(cell[k])
    assert short_line(cell["why"])
    assert cell["chips"] == 1
    assert cell["config"] in {c["name"] for c in MANIFEST["configs"]}
    traffic = BENCH / "traffic" / f"{cell['traffic']}.json"
    assert traffic.is_file()
    driver = json.loads(traffic.read_text())["driver"]
    assert (BENCH / "drivers" / f"{driver}.py").is_file()


def test_cells_and_names_are_unique():
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert len(set(CELLS)) == len(CELLS)
    names = [m["name"] for m in METRICS]
    assert len(set(names)) == len(names)
    assert 1 <= len(MANIFEST["workloads"]) <= 24
    assert 1 <= len(MANIFEST["configs"]) <= 24


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_entry(metric):
    e2e = metric in MANIFEST["end_to_end"]
    keys = {"name", "unit", "better", "source"} | (
        {"bound"} if e2e else {"layer", "moves"})
    assert set(metric) - {"workloads"} == keys
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in SOURCES
    if e2e:
        assert metric["source"] in ("host_clock", "device_trace")
        cap = 0.25
        assert 0.01 <= metric["bound"] <= cap
    else:
        assert short_line(metric["layer"])
        assert metric["moves"] in {m["name"] for m in MANIFEST["end_to_end"]}
    for cell in metric.get("workloads", CELLS):
        assert cell in CELLS
    assert harness.reader_path(BENCH, metric["name"]).is_file()


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports_what_the_contract_asks(cell):
    def reports(m):
        return cell in m.get("workloads", CELLS)

    e2e = {m["name"] for m in MANIFEST["end_to_end"] if reports(m)}
    layer = [m for m in MANIFEST["per_layer"] if reports(m)]
    assert "setup_s" in e2e and len(e2e) >= 2 and layer
    for m in layer:  # a per-layer metric's cell reports what it moves
        assert m["moves"] in e2e


def test_one_layer_name_a_layer():
    layers = {m["layer"] for m in MANIFEST["per_layer"]}
    perf = (ROOT / "PERF.md").read_text()
    for layer in layers:
        assert layer in perf, layer


def test_end_to_end_has_setup_and_another():
    names = [m["name"] for m in MANIFEST["end_to_end"]]
    assert "setup_s" in names and len(names) >= 2
    setup = next(m for m in MANIFEST["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] <= 0.25


def test_split_metric_takes_its_stem_reader(tmp_path):
    metrics = tmp_path / "metrics"
    metrics.mkdir()
    (metrics / "a.b.py").write_text("")
    assert harness.reader_path(tmp_path, "a.b.x") == metrics / "a.b.py"
    assert harness.reader_path(tmp_path, "a.b") == metrics / "a.b.py"
    (metrics / "a.b.x.py").write_text("")
    assert harness.reader_path(tmp_path, "a.b.x") == metrics / "a.b.x.py"
    assert not harness.reader_path(tmp_path, "c.d").is_file()
