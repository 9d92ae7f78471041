"""The port's observability, checkpoint/resume and docs plane
(core/introspect.py, Topology.query_stats/save_state/load_state and the
CLI's list/doc/catalog) against the JAX package: the 10 tests of
tests/test_introspect.py, tests/test_fusion.py::test_checkpoint_while_engaged,
a checkpoint of an engaged segment holding no torch.Tensor, the catalogs
of both packages equal, and the CLI where JAX cannot be imported.

Inputs are explicit float32/float64 arrays from
numpy.random.default_rng(seed). Tolerances: a float64 resume against the
uninterrupted run within 1e-12 (the JAX tests' bound) and against the
JAX package's within the same; a float32 fused resume within 1e-3
absolute (tests/test_fusion.py:317); counters, schemas and CLI output
exactly.
"""

import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import pothoscomms_tpu as jpkg
import pothoscomms_tpu.core.fixtures as jfix
import pothoscomms_tpu.core.introspect as jintro
import pothoscomms_tpu_torch as pkg
import pothoscomms_tpu_torch.core.fixtures as fix
from pothoscomms_tpu_torch.core.introspect import block_doc, catalog

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
THRESH = 4096
PACKAGES = {"port": (pkg, fix), "jax": (jpkg, jfix)}


def _topo(p):
    return p.Topology(device="cpu") if p is pkg else p.Topology()


def test_query_stats():
    stats = {}
    for which, (p, fx) in PACKAGES.items():
        feed = fx.FeederSource("float32")
        feed.feed_buffer(np.ones(100, np.float32))
        scale = p.BlockRegistry.make("/comms/scale", "float32")
        scale.set_factor(2.0)
        sink = fx.CollectorSink("float32")
        topo = _topo(p)
        topo.connect(feed, 0, scale, 0)
        topo.connect(scale, 0, sink, 0)
        topo.commit()
        assert topo.wait_inactive()
        st = topo.query_stats()
        s = st[scale.name]
        assert s["work_calls"] >= 1
        assert s["inputs"]["0"]["consumed"] == 100
        assert s["outputs"]["0"]["produced"] == 100
        assert s["work_time_s"] >= 0.0
        # the counters by graph position, without the timings
        stats[which] = [(v["type"], v["inputs"], v["outputs"])
                        for v in st.values()]
    assert stats["port"] == stats["jax"]


def _checkpoint_resume(which, tmp_path, build, x, split):
    """Run x[:split], checkpoint, restore into a fresh topology, run the
    rest; returns (uninterrupted output, first + second half)."""
    p, fx = PACKAGES[which]
    topo, feed, sink = build(p, fx)
    feed.feed_buffer(x)
    topo.commit()
    assert topo.wait_inactive()
    full = sink.get_buffer()

    topo1, feed1, sink1 = build(p, fx)
    feed1.feed_buffer(x[:split])
    topo1.commit()
    assert topo1.wait_inactive()
    ckpt = str(tmp_path / f"{which}.pkl")
    topo1.save_state(ckpt)
    first = sink1.get_buffer()

    topo2, feed2, sink2 = build(p, fx)
    topo2.commit()  # commit resets state; restore must override it
    topo2.load_state(ckpt)
    sink2.clear()
    feed2.feed_buffer(x[split:])
    assert topo2.wait_inactive()
    return full, np.concatenate([first, sink2.get_buffer()])


def test_checkpoint_resume_iir(tmp_path):
    rng = np.random.default_rng(0)
    x = rng.normal(size=400)
    taps = [0.2, 0.3, 1.0, -0.5]

    def build(p, fx):
        feed = fx.FeederSource("float64")
        iir = p.BlockRegistry.make("/comms/iir_filter", "float64")
        iir.set_taps(taps)
        sink = fx.CollectorSink("float64")
        topo = _topo(p)
        topo.connect(feed, 0, iir, 0)
        topo.connect(iir, 0, sink, 0)
        return topo, feed, sink

    full, resumed = _checkpoint_resume("port", tmp_path, build, x, 200)
    np.testing.assert_allclose(resumed, full, rtol=0, atol=1e-12)
    jfull, _ = _checkpoint_resume("jax", tmp_path, build, x, 200)
    np.testing.assert_allclose(resumed, jfull, rtol=0, atol=1e-12)


def test_checkpoint_covers_port_queues(tmp_path):
    # FIR keeps K-1 history samples queued in the port: a checkpoint must
    # carry them so the restored stream is seamless
    rng = np.random.default_rng(1)
    x = rng.normal(size=300)
    taps = rng.normal(size=15)

    def build(p, fx):
        feed = fx.FeederSource("float64")
        fir = p.BlockRegistry.make("/comms/fir_filter", "float64", "REAL")
        fir.set_taps(taps)
        sink = fx.CollectorSink("float64")
        topo = _topo(p)
        topo.connect(feed, 0, fir, 0)
        topo.connect(fir, 0, sink, 0)
        return topo, feed, sink

    full, resumed = _checkpoint_resume("port", tmp_path, build, x, 150)
    np.testing.assert_allclose(resumed, full, rtol=0, atol=1e-12)
    jfull, _ = _checkpoint_resume("jax", tmp_path, build, x, 150)
    np.testing.assert_allclose(resumed, jfull, rtol=0, atol=1e-12)


def test_checkpoint_type_mismatch(tmp_path):
    for p, fx in PACKAGES.values():
        feed = fx.FeederSource("float32")
        sink = fx.CollectorSink("float32")
        topo = _topo(p)
        topo.connect(feed, 0, sink, 0)
        topo.commit()
        path = str(tmp_path / "s.pkl")
        topo.save_state(path)
        other = _topo(p)
        f2, s2 = fx.FeederSource("float32"), fx.CollectorSink("float32")
        scale = p.BlockRegistry.make("/comms/scale", "float32")
        other.connect(f2, 0, scale, 0)
        other.connect(scale, 0, s2, 0)
        with pytest.raises(ValueError):
            other.load_state(path)


def test_block_doc_schema():
    fir = pkg.BlockRegistry.make("/comms/fir_filter", "float32", "REAL")
    doc = block_doc(fir)
    assert doc["type"] == "FIRFilter"
    assert "taps" in doc["params"] and "decimation" in doc["params"]
    assert doc["inputs"] == ["0"] and doc["outputs"] == ["0"]
    assert "FIR" in doc["doc"] or "resampl" in doc["doc"]
    designer = pkg.BlockRegistry.make("/comms/fir_designer")
    assert "tapsChanged" in block_doc(designer)["signals"]
    jdoc = jintro.block_doc(jpkg.BlockRegistry.make("/comms/fir_filter",
                                                    "float32", "REAL"))
    for key in ("type", "category", "keywords", "inputs", "outputs",
                "params", "signals", "probes"):
        assert doc[key] == jdoc[key], key


def test_catalog_covers_all_comms_paths():
    cat = catalog()
    comms = [p for p in pkg.BlockRegistry.paths() if p.startswith("/comms/")]
    assert set(cat) == set(comms)
    documented = [p for p, d in cat.items() if "error" not in d]
    assert len(documented) >= len(comms) - 2, sorted(
        p for p, d in cat.items() if "error" in d)


def test_catalog_equals_jax():
    """The same paths, and for each the same params (specs and defaults),
    ports and signals as the JAX package's catalog."""
    cat, jcat = catalog(), jintro.catalog()
    assert sorted(cat) == sorted(jcat)
    for path in jcat:
        for key in ("type", "params", "inputs", "outputs", "signals",
                    "probes"):
            assert cat[path].get(key) == jcat[path].get(key), (path, key)


def test_cli_list_and_doc(capsys):
    from pothoscomms_tpu_torch.__main__ import main

    assert main(["list"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert "/comms/fft" in out and len(out) == len(pkg.BlockRegistry.paths())
    assert out == jpkg.BlockRegistry.paths()
    assert main(["doc", "/comms/fir_filter", "float32"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert "decimation" in doc["params"]
    # arguments parse as Python literals where they can
    assert main(["doc", "/comms/fft", "complex_float32", "256", "False"]) == 0
    assert json.loads(capsys.readouterr().out)["type"] == "FFTBlock"
    assert main(["doc"]) == 2
    assert main(["doc", "/comms/nonexistent"]) == 2
    assert main(["nonsense"]) == 2
    assert main([]) == 2
    assert main(["catalog"]) == 0
    assert set(json.loads(capsys.readouterr().out)) == set(catalog())


def test_cli_runs_where_jax_cannot_be_imported():
    """``python -m pothoscomms_tpu_torch list|doc|catalog`` with jax and
    the JAX package blocked from importing, as on a machine without
    them: 116 paths, a catalog with no unconstructible entry."""
    code = (
        "import runpy, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['pothoscomms_tpu'] = None\n"
        "import pothoscomms_tpu_torch, pothoscomms_tpu_torch.__main__\n"
        "from pothoscomms_tpu_torch.core.introspect import catalog\n"
        "cat = catalog()\n"
        "assert not [p for p, d in cat.items() if d.get('type') == '?']\n"
        "assert not [m for m in sys.modules if m.startswith('jax')\n"
        "            and sys.modules[m] is not None]\n"
        "sys.argv = ['pothoscomms_tpu_torch', sys.argv[1]] + sys.argv[2:]\n"
        "runpy.run_module('pothoscomms_tpu_torch', run_name='__main__')\n")
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    runs = {}
    for args in (["list"], ["doc", "/comms/signal_probe", "complex_float32"],
                 ["nonsense"]):
        proc = subprocess.run([sys.executable, "-c", code, *args], cwd=REPO,
                              capture_output=True, text=True, timeout=120,
                              env=env)
        runs[args[0]] = proc
    assert runs["list"].returncode == 0, runs["list"].stderr
    lines = runs["list"].stdout.splitlines()
    assert len(lines) == 116 and lines == jpkg.BlockRegistry.paths()
    assert runs["doc"].returncode == 0, runs["doc"].stderr
    assert json.loads(runs["doc"].stdout)["probes"] == ["value"]
    assert runs["nonsense"].returncode == 2


def test_cli_self_test_runs_the_named_file():
    """``self-test FILE`` runs the port's tests of that file alone (pytest
    in a subprocess, the options passed through) and returns pytest's
    exit code."""
    proc = subprocess.run(
        [sys.executable, "-m", "pothoscomms_tpu_torch", "self-test",
         "tests/test_torch_placement.py", "-p", "no:cacheprovider"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(REPO)})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert " passed" in proc.stdout and "failed" not in proc.stdout


def test_cli_self_test_picks_the_card_tests_without_jax(monkeypatch):
    """Where JAX is not installed, the default set is the card's tests,
    run without tests/conftest.py (which imports JAX); with JAX, every
    tests/test_torch_*.py."""
    import importlib.util

    from pothoscomms_tpu_torch import __main__ as cli

    calls = []
    monkeypatch.setattr(subprocess, "call",
                        lambda cmd, **kw: calls.append(cmd) or 0)
    assert cli.main(["self-test", "-x"]) == 0
    files = [a for a in calls[0] if a.endswith(".py")]
    assert len(files) > 30 and all("test_torch_" in f for f in files)
    assert "--noconftest" not in calls[0] and calls[0][-1] == "-x"
    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "jax"
                        else real(name, *a))
    assert cli.main(["self-test", "-k", "sync_search"]) == 0
    cmd = calls[1]
    assert [a for a in cmd if a.endswith(".py")] == [
        str(REPO / "tests" / "test_torch_cuda.py")]
    assert cmd[-3:] == ["--noconftest", "-k", "sync_search"]


def test_catalog_has_no_unconstructible_entries():
    cat = catalog()
    broken = [p for p, d in cat.items() if d.get("type") == "?"]
    assert broken == [], f"unconstructible catalog entries: {broken}"


def test_fir_designer_doc_form_parity():
    doc = block_doc(pkg.BlockRegistry.make("/comms/fir_designer"))
    p = doc["params"]
    assert doc["category"] == "/Filter"
    assert "remez" in doc["keywords"]
    ft = [o["value"] for o in p["filter_type"]["options"]]
    assert set(ft) == {"ROOT_RAISED_COSINE", "RAISED_COSINE", "SINC",
                       "MAXFLAT", "GAUSSIAN", "REMEZ"}
    bt = [o["value"] for o in p["band_type"]["options"]]
    assert "COMPLEX_BAND_PASS" in bt
    wt = [o["value"] for o in p["window_type"]["options"]]
    assert {"kaiser", "chebyshev", "hann"} <= set(wt)
    assert p["sample_rate"]["units"] == "Sps"
    assert p["frequency_lower"]["units"] == "Hz"
    assert p["stop_db"]["units"] == "dB"
    assert p["num_taps"]["default"] == 51
    assert "SpinBox" in p["num_taps"]["widget"]
    assert "REMEZ" in p["bandwidth_trans"]["preview"]
    for name in ("filter_type", "band_type", "window_type", "gain",
                 "alpha", "num_taps"):
        assert p[name].get("label"), name
    assert doc == jintro.block_doc(jpkg.BlockRegistry.make(
        "/comms/fir_designer"))


def test_catalog_params_carry_defaults():
    cat = catalog()
    fft = cat["/comms/fft"]["params"]
    assert fft["num_bins"]["default"] == 1024
    assert any(o["value"] == 4096 for o in fft["num_bins"]["options"])
    wave = cat["/comms/waveform_source"]["params"]
    assert [o["value"] for o in wave["waveform"]["options"]] == [
        "CONST", "SINE", "RAMP", "SQUARE"]
    assert wave["frequency"]["units"] == "Hz"
    probe = cat["/comms/signal_probe"]["params"]
    assert {o["value"] for o in probe["mode"]["options"]} == {
        "VALUE", "RMS", "MEAN"}
    assert cat["/comms/fir_filter"]["params"]["decimation"]["default"] == 1


# ------------------------------------------------------------------ #
# checkpoints of engaged segments (tests/test_fusion.py:286)
# ------------------------------------------------------------------ #
def _fir_env(p):
    fir = p.BlockRegistry.make("/comms/fir_filter", "float32", "REAL")
    fir.set_taps(np.hamming(13) / 7)
    env = p.BlockRegistry.make("/comms/envelope_detector", "float32")
    return [fir, env]


def _run_fir_env(which, xs, fuse=True, ckpt=None):
    """feeder -> FIR -> envelope -> collector: feed xs[0], and, with
    ``ckpt``, save the state while engaged and load it back; then feed
    xs[1]. Returns (output, topology)."""
    p, fx = PACKAGES[which]
    blocks = _fir_env(p)
    feed, sink = fx.FeederSource("float32"), fx.CollectorSink("float32")
    topo = _topo(p)
    topo.auto_fuse = fuse
    topo.fuse_threshold = THRESH
    chain = [feed] + blocks + [sink]
    for a, b in zip(chain[:-1], chain[1:]):
        topo.connect(a, 0, b, 0)
    feed.feed_buffer(xs[0])
    topo.commit()
    assert topo.wait_inactive(timeout=30.0)
    if ckpt is not None:
        assert fuse and any(s.engaged for s in topo._segments)
        topo.save_state(ckpt)
        topo.load_state(ckpt)
    feed.feed_buffer(xs[1])
    assert topo.wait_inactive(timeout=30.0)
    return sink.get_buffer(), topo


def test_checkpoint_while_engaged(tmp_path):
    """save_state during fused execution folds the carries back into
    block state; the resumed stream equals an un-fused run within 1e-3,
    and the JAX package's resumed stream likewise."""
    rng = np.random.default_rng(8)
    # the first feed is the FIR's 12 samples of history and two whole
    # pulls, so the head drains and the segment stays engaged
    xs = [rng.normal(size=n).astype(np.float32)
          for n in (12 + 2 * THRESH, 2 * THRESH)]
    got, _ = _run_fir_env("port", xs, ckpt=str(tmp_path / "port.pkl"))
    ref, _ = _run_fir_env("port", xs, fuse=False)
    jgot, _ = _run_fir_env("jax", xs, ckpt=str(tmp_path / "jax.pkl"))
    assert got.shape == ref.shape == jgot.shape
    np.testing.assert_allclose(got, ref, atol=1e-3)
    np.testing.assert_allclose(got, jgot, atol=1e-3)


def _tensors_in(obj, seen=None):
    """Every torch.Tensor reachable from obj through containers and
    object attributes."""
    seen = set() if seen is None else seen
    if id(obj) in seen:
        return []
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        items = list(obj.values())
    elif isinstance(obj, (list, tuple, set, frozenset)):
        items = list(obj)
    elif hasattr(obj, "__dict__") and not isinstance(obj, type):
        items = list(vars(obj).values())
    else:
        return []
    return [t for it in items for t in _tensors_in(it, seen)]


def test_checkpoint_of_an_engaged_segment_holds_no_tensor(tmp_path):
    """A checkpoint taken while a FIR -> FFT segment is engaged and its
    FIR's planar taps are cached as a tensor holds host data only, and a
    fresh topology resumed from it continues the spectra within 2e-4
    (the JAX tests' FFT bound on unit-variance input)."""
    rng = np.random.default_rng(12)
    taps = (rng.normal(size=16) + 1j * rng.normal(size=16)) / 16
    # 100 samples stream; then whole pulls of 16384 + 4096 (the FFT's
    # 256-sample granule) drain the head, so the segment stays engaged
    n = 100 + 5 * THRESH
    x = (rng.normal(size=2 * n) + 1j * rng.normal(size=2 * n)).astype(
        np.complex64)

    def build():
        fir = pkg.BlockRegistry.make("/comms/fir_filter", "complex_float32",
                                     "COMPLEX")
        fir.set_taps(taps)
        fft = pkg.BlockRegistry.make("/comms/fft", "complex_float32", 256,
                                     False)
        feed = fix.FeederSource("complex_float32")
        sink = fix.CollectorSink("complex_float32")
        topo = pkg.Topology(device="cpu")
        topo.fuse_threshold = THRESH
        for a, b in ((feed, fir), (fir, fft), (fft, sink)):
            topo.connect(a, 0, b, 0)
        return topo, feed, fir, sink

    topo, feed, fir, sink = build()
    feed.feed_buffer(x[:100])  # streams: the FIR caches its taps
    topo.commit()
    assert topo.wait_inactive(timeout=30.0)
    assert isinstance(fir._taps_dev, torch.Tensor)
    feed.feed_buffer(x[100:n])
    assert topo.wait_inactive(timeout=30.0)
    seg = topo._segments[0]
    assert seg.engaged and seg.fused_elements > 0
    path = tmp_path / "engaged.pkl"
    topo.save_state(str(path))
    assert not seg.engaged
    with open(path, "rb") as f:
        blob = pickle.load(f)
    assert _tensors_in(blob) == []
    assert "_taps_dev" not in blob[1]["state"]
    first = sink.get_buffer()

    topo2, feed2, fir2, sink2 = build()
    topo2.commit()
    topo2.load_state(str(path))
    assert fir2._taps_dev is None
    sink2.clear()  # the sink's restored state holds the first half
    feed2.feed_buffer(x[n:])
    assert topo2.wait_inactive(timeout=30.0)
    resumed = np.concatenate([first, sink2.get_buffer()])

    topo3, feed3, _, sink3 = build()
    feed3.feed_buffer(x)
    topo3.commit()
    assert topo3.wait_inactive(timeout=30.0)
    full = sink3.get_buffer()
    assert resumed.shape == full.shape
    np.testing.assert_allclose(resumed, full, atol=2e-4)
