"""The port's BASELINE bench suite (``benches_torch/bench_suite.py``) and the
CLI's ``bench`` against the JAX package's suite (``benches/bench_suite.py``),
run small on ``device="cpu"``.

Each line has the JAX line's keys, ``metric`` and ``unit`` (read from the
JAX source for every workload, and from the JAX suite's own line for the
three that are cheap on the CPU). Parity on the same seeded numpy inputs,
built as explicit float32: the FFT within 2e-5 of max |y| of JAX
``fft_planar``; one chained resampler step within 1e-4 of max |y| of JAX
``rational_fir_mm``, its history exact; the FM step within 2e-3 absolute
of JAX ``compile_chain``; fir_1ch's whole timed output within 1e-3 of the
float64 convolution; the modem bit for bit; the digital link delivering as
many bit-exact frames as JAX's; the sharded link's ``bit_exact`` list at
world size 1 on gloo equal to JAX's on a one-device mesh.
"""

import ast
import importlib.util
import json
import os
import subprocess
import sys
import tomllib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import pothoscomms_tpu as jpkg
from pothoscomms_tpu.ops import filter as jfilter
from pothoscomms_tpu.parallel import compiler as jcompiler
from pothoscomms_tpu.parallel import fft as jfft
from pothoscomms_tpu.parallel import link as jlink
from pothoscomms_tpu_torch import __main__ as cli

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
NAMES = ["fir_1ch", "fft_64ch_1024", "resampler_3_2", "fm_chain_256ch",
         "digital_link", "digital_modem_bulk", "digital_link_sharded"]
# small sizes for the CPU; each still engages its fused segment
SMALL = {
    "fir_1ch": dict(n=1 << 17, reps=2),
    "fft_64ch_1024": dict(channels=2, frames=4, iters=2),
    "resampler_3_2": dict(channels=2, n=1024, iters=2),
    "fm_chain_256ch": dict(channels=4, t=2048, pool=2, iters=2),
    "digital_link": dict(n_frames=4),
    "digital_modem_bulk": dict(n_bits=1 << 17),
    "digital_link_sharded": dict(),
}


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def suite():
    return _load("bench_suite_torch",
                 REPO / "benches_torch" / "bench_suite.py")


@pytest.fixture(scope="module")
def jax_suite():
    return _load("bench_suite_jax", REPO / "benches" / "bench_suite.py")


@pytest.fixture(scope="module")
def lines(suite):
    """Each workload's line at its small size on the CPU."""
    return {n: suite.ALL[n](device="cpu", **SMALL[n]) for n in NAMES}


def jax_line_shapes():
    """{workload: (keys, metric, unit pattern)} from the dict each JAX
    ``bench_*`` returns, read from its source: a formatted part of the
    unit matches any text."""
    tree = ast.parse((REPO / "benches" / "bench_suite.py").read_text())
    funcs = {f.name: f for f in tree.body if isinstance(f, ast.FunctionDef)}
    table = next(n.value for n in tree.body if isinstance(n, ast.Assign)
                 and n.targets[0].id == "ALL")
    out = {}
    for key, fn in zip(table.keys, table.values):
        ret = [r.value for r in ast.walk(funcs[fn.id])
               if isinstance(r, ast.Return)
               and isinstance(r.value, ast.Dict)][-1]
        fields = dict(zip((k.value for k in ret.keys), ret.values))
        unit = fields["unit"]
        if isinstance(unit, ast.JoinedStr):
            pattern = "".join(
                v.value if isinstance(v, ast.Constant) else "\0"
                for v in unit.values)
        else:
            pattern = unit.value
        out[key.value] = (set(fields), fields["metric"].value, pattern)
    return out


def unit_matches(unit, pattern):
    parts = pattern.split("\0")
    if len(parts) == 1:
        return unit == pattern
    return unit.startswith(parts[0]) and unit.endswith(parts[-1]) \
        and len(unit) > len(parts[0]) + len(parts[-1])


def test_suite_has_the_jax_suites_workloads(suite):
    assert list(suite.ALL) == NAMES == list(jax_line_shapes())


@pytest.mark.parametrize("name", NAMES)
def test_line_matches_the_jax_suite(lines, name):
    keys, metric, pattern = jax_line_shapes()[name]
    line = lines[name]
    assert set(line) == keys
    assert line["metric"] == metric
    assert unit_matches(line["unit"], pattern), (line["unit"], pattern)
    assert np.isfinite(line["value"]) and line["value"] > 0


@pytest.mark.parametrize("name", ["fft_64ch_1024", "digital_link",
                                  "digital_link_sharded"])
def test_line_matches_the_jax_suites_own_line(suite, jax_suite, name):
    """At the suites' defaults, where the JAX suite is cheap on the CPU:
    the same keys, metric and unit (the sharded link's unit counts the
    channels of each one's devices)."""
    ours = suite.ALL[name](device="cpu")
    theirs = jax_suite.ALL[name]()
    assert set(ours) == set(theirs)
    assert ours["metric"] == theirs["metric"]
    if name == "digital_link_sharded":
        assert ours["unit"] == f"bit-exact channels of {2 * ours['devices']}"
        assert theirs["unit"] == \
            f"bit-exact channels of {2 * theirs['devices']}"
    else:
        assert ours["unit"] == theirs["unit"]
    assert suite.passed(ours)


@pytest.mark.parametrize("name", NAMES)
def test_small_line_passes_its_gates(suite, lines, name):
    assert suite.passed(lines[name]), lines[name]


# ---------------------------------------------------------------------- #
# parity with the JAX functions on the same inputs
# ---------------------------------------------------------------------- #
def test_fft_step_matches_jax_fft_planar(suite):
    step, hosts, xs = suite.build_fft_64ch_1024(channels=2, frames=4,
                                                iters=1, device="cpu")
    assert hosts[0].dtype == np.float32 and hosts[0].shape == (8, 1024, 2)
    got = step(xs[0]).numpy()
    ref = np.asarray(jfft.fft_planar(jnp.asarray(hosts[0]), 1024, False))
    assert np.max(np.abs(got - ref)) < 2e-5 * np.max(np.abs(ref))


def test_resampler_chained_step_matches_jax_rational_fir_mm(suite):
    C, N = 2, 1024
    step, x0, hist0, taps = suite.build_resampler_3_2(channels=C, n=N,
                                                      device="cpu")
    t0, t1, b_in, b_out = jfilter.rational_fir_operators(taps, 2, 3)
    y1, h1 = step(x0, hist0)
    x1 = y1[:, :N] * np.float32(0.5)
    y2, h2 = step(x1, h1)
    jy1, jh1 = jfilter.rational_fir_mm(jnp.asarray(x0.numpy()),
                                       jnp.asarray(hist0.numpy()), t0, t1,
                                       b_in, b_out)
    jy2, jh2 = jfilter.rational_fir_mm(jnp.asarray(x1.numpy()), jh1, t0, t1,
                                       b_in, b_out)
    for got, ref in ((y1, jy1), (y2, jy2)):
        ref = np.asarray(ref)
        assert got.shape == ref.shape == (C, N * 3 // 2, 2)
        assert np.max(np.abs(got.numpy() - ref)) < 1e-4 * np.max(np.abs(ref))
    assert np.array_equal(h2.numpy(), np.asarray(jh2, np.float32))


def fm_jax_blocks():
    demod = jpkg.BlockRegistry.make("/comms/freq_demod", "complex_float32")
    dc = jpkg.BlockRegistry.make("/comms/dc_removal", "float32")
    dc.set_average_size(64)
    dc.set_cascade_size(2)
    env = jpkg.BlockRegistry.make("/comms/envelope_detector", "float32")
    env.set_attack(10.0)
    env.set_release(40.0)
    return [demod, dc, env]


def test_fm_step_matches_jax_compile_chain(suite):
    C, T = 4, 2048
    step, carry, hosts, xs = suite.build_fm_chain_256ch(channels=C, t=T,
                                                        pool=2, device="cpu")
    jstep, jcarry = jcompiler.compile_chain(fm_jax_blocks(), channels=C)
    for h, x in zip(hosts, xs):
        assert h.dtype == np.float32
        y, carry = step(x, carry)
        jy, jcarry = jstep(jnp.asarray(h), jcarry)
        assert y.shape == (C, T)
        assert np.max(np.abs(y.numpy() - np.asarray(jy))) < 2e-3


def test_fir_1ch_output_matches_the_convolution(suite):
    """The suite's parity gate holds at a size that engages the segment,
    and the designer's taps are the JAX designer's."""
    line = suite.bench_fir_1ch(n=1 << 17, reps=2, device="cpu")
    assert line["parity"] and line["max_err"] < 1e-3 and line["engaged"] >= 1
    captured = {}

    class Catch:
        def call(self, name, *args):
            captured["taps"] = np.asarray(args[0])

    designer = jpkg.BlockRegistry.make("/comms/fir_designer")
    designer.connect_signal("tapsChanged", Catch(), "setTaps")
    designer.set_filter_type("SINC")
    designer.set_band_type("LOW_PASS")
    designer.set_num_taps(51)
    designer.set_frequency_lower(0.1)
    designer.set_sample_rate(1.0)
    designer._active = True
    designer.recalculate()
    np.testing.assert_allclose(suite.fir_1ch_taps(), captured["taps"],
                               rtol=0, atol=1e-12)


def test_fir_1ch_oracle_is_the_cosine_convolved(suite):
    """The oracle's table walk is the float32 stream the source emits (the
    real part of the table's SINE, a cosine at the table's step), whose
    first K-1 samples fill the FIR's history."""
    topo, src, sink, taps = suite.build_fir_1ch(device="cpu")
    topo.run_source_elements(4096)
    out = sink.get_buffer()
    k1 = len(taps) - 1
    assert len(out) == 4096 - k1
    wave = np.cos(2 * np.pi * src._step / (src._mask + 1) * np.arange(4096))
    exp = np.convolve(wave, taps)[k1: k1 + len(out)]
    assert np.max(np.abs(out - exp)) < 1e-5
    assert np.max(np.abs(out - suite.fir_1ch_oracle(src, taps, k1,
                                                    len(out)))) < 1e-5


def test_modem_bit_exact_through_one_fused_segment(suite):
    line = suite.bench_digital_modem_bulk(n_bits=1 << 17, device="cpu")
    assert line["bit_exact"] and line["quiesced"]
    assert line["seg_blocks"] == 6 and line["fused_bits"] > 0


def test_digital_link_delivers_as_many_frames_as_jax(suite, jax_suite):
    ours = suite.bench_digital_link(device="cpu")
    theirs = jax_suite.bench_digital_link()
    assert ours["value"] == theirs["value"] == 40
    assert ours["quiesced"] and theirs["quiesced"]


def test_sharded_link_matches_jax_on_one_device(suite):
    res, seconds = suite.run_digital_link_sharded(device="cpu")
    mesh = Mesh(np.array(jax.devices()[:1]), ("ch",))
    ref = jlink.run_sharded_link(mesh, n_channels=2, n_bits=64, seed=17,
                                 noise=0.01)
    assert res["channels"] == ref["channels"] == 2
    assert res["devices"] == ref["devices"] == 1
    assert list(res["bit_exact"]) == list(ref["bit_exact"])
    assert res["all_exact"] == ref["all_exact"]
    assert seconds > 0
    assert not torch.distributed.is_initialized()


# ---------------------------------------------------------------------- #
# the CLI
# ---------------------------------------------------------------------- #
def run_cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "pothoscomms_tpu_torch", *args], cwd=REPO,
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(REPO)})


def test_cli_bench_prints_one_line():
    proc = run_cli("bench", "--device", "cpu", "digital_link_sharded")
    assert proc.returncode == 0, proc.stderr
    out = proc.stdout.strip().splitlines()
    assert len(out) == 1
    line = json.loads(out[0])
    assert line["metric"] == "digital_link_sharded" and line["all_exact"]


def test_cli_bench_without_a_card_fails_with_torchs_own_error():
    """With no --device the suite runs on the card; without one it reports
    torch's error and exits 1, and runs nothing on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: bench would run on it")
    proc = run_cli("bench", "fft_64ch_1024")
    assert proc.returncode == 1
    line = json.loads(proc.stdout.strip())
    assert set(line) == {"metric", "error"}
    assert line["metric"] == "fft_64ch_1024"


def test_cli_bench_unknown_name_exits_2_before_running(suite, monkeypatch):
    ran = []
    monkeypatch.setitem(suite.ALL, "fft_64ch_1024",
                        lambda device=None: ran.append(device))
    assert suite.main(["fft_64ch_1024", "no_such_workload"]) == 2
    assert suite.main(["--device"]) == 2
    assert suite.main(["--device", "no_such_device", "fft_64ch_1024"]) == 2
    assert ran == []
    assert cli.main(["bench", "no_such_workload"]) == 2


def test_failed_gate_or_error_exits_1_and_the_others_still_print(
        suite, monkeypatch, capsys):
    ok = {"metric": "fm_chain_256ch", "value": 1.0, "unit": "Msamples/s"}

    def raises(device=None):
        raise RuntimeError("boom")

    monkeypatch.setitem(suite.ALL, "fm_chain_256ch", lambda device=None: ok)
    monkeypatch.setitem(suite.ALL, "digital_modem_bulk",
                        lambda device=None: {"metric": "digital_modem_bulk",
                                             "bit_exact": False})
    monkeypatch.setitem(suite.ALL, "digital_link",
                        lambda device=None: {"metric": "digital_link_frames",
                                             "value": 39,
                                             "unit": "bit-exact frames of 40"})
    monkeypatch.setitem(suite.ALL, "fft_64ch_1024", raises)
    for failing in ("digital_modem_bulk", "digital_link", "fft_64ch_1024"):
        capsys.readouterr()
        assert suite.main(["--device", "cpu", failing,
                           "fm_chain_256ch"]) == 1
        out = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
        assert len(out) == 2 and out[1] == ok
    assert out[0] == {"metric": "fft_64ch_1024", "error": "RuntimeError: boom"}
    assert suite.main(["fm_chain_256ch"]) == 0


def test_cli_help_lists_bench(capsys):
    assert cli.main(["--help"]) == 0
    assert "bench [--device DEV] [name ...]" in capsys.readouterr().out
    assert "bench" in cli.COMMANDS


def test_pyproject_names_the_ports_console_script():
    project = tomllib.loads((REPO / "pyproject.toml").read_text())["project"]
    target = project["scripts"]["pothoscomms-tpu-torch"]
    assert target == "pothoscomms_tpu_torch.__main__:main"
    module, _, attr = target.partition(":")
    assert callable(getattr(importlib.import_module(module), attr))
    assert project["scripts"]["pothoscomms-tpu"] == \
        "pothoscomms_tpu.__main__:main"


def test_suite_imports_no_jax():
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['pothoscomms_tpu'] = None\n"
            "import importlib.util\n"
            "spec = importlib.util.spec_from_file_location('s', "
            "'benches_torch/bench_suite.py')\n"
            "m = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(m)\n"
            "assert m.main(['--device', 'cpu', 'digital_link']) == 0\n"
            "assert not [k for k in sys.modules if k.startswith('jax')\n"
            "            and sys.modules[k] is not None]\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": str(REPO)})
    assert proc.returncode == 0, proc.stderr


def test_build_dir_is_the_checkouts_or_the_users_cache(tmp_path, monkeypatch):
    """A checkout builds under its build/torch_kernels; an installed
    package under the user's cache, never into site-packages (where it
    made a top-level build/ directory that no package owns)."""
    from pothoscomms_tpu_torch.kernels import build

    assert build.BUILD_DIR == REPO / "build" / "torch_kernels"
    site = tmp_path / "site-packages"
    (site / "pothoscomms_tpu_torch").mkdir(parents=True)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    assert build.build_dir(site / "pothoscomms_tpu_torch") == \
        tmp_path / "cache" / "pothoscomms_tpu_torch" / "torch_kernels"
    monkeypatch.delenv("XDG_CACHE_HOME")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert build.build_dir(site / "pothoscomms_tpu_torch") == \
        tmp_path / "home" / ".cache" / "pothoscomms_tpu_torch" / \
        "torch_kernels"
    (tmp_path / "checkout" / "pothoscomms_tpu_torch").mkdir(parents=True)
    (tmp_path / "checkout" / "pyproject.toml").write_text("")
    assert build.build_dir(tmp_path / "checkout" / "pothoscomms_tpu_torch") \
        == tmp_path / "checkout" / "build" / "torch_kernels"
