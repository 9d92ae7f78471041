"""The build record of the port's set-up (``parallel/profiling.build``).

A build span wraps work that makes state kept for later steps: a
library's load (``pc.build.library.<name>``), a kernel wrapper's first
call on a card (``pc.build.first_launch.<wrapper>``), a chain's operators
(``pc.build.fir_fft.<form>``), a block's core (``pc.build.core.<Class>``),
I1's tables, the link's receiver and the block API's pair core. These
tests hold the record to what the span promises: it counts without a
profiler, it is a host range with one, a key seen before is a rebuild,
nested spans keep their own seconds, nvcc's seconds are noted only where
nvcc ran, every builder named above records its first build, and a warm
step adds nothing. Each test reads the difference from a snapshot
(``build_record(since=...)``); nothing resets the process's record. The
file imports no JAX.
"""

import importlib
import importlib.util
import json
import time
import uuid
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import pothoscomms_tpu_torch as pkg
from pothoscomms_tpu_torch.core import fusion
from pothoscomms_tpu_torch.core.fixtures import CollectorSink, FeederSource
from pothoscomms_tpu_torch.kernels import build as kbuild
from pothoscomms_tpu_torch.kernels import iir_df2t
from pothoscomms_tpu_torch.parallel import chain, compiler, profiling

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
NOTHING = {"builds": {}, "compiled": {}}


def _unique(prefix: str) -> str:
    return prefix + uuid.uuid4().hex[:12]


def _load(name: str):
    path = ROOT / "benchmark" / "configs" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("_build_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    cfg = json.loads(path.with_suffix(".json").read_text())
    return mod, cfg


def _firsts(diff: dict) -> dict:
    """Names built for the first time in ``diff``, with their counts."""
    return {n: r["first_n"] for n, r in diff["builds"].items()
            if r["first_n"]}


# ---------------------------------------------------------------------- #
# the span and the record
# ---------------------------------------------------------------------- #
def test_build_counts_without_a_profiler():
    name = _unique("pc.build.test.")
    snap = profiling.build_record()
    with profiling.build(name):
        time.sleep(0.002)
    diff = profiling.build_record(since=snap)
    assert list(diff["builds"]) == [name]
    row = diff["builds"][name]
    assert row["first_n"] == 1 and row["again_n"] == 0
    assert 0.002 <= row["first_s"] < 1.0 and row["again_s"] == 0
    assert diff["compiled"] == {}


def test_build_under_a_cpu_profiler_is_a_host_event_with_no_device_row():
    name = _unique("pc.build.test.")
    snap = profiling.build_record()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.build(name):
            torch.ones(4).sum()
    events = [e for e in prof.events() if e.name == name]
    assert len(events) == 1
    assert events[0].device_type == DeviceType.CPU
    assert profiling.build_record(since=snap)["builds"][name]["first_n"] == 1


def test_same_name_and_key_twice_is_one_first_build_and_one_rebuild():
    name = _unique("pc.build.test.")
    snap = profiling.build_record()
    for key in ((1, "a"), (1, "a"), (2, "a")):
        with profiling.build(name, key=key):
            pass
    row = profiling.build_record(since=snap)["builds"][name]
    assert (row["first_n"], row["again_n"]) == (2, 1)


def test_a_nested_build_keeps_its_own_seconds():
    outer, inner = _unique("pc.build.test."), _unique("pc.build.test.")
    snap = profiling.build_record()
    t0 = time.perf_counter()
    with profiling.build(outer):
        with profiling.build(inner):
            time.sleep(0.02)
    total = time.perf_counter() - t0
    rows = profiling.build_record(since=snap)["builds"]
    assert rows[inner]["first_s"] >= 0.02
    assert rows[outer]["first_s"] < 0.01
    assert rows[inner]["first_s"] + rows[outer]["first_s"] <= total


def test_first_launch_runs_a_wrappers_first_call_inside_its_span():
    def wrapper(x):
        if not wrapper.launches and wrapper not in profiling.launching:
            return profiling.first_launch(wrapper, x)
        wrapper.launches += 1
        return 2 * x

    wrapper.launches = 0
    wrapper.__name__ = _unique("kernel_")
    name = "pc.build.first_launch." + wrapper.__name__
    snap = profiling.build_record()
    assert [wrapper(i) for i in range(3)] == [0, 2, 4]
    assert wrapper.launches == 3
    rows = profiling.build_record(since=snap)["builds"]
    assert list(rows) == [name]
    assert (rows[name]["first_n"], rows[name]["again_n"]) == (1, 0)
    assert not profiling.launching


def test_identity_is_never_reused():
    a, b = object.__new__(type("A", (), {})), object.__new__(
        type("B", (), {}))
    ia, ib = profiling.identity(a), profiling.identity(b)
    assert ia != ib and profiling.identity(a) == ia
    del a
    assert profiling.identity(object.__new__(type("C", (), {}))) not in (
        ia, ib)


STAND_IN_NVCC = """#!/bin/sh
# a stand-in for nvcc: an empty shared library at the -o path
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; fi
  shift
done
exec cc -shared -fPIC -x c /dev/null -o "$out"
"""


def test_load_records_the_library_and_compiled_only_where_nvcc_ran(
        tmp_path, monkeypatch):
    csrc, out = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    lib = _unique("stand_in_")
    (csrc / f"{lib}.cu").write_text("// no kernel\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(STAND_IN_NVCC)
    nvcc.chmod(0o755)
    monkeypatch.setattr(kbuild, "CSRC", csrc)
    monkeypatch.setattr(kbuild, "BUILD_DIR", out)
    monkeypatch.setattr(kbuild, "find_nvcc", lambda: str(nvcc))
    name = "pc.build.library." + lib
    snap = profiling.build_record()
    kbuild.load(lib)
    kbuild.load(lib)  # the lru_cache: no second span
    diff = profiling.build_record(since=snap)
    assert _firsts(diff) == {name: 1}
    assert diff["builds"][name]["again_n"] == 0
    assert list(diff["compiled"]) == [lib] and diff["compiled"][lib] > 0
    # the library is there now: a load compiles nothing
    snap = profiling.build_record()
    kbuild.load.__wrapped__(lib)
    diff = profiling.build_record(since=snap)
    assert diff["builds"][name]["again_n"] == 1
    assert diff["compiled"] == {}


def test_kernel_modules_keep_the_library_loader_under_its_name():
    """Every kernel module loads its library through ``kernels/build``
    under the name ``build``, which the build span's name must not take
    (the card path, which no CPU test reaches, calls ``build.load``)."""
    import pkgutil

    import pothoscomms_tpu_torch.kernels as kernels

    found = 0
    for info in pkgutil.iter_modules(kernels.__path__):
        mod = importlib.import_module("pothoscomms_tpu_torch.kernels."
                                      + info.name)
        if "build.load(" in Path(mod.__file__).read_text():
            assert mod.build is kbuild, info.name
            found += 1
    assert found >= 10


# ---------------------------------------------------------------------- #
# the builders, and a warm step
# ---------------------------------------------------------------------- #
def _step_adds_nothing(step, *args):
    snap = profiling.build_record()
    out = step(*args)
    assert profiling.build_record(since=snap) == NOTHING
    return out


def test_fir_fft_chain_one_pass_builds_once_and_a_warm_step_adds_nothing():
    rng = np.random.default_rng(5)
    taps = (rng.normal(size=37) + 1j * rng.normal(size=37)) / 37
    snap = profiling.build_record()
    # a block no other test builds, so the shape's build is a first one
    run, carry = chain.fir_fft_chain(taps, 1024, 2, 13 * 1024,
                                     device="cpu")
    assert run.form == "one_pass"
    assert _firsts(profiling.build_record(since=snap)) == {
        "pc.build.fir_fft.one_pass": 1}
    x = torch.randn(2, 13 * 1024, 2)
    _, carry = run(x, carry)
    _step_adds_nothing(run, x, carry)
    # the same shape again, as a re-tune builds it: a rebuild
    snap = profiling.build_record()
    chain.fir_fft_chain(taps[::-1], 1024, 2, 13 * 1024, device="cpu")
    row = profiling.build_record(since=snap)["builds"][
        "pc.build.fir_fft.one_pass"]
    assert (row["first_n"], row["again_n"]) == (0, 1)


def test_fir_fft_chain_polyphase_builds_once_and_a_warm_step_adds_nothing():
    rng = np.random.default_rng(6)
    taps = (rng.normal(size=29) + 1j * rng.normal(size=29)) / 29
    snap = profiling.build_record()
    run, carry = chain.fir_fft_chain(taps, 1024, 2, 7 * 2048, decim=2,
                                     device="cpu")
    assert run.form == "polyphase"
    assert _firsts(profiling.build_record(since=snap)) == {
        "pc.build.fir_fft.polyphase": 1}
    x = torch.randn(2, 7 * 2048, 2)
    _, carry = run(x, carry)
    _step_adds_nothing(run, x, carry)


def test_compile_chain_fm_builds_each_core_and_a_warm_step_adds_nothing():
    mod, cfg = _load("fm_receiver_256ch")
    snap = profiling.build_record()
    step, carry = mod.step_entry(cfg, mod.weights(cfg, 1), 3, 4096,
                                 torch.device("cpu"))
    assert _firsts(profiling.build_record(since=snap)) == {
        "pc.build.core.FreqDemod": 1, "pc.build.core.DCRemoval": 1,
        "pc.build.core.EnvelopeDetector": 1}
    x = torch.randn(3, 4096, 2)
    _, carry = step(x, carry)
    _step_adds_nothing(step, x, carry)


def test_compile_chain_resampler_builds_each_core_and_warm_adds_nothing():
    mod, cfg = _load("resampler_fir99_3to2_ellip6")
    snap = profiling.build_record()
    step, carry = mod.step_entry(cfg, mod.weights(cfg, 1), 3, 4096,
                                 torch.device("cpu"))
    assert _firsts(profiling.build_record(since=snap)) == {
        "pc.build.core.FIRFilter": 1, "pc.build.core.IIRFilter": 1}
    x = torch.randn(3, 4096, 2)
    _, carry = step(x, carry)
    _step_adds_nothing(step, x, carry)


def test_compiling_the_same_blocks_again_is_a_rebuild():
    blocks = [pkg.BlockRegistry.make("/comms/freq_demod", "complex_float32"),
              pkg.BlockRegistry.make("/comms/dc_removal", "float32")]
    snap = profiling.build_record()
    compiler.compile_chain(blocks, 2, device="cpu")
    compiler.compile_chain(blocks, 2, device="cpu")
    rows = profiling.build_record(since=snap)["builds"]
    for name in ("pc.build.core.FreqDemod", "pc.build.core.DCRemoval"):
        assert (rows[name]["first_n"], rows[name]["again_n"]) == (1, 1)


def test_iir_tables_and_stray_build_once_for_their_taps():
    # a low-pass no other test builds: b scaled by a factor of its own
    b = np.array([0.2, 0.3, 0.2]) * (1 + np.random.default_rng().random())
    a = np.array([1.0, -0.5, 0.2])
    snap = profiling.build_record()
    assert iir_df2t.tables(b, a) is not None
    assert _firsts(profiling.build_record(since=snap)) == {
        "pc.build.iir_df2t.tables": 1, "pc.build.iir_df2t.stray": 1}
    _step_adds_nothing(iir_df2t.tables, b, a)


def test_link_receiver_builds_once_and_a_warm_receive_adds_nothing():
    mod, cfg = _load("digital_link_bpsk_4000b")
    cfg["payload_bits"] = 64
    # a window no other test builds: the receiver's key is new
    window = 4096 + 64 + np.random.default_rng().integers(1, 1000)
    snap = profiling.build_record()
    receive = mod.step_entry(cfg, {}, 2, int(window), torch.device("cpu"))
    assert _firsts(profiling.build_record(since=snap)) == {
        "pc.build.link.receiver": 1}
    x = torch.zeros(2, int(window), 2)
    lengths = np.full(2, int(window))
    receive(x, lengths)
    _step_adds_nothing(receive, x, lengths)


def test_topology_first_feed_builds_its_cores_and_warm_feeds_add_nothing(
        monkeypatch):
    """The block API's FIR -> FFT: the first feed engages the pair core
    (the FIR's and FFT's exports, the pair, its chain), the second
    engages again as single cores (a rebuild of both exports), and from
    then on the segment stays engaged and a feed builds nothing."""
    monkeypatch.setattr(fusion, "MAX_QUANTUM", 1 << 16)
    rng = np.random.default_rng(8)
    taps = (rng.normal(size=64) + 1j * rng.normal(size=64)) / 64
    feed = FeederSource("complex_float32")
    fir = pkg.BlockRegistry.make("/comms/fir_filter", "complex_float32",
                                 "COMPLEX")
    fir.set_taps(taps)
    fft = pkg.BlockRegistry.make("/comms/fft", "complex_float32", 1024,
                                 False)
    sink = CollectorSink("complex_float32")
    topo = pkg.Topology(device="cpu")
    topo.fuse_threshold = 4096  # so it engages on small buffers
    for a, b in ((feed, fir), (fir, fft), (fft, sink)):
        topo.connect(a, 0, b, 0)
    fir.input(0).set_capacity(4 << 16)
    fft.input(0).set_capacity(2 << 16)
    sink.input(0).set_capacity(2 << 16)
    topo.commit()
    buf = (rng.normal(size=1 << 16)
           + 1j * rng.normal(size=1 << 16)).astype(np.complex64)

    def fed():
        snap = profiling.build_record()
        feed.feed_buffer(buf)
        assert topo.wait_inactive(timeout=60.0)
        sink.clear()
        return profiling.build_record(since=snap)

    first = fed()
    assert {"pc.build.core.FIRFilter", "pc.build.core.FFTBlock",
            "pc.build.segment.pair"} <= set(_firsts(first))
    assert any(n.startswith("pc.build.fir_fft.") for n in first["builds"])
    second = fed()
    assert _firsts(second) == {}
    assert {n: r["again_n"] for n, r in second["builds"].items()} == {
        "pc.build.core.FIRFilter": 1, "pc.build.core.FFTBlock": 1}
    for _ in range(2):
        assert fed() == NOTHING
