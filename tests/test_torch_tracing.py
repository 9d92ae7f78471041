"""The port's spans and window counters.

``profiling.annotate`` is the program's one span function: a shared no-op
while no profiler runs, a host range on the profiler's timeline while one
does. These tests hold the off path to building nothing, the spans of the
block runtime, the chain entries and the kernel wrappers to their names
and their nesting, and ``FusedSegment``'s ``h2d_bytes`` and
``pull_time_s`` to what a pull moves. The file imports no JAX; its card
tests run on a card with

    python -m pytest tests/test_torch_tracing.py --noconftest -q
"""

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

import pothoscomms_tpu_torch as pkg
from pothoscomms_tpu_torch.core import fixtures as fix
from pothoscomms_tpu_torch.parallel import chain, compiler, profiling

torch.set_num_threads(1)

THRESH = 4096  # low threshold so the topology engages on small data


def host_spans(prof, prefix="pc."):
    """(name, start, end) of the host events whose name starts with
    ``prefix``, in start order."""
    out = [(e.name, e.time_range.start, e.time_range.end)
           for e in prof.events()
           if e.device_type == DeviceType.CPU and e.name.startswith(prefix)]
    return sorted(out, key=lambda s: s[1])


def inside(spans, outer, name=None):
    """The spans strictly within ``outer``'s range (``name``: only those)."""
    _, a, b = outer
    return [s for s in spans if s is not outer and a <= s[1] and s[2] <= b
            and (name is None or s[0] == name)]


def fir_fft_topology(n, dtype="complex_float32", nb=256, k=17):
    """FeederSource -> FIR -> FFT -> CollectorSink on the CPU, ``n``
    samples queued; returns (topology, sink)."""
    rng = np.random.default_rng(3)
    feed = fix.FeederSource(dtype)
    fir = pkg.BlockRegistry.make("/comms/fir_filter", dtype, "COMPLEX")
    fir.set_taps((rng.normal(size=k) + 1j * rng.normal(size=k)) / k)
    fft = pkg.BlockRegistry.make("/comms/fft", dtype, nb, False)
    sink = fix.CollectorSink(dtype)
    topo = pkg.Topology(device="cpu")
    topo.fuse_threshold = THRESH
    for a, b in zip([feed, fir, fft], [fir, fft, sink]):
        topo.connect(a, 0, b, 0)
    x = rng.normal(size=n) + 1j * rng.normal(size=n)
    feed.feed_buffer(x.astype(np.complex64))
    topo.commit()
    return topo, sink


def fm_blocks():
    demod = pkg.BlockRegistry.make("/comms/freq_demod", "complex_float32")
    dc = pkg.BlockRegistry.make("/comms/dc_removal", "float32")
    env = pkg.BlockRegistry.make("/comms/envelope_detector", "float32")
    return [demod, dc, env]


# ------------------------------------------------------------------ #
# the gate
# ------------------------------------------------------------------ #
def _refuse(*args, **kwargs):
    raise AssertionError("a span was built with no profiler running")


def test_annotate_off_is_one_shared_noop(monkeypatch):
    monkeypatch.setattr(profiling, "_RecordFunctionFast", _refuse)
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    a, b = profiling.annotate("pc.a"), profiling.annotate("pc.b")
    assert a is b
    with a, profiling.annotate("pc.c"):
        pass


def test_topology_off_builds_no_span(monkeypatch):
    """A whole engaged run with no profiler never builds a range."""
    monkeypatch.setattr(profiling, "_RecordFunctionFast", _refuse)
    topo, sink = fir_fft_topology(4 * THRESH)
    assert topo.wait_inactive(timeout=30.0)
    assert topo._segments[0].engage_count >= 1
    assert len(sink.get_buffer()) > 0


def test_annotate_on_is_a_host_range_at_function_scope():
    """Under the profiler a span is a host range of its name, recorded at
    another scope than ``record_function``'s user scope (the scope whose
    ranges the profiler mirrors on the device timeline)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.annotate("pc.test.span"):
            torch.ones(4).add_(1)
        with record_function("user.range"):
            pass
    ev = {e.name: e for e in prof.events()}
    span, user = ev["pc.test.span"], ev["user.range"]
    assert span.device_type == DeviceType.CPU
    assert span.time_range.end > span.time_range.start
    assert span.scope != user.scope
    assert not profiling._autograd_profiler._is_profiler_enabled


# ------------------------------------------------------------------ #
# the spans
# ------------------------------------------------------------------ #
def test_topology_spans_nest_round_work_pull_step_post(tmp_path):
    topo, _ = fir_fft_topology(4 * THRESH)
    with profiling.trace(str(tmp_path)) as prof:
        assert topo.wait_inactive(timeout=30.0)
    spans = host_spans(prof)
    names = {s[0] for s in spans}
    assert {"pc.topology.round", "pc.segment.engage", "pc.segment.work",
            "pc.segment.disengage", "pc.block.FeederSource",
            "pc.block.CollectorSink"} <= names
    works = [s for s in spans if s[0] == "pc.segment.work"]
    quanta = 0
    for work in works:
        assert [s for s in spans if s[0] == "pc.topology.round"
                and work in inside(spans, s)]
        pulls = inside(spans, work, "pc.segment.pull")
        steps = inside(spans, work, "pc.segment.step")
        posts = inside(spans, work, "pc.segment.post")
        assert len(pulls) == len(steps) == len(posts) <= 1
        if not pulls:
            continue  # a call that pulled nothing (the drain's disengage)
        quanta += 1
        assert pulls[0][2] <= steps[0][1] and steps[0][2] <= posts[0][1]
        within = inside(spans, steps[0])
        assert [c[0] for c in within] == ["pc.chain.FIRFilter+FFTBlock",
                                          "pc.fir_fft.combined",
                                          "pc.op.combined_operand"]
        assert inside(spans, within[0]) == within[1:]
    assert quanta >= 1


@pytest.mark.parametrize("T,spans", [
    # DC removal's default average (512) fits F1 at T = 512: one core
    (512, ["pc.chain.FreqDemod+DCRemoval", "pc.chain.EnvelopeDetector"]),
    # below the average the two single cores run
    (256, ["pc.chain.FreqDemod", "pc.chain.DCRemoval",
           "pc.chain.EnvelopeDetector"])])
def test_fm_compile_chain_spans_in_order(T, spans):
    step, carry = compiler.compile_chain(fm_blocks(), 2, device="cpu")
    x = torch.randn(2, T, 2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(x, carry)
    assert [s[0] for s in host_spans(prof, "pc.chain.")] == spans


@pytest.mark.parametrize("nb,form,operand", [
    (64, "combined", "combined_operand"),
    (1024, "one_pass", "correction_operand")])
def test_fir_fft_chain_span_holds_the_operand_span(nb, form, operand):
    run, carry = chain.fir_fft_chain(np.ones(4) / 4, nb, 2, 4 * nb,
                                     device="cpu")
    assert run.form == form
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run(torch.zeros(2, 4 * nb, 2), carry)
    spans = host_spans(prof)
    assert [s[0] for s in spans] == ["pc.fir_fft." + form, "pc.op." + operand]
    assert inside(spans, spans[0]) == [spans[1]]


# ------------------------------------------------------------------ #
# the counters
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("n", [4 * THRESH, 5 * THRESH + 777])
def test_h2d_bytes_counts_eight_bytes_a_complex_sample_pulled(n):
    topo, _ = fir_fft_topology(n)
    seg = topo._segments[0]
    assert (seg.h2d_bytes, seg.pull_time_s) == (0, 0.0)
    assert topo.wait_inactive(timeout=30.0)
    assert seg.fused_elements > 0
    assert seg.h2d_bytes == 8 * seg.fused_elements
    assert seg.pull_time_s > 0.0


# ------------------------------------------------------------------ #
# on a card
# ------------------------------------------------------------------ #
@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card (the kernels have no CPU mode)")
def test_card_fir_fft_chain_step_records_the_k1_span_host_side_only():
    """K = 66 at 1024 bins: past the one-pass step's K - 1 <= 64, so the
    chain keeps the combined form on K1."""
    run, carry = chain.fir_fft_chain(np.ones(66) / 66, 1024, 4, 8192)
    assert run.form == "combined"
    x = torch.randn(4, 8192, 2, device="cuda")
    run(x, carry)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(x, carry)
        torch.cuda.synchronize()
    spans = host_spans(prof)
    outer = [s for s in spans if s[0] == "pc.fir_fft.combined"]
    assert len(outer) == 1
    assert [s[0] for s in inside(spans, outer[0], "pc.kernel.cgemm")] == [
        "pc.kernel.cgemm"]
    device = [e.name for e in prof.events()
              if e.device_type == DeviceType.CUDA]
    assert any("cgemm" in n for n in device)
    assert not [n for n in device if n.startswith("pc.")]


@pytest.mark.cuda
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card (the kernels have no CPU mode)")
def test_card_fir_fft_chain_step_records_the_k3_span_host_side_only():
    run, carry = chain.fir_fft_chain(np.ones(64) / 64, 1024, 4, 8192)
    assert run.form == "one_pass"
    x = torch.randn(4, 8192, 2, device="cuda")
    run(x, carry)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(x, carry)
        torch.cuda.synchronize()
    spans = host_spans(prof)
    outer = [s for s in spans if s[0] == "pc.fir_fft.one_pass"]
    assert len(outer) == 1
    assert [s[0] for s in inside(spans, outer[0])] == [
        "pc.op.correction_operand", "pc.kernel.fir_fft_fused"]
    device = [e.name for e in prof.events()
              if e.device_type == DeviceType.CUDA]
    assert any("fir_fft_fused" in n for n in device)
    assert not any("cgemm" in n for n in device)
    assert not [n for n in device if n.startswith("pc.")]
