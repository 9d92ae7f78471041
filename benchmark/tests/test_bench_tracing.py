"""The traced sub-window beside the program's own spans.

The program records spans (``pothoscomms_tpu_torch.parallel.profiling.
annotate``, names ``pc.*``) whenever a profiler runs, so they are inside
every ``--trace 1`` window. These tests pin what the harness makes of a
window: ``summarize_trace`` reads a fixed event list as it always has
(the golden below was written from the accepted harness) and charges
idle and device time to the program's spans on a window that holds them
(a golden worked out by hand); ``trace_events`` finds the spans open
at each device event's launch; the readers of the idle shares add up to
``device_idle_pct``; a program span names the gap it holds; and on a card
no program span has a device-side row that ``busy_s``, ``kernel_s`` or
``device_ops`` could count, and the one-pass chain's span claims every
kernel of its steps."""

import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import harness
from pothoscomms_tpu_torch.parallel import profiling

BENCH = harness.BENCH_DIR

EVENTS = [
    ("host", "window", 100.0, 1100.0),
    ("device", "k1", 50.0, 150.0),
    ("device", "k1", 200.0, 300.0),
    ("device", "memcpy", 290.0, 420.0),
    ("device", "k2", 600.0, 640.0),
    ("device", "k2", 900.0, 1050.0),
    ("device", "late", 1090.0, 1200.0),
    ("device", "outside", 1300.0, 1400.0),
    ("host", "step call", 140.0, 460.0),
    ("host", "sync wait", 430.0, 700.0),
    ("host", "feed", 700.0, 760.0),
    ("host", "wait_inactive", 760.0, 1000.0),
    ("host", "step call", 800.0, 850.0),
]

GOLDEN = {
    "busy_s": 0.00047, "window_s": 0.001,
    "kernel_s": 0.00047999999999999996, "steps": 7,
    "device_ops": [["k2", 0.00018999999999999998], ["k1", 0.00015],
                   ["memcpy", 0.00013], ["late", 9.999999999999999e-06]],
    "idle_gaps": [["wait_inactive", 0.00026],
                  ["sync wait", 0.00017999999999999998],
                  ["step call", 4.9999999999999996e-05],
                  ["host other", 3.9999999999999996e-05]],
}

# the same window's idle, charged exactly (by hand, in microseconds):
# [150, 200] step call; [420, 430] step call, [430, 600] sync wait (the
# shorter of the two open); [640, 700] sync wait, [700, 760] feed,
# [760, 800] wait_inactive, [800, 850] step call, [850, 900]
# wait_inactive; [1050, 1090] nothing open. No program span: the roots
# are the same spans.
IDLE_BY_SPAN = {"sync wait": 230, "step call": 110, "wait_inactive": 90,
                "feed": 60, "host other": 40}

# a window with nested program spans and device events linked to them
EVENTS_PC = [
    ("host", "window", 0.0, 1000.0),
    ("host", "step call", 0.0, 600.0),
    ("host", "pc.chain.A", 10.0, 500.0),
    ("host", "pc.op.x", 20.0, 100.0),
    ("host", "pc.kernel.k", 150.0, 300.0),
    ("host", "sync wait", 600.0, 900.0),
    ("host", "pc.topology.round", 650.0, 800.0),
    ("device", "d5", -50.0, 30.0, ("pc.chain.A",)),
    ("device", "d1", 50.0, 120.0, ("pc.chain.A", "pc.op.x")),
    ("device", "d2", 200.0, 400.0, ("pc.chain.A", "pc.kernel.k")),
    ("device", "d3", 700.0, 750.0, ("pc.topology.round",)),
    ("device", "d4", 950.0, 980.0, ()),
]

# worked out by hand, in microseconds. Busy [0, 30], [50, 120], [200,
# 400], [700, 750], [950, 980]; idle [30, 50] (innermost pc.op.x, root
# pc.chain.A), [120, 150] (A, A), [150, 200] (pc.kernel.k, A), [400, 500]
# (A, A), [500, 600] (step call), [600, 650] (sync wait), [650, 700] and
# [750, 800] (pc.topology.round, itself), [800, 900] (sync wait), [900,
# 950] and [980, 1000] (host other).
GOLDEN_PC = {
    "busy_s": 380, "window_s": 1000, "kernel_s": 380,
    "device_ops": [["d2", 200], ["d1", 70], ["d3", 50], ["d5", 30],
                   ["d4", 30]],
    "idle_gaps": [["step call", 300], ["sync wait", 200],
                  ["pc.kernel.k", 80], ["pc.op.x", 20], ["host other", 20]],
    "idle_by_span": {"sync wait": 150, "pc.chain.A": 130, "step call": 100,
                     "pc.topology.round": 100, "host other": 70,
                     "pc.kernel.k": 50, "pc.op.x": 20},
    "idle_by_root": {"pc.chain.A": 200, "sync wait": 150, "step call": 100,
                     "pc.topology.round": 100, "host other": 70},
    "device_by_span": {"pc.chain.A": 300, "pc.kernel.k": 200,
                       "pc.op.x": 70, "pc.topology.round": 50},
    "device_unclaimed_s": 30,
    "program_spans": {"pc.chain.A": 1, "pc.op.x": 1, "pc.kernel.k": 1,
                      "pc.topology.round": 1},
}


def seconds(us):
    """Microseconds (a number, a dict of them, gaps or ops) as seconds."""
    if isinstance(us, dict):
        return {k: pytest.approx(v * 1e-6, rel=1e-12) for k, v in us.items()}
    if isinstance(us, list):
        return [[n, pytest.approx(v * 1e-6, rel=1e-12)] for n, v in us]
    return pytest.approx(us * 1e-6, rel=1e-12)


def test_summary_of_a_fixed_window_is_the_golden():
    got = harness.summarize_trace(EVENTS, 7)
    assert {k: got[k] for k in GOLDEN} == GOLDEN
    assert got["idle_by_span"] == seconds(IDLE_BY_SPAN)
    assert got["idle_by_root"] == seconds(IDLE_BY_SPAN)
    assert list(got["idle_by_span"]) == list(IDLE_BY_SPAN)  # most first
    assert got["device_by_span"] == {} and got["program_spans"] == {}
    assert got["device_unclaimed_s"] == got["kernel_s"]


def test_summary_charges_the_program_spans():
    got = harness.summarize_trace(EVENTS_PC, 3)
    assert got["steps"] == 3 and got["program_spans"] == \
        GOLDEN_PC["program_spans"]
    for k in ("busy_s", "window_s", "kernel_s", "device_unclaimed_s"):
        assert got[k] == seconds(GOLDEN_PC[k]), k
    for k in ("device_ops", "idle_gaps", "idle_by_span", "idle_by_root",
              "device_by_span"):
        assert got[k] == seconds(GOLDEN_PC[k]), k
    idle = got["window_s"] - got["busy_s"]
    for k in ("idle_by_span", "idle_by_root"):  # each instant once
        assert sum(got[k].values()) == pytest.approx(idle, rel=1e-12)


# ---------------------------------------------------------------------- #
# the spans that launched each device event
# ---------------------------------------------------------------------- #
HOST, CARD = "host", "card"


def fev(name, a, b, id=0, link=0, device=HOST):
    """A stand-in for one of the profiler's FunctionEvents."""
    return SimpleNamespace(name=name, device_type=device, id=id,
                           linked_correlation_id=link,
                           time_range=SimpleNamespace(start=a, end=b))


@pytest.mark.parametrize("linked", [True, False])
def test_device_events_find_the_spans_that_launched_them(linked):
    """A device event is claimed by the program spans open at the start of
    its runtime call, found by the device event's id; a link to an op
    (where the profiler gives one) plays no part. ``linked`` False is a
    profiler whose events carry no ``linked_correlation_id``: the runtime
    calls are then found by name."""
    window = fev("window", 0, 1000, id=1)
    chain = fev("pc.chain.A", 10, 500, id=2)
    op = fev("pc.op.x", 20, 100, id=3)
    cat = fev("aten::cat", 30, 60, id=4)
    kern = fev("pc.kernel.k", 150, 300, id=5)
    round_ = fev("pc.topology.round", 600, 800, id=6)
    own = fev("aten::copy_", 850, 860, id=7)
    fevents = [
        window, chain, op, cat, kern, round_, own,
        # runtime calls: the ids of their device rows
        fev("cudaLaunchKernel", 40, 45, id=101, link=4),
        fev("cuLaunchKernel", 160, 170, id=102, link=5),
        fev("cudaLaunchKernel", 650, 655, id=103),
        fev("cudaMemcpyAsync", 852, 855, id=104, link=7),
        # a link to an op that was not open at the launch: not the launcher
        fev("cudaLaunchKernel", 720, 721, id=105, link=4),
        # device rows
        fev("cat_kernel", 50, 80, id=101, link=4, device=CARD),
        fev("k_kernel", 200, 400, id=102, link=5, device=CARD),
        fev("round_kernel", 700, 750, id=103, device=CARD),
        fev("stray_kernel", 760, 770, id=105, link=4, device=CARD),
        fev("Memcpy DtoH", 870, 880, id=104, link=7, device=CARD),
        fev("lost_kernel", 900, 910, id=106, device=CARD),
        fev("window", 0, 1000, id=1, device=CARD),
        fev("spin_kernel", 990, 995, id=107, device=CARD),
    ]
    if not linked:
        for ev in fevents:
            del ev.linked_correlation_id
    events, unclaimed = harness.trace_events(fevents, CARD)
    dev = {e[1]: e[4] for e in events if e[0] == "device"}
    assert dev == {"cat_kernel": ("pc.chain.A", "pc.op.x"),
                   "k_kernel": ("pc.chain.A", "pc.kernel.k"),
                   "round_kernel": ("pc.topology.round",),
                   "stray_kernel": ("pc.topology.round",),
                   "Memcpy DtoH": (), "lost_kernel": ()}
    assert unclaimed == 2
    hosts = sorted(e[1] for e in events if e[0] == "host")
    assert hosts == ["pc.chain.A", "pc.kernel.k", "pc.op.x",
                     "pc.topology.round", "window"]


def test_program_spans_name_the_gap_on_cpu():
    """A window whose host time is spent inside program spans, inside the
    benchmark's own span: the gap takes the innermost program span's name,
    and its idle goes to the outermost program span."""
    dev = torch.device("cpu")

    def loop():
        with harness.span("feed"):
            with profiling.annotate("pc.segment.pull"):
                with profiling.annotate("pc.kernel.cgemm"):
                    time.sleep(0.002)
        return 1

    tr = harness.profiled(loop, dev)
    assert tr["busy_s"] == 0 and tr["device_ops"] == []
    assert [g[0] for g in tr["idle_gaps"]] == ["pc.kernel.cgemm"]
    assert next(iter(tr["idle_by_root"])) == "pc.segment.pull"
    assert next(iter(tr["idle_by_span"])) == "pc.kernel.cgemm"
    assert "pc.kernel.cgemm" not in tr["idle_by_root"]
    assert tr["program_spans"] == {"pc.segment.pull": 1,
                                   "pc.kernel.cgemm": 1}


# ---------------------------------------------------------------------- #
# the readers of the idle shares
# ---------------------------------------------------------------------- #
IDLE_READERS = {"entry.idle_pct": ("pc.chain.", "pc.fir_fft.", "pc.op.",
                                   "pc.kernel."),
                "runtime.idle_pct.host_paced": ("pc.topology.",
                                                "pc.segment.", "pc.block."),
                "link.idle_pct": ("pc.link.",)}


def reader(name):
    return harness.load_module(harness.reader_path(BENCH, name))


def summary():
    """A hand-made summary: 1 s window, 0.4 s busy, the 0.6 s of idle
    charged to each kind of root."""
    return {"busy_s": 0.4, "window_s": 1.0, "kernel_s": 0.4, "steps": 10,
            "idle_by_root": {"pc.chain.FIRFilter": 0.05,
                             "pc.fir_fft.one_pass": 0.04, "pc.op.y": 0.03,
                             "pc.kernel.z": 0.02,
                             "pc.topology.round": 0.12,
                             "pc.segment.pull": 0.01, "pc.block.Sink": 0.02,
                             "pc.link.receive": 0.15, "step call": 0.07,
                             "sync wait": 0.05, "host other": 0.04},
            "program_spans": {"pc.chain.FIRFilter": 10}}


def test_idle_readers_on_a_hand_made_summary():
    m = {"trace": summary()}
    got = {n: reader(n).read(m) for n in IDLE_READERS}
    assert got == {"entry.idle_pct": pytest.approx(14.0),
                   "runtime.idle_pct.host_paced": pytest.approx(15.0),
                   "link.idle_pct": pytest.approx(15.0)}
    assert reader("entry.idle_pct.host_paced").read(m) == \
        pytest.approx(14.0)
    # with the benchmark spans' share and "host other", device_idle_pct
    rest = 100.0 * (0.07 + 0.05 + 0.04)
    idle = reader("device_idle_pct").read(m)
    assert sum(got.values()) + rest == pytest.approx(idle, rel=1e-12)


def test_idle_readers_on_the_golden_window_add_up():
    m = {"trace": harness.summarize_trace(EVENTS_PC, 3)}
    got = {n: reader(n).read(m) for n in IDLE_READERS}
    assert got == {"entry.idle_pct": pytest.approx(20.0),
                   "runtime.idle_pct.host_paced": pytest.approx(10.0),
                   "link.idle_pct": 0.0}
    bench = sum(v for n, v in m["trace"]["idle_by_root"].items()
                if not n.startswith("pc."))
    assert sum(got.values()) + 100.0 * bench / m["trace"]["window_s"] == \
        pytest.approx(reader("device_idle_pct").read(m), rel=1e-12)


@pytest.mark.parametrize("name", sorted(IDLE_READERS))
def test_idle_readers_find_nothing_to_read(name):
    read = reader(name).read
    assert read({}) is None
    assert read({"trace": {}}) is None
    no_program = dict(summary(), program_spans={})
    assert read({"trace": no_program}) is None
    no_device = dict(summary(), busy_s=0.0, kernel_s=0.0)
    assert read({"trace": no_device}) is None
    # the window without a program span: the old keys alone
    assert read({"trace": harness.summarize_trace(EVENTS, 7)}) is None


# ---------------------------------------------------------------------- #
# on a card
# ---------------------------------------------------------------------- #
@pytest.mark.cuda
def test_program_spans_have_no_device_rows_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from pothoscomms_tpu_torch.kernels import fir_fft_fused
    from pothoscomms_tpu_torch.parallel.chain import fir_fft_chain

    dev = torch.device("cuda", 0)
    run, carry = fir_fft_chain(np.ones(64) / 64, 1024, 8, 1 << 14)
    x = torch.randn(8, 1 << 14, 2, device=dev)
    run(x, carry)
    harness.sync(dev)
    before = fir_fft_fused.fir_fft_fused.launches

    def loop():
        for _ in range(4):
            run(x, carry)
        return 4

    tr = harness.profiled(loop, dev)
    assert fir_fft_fused.fir_fft_fused.launches - before == 4
    names = [n for n, _ in tr["device_ops"]]
    assert any("fir_fft_fused" in n for n in names)
    assert not [n for n in names if n.startswith("pc.")]
    assert 0 < tr["busy_s"] <= tr["window_s"]
    assert tr["busy_s"] <= tr["kernel_s"] + 1e-12
    # the chain's span is a host event, and it launched every kernel
    assert tr["program_spans"]["pc.fir_fft.one_pass"] == 4
    assert tr["device_by_span"]["pc.fir_fft.one_pass"] == pytest.approx(
        tr["kernel_s"], rel=1e-9)
    assert tr["device_unclaimed_s"] == 0
