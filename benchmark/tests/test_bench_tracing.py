"""The traced sub-window beside the program's own spans.

The program records spans (``pothoscomms_tpu_torch.parallel.profiling.
annotate``, names ``pc.*``) whenever a profiler runs, so they are inside
every ``--trace 1`` window. These tests pin what the harness makes of a
window: ``summarize_trace`` reads a fixed event list as it always has
(the golden below was written from the accepted harness), a program span
names no idle gap, and on a card no program span has a device-side row
that ``busy_s``, ``kernel_s`` or ``device_ops`` could count."""

import time

import numpy as np
import pytest
import torch

from benchmark import harness
from pothoscomms_tpu_torch.parallel import profiling

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


def test_summary_of_a_fixed_window_is_the_golden():
    assert harness.summarize_trace(EVENTS, 7) == GOLDEN


def test_program_spans_name_no_gap_on_cpu():
    """A window whose host time is spent inside program spans, inside the
    benchmark's own span: the gap keeps the benchmark's name."""
    dev = torch.device("cpu")

    def loop():
        with harness.span("feed"):
            with profiling.annotate("pc.segment.pull"):
                with profiling.annotate("pc.kernel.cgemm"):
                    time.sleep(0.002)
        return 1

    tr = harness.profiled(loop, dev)
    assert tr["busy_s"] == 0 and tr["device_ops"] == []
    assert [g[0] for g in tr["idle_gaps"]] == ["feed"]


@pytest.mark.cuda
def test_program_spans_have_no_device_rows_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from pothoscomms_tpu_torch.kernels import cgemm
    from pothoscomms_tpu_torch.parallel.chain import fir_fft_chain

    dev = torch.device("cuda", 0)
    run, carry = fir_fft_chain(np.ones(64) / 64, 1024, 8, 1 << 14)
    x = torch.randn(8, 1 << 14, 2, device=dev)
    run(x, carry)
    harness.sync(dev)
    before = cgemm.cgemm.launches

    def loop():
        for _ in range(4):
            run(x, carry)
        return 4

    tr = harness.profiled(loop, dev)
    assert cgemm.cgemm.launches - before == 4
    names = [n for n, _ in tr["device_ops"]]
    assert any("cgemm" in n for n in names)
    assert not [n for n in names if n.startswith("pc.")]
    assert 0 < tr["busy_s"] <= tr["window_s"]
    assert tr["busy_s"] <= tr["kernel_s"] + 1e-12
