"""kernel_roofline_pct.iir (%): the IIR stage's share of its roofline.
The least time of the ``iir`` stage of the work the profiled steps need
(``counts/<config>.py``'s ``stages``; the larger of its bytes over the
card's memory bandwidth and its flops over the dense TF32 peak,
``peaks.json``) over the summed device time of every kernel, copy and set
of those steps but K1's (``kernel_roofline_pct.resampler``): the IIR's
block products, its scan and its layout copies, and also the resampler's
operand ``cat``, which runs outside K1. None without a trace, the card's
peaks, the ``stages`` key or a K1 row."""

import importlib.util
from pathlib import Path


def _resampler_reader():
    path = Path(__file__).with_name("kernel_roofline_pct.resampler.py")
    spec = importlib.util.spec_from_file_location(
        "_kernel_roofline_pct_resampler_reader", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


k1_seconds = _resampler_reader().k1_seconds


def read(m: dict):
    tr, peaks, work = m.get("trace"), m.get("peaks"), m.get("work")
    if not tr or not peaks or not work or "stages" not in work:
        return None
    k1 = k1_seconds(tr)
    rest = tr.get("kernel_s", 0.0) - k1
    if k1 <= 0 or rest <= 0:
        return None
    stage = work["stages"]["iir"]
    least = max(stage["bytes"] / peaks["hbm_bytes_per_s"],
                stage["flops"] / peaks["tf32_dense_flops_per_s"])
    return 100.0 * least * tr["steps"] / rest
