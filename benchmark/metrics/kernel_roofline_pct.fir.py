"""kernel_roofline_pct.fir (%): the FIR stage's share of its roofline. The
least time of the ``fir`` stage of the work the profiled steps need
(``counts/<config>.py``'s ``stages``; the larger of its bytes over the
card's memory bandwidth and its flops over the dense TF32 peak,
``peaks.json``) over the summed device time of every kernel, copy and set
of those steps but K2's (``kernel_roofline_pct.fft``): the FIR's copies,
its convolution and the carry. None without a trace, the card's peaks,
the ``stages`` key or a K2 row."""

import importlib.util
from pathlib import Path


def _fft_reader():
    path = Path(__file__).with_name("kernel_roofline_pct.fft.py")
    spec = importlib.util.spec_from_file_location(
        "_kernel_roofline_pct_fft_reader", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


k2_seconds = _fft_reader().k2_seconds


def read(m: dict):
    tr, peaks, work = m.get("trace"), m.get("peaks"), m.get("work")
    if not tr or not peaks or not work or "stages" not in work:
        return None
    k2 = k2_seconds(tr)
    rest = tr.get("kernel_s", 0.0) - k2
    if k2 <= 0 or rest <= 0:
        return None
    stage = work["stages"]["fir"]
    least = max(stage["bytes"] / peaks["hbm_bytes_per_s"],
                stage["flops"] / peaks["tf32_dense_flops_per_s"])
    return 100.0 * least * tr["steps"] / rest
