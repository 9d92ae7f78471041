"""kernel_roofline_pct.resampler (%): the resampler stage's share of its
roofline. The least time of the ``resampler`` stage of the work the
profiled steps need (``counts/<config>.py``'s ``stages``; the larger of
its bytes over the card's memory bandwidth and its flops over the dense
TF32 peak, ``peaks.json``) over the device time of every kernel, copy and
set launched inside the rational FIR's core, the program span
``pc.chain.FIRFilter`` (``device_by_span``): its operand, its product and
its carry, whichever kernels run them. None without a trace, the card's
peaks, the ``stages`` key or device time under that span."""

SPAN = "pc.chain.FIRFilter"
STAGE = "resampler"


def read(m: dict):
    tr, peaks, work = m.get("trace"), m.get("peaks"), m.get("work")
    if not tr or not peaks or not work or "stages" not in work:
        return None
    spent = tr.get("device_by_span", {}).get(SPAN, 0.0)
    if spent <= 0:
        return None
    stage = work["stages"][STAGE]
    least = max(stage["bytes"] / peaks["hbm_bytes_per_s"],
                stage["flops"] / peaks["tf32_dense_flops_per_s"])
    return 100.0 * least * tr["steps"] / spent
