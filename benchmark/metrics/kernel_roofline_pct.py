"""kernel_roofline_pct (%): the least time of the work the profiled steps
need (``counts/<config>.py``: the larger of its bytes over the card's
memory bandwidth and its flops over the dense TF32 peak, ``peaks.json``)
over the summed device time of every kernel, copy and set those steps
launched. None without a trace, a device event or the card's peaks."""


def read(m: dict):
    tr, peaks, work = m.get("trace"), m.get("peaks"), m.get("work")
    if not tr or not peaks or not work or not tr.get("kernel_s"):
        return None
    least = max(work["bytes"] / peaks["hbm_bytes_per_s"],
                work["flops"] / peaks["tf32_dense_flops_per_s"])
    return 100.0 * least * tr["steps"] / tr["kernel_s"]
