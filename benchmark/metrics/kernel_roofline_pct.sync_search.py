"""kernel_roofline_pct.sync_search (%): the frame search's share of its
roofline. The least time of the ``sync_search`` stage of the work the
profiled steps need (``counts/<config>.py``'s ``stages``; the larger of
its bytes over the card's memory bandwidth and its flops over the dense
TF32 peak, ``peaks.json``) over the summed device time of S1, the port's
search kernel: the trace's device operations whose name holds
``sync_search_kernel`` (``csrc/sync_search.cu``). None without a trace,
the card's peaks, the ``stages`` key or an S1 row."""

S1_KERNELS = ("sync_search_kernel",)


def read(m: dict):
    tr, peaks, work = m.get("trace"), m.get("peaks"), m.get("work")
    if not tr or not peaks or not work or "sync_search" not in work.get(
            "stages", {}):
        return None
    s1 = sum(s for name, s in tr.get("device_ops", [])
             if any(k in name for k in S1_KERNELS))
    if s1 <= 0:
        return None
    stage = work["stages"]["sync_search"]
    least = max(stage["bytes"] / peaks["hbm_bytes_per_s"],
                stage["flops"] / peaks["tf32_dense_flops_per_s"])
    return 100.0 * least * tr["steps"] / s1
