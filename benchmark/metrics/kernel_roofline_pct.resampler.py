"""kernel_roofline_pct.resampler (%): the resampler stage's share of its
roofline. The least time of the ``resampler`` stage of the work the
profiled steps need (``counts/<config>.py``'s ``stages``; the larger of
its bytes over the card's memory bandwidth and its flops over the dense
TF32 peak, ``peaks.json``) over the summed device time of K1, the port's
complex product kernel: the trace's device operations whose name holds
one of K1's kernel names (``csrc/cgemm.cu``: the two product variants and
the operator's hi/lo split). None without a trace, the card's peaks, the
``stages`` key or a K1 row.

The split is by K1's kernel names, not by stage: a kernel that takes the
resampler off K1 must be named in ``K1_KERNELS``, or both stage readers
keyed on the ``pc.chain.FIRFilter`` / ``pc.chain.IIRFilter`` spans once
the harness keeps them."""

K1_KERNELS = ("cgemm_kernel", "cgemm_tc_kernel", "tf32_operator_kernel")


def k1_seconds(trace: dict) -> float:
    """The summed device time of the trace's K1 rows."""
    return sum(s for name, s in trace.get("device_ops", [])
               if any(k in name for k in K1_KERNELS))


def read(m: dict):
    tr, peaks, work = m.get("trace"), m.get("peaks"), m.get("work")
    if not tr or not peaks or not work or "stages" not in work:
        return None
    k1 = k1_seconds(tr)
    if k1 <= 0:
        return None
    stage = work["stages"]["resampler"]
    least = max(stage["bytes"] / peaks["hbm_bytes_per_s"],
                stage["flops"] / peaks["tf32_dense_flops_per_s"])
    return 100.0 * least * tr["steps"] / k1
