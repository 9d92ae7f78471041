"""kernel_roofline_pct.fft (%): the FFT stage's share of its roofline. The
least time of the ``fft`` stage of the work the profiled steps need
(``counts/<config>.py``'s ``stages``; the larger of its bytes over the
card's memory bandwidth and its flops over the dense TF32 peak,
``peaks.json``) over the summed device time of K2, the port's FFT kernel:
the trace's device operations whose name holds one of K2's kernel names
(``csrc/fft.cu``). None without a trace, the card's peaks, the
``stages`` key or a K2 row."""

K2_KERNELS = ("stockham_kernel", "dft_kernel")


def k2_seconds(trace: dict) -> float:
    """The summed device time of the trace's K2 rows."""
    return sum(s for name, s in trace.get("device_ops", [])
               if any(k in name for k in K2_KERNELS))


def read(m: dict):
    tr, peaks, work = m.get("trace"), m.get("peaks"), m.get("work")
    if not tr or not peaks or not work or "stages" not in work:
        return None
    k2 = k2_seconds(tr)
    if k2 <= 0:
        return None
    stage = work["stages"]["fft"]
    least = max(stage["bytes"] / peaks["hbm_bytes_per_s"],
                stage["flops"] / peaks["tf32_dense_flops_per_s"])
    return 100.0 * least * tr["steps"] / k2
