"""runtime.fused_pct (%): the samples the block API's engaged segments
processed (``FusedSegment.fused_elements`` gained) over the samples fed,
in the traced run's window without the profiler."""


def read(m: dict):
    c = m.get("counters")
    if not c or not c.get("fed_samples"):
        return None
    return 100.0 * c["fused_elements"] / c["fed_samples"]
