"""step_p95 (ms): the nearest-rank 95th percentile of every step's latency
in the measured window, from the host's call of the step to the host
seeing its completion event."""

from benchmark.harness import percentile


def read(m: dict):
    lat = m.get("latencies_s")
    if not lat:
        return None
    return percentile(lat, 95) * 1e3
