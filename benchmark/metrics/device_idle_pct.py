"""device_idle_pct (%): the share of the profiled sub-window in which no
kernel, copy or set runs on the card. None when the trace holds no
device event."""


def read(m: dict):
    tr = m.get("trace")
    if not tr or not tr.get("busy_s") or not tr.get("window_s"):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
