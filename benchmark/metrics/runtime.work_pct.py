"""runtime.work_pct (%): the blocks' work time (``query_stats()``'s
``work_time_s`` gained, summed over blocks) over the wall time of the
traced run's window without the profiler; the rest is the scheduler's
own loop and the feeding."""


def read(m: dict):
    c = m.get("counters")
    if not c or not c.get("window_s"):
        return None
    return 100.0 * c["work_time_s"] / c["window_s"]
