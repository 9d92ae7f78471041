"""entry.enqueue_ms (ms): the mean host time for a step call to return,
over every step of the traced run's window without the profiler."""


def read(m: dict):
    enq = m.get("enqueue_s")
    if not enq:
        return None
    return sum(enq) / len(enq) * 1e3
