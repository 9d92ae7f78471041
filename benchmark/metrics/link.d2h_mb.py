"""link.d2h_mb (MB): the bytes the receiver copied from the card to the
host a step (the program's counter ``link.d2h_bytes`` gained over the
measured window, over its steps), in 1e6 bytes. None where the program
has no such counter."""


def read(m: dict):
    c = m.get("counters")
    if not c or c.get("d2h_bytes") is None or not m.get("steps"):
        return None
    return c["d2h_bytes"] / m["steps"] / 1e6
