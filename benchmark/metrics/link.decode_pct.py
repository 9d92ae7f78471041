"""link.decode_pct (%): the receiver's host seconds from the search's
copies to the frames (the program's counter ``link.decode_s``: the
automaton, the header, the slicer and the descrambler) gained over the
measured window, over the window's length. None where the program has no
such counter."""


def read(m: dict):
    c = m.get("counters")
    if not c or c.get("decode_s") is None or not c.get("window_s"):
        return None
    return 100.0 * c["decode_s"] / c["window_s"]
