"""link.decode_pct (%): the receiver's host seconds from the search
stage's end to the frames (the program's counter ``link.decode_s``)
gained over the measured window, over the window's length. On a card the
decode is D1's, inside the search stage, and the counter times the
unpacking of its records into the frames; on the CPU it times the
automaton, the header, the slicer and the descrambler. None where the
program has no such counter."""


def read(m: dict):
    c = m.get("counters")
    if not c or c.get("decode_s") is None or not c.get("window_s"):
        return None
    return 100.0 * c["decode_s"] / c["window_s"]
