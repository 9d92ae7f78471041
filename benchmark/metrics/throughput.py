"""throughput (Msamples/s): input samples over all channels of the steps
that completed inside the measured window, over the window's length (it
ends when the last step issued has completed)."""


def read(m: dict):
    if not m.get("window_s") or not m.get("samples"):
        return None
    return m["samples"] / m["window_s"] / 1e6
