"""The work a step of ``fm_receiver_256ch`` needs, whatever computes it:
bytes only (no product a tensor core could take): each complex64 input
sample read once and each float32 envelope sample written once, and the
blocks' states read and written (the demodulator's last sample, the DC
removal's D samples a stage, the envelope)."""


def work(cfg: dict, shape: dict) -> dict:
    c, t = int(shape["channels"]), int(shape["samples"])
    state = c * (8 + int(cfg["dc_cascade"]) * int(cfg["dc_average"]) * 4 + 4)
    return {"flops": 0, "bytes": c * t * (8 + 4) + 2 * state}
