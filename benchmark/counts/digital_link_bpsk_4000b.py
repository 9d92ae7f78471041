"""The work a step of ``digital_link_bpsk_4000b`` needs, whatever computes
it: the search over every offset of every channel's window, 806 float32
operations an offset at the link's sizes (the least any formulation
needs: one complex multiply-add a correlation tap, 8 sw; the frequency
estimate's product x[m] conj(x[m + w/2]) and |x[m]| once a sample, 6 +
4; one complex add a term of the estimate's sum, 2 (w/2 - 2 dw), and one
add a term of each envelope window, 2 (w/2 - dw); ~20 for the divisions,
two atan2 and |L|; one complex product for each preamble symbol after
the first, 8 (npre - 1)); the window read once, the payload bits written
once, one byte a bit.

``stages`` has the one stage, ``sync_search``. The four per-offset arrays
the search hands the decode are not counted: a decode on the card would
not write them."""


def ops_per_offset(cfg: dict) -> int:
    w = int(cfg["symbol_width"]) * int(cfg["data_width"])
    dw, npre = int(cfg["data_width"]), len(cfg["preamble"])
    half = w // 2
    return 8 * w * npre + 6 + 4 + 2 * (half - 2 * dw) + 2 * (half - dw) \
        + 20 + 8 * (npre - 1)


def work(cfg: dict, shape: dict) -> dict:
    c, t = int(shape["channels"]), int(shape["samples"])
    w = int(cfg["symbol_width"]) * int(cfg["data_width"])
    frame_head = w * len(cfg["preamble"]) + 58 * int(cfg["data_width"])
    offsets = t - frame_head + 1
    flops = c * offsets * ops_per_offset(cfg)
    nbytes = c * t * 8 + c * int(cfg["payload_bits"])
    return {"flops": flops, "bytes": nbytes,
            "stages": {"sync_search": {"flops": flops, "bytes": nbytes}}}
