"""The work a step of ``spectrum_fir64_fft1024`` needs, whatever computes
it: the FIR's 8 flops a tap an output sample (a complex multiply and add),
the FFT's 5 N log2 N a transform, and each input byte read once and each
output byte written once (the samples and the carry in, the spectra and
the carry out, the taps)."""

import math


def work(cfg: dict, shape: dict) -> dict:
    c, t = int(shape["channels"]), int(shape["samples"])
    k, n = int(cfg["taps"]), int(cfg["nbins"])
    samples = c * t
    flops = samples * 8 * k + (samples // n) * 5 * n * math.log2(n)
    carry = c * (k - 1) * 8
    nbytes = samples * 8 + carry + k * 8 + samples * 8 + carry
    return {"flops": flops, "bytes": nbytes}
