"""The work a step of ``spectrum_fir64_decim2_fft1024`` needs, whatever
computes it: the FIR's 8 flops a tap an output sample (a complex multiply
and add), computed only at the T / D outputs kept, the FFT's 5 N log2 N a
transform, and each input byte read once and each output byte written
once (the samples and the carry in, the spectra and the carry out, the
taps).

``stages`` splits the step between its two stages, each counted as a
pass of its own through memory: ``fir`` reads the samples, the carry and
the taps and writes the filtered, decimated samples and the carry;
``fft`` reads the filtered samples and writes the spectra."""

import math


def work(cfg: dict, shape: dict) -> dict:
    c, t = int(shape["channels"]), int(shape["samples"])
    k, n, d = int(cfg["taps"]), int(cfg["nbins"]), int(cfg["decim"])
    samples = c * t
    kept = samples // d
    fir_flops = kept * 8 * k
    fft_flops = (kept // n) * 5 * n * math.log2(n)
    carry = c * (k - 1) * 8
    taps = k * 8
    return {
        "flops": fir_flops + fft_flops,
        "bytes": samples * 8 + carry + taps + kept * 8 + carry,
        "stages": {
            "fir": {"flops": fir_flops,
                    "bytes": samples * 8 + carry + taps + kept * 8 + carry},
            "fft": {"flops": fft_flops, "bytes": kept * 8 + kept * 8},
        },
    }
