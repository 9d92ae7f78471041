"""The work a step of ``resampler_fir99_3to2_ellip6`` needs, whatever
computes it: the resampler's 4 flops a real tap an output (a complex
sample times a real tap, added), ceil(K / L) taps an output, at the
T L / M outputs; the IIR's 2 x 2 x (2 order + 1) flops an output (each
plane's order + 1 feed-forward and order feedback products, added); and
each input byte read once and each output byte written once (the
samples, the FIR's carry and the IIR's state in and out, the taps, float32).

``stages`` splits the step between its two stages, each counted as a
pass of its own through memory: ``resampler`` reads the samples, its
carry and its taps and writes the resampled samples and its carry;
``iir`` reads the resampled samples, its state and its taps and writes
the output and its state."""


def work(cfg: dict, shape: dict) -> dict:
    c, t = int(shape["channels"]), int(shape["samples"])
    k, order = int(cfg["taps"]), int(cfg["iir_order"])
    interp, decim = int(cfg["interpolation"]), int(cfg["decimation"])
    taps_a_phase = -(-k // interp)
    samples = c * t
    outputs = samples * interp // decim
    res_flops = outputs * 4 * taps_a_phase
    iir_flops = outputs * 2 * 2 * (2 * order + 1)
    carry = c * (taps_a_phase - 1) * 8
    state = c * order * 8
    fir_taps, iir_taps = k * 4, 2 * (order + 1) * 4
    return {
        "flops": res_flops + iir_flops,
        "bytes": (samples * 8 + 2 * carry + fir_taps + 2 * state + iir_taps
                  + outputs * 8),
        "stages": {
            "resampler": {"flops": res_flops,
                          "bytes": samples * 8 + 2 * carry + fir_taps
                          + outputs * 8},
            "iir": {"flops": iir_flops,
                    "bytes": outputs * 8 + 2 * state + iir_taps
                    + outputs * 8},
        },
    }
