"""The 3:2 resampler bank with an elliptic channel filter through the
port's public entry point: ``compile_chain([fir_filter, iir_filter],
channels)`` of the registry's blocks, as its users call it."""

from __future__ import annotations

import numpy as np
import scipy.signal

from pothoscomms_tpu_torch import BlockRegistry
from pothoscomms_tpu_torch.parallel.compiler import compile_chain

# GNU Radio rational_resampler's design_filter(3, 2, 0.4): the transition
# band 0.5 - 0.4 wide, centred at 0.45, at the upsampled rate of 3
KAISER_BETA = 7.0
MID_TRANSITION = 0.45


def fir_taps(cfg: dict) -> np.ndarray:
    """firdes.low_pass(L, L, 0.45, 0.1, WIN_KAISER, 7): a K-tap Kaiser
    windowed sinc of cutoff 0.45 / L cycles a sample of the upsampled
    rate, scaled to sum to L (the interpolation's gain)."""
    k, interp = int(cfg["taps"]), int(cfg["interpolation"])
    fc = MID_TRANSITION / interp
    n = np.arange(k) - (k - 1) / 2
    h = 2 * fc * np.sinc(2 * fc * n) * np.kaiser(k, KAISER_BETA)
    return h * (interp / h.sum())


def weights(cfg: dict, seed: int) -> dict:
    """The FIR's real taps and the IIR's (b, a), both made outside the
    port: the IIR is scipy's elliptic low-pass of the configuration's
    order, ripple and attenuation, its edge given as a share of Nyquist
    (twice the cutoff's share of the rate). The same for every seed."""
    b, a = scipy.signal.ellip(int(cfg["iir_order"]),
                              float(cfg["iir_ripple_db"]),
                              float(cfg["iir_stop_atten_db"]),
                              2 * float(cfg["iir_cutoff"]))
    return {"fir": fir_taps(cfg), "b": np.asarray(b, np.float64),
            "a": np.asarray(a, np.float64)}


def step_entry(cfg: dict, w: dict, channels: int, samples: int, device):
    """(step, carry0) of the compiled two-block chain."""
    fir = BlockRegistry.make("/comms/fir_filter", "complex_float32", "REAL")
    fir.set_taps(w["fir"])
    fir.set_interpolation(int(cfg["interpolation"]))
    fir.set_decimation(int(cfg["decimation"]))
    iir = BlockRegistry.make("/comms/iir_filter", "complex_float32")
    iir.set_taps(np.concatenate([w["b"], w["a"]]))
    return compile_chain([fir, iir], channels=channels, device=device)
