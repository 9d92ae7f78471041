"""The decimating channelizer through the port's public entry point:
``fir_fft_chain`` with ``decim=2``, as its users call it."""

from __future__ import annotations

import numpy as np

from pothoscomms_tpu_torch.parallel.chain import fir_fft_chain

# the band the low-pass keeps, in cycles a sample, and the shift of the
# pass band, in cycles a sample (f_s / 8)
CUTOFF = 0.25
SHIFT = 0.125


def weights(cfg: dict, seed: int) -> np.ndarray:
    """The complex taps: a K-tap Hann-windowed sinc low-pass of cutoff
    ``CUTOFF`` with unit DC gain, times e^(j 2 pi SHIFT n). The window is
    Hann's without its zero end points, so every tap counts. The same for
    every seed."""
    k = int(cfg["taps"])
    n = np.arange(k)
    lp = 2 * CUTOFF * np.sinc(2 * CUTOFF * (n - (k - 1) / 2))
    lp *= np.hanning(k + 2)[1:-1]
    lp /= lp.sum()
    return lp * np.exp(2j * np.pi * SHIFT * n)


def step_entry(cfg: dict, taps, channels: int, samples: int, device):
    """(step, carry0): ``fir_fft_chain(taps, nbins, channels, samples,
    decim=D)``."""
    return fir_fft_chain(taps, int(cfg["nbins"]), channels, samples,
                         decim=int(cfg["decim"]), device=device)
