"""Plain reference of ``spectrum_fir64_fft1024``: the complex FIR as a sum
of K shifted products and the DFT of every window of ``nbins`` filtered
samples (``torch.fft``), in complex128. It takes the taps and the inputs
from the benchmark and works the FIR's history out again from the input
before each step; the program's outputs are only read to be judged.

The control (``control_output``) is the same computation on TF32
operands: the inputs, the taps and the filtered samples rounded to TF32's
10 mantissa bits (as a one-pass TF32 tensor-core product takes them),
the products accumulated and the DFT taken in float32. The configuration
states float32 with TF32 off, so the control has to fail ``spec_err``.
"""

from __future__ import annotations

import numpy as np
import torch

# channels a pass, so the reference fits beside the kept outputs
CHANNEL_BLOCK = 32


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 -> float32 rounded to nearest (even) at 10 mantissa bits."""
    b = t.contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & -0x2000
    return b.view(torch.float32)


def _history(x_prev, c0, c1, k, x):
    if x_prev is None:
        return torch.zeros((c1 - c0, k - 1, 2), dtype=x.dtype, device=x.device)
    return x_prev[c0:c1, x_prev.shape[1] - (k - 1):]


def spectra(cfg: dict, taps, x_prev, x, c0: int, c1: int,
            control: bool = False) -> torch.Tensor:
    """Spectra [c1 - c0, T / nbins, nbins] of channels c0..c1 of the step
    whose input is ``x`` [C, T, 2] (planar float32) after ``x_prev``
    [C, P, 2] (None: the stream starts with x): complex128, or complex64
    on TF32 operands for the control."""
    n = int(cfg["nbins"])
    h = np.asarray(taps, np.complex128)
    k = len(h)
    t = x.shape[1]
    full = torch.cat([_history(x_prev, c0, c1, k, x), x[c0:c1]], dim=1)
    if control:
        full = round_tf32(full.float())
        hp = round_tf32(torch.tensor(np.stack([h.real, h.imag], -1),
                                     dtype=torch.float32))
        hc = torch.view_as_complex(hp.contiguous()).to(full.device)
        ctype = torch.complex64
    else:
        hc = torch.tensor(h, dtype=torch.complex128, device=full.device)
        ctype = torch.complex128
    z = torch.view_as_complex(full.contiguous()).to(ctype)
    y = torch.zeros((c1 - c0, t), dtype=ctype, device=x.device)
    for d in range(k):
        y += hc[d] * z[:, k - 1 - d:k - 1 - d + t]
    if control:
        y = torch.view_as_complex(round_tf32(torch.view_as_real(y)))
    return torch.fft.fft(y.reshape(c1 - c0, t // n, n), dim=-1)


def check_step(cfg: dict, taps, x_prev, x, y) -> dict:
    """``spec_err``: max |y - reference| over the step, relative to the
    largest |reference| of the step. ``y`` is the step's output, any
    shape holding [C, T / nbins, nbins, 2] planar float32."""
    c, t = x.shape[:2]
    n = int(cfg["nbins"])
    y = y.reshape(c, t // n, n, 2)
    worst = top = 0.0
    for c0 in range(0, c, CHANNEL_BLOCK):
        c1 = min(c, c0 + CHANNEL_BLOCK)
        ref = spectra(cfg, taps, x_prev, x, c0, c1)
        got = torch.view_as_complex(y[c0:c1].float().contiguous())
        worst = max(worst, float((got.to(torch.complex128) - ref).abs().max()))
        top = max(top, float(ref.abs().max()))
        del ref, got
    return {"spec_err": worst / top}


def check_carry(cfg: dict, taps, x, carry) -> dict:
    """``carry_err``: max |carry - x's last K - 1 samples| (exact: 0)."""
    k = int(cfg["taps"])
    tail = x[:, x.shape[1] - (k - 1):]
    return {"carry_err": float((carry.reshape(tail.shape) - tail).abs().max())}


def control_output(cfg: dict, taps, x_prev, x) -> torch.Tensor:
    """The control's output in the program's layout [C, T / nbins, nbins,
    2], planar float32."""
    c = x.shape[0]
    parts = [torch.view_as_real(spectra(cfg, taps, x_prev, x, c0,
                                        min(c, c0 + CHANNEL_BLOCK), True))
             for c0 in range(0, c, CHANNEL_BLOCK)]
    return torch.cat(parts).float()
