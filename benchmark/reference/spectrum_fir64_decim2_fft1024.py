"""Plain reference of ``spectrum_fir64_decim2_fft1024``: the complex FIR
as a sum of K shifted products over the carry-extended input, computed
only at every D-th output (y[D m], the stream counted from its first
sample), and the DFT of every window of ``nbins`` decimated samples
(``torch.fft``), in complex128. It takes the taps and the inputs from the
benchmark and works the FIR's history out again from the input before
each step; the program's outputs are only read to be judged.

The control (``control_output``) is the same computation on TF32
operands, as the sibling reference (``spectrum_fir64_fft1024.py``, whose
TF32 rounding and carry check this file takes) makes it: the inputs, the
taps and the filtered samples rounded to TF32's 10 mantissa bits, the
products accumulated and the DFT taken in float32. The configuration
states float32 with TF32 off, so the control has to fail ``spec_err``.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import torch


def _sibling():
    path = Path(__file__).with_name("spectrum_fir64_fft1024.py")
    spec = importlib.util.spec_from_file_location(
        "_spectrum_fir64_fft1024_reference", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_SIB = _sibling()
round_tf32 = _SIB.round_tf32
check_carry = _SIB.check_carry
# channels a pass, so the reference fits beside the kept outputs
CHANNEL_BLOCK = _SIB.CHANNEL_BLOCK


def spectra(cfg: dict, taps, x_prev, x, c0: int, c1: int,
            control: bool = False) -> torch.Tensor:
    """Spectra [c1 - c0, T / (D nbins), nbins] of channels c0..c1 of the
    step whose input is ``x`` [C, T, 2] (planar float32) after ``x_prev``
    [C, P, 2] (None: the stream starts with x): complex128, or complex64
    on TF32 operands for the control. T is a multiple of D, so the step
    starts on the decimation's phase."""
    n, d = int(cfg["nbins"]), int(cfg["decim"])
    h = np.asarray(taps, np.complex128)
    k = len(h)
    t = x.shape[1]
    m = t // d
    full = torch.cat([_SIB._history(x_prev, c0, c1, k, x), x[c0:c1]], dim=1)
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
    y = torch.zeros((c1 - c0, m), dtype=ctype, device=x.device)
    for j in range(k):
        # y[D i] takes x[D i - j], which is z[K - 1 + D i - j]
        y += hc[j] * z[:, k - 1 - j:k - 1 - j + t:d]
    if control:
        y = torch.view_as_complex(round_tf32(torch.view_as_real(y)))
    return torch.fft.fft(y.reshape(c1 - c0, m // n, n), dim=-1)


def check_step(cfg: dict, taps, x_prev, x, y) -> dict:
    """``spec_err``: max |y - reference| over the step, relative to the
    largest |reference| of the step. ``y`` is the step's output, any
    shape holding [C, T / (D nbins), nbins, 2] planar float32."""
    c, t = x.shape[:2]
    n, d = int(cfg["nbins"]), int(cfg["decim"])
    y = y.reshape(c, t // (d * n), n, 2)
    worst = top = 0.0
    for c0 in range(0, c, CHANNEL_BLOCK):
        c1 = min(c, c0 + CHANNEL_BLOCK)
        ref = spectra(cfg, taps, x_prev, x, c0, c1)
        got = torch.view_as_complex(y[c0:c1].float().contiguous())
        worst = max(worst, float((got.to(torch.complex128) - ref).abs().max()))
        top = max(top, float(ref.abs().max()))
        del ref, got
    return {"spec_err": worst / top}


def control_output(cfg: dict, taps, x_prev, x) -> torch.Tensor:
    """The control's output in the program's layout [C, T / (D nbins),
    nbins, 2], planar float32."""
    c = x.shape[0]
    parts = [torch.view_as_real(spectra(cfg, taps, x_prev, x, c0,
                                        min(c, c0 + CHANNEL_BLOCK), True))
             for c0 in range(0, c, CHANNEL_BLOCK)]
    return torch.cat(parts).float()
