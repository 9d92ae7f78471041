"""Plain reference of ``resampler_fir99_3to2_ellip6``: the two blocks
written out from their definitions in float64 / complex128, over the
step's input behind the tail of the input before it, with every state
worked out again from the inputs:

- the resampler (interpolation L, decimation M, real taps h of length K)
  is PothosComms' polyphase map (filter/FIRFilter.cpp:286-302): output t
  of the stream sits at u = t M + M - 1 of the upsampled stream and is
  y[t] = sum_k h[u mod L + k L] x[floor(u / L) - k]. Outputs come L to
  every M inputs, so output L m + r takes phase (r M + M - 1) mod L
  against inputs M m + floor((r M + M - 1) / L) - k: ceil(K / L) shifted
  products a phase, over the last ceil(K / L) - 1 inputs of the step
  before and the step's own;
- the IIR is direct form II transposed (filter/IIRFilter.cpp), per
  sample y = b0 v + z0, z_i = b_{i+1} v - a_{i+1} y + z_{i+1}. It is a
  contraction by the largest pole radius r a sample, so it is computed
  for all rows at once (rows of ``ROW`` outputs, each started from the
  zero state ``warm`` samples before it, with r^warm below 1e-20 twice
  over for the order's transient): in float64 that is the sequential
  recurrence to the last bit. The state after the step is the
  definition's sum over the last ``order`` inputs and outputs.

The control (``control_output``, ``control_carry``) is the same
computation on TF32 operands: the inputs, the taps and the resampled
samples rounded to TF32's 10 mantissa bits (the resampler's products
accumulated in float32), the IIR then in float64. With ``iir=True`` the
IIR runs on TF32 operands too, in the blocked state-space form of blocks
of ``IIR_BLOCK`` samples (:func:`iir_blocks`): its block operators, the
resampled samples and each block's state rounded to TF32, the products
accumulated in float64. The configuration states float32 with TF32 off,
so the control has to fail ``out_err`` and ``state_err`` either way.
"""

from __future__ import annotations

import importlib.util
import math
from pathlib import Path

import numpy as np
import torch

# channels a pass of the resampler, so it fits beside the kept outputs
CHANNEL_BLOCK = 32
# outputs a row of the IIR
ROW = 512
# samples a block of the IIR control's blocked form (the program's block)
IIR_BLOCK = 256


def _sibling():
    path = Path(__file__).with_name("spectrum_fir64_fft1024.py")
    spec = importlib.util.spec_from_file_location(
        "_spectrum_fir64_fft1024_reference", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


round_tf32 = _sibling().round_tf32


def _rates(cfg: dict):
    return int(cfg["interpolation"]), int(cfg["decimation"])


def history_len(cfg: dict, w: dict) -> int:
    """The inputs before a step that its outputs reach: ceil(K / L) - 1."""
    interp, _ = _rates(cfg)
    return -(-len(w["fir"]) // interp) - 1


def warm_len(a) -> int:
    """Samples an IIR row starts before its first output: twice the n
    with r^n below 1e-20 for the largest pole radius r, rounded up to a
    multiple of 256."""
    r = float(np.max(np.abs(np.roots(np.asarray(a, np.float64)))))
    n = math.ceil(math.log(1e-20) / math.log(r))
    return -(-2 * n // 256) * 256


def _complex(planar: torch.Tensor, control: bool) -> torch.Tensor:
    if control:
        return torch.view_as_complex(round_tf32(planar.float()).contiguous())
    return torch.view_as_complex(planar.double().contiguous())


def resampled(cfg: dict, w: dict, before, x, c0: int, c1: int,
              control: bool = False) -> torch.Tensor:
    """The resampler's output [c1 - c0, T L / M] of channels c0..c1 of
    the inputs ``x`` [C, T, 2] (planar float32) after ``before`` [C, P, 2]
    (None: the stream starts with x; zeros before it where P is short):
    complex128; for the control rounded to TF32 after float32 products on
    TF32 operands. T and P are multiples of M, so x starts on the map's
    phase."""
    interp, decim = _rates(cfg)
    h = np.asarray(w["fir"], np.float64)
    k = len(h)
    hist = history_len(cfg, w)
    t = x.shape[1]
    m = t // decim
    have = 0 if before is None else min(hist, before.shape[1])
    parts = [x.new_zeros((c1 - c0, hist - have, 2))]
    if have:
        parts.append(before[c0:c1, before.shape[1] - have:])
    full = _complex(torch.cat(parts + [x[c0:c1]], dim=1), control)
    if control:
        h = round_tf32(torch.from_numpy(h.astype(np.float32))).double()
        h = h.numpy()
    y = full.new_zeros((c1 - c0, m, interp))
    for r in range(interp):
        u = r * decim + decim - 1
        j, n = u % interp, u // interp
        for q in range(hist + 1):
            if j + q * interp >= k:
                continue
            # output L m' + r takes x[M m' + n - q], full[hist + M m' + n - q]
            s = hist + n - q
            y[:, :, r] += float(h[j + q * interp]) \
                * full[:, s:s + decim * (m - 1) + 1:decim]
    y = y.reshape(c1 - c0, m * interp)
    if control:
        y = torch.view_as_complex(round_tf32(torch.view_as_real(y)))
        return y.to(torch.complex128)
    return y


def _stream(cfg: dict, w: dict, before, x, control: bool):
    """:func:`resampled` of every channel, a block of channels at a
    time."""
    c = x.shape[0]
    return torch.cat([resampled(cfg, w, before, x, c0,
                                min(c, c0 + CHANNEL_BLOCK), control)
                      for c0 in range(0, c, CHANNEL_BLOCK)])


def _lead(cfg: dict, outputs: int) -> int:
    """The fewest inputs, a multiple of M, whose resampled outputs number
    at least ``outputs``."""
    interp, decim = _rates(cfg)
    return -(-outputs // interp) * decim


def _ba(w: dict):
    """(b, a, order): the IIR's taps over a[0], both of length order + 1."""
    b = np.asarray(w["b"], np.float64) / w["a"][0]
    a = np.asarray(w["a"], np.float64) / w["a"][0]
    order = max(len(b), len(a)) - 1
    return (np.pad(b, (0, order + 1 - len(b))),
            np.pad(a, (0, order + 1 - len(a))), order)


def iir_tail(w: dict, v: torch.Tensor, count: int) -> torch.Tensor:
    """The IIR's output of the last ``count`` samples of ``v`` [C, n]
    (complex128): rows of ``ROW`` outputs, all at once, each run from the
    zero state ``warm_len`` samples before it; where the stream starts
    inside that span, from its true zero state at the stream's start."""
    b, a, order = _ba(w)
    warm = warm_len(a)
    c, n = v.shape
    if n - count >= warm:
        seg = v[:, n - count - warm:]
    else:
        seg = torch.cat([v.new_zeros((c, warm - (n - count))), v], dim=1)
    row = min(ROW, count)
    pad = (-count) % row
    seg = torch.cat([seg, seg.new_zeros((c, pad))], dim=1)
    nb = (count + pad) // row
    z = [seg.new_zeros((c, nb)) for _ in range(order)]
    y = seg.new_empty((c, nb, row))
    for j in range(warm + row):
        vn = seg[:, j:j + nb * row:row]
        yn = b[0] * vn + z[0]
        z = [b[i + 1] * vn - a[i + 1] * yn + (z[i + 1] if i + 1 < order
                                               else 0.0)
             for i in range(order)]
        if j >= warm:
            y[:, :, j - warm] = yn
    return y.reshape(c, nb * row)[:, :count]


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """float64 or complex128 ``t`` rounded to TF32, in its own dtype."""
    if t.is_complex():
        return torch.view_as_complex(_tf32(torch.view_as_real(t)))
    return round_tf32(t.float()).to(t.dtype)


def iir_blocks(w: dict, v: torch.Tensor, count: int, tf32: bool,
               block: int = IIR_BLOCK):
    """The IIR over ``v`` [C, n] (complex128) from the zero state at its
    start, in the blocked state-space form: with the DF-II-T state z (z_i
    as in :func:`iir_tail`), z' = A z + B v and y = z_0 + b0 v a sample,
    a block of ``block`` samples is y = Wz z + H v, z' = M z + G v, where
    H holds the impulse response (h_0 = b0, h_k = (A^(k-1) B)_0) below its
    diagonal, Wz's rows are the first rows of A^n, G's columns A^(L-1-m)
    B, and M = A^L; the blocks' states follow one another. ``tf32``: H,
    Wz, G, M, v and each state rounded to TF32 before their products.
    Returns (the output's last ``count`` samples, the state [order, C]
    after the last sample)."""
    b, a, order = _ba(w)
    A = np.zeros((order, order))
    A[:, 0] = -a[1:]
    A[np.arange(order - 1), np.arange(1, order)] = 1.0
    B = b[1:] - a[1:] * b[0]
    pw = [np.eye(order)]
    for _ in range(block):
        pw.append(A @ pw[-1])
    h = np.array([b[0]] + [(pw[k] @ B)[0] for k in range(block - 1)])
    idx = np.arange(block)
    diff = idx[:, None] - idx[None, :]
    ops = [np.where(diff >= 0, h[np.clip(diff, 0, None)], 0.0),   # H
           np.stack([pw[n][0] for n in range(block)]),             # Wz
           np.stack([pw[block - 1 - m] @ B for m in range(block)],
                    axis=1),                                       # G
           pw[block]]                                              # M
    rnd = _tf32 if tf32 else (lambda t: t)
    H, Wz, G, M = (rnd(torch.from_numpy(o).to(v.device)).to(v.dtype)
                   for o in ops)
    c, n = v.shape
    v = rnd(torch.cat([v.new_zeros((c, (-n) % block)), v], dim=1))
    xb = v.reshape(c, -1, block)
    u = xb @ G.T                                     # [C, nb, order]
    z = v.new_zeros((c, order))
    zs = []
    for k in range(xb.shape[1]):
        zs.append(z)
        z = rnd(z) @ M.T + u[:, k]
    y = rnd(torch.stack(zs, dim=1)) @ Wz.T + xb @ H.T
    return y.reshape(c, -1)[:, -count:], z.T


def _state(w: dict, v: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The DF-II-T state [order, C] after the last sample, from the last
    ``order`` inputs ``v`` and outputs ``y`` [C, >= order]:
    z_i = sum_{j=0}^{order-1-i} b_{i+1+j} v[-1-j] - a_{i+1+j} y[-1-j]."""
    b, a, order = _ba(w)
    n, m = v.shape[1], y.shape[1]
    z = []
    for i in range(order):
        zi = v.new_zeros(v.shape[0])
        for j in range(order - i):
            zi = zi + b[i + 1 + j] * v[:, n - 1 - j] \
                - a[i + 1 + j] * y[:, m - 1 - j]
        z.append(zi)
    return torch.stack(z)


def output(cfg: dict, w: dict, x_prev, x, control: bool = False,
           iir: bool = False):
    """The chain's output [C, T L / M] (complex128) for the step whose
    input is ``x`` after ``x_prev`` (None: the stream starts with x):
    the resampler over the step and enough of ``x_prev``'s tail for the
    IIR's warm-up, then the IIR of all channels at once (``iir``: on TF32
    operands, :func:`iir_blocks`)."""
    interp, decim = _rates(cfg)
    before, cur = None, x
    if x_prev is not None:
        p = x_prev.shape[1]
        lead = min(p, _lead(cfg, warm_len(w["a"])))
        before, cur = x_prev[:, :p - lead], torch.cat(
            [x_prev[:, p - lead:], x], dim=1)
    v = _stream(cfg, w, before, cur, control)
    count = x.shape[1] * interp // decim
    if iir:
        return iir_blocks(w, v, count, True)[0]
    return iir_tail(w, v, count)


def _tail_state(cfg: dict, w: dict, x, control: bool = False,
                iir: bool = False):
    """The IIR's state after the step whose input is ``x``, from the
    step's own tail: enough inputs that the resampled tail spans the
    IIR's warm-up (the whole step, as a stream's start, when it is
    shorter)."""
    _, a, order = _ba(w)
    t = x.shape[1]
    s = min(t, _lead(cfg, warm_len(a) + order))
    v = _stream(cfg, w, x[:, :t - s], x[:, t - s:], control)
    if iir:
        return iir_blocks(w, v, order, True)[1]
    return _state(w, v, iir_tail(w, v, order))


def check_step(cfg: dict, w: dict, x_prev, x, y) -> dict:
    """``out_err``: max |y - reference| over the step, relative to the
    largest |reference| of the step. ``y`` holds [C, T L / M, 2] planar
    float32."""
    ref = output(cfg, w, x_prev, x)
    got = torch.view_as_complex(
        y.reshape(ref.shape + (2,)).double().contiguous())
    worst = float((got - ref).abs().max())
    return {"out_err": worst / float(ref.abs().max())}


def check_carry(cfg: dict, w: dict, x, carry) -> dict:
    """``carry_err``: max |FIR carry - x's last ceil(K / L) - 1 samples|
    (exact: 0); ``state_err``: max |IIR state - reference state| relative
    to the largest |reference state|. ``carry`` is the chain's (FIR
    history [C, H, 2], IIR state [order, C, 2])."""
    hist, state = carry
    tail = x[:, x.shape[1] - history_len(cfg, w):]
    ref = _tail_state(cfg, w, x)
    got = torch.view_as_complex(
        state.reshape(ref.shape + (2,)).double().contiguous())
    return {"carry_err": float((hist.reshape(tail.shape) - tail).abs().max()),
            "state_err": float((got - ref).abs().max())
            / float(ref.abs().max())}


def control_output(cfg: dict, w: dict, x_prev, x,
                   iir: bool = False) -> torch.Tensor:
    """The control's output in the program's layout [C, T L / M, 2],
    planar float32 (``iir``: the IIR on TF32 operands too)."""
    return torch.view_as_real(output(cfg, w, x_prev, x, True, iir)).float()


def control_carry(cfg: dict, w: dict, x, iir: bool = False):
    """The control's carry after the step whose input is ``x``, in the
    program's layout: (the FIR history, exact; the IIR state [order, C,
    2] from TF32 operands; ``iir``: the IIR's on TF32 operands too)."""
    hist = x[:, x.shape[1] - history_len(cfg, w):]
    state = _tail_state(cfg, w, x, True, iir)
    return hist, torch.view_as_real(state.contiguous()).float()
