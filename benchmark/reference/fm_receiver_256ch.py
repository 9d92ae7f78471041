"""Plain reference of ``fm_receiver_256ch``: the three blocks written out
from their definitions in float64, over the step's input behind the
input before it, with every state worked out again from the inputs:

- FreqDemod: u[n] = arg(x[n] conj(x[n-1]));
- DCRemoval (average D, cascade S): S moving means of width D, each as a
  sum of D shifted copies, and u delayed by D - 1 less the last mean;
- EnvelopeDetector (attack a, release r): e[n] = g e[n-1] + (1 - g) |v[n]|
  with g = exp(-1/a) where |v[n]| > e[n-1], else exp(-1/r).

The envelope is a contraction by at least max(g) a sample, so it is
computed for all rows at once (rows of ``ROW`` samples, each started from
0 the ``warm`` samples before it, with max(g)^warm below 1e-20): in
float64 that is the sequential recurrence to the last bit. The
demodulator needs one sample of history and DC removal 2D - 2, which the
previous input holds.

The control (``control_output``) is the same computation in bfloat16
(the configuration states float32), gains included.
"""

from __future__ import annotations

import math

import torch

CHANNEL_BLOCK = 64
ROW = 512


def _gains(w: dict, dtype, device):
    ga, gr = math.exp(-1.0 / w["attack"]), math.exp(-1.0 / w["release"])
    warm = math.ceil(math.log(1e-20) / math.log(max(ga, gr)) / 256) * 256
    as_t = (lambda g: torch.tensor(g, dtype=dtype, device=device))
    return as_t(ga), as_t(gr), warm


def _shift(v: torch.Tensor, s: int) -> torch.Tensor:
    """v delayed by s samples, zeros before the stream."""
    if s == 0:
        return v
    return torch.cat([v.new_zeros((v.shape[0], s)), v[:, :v.shape[1] - s]],
                     dim=1)


def _moving_mean(v: torch.Tensor, d: int) -> torch.Tensor:
    acc = v.clone()
    for s in range(1, d):
        acc += _shift(v, s)
    return acc / d


def _follower(mag: torch.Tensor, w: dict, count: int) -> torch.Tensor:
    """The envelope of the last ``count`` samples of ``mag`` [C, n]."""
    ga, gr, warm = _gains(w, mag.dtype, mag.device)
    c, n = mag.shape
    if n - count >= warm:
        seg = mag[:, n - count - warm:]
    else:  # the stream starts inside: from its true zero state
        seg = torch.cat([mag.new_zeros((c, warm - (n - count))), mag], dim=1)
    row = min(ROW, count)
    pad = (-count) % row
    seg = torch.cat([seg, seg.new_zeros((c, pad))], dim=1)
    nb = (count + pad) // row
    e = seg.new_zeros((c, nb))
    y = seg.new_empty((c, nb, row))
    for j in range(warm + row):
        xn = seg[:, j:j + nb * row:row]
        # e + (1 - g)(x - e), the gain by the comparison with x
        e = xn + torch.where(xn > e, ga, gr) * (e - xn)
        if j >= warm:
            y[:, :, j - warm] = e
    return y.reshape(c, nb * row)[:, :count]


def _dc_removed(w: dict, x_prev, x, c0: int, c1: int, dtype):
    """The DC removal's output [c1 - c0, P + T] over x_prev and x."""
    full = x[c0:c1] if x_prev is None else torch.cat(
        [x_prev[c0:c1], x[c0:c1]], dim=1)
    re, im = full[..., 0].to(dtype), full[..., 1].to(dtype)
    pr, pi = _shift(re, 1), _shift(im, 1)
    u = torch.atan2(im * pr - re * pi, re * pr + im * pi)
    del re, im, pr, pi
    d = w["average"]
    a = u
    for _ in range(w["cascade"]):
        a = _moving_mean(a, d)
    return _shift(u, d - 1) - a


def envelope(cfg: dict, w: dict, x_prev, x, dtype=torch.float64):
    """The chain's output [C, T] for the step whose input is ``x``
    [C, T, 2] after ``x_prev`` (None: the stream starts with x), computed
    in ``dtype``: DC removal a block of channels at a time, the envelope
    of all channels at once."""
    c, t = x.shape[:2]
    mags = [_dc_removed(w, x_prev, x, c0, min(c, c0 + CHANNEL_BLOCK),
                        dtype).abs() for c0 in range(0, c, CHANNEL_BLOCK)]
    return _follower(torch.cat(mags), w, t)


def check_step(cfg: dict, w: dict, x_prev, x, y) -> dict:
    """``env_err``: max |y - reference| over the step, relative to the
    largest reference value of the step. ``y`` holds [C, T] float32."""
    ref = envelope(cfg, w, x_prev, x)
    worst = float((y.reshape(ref.shape).double() - ref).abs().max())
    return {"env_err": worst / float(ref.abs().max())}


def check_carry(cfg: dict, w: dict, x, carry) -> dict:
    """The chain's carry is internal to the program: the next step's
    output, worked out again from the inputs, judges it."""
    return {}


def control_output(cfg: dict, w: dict, x_prev, x) -> torch.Tensor:
    """The control's output [C, T] (bfloat16 arithmetic, as float32)."""
    return envelope(cfg, w, x_prev, x, torch.bfloat16).float()
