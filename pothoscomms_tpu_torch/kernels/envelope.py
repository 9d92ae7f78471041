"""E1: the attack/release envelope follower over rows of a [P, T] block
(``csrc/envelope.cu``).

It carries both of the JAX package's envelope scans: ``envelope_blocked``
(rows of L samples, each warm-started Wr samples early) and, with
``L = T, Wr = 0``, the sequential ``envelope_scan``
(``pothoscomms_tpu/ops/filter.py:378-453``). :func:`envelope_rows`
launches the CUDA kernel for CUDA tensors and uses
:func:`envelope_rows_plain`, a Python loop over the Wr + L steps, only
for CPU tensors; any other device raises. The kernel's time is that of
one row's chain of Wr + L steps (rows run side by side), so callers that
may choose L keep it short: the envelope block's fused core takes
``blocks/filter.ENVELOPE_BLOCK``.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from pothoscomms_tpu_torch.kernels import build
from pothoscomms_tpu_torch.parallel.profiling import (
    annotate, first_launch, launching)


def _check(mag, env0, L, Wr):
    if mag.dim() != 2 or env0.shape != mag.shape[:1]:
        raise ValueError(f"envelope_rows: mag must be [P, T] and env0 [P], "
                         f"got {tuple(mag.shape)} and {tuple(env0.shape)}")
    if mag.dtype != torch.float32 or env0.dtype != torch.float32:
        raise TypeError(f"envelope_rows: float32 only, got {mag.dtype}, "
                        f"{env0.dtype}")
    if mag.device != env0.device:
        raise ValueError("envelope_rows: mag and env0 must be on one device")
    if L < 1 or mag.shape[1] % L != 0 or Wr < 0:
        raise ValueError(f"envelope_rows: need L >= 1 dividing "
                         f"T={mag.shape[1]} and Wr >= 0, got L={L} Wr={Wr}")


def envelope_rows_plain(mag: torch.Tensor, env0: torch.Tensor, ga, gr,
                        L: int, Wr: int):
    """Plain PyTorch version of :func:`envelope_rows`: the JAX
    ``envelope_blocked`` scan, all nb = T / L rows of a channel stepped
    together, one step per loop iteration."""
    _check(mag, env0, L, Wr)
    P, T = mag.shape
    if T == 0:
        return mag.new_empty((P, 0)), env0.clone()
    nb = T // L
    ga = torch.tensor(np.float32(ga), device=mag.device)
    gr = torch.tensor(np.float32(gr), device=mag.device)
    # xfull[p, Wr + t] = mag[p, t]; the first Wr entries are env0
    xfull = torch.cat([env0[:, None].expand(P, Wr), mag], dim=1)
    span = (nb - 1) * L + 1
    e = xfull[:, 0:span:L].clone()    # e_init: xfull[p, b*L] ...
    e[:, 0] = env0                    # ... but env0 for row 0
    y = mag.new_empty((P, nb, L))
    for j in range(Wr + L):
        xn = xfull[:, j:j + span:L]   # xfull[p, b*L + j], every row b
        g = torch.where(xn > e, ga, gr)
        e = g * e + (1.0 - g) * xn
        if j >= Wr:
            y[:, :, j - Wr] = e
    return y.reshape(P, T), e[:, -1].clone()


def envelope_rows(mag: torch.Tensor, env0: torch.Tensor, ga, gr, L: int,
                  Wr: int):
    """Envelope of mag [P, T] float32 from env0 [P]: returns (y [P, T],
    env_f [P]).

    Row (p, b) of L samples is warm-started from the Wr samples before it,
    the first Wr of each channel being env0[p] (the JAX
    ``envelope_blocked`` index algebra). Row b starts from its first
    warm-up sample, row 0 from env0[p] (the same when Wr > 0), so
    L = T, Wr = 0 is the plain sequential scan from env0. ga, gr are the
    attack and release gains, rounded to float32. On CUDA mag and env0
    must be contiguous.
    """
    _check(mag, env0, L, Wr)
    if mag.device.type == "cpu":
        return envelope_rows_plain(mag, env0, ga, gr, L, Wr)
    if mag.device.type != "cuda":
        raise ValueError(f"envelope_rows: no kernel for device {mag.device}")
    if not envelope_rows.launches and envelope_rows not in launching:
        return first_launch(envelope_rows, mag, env0, ga, gr, L, Wr)
    if not (mag.is_contiguous() and env0.is_contiguous()):
        raise ValueError("envelope_rows: mag and env0 must be contiguous")
    P, T = mag.shape
    if T == 0:
        return mag.new_empty((P, 0)), env0.clone()
    if -(-P * (T // L) // 32) >= 2 ** 31:
        raise ValueError(f"envelope_rows: {P} x {T // L} rows exceed the "
                         f"kernel's grid")
    y = torch.empty_like(mag)
    env_f = torch.empty_like(env0)
    with annotate("pc.kernel.envelope_rows"), torch.cuda.device(mag.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry()(mag.data_ptr(), env0.data_ptr(), y.data_ptr(),
                       env_f.data_ptr(), P, T, L, Wr, float(np.float32(ga)),
                       float(np.float32(gr)), stream)
    build.check(err, "envelope_rows_f32")
    envelope_rows.launches += 1
    return y, env_f


envelope_rows.launches = 0


@lru_cache(maxsize=None)
def _entry():
    fn = build.load("envelope").envelope_rows_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 4 \
        + [ctypes.c_float] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn
