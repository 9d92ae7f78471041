"""The polyphase rational-resampling FIR (the port of ``polyphase_fir`` and
``fir_tap_state`` in the JAX package's ``ops/filter.py``).

The reference's per-sample interp/decim counter loop
(filter/FIRFilter.cpp:286-302) becomes static index arithmetic over all
outputs at once: output t sits at upsampled position u = t*M + M-1, phase
j = u mod L, input index n = u div L; a gather of the K-sample frames and
a phase-selected dot give every output in one pass.

Fixed-point paths follow Pothos Q-format semantics exactly
(core/qformat.py): taps scaled by 2**(bits/2) with truncation; integer
products and sums wrap in the accumulator type; outputs are arithmetic-
shifted right by half the accumulator width.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from pothoscomms_tpu_torch.core.dtypes import DType
from pothoscomms_tpu_torch.core.qformat import Q_ACCUMULATOR, float_to_q


def _polyphase_matrix(taps: np.ndarray, L: int) -> Tuple[np.ndarray, int]:
    """taps[i] -> phases[j, k] = taps[j + k*L], zero padded. K = ceil(n/L)."""
    n = len(taps)
    K = n // L + (0 if n % L == 0 else 1)
    out = np.zeros((L, K), dtype=taps.dtype)
    for j in range(L):
        for k in range(K):
            i = j + k * L
            if i < n:
                out[j, k] = taps[i]
    return out, K


def fir_tap_state(taps, L: int, data_dtype: DType, complex_taps: bool):
    """Q-format polyphase taps [L, K] (complex int: [L, K, 2]) for a data
    dtype, and K.

    Mirrors the factory's Q-type table (filter/FIRFilter.cpp:369-383):
    int8 -> int16 taps/acc, int16 -> int32, int32/64 -> int64,
    float -> same-width float.
    """
    taps = np.asarray(taps)
    phases, K = _polyphase_matrix(taps, L)
    if data_dtype.is_float:
        # floatToQ<float/double> is a plain cast; accumulate in data width
        q = phases.astype(np.complex128 if complex_taps else np.float64)
        if data_dtype.bits == 32:
            q = q.astype(np.complex64 if complex_taps else np.float32)
        return q, K
    # fixed point: scale by 2**(qbits/2), truncate (core/qformat semantics)
    qname = Q_ACCUMULATOR[data_dtype.scalar.name]
    qdt = DType.parse(("complex_" + qname) if complex_taps else qname)
    return float_to_q(phases, qdt), K


def polyphase_fir(xh: torch.Tensor, taps_q: torch.Tensor, M: int, L: int,
                  K: int, kind: str, half_shift: int) -> torch.Tensor:
    """Run the rational resampler over one window.

    xh: input INCLUDING K-1 leading history samples — shape [K-1+N] (real /
    complex float), or [K-1+N, 2] (complex int, or complex float32 as
    planar re/im). taps_q: the polyphase matrix from :func:`fir_tap_state`
    (planar [L, K, 2] for ``kind="planar"``), on xh's device.
    kind: 'float' | 'int' | 'cint_rtaps' | 'cint_ctaps' | 'planar'.
    half_shift: Q shift for fixed point (half the accumulator width), 0 for
    float.

    Returns y with (N//M)*L elements in the reference's output order
    (filter/FIRFilter.cpp:286-302: output t sits at upsampled position
    u = t*M + (M-1); y[t] = sum_k taps[u%L, k] * x[u//L - k]).
    """
    n_in = xh.shape[0] - (K - 1)
    N = (n_in // M) * M
    T = (N // M) * L
    dev = xh.device
    u = torch.arange(T, device=dev) * M + (M - 1)
    n_idx = u // L
    j_idx = u % L
    # gather frames: frame[t, k] = xh[n_idx[t] + (K-1) - k]
    gidx = n_idx[:, None] + (K - 1) - torch.arange(K, device=dev)[None, :]
    tsel = taps_q[j_idx]                                   # [T, K(, 2)]

    if kind == "float":
        return (xh[gidx] * tsel).sum(dim=-1)

    if kind == "planar":
        fr = xh[gidx]                                      # [T, K, 2]
        pr = fr[..., 0] * tsel[..., 0] - fr[..., 1] * tsel[..., 1]
        pi = fr[..., 0] * tsel[..., 1] + fr[..., 1] * tsel[..., 0]
        return torch.stack([pr.sum(dim=1), pi.sum(dim=1)], dim=-1)

    # fixed point: products and sums wrap in the accumulator type
    acc_dt = taps_q.dtype
    frames = xh[gidx].to(acc_dt)
    if kind == "int":
        acc = (frames * tsel).sum(dim=-1, dtype=acc_dt)
    elif kind == "cint_rtaps":
        acc = (frames * tsel[..., None]).sum(dim=1, dtype=acc_dt)
    elif kind == "cint_ctaps":
        pr = frames[..., 0] * tsel[..., 0] - frames[..., 1] * tsel[..., 1]
        pi = frames[..., 0] * tsel[..., 1] + frames[..., 1] * tsel[..., 0]
        acc = torch.stack([pr.sum(dim=1, dtype=acc_dt),
                           pi.sum(dim=1, dtype=acc_dt)], dim=-1)
    else:
        raise ValueError(f"unknown fir kind {kind}")
    return acc >> half_shift
