"""Filter cores (the port of the JAX package's ``ops/filter.py``): the
polyphase rational-resampling FIR (``polyphase_fir``, ``fir_tap_state``),
the moving-average cascade of DC removal and the envelope follower.

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
from pothoscomms_tpu_torch.kernels.envelope import envelope_rows


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


# ---------------------------------------------------------------------- #
# Moving average cascade / DC removal
# ---------------------------------------------------------------------- #
def _trunc_div(a, d: int, is_int: bool):
    if is_int:
        return torch.div(a, d, rounding_mode="trunc")  # C's /, not floor
    return a / d


def moving_average_stage(ext: torch.Tensor, depth: int,
                         is_int: bool) -> torch.Tensor:
    """One moving-average stage over ``ext`` = [depth hist, N new samples]
    in the accumulator dtype. Returns the N window-average outputs
    (exact vs the reference's integrator+comb: the running integrator
    telescopes to a width-``depth`` rolling sum, identically mod 2^bits).
    Integer sums are taken in int64 and wrapped back to the accumulator
    type, so a prefix sum that overflows it still gives the window sum
    mod 2^bits. Float sums are taken in double width and rounded once
    (:func:`window_sum`)."""
    n = ext.shape[0] - depth
    if is_int:
        csum = torch.cumsum(ext, dim=0, dtype=torch.int64)
        s = (csum[depth:] - csum[:n]).to(ext.dtype)
    else:
        s = window_sum(ext, depth, dim=0)
    return _trunc_div(s, depth, is_int)


def window_sum(ext: torch.Tensor, depth: int, dim: int) -> torch.Tensor:
    """Width-``depth`` rolling sums along ``dim`` of a float tensor, as
    the difference of two prefix sums taken in float64 (complex128) and
    rounded once to ``ext``'s type.

    The JAX package takes the prefix sums in float32: a prefix sum grows
    with the stream's mean, and the difference of two then loses the
    window sum's low bits. With a mean of 0.25 the fused DC removal's
    error reaches 1e-2 at a 2^24-sample pull (7e-5 at 131072); in double
    width it stays at float32 rounding."""
    wide = torch.complex128 if ext.is_complex() else torch.float64
    csum = torch.cumsum(ext, dim=dim, dtype=wide)
    n = ext.shape[dim] - depth
    return (csum.narrow(dim, depth, n) - csum.narrow(dim, 0, n)).to(ext.dtype)


def dc_removal(x_acc: torch.Tensor, hists: torch.Tensor, depth: int,
               cascade: int, is_int: bool):
    """DC removal cascade (reference: filter/DCRemoval.cpp:100-110).

    x_acc: [N(, 2)] new samples in accumulator dtype. hists: [cascade,
    depth(, 2)] per-stage input history (oldest first). Returns (y,
    new_hists) where y[i] = delayed_input - dc_estimate: stage0 input
    delayed by depth-1 minus the cascaded average (narrowing happens in
    the caller).
    """
    new_hists = []
    cur = x_acc
    delayed = None
    for s in range(cascade):
        ext = torch.cat([hists[s], cur])
        avg = moving_average_stage(ext, depth, is_int)
        new_hists.append(ext[-depth:])
        if s == 0:
            # filters[0].front() after update at step i = ext[i+1]
            delayed = ext[1:1 + x_acc.shape[0]]
        cur = avg
    return delayed - cur, torch.stack(new_hists)


# ---------------------------------------------------------------------- #
# Envelope follower (the E1 kernel on CUDA, kernels/envelope.py)
# ---------------------------------------------------------------------- #
def envelope_scan(xabs: torch.Tensor, env0, attack_gain, release_gain):
    """Attack/release envelope (reference: EnvelopeDetector.cpp:131-143),
    the plain sequential scan. xabs: [N] float magnitudes with a scalar
    env0, or [C, N] rows with env0 [C]. Returns (y, env_f) of the same
    ranks."""
    rows = xabs.reshape(-1, xabs.shape[-1]).contiguous()
    e0 = torch.as_tensor(env0, dtype=torch.float32,
                         device=xabs.device).reshape(rows.shape[0])
    y, env_f = envelope_rows(rows, e0.contiguous(), attack_gain,
                             release_gain, max(rows.shape[1], 1), 0)
    if xabs.dim() == 1:
        return y[0], env_f[0]
    return y, env_f


def envelope_warmup(attack: float, release: float) -> int:
    """Samples after which the follower's initial condition decays below
    f32 resolution: |d env_N / d env_0| <= max(ga, gr)^N < 2^-25 at
    N = 25 ln2 * tau_max. Rounded up to a multiple of 256."""
    tau = max(attack, release, 1.0)
    w = int(np.ceil(25.0 * np.log(2.0) * tau))
    return ((w + 255) // 256) * 256


def envelope_blocked(xabs: torch.Tensor, env0: torch.Tensor, attack_gain,
                     release_gain, L: int, W: int):
    """Blocked-parallel attack/release follower.

    The recurrence env' = g(x, env) env + (1-g) x is nonlinear (g picks
    attack/release by comparing x to env) so no associative scan exists
    — but it is CONTRACTIVE: both slopes are < 1, so the initial
    condition washes out below f32 resolution within W samples
    (envelope_warmup). Time is split into L-blocks and every block runs
    as an independent row, warm-started from the Wr samples before it (W
    rounded up to a whole number of L-blocks, as the JAX package does).
    Row 0's warmup is the CONSTANT env0 — a fixed point of the recurrence
    (x == env keeps env exactly), so the carried state stays exact across
    quanta.

    xabs: [P, T] (T % L == 0); env0: [P]. Returns (y [P, T], env [P]).
    """
    Wr = -(-W // L) * L
    return envelope_rows(xabs.contiguous(), env0.contiguous(), attack_gain,
                         release_gain, L, Wr)
