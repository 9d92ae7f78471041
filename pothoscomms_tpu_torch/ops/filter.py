"""Filter cores (the port of the JAX package's ``ops/filter.py``): the
polyphase rational-resampling FIR (``polyphase_fir``, ``fir_tap_state``)
and its blocked-Toeplitz product form (``rational_fir_mm``, on the K1
kernel), the IIR filter's direct form (``iir_df``, on the host) and
blocked state-space form (``iir_blocked_step``), the moving-average
cascade of DC removal and the envelope follower (the E1 kernel).

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

import collections
from typing import Tuple

import numpy as np
import torch

from pothoscomms_tpu_torch.core.dtypes import DType
from pothoscomms_tpu_torch.core.qformat import Q_ACCUMULATOR, float_to_q
from pothoscomms_tpu_torch.kernels.cgemm import cgemm
from pothoscomms_tpu_torch.kernels.envelope import envelope_rows
from pothoscomms_tpu_torch.parallel.profiling import annotate


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
# The rational resampler as a blocked-Toeplitz product (the K1 kernel on
# CUDA)
# ---------------------------------------------------------------------- #
def rational_fir_operators(taps, M: int, L: int, block_in: int = None):
    """Blocked-Toeplitz operators for the rational resampler as a
    product: over a block of B_in input samples producing
    B_out = B_in*L/M outputs,

        y_blk = x_blk @ T0 + prev_tail @ T1,

    with T0 [B_in, B_out], T1 [K-1, B_out] built from the polyphase map
    (filter/FIRFilter.cpp:286-302: output t at upsampled position
    u = t*M + M-1, y[t] = sum_k taps[u%L + k*L] * x[u//L - k]).

    Returns (t0 planar [B_in, B_out, 2], t1 planar [max(K-1, 1), B_out,
    2], B_in, B_out) as float32 tensors."""
    h = np.asarray(taps, np.complex128)
    # K = ceil(n/L) with zero padding, matching _polyphase_matrix
    K = len(h) // L + (0 if len(h) % L == 0 else 1)
    hp = np.zeros(K * L, np.complex128)
    hp[: len(h)] = h
    b_in = block_in or 128 * M
    if b_in % M:
        raise ValueError(f"block_in {b_in} is not a multiple of M={M}")
    b_out = (b_in // M) * L
    t0 = np.zeros((b_in, b_out), np.complex128)
    t1 = np.zeros((max(K - 1, 1), b_out), np.complex128)
    for t in range(b_out):
        u = t * M + (M - 1)
        n = u // L
        j = u % L
        for k in range(K):
            i = n - k
            c = hp[j + k * L]
            if i >= 0:
                t0[i, t] += c
            else:
                t1[(K - 1) + i, t] += c

    def planar(z):
        return torch.from_numpy(
            np.stack([z.real, z.imag], -1).astype(np.float32))

    return planar(t0), planar(t1), b_in, b_out


# The previous block's tail sits in the product's operand behind zero rows,
# up to a multiple of this width: N = tail + B_in then stays even, which K1
# needs for its tensor-core variant (kernels/cgemm.variant).
RATIONAL_TAIL_ROWS = 32


def stack_rational_operators(t0: torch.Tensor, t1: torch.Tensor):
    """(t0, t1) of :func:`rational_fir_operators` -> the stacked [T1; T0]
    planes (gr, gi), each [kp + B_in, B_out], T1's K-1 rows behind
    kp - (K-1) zero rows (kp: K-1 rounded up to RATIONAL_TAIL_ROWS)."""
    k1 = t1.shape[0]
    kp = -(-k1 // RATIONAL_TAIL_ROWS) * RATIONAL_TAIL_ROWS
    g = torch.cat([t1.new_zeros(kp - k1, t1.shape[1], 2), t1, t0])
    return g[..., 0].contiguous(), g[..., 1].contiguous()


def rational_operand(x: torch.Tensor, history: torch.Tensor, b_in: int,
                     kp: int) -> torch.Tensor:
    """The resampler product's left operand [C * T//b_in, kp + b_in, 2]:
    each input block behind the K-1 samples before it (the history before
    block 0), those behind kp - (K-1) zeros."""
    c, t, _ = x.shape
    k1 = history.shape[1]
    nb = t // b_in
    xb = x.reshape(c, nb, b_in, 2)
    prev = torch.cat([history[:, None], xb[:, :-1, b_in - k1:]], dim=1)
    a = torch.cat([x.new_zeros(c, nb, kp - k1, 2), prev, xb], dim=2)
    return a.reshape(c * nb, kp + b_in, 2)


def rational_fir_mm(x: torch.Tensor, history: torch.Tensor, gr, gi,
                    b_in: int, b_out: int):
    """Matmul rational resampler: x [C, T, 2] planar float32 with
    T % b_in == 0; history [C, K-1, 2] (the K-1 previous INPUT samples);
    (gr, gi) the stacked [T1; T0] of :func:`stack_rational_operators`, on
    x's device. Returns (y [C, T*b_out//b_in, 2], new_history),
    new_history the last K-1 inputs. The block and its tail are one
    operand against [T1; T0]: one product on the K1 kernel.

    The operand's build runs inside the span ``pc.op.rational_operand``;
    ``rational_fir_mm.by_shape`` counts the calls at each (C, T, b_in,
    b_out, K-1)."""
    c, t, _ = x.shape
    if t % b_in:
        raise ValueError(f"T={t} is not a multiple of the block {b_in}")
    with annotate("pc.op.rational_operand"):
        a = rational_operand(x, history, b_in, gr.shape[0] - b_in)
    y = cgemm(a, gr, gi).reshape(c, (t // b_in) * b_out, 2)
    rational_fir_mm.by_shape[(c, t, b_in, b_out, history.shape[1])] += 1
    return y, x[:, t - history.shape[1]:].contiguous()


rational_fir_mm.by_shape = collections.Counter()


# ---------------------------------------------------------------------- #
# IIR direct form (spuce iir_df equivalent) and its blocked state-space
# form
# ---------------------------------------------------------------------- #
def iir_df(x, b, a, z0):
    """Direct-form II transposed IIR over a block, on the host.

    x: [N] (complex or real, any width — computed in double like spuce's
    ``iir_df<Type, double>``); b: [nb] float64; a: [na] float64 (a[0]=1);
    z0: [order] state (complex128 or float64). Numpy arrays or CPU
    tensors. The recursion, per sample:

        y = b0 x + z[0];   z' = b[1:] x - a[1:] y + (z[1:], 0)

    run by ``scipy.signal.lfilter``, whose state is this z. Returns
    (y, z_final) as CPU tensors of z0's dtype; the caller narrows y to the
    stream dtype."""
    from scipy.signal import lfilter

    z = np.asarray(z0)
    order = z.shape[0]
    bp = np.zeros(order + 1)
    ap = np.zeros(order + 1)
    b, a = np.asarray(b, np.float64), np.asarray(a, np.float64)
    bp[: b.shape[0]] = b
    ap[: a.shape[0]] = a
    xs = np.asarray(x).astype(z.dtype, copy=False)
    y, zf = lfilter(bp, ap, xs, zi=z)
    return (torch.from_numpy(np.asarray(y, z.dtype)),
            torch.from_numpy(np.asarray(zf, z.dtype)))


def iir_blocked_operators(b: np.ndarray, a: np.ndarray, L: int):
    """Blocked state-space operators for the parallel IIR core.

    The DF-II-T recursion is linear: z_{n+1} = A z_n + g x_n,
    y_n = z_n[0] + b0 x_n, with
      A[i, 0] = -a[i+1], A[i, i+1] = 1;  g[i] = b[i+1] - a[i+1] b0.
    Over a block of L samples this is exact linear algebra (only float32
    rounding at use):
      y_block = Wz @ z_k + Hmat @ x_block         (per block, parallel)
      z_{k+1} = M z_k + G @ x_block               (block recurrence)
    where h[0] = b0, h[d] = (A^{d-1} g)[0] (the truncated impulse
    response), Hmat[j, m] = h[j-m] (lower-triangular Toeplitz),
    Wz[j] = (A^j)[0, :], M = A^L, G[:, j] = A^{L-1-j} g. The block
    recurrence has a constant M, so it runs as a log-depth scan
    (:func:`iir_block_scan`). All operators computed here in float64.

    Returns (Hmat [L, L], Wz [L, O], M [O, O], G [O, L]) as float64.
    """
    b = np.asarray(b, np.float64)
    a = np.asarray(a, np.float64)
    order = max(len(b), len(a)) - 1
    order = max(order, 1)
    bp = np.zeros(order + 1)
    bp[: len(b)] = b
    ap = np.zeros(order + 1)
    ap[: len(a)] = a
    A = np.zeros((order, order))
    A[:, 0] = -ap[1:]
    if order > 1:
        A[: order - 1, 1:] += np.eye(order - 1)
    g = bp[1:] - ap[1:] * bp[0]
    pw = [np.eye(order)]
    for _ in range(L):
        pw.append(A @ pw[-1])
    h = np.zeros(L)
    h[0] = bp[0]
    for d in range(1, L):
        h[d] = (pw[d - 1] @ g)[0]
    Hmat = np.zeros((L, L))
    for j in range(L):
        Hmat[j, : j + 1] = h[: j + 1][::-1]
    Wz = np.stack([pw[j][0, :] for j in range(L)])
    M = pw[L]
    G = np.stack([pw[L - 1 - j] @ g for j in range(L)], axis=1)
    return Hmat, Wz, M, G


def iir_scan_powers(M: np.ndarray, nb: int) -> np.ndarray:
    """M^(2^j) for j < ceil(log2 nb), [J, O, O], by repeated squaring in
    float64: the scan's operators for ``nb`` blocks."""
    M = np.asarray(M, np.float64)
    out = []
    p = M
    while (1 << len(out)) < nb:
        out.append(p)
        p = p @ p
    return np.stack(out) if out else np.zeros((0,) + M.shape)


def iir_block_scan(u: torch.Tensor, z0: torch.Tensor, M: torch.Tensor,
                   powers: torch.Tensor) -> torch.Tensor:
    """The block states z_{k+1} = M z_k + u_k, k = 0..nb-1, for u [nb, O,
    P] and z0 [O, P]: [nb, O, P]. M z0 joins u_0, then a log-depth
    doubling scan: in round j, w[s:] += M^s w[:-s] with s = 2^j and M^s
    = ``powers[j]`` (:func:`iir_scan_powers`), so ceil(log2 nb) rounds of
    one batched product each, not nb steps."""
    w = u.clone()
    w[0] += M @ z0
    nb = w.shape[0]
    j = 0
    while (1 << j) < nb:
        s = 1 << j
        # the product reads the old w[:-s] in full before the add
        w[s:] += torch.matmul(powers[j], w[:-s])
        j += 1
    return w


def iir_blocked_step(xp: torch.Tensor, z0: torch.Tensor, Hmat, Wz, M, G,
                     L: int, powers: torch.Tensor):
    """One blocked-IIR quantum: xp [P, T] planes (T % L == 0), z0 [O, P]
    state -> (y [P, T], z_final [O, P]). Fully parallel: the block
    products (plain float32 ``torch.matmul`` / ``einsum``; TF32 stays
    off) and the log-depth block scan over T/L blocks. ``powers``: the
    scan's M^(2^j) for at least T/L blocks (:func:`iir_scan_powers`),
    float32 on xp's device.

    The block products run inside the span ``pc.op.iir_products`` (one
    before the scan, one after), the scan inside ``pc.op.iir_scan``;
    ``iir_blocked_step.by_shape`` counts the calls at each (P, T, L,
    order), which sets the scan's rounds: ``(T // L - 1).bit_length()``."""
    P, t = xp.shape
    nb = t // L
    xb = xp.reshape(P, nb, L)
    with annotate("pc.op.iir_products"):
        u = torch.einsum("pnl,ol->nop", xb, G)             # [nb, O, P]
    with annotate("pc.op.iir_scan"):
        z_next = iir_block_scan(u, z0, M, powers)           # z_{k+1}
    with annotate("pc.op.iir_products"):
        zs = torch.cat([z0[None], z_next[:-1]])             # z_k per block
        y = (torch.einsum("jo,kop->pkj", Wz, zs)
             + torch.einsum("jm,pkm->pkj", Hmat, xb))
    iir_blocked_step.by_shape[(P, t, L, z0.shape[0])] += 1
    return y.reshape(P, t), z_next[-1]


iir_blocked_step.by_shape = collections.Counter()


# block lengths of the blocked form, tried in order (the largest dividing
# a quantum wins); each is a one-time host precompute and an L x L
# operator on the device
IIR_BLOCK_LENGTHS = (256, 128, 64, 32)


def iir_block_length(t: int):
    """The first of ``IIR_BLOCK_LENGTHS`` that divides ``t`` samples, or
    None."""
    return next((c for c in IIR_BLOCK_LENGTHS if t % c == 0 and t >= c),
                None)


def iir_blocked_operators32(b, a, L: int):
    """The blocked form's operators for block length ``L`` in float32
    (:func:`iir_blocked_operators`, then the scan's M^(2^j) for up to
    2^31 blocks): (Hmat, Wz, M, G, powers) as numpy arrays, or None where
    one of the first four is not finite in float32 (an unstable or
    marginal filter overflows the A^j powers; checked after the cast,
    since finite float64 values can still overflow float32)."""
    ops = iir_blocked_operators(b, a, L)
    with np.errstate(over="ignore", invalid="ignore"):
        ops32 = tuple(m.astype(np.float32) for m in ops) + (
            iir_scan_powers(ops[2], 1 << 31).astype(np.float32),)
    ok = all(np.all(np.isfinite(m)) for m in ops32[:4])
    return ops32 if ok else None


def iir_blocked_rows(x: torch.Tensor, z: torch.Tensor, ops, L: int):
    """The blocked form over rows: x [R, T] (real) or [R, T, 2] (complex,
    interleaved), z [O, R] or [O, R, 2], ``ops`` the float32 operators of
    :func:`iir_blocked_operators32` as tensors on x's device, L dividing
    T -> (y like x, z_final like z). Complex rows run as planes ordered
    (r0 re, r0 im, r1 re, ...), row-major over the trailing axis in both x
    and z."""
    H, Wz, M, G, powers = ops
    if x.dim() == 2:
        return iir_blocked_step(x, z, H, Wz, M, G, L, powers)
    R, t = x.shape[:2]
    order = z.shape[0]
    yp, zf = iir_blocked_step(x.permute(0, 2, 1).reshape(R * 2, t),
                              z.reshape(order, R * 2), H, Wz, M, G, L,
                              powers)
    return (yp.reshape(R, 2, t).permute(0, 2, 1).contiguous(),
            zf.reshape(order, R, 2))


def iir_df_rows(x: torch.Tensor, z: torch.Tensor, bp: torch.Tensor,
                ap: torch.Tensor):
    """The DF-II-T recursion sample by sample over rows, x [R, T, ...]
    and z [O, R, ...], with bp, ap [O + 1] normalised taps on x's device
    -> (y like x, z_final like z). A Python loop of T steps: slow on a
    card."""
    order = z.shape[0]
    bcol = bp[1:].reshape((order,) + (1,) * (x.dim() - 1))
    acol = ap[1:].reshape((order,) + (1,) * (x.dim() - 1))
    ys = []
    for n in range(x.shape[1]):
        xn = x[:, n]
        yn = bp[0] * xn + z[0]
        z = bcol * xn[None] - acol * yn[None] + torch.cat(
            [z[1:], torch.zeros_like(z[:1])])
        ys.append(yn)
    return torch.stack(ys, dim=1), z


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


def dc_removal_rows(x: torch.Tensor, hists: torch.Tensor, depth: int,
                    cascade: int):
    """The fused DC removal over rows (``DCRemoval.device_core``): x
    [C, T(, 2)] float32, hists [cascade, C, depth(, 2)], each stage's last
    ``depth`` inputs. Each stage is a moving average of width ``depth``
    over [history, input] (:func:`window_sum`, so in float64, then / depth
    in float32); returns (y, new_hists) with y = the input delayed by
    depth - 1 minus the last stage's average (``dc_removal``'s algebra)."""
    cur = x
    new_hists = []
    delayed = None
    for s in range(cascade):
        ext = torch.cat([hists[s], cur], dim=1)
        avg = window_sum(ext, depth, dim=1) / depth
        new_hists.append(ext[:, -depth:])
        if s == 0:
            delayed = ext[:, 1:1 + x.shape[1]]
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
