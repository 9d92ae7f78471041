"""I1: the direct form II transposed IIR recurrence over rows of float32
samples, with its state carried (``csrc/iir_df2t.cu``), the fused IIR
core of ``blocks/filter.IIRFilter.device_core`` on a card.

For each row of x [R, T, W] (W = 2: interleaved complex, both planes
through the same real taps; W = 1: a real row) and state z [O, R, W]:

    y = b0 x + z[0];   z' = b[1:] x - a[1:] y + (z[1:], 0)

with b, a the normalised taps (a[0] = 1), each O + 1 long: what
``ops/filter.iir_df`` (scipy ``lfilter``) computes. Returns y [R, T, W]
and the new state [O, R, W], both fresh.

:func:`iir_df2t` launches the kernel for CUDA tensors and runs
:func:`iir_df2t_plain` (the blocked state-space form the core ran before,
``ops/filter.iir_blocked_step``) for CPU tensors; any other device, a
wrong dtype or shape, a non-contiguous operand, or taps whose tables
overflow float32 or on which the kernel's algorithm strays (:func:`stray`)
raise. One library holds the kernel at every order and width. It replaces
no Pallas kernel: the JAX package runs this IIR as the XLA ops of
``iir_blocked_step``.
"""

from __future__ import annotations

import ctypes
from collections import namedtuple
from functools import lru_cache

import numpy as np
import torch

from pothoscomms_tpu_torch.kernels import build
from pothoscomms_tpu_torch.ops import filter as fops
from pothoscomms_tpu_torch.parallel import profiling
from pothoscomms_tpu_torch.parallel.profiling import (
    annotate, first_launch, launching)

MAX_ORDER = 8      # csrc/iir_df2t.cu kMaxOrder: the state in registers
CHUNK = 32         # csrc kChunk: samples a thread runs
THREADS = 128      # csrc kThreads: threads a block
ROUNDS = 7         # csrc kRounds: the scan's rounds, log2(THREADS)
SLOTS = 2          # csrc kSlots: tiles of a block's shared-memory ring
TILE = THREADS * CHUNK
BLOCKS_AN_SM = 2   # the plan's shared memory keeps two blocks on an SM
MAX_FLOATS = 1 << 31  # the kernel indexes a row with 32-bit ints
# the most the kernel's algorithm on its float32 tables may move a probe's
# output or end state off the float64 recursion, as a share of its largest
# value (:func:`stray`); the resampler bank's elliptic order-6 low-pass
# reads ~5e-6
STRAY = 1e-5

Plan = namedtuple("Plan", "tile ntiles segs seg_tiles smem")


def fits(order: int, t: int) -> bool:
    """Whether I1 takes a filter of ``order`` over rows of ``t`` samples
    (of up to two planes)."""
    return 1 <= order <= MAX_ORDER and 1 <= t and 2 * t < MAX_FLOATS


@lru_cache(maxsize=None)
def plan(order: int, t: int, width: int, rows: int = 1, sms: int = 1) -> Plan:
    """The launch of I1 over ``rows`` rows of ``t`` samples of ``width``
    planes on a card of ``sms`` SMs: ``ntiles`` tiles of ``tile`` samples
    a row (THREADS chunks of CHUNK samples), the last holding the
    remaining t - (ntiles - 1) tile samples (a shorter last chunk, threads
    past it idle). Where the rows are too few to give the card its
    BLOCKS_AN_SM blocks an SM, a row is cut into ``segs`` segments of
    ``seg_tiles`` tiles (the last may have fewer), a block each, and the
    kernel runs twice (the segments' end states, then the rows); else
    ``segs`` is 1. ``smem``: a block's shared memory as csrc/iir_df2t.cu
    `smem_bytes` counts it, the ring of SLOTS tiles (each chunk padded by
    16 bytes), the scan's two buffers of order x width states a thread,
    and the carried state."""
    if not fits(order, t) or width not in (1, 2) or rows < 1 or sms < 1:
        raise ValueError(f"iir_df2t: no plan for order {order}, T={t}, "
                         f"width {width}, {rows} rows, {sms} SMs")
    ntiles = -(-t // TILE)
    want = min(ntiles, max(1, BLOCKS_AN_SM * sms // rows))
    seg_tiles = -(-ntiles // want)
    ow = order * width
    smem = 4 * (SLOTS * THREADS * (CHUNK * width + 4) + 2 * ow * THREADS
                + -(-ow // 4) * 4)
    return Plan(TILE, ntiles, -(-ntiles // seg_tiles), seg_tiles, smem)


def tables(b, a, seg_len: int = 0):
    """The kernel's coefficients for taps b, a (O + 1 each, a[0] = 1) as
    one float32 array: b and -a (the recurrence's taps, rounded), the
    chunk's end-state map G [O, CHUNK] (G[:, j] = A^(CHUNK-1-j) g), the
    scan's ROUNDS powers (A^CHUNK)^(2^r) [ROUNDS, O, O] and A^seg_len
    [O, O] (a segment's samples, a multiple of the chunk; zero for 0),
    these computed in float64 from the taps as given and then rounded, as
    the blocked form's operators are. None where a table is not finite in
    float32 (an unstable filter) or where the algorithm on them strays
    past STRAY (:func:`stray`: an ill-conditioned filter). Each is
    computed once for its taps (and ``seg_len``), inside the build span
    ``pc.build.iir_df2t.tables``, and the stray inside
    ``pc.build.iir_df2t.stray``: at the IIR core's first step, which asks
    :func:`engages`."""
    key = (tuple(np.asarray(b, np.float64).tolist()),
           tuple(np.asarray(a, np.float64).tolist()))
    coef = _tables(*key, seg_len)
    return None if coef is None or _stray(*key) > STRAY else coef


@lru_cache(maxsize=64)
def _tables(b, a, seg_len):
    with profiling.build("pc.build.iir_df2t.tables", key=(b, a, seg_len)):
        return _tables_f32(b, a, seg_len)


def _tables_f32(b, a, seg_len):
    b64, a64 = np.array(b), np.array(a)
    order = len(b64) - 1
    _, _, m, g = fops.iir_blocked_operators(b64, a64, CHUNK)
    with np.errstate(over="ignore", invalid="ignore"):
        p = fops.iir_scan_powers(m, THREADS)
        pseg = (np.linalg.matrix_power(m, seg_len // CHUNK) if seg_len
                else np.zeros((order, order)))
        out = np.concatenate([b64, -a64, g.ravel(), p.ravel(),
                              pseg.ravel()]).astype(np.float32)
    return out if np.all(np.isfinite(out)) else None


def emulate(x: np.ndarray, z: np.ndarray, coef: np.ndarray):
    """The kernel's algorithm over one row of one plane, x [T] from state
    z [O], on the table ``coef`` (as :func:`tables` lays it out, read in
    float64): each tile's chunks' zero-state end states by G, the carried
    state joined to chunk 0 and the Hillis-Steele scan with the powers,
    each chunk re-run by the recurrence on the table's taps from its start
    state; the state carried to the next tile the scan's where the tile
    ends a chunk, else the recurrence's. The arithmetic is float64, so
    what it departs from the float64 recursion is the tables' rounding.
    Returns (y [T], z_final [O])."""
    coef = np.asarray(coef, np.float64)
    order = len(z)
    o1 = order + 1
    b, na = coef[:o1], coef[o1:2 * o1]
    g = coef[2 * o1:2 * o1 + order * CHUNK].reshape(order, CHUNK)
    p = coef[2 * o1 + order * CHUNK:].reshape(ROUNDS + 1, order, order)
    t = len(x)
    y = np.empty(t)
    zc = np.asarray(z, np.float64)
    for t0 in range(0, t, TILE):
        n = min(TILE, t - t0)
        xc = np.zeros(TILE)
        xc[:n] = x[t0:t0 + n]
        xc = xc.reshape(THREADS, CHUNK)
        w = xc @ g.T
        w[0] += p[0] @ zc
        for r in range(ROUNDS):
            d = 1 << r
            w[d:] = w[d:] + w[:-d] @ p[r].T
        zs = np.concatenate([zc[None], w[:-1]]).T.copy()  # [O, THREADS]
        yc = np.empty((THREADS, CHUNK))
        for j in range(CHUNK):
            yc[:, j] = b[0] * xc[:, j] + zs[0]
            zs = np.concatenate([zs[1:], np.zeros((1, THREADS))]) \
                + b[1:, None] * xc[:, j] + na[1:, None] * yc[:, j]
            if j + 1 == n % CHUNK and t0 + TILE >= t:
                ragged = zs[:, (n - 1) // CHUNK].copy()
        y[t0:t0 + n] = yc.ravel()[:n]
        zc = w[(n - 1) // CHUNK] if n % CHUNK == 0 else ragged
    return y, zc


def stray(b, a) -> float:
    """How far the kernel's algorithm on I1's float32 tables for taps b, a
    (:func:`emulate`) moves a probe off scipy's float64 ``lfilter``: the
    larger of its output's and its end state's largest difference, each
    as a share of the largest value. The probe: 2 tiles and 17 samples of
    white noise (so the end state is the recurrence's, over a ragged
    chunk) from the state 2048 samples of noise leave. inf where a table
    is not finite."""
    return _stray(tuple(np.asarray(b, np.float64).tolist()),
                  tuple(np.asarray(a, np.float64).tolist()))


@lru_cache(maxsize=64)
def _stray(b, a) -> float:
    with profiling.build("pc.build.iir_df2t.stray", key=(b, a)):
        return _stray_probe(b, a)


def _stray_probe(b, a) -> float:
    from scipy.signal import lfilter

    coef = _tables(b, a, 0)
    if coef is None:
        return float("inf")
    rng = np.random.default_rng(0)
    order = len(b) - 1
    _, z0 = lfilter(b, a, rng.standard_normal(2048), zi=np.zeros(order))
    x = rng.standard_normal(2 * TILE + 17)
    ye, ze = lfilter(b, a, x, zi=z0)
    with np.errstate(over="ignore", invalid="ignore"):
        y, zf = emulate(x, z0, coef)
        err = max(np.max(np.abs(y - ye)) / np.max(np.abs(ye)),
                  np.max(np.abs(zf - ze)) / np.max(np.abs(ze)))
    return float(err) if np.isfinite(err) else float("inf")


@lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _segment(shape, order: int, sms: int):
    """(plan, segment length in samples or 0) of I1 over rows of ``shape``
    ([R, T] or [R, T, W]) on a card of ``sms`` SMs."""
    R, t = shape[:2]
    width = shape[2] if len(shape) == 3 else 1
    p = plan(order, t, width, R, sms)
    return p, (p.seg_tiles * p.tile if p.segs > 1 else 0)


def takes(shape, b, a, sms: int) -> bool:
    """Whether I1 runs rows of ``shape`` ([R, T] real, or [R, T, W]) with
    taps b, a on a card of ``sms`` SMs: :func:`fits` at the taps' order
    and T, and :func:`tables` (finite, and not straying) for the launch's
    plan."""
    order = len(b) - 1
    if not fits(order, shape[1]):
        return False
    return tables(b, a, _segment(tuple(shape), order, sms)[1]) is not None


def engages(x: torch.Tensor, b, a) -> bool:
    """Whether ``IIRFilter``'s core runs x ([R, T] or [R, T, W]) through
    I1: x on a card and :func:`takes` there."""
    return x.is_cuda and takes(tuple(x.shape), b, a, _sms(x.device))


def _check(x, z, b, a):
    if x.dim() != 3 or x.shape[2] not in (1, 2):
        raise ValueError(f"iir_df2t: x must be [R, T, W] with W 1 or 2, "
                         f"got {tuple(x.shape)}")
    R, t, w = x.shape
    order = len(b) - 1
    if len(a) != order + 1 or not fits(order, t):
        raise ValueError(f"iir_df2t: takes b, a of one length O + 1 with "
                         f"1 <= O <= {MAX_ORDER} and 1 <= T, got "
                         f"{len(b)}, {len(a)} taps and T={t}")
    if a[0] != 1:
        raise ValueError("iir_df2t: the taps must be normalised (a[0] = 1)")
    if tuple(z.shape) != (order, R, w):
        raise ValueError(f"iir_df2t: z must be [{order}, {R}, {w}], got "
                         f"{tuple(z.shape)}")
    if x.dtype != torch.float32 or z.dtype != torch.float32:
        raise TypeError(f"iir_df2t: float32 only, got {x.dtype}, {z.dtype}")
    if x.device != z.device:
        raise ValueError("iir_df2t: x and z must be on one device")
    if not (x.is_contiguous() and z.is_contiguous()):
        raise ValueError("iir_df2t: x and z must be contiguous")


def iir_df2t_plain(x: torch.Tensor, z: torch.Tensor, b, a):
    """Plain PyTorch version of :func:`iir_df2t`, on x's device: the
    blocked state-space form (``ops/filter.iir_blocked_rows``, operators
    in float64 from the taps, cast to float32) where a block length of
    ``ops/filter.IIR_BLOCK_LENGTHS`` divides T and the operators are
    finite, else the recursion sample by sample (``iir_df_rows``). Both
    results are contiguous, as the kernel's are."""
    _check(x, z, b, a)
    b64, a64 = np.asarray(b, np.float64), np.asarray(a, np.float64)
    width = x.shape[2]
    L = fops.iir_block_length(x.shape[1])
    ops = fops.iir_blocked_operators32(b64, a64, L) if L else None
    if ops is not None:
        dev_ops = tuple(torch.from_numpy(m).to(x.device) for m in ops)
        if width == 2:
            y, zf = fops.iir_blocked_rows(x, z, dev_ops, L)
        else:
            y, zf = fops.iir_blocked_rows(x[..., 0], z[..., 0], dev_ops, L)
            y, zf = y[..., None], zf[..., None]
    else:
        bp = torch.from_numpy(b64.astype(np.float32)).to(x.device)
        ap = torch.from_numpy(a64.astype(np.float32)).to(x.device)
        y, zf = fops.iir_df_rows(x, z, bp, ap)
    return y.contiguous(), zf.contiguous()


def iir_df2t(x: torch.Tensor, z: torch.Tensor, b, a):
    """y [R, T, W] and the new state [O, R, W] of the DF-II-T recurrence
    over x [R, T, W] (float32, W = 1 or 2) from state z [O, R, W], with
    normalised taps b, a (O + 1 each, host sequences, float64 where the
    caller has them: the recurrence runs their float32 values, the scan's
    tables are computed from them in float64). Needs :func:`fits`."""
    _check(x, z, b, a)
    if x.device.type == "cpu":
        return iir_df2t_plain(x, z, b, a)
    if x.device.type != "cuda":
        raise ValueError(f"iir_df2t: no kernel for device {x.device}")
    if not iir_df2t.launches and iir_df2t not in launching:
        return first_launch(iir_df2t, x, z, b, a)
    if x.data_ptr() % 4 or z.data_ptr() % 4:
        raise ValueError("iir_df2t: x and z must be 4-byte aligned")
    R, t, width = x.shape
    order = len(b) - 1
    p, seg_len = _segment(x.shape, order, _sms(x.device))
    coef = tables(b, a, seg_len)
    if coef is None:
        raise ValueError("iir_df2t: the taps' tables overflow float32 or "
                         "the kernel strays on them (an unstable or "
                         "ill-conditioned filter)")
    if R * p.segs >= 2 ** 31:
        raise ValueError(f"iir_df2t: R={R} exceeds the kernel's grid")
    y = torch.empty_like(x)
    z_out = torch.empty_like(z)
    ends = x.new_empty((R, p.segs, order, width)) if p.segs > 1 else None
    with annotate("pc.kernel.iir_df2t"), torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry()(
            x.data_ptr(), z.data_ptr(), y.data_ptr(), z_out.data_ptr(),
            None if ends is None else ends.data_ptr(), R, t, order, width,
            coef.ctypes.data, coef.size, p.segs, p.seg_tiles, stream)
    build.check(err, "iir_df2t_f32")
    iir_df2t.launches += 2 if p.segs > 1 else 1
    return y, z_out


# kernel launches (a row in segments takes two a call)
iir_df2t.launches = 0


@lru_cache(maxsize=None)
def _entry():
    fn = build.load("iir_df2t").iir_df2t_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 2 \
        + [ctypes.c_int] * 2 + [ctypes.c_void_p] + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn
