"""S1: the frame-sync search over every candidate offset of every channel
(``csrc/sync_search.cu``).

It computes what the JAX package's ``sync_search_planar``
(``pothoscomms_tpu/ops/framing.py:37-119``, an XLA program, not a Pallas
kernel) computes, with the numerics of the reference's
digital/FrameSync.cpp:595-693: for each offset i of x [C, L, 2] it forms
the envelope-consistency windows and the scale estimate, the frequency
estimate from x[j] conj(x[j + w/2]) over the last preamble symbol, the
dechirped correlation of sw samples with the repeated preamble, and from
it the phase and the floored peak. :func:`sync_search` launches the CUDA
kernel for CUDA tensors and uses :func:`sync_search_plain`, torch ops
tiled over offsets and channels, only for CPU tensors; any other device
raises.

The JAX program takes its window sums and the frequency estimate's sum as
differences of float32 prefix sums over the whole bucket, whose
resolution falls as the bucket grows (at 32768 samples the prefix sums of
|x| reach ~1e4, where a float32 step is ~1e-3). The plain version takes
those prefix sums in float64; the kernel sums each window directly, and
takes the correlation by Horner's rule in blocks of taps (the source's
note). :func:`card_plan` reads the launch's plan, the offsets a thread and
the threads a block, from the compiled kernel; :func:`ops_per_offset` and
:func:`work` count the search's least work, the yardstick of its bound.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from pothoscomms_tpu_torch.kernels import build
from pothoscomms_tpu_torch.parallel import cplx
from pothoscomms_tpu_torch.parallel.profiling import (
    annotate, first_launch, launching)

# window samples in one tile of the plain version's correlation,
# [channels, offsets, sw]: each float32 plane of it is 64 MB
TILE_ELEMENTS = 1 << 24


def ops_per_offset(sw: int, w: int, dw: int, npre: int) -> int:
    """The search's least work an offset, in float32 operations: one
    complex multiply-add (8) a correlation tap (Horner's rule: the least
    any formulation needs; applying the preamble once a symbol is algebra,
    not work left out); K's product x[m] conj(x[m + w/2]) (6) and |x[m]|
    (4) once a sample, counted once an offset (n offsets read n + sw - 1
    samples); one complex add (2) a term of K and one add a term of each
    window sum, which stay direct sums (float32 running or prefix sums
    lose the windows at 32768 samples); ~20 for the rest (the divisions,
    two atan2, |L|); and one complex product for each preamble symbol
    after the first. 806 at the link's sw = w = 80, dw = 4, npre = 1."""
    half = w // 2
    return 8 * sw + 6 + 4 + 2 * (half - 2 * dw) + 2 * (half - dw) + 20 \
        + 8 * (npre - 1)


def work(C: int, L: int, n: int, sw: int, w: int, dw: int, npre: int):
    """(bytes, operations) of one search of C channels of L samples at n
    offsets: x read once, four [C, n] float32 outputs written once;
    :func:`ops_per_offset` an offset."""
    return C * L * 8 + 4 * C * n * 4, C * n * ops_per_offset(sw, w, dw,
                                                             npre)


def _check(x, pre, sw, w, dw, npre, n):
    if x.dim() != 3 or x.shape[-1] != 2 or pre.shape != (npre, 2):
        raise ValueError(f"sync_search: x must be [C, L, 2] and pre "
                         f"[{npre}, 2], got {tuple(x.shape)} and "
                         f"{tuple(pre.shape)}")
    if x.dtype != torch.float32 or pre.dtype != torch.float32:
        raise TypeError(f"sync_search: float32 only, got {x.dtype}, "
                        f"{pre.dtype}")
    if x.device != pre.device:
        raise ValueError("sync_search: x and pre must be on one device")
    if not (sw == w * npre and w % 2 == 0 and 0 <= dw < w // 2 - dw
            and n >= 0):
        raise ValueError(f"sync_search: need sw = w * npre, w even and "
                         f"0 <= dw < w/2 - dw, got sw={sw} w={w} dw={dw} "
                         f"npre={npre}")
    if n and x.shape[1] < n + sw - 1:
        raise ValueError(f"sync_search: {n} offsets need L >= "
                         f"{n + sw - 1} samples, got {x.shape[1]}")


def sync_search_plain(x: torch.Tensor, pre: torch.Tensor, thr: float,
                      sw: int, w: int, dw: int, npre: int, n: int):
    """Plain PyTorch version of :func:`sync_search`: the JAX program's
    formulas in torch ops, its prefix sums in float64, the correlation
    tiled over channels and offsets so one tile's window planes stay at
    :data:`TILE_ELEMENTS` samples."""
    _check(x, pre, sw, w, dw, npre, n)
    C = x.shape[0]
    dev = x.device
    i = torch.arange(n, device=dev)
    absx = cplx.cabs(x)                                  # [C, L]
    cs = torch.nn.functional.pad(torch.cumsum(absx.double(), dim=1), (1, 0))

    def winsum(lo, hi):
        return (cs[:, i + hi] - cs[:, i + lo]).float()

    # envelope consistency + scale estimate (reference :596-634); the
    # symbol span in samples is w = symbol_width * data_width
    begin0, end0 = dw, w // 2
    sum0 = winsum(begin0, end0) / (end0 - begin0)
    begin1, end1 = sw - w // 2, sw - dw
    sum1 = winsum(begin1, end1) / (end1 - begin1)
    p_abs_f = cplx.cabs(pre[0])
    p_abs_l = cplx.cabs(pre[-1])
    ok = (absx[:, i + dw] >= thr) & (absx[:, i + sw - dw] >= thr)
    ok &= sum0 >= thr
    s0 = sum0 / p_abs_f
    ok &= sum1 >= thr
    s1 = sum1 / p_abs_l
    safe_s1 = torch.where(s1 == 0, 1.0, s1)
    ratio = torch.where(s1 != 0, s0 / safe_s1, torch.inf)
    ok &= (ratio <= 2) & (ratio >= 0.5)
    scale = torch.where(ok, 2.0 / torch.where(ok, s0 + s1, 1.0), 0.0)

    # frequency-offset estimate (reference :640-664): the sum of
    # y[j] = x[j] conj(x[j + delta]) across the final preamble symbol
    delta = w // 2
    y = cplx.mul(x[:, :-delta], cplx.conj(x[:, delta:]))
    cy = torch.nn.functional.pad(torch.cumsum(y.double(), dim=1),
                                 (0, 0, 1, 0))
    off = w * (npre - 1)
    lo, hi = off + dw, off + w - delta - dw
    K = (cy[:, i + hi] - cy[:, i + lo]).float()
    delta_fc = torch.where(scale != 0,
                           torch.atan2(K[..., 1], K[..., 0]) / delta, 0.0)

    # frequency-corrected (dechirped) correlation (reference :670-693)
    j = torch.arange(sw, device=dev, dtype=torch.float32)
    conj_p = cplx.conj(torch.repeat_interleave(pre, w, dim=0))   # [sw, 2]
    xr = x[..., 0].unfold(1, sw, 1)                  # [C, L - sw + 1, sw]
    xi = x[..., 1].unfold(1, sw, 1)
    Ls = torch.empty((C, n, 2), dtype=torch.float32, device=dev)
    tile = max(1, min(n, TILE_ELEMENTS // sw))
    ct = max(1, TILE_ELEMENTS // (tile * sw))
    for c0 in range(0, C, ct):
        for t0 in range(0, n, tile):
            cs_, ts_ = slice(c0, c0 + ct), slice(t0, min(t0 + tile, n))
            frames = torch.stack([xr[cs_, ts_], xi[cs_, ts_]], dim=-1)
            ang = delta_fc[cs_, ts_, None] * j
            rot = torch.stack([torch.cos(ang), torch.sin(ang)], dim=-1)
            prod = cplx.mul(cplx.mul(frames, rot), conj_p)
            Ls[cs_, ts_] = prod.sum(dim=2)
    L = Ls * scale[..., None]
    phase_off = -torch.atan2(L[..., 1], L[..., 0])
    corr_peak = torch.where(scale != 0, torch.floor(cplx.cabs(L)), 0.0)
    return scale, delta_fc, phase_off, corr_peak


def sync_search(x: torch.Tensor, pre: torch.Tensor, thr: float, sw: int,
                w: int, dw: int, npre: int, n: int):
    """Frame-search arrays for offsets 0 .. n-1 of every channel.

    x: [C, L, 2] planar float32 with L >= n + sw - 1; pre: [npre, 2] the
    planar preamble; sw = w * npre samples of sync word, w samples a
    preamble symbol, dw samples a data bit; thr the input threshold.
    Returns (scale, delta_fc, phase_off, corr_peak), each [C, n] float32
    (corr_peak floored to the reference's integer). On CUDA x and pre
    must be contiguous; a sync word too long for one block's shared
    memory (~19000 samples) makes the launch fail, and the call raise.
    """
    _check(x, pre, sw, w, dw, npre, n)
    if x.device.type == "cpu":
        return sync_search_plain(x, pre, thr, sw, w, dw, npre, n)
    if x.device.type != "cuda":
        raise ValueError(f"sync_search: no kernel for device {x.device}")
    if not sync_search.launches and sync_search not in launching:
        return first_launch(sync_search, x, pre, thr, sw, w, dw, npre, n)
    if not (x.is_contiguous() and pre.is_contiguous()):
        raise ValueError("sync_search: x and pre must be contiguous")
    C, L = x.shape[0], x.shape[1]
    if C >= 65536:
        raise ValueError(f"sync_search: {C} channels exceed the grid")
    outs = torch.empty((4, C, n), dtype=torch.float32, device=x.device)
    if n:
        with annotate("pc.kernel.sync_search"), \
                torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = _entry()(x.data_ptr(), pre.data_ptr(), outs.data_ptr(),
                           C, L, n, sw, w, dw, npre, float(thr), stream)
        build.check(err, "sync_search_f32")
        sync_search.launches += 1
    return outs[0], outs[1], outs[2], outs[3]


sync_search.launches = 0


@lru_cache(maxsize=None)
def _entry():
    fn = build.load("sync_search").sync_search_f32
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 7 \
        + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def card_plan(C: int, n: int, w: int) -> tuple[int, int]:
    """(k, threads): the compiled kernel's plan (``sync_search_plan``)
    for C channels of n offsets at symbol width w, k consecutive offsets a
    thread and the threads a block."""
    fn = build.load("sync_search").sync_search_plan
    fn.argtypes = [ctypes.c_longlong] * 3 + [ctypes.POINTER(ctypes.c_int)] * 2
    fn.restype = None
    k, threads = ctypes.c_int(), ctypes.c_int()
    fn(C, n, w, ctypes.byref(k), ctypes.byref(threads))
    return k.value, threads.value
