"""K2: batched complex FFT on interleaved complex f32 (``csrc/fft.cu``).

The counterpart of ``fft_fused_pallas`` / ``fft_planar_fused`` in
``pothoscomms_tpu/parallel/pallas_kernels.py``. :func:`fft_c2c` launches
the CUDA kernel for a CUDA tensor and uses :func:`fft_c2c_plain` only for
a CPU tensor; any other device raises.

:func:`fft_c2c_plain` is the JAX package's DFT-matmul factorization
(``pothoscomms_tpu/parallel/fft.py:74-104``) written with
``torch.matmul``; its DFT and twiddle tables are built by the same numpy
code, so they equal the JAX package's bit for bit.

The kernel is a mixed-radix Stockham FFT whose plan is built here
(:func:`stockham_plan`): the radices (:func:`fft_plan`), the per-pass
twiddle tables in float64 rounded to f32, the magic numbers of its
divisions and the shared-memory offsets of its exchanges, which come from
:func:`smem_swizzle`, the Python copy of ``csrc/smem_layout.cuh``. An n
with a prime factor above 7 has no plan and takes the kernel's direct
DFT.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from pothoscomms_tpu_torch.kernels import build
from pothoscomms_tpu_torch.kernels.cgemm import cgemm_plain
from pothoscomms_tpu_torch.parallel.profiling import (
    annotate, first_launch, launching)

MAX_N = 4096  # largest row the kernel holds in shared memory


@lru_cache(maxsize=64)
def dft_matrices(n: int, inverse: bool):
    """Real/imag parts of the DFT matrix W[j,k] = exp(-+2pi i jk/n), as
    float32 numpy arrays."""
    j, k = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    sign = 2.0 if inverse else -2.0
    w = np.exp(sign * 1j * np.pi * j * k / n)
    return (w.real.astype(np.float32), w.imag.astype(np.float32))


@lru_cache(maxsize=64)
def _twiddles(n1: int, n2: int, inverse: bool):
    """W_N^{k1*n2} as [N1, N2] numpy planar pair."""
    k1, n2i = np.meshgrid(np.arange(n1), np.arange(n2), indexing="ij")
    sign = 2.0 if inverse else -2.0
    w = np.exp(sign * 1j * np.pi * k1 * n2i / (n1 * n2))
    return (w.real.astype(np.float32), w.imag.astype(np.float32))


def _split_factor(n: int) -> int:
    """N1 of the two-factor split n = N1*N2 (same rule as the JAX
    package: a 128-wide second stage where possible, else near-sqrt)."""
    if n % 128 == 0 and n // 128 >= 4:
        return n // 128
    for cand in (128, 64, 32, 16, 8, 4, 2):
        if n % cand == 0 and n // cand >= cand // 4:
            if cand * cand <= n * 4:
                return cand
    return 1


def _tensors(pair, device):
    """numpy (real, imag) pair -> float32 tensors on ``device``."""
    return tuple(torch.from_numpy(p).to(device) for p in pair)


def fft_c2c_plain(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """Plain PyTorch version of :func:`fft_c2c` on x [..., n, 2]: a direct
    DFT matmul for n <= 256, else the two-factor Cooley-Tukey split.
    Output in natural order; the inverse is unnormalized."""
    n = x.shape[-2]
    if n <= 256:
        return cgemm_plain(x, *_tensors(dft_matrices(n, inverse), x.device))
    lead = x.shape[:-2]
    n1 = _split_factor(n)
    n2 = n // n1
    xr = x.reshape(-1, n1, n2, 2)
    # step 1: DFT over n1 (sample index n1_idx*n2 + n2_idx)
    a = cgemm_plain(xr.transpose(1, 2),
                    *_tensors(dft_matrices(n1, inverse), x.device))
    a = a.transpose(1, 2)                                   # [b, k1, n2, 2]
    # step 2: twiddle W_N^{k1*n2}
    tr, ti = _tensors(_twiddles(n1, n2, inverse), x.device)
    ar, ai = a[..., 0], a[..., 1]
    a = torch.stack([ar * tr - ai * ti, ar * ti + ai * tr], dim=-1)
    # step 3: DFT over n2 -> [b, k1, k2]; output index k = k2*n1 + k1
    y = cgemm_plain(a, *_tensors(dft_matrices(n2, inverse), x.device))
    return y.transpose(1, 2).reshape(*lead, n, 2)


@lru_cache(maxsize=32)
def _twiddle_table(n: int, inverse: bool, device: torch.device):
    """[n, 2] float32 table exp(-+2 pi i j / n), computed in float64."""
    sign = 2.0 if inverse else -2.0
    w = np.exp(sign * 1j * np.pi * np.arange(n) / n)
    tab = np.stack([w.real, w.imag], axis=-1).astype(np.float32)
    return torch.from_numpy(tab).to(device)


# ------------------------------------------------------------------ #
# the Stockham plan of csrc/fft.cu
# ------------------------------------------------------------------ #
RADICES = (16, 8, 4, 2, 3, 5, 7)  # the radix-R DFTs csrc/fft.cu holds
MAX_PASSES = 12                    # csrc/fft.cu kMaxPasses
MAX_LOG2_RADIX = 4                 # csrc/fft.cu kMaxLog2Radix
THREADS = 256                      # csrc/fft.cu kThreads
PLAN_INTS = 5 * MAX_PASSES + 2 * MAX_PASSES * MAX_LOG2_RADIX  # kPlanInts
# csrc/smem_layout.cuh:36, the bank mask of bit 5 + b of a word index
SWIZZLE_TABLE = (15, 25, 29, 21, 27, 18, 19, 18)


def smem_swizzle(i: int) -> int:
    """``smem::swz`` (csrc/smem_layout.cuh:40-46): XOR into bits 0..4 of
    the word index the table masks of its bits 5..12."""
    h, m = i >> 5, 0
    for b, mask in enumerate(SWIZZLE_TABLE):
        if h >> b & 1:
            m ^= mask
    return i ^ m


def smem_pad(i: int) -> int:
    """``smem::pad`` (csrc/smem_layout.cuh:48-50): a padding word after
    every 32."""
    return i + (i >> 5)


def fastdiv(d: int):
    """(magic, shift) of ``smem::make_fastdiv`` (csrc/smem_layout.cuh:
    60-65): x // d == ((x * magic >> 32) + x) >> shift for 0 <= x < 2^31."""
    shift = 0
    while (1 << shift) < d:
        shift += 1
    return ((1 << 32) * ((1 << shift) - d)) // d + 1, shift


def fft_plan(n: int):
    """The radices of K2's passes for an n-point FFT, largest first: as
    many 16s as the power of two holds, its remainder (8, 4 or 2), then
    3s, 5s and 7s. (1,) for n = 1 (one copy pass); None when n has a
    prime factor above 7 (the kernel's direct DFT)."""
    if n < 1:
        raise ValueError(f"fft_plan: n={n}")
    if n == 1:
        return (1,)
    a = (n & -n).bit_length() - 1
    rest = n >> a
    radices = [16] * (a // 4) + ([1 << a % 4] if a % 4 else [])
    for p in (3, 5, 7):
        while rest % p == 0:
            radices.append(p)
            rest //= p
    return tuple(radices) if rest == 1 else None


class StockhamPlan(NamedTuple):
    n: int
    radices: tuple
    ns: tuple           # product of the radices before each pass
    trow: int           # threads per row
    rows: int           # rows per block
    tw_offsets: tuple   # each pass's first entry in ``twiddles``
    twiddles: np.ndarray  # [T, 2] float32, pass tables [(R - 1), ns]
    ints: np.ndarray    # [PLAN_INTS] int32, the layout csrc/fft.cu reads


@lru_cache(maxsize=64)
def stockham_plan(n: int, inverse: bool):
    """K2's plan for n (None where :func:`fft_plan` has none). Pass s of
    radix R multiplies sample r of butterfly j by W_{ns R}^{r (j mod ns)}
    (table entry (r - 1) ns + j mod ns), computed in float64 and rounded
    to f32. For a power-of-two n it also holds, per pass, the swizzled
    offsets of the reads' (n / R) << b and the writes' ns << b, b < log2 R:
    sample r's offset is the XOR of those of r's set bits."""
    radices = fft_plan(n)
    if radices is None:
        return None
    if len(radices) > MAX_PASSES:
        raise ValueError(f"fft_plan({n}) has more than {MAX_PASSES} passes")
    sign = 2.0 if inverse else -2.0
    ints = np.zeros(PLAN_INTS, np.int64)
    roff = 5 * MAX_PASSES
    woff = roff + MAX_PASSES * MAX_LOG2_RADIX
    pow2 = n & (n - 1) == 0
    ns, tables, offsets, at = [], [], [], 0
    stride = 1
    for s, r_ in enumerate(radices):
        ns.append(stride)
        offsets.append(at)
        if stride > 1:
            r, k = np.meshgrid(np.arange(1, r_), np.arange(stride),
                               indexing="ij")
            w = np.exp(sign * 1j * np.pi * r * k / (stride * r_)).reshape(-1)
            tables.append(w)
            at += w.size
        magic, shift = fastdiv(stride)
        ints[[s, MAX_PASSES + s, 2 * MAX_PASSES + s, 3 * MAX_PASSES + s,
              4 * MAX_PASSES + s]] = (r_, offsets[-1], stride, magic, shift)
        if pow2:
            for b in range(r_.bit_length() - 1):
                ints[roff + s * MAX_LOG2_RADIX + b] = smem_swizzle(
                    (n // r_) << b)
                ints[woff + s * MAX_LOG2_RADIX + b] = smem_swizzle(stride << b)
        stride *= r_
    w = np.concatenate(tables) if tables else np.ones(1)
    trow = min(-(-n // max(radices)), THREADS)
    return StockhamPlan(
        n, radices, tuple(ns), trow, max(1, THREADS // trow),
        tuple(offsets), np.stack([w.real, w.imag], -1).astype(np.float32),
        ints.astype(np.uint32).view(np.int32))


@lru_cache(maxsize=64)
def _plan_on(n: int, inverse: bool, device: torch.device):
    """The plan's (twiddles, ints) on ``device``."""
    plan = stockham_plan(n, inverse)
    return (torch.from_numpy(plan.twiddles).to(device),
            torch.from_numpy(plan.ints.copy()).to(device))


def fft_c2c(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """Batched FFT of x [B, n, 2] float32 -> [B, n, 2], natural order.
    Forward: plain DFT. Inverse: unnormalized (x n over a round trip).
    On CUDA, x must be contiguous and 1 <= n <= 4096."""
    if x.dim() != 3 or x.shape[-1] != 2:
        raise ValueError(f"fft_c2c: x must be [B, n, 2], got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"fft_c2c: float32 only, got {x.dtype}")
    if x.device.type == "cpu":
        return fft_c2c_plain(x, inverse)
    if x.device.type != "cuda":
        raise ValueError(f"fft_c2c: no kernel for device {x.device}")
    if not fft_c2c.launches and fft_c2c not in launching:
        return first_launch(fft_c2c, x, inverse)
    b, n, _ = x.shape
    if not 1 <= n <= MAX_N:
        raise ValueError(f"fft_c2c: n={n} outside the kernel's 1..{MAX_N}")
    if not x.is_contiguous():
        raise ValueError("fft_c2c: x must be contiguous")
    inverse = bool(inverse)
    plan = stockham_plan(n, inverse)
    if -(-b // (plan.rows if plan else 1)) >= 2 ** 31:
        raise ValueError(f"fft_c2c: B={b} exceeds the kernel's grid")
    y = torch.empty_like(x)
    with annotate("pc.kernel.fft_c2c"), torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if plan is None:
            tw = _twiddle_table(n, inverse, x.device)
            err = _entries()[1](x.data_ptr(), y.data_ptr(), tw.data_ptr(), b,
                                n, stream)
        else:
            tw, ints = _plan_on(n, inverse, x.device)
            err = _entries()[0](x.data_ptr(), y.data_ptr(), tw.data_ptr(),
                                ints.data_ptr(), b, n, len(plan.radices),
                                plan.trow, plan.rows, int(inverse), stream)
    build.check(err, "fft_c2c_f32")
    fft_c2c.launches += 1
    return y


fft_c2c.launches = 0


@lru_cache(maxsize=None)
def _entries():
    """(fft_stockham_f32, fft_dft_f32) of the built library."""
    lib = build.load("fft")
    lib.fft_plan_ints.restype = ctypes.c_int
    if lib.fft_plan_ints() != PLAN_INTS:
        raise RuntimeError(f"csrc/fft.cu packs {lib.fft_plan_ints()} plan "
                           f"ints, kernels/fft.py {PLAN_INTS}")
    stockham = lib.fft_stockham_f32
    stockham.argtypes = ([ctypes.c_void_p] * 4
                         + [ctypes.c_longlong] + [ctypes.c_int] * 5
                         + [ctypes.c_void_p])
    stockham.restype = ctypes.c_int
    dft = lib.fft_dft_f32
    dft.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                            ctypes.c_void_p]
    dft.restype = ctypes.c_int
    return stockham, dft
