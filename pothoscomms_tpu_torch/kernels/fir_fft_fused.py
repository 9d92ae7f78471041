"""K3: the one-pass FIR+FFT step (``csrc/fir_fft_fused.cu``) and the
one-pass chain built on it.

The counterpart of ``fir_fft_fused_pallas`` and ``make_fused_pallas_chain``
in ``pothoscomms_tpu/parallel/pallas_kernels.py``. Per window of N
samples the step computes ``spec = FFT(x_w) * H + u_w @ Gc`` (the
circular-correction form of FIR-then-FFT), in natural bin order.

Every row of Gc [pp, N] is the DFT of a short row: ``Gc = FFT_N(pad(gt))``
with gt [pp, S] the correction operator in the time domain (S <= K - 1
for K taps). The port carries gt, not Gc: the kernel forms ``c_w = u_w @
gt`` (pp S products a window, where ``u_w @ Gc`` takes pp N) and
transforms it with x_w's plan.

- :func:`fir_fft_fused` launches the kernel for a CUDA tensor and uses
  :func:`fir_fft_fused_plain` only for a CPU tensor; any other device,
  a wrong shape or a non-contiguous operand raises.
- :func:`fused_chain_consts` builds H and gt from the taps;
  :func:`fused_consts_from_numpy` takes the JAX ``_fused_chain_consts``
  tuple (Mosaic layouts, Gc in the frequency domain) to the same arrays;
  :func:`correction_spectrum` rebuilds Gc from gt.
- :func:`one_pass_step` is one step of the one-pass FIR -> FFT chain
  with the K-1 sample carry; :func:`make_fused_chain` builds
  :class:`FusedFirFftChain`, which runs it, and ``fir_fft_chain`` takes
  it as its ``"one_pass"`` form.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch
from torch import nn

from pothoscomms_tpu_torch.core import placement
from pothoscomms_tpu_torch.kernels import build
from pothoscomms_tpu_torch.kernels.cgemm import cgemm_plain
from pothoscomms_tpu_torch.kernels.fft import (PLAN_INTS, _plan_on,
                                               fft_c2c_plain, stockham_plan)
from pothoscomms_tpu_torch.parallel.profiling import (
    annotate, first_launch, launching)

MAX_N = 1024   # largest window the kernel takes
MAX_PP = 256   # largest correction length
ONE_PASS_PP = 64  # the one-pass chain's correction length
SUPPORT_ENERGY = 1e-6  # share of a Gc row's energy allowed outside gt


def correction_spectrum(gt: torch.Tensor, n: int):
    """(gcr, gci) [pp, n] float32 planes of ``Gc = FFT_n(pad(gt))`` for
    gt [pp, S, 2], the DFT taken in float64 on gt's device: the operator
    of the TPU kernel's ``u_w @ Gc``."""
    s = gt.shape[1]
    idx = torch.arange(s, device=gt.device)[:, None] \
        * torch.arange(n, device=gt.device)[None, :] % n
    ang = idx.to(torch.float64) * (-2.0 * np.pi / n)
    f = torch.complex(torch.cos(ang), torch.sin(ang))          # [S, n]
    gc = torch.complex(gt[..., 0].double(), gt[..., 1].double()) @ f
    return gc.real.to(torch.float32), gc.imag.to(torch.float32)


def fir_fft_fused_plain(x: torch.Tensor, uw, H: torch.Tensor,
                        gt: torch.Tensor, gc=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`fir_fft_fused`, in the TPU
    kernel's arithmetic: ``fft_c2c_plain(x) * H + cgemm_plain(uw, Gc)``.
    ``gc`` is the (gcr, gci) of :func:`correction_spectrum` for this gt
    and N, built here when not given; a caller that times the function or
    calls it repeatedly builds the planes once and passes them."""
    spec = fft_c2c_plain(x)
    sr, si = spec[..., 0], spec[..., 1]
    hr, hi = H[:, 0], H[:, 1]
    y = torch.stack([sr * hr - si * hi, sr * hi + si * hr], dim=-1)
    if uw is None:
        return y
    if gc is None:
        gc = correction_spectrum(gt, x.shape[1])
    return y + cgemm_plain(uw, *gc)


def _check(x, uw, H, gt):
    if x.dim() != 3 or x.shape[-1] != 2:
        raise ValueError(
            f"fir_fft_fused: x must be [B, N, 2], got {tuple(x.shape)}")
    b, n, _ = x.shape
    ops = [x, H, gt] + ([] if uw is None else [uw])
    for t in ops:
        if t.dtype != torch.float32:
            raise TypeError(f"fir_fft_fused: float32 only, got {t.dtype}")
        if t.device != x.device:
            raise ValueError("fir_fft_fused: all operands must be on one "
                             "device")
    if H.shape != (n, 2):
        raise ValueError(f"fir_fft_fused: H must be [N={n}, 2], got "
                         f"{tuple(H.shape)}")
    if gt.dim() != 3 or gt.shape[2] != 2 or not 1 <= gt.shape[1] <= n:
        raise ValueError(f"fir_fft_fused: gt must be [pp, S, 2] with "
                         f"1 <= S <= N={n}, got {tuple(gt.shape)}")
    if uw is not None and uw.shape != (b, gt.shape[0], 2):
        raise ValueError(f"fir_fft_fused: uw must be [B={b}, "
                         f"pp={gt.shape[0]}, 2], got {tuple(uw.shape)}")


def fir_fft_fused(x: torch.Tensor, uw, H: torch.Tensor,
                  gt: torch.Tensor) -> torch.Tensor:
    """One-pass FIR+FFT of windows x [B, N, 2] -> spectra [B, N, 2]:
    ``FFT(x) * H + FFT(pad(uw @ gt))``, natural bin order. ``uw``
    [B, pp, 2] is the per-window correction operand, ``gt`` [pp, S, 2]
    the correction operator in the time domain; ``uw=None`` skips the
    correction (the JAX kernel's ``with_corr=False``).

    On CUDA every operand must be contiguous float32, N a power of two
    up to 1024 and pp <= 256; the kernel runs on the current stream and
    the call does no host work beyond the enqueue.
    """
    _check(x, uw, H, gt)
    if x.device.type == "cpu":
        return fir_fft_fused_plain(x, uw, H, gt)
    if x.device.type != "cuda":
        raise ValueError(f"fir_fft_fused: no kernel for device {x.device}")
    if not fir_fft_fused.launches and fir_fft_fused not in launching:
        return first_launch(fir_fft_fused, x, uw, H, gt)
    b, n, _ = x.shape
    pp, s = (0, 0) if uw is None else gt.shape[:2]
    if not (2 <= n <= MAX_N and n & (n - 1) == 0):
        raise ValueError(f"fir_fft_fused: N={n} is not a power of two in "
                         f"2..{MAX_N}")
    if pp > MAX_PP:
        raise ValueError(f"fir_fft_fused: pp={pp} exceeds {MAX_PP}")
    ops = [x, H, gt] + ([] if uw is None else [uw])
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("fir_fft_fused: operands must be contiguous")
    plan = stockham_plan(n, False)
    if b >= 2 ** 31:
        raise ValueError(f"fir_fft_fused: B={b} exceeds the kernel's grid")
    tw, ints = _plan_on(n, False, x.device)
    y = torch.empty_like(x)
    with annotate("pc.kernel.fir_fft_fused"), torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry()(x.data_ptr(), None if uw is None else uw.data_ptr(),
                       H.data_ptr(), gt.data_ptr(), tw.data_ptr(),
                       ints.data_ptr(), y.data_ptr(), b, n,
                       len(plan.radices), plan.trow, plan.rows, pp, s, stream)
    build.check(err, "fir_fft_fused_f32")
    fir_fft_fused.launches += 1
    return y


fir_fft_fused.launches = 0


@lru_cache(maxsize=None)
def _entry():
    lib = build.load("fir_fft_fused")
    lib.fir_fft_fused_plan_ints.restype = ctypes.c_int
    if lib.fir_fft_fused_plan_ints() != PLAN_INTS:
        raise RuntimeError(
            f"csrc/stockham.cuh packs {lib.fir_fft_fused_plan_ints()} plan "
            f"ints, kernels/fft.py {PLAN_INTS}")
    fn = lib.fir_fft_fused_f32
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_longlong] \
        + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


# ------------------------------------------------------------------ #
# constants
# ------------------------------------------------------------------ #
def fused_chain_consts(taps, nbins: int, pp: int):
    """(H [nbins, 2], gt [pp, S, 2]) float32 tensors, S = min(pp, nbins):
    H = FFT(taps, nbins) in natural bin order, and the time-domain
    correction operator, row ``pp - m`` holding offset -m:
    ``gt[pp - m, t] = taps[t + m]`` for t < K - m, zero elsewhere (rows
    0 .. pp - K are zero). Its spectrum (:func:`correction_spectrum`) is
    the Gc that the JAX ``_fused_chain_consts`` builds before its Mosaic
    permutations: ``gc[pp - m] = sum_j taps[j + m] f[j]``."""
    h = np.asarray(taps, np.complex128)
    k = len(h)
    s = min(pp, nbins)
    if k - 1 > s:
        raise ValueError(f"{k} taps need pp and nbins >= {k - 1}, got "
                         f"pp={pp}, nbins={nbins}")
    H = np.fft.fft(h, nbins)
    gt = np.zeros((pp, s), np.complex128)
    for m in range(1, k):
        gt[pp - m, :k - m] = h[m:]
    return (torch.from_numpy(np.stack([H.real, H.imag], -1)
                             .astype(np.float32)),
            torch.from_numpy(np.stack([gt.real, gt.imag], -1)
                             .astype(np.float32)))


def fused_consts_from_numpy(consts, device=None):
    """The JAX ``_fused_chain_consts(taps, nbins, pp)`` 5-tuple of float32
    numpy pairs ``(f8, tw, vmat, Hl, gcf)`` -> the port's ``(H [nbins, 2],
    gt [pp, S, 2])`` on ``device`` (default: the card), S = min(pp,
    nbins). ``Hl`` is [m, ps] with bin ps*8 + m; ``gcf`` columns are
    m-major (pallas_kernels.py:386, :396); both permutations are undone,
    so no value of H changes. gt is recovered from Gc by one float64
    inverse DFT on the host; a row with more than ``SUPPORT_ENERGY`` of
    its energy from sample S on has no such gt and raises."""
    (hr, hi), (gfr, gfi) = consts[3], consts[4]
    u, v = np.asarray(hr).shape                       # [m(8), ps]
    pp = np.asarray(gfr).shape[0]

    def unperm_h(a):
        return np.asarray(a, np.float32).T.reshape(-1)

    def unperm_gc(a):
        return np.asarray(a, np.float64).reshape(pp, u, v) \
            .transpose(0, 2, 1).reshape(pp, u * v)

    H = np.stack([unperm_h(hr), unperm_h(hi)], -1)
    full = np.fft.ifft(unperm_gc(gfr) + 1j * unperm_gc(gfi), axis=-1)
    s = min(pp, u * v)
    outside = np.sum(np.abs(full[:, s:]) ** 2, axis=-1)
    energy = np.sum(np.abs(full) ** 2, axis=-1)
    if np.any(outside > SUPPORT_ENERGY * energy):
        raise ValueError(
            f"fused_consts_from_numpy: a row of Gc keeps "
            f"{np.max(outside / np.maximum(energy, 1e-300)):.3e} of its "
            f"energy from sample {s} on; it is not the spectrum of a "
            f"correction operator of at most {s} samples")
    gt = np.stack([full[:, :s].real, full[:, :s].imag], -1).astype(np.float32)
    device = placement.resolve(device)
    return torch.from_numpy(H).to(device), torch.from_numpy(gt).to(device)


# ------------------------------------------------------------------ #
# the one-pass chain
# ------------------------------------------------------------------ #
def correction_operand(x: torch.Tensor, hist: torch.Tensor, nbins: int,
                       k: int, pp: int) -> torch.Tensor:
    """u_w [C * T//nbins, pp, 2]: the previous window's last K-1 samples
    minus this window's own (the carry before window 0), zero-padded at
    the front to pp, as ``make_fused_pallas_chain`` builds it."""
    c, t, _ = x.shape
    nw = t // nbins
    with annotate("pc.op.correction_operand"):
        tails = x.reshape(c, nw, nbins, 2)[:, :, nbins - (k - 1):]
        prev = torch.cat([hist[:, None], tails[:, :-1]], dim=1)
        pad = x.new_zeros(c, nw, pp - (k - 1), 2)
        return torch.cat([pad, prev - tails], dim=2).reshape(c * nw, pp, 2)


def one_pass_step(x: torch.Tensor, hist: torch.Tensor, H: torch.Tensor,
                  gt: torch.Tensor, k: int):
    """One one-pass FIR+FFT step on K3: x [C, T, 2], hist [C, K-1, 2] ->
    (spec [C, T//nbins, nbins, 2], new_hist [C, K-1, 2]), nbins = H's
    length and pp = gt's rows (:func:`fused_chain_consts`). T must be a
    multiple of nbins; the new carry is the last K-1 raw inputs."""
    c, t, _ = x.shape
    nbins, pp = H.shape[0], gt.shape[0]
    if t % nbins:
        raise ValueError(f"T={t} is not a multiple of {nbins}")
    nw = t // nbins
    uw = correction_operand(x, hist, nbins, k, pp)
    spec = fir_fft_fused(x.reshape(c * nw, nbins, 2).contiguous(), uw, H, gt)
    return spec.reshape(c, nw, nbins, 2), x[:, t - (k - 1):].contiguous()


class FusedFirFftChain(nn.Module):
    """FIR -> windowed FFT over [C, T, 2] blocks on K3, with the K-1
    sample carry. H and gt are buffers on ``device`` (default: the card).
    The contract of
    ``make_fused_pallas_chain`` holds: K - 1 <= pp and nbins == 1024."""

    def __init__(self, taps, nbins: int, pp: int = ONE_PASS_PP, device=None):
        super().__init__()
        taps = np.asarray(taps)
        self.k, self.nbins, self.pp = len(taps), int(nbins), int(pp)
        if self.k - 1 > self.pp:
            raise ValueError(f"{self.k} taps need pp >= {self.k - 1}, got "
                             f"{self.pp}")
        if self.nbins != 1024:
            raise ValueError(f"the one-pass chain takes nbins == 1024, got "
                             f"{self.nbins}")
        H, gt = fused_chain_consts(taps, self.nbins, self.pp)
        device = placement.resolve(device)
        for name, op in (("H", H), ("gt", gt)):
            self.register_buffer(name, op.to(device))

    def forward(self, x: torch.Tensor, hist: torch.Tensor):
        """x [C, T, 2], hist [C, K-1, 2] -> (spec [C, T//nbins, nbins, 2],
        new_hist [C, K-1, 2]) by :func:`one_pass_step`. T must be a
        multiple of nbins."""
        return one_pass_step(x, hist, self.H, self.gt, self.k)

    run = forward


def make_fused_chain(taps, nbins: int, pp: int = ONE_PASS_PP, device=None):
    """The counterpart of ``make_fused_pallas_chain``: a
    :class:`FusedFirFftChain` whose ``run(x, hist)`` returns (spectra,
    new_hist)."""
    return FusedFirFftChain(taps, nbins, pp, device)
