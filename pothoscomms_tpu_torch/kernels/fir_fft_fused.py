"""K3: the one-pass FIR+FFT step (``csrc/fir_fft_fused.cu``) and the
one-pass chain built on it.

The counterpart of ``fir_fft_fused_pallas`` and ``make_fused_pallas_chain``
in ``pothoscomms_tpu/parallel/pallas_kernels.py``. Per window of N
samples the step computes ``spec = FFT(x_w) * H + u_w @ Gc`` (the
circular-correction form of FIR-then-FFT), in natural bin order.

- :func:`fir_fft_fused` launches the kernel for a CUDA tensor and uses
  :func:`fir_fft_fused_plain` only for a CPU tensor; any other device,
  a wrong shape or a non-contiguous operand raises.
- :func:`fused_chain_consts` builds H and Gc in natural order (the
  chain's circular-correction operators, laid out as K3 reads them);
  :func:`fused_consts_from_numpy` takes the JAX ``_fused_chain_consts``
  tuple (Mosaic layouts) to the same arrays.
- :func:`make_fused_chain` builds :class:`FusedFirFftChain`, the
  one-pass FIR -> FFT chain with the K-1 sample carry.
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
from pothoscomms_tpu_torch.kernels.fft import _twiddle_table, fft_c2c_plain
from pothoscomms_tpu_torch.parallel.chain import circ_correction_operators

MAX_N = 1024   # largest window the kernel takes (four windows per block)
MAX_PP = 256   # largest correction length (shared memory under 48 KB)


def fir_fft_fused_plain(x: torch.Tensor, uw, H: torch.Tensor,
                        gcr: torch.Tensor, gci: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`fir_fft_fused`:
    ``fft_c2c_plain(x) * H + cgemm_plain(uw, gcr, gci)``."""
    spec = fft_c2c_plain(x)
    sr, si = spec[..., 0], spec[..., 1]
    hr, hi = H[:, 0], H[:, 1]
    y = torch.stack([sr * hr - si * hi, sr * hi + si * hr], dim=-1)
    if uw is None:
        return y
    return y + cgemm_plain(uw, gcr, gci)


def _check(x, uw, H, gcr, gci):
    if x.dim() != 3 or x.shape[-1] != 2:
        raise ValueError(
            f"fir_fft_fused: x must be [B, N, 2], got {tuple(x.shape)}")
    b, n, _ = x.shape
    ops = [x, H, gcr, gci] + ([] if uw is None else [uw])
    for t in ops:
        if t.dtype != torch.float32:
            raise TypeError(f"fir_fft_fused: float32 only, got {t.dtype}")
        if t.device != x.device:
            raise ValueError("fir_fft_fused: all operands must be on one "
                             "device")
    if H.shape != (n, 2):
        raise ValueError(f"fir_fft_fused: H must be [N={n}, 2], got "
                         f"{tuple(H.shape)}")
    if gcr.dim() != 2 or gcr.shape[1] != n or gci.shape != gcr.shape:
        raise ValueError(f"fir_fft_fused: gcr, gci must be [pp, N={n}], "
                         f"got {tuple(gcr.shape)}, {tuple(gci.shape)}")
    if uw is not None and uw.shape != (b, gcr.shape[0], 2):
        raise ValueError(f"fir_fft_fused: uw must be [B={b}, "
                         f"pp={gcr.shape[0]}, 2], got {tuple(uw.shape)}")


def fir_fft_fused(x: torch.Tensor, uw, H: torch.Tensor, gcr: torch.Tensor,
                  gci: torch.Tensor) -> torch.Tensor:
    """One-pass FIR+FFT of windows x [B, N, 2] -> spectra [B, N, 2]:
    ``FFT(x) * H + uw @ (gcr + i gci)``, natural bin order. ``uw``
    [B, pp, 2] is the per-window correction operand; ``uw=None`` skips
    the correction (the JAX kernel's ``with_corr=False``).

    On CUDA every operand must be contiguous float32, N a power of two
    up to 1024 and pp <= 256; the kernel runs on the current stream.
    """
    _check(x, uw, H, gcr, gci)
    if x.device.type == "cpu":
        return fir_fft_fused_plain(x, uw, H, gcr, gci)
    if x.device.type != "cuda":
        raise ValueError(f"fir_fft_fused: no kernel for device {x.device}")
    b, n, _ = x.shape
    pp = 0 if uw is None else gcr.shape[0]
    if not (2 <= n <= MAX_N and n & (n - 1) == 0):
        raise ValueError(f"fir_fft_fused: N={n} is not a power of two in "
                         f"2..{MAX_N}")
    if pp > MAX_PP:
        raise ValueError(f"fir_fft_fused: pp={pp} exceeds {MAX_PP}")
    ops = [x, H, gcr, gci] + ([] if uw is None else [uw])
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("fir_fft_fused: operands must be contiguous")
    if (b + 3) // 4 >= 2 ** 31:
        raise ValueError(f"fir_fft_fused: B={b} exceeds the kernel's grid")
    tw = _twiddle_table(n, False, x.device)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry()(x.data_ptr(), None if uw is None else uw.data_ptr(),
                       H.data_ptr(), gcr.data_ptr(), gci.data_ptr(),
                       tw.data_ptr(), y.data_ptr(), b, n, pp, stream)
    build.check(err, "fir_fft_fused_f32")
    fir_fft_fused.launches += 1
    return y


fir_fft_fused.launches = 0


@lru_cache(maxsize=None)
def _entry():
    fn = build.load("fir_fft_fused").fir_fft_fused_f32
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


# ------------------------------------------------------------------ #
# constants
# ------------------------------------------------------------------ #
def fused_chain_consts(taps, nbins: int, pp: int):
    """(H [nbins, 2], (gcr, gci) [pp, nbins]) float32 tensors in natural
    bin order: H = FFT(taps, nbins) and the correction rows Gc, row
    ``pp - m`` holding offset -m — the circular-correction operators of
    ``parallel/chain.py`` with their K-1 rows reversed and zero-padded at
    the front to pp, as the JAX ``_fused_chain_consts`` lays them out
    before its Mosaic permutations (the same float64 sums)."""
    H, gc = circ_correction_operators(taps, nbins)
    pad = pp - gc[0].shape[0]
    return H, tuple(torch.cat([g.new_zeros(pad, nbins), g.flip(0)])
                    for g in gc)


def fused_consts_from_numpy(consts, device=None):
    """The JAX ``_fused_chain_consts(taps, nbins, pp)`` 5-tuple of float32
    numpy pairs ``(f8, tw, vmat, Hl, gcf)`` -> the port's natural-order
    ``(H [nbins, 2], (gcr, gci) [pp, nbins])`` on ``device`` (default: the
    card). ``Hl`` is [m, ps] with bin ps*8 + m; ``gcf`` columns are
    m-major (pallas_kernels.py:386, :396); both permutations are undone,
    so no value changes."""
    (hr, hi), (gfr, gfi) = consts[3], consts[4]
    u, v = np.asarray(hr).shape                       # [m(8), ps]
    pp = np.asarray(gfr).shape[0]

    def unperm_h(a):
        return np.asarray(a, np.float32).T.reshape(-1)

    def unperm_gc(a):
        return np.asarray(a, np.float32).reshape(pp, u, v) \
            .transpose(0, 2, 1).reshape(pp, u * v)

    H = np.stack([unperm_h(hr), unperm_h(hi)], -1)
    device = placement.resolve(device)
    return torch.from_numpy(H).to(device), (
        torch.from_numpy(unperm_gc(gfr)).to(device),
        torch.from_numpy(unperm_gc(gfi)).to(device))


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
    tails = x.reshape(c, nw, nbins, 2)[:, :, nbins - (k - 1):]
    prev = torch.cat([hist[:, None], tails[:, :-1]], dim=1)
    pad = x.new_zeros(c, nw, pp - (k - 1), 2)
    return torch.cat([pad, prev - tails], dim=2).reshape(c * nw, pp, 2)


class FusedFirFftChain(nn.Module):
    """FIR -> windowed FFT over [C, T, 2] blocks on K3, with the K-1
    sample carry. H and Gc are buffers on ``device`` (default: the card).
    The contract of
    ``make_fused_pallas_chain`` holds: K - 1 <= pp and nbins == 1024."""

    def __init__(self, taps, nbins: int, pp: int = 64, device=None):
        super().__init__()
        taps = np.asarray(taps)
        self.k, self.nbins, self.pp = len(taps), int(nbins), int(pp)
        if self.k - 1 > self.pp:
            raise ValueError(f"{self.k} taps need pp >= {self.k - 1}, got "
                             f"{self.pp}")
        if self.nbins != 1024:
            raise ValueError(f"the one-pass chain takes nbins == 1024, got "
                             f"{self.nbins}")
        H, (gcr, gci) = fused_chain_consts(taps, self.nbins, self.pp)
        device = placement.resolve(device)
        for name, op in (("H", H), ("gcr", gcr), ("gci", gci)):
            self.register_buffer(name, op.to(device))

    def forward(self, x: torch.Tensor, hist: torch.Tensor):
        """x [C, T, 2], hist [C, K-1, 2] -> (spec [C, T//nbins, nbins, 2],
        new_hist [C, K-1, 2]). T must be a multiple of nbins."""
        c, t, _ = x.shape
        if t % self.nbins:
            raise ValueError(f"T={t} is not a multiple of {self.nbins}")
        nw = t // self.nbins
        uw = correction_operand(x, hist, self.nbins, self.k, self.pp)
        spec = fir_fft_fused(x.reshape(c * nw, self.nbins, 2).contiguous(),
                             uw, self.H, self.gcr, self.gci)
        return (spec.reshape(c, nw, self.nbins, 2),
                x[:, t - (self.k - 1):].contiguous())

    run = forward


def make_fused_chain(taps, nbins: int, pp: int = 64, device=None):
    """The counterpart of ``make_fused_pallas_chain``: a
    :class:`FusedFirFftChain` whose ``run(x, hist)`` returns (spectra,
    new_hist)."""
    return FusedFirFftChain(taps, nbins, pp, device)
