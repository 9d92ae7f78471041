"""Batched FFT of planar-complex tensors.

Scaling matches the JAX package (and the reference's fft/TestFFT.cpp):
forward = plain DFT; inverse = unnormalized (gain N over a round trip).
On CUDA :func:`fft_planar` runs the K2 kernel; rows longer than K2 holds
(``MAX_N``) take the JAX package's two-factor split, each factor's FFTs
on K2 again (or, when n has no split, one DFT product on K1). On the CPU
it runs the JAX package's DFT-matmul factorization (``kernels/fft.py``).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from pothoscomms_tpu_torch.kernels.cgemm import cgemm
from pothoscomms_tpu_torch.kernels.fft import (  # noqa: F401 (re-exported)
    MAX_N, _split_factor, _twiddles, dft_matrices, fft_c2c)
from pothoscomms_tpu_torch.parallel import cplx


def fft_planar(x: torch.Tensor, n: int, inverse: bool = False) -> torch.Tensor:
    """FFT over the ``n`` axis of x [..., n, 2] float32 -> [..., n, 2]."""
    if x.shape[-2:] != (n, 2):
        raise ValueError(f"fft_planar: expected [..., {n}, 2], got "
                         f"{tuple(x.shape)}")
    xb = x.reshape(-1, n, 2).contiguous()
    if xb.is_cuda and n > MAX_N:
        y = fft_split(xb, n, inverse)
    else:
        y = fft_c2c(xb, inverse)
    return y.reshape(x.shape)


@lru_cache(maxsize=32)
def _dft_on(n: int, inverse: bool, device: torch.device):
    return tuple(torch.from_numpy(p).to(device)
                 for p in dft_matrices(n, inverse))


@lru_cache(maxsize=32)
def _twiddles_on(n1: int, n2: int, inverse: bool, device: torch.device):
    """W_n^{k1 n2} as an [n1, n2, 2] float32 tensor on ``device``."""
    return torch.from_numpy(np.stack(_twiddles(n1, n2, inverse), -1)) \
        .to(device)


def fft_split(x: torch.Tensor, n: int, inverse: bool = False) -> torch.Tensor:
    """The JAX package's two-factor Cooley-Tukey split of x [B, n, 2]
    (``pothoscomms_tpu/parallel/fft.py:85-104``), n = n1 * n2: n1-point
    then n2-point FFTs through :func:`fft_planar`, the twiddle
    W_n^{k1 n2} a torch op between them. Output in natural order."""
    n1 = _split_factor(n)
    if n1 == 1:  # no factor: one direct DFT product (K1 on CUDA)
        return cgemm(x, *_dft_on(n, inverse, x.device))
    n2 = n // n1
    b = x.shape[0]
    # step 1: DFT over n1 (sample index n1_idx * n2 + n2_idx)
    xt = x.reshape(b, n1, n2, 2).transpose(1, 2).reshape(b * n2, n1, 2)
    a = fft_planar(xt, n1, inverse).reshape(b, n2, n1, 2).transpose(1, 2)
    # step 2: twiddle W_n^{k1 n2}
    tw = _twiddles_on(n1, n2, inverse, x.device)
    a = cplx.mul(a, tw)                                    # [b, k1, n2, 2]
    # step 3: DFT over n2 -> [b, k1, k2]; output index k = k2 * n1 + k1
    y = fft_planar(a.reshape(b * n1, n2, 2), n2, inverse)
    return y.reshape(b, n1, n2, 2).transpose(1, 2).reshape(b, n, 2)


def fft_complex64_host(x: np.ndarray, inverse: bool = False) -> np.ndarray:
    """Host-side reference path (numpy), same scaling contract."""
    if inverse:
        return np.fft.ifft(x, axis=-1) * x.shape[-1]
    return np.fft.fft(x, axis=-1)
