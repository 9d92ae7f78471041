"""K4: the decimating complex FIR with its K-1 sample carry
(``csrc/fir_decim.cu``), the FIR stage of ``parallel/chain.FirFftChain``'s
``"polyphase"`` form.

``y[c, n] = sum_k h[k] xt[c, D n - k]`` for the T / D outputs a step
keeps, ``xt`` the carry followed by x: the phase of ``conv1d`` with
stride D on ``cat(carry, x)``, as ``parallel/chain.fir_multichannel``
computes it. The new carry is the last K-1 samples of ``xt``, bit for
bit, in a fresh tensor.

:func:`fir_decim` launches the kernel for CUDA tensors and runs
:func:`fir_decim_plain` for CPU tensors; any other device, a wrong dtype
or shape, or a non-contiguous operand raises. It replaces no TPU kernel
(the JAX package runs this FIR as ``lax.conv``).
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch
import torch.nn.functional as F

from pothoscomms_tpu_torch.kernels import build
from pothoscomms_tpu_torch.parallel.profiling import (
    annotate, first_launch, launching)

MAX_TAPS = 256     # taps the kernel stages in shared memory
MAX_DECIM = 64     # 64 phase rows of a 32-thread block take 156 KB
R = 8              # csrc/fir_decim.cu kR: outputs a thread
SMEM_GOAL = 48 * 1024  # fewer threads a block above this, bytes
MAX_T = 1 << 31    # the kernel indexes a row with 32-bit ints


def fits(k: int, decim: int) -> bool:
    """Whether K4 takes ``k`` taps at decimation ``decim``."""
    return 2 <= decim <= MAX_DECIM and 1 <= k <= MAX_TAPS


@lru_cache(maxsize=None)
def plan(k: int, decim: int):
    """(threads, jp, smem): the kernel's block of ``threads`` (R outputs
    each), ``jp`` taps a phase (ceil(K / D) rounded up to 8) and the
    shared memory it stages, bytes: the taps and min(D, K) phase rows of
    L + jp samples, one float2 of padding after every 8. The most threads
    (128, 64, 32) whose stage stays within ``SMEM_GOAL``, else 32."""
    per_phase = -(-k // decim)
    jp = -(-per_phase // 8) * 8
    phases = min(decim, k)
    for threads in (128, 64, 32):
        n = R * threads + jp
        smem = 8 * phases * (jp + n + n // 8)
        if smem <= SMEM_GOAL:
            break
    return threads, jp, smem


def _check(x, carry, taps, decim):
    if x.dim() != 3 or x.shape[2] != 2 or taps.dim() != 2 \
            or taps.shape[1] != 2:
        raise ValueError(f"fir_decim: x must be [C, T, 2] and taps [K, 2], "
                         f"got {tuple(x.shape)} and {tuple(taps.shape)}")
    C, T = x.shape[:2]
    k = taps.shape[0]
    if tuple(carry.shape) != (C, k - 1, 2):
        raise ValueError(f"fir_decim: carry must be [{C}, {k - 1}, 2], got "
                         f"{tuple(carry.shape)}")
    if {x.dtype, carry.dtype, taps.dtype} != {torch.float32}:
        raise TypeError(f"fir_decim: float32 only, got {x.dtype}, "
                        f"{carry.dtype}, {taps.dtype}")
    if not x.device == carry.device == taps.device:
        raise ValueError("fir_decim: x, carry and taps must be on one device")
    if not (x.is_contiguous() and carry.is_contiguous()
            and taps.is_contiguous()):
        raise ValueError("fir_decim: x, carry and taps must be contiguous")
    if not fits(k, decim):
        raise ValueError(f"fir_decim: takes 1 <= K <= {MAX_TAPS} taps and "
                         f"2 <= D <= {MAX_DECIM}, got K={k} D={decim}")
    if not 1 <= T < MAX_T or T % decim:
        raise ValueError(f"fir_decim: T={T} is not a positive multiple of "
                         f"D={decim} below {MAX_T}")


def fir_decim_plain(x: torch.Tensor, carry: torch.Tensor,
                    taps: torch.Tensor, decim: int):
    """Plain PyTorch version of :func:`fir_decim`: ``conv1d`` with stride
    ``decim`` over ``cat(carry, x)``, the taps reversed (``conv1d``
    correlates), as ``parallel/chain.fir_multichannel`` runs it."""
    _check(x, carry, taps, decim)
    k = taps.shape[0]
    xin = torch.cat([carry, x], dim=1)
    hr, hi = taps.flip(0).unbind(-1)
    w = torch.stack([torch.stack([hr, -hi]), torch.stack([hi, hr])])
    y = F.conv1d(xin.permute(0, 2, 1), w, stride=decim)
    return (y.permute(0, 2, 1).contiguous(),
            xin[:, xin.shape[1] - (k - 1):].contiguous())


def fir_decim(x: torch.Tensor, carry: torch.Tensor, taps: torch.Tensor,
              decim: int):
    """The decimated FIR output of x [C, T, 2] (planar complex float32)
    after carry [C, K-1, 2], with taps [K, 2]: returns (y [C, T / decim,
    2], new carry [C, K-1, 2]), both fresh and contiguous. Needs
    :func:`fits` and T a multiple of ``decim``."""
    _check(x, carry, taps, decim)
    if x.device.type == "cpu":
        return fir_decim_plain(x, carry, taps, decim)
    if x.device.type != "cuda":
        raise ValueError(f"fir_decim: no kernel for device {x.device}")
    if not fir_decim.launches and fir_decim not in launching:
        return first_launch(fir_decim, x, carry, taps, decim)
    if x.data_ptr() % 8 or carry.data_ptr() % 8 or taps.data_ptr() % 8:
        raise ValueError("fir_decim: x, carry and taps must be 8-byte "
                         "aligned")
    C, T = x.shape[:2]
    k = taps.shape[0]
    threads, jp, smem = plan(k, decim)
    if C * -(-(T // decim) // (R * threads)) >= 2 ** 31:
        raise ValueError(f"fir_decim: C={C}, T={T}, D={decim} exceed the "
                         f"kernel's grid")
    y = x.new_empty((C, T // decim, 2))
    new_carry = torch.empty_like(carry)
    with annotate("pc.kernel.fir_decim"), torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry()(x.data_ptr(), carry.data_ptr(), taps.data_ptr(),
                       y.data_ptr(), new_carry.data_ptr(), C, T, k, decim,
                       threads, jp, smem, stream)
    build.check(err, "fir_decim_f32")
    fir_decim.launches += 1
    return y, new_carry


fir_decim.launches = 0


@lru_cache(maxsize=None)
def _entry():
    fn = build.load("fir_decim").fir_decim_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 2 \
        + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn
