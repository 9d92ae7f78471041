"""K1: complex GEMM on interleaved complex f32 (``csrc/cgemm.cu``).

The counterpart of ``cmatmul_pallas`` / ``cmatmul`` in
``pothoscomms_tpu/parallel/pallas_kernels.py``. :func:`cgemm` launches
one of the two CUDA kernels of ``cgemm.cu`` for a CUDA tensor, picked by
:func:`variant` from the shape before the launch, and uses
:func:`cgemm_plain` only for a CPU tensor; any other device raises.

The tensor-core variant reads ``a`` [B, N, 2] as the real matrix
[B, 2N] and multiplies it by :func:`real_embedding` of the operator,
K-major [2M, 2N], split into TF32 hi and lo planes
(:func:`tf32_operator`), in three TF32 passes; :func:`tf32_operator_plain`
and :func:`tf32_round` are the same arithmetic in PyTorch.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from pothoscomms_tpu_torch.kernels import build
from pothoscomms_tpu_torch.parallel.profiling import (
    annotate, first_launch, launching)

TENSOR_CORES, SIMT = "tensor_cores", "simt"


def cgemm_plain(a: torch.Tensor, gr: torch.Tensor,
                gi: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`cgemm`: a [..., N, 2] @ (gr + i gi)
    [N, M] -> [..., M, 2] in four real products."""
    ar, ai = a[..., 0], a[..., 1]
    yr = torch.matmul(ar, gr) - torch.matmul(ai, gi)
    yi = torch.matmul(ar, gi) + torch.matmul(ai, gr)
    return torch.stack([yr, yi], dim=-1)


def real_embedding(gr: torch.Tensor, gi: torch.Tensor) -> torch.Tensor:
    """The real embedding of G = gr + i gi [N, M], K-major: Bt [2M, 2N]
    with Bt[2m, 2n] = gr, Bt[2m, 2n+1] = -gi, Bt[2m+1, 2n] = gi,
    Bt[2m+1, 2n+1] = gr, so that ``a.reshape(B, 2N) @ Bt.T`` is y
    [B, M, 2] interleaved, reshaped to [B, 2M]."""
    n, m = gr.shape
    re_row = torch.stack([gr.t(), -gi.t()], dim=-1).reshape(m, 2 * n)
    im_row = torch.stack([gi.t(), gr.t()], dim=-1).reshape(m, 2 * n)
    return torch.stack([re_row, im_row], dim=1).reshape(2 * m, 2 * n)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (10 mantissa bits), to nearest, ties
    to even: the kernel's ``tf32_rne``, in int32 arithmetic that wraps as
    the kernel's uint32 does."""
    u = x.contiguous().view(torch.int32)
    u = (u + (0xFFF + ((u >> 13) & 1))) & -0x2000
    return u.view(torch.float32)


def tf32_split(x: torch.Tensor):
    """(hi, lo) with hi = tf32(x), lo = tf32(x - hi)."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def tf32_operator_plain(gr: torch.Tensor, gi: torch.Tensor):
    """Plain version of :func:`tf32_operator`: the hi and lo planes of
    :func:`real_embedding`."""
    return tf32_split(real_embedding(gr, gi))


def variant(n: int, m: int, aligned: bool = True) -> str:
    """The kernel that takes a [B, N, 2] x [N, M]: the tensor cores where
    TMA can address ``a`` as [B, 2N] f32 (N even and above 0, so rows are
    a nonzero multiple of 16 bytes; ``aligned``: its start on 16 bytes);
    else the SIMT kernel."""
    if n > 0 and n % 2 == 0 and aligned:
        return TENSOR_CORES
    return SIMT


def _check(a, gr, gi):
    if a.dim() != 3 or a.shape[-1] != 2:
        raise ValueError(f"cgemm: a must be [B, N, 2], got {tuple(a.shape)}")
    n = a.shape[1]
    ops = (gr, gi)
    for t in (a, *ops):
        if t.dtype != torch.float32:
            raise TypeError(f"cgemm: float32 only, got {t.dtype}")
        if t.device != a.device:
            raise ValueError("cgemm: all operands must be on one device")
    for g in ops:
        if g.dim() != 2 or g.shape[0] != n or g.shape != gr.shape:
            raise ValueError(
                f"cgemm: operator planes must be [N={n}, M], got "
                f"{[tuple(o.shape) for o in ops]}")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def tf32_operator(gr: torch.Tensor, gi: torch.Tensor):
    """(Bt_hi, Bt_lo) [2M, 2N], the tensor-core variant's operator, from
    contiguous float32 planes gr, gi [N, M]; on CUDA by the
    ``cgemm_operator_tf32`` kernel (one pass, 8 bytes read and 32
    written per complex element of G), on the CPU by its plain version."""
    if gr.dim() != 2 or gr.shape != gi.shape or gr.device != gi.device \
            or gr.dtype != torch.float32 or gi.dtype != torch.float32:
        raise ValueError("tf32_operator: gr, gi must be float32 planes of "
                         "one [N, M] shape on one device")
    if gr.device.type == "cpu":
        return tf32_operator_plain(gr, gi)
    if gr.device.type != "cuda" or not (gr.is_contiguous()
                                        and gi.is_contiguous()):
        raise ValueError("tf32_operator: the kernel takes contiguous CUDA "
                         "planes")
    if not tf32_operator.launches and tf32_operator not in launching:
        return first_launch(tf32_operator, gr, gi)
    n, m = gr.shape
    if -(-n // 32) > 65535:
        raise ValueError(f"cgemm: N={n} exceeds the operator kernel's grid")
    hi = torch.empty((2 * m, 2 * n), dtype=torch.float32, device=gr.device)
    lo = torch.empty_like(hi)
    with torch.cuda.device(gr.device):
        err = _entries()[1](gr.data_ptr(), gi.data_ptr(), hi.data_ptr(),
                            lo.data_ptr(), n, m, _stream(gr.device))
    build.check(err, "cgemm_operator_tf32")
    tf32_operator.launches += 1
    return hi, lo


tf32_operator.launches = 0


def cgemm(a: torch.Tensor, gr: torch.Tensor, gi: torch.Tensor,
          out: torch.Tensor = None) -> torch.Tensor:
    """Complex product y [B, M, 2] = a [B, N, 2] @ (gr + i gi) [N, M],
    written into ``out`` when one is given (contiguous float32 [B, M, 2]
    on a's device; the split step writes each stream's product into its
    slot of one buffer so).

    On CUDA every operand must be contiguous float32; the kernel runs on
    the current stream. The tensor-core variant builds its operator from
    gr, gi on each call (:func:`tf32_operator`, 38 MB at N = 1152,
    M = 1024). The launch, the operator build included, runs inside the
    span ``pc.kernel.cgemm``.
    """
    _check(a, gr, gi)
    if out is not None and (out.shape != (a.shape[0], gr.shape[1], 2)
                            or out.dtype != torch.float32
                            or out.device != a.device
                            or not out.is_contiguous()):
        raise ValueError(f"cgemm: out must be contiguous float32 "
                         f"[{a.shape[0]}, {gr.shape[1]}, 2] on {a.device}")
    if a.device.type == "cpu":
        y = cgemm_plain(a, gr, gi)
        return y if out is None else out.copy_(y)
    if a.device.type != "cuda":
        raise ValueError(f"cgemm: no kernel for device {a.device}")
    if not cgemm.launches and cgemm not in launching:
        return first_launch(cgemm, a, gr, gi, out)
    if not all(t.is_contiguous() for t in (a, gr, gi)):
        raise ValueError("cgemm: operands must be contiguous")
    n, m = gr.shape
    with annotate("pc.kernel.cgemm"):
        return _launch(a, gr, gi, variant(n, m, a.data_ptr() % 16 == 0),
                       out)


def _launch(a: torch.Tensor, gr: torch.Tensor, gi: torch.Tensor,
            kind: str, out: torch.Tensor = None) -> torch.Tensor:
    """Launch K1's ``kind`` variant, picked by :func:`variant`, on the
    operands :func:`cgemm` has checked. Counts the launch in
    ``cgemm.launches`` and ``cgemm.launches_by_variant``."""
    b, n, _ = a.shape
    m = gr.shape[1]
    y = torch.empty((b, m, 2), dtype=torch.float32, device=a.device) \
        if out is None else out
    simt, _, tc = _entries()
    if kind == TENSOR_CORES:
        tiles = -(-b // 128) * -(-2 * m // 128)
        if max(b, 2 * n, 2 * m, tiles) >= 2 ** 31:
            raise ValueError(f"cgemm: [{b}, {n}] x [{n}, {m}] exceeds the "
                             "tensor-core kernel's int32 indices")
        hi, lo = tf32_operator(gr, gi)
        with torch.cuda.device(a.device):
            err = tc(a.data_ptr(), hi.data_ptr(), lo.data_ptr(),
                     y.data_ptr(), b, n, m, _stream(a.device))
        build.check(err, "cgemm_f32_tc")
    else:
        if (m + 63) // 64 > 65535:
            raise ValueError(f"cgemm: M={m} exceeds the kernel's grid")
        with torch.cuda.device(a.device):
            err = simt(a.data_ptr(), gr.data_ptr(), gi.data_ptr(),
                       y.data_ptr(), b, n, m, _stream(a.device))
        build.check(err, "cgemm_f32_simt")
    cgemm.launches += 1
    cgemm.launches_by_variant[kind] += 1
    return y


cgemm.launches = 0
cgemm.launches_by_variant = {TENSOR_CORES: 0, SIMT: 0}


@lru_cache(maxsize=None)
def _entries():
    """(cgemm_f32_simt, cgemm_operator_tf32, cgemm_f32_tc) of the built
    library."""
    lib = build.load("cgemm")
    fns = (lib.cgemm_f32_simt, lib.cgemm_operator_tf32, lib.cgemm_f32_tc)
    for fn, sizes in zip(fns, (3, 2, 3)):
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * sizes \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fns
