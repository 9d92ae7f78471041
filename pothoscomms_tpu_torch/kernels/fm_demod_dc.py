"""F1: the FM discriminator and the DC-removal cascade in one pass over a
[C, T] block (``csrc/fm_demod_dc.cu``).

It computes what the two fused cores compute one after the other,
``FreqDemod``'s (``parallel/chain.freq_demod_planar``) and
``DCRemoval``'s (``ops/filter.dc_removal_rows``), with both blocks'
carries in their own layouts: :func:`fm_demod_dc_plain` is those two
cores' torch ops, and :func:`fm_demod_dc` launches the CUDA kernel for
CUDA tensors and runs the plain version for CPU tensors; any other device
raises. ``parallel/compiler.compile_chain`` runs a FreqDemod directly
followed by a float32 DCRemoval as this one core where :func:`fits`.

The kernel's window sums are local float64 prefix sums over a block's
span of at most 2048 samples, the plain version's are float64 prefix sums
over the whole row: both round a float64 window sum once to float32, and
they agree to float32 rounding of the window sum, also at a DC offset.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from pothoscomms_tpu_torch.kernels import build
from pothoscomms_tpu_torch.ops.filter import dc_removal_rows
from pothoscomms_tpu_torch.parallel.chain import freq_demod_planar
from pothoscomms_tpu_torch.parallel.profiling import (
    annotate, first_launch, launching)

THREADS, PER = 256, 8    # csrc/fm_demod_dc.cu kThreads, kPer
SPAN = THREADS * PER     # samples a block stages: its tile and halo
MAX_HALO = 1536          # the largest cascade * (D - 1): tiles of >= 512
MAX_T = 1 << 30          # the kernel indexes a row with 32-bit ints


def fits(D: int, casc: int, T: int | None = None) -> bool:
    """Whether F1 takes a DC removal of average D and cascade ``casc`` (a
    halo of casc * (D - 1) samples within ``MAX_HALO``), and a block of T
    samples (D <= T <= MAX_T, so the new histories lie in the block; any T
    when None)."""
    return (D >= 1 and casc >= 1 and casc * (D - 1) <= MAX_HALO
            and (T is None or D <= T <= MAX_T))


def plan(T: int, D: int, casc: int):
    """(B, ntiles): the kernel's tiles of a row, ntiles = ceil(T / B)
    tiles of B outputs, B a multiple of 32 with B + casc * (D - 1) within
    the block's span, the tiles as even as that allows."""
    most = (SPAN - casc * (D - 1)) // 32 * 32
    ntiles = -(-T // most)
    per_tile = -(-T // ntiles)
    return -(-per_tile // 32) * 32, ntiles


def _check(x, last, hists, D, casc):
    if x.dim() != 3 or x.shape[2] != 2:
        raise ValueError(f"fm_demod_dc: x must be [C, T, 2], got "
                         f"{tuple(x.shape)}")
    C, T = x.shape[:2]
    if tuple(last.shape) != (C, 1, 2) or tuple(hists.shape) != (casc, C, D):
        raise ValueError(f"fm_demod_dc: last must be [{C}, 1, 2] and hists "
                         f"[{casc}, {C}, {D}], got {tuple(last.shape)} and "
                         f"{tuple(hists.shape)}")
    if {x.dtype, last.dtype, hists.dtype} != {torch.float32}:
        raise TypeError(f"fm_demod_dc: float32 only, got {x.dtype}, "
                        f"{last.dtype}, {hists.dtype}")
    if not x.device == last.device == hists.device:
        raise ValueError("fm_demod_dc: x, last and hists must be on one "
                         "device")
    if not fits(D, casc, T):
        raise ValueError(f"fm_demod_dc: takes {MAX_T} >= T >= D >= 1, "
                         f"cascade >= 1 and cascade * (D - 1) <= "
                         f"{MAX_HALO}, got T={T} D={D} cascade={casc}")


def fm_demod_dc_plain(x: torch.Tensor, last: torch.Tensor,
                      hists: torch.Tensor, D: int, casc: int):
    """Plain PyTorch version of :func:`fm_demod_dc`: the FreqDemod core,
    then the DCRemoval core, as the two single cores run them."""
    _check(x, last, hists, D, casc)
    u, new_last = freq_demod_planar(x, last)
    y, new_hists = dc_removal_rows(u, hists, D, casc)
    return y, new_last, new_hists


def fm_demod_dc(x: torch.Tensor, last: torch.Tensor, hists: torch.Tensor,
                D: int, casc: int):
    """The DC-removed discriminator output of x [C, T, 2] (planar complex
    float32) from the discriminator's carry last [C, 1, 2] (the previous
    sample) and the DC stages' histories hists [casc, C, D]: returns
    (y [C, T], new last, new hists), the values and layouts of
    ``freq_demod_planar`` followed by ``dc_removal_rows``. Needs
    :func:`fits`; on CUDA the operands must be contiguous."""
    _check(x, last, hists, D, casc)
    if x.device.type == "cpu":
        return fm_demod_dc_plain(x, last, hists, D, casc)
    if x.device.type != "cuda":
        raise ValueError(f"fm_demod_dc: no kernel for device {x.device}")
    if not fm_demod_dc.launches and fm_demod_dc not in launching:
        return first_launch(fm_demod_dc, x, last, hists, D, casc)
    if not (x.is_contiguous() and last.is_contiguous()
            and hists.is_contiguous()):
        raise ValueError("fm_demod_dc: x, last and hists must be contiguous")
    if x.data_ptr() % 8 or last.data_ptr() % 8:
        raise ValueError("fm_demod_dc: x and last must be 8-byte aligned")
    C, T = x.shape[:2]
    B, ntiles = plan(T, D, casc)
    if C * ntiles >= 2 ** 31:
        raise ValueError(f"fm_demod_dc: {C} x {ntiles} tiles exceed the "
                         f"kernel's grid")
    y = x.new_empty((C, T))
    new_last = torch.empty_like(last)
    new_hists = torch.empty_like(hists)
    with annotate("pc.kernel.fm_demod_dc"), torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry()(x.data_ptr(), last.data_ptr(), hists.data_ptr(),
                       y.data_ptr(), new_last.data_ptr(),
                       new_hists.data_ptr(), C, T, D, casc, B, ntiles,
                       stream)
    build.check(err, "fm_demod_dc_f32")
    fm_demod_dc.launches += 1
    return y, new_last, new_hists


fm_demod_dc.launches = 0


@lru_cache(maxsize=None)
def _entry():
    fn = build.load("fm_demod_dc").fm_demod_dc_f32
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 2 \
        + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn
