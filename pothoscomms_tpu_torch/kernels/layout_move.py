"""P2: the layout-move probe, four in-row permutations of a [B, N] f32
array (``csrc/layout_move.cu``).

The counterpart of ``try_kernel.run`` in ``benches/probe_mosaic.py``
and its four bodies: what each move costs on the card against a plain
copy (``benches_torch/probe_layout.py``). :func:`layout_move` launches
the CUDA kernel for a CUDA tensor and uses :func:`layout_move_plain`
only for a CPU tensor; any other device raises.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from pothoscomms_tpu_torch.kernels import build
from pothoscomms_tpu_torch.parallel.profiling import (
    annotate, first_launch, launching)

MODES = ("A", "B", "C", "D")
MAX_N = 8192  # one row must fit the kernel's shared-memory tile
TILE = 2048   # words in the kernel's tile of rows of N <= 2048


def layout_move_plain(x: torch.Tensor, mode: str) -> torch.Tensor:
    """The probe's numpy oracles (``probe_mosaic.py:56, 62, 69-70, 76``)
    in torch: A (8, N/8) swap, B (N/8, 8) swap, C (8, N/64, 8)
    transpose (0, 3, 2, 1), D the stride-8 lane gather."""
    b, n = x.shape
    if mode == "A":
        return x.reshape(b, 8, n // 8).transpose(1, 2).reshape(b, n)
    if mode == "B":
        return x.reshape(b, n // 8, 8).transpose(1, 2).reshape(b, n)
    if mode == "C":
        return x.reshape(b, 8, n // 64, 8).permute(0, 3, 2, 1).reshape(b, n)
    if mode == "D":
        return torch.cat([x[:, m::8] for m in range(8)], dim=1)
    raise ValueError(f"layout_move: mode {mode!r} not in {MODES}")


def layout_move(x: torch.Tensor, mode: str) -> torch.Tensor:
    """Permute each row of x [B, N] float32 by ``mode`` (A, B, C or D;
    module docstring). N must be a multiple of 64 and, on CUDA, at most
    8192, with x contiguous."""
    if mode not in MODES:
        raise ValueError(f"layout_move: mode {mode!r} not in {MODES}")
    if x.dim() != 2 or x.shape[1] % 64 != 0 or x.shape[1] == 0:
        raise ValueError(f"layout_move: x must be [B, N] with N a multiple "
                         f"of 64, got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"layout_move: float32 only, got {x.dtype}")
    if x.device.type == "cpu":
        return layout_move_plain(x, mode)
    if x.device.type != "cuda":
        raise ValueError(f"layout_move: no kernel for device {x.device}")
    if not layout_move.launches and layout_move not in launching:
        return first_launch(layout_move, x, mode)
    if not x.is_contiguous():
        raise ValueError("layout_move: x must be contiguous")
    b, n = x.shape
    if n > MAX_N:
        raise ValueError(f"layout_move: N={n} above the kernel's {MAX_N}")
    if -(-b // max(1, TILE // n)) >= 2 ** 31:
        raise ValueError(f"layout_move: B={b} exceeds the kernel's grid")
    y = torch.empty_like(x)
    with annotate("pc.kernel.layout_move"), torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry()(x.data_ptr(), y.data_ptr(), b, n, MODES.index(mode),
                       stream)
    build.check(err, "layout_move_f32")
    layout_move.launches += 1
    return y


layout_move.launches = 0


@lru_cache(maxsize=None)
def _entry():
    fn = build.load("layout_move").layout_move_f32
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn
