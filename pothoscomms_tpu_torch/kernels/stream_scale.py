"""P1: the streaming ceiling probe, y = 2 x on two f32 planes
(``csrc/stream_scale.cu``).

The counterpart of ``scale_pallas`` in ``benches/probe_pallas_ceiling.py``:
what a trivial streaming kernel reaches on the card, the roof the
repo's other kernels are read against (``benches_torch/
probe_stream_ceiling.py``). :func:`stream_scale` launches the CUDA
kernel for CUDA tensors and uses :func:`stream_scale_plain` only for CPU
tensors; any other device raises.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from pothoscomms_tpu_torch.kernels import build
from pothoscomms_tpu_torch.parallel.profiling import (
    annotate, first_launch, launching)


# blocks a launch may take per SM: 16 waves of the 8 resident 256-thread
# blocks of the kernel
UNITS_PER_SM = 128


def stream_scale_plain(xr: torch.Tensor, xi: torch.Tensor,
                       rows_per_block: int = 256):
    """Plain PyTorch version of :func:`stream_scale` (the row tile does
    not change the result)."""
    return xr * 2.0, xi * 2.0


@lru_cache(maxsize=None)
def _units(index: int) -> int:
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return sms * UNITS_PER_SM


def stream_scale(xr: torch.Tensor, xi: torch.Tensor,
                 rows_per_block: int = 256):
    """(2 xr, 2 xi) for two float32 planes of one shape [B, N].

    ``rows_per_block`` is the probe's row tile tb, kept so the probe
    sweeps tb as the TPU probe does; the kernel does not take it: its grid
    fills the card whatever tb is, one flat range of both planes cut into
    equal units (``csrc/stream_scale.cu``). On CUDA both planes must be
    contiguous.
    """
    if xr.dim() != 2 or xr.shape != xi.shape:
        raise ValueError(f"stream_scale: planes must be one [B, N] shape, "
                         f"got {tuple(xr.shape)} and {tuple(xi.shape)}")
    if xr.dtype != torch.float32 or xi.dtype != torch.float32:
        raise TypeError(f"stream_scale: float32 only, got {xr.dtype}, "
                        f"{xi.dtype}")
    if xr.device != xi.device:
        raise ValueError("stream_scale: both planes must be on one device")
    if rows_per_block < 1:
        raise ValueError(f"stream_scale: rows_per_block={rows_per_block}")
    if xr.device.type == "cpu":
        return stream_scale_plain(xr, xi, rows_per_block)
    if xr.device.type != "cuda":
        raise ValueError(f"stream_scale: no kernel for device {xr.device}")
    if not stream_scale.launches and stream_scale not in launching:
        return first_launch(stream_scale, xr, xi, rows_per_block)
    if not (xr.is_contiguous() and xi.is_contiguous()):
        raise ValueError("stream_scale: planes must be contiguous")
    b, n = xr.shape
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    with annotate("pc.kernel.stream_scale"), torch.cuda.device(xr.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry()(xr.data_ptr(), xi.data_ptr(), yr.data_ptr(),
                       yi.data_ptr(), b, n,
                       _units(torch.cuda.current_device()), stream)
    build.check(err, "stream_scale_f32")
    stream_scale.launches += 1
    return yr, yi


stream_scale.launches = 0


@lru_cache(maxsize=None)
def _entry():
    fn = build.load("stream_scale").stream_scale_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2 \
        + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn
