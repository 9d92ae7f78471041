"""D1: the link's frame decode for every channel of a batch on the card
(``csrc/frame_decode.cu``): the acceptance automaton over S1's arrays,
the header, the payload's slicer and the descrambler, one block a channel.

:func:`frame_decode` launches the kernel for CUDA tensors. It computes
what ``parallel/link.decode_frame`` computes on the host for each
channel, and that host decode, which the receiver runs on CPU tensors,
is its plain version: a CPU tensor, any other device, a wrong dtype or
shape, or a non-contiguous operand raises here. It replaces no TPU
kernel (the JAX package decodes each channel on the host).

Each channel's result is a record of :func:`record_bytes` bytes (layout
in the source; :func:`read_records` unpacks a batch of them). The
keystream is the additive descrambler's, :data:`KEYSTREAM_BITS` long.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from pothoscomms_tpu_torch.kernels import build
from pothoscomms_tpu_torch.parallel.profiling import annotate

MAX_LENGTH = (1 << 12) - 1          # the header's 12-bit payload length
# keystream bits the descrambler reads at most: the longest payload, then
# align_payload's two shifts
KEYSTREAM_BITS = MAX_LENGTH + 2
RECORD_HEAD = 32                    # bytes of a record before its bits


def record_bytes(n_bits: int) -> int:
    """A channel's record: 32 bytes, then ``n_bits`` bits a byte, padded
    to 16 bytes."""
    return RECORD_HEAD + -(-n_bits // 16) * 16


def read_records(buf: np.ndarray, n_bits: int, bits=None) -> dict:
    """The frames of a batch of records (uint8 [C, record_bytes]), in
    arrays of their own: ``offset`` int64 (-1: no header decoded),
    ``scale``, ``dfc``, ``phase`` float64 (NaN there), ``rejects`` and
    ``shift`` int32 (-1: payload not recovered), ``found`` bool and
    ``bits`` uint8 [C, n_bits], written into ``bits`` where given."""
    if bits is None:
        bits = np.empty((buf.shape[0], n_bits), np.uint8)
    np.copyto(bits, buf[:, RECORD_HEAD:RECORD_HEAD + n_bits])
    head = np.ascontiguousarray(buf[:, :RECORD_HEAD])
    est = head[:, 8:20].view(np.float32).astype(np.float64)
    ints = head[:, 20:28].view(np.int32)
    shift = ints[:, 1].copy()
    return {"offset": head[:, :8].view(np.int64)[:, 0].copy(),
            "scale": est[:, 0].copy(), "dfc": est[:, 1].copy(),
            "phase": est[:, 2].copy(), "rejects": ints[:, 0].copy(),
            "shift": shift, "found": shift >= 0,
            "bits": bits}


def _check(arrays, x, lengths, keystream, out, n_bits, sw, w, fw, dw):
    if len(arrays) != 4:
        raise ValueError(f"frame_decode: four search arrays, got "
                         f"{len(arrays)}")
    if x.dim() != 3 or x.shape[2] != 2:
        raise ValueError(f"frame_decode: x must be [C, lp, 2], got "
                         f"{tuple(x.shape)}")
    C, lp = x.shape[:2]
    n_pad = lp - fw + 1  # S1's offsets over the window
    if any(tuple(a.shape) != (C, n_pad) for a in arrays):
        raise ValueError(f"frame_decode: the arrays must be [{C}, {n_pad}] "
                         f"for x [{C}, {lp}, 2], got "
                         f"{[tuple(a.shape) for a in arrays]}")
    if tuple(lengths.shape) != (C,) or keystream.dim() != 1 \
            or keystream.shape[0] < KEYSTREAM_BITS \
            or tuple(out.shape) != (C, record_bytes(n_bits)):
        raise ValueError(f"frame_decode: lengths [{C}], a keystream of >= "
                         f"{KEYSTREAM_BITS} bits and out [{C}, "
                         f"{record_bytes(n_bits)}], got "
                         f"{tuple(lengths.shape)}, {tuple(keystream.shape)}"
                         f", {tuple(out.shape)}")
    if any(a.dtype != torch.float32 for a in (*arrays, x)) \
            or lengths.dtype != torch.int64 \
            or keystream.dtype != torch.uint8 or out.dtype != torch.uint8:
        raise TypeError("frame_decode: float32 arrays and x, int64 lengths, "
                        "uint8 keystream and out")
    if not (n_bits >= 0 and dw >= 1 and w >= 2 and sw >= w and n_pad >= 1):
        raise ValueError(f"frame_decode: need n_bits >= 0, dw >= 1, w >= 2, "
                         f"sw >= w and a window longer than a frame head, "
                         f"got n_bits={n_bits} dw={dw} w={w} sw={sw} lp={lp}")
    tensors = (*arrays, x, lengths, keystream, out)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("frame_decode: every operand on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("frame_decode: every operand contiguous")


def frame_decode(arrays, x: torch.Tensor, lengths: torch.Tensor,
                 keystream: torch.Tensor, out: torch.Tensor, *, n_bits: int,
                 sw: int, w: int, fw: int, dw: int, mag: int, dur: int,
                 header_id: int, last_symbol: complex) -> torch.Tensor:
    """Decode every channel's frame into ``out`` (uint8 [C,
    record_bytes(n_bits)]) and return it.

    arrays: S1's (scale, delta_fc, phase_off, corr_peak), each float32
    [C, n_pad]; x: the searched window, float32 [C, lp, 2] with lp =
    n_pad + fw - 1; lengths: int64 [C], channel c's samples valid up to
    lengths[c]; keystream: the additive descrambler's bits on zeros,
    uint8, at least :data:`KEYSTREAM_BITS`; sw, w, fw, mag and dur the
    frame's geometry (``parallel/link.frame_geometry``), dw samples a
    bit; last_symbol the preamble's last symbol. On the card's current
    stream; nothing is synchronised."""
    _check(arrays, x, lengths, keystream, out, n_bits, sw, w, fw, dw)
    if x.device.type != "cuda":
        raise ValueError(f"frame_decode: no kernel for device {x.device}; "
                         "on the host the link decodes a channel at a time "
                         "(parallel/link.decode_frame)")
    C, lp = x.shape[:2]
    sym = complex(last_symbol).conjugate()
    with annotate("pc.kernel.frame_decode"), torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry()(*(a.data_ptr() for a in arrays), x.data_ptr(),
                       lengths.data_ptr(), keystream.data_ptr(),
                       out.data_ptr(), C, arrays[0].shape[1], lp,
                       out.shape[1], n_bits, keystream.shape[0], sw, w, dw,
                       mag, dur, header_id, sym.real, sym.imag, stream)
    build.check(err, "frame_decode_f32")
    frame_decode.launches += 1
    return out


frame_decode.launches = 0


@lru_cache(maxsize=None)
def _entry():
    fn = build.load("frame_decode").frame_decode_f32
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_longlong] * 12 \
        + [ctypes.c_double] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def load() -> None:
    """Build and load the kernel's library now (nvcc on first use)."""
    _entry()
