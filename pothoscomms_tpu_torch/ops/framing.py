"""PHY synchronisation cores on tensors (the port of the JAX package's
``ops/framing.py``).

The reference's frame synchroniser walks candidate offsets one sample at a
time (digital/FrameSync.cpp:470-497), its most expensive loop. Here the
whole per-offset search (envelope consistency, frequency estimate,
dechirped correlation — FrameSync.cpp:595-693) is one call over every
offset of every channel: S1, :func:`pothoscomms_tpu_torch.kernels.
sync_search.sync_search` (a CUDA kernel on the card, its plain torch
version on the CPU). Only the small acceptance automaton and the one-off
header decode stay on the host (blocks/framing.py).

Also here: the preamble correlator's sliding Hamming distance
(digital/PreambleCorrelator.cpp:130-151) as a bit-plane correlation —
XOR-popcount decomposes into ``dist[i] = bias + sum_j x_bits[i+j] . (1 -
2 p_bits[j])``, one float32 ``conv1d``. Every product is of 0/1 and +-1
and every sum an integer far below 2^24, so the result is exact in float32
(and in TF32, which cuDNN would use if allowed: 0 and +-1 are exact
there too).
"""

from __future__ import annotations

import numpy as np
import torch

from pothoscomms_tpu_torch.core import placement
from pothoscomms_tpu_torch.kernels.sync_search import sync_search
from pothoscomms_tpu_torch.parallel import cplx


def sync_search_planar(x: torch.Tensor, pre: torch.Tensor, thr: float,
                       sw: int, w: int, dw: int, npre: int, n: int):
    """Per-offset frame-search arrays for offsets 0 .. n-1.

    x: [L, 2] or [C, L, 2] planar float32 with L >= n + sw - 1 (callers
    pad; padded offsets are sliced away on the host); pre: [npre, 2] the
    planar preamble. Returns (scale, delta_fc, phase_off, corr_peak), each
    [n] or [C, n] float32 (corr_peak floored to integer semantics).
    Numerics follow digital/FrameSync.cpp:595-693; see blocks/framing.py
    FrameSync for the acceptance automaton.
    """
    single = x.dim() == 2
    xc = x[None] if single else x
    out = sync_search(xc.contiguous(), pre.contiguous(), thr, sw, w, dw,
                      npre, n)
    return tuple(o[0] for o in out) if single else out


def make_sync_search(preamble: np.ndarray, symbol_width: int,
                     data_width: int, input_threshold: float, device=None):
    """Close over frame-sync settings -> search(x_planar, n) callable.

    The returned function takes planar x [L, 2] (numpy or tensor), puts it
    on ``device`` (the card unless the caller names one) and returns the
    four arrays for offsets 0 .. n-1 as numpy (corr_peak as int64).
    """
    dev = placement.resolve(device)
    pre = np.asarray(preamble)
    npre = len(pre)
    w = symbol_width * data_width
    sw = w * npre
    pre_p = cplx.to_planar(np.asarray(pre, np.complex64)).to(dev)
    thr = float(input_threshold)

    def search(x_planar, n: int):
        x = torch.as_tensor(np.asarray(x_planar, np.float32)).to(dev)
        s, d, p, c = sync_search_planar(x, pre_p, thr, sw, w, data_width,
                                        npre, n)
        return (s.cpu().numpy(), d.cpu().numpy(), p.cpu().numpy(),
                c.cpu().numpy().astype(np.int64))

    return search


# --------------------------------------------------------------------- #
# Preamble correlator: sliding Hamming distance as bit-plane correlation
# --------------------------------------------------------------------- #
def _bitplane_weights(preamble: np.ndarray, nbits: int = 8):
    """Preamble -> (weight [P, nbits], bias) so that
    dist[i] = bias + sum over the window of x bit planes * weight."""
    p = np.asarray(preamble, np.uint8)
    pb = ((p[:, None] >> np.arange(nbits)[None, :]) & 1).astype(np.float32)
    weight = 1.0 - 2.0 * pb            # [P, nbits]
    bias = float(pb.sum())
    return weight, bias


def hamming_profile(x: torch.Tensor, weight: torch.Tensor, bias: float,
                    plen: int, nbits: int, n: int) -> torch.Tensor:
    """Sliding Hamming distance of a uint8-symbol stream to a preamble.

    x: [L] float32 symbol values (integer-valued, < 2**nbits), L >= n +
    plen - 1; weight: [plen, nbits] from :func:`_bitplane_weights`.
    Returns [n] float32 distances (exact integers):
    dist[i] = bias + sum_j xb[i+j] . weight[j], a "valid" correlation over
    the bit-plane feature axis (conv1d correlates, it does not flip).
    """
    shifts = torch.arange(nbits, device=x.device)
    xb = ((torch.round(x).to(torch.int64)[:, None] >> shifts) & 1).to(
        torch.float32)                                   # [L, nbits]
    out = torch.nn.functional.conv1d(xb.T[None], weight.T[None])
    return bias + out[0, 0, :n]


def make_hamming_profile(preamble: np.ndarray, nbits: int = 8, device=None):
    """Close over the preamble -> profile(x_uint8, n) -> numpy int64, on
    ``device`` (the card unless the caller names one)."""
    dev = placement.resolve(device)
    weight, bias = _bitplane_weights(preamble, nbits)
    wt = torch.from_numpy(weight).to(dev)
    plen = len(np.asarray(preamble))

    def profile(x, n: int):
        xf = torch.from_numpy(np.asarray(x, np.float32)).to(dev)
        d = hamming_profile(xf, wt, bias, plen, nbits, n)
        return d.cpu().numpy().astype(np.int64)

    return profile


def bucket_len(n: int, minimum: int = 1024) -> int:
    """Round up to the next power of two (>= minimum), so the search's
    shapes stay few."""
    b = minimum
    while b < n:
        b *= 2
    return b
