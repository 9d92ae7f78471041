"""Where the port's work runs when the caller names no device: the card.

Every entry point (``Topology``, ``Block.device`` outside a topology,
``fir_fft_chain``, ``make_fused_chain``, ``compile_chain`` and the
``*_from_numpy`` converters) resolves its ``device`` argument here. The
default does not probe ``torch.cuda.is_available()``: without a card, the
first allocation on it raises torch's own error, and nothing carries on on
the CPU. Callers that want the CPU (the CPU tests) say ``device="cpu"``.

The scale-out layer (``parallel/mesh.py``) runs one process per device;
:func:`rank_device` gives each rank its card, and :func:`backend` the
``torch.distributed`` backend that device needs.
"""

from __future__ import annotations

import os

import torch

DEFAULT_DEVICE = torch.device("cuda")


def resolve(device=None) -> torch.device:
    """``device`` as a ``torch.device``; the card when it is None."""
    return DEFAULT_DEVICE if device is None else torch.device(device)


def rank_device(device=None, rank=None) -> torch.device:
    """This rank's device: ``device`` as a ``torch.device`` where given,
    else the card of the rank's local index on its host (``LOCAL_RANK``,
    as torchrun sets it; else ``rank``; else 0)."""
    if device is not None:
        return torch.device(device)
    local = int(os.environ.get("LOCAL_RANK", rank or 0))
    return torch.device(DEFAULT_DEVICE.type, local)


def backend(device: torch.device) -> str:
    """The process-group backend for a rank on ``device``: NCCL on the
    card, gloo on the CPU."""
    return "nccl" if device.type == "cuda" else "gloo"
