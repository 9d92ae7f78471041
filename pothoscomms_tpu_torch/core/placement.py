"""Where the port's work runs when the caller names no device: the card.

Every entry point (``Topology``, ``Block.device`` outside a topology,
``fir_fft_chain``, ``make_fused_chain``, ``compile_chain`` and the
``*_from_numpy`` converters) resolves its ``device`` argument here. The
default does not probe ``torch.cuda.is_available()``: without a card, the
first allocation on it raises torch's own error, and nothing carries on on
the CPU. Callers that want the CPU (the CPU tests) say ``device="cpu"``.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = torch.device("cuda")


def resolve(device=None) -> torch.device:
    """``device`` as a ``torch.device``; the card when it is None."""
    return DEFAULT_DEVICE if device is None else torch.device(device)
