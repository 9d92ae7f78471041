"""The burst receiver bank through the port's public entry point:
``parallel.link.make_link_receiver``, built once and called a step on a
window batch already on the card."""

from __future__ import annotations

from pothoscomms_tpu_torch.parallel.link import make_link_receiver


def weights(cfg: dict, seed: int) -> dict:
    """The link has no random weights: its payloads come with the traffic."""
    return {}


def step_entry(cfg: dict, w: dict, channels: int, window: int, device):
    """``receive(x, lengths) -> LinkFrames`` for ``channels`` channels of
    ``window`` samples."""
    return make_link_receiver(
        channels, window, int(cfg["payload_bits"]),
        preamble=tuple(cfg["preamble"]),
        symbol_width=int(cfg["symbol_width"]),
        data_width=int(cfg["data_width"]), poly=int(cfg["scrambler_poly"]),
        seed=int(cfg["scrambler_seed"]), header_id=int(cfg["header_id"]),
        input_threshold=float(cfg["input_threshold"]), device=device)
