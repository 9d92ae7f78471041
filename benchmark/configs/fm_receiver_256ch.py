"""The FM receive bank through the port's public entry point:
``compile_chain([freq_demod, dc_removal, envelope_detector], channels)``."""

from __future__ import annotations

from pothoscomms_tpu_torch import BlockRegistry
from pothoscomms_tpu_torch.parallel.compiler import compile_chain


def weights(cfg: dict, seed: int) -> dict:
    """The block settings; the chain has no random weights."""
    return {"average": int(cfg["dc_average"]),
            "cascade": int(cfg["dc_cascade"]),
            "attack": float(cfg["envelope_attack"]),
            "release": float(cfg["envelope_release"])}


def step_entry(cfg: dict, w: dict, channels: int, samples: int, device):
    """(step, carry0) of the compiled three-block chain."""
    demod = BlockRegistry.make("/comms/freq_demod", "complex_float32")
    dc = BlockRegistry.make("/comms/dc_removal", "float32")
    dc.set_average_size(w["average"])
    dc.set_cascade_size(w["cascade"])
    env = BlockRegistry.make("/comms/envelope_detector", "float32")
    env.set_attack(w["attack"])
    env.set_release(w["release"])
    env.set_lookahead(int(cfg["envelope_lookahead"]))
    return compile_chain([demod, dc, env], channels=channels, device=device)
