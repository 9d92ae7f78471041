"""The channelizer / spectrum monitor through the port's public entry
points: ``fir_fft_chain`` as its users call it, and the block API
(``Topology`` with ``/comms/fir_filter`` -> ``/comms/fft``)."""

from __future__ import annotations

import numpy as np

from pothoscomms_tpu_torch import BlockRegistry, Topology
from pothoscomms_tpu_torch.core import fusion
from pothoscomms_tpu_torch.core.fixtures import FeederSource
from pothoscomms_tpu_torch.parallel.chain import fir_fft_chain


def weights(cfg: dict, seed: int) -> np.ndarray:
    """The complex taps, (normal + j normal) / K from the seed."""
    rng = np.random.default_rng([seed, 7])
    k = int(cfg["taps"])
    return (rng.normal(size=k) + 1j * rng.normal(size=k)) / k


def step_entry(cfg: dict, taps, channels: int, samples: int, device):
    """(step, carry0): ``fir_fft_chain(taps, nbins, channels, samples)``."""
    return fir_fft_chain(taps, int(cfg["nbins"]), channels, samples,
                         device=device)


def stream_delay(cfg: dict) -> int:
    """Output sample j of the block API's stream has input j + K - 1 as
    its newest sample: the FIR emits once it holds K - 1 samples."""
    return int(cfg["taps"]) - 1


def topology_entry(cfg: dict, taps, device, sink):
    """(topology, feeder): FeederSource -> fir_filter -> fft -> ``sink``,
    committed on ``Topology(device)``, the edges sized for quanta of
    ``fusion.MAX_QUANTUM`` as the port's smoke test sizes them."""
    qb = fusion.MAX_QUANTUM
    feed = FeederSource("complex_float32")
    fir = BlockRegistry.make("/comms/fir_filter", "complex_float32",
                             "COMPLEX")
    fir.set_taps(taps)
    fft = BlockRegistry.make("/comms/fft", "complex_float32",
                             int(cfg["nbins"]), False)
    topo = Topology(device=device)
    for a, b in ((feed, fir), (fir, fft), (fft, sink)):
        topo.connect(a, 0, b, 0)
    fir.input(0).set_capacity(4 * qb)
    fft.input(0).set_capacity(2 * qb)
    sink.input(0).set_capacity(2 * qb)
    topo.commit()
    return topo, feed
