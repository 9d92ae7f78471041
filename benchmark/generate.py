"""The one generator of inputs: reads a traffic file's ``signal`` block
and makes the samples from the seed, on the device, in a few large calls.

Signal kinds:

- ``complex_normal``: independent complex samples, each plane N(0, 1)
  (the north-star bench's inputs);
- ``fm_carriers``: one FM carrier a channel. Each channel has a carrier
  offset drawn from [-carrier_max, carrier_max] cycles a sample, ``tones``
  message tones between ``tone_min`` and ``tone_max`` cycles a sample whose
  summed deviation is ``deviation`` cycles a sample, an amplitude in
  [amp_min, amp_max] with a slow AM of depth ``am_depth`` (a whole number
  of cycles over the stream), and complex Gaussian noise ``snr_db`` below
  the carrier. The phase track closes on itself over the whole stream,
  so a pool of inputs played in a cycle is one continuous signal; the
  phase step between samples stays inside +-(carrier_max + deviation)
  cycles plus noise, far from the discriminator's branch cut at +-pi.

A stream is [channels, total, 2] planar float32, cut along time into
``count`` consecutive pieces.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np
import torch


def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def stream(signal: dict, channels: int, total: int, seed: int,
           device) -> torch.Tensor:
    """[channels, total, 2] float32 planar samples on ``device``."""
    g = _generator(seed, device)
    kind = signal["kind"]
    if kind == "complex_normal":
        return torch.randn((channels, total, 2), generator=g, device=device)
    if kind == "fm_carriers":
        return _fm_carriers(signal, channels, total, g, device)
    raise ValueError(f"unknown signal kind {kind!r}")


def _fm_carriers(s: dict, c: int, n: int, g, device) -> torch.Tensor:
    f64 = torch.float64

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=g, device=device,
                                           dtype=f64)

    m = int(s["tones"])
    fc = uniform((c, 1), -s["carrier_max"], s["carrier_max"])
    ftone = uniform((c, m), s["tone_min"], s["tone_max"])
    weight = uniform((c, m), 0.2, 1.0)
    amp_tone = s["deviation"] * weight / weight.sum(dim=1, keepdim=True)
    phase0 = uniform((c, m), 0.0, 2 * math.pi)
    t = torch.arange(n, device=device, dtype=f64)
    inst = fc.expand(c, n).clone()
    for k in range(m):
        inst += amp_tone[:, k:k + 1] * torch.cos(
            2 * math.pi * ftone[:, k:k + 1] * t + phase0[:, k:k + 1])
    # close the phase track: a whole number of cycles over the stream
    total = inst.sum(dim=1, keepdim=True)
    inst -= (total - torch.round(total)) / n
    phase = 2 * math.pi * torch.cumsum(inst, dim=1)
    del inst
    amp = uniform((c, 1), s["amp_min"], s["amp_max"])
    am_cycles = torch.randint(1, 65, (c, 1), generator=g, device=device)
    am_phase = uniform((c, 1), 0.0, 2 * math.pi)
    env = amp * (1 + s["am_depth"] * torch.cos(
        2 * math.pi * am_cycles.to(f64) * t / n + am_phase))
    out = torch.empty((c, n, 2), device=device, dtype=torch.float32)
    out[..., 0] = env * torch.cos(phase)
    out[..., 1] = env * torch.sin(phase)
    del phase, env
    sigma = (amp * 10 ** (-s["snr_db"] / 20) / math.sqrt(2)).to(torch.float32)
    out += sigma[..., None] * torch.randn((c, n, 2), generator=g,
                                          device=device)
    return out


def pool(signal: dict, count: int, channels: int, samples: int, seed: int,
         device) -> List[torch.Tensor]:
    """``count`` consecutive pieces [channels, samples, 2] of one stream,
    each contiguous, on ``device``."""
    if signal["kind"] == "complex_normal":
        g = _generator(seed, device)
        block = torch.randn((count, channels, samples, 2), generator=g,
                            device=device)
        return list(block.unbind(0))
    s = stream(signal, channels, count * samples, seed, device)
    out = [s[:, i * samples:(i + 1) * samples].contiguous()
           for i in range(count)]
    del s
    return out


def host_buffers(signal: dict, count: int, samples: int, seed: int,
                 device) -> List[np.ndarray]:
    """``count`` consecutive pieces of one single-channel stream as host
    numpy complex64 arrays of ``samples`` each, made on ``device``. Beside
    a CUDA device they are page-locked, as a receiver's DMA buffers are;
    beside the CPU they are plain host memory."""
    s = stream(signal, 1, count * samples, seed, device)[0]
    out = []
    for i in range(count):
        piece = s[i * samples:(i + 1) * samples]
        host = torch.empty(piece.shape, dtype=piece.dtype,
                           pin_memory=device.type == "cuda")
        host.copy_(piece)
        # the array keeps the tensor, and so its memory, alive
        out.append(host.numpy().view(np.complex64)[:, 0])
    return out
