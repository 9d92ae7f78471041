"""Fused-chain compiler: a linear chain of blocks -> ONE step function (the
port of the JAX package's ``parallel/compiler.py``).

The streaming executor (core/topology.py) is the semantics path: every
block's work() runs separately with host-side buffers between them. For
high-rate multichannel processing the whole chain runs as one step over a
``[channels, time]`` block with an explicit carry, data staying on the
device between stages.

A block opts in by implementing ``device_core(channels, device=None)``
returning ``(carry0, step)`` with ``step(carry, x) -> (carry', y)`` over
planar float32 tensors:

- real streams:   x is [C, T] float32
- complex streams: x is [C, T, 2] planar float32

:func:`compile_chain` composes the cores front to back. The JAX package
jits the composition; torch runs eagerly, so the composed step is a plain
call, and each core's hand kernels (e.g. the envelope's E1) launch from
inside it. Carries are tuples (one entry per block).

Every ``device_core`` of the port composes here: the FIR (1:1 and
rational), the IIR filter, the FFT, the FM discriminator, DC removal and
the envelope follower. :func:`compile_chain_sharded` runs the same step on
one rank's channel shard of a ``parallel/mesh.Mesh``.

One pair of adjacent blocks takes one core: a ``FreqDemod`` on
complex_float32 directly followed by a ``DCRemoval`` on float32 runs as
F1 (``kernels/fm_demod_dc``, one pass over the block; its plain version,
the two cores' ops, on the CPU) wherever F1 takes the DC removal's
average D and cascade and the block's T (:func:`fm_pair`,
``fm_demod_dc.fits``). The rule reads only the blocks' types, dtypes, D,
cascade and T; elsewhere, and at a T below D, the two single cores run.
The carries keep one entry per block either way.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from pothoscomms_tpu_torch.core import placement
from pothoscomms_tpu_torch.core.dtypes import DType
from pothoscomms_tpu_torch.kernels.fm_demod_dc import fits, fm_demod_dc
from pothoscomms_tpu_torch.parallel import cplx
from pothoscomms_tpu_torch.parallel.chain import operators_from_numpy
from pothoscomms_tpu_torch.parallel.profiling import (annotate, build,
                                                      identity)


def fm_pair(first, second):
    """(D, cascade) where ``first``, ``second`` run as one F1 core at a
    block of T >= D samples: a FreqDemod on complex_float32 directly
    followed by a DCRemoval on float32 whose average D and cascade F1
    takes; else None."""
    from pothoscomms_tpu_torch.blocks.demod import FreqDemod
    from pothoscomms_tpu_torch.blocks.filter import DCRemoval

    if not (type(first) is FreqDemod and type(second) is DCRemoval
            and first.dtype == DType.parse("complex_float32")
            and second.dtype == DType.parse("float32")):
        return None
    d, casc = second.get_average_size(), second.get_cascade_size()
    return (d, casc) if fits(d, casc) else None


def _units(pairs, T: int):
    """The cores of a step of T samples, in order: (i, (D, cascade)) where
    blocks i and i + 1 run as one F1 core, (i, None) where block i runs
    alone; ``pairs[i]`` is :func:`fm_pair` of blocks i and i + 1, and
    ``pairs`` holds one entry a block (None for the last)."""
    i = 0
    while i < len(pairs):
        pair = pairs[i]
        if pair is not None and fits(*pair, T):
            yield i, pair
            i += 2
        else:
            yield i, None
            i += 1


def _pairs(blocks: Sequence[Any]) -> list:
    return [fm_pair(a, b) for a, b in zip(blocks, blocks[1:])] \
        + [None] * min(1, len(blocks))


def paired(blocks: Sequence[Any], T: int) -> list:
    """Indices i where blocks i and i + 1 run as one core in a step of T
    samples, as :func:`compile_chain`'s step takes them."""
    return [i for i, pair in _units(_pairs(blocks), T) if pair is not None]


def compile_chain(blocks: Sequence[Any], channels: int, device=None):
    """Compose ``device_core``s of a block chain into one step on
    ``device`` (default: each block's own, the card outside a topology).

    Returns (step, carry0): ``step(x, carry) -> (y, carry')``; each
    block's core runs inside its span, ``pc.chain.<Class>``, and the FM
    pair's one core (:func:`fm_pair`) inside
    ``pc.chain.FreqDemod+DCRemoval``. Each block's ``device_core`` is
    built inside the build span ``pc.build.core.<Class>``, keyed by the
    block, the channels and the device: compiling a block again is a
    rebuild. The FM pair builds nothing of its own: F1 runs on the two
    single cores' carries, and its first call is
    ``pc.build.first_launch.fm_demod_dc``.
    Raises TypeError for blocks that don't provide a device core.
    """
    cores = []
    carries = []
    spans = ["pc.chain." + type(blk).__name__ for blk in blocks]
    for blk in blocks:
        fn = getattr(blk, "device_core", None)
        if fn is None:
            raise TypeError(
                f"{type(blk).__name__} has no device_core; it cannot be "
                "fused (run it in the streaming executor instead)"
            )
        with build("pc.build.core." + type(blk).__name__,
                   key=(identity(blk), channels, device)):
            carry0, step = fn(channels, device=device)
        cores.append(step)
        carries.append(carry0)
    pairs = _pairs(blocks)
    pair_spans = [span + "+" + type(nxt).__name__
                  for span, nxt in zip(spans, blocks[1:])]

    def chain_step(x, carry):
        new_carries = []
        for i, pair in _units(pairs, x.shape[1]):
            if pair is None:
                with annotate(spans[i]):
                    c2, x = cores[i](carry[i], x)
                new_carries.append(c2)
            else:
                with annotate(pair_spans[i]):
                    x, last, hists = fm_demod_dc(x.contiguous(), carry[i],
                                                 carry[i + 1], *pair)
                new_carries += [last, hists]
        return x, tuple(new_carries)

    return chain_step, tuple(carries)


def compile_chain_sharded(blocks: Sequence[Any], channels: int, mesh,
                          axis: str = "ch"):
    """compile_chain with the [C, T(, 2)] block channel-sharded over the
    mesh axis ``axis`` (BASELINE config #4: "256 channels sharded").

    Each rank runs ``compile_chain(blocks, C // n)`` on its own [C/n,
    T(, 2)] shard, on the mesh's device and with its own carry: channel
    parallelism needs no collective. Each process builds its own blocks.
    Returns (step, carry0) like compile_chain; the step takes and returns
    the rank's shard (``parallel/mesh.shard`` and ``gather`` go between
    global and local).
    """
    n = mesh.axis_size(axis)
    if channels % n:
        raise ValueError(f"{channels} channels do not split into {n} shards")
    return compile_chain(blocks, channels // n, device=mesh.device)


def chain_carry_from_numpy(carry, device=None):
    """A JAX ``compile_chain`` carry (its tuple of per-block carries, each
    an array or a tuple of arrays, brought to numpy as float32) -> the
    same nesting of tensors on ``device`` (default: the card), so both
    packages can run on from one mid-stream state. The layouts are the
    same in both: a rational FIR's [C, K-1 + r, 2] (history, then the
    input-phase residue), an IIR filter's [O, C, 2] or [O, C]."""
    return operators_from_numpy(carry, device)


def run_chain_numpy(step, carry, x_np: np.ndarray):
    """Convenience host wrapper: numpy (complex ok) in/out, the step run
    where the carry lies (on the card for a carry that holds no tensor)."""
    if np.iscomplexobj(x_np):
        x = cplx.to_planar(np.ascontiguousarray(x_np, np.complex64))
    else:
        x = torch.from_numpy(np.ascontiguousarray(x_np, np.float32))
    devices = [c.device for c in carry if isinstance(c, torch.Tensor)]
    y, carry = step(x.to(devices[0] if devices else placement.DEFAULT_DEVICE),
                    carry)
    y = y.cpu().numpy()
    if y.ndim >= 1 and y.shape[-1] == 2:
        y = y[..., 0] + 1j * y[..., 1]
    return y, carry
