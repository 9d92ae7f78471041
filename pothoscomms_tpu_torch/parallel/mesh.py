"""Mesh sharding for multi-card scale-out on ``torch.distributed``: the port
of the JAX package's ``parallel/mesh.py``.

The reference has no distribution layer (SURVEY.md §2.13(4): the Pothos
remote proxy only). The JAX package shards ``[channel, time]`` streams
over a ``jax.sharding.Mesh`` with ``shard_map``; here one process runs
per device, so every sharded function is the body of that ``shard_map``:
it takes the calling rank's local shard and returns its local shard.
:func:`shard` and :func:`gather` go between global and local arrays, as
``jax.make_array_from_callback`` and ``np.asarray(global)`` do for the
JAX package.

Two shardings:

- **Channel sharding** ("ch" axis): each rank owns C/n channels end to
  end. No collectives in steady state.
- **Time sharding** ("t" axis): each rank owns a contiguous time slice.
  Stateful filters need the K-1 samples before the slice: rank i sends
  the tail of its slice to rank i+1 (point to point, in place of JAX's
  ``ppermute``), rank 0 takes the stream's carry in its place, and the
  new carry, the last rank's tail, goes to every rank by a broadcast (in
  place of JAX's ``psum`` of a one-hot contribution).

Every buffer sent or received is contiguous. The tail ``x[:, -(K-1):]``
of a multichannel slice is a strided view, and a process group is no
place for one: gloo refuses it on the sender, and a strided receive
buffer would be written as if it were dense.

A mesh needs an initialized process group (``distributed.initialize``):
NCCL when the rank's device is the card, gloo on the CPU.
"""

from __future__ import annotations

from math import prod
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from pothoscomms_tpu_torch.core import placement
from pothoscomms_tpu_torch.ops.filter import _polyphase_matrix, polyphase_fir
from pothoscomms_tpu_torch.parallel.chain import (
    combined_fir_fft_operators, complex_fir_kernel, fir_fft_combined_step,
    fir_fft_step, fir_multichannel, stack_combined_operators)


class Mesh:
    """This rank's view of a device mesh: for each axis name its size, the
    rank's index along it and the process group of the ranks that share
    every other index; and the rank's device.

    Built by :func:`make_mesh`, ``distributed.make_global_mesh`` and
    ``distributed.make_2d_mesh``. The collectives the sharded functions
    issue go through its methods, which count them: ``p2p_ops`` (sends
    and receives) and ``collectives`` (broadcasts, gathers, reductions).
    """

    def __init__(self, axes: Dict[str, Tuple[int, int, object]],
                 device: torch.device):
        self.axes = axes
        self.device = device
        self.p2p_ops = 0
        self.collectives = 0

    @property
    def shape(self) -> Dict[str, int]:
        return {a: n for a, (n, _, _) in self.axes.items()}

    @property
    def size(self) -> int:
        return prod(self.shape.values())

    def axis_size(self, axis: str) -> int:
        return self.axes[axis][0]

    def axis_index(self, axis: str) -> int:
        return self.axes[axis][1]

    def _peer(self, axis: str, index: int) -> int:
        return dist.get_global_rank(self.axes[axis][2], index)

    def shift_right(self, t: torch.Tensor,
                    axis: str) -> Optional[torch.Tensor]:
        """Send ``t`` to index i+1 along ``axis`` and return what index i-1
        sent (None at index 0). Nothing wraps around, and an axis of one
        rank sends nothing."""
        n, i, group = self.axes[axis]
        t = t.contiguous()
        ops, got = [], None
        if i + 1 < n:
            ops.append(dist.P2POp(dist.isend, t, self._peer(axis, i + 1),
                                  group))
        if i > 0:
            got = torch.empty_like(t)
            ops.append(dist.P2POp(dist.irecv, got, self._peer(axis, i - 1),
                                  group))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
            self.p2p_ops += len(ops)
        return got

    def broadcast_from_last(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """The last index's ``t`` along ``axis``, on every rank of it."""
        n, i, group = self.axes[axis]
        buf = t.contiguous() if i == n - 1 else torch.empty_like(t)
        dist.broadcast(buf, src=self._peer(axis, n - 1), group=group)
        self.collectives += 1
        return buf

    def all_gather_cat(self, t: torch.Tensor, axis: str,
                       dim: int) -> torch.Tensor:
        """Every index's ``t`` along ``axis``, joined along ``dim`` in
        index order."""
        n, _, group = self.axes[axis]
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t, group=group)
        self.collectives += 1
        return torch.cat(parts, dim=dim)

    def all_gather_object(self, obj, axis: str) -> list:
        """Every index's picklable ``obj`` along ``axis``, in index order."""
        n, _, group = self.axes[axis]
        out = [None] * n
        dist.all_gather_object(out, obj, group=group)
        self.collectives += 1
        return out

    def all_reduce_max(self, value: int, axis: str) -> int:
        """The largest of every index's integer ``value`` along ``axis``."""
        t = torch.tensor([value], dtype=torch.int64, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.axes[axis][2])
        self.collectives += 1
        return int(t.item())


def resolve(device=None, rank=None) -> Tuple[torch.device, str]:
    """(this rank's device, the backend its process group must have): the
    card of the rank's local index (``placement.rank_device``) over NCCL
    unless the caller names a device (``device="cpu"``: gloo).
    Initializes nothing."""
    dev = placement.rank_device(device, rank)
    return dev, placement.backend(dev)


def _mesh_device(device) -> torch.device:
    """This rank's device for a mesh, checked against the process group's
    backend (no gloo on the card, no NCCL on the CPU)."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call "
                           "parallel.distributed.initialize first")
    dev, backend = resolve(device, dist.get_rank())
    have = dist.get_backend()
    if have != backend:
        raise ValueError(f"the process group runs {have}; a mesh on {dev} "
                         f"needs {backend}")
    return dev


def _mesh_1d(ranks: Sequence[int], axis: str, device) -> Optional[Mesh]:
    """A 1-D mesh over ``ranks`` (indices in ascending rank order). Every
    rank of the job calls it; a rank outside ``ranks`` gets None."""
    dev = _mesh_device(device)
    ranks = sorted(ranks)
    group = dist.new_group(ranks)
    if dist.get_rank() not in ranks:
        return None
    return Mesh({axis: (len(ranks), dist.get_rank(group), group)}, dev)


def make_mesh(n_devices: Optional[int] = None, axis: str = "ch",
              device=None) -> Optional[Mesh]:
    """1-D mesh over the first ``n_devices`` ranks of the job (all when
    None), each on its device (default: the card of its local index, over
    NCCL). Every rank of the job calls it; ranks past ``n_devices`` get
    None."""
    return _mesh_1d(range(n_devices or dist.get_world_size()), axis, device)


def _dim_slices(shape, mesh: Mesh, spec):
    """(dim, axis, n, i) for each dimension ``spec`` splits."""
    out = []
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n, i = mesh.axis_size(axis), mesh.axis_index(axis)
        if shape[dim] % n:
            raise ValueError(f"dimension {dim} of length {shape[dim]} does "
                             f"not split into {n} shards along {axis!r}")
        out.append((dim, axis, n, i))
    return out


def shard(x_global, mesh: Mesh, spec: Sequence[Optional[str]]):
    """This rank's slice of the global array ``x_global`` (numpy or
    tensor) as a contiguous tensor on the mesh's device. ``spec`` names
    the mesh axis that splits each leading dimension, or None (as a JAX
    ``PartitionSpec``: ``("ch",)``, ``(None, "t")``, ``("ch", "t")``;
    ``()`` replicates)."""
    x = torch.as_tensor(np.asarray(x_global) if not isinstance(
        x_global, torch.Tensor) else x_global)
    idx = [slice(None)] * x.dim()
    for dim, _, n, i in _dim_slices(x.shape, mesh, spec):
        step = x.shape[dim] // n
        idx[dim] = slice(i * step, (i + 1) * step)
    return x[tuple(idx)].to(mesh.device).contiguous()


def gather(y_local: torch.Tensor, mesh: Mesh,
           spec: Sequence[Optional[str]]) -> torch.Tensor:
    """The global array of which ``y_local`` is this rank's slice under
    ``spec`` (as :func:`shard`'s), on every rank: one ``all_gather`` over
    each splitting axis's group."""
    for dim, axis in enumerate(spec):
        if axis is not None:
            y_local = mesh.all_gather_cat(y_local, axis, dim)
    return y_local


# ---------------------------------------------------------------------- #
# Channel sharding: no collectives
# ---------------------------------------------------------------------- #
def channel_sharded_fir_fft(mesh: Mesh, taps, nbins: int, decim: int = 1):
    """FIR+FFT chain sharded over channels: this rank's [C/n, T, 2] with C
    split over the mesh's "ch" axis. Returns (run, init_history) with
    ``run(x, hist) -> (spectra, hist)`` on the rank's shard.

    decim == 1 with 1 < K <= prev_pad + 1 (prev_pad = min(128, nbins))
    runs the combined FIR*DFT step (parallel/chain.py) on K1, its stacked
    operator built once on the rank's device; else the conv FIR and the
    FFT on K2."""
    taps = np.asarray(taps)
    k = len(taps)
    n = mesh.axis_size("ch")
    dev = mesh.device
    # prev_pad <= nbins required by the combined step's previous-window
    # slice (see fir_fft_chain); longer taps use the conv fallback
    prev_pad = min(128, nbins)

    def init_history(channels: int) -> torch.Tensor:
        """This rank's zero carry [channels // n, K-1, 2] on its device
        (the JAX package's returns the global array)."""
        if channels % n:
            raise ValueError(f"{channels} channels do not split into {n}")
        return torch.zeros((channels // n, k - 1, 2), dtype=torch.float32,
                           device=dev)

    if decim == 1 and 1 < k <= prev_pad + 1:
        gr, gi = (g.to(dev) for g in stack_combined_operators(
            *combined_fir_fft_operators(taps, nbins, prev_pad)))

        def run(x, hist):
            return fir_fft_combined_step(x, hist, gr, gi, nbins, k, prev_pad)

        return run, init_history

    kernel = complex_fir_kernel(taps).to(dev)

    def run(x, hist):
        return fir_fft_step(x, hist, kernel, nbins, decim)

    return run, init_history


# ---------------------------------------------------------------------- #
# Time sharding: K-1 halos to the right neighbour
# ---------------------------------------------------------------------- #
def _halo(mesh: Mesh, x: torch.Tensor, carry: torch.Tensor, k1: int):
    """(hist, tail): the k1 samples before this rank's slice x [C, Tl, 2]
    (the left neighbour's tail along "t"; the carry at index 0) and the
    slice's own tail."""
    if x.shape[1] < k1:
        raise ValueError(f"a local slice of {x.shape[1]} samples is shorter "
                         f"than the {k1}-sample halo")
    tail = x[:, x.shape[1] - k1:]
    if k1 == 0:
        return tail, tail
    left = mesh.shift_right(tail, "t")
    return (carry if left is None else left), tail


def _carry_out(mesh: Mesh, tail: torch.Tensor) -> torch.Tensor:
    """The stream's new carry: the last rank's tail, on every rank."""
    return tail if tail.shape[1] == 0 else mesh.broadcast_from_last(tail, "t")


def time_sharded_fir(mesh: Mesh, taps, decim: int = 1):
    """FIR sharded over the time axis with the K-1 halo exchange.

    Each rank holds a contiguous [C, T/n, 2] slice along the mesh's "t"
    axis; its history is rank i-1's last K-1 samples (overlap-save), rank
    0's the stream's carry. Returns ``f(x, carry) -> (y, new_carry)``
    with ``carry`` the global stream tail [C, K-1, 2], the same on every
    rank (taken by rank 0, returned from the last rank). With decimation,
    each local slice length is a multiple of ``decim``."""
    kernel = complex_fir_kernel(np.asarray(taps)).to(mesh.device)
    k1 = kernel.shape[-1] - 1

    def run(x, carry):
        hist, tail = _halo(mesh, x, carry, k1)
        y, _ = fir_multichannel(x, hist, kernel, decim)
        return y, _carry_out(mesh, tail)

    return run


def grid_sharded_fir(mesh: Mesh, taps, decim: int = 1):
    """FIR sharded over a 2-D [ch, t] mesh (``distributed.make_2d_mesh``):
    channels split over "ch" (no collectives), time over "t" with K-1
    halos, as :func:`time_sharded_fir`. Returns ``f(x, carry) -> (y,
    new_carry)`` on this rank's [C/nch, T/nt, 2] slice; ``carry`` is the
    stream tail of the rank's channels [C/nch, K-1, 2]."""
    return time_sharded_fir(mesh, taps, decim)


def time_sharded_resampler(mesh: Mesh, taps, M: int, L: int):
    """Rational L/M polyphase resampler sharded over the time axis.

    Each rank holds [C, Tl, 2] along "t"; K-1 input halos travel to the
    right neighbour and the polyphase phase alignment holds because each
    local slice length is a multiple of M (checked: ValueError). Output
    is the rank's [C, Tl*L/M, 2] of the global resampled stream. The
    carry is the global input tail [C, K-1, 2] (taken by rank 0, returned
    from the last rank)."""
    phases, K = _polyphase_matrix(np.asarray(taps, np.complex128), L)
    taps_q = torch.from_numpy(np.stack([phases.real, phases.imag], -1)
                              .astype(np.float32)).to(mesh.device)

    def run(x, carry):
        tl = x.shape[1]
        if tl % M:
            raise ValueError(
                f"local slice length {tl} must be a multiple of M={M} "
                "for phase alignment across shards")
        hist, tail = _halo(mesh, x, carry, K - 1)
        xh = torch.cat([hist, x], dim=1)               # [C, K-1+Tl, 2]
        y = torch.stack([polyphase_fir(s, taps_q, M, L, K, "planar", 0)
                         for s in xh])
        return y, _carry_out(mesh, tail)

    return run
