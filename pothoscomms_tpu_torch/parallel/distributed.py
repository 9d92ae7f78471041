"""Multi-process runtime setup (``torch.distributed``) and mesh construction:
the port of the JAX package's ``parallel/distributed.py``.

The reference's only cross-process story is the Pothos TCP remote proxy
(SURVEY.md §2.13(4)). Here every process, one per device, calls
:func:`initialize`, then builds a mesh with :func:`make_global_mesh` or
:func:`make_2d_mesh` and runs the channel- and time-sharded chains of
:mod:`pothoscomms_tpu_torch.parallel.mesh` on its shard. NCCL carries the
halos and gathers between cards; gloo between CPU processes (the CPU
tests, ``python -m pothoscomms_tpu_torch.parallel.dryrun``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

from pothoscomms_tpu_torch.parallel.mesh import (Mesh, _mesh_1d,
                                                 _mesh_device, resolve)


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None, device=None) -> torch.device:
    """Bring up the process group (idempotent) and return this rank's
    device.

    ``env://`` by default, so torchrun's ``MASTER_ADDR``, ``RANK``,
    ``WORLD_SIZE`` and ``LOCAL_RANK`` work; pass the rest explicitly for a
    manual launch:

        initialize("file:///tmp/store", world_size=4, rank=r, device="cpu")

    The rank's device is the card of its local index (``LOCAL_RANK``,
    else ``rank``) unless the caller names one; NCCL there, after
    ``torch.cuda.set_device``, and gloo for ``device="cpu"``. A failed
    init raises.
    """
    dev, backend = resolve(device, rank)
    if dist.is_initialized():
        return dev
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=init_method or "env://",
        world_size=-1 if world_size is None else world_size,
        rank=-1 if rank is None else rank)
    return dev


def make_global_mesh(axis: str = "ch", devices: Optional[Sequence[int]] = None,
                     device=None) -> Optional[Mesh]:
    """1-D mesh over every rank of the job, or over the ranks ``devices``
    (one device a rank; indices in ascending rank order, and a rank
    outside them gets None), each on its device (default: the card)."""
    ranks = range(dist.get_world_size()) if devices is None else devices
    return _mesh_1d(ranks, axis, device)


def make_2d_mesh(ch: int, t: int, device=None) -> Mesh:
    """[channel, time] mesh over every rank, rank r at (r // t, r % t): the
    "t" rings are runs of consecutive ranks, so on a multi-card host the
    halos of time sharding stay between neighbouring cards."""
    dev = _mesh_device(device)
    world = dist.get_world_size()
    if world != ch * t:
        raise ValueError(f"need {ch * t} devices, have {world}")
    # every rank creates every group, in the same order
    t_groups = [dist.new_group([i * t + j for j in range(t)])
                for i in range(ch)]
    ch_groups = [dist.new_group([i * t + j for i in range(ch)])
                 for j in range(t)]
    i, j = divmod(dist.get_rank(), t)
    return Mesh({"ch": (ch, i, ch_groups[j]), "t": (t, j, t_groups[i])}, dev)


def scaling_efficiency(samples_per_s: dict) -> dict:
    """Given {n_devices: samples_per_s}, efficiency vs linear scaling
    from the smallest configuration (the BASELINE.md >=80% criterion)."""
    base_n = min(samples_per_s)
    base = samples_per_s[base_n] / base_n
    return {
        n: round(v / (n * base), 4) for n, v in samples_per_s.items()
    }
