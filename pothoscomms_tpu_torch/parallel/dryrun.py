"""Entry points of the scale-out layer, the port of the JAX package's
``__graft_entry__.py``, and a launcher for one rank of a job.

- :func:`entry`: a forward step of the flagship pipeline (the FIR+FFT
  chain, ``parallel/chain.FirFftChain``) with example arguments.
- :func:`dryrun_multichip`: on every rank of an n-rank job, one full
  sharded step at small shapes: channel-parallel FIR+FFT, time-parallel
  FIR with K-1 halos (checked against one device), the channel-sharded FM
  chain, and the 2-D [ch, t] mesh when n is even.

One rank of a job, its process group on a ``file://`` store:

    python -m pothoscomms_tpu_torch.parallel.dryrun --world N --rank r \\
        --store PATH --scenario NAME --out DIR [--device cpu]

``--scenario dryrun`` runs :func:`dryrun_multichip` over the whole job;
``--scenario module:function`` imports ``function`` and calls it as
``function(device)``. Either result is pickled to ``DIR/rank<r>.pkl``. The
rank's device is the card of its index (NCCL) unless ``--device`` names
one (``cpu``: gloo).
"""

from __future__ import annotations

import argparse
import importlib
import pickle
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from pothoscomms_tpu_torch.parallel import distributed
from pothoscomms_tpu_torch.parallel.chain import (FirFftChain,
                                                  complex_fir_kernel,
                                                  fir_multichannel)
from pothoscomms_tpu_torch.parallel.compiler import compile_chain_sharded
from pothoscomms_tpu_torch.parallel.mesh import (channel_sharded_fir_fft,
                                                 gather, grid_sharded_fir,
                                                 make_mesh, shard,
                                                 time_sharded_fir)


def entry(device=None):
    """(fn, args): the FIR+FFT chain's step (a ``FirFftChain``, in the form
    ``fir_fft_form`` picks: ``combined`` at these shapes) and example
    arguments on ``device`` (default: the card), C=8, T=2048, K=16,
    NBINS=256; ``fn(*args) -> (spectra, carry)``."""
    from pothoscomms_tpu_torch.core import placement

    dev = placement.resolve(device)
    C, T, K, NBINS = 8, 2048, 16, 256
    rng = np.random.default_rng(0)
    taps = (rng.normal(size=K) + 1j * rng.normal(size=K)) / K
    fn = FirFftChain(taps, NBINS, T, 1, dev)
    x = torch.from_numpy(rng.normal(size=(C, T, 2)).astype(np.float32)).to(dev)
    hist = torch.zeros((C, K - 1, 2), dtype=torch.float32, device=dev)
    return fn, (x, hist)


def _fm_blocks():
    from pothoscomms_tpu_torch.core.registry import BlockRegistry

    demod = BlockRegistry.make("/comms/freq_demod", "complex_float32")
    dc = BlockRegistry.make("/comms/dc_removal", "float32")
    dc.set_average_size(8)
    dc.set_cascade_size(2)
    env = BlockRegistry.make("/comms/envelope_detector", "float32")
    return [demod, dc, env]


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """One sharded processing step on each rank of an ``n_devices``-rank
    job (every rank calls it; the process group is up, ``distributed.
    initialize``), each on its device (default: the card). Every rank
    makes the same global inputs from one seed and cuts its shard.
    Returns the global shapes and the largest error against one device
    of each step; raises where a check fails."""
    world = dist.get_world_size()
    if world < n_devices:
        raise ValueError(f"need {n_devices} ranks, have {world}")
    rng = np.random.default_rng(1)
    K = 9
    taps = (rng.normal(size=K) + 1j * rng.normal(size=K)) / K
    kern = complex_fir_kernel(taps)
    out = {}

    # 1) channel-parallel: C split over the mesh, no collectives
    mesh = make_mesh(n_devices, axis="ch", device=device)
    mesh_t = make_mesh(n_devices, axis="t", device=device)
    if mesh is None:  # a rank past n_devices: took part in the groups only
        return out
    C, T, NBINS = 2 * n_devices, 512, 128
    run, init_hist = channel_sharded_fir_fft(mesh, taps, NBINS)
    x = rng.normal(size=(C, T, 2)).astype(np.float32)
    spec, _ = run(shard(x, mesh, ("ch",)), init_hist(C))
    spec = gather(spec, mesh, ("ch",)).cpu()
    if spec.shape != (C, T // NBINS, NBINS, 2):
        raise AssertionError(f"channel-parallel spectra {spec.shape}")
    y0, _ = fir_multichannel(torch.from_numpy(x), torch.zeros(C, K - 1, 2),
                             kern)
    ref = torch.fft.fft(torch.view_as_complex(y0.contiguous()).reshape(
        C, T // NBINS, NBINS))
    out["channel_fir_fft"] = (tuple(spec.shape), (
        torch.view_as_complex(spec.contiguous()) - ref).abs().max().item()
        / ref.abs().max().item())
    if out["channel_fir_fft"][1] > 1e-4:
        raise AssertionError(f"channel-parallel FIR+FFT: "
                             f"{out['channel_fir_fft']}")

    # 2) time-parallel: T split over the mesh, K-1 halos to the right
    Ct, Tt = 4, 128 * n_devices
    run_t = time_sharded_fir(mesh_t, taps)
    xt = rng.normal(size=(Ct, Tt, 2)).astype(np.float32)
    carry = torch.zeros((Ct, K - 1, 2), dtype=torch.float32,
                        device=mesh_t.device)
    y, carry2 = run_t(shard(xt, mesh_t, (None, "t")), carry)
    y = gather(y, mesh_t, (None, "t")).cpu()
    y_ref, tail_ref = fir_multichannel(torch.from_numpy(xt),
                                       torch.zeros(Ct, K - 1, 2), kern)
    out["time_fir"] = (tuple(y.shape), (y - y_ref).abs().max().item())
    if out["time_fir"][1] > 1e-4 or not torch.equal(carry2.cpu(), tail_ref):
        raise AssertionError(f"time-parallel FIR: {out['time_fir']}")

    # 3) channel-sharded FM chain through the product chain compiler
    step_fm, carry_fm = compile_chain_sharded(_fm_blocks(), C, mesh)
    x_fm = shard(x, mesh, ("ch",))
    y_fm, _ = step_fm(x_fm, carry_fm)
    y_fm = gather(y_fm, mesh, ("ch",))
    if y_fm.shape != (C, T):
        raise AssertionError(f"FM chain {tuple(y_fm.shape)}")
    out["fm_chain"] = (tuple(y_fm.shape),)

    # 4) 2-D [ch, t] sharding: channel-parallel and time-parallel with
    # halos, when the rank count factors
    if n_devices % 2 == 0 and n_devices == world:
        nch, nt = 2, n_devices // 2
        mesh2 = distributed.make_2d_mesh(nch, nt, device=device)
        C2, T2 = 2 * nch, 128 * nt
        run2 = grid_sharded_fir(mesh2, taps)
        x2 = rng.normal(size=(C2, T2, 2)).astype(np.float32)
        c2 = shard(np.zeros((C2, K - 1, 2), np.float32), mesh2, ("ch",))
        y2, _ = run2(shard(x2, mesh2, ("ch", "t")), c2)
        y2 = gather(y2, mesh2, ("ch", "t")).cpu()
        y2_ref, _ = fir_multichannel(torch.from_numpy(x2),
                                     torch.zeros(C2, K - 1, 2), kern)
        out["grid_fir"] = (tuple(y2.shape), (y2 - y2_ref).abs().max().item())
        if out["grid_fir"][1] > 1e-4:
            raise AssertionError(f"2-D mesh FIR: {out['grid_fir']}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m pothoscomms_tpu_torch.parallel.dryrun",
        description="Run one rank of a sharded job.")
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--store", required=True,
                    help="path of the file:// rendezvous store")
    ap.add_argument("--scenario", default="dryrun",
                    help="'dryrun' or module:function")
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default=None,
                    help="this rank's device (default: its card)")
    args = ap.parse_args(argv)

    torch.set_num_threads(1)
    device = distributed.initialize(f"file://{Path(args.store).resolve()}",
                                    world_size=args.world, rank=args.rank,
                                    device=args.device)
    try:
        if args.scenario == "dryrun":
            result = dryrun_multichip(args.world, device)
        else:
            module, _, name = args.scenario.partition(":")
            result = getattr(importlib.import_module(module), name)(device)
        with open(Path(args.out) / f"rank{args.rank}.pkl", "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()
    print(f"RANK {args.rank} OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
