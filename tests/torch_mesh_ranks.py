"""The body of one gloo rank for tests/test_torch_mesh.py (no JAX here).

Each rank of an n-rank job runs :func:`run` through

    python -m pothoscomms_tpu_torch.parallel.dryrun --world n --rank r \\
        --store PATH --scenario tests.torch_mesh_ranks:run --out DIR \\
        --device cpu

It cuts its shard of the global inputs of :func:`inputs` (the same numpy
seed on every rank and in the test), runs every sharded function of the
port on it, and returns the gathered global outputs with the collectives
each case issued; the test holds them against the JAX package.
"""

import numpy as np
import torch
import torch.distributed as dist

from pothoscomms_tpu_torch.core.registry import BlockRegistry
from pothoscomms_tpu_torch.parallel import distributed, link
from pothoscomms_tpu_torch.parallel.compiler import compile_chain_sharded
from pothoscomms_tpu_torch.parallel.dryrun import dryrun_multichip
from pothoscomms_tpu_torch.parallel.mesh import (
    channel_sharded_fir_fft, gather, grid_sharded_fir, make_mesh, shard,
    time_sharded_fir, time_sharded_resampler)

DECIMS = (1, 2, 4)
RESAMPLER_ML = ((2, 3), (3, 2), (1, 4))
# the link cases of tests/test_link.py: (channels, bits, seed, noise)
LINK_CASES = ((16, 64, 7, 0.0), (8, 64, 11, 0.02))
SEARCH_CHANNELS = 8


def _ctaps(rng, k):
    return ((rng.normal(size=k) + 1j * rng.normal(size=k)) / k).astype(
        np.complex64)


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def grids(n):
    """The 2-D meshes (ch, t) tried at world size n."""
    return [(2, 1), (1, 2)] if n == 2 else [(2, n // 2)]


def inputs(n):
    """Every case's global float32 inputs at world size n, from one seed."""
    rng = np.random.default_rng(1200 + n)
    C = 2 * n
    phase = np.cumsum(rng.uniform(-0.5, 0.5, size=(C, 2048)), axis=1)
    fm = np.stack([np.cos(phase), np.sin(phase)], -1).astype(np.float32)
    return {
        # channel sharding: the combined step (K=9), the conv branch by
        # decimation and by length (K=140 > prev_pad + 1)
        "ch_taps": _ctaps(rng, 9), "ch_long_taps": _ctaps(rng, 140),
        "ch_x": _f32(rng, 2, C, 512, 2),
        # time sharding with C > 1 and K > 2: each rank's tail
        # x[:, -(K-1):] is a strided view of its slice
        "t_taps": _ctaps(rng, 7), "t_x": _f32(rng, 2, 3, 64 * n, 2),
        "t_carry": _f32(rng, 3, 6, 2),
        "g_x": _f32(rng, 4, 64 * n, 2), "g_carry": _f32(rng, 4, 6, 2),
        "r_taps": _ctaps(rng, 12), "r_x": _f32(rng, 2, 2, 24 * n, 2),
        "r_carry": _f32(rng, 2, 5, 2),
        "fm_x": np.stack([fm, 0.5 * fm]),
    }


def search_batch():
    """[SEARCH_CHANNELS, lp, 2] search input (tests/test_link.py's): one
    frame, scaled per channel, and the search's lp."""
    rng = np.random.default_rng(5)
    bits = rng.integers(0, 2, 32).astype(np.uint8)
    wave = link.apply_channel(link.tx_waveform(bits, device="cpu"),
                              attenuation=0.6, phase=0.4, freq_offset=5e-5)
    _, lp, _ = link.make_channel_search([1.0], 20, 4, 0.01, len(wave),
                                        device="cpu")
    x = np.zeros((SEARCH_CHANNELS, lp, 2), np.float32)
    for c in range(SEARCH_CHANNELS):
        w = wave * np.float32(0.8 + 0.05 * c)
        x[c, : len(wave), 0], x[c, : len(wave), 1] = w.real, w.imag
    return x, len(wave)


def fm_blocks():
    """The FM chain of tests/test_compiler.py's sharded case."""
    demod = BlockRegistry.make("/comms/freq_demod", "complex_float32")
    dc = BlockRegistry.make("/comms/dc_removal", "float32")
    dc.set_average_size(16)
    dc.set_cascade_size(2)
    env = BlockRegistry.make("/comms/envelope_detector", "float32")
    env.set_attack(10.0)
    env.set_release(40.0)
    return [demod, dc, env]


def _np(t):
    return t.cpu().numpy()


def _steps(run, mesh, xs, carry, spec, carry_spec):
    """Two chained steps of a sharded ``run`` on the global inputs xs;
    the gathered outputs of both and the final gathered carry, with the
    collectives and sends the mesh counted."""
    mesh.p2p_ops = mesh.collectives = 0
    ys = []
    for x in xs:
        y, carry = run(shard(x, mesh, spec), carry)
        ys.append(y)
    counts = (mesh.p2p_ops, mesh.collectives)
    ys = [_np(gather(y, mesh, spec)) for y in ys]
    return ys, _np(gather(carry, mesh, carry_spec)), counts


def run(device):
    n, rank = dist.get_world_size(), dist.get_rank()
    d = inputs(n)
    res = {"world": n, "rank": rank}
    ch = make_mesh(n, "ch", device=device)
    tm = make_mesh(n, "t", device=device)

    # channel-sharded FIR+FFT, both branches
    for name, taps, nbins, decim in (("combined", d["ch_taps"], 128, 1),
                                     ("conv_decim", d["ch_taps"], 64, 2),
                                     ("conv_long", d["ch_long_taps"], 128, 1)):
        fn, init = channel_sharded_fir_fft(ch, taps, nbins, decim)
        res[f"ch_{name}"] = _steps(fn, ch, d["ch_x"], init(2 * n), ("ch",),
                                   ("ch",))

    # time-sharded FIR, carry replicated
    for decim in DECIMS:
        fn = time_sharded_fir(tm, d["t_taps"], decim)
        carry = torch.from_numpy(d["t_carry"])
        res[f"t_fir_{decim}"] = _steps(fn, tm, d["t_x"], carry, (None, "t"),
                                       ())

    # the 2-D mesh: channels over "ch", halos along "t"
    for nch, nt in grids(n):
        g = distributed.make_2d_mesh(nch, nt, device=device)
        fn = grid_sharded_fir(g, d["t_taps"])
        res[f"grid_{nch}x{nt}"] = _steps(
            fn, g, [d["g_x"]], shard(d["g_carry"], g, ("ch",)), ("ch", "t"),
            ("ch",))

    # the time-sharded resampler, and its check of the local length
    for m, l in RESAMPLER_ML:
        fn = time_sharded_resampler(tm, d["r_taps"], m, l)
        k = -(-len(d["r_taps"]) // l)  # the polyphase K
        carry = torch.from_numpy(d["r_carry"][:, :k - 1].copy())
        res[f"resampler_{m}_{l}"] = _steps(fn, tm, d["r_x"], carry,
                                           (None, "t"), ())
    fn = time_sharded_resampler(tm, d["r_taps"], 2, 3)
    try:
        fn(torch.zeros(2, 25, 2), torch.zeros(2, 3, 2))  # 25 % M != 0
        res["resampler_bad_length"] = None
    except ValueError as exc:
        res["resampler_bad_length"] = str(exc)

    # the FM chain, channel-sharded, two steps with the carry
    step, carry = compile_chain_sharded(fm_blocks(), 2 * n, ch)
    ys = []
    for x in d["fm_x"]:
        y, carry = step(shard(x, ch, ("ch",)), carry)
        ys.append(_np(gather(y, ch, ("ch",))))
    res["fm"] = ys

    # the channel-sharded search and the link
    xs, length = search_batch()
    search, lp, n_pad = link.make_sharded_search(ch, [1.0], 20, 4, 0.01,
                                                 length)
    res["search"] = [_np(gather(a, ch, ("ch",)))
                     for a in search(shard(xs, ch, ("ch",)))]
    for c, bits, seed, noise in LINK_CASES:
        out = link.run_sharded_link(ch, c, n_bits=bits, seed=seed,
                                    noise=noise)
        res[f"link_{c}_{noise}"] = {k: out[k] for k in
                                    ("channels", "bit_exact", "all_exact",
                                     "devices")}

    # initialize again (idempotent), then the global mesh, as
    # tests/distributed_worker.py runs it: each rank's shard of the
    # channel-sharded chain, which the test holds against the same chain
    # on all channels of one device
    again = distributed.initialize(device=device)
    gm = distributed.make_global_mesh("ch", device=device)
    fn, init = channel_sharded_fir_fft(gm, d["ch_taps"], 128)
    spec, _ = fn(shard(d["ch_x"][0], gm, ("ch",)), init(2 * n))
    res["global_mesh"] = {"device": str(again), "size": gm.size,
                          "index": gm.axis_index("ch"), "shard": _np(spec)}
    # a mesh of the first rank: every rank builds its group, the others
    # get None
    one = make_mesh(1, "ch", device=device)
    res["mesh_of_one"] = None if one is None else one.size
    last = distributed.make_global_mesh("ch", devices=[n - 1], device=device)
    res["global_of_last"] = None if last is None else (
        last.size, last.axis_index("ch"))

    # the four steps of the dry run over the whole job
    res["dryrun"] = dryrun_multichip(n, device)
    return res
