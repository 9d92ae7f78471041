"""The port's scale-out layer (parallel/mesh.py, distributed.py, dryrun.py,
compiler.compile_chain_sharded, link.make_sharded_search and
run_sharded_link) on gloo ranks, against the JAX package's meshes.

One job a world size (2 and 4 ranks, each a process launched through
``python -m pothoscomms_tpu_torch.parallel.dryrun`` on a ``file://`` store
under the test's temporary directory, each with its own timeout) runs
every case of tests/torch_mesh_ranks.py and returns the gathered global
outputs; the JAX functions run here on the first n devices of the
8-device CPU mesh (tests/conftest.py), on the same float32 inputs.

Tolerances: spectra within 1e-4 of max |spectrum| (the chain's contract,
tests/test_tpu_lane.py:181-198); the time-sharded FIR, the 2-D mesh and
the resampler within 1e-4 absolute (tests/test_parallel.py's); carries
exactly the last K-1 inputs; the FM chain within 1e-6 of the port's own
compile_chain (the same float32 ops on fewer channels) and within the FM
contract's 2e-3 of JAX; the sharded search equal to the port's one-rank
search bit for bit, and within the float64 oracle's bounds of
tests/test_torch_framing.py; the link's result dict equal to JAX's.
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from pothoscomms_tpu.parallel import distributed as jdist
from pothoscomms_tpu.parallel import link as jlink
from pothoscomms_tpu.parallel import mesh as jmesh
from pothoscomms_tpu.parallel.compiler import \
    compile_chain_sharded as j_compile_chain_sharded
from pothoscomms_tpu_torch.core.testing import (search_agreement,
                                                sync_search_f64)
from pothoscomms_tpu_torch.parallel import distributed, link, mesh
from pothoscomms_tpu_torch.parallel.chain import fir_fft_chain, fir_fft_form
from pothoscomms_tpu_torch.parallel.compiler import compile_chain
from tests.test_torch_framing import TOL_JAX, assert_tolerances
from tests.torch_mesh_ranks import (CH_CASES, DECIMS, LINK_CASES,
                                    RESAMPLER_ML, fm_blocks, grids, inputs,
                                    search_batch)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
WORLDS = (2, 4)
RANK_TIMEOUT_S = 240


@pytest.fixture(scope="module", params=WORLDS)
def job(request, tmp_path_factory):
    """Launch one n-rank gloo job of every case; (n, per-rank results)."""
    n = request.param
    out = tmp_path_factory.mktemp(f"mesh{n}")
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": str(REPO) + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "pothoscomms_tpu_torch.parallel.dryrun",
         "--world", str(n), "--rank", str(r), "--store",
         str(out / "store"), "--scenario", "tests.torch_mesh_ranks:run",
         "--out", str(out), "--device", "cpu"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(n)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"{n} ranks timed out:\n" + "\n".join(logs))
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log}"
    results = []
    for r in range(n):
        with open(out / f"rank{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return n, results


def _jmesh(n, axis):
    return JMesh(np.asarray(jax.devices()[:n]), (axis,))


def _rel(got, ref):
    return np.max(np.abs(got - ref)) / np.max(np.abs(ref))


def _jsteps(run, xs, carry):
    ys = []
    for x in xs:
        y, carry = run(jnp.asarray(x), jnp.asarray(carry))
        ys.append(np.asarray(y))
    return ys, np.asarray(carry)


@pytest.mark.parametrize("case,taps_key,nbins,decim,x_key", CH_CASES)
def test_channel_sharded_fir_fft_matches_jax(job, case, taps_key, nbins,
                                             decim, x_key):
    """Each form, two steps: the one-pass step (K3) at 1024 bins, the
    combined step (K1), the polyphase FIR (K4) by decimation and the conv
    FIR by K > prev_pad + 1, each followed by the FFT (K2), each the form
    fir_fft_form picks; no collective on the way."""
    n, results = job
    d = inputs(n)
    taps, xs = d[taps_key], d[x_key]
    run, init = jmesh.channel_sharded_fir_fft(_jmesh(n, "ch"), taps, nbins,
                                              decim)
    jys, _ = _jsteps(run, xs, init(2 * n))
    ys, carry, counts = results[0][f"ch_{case}"]
    form = "conv" if case.startswith("conv") else case
    assert form == fir_fft_form(len(taps), nbins, decim, decim * nbins)
    assert all(r[f"ch_{case}_form"] == form for r in results)
    for y, jy in zip(ys, jys):
        assert y.shape == jy.shape
        assert _rel(y, jy) < 1e-4
    k1, t = len(taps) - 1, xs.shape[2]
    np.testing.assert_array_equal(carry, xs[1][:, t - k1:])
    assert all(r[f"ch_{case}"][2] == (0, 0) for r in results)


@pytest.mark.parametrize("decim", DECIMS)
def test_time_sharded_fir_matches_jax(job, decim):
    """Three channels and K = 7: each rank's tail x[:, -(K-1):] is a
    strided view of its slice, which gloo refuses to send; the halos
    come through exact. One send and one receive a boundary a step, one
    broadcast a rank a step."""
    n, results = job
    d = inputs(n)
    tl = d["t_x"].shape[2] // n
    assert not torch.from_numpy(d["t_x"][0])[:, tl - 6:tl].is_contiguous()
    run = jmesh.time_sharded_fir(_jmesh(n, "t"), d["t_taps"], decim)
    jys, _ = _jsteps(run, d["t_x"], d["t_carry"])
    ys, carry, _ = results[0][f"t_fir_{decim}"]
    for y, jy in zip(ys, jys):
        assert y.shape == jy.shape == (3, 64 * n // decim, 2)
        np.testing.assert_allclose(y, jy, atol=1e-4)
    for r in results:
        np.testing.assert_array_equal(r[f"t_fir_{decim}"][1],
                                      d["t_x"][1][:, -6:])
    assert sum(r[f"t_fir_{decim}"][2][0] for r in results) \
        == 2 * (n - 1) * 2
    assert all(r[f"t_fir_{decim}"][2][1] == 2 for r in results)


def test_grid_sharded_fir_matches_jax(job):
    """Every 2-D mesh at the world size (2x1 and 1x2 at 2 ranks, 2x2 at
    4): a "t" axis of one rank sends nothing."""
    n, results = job
    d = inputs(n)
    for nch, nt in grids(n):
        jm = JMesh(np.asarray(jax.devices()[:n]).reshape(nch, nt),
                   ("ch", "t"))
        run = jmesh.grid_sharded_fir(jm, d["t_taps"])
        jy, _ = run(jnp.asarray(d["g_x"]), jnp.asarray(d["g_carry"]))
        (y,), carry, _ = results[0][f"grid_{nch}x{nt}"]
        np.testing.assert_allclose(y, np.asarray(jy), atol=1e-4)
        np.testing.assert_array_equal(carry, d["g_x"][:, -6:])
        p2p = sum(r[f"grid_{nch}x{nt}"][2][0] for r in results)
        assert p2p == 2 * nch * (nt - 1)


@pytest.mark.parametrize("ml", RESAMPLER_ML)
def test_time_sharded_resampler_matches_jax(job, ml):
    m, l = ml
    n, results = job
    d = inputs(n)
    k = -(-len(d["r_taps"]) // l)
    carry0 = d["r_carry"][:, :k - 1]
    run = jmesh.time_sharded_resampler(_jmesh(n, "t"), d["r_taps"], m, l)
    jys, _ = _jsteps(run, d["r_x"], carry0)
    ys, carry, _ = results[0][f"resampler_{m}_{l}"]
    for y, jy in zip(ys, jys):
        assert y.shape == jy.shape == (2, 24 * n * l // m, 2)
        np.testing.assert_allclose(y, jy, atol=1e-4)
    np.testing.assert_array_equal(carry, d["r_x"][1][:, -(k - 1):])


def test_time_sharded_resampler_rejects_unaligned_slices(job):
    """A local length that is not a multiple of M raises ValueError on
    every rank before any send, as JAX's runner raises for its global
    array."""
    n, results = job
    for r in results:
        assert "must be a multiple of M=2" in r["resampler_bad_length"]
    run = jmesh.time_sharded_resampler(_jmesh(n, "t"), inputs(n)["r_taps"],
                                       2, 3)
    with pytest.raises(ValueError, match="multiple of M=2"):
        run(jnp.zeros((2, 25 * n, 2), jnp.float32),
            jnp.zeros((2, 3, 2), jnp.float32))


def test_compile_chain_sharded_fm(job):
    """The FM chain, two steps: the port's own compile_chain on all
    channels within 1e-6, JAX's sharded chain within the FM contract."""
    n, results = job
    d = inputs(n)
    C = 2 * n
    step, carry = compile_chain(fm_blocks(), C, device="cpu")
    jm = _jmesh(n, "ch")
    jstep, jcarry = j_compile_chain_sharded(_j_fm_blocks(), C, jm)
    ys = results[0]["fm"]
    for x, y in zip(d["fm_x"], ys):
        ref, carry = step(torch.from_numpy(x), carry)
        with jm:
            jy, jcarry = jstep(jnp.asarray(x), jcarry)
        assert y.shape == (C, 2048)
        np.testing.assert_allclose(y, ref.numpy(), atol=1e-6)
        np.testing.assert_allclose(y, np.asarray(jy), atol=2e-3)


def _j_fm_blocks():
    from pothoscomms_tpu.core.registry import BlockRegistry

    demod = BlockRegistry.make("/comms/freq_demod", "complex_float32")
    dc = BlockRegistry.make("/comms/dc_removal", "float32")
    dc.set_average_size(16)
    dc.set_cascade_size(2)
    env = BlockRegistry.make("/comms/envelope_detector", "float32")
    env.set_attack(10.0)
    env.set_release(40.0)
    return [demod, dc, env]


def test_sharded_search_equals_one_rank(job):
    """make_sharded_search over the ranks equals the port's one-device
    search bit for bit; both that and JAX's sharded search within the
    float64 oracle's bounds."""
    n, results = job
    x, length = search_batch()
    search, lp, n_pad = link.make_channel_search([1.0], 20, 4, 0.01, length,
                                                 device="cpu")
    one = [a.numpy() for a in search(torch.from_numpy(x))]
    for got, ref in zip(results[0]["search"], one):
        np.testing.assert_array_equal(got, ref)
    jsearch, jlp, jn = jlink.make_sharded_search(_jmesh(n, "ch"), [1.0], 20,
                                                 4, 0.01, length)
    assert (jlp, jn) == (lp, n_pad)
    jgot = [np.asarray(a) for a in jsearch(jnp.asarray(x))]
    oracle = sync_search_f64(x, [1.0], 0.01, 80, 80, 4, 1, n_pad)
    assert_tolerances(search_agreement(results[0]["search"], oracle))
    assert_tolerances(search_agreement(jgot, oracle, peak_floor=56),
                      TOL_JAX, peaks=False)


@pytest.mark.parametrize("channels,bits,seed,noise", LINK_CASES)
def test_run_sharded_link_matches_jax(job, channels, bits, seed, noise):
    """Every channel exact at noise 0 and 0.02, and every rank's result
    dict equal to JAX's on a mesh of as many devices."""
    n, results = job
    ref = jlink.run_sharded_link(_jmesh(n, "ch"), channels, n_bits=bits,
                                 seed=seed, noise=noise)
    for r in results:
        got = r[f"link_{channels}_{noise}"]
        assert got == ref
        assert got["all_exact"] and got["devices"] == n


def test_initialize_and_global_mesh(job):
    """As tests/test_distributed.py: initialize (again: idempotent), a
    global mesh over every rank, each rank's shard of the channel-sharded
    chain against the same chain on all channels of one device; meshes
    over a subset of the ranks (the first, the last) leave the others
    None."""
    n, results = job
    d = inputs(n)
    C = 2 * n
    run, hist = fir_fft_chain(d["ch_taps"], 128, C, 512, device="cpu")
    ref, _ = run(torch.from_numpy(d["ch_x"][0]), hist)
    for rank, r in enumerate(results):
        g = r["global_mesh"]
        assert (g["device"], g["size"], g["index"]) == ("cpu", n, rank)
        np.testing.assert_allclose(g["shard"], ref[2 * rank:2 * rank + 2],
                                   atol=1e-4)
        assert r["mesh_of_one"] == (1 if rank == 0 else None)
        assert r["global_of_last"] == ((1, 0) if rank == n - 1 else None)


def test_dryrun_multichip(job):
    """The four steps of __graft_entry__.dryrun_multichip on every rank,
    each checked against one device where it computes."""
    n, results = job
    for r in results:
        dr = r["dryrun"]
        assert dr["channel_fir_fft"][0] == (2 * n, 4, 128, 2)
        assert dr["channel_fir_fft"][1] < 1e-4
        assert dr["time_fir"] == ((4, 128 * n, 2), dr["time_fir"][1])
        assert dr["time_fir"][1] <= 1e-4
        assert dr["fm_chain"] == ((2 * n, 512),)
        assert dr["grid_fir"][0] == (4, 64 * n, 2)
        assert dr["grid_fir"][1] <= 1e-4


def test_every_rank_gathers_the_same_result(job):
    n, results = job
    for r in results[1:]:
        for key in ("ch_combined", "t_fir_1", "resampler_2_3"):
            for a, b in zip(r[key][0], results[0][key][0]):
                np.testing.assert_array_equal(a, b)
        for a, b in zip(r["fm"], results[0]["fm"]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("rates", [{1: 100.0, 2: 190.0, 4: 350.0},
                                   {2: 3.0e9, 8: 1.1e10, 4: 5.9e9},
                                   {1: 7.0}])
def test_scaling_efficiency_equals_jax(rates):
    assert distributed.scaling_efficiency(rates) \
        == jdist.scaling_efficiency(rates)


def test_make_mesh_defaults_to_the_card_and_nccl(monkeypatch):
    """With no device, a mesh resolves to the card of the rank's local
    index over NCCL, read from the resolver without initializing; the CPU
    only where the caller names it, over gloo."""
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    assert mesh.resolve() == (torch.device("cuda", 0), "nccl")
    assert mesh.resolve(rank=2) == (torch.device("cuda", 2), "nccl")
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert mesh.resolve(rank=5) == (torch.device("cuda", 3), "nccl")
    assert mesh.resolve("cpu") == (torch.device("cpu"), "gloo")
    assert not torch.distributed.is_initialized()


def test_mesh_needs_a_process_group():
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="initialize"):
        mesh.make_mesh(1, device="cpu")
    with pytest.raises(RuntimeError, match="initialize"):
        distributed.make_2d_mesh(1, 1, device="cpu")
