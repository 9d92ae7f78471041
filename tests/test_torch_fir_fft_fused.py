"""Parity of the port's one-pass FIR+FFT (K3,
pothoscomms_tpu_torch.kernels.fir_fft_fused) with the JAX package's
``fir_fft_fused_pallas`` / ``make_fused_pallas_chain`` (interpret mode,
as the JAX package runs Pallas kernels on the CPU), and of the long-row
FFT split with numpy and the JAX ``fft_planar``.

Inputs are float32 from numpy.random.default_rng(seed). Tolerances: the
step at 2e-5 of max |spectrum| (float32 FFT and 64-term sums in another
order); chains at 1e-4 of max |spectrum| (the JAX chain contract,
tests/test_tpu_lane.py) against the JAX chain, the float64
convolve-then-FFT oracle and the port's combined step; carries exact;
constants bit for bit; the split FFT at 2e-5 as the JAX FFT tests.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pothoscomms_tpu.parallel import pallas_kernels as jpk
from pothoscomms_tpu.parallel.fft import fft_planar as jfft_planar
from pothoscomms_tpu_torch.kernels import fir_fft_fused as ff
from pothoscomms_tpu_torch.parallel import chain
from pothoscomms_tpu_torch.parallel.fft import fft_split

torch.set_num_threads(1)


def _rel_err(got, exp):
    got, exp = np.asarray(got), np.asarray(exp)
    return np.max(np.abs(got - exp)) / np.max(np.abs(exp))


def _taps(rng, k):
    return (rng.normal(size=k) + 1j * rng.normal(size=k)) / k


def _x(rng, *shape):
    return rng.normal(size=(*shape, 2)).astype(np.float32)


def _jax_consts(taps, nbins=1024, pp=64):
    return jpk._fused_chain_consts(tuple(np.asarray(taps).tolist()), nbins,
                                   pp)


@pytest.mark.parametrize("with_corr", [True, False])
def test_step_matches_jax_pallas_kernel(with_corr):
    rng = np.random.default_rng(40)
    B, N, PP = 16, 1024, 64
    x, uw = _x(rng, B, N), _x(rng, B, PP)
    consts = _jax_consts(_taps(rng, 64))
    flat = [jnp.asarray(a) for pair in consts for a in pair]
    yr, yi = jpk.fir_fft_fused_pallas(
        jnp.asarray(x[..., 0]), jnp.asarray(x[..., 1]),
        jnp.asarray(uw[..., 0]), jnp.asarray(uw[..., 1]), *flat,
        u=8, v=128, pp=PP, tile_b=16, chunk=16, with_corr=with_corr,
        interpret=True)
    exp = np.stack([np.asarray(yr).reshape(B, N),
                    np.asarray(yi).reshape(B, N)], -1)
    H, (gcr, gci) = ff.fused_consts_from_numpy(consts, device="cpu")
    got = ff.fir_fft_fused(torch.from_numpy(x),
                           torch.from_numpy(uw) if with_corr else None,
                           H, gcr, gci)
    assert got.shape == (B, N, 2)
    assert _rel_err(got, exp) < 2e-5


@pytest.mark.parametrize("k", [2, 17, 64, 65])
def test_consts_from_numpy_equal_fused_chain_consts(k):
    taps = _taps(np.random.default_rng(41), k)
    H, (gcr, gci) = ff.fused_consts_from_numpy(_jax_consts(taps),
                                               device="cpu")
    H2, (gcr2, gci2) = ff.fused_chain_consts(taps, 1024, 64)
    assert H.dtype == gcr.dtype == torch.float32
    assert H.shape == (1024, 2) and gcr.shape == gci.shape == (64, 1024)
    for a, b in ((H, H2), (gcr, gcr2), (gci, gci2)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def _oracle(x_steps, taps, nb):
    """float64 numpy convolve-then-FFT over the concatenated steps."""
    xs = np.concatenate(x_steps, axis=1)
    xc = xs[..., 0].astype(np.float64) + 1j * xs[..., 1]
    c, t = xc.shape
    y = np.stack([np.convolve(xc[i], taps)[:t] for i in range(c)])
    return np.fft.fft(y.reshape(c, -1, nb), axis=-1)


@pytest.mark.parametrize("k", [2, 17, 64, 65])
def test_chain_matches_jax_pallas_chain_oracle_and_combined_step(k):
    rng = np.random.default_rng(42 + k)
    C, T, NB = 2, 8192, 1024
    taps = _taps(rng, k)
    run = ff.make_fused_chain(taps, NB, device="cpu")
    assert isinstance(run, torch.nn.Module)
    assert {n for n, _ in run.named_buffers()} == {"H", "gcr", "gci"}
    jrun = jpk.make_fused_pallas_chain(taps, NB, interpret=True)
    pp = min(128, NB)
    gr, gi = chain.stack_combined_operators(
        *chain.combined_fir_fft_operators(taps, NB, pp))
    hist = torch.zeros(C, k - 1, 2)
    jhist = jnp.zeros((C, k - 1, 2), jnp.float32)
    chist = hist
    xs, specs = [], []
    for _ in range(2):
        x = _x(rng, C, T)
        xs.append(x)
        spec, hist = run.run(torch.from_numpy(x), hist)
        se, jhist = jrun(jnp.asarray(x), jhist)
        sc, chist = chain.fir_fft_combined_step(torch.from_numpy(x), chist,
                                                gr, gi, NB, k, pp)
        assert spec.shape == se.shape == (C, T // NB, NB, 2)
        assert _rel_err(spec, se) < 1e-4
        assert _rel_err(spec, sc) < 1e-4
        np.testing.assert_array_equal(hist.numpy(), np.asarray(jhist))
        np.testing.assert_array_equal(hist.numpy(), x[:, T - (k - 1):])
        specs.append(spec.numpy())
    got = np.concatenate(specs, axis=1)
    exp = _oracle(xs, taps, NB)
    assert _rel_err(got[..., 0] + 1j * got[..., 1], exp) < 1e-4


def test_too_many_taps_raise_in_both_packages():
    taps = _taps(np.random.default_rng(43), 66)
    with pytest.raises(AssertionError):
        jpk.make_fused_pallas_chain(taps, 1024, interpret=True)
    with pytest.raises(ValueError):
        ff.make_fused_chain(taps, 1024)
    with pytest.raises(ValueError):        # the JAX kernel fixes N = 1024
        ff.make_fused_chain(taps[:8], 512)


def test_plain_version_is_fft_times_h_plus_correction():
    rng = np.random.default_rng(44)
    x, uw = torch.from_numpy(_x(rng, 3, 16)), torch.from_numpy(_x(rng, 3, 4))
    H = torch.from_numpy(_x(rng, 16))
    gr = torch.from_numpy(rng.normal(size=(4, 16)).astype(np.float32))
    gi = torch.from_numpy(rng.normal(size=(4, 16)).astype(np.float32))
    xc = x[..., 0].double().numpy() + 1j * x[..., 1].double().numpy()
    uc = uw[..., 0].double().numpy() + 1j * uw[..., 1].double().numpy()
    exp = np.fft.fft(xc, axis=-1) * (H[:, 0].double().numpy()
                                     + 1j * H[:, 1].double().numpy()) \
        + uc @ (gr.double().numpy() + 1j * gi.double().numpy())
    got = ff.fir_fft_fused_plain(x, uw, H, gr, gi).numpy()
    assert _rel_err(got[..., 0] + 1j * got[..., 1], exp) < 2e-6


def test_wrapper_never_counts_cpu_and_refuses_bad_operands():
    x = torch.zeros(4, 16, 2)
    uw = torch.zeros(4, 8, 2)
    H = torch.zeros(16, 2)
    g = torch.zeros(8, 16)
    before = ff.fir_fft_fused.launches
    ff.fir_fft_fused(x, uw, H, g, g)
    ff.make_fused_chain(np.ones(4) / 4, 1024, device="cpu").run(
        torch.zeros(1, 1024, 2), torch.zeros(1, 3, 2))
    assert ff.fir_fft_fused.launches == before
    with pytest.raises(ValueError):        # no kernel and no plain path
        ff.fir_fft_fused(*(t.to("meta") for t in (x, uw, H, g, g)))
    with pytest.raises(TypeError):
        ff.fir_fft_fused(x.double(), uw, H, g, g)
    with pytest.raises(ValueError):        # H of another length
        ff.fir_fft_fused(x, uw, torch.zeros(8, 2), g, g)
    with pytest.raises(ValueError):        # uw rows != pp
        ff.fir_fft_fused(x, torch.zeros(4, 7, 2), H, g, g)
    with pytest.raises(ValueError):        # gci of another shape
        ff.fir_fft_fused(x, uw, H, g, torch.zeros(8, 15))
    with pytest.raises(ValueError):        # T not a multiple of nbins
        ff.make_fused_chain(np.ones(4), 1024, device="cpu").run(
            torch.zeros(1, 1000, 2), torch.zeros(1, 3, 2))


@pytest.mark.parametrize("n", [8192, 16384, 257])
@pytest.mark.parametrize("inverse", [False, True])
def test_long_row_split_matches_numpy_and_jax(n, inverse):
    """The split that fft_planar takes on CUDA above K2's 4096 (here on
    CPU tensors, its factors on the plain version); a prime n has no
    split and takes one direct DFT product."""
    rng = np.random.default_rng(n)
    x = _x(rng, 2, n)
    got = fft_split(torch.from_numpy(x), n, inverse).numpy()
    xc = x[..., 0].astype(np.float64) + 1j * x[..., 1]
    exp = np.fft.ifft(xc, axis=-1) * n if inverse else np.fft.fft(xc, axis=-1)
    assert _rel_err(got[..., 0] + 1j * got[..., 1], exp) < 2e-5
    jexp = np.asarray(jfft_planar(jnp.asarray(x), n, inverse))
    assert _rel_err(got, jexp) < 2e-5
