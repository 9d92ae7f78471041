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
H bit for bit; the time-domain correction operator gt, which the port
recovers from the JAX Gc by a float64 inverse DFT, within 1e-6 of max
|gt| of the one built from the taps, and its spectrum within 1e-6 of max
|Gc| of the JAX Gc (float32 roundings of Gc and of the taps), and with
taps that float32 holds exactly within one float32 step of it; the split
FFT at 2e-5 as the JAX FFT tests.
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
    H, gt = ff.fused_consts_from_numpy(consts, device="cpu")
    got = ff.fir_fft_fused(torch.from_numpy(x),
                           torch.from_numpy(uw) if with_corr else None,
                           H, gt)
    assert got.shape == (B, N, 2)
    assert _rel_err(got, exp) < 2e-5


@pytest.mark.parametrize("k", [2, 17, 64, 65])
def test_consts_from_numpy_equal_fused_chain_consts(k):
    taps = _taps(np.random.default_rng(41), k)
    consts = _jax_consts(taps)
    H, gt = ff.fused_consts_from_numpy(consts, device="cpu")
    H2, gt2 = ff.fused_chain_consts(taps, 1024, 64)
    assert H.dtype == gt.dtype == torch.float32
    assert H.shape == (1024, 2) and gt.shape == gt2.shape == (64, 64, 2)
    np.testing.assert_array_equal(H.numpy(), H2.numpy())
    assert np.max(np.abs(gt.numpy() - gt2.numpy())) \
        < 1e-6 * np.max(np.abs(gt2.numpy()))
    # the JAX Gc, its m-major columns undone (pallas_kernels.py:396)
    jgc = [np.asarray(a).reshape(64, 8, 128).transpose(0, 2, 1)
           .reshape(64, 1024) for a in consts[4]]
    for planes in (ff.correction_spectrum(gt, 1024),
                   ff.correction_spectrum(gt2, 1024)):
        for got, exp in zip(planes, jgc):
            assert got.shape == (64, 1024) and got.dtype == torch.float32
            assert np.max(np.abs(got.numpy() - exp)) \
                < 1e-6 * np.max(np.abs(exp))


@pytest.mark.parametrize("k", [2, 17, 64, 65])
def test_gc_rebuilt_from_gt_is_the_jax_gc_to_one_float32_step(k):
    """With taps that float32 holds exactly, gt from ``fused_chain_consts``
    is exact, and its spectrum is the Gc of the JAX ``_fused_chain_consts``
    and of ``parallel.chain.circ_correction_operators`` (flipped and
    padded at the front to pp, which is bit for bit the JAX Gc). The two
    float64 sums run in different orders with twiddles from different
    routines, so a value that falls within ~1e-16 of a float32 rounding
    boundary may land on its other side: every element within one float32
    step of the JAX value, and no more than one in 5000 not equal."""
    taps = _taps(np.random.default_rng(41), k).astype(np.complex64) \
        .astype(np.complex128)
    consts = _jax_consts(taps)
    jgc = [np.asarray(a).reshape(64, 8, 128).transpose(0, 2, 1)
           .reshape(64, 1024) for a in consts[4]]
    _, gc = chain.circ_correction_operators(taps, 1024)
    _, gt = ff.fused_chain_consts(taps, 1024, 64)
    gt64 = np.zeros((64, 64), np.complex128)
    for m in range(1, k):
        gt64[64 - m, :k - m] = taps[m:]
    np.testing.assert_array_equal(
        gt.numpy(), np.stack([gt64.real, gt64.imag], -1).astype(np.float32))
    for got, exp, par in zip(ff.correction_spectrum(gt, 1024), jgc, gc):
        np.testing.assert_array_equal(
            torch.cat([par.new_zeros(64 - (k - 1), 1024), par.flip(0)])
            .numpy(), exp)
        got = got.numpy()
        assert np.all(np.abs(got - exp) <= np.spacing(np.abs(exp)))
        assert np.count_nonzero(got != exp) * 5000 <= got.size


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
    assert {n for n, _ in run.named_buffers()} == {"H", "gt"}
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
    gt = torch.from_numpy(_x(rng, 4, 5))
    xc = x[..., 0].double().numpy() + 1j * x[..., 1].double().numpy()
    uc = uw[..., 0].double().numpy() + 1j * uw[..., 1].double().numpy()
    gc = np.fft.fft(gt[..., 0].double().numpy()
                    + 1j * gt[..., 1].double().numpy(), 16, axis=-1)
    exp = np.fft.fft(xc, axis=-1) * (H[:, 0].double().numpy()
                                     + 1j * H[:, 1].double().numpy()) \
        + uc @ gc
    got = ff.fir_fft_fused_plain(x, uw, H, gt).numpy()
    assert _rel_err(got[..., 0] + 1j * got[..., 1], exp) < 2e-6


def test_wrapper_never_counts_cpu_and_refuses_bad_operands():
    x = torch.zeros(4, 16, 2)
    uw = torch.zeros(4, 8, 2)
    H = torch.zeros(16, 2)
    g = torch.zeros(8, 8, 2)
    before = ff.fir_fft_fused.launches
    ff.fir_fft_fused(x, uw, H, g)
    ff.make_fused_chain(np.ones(4) / 4, 1024, device="cpu").run(
        torch.zeros(1, 1024, 2), torch.zeros(1, 3, 2))
    assert ff.fir_fft_fused.launches == before
    with pytest.raises(ValueError):        # no kernel and no plain path
        ff.fir_fft_fused(*(t.to("meta") for t in (x, uw, H, g)))
    with pytest.raises(TypeError):
        ff.fir_fft_fused(x.double(), uw, H, g)
    with pytest.raises(ValueError):        # H of another length
        ff.fir_fft_fused(x, uw, torch.zeros(8, 2), g)
    with pytest.raises(ValueError):        # uw rows != pp
        ff.fir_fft_fused(x, torch.zeros(4, 7, 2), H, g)
    with pytest.raises(ValueError):        # gt longer than the window
        ff.fir_fft_fused(x, uw, H, torch.zeros(8, 17, 2))
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
