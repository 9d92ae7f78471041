"""The port's split-stream (radix-R) FIR -> FFT step against the JAX
package's ``split_stream_fir_fft_operators`` / ``make_split_step``
(pothoscomms_tpu/parallel/chain.py:266-367), a float64 numpy oracle and
the port's combined step.

Inputs are explicit float32 arrays made with numpy.random.default_rng(seed)
(JAX runs with x64 on here). Tolerances: the operators equal JAX's arrays
bit for bit (the same float64 numpy code, cast to float32 once); spectra
within 1e-4 of max |spectrum| against JAX, the float64 oracle and the
combined step (the test_tpu_lane.py contract: float32 products over W + pp
terms, in another order); the carry exactly the last K-1 inputs. On the
CPU the K1 products run as their plain PyTorch version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pothoscomms_tpu.parallel import chain as jchain
from pothoscomms_tpu_torch.parallel import chain

torch.set_num_threads(1)

TOL = 1e-4
C, NB, K = 4, 256, 16
CASES = [(R, pp) for R in (2, 4, 8) for pp in (16, 32)]


def _taps(rng, k=K):
    return (rng.normal(size=k) + 1j * rng.normal(size=k)) / k


def _x(rng, c, t):
    return rng.normal(size=(c, t, 2)).astype(np.float32)


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.max(np.abs(got - ref)) / np.max(np.abs(ref))


def _oracle(x_steps, taps, nbins):
    """float64 spectra of every step of a stream that starts from zeros:
    [steps][C, T//nbins, nbins] complex."""
    xs = np.concatenate(x_steps, axis=1).astype(np.float64)
    xc = xs[..., 0] + 1j * xs[..., 1]
    c, n = xc.shape
    y = np.stack([np.convolve(xc[ch], taps)[:n] for ch in range(c)])
    spec = np.fft.fft(y.reshape(c, n // nbins, nbins), axis=-1)
    t = x_steps[0].shape[1]
    return np.split(spec, n // t, axis=1)


def _cplx(spec):
    s = np.asarray(spec)
    return s[..., 0] + 1j * s[..., 1]


@pytest.mark.parametrize("R,pp", CASES)
def test_operators_equal_jax(R, pp):
    taps = _taps(np.random.default_rng(R * 100 + pp))
    ops, wr = chain.split_stream_fir_fft_operators(taps, NB, R, pp)
    jops, jwr = jchain.split_stream_fir_fft_operators(taps, NB, R, pp)
    np.testing.assert_array_equal(wr, jwr)
    assert len(ops) == len(jops) == R
    for (g0, g1), (j0, j1) in zip(ops, jops):
        for mine, theirs in zip(g0 + g1, j0 + j1):
            assert mine.dtype == torch.float32
            np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))


@pytest.mark.parametrize("R,pp", CASES)
def test_split_step_matches_jax_oracle_and_carry(R, pp):
    rng = np.random.default_rng(7 + R * 10 + pp)
    taps = _taps(rng)
    T = 4 * NB
    run, hist0 = chain.make_split_step(taps, NB, R, pp, device="cpu")
    jrun, jhist0 = jchain.make_split_step(taps, NB, R, pp)
    assert tuple(hist0.shape) == tuple(jhist0.shape) == (1, K - 1, 2)
    hist = torch.zeros(C, K - 1, 2)
    jhist = jnp.zeros((C, K - 1, 2), jnp.float32)
    xs = [_x(rng, C, T) for _ in range(2)]
    oracle = _oracle(xs, taps, NB)
    for s, x in enumerate(xs):
        spec, new_hist = run(torch.from_numpy(x), hist)
        jspec, jhist = jrun(jnp.asarray(x), jhist)
        assert tuple(spec.shape) == (C, T // NB, NB, 2)
        assert _rel(spec.numpy(), jspec) < TOL
        assert _rel(_cplx(spec), oracle[s]) < TOL
        np.testing.assert_array_equal(new_hist.numpy(), x[:, T - (K - 1):])
        np.testing.assert_array_equal(new_hist.numpy(), np.asarray(jhist))
        hist = new_hist


@pytest.mark.parametrize("R", [2, 4, 8])
def test_split_step_matches_combined_step(R):
    """The same spectra as the main path's combined operator
    (fir_fft_chain), from the same mid-stream carry."""
    rng = np.random.default_rng(40 + R)
    taps = _taps(rng)
    T = 8 * NB
    run, _ = chain.make_split_step(taps, NB, R, 32, device="cpu")
    comb, _ = chain.fir_fft_chain(taps, NB, C, T, device="cpu")
    assert comb.form == "combined"
    x = torch.from_numpy(_x(rng, C, T))
    hist = torch.from_numpy(_x(rng, C, K - 1))
    spec, h = run(x, hist)
    ref, hc = comb(x, hist)
    assert _rel(spec.numpy(), ref.numpy()) < TOL
    assert torch.equal(h, hc)


@pytest.mark.parametrize("R", [2, 4, 8])
def test_split_operand_streams_are_the_weighted_quarters(R):
    """Stream r's operand row is [0 .. 0 | hist_r | v_r], with
    v_r = sum_m W_R^{mr} x_m and hist_r from the raw tails (the JAX
    step's sums at chain.py:344-352), here in float64."""
    rng = np.random.default_rng(60 + R)
    pp, T = 32, 2 * NB
    W, k1 = NB // R, K - 1
    x = _x(rng, 2, T)
    hist = _x(rng, 2, k1)
    _, wr = chain.split_stream_fir_fft_operators(_taps(rng), NB, R, pp)
    a = chain.split_operand(torch.from_numpy(x), torch.from_numpy(hist),
                            torch.from_numpy(wr.astype(np.complex64)), NB,
                            K, pp).numpy()
    assert a.shape == (R, 2 * (T // NB), pp + W, 2)
    xc = x[..., 0].astype(np.float64) + 1j * x[..., 1]
    hc = hist[..., 0].astype(np.float64) + 1j * hist[..., 1]
    xq = xc.reshape(2, T // NB, R, W)
    qt = xq[..., W - k1:]
    prev_last = np.concatenate([hc[:, None], qt[:, :-1, R - 1]], axis=1)
    for r in range(R):
        v = sum(wr[r, m] * xq[:, :, m] for m in range(R))
        h = prev_last + sum(wr[r, m] * qt[:, :, m - 1] for m in range(1, R))
        exp = np.concatenate([np.zeros((2, T // NB, pp - k1)), h, v],
                             axis=2).reshape(-1, pp + W)
        got = a[r, ..., 0] + 1j * a[r, ..., 1]
        assert np.max(np.abs(got - exp)) < 1e-5 * np.max(np.abs(exp))


def test_split_step_rejects_a_tail_longer_than_pp():
    with pytest.raises(ValueError):
        chain.split_stream_fir_fft_operators(np.ones(40), NB, 4, 32)
    with pytest.raises(ValueError):  # pp above the stream width W = 32
        chain.split_stream_fir_fft_operators(np.ones(8), NB, 8, 64)


def test_cgemm_writes_into_out():
    """The split step's streams land in one buffer through ``out``."""
    from pothoscomms_tpu_torch.kernels.cgemm import cgemm, cgemm_plain

    rng = np.random.default_rng(3)
    a = torch.from_numpy(_x(rng, 5, 7))
    gr = torch.from_numpy(rng.normal(size=(7, 4)).astype(np.float32))
    gi = torch.from_numpy(rng.normal(size=(7, 4)).astype(np.float32))
    buf = torch.zeros(2, 5, 4, 2)
    got = cgemm(a, gr, gi, out=buf[1])
    assert got.data_ptr() == buf[1].data_ptr()
    assert torch.equal(buf[1], cgemm_plain(a, gr, gi))
    assert torch.equal(buf[0], torch.zeros(5, 4, 2))
    for bad in (torch.zeros(5, 4, 3), torch.zeros(5, 4, 2).double(),
                torch.zeros(4, 5, 2).transpose(0, 1)):
        with pytest.raises(ValueError):
            cgemm(a, gr, gi, out=bad)
