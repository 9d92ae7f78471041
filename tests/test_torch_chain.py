"""Parity of the port's FIR -> FFT chain (pothoscomms_tpu_torch.parallel
.chain / .profiling) with the JAX package, function by function and for
the slice as a whole.

Inputs are float32 from numpy.random.default_rng(seed) and go through
both packages. Tolerances: spectra at 1e-4 relative to max |spectrum|
(the JAX package's chain contract, tests/test_tpu_lane.py); FIR outputs
at 1e-5 relative to max |y| (float32 sums over K terms in another
order); carries exact; operator builders bit for bit.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pothoscomms_tpu.parallel import chain as jchain
from pothoscomms_tpu.parallel import profiling as jprofiling
from pothoscomms_tpu_torch.parallel import chain, profiling

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def _rel_err(got, exp):
    got, exp = np.asarray(got), np.asarray(exp)
    return np.max(np.abs(got - exp)) / np.max(np.abs(exp))


def _taps(rng, k):
    return (rng.normal(size=k) + 1j * rng.normal(size=k)) / k


def _x(rng, *shape):
    return rng.normal(size=(*shape, 2)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------------ #
# operator builders: bit for bit
# ------------------------------------------------------------------ #
def _flat(ops):
    if isinstance(ops, (tuple, list)):
        return [a for o in ops for a in _flat(o)]
    return [np.asarray(ops)]


@pytest.mark.parametrize("builder,args", [
    ("complex_fir_kernel", ()),
    ("make_fir_kernel", ()),
    ("fir_toeplitz_matrices", ()),
    ("combined_fir_fft_operators", (256, 128)),
    ("combined_fir_fft_operators", (64, 64)),
    ("circ_correction_operators", (256,)),
])
def test_operator_builders_equal_jax_bit_for_bit(builder, args):
    taps = _taps(np.random.default_rng(20), 33)
    got = _flat(getattr(chain, builder)(taps, *args))
    exp = _flat(getattr(jchain, builder)(taps, *args))
    assert len(got) == len(exp)
    for g, e in zip(got, exp):
        assert g.dtype == e.dtype == np.float32
        np.testing.assert_array_equal(g, e)


def test_real_taps_fir_kernel_equals_jax():
    taps = np.random.default_rng(21).normal(size=9)
    np.testing.assert_array_equal(chain.complex_fir_kernel(taps).numpy(),
                                  np.asarray(jchain.complex_fir_kernel(taps)))


# ------------------------------------------------------------------ #
# each chain function
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("k,decim", [(12, 1), (6, 3), (1, 1)])
def test_fir_multichannel_matches_jax(k, decim):
    rng = np.random.default_rng(22)
    C, T = 4, 300
    x, hist = _x(rng, C, T), _x(rng, C, k - 1)
    taps = _taps(rng, k)
    y, h = chain.fir_multichannel(_t(x), _t(hist),
                                  chain.complex_fir_kernel(taps), decim)
    ye, he = jchain.fir_multichannel(jnp.asarray(x), jnp.asarray(hist),
                                     jchain.complex_fir_kernel(taps), decim)
    assert y.shape == ye.shape
    assert _rel_err(y, ye) < 1e-5
    np.testing.assert_array_equal(h.numpy(), np.asarray(he))


@pytest.mark.parametrize("k", [8, 64, 128])
def test_fir_multichannel_mm_matches_jax(k):
    rng = np.random.default_rng(23)
    C, T = 3, 512
    x, hist = _x(rng, C, T), _x(rng, C, k - 1)
    taps = _taps(rng, k)
    t0, t1 = chain.fir_toeplitz_matrices(taps)
    y, h = chain.fir_multichannel_mm(_t(x), _t(hist), t0, t1)
    jt0, jt1 = jchain.fir_toeplitz_matrices(taps)
    ye, he = jchain.fir_multichannel_mm(jnp.asarray(x), jnp.asarray(hist),
                                        jt0, jt1)
    assert _rel_err(y, ye) < 1e-5
    np.testing.assert_array_equal(h.numpy(), np.asarray(he))


def test_fir_toeplitz_rejects_long_taps():
    with pytest.raises(ValueError):
        chain.fir_toeplitz_matrices(np.ones(129))


@pytest.mark.parametrize("decim", [1, 2])
def test_fir_fft_step_matches_jax(decim):
    rng = np.random.default_rng(24)
    C, T, K, NB = 2, 1024, 40, 256
    x, hist = _x(rng, C, T), _x(rng, C, K - 1)
    taps = _taps(rng, K)
    spec, h = chain.fir_fft_step(_t(x), _t(hist),
                                 chain.complex_fir_kernel(taps), NB, decim)
    se, he = jchain.fir_fft_step(jnp.asarray(x), jnp.asarray(hist),
                                 jchain.complex_fir_kernel(taps), NB, decim)
    assert spec.shape == se.shape == (C, T // decim // NB, NB, 2)
    assert _rel_err(spec, se) < 1e-4
    np.testing.assert_array_equal(h.numpy(), np.asarray(he))


def test_fir_fft_step_mm_matches_jax():
    rng = np.random.default_rng(25)
    C, T, K, NB = 2, 1024, 100, 64
    x, hist = _x(rng, C, T), _x(rng, C, K - 1)
    taps = _taps(rng, K)
    t0, t1 = chain.fir_toeplitz_matrices(taps)
    spec, h = chain.fir_fft_step_mm(_t(x), _t(hist), t0, t1, NB)
    jt0, jt1 = jchain.fir_toeplitz_matrices(taps)
    se, he = jchain.fir_fft_step_mm(jnp.asarray(x), jnp.asarray(hist),
                                    jt0, jt1, NB)
    assert _rel_err(spec, se) < 1e-4
    np.testing.assert_array_equal(h.numpy(), np.asarray(he))


@pytest.mark.parametrize("k,nb", [(64, 1024), (33, 64), (2, 256)])
def test_fir_fft_combined_step_matches_jax(k, nb):
    rng = np.random.default_rng(26)
    C, T = 2, 4 * nb
    pp = min(128, nb)
    x, hist = _x(rng, C, T), _x(rng, C, k - 1)
    taps = _taps(rng, k)
    gr, gi = chain.stack_combined_operators(
        *chain.combined_fir_fft_operators(taps, nb, pp))
    spec, h = chain.fir_fft_combined_step(_t(x), _t(hist), gr, gi, nb, k, pp)
    (j0r, j0i), (j1r, j1i) = jchain.combined_fir_fft_operators(taps, nb, pp)
    se, he = jchain.fir_fft_combined_step(
        jnp.asarray(x), jnp.asarray(hist), j0r, j0i, j0r + j0i,
        j1r, j1i, j1r + j1i, nb, k, pp)
    assert spec.shape == se.shape
    assert _rel_err(spec, se) < 1e-4
    np.testing.assert_array_equal(h.numpy(), np.asarray(he))


def test_stacked_operators_equal_jax_operators_stacked():
    """[G1; G0], built once, equals the JAX package's two operators
    concatenated (the step's ``jnp.concatenate``) bit for bit."""
    taps = _taps(np.random.default_rng(31), 64)
    gr, gi = chain.stack_combined_operators(
        *chain.combined_fir_fft_operators(taps, 256, 128))
    (j0r, j0i), (j1r, j1i) = jchain.combined_fir_fft_operators(taps, 256, 128)
    assert gr.shape == gi.shape == (128 + 256, 256)
    np.testing.assert_array_equal(gr.numpy(), np.concatenate([j1r, j0r]))
    np.testing.assert_array_equal(gi.numpy(), np.concatenate([j1i, j0i]))


def test_combined_operand_layout():
    """Window w's operand is the prev_pad samples before it, then it."""
    rng = np.random.default_rng(27)
    C, NB, PP, K = 2, 64, 16, 5
    x, hist = _x(rng, C, 3 * NB), _x(rng, C, K - 1)
    a = chain.combined_operand(_t(x), _t(hist), NB, K, PP).numpy()
    a = a.reshape(C, 3, PP + NB, 2)
    padded = np.concatenate([np.zeros((C, PP - (K - 1), 2), np.float32),
                             hist, x], axis=1)
    for w in range(3):
        np.testing.assert_array_equal(
            a[:, w], padded[:, w * NB: w * NB + PP + NB])


@pytest.mark.parametrize("k", [29, 2])
def test_fir_fft_circ_step_matches_jax(k):
    rng = np.random.default_rng(28)
    C, T, NB = 2, 2048, 512
    x, hist = _x(rng, C, T), _x(rng, C, k - 1)
    taps = _taps(rng, k)
    Hp, (gcr, gci) = chain.circ_correction_operators(taps, NB)
    spec, h = chain.fir_fft_circ_step(_t(x), _t(hist), Hp, gcr, gci, NB, k)
    jH, (jgr, jgi) = jchain.circ_correction_operators(taps, NB)
    se, he = jchain.fir_fft_circ_step(jnp.asarray(x), jnp.asarray(hist), jH,
                                      jgr, jgi, jgr + jgi, NB, k)
    assert _rel_err(spec, se) < 1e-4
    np.testing.assert_array_equal(h.numpy(), np.asarray(he))


# ------------------------------------------------------------------ #
# the slice as a whole: fir_fft_chain, three chained steps
# ------------------------------------------------------------------ #
def _oracle(x_steps, taps, nb, decim=1):
    """float64 numpy convolve-then-FFT over the concatenated steps."""
    xs = np.concatenate(x_steps, axis=1)
    xc = xs[..., 0].astype(np.float64) + 1j * xs[..., 1]
    c, t = xc.shape
    y = np.stack([np.convolve(xc[i], taps)[:t] for i in range(c)])[:, ::decim]
    return np.fft.fft(y.reshape(c, -1, nb), axis=-1)


@pytest.mark.parametrize("k,nb,decim,form", [
    (64, 1024, 1, "combined"),
    (100, 64, 1, "toeplitz"),   # nbins < 128 with long taps
    (200, 1024, 1, "conv"),     # K > 129
    (64, 1024, 2, "conv"),      # decimation
])
def test_fir_fft_chain_three_steps_matches_jax(k, nb, decim, form):
    rng = np.random.default_rng(29)
    C, T = 8, 4096
    taps = _taps(rng, k)
    run, carry = chain.fir_fft_chain(taps, nb, C, T, decim, device="cpu")
    assert run.form == form
    assert carry.shape == (C, k - 1, 2) and not carry.any()
    jrun, jcarry = jchain.fir_fft_chain(taps, nb, C, T, decim)
    xs, specs = [], []
    for _ in range(3):
        x = _x(rng, C, T)
        xs.append(x)
        spec, carry = run(_t(x), carry)
        se, jcarry = jrun(jnp.asarray(x), jcarry)
        assert spec.shape == se.shape == (C, T // decim // nb, nb, 2)
        assert _rel_err(spec, se) < 1e-4
        np.testing.assert_array_equal(carry.numpy(), np.asarray(jcarry))
        np.testing.assert_array_equal(carry.numpy(), x[:, T - (k - 1):])
        specs.append(spec.numpy())
    got = np.concatenate(specs, axis=1)
    exp = _oracle(xs, taps, nb, decim)
    assert _rel_err(got[..., 0] + 1j * got[..., 1], exp) < 1e-4


def test_chain_from_jax_operators_matches():
    """Operators and carry made by the JAX package, moved over with
    operators_from_numpy / carry_from_numpy, drive the port's step to the
    JAX chain's spectra over three steps."""
    rng = np.random.default_rng(30)
    C, T, K, NB = 4, 2048, 64, 1024
    taps = _taps(rng, K)
    jrun, jcarry = jchain.fir_fft_chain(taps, NB, C, T)
    g0, g1 = chain.operators_from_numpy(
        jax_ops := jchain.combined_fir_fft_operators(taps, NB, 128),
        device="cpu")
    assert all(isinstance(t, torch.Tensor) and t.dtype == torch.float32
               for t in (*g0, *g1))
    assert len(_flat(jax_ops)) == 4
    gr, gi = chain.stack_combined_operators(g0, g1)
    carry = chain.carry_from_numpy(np.asarray(jcarry), device="cpu")
    for _ in range(3):
        x = _x(rng, C, T)
        spec, carry = chain.fir_fft_combined_step(_t(x), carry, gr, gi,
                                                  NB, K, 128)
        se, jcarry = jrun(jnp.asarray(x), jcarry)
        assert _rel_err(spec, se) < 1e-4
        np.testing.assert_array_equal(carry.numpy(), np.asarray(jcarry))


def test_from_numpy_refuses_other_dtypes():
    with pytest.raises(TypeError):
        chain.operators_from_numpy((np.zeros(3),))
    with pytest.raises(TypeError):
        chain.carry_from_numpy(np.zeros((2, 3, 2)))


def test_fir_fft_chain_module_holds_operators_on_device():
    run, hist0 = chain.fir_fft_chain(np.ones(8) / 8, 256, 3, 1024,
                                     device="cpu")
    assert isinstance(run, torch.nn.Module)
    assert {n for n, _ in run.named_buffers()} == {"gr", "gi"}
    assert run.gr.shape == run.gi.shape == (128 + 256, 256)
    assert all(b.device.type == "cpu" for b in run.buffers())
    assert hist0.dtype == torch.float32 and hist0.shape == (3, 7, 2)


# ------------------------------------------------------------------ #
# profiling
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("c,t,k,nb", [(256, 131072, 64, 1024),
                                      (4, 2048, 16, 256)])
def test_chain_flops_matches_jax_at_prev_pad_128(c, t, k, nb):
    """The same model, except that the port's combined step executes the
    4-product form (8 real flops per complex MAC) where the JAX package
    executes Karatsuba's 3 products (6)."""
    got = profiling.chain_flops(c, t, k, nb, prev_pad=128)
    exp = jprofiling.chain_flops(c, t, k, nb)
    for key in ("necessary_gflop", "hbm_mbytes"):
        assert got[key] == exp[key]
    assert got["executed_gflop"] == round(c * t * (nb + 128) * 8 / 1e9, 2)
    assert abs(got["executed_gflop"] * 6 / 8 - exp["executed_gflop"]) < 0.02
    small = profiling.chain_flops(c, t, k, 64, prev_pad=64)
    assert small["executed_gflop"] == round(c * t * 128 * 8 / 1e9, 2)


def test_trace_and_annotate_write_a_trace(tmp_path):
    run, carry = chain.fir_fft_chain(np.ones(4) / 4, 64, 2, 256,
                                     device="cpu")
    x = torch.zeros(2, 256, 2)
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("chain_step"):
            run(x, carry)
    files = list(tmp_path.iterdir())
    assert files
    assert "chain_step" in files[0].read_text()


# ------------------------------------------------------------------ #
# the package stands alone
# ------------------------------------------------------------------ #
def test_package_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['pothoscomms_tpu'] = None\n"
        "import pothoscomms_tpu_torch\n"
        "from pothoscomms_tpu_torch.kernels import (build, cgemm, fft,\n"
        "    fir_fft_fused, envelope, layout_move, stream_scale,\n"
        "    sync_search)\n"
        "from pothoscomms_tpu_torch.parallel import (chain, compiler, cplx,\n"
        "    distributed, dryrun, fft, link, mesh, profiling)\n"
        "from pothoscomms_tpu_torch import native\n"
        "from pothoscomms_tpu_torch.core import (block, dtypes, fixtures,\n"
        "    fusion, introspect, labels, packet, qformat, registry, testing,\n"
        "    topology)\n"
        "import pothoscomms_tpu_torch.__main__\n"
        "from pothoscomms_tpu_torch.design import (firdes, iirdes, remez,\n"
        "    windows)\n"
        "from pothoscomms_tpu_torch.ops import (bits, cint, digital_device,"
        " elementwise,\n    filter, framing, fxpt, gf2)\n"
        "from pothoscomms_tpu_torch.blocks import (demod, digital, fft, "
        "filter,\n    framing, mac, math, sources, utility, window)\n"
        "assert not [m for m in sys.modules if m.startswith('jax')\n"
        "            and sys.modules[m] is not None]\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": str(REPO)})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_chip_smoke_fails_without_a_card(tmp_path):
    """chip_smoke.py exits non-zero, with no result line, where CUDA is
    unavailable (always so on the CPU lane)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run for real")
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                          cwd=tmp_path, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
