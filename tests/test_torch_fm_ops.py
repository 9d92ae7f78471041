"""The FM receive chain's functional cores in the port against the JAX
package: ``freq_demod_planar``, ``dc_removal``, the envelope scans and
E1's plain version ``envelope_rows_plain``, ``fxpt_atan2``,
``q_rsqrt_f32`` and ``cint`` (the cases of tests/test_parallel.py,
test_filter.py and test_math.py for these functions).

Inputs are explicit float32/complex64 (or int16) arrays made with
numpy.random.default_rng(seed). Tolerances: integer results bit-exact;
the discriminator within 1e-5 absolute (atan2 of the same products,
float32); DC removal within 1e-5 of max |y| in float32 (cumulative sums
in another order) and 1e-12 in float64; the envelope within rtol 1e-5 /
atol 1e-6 (the bound of test_filter.py's blocked-envelope test).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pothoscomms_tpu.ops import cint as jcint
from pothoscomms_tpu.ops import filter as jfops
from pothoscomms_tpu.ops import fxpt as jfxpt
from pothoscomms_tpu.parallel.chain import freq_demod_planar as j_demod
from pothoscomms_tpu_torch.kernels.envelope import (envelope_rows,
                                                    envelope_rows_plain)
from pothoscomms_tpu_torch.ops import cint, fxpt
from pothoscomms_tpu_torch.ops import filter as fops
from pothoscomms_tpu_torch.parallel.chain import freq_demod_planar

torch.set_num_threads(1)

ENV_TOL = dict(rtol=1e-5, atol=1e-6)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _planar(z):
    return np.stack([z.real, z.imag], -1).astype(np.float32)


# ---------------------------------------------------------------------- #
# freq_demod_planar (tests/test_parallel.py:162-176)
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("C,T", [(2, 128), (1, 1), (5, 333)])
def test_freq_demod_planar_matches_jax_and_numpy(C, T):
    rng = np.random.default_rng(6)
    phase = np.cumsum(rng.normal(size=(C, T)) * 0.3, axis=1)
    x = _planar(np.exp(1j * phase))
    last = _planar(np.ones((C, 1)))  # start at 1+0j
    y, last2 = freq_demod_planar(_t(x), _t(last))
    yj, lastj = j_demod(jnp.asarray(x), jnp.asarray(last))
    assert y.shape == (C, T) and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(last2.numpy(), np.asarray(lastj))
    xc = x[..., 0].astype(np.float64) + 1j * x[..., 1]
    prev = np.concatenate([np.ones((C, 1)), xc[:, :-1]], axis=1)
    np.testing.assert_allclose(y.numpy(), np.angle(xc * np.conj(prev)),
                               atol=1e-5)


# ---------------------------------------------------------------------- #
# moving_average_stage / dc_removal (tests/test_filter.py:647-717)
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype,depth,cascade,n", [
    (np.float64, 32, 2, 400), (np.float64, 8, 3, 300),
    (np.float32, 16, 2, 1000), (np.complex64, 16, 2, 257)])
def test_dc_removal_float_matches_jax(dtype, depth, cascade, n):
    rng = np.random.default_rng(16)
    x = rng.normal(size=n) + 3.0
    if np.issubdtype(dtype, np.complexfloating):
        x = x + 1j * (rng.normal(size=n) - 2.0)
    x = x.astype(dtype)
    hists = (rng.normal(size=(cascade, depth)) * 0.5).astype(dtype)
    y, h = fops.dc_removal(_t(x), _t(hists), depth, cascade, False)
    yj, hj = jfops.dc_removal(jnp.asarray(x), jnp.asarray(hists), depth,
                              cascade, False)
    tol = 1e-12 if dtype == np.float64 else 1e-5
    yj, hj = np.asarray(yj), np.asarray(hj)
    assert y.shape == yj.shape and h.shape == hj.shape
    assert np.max(np.abs(y.numpy() - yj)) <= tol * np.max(np.abs(yj))
    # stage 0 keeps raw inputs (exact); later stages keep averages
    np.testing.assert_array_equal(h[0].numpy(), hj[0])
    assert np.max(np.abs(h.numpy() - hj)) <= tol * np.max(np.abs(hj))


@pytest.mark.parametrize("depth,cascade", [(16, 2), (5, 1), (7, 3)])
def test_dc_removal_int_bit_exact(depth, cascade):
    rng = np.random.default_rng(17)
    x = (rng.integers(-100, 100, 300) + 50).astype(np.int32)
    hists = rng.integers(-40, 40, (cascade, depth)).astype(np.int32)
    y, h = fops.dc_removal(_t(x), _t(hists), depth, cascade, True)
    yj, hj = jfops.dc_removal(jnp.asarray(x), jnp.asarray(hists), depth,
                              cascade, True)
    # the block narrows to the data type; compare there
    np.testing.assert_array_equal(y.numpy().astype(np.int16),
                                  np.asarray(yj).astype(np.int16))
    np.testing.assert_array_equal(h.numpy(), np.asarray(hj))


def test_moving_average_int_wraps_mod_2_32():
    """A window sum is exact mod 2^32 even where the running prefix sum
    overflows int32 (the reference's wrapping integrator)."""
    x = np.full(64, 2 ** 30, np.int32)
    x[::2] = -(2 ** 30) + 3
    got = fops.moving_average_stage(_t(x), 4, True)
    win = np.convolve(x.astype(np.int64), np.ones(4, np.int64), "valid")[1:]
    exp = (((win + 2 ** 31) % 2 ** 32) - 2 ** 31).astype(np.int32)
    exp = np.trunc(exp / 4).astype(np.int32)
    np.testing.assert_array_equal(got.numpy(), exp)


def test_dc_core_prefix_sums_hold_float32_resolution_at_a_dc_offset():
    """The fused DC removal takes its prefix sums in float64. In float32,
    as the JAX core takes them, a 2^20-sample block with a mean of 0.25
    loses ~1e-3 absolute (1e-2 at a 2^24 pull); in double width the
    output stays at float32 rounding of the float64 result."""
    from pothoscomms_tpu_torch.blocks.filter import DCRemoval

    d, casc, t = 32, 2, 1 << 20
    rng = np.random.default_rng(30)
    x = (rng.uniform(-0.5, 0.5, t) + 0.25).astype(np.float32)
    dcb = DCRemoval("float32")
    dcb.set_average_size(d)
    dcb.set_cascade_size(casc)
    carry0, step = dcb.device_core(1, device="cpu")
    _, y = step(carry0, _t(x)[None])

    def cascade(cur, cumsum):
        delayed = np.concatenate([np.zeros(d, cur.dtype), cur])[1:1 + t]
        for _ in range(casc):
            cs = cumsum(np.concatenate([np.zeros(d, cur.dtype), cur]))
            cur = (cs[d:] - cs[:-d]) / cur.dtype.type(d)
        return delayed - cur

    ref = cascade(x.astype(np.float64), np.cumsum)
    f32 = cascade(x, lambda a: np.cumsum(a, dtype=np.float32))
    assert np.max(np.abs(f32 - ref)) > 1e-4       # the JAX formulation
    assert np.max(np.abs(y[0].numpy() - ref)) < 1e-6


def test_trunc_div_truncates_toward_zero():
    a = _t(np.array([-7, -1, 7, 1, -8], np.int32))
    np.testing.assert_array_equal(fops._trunc_div(a, 4, True).numpy(),
                                  [-1, 0, 1, 0, -2])


# ---------------------------------------------------------------------- #
# envelope (tests/test_filter.py:899-924)
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("attack,release", [(4.0, 16.0), (10.0, 40.0),
                                            (1.0, 1.0)])
def test_envelope_blocked_matches_jax_and_sequential(attack, release):
    rng = np.random.default_rng(11)
    ga = np.float32(np.exp(-1.0 / attack))
    gr = np.float32(np.exp(-1.0 / release))
    W = fops.envelope_warmup(attack, release)
    assert W == jfops.envelope_warmup(attack, release) and W <= 2048
    P, T, L = 3, 1 << 15, 4096
    x = np.abs(rng.normal(size=(P, T))).astype(np.float32)
    env0 = np.abs(rng.normal(size=P)).astype(np.float32)
    yb, eb = fops.envelope_blocked(_t(x), _t(env0), ga, gr, L, W)
    ybj, ebj = jfops.envelope_blocked(jnp.asarray(x), jnp.asarray(env0),
                                      ga, gr, L, W)
    np.testing.assert_allclose(yb.numpy(), np.asarray(ybj), **ENV_TOL)
    np.testing.assert_allclose(eb.numpy(), np.asarray(ebj), **ENV_TOL)
    ys, es = fops.envelope_scan(_t(x), _t(env0), ga, gr)
    np.testing.assert_allclose(yb.numpy(), ys.numpy(), **ENV_TOL)
    np.testing.assert_allclose(eb.numpy(), es.numpy(), rtol=1e-5)
    for p in range(P):
        ysj, esj = jfops.envelope_scan(jnp.asarray(x[p]),
                                       jnp.float32(env0[p]), ga, gr)
        np.testing.assert_allclose(ys[p].numpy(), np.asarray(ysj), **ENV_TOL)
        np.testing.assert_allclose(float(es[p]), float(esj), rtol=1e-5)


def test_envelope_scan_1d_matches_jax():
    rng = np.random.default_rng(19)
    x = np.abs(rng.normal(size=777) * 3).astype(np.float32)
    ga, gr = np.float32(np.exp(-1 / 8.0)), np.float32(np.exp(-1 / 24.0))
    y, e = fops.envelope_scan(_t(x), np.float32(0.5), ga, gr)
    yj, ej = jfops.envelope_scan(jnp.asarray(x), jnp.float32(0.5), ga, gr)
    assert y.shape == (777,) and e.dim() == 0
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), **ENV_TOL)
    np.testing.assert_allclose(float(e), float(ej), rtol=1e-5)


@pytest.mark.parametrize("P,T,L,Wr", [(2, 4096, 1024, 1024),
                                      (3, 8192, 1024, 2048),
                                      (4, 600, 600, 0), (1, 96, 32, 64),
                                      (2, 0, 1, 0)])
def test_envelope_rows_plain_is_the_jax_scan(P, T, L, Wr):
    """E1's plain version: with Wr a whole number of L-blocks it is JAX
    envelope_blocked (W = Wr), with L = T, Wr = 0 JAX envelope_scan."""
    rng = np.random.default_rng(P * 1000 + T)
    ga, gr = np.float32(np.exp(-1 / 10.0)), np.float32(np.exp(-1 / 40.0))
    x = np.abs(rng.normal(size=(P, T))).astype(np.float32)
    env0 = np.abs(rng.normal(size=P)).astype(np.float32)
    y, e = envelope_rows(_t(x), _t(env0), ga, gr, L, Wr)  # CPU: the twin
    y2, e2 = envelope_rows_plain(_t(x), _t(env0), ga, gr, L, Wr)
    assert torch.equal(y, y2) and torch.equal(e, e2)
    if T == 0:
        np.testing.assert_array_equal(e.numpy(), env0)
        return
    if Wr == 0 and L == T:
        for p in range(P):
            yj, ej = jfops.envelope_scan(jnp.asarray(x[p]),
                                         jnp.float32(env0[p]), ga, gr)
            np.testing.assert_allclose(y[p].numpy(), np.asarray(yj),
                                       **ENV_TOL)
            np.testing.assert_allclose(float(e[p]), float(ej), rtol=1e-5)
    else:
        yj, ej = jfops.envelope_blocked(jnp.asarray(x), jnp.asarray(env0),
                                        ga, gr, L, Wr)
        np.testing.assert_allclose(y.numpy(), np.asarray(yj), **ENV_TOL)
        np.testing.assert_allclose(e.numpy(), np.asarray(ej), **ENV_TOL)


def test_envelope_rows_rejects_bad_shapes():
    x = torch.zeros(2, 100)
    with pytest.raises(ValueError):
        envelope_rows(x, torch.zeros(2), 0.5, 0.5, 30, 0)  # 30 ∤ 100
    with pytest.raises(ValueError):
        envelope_rows(x, torch.zeros(3), 0.5, 0.5, 100, 0)
    with pytest.raises(TypeError):
        envelope_rows(x.double(), torch.zeros(2).double(), 0.5, 0.5, 100, 0)


# ---------------------------------------------------------------------- #
# fxpt (tests/test_math.py:367-382) and cint
# ---------------------------------------------------------------------- #
def _atan2_grid():
    rng = np.random.default_rng(3)
    ys = rng.integers(-32768, 32768, 512).astype(np.int16)
    xs = rng.integers(-32768, 32768, 512).astype(np.int16)
    specials = np.array(
        [[0, 0], [1, 1], [-5, -5], [100, 0], [0, 100], [-100, 0], [0, -100],
         [-32768, -32768], [-32768, 0], [0, -32768], [32767, -32768],
         [-32768, 32767], [1, -1], [-1, 1]], dtype=np.int16)
    return (np.concatenate([ys, specials[:, 0]]),
            np.concatenate([xs, specials[:, 1]]))


def test_fxpt_atan2_bit_exact_with_jax_and_scalar_oracle():
    from tests.test_math import _fxpt_atan2_scalar

    ys, xs = _atan2_grid()
    got = fxpt.fxpt_atan2(ys, xs)
    assert got.dtype == torch.uint16
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jfxpt.fxpt_atan2(ys, xs)))
    exp = np.array([_fxpt_atan2_scalar(int(y), int(x))
                    for y, x in zip(ys, xs)], np.uint16)
    np.testing.assert_array_equal(got.numpy(), exp)


def test_q_rsqrt_bit_exact_with_jax():
    rng = np.random.default_rng(4)
    x = np.concatenate([np.abs(rng.normal(size=200)) * 10 ** rng.uniform(
        -6, 6, 200), [1.0, 4.0, 0.25, 1e-30, 3e30]]).astype(np.float32)
    got = fxpt.q_rsqrt_f32(x)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jfxpt.q_rsqrt_f32(x)))


@pytest.mark.parametrize("dt", [np.int8, np.int16, np.int32, np.int64])
def test_cint_mul_div_wrap_like_jax(dt):
    info = np.iinfo(dt)
    rng = np.random.default_rng(5)
    a = rng.integers(info.min, info.max, (300, 2), endpoint=True).astype(dt)
    b = rng.integers(info.min, info.max, (300, 2), endpoint=True).astype(dt)
    a[:4] = [[info.max, info.max], [info.min, info.min], [info.max, info.min],
             [-1, info.min]]
    b[:4] = [[info.max, -info.max], [info.min, 1], [2, info.max],
             [info.min, -1]]
    np.testing.assert_array_equal(cint.mul(_t(a), _t(b)).numpy(),
                                  np.asarray(jcint.mul(jnp.asarray(a),
                                                       jnp.asarray(b))))
    small = rng.integers(-60, 60, (300, 2)).astype(dt)
    den = rng.integers(-9, 9, (300, 2)).astype(dt)
    den[np.all(den == 0, axis=-1)] = 1
    np.testing.assert_array_equal(
        cint.div(_t(small), _t(den)).numpy(),
        np.asarray(jcint.div(jnp.asarray(small), jnp.asarray(den))))
    np.testing.assert_array_equal(cint.conj(_t(small)).numpy(),
                                  np.asarray(jcint.conj(jnp.asarray(small))))
    tiny = small // 9  # re^2 + im^2 fits every type: no NaN casts
    np.testing.assert_array_equal(
        cint.abs_int(_t(tiny), np.int32).numpy(),
        np.asarray(jcint.abs_int(jnp.asarray(tiny), np.int32)))


def test_cint_mul_int16_wraparound():
    """(300 + 300i)(300 - 300i) = 180000: wraps to 180000 - 2^16*3 in
    int16, as std::complex<int16_t> does."""
    a = _t(np.array([[300, 300]], np.int16))
    b = _t(np.array([[300, -300]], np.int16))
    got = cint.mul(a, b).numpy()
    assert got.dtype == np.int16
    np.testing.assert_array_equal(got, [[180000 - 3 * 65536, 0]])
