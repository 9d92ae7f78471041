"""BASELINE config #3 in the port — the 3:2 rational resampler with
stateful taps, the IIR filter and both designer blocks — against the JAX
package (ops/filter.py:151-327, blocks/filter.py:330-675 and :963-1446).

Inputs are explicit float32 / complex64 (or the stream dtype's) arrays
made with numpy.random.default_rng(seed). Tolerances, each with its
reason:

- operators (rational, IIR blocked) equal JAX's arrays bit for bit: the
  same float64 numpy code;
- ``rational_fir_mm`` within 1e-5 of max |y| of JAX's (float32 products
  over at most a few hundred terms, in another order), 2e-4 absolute of
  the polyphase gather (test_filter.py:961);
- ``iir_df`` within 1e-12 relative of JAX's (both float64; scipy's
  lfilter associates z[i+1] + b x - a y in another order);
- the blocked IIR within 2e-4 absolute of float64 ``iir_df``
  (test_filter.py:878) and 1e-5 of max against JAX (the block scan runs
  by doubling here, by JAX's associative scan there);
- streaming IIR blocks: float dtypes within 1e-12, integer dtypes bit for
  bit (the same truncation of the same float64 values);
- designer taps within 1e-12 of the JAX designer's (the same numpy);
- fused segments within 1e-3 absolute of the streaming run (JAX's
  tolerance in test_fusion_breadth.py).

On the CPU the K1 products run as their plain PyTorch version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal
import torch

import pothoscomms_tpu as jpkg
import pothoscomms_tpu.core.fixtures as jfix
import pothoscomms_tpu_torch as pkg
import pothoscomms_tpu_torch.core.fixtures as fix
from pothoscomms_tpu.ops import filter as jfops
from pothoscomms_tpu.parallel import compiler as jcompiler
from pothoscomms_tpu_torch.core.testing import to_complex_int
from pothoscomms_tpu_torch.ops import filter as fops
from pothoscomms_tpu_torch.parallel import compiler
from tests.test_filter import (_band_points, _bin_at, _freq_gain,
                               _power_bins, iir_oracle)

torch.set_num_threads(1)

PACKAGES = {"port": (pkg, fix), "jax": (jpkg, jfix)}
BIQUAD = [0.0676, 0.135, 0.0676, 1, -1.142, 0.412]
THRESH = 4096
RATIONAL = [(2, 3), (3, 2), (1, 4), (4, 1)]


def _on_cpu(blk):
    pkg.Topology(device="cpu")._register(blk)
    return blk


def _cplx(rng, n):
    return (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.max(np.abs(got - ref)) / np.max(np.abs(ref))


def _taps60(rng, L):
    k = 60 - (60 % L)
    return (rng.normal(size=k) + 1j * rng.normal(size=k)) / k


# ---------------------------------------------------------------------- #
# registry
# ---------------------------------------------------------------------- #
def test_config3_blocks_registered_under_jax_names():
    for path in ("/comms/iir_filter", "/blocks/iir_filter",
                 "/comms/fir_designer", "/blocks/fir_designer",
                 "/comms/iir_designer"):
        assert pkg.BlockRegistry.exists(path)
        assert jpkg.BlockRegistry.exists(path)
    assert not jpkg.BlockRegistry.exists("/blocks/iir_designer")
    assert not pkg.BlockRegistry.exists("/blocks/iir_designer")


# ---------------------------------------------------------------------- #
# rational resampler ops
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("M,L", RATIONAL)
def test_rational_operators_equal_jax(M, L):
    taps = _taps60(np.random.default_rng(M * 10 + L), L)
    t0, t1, b_in, b_out = fops.rational_fir_operators(taps, M, L)
    j0, j1, jb_in, jb_out = jfops.rational_fir_operators(taps, M, L)
    assert (b_in, b_out) == (jb_in, jb_out)
    np.testing.assert_array_equal(t0.numpy(), np.asarray(j0))
    np.testing.assert_array_equal(t1.numpy(), np.asarray(j1))


@pytest.mark.parametrize("M,L", RATIONAL)
def test_stacked_rational_operator_has_an_even_width(M, L):
    """[T1; T0] with T1's K-1 rows behind zeros up to a multiple of 32:
    N = kp + B_in is even, so K1 takes its tensor cores on the card."""
    from pothoscomms_tpu_torch.kernels.cgemm import TENSOR_CORES, variant

    taps = _taps60(np.random.default_rng(3), L)
    t0, t1, b_in, b_out = fops.rational_fir_operators(taps, M, L)
    gr, gi = fops.stack_rational_operators(t0, t1)
    k1 = t1.shape[0]
    kp = gr.shape[0] - b_in
    assert kp % fops.RATIONAL_TAIL_ROWS == 0 and k1 <= kp < k1 + 32
    assert variant(gr.shape[0], b_out) == TENSOR_CORES
    assert torch.equal(gr[: kp - k1], torch.zeros(kp - k1, b_out))
    assert torch.equal(gr[kp - k1: kp], t1[..., 0])
    assert torch.equal(gi[kp:], t0[..., 1])


@pytest.mark.parametrize("M,L", RATIONAL)
def test_rational_fir_mm_matches_jax_and_polyphase(M, L):
    """test_filter.py:927-961: two windows with history continued."""
    rng = np.random.default_rng(13 + M * 10 + L)
    taps = _taps60(rng, L)
    K = len(taps) // L
    t0, t1, b_in, b_out = fops.rational_fir_operators(taps, M, L)
    gr, gi = fops.stack_rational_operators(t0, t1)
    j0, j1, _, _ = jfops.rational_fir_operators(taps, M, L)
    phases = np.zeros((L, K), np.complex128)
    for j in range(L):
        for k in range(K):
            phases[j, k] = taps[j + k * L]
    taps_q = torch.from_numpy(
        np.stack([phases.real, phases.imag], -1).astype(np.float32))
    T = 4 * b_in
    hist = np.zeros((1, max(K - 1, 1), 2), np.float32)
    h, jh = torch.from_numpy(hist), jnp.asarray(hist)
    for _ in range(2):
        x = rng.normal(size=(1, T, 2)).astype(np.float32)
        y, h = fops.rational_fir_mm(torch.from_numpy(x), h, gr, gi, b_in,
                                    b_out)
        jy, jh = jfops.rational_fir_mm(jnp.asarray(x), jh, j0, j1, b_in,
                                       b_out)
        assert tuple(y.shape) == (1, T * L // M, 2)
        assert _rel(y.numpy(), jy) < 1e-5
        np.testing.assert_array_equal(h.numpy(), np.asarray(jh))
        xh = torch.from_numpy(np.concatenate([hist[0], x[0]]))
        y_ref = fops.polyphase_fir(xh, taps_q, M, L, K, "planar", 0)
        np.testing.assert_allclose(y[0].numpy(), y_ref.numpy(), atol=2e-4)
        hist = x[:, T - max(K - 1, 1):]


def test_rational_fir_mm_rejects_a_partial_block():
    t0, t1, b_in, b_out = fops.rational_fir_operators(np.ones(6), 2, 3)
    with pytest.raises(ValueError):
        fops.rational_fir_mm(torch.zeros(1, b_in + 2, 2),
                             torch.zeros(1, 1, 2),
                             *fops.stack_rational_operators(t0, t1), b_in,
                             b_out)


# ---------------------------------------------------------------------- #
# IIR ops
# ---------------------------------------------------------------------- #
def _ba(taps):
    half = len(taps) // 2
    b, a = np.asarray(taps[:half], float), np.asarray(taps[half:], float)
    return b / a[0], a / a[0]


@pytest.mark.parametrize("taps", [BIQUAD, [0.2, 0.3, 1.0, -0.5],
                                  [0.5, 0.1, 0.3, 0.2, 1.0, -0.3, 0.2, 0.1],
                                  [2.0, 1.0]])
@pytest.mark.parametrize("is_cplx", [False, True])
def test_iir_df_matches_jax_with_state_continued(taps, is_cplx):
    rng = np.random.default_rng(len(taps) + is_cplx)
    b, a = _ba(taps)
    order = max(len(b), len(a), 2) - 1
    sdt = np.complex128 if is_cplx else np.float64
    z, jz = np.zeros(order, sdt), jnp.zeros(order, sdt)
    for n in (300, 77):
        x = rng.normal(size=n)
        if is_cplx:
            x = x + 1j * rng.normal(size=n)
        y, z = fops.iir_df(x, b, a, z)
        jy, jz = jfops.iir_df(jnp.asarray(x), jnp.asarray(b), jnp.asarray(a),
                              jz)
        assert y.dtype == (torch.complex128 if is_cplx else torch.float64)
        assert _rel(y.numpy(), jy) < 1e-12
        np.testing.assert_allclose(z.numpy(), np.asarray(jz), rtol=1e-12,
                                   atol=1e-12 * np.max(np.abs(np.asarray(jy))))


def test_iir_df_matches_the_direct_recursion():
    rng = np.random.default_rng(5)
    x = rng.normal(size=200) + 1j * rng.normal(size=200)
    b, a = _ba(BIQUAD)
    y, _ = fops.iir_df(torch.from_numpy(x), torch.from_numpy(b),
                       torch.from_numpy(a), torch.zeros(2, dtype=torch.complex128))
    np.testing.assert_allclose(y.numpy(), iir_oracle(x, BIQUAD), atol=1e-12)


@pytest.mark.parametrize("L", [256, 128, 64, 32])
def test_iir_blocked_operators_equal_jax(L):
    b, a = _ba(BIQUAD)
    for mine, theirs in zip(fops.iir_blocked_operators(b, a, L),
                            jfops.iir_blocked_operators(b, a, L)):
        np.testing.assert_array_equal(mine, theirs)


@pytest.mark.parametrize("nb", [1, 2, 3, 768, 3072])
def test_iir_scan_powers_are_repeated_squares(nb):
    M = jfops.iir_blocked_operators(*_ba(BIQUAD), 32)[2]
    p = fops.iir_scan_powers(M, nb)
    assert p.shape == (int(np.ceil(np.log2(nb))), 2, 2)
    for j in range(p.shape[0]):
        np.testing.assert_allclose(p[j], np.linalg.matrix_power(M, 2 ** j),
                                   rtol=1e-12, atol=1e-300)


@pytest.mark.parametrize("nb", [1, 2, 5, 8, 37])
def test_iir_block_scan_matches_the_sequential_recurrence(nb):
    rng = np.random.default_rng(nb)
    M = rng.normal(size=(3, 3)) * 0.4
    u = rng.normal(size=(nb, 3, 4))
    z0 = rng.normal(size=(3, 4))
    z, want = z0, []
    for k in range(nb):
        z = M @ z + u[k]
        want.append(z)
    got = fops.iir_block_scan(torch.from_numpy(u), torch.from_numpy(z0),
                              torch.from_numpy(M),
                              torch.from_numpy(fops.iir_scan_powers(M, nb)))
    np.testing.assert_allclose(got.numpy(), np.stack(want), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("L,t", [(256, 1024), (32, 96), (64, 4096)])
def test_iir_blocked_step_matches_jax_and_iir_df(L, t):
    rng = np.random.default_rng(L + t)
    b, a = _ba(BIQUAD)
    ops = jfops.iir_blocked_operators(b, a, L)
    ops32 = [o.astype(np.float32) for o in ops]
    powers = torch.from_numpy(
        fops.iir_scan_powers(ops[2], t // L).astype(np.float32))
    P = 3
    xs = [rng.normal(size=(P, t)).astype(np.float32) for _ in range(2)]
    z = np.zeros((2, P), np.float32)
    zt, jz = torch.from_numpy(z), jnp.asarray(z)
    zref = [np.zeros(2) for _ in range(P)]
    for x in xs:
        y, zt = fops.iir_blocked_step(torch.from_numpy(x), zt,
                                      *map(torch.from_numpy, ops32), L,
                                      powers)
        jy, jz = jfops.iir_blocked_step(jnp.asarray(x), jz,
                                        *map(jnp.asarray, ops32), L)
        assert _rel(y.numpy(), jy) < 1e-5
        for p in range(P):
            yr, zr = fops.iir_df(x[p], b, a, zref[p])
            zref[p] = zr.numpy()
            np.testing.assert_allclose(y[p].numpy(), yr.numpy(), atol=2e-4)
        np.testing.assert_allclose(zt.numpy(), np.stack(zref, 1), atol=2e-4)


# ---------------------------------------------------------------------- #
# IIRFilter: the fused core
# ---------------------------------------------------------------------- #
def _iir_ref(x, taps, is_cplx, z=None):
    """float64 iir_df of one channel [t(, 2)] -> (y [t(, 2)], z)."""
    b, a = _ba(taps)
    xc = x[..., 0] + 1j * x[..., 1] if is_cplx else x
    if z is None:
        z = np.zeros(max(len(b), len(a), 2) - 1,
                     np.complex128 if is_cplx else np.float64)
    y, z = fops.iir_df(xc.astype(np.float64 if not is_cplx
                                 else np.complex128), b, a, z)
    y = y.numpy()
    return (np.stack([y.real, y.imag], -1) if is_cplx else y), z.numpy()


@pytest.mark.parametrize("dtype", ["float32", "complex_float32"])
@pytest.mark.parametrize("t", [1024, 4096, 96, 320, 50])
def test_iir_device_core_matches_jax_and_iir_df(dtype, t):
    """test_filter.py:825-924 over two quanta: t = 1024 and 4096 take
    L = 256, 96 L = 32, 320 L = 64, and 50 (no block length divides it)
    the per-sample scan."""
    is_cplx = dtype.startswith("complex")
    rng = np.random.default_rng(9 + t)
    blk = _on_cpu(pkg.BlockRegistry.make("/comms/iir_filter", dtype))
    jblk = jpkg.BlockRegistry.make("/comms/iir_filter", dtype)
    carry, step = blk.device_core(2)
    jcarry, jstep = jblk.device_core(2)
    shape = (2, t, 2) if is_cplx else (2, t)
    zs = [None, None]
    for _ in range(2):
        x = rng.normal(size=shape).astype(np.float32)
        carry, y = step(carry, torch.from_numpy(x))
        jcarry, jy = jstep(jcarry, jnp.asarray(x))
        assert y.shape == x.shape and carry.shape == jcarry.shape
        assert _rel(y.numpy(), jy) < 1e-5
        np.testing.assert_allclose(carry.numpy(), np.asarray(jcarry),
                                   atol=1e-5)
        for ch in range(2):
            yr, zs[ch] = _iir_ref(x[ch], BIQUAD, is_cplx, zs[ch])
            np.testing.assert_allclose(y[ch].numpy(), yr, atol=2e-4)


def test_iir_blocked_unstable_falls_back():
    """test_filter.py:964-978: an unstable filter overflows the blocked
    operators; the core takes the per-sample scan and stays finite."""
    blk = _on_cpu(pkg.BlockRegistry.make("/comms/iir_filter", "float32"))
    blk.set_taps([1.0, 0.0, 1.0, -2.5])  # pole at 2.5: unstable
    carry0, step = blk.device_core(1)
    x = torch.from_numpy(np.ones((1, 1024), np.float32) * 1e-3)
    z, y = step(carry0, x)
    assert np.all(np.isfinite(y.numpy()[0, :64]))
    jblk = jpkg.BlockRegistry.make("/comms/iir_filter", "float32")
    jblk.set_taps([1.0, 0.0, 1.0, -2.5])
    jc, jstep = jblk.device_core(1)
    _, jy = jstep(jc, jnp.asarray(x.numpy()))
    np.testing.assert_allclose(y.numpy()[0, :64], np.asarray(jy)[0, :64],
                               rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "complex_float32"])
def test_iir_fuse_export_import_roundtrip(dtype):
    blk = _on_cpu(pkg.BlockRegistry.make("/comms/iir_filter", dtype))
    jblk = jpkg.BlockRegistry.make("/comms/iir_filter", dtype)
    state = (np.array([0.25 - 0.5j, 1.5 + 0.125j]) if "complex" in dtype
             else np.array([0.25, -1.5]))
    blk._state = state.copy()
    jblk._state = state.copy()
    assert blk.fuse_ready() and jblk.fuse_ready()
    carry, _ = blk.fuse_export(3)
    jcarry, _ = jblk.fuse_export(3)
    np.testing.assert_array_equal(carry.numpy(), np.asarray(jcarry))
    blk._state = np.zeros_like(state)
    blk.fuse_import(carry)
    np.testing.assert_array_equal(blk._state, state)
    assert blk._state.dtype == jblk._state.dtype


def test_iir_fuse_ready_gates():
    for dtype, ready in (("float32", True), ("complex_float32", True),
                         ("float64", False), ("int16", False)):
        assert pkg.BlockRegistry.make("/comms/iir_filter",
                                      dtype).fuse_ready() == ready
    blk = pkg.BlockRegistry.make("/comms/iir_filter", "float32")
    blk.set_wait_taps(True)
    blk.activate()
    assert not blk.fuse_ready()
    blk.set_taps(BIQUAD)
    assert blk.fuse_ready()


def test_iir_set_taps_validation():
    blk = pkg.BlockRegistry.make("/comms/iir_filter", "float64")
    with pytest.raises(ValueError):
        blk.set_taps([])
    with pytest.raises(ValueError):
        blk.set_taps([1.0, 0.0])          # a0 == 0
    with pytest.raises(ValueError):
        pkg.BlockRegistry.make("/comms/iir_filter", "uint16")
    blk.set_taps([0.2, 0.3, 1.0, -0.5])
    np.testing.assert_array_equal(blk.get_taps(), [0.2, 0.3, 1.0, -0.5])


# ---------------------------------------------------------------------- #
# IIRFilter: streaming (test_filter.py:488-545)
# ---------------------------------------------------------------------- #
def _stream(which, blocks_of, dtype_in, dtype_out, feeds, fuse=False,
            threshold=THRESH, topo_hook=None):
    p, fx = PACKAGES[which]
    blocks = blocks_of(p)
    feed = fx.FeederSource(dtype_in)
    sink = fx.CollectorSink(dtype_out)
    topo = p.Topology(device="cpu") if p is pkg else p.Topology()
    topo.auto_fuse = fuse
    topo.fuse_threshold = threshold
    chain = [feed] + blocks + [sink]
    for a, b in zip(chain[:-1], chain[1:]):
        topo.connect(a, 0, b, 0)
    if topo_hook is not None:
        topo_hook(topo, blocks)
    for x in feeds:
        feed.feed_buffer(x)
    topo.commit()
    assert topo.wait_inactive(timeout=60.0)
    return sink.get_buffer(), topo, blocks


def _iir(dtype, taps=None):
    def make(p):
        blk = p.BlockRegistry.make("/comms/iir_filter", dtype)
        if taps is not None:
            blk.set_taps(taps)
        return [blk]
    return make


@pytest.mark.parametrize("dtype", ["float64", "complex_float64", "float32",
                                   "complex_float32", "int16",
                                   "complex_int16"])
@pytest.mark.parametrize("taps", [None, [0.2, 0.3, 1.0, -0.5]])
def test_iir_streaming_matches_jax(dtype, taps):
    rng = np.random.default_rng(14)
    n = 200
    if dtype == "int16":
        x = rng.integers(-3000, 3000, n).astype(np.int16)
    elif dtype == "complex_int16":
        x = to_complex_int(rng.integers(-3000, 3000, n)
                           + 1j * rng.integers(-3000, 3000, n), dtype)
    elif "complex" in dtype:
        x = _cplx(rng, n).astype(pkg.DType.parse(dtype).np)
    else:
        x = rng.normal(size=n).astype(pkg.DType.parse(dtype).np)
    feeds = [x[:77], x[77:]]
    got, _, _ = _stream("port", _iir(dtype, taps), dtype, dtype, feeds)
    exp, _, _ = _stream("jax", _iir(dtype, taps), dtype, dtype, feeds)
    assert got.dtype == exp.dtype and got.shape == exp.shape
    if "int" in dtype:
        np.testing.assert_array_equal(got, exp)
    else:
        np.testing.assert_allclose(got, exp, rtol=1e-12, atol=1e-12)
    if dtype in ("float64", "complex_float64"):
        ref = iir_oracle(x, taps or BIQUAD)
        np.testing.assert_allclose(got, ref if "complex" in dtype
                                   else ref.real, atol=1e-9)


def test_iir_wait_taps_holds_until_set_taps():
    rng = np.random.default_rng(3)
    x = rng.normal(size=64)

    def hook(topo, blocks):
        blocks[0].set_wait_taps(True)

    got, _, blocks = _stream("port", _iir("float64"), "float64", "float64",
                             [x], topo_hook=hook)
    assert got.size == 0 and blocks[0].input(0).elements() == 64


# ---------------------------------------------------------------------- #
# FIRFilter's rational fused core
# ---------------------------------------------------------------------- #
def _rational_fir(p, taps, M, L, dtype="complex_float32", taps_type="COMPLEX"):
    fir = p.BlockRegistry.make("/comms/fir_filter", dtype, taps_type)
    fir.set_taps(taps)
    fir.set_decimation(M)
    fir.set_interpolation(L)
    return fir


@pytest.mark.parametrize("M,L", RATIONAL)
def test_rational_device_core_matches_jax_with_residue(M, L):
    """The rational core against JAX's, from a carry holding K-1 history
    samples plus a residue r in [0, M) (the interior engage state)."""
    rng = np.random.default_rng(31 + M * 10 + L)
    taps = _taps60(rng, L)
    fir = _on_cpu(_rational_fir(pkg, taps, M, L))
    jfir = _rational_fir(jpkg, taps, M, L)
    _, step = fir.device_core(2)
    _, jstep = jfir.device_core(2)
    k1 = fir._K - 1
    for r in range(M):
        carry = rng.normal(size=(2, k1 + r, 2)).astype(np.float32)
        c, jc = torch.from_numpy(carry), jnp.asarray(carry)
        for _ in range(2):
            x = rng.normal(size=(2, 2 * 128 * M, 2)).astype(np.float32)
            c, y = step(c, torch.from_numpy(x))
            jc, jy = jstep(jc, jnp.asarray(x))
            assert tuple(c.shape) == (2, k1 + r, 2)
            assert _rel(y.numpy(), jy) < 1e-5
            np.testing.assert_array_equal(c.numpy(), np.asarray(jc))


def test_rational_device_core_real_stream_matches_jax():
    rng = np.random.default_rng(41)
    taps = rng.normal(size=21) / 21
    fir = _on_cpu(_rational_fir(pkg, taps, 2, 3, "float32", "REAL"))
    jfir = _rational_fir(jpkg, taps, 2, 3, "float32", "REAL")
    c, step = fir.device_core(3)
    jc, jstep = jfir.device_core(3)
    for _ in range(2):
        x = rng.normal(size=(3, 512)).astype(np.float32)
        c, y = step(c, torch.from_numpy(x))
        jc, jy = jstep(jc, jnp.asarray(x))
        assert tuple(y.shape) == (3, 768)
        assert _rel(y.numpy(), jy) < 1e-5
        np.testing.assert_array_equal(c.numpy(), np.asarray(jc))


@pytest.mark.parametrize("case", ["ready", "wait", "k1", "f64", "short",
                                  "burst"])
def test_rational_fuse_ready_matches_jax(case):
    blks = []
    for p in (pkg, jpkg):
        dtype = "complex_float64" if case == "f64" else "complex_float32"
        taps = np.ones(3) / 3 if case == "k1" else np.ones(60) / 60
        fir = _rational_fir(p, taps, 2, 3, dtype)
        n = 10 if case == "short" else 40
        fir.input(0).push_buffer(np.zeros(n, np.complex64).astype(
            fir.dtype.np))
        if case == "wait":
            fir.set_wait_taps(True)
            fir.activate()
        if case == "burst":
            fir._eob_samps_left = 5
        blks.append(fir)
    assert blks[0].fuse_ready() == blks[1].fuse_ready()
    assert blks[0].fuse_ready() == (case == "ready")


@pytest.mark.parametrize("avail", [19, 20, 21])
def test_rational_fuse_export_absorbs_the_residue(avail):
    """K-1 = 19 history samples plus residue avail - 19 < M = 2 go into
    the carry (JAX blocks/filter.py:451-455); 21 queued is backlog, so
    only the history is taken."""
    rng = np.random.default_rng(avail)
    x = _cplx(rng, avail)
    carries = []
    for p in (pkg, jpkg):
        fir = _rational_fir(p, np.ones(60) / 60, 2, 3)
        if p is pkg:
            _on_cpu(fir)
        fir.input(0).push_buffer(x)
        assert fir.fuse_retained() == (avail if avail < 21 else 19)
        carry, _ = fir.fuse_export(1)
        carries.append(np.asarray(carry))
        assert fir.input(0).elements() == avail - carry.shape[1]
    np.testing.assert_array_equal(carries[0], carries[1])
    take = avail if avail < 21 else 19
    np.testing.assert_array_equal(carries[0][0], np.stack(
        [x[:take].real, x[:take].imag], -1))


# ---------------------------------------------------------------------- #
# compile_chain: the config #3 chain
# ---------------------------------------------------------------------- #
def _config3(p, taps, M=2, L=3, iir_taps=None):
    fir = _rational_fir(p, taps, M, L)
    iir = p.BlockRegistry.make("/comms/iir_filter", "complex_float32")
    if iir_taps is not None:
        iir.set_taps(iir_taps)
    return [fir, iir]


def _config3_oracle(x, taps, M, L, iir_taps=BIQUAD):
    """float64 resampler (the polyphase sum of ops/filter.py:91-93 from a
    zero history) then scipy's lfilter from a zero state, per channel:
    (resampled, filtered) [C, T*L//M] complex."""
    K = len(taps) // L + (len(taps) % L != 0)
    b, a = _ba(iir_taps)
    xc = x[..., 0].astype(np.float64) + 1j * x[..., 1]
    res, out = [], []
    for ch in range(x.shape[0]):
        xh = np.concatenate([np.zeros(K - 1), xc[ch]])
        n = xc.shape[1] // M * L
        u = np.arange(n) * M + (M - 1)
        y = np.zeros(n, np.complex128)
        for k in range(K):
            i = u % L + k * L
            ok = i < len(taps)
            y[ok] += taps[i[ok]] * xh[u[ok] // L + (K - 1) - k]
        res.append(y)
        out.append(scipy.signal.lfilter(b, a, y))
    return np.stack(res), np.stack(out)


@pytest.mark.parametrize("T", [1024, 768])
def test_config3_compile_chain_matches_jax_and_oracle(T):
    """compile_chain([FIR 3:2, IIR]) over two steps against JAX's and the
    float64 oracle; then from a carry taken from JAX mid-stream
    (chain_carry_from_numpy). T = 1024 gives the IIR 1536 samples
    (L = 256), T = 768 gives 1152 (L = 128)."""
    rng = np.random.default_rng(T)
    taps = _taps60(rng, 3)
    C = 2
    step, carry = compiler.compile_chain(_config3(pkg, taps), C,
                                         device="cpu")
    jstep, jcarry = jcompiler.compile_chain(_config3(jpkg, taps), C)
    xs = [(rng.normal(size=(C, T, 2)) / np.sqrt(2)).astype(np.float32)
          for _ in range(2)]
    ys = []
    for x in xs:
        y, carry = step(torch.from_numpy(x), carry)
        jy, jcarry_next = jstep(jnp.asarray(x), jcarry)
        assert tuple(y.shape) == (C, T * 3 // 2, 2)
        assert _rel(y.numpy(), jy) < 1e-5
        for mine, theirs in zip(carry, jcarry_next):
            np.testing.assert_allclose(mine.numpy(), np.asarray(theirs),
                                       atol=1e-5)
        ys.append(y.numpy())
        jcarry_mid, jcarry = jcarry, jcarry_next
    _, exp = _config3_oracle(np.concatenate(xs, 1), taps, 2, 3)
    got = np.concatenate(ys, 1)
    np.testing.assert_allclose(got[..., 0] + 1j * got[..., 1], exp,
                               atol=2e-4)
    # the second step again, from the carry JAX held before it
    mid = compiler.chain_carry_from_numpy(
        tuple(np.asarray(c) for c in jcarry_mid), device="cpu")
    y2, _ = step(torch.from_numpy(xs[1]), mid)
    np.testing.assert_allclose(y2.numpy(), ys[1], atol=1e-6)


def test_rational_fir_device_core_compiles():
    """test_compiler.py:160: a 2:1 decimator halves the length."""
    taps = np.asarray([0.25, 0.5, 0.25])
    outs = []
    x = np.random.default_rng(0).normal(size=(2, 512)).astype(np.float32)
    for p, comp in ((pkg, compiler), (jpkg, jcompiler)):
        fir = p.BlockRegistry.make("/comms/fir_filter", "float32", "REAL")
        fir.set_taps(taps)
        fir.set_decimation(2)
        kw = {"device": "cpu"} if p is pkg else {}
        step, carry = comp.compile_chain([fir], channels=2, **kw)
        y, _ = step(torch.from_numpy(x) if p is pkg else jnp.asarray(x),
                    carry)
        assert tuple(y.shape) == (2, 256)
        outs.append(np.asarray(y))
    np.testing.assert_allclose(outs[0], outs[1], atol=1e-6)
    exp = np.stack([np.convolve(x[c], taps)[:512][1::2] for c in range(2)])
    np.testing.assert_allclose(outs[0], exp, atol=1e-6)


def test_fir_iir_compile_chain_real_matches_oracle():
    """test_compiler.py:55 with a 1:1 FIR in place of /comms/scale (not
    ported): FIR(31) -> FIR(7) -> IIR over [4, 512] float32, against JAX
    and a float64 numpy oracle."""
    rng = np.random.default_rng(0)
    C, T = 4, 512
    x = rng.normal(size=(C, T)).astype(np.float32)
    taps, taps2 = rng.normal(size=31) / 31, rng.normal(size=7) / 7
    iir_taps = [0.2, 0.3, 1.0, -0.4]

    def blocks(p):
        f1 = p.BlockRegistry.make("/comms/fir_filter", "float32", "REAL")
        f1.set_taps(taps)
        f2 = p.BlockRegistry.make("/comms/fir_filter", "float32", "REAL")
        f2.set_taps(taps2)
        iir = p.BlockRegistry.make("/comms/iir_filter", "float32")
        iir.set_taps(iir_taps)
        return [f1, f2, iir]

    step, carry = compiler.compile_chain(blocks(pkg), C, device="cpu")
    y, _ = compiler.run_chain_numpy(step, carry, x)
    jstep, jcarry = jcompiler.compile_chain(blocks(jpkg), C)
    jy, _ = jcompiler.run_chain_numpy(jstep, jcarry, x)
    np.testing.assert_allclose(y, jy, atol=1e-5)
    b, a = _ba(iir_taps)
    ref = np.stack([scipy.signal.lfilter(b, a, np.convolve(
        np.convolve(x[c].astype(np.float64), taps)[:T], taps2)[:T])
        for c in range(C)])
    np.testing.assert_allclose(y, ref, atol=1e-4)


# ---------------------------------------------------------------------- #
# the block API: rational FIR segments (test_fusion_breadth.py:290-380)
# ---------------------------------------------------------------------- #
def _record_residues(topo, blocks):
    """Notes the residue of every rational FIR export (carry length minus
    K-1) on the block."""
    for blk in blocks:
        if getattr(blk, "fuse_kind", None) == "fir" and blk._M > 1:
            blk.residues = []
            export = blk.fuse_export

            def noting(channels, _blk=blk, _export=export):
                carry, step = _export(channels)
                _blk.residues.append(int(np.asarray(carry).shape[1])
                                     - (_blk._K - 1))
                return carry, step

            blk.fuse_export = noting


def _fused_vs_streaming(blocks_of, feeds):
    got, topo, blocks = _stream("port", blocks_of, "complex_float32",
                                "complex_float32", feeds, fuse=True,
                                topo_hook=_record_residues)
    ref, _, _ = _stream("port", blocks_of, "complex_float32",
                        "complex_float32", feeds, fuse=False)
    jgot, jtopo, _ = _stream("jax", blocks_of, "complex_float32",
                             "complex_float32", feeds, fuse=True)
    assert sum(s.engage_count for s in topo._segments) >= 1
    assert sum(s.engage_count for s in jtopo._segments) >= 1
    n = min(len(got), len(ref))
    assert n > 0 and abs(len(got) - len(ref)) < 120
    np.testing.assert_allclose(got[:n], ref[:n], atol=1e-3)
    assert len(got) == len(jgot)
    np.testing.assert_allclose(got, jgot, atol=1e-3)
    return blocks


def test_rational_fir_heads_a_fused_segment():
    """BASELINE config #3: a 3:2 resampler heads [FIR, IIR]."""
    rng = np.random.default_rng(21)
    taps = _taps60(rng, 3)
    feeds = [_cplx(rng, 4 * THRESH), _cplx(rng, 2 * THRESH + 64)]
    blocks = _fused_vs_streaming(lambda p: _config3(p, taps), feeds)
    assert blocks[0].residues and set(blocks[0].residues) == {0}


@pytest.mark.parametrize("head", ["iir", "fir"])
@pytest.mark.parametrize("residue", [0, 1])
def test_rational_fir_interior_engages_at_residue(head, residue):
    """An interior 3:2 resampler engages at polyphase residue 0 and 1
    (test_fusion_breadth.py:329-380), behind an IIR filter or a 1:1 FIR
    in place of /comms/scale. The IIR passes every sample on; an 8-tap
    FIR keeps 7 back, so the feed sizes that give each residue differ."""
    rng = np.random.default_rng(23 + residue)
    taps = _taps60(rng, 3)
    taps1 = (rng.normal(size=8) + 1j * rng.normal(size=8)) / 8

    def blocks_of(p):
        if head == "iir":
            first = p.BlockRegistry.make("/comms/iir_filter",
                                         "complex_float32")
        else:
            first = p.BlockRegistry.make("/comms/fir_filter",
                                         "complex_float32", "COMPLEX")
            first.set_taps(taps1)
        return [first, _rational_fir(p, taps, 2, 3)]

    # residue (avail - 19) mod 2 after the first feed streams through
    odd = (residue == 0) == (head == "iir")
    feeds = [_cplx(rng, 4 * THRESH + odd), _cplx(rng, 2 * THRESH + odd)]
    blocks = _fused_vs_streaming(blocks_of, feeds)
    assert blocks[1].residues and set(blocks[1].residues) == {residue}


# ---------------------------------------------------------------------- #
# FIRDesigner (test_filter.py:391-467)
# ---------------------------------------------------------------------- #
FILTER_TYPES = ["SINC", "MAXFLAT", "GAUSSIAN", "REMEZ", "ROOT_RAISED_COSINE",
                "RAISED_COSINE"]
BAND_TYPES = ["LOW_PASS", "HIGH_PASS", "BAND_PASS", "BAND_STOP",
              "COMPLEX_BAND_PASS", "COMPLEX_BAND_STOP"]


class _Catch:
    name = "catcher"

    def __init__(self):
        self.taps = None

    def call(self, name, *args):
        self.taps = np.asarray(args[0])


def _design_fir(p, ftype, band, fs=1e6, fl=1.5e5, fu=3.0e5):
    designer = p.BlockRegistry.make("/comms/fir_designer")
    catch = _Catch()
    designer.connect_signal("tapsChanged", catch, "setTaps")
    designer.set_sample_rate(fs)
    designer.set_filter_type(ftype)
    designer.set_band_type(band)
    designer.set_frequency_lower(fl)
    designer.set_frequency_upper(fu)
    designer.set_bandwidth_trans(fs / 20)
    designer.set_num_taps(101)
    designer._active = True
    designer.recalculate()
    return catch.taps


@pytest.mark.parametrize("ftype", FILTER_TYPES)
def test_fir_designer_taps_equal_jax_and_band_masks(ftype):
    fs, fl, fu = 1e6, 1.5e5, 3.0e5
    for band in BAND_TYPES:
        raised = []
        taps = []
        for p in (pkg, jpkg):
            try:
                taps.append(_design_fir(p, ftype, band))
            except ValueError:
                raised.append(p)
        assert raised in ([], [pkg, jpkg]), f"{ftype}/{band}"
        if raised:
            continue
        np.testing.assert_allclose(taps[0], taps[1], rtol=0, atol=1e-12)
        # the band-power matrix of test_filter.py:391-440, same exclusions
        is_stop, is_high = "STOP" in band, "HIGH" in band
        if ftype == "GAUSSIAN" or (ftype == "MAXFLAT" and is_stop) or (
                "COSINE" in ftype and (is_stop or is_high)):
            continue
        bins = _power_bins(taps[0])
        for is_pass, f in _band_points(band, fs, fl, fu):
            level = bins[_bin_at(1024, fs, f)]
            if is_pass:
                assert level > -30.0, f"{ftype}/{band} PASS@{f}: {level}"
            else:
                assert level < -80.0, f"{ftype}/{band} STOP@{f}: {level}"


@pytest.mark.parametrize("window", ["rectangular", "hamming", "blackman",
                                    "kaiser", "chebyshev"])
def test_fir_designer_windows_and_gain_equal_jax(window):
    taps = []
    for p in (pkg, jpkg):
        d = p.BlockRegistry.make("/comms/fir_designer")
        catch = _Catch()
        d.connect_signal("tapsChanged", catch, "setTaps")
        d.set_window_type(window)
        d.set_window_args([6.0] if window == "kaiser" else
                          [60.0] if window == "chebyshev" else [])
        d.set_gain(2.5)
        d.set_num_taps(33)
        d.set_filter_type("SINC")
        d.set_band_type("LOW_PASS")
        d._active = True
        d.recalculate()
        taps.append(catch.taps)
    np.testing.assert_allclose(taps[0], taps[1], rtol=0, atol=1e-12)


def test_fir_designer_validation():
    """test_filter.py:442-467."""
    d = pkg.BlockRegistry.make("/comms/fir_designer")
    d._active = True
    with pytest.raises(ValueError):
        d.set_sample_rate(-1.0)
    d._samp_rate = 1.0
    with pytest.raises(ValueError):
        d.set_frequency_lower(-0.1)  # real band: must be positive
    d._freq_lower = 0.1
    d._band_type = "BAND_PASS"
    with pytest.raises(ValueError):
        d.set_num_taps(50)  # band filters need odd taps
    d._num_taps = 51
    with pytest.raises(ValueError):
        d.set_frequency_upper(0.05)  # upper <= lower
    with pytest.raises(ValueError):
        d.set_num_taps(0)
    d._num_taps = 51
    with pytest.raises(ValueError):
        d.set_frequency_lower(0.6)  # above Nyquist
    d._freq_lower = 0.1
    d._band_type = "BAND_STOP"
    d._freq_upper = 0.2
    with pytest.raises(ValueError):
        d.set_filter_type("MAXFLAT")  # no stop-band MAXFLAT prototype


def test_fir_designer_backcompat_band_as_filter_type():
    d = pkg.BlockRegistry.make("/comms/fir_designer")
    d._active = True
    d.set_frequency_lower(0.1)
    d.set_filter_type("HIGH_PASS")  # legacy: band passed as filter type
    assert d.filter_type() == "SINC"
    assert d.band_type() == "HIGH_PASS"


def test_fir_designer_inactive_setters_do_not_emit():
    d = pkg.BlockRegistry.make("/comms/fir_designer")
    catch = _Catch()
    d.connect_signal("tapsChanged", catch, "setTaps")
    d.set_num_taps(50)            # inactive: no validation, no emit
    assert catch.taps is None
    d.set_num_taps(51)
    d._active = True
    d.set_gain(0.5)
    assert catch.taps is not None and len(catch.taps) == 51


# ---------------------------------------------------------------------- #
# IIRDesigner (test_filter.py:547-600)
# ---------------------------------------------------------------------- #
def _design_iir(p, iir_type, band, order=5, fl=0.1, fu=0.2):
    d = p.BlockRegistry.make("/comms/iir_designer")
    catch = _Catch()
    d.connect_signal("tapsChanged", catch, "setTaps")
    d._active = True
    d.set_iir_type(iir_type)
    d.set_filter_type(band)
    d.set_sample_rate(1.0)
    d.set_order(order)
    d.set_frequency_lower(fl)
    d.set_frequency_upper(fu)
    return catch.taps


@pytest.mark.parametrize("iir_type", ["butterworth", "chebyshev",
                                      "chebyshev2", "elliptic"])
def test_iir_designer_taps_equal_jax(iir_type):
    for band in ("LOW_PASS", "HIGH_PASS", "BAND_PASS", "BAND_STOP"):
        order = 3 if "BAND" in band else 5
        mine = _design_iir(pkg, iir_type, band, order)
        theirs = _design_iir(jpkg, iir_type, band, order)
        assert mine.shape == theirs.shape
        np.testing.assert_allclose(mine, theirs, rtol=0, atol=1e-12)


@pytest.mark.parametrize("iir_type", ["butterworth", "chebyshev",
                                      "chebyshev2", "elliptic"])
def test_iir_designer_lowpass_properties(iir_type):
    taps = _design_iir(pkg, iir_type, "LOW_PASS")
    half = len(taps) // 2
    b, a = taps[:half], taps[half:]
    # DC gain ~ 1 (within passband ripple), deep stopband at 0.4
    assert 10 ** (-0.2 / 20) < _freq_gain(b, a, 1e-6) < 1.01
    assert _freq_gain(b, a, 0.4) < 10 ** (-40 / 20)
    assert np.max(np.abs(np.roots(a))) < 1.0


def test_iir_designer_bandpass():
    taps = _design_iir(pkg, "butterworth", "BAND_PASS", 3)
    half = len(taps) // 2
    b, a = taps[:half], taps[half:]
    assert _freq_gain(b, a, 0.15) > 0.7  # center
    assert _freq_gain(b, a, 0.02) < 0.1  # below band
    assert _freq_gain(b, a, 0.35) < 0.1  # above band
    assert np.max(np.abs(np.roots(a))) < 1.0


def test_iir_designer_validation_and_camel_names():
    d = pkg.BlockRegistry.make("/comms/iir_designer")
    d._active = True
    with pytest.raises(ValueError):
        d.set_order(0)
    d._order = 2
    with pytest.raises(ValueError):
        d.set_frequency_lower(0.6)   # above Nyquist
    d._freq_lower = 0.1
    d._filter_type = "BAND_PASS"
    with pytest.raises(ValueError):
        d.set_frequency_upper(0.1005)  # bandwidth below 0.001
    d._freq_upper = 0.2
    d.setIIRType("elliptic")
    assert d.IIRType() == d.iir_type() == "elliptic"


# ---------------------------------------------------------------------- #
# designers wired to the filters: tapsChanged -> setTaps
# ---------------------------------------------------------------------- #
def test_designers_drive_the_config3_topology_like_jax():
    """FIRDesigner -> FIR(3:2) and IIRDesigner -> IIR through the
    topology's signal edges, the segment fused, against the JAX topology
    on the same feed."""
    rng = np.random.default_rng(51)
    x = _cplx(rng, 6 * THRESH + 11)
    outs = []
    for which in ("port", "jax"):
        p, fx = PACKAGES[which]
        fird = p.BlockRegistry.make("/comms/fir_designer")
        fird.set_band_type("LOW_PASS")
        fird.set_filter_type("SINC")
        fird.set_sample_rate(1.0)
        fird.set_frequency_lower(0.2)
        fird.set_num_taps(61)
        iird = p.BlockRegistry.make("/comms/iir_designer")
        iird.set_order(4)
        iird.set_frequency_lower(0.25)
        fir = _rational_fir(p, [1.0], 2, 3)
        fir.set_wait_taps(True)
        iir = p.BlockRegistry.make("/comms/iir_filter", "complex_float32")
        iir.set_wait_taps(True)
        feed = fx.FeederSource("complex_float32")
        sink = fx.CollectorSink("complex_float32")
        topo = p.Topology(device="cpu") if p is pkg else p.Topology()
        topo.fuse_threshold = THRESH
        topo.connect(fird, "tapsChanged", fir, "setTaps")
        topo.connect(iird, "tapsChanged", iir, "setTaps")
        for a, b in ((feed, fir), (fir, iir), (iir, sink)):
            topo.connect(a, 0, b, 0)
        feed.feed_buffer(x)
        topo.commit()
        assert topo.wait_inactive(timeout=60.0)
        assert len(fir.get_taps()) == 61 and len(iir.get_taps()) == 10
        if p is pkg:
            assert topo._segments[0].engage_count >= 1
        outs.append(sink.get_buffer())
    assert outs[0].shape == outs[1].shape and len(outs[0]) > 0
    np.testing.assert_allclose(outs[0], outs[1], atol=1e-3)
