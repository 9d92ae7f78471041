"""I1, the DF-II-T IIR kernel (``kernels/iir_df2t.py``, ``csrc/iir_df2t.cu``):
its contract (``fits``, ``plan``, ``tables``, ``takes``), its plain version
against scipy's ``lfilter``, a float64 emulation of the kernel's tile,
chunk and scan algorithm on its own tables, the refusal of taps on which
that algorithm strays (``stray``: elliptic low-passes of order 7 and 8),
and the choice ``IIRFilter``'s fused core makes, complex and real: I1
where ``iir_df2t.engages``, the blocked form and the per-sample fallback
where it does not.

The card tests hold I1 against its plain version and ``lfilter`` at the
resampler bank's launch ([256, 196608, 2], the elliptic order-6 low-pass
of ``benchmark/configs/resampler_fir99_3to2_ellip6``), at [16, 768, 2]
and at a real [64, 4099] row, run the cell's ``compile_chain`` step, a
real float32 chain, and elliptic order-7 and order-8 chains (the blocked
form, not I1). They skip without a card. The file imports no JAX; on a
card:

    python -m pytest tests/test_torch_iir_df2t.py --noconftest -q

Tolerances: against ``lfilter`` with the float64 taps, 3e-5 of max |y|
(the cell's ``out_err`` limit): the recurrence's taps rounded to float32
move this filter's output ~5e-6 within a chunk, the scan's float32 maps
~2e-6 more. The emulation on I1's tables: 1e-5 (``iir_df2t.STRAY``, which
the kernel refuses taps past), the state 1e-6 where the row ends a chunk;
on tables kept in float64: 1e-10 (the algorithm is exact).
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import scipy.signal
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import pothoscomms_tpu_torch as pkg
from pothoscomms_tpu_torch.blocks import filter as filter_mod
from pothoscomms_tpu_torch.blocks.filter import IIRFilter
from pothoscomms_tpu_torch.kernels import iir_df2t as i1
from pothoscomms_tpu_torch.ops import filter as fops
from pothoscomms_tpu_torch.parallel import compiler

torch.set_num_threads(1)

TOL = 3e-5
BIQUAD = (np.array([0.0676, 0.135, 0.0676]), np.array([1.0, -1.142, 0.412]))


def ellip(order):
    """The resampler cell's elliptic low-pass at ``order``, normalised."""
    b, a = scipy.signal.ellip(order, 0.1, 60, 0.3)
    return b / a[0], a / a[0]


def taps(order):
    """Order 2: the block's default biquad; 6: the cell's elliptic
    low-pass; any other order a Butterworth low-pass at half Nyquist
    (well conditioned in float32, so the plain version's per-sample
    recursion, float32 on float32 taps, holds TOL at every order; the
    elliptic designs of every order are held in the tests of ``stray``
    and of the core's choice)."""
    if order == 2:
        return BIQUAD
    if order == 6:
        return ellip(6)
    return scipy.signal.butter(order, 0.5)


def lfilter_rows(x, z, b, a):
    """scipy's float64 ``lfilter`` over every row and plane of x [R, T,
    W] from z [O, R, W]: (y, z_final) as float64 arrays."""
    x, z = np.asarray(x, np.float64), np.asarray(z, np.float64)
    y, zf = np.empty_like(x), np.empty_like(z)
    for r in range(x.shape[0]):
        for p in range(x.shape[2]):
            y[r, :, p], zf[:, r, p] = scipy.signal.lfilter(
                b, a, x[r, :, p], zi=z[:, r, p])
    return y, zf


def rel(got, exp):
    got, exp = np.asarray(got, np.float64), np.asarray(exp, np.float64)
    return np.max(np.abs(got - exp)) / np.max(np.abs(exp))


def emulate(x, z, coef, order, chunk, threads, seg_tiles=0):
    """The kernel's algorithm in float64 on the table ``coef``: each tile
    of ``threads`` chunks of ``chunk`` samples, zero-filled past the row;
    each chunk's zero-state end state s = G x; the carried state joined
    to chunk 0 (w_0 += P_0 z) and a Hillis-Steele scan w_k += P_r w_{k-d};
    each chunk re-run by the recurrence from its start state (the state
    carried in, then w_{k-1}); the next tile's state that of the tile's
    last sample: the scan's w_k where it ends chunk k, else the
    recurrence's. With ``seg_tiles``, a row in segments of that many
    tiles: each segment's end state from a zero state first, then each
    segment from z <- A^(segment) z + end over the earlier ones."""
    coef = np.asarray(coef, np.float64)
    o1 = order + 1
    b, na = coef[:o1], coef[o1:2 * o1]
    G = coef[2 * o1:2 * o1 + order * chunk].reshape(order, chunk)
    P = coef[2 * o1 + order * chunk:].reshape(i1.ROUNDS + 1, order,
                                              order)
    R, T, W = x.shape
    tile = threads * chunk
    y = np.zeros((R, T, W))
    zout = np.zeros((order, R, W))

    def run(r, zc, t_lo, t_hi):
        for t0 in range(t_lo, t_hi, tile):
            n = min(tile, T - t0)
            xt = np.zeros((tile, W))
            xt[:n] = x[r, t0:t0 + n]
            xc = xt.reshape(threads, chunk, W)
            w = np.einsum("oj,kjw->kow", G, xc)
            w[0] += P[0] @ zc
            rnd = 0
            while (1 << rnd) < threads:
                d = 1 << rnd
                w[d:] = w[d:] + np.einsum("om,kmw->kow", P[rnd], w[:-d])
                rnd += 1
            starts = np.concatenate([zc[None], w[:-1]])
            for k in range(-(-n // chunk)):
                zs = starts[k].copy()
                for j in range(min(chunk, n - k * chunk)):
                    xv = xc[k, j]
                    yv = b[0] * xv + zs[0]
                    zs = np.concatenate([zs[1:], np.zeros((1, W))]) \
                        + b[1:, None] * xv + na[1:, None] * yv
                    y[r, t0 + k * chunk + j] = yv
            zc = w[k] if n % chunk == 0 else zs
        return zc

    seg = (seg_tiles or -(-T // tile)) * tile
    for r in range(R):
        bounds = [(lo, min(T, lo + seg)) for lo in range(0, T, seg)]
        ends = [run(r, np.zeros((order, W)), lo, hi)
                for lo, hi in bounds[:-1]]
        for s, (lo, hi) in enumerate(bounds):
            zc = np.asarray(z[:, r], np.float64)
            for e in ends[:s]:
                zc = P[-1] @ zc + e
            zc = run(r, zc, lo, hi)
        zout[:, r] = zc
    return y, zout


# ---------------------------------------------------------------------- #
# the contract
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("width", [1, 2])
@pytest.mark.parametrize("order", range(1, i1.MAX_ORDER + 1))
@pytest.mark.parametrize("t", [1, 7, i1.CHUNK + 1, 4095, 4097, 196608,
                               3 * 4096 - 5])
def test_fits_and_plan_contract(t, order, width):
    """Every order up to the maximum at T = 1, odd T, T no multiple of the
    chunk or of a tile, at 1, 16 and 256 rows on 132 SMs: tiles of 128
    chunks of 32 samples (whole 16 bytes), ceil(T / tile) tiles whose
    last holds 1..tile samples (a shorter last chunk, threads past it
    idle), and shared memory that keeps two blocks on an SM, as
    csrc/iir_df2t.cu counts it. A row is cut into segments, none empty,
    only where the rows leave the card's 264 block places unfilled, and
    then into no more than fill them."""
    assert i1.fits(order, t)
    assert i1.CHUNK % 4 == 0 and 1 << i1.ROUNDS == i1.THREADS
    for rows in (1, 16, 256):
        p = i1.plan(order, t, width, rows, 132)
        assert p.tile == i1.THREADS * i1.CHUNK == i1.TILE
        assert p.ntiles == -(-t // p.tile)
        last = t - (p.ntiles - 1) * p.tile
        assert 1 <= last <= p.tile
        ow = order * width
        assert p.smem == 4 * (i1.SLOTS * i1.THREADS * (i1.CHUNK * width + 4)
                              + 2 * ow * i1.THREADS + -(-ow // 4) * 4)
        assert 2 * (p.smem + 1024) <= 233472  # two blocks on an SM
        assert (p.segs - 1) * p.seg_tiles < p.ntiles <= p.segs * p.seg_tiles
        assert p.segs == 1 or rows * p.segs <= 2 * 132
        assert (p.segs > 1) == (rows < 132 and p.ntiles > 1)


@pytest.mark.parametrize("order, t", [(0, 100), (i1.MAX_ORDER + 1, 100),
                                      (6, 0), (6, 1 << 30)])
def test_fits_refuses_outside(order, t):
    assert not i1.fits(order, t)
    with pytest.raises(ValueError):
        i1.plan(order, t, 2)


@pytest.mark.parametrize("order", range(1, i1.MAX_ORDER + 1))
def test_tables_layout(order):
    """b, -a rounded to float32, G [O, chunk], the scan's ROUNDS powers
    (A^chunk)^(2^r) and A^(segment), zero without segments, computed in
    float64 from the taps and rounded; None for an unstable filter and
    for one on which the kernel strays."""
    b, a = taps(order)
    seg_len = 12 * 4096
    coef = i1.tables(b, a, seg_len)
    o1 = order + 1
    assert coef.dtype == np.float32
    assert coef.size == 2 * o1 + order * i1.CHUNK \
        + (i1.ROUNDS + 1) * order * order
    assert np.array_equal(coef[:o1], np.float32(b))
    assert np.array_equal(coef[o1:2 * o1], -np.float32(a))
    _, _, m, g = fops.iir_blocked_operators(b, a, i1.CHUNK)
    np.testing.assert_array_equal(
        coef[2 * o1:2 * o1 + order * i1.CHUNK], g.ravel().astype(np.float32))
    p = coef[2 * o1 + order * i1.CHUNK:].reshape(i1.ROUNDS + 1, order,
                                                 order)
    np.testing.assert_array_equal(
        p[:-1], fops.iir_scan_powers(m, i1.THREADS).astype(np.float32))
    np.testing.assert_array_equal(p[-1], np.linalg.matrix_power(
        m, seg_len // i1.CHUNK).astype(np.float32))
    assert not i1.tables(b, a)[-order * order:].any()
    assert i1.tables([1.0, 0.0], [1.0, -2.5]) is None
    assert i1.tables(*ellip(8), seg_len) is None


@pytest.mark.parametrize("t, w, order, seg_tiles", [
    (4096 + 37, 2, 6, 0), (1, 2, 6, 0), (4099, 1, 6, 0), (2 * 4096, 2, 2, 0),
    (3 * 4096, 2, 6, 0), (300, 2, i1.MAX_ORDER, 0), (5 * 4096 + 37, 2, 6, 2),
    (4 * 4096, 1, 6, 1)])
def test_emulated_kernel_matches_lfilter(t, w, order, seg_tiles):
    """The kernel's algorithm (``emulate``) at the plan's threads and
    chunk, from a nonzero state, against ``lfilter``: exact on tables kept
    in float64; on I1's tables (the taps and maps rounded to float32)
    within 1e-5, outputs and state, and the state within 1e-6 where the
    row ends a chunk (the scan's, not the recurrence's on rounded taps);
    in one row or in segments of ``seg_tiles`` tiles."""
    b, a = taps(order)
    rng = np.random.default_rng(t + order)
    x = rng.normal(size=(2, t, w))
    z = 0.1 * rng.normal(size=(order, 2, w))
    ye, ze = lfilter_rows(x, z, b, a)
    seg_len = seg_tiles * i1.THREADS * i1.CHUNK
    _, _, m, g = fops.iir_blocked_operators(b, a, i1.CHUNK)
    p = np.zeros((i1.ROUNDS + 1, order, order))
    p[:-1] = fops.iir_scan_powers(m, i1.THREADS)
    if seg_len:
        p[-1] = np.linalg.matrix_power(m, seg_len // i1.CHUNK)
    exact = np.concatenate([b, -a, g.ravel(), p.ravel()])
    for coef, tol in ((exact, 1e-10), (i1.tables(b, a, seg_len), 1e-5)):
        y, zf = emulate(x, z, coef, order, i1.CHUNK, i1.THREADS, seg_tiles)
        assert rel(y, ye) < tol
        assert rel(zf, ze) < (tol if t % i1.CHUNK else min(tol, 1e-6))


@pytest.mark.parametrize("t", [3 * 4096, 2 * 4096 + 17, 50])
def test_library_emulation_is_the_tests(t):
    """``iir_df2t.emulate`` (vectorised over a tile's chunks, what
    ``stray`` runs) computes what this file's ``emulate`` does, sample by
    sample, on I1's tables: outputs and end state, whole chunks and a
    ragged end."""
    b, a = ellip(6)
    rng = np.random.default_rng(t)
    x = rng.normal(size=t)
    z = 0.1 * rng.normal(size=6)
    coef = i1.tables(b, a)
    y, zf = i1.emulate(x, z, coef)
    ye, ze = emulate(x[None, :, None], z[:, None, None], coef, 6, i1.CHUNK,
                     i1.THREADS)
    np.testing.assert_allclose(y, ye[0, :, 0], rtol=0, atol=1e-12)
    np.testing.assert_allclose(zf, ze[:, 0, 0], rtol=0, atol=1e-12)


@pytest.mark.parametrize("order", range(1, i1.MAX_ORDER + 1))
def test_stray_refuses_high_order_elliptic_taps(order):
    """The resampler cell's elliptic design at every order: the kernel's
    algorithm on its float32 tables (``stray``) stays within STRAY of
    ``lfilter`` up to order 6 and strays past it at 7 and 8 (the rounded
    scan powers and taps of a direct form with clustered poles), where
    ``tables`` refuses; and ``stray`` foretells what the algorithm does
    on other signals: this file's emulation, from a nonzero state over a
    ragged row (3 seeds), keeps its output within STRAY of ``lfilter``
    where the taps are taken, and its end state within 2 STRAY (over a
    ragged chunk the state is the recurrence's on float32 taps, which
    for the order-6 design reads up to 1.3e-5 of max |z|, as a float32
    sequential DF-II-T's does); where they are refused, output or state
    departs by more than STRAY."""
    b, a = ellip(order)
    e = i1.stray(b, a)
    takes = order <= 6
    assert (e <= i1.STRAY) == takes
    assert (i1.tables(b, a) is not None) == takes
    coef = i1._tables(tuple(b), tuple(a), 0)
    for seed in range(3):
        rng = np.random.default_rng(100 + order + 10 * seed)
        x = rng.normal(size=(1, 4096 + 1001, 1))
        z = 0.1 * rng.normal(size=(order, 1, 1))
        ye, ze = lfilter_rows(x, z, b, a)
        y, zf = emulate(x, z, coef, order, i1.CHUNK, i1.THREADS)
        if takes:
            assert rel(y, ye) < i1.STRAY and rel(zf, ze) < 2 * i1.STRAY
        else:
            assert max(rel(y, ye), rel(zf, ze)) > i1.STRAY


def test_stray_refuses_what_overflows():
    assert i1.stray([1.0, 0.0], [1.0, -2.5]) == float("inf")
    assert i1.stray(*BIQUAD) < i1.STRAY


# ---------------------------------------------------------------------- #
# the plain version
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("t", [512, 100])
@pytest.mark.parametrize("order", [1, 2, 6, i1.MAX_ORDER])
@pytest.mark.parametrize("w", [2, 1])
def test_plain_matches_lfilter_over_three_steps(w, order, t):
    """Complex and real rows, the state carried over 3 steps; T = 512
    takes the blocked form (block 256), T = 100 the recursion sample by
    sample (no block length divides it)."""
    b, a = taps(order)
    rng = np.random.default_rng(10 * order + w)
    x = rng.normal(size=(3, 3 * t, w)).astype(np.float32)
    z = (0.1 * rng.normal(size=(order, 3, w))).astype(np.float32)
    ye, ze = lfilter_rows(x, z, b, a)
    blocked = dict(fops.iir_blocked_step.by_shape)
    zt, ys = torch.from_numpy(z), []
    for s in range(3):
        y, zt = i1.iir_df2t(torch.from_numpy(x[:, s * t:(s + 1) * t].copy()),
                            zt, b, a)
        assert y.shape == (3, t, w) and zt.shape == z.shape
        ys.append(y)
    took_blocked = dict(fops.iir_blocked_step.by_shape) != blocked
    assert took_blocked == (t == 512)
    assert rel(torch.cat(ys, dim=1).numpy(), ye) < TOL
    assert rel(zt.numpy(), ze) < TOL


def test_wrapper_refuses_what_the_kernel_does_not_take():
    b, a = ellip(6)
    x, z = torch.zeros(2, 64, 2), torch.zeros(6, 2, 2)
    i1.iir_df2t(x, z, b, a)
    for bad in (lambda: i1.iir_df2t(torch.zeros(2, 64, 3), z, b, a),
                lambda: i1.iir_df2t(x, torch.zeros(6, 2, 1), b, a),
                lambda: i1.iir_df2t(x, z, b[:3], a),
                lambda: i1.iir_df2t(x, z, b, 2 * a),
                lambda: i1.iir_df2t(x[:, ::2], z, b, a),
                lambda: i1.iir_df2t(x, z[:5].contiguous(), b, a)):
        with pytest.raises(ValueError):
            bad()
    with pytest.raises(TypeError):
        i1.iir_df2t(x.double(), z.double(), b, a)
    with pytest.raises(ValueError):
        i1.iir_df2t(x.to("meta"), z.to("meta"), b, a)


# ---------------------------------------------------------------------- #
# the core's choice
# ---------------------------------------------------------------------- #
def _core(dtype, b, a, channels=2):
    blk = pkg.BlockRegistry.make("/comms/iir_filter", dtype)
    blk.set_taps(np.concatenate([b, a]))
    return compiler.compile_chain([blk], channels, device="cpu")


def on_a_card(x, b, a):
    """``iir_df2t.engages`` as it decides on a card of 132 SMs: the real
    ``takes`` on x's shape."""
    return i1.takes(tuple(x.shape), b, a, 132)


def test_core_takes_no_i1_on_the_cpu():
    """``engages`` holds only on a card: on the CPU the core keeps the
    blocked form and the fallback, whatever the shape."""
    b, a = ellip(6)
    assert not i1.engages(torch.zeros(2, 512, 2), np.float32(b),
                          np.float32(a))
    assert not i1.engages(torch.zeros(2, 512), b, a)
    step, carry = _core("complex_float32", b, a)
    blocked = dict(fops.iir_blocked_step.by_shape)
    step(torch.zeros(2, 512, 2), carry)
    assert dict(fops.iir_blocked_step.by_shape) != blocked


@pytest.mark.parametrize("dtype", ["complex_float32", "float32"])
@pytest.mark.parametrize("order, t, expect", [
    (6, 512, "i1"), (6, 100, "i1"), (2, 1, "i1"),
    (i1.MAX_ORDER + 1, 512, "blocked"), (i1.MAX_ORDER + 1, 100, "fallback")])
def test_core_choice(monkeypatch, dtype, order, t, expect):
    """With ``engages`` as on a card (no device test), the core runs I1's
    wrapper wherever ``fits`` holds, with no blocked step and no fallback
    counted, and gives what the blocked core gives; past the largest
    order it keeps the blocked form where a block length divides T, else
    the counted per-sample fallback."""
    b, a = taps(order)
    calls = []
    wrapper = i1.iir_df2t

    def recorded(x, z, b_, a_):
        calls.append((tuple(x.shape), tuple(z.shape), len(b_)))
        return wrapper(x, z, b_, a_)

    monkeypatch.setattr(filter_mod, "i1_engages", on_a_card)
    monkeypatch.setattr(filter_mod, "iir_df2t", recorded)
    is_cplx = dtype.startswith("complex")
    rng = np.random.default_rng(order + t)
    shape = (2, t, 2) if is_cplx else (2, t)
    xs = [torch.from_numpy(rng.normal(size=shape).astype(np.float32))
          for _ in range(2)]
    step, carry = _core(dtype, b, a)
    before = (IIRFilter.fallback_steps, dict(fops.iir_blocked_step.by_shape))
    ys = []
    for x in xs:
        y, carry = step(x, carry)
        ys.append(y)
    took = {"i1": bool(calls),
            "fallback": IIRFilter.fallback_steps != before[0],
            "blocked": dict(fops.iir_blocked_step.by_shape) != before[1]}
    assert took == {k: k == expect or (expect == "i1" and k == "blocked"
                                       and t == 512) for k in took}
    if expect == "i1":
        w = 2 if is_cplx else 1
        assert calls == [((2, t, w), (order, 2, w), order + 1)] * 2
    x = torch.cat(xs, dim=1).double().numpy()
    xc = x[..., 0] + 1j * x[..., 1] if is_cplx else x
    exp = scipy.signal.lfilter(b, a, xc, axis=1)
    got = torch.cat(ys, dim=1).double().numpy()
    got = got[..., 0] + 1j * got[..., 1] if is_cplx else got
    assert np.max(np.abs(got - exp)) / np.max(np.abs(exp)) < TOL


@pytest.mark.parametrize("t", [4099, 512, 1, 3 * 4096 * 40 + 32])
def test_takes_real_rows_of_two_axes(t):
    """``takes`` plans a real row given as [R, T] as the one plane of
    [R, T, 1]: what the real core's step holds before it adds the plane
    axis. Rows in segments included (the last T, on 2 rows)."""
    b, a = ellip(6)
    for rows in (64, 2):
        assert i1.takes((rows, t), b, a, 132)
        assert i1.takes((rows, t), b, a, 132) == i1.takes((rows, t, 1), b,
                                                        a, 132)
        assert i1._segment((rows, t), 6, 132) == i1._segment((rows, t, 1),
                                                             6, 132)
    assert not i1.takes((64, t), *ellip(8), 132)


@pytest.mark.parametrize("dtype", ["float32", "complex_float32"])
def test_core_asks_engages_with_the_plane_axis(monkeypatch, dtype):
    """The core asks ``engages`` (the real one, past its device check)
    with rows [R, T, W], W = 1 for a real stream, and hands I1 the same
    rows."""
    b, a = ellip(6)
    asked, calls = [], []
    wrapper = i1.iir_df2t

    def engages(x, b_, a_):
        asked.append(tuple(x.shape))
        return i1.takes(tuple(x.shape), b_, a_, 132)

    def recorded(x, z, b_, a_):
        calls.append(tuple(x.shape))
        return wrapper(x, z, b_, a_)

    monkeypatch.setattr(filter_mod, "i1_engages", engages)
    monkeypatch.setattr(filter_mod, "iir_df2t", recorded)
    is_cplx = dtype.startswith("complex")
    step, carry = _core(dtype, b, a, channels=3)
    x = torch.randn((3, 4099, 2) if is_cplx else (3, 4099))
    y, carry = step(x, carry)
    w = 2 if is_cplx else 1
    assert asked == calls == [(3, 4099, w)]
    assert y.shape == x.shape
    assert carry[0].shape == ((6, 3, 2) if is_cplx else (6, 3))


@pytest.mark.parametrize("dtype", ["complex_float32", "float32"])
@pytest.mark.parametrize("order", [6, 7, 8])
def test_core_keeps_the_blocked_form_for_high_order_elliptic_taps(
        monkeypatch, dtype, order):
    """The resampler cell's elliptic design at orders 6, 7 and 8 through
    the core with ``engages`` as on a card: I1's wrapper at order 6; at
    7 and 8, where I1 strays, the blocked form; each within TOL of
    ``lfilter`` over two steps."""
    b, a = ellip(order)
    calls = []
    wrapper = i1.iir_df2t

    def recorded(x, z, b_, a_):
        calls.append(tuple(x.shape))
        return wrapper(x, z, b_, a_)

    monkeypatch.setattr(filter_mod, "i1_engages", on_a_card)
    monkeypatch.setattr(filter_mod, "iir_df2t", recorded)
    is_cplx = dtype.startswith("complex")
    rng = np.random.default_rng(order)
    shape = (2, 1024, 2) if is_cplx else (2, 1024)
    xs = [torch.from_numpy(rng.normal(size=shape).astype(np.float32))
          for _ in range(2)]
    step, carry = _core(dtype, b, a)
    before = dict(fops.iir_blocked_step.by_shape)
    ys = []
    for x in xs:
        y, carry = step(x, carry)
        ys.append(y)
    # on the CPU I1's wrapper runs its plain version, the blocked form
    assert bool(calls) == (order == 6)
    assert dict(fops.iir_blocked_step.by_shape) != before
    x = torch.cat(xs, dim=1).double().numpy()
    xc = x[..., 0] + 1j * x[..., 1] if is_cplx else x
    exp = scipy.signal.lfilter(b, a, xc, axis=1)
    got = torch.cat(ys, dim=1).double().numpy()
    got = got[..., 0] + 1j * got[..., 1] if is_cplx else got
    assert np.max(np.abs(got - exp)) / np.max(np.abs(exp)) < TOL


def test_core_falls_back_for_an_unstable_filter(monkeypatch):
    """An unstable filter overflows I1's tables: the core does not take
    I1, and the blocked operators overflow too, so it takes the counted
    per-sample fallback."""
    monkeypatch.setattr(filter_mod, "i1_engages", on_a_card)
    b, a = np.array([1.0, 0.0]), np.array([1.0, -2.5])
    step, carry = _core("float32", b, a, channels=1)
    before = IIRFilter.fallback_steps
    y, _ = step(torch.full((1, 1024), 1e-3), carry)
    assert IIRFilter.fallback_steps == before + 1
    assert np.all(np.isfinite(y.numpy()[0, :64]))


# ---------------------------------------------------------------------- #
# on the card
# ---------------------------------------------------------------------- #
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (I1 has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("r, t, w", [(256, 196608, 2), (16, 768, 2),
                                     (64, 4099, 1), (1, (1 << 22) + 256, 2),
                                     (2, 3 * 4096 * 40 + 32, 1)])
def test_card_i1_matches_plain_and_lfilter(card, r, t, w):
    """I1 against its plain version on the card and against ``lfilter``
    (up to 4 rows), outputs and states, from a nonzero state, one call:
    one launch, two where the rows are cut into segments (the last three
    shapes)."""
    b, a = ellip(6)
    g = torch.Generator(device=card).manual_seed(r + t)
    x = torch.randn((r, t, w), generator=g, device=card)
    z = 0.1 * torch.randn((6, r, w), generator=g, device=card)
    before = i1.iir_df2t.launches
    y, zo = i1.iir_df2t(x, z, b, a)
    segs = i1.plan(6, t, w, r, i1._sms(card)).segs
    assert i1.iir_df2t.launches == before + (2 if segs > 1 else 1)
    yp, zp = i1.iir_df2t_plain(x, z, b, a)
    torch.cuda.synchronize()
    assert rel(y.cpu(), yp.cpu()) < TOL
    assert rel(zo.cpu(), zp.cpu()) < TOL
    rows = sorted({0, r // 2, r - 1})
    ye, ze = lfilter_rows(x[rows].cpu().numpy(), z[:, rows].cpu().numpy(),
                          b, a)
    assert rel(y[rows].cpu(), ye) < TOL
    assert rel(zo[:, rows].cpu(), ze) < TOL


def _load(path: Path):
    spec = importlib.util.spec_from_file_location(
        "_iir_df2t_" + path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.cuda
def test_card_cell_step_launches_i1_once_a_step(card):
    """The resampler cell's ``compile_chain`` step at its size: one I1
    launch a step, its span ``pc.kernel.iir_df2t`` inside
    ``pc.chain.IIRFilter``, no blocked step and no fallback, each step
    within the cell's limits of the benchmark's plain reference."""
    bench = Path(__file__).resolve().parents[1] / "benchmark"
    name = "resampler_fir99_3to2_ellip6"
    cfg = json.loads((bench / "configs" / f"{name}.json").read_text())
    ref = _load(bench / "reference" / f"{name}.py")
    mod = _load(bench / "configs" / f"{name}.py")
    wts = mod.weights(cfg, 3000000019)
    C, T = cfg["channels"], cfg["samples_per_step"]
    step, carry = mod.step_entry(cfg, wts, C, T, card)
    g = torch.Generator(device=card).manual_seed(5)
    before = (i1.iir_df2t.launches, IIRFilter.fallback_steps,
              dict(fops.iir_blocked_step.by_shape))
    prev = None
    for s in range(1, 3):
        x = torch.randn((C, T, 2), generator=g, device=card)
        y, carry = step(x, carry)
        torch.cuda.synchronize()
        assert i1.iir_df2t.launches == before[0] + s
        assert ref.check_step(cfg, wts, prev, x, y)["out_err"] \
            < cfg["limits"]["out_err"]
        got = ref.check_carry(cfg, wts, x, carry)
        assert got["carry_err"] == 0.0
        assert got["state_err"] < cfg["limits"]["state_err"]
        prev = x
    assert IIRFilter.fallback_steps == before[1]
    assert dict(fops.iir_blocked_step.by_shape) == before[2]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(x, carry)
        torch.cuda.synchronize()
    spans = sorted(((e.name, e.time_range.start, e.time_range.end)
                    for e in prof.events() if e.device_type == DeviceType.CPU
                    and e.name.startswith("pc.")), key=lambda s: s[1])
    iir = [s for s in spans if s[0] == "pc.chain.IIRFilter"]
    kern = [s for s in spans if s[0] == "pc.kernel.iir_df2t"]
    assert len(iir) == len(kern) == 1
    assert iir[0][1] <= kern[0][1] and kern[0][2] <= iir[0][2]
    assert not [s for s in spans if s[0].startswith("pc.op.iir")]
    device = [e.name for e in prof.events()
              if e.device_type == DeviceType.CUDA]
    assert any("iir_df2t_kernel" in n for n in device)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [4099, 8192])
def test_card_real_chain_takes_i1(card, t):
    """A real float32 IIR through ``compile_chain`` on the card: one I1
    call a step on the rows [C, T, 1] (two launches: its plan cuts the 4
    rows into segments), no blocked step and no fallback, each step and
    the carried state within TOL of ``lfilter``."""
    b, a = ellip(6)
    blk = pkg.BlockRegistry.make("/comms/iir_filter", "float32")
    blk.set_taps(np.concatenate([b, a]))
    step, carry = compiler.compile_chain([blk], 4, device=card)
    rng = np.random.default_rng(t)
    xs = rng.normal(size=(2, 4, t)).astype(np.float32)
    before = (i1.iir_df2t.launches, IIRFilter.fallback_steps,
              dict(fops.iir_blocked_step.by_shape))
    per_call = 2 if i1.plan(6, t, 1, 4, i1._sms(card)).segs > 1 else 1
    ys = []
    for s, x in enumerate(xs, 1):
        y, carry = step(torch.from_numpy(x).to(card), carry)
        torch.cuda.synchronize()
        assert y.shape == (4, t)
        assert i1.iir_df2t.launches == before[0] + per_call * s
        ys.append(y.cpu().numpy())
    assert IIRFilter.fallback_steps == before[1]
    assert dict(fops.iir_blocked_step.by_shape) == before[2]
    ye, ze = lfilter_rows(np.concatenate(list(xs), axis=1)[..., None],
                          np.zeros((6, 4, 1)), b, a)
    assert rel(np.concatenate(ys, axis=1), ye[..., 0]) < TOL
    assert rel(carry[0].cpu().numpy(), ze[..., 0]) < TOL


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["complex_float32", "float32"])
@pytest.mark.parametrize("order", [7, 8])
def test_card_high_order_elliptic_keeps_the_blocked_form(card, dtype, order):
    """The cell's elliptic design at orders 7 and 8 on the card: I1's
    wrapper refuses the taps (its algorithm strays past STRAY on them),
    and ``compile_chain`` runs the blocked form, no I1 launch and no
    fallback, within TOL of ``lfilter``."""
    b, a = ellip(order)
    x1 = torch.randn((2, 4096, 2), device=card)
    with pytest.raises(ValueError):
        i1.iir_df2t(x1, torch.zeros((order, 2, 2), device=card), b, a)
    blk = pkg.BlockRegistry.make("/comms/iir_filter", dtype)
    blk.set_taps(np.concatenate([b, a]))
    step, carry = compiler.compile_chain([blk], 2, device=card)
    is_cplx = dtype.startswith("complex")
    rng = np.random.default_rng(order)
    x = rng.normal(size=(2, 8192, 2) if is_cplx else (2, 8192))
    before = (i1.iir_df2t.launches, IIRFilter.fallback_steps)
    y, carry = step(torch.from_numpy(x.astype(np.float32)).to(card), carry)
    torch.cuda.synchronize()
    assert (i1.iir_df2t.launches, IIRFilter.fallback_steps) == before
    xc = x[..., 0] + 1j * x[..., 1] if is_cplx else x
    exp = scipy.signal.lfilter(b, a, xc, axis=1)
    got = y.double().cpu().numpy()
    got = got[..., 0] + 1j * got[..., 1] if is_cplx else got
    assert np.max(np.abs(got - exp)) / np.max(np.abs(exp)) < TOL
