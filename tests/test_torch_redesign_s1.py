"""The redesigned S1 (csrc/sync_search.cu) on the CPU, where the kernel
cannot run: its arithmetic and its index maps mirrored in numpy, held to
the float64 oracle of the search (core/testing.py ``sync_search_f64``,
``search_agreement``) and to the JAX program.

- In float64, the correlation by Horner's rule a block at a time,
  sum over blocks of z^lo conj(p_s) sum_r x[lo + r] z^r, equals the
  JAX program's tap-by-tap sum of (frame * rot) * conj(p) to 1e-12 of the
  sum of the terms' magnitudes, at npre = 1, 2 and 4 with random preamble
  phases and block lengths that split a symbol or not.
- A float32 emulation of the kernel's sums (direct window sums, K's
  products once each with the imaginary part a difference of two rounded
  products, Horner in blocks of the source's kHornerBlock taps with
  full-precision
  sincos anchors, FMAs as the kernel writes them) lands within the bounds
  of tests/test_torch_framing.py's TOL against the oracle on link data at
  the link's bucket of 32768 samples (noise 0.001, 0.01 and none), and on
  preambles of 2 and 4 symbols and a symbol split into two blocks; and at
  a 4096 bucket its floored peaks equal the JAX program's at the
  automaton's candidate offsets; and its |L| at those offsets is as
  precise as the first design's tap-by-tap sum, which fixes kHornerBlock.
- A mirror of the launch (k consecutive offsets a thread at a plan
  (k, threads), the staged span deinterleaved by k, the loops of the
  window sums, K and the Horner blocks) reaches every offset exactly once,
  gives every offset each of its terms once and in the kernel's order from
  samples inside the staged span, and a warp's staged reads are free of
  bank conflicts. The plan the kernel takes for a shape is its own
  (``sync_search_plan``), held on the card (tests/test_torch_cuda.py).
- The bound's yardstick, ``ops_per_offset``, counts the search's least
  work.

The emulation rounds each float32 operation from float64 (an FMA as
float64 a * b + c rounded once; a product of two float32 values is exact
in float64); sin, cos and atan2 are float64 results rounded to float32,
within the kernel's full-precision functions' few ulps.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from pothoscomms_tpu.ops import framing as jframing
from pothoscomms_tpu_torch.core.testing import (search_agreement,
                                                sync_search_f64)
from pothoscomms_tpu_torch.kernels import sync_search as ss
from tests.test_torch_framing import TOL, _link_bucket, assert_tolerances

torch.set_num_threads(1)

_F = np.float32
_SOURCE = (Path(ss.__file__).resolve().parent.parent / "csrc"
           / "sync_search.cu").read_text()


# taps between two anchors of the Horner rotation, as the source sets it
HORNER_BLOCK = int(re.search(r"constexpr int kHornerBlock = (\d+);",
                             _SOURCE)[1])


def _blocks(w, npre, B):
    """The kernel's Horner blocks [lo, hi), in the order it takes them:
    symbols from the last, and within a symbol blocks of B taps from its
    start, the last one the rest."""
    return [(s * w + u, min(s * w + u + B, (s + 1) * w))
            for s in reversed(range(npre))
            for u in reversed(range(0, w, B))]


@pytest.mark.parametrize("sw,w,dw,npre,ops", [(80, 80, 4, 1, 806),
                                              (80, 40, 4, 2, 734),
                                              (80, 20, 4, 4, 710)])
def test_s1_bound_counts_the_least_work_of_the_search(sw, w, dw, npre, ops):
    """8 operations a correlation tap (one complex multiply-add); K's
    product (6) and |x| (4) once a sample, counted once an offset; 2 a
    term of K and 1 a term of each window sum; 20 for the rest; 8 for each
    preamble symbol after the first: 806 an offset at the link's
    parameters, and at the link's launch 0.0999 ms by operations
    (67 TFLOP/s), above its 0.060 ms of bytes (3.35 TB/s)."""
    assert ss.ops_per_offset(sw, w, dw, npre) == ops
    half = w // 2
    # the kernel computes each of K's products once and adds it into every
    # offset that takes it: K costs one product a sample, not one a term
    assert ops - 8 * sw - 20 - 8 * (npre - 1) == \
        (6 + 2 * (half - 2 * dw)) + (4 + 2 * (half - dw))
    nbytes, total = ss.work(256, 32768, 32457, sw, w, dw, npre)
    assert total == 256 * 32457 * ops
    assert nbytes == 256 * 32768 * 8 + 4 * 256 * 32457 * 4
    if npre == 1:
        assert total / 67e12 * 1e3 == pytest.approx(0.0999, rel=1e-3)
        assert nbytes / 3.35e12 * 1e3 == pytest.approx(0.0597, rel=1e-3)


# ---------------------------------------------------------------------- #
# (i) the algebra, in float64
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("npre,w,B", [(1, 80, 80), (2, 40, 80), (4, 20, 80),
                                      (1, 80, 24), (2, 40, 16)])
def test_s1_horner_by_block_equals_the_tap_by_tap_sum(npre, w, B):
    rng = np.random.default_rng(npre * 100 + B)
    sw, n = w * npre, 300
    x = rng.normal(size=n + sw) + 1j * rng.normal(size=n + sw)
    theta = rng.uniform(-np.pi / 40, np.pi / 40, n)
    pre = np.exp(1j * rng.uniform(0, 2 * np.pi, npre))
    j = np.arange(sw)
    frames = x[np.arange(n)[:, None] + j]
    terms = frames * np.exp(1j * theta[:, None] * j) \
        * np.conj(np.repeat(pre, w))[None, :]
    tap_by_tap = terms.sum(axis=1)
    z = np.exp(1j * theta)
    horner = np.zeros(n, np.complex128)
    for lo, hi in _blocks(w, npre, B):
        acc = np.zeros(n, np.complex128)
        for t in range(hi - 1, lo - 1, -1):
            acc = acc * z + frames[:, t]
        horner += z ** lo * np.conj(pre[lo // w]) * acc
    scale = np.abs(terms).sum(axis=1)
    assert np.max(np.abs(horner - tap_by_tap) / scale) < 1e-12


# ---------------------------------------------------------------------- #
# (ii) the kernel's float32 sums against the oracle and JAX
# ---------------------------------------------------------------------- #
def _fma(a, b, c):
    return (np.asarray(a, np.float64) * b + c).astype(_F)


def _mul(a, b):
    return (np.asarray(a, np.float64) * b).astype(_F)


def _cos_sin(a):
    a = np.asarray(a, np.float64)
    return np.cos(a).astype(_F), np.sin(a).astype(_F)


def s1_emulation(x, pre, thr, sw, w, dw, npre, n, B=HORNER_BLOCK,
                 abs_L=False):
    """The kernel's arithmetic for every offset of x [C, L, 2], in float32:
    (scale, delta_fc, phase_off, corr_peak), each [C, n]; with ``abs_L``
    also |L| before the floor."""
    xr, xi = x[..., 0].astype(_F), x[..., 1].astype(_F)
    ax = np.sqrt(_fma(xr, xr, _mul(xi, xi)).astype(np.float64)).astype(_F)
    i = np.arange(n)
    half = w // 2
    shape = (x.shape[0], n)

    def window(lo, hi):
        s = np.zeros(shape, _F)
        for k in range(lo, hi):
            s = (s + ax[:, i + k]).astype(_F)
        return (s / _F(half - dw)).astype(_F)

    sum0, sum1 = window(dw, half), window(sw - half, sw - dw)
    pre = np.asarray(pre, np.complex128)
    cp = np.conj(pre).astype(np.complex64)
    p_abs_f = np.sqrt(np.float64(_fma(pre[0].real, _F(pre[0].real),
                                      _mul(pre[0].imag, _F(pre[0].imag))))
                      ).astype(_F)
    p_abs_l = np.sqrt(np.float64(_fma(pre[-1].real, _F(pre[-1].real),
                                      _mul(pre[-1].imag, _F(pre[-1].imag))))
                      ).astype(_F)
    ok = (ax[:, i + dw] >= thr) & (ax[:, i + sw - dw] >= thr) & (sum0 >= thr)
    s0 = (sum0 / p_abs_f).astype(_F)
    ok &= sum1 >= thr
    s1 = (sum1 / p_abs_l).astype(_F)
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = np.where(s1 != 0, s0 / np.where(s1 == 0, _F(1), s1),
                         np.inf).astype(_F)
        ok &= (ratio <= 2) & (ratio >= 0.5)
        scale = np.where(ok, _F(2) / (s0 + s1).astype(_F), _F(0)).astype(_F)

    klo = w * (npre - 1) + dw
    kr, ki = np.zeros(shape, _F), np.zeros(shape, _F)
    for k in range(klo, klo + half - 2 * dw):
        ar, ai = xr[:, i + k], xi[:, i + k]
        br, bi = xr[:, i + k + half], xi[:, i + k + half]
        kr = (kr + _fma(ar, br, _mul(ai, bi))).astype(_F)
        ki = (ki + (_mul(ai, br) - _mul(ar, bi)).astype(_F)).astype(_F)
    dfc = np.where(scale != 0, (np.arctan2(ki.astype(np.float64), kr)
                                .astype(_F) / _F(half)).astype(_F), _F(0))
    zr, zi = _cos_sin(dfc)

    lr, li = np.zeros(shape, _F), np.zeros(shape, _F)
    for lo, hi in _blocks(w, npre, B):
        accr, acci = np.zeros(shape, _F), np.zeros(shape, _F)
        for t in range(hi - 1, lo - 1, -1):
            vr, vi = xr[:, i + t], xi[:, i + t]
            accr, acci = (_fma(accr, zr, _fma(-acci, zi, vr)),
                          _fma(accr, zi, _fma(acci, zr, vi)))
        c = cp[lo // w]
        if lo == 0:
            anr, ani = np.full(shape, c.real, _F), np.full(shape, c.imag, _F)
        else:
            rr, ri = _cos_sin(_mul(dfc, _F(lo)))
            anr = _fma(rr, c.real, -_mul(ri, c.imag))
            ani = _fma(rr, c.imag, _mul(ri, c.real))
        lr = _fma(anr, accr, _fma(-ani, acci, lr))
        li = _fma(anr, acci, _fma(ani, accr, li))
    lr, li = _mul(lr, scale), _mul(li, scale)
    mag = np.sqrt(_fma(lr, lr, _mul(li, li)).astype(np.float64)).astype(_F)
    phase = (-np.arctan2(li.astype(np.float64), lr)).astype(_F)
    out = scale, dfc, phase, np.where(scale != 0, np.floor(mag), _F(0))
    return out + (mag,) if abs_L else out


def tap_by_tap_abs_L(x, scale, dfc, sw):
    """|L| of the first design's float32 correlation (the JAX program's
    order: a rotation from cos and sin of fl(delta_fc j) a tap, the
    product with the frame rounded term by term, summed tap by tap), for
    a preamble of one symbol of 1, on the scale and delta_fc given."""
    xr, xi = x[..., 0].astype(_F), x[..., 1].astype(_F)
    i = np.arange(scale.shape[1])
    lr, li = np.zeros(scale.shape, _F), np.zeros(scale.shape, _F)
    for j in range(sw):
        co, sn = _cos_sin(_mul(dfc, _F(j)))
        fr, fi = xr[:, i + j], xi[:, i + j]
        lr = (lr + (_mul(fr, co) - _mul(fi, sn)).astype(_F)).astype(_F)
        li = (li + (_mul(fr, sn) + _mul(fi, co)).astype(_F)).astype(_F)
    lr, li = _mul(lr, scale), _mul(li, scale)
    return np.sqrt(lr.astype(np.float64) ** 2 + li.astype(np.float64) ** 2)


def _planar(pre):
    pre = np.asarray(pre, np.complex128)
    return np.stack([pre.real, pre.imag], -1).astype(_F)


@pytest.mark.parametrize("noise", [0.001, 0.01, 0.0])
def test_s1_float32_sums_hold_the_oracle_at_the_link_bucket(noise):
    """Three channels of the link's 32768-sample bucket (the link's
    sw = w = 80, dw = 4, one preamble symbol)."""
    x = _link_bucket(3, 32768, noise, seed=9)
    n = 32768 - 312 + 1
    got = s1_emulation(x, [1.0], 0.01, 80, 80, 4, 1, n)
    ref = sync_search_f64(x, [1.0], 0.01, 80, 80, 4, 1, n)
    agree = search_agreement(got, ref)
    assert_tolerances(agree)
    assert (ref["corr_peak"] > 56).any()  # frames are in the bucket
    assert (ref["scale"] != 0).sum() > 10000  # and accepted offsets


def test_s1_peaks_as_precise_as_the_first_design():
    """At the automaton's candidate offsets (oracle |L| >= 0.7 sw) of 16
    link channels at noise 0.001, the 99th percentile of | |L| - oracle |
    stays within 1.25x that of the first design's tap-by-tap sum. The
    automaton takes the first offset of the highest floored peak, so an
    error that moves a peak across an integer moves FrameSync's estimates
    to another offset. Here the first design's p99 is 2.5e-5; Horner in
    blocks of 80, 40 and 20 taps gives 8.2e-5, 4.5e-5 and 2.6e-5 (blocks
    of 80 moved one frame of 64 off the plain version's choice in
    chip_smoke [22]), so the kernel takes blocks of 20."""
    x = _link_bucket(16, 8192, 0.001, seed=11)
    n = 8192 - 312 + 1
    scale, dfc, _, _, mag = s1_emulation(x, [1.0], 0.01, 80, 80, 4, 1, n,
                                         abs_L=True)
    ref = sync_search_f64(x, [1.0], 0.01, 80, 80, 4, 1, n)
    cand = (ref["abs_L"] >= 0.7 * 80) & ~ref["ill_conditioned"] \
        & (ref["scale"] != 0) & (scale != 0)
    assert cand.sum() > 500
    err = np.quantile(np.abs(mag - ref["abs_L"])[cand], 0.99)
    first = np.quantile(np.abs(tap_by_tap_abs_L(x, scale, dfc, 80)
                               - ref["abs_L"])[cand], 0.99)
    assert err <= 1.25 * first, (err, first)


@pytest.mark.parametrize("npre,w", [(2, 40), (4, 20), (1, 160)])
def test_s1_float32_sums_hold_the_oracle_across_blocks(npre, w):
    """Preambles of 2 and 4 symbols with random phases, and one symbol of
    160 taps: anchors at every block after the first."""
    rng = np.random.default_rng(npre * 1000 + w)
    x = _link_bucket(4, 4096, 0.01, seed=npre)
    pre = np.exp(1j * rng.uniform(0, 2 * np.pi, npre))
    sw = w * npre
    n = 4096 - sw - 58 * 4 + 1
    assert len(_blocks(w, npre, HORNER_BLOCK)) > 1
    got = s1_emulation(x, pre, 0.01, sw, w, 4, npre, n)
    ref = sync_search_f64(x, pre, 0.01, sw, w, 4, npre, n)
    assert_tolerances(search_agreement(got, ref))
    assert (ref["scale"] != 0).sum() > 1000


def test_s1_float32_sums_agree_with_jax_at_a_4096_bucket():
    """At a 4096 bucket, where the JAX program's prefix sums still hold
    (tests/test_torch_framing.py), the emulation's floored peaks equal
    JAX's at the automaton's candidate offsets (|L| >= 0.7 sw, clear of
    an integer), and the emulation holds the oracle."""
    import jax.numpy as jnp

    x = _link_bucket(4, 4096, 0.01)
    n = 4096 - 312 + 1
    got = s1_emulation(x, [1.0], 0.01, 80, 80, 4, 1, n)
    jax_out = [np.stack([np.asarray(a) for a in jframing.sync_search_planar(
        jnp.asarray(x[c]), jnp.asarray(_planar([1.0])), 0.01, 80, 80, 4, 1,
        n)]) for c in range(x.shape[0])]
    jpeak = np.stack([o[3] for o in jax_out])
    ref = sync_search_f64(x, [1.0], 0.01, 80, 80, 4, 1, n)
    assert_tolerances(search_agreement(got, ref))
    live = (ref["scale"] != 0) & ~ref["borderline"] \
        & ~ref["ill_conditioned"]
    near = np.abs(ref["abs_L"] - np.round(ref["abs_L"])) < 1e-3
    cand = live & ~near & (ref["abs_L"] >= 0.7 * 80)
    assert cand.any()
    np.testing.assert_array_equal(got[3][cand], jpeak[cand])


# ---------------------------------------------------------------------- #
# (iii) the launch's maps
# ---------------------------------------------------------------------- #
def _staged(K, S, m):
    """staged<K>(m, S): sample m's index in the [K][S] layout."""
    return m % K * S + m // K


def _slide(K, lo, hi, S=1000):
    """slide<K>'s loops: (m, q) in the kernel's order. The main range's
    kept indices are checked against the layout as the loop steps."""
    out = []
    for t in range(K - 1):
        m = lo + t
        out += [(m, q) for q in range(t + 1) if m - q < hi]
    m = lo + K - 1
    at = [_staged(K, S, m + t) for t in range(K)]
    while m + K <= hi:
        for t in range(K):
            assert at[t] == _staged(K, S, m + t)
            at[t] += 1
            out += [(m + t, q) for q in range(K)]
        m += K
    for t in range(K - 1):
        if m + t < hi:
            assert at[t] == _staged(K, S, m + t)
            out += [(m + t, q) for q in range(K)]
    m0 = max(hi, lo + K - 1)
    for t in range(K - 1):
        m = m0 + t
        if m < hi + K - 1:
            out += [(m, q) for q in range(K) if lo <= m - q < hi]
    return out


def _horner(K, lo, hi):
    """One Horner block's chunk loops: (m, q) in the kernel's order."""
    out = []
    for r in range(K - 2, -1, -1):
        out += [(hi + r, q) for q in range(r + 1, K)]
    for g in range(hi // K - 1, lo // K, -1):
        for r in range(K - 1, -1, -1):
            out += [(g * K + r, q) for q in range(K)]
    for r in range(K - 1, -1, -1):
        out += [(lo + r, q) for q in range(r + 1)]
    return out


def _terms_by_offset(events, K):
    """Each offset q's terms k' = m - q, in the order the loops give."""
    by_q = {q: [] for q in range(K)}
    for m, q in events:
        by_q[q].append(m - q)
    return by_q


PLAN_CASES = [
    # (C, n, w): the link's launch, FrameSync's two buckets, ragged n
    (256, 32768 - 312 + 1, 80), (1, 32768 - 312 + 1, 80),
    (1, 65536 - 312 + 1, 80), (7, 5000 - 80 - 232 + 1, 40),
    (3, 1001, 20), (1, 1, 80), (2, 4097, 6), (40, 1000, 80)]
# (k, threads): the plans sync_search_plan takes
PLANS = [(2, 128), (1, 128), (1, 64)]


@pytest.mark.parametrize("C,n,w,k,threads", [
    (*case, *plan) for case in PLAN_CASES for plan in PLANS
    if (case[2] // 2) % plan[0] == 0])  # k divides w / 2
def test_s1_launch_reaches_every_offset_once(C, n, w, k, threads):
    tile = k * threads
    grid_x = -(-n // tile)
    b, t, q = np.meshgrid(np.arange(grid_x), np.arange(threads),
                          np.arange(k), indexing="ij")
    i = (b * tile + k * t + q).ravel()
    i = i[i < n]
    assert np.array_equal(np.bincount(i, minlength=n), np.ones(n, int))


@pytest.mark.parametrize("K,sw,w,dw,npre", [
    (K, *case) for K in (1, 2, 4)
    for case in [(80, 80, 4, 1), (80, 40, 4, 2), (80, 20, 4, 4),
                 (160, 160, 4, 1), (24, 24, 2, 1), (8, 4, 0, 2), (6, 6, 1, 1)]
    if (case[1] // 2) % K == 0])  # the plan's k divides w / 2
def test_s1_loops_give_each_offset_its_terms_in_order(K, sw, w, dw, npre):
    half = w // 2
    # K's second sample, m + half, lies half / K columns after m
    assert all(_staged(K, 1000, m + half) == _staged(K, 1000, m) + half // K
               for m in range(sw))
    staged = sw + K  # samples a thread may read, m < sw + K
    sums = [(dw, half), (sw - half, sw - dw)]
    klo = w * (npre - 1) + dw
    for lo, hi in sums + [(klo, klo + half - 2 * dw)]:
        events = _slide(K, lo, hi)
        extra = half if (lo, hi) not in sums else 0  # K reads m + half too
        assert all(0 <= m and m + extra < staged for m, _ in events)
        for q, terms in _terms_by_offset(events, K).items():
            assert terms == list(range(lo, hi)), (lo, hi, q)
    taps = {q: [] for q in range(K)}
    for lo, hi in _blocks(w, npre, HORNER_BLOCK):
        assert lo % K == 0 and hi % K == 0
        events = _horner(K, lo, hi)
        assert all(0 <= m < staged for m, _ in events)
        for q, terms in _terms_by_offset(events, K).items():
            assert terms == list(range(hi - 1, lo - 1, -1)), (lo, hi, q)
            taps[q] += terms
    assert all(sorted(t) == list(range(sw)) for t in taps.values())
    # |x| at i + dw and i + sw - dw, read as m = q + dw and q + sw - dw
    assert K - 1 + sw - dw < staged


@pytest.mark.parametrize("K,threads,sw", [(4, 256, 80), (2, 64, 80),
                                          (1, 64, 80), (4, 128, 160),
                                          (2, 256, 6)])
def test_s1_staged_reads_are_free_of_bank_conflicts(K, threads, sw):
    """A warp's staged read of sample m: float2 words 2 (row S + t + m/K)
    (an LDS.64 of 32 lanes: 64 words, each of the 32 banks twice, the two
    wavefronts of 256 bytes) and the magnitudes' words (32 banks once);
    and the staged span's rows hold it."""
    S = threads + -(-sw // K)
    span = threads * K + sw
    assert K * S >= span
    for warp in range(threads // 32):
        t = warp * 32 + np.arange(32)
        for m in range(sw + K):
            word = (m % K) * S + t + m // K
            assert np.all(K * t + m < span) and np.all(word < K * S)
            banks = np.concatenate([2 * word, 2 * word + 1]) % 32
            assert np.array_equal(np.bincount(banks, minlength=32),
                                  np.full(32, 2))
            assert np.array_equal(np.bincount(word % 32, minlength=32),
                                  np.ones(32, int))
