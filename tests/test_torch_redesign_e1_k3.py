"""The redesigned E1 (csrc/envelope.cu) and K3 (csrc/fir_fft_fused.cu) on
the CPU, where the kernels cannot run: their arithmetic and index maps
mirrored in numpy, and the functions around them against the JAX package.

E1
- the kernel's step (two candidates, then a select) equals the JAX order
  ``g = x > e ? ga : gr; g e + (1 - g) x`` bit for bit in float32;
- a numpy mirror of the kernel's tile ring (32 rows x 32 steps a tile,
  16-byte chunks swizzled by row, kStages tiles in flight, one warp
  stepping while the other loads and stores) loads every (row, step)
  that reads memory once, steps them in order and stores every output
  once, whichever of the two warps runs ahead between two barriers;
- ``envelope_rows_plain`` against the JAX ``envelope_blocked`` and
  ``envelope_scan``, and the envelope block's fused core at the port's
  block length against the JAX block's and the sequential scan, all at
  rtol 1e-5 / atol 1e-6 (tests/test_filter.py's envelope bound: the
  follower is contractive, so a shorter block differs by float32
  resolution only).

K3
- ``FFT_n(pad(u_w @ gt)) == u_w @ Gc`` in float64 to 1e-12 of max;
- a numpy model of the kernel's correction row through the Stockham plan
  (pass 0 pruned to a broadcast when the row is short, the model of
  tests/test_torch_fft_plan.py for the rest) against numpy, rel 1e-5 as
  that model's own tests;
- gt from the taps and gt recovered from the JAX Gc agree to 1e-6 of max
  (float32 roundings of Gc), Gc rebuilt from gt equals the planes of
  ``circ_correction_operators`` to 1e-6 of max (float32 rounding of the
  taps), and a Gc without a short support raises;
- the one-pass chain against JAX ``make_fused_pallas_chain`` (interpret
  mode) within 1e-4 of max |spectrum|, the JAX chain contract.

Inputs are float32 from numpy.random.default_rng(seed).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import pothoscomms_tpu as jpkg
import pothoscomms_tpu_torch as pkg
from pothoscomms_tpu.ops import filter as jfops
from pothoscomms_tpu.parallel import pallas_kernels as jpk
from pothoscomms_tpu_torch.blocks import filter as bfilter
from pothoscomms_tpu_torch.kernels import fft as kfft
from pothoscomms_tpu_torch.kernels import fir_fft_fused as ff
from pothoscomms_tpu_torch.kernels.envelope import envelope_rows_plain
from pothoscomms_tpu_torch.ops import filter as fops
from pothoscomms_tpu_torch.parallel import chain
from tests.test_torch_fft_plan import stockham_model

torch.set_num_threads(1)

_F = np.float32


# ---------------------------------------------------------------------- #
# E1: the step
# ---------------------------------------------------------------------- #
def _follow_jax_order(e, x, ga, gr):
    """g = x > e ? ga : gr; g e + (1 - g) x, every operation in float32."""
    g = np.where(x > e, ga, gr).astype(_F)
    return (g * e).astype(_F) + ((_F(1) - g).astype(_F) * x).astype(_F)


def _follow_kernel(e, x, ga, gr):
    """envelope.cu `follow`: both candidates, then the select."""
    oma, omr = _F(1) - ga, _F(1) - gr
    pa, pr = (oma * x).astype(_F), (omr * x).astype(_F)
    ea = ((ga * e).astype(_F) + pa).astype(_F)
    er = ((gr * e).astype(_F) + pr).astype(_F)
    return np.where(x > e, ea, er)


@pytest.mark.parametrize("attack,release", [(10.0, 40.0), (4.0, 16.0),
                                            (1.0, 1.0), (0.3, 2000.0)])
def test_e1_three_op_step_equals_the_jax_order_bit_for_bit(attack, release):
    rng = np.random.default_rng(int(attack * 10 + release))
    ga, gr = _F(np.exp(-1 / attack)), _F(np.exp(-1 / release))
    n = 200000
    e = np.abs(rng.standard_normal(n, dtype=_F)) * _F(10) ** rng.integers(
        -20, 20, n).astype(_F)
    x = np.abs(rng.standard_normal(n, dtype=_F)) * _F(10) ** rng.integers(
        -20, 20, n).astype(_F)
    special = np.array([0.0, -0.0, np.nan, np.inf, 1e-45, 3.4e38, 1.0], _F)
    x[:49] = np.repeat(special, 7)
    e[:49] = np.tile(special, 7)
    x[49:5000] = e[49:5000]          # x == e takes the release branch
    x[5000:6000] = 0
    e[6000:7000] = 0
    with np.errstate(all="ignore"):
        got = _follow_kernel(e, x, ga, gr)
        exp = _follow_jax_order(e, x, ga, gr)
    np.testing.assert_array_equal(got.view(np.uint32), exp.view(np.uint32))


# ---------------------------------------------------------------------- #
# E1: the tile ring (envelope.cu envelope_rows_kernel)
# ---------------------------------------------------------------------- #
LANES, TILE, CHUNKS, STAGES = 32, 32, 8, 4


def _tile_word(r, col):
    """envelope.cu `tile_word`."""
    return r * TILE + ((((col >> 2) ^ r) & (CHUNKS - 1)) << 2) + (col & 3)


def _e1_ring_model(mag, L, Wr, aligned, mover_first):
    """The kernel's control flow over mag [P, T], one block of two warps
    for 32 rows: between barriers k and k + 1 the stepping warp steps tile
    k out of ring slot k % STAGES into outs[k & 1], while the moving warp
    stores tile k - 1's results and loads tile k + STAGES - 1 into the
    slot that tile k - 1 left. The two run side by side, so the model
    runs them in either order (``mover_first``) and must not care.

    Returns (consumed, stored): consumed[row] the list of (step j, value)
    the row was stepped on, value None for the env0 prefix; stored {flat
    index of y: (row, step)}. Asserts that every word stepped on is the
    one loaded for that tile, row and step, and that no load or store
    falls outside mag / y."""
    P, T = mag.shape
    flat = mag.reshape(-1)
    nb, nsteps = T // L, Wr + L
    rows = P * nb
    consumed = {r: [] for r in range(rows)}
    stored = {}
    ntiles = -(-nsteps // TILE)
    for blk in range(-(-rows // LANES)):
        lanes = []
        for lane in range(LANES):
            row = blk * LANES + lane
            valid = row < rows
            p, b = (row // nb, row % nb) if valid else (0, 0)
            base = b * L
            first = nsteps if not valid else max(Wr - base, 0)
            lanes.append((valid, p * T + base - Wr, first))
        ring = [dict() for _ in range(STAGES)]   # word -> (tile, row, step)
        outs = [dict(), dict()]

        def cells(lane):
            """(row, column) pairs lane copies, in or out."""
            if aligned:  # chunk lane & 7 of rows (lane >> 3) + 4 i
                return [((lane >> 3) + 4 * i, 4 * (lane & 7) + q)
                        for i in range(CHUNKS) for q in range(4)]
            return [(r, lane) for r in range(LANES)]

        def load(k):
            dst = ring[k % STAGES]
            j0 = k * TILE
            for lane in range(LANES):
                for r, col in cells(lane):
                    _, start, first = lanes[r]
                    j = j0 + col
                    ok = first <= j < nsteps
                    if aligned:   # decided for the 16-byte chunk
                        jc = j0 + (col & ~3)
                        ok = first <= jc < nsteps
                        assert (start + jc) % 4 == 0
                        assert _tile_word(r, col & ~3) % 4 == 0
                        assert not ok or jc + 3 < nsteps
                    if ok:
                        assert 0 <= start + j < flat.size
                        dst[_tile_word(r, col)] = (k, r, j, flat[start + j])

        def store(k):
            j0 = k * TILE
            if j0 + TILE <= Wr:
                return
            out = outs[k & 1]
            for lane in range(LANES):
                for r, col in cells(lane):
                    valid, start, first = lanes[r]
                    j = j0 + col
                    jc = j0 + (col & ~3) if aligned else j
                    if first < nsteps and Wr <= jc < nsteps:
                        assert out[_tile_word(r, col)] == (
                            k, blk * LANES + r, j)
                        dst = start + j
                        assert 0 <= dst < flat.size and dst not in stored
                        stored[dst] = (blk * LANES + r, j)

        def step(k):
            j0 = k * TILE
            out = outs[k & 1]
            for lane, (valid, start, first) in enumerate(lanes):
                if not valid:
                    continue
                row = blk * LANES + lane
                frm = min(max(first - j0, 0), TILE)
                to = min(nsteps - j0, TILE)
                for ch in range(CHUNKS):
                    at = lane * TILE + ((ch ^ (lane & 7)) << 2)
                    for q in range(4):
                        c = 4 * ch + q
                        if c >= to:
                            continue
                        if c >= frm:
                            tile, r, j, v = ring[k % STAGES][at + q]
                            assert (tile, r, j) == (k, lane, j0 + c)
                            consumed[row].append((j0 + c, v))
                        else:
                            consumed[row].append((j0 + c, None))
                        out[at + q] = (k, row, j0 + c)

        def move(k):
            if k > 0:
                store(k - 1)
            if k + STAGES - 1 < ntiles:
                load(k + STAGES - 1)

        for k in range(min(STAGES - 1, ntiles)):
            load(k)
        for k in range(ntiles):                  # after barrier k
            for act in ((move, step) if mover_first else (step, move)):
                act(k)
        store(ntiles - 1)                        # after the last barrier
    return consumed, stored


@pytest.mark.parametrize("P,T,L,Wr", [
    (3, 256, 64, 64),      # blocked, Wr = L
    (2, 512, 128, 0),      # Wr = 0
    (2, 384, 64, 192),     # Wr > base for the first three rows of a channel
    (5, 231, 33, 66),      # odd L: the scalar variant
    (1, 300, 300, 0),      # T = L, the sequential scan, a ragged last tile
    (40, 128, 16, 8),      # more rows than a warp, tiles past the row's end
    (2, 256, 64, 36),      # Wr off the tile, still 16-byte aligned
    (3, 200, 40, 7),       # odd Wr
])
def test_e1_tile_ring_reads_every_row_and_step_once_in_order(P, T, L, Wr):
    rng = np.random.default_rng(P * T + L + Wr)
    mag = rng.standard_normal((P, T)).astype(_F)
    aligned = T % 4 == 0 and L % 4 == 0 and Wr % 4 == 0
    nb, nsteps = T // L, Wr + L
    for variant, mover_first in [(v, m) for v in ((True, False) if aligned
                                                  else (False,))
                                 for m in (True, False)]:
        consumed, stored = _e1_ring_model(mag, L, Wr, variant, mover_first)
        for row in range(P * nb):
            p, b = divmod(row, nb)
            steps = consumed[row]
            assert [j for j, _ in steps] == list(range(nsteps))
            for j, v in steps:
                i = b * L + j                # index into xfull
                if i < Wr:
                    assert v is None         # the env0 prefix
                else:
                    assert v == mag[p, i - Wr]
        # every y[p, t] written once, by the row and step that own it
        assert sorted(stored) == list(range(P * T))
        for dst, (row, j) in stored.items():
            p, t = divmod(dst, T)
            assert (row, j) == (p * nb + t // L, Wr + t % L)


def test_e1_tile_swizzle_is_conflict_free_for_16_byte_accesses():
    """A quarter warp's 16-byte shared accesses are conflict-free when its
    eight lanes hit eight distinct 16-byte bank groups: a lane reading
    chunk ch of its own row (step_tile), and eight lanes copying one row's
    line in or out (the moving warp's load and store)."""
    for ch in range(CHUNKS):
        for quarter in range(4):
            lanes = range(8 * quarter, 8 * quarter + 8)
            groups = {(_tile_word(lane, 4 * ch) // 4) % 8 for lane in lanes}
            assert len(groups) == 8
    for r in range(LANES):
        assert {(_tile_word(r, 4 * c) // 4) % 8 for c in range(8)} \
            == set(range(8))
    words = sorted(_tile_word(r, c) for r in range(LANES)
                   for c in range(TILE))
    assert words == list(range(LANES * TILE))


# ---------------------------------------------------------------------- #
# E1: the functions around the kernel against the JAX package
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("P,T,L,W", [
    (3, 8192, 1024, 768), (2, 4096, 1024, 512), (2, 8192, 2048, 768),
    (1, 4096, 4096, 0)])
def test_e1_plain_version_matches_jax_blocked_and_scan(P, T, L, W):
    rng = np.random.default_rng(T + L + W)
    x = np.abs(rng.standard_normal((P, T))).astype(_F)
    env0 = np.abs(rng.standard_normal(P)).astype(_F)
    ga, gr = _F(np.exp(-1 / 10.0)), _F(np.exp(-1 / 40.0))
    Wr = -(-W // L) * L
    y, e = envelope_rows_plain(torch.from_numpy(x), torch.from_numpy(env0),
                               ga, gr, L, Wr)
    if L == T:
        for p in range(P):
            yj, ej = jfops.envelope_scan(jnp.asarray(x[p]),
                                         jnp.float32(env0[p]), ga, gr)
            np.testing.assert_allclose(y[p].numpy(), np.asarray(yj),
                                       rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(e[p].numpy(), np.asarray(ej),
                                       rtol=1e-5, atol=1e-6)
        return
    yj, ej = jfops.envelope_blocked(jnp.asarray(x), jnp.asarray(env0), ga,
                                    gr, L, W)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(e.numpy(), np.asarray(ej), rtol=1e-5,
                               atol=1e-6)
    ys, es = fops.envelope_scan(torch.from_numpy(x), torch.from_numpy(env0),
                                ga, gr)
    np.testing.assert_allclose(y.numpy(), ys.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(e.numpy(), es.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("attack,release,T", [(10.0, 40.0, 8192),
                                              (4.0, 16.0, 4096),
                                              (10.0, 40.0, 32768),
                                              (10.0, 40.0, 3072)])
def test_e1_block_core_at_the_port_block_length_matches_jax_block(
        attack, release, T):
    """The fused core of /comms/envelope_detector over two chained steps:
    the port blocks at ENVELOPE_BLOCK (T >= 4 blocks), the JAX block at
    8192 (only T = 32768 here), and both must agree with each other and
    with the sequential scan."""
    C = 3
    rng = np.random.default_rng(int(T + attack))
    blk = pkg.BlockRegistry.make("/comms/envelope_detector", "float32")
    pkg.Topology(device="cpu")._register(blk)
    jblk = jpkg.BlockRegistry.make("/comms/envelope_detector", "float32")
    for b in (blk, jblk):
        b.set_attack(attack)
        b.set_release(release)
    carry, step = blk.device_core(C)
    jcarry, jstep = jblk.device_core(C)
    L = bfilter.ENVELOPE_BLOCK
    calls = []
    saved = fops.envelope_blocked
    fops.envelope_blocked = lambda *a: calls.append(a[4:]) or saved(*a)
    try:
        env = torch.zeros(C)
        for _ in range(2):
            x = rng.standard_normal((C, T)).astype(_F)
            carry, y = step(carry, torch.from_numpy(x))
            jcarry, jy = jstep(jcarry, jnp.asarray(x))
            ys, env = fops.envelope_scan(torch.from_numpy(np.abs(x)), env,
                                         *blk._gains())
            np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                                       atol=1e-6)
            np.testing.assert_allclose(carry.numpy(), np.asarray(jcarry),
                                       rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(y.numpy(), ys.numpy(), rtol=1e-5,
                                       atol=1e-6)
            np.testing.assert_allclose(carry.numpy(), env.numpy(), rtol=1e-5,
                                       atol=1e-6)
    finally:
        fops.envelope_blocked = saved
    blocked = T % L == 0 and T >= 4 * L
    assert calls == ([(L, fops.envelope_warmup(attack, release))] * 2
                     if blocked else [])


# ---------------------------------------------------------------------- #
# K3: the pruned correction
# ---------------------------------------------------------------------- #
def _taps(rng, k):
    return (rng.normal(size=k) + 1j * rng.normal(size=k)) / k


def _c(a):
    a = np.asarray(a, np.float64)
    return a[..., 0] + 1j * a[..., 1]


@pytest.mark.parametrize("k", [2, 17, 64])
def test_k3_transform_of_the_short_product_is_the_correction(k):
    """FFT_n(pad(u_w @ gt)) == u_w @ Gc in float64, Gc the operator of the
    TPU kernel as parallel/chain.py builds it."""
    rng = np.random.default_rng(k)
    taps = _taps(rng, k)
    n, pp = 1024, 64
    _, gt = ff.fused_chain_consts(taps, n, pp)
    g = np.zeros((pp, pp), np.complex128)      # gt before its f32 rounding
    for m in range(1, k):
        g[pp - m, :k - m] = taps[m:]
    np.testing.assert_array_equal(gt.numpy(), np.stack(
        [g.real, g.imag], -1).astype(_F))
    f = np.exp(-2j * np.pi * np.outer(np.arange(n), np.arange(n)) / n)
    gc = np.zeros((pp, n), np.complex128)      # chain.py:229-232, fused rows
    for m in range(1, k):
        for j in range(k - m):
            gc[pp - m] += taps[j + m] * f[j]
    uw = rng.normal(size=(5, pp)) + 1j * rng.normal(size=(5, pp))
    got = np.fft.fft(uw @ g, n, axis=-1)
    exp = uw @ gc
    assert np.max(np.abs(got - exp)) < 1e-12 * np.max(np.abs(exp))


def _correction_model(c, plan):
    """The kernel's correction row through the plan: c [..., S] complex.
    When S <= n / R0 and the plan has more than one pass, pass 0 is a
    broadcast: butterfly j's only non-zero input is c[j], its R0 outputs
    all equal it and land at j R0 + q. The rest is the model of K2's
    passes on the row as pass 0 left it."""
    n, s = plan.n, c.shape[-1]
    r0 = plan.radices[0]
    row = np.zeros(c.shape[:-1] + (n,), np.complex128)
    row[..., :s] = c
    if len(plan.radices) < 2 or s > n // r0:
        return stockham_model(row, plan, False)
    src = np.repeat(row[..., :n // r0], r0, axis=-1)   # [.., j R0 + q] = c[j]
    rest = plan._replace(radices=plan.radices[1:], ns=plan.ns[1:],
                         tw_offsets=plan.tw_offsets[1:])
    return stockham_model(src, rest, False)


@pytest.mark.parametrize("n,s", [(1024, 64), (1024, 63), (1024, 1),
                                 (1024, 65), (1024, 256), (512, 32),
                                 (256, 16), (256, 17), (128, 8), (64, 4),
                                 (32, 2), (16, 16), (16, 1), (8, 8), (2, 2)])
def test_k3_pruned_first_pass_model_matches_numpy(n, s):
    rng = np.random.default_rng(n + s)
    c = rng.normal(size=(3, s)) + 1j * rng.normal(size=(3, s))
    plan = kfft.stockham_plan(n, False)
    # what the kernel relies on: every pass but the last has radix 16 and
    # one butterfly a thread, the last 16 / R of them (one for one pass)
    assert all(r == 16 for r in plan.radices[:-1])
    assert plan.trow == (n // 16 if n >= 16 else 1)
    got = _correction_model(c, plan)
    exp = np.fft.fft(c, n, axis=-1)
    assert np.max(np.abs(got - exp)) < 1e-5 * np.max(np.abs(exp))


@pytest.mark.parametrize("k", [2, 17, 64, 65])
def test_k3_gt_from_taps_and_from_the_jax_constants_agree(k):
    taps = _taps(np.random.default_rng(41 + k), k)
    consts = jpk._fused_chain_consts(tuple(taps.tolist()), 1024, 64)
    _, gt = ff.fused_chain_consts(taps, 1024, 64)
    _, gtj = ff.fused_consts_from_numpy(consts, device="cpu")
    assert gt.shape == gtj.shape == (64, 64, 2)
    assert np.max(np.abs(gt.numpy() - gtj.numpy())) \
        < 1e-6 * np.max(np.abs(gt.numpy()))
    # Gc rebuilt from gt: the planes chain.py builds from the taps in
    # float64, rows reversed and zero-padded at the front to pp
    _, gc = chain.circ_correction_operators(taps, 1024)
    pad = 64 - (k - 1)
    for got, ref in zip(ff.correction_spectrum(gt, 1024), gc):
        exp = torch.cat([ref.new_zeros(pad, 1024), ref.flip(0)]).numpy()
        assert np.max(np.abs(got.numpy() - exp)) < 1e-6 * np.max(np.abs(exp))


def test_k3_consts_from_numpy_raise_without_a_short_support():
    rng = np.random.default_rng(7)
    taps = _taps(rng, 64)
    consts = list(jpk._fused_chain_consts(tuple(taps.tolist()), 1024, 64))
    gfr, gfi = (np.array(a) for a in consts[4])
    gfr[5] += rng.normal(size=1024).astype(_F)     # a row with a long gt
    consts[4] = (gfr, gfi)
    with pytest.raises(ValueError, match="energy"):
        ff.fused_consts_from_numpy(tuple(consts), device="cpu")
    with pytest.raises(ValueError):                # K - 1 above pp
        ff.fused_chain_consts(_taps(rng, 66), 1024, 64)


@pytest.mark.parametrize("k", [2, 33, 64])
def test_k3_one_pass_chain_matches_jax_pallas_chain(k):
    rng = np.random.default_rng(60 + k)
    C, T, NB = 2, 4096, 1024
    taps = _taps(rng, k)
    run = ff.make_fused_chain(taps, NB, device="cpu")
    jrun = jpk.make_fused_pallas_chain(taps, NB, interpret=True)
    hist = torch.zeros(C, k - 1, 2)
    jhist = jnp.zeros((C, k - 1, 2), jnp.float32)
    for _ in range(2):
        x = rng.normal(size=(C, T, 2)).astype(_F)
        spec, hist = run.run(torch.from_numpy(x), hist)
        se, jhist = jrun(jnp.asarray(x), jhist)
        se = np.asarray(se)
        assert np.max(np.abs(spec.numpy() - se)) < 1e-4 * np.max(np.abs(se))
        np.testing.assert_array_equal(hist.numpy(), np.asarray(jhist))
