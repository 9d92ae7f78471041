"""The index algebra of K2 (csrc/fft.cu, its passes in csrc/stockham.cuh,
which K3 runs too) and P2 (csrc/layout_move.cu) on
the CPU, where the kernels cannot run.

- K2's plan (pothoscomms_tpu_torch.kernels.fft.stockham_plan): for every
  n <= 4096 whose largest prime factor is at most 7, radices from the
  kernel's set multiplying to n; a numpy model of the kernel's Stockham
  passes and radix-R butterflies, fed the plan's own f32 twiddle tables,
  against np.fft (float64, rel < 1e-5), the JAX package's fft_planar and,
  at n = 256 and 1024, its Pallas fft_planar_fused in interpret mode.
- The shared-memory layout of csrc/smem_layout.cuh (mirrored by
  kernels.fft.smem_swizzle / smem_pad / fastdiv): a bijection on every
  tile, linear over XOR, and conflict-free (32 distinct banks per warp)
  for every warp access of P2's four modes and of K2's exchanges, with
  each kernel's own thread layout, at power-of-two sizes. At other sizes
  K2 pads instead, which is not conflict-free: the words per bank of
  every warp access are counted and pinned.

Tolerances: rel 1e-5 of max |X| against float64 (the f32 twiddle tables
carry ~6e-8 relative error each, a few passes deep); 2e-5 against the
JAX functions (the port's FFT contract).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from collections import Counter

from pothoscomms_tpu.parallel.fft import fft_planar as jfft_planar
from pothoscomms_tpu.parallel.pallas_kernels import fft_planar_fused
from pothoscomms_tpu_torch.kernels import fft as kfft

torch.set_num_threads(1)

SIZES = [2 ** k for k in range(0, 13)] + [48, 100, 384, 1000, 1536, 2187,
                                          2401, 3000]


def _largest_prime(n):
    p, big = 2, 1
    while n > 1:
        while n % p == 0:
            n //= p
            big = p
        p += 1
    return big


SMOOTH = [n for n in range(1, 4097) if _largest_prime(n) <= 7]


# ------------------------------------------------------------------ #
# the plan
# ------------------------------------------------------------------ #
def test_plan_covers_exactly_the_7_smooth_sizes():
    for n in range(1, 4097):
        radices = kfft.fft_plan(n)
        if _largest_prime(n) > 7:
            assert radices is None, n
            assert kfft.stockham_plan(n, False) is None
            continue
        assert int(np.prod(radices)) == n, n
        assert set(radices) <= set(kfft.RADICES) | ({1} if n == 1 else set())
        assert len(radices) <= kfft.MAX_PASSES
        # powers of two first, largest first, then 3s, 5s and 7s
        evens = [r for r in radices if r % 2 == 0]
        assert list(radices) == sorted(evens, reverse=True) + sorted(
            r for r in radices if r % 2)
    assert len(SMOOTH) == sum(kfft.fft_plan(n) is not None
                              for n in range(1, 4097))


@pytest.mark.parametrize("n", [1, 2, 16, 48, 100, 384, 1000, 1024, 2187,
                               2401, 3000, 4096])
def test_plan_block_shape_and_packed_fields(n):
    """128-256 threads a block (several rows for small n), and the int32
    fields the kernel reads (PlanView, csrc/stockham.cuh) in their places."""
    plan = kfft.stockham_plan(n, False)
    threads = plan.trow * plan.rows
    assert 128 < threads <= kfft.THREADS
    assert plan.trow == min(-(-n // max(plan.radices)), kfft.THREADS)
    ints = plan.ints.view(np.uint32).astype(np.int64)
    m = kfft.MAX_PASSES
    for s, r in enumerate(plan.radices):
        assert ints[s] == r and ints[m + s] == plan.tw_offsets[s]
        assert ints[2 * m + s] == plan.ns[s]
        assert (ints[3 * m + s], ints[4 * m + s]) == kfft.fastdiv(plan.ns[s])
    assert plan.ints.shape == (kfft.PLAN_INTS,)
    assert plan.twiddles.dtype == np.float32


def test_fastdiv_mirror_divides_exactly():
    rng = np.random.default_rng(3)
    xs = np.concatenate([np.arange(70000), rng.integers(0, 2 ** 31, 50000),
                         [2 ** 31 - 1]]).astype(np.uint64)
    for d in list(range(1, 4097)) + [8192, 12345]:
        magic, shift = kfft.fastdiv(d)
        assert 0 < magic < 2 ** 32
        q = (((xs * np.uint64(magic)) >> np.uint64(32)) + xs) \
            >> np.uint64(shift)
        np.testing.assert_array_equal(q, xs // np.uint64(d))


# ------------------------------------------------------------------ #
# a numpy model of the kernel's passes (stockham.cuh `pass`)
# ------------------------------------------------------------------ #
_F = np.float32


def _w16(m, inverse):
    """w16 (stockham.cuh): the f32 constants of W_16^m."""
    c, s = _F(np.cos(np.pi * m / 8)), _F(np.sin(np.pi * m / 8))
    return complex(c, s if inverse else -s)


def _rot90(a, inverse):
    return a * (1j if inverse else -1j)


def _dft4(a0, a1, a2, a3, inverse):
    """dft4 (stockham.cuh)."""
    t0, t1, t2, t3 = a0 + a2, a0 - a2, a1 + a3, _rot90(a1 - a3, inverse)
    return t0 + t2, t1 + t3, t0 - t2, t1 - t3


def _butterfly(v, inverse):
    """The radix-R DFT as stockham.cuh computes it: 2 and 4 directly, 8
    as 2 x 4 (dft8), 16 as 4 x 4 (dft16), 3, 5, 7 by the odd formula with
    f32 cos / sin tables (dft_odd); the kernel leaves the outputs of 8
    and 16 in place, transposed (slot<R>), and stores output k from slot
    k."""
    r_ = len(v)
    if r_ == 1:
        return v
    if r_ == 2:
        return [v[0] + v[1], v[0] - v[1]]
    if r_ == 4:
        return list(_dft4(*v, inverse))
    v = list(v)
    if r_ == 8:       # in place, as the kernel: v[l::2] = DFT4, then pairs
        v[0::2] = _dft4(*v[0::2], inverse)
        v[1::2] = _dft4(*v[1::2], inverse)
        for q in range(4):
            b = v[2 * q + 1] * (_w16(2 * q, inverse) if q else 1)
            v[2 * q], v[2 * q + 1] = v[2 * q] + b, v[2 * q] - b
        return [v[2 * (k & 3) + (k >> 2)] for k in range(8)]   # slot<8>
    if r_ == 16:      # in place: DFT4 over v[l::4], twiddles, DFT4 rows
        for l in range(4):
            v[l::4] = _dft4(*v[l::4], inverse)
        for l in range(1, 4):
            for q in range(1, 4):
                v[l + 4 * q] = v[l + 4 * q] * _w16(l * q, inverse)
        for q in range(4):
            v[4 * q:4 * q + 4] = _dft4(*v[4 * q:4 * q + 4], inverse)
        return [v[4 * (k & 3) + (k >> 2)] for k in range(16)]  # slot<16>
    h = (r_ - 1) // 2
    cos = [_F(np.cos(2 * np.pi * m / r_)) for m in range(r_)]
    sin = [_F(np.sin(2 * np.pi * m / r_)) for m in range(r_)]
    t = [v[p + 1] + v[r_ - 1 - p] for p in range(h)]
    d = [v[p + 1] - v[r_ - 1 - p] for p in range(h)]
    out = [v[0] + sum(t)]
    for k in range(1, r_):
        c = v[0] + sum(cos[(p + 1) * k % r_] * t[p] for p in range(h))
        s = sum(sin[(p + 1) * k % r_] * d[p] for p in range(h))
        out.append(c + (1j * s if inverse else -1j * s))
    return out


def stockham_model(x, plan, inverse):
    """x [..., n] complex -> the kernel's output: pass s reads samples
    j + r n/R, multiplies sample r by table entry (r - 1) ns + j mod ns,
    runs the butterfly, and writes (j / ns) ns R + j mod ns + q ns."""
    n, src = plan.n, np.asarray(x, np.complex128)
    tw = plan.twiddles[:, 0].astype(np.float64) \
        + 1j * plan.twiddles[:, 1].astype(np.float64)
    for s, r_ in enumerate(plan.radices):
        ns, nb = plan.ns[s], n // r_
        j = np.arange(nb)
        k = j % ns
        v = [src[..., j + r * nb] for r in range(r_)]
        if ns > 1:
            off = plan.tw_offsets[s]
            v = [v[0]] + [v[r] * tw[off + (r - 1) * ns + k]
                          for r in range(1, r_)]
        out = _butterfly(v, inverse)
        dst = np.empty_like(src)
        for q in range(r_):
            dst[..., (j // ns) * ns * r_ + k + q * ns] = out[q]
        src = dst
    return src


def _rel(got, exp):
    return np.max(np.abs(got - exp)) / np.max(np.abs(exp))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("inverse", [False, True])
def test_stockham_model_matches_numpy_and_jax(n, inverse):
    rng = np.random.default_rng(n + 7 * inverse)
    x = rng.normal(size=(3, n, 2)).astype(np.float32)
    xc = x[..., 0].astype(np.float64) + 1j * x[..., 1]
    got = stockham_model(xc, kfft.stockham_plan(n, inverse), inverse)
    exp = np.fft.ifft(xc, axis=-1) * n if inverse else np.fft.fft(xc,
                                                                   axis=-1)
    assert _rel(got, exp) < 1e-5
    j = np.asarray(jfft_planar(jnp.asarray(x), n, inverse))
    assert _rel(got, j[..., 0] + 1j * j[..., 1]) < 2e-5


@pytest.mark.parametrize("n", [256, 1024])
@pytest.mark.parametrize("inverse", [False, True])
def test_stockham_model_matches_jax_pallas_fused_fft(n, inverse):
    rng = np.random.default_rng(n + 1)
    x = rng.normal(size=(8, n, 2)).astype(np.float32)
    exp = np.asarray(fft_planar_fused(jnp.asarray(x), n, inverse,
                                      interpret=True))
    got = stockham_model(x[..., 0] + 1j * x[..., 1].astype(np.float64),
                         kfft.stockham_plan(n, inverse), inverse)
    assert _rel(got, exp[..., 0] + 1j * exp[..., 1]) < 2e-5


@pytest.mark.parametrize("n", [7, 9, 17, 100, 4096])
def test_every_7_smooth_size_passes_the_model(n):
    """A sweep over all 7-smooth sizes in a window around n, forward."""
    rng = np.random.default_rng(n)
    for m in [s for s in SMOOTH if n <= s < n + 40][:6]:
        xc = rng.normal(size=(1, m)) + 1j * rng.normal(size=(1, m))
        got = stockham_model(xc, kfft.stockham_plan(m, False), False)
        assert _rel(got, np.fft.fft(xc, axis=-1)) < 1e-5, m


# ------------------------------------------------------------------ #
# the shared-memory layout
# ------------------------------------------------------------------ #
def _conflict(addrs, layout):
    """Distinct words per bank in one warp access (1 = conflict-free)."""
    banks = Counter(layout(a) % 32 for a in set(addrs))
    return max(banks.values())


def test_swizzle_is_a_linear_bijection_of_each_32_word_line():
    words = np.arange(8192)
    phys = np.array([kfft.smem_swizzle(int(i)) for i in words])
    np.testing.assert_array_equal(np.sort(phys), words)
    np.testing.assert_array_equal(phys >> 5, words >> 5)
    rng = np.random.default_rng(5)
    for a, b in rng.integers(0, 8192, (500, 2)):
        assert kfft.smem_swizzle(int(a) ^ int(b)) == \
            kfft.smem_swizzle(int(a)) ^ kfft.smem_swizzle(int(b))
    pads = [kfft.smem_pad(i) for i in range(8192)]
    assert len(set(pads)) == 8192 and max(pads) == kfft.smem_pad(8191)


def _p2_source(mode, o, n):
    """layout_move.cu:56-70, the in-tile source of output word o."""
    m = n // 8
    row, o = divmod(o, n)
    if mode == "A":
        src = (o & 7) * m + (o >> 3)
    elif mode == "C":
        c, r = divmod(o, m)
        src = (r & 7) * m + (r >> 3) * 8 + c
    else:  # B and D
        i, r = divmod(o, m)
        src = r * 8 + i
    return row * n + src


@pytest.mark.parametrize("n", [2 ** k for k in range(6, 14)])
@pytest.mark.parametrize("mode", ["A", "B", "C", "D"])
def test_p2_tile_accesses_hit_32_banks(n, mode):
    """Warp w's lanes own output groups 4 (32 w + t) .. + 3 of a tile
    (layout_move.cu:87-88, :129-130). Stores: word 4g + k at swz(4g) ^ k
    (:104-109); reads: source of word 4g + k at swz(source of 4g) ^
    swz(k step) (:120-139), which is swz(source of 4g + k), for each k."""
    tile = max(1, 2048 // n) * n  # layout_move.cu:186, the tile
    sw = kfft.smem_swizzle
    step = n // 8 if mode in "AC" else 8
    for w in range(tile // 128):
        for k in range(4):
            groups = [32 * w + t for t in range(32)]
            assert _conflict([4 * g + k for g in groups], sw) == 1
            reads = [_p2_source(mode, 4 * g, n) for g in groups]
            assert [sw(a) ^ sw(k * step) for a in reads] == \
                [sw(_p2_source(mode, 4 * g + k, n)) for g in groups]
            assert _conflict([_p2_source(mode, 4 * g + k, n)
                              for g in groups], sw) == 1


def _k2_accesses(n):
    """Every warp access of K2's exchanges: thread t of local row
    lrow = tid / trow (fft.cu stockham_kernel) takes butterflies j = t,
    t + trow, .. (stockham.cuh `pass`), reads row * n + j + r n/R in
    every pass but the first and writes row * n + (j / ns) ns R + j mod ns
    + r ns in every pass but the last. Yields (kind, addresses)."""
    plan = kfft.stockham_plan(n, False)
    threads = plan.trow * plan.rows
    last = len(plan.radices) - 1
    for s, r_ in enumerate(plan.radices):
        nb, ns = n // r_, plan.ns[s]
        for w in range(-(-threads // 32)):
            tids = range(32 * w, min(32 * w + 32, threads))
            for it in range(-(-nb // plan.trow)):
                lanes = [(tid // plan.trow, tid % plan.trow + it * plan.trow)
                         for tid in tids]
                lanes = [(row, j) for row, j in lanes if j < nb]
                if not lanes:
                    continue
                for r in range(r_):
                    if s > 0:
                        yield "read", [row * n + j + r * nb
                                       for row, j in lanes]
                    if s < last:
                        yield "write", [row * n + (j // ns) * ns * r_
                                        + j % ns + r * ns
                                        for row, j in lanes]


@pytest.mark.parametrize("n", [2 ** k for k in range(1, 13)])
def test_k2_exchanges_hit_32_banks(n):
    count = 0
    for _, addrs in _k2_accesses(n):
        assert _conflict(addrs, kfft.smem_swizzle) == 1
        count += 1
    assert (count > 0) == (len(kfft.fft_plan(n)) > 1)


@pytest.mark.parametrize("n", [2 ** k for k in range(2, 13)])
def test_k2_precomputed_offsets_equal_the_full_swizzle(n):
    """For a power-of-two n, swz(first address) ^ the XOR of the plan's
    basis offsets over r's set bits (stockham.cuh xor_basis, in pass()) is the
    swizzle of each sample's own address."""
    plan = kfft.stockham_plan(n, False)
    ints = plan.ints.view(np.uint32)
    roff = 5 * kfft.MAX_PASSES
    woff = roff + kfft.MAX_PASSES * kfft.MAX_LOG2_RADIX
    sw = kfft.smem_swizzle

    def offset(base, s, r):
        o = 0
        for b in range(kfft.MAX_LOG2_RADIX):
            if r >> b & 1:
                o ^= int(ints[base + s * kfft.MAX_LOG2_RADIX + b])
        return o

    rng = np.random.default_rng(n)
    for s, r_ in enumerate(plan.radices):
        nb, ns = n // r_, plan.ns[s]
        for row, j in zip(rng.integers(0, plan.rows, 20),
                          rng.integers(0, nb, 20)):
            row, j = int(row), int(j)
            for r in range(r_):
                assert sw(row * n + j) ^ offset(roff, s, r) == \
                    sw(row * n + j + r * nb)
                o = row * n + (j // ns) * ns * r_ + j % ns
                assert sw(o) ^ offset(woff, s, r) == sw(o + r * ns)


@pytest.mark.parametrize("n", [48, 100, 384, 1000, 3000])
def test_k2_padded_exchanges_stay_inside_their_plane(n):
    """Other n: smem::pad, injective on the plane of rows * n words."""
    plan = kfft.stockham_plan(n, False)
    words = plan.rows * n
    seen = set()
    for _, addrs in _k2_accesses(n):
        assert max(addrs) < words
        seen.update(kfft.smem_pad(a) for a in addrs)
    assert max(seen) <= kfft.smem_pad(words - 1)
    assert len({kfft.smem_pad(a) for a in range(words)}) == words


# Words in the busiest bank of each warp access of K2's padded exchanges
# (stockham.cuh `pass`, through smem::pad): {words: accesses}.
# Up to 3 words share a bank (2187's and 100's writes); on average an
# access takes 1.2-1.9 times a conflict-free one.
PADDED_BANKS = {
    48: {1: 217, 2: 55},
    100: {1: 46, 2: 108, 3: 30},
    384: {1: 188, 2: 337},
    1000: {1: 192, 2: 247},
    1536: {1: 480, 2: 96},
    2187: {1: 192, 2: 596, 3: 40},
    2401: {1: 73, 2: 389},
    3000: {1: 296, 2: 467},
}


@pytest.mark.parametrize("n", sorted(PADDED_BANKS))
def test_k2_padded_exchanges_bank_counts(n):
    """Sizes that are not powers of two keep 2- and 3-way bank conflicts
    under smem::pad; the counts are pinned, so a change of layout shows."""
    counts = Counter(_conflict(addrs, kfft.smem_pad)
                     for _, addrs in _k2_accesses(n))
    assert dict(counts) == PADDED_BANKS[n]
