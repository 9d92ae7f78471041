"""K1's tensor-core formulation and P1's block map, on the CPU.

K1's tensor-core variant (``csrc/cgemm.cu``) multiplies ``a`` [B, N, 2],
read as the real matrix [B, 2N], by the K-major real embedding of the
operator, [2M, 2N], in a 3xTF32 split. Here, without a card:

- the embedding times ``a`` equals ``cgemm_plain`` and the JAX package's
  ``cmatmul`` (its Pallas kernel in interpret mode where the shape tiles,
  as tests/test_torch_kernels.py runs it), odd N and M included;
- an emulation of the kernel's arithmetic (TF32 by masking the mantissa,
  round to nearest even; each 32-wide k-slice summed exactly and rounded
  to float32, as the kernel sums a slice on the tensor cores and adds it
  to a float32 accumulator) at the main path's width with the chain's
  real 64-tap operator lands within 1e-5 of max |y| of float64, where
  one TF32 pass does not. The emulation is test code only;
- a mirror of P1's launch (one flat range cut into equal units, one
  block a unit) covers every element of both planes exactly once.

Inputs are float32, made with numpy.random.default_rng(seed).
Tolerances: 3e-6 of max |reference| against float32 products (as
tests/test_torch_kernels.py), 1e-5 of max |y| for the split (chip_smoke's
K1 contract).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pothoscomms_tpu.parallel.pallas_kernels import cmatmul
from pothoscomms_tpu_torch.kernels.cgemm import (
    SIMT, TENSOR_CORES, cgemm, cgemm_plain, real_embedding, tf32_operator,
    tf32_operator_plain, tf32_round, tf32_split, variant)
from pothoscomms_tpu_torch.parallel.chain import (combined_fir_fft_operators,
                                                  stack_combined_operators)

torch.set_num_threads(1)

THREADS, UNROLL = 256, 4  # csrc/stream_scale.cu kThreads, kUnroll


def _normal(rng, *shape):
    return rng.standard_normal(shape, dtype=np.float32)


def _scaled_err(got, exp):
    return np.max(np.abs(got - exp)) / np.max(np.abs(exp))


@pytest.mark.parametrize("b,n,m", [(64, 256, 128), (3, 100, 77),
                                   (5, 17, 9), (2, 1, 1), (128, 64, 256)])
def test_real_embedding_times_a_equals_cgemm_and_jax(b, n, m):
    rng = np.random.default_rng(b * 31 + n + m)
    a = _normal(rng, b, n, 2)
    gr, gi = _normal(rng, n, m), _normal(rng, n, m)
    bt = real_embedding(torch.from_numpy(gr), torch.from_numpy(gi))
    assert bt.shape == (2 * m, 2 * n) and bt.is_contiguous()
    got = (torch.from_numpy(a).reshape(b, 2 * n) @ bt.T).reshape(b, m, 2)
    plain = cgemm_plain(torch.from_numpy(a), torch.from_numpy(gr),
                        torch.from_numpy(gi))
    assert _scaled_err(got.numpy(), plain.numpy()) < 3e-6
    exp = np.asarray(cmatmul(jnp.asarray(a), jnp.asarray(gr), jnp.asarray(gi),
                             interpret=True))
    assert _scaled_err(got.numpy(), exp) < 3e-6
    # the embedding's entries, one by one
    g = gr + 1j * gi
    e = bt.numpy()
    np.testing.assert_array_equal(e[0::2, 0::2], g.real.T)
    np.testing.assert_array_equal(e[0::2, 1::2], -g.imag.T)
    np.testing.assert_array_equal(e[1::2, 0::2], g.imag.T)
    np.testing.assert_array_equal(e[1::2, 1::2], g.real.T)


def _tf32_numpy(x):
    """Round-to-nearest-even to 10 mantissa bits in numpy uint32."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0xFFF + ((u >> 13) & 1)) & 0xFFFFE000
    return (u & 0xFFFFFFFF).astype(np.uint32).view(np.float32)


def test_tf32_round_is_round_to_nearest_even():
    rng = np.random.default_rng(3)
    x = np.concatenate([
        _normal(rng, 4096) * np.float32(1e3),
        np.float32([0.0, -0.0, 1.0, 1 + 2 ** -11, 1 + 3 * 2 ** -11,
                    -(1 + 3 * 2 ** -11), 2 ** -126, 3.0e38, np.inf, -np.inf])])
    got = tf32_round(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, _tf32_numpy(x))
    # ties go to the even neighbour, 10 mantissa bits are left
    assert got[-7] == 1.0 and got[-6] == np.float32(1 + 2 ** -9)
    assert not (got[np.isfinite(got)].view(np.uint32) & 0x1FFF).any()
    hi, lo = tf32_split(torch.from_numpy(x[:4096]))
    rel = np.abs((hi + lo).numpy() - x[:4096]) / np.abs(x[:4096])
    assert rel.max() < 2 ** -21


def test_tf32_operator_on_cpu_is_its_plain_version():
    rng = np.random.default_rng(4)
    gr, gi = (torch.from_numpy(_normal(rng, 33, 20)) for _ in range(2))
    hi, lo = tf32_operator(gr, gi)
    phi, plo = tf32_operator_plain(gr, gi)
    assert torch.equal(hi, phi) and torch.equal(lo, plo)
    assert torch.equal(hi, tf32_round(real_embedding(gr, gi)))


@pytest.mark.parametrize("n,m,aligned,kind", [
    (1152, 1024, True, TENSOR_CORES),   # the main path's product
    (100, 77, True, TENSOR_CORES), (256, 128, True, TENSOR_CORES),
    (63, 1024, True, SIMT),             # the circ correction, N = K - 1
    (17, 200, True, SIMT), (1, 1, True, SIMT), (0, 9, True, SIMT),
    (8, 1024, True, TENSOR_CORES), (1024, 8, True, TENSOR_CORES),
    (2, 1, True, TENSOR_CORES),         # TMA's least row: 16 bytes
    (1152, 1024, False, SIMT)])
def test_variant_is_picked_by_shape(n, m, aligned, kind):
    assert variant(n, m, aligned) == kind


def test_cpu_tensors_count_no_variant():
    before = dict(cgemm.launches_by_variant)
    a = torch.zeros(4, 32, 2)
    g = torch.zeros(32, 32)
    cgemm(a, g, g)
    assert cgemm.launches_by_variant == before


def _split_gemm_emulation(a, bt, passes=3, slice_k=32):
    """y = a @ bt.T the way the tensor-core kernel computes it: TF32 hi/lo
    of both operands, each k-slice's ``passes`` products summed in float64
    (exact for TF32 inputs up to the final rounding) and rounded to
    float32, the slices added in float32."""
    ahi, alo = tf32_split(a)
    bhi, blo = tf32_split(bt)
    acc = torch.zeros(a.shape[0], bt.shape[0], dtype=torch.float32)
    for k0 in range(0, a.shape[1], slice_k):
        s = slice(k0, k0 + slice_k)
        part = ahi[:, s].double() @ bhi[:, s].double().T
        if passes == 3:
            part += ahi[:, s].double() @ blo[:, s].double().T
            part += alo[:, s].double() @ bhi[:, s].double().T
        acc += part.float()
    return acc


def test_3xtf32_split_holds_the_contract_at_main_path_width():
    """[512, 1152] x [1152, 1024] with the chain's stacked 64-tap combined
    operator: 3xTF32 within 1e-5 of max |y| against float64, one TF32 pass
    outside it (why the kernel takes three)."""
    rng = np.random.default_rng(5)
    taps = (rng.normal(size=64) + 1j * rng.normal(size=64)) / 64
    gr, gi = stack_combined_operators(*combined_fir_fft_operators(taps, 1024,
                                                                  128))
    assert gr.shape == (1152, 1024)
    a = torch.from_numpy(_normal(rng, 512, 1152, 2)).reshape(512, 2304)
    bt = real_embedding(gr, gi)
    ref = a.double() @ bt.double().T
    scale = ref.abs().max().item()
    err3 = (_split_gemm_emulation(a, bt).double() - ref).abs().max().item()
    err1 = (_split_gemm_emulation(a, bt, passes=1).double()
            - ref).abs().max().item()
    assert err3 / scale < 1e-5
    assert err1 / scale > 1e-4


def p1_plan(total, units):
    """(grid, chunk) of stream_scale_f32 for ``total`` elements a plane in
    at most ``units`` blocks, in csrc/stream_scale.cu ``plan``'s own
    arithmetic."""
    chunk = max(-(-total // units), THREADS)
    return -(-total // chunk), chunk


# (B, N in vector elements, the wrapper's units): the probe's [32768,
# 1024] on an H100 (132 SMs x 128), the card test's [8192, 1024], one
# resident wave, ragged rows, units below the 256-element floor, a scalar
# row length, one element, the unaligned card test's scalar path, units
# of several UNROLL x THREADS steps
P1_MAPS = [(32768, 256, 16896), (8192, 256, 16896), (32768, 256, 1056),
           (37, 9, 64), (1000, 9, 16896), (5, 7, 1056), (3000, 16, 100),
           (1, 1, 8), (130, 33, 132), (33, 64, 16896), (2, 3000, 3)]


@pytest.mark.parametrize("b,n,units", P1_MAPS)
def test_p1_units_cover_every_element_once(b, n, units):
    """Mirror of stream_scale_kernel's loops: block -> [begin, end) ->
    each thread's UNROLL loads a step."""
    total = b * n
    grid, chunk = p1_plan(total, units)
    assert 1 <= grid <= units and chunk >= THREADS
    hits = np.zeros(total, np.int32)
    for blk in range(grid):
        lo, hi = blk * chunk, min((blk + 1) * chunk, total)
        assert lo < hi
        for i in range(lo, hi, UNROLL * THREADS):
            for j in range(UNROLL):
                k = i + j * THREADS + np.arange(THREADS)
                np.add.at(hits, k[k < hi], 1)
    assert (hits == 1).all()
