// K2: batched complex FFT, x [B, n] -> y [B, n], complex f32, forward
// (plain DFT) or unnormalized inverse, output in natural order.
//
// Replaces the TPU kernel `fft_fused_pallas` / `_fft_fused_kernel`
// (pothoscomms_tpu/parallel/pallas_kernels.py:97-185) and its wrapper
// `fft_planar_fused` (:200-227). The TPU kernel's 8x128 two-stage DFT
// split exists for the TPU's 128-wide matrix unit and is not copied.
//
// What bounds it on the H100: an FFT does ~5 n log2 n flops per 16 n
// bytes (8 read, 8 written per complex sample), under 4 flops per byte
// at n <= 4096, so it is HBM-bound (3.35 TB/s published). The design
// reads each sample once and writes it once, keeps every pass's data in
// registers, and moves it between passes through shared memory in an
// order that costs no bank conflicts where n is a power of two.
//
// Design: a mixed-radix Stockham auto-sort FFT (no bit reversal), one
// plan per n built on the host (kernels/fft.py `stockham_plan`): radices
// from {16, 8, 4, 2, 3, 5, 7}, largest first, for n = 2^a 3^b 5^c 7^d
// <= 4096 (16 * 16 * 4 for n = 1024: 3 passes and 2 exchanges, where a
// radix-2 FFT takes 10 passes).
// Pass p of radix R, with ns the product of the earlier radices, takes
// for each j < n / R the R samples j + r n/R, multiplies sample r by the
// twiddle W_{ns R}^{r (j mod ns)}, runs a radix-R DFT in registers, and
// writes the results to (j / ns) ns R + (j mod ns) + q ns. The first pass
// reads global memory and the last writes it, both coalesced (neighbour
// threads, neighbour samples); between passes the row goes through shared
// memory as two f32 planes (re, im), in two buffers taken in turn.
//  * Shared-memory layout (smem_layout.cuh): for n a power of two the XOR
//    swizzle smem::swz, under which every warp access of every exchange
//    hits 32 distinct banks; the addresses of a butterfly are its first
//    address XOR per-pass offsets precomputed on the host (the parts lie
//    on disjoint bits). For other n, smem::pad, which leaves 2- and
//    3-way conflicts on some accesses (1.2-1.9 times a conflict-free
//    access on average, counted in tests/test_torch_fft_plan.py).
//  * j / ns and j mod ns without a divide: smem::FastDiv from the plan.
//  * Twiddles: per-pass tables [(R - 1) x ns] computed in float64 on the
//    host and rounded to f32, one table per direction; nothing is
//    computed with sincosf on the card.
//  * Threads: trow = min(n / R_max, 256) per row, and 256 / trow rows per
//    block for small n; a ragged last block is masked.
//  * Full f32 arithmetic, no tensor cores.
// The plan's view, the butterflies and the pass are in stockham.cuh, which
// K3 (fir_fft_fused.cu) runs too.
// An n with a prime factor above 7 keeps the direct O(n^2) DFT below.
// Rows longer than 4096 are split into two factors by the caller
// (parallel/fft.py), each factor's FFTs running here.

#include <cuda_runtime.h>
#include <stdint.h>

#include "stockham.cuh"

namespace {

using namespace stockham;

template <bool INV, bool POW2>
__global__ void __launch_bounds__(kThreads, 2)
    stockham_kernel(const float2* __restrict__ x, float2* __restrict__ y,
                    const float2* __restrict__ tw,
                    const int* __restrict__ plan_ints, long long B, int n,
                    int passes, int trow, int rows, unsigned plane) {
  extern __shared__ float sm[];
  const PlanView plan{plan_ints};
  const int lrow = threadIdx.x / trow;
  const int t = threadIdx.x - lrow * trow;
  const long long grow = (long long)blockIdx.x * rows + lrow;
  Row row;
  row.active = grow < B;
  row.base = (unsigned)(lrow * n);
  row.plane = plane;
  const float2* xrow = x + (row.active ? grow : 0) * n;
  float2* yrow = y + (row.active ? grow : 0) * n;
  const bool active = row.active;
  auto in = [=](int idx) {
    return active ? xrow[idx] : make_float2(0.f, 0.f);
  };
  auto out = [=](int, int, int idx, float2 v) {
    if (active) yrow[idx] = v;
  };
  for (int s = 0; s < passes; ++s) {
    switch (plan.radix(s)) {
      case 16: pass<16, INV, POW2>(plan, s, passes, n, t, trow, row, sm, tw, in, out); break;
      case 8: pass<8, INV, POW2>(plan, s, passes, n, t, trow, row, sm, tw, in, out); break;
      case 4: pass<4, INV, POW2>(plan, s, passes, n, t, trow, row, sm, tw, in, out); break;
      case 2: pass<2, INV, POW2>(plan, s, passes, n, t, trow, row, sm, tw, in, out); break;
      case 3: pass<3, INV, POW2>(plan, s, passes, n, t, trow, row, sm, tw, in, out); break;
      case 5: pass<5, INV, POW2>(plan, s, passes, n, t, trow, row, sm, tw, in, out); break;
      case 7: pass<7, INV, POW2>(plan, s, passes, n, t, trow, row, sm, tw, in, out); break;
      default: pass<1, INV, POW2>(plan, s, passes, n, t, trow, row, sm, tw, in, out); break;
    }
    if (s + 1 < passes) __syncthreads();
  }
}

// direct DFT for an n with a prime factor above 7: one block per row,
// each thread one output bin, the n-entry twiddle table W[j] (staged in
// shared memory) indexed by (j * k) mod n, accumulated incrementally
__global__ void dft_kernel(const float2* __restrict__ x,
                           float2* __restrict__ y,
                           const float2* __restrict__ tw, int n) {
  extern __shared__ float2 s2[];
  float2* sx = s2;       // the row
  float2* stw = s2 + n;  // the twiddle table
  const float2* xr = x + (int64_t)blockIdx.x * n;
  float2* yr = y + (int64_t)blockIdx.x * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    sx[i] = xr[i];
    stw[i] = tw[i];
  }
  __syncthreads();
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    float re = 0.f, im = 0.f;
    int idx = 0;  // (j * k) mod n
    for (int j = 0; j < n; ++j) {
      const float2 v = sx[j];
      const float2 w = stw[idx];
      re = fmaf(v.x, w.x, fmaf(-v.y, w.y, re));
      im = fmaf(v.x, w.y, fmaf(v.y, w.x, im));
      idx += k;
      if (idx >= n) idx -= n;
    }
    yr[k] = make_float2(re, im);
  }
}


}  // namespace

extern "C" int fft_plan_ints() { return kPlanInts; }

// Stockham path. x, y [B, n, 2]; tw the plan's twiddles for the
// direction; plan the packed int32 plan (kernels/fft.py, on the card);
// passes, trow, rows from the same plan. Returns cudaGetLastError() after
// the launch (or the error of raising the shared-memory limit), or
// cudaErrorInvalidValue for a plan the kernel does not take.
extern "C" int fft_stockham_f32(const float* x, float* y, const float* tw,
                                const int* plan, long long B, int n,
                                int passes, int trow, int rows, int inverse,
                                void* stream) {
  if (n < 1 || n > 4096 || passes < 1 || passes > kMaxPasses || trow < 1 ||
      rows < 1 || trow * rows > kThreads)
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool pow2 = (n & (n - 1)) == 0;
  const unsigned words = (unsigned)(rows * n);
  const unsigned plane = pow2 ? words : smem::pad(words - 1) + 1;
  const int buffers = passes >= 3 ? 2 : 1;
  const size_t smem = (size_t)buffers * 2 * plane * sizeof(float);
  const unsigned blocks = (unsigned)((B + rows - 1) / rows);
  const float2* x2 = reinterpret_cast<const float2*>(x);
  float2* y2 = reinterpret_cast<float2*>(y);
  const float2* tw2 = reinterpret_cast<const float2*>(tw);
  auto go = [&](auto kernel) {
    const int e = launch_with_smem(kernel, smem);
    if (e) return e;
    kernel<<<blocks, trow * rows, smem, st>>>(x2, y2, tw2, plan, B, n, passes,
                                              trow, rows, plane);
    return (int)cudaGetLastError();
  };
  if (inverse)
    return pow2 ? go(stockham_kernel<true, true>)
                : go(stockham_kernel<true, false>);
  return pow2 ? go(stockham_kernel<false, true>)
              : go(stockham_kernel<false, false>);
}

// Direct DFT. x, y [B, n, 2]; tw [n, 2] = exp(-+2 pi i j / n).
extern "C" int fft_dft_f32(const float* x, float* y, const float* tw,
                           long long B, int n, void* stream) {
  if (n < 1 || n > 4096) return (int)cudaErrorInvalidValue;
  if (B <= 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int threads = ((n + 31) / 32) * 32;
  if (threads > 256) threads = 256;
  const size_t smem = 2 * (size_t)n * sizeof(float2);
  const int e = launch_with_smem(dft_kernel, smem);
  if (e) return e;
  dft_kernel<<<(unsigned)B, threads, smem, st>>>(
      reinterpret_cast<const float2*>(x), reinterpret_cast<float2*>(y),
      reinterpret_cast<const float2*>(tw), n);
  return (int)cudaGetLastError();
}
