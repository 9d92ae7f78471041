// K3: the one-pass FIR+FFT step in circular-correction form. For each
// window b of n complex samples:
//
//   y[b] = FFT_n(x[b]) * H + FFT_n(pad(c[b])),   c[b, t] = sum_m uw[b, m] gt[m, t]
//
// where H = FFT(taps) and the second term turns the circular convolution
// into the linear one (uw[b] = previous window's tail minus this window's
// own tail, zero-padded at the front to pp). gt [pp, S] is the correction
// operator in the time domain: row m of the TPU kernel's Gc [pp, n] is the
// DFT of a row that is zero from sample S on (S <= K - 1 for a K-tap
// filter), so uw @ Gc == FFT_n(pad(uw @ gt)). Output in natural bin order;
// with uw == nullptr the correction is skipped.
//
// Replaces the TPU kernel `fir_fft_fused_pallas` / `_fir_fft_fused_kernel`
// (pothoscomms_tpu/parallel/pallas_kernels.py:257-367). What it computes
// is carried over, not how: the Pallas kernel's DIF 8x128 split, its
// [B, 128, 8] output layout, the m-major H / Gc layouts, the static chunk
// loop and the [B, pp] x [pp, n] product on the matrix unit are the TPU's
// and are not copied.
//
// Layout: x, y [B, n, 2], uw [B, pp, 2], H [n, 2] and gt [pp, S, 2] are
// interleaved complex f32; tw and the packed plan are K2's for this n
// (kernels/fft.py `stockham_plan`). H, gt and tw are built in float64 on
// the host and rounded to f32 once.
//
// What bounds it on the H100: bytes. At the main path's width (B = 32768
// windows of n = 1024, pp = 64, S = 64) it moves ~0.55 GB (268 MB in, 16.8
// MB of uw, 268 MB out), ~0.165 ms at 3.35 TB/s; per window it does ~51k
// flops for x's FFT, 8 pp S = 33k for c, ~34k for c's two last passes and
// 8k for the epilogue, 4.1 GFLOP in all, 0.06 ms at the 67 TFLOP/s f32
// SIMT peak. (The [B, pp] x [pp, n] form costs 8 pp n = 524k flops a
// window and was bound by them.)
//
// Design: K2's block (stockham.cuh): `rows` windows a block, `trow`
// threads each, every pass in registers, the exchanges through the
// swizzled shared planes. The block first builds c for its windows in
// shared memory (uw staged there with one coalesced load, gt coalesced
// from L1 / L2; meanwhile a prefetch brings x from HBM to L2),
// then runs c through the plan: when S <= n / 16 only sample r = 0 of each
// radix-16 butterfly of pass 0 is non-zero, so that pass would only copy
// c[j] to 16 j .. 16 j + 15 and is left out, the next pass reading c in
// its place; the later passes run in full, and the last leaves its 16
// results in registers. Then x takes the same
// passes through the same buffers, and the epilogue of its last pass, in
// the thread that holds X at the same bins, stores X H + C once. Every
// FMA is full f32.

#include <cuda_runtime.h>
#include <stdint.h>

#include "stockham.cuh"

namespace {

using namespace stockham;

constexpr int kMaxUwWords = 2048;  // complex words of uw a block stages

// The last pass of a power-of-two plan with n <= 1024: every thread holds
// 16 / R butterflies of radix R (one when the plan is a single pass), so
// fn(k, idx, v) sees result v of bin idx with k < 16 a constant.
template <class In, class Fn>
__device__ __forceinline__ void last_pass(const PlanView& plan, int passes,
                                          int n, int t, int trow,
                                          const Row& row, float* sm,
                                          const float2* __restrict__ tw,
                                          In in, Fn fn, bool from_in = false) {
  const int s = passes - 1;
  const bool single = passes == 1;
#define K3_LAST(R, ITERS)                                            \
  pass<R, false, true, ITERS>(                                       \
      plan, s, passes, n, t, trow, row, sm, tw, in,                  \
      [&](int it, int r, int idx, float2 v) { fn(it * R + r, idx, v); }, \
      from_in)
  switch (plan.radix(s)) {
    case 16: K3_LAST(16, 1); break;
    case 8: if (single) K3_LAST(8, 1); else K3_LAST(8, 2); break;
    case 4: if (single) K3_LAST(4, 1); else K3_LAST(4, 4); break;
    default: if (single) K3_LAST(2, 1); else K3_LAST(2, 8); break;
  }
#undef K3_LAST
}

template <bool CORR>
__global__ void __launch_bounds__(kThreads, 2)
    fir_fft_fused_kernel(const float2* __restrict__ x,
                         const float2* __restrict__ uw,
                         const float2* __restrict__ H,
                         const float2* __restrict__ gt,
                         const float2* __restrict__ tw,
                         const int* __restrict__ plan_ints,
                         float2* __restrict__ y, long long B, int n,
                         int passes, int trow, int rows, unsigned plane,
                         int buffers, int pp, int S, int pruned) {
  extern __shared__ float sm[];
  const PlanView plan{plan_ints};
  const int lrow = threadIdx.x / trow;
  const int t = threadIdx.x - lrow * trow;
  const long long b0 = (long long)blockIdx.x * rows;
  const long long grow = b0 + lrow;
  Row row;
  row.active = grow < B;
  row.base = (unsigned)(lrow * n);
  row.plane = plane;
  const bool active = row.active;
  const float2* xrow = x + (active ? grow : 0) * n;
  float2* yrow = y + (active ? grow : 0) * n;
  auto nothing = [](int, int, int, float2) {};

  float2 cc[16];  // C at this thread's last-pass bins
  if constexpr (CORR) {
    float2* sc = reinterpret_cast<float2*>(sm + (size_t)buffers * 2 * plane);
    float2* su = sc + rows * S;
    // The block's uw rows are contiguous in global memory: one coalesced
    // load a thread brings them to shared memory in a single round trip.
    // x is not needed before the correction is through its passes; a
    // prefetch starts its trip from HBM to L2 now.
    const long long live = B - b0 < rows ? B - b0 : rows;
    for (int i = threadIdx.x; i < rows * pp; i += blockDim.x)
      su[i] = i < live * pp ? __ldg(uw + b0 * pp + i) : make_float2(0.f, 0.f);
    for (long long i = threadIdx.x; i < live * n / 16; i += blockDim.x)
      asm volatile("prefetch.global.L2 [%0];" ::"l"(x + b0 * n + i * 16));
    __syncthreads();
    // c[w, tt] = sum_m uw[w, m] gt[m, tt] for the block's windows, in
    // four partial sums so that no sum waits on the one before it
    for (int i = threadIdx.x; i < rows * S; i += blockDim.x) {
      const int w = i / S, tt = i - w * S;
      const float2* u = su + w * pp;
      const float2* g = gt + tt;
      float2 acc[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) acc[a] = make_float2(0.f, 0.f);
      auto mac = [&](int a, int m) {
        const float2 uu = u[m];
        const float2 gg = __ldg(g + (size_t)m * S);
        acc[a].x = fmaf(uu.x, gg.x, fmaf(-uu.y, gg.y, acc[a].x));
        acc[a].y = fmaf(uu.x, gg.y, fmaf(uu.y, gg.x, acc[a].y));
      };
      int m = 0;
#pragma unroll 4
      for (; m + 4 <= pp; m += 4) {
#pragma unroll
        for (int a = 0; a < 4; ++a) mac(a, m + a);
      }
      for (; m < pp; ++m) mac(0, m);
      sc[i] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
    }
    __syncthreads();
    const float2* crow = sc + lrow * S;
    // Pruned: pass 0 (radix 16, samples j + r n / 16) would find only
    // sample r = 0 non-zero and leave c[j] at 16 j + q for every q < 16,
    // so it is not run: the next pass reads sample idx as c[idx / 16].
    const int s0 = pruned ? 1 : 0;
    auto cin = [=](int idx) {
      const int i = pruned ? idx >> 4 : idx;
      return i < S ? crow[i] : make_float2(0.f, 0.f);
    };
    // every pass but the last has radix 16 and one butterfly a thread
    for (int s = s0; s + 1 < passes; ++s) {
      pass<16, false, true, 1>(plan, s, passes, n, t, trow, row, sm, tw, cin,
                               nothing, s == s0);
      __syncthreads();
    }
    last_pass(plan, passes, n, t, trow, row, sm, tw, cin,
              [&](int k, int, float2 v) { cc[k] = v; }, passes - 1 == s0);
    // a two-pass plan has one buffer: x's first pass writes what the
    // correction's last pass may have just read
    if (passes == 2) __syncthreads();
  }

  auto xin = [=](int idx) {
    return active ? xrow[idx] : make_float2(0.f, 0.f);
  };
  for (int s = 0; s + 1 < passes; ++s) {
    pass<16, false, true, 1>(plan, s, passes, n, t, trow, row, sm, tw, xin,
                             nothing);
    __syncthreads();
  }
  last_pass(plan, passes, n, t, trow, row, sm, tw, xin,
            [&](int k, int idx, float2 v) {
              if (active) {
                float2 o = cmul(v, __ldg(H + idx));
                if constexpr (CORR) o = o + cc[k];
                yrow[idx] = o;
              }
            });
}

}  // namespace

extern "C" int fir_fft_fused_plan_ints() { return kPlanInts; }

// x, y [B, n, 2]; uw [B, pp, 2] or null; H [n, 2]; gt [pp, S, 2]; tw and
// plan the forward Stockham plan of n on the card, passes, trow, rows from
// the same plan (kernels/fft.py); with uw the block takes fewer rows
// where their uw would not fit kMaxUwWords of shared memory. n a power of
// two, 2 <= n <= 1024; 0 <= pp; 1 <= S <= n when uw is given. Returns
// cudaGetLastError() after the launch (or the error of raising the
// shared-memory limit), or cudaErrorInvalidValue for arguments the kernel
// does not take.
extern "C" int fir_fft_fused_f32(const float* x, const float* uw,
                                 const float* H, const float* gt,
                                 const float* tw, const int* plan, float* y,
                                 long long B, int n, int passes, int trow,
                                 int rows, int pp, int S, void* stream) {
  if (n < 2 || n > 1024 || (n & (n - 1)) != 0 || passes < 1 || passes > 3 ||
      trow < 1 || rows < 1 || trow * rows > kThreads ||
      trow != (n >= 16 ? n / 16 : 1) || pp < 0 ||
      (uw != nullptr && (S < 1 || S > n)))
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return (int)cudaGetLastError();
  const bool corr = uw != nullptr;
  if (corr && rows * pp > kMaxUwWords) rows = max(1, kMaxUwWords / pp);
  const unsigned plane = (unsigned)(rows * n);
  const int buffers = passes >= 3 ? 2 : 1;
  const size_t smem = (size_t)buffers * 2 * plane * sizeof(float) +
                      (corr ? (size_t)rows * (S + pp) * sizeof(float2) : 0);
  const int pruned = passes >= 2 && S <= n / 16;
  if ((B + rows - 1) / rows >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((B + rows - 1) / rows);
  auto go = [&](auto kernel) {
    const int e = launch_with_smem(kernel, smem);
    if (e) return e;
    kernel<<<blocks, trow * rows, smem, static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float2*>(x),
        reinterpret_cast<const float2*>(uw),
        reinterpret_cast<const float2*>(H),
        reinterpret_cast<const float2*>(gt),
        reinterpret_cast<const float2*>(tw), plan,
        reinterpret_cast<float2*>(y), B, n, passes, trow, rows, plane,
        buffers, pp, S, pruned);
    return (int)cudaGetLastError();
  };
  return corr ? go(fir_fft_fused_kernel<true>)
              : go(fir_fft_fused_kernel<false>);
}
