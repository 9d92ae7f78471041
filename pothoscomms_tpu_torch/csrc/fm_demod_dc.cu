// F1: the FM discriminator and the DC-removal cascade in one pass over a
// [C, T] block, with the carries of both blocks.
//
// Not a Pallas kernel: it replaces the XLA ops that the JAX package runs
// for the discriminator, `freq_demod_planar`
// (pothoscomms_tpu/parallel/chain.py), and for the fused DC removal
// (`DCRemoval.device_core`, pothoscomms_tpu/blocks/filter.py). Their
// torch ops (a `cat` of the shifted block, the complex product, `atan2`;
// a stage a `cat`, a float64 `cumsum`, a difference, a cast and a
// division; the `stack` of the histories) moved ~200 bytes a sample where
// one pass needs 12, and held an H100 at 2.25% of that bound
// (`kernel_roofline_pct` of the FM receive bank at 256 x 131072).
//
// What it computes, as the two cores do (kernels/fm_demod_dc.py
// `fm_demod_dc_plain`), on row c of x [C, T, 2]:
//  * u[i] = atan2f(im, re) of x[i] conj(x[i-1]), x[-1] = last[c]: the
//    product's four products and two sums each rounded alone, in the
//    order of the planar product of conj (parallel/cplx.py `mul`).
//  * cascade stages: stage s reads in_s (in_0 = u) and gives
//    avg_s[i] = f32(sum in_s[i-D+1 .. i]) / D, the window sum taken in
//    float64 and rounded once (ops/filter.py `window_sum`); in_{s+1} =
//    avg_s. Inputs at i < 0 are the stage's history, in_s[i] =
//    hists[s, c, D + i].
//  * y[i] = u[i + 1 - D] - avg_{casc-1}[i] (the plain `ext[1 : 1 + T]`).
//  * carries: last' = x[T-1]; hists'[s] = in_s[T-D .. T-1] (T >= D).
//
// The window sums. A block stages a span of kSpan consecutive samples of
// one row (its tile of outputs and the halo the cascade reads before it)
// and takes, a stage at a time, a prefix sum in float64 over that span:
// window = P[i] - P[i-D]. The prefix is local to the span (at most
// kSpan terms), so its rounding stays at float64 resolution of the
// span's sum, far below float32 resolution of the window, whatever the
// row's length or its DC offset; the JAX package's float32 prefix sums
// lose ~1e-2 at a 2^24-sample pull with a mean of 0.25, this does not.
// Each thread owns kPer consecutive samples of the span: their prefix in
// registers, the threads' totals scanned across the block (warp shuffles,
// then the warps' totals), the prefix stored once to shared memory for
// the look-back P[i-D]. A stage's averages stay in the registers of the
// thread that owns the sample, which is where the next stage reads them.
//
// Tiles. Block b covers row b / ntiles, outputs [t0, e), t0 = (b % ntiles)
// * B, e = min(t0 + B, T). Stage s must give outputs on
// [out_lo(s), e), out_lo(s) = max(0, t0 - (casc - 1 - s)(D - 1)), and so
// reads in_s on [out_lo(s) - (D - 1), e); the span starts at stage 0's
// first input, base = out_lo(0) - (D - 1) >= t0 - casc (D - 1), so a tile
// of B <= kSpan - casc (D - 1) outputs fits (kernels/fm_demod_dc.py
// `plan` takes B, a multiple of 32, and the tile count). Samples of the
// span below a stage's first input, or past e, enter its prefix as 0.
// The row's last tile writes last' and hists'.
//
// Memory. x is read once (plus the halo, ~7% at D = 64, cascade 2, and a
// sample's neighbour by a warp shuffle), y written once, coalesced: stage
// 0 computes u with consecutive threads on consecutive samples into a
// float copy of the span (which also serves the delayed input), and y
// leaves the same way through that buffer. Shared arrays are padded by a
// word every kPer, so a thread's run starts kPer + 1 words after its
// neighbour's: its own loads, stores and look-backs are free of bank
// conflicts.
//
// What bounds it on the H100: the bytes (12 a sample) would take 0.120 ms
// at [256, 131072], D = 64, cascade 2. The kernel takes ~0.23 ms there:
// a copy of the same traffic with neither atan2f nor the stages takes
// ~0.14, atan2f adds ~0.04 and the two stages ~0.05 (float64 adds and
// float32 <-> float64 conversions, a scan across the block, shared
// look-backs). Within a block the loads, atan2f and the stages run one
// after another, so the design keeps five blocks resident on an SM
// (kPer = 8, a 2048-sample span, 48 registers): one block's loads run
// under another's arithmetic. Measured alternatives on the same card:
// kPer = 16 at three blocks an SM 0.315 ms; a persistent block that
// prefetched its next tile with cp.async 0.316 ms. A thread whose run
// lies wholly inside a stage's outputs takes a loop with no bounds and
// its look-backs at a fixed offset; that took the stages from ~0.08 to
// ~0.05 ms.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;           // threads a block
constexpr int kPer = 8;                 // consecutive samples a thread owns
constexpr int kSpan = kThreads * kPer;  // samples a block stages
constexpr int kPadded = kSpan + kSpan / kPer;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSM = 5;         // resident blocks the design wants

// the padded word of span sample m
__device__ __forceinline__ int pad(int m) {
  return m + (int)((unsigned)m / kPer);
}

// arg(a conj(b)), as parallel/chain.py freq_demod_planar rounds it
__device__ __forceinline__ float discriminate(float2 a, float2 b) {
  const float re = __fadd_rn(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y));
  const float im = __fsub_rn(__fmul_rn(a.y, b.x), __fmul_rn(a.x, b.y));
  return atan2f(im, re);
}

struct Args {
  const float2* __restrict__ x;     // [C, T]
  const float2* __restrict__ last;  // [C]
  const float* __restrict__ hists;  // [casc, C, D]
  float* __restrict__ y;            // [C, T]
  float2* __restrict__ last_out;    // [C]
  float* __restrict__ hists_out;    // [casc, C, D]
  int C, T, D, casc, B, ntiles;
};

// avg = f32(window) / D, as the plain version rounds it: a product by the
// exact reciprocal where D is a power of two (POW2), else a division
template <bool POW2>
__device__ __forceinline__ float average(double window, float fd, float inv) {
  const float w = __double2float_rn(window);
  return POW2 ? __fmul_rn(w, inv) : __fdiv_rn(w, fd);
}

// Indices inside a block are ints (T < 2^31); i is a sample's place in
// its row, m = i - base its place in the span. A thread whose run lies
// wholly inside a stage's outputs (the bulk of the tile) takes the loop
// without bounds; the others, at the span's edges, the general one.
template <bool POW2>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    fm_demod_dc_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  // a stage's prefix, and after it a 0 for the prefix before the span
  double* P = reinterpret_cast<double*>(smem);
  float* U = reinterpret_cast<float*>(P + kPadded + 1);  // u, then y
  __shared__ double warp_total[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = blockIdx.x / a.ntiles;
  const int t0 = (blockIdx.x % a.ntiles) * a.B;
  const int T = a.T, D = a.D, casc = a.casc, dm1 = a.D - 1;
  const int e = min(t0 + a.B, T);
  const bool last_tile = e == T;
  // out_lo(s): stage s's first output; base: stage 0's first input
  auto out_lo = [&](int s) { return max(0, t0 - (casc - 1 - s) * dm1); };
  const int base = out_lo(0) - dm1;
  const int n = e - base;  // span samples in use, <= kSpan
  // in the row's last tile, the new histories start at m_keep (T - D)
  const int m_keep = T - D - base;
  const float2* xr = a.x + (long long)c * T;
  const float* hist0 = a.hists + (long long)c * D;

  // stage 0's input over the span, consecutive threads on consecutive
  // samples, every load of the thread issued first; x[i - 1] comes from
  // the lane before (lane 0 and i = 0 load it)
  {
    float2 xv[kPer];
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int m = q * kThreads + tid, i = base + m;
      xv[q] = m < n && i >= 0 ? xr[i] : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int m = q * kThreads + tid, i = base + m;
      float2 pv;
      pv.x = __shfl_up_sync(0xffffffffu, xv[q].x, 1);
      pv.y = __shfl_up_sync(0xffffffffu, xv[q].y, 1);
      if (m < n) {
        if (lane == 0 || i == 0) pv = i > 0 ? xr[i - 1] : a.last[c];
        U[pad(m)] = i < 0 ? hist0[D + i] : discriminate(xv[q], pv);
      }
    }
  }
  if (tid == 0) {
    P[kPadded] = 0.0;
    if (last_tile) a.last_out[c] = xr[T - 1];
  }
  __syncthreads();
  if (last_tile)
    for (int m = m_keep + tid; m < n; m += kThreads)
      a.hists_out[(long long)c * D + (m - m_keep)] = U[pad(m)];

  const int m_own = tid * kPer;  // this thread's first span sample
  const int own = pad(m_own);    // pad(m_own + j) = own + j
  float v[kPer];                 // its stage input, then its output
#pragma unroll
  for (int j = 0; j < kPer; ++j) v[j] = m_own + j < n ? U[own + j] : 0.f;
  const float fd = (float)D, inv = 1.0f / fd;  // exact where D = 2^k
  // the look-backs of a run start kPer-aligned where D is a multiple of kPer
  const bool aligned = D % kPer == 0;
  double p[kPer];
  // the span's prefix of v: this thread's run, then the threads before it
  auto prefix = [&]() {
    double acc = 0.0;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      acc += (double)v[j];
      p[j] = acc;
    }
    double inc = acc;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double nb = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc += nb;
    }
    if (lane == 31) warp_total[warp] = inc;
    __syncthreads();
    double off = inc - acc;
    for (int w = 0; w < warp; ++w) off += warp_total[w];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      p[j] += off;
      P[own + j] = p[j];
    }
    __syncthreads();
  };
  // the window of span sample m_own + j; below the span the prefix is 0
  auto window = [&](int j) {
    const int m = m_own + j;
    return p[j] - P[m >= D ? pad(m - D) : kPadded];
  };

  for (int s = 0; s + 1 < casc; ++s) {
    prefix();
    // outputs on [m_lo, n); the next stage's history fills
    // [m_next, m_zero) (its inputs below i = 0)
    const int m_lo = out_lo(s) - base, m_next = out_lo(s + 1) - dm1 - base;
    if (aligned && m_own >= max(m_lo, D) && m_own + kPer <= n) {
      const int lag = pad(m_own - D);
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        v[j] = average<POW2>(p[j] - P[lag + j], fd, inv);
    } else {
      const int m_zero = -base;
      const float* next_hist = a.hists + ((long long)(s + 1) * a.C + c) * D;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int m = m_own + j;
        if (m >= m_lo && m < n)
          v[j] = average<POW2>(window(j), fd, inv);
        else
          v[j] = m >= m_next && m < m_zero ? next_hist[D + m - m_zero] : 0.f;
      }
    }
    if (last_tile && m_own + kPer > m_keep) {
      float* next_out = a.hists_out + ((long long)(s + 1) * a.C + c) * D;
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        if (m_own + j >= m_keep && m_own + j < n)
          next_out[m_own + j - m_keep] = v[j];
    }
  }
  prefix();
  {
    // the tile's outputs: y = u delayed by D - 1, less the last average
    const int m_lo = t0 - base;
    if (aligned && m_own >= max(m_lo, D) && m_own + kPer <= n) {
      const int lag = pad(m_own - D);
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        v[j] = __fsub_rn(U[pad(m_own + j - dm1)],
                         average<POW2>(p[j] - P[lag + j], fd, inv));
    } else {
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int m = m_own + j;
        v[j] = m >= m_lo && m < n
                   ? __fsub_rn(U[pad(m - dm1)],
                               average<POW2>(window(j), fd, inv))
                   : 0.f;
      }
    }
  }

  // y through the float buffer, out coalesced
  __syncthreads();  // every delayed read of U is done
#pragma unroll
  for (int j = 0; j < kPer; ++j) U[own + j] = v[j];
  __syncthreads();
  float* yr = a.y + (long long)c * T;
  for (int m = t0 - base + tid; m < n; m += kThreads) yr[base + m] = U[pad(m)];
}

}  // namespace

// x [C, T, 2], last [C, 1, 2], hists [casc, C, D] -> y [C, T], last_out,
// hists_out (same layouts), contiguous f32, x and last 8-byte aligned;
// 1 <= D <= T < 2^31, casc >= 1, B a multiple of 32 with
// B + casc (D - 1) <= kSpan and ntiles = ceil(T / B) (kernels/fm_demod_dc.py
// `plan`), C * ntiles < 2^31. Returns cudaGetLastError() after the launch.
extern "C" int fm_demod_dc_f32(const float* x, const float* last,
                               const float* hists, float* y, float* last_out,
                               float* hists_out, long long C, long long T,
                               int D, int casc, int B, int ntiles,
                               void* stream) {
  if (C <= 0) return (int)cudaGetLastError();
  if (D < 1 || casc < 1 || T < D || T >= (1LL << 31) || B < 1 ||
      B % 32 != 0 || B + (long long)casc * (D - 1) > kSpan ||
      (long long)ntiles * B < T || (long long)(ntiles - 1) * B >= T ||
      C * ntiles >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  constexpr int kSmem = (kPadded + 1) * (int)sizeof(double) +
                        kPadded * (int)sizeof(float);
  const bool pow2 = (D & (D - 1)) == 0;
  auto kernel = pow2 ? fm_demod_dc_kernel<true> : fm_demod_dc_kernel<false>;
  static bool opted[2][64] = {};
  int devno = 0;
  cudaGetDevice(&devno);
  if (devno < 0 || devno >= 64) return (int)cudaErrorInvalidDevice;
  if (!opted[pow2][devno]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return (int)err;
    opted[pow2][devno] = true;
  }
  const Args a{reinterpret_cast<const float2*>(x),
               reinterpret_cast<const float2*>(last),
               hists,
               y,
               reinterpret_cast<float2*>(last_out),
               hists_out,
               (int)C,
               (int)T,
               D,
               casc,
               B,
               ntiles};
  kernel<<<(unsigned)(C * ntiles), kThreads, kSmem,
           static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
