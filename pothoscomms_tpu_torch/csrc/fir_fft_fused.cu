// K3: the one-pass FIR+FFT step in circular-correction form. For each
// window b of n complex samples:
//
//   y[b, j] = FFT(x[b])[j] * H[j] + sum_m uw[b, m] * Gc[m, j]
//
// where H = FFT(taps) and the correction turns the circular convolution
// into the linear one (uw[b] = previous window's tail minus this
// window's own tail, zero-padded at the front to pp). Output in natural
// bin order; with uw == nullptr the correction is skipped.
//
// Replaces the TPU kernel `fir_fft_fused_pallas` / `_fir_fft_fused_kernel`
// (pothoscomms_tpu/parallel/pallas_kernels.py:257-367). What it computes
// is carried over, not how: the Pallas kernel's DIF 8x128 split, its
// [B, 128, 8] output layout, the m-major H / Gc layouts and the static
// chunk loop are workarounds for Mosaic's reshape and VMEM limits and
// are not copied.
//
// Layout: x, y [B, n, 2] and uw [B, pp, 2] are interleaved complex f32;
// H [n, 2] interleaved; Gc as real planes gcr, gci [pp, n]; tw the n-entry
// twiddle table of K2. H, Gc and tw are built in float64 on the host and
// rounded to f32 once.
//
// What bounds it on the H100: at the main path's width (B = 32768
// windows of n = 1024, pp = 64) it moves ~0.55 GB (268 MB in, 16.8 MB of
// uw, 268 MB out), ~0.16 ms at 3.35 TB/s; the correction costs 8 flops x
// pp x n per window, 17.2 GFLOP, >= 0.26 ms at the 67 TFLOP/s f32 SIMT
// peak; the FFT ~1.7 GFLOP. On paper the correction's flops bound it.
// Measured on an H100 SXM at 700 W: 1.19 ms, of which the kernel without
// uw takes 0.70 ms and the correction ~0.49 ms (35 TFLOP/s): the radix-2
// stages in shared memory, a __syncthreads() each, bound this design.
//
// Simple design: one 256-thread block per WPB = 4 windows. The windows
// (8 KB each at n = 1024) and their uw rows sit in shared memory; the
// radix-2 stages of fft_radix2.cuh (shared with K2) run over all four at
// once. Then each thread owns bins j = tid, tid + 256, ...: it multiplies
// the four spectra by H[j] and adds the correction for its bins, reading
// Gc[m, j] coalesced (Gc, 512 KB, stays in L2) once for all four windows
// and uw[w, m] as a shared-memory broadcast. Each spectrum is written
// once. Every FMA is full f32.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fft_radix2.cuh"

namespace {

constexpr int WPB = 4;        // windows per block
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
fir_fft_fused_kernel(const float2* __restrict__ x,
                     const float2* __restrict__ uw,
                     const float2* __restrict__ H,
                     const float* __restrict__ gcr,
                     const float* __restrict__ gci,
                     const float2* __restrict__ tw,
                     float2* __restrict__ y, long long B, int n, int log2n,
                     int pp) {
  extern __shared__ float2 smem[];
  float2* s = smem;             // WPB rows of n (bit-reversed, then spectra)
  float2* su = smem + WPB * n;  // WPB rows of pp
  const long long b0 = (long long)blockIdx.x * WPB;
  const int rows = (int)(B - b0 < WPB ? B - b0 : WPB);
  fftdev::load_bitrev(s, x + b0 * n, rows, n, log2n);
  if (uw != nullptr) {
    for (int i = threadIdx.x; i < WPB * pp; i += blockDim.x)
      su[i] = i < rows * pp ? uw[b0 * pp + i] : make_float2(0.f, 0.f);
  }
  fftdev::radix2_stages(s, tw, rows, n, log2n);  // syncs su as well
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const float2 h = __ldg(&H[j]);
    float2 acc[WPB];
#pragma unroll
    for (int r = 0; r < WPB; ++r)
      acc[r] = r < rows ? fftdev::cmul(s[r * n + j], h)
                        : make_float2(0.f, 0.f);
    if (uw != nullptr) {
      for (int m = 0; m < pp; ++m) {
        const float gr = __ldg(&gcr[(int64_t)m * n + j]);
        const float gi = __ldg(&gci[(int64_t)m * n + j]);
#pragma unroll
        for (int r = 0; r < WPB; ++r) {
          const float2 u = su[r * pp + m];
          acc[r].x = fmaf(u.x, gr, fmaf(-u.y, gi, acc[r].x));
          acc[r].y = fmaf(u.x, gi, fmaf(u.y, gr, acc[r].y));
        }
      }
    }
#pragma unroll
    for (int r = 0; r < WPB; ++r)
      if (r < rows) y[(b0 + r) * n + j] = acc[r];
  }
}

}  // namespace

// x, y [B, n, 2]; uw [B, pp, 2] or null; H [n, 2]; gcr, gci [pp, n];
// tw [n, 2]. n a power of two, 2 <= n <= 1024; 0 <= pp <= 256 (so the
// shared memory stays under the 48 KB default). Returns
// cudaGetLastError() after the launch.
extern "C" int fir_fft_fused_f32(const float* x, const float* uw,
                                 const float* H, const float* gcr,
                                 const float* gci, const float* tw, float* y,
                                 long long B, int n, int pp, void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  int log2n = 0;
  while ((1 << log2n) < n) ++log2n;
  const long long blocks = (B + WPB - 1) / WPB;
  const size_t smem = (size_t)WPB * (n + pp) * sizeof(float2);
  fir_fft_fused_kernel<<<(unsigned)blocks, THREADS, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float2*>(x), reinterpret_cast<const float2*>(uw),
      reinterpret_cast<const float2*>(H), gcr, gci,
      reinterpret_cast<const float2*>(tw), reinterpret_cast<float2*>(y), B,
      n, log2n, pp);
  return (int)cudaGetLastError();
}
