// K2: batched complex FFT, x [B, n] -> y [B, n], complex f32, forward
// (plain DFT) or unnormalized inverse, output in natural order.
//
// Replaces the TPU kernel `fft_fused_pallas` / `_fft_fused_kernel`
// (pothoscomms_tpu/parallel/pallas_kernels.py:97-185) and its wrapper
// `fft_planar_fused` (:200-227). The TPU kernel's 8x128 two-stage DFT
// split exists for the TPU's 128-wide matrix unit and is not copied.
//
// Layout: x and y are interleaved complex ([B, n, 2] float32, i.e.
// complex64). `tw` holds n twiddles W[j] = exp(-+2 pi i j / n) for the
// requested direction, computed in float64 on the host and rounded to
// f32, so no twiddle carries sin/cos error from the device.
//
// What bounds it on the H100: an FFT does 5 n log2 n flops per 16 n
// bytes moved, so at n = 1024 it is HBM-bound (3.35 TB/s published);
// the row fits in shared memory, so each sample is read and written once.
//
// Simple design: one thread block per row, the row in shared memory.
//  * n a power of two (the FFT block's 16..4096 range included):
//    bit-reversed load, then log2 n in-place radix-2 DIT stages with a
//    __syncthreads() between stages (fft_radix2.cuh, shared with K3).
//  * any other n up to 4096: a direct O(n^2) DFT, each thread one output
//    bin, indexing the n-entry twiddle table (staged in shared memory)
//    by (j * k) mod n, accumulated incrementally without a multiply.
// Shared memory is dynamic; the DFT path needs 16 n bytes (64 KB at
// n = 4096), above the 48 KB default, so the launcher raises the limit.
// Rows longer than 4096 are split into two factors by the caller
// (parallel/fft.py), each factor's FFTs running here.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fft_radix2.cuh"

namespace {

__global__ void fft_radix2_kernel(const float2* __restrict__ x,
                                  float2* __restrict__ y,
                                  const float2* __restrict__ tw, int n,
                                  int log2n) {
  extern __shared__ float2 s[];
  const float2* xr = x + (int64_t)blockIdx.x * n;
  float2* yr = y + (int64_t)blockIdx.x * n;
  fftdev::load_bitrev(s, xr, 1, n, log2n);
  fftdev::radix2_stages(s, tw, 1, n, log2n);
  for (int i = threadIdx.x; i < n; i += blockDim.x) yr[i] = s[i];
}

__global__ void dft_kernel(const float2* __restrict__ x,
                           float2* __restrict__ y,
                           const float2* __restrict__ tw, int n) {
  extern __shared__ float2 s[];
  float2* sx = s;       // the row
  float2* stw = s + n;  // the twiddle table
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

// x, y [B, n, 2]; tw [n, 2]; 1 <= n <= 4096. Returns cudaGetLastError()
// after the launch (or the error of raising the shared-memory limit).
extern "C" int fft_c2c_f32(const float* x, float* y, const float* tw,
                           long long B, int n, void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float2* x2 = reinterpret_cast<const float2*>(x);
  float2* y2 = reinterpret_cast<float2*>(y);
  const float2* tw2 = reinterpret_cast<const float2*>(tw);
  const bool pow2 = (n & (n - 1)) == 0;
  if (pow2) {
    int log2n = 0;
    while ((1 << log2n) < n) ++log2n;
    int threads = n / 2;
    if (threads < 32) threads = 32;
    if (threads > 512) threads = 512;
    const size_t smem = (size_t)n * sizeof(float2);
    fft_radix2_kernel<<<(unsigned)B, threads, smem, st>>>(x2, y2, tw2, n, log2n);
  } else {
    int threads = ((n + 31) / 32) * 32;
    if (threads > 256) threads = 256;
    const size_t smem = 2 * (size_t)n * sizeof(float2);
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          dft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    dft_kernel<<<(unsigned)B, threads, smem, st>>>(x2, y2, tw2, n);
  }
  return (int)cudaGetLastError();
}
