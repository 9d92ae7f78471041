// Radix-2 FFT of rows held in shared memory: the device code that K2
// (fft.cu) and K3 (fir_fft_fused.cu) share.
//
// A block loads `rows` rows of n = 2^log2n complex samples into shared
// memory in bit-reversed order, then runs log2n in-place decimation-in-
// time stages over all rows at once, with a __syncthreads() between
// stages. `tw` holds n twiddles W[j] = exp(-+2 pi i j / n) for the
// requested direction, built in float64 on the host and rounded to f32.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace fftdev {

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// x [rows, n] (global) -> s [rows, n] (shared), each row bit-reversed.
__device__ __forceinline__ void load_bitrev(float2* s,
                                            const float2* __restrict__ x,
                                            int rows, int n, int log2n) {
  for (int i = threadIdx.x; i < rows * n; i += blockDim.x) {
    const int c = i & (n - 1);
    const int j = log2n ? (int)(__brev((unsigned)c) >> (32 - log2n)) : 0;
    s[i - c + j] = x[i];
  }
}

// The log2n stages over `rows` bit-reversed rows in s. Starts and ends
// with a __syncthreads(), so the caller may read s right after.
__device__ __forceinline__ void radix2_stages(float2* s,
                                              const float2* __restrict__ tw,
                                              int rows, int n, int log2n) {
  __syncthreads();
  const int half = n >> 1;
  for (int st = 0; st < log2n; ++st) {
    const int h = 1 << st;  // half-size of this stage's butterflies
    for (int i = threadIdx.x; i < rows * half; i += blockDim.x) {
      const int r = i >> (log2n - 1);
      const int b = i & (half - 1);
      const int pos = b & (h - 1);
      const int i0 = r * n + ((b >> st) << (st + 1)) + pos;
      // W_{2h}^{pos} = W_n^{pos * n / (2h)}
      const float2 w = __ldg(&tw[pos << (log2n - 1 - st)]);
      const float2 u = s[i0];
      const float2 t = cmul(s[i0 + h], w);
      s[i0] = make_float2(u.x + t.x, u.y + t.y);
      s[i0 + h] = make_float2(u.x - t.x, u.y - t.y);
    }
    __syncthreads();
  }
}

}  // namespace fftdev
