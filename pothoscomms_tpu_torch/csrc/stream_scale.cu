// P1: the streaming ceiling probe, y = 2 x on two f32 planes [B, N].
//
// Replaces the TPU kernel `scale_pallas` / `_scale_kernel`
// (benches/probe_pallas_ceiling.py:17-40), which asked how fast a
// trivial Pallas kernel streams HBM on the TPU at row tiles
// tb in {128, 256, 512}. Here it asks the same of the H100: the roof a
// streaming kernel of this repo can reach, against which the FFT and
// FIR kernels' bytes per second are read.
//
// What bounds it on the H100: bytes only, 16 B moved per 2 flops (two
// planes in, two out). 3.35 TB/s published at 700 W.
//
// Design: the grid fills the card, whatever tb is. Both planes are one
// flat range of B * N elements, cut into equal units of at least
// kThreads vectors, one block a unit; the wrapper asks for 16 waves of
// the card's resident blocks (SMs x 8 blocks of 256 threads,
// kernels/stream_scale.py `UNITS_PER_SM`), ~500 float4 a unit at the
// probe's [32768, 1024] (tests/test_torch_redesign_k1_p1.py mirrors the
// map). Small units taken in block order sweep memory nearly in address
// order; one resident wave of large units, each block on its own
// stretch of both planes, streamed slower (PERF.md). The probe's row
// tile tb does not enter the launch: a grid that fills the card splits
// every tile of the probe (256 at tb 128) across many blocks anyway, so
// the three tb of the probe run the same kernel. A thread keeps
// kUnroll independent loads per plane in flight before its stores, with
// streaming (evict-first) cache hints, since nothing is read twice.
// float4 when N % 4 == 0 and every pointer is 16-byte aligned, else
// scalars. x 2 is exact in f32, so the result equals the plain version
// bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

__device__ __forceinline__ float twice(float v) { return v * 2.f; }
__device__ __forceinline__ float4 twice(float4 v) {
  return make_float4(v.x * 2.f, v.y * 2.f, v.z * 2.f, v.w * 2.f);
}

// V is float4 or float; block b takes [b chunk, (b + 1) chunk) of the
// `total` elements of each plane.
template <typename V>
__global__ void __launch_bounds__(kThreads)
stream_scale_kernel(const V* __restrict__ xr, const V* __restrict__ xi,
                    V* __restrict__ yr, V* __restrict__ yi, long long total,
                    long long chunk) {
  const long long b = blockIdx.x * chunk;
  const long long e = b + chunk < total ? b + chunk : total;
  for (long long i = b + threadIdx.x; i < e; i += kUnroll * kThreads) {
    V a[kUnroll], c[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const long long k = i + j * kThreads;
      if (k < e) {
        a[j] = __ldcs(xr + k);
        c[j] = __ldcs(xi + k);
      }
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const long long k = i + j * kThreads;
      if (k < e) {
        __stcs(yr + k, twice(a[j]));
        __stcs(yi + k, twice(c[j]));
      }
    }
  }
}

// [grid, chunk] of a launch over `total` elements in at most `units`
// blocks (the wrapper's target)
void plan(long long total, int units, long long* grid, long long* chunk) {
  *chunk = (total + units - 1) / units;
  if (*chunk < kThreads) *chunk = kThreads;
  *grid = (total + *chunk - 1) / *chunk;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// xr, xi, yr, yi [rows, n] contiguous f32; at most `units` blocks.
// Returns cudaGetLastError() after the launch.
extern "C" int stream_scale_f32(const float* xr, const float* xi, float* yr,
                                float* yi, long long rows, long long n,
                                int units, void* stream) {
  if (rows <= 0 || n <= 0 || units <= 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  long long grid, chunk;
  if (n % 4 == 0 && aligned16(xr) && aligned16(xi) && aligned16(yr) &&
      aligned16(yi)) {
    plan(rows * n / 4, units, &grid, &chunk);
    stream_scale_kernel<float4><<<(unsigned)grid, kThreads, 0, st>>>(
        reinterpret_cast<const float4*>(xr),
        reinterpret_cast<const float4*>(xi), reinterpret_cast<float4*>(yr),
        reinterpret_cast<float4*>(yi), rows * n / 4, chunk);
  } else {
    plan(rows * n, units, &grid, &chunk);
    stream_scale_kernel<float><<<(unsigned)grid, kThreads, 0, st>>>(
        xr, xi, yr, yi, rows * n, chunk);
  }
  return (int)cudaGetLastError();
}
