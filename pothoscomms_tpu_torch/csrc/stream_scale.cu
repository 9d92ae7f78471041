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
// Simple design: one thread block per tile of `rows_per_block` rows (the
// probe's tb), both planes; the tile is one flat range of rows * N
// floats, walked with float4 loads and stores when N % 4 == 0 and every
// pointer is 16-byte aligned, else with scalar ones. x 2 is exact in
// f32, so the result equals the plain version bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void stream_scale_vec4(const float4* __restrict__ xr,
                                  const float4* __restrict__ xi,
                                  float4* __restrict__ yr,
                                  float4* __restrict__ yi, long long rows,
                                  long long n4, int rows_per_block) {
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 =
      r0 + rows_per_block < rows ? r0 + rows_per_block : rows;
  const long long end = r1 * n4;
#pragma unroll 4
  for (long long i = r0 * n4 + threadIdx.x; i < end; i += blockDim.x) {
    float4 a = xr[i];
    float4 b = xi[i];
    a.x *= 2.f; a.y *= 2.f; a.z *= 2.f; a.w *= 2.f;
    b.x *= 2.f; b.y *= 2.f; b.z *= 2.f; b.w *= 2.f;
    yr[i] = a;
    yi[i] = b;
  }
}

__global__ void stream_scale_scalar(const float* __restrict__ xr,
                                    const float* __restrict__ xi,
                                    float* __restrict__ yr,
                                    float* __restrict__ yi, long long rows,
                                    long long n, int rows_per_block) {
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 =
      r0 + rows_per_block < rows ? r0 + rows_per_block : rows;
  const long long end = r1 * n;
  for (long long i = r0 * n + threadIdx.x; i < end; i += blockDim.x) {
    yr[i] = xr[i] * 2.f;
    yi[i] = xi[i] * 2.f;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// xr, xi, yr, yi [rows, n] contiguous f32; rows_per_block >= 1. Returns
// cudaGetLastError() after the launch.
extern "C" int stream_scale_f32(const float* xr, const float* xi, float* yr,
                                float* yi, long long rows, long long n,
                                int rows_per_block, void* stream) {
  if (rows <= 0 || n <= 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long blocks = (rows + rows_per_block - 1) / rows_per_block;
  if (n % 4 == 0 && aligned16(xr) && aligned16(xi) && aligned16(yr) &&
      aligned16(yi)) {
    stream_scale_vec4<<<(unsigned)blocks, kThreads, 0, st>>>(
        reinterpret_cast<const float4*>(xr),
        reinterpret_cast<const float4*>(xi), reinterpret_cast<float4*>(yr),
        reinterpret_cast<float4*>(yi), rows, n / 4, rows_per_block);
  } else {
    stream_scale_scalar<<<(unsigned)blocks, kThreads, 0, st>>>(
        xr, xi, yr, yi, rows, n, rows_per_block);
  }
  return (int)cudaGetLastError();
}
