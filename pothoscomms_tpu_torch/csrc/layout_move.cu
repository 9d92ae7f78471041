// P2: the layout-move probe, four in-row permutations of x [B, N] f32.
//
// Replaces the TPU kernel `try_kernel.run` (benches/probe_mosaic.py:24-32)
// with its four bodies (:55, :61, :67-68, :75), which asked which
// in-kernel layout moves Mosaic accepts. Here the question is what each
// move costs on the H100 against a plain copy (P1): these are the data
// moves of a register-resident radix-8/16 FFT. With m = N / 8:
//   A  (8, m) swap -> (m, 8):          y[j*8 + i]        = x[i*m + j]
//   B  (m, 8) swap -> (8, m):          y[i*m + j]        = x[j*8 + i]
//   C  (8, m/8, 8) transpose (0,3,2,1): y[c*m + b*8 + a] = x[a*m + b*8 + c]
//   D  stride-8 lane gather x[:, k::8]:  the same map as B, reached as a
//      gather in the probe
// so N must be a multiple of 64.
//
// What bounds it on the H100: bytes, 8 per element (one read, one
// write), the same roof as P1.
//
// Simple design: one thread block per tile of rows (8192 / N rows, 32 KB
// of shared memory). The tile is loaded coalesced into shared memory and
// written out coalesced, each thread reading its element's source from
// shared memory. The reads of A (stride m) and of B, C, D (stride 8)
// conflict on the shared-memory banks: written down, not fixed here
// (padding or a swizzle is later work).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileFloats = 8192;  // 32 KB of shared memory per block

template <int MODE>
__device__ __forceinline__ int source_index(int o, int m) {
  if (MODE == 0) {  // A
    return (o & 7) * m + (o >> 3);
  } else if (MODE == 2) {  // C
    const int c = o / m;
    const int r = o - c * m;
    return (r & 7) * m + (r >> 3) * 8 + c;
  } else {  // B and D
    const int i = o / m;
    return (o - i * m) * 8 + i;
  }
}

template <int MODE>
__global__ void layout_move_kernel(const float* __restrict__ x,
                                   float* __restrict__ y, long long rows,
                                   int n, int tile_rows) {
  __shared__ float s[kTileFloats];
  const long long r0 = (long long)blockIdx.x * tile_rows;
  const int nr = (int)(rows - r0 < tile_rows ? rows - r0 : tile_rows);
  const float* xt = x + r0 * n;
  float* yt = y + r0 * n;
  const int total = nr * n;
  for (int i = threadIdx.x; i < total; i += blockDim.x) s[i] = xt[i];
  __syncthreads();
  const int m = n >> 3;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int r = i / n;
    const int o = i - r * n;
    yt[i] = s[r * n + source_index<MODE>(o, m)];
  }
}

}  // namespace

// x, y [rows, n] contiguous f32; 64 <= n <= 8192, n % 64 == 0;
// mode 0..3 = A..D. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a shape or mode the kernel does not take.
extern "C" int layout_move_f32(const float* x, float* y, long long rows,
                               int n, int mode, void* stream) {
  if (n < 64 || n > kTileFloats || n % 64 != 0 || mode < 0 || mode > 3)
    return (int)cudaErrorInvalidValue;
  if (rows <= 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tile_rows = kTileFloats / n;
  const unsigned blocks = (unsigned)((rows + tile_rows - 1) / tile_rows);
  switch (mode) {
    case 0:
      layout_move_kernel<0><<<blocks, kThreads, 0, st>>>(x, y, rows, n,
                                                          tile_rows);
      break;
    case 2:
      layout_move_kernel<2><<<blocks, kThreads, 0, st>>>(x, y, rows, n,
                                                          tile_rows);
      break;
    default:
      layout_move_kernel<1><<<blocks, kThreads, 0, st>>>(x, y, rows, n,
                                                          tile_rows);
      break;
  }
  return (int)cudaGetLastError();
}
