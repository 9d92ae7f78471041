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
// Design: one thread block per tile of rows (max(1, 2048 / N) rows, 8 KB
// of shared memory at N <= 2048, one row of N words above), so that an SM
// holds eight blocks and one block's loads overlap another's stores. Each
// thread moves up to eight groups of four consecutive words, its loads
// in flight together:
//  * 16-byte global loads and stores (float4) when both pointers are
//    16-byte aligned (N % 64 == 0 keeps every row aligned then); four
//    scalar accesses otherwise, with the same shared-memory pattern;
//  * the tile lies in shared memory in the XOR swizzle of smem_layout.cuh
//    for power-of-two N. Every warp's stores and each of its four reads
//    per output group (source words at stride 8, m or 4 m) then hit 32
//    distinct banks. The four sources of an output group differ from the
//    first on bits of their own (k*m for A and C, 8k for B and D), so a
//    thread swizzles one address per group and XORs in four offsets it
//    computed once;
//  * for other N (m not a power of two) sums carry across bits, so the
//    tile takes smem::pad and each source is addressed in full;
//  * no divide instruction: the row of an output and the (i, j) split by
//    m use smem::FastDiv magic numbers made on the host (a shift when N
//    is a power of two).

#include <cuda_runtime.h>
#include <stdint.h>

#include "smem_layout.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxN = 8192;        // the largest row, one row a tile
constexpr int kTileFloats = 2048;  // the tile of rows of N <= 2048
constexpr int kGroups = kMaxN / 4 / kThreads;  // per thread, at most 8

struct Geometry {
  unsigned n, m;
  smem::FastDiv by_n, by_m;
};

// source index, within its row, of output word o of the row
template <int MODE>
__device__ __forceinline__ unsigned source_index(unsigned o,
                                                 const Geometry& g) {
  if (MODE == 0) {  // A
    return (o & 7u) * g.m + (o >> 3);
  } else if (MODE == 2) {  // C
    const unsigned c = smem::div(o, g.by_m);
    const unsigned r = o - c * g.m;
    return (r & 7u) * g.m + (r >> 3) * 8u + c;
  } else {  // B and D
    const unsigned i = smem::div(o, g.by_m);
    return (o - i * g.m) * 8u + i;
  }
}

template <int MODE, bool POW2, bool VEC>
__global__ void __launch_bounds__(kThreads)
    layout_move_kernel(const float* __restrict__ x, float* __restrict__ y,
                       long long rows, int tile_rows, Geometry g) {
  extern __shared__ float s[];
  const long long r0 = (long long)blockIdx.x * tile_rows;
  const unsigned nr =
      (unsigned)(rows - r0 < tile_rows ? rows - r0 : tile_rows);
  const float* xt = x + r0 * g.n;
  float* yt = y + r0 * g.n;
  const unsigned groups = nr * g.n / 4;

  // all of a thread's loads are issued before its first shared store
  float4 in[kGroups];
#pragma unroll
  for (int u = 0; u < kGroups; ++u) {
    const unsigned q = threadIdx.x + u * kThreads;
    if (q >= groups) break;
    if (VEC) {
      in[u] = reinterpret_cast<const float4*>(xt)[q];
    } else {
      in[u] = make_float4(xt[4 * q], xt[4 * q + 1], xt[4 * q + 2],
                          xt[4 * q + 3]);
    }
  }
#pragma unroll
  for (int u = 0; u < kGroups; ++u) {
    const unsigned q = threadIdx.x + u * kThreads;
    if (q >= groups) break;
    const float4 v = in[u];
    // the four words of a group stay in their 32-word line under both
    // layouts, so their addresses follow from the first's
    if (POW2) {
      const unsigned p = smem::swz(4 * q);
      s[p] = v.x;
      s[p ^ 1u] = v.y;
      s[p ^ 2u] = v.z;
      s[p ^ 3u] = v.w;
    } else {
      const unsigned p = smem::pad(4 * q);
      s[p] = v.x;
      s[p + 1] = v.y;
      s[p + 2] = v.z;
      s[p + 3] = v.w;
    }
  }
  __syncthreads();

  // power-of-two N: source of output o + k = source of o XOR (k*m or 8k)
  unsigned d1 = 0, d2 = 0, d3 = 0;
  if (POW2) {
    const unsigned step = (MODE == 0 || MODE == 2) ? g.m : 8u;
    d1 = smem::swz(step);
    d2 = smem::swz(2 * step);
    d3 = smem::swz(3 * step);
  }
#pragma unroll
  for (int u = 0; u < kGroups; ++u) {
    const unsigned q = threadIdx.x + u * kThreads;
    if (q >= groups) break;
    const unsigned o = 4 * q;
    const unsigned row = smem::div(o, g.by_n);
    const unsigned base = row * g.n;
    const unsigned oi = o - base;
    float4 v;
    if (POW2) {
      const unsigned p = smem::swz(base + source_index<MODE>(oi, g));
      v = make_float4(s[p], s[p ^ d1], s[p ^ d2], s[p ^ d3]);
    } else {
      v = make_float4(s[smem::pad(base + source_index<MODE>(oi, g))],
                      s[smem::pad(base + source_index<MODE>(oi + 1, g))],
                      s[smem::pad(base + source_index<MODE>(oi + 2, g))],
                      s[smem::pad(base + source_index<MODE>(oi + 3, g))]);
    }
    if (VEC) {
      reinterpret_cast<float4*>(yt)[q] = v;
    } else {
      yt[o] = v.x;
      yt[o + 1] = v.y;
      yt[o + 2] = v.z;
      yt[o + 3] = v.w;
    }
  }
}

template <int MODE>
void launch(const float* x, float* y, long long rows, int tile_rows,
            const Geometry& g, bool pow2, bool vec, unsigned blocks,
            size_t smem, cudaStream_t st) {
  if (pow2 && vec)
    layout_move_kernel<MODE, true, true>
        <<<blocks, kThreads, smem, st>>>(x, y, rows, tile_rows, g);
  else if (pow2)
    layout_move_kernel<MODE, true, false>
        <<<blocks, kThreads, smem, st>>>(x, y, rows, tile_rows, g);
  else if (vec)
    layout_move_kernel<MODE, false, true>
        <<<blocks, kThreads, smem, st>>>(x, y, rows, tile_rows, g);
  else
    layout_move_kernel<MODE, false, false>
        <<<blocks, kThreads, smem, st>>>(x, y, rows, tile_rows, g);
}

}  // namespace

// x, y [rows, n] contiguous f32; 64 <= n <= 8192, n % 64 == 0;
// mode 0..3 = A..D. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a shape or mode the kernel does not take.
extern "C" int layout_move_f32(const float* x, float* y, long long rows,
                               int n, int mode, void* stream) {
  if (n < 64 || n > kMaxN || n % 64 != 0 || mode < 0 || mode > 3)
    return (int)cudaErrorInvalidValue;
  if (rows <= 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tile_rows = n < kTileFloats ? kTileFloats / n : 1;
  const unsigned blocks = (unsigned)((rows + tile_rows - 1) / tile_rows);
  const unsigned un = (unsigned)n;
  const Geometry g{un, un / 8, smem::make_fastdiv(un),
                   smem::make_fastdiv(un / 8)};
  const bool pow2 = (un & (un - 1)) == 0;
  const unsigned words = (unsigned)tile_rows * un;
  const size_t smem_bytes =
      (pow2 ? words : smem::pad(words - 1) + 1) * sizeof(float);
  const bool vec = ((reinterpret_cast<uintptr_t>(x) |
                     reinterpret_cast<uintptr_t>(y)) & 15) == 0;
  switch (mode) {
    case 0:
      launch<0>(x, y, rows, tile_rows, g, pow2, vec, blocks, smem_bytes, st);
      break;
    case 2:
      launch<2>(x, y, rows, tile_rows, g, pow2, vec, blocks, smem_bytes, st);
      break;
    default:
      launch<1>(x, y, rows, tile_rows, g, pow2, vec, blocks, smem_bytes, st);
      break;
  }
  return (int)cudaGetLastError();
}
