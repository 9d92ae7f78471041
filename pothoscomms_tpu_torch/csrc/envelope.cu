// E1: the attack/release envelope follower over rows of a [P, T] block,
// env' = g env + (1 - g) x with g = ga if x > env else gr.
//
// Not a Pallas kernel: it replaces the XLA scans that the JAX package
// runs for the envelope, `envelope_scan` and `envelope_blocked`
// (pothoscomms_tpu/ops/filter.py:378-391, 403-453) and the unblocked
// branch of `EnvelopeDetector.device_core` (blocks/filter.py:933-941).
// XLA compiles those scans into an on-device loop; PyTorch has none,
// and its eager loop costs several launches per time step.
//
// One kernel serves both forms. Row (p, b), b < nb = T / L, reads
// xfull[p, b*L + j] for j = 0 .. Wr+L-1, where xfull[p, i] = env0[p]
// for i < Wr and mag[p, i - Wr] after; it starts from e = xfull[p, b*L]
// for b > 0 and from e = env0[p] for b = 0 (both the JAX `e_init =
// xt[0]` when Wr > 0), steps on every j (j = 0 included) and writes
// y[p, b*L + j - Wr] for j >= Wr. env_f[p] is the last row's final
// state. L = T, Wr = 0 is then the plain sequential scan, which starts
// from env0 (`envelope_scan`).
//
// What bounds it on the H100: the latency of one row's chain of Wr + L
// dependent steps; the rows run in parallel, one a thread. The design
// keeps everything but the arithmetic off that chain.
//  * The step. With oma = 1 - ga and omr = 1 - gr hoisted, a step forms
//    pa = oma x and pr = omr x (they do not depend on e), then
//    ea = ga e + pa, er = gr e + pr and e = x > e ? ea : er: a product, a
//    sum and a select on the chain (the compare runs beside the product
//    and the sum). Every operation is rounded alone (round-to-nearest
//    intrinsics, so nvcc contracts nothing into an FMA), which makes the
//    result bit for bit that of g = x > e ? ga : gr; e = g e + (1 - g) x,
//    the JAX order; NaN and x == e take the release branch in both.
//  * Two warps a block, 32 rows. Warp 0 only steps: a warp runs its
//    instructions in order, so every one it spends on addresses, copies
//    and stores would sit between two steps of its chain. Warp 1 moves the
//    data: loads into a ring of tiles in shared memory, results out of a
//    pair of tiles. They meet at one named barrier a tile.
//  * A tile is 32 rows x 32 steps, 128 bytes a row. Warp 1 fetches it with
//    cp.async, 16 bytes a lane, eight lanes on one row's 128-byte line
//    (whole lines, where a lane reading its own row would touch 32 lines
//    a step), into a ring of kStages tiles: while tile k is stepped, tiles
//    k + 1 .. k + kStages - 2 are landing or have landed, and the slot
//    that tile k - 1 left is refilled. The warm-up steps read the same
//    ring and store nothing.
//  * The tile's layout. cp.async's 16-byte chunks must stay aligned, so
//    a row is not padded; chunk c of row r sits at chunk c ^ (r & 7) of
//    its row. A lane reads its row four samples at a time (all eight
//    16-byte loads before the tile's first step, so none waits behind a
//    store of results); the eight lanes of a quarter warp hit eight
//    distinct 16-byte bank groups, as do the eight lanes that copy one
//    row's line in or out.
//  * Results go to a second swizzled tile (two, taken in turn) and leave
//    as whole lines, 16 bytes a lane, while the next tile is stepped.
//  * Rows that do not start on a 16-byte boundary (odd L or Wr, a view
//    of mag off a boundary) take the scalar variant of the same kernel,
//    picked from the addresses at launch: 4-byte cp.async, a lane a
//    column, one row's 128 bytes an instruction; same ring, same steps.
//  * One stepping warp a block, so the chains spread over every SM.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;   // rows a warp carries, one a lane
constexpr int kTile = 32;    // steps a tile
constexpr int kChunks = kTile / 4;  // 16-byte chunks in a tile's row
constexpr int kStages = 4;   // input tiles in the ring
constexpr int kTileWords = kLanes * kTile;

// word of (row r, column col) in a swizzled tile
__device__ __forceinline__ int tile_word(int r, int col) {
  return r * kTile + ((((col >> 2) ^ r) & (kChunks - 1)) << 2) + (col & 3);
}

__device__ __forceinline__ void cp_async16(float* smem, const float* g) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(g)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* smem, const float* g) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(g)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct Gains {
  float ga, gr, oma, omr;
};

// one step; bit for bit g = x > e ? ga : gr; g e + (1 - g) x
__device__ __forceinline__ float follow(float e, float x, const Gains& g) {
  const float pa = __fmul_rn(g.oma, x), pr = __fmul_rn(g.omr, x);
  const float ea = __fadd_rn(__fmul_rn(g.ga, e), pa);
  const float er = __fadd_rn(__fmul_rn(g.gr, e), pr);
  return x > e ? ea : er;
}

// The 32 steps of one tile on this lane's row: column c is step j0 + c.
// PREFIX: columns below `from` step on e0 (the constant prefix of xfull).
// FULL: the tile ends inside the row; else columns from `to` on are past
// the row's end. Results go to `out` when `keep`. The row's 32 samples are
// read before the first step, so no shared load waits behind a store of
// results.
template <bool FULL, bool PREFIX>
__device__ __forceinline__ float step_tile(const float* __restrict__ in,
                                           float* __restrict__ out, int lane,
                                           int from, int to, bool keep,
                                           float e0, const Gains& g,
                                           float e) {
  float4 xv[kChunks];
#pragma unroll
  for (int ch = 0; ch < kChunks; ++ch)
    xv[ch] = *reinterpret_cast<const float4*>(
        in + lane * kTile + ((ch ^ (lane & (kChunks - 1))) << 2));
#pragma unroll
  for (int ch = 0; ch < kChunks; ++ch) {
    const float xs[4] = {xv[ch].x, xv[ch].y, xv[ch].z, xv[ch].w};
    float o[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = 4 * ch + q;
      const float x = !PREFIX || c >= from ? xs[q] : e0;
      if (FULL || c < to) e = follow(e, x, g);
      o[q] = e;
    }
    if (keep)
      *reinterpret_cast<float4*>(
          out + lane * kTile + ((ch ^ (lane & (kChunks - 1))) << 2)) =
          make_float4(o[0], o[1], o[2], o[3]);
  }
  return e;
}

// the block's two warps meet here once a tile
__device__ __forceinline__ void tile_barrier() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(2 * kLanes) : "memory");
}

template <bool ALIGNED>
__global__ void __launch_bounds__(2 * kLanes)
    envelope_rows_kernel(const float* __restrict__ mag,
                         const float* __restrict__ env0,
                         float* __restrict__ y, float* __restrict__ env_f,
                         long long P, long long T, long long L, long long Wr,
                         float ga, float gr) {
  __shared__ __align__(16) float ring[kStages][kTileWords];
  __shared__ __align__(16) float outs[2][kTileWords];
  const int lane = threadIdx.x & (kLanes - 1);
  const bool stepper = threadIdx.x < kLanes;  // warp 0 steps, warp 1 moves
  const long long nb = T / L;
  const long long nsteps = Wr + L;
  const long long ntiles = (nsteps + kTile - 1) / kTile;
  const long long row = (long long)blockIdx.x * kLanes + lane;
  const bool valid = row < P * nb;
  const long long p = valid ? row / nb : 0;
  const long long b = valid ? row - p * nb : 0;
  const long long base = b * L;
  // step j of this row reads mag[start + j] and, from j = Wr on, writes
  // y[start + j]; steps below first = max(0, Wr - base) read the prefix.
  // A row past the end has first = nsteps: nothing is loaded or stored.
  const long long start = p * T + base - Wr;
  const long long first = !valid ? nsteps : base < Wr ? Wr - base : 0;

  if (stepper) {
    const float e0 = valid ? env0[p] : 0.f;
    const Gains g{ga, gr, __fsub_rn(1.0f, ga), __fsub_rn(1.0f, gr)};
    float e = (!valid || b == 0 || base < Wr) ? e0 : mag[start];
    for (long long k = 0; k < ntiles; ++k) {
      tile_barrier();  // tile k has landed; outs[k & 1] has left
      const long long j0 = k * kTile;
      const float* in = ring[k % kStages];
      float* out = outs[k & 1];
      const bool keep = j0 + kTile > Wr;  // the tile holds steps that store
      if (j0 >= Wr && j0 + kTile <= nsteps) {
        e = step_tile<true, false>(in, out, lane, 0, kTile, true, e0, g, e);
      } else {
        const int from = (int)(first - j0 < 0 ? 0 : first - j0 > kTile
                                                       ? kTile : first - j0);
        const int to = (int)(nsteps - j0 > kTile ? kTile : nsteps - j0);
        e = to == kTile
                ? step_tile<true, true>(in, out, lane, from, to, keep, e0, g, e)
                : step_tile<false, true>(in, out, lane, from, to, keep, e0, g,
                                         e);
      }
    }
    tile_barrier();  // the last tile's results are whole
    if (valid && b == nb - 1) env_f[p] = e;
    return;
  }

  // the mover. ALIGNED: this lane copies chunk lane & 7 of rows
  // (lane >> 3) + 4 i, in and out
  const int ch = lane & (kChunks - 1);
  long long cstart[kChunks], cfirst[kChunks];
  if (ALIGNED) {
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      cstart[i] = __shfl_sync(0xffffffffu, start, (lane >> 3) + 4 * i);
      cfirst[i] = __shfl_sync(0xffffffffu, first, (lane >> 3) + 4 * i);
    }
  }
  auto load = [&](long long k) {  // the loads of tile k
    float* dst = ring[k % kStages];
    const long long j0 = k * kTile;
    if (ALIGNED) {
      const long long j = j0 + 4 * ch;
#pragma unroll
      for (int i = 0; i < kChunks; ++i) {
        const int r = (lane >> 3) + 4 * i;
        if (j >= cfirst[i] && j < nsteps)
          cp_async16(dst + r * kTile + ((ch ^ (r & (kChunks - 1))) << 2),
                     mag + cstart[i] + j);
      }
    } else {
      const long long j = j0 + lane;
      for (int r = 0; r < kLanes; ++r) {
        const long long rs = __shfl_sync(0xffffffffu, start, r);
        const long long rf = __shfl_sync(0xffffffffu, first, r);
        if (j >= rf && j < nsteps)
          cp_async4(dst + tile_word(r, lane), mag + rs + j);
      }
    }
  };
  auto store = [&](long long k) {  // the results of tile k
    const long long j0 = k * kTile;
    if (j0 + kTile <= Wr) return;  // warm-up only
    const float* out = outs[k & 1];
    if (ALIGNED) {
      const long long j = j0 + 4 * ch;
#pragma unroll
      for (int i = 0; i < kChunks; ++i) {
        const int r = (lane >> 3) + 4 * i;
        if (cfirst[i] < nsteps && j >= Wr && j < nsteps)
          *reinterpret_cast<float4*>(y + cstart[i] + j) =
              *reinterpret_cast<const float4*>(
                  out + r * kTile + ((ch ^ (r & (kChunks - 1))) << 2));
      }
    } else {
      const long long j = j0 + lane;
      for (int r = 0; r < kLanes; ++r) {
        const long long rs = __shfl_sync(0xffffffffu, start, r);
        const long long rf = __shfl_sync(0xffffffffu, first, r);
        if (rf < nsteps && j >= Wr && j < nsteps)
          y[rs + j] = out[tile_word(r, lane)];
      }
    }
  };
  // Before barrier k the mover has tile k landed and tile k - 2's results
  // out of outs[k & 1]; between barriers k and k + 1, while tile k is
  // stepped, it stores tile k - 1's results and refills the ring slot that
  // tile k - 1 left with tile k + kStages - 1.
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < ntiles) load(k);
    cp_async_commit();
  }
  cp_async_wait<kStages - 2>();
  for (long long k = 0; k < ntiles; ++k) {
    tile_barrier();
    if (k > 0) store(k - 1);
    if (k + kStages - 1 < ntiles) load(k + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 2>();  // tile k + 1 has landed
  }
  tile_barrier();
  store(ntiles - 1);
}

}  // namespace

// mag, y [P, T], env0, env_f [P], contiguous f32; L >= 1, T % L == 0,
// Wr >= 0. Returns cudaGetLastError() after the launch.
extern "C" int envelope_rows_f32(const float* mag, const float* env0,
                                 float* y, float* env_f, long long P,
                                 long long T, long long L, long long Wr,
                                 float ga, float gr, void* stream) {
  const long long rows = P * (T / L);
  if (rows <= 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = (unsigned)((rows + kLanes - 1) / kLanes);
  // every row's first step, and so every chunk of four steps, lies on a
  // 16-byte boundary of mag and of y
  const bool aligned = (reinterpret_cast<uintptr_t>(mag) |
                        reinterpret_cast<uintptr_t>(y)) % 16 == 0 &&
                       T % 4 == 0 && L % 4 == 0 && Wr % 4 == 0;
  if (aligned)
    envelope_rows_kernel<true><<<blocks, 2 * kLanes, 0, st>>>(
        mag, env0, y, env_f, P, T, L, Wr, ga, gr);
  else
    envelope_rows_kernel<false><<<blocks, 2 * kLanes, 0, st>>>(
        mag, env0, y, env_f, P, T, L, Wr, ga, gr);
  return (int)cudaGetLastError();
}
