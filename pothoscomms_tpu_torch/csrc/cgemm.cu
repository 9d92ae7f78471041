// K1: complex GEMM, y[B, M] = a[B, N] x G[N, M], complex f32.
//
// Replaces the TPU kernel `cmatmul_pallas` / `_cmatmul_kernel`
// (pothoscomms_tpu/parallel/pallas_kernels.py:44-91). It also carries
// the combined FIR*DFT step's merged [G1; G0] product, which the JAX
// package runs as a Karatsuba 3-product form
// (pothoscomms_tpu/parallel/chain.py:223-229); here it takes no
// Karatsuba cancellation. `a` and `y` are interleaved complex ([rows,
// cols, 2] float32), read and written directly; G comes as real planes
// gr, gi [N, M]: yr = ar.gr - ai.gi ; yi = ar.gi + ai.gr.
//
// Two variants, picked by the wrapper (kernels/cgemm.py) from the shape
// before the launch:
//
// * Tensor cores (`cgemm_f32_tc`, N even and above 0). `a` is read as
//   the real matrix [B, 2N] (re, im interleaved along k, its memory as it
//   stands) and multiplied by the real embedding of G, stored K-major as
//   Bt [2M, 2N]: Bt[2m][2n] = gr, Bt[2m][2n+1] = -gi, Bt[2m+1][2n] = gi,
//   Bt[2m+1][2n+1] = gr. The product is y [B, 2M], interleaved, written
//   directly; still 8 B N M flops. f32 accuracy from TF32 `wgmma` by a
//   3xTF32 split, as the TPU kernel's Precision.HIGHEST is a multi-pass
//   bf16 split on the MXU:
//     a b ~ a_hi b_lo + a_lo b_hi + a_hi b_hi,
//   x_hi = tf32(x), x_lo = tf32(x - x_hi), both rounded to nearest even
//   (the dropped a_lo b_lo is 2^-22 of a b). `cgemm_operator_tf32`
//   builds Bt's hi and lo planes (one pass over G, a 32x32 transpose
//   through shared memory). The activation's split is done per tile in
//   shared memory. The tensor cores accumulate with truncation, which
//   biases a long sum; so each 32-wide k-slice is summed on the tensor
//   cores from zero and then added to a float32 register accumulator
//   (rounded to nearest), which keeps the error at float32's level.
//
//   Block: 128 x 128 outputs (64 complex columns), two consumer
//   warpgroups of 64 rows each and one producer warp. The producer
//   streams k-slices of 32 (128 B, one 128-byte swizzle row) of `a`,
//   Bt_hi and Bt_lo by TMA into a ring of 3 stages (64 KB each) with
//   full/empty mbarriers. A consumer warpgroup splits its 64 rows of
//   the `a` slice (hi in place, lo beside it), fences, and issues twelve
//   m64n128k8 wgmma (3 passes x 4 k-steps); while they run it waits for
//   and splits the next slice, then adds the slice's sum into its
//   float32 accumulators and frees the stage. TMA zero-fills the ragged
//   edges of B, 2M and 2N; the epilogue stores float2 (re, im) pairs
//   from registers with bounds checks.
//
//   What bounds it on the H100: operations. 3 x 8 B N M flops at the
//   495 TFLOP/s dense TF32 peak (700 W): 1.875 ms at the main path's
//   [32768, 1152] x [1152, 1024], against 0.17 ms for its ~0.58 GB of
//   HBM traffic. What the design gives up: the split, the promotion and
//   the per-tile prologue run on the consumer warps, not overlapped with
//   their own tensor-core work except for the next slice's split; the
//   grid is not persistent, so each tile's epilogue idles its SM.
//
// * SIMT (`cgemm_f32_simt`, every other shape: odd N, where TMA's
//   16-byte row stride cannot hold [B, 2N] f32, N = 0, or an `a` not
//   16-byte aligned). One 64x64 output tile per 256-thread block, a
//   K-slice of 16 staged through shared memory, a 4x4 complex
//   micro-tile per thread; every FMA a full f32 FMA, bound by
//   shared-memory loads at ~33 TFLOP/s of the 67 TFLOP/s f32 peak.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------- SIMT --
constexpr int BM = 64;       // output rows per block
constexpr int BN = 64;       // output cols per block
constexpr int BK = 16;       // contraction slice staged in shared memory
constexpr int TM = 4;        // rows per thread
constexpr int TN = 4;        // cols per thread
constexpr int THREADS = 256; // (BM / TM) * (BN / TN)

__global__ void __launch_bounds__(THREADS)
cgemm_kernel(const float* __restrict__ a, const float* __restrict__ gr,
             const float* __restrict__ gi, float* __restrict__ y, int64_t B,
             int64_t N, int64_t M) {
  __shared__ float sar[BK][BM];
  __shared__ float sai[BK][BM];
  __shared__ float sgr[BK][BN];
  __shared__ float sgi[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // column group: cols tx + 16 j
  const int ty = tid / 16;  // row group: rows ty + 16 i
  const int64_t row0 = (int64_t)blockIdx.x * BM;
  const int64_t col0 = (int64_t)blockIdx.y * BN;

  // a-tile loader: 64 rows x 16 complex; each thread 4 consecutive
  // complex values of one row. g-tile loader: 16 k x 64 cols; each
  // thread 4 consecutive columns of one k.
  const int la_row = tid / 4;
  const int la_k = (tid % 4) * 4;
  const int lg_k = tid / 16;
  const int lg_col = (tid % 16) * 4;

  float accr[TM][TN], acci[TM][TN];  // yr, yi
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      accr[i][j] = 0.f;
      acci[i][j] = 0.f;
    }

  const float2* a2 = reinterpret_cast<const float2*>(a);
  for (int64_t k0 = 0; k0 < N; k0 += BK) {
    const int64_t r = row0 + la_row;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int64_t kk = k0 + la_k + e;
      float2 v = make_float2(0.f, 0.f);
      if (r < B && kk < N) v = a2[r * N + kk];
      sar[la_k + e][la_row] = v.x;
      sai[la_k + e][la_row] = v.y;
    }
    const int64_t kg = k0 + lg_k;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int64_t c = col0 + lg_col + e;
      const bool ok = kg < N && c < M;
      const int64_t off = kg * M + c;
      sgr[lg_k][lg_col + e] = ok ? gr[off] : 0.f;
      sgi[lg_k][lg_col + e] = ok ? gi[off] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float ar[TM], ai[TM], br[TN], bi[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        ar[i] = sar[k][ty + 16 * i];
        ai[i] = sai[k][ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        br[j] = sgr[k][tx + 16 * j];
        bi[j] = sgi[k][tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          accr[i][j] = fmaf(ar[i], br[j], accr[i][j]);
          accr[i][j] = fmaf(-ai[i], bi[j], accr[i][j]);
          acci[i][j] = fmaf(ar[i], bi[j], acci[i][j]);
          acci[i][j] = fmaf(ai[i], br[j], acci[i][j]);
        }
    }
    __syncthreads();
  }

  float2* y2 = reinterpret_cast<float2*>(y);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t r = row0 + ty + 16 * i;
    if (r >= B) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int64_t c = col0 + tx + 16 * j;
      if (c >= M) continue;
      y2[r * M + c] = make_float2(accr[i][j], acci[i][j]);
    }
  }
}

// -------------------------------------------------------- tensor cores --
constexpr int TC_BM = 128;                   // rows of y per block
constexpr int TC_BN = 128;                   // columns of y [B, 2M]
constexpr int TC_BK = 32;                    // k per stage: 128 B of f32
constexpr int TC_STAGES = 3;
constexpr int TC_CONSUMERS = 256;            // two warpgroups
constexpr int TC_THREADS = TC_CONSUMERS + 32;  // and one producer warp
constexpr int TILE_BYTES = TC_BM * TC_BK * 4;  // 16 KB (TC_BN == TC_BM)
constexpr int STAGE_BYTES = 4 * TILE_BYTES;    // a (hi), a_lo, bt_hi, bt_lo
constexpr int TC_SMEM = TC_STAGES * STAGE_BYTES + 1024 + 64;

// x rounded to TF32 (10 mantissa bits), to nearest, ties to even.
// kernels/cgemm.py `tf32_round` is the same integer arithmetic.
__device__ __forceinline__ float tf32_rne(float x) {
  uint32_t u = __float_as_uint(x);
  u += 0xFFFu + ((u >> 13) & 1u);
  return __uint_as_float(u & 0xFFFFE000u);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Waits for the phase of `bar` with this parity to complete. A wait that
// never completes (a fault in the pipeline) traps after ~2^24 polls, so
// the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 24)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// One TMA box {TC_BK, 128} at (k, row) into shared memory, completing on
// `bar`. Out-of-range elements arrive as zeros.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int k, int row, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(k), "r"(row),
      "r"(smem_u32(bar))
      : "memory");
}

// wgmma descriptor of a K-major tile with the 128-byte swizzle TMA
// wrote: rows of 128 B, 8-row atoms 1024 B apart (SBO), LBO unused.
// A k-step of 8 f32 inside the row advances the start by 32 B.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d (+)= A[64 x 8] . B[128 x 8]^T, both TF32 from shared memory.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// Keeps the compiler from moving accesses of d across a wgmma fence or
// wait.
__device__ __forceinline__ void fence_operands(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Split this warpgroup's 64 rows of a stage's `a` slice: hi in place,
// lo at the same offset one tile further on (the swizzled layout is kept,
// element by element). Then make the writes visible to wgmma and meet
// the warpgroup's other warps.
__device__ __forceinline__ void split_rows(uint8_t* stage, int wg, int t) {
  float4* hi = reinterpret_cast<float4*>(stage + wg * (TILE_BYTES / 2));
  float4* lo =
      reinterpret_cast<float4*>(stage + TILE_BYTES + wg * (TILE_BYTES / 2));
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float4 v = hi[t + 128 * j];
    const float4 h = make_float4(tf32_rne(v.x), tf32_rne(v.y), tf32_rne(v.z),
                                 tf32_rne(v.w));
    hi[t + 128 * j] = h;
    lo[t + 128 * j] =
        make_float4(tf32_rne(v.x - h.x), tf32_rne(v.y - h.y),
                    tf32_rne(v.z - h.z), tf32_rne(v.w - h.w));
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
}

__global__ void __launch_bounds__(TC_THREADS, 1)
cgemm_tc_kernel(const __grid_constant__ CUtensorMap map_a,
                const __grid_constant__ CUtensorMap map_bhi,
                const __grid_constant__ CUtensorMap map_blo,
                float* __restrict__ y, int rows, int k2, int m2,
                int col_tiles) {
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 B: align the stages to it
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  const uint32_t base = smem_u32(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + TC_STAGES * STAGE_BYTES);
  uint64_t* empty = full + TC_STAGES;

  const int row0 = (blockIdx.x / col_tiles) * TC_BM;
  const int col0 = (blockIdx.x % col_tiles) * TC_BN;
  const int kt_count = (k2 + TC_BK - 1) / TC_BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < TC_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], TC_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  if (warp == TC_CONSUMERS / 32) {  // the producer warp: one thread
    if (threadIdx.x % 32 == 0) {
      for (int kt = 0; kt < kt_count; ++kt) {
        const int s = kt % TC_STAGES;
        mbar_wait(&empty[s], ((kt / TC_STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], 3 * TILE_BYTES);
        const uint32_t st = base + s * STAGE_BYTES;
        tma_load(st, &map_a, kt * TC_BK, row0, &full[s]);
        tma_load(st + 2 * TILE_BYTES, &map_bhi, kt * TC_BK, col0, &full[s]);
        tma_load(st + 3 * TILE_BYTES, &map_blo, kt * TC_BK, col0, &full[s]);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of the tile
  const int wg = warp / 4;
  const int t = threadIdx.x % 128;
  float acc[64], d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    acc[i] = 0.f;
    d[i] = 0.f;
  }

  mbar_wait(&full[0], 0);
  split_rows(smem, wg, t);
  for (int kt = 0; kt < kt_count; ++kt) {
    const int s = kt % TC_STAGES;
    const uint32_t st = base + s * STAGE_BYTES;
    const uint32_t a_hi = st + wg * (TILE_BYTES / 2);
    const uint32_t a_lo = a_hi + TILE_BYTES;
    const uint32_t b_hi = st + 2 * TILE_BYTES;
    const uint32_t b_lo = st + 3 * TILE_BYTES;
    fence_operands(d);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
    // the small terms first, from zero; then the large one
#pragma unroll
    for (int k = 0; k < TC_BK / 8; ++k)
      wgmma_tf32(d, sw128_desc(a_hi + 32 * k), sw128_desc(b_lo + 32 * k),
                 k > 0);
#pragma unroll
    for (int k = 0; k < TC_BK / 8; ++k)
      wgmma_tf32(d, sw128_desc(a_lo + 32 * k), sw128_desc(b_hi + 32 * k), 1);
#pragma unroll
    for (int k = 0; k < TC_BK / 8; ++k)
      wgmma_tf32(d, sw128_desc(a_hi + 32 * k), sw128_desc(b_hi + 32 * k), 1);
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    if (kt + 1 < kt_count) {  // split the next slice meanwhile
      const int s1 = (kt + 1) % TC_STAGES;
      mbar_wait(&full[s1], ((kt + 1) / TC_STAGES) & 1);
      split_rows(smem + s1 * STAGE_BYTES, wg, t);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_operands(d);
    mbar_arrive(&empty[s]);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += d[i];
  }

  // accumulator layout of m64n128 f32: acc[4 i + 2 h + e] is row
  // 16 w + lane / 4 + 8 h, column 8 i + 2 (lane % 4) + e of the
  // warpgroup's 64 x 128 tile; e = 0, 1 is one (re, im) pair
  const int lane = t % 32;
  const int r0 = row0 + wg * 64 + (t / 32) * 16 + lane / 4;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int c = col0 + 8 * i + 2 * (lane % 4);
    if (c >= m2) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      if (r < rows)
        *reinterpret_cast<float2*>(y + (int64_t)r * m2 + c) =
            make_float2(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
    }
  }
}

// Bt_hi, Bt_lo [2M, 2N] from gr, gi [N, M]: the real embedding of G,
// K-major, split into TF32 hi and lo. A 32 x 32 tile of (n, m) per
// block, transposed through shared memory so both sides coalesce.
__global__ void tf32_operator_kernel(const float* __restrict__ gr,
                                     const float* __restrict__ gi,
                                     float2* __restrict__ bhi,
                                     float2* __restrict__ blo, int64_t N,
                                     int64_t M) {
  __shared__ float sr[32][33], si[32][33];
  const int64_t n0 = (int64_t)blockIdx.y * 32, m0 = (int64_t)blockIdx.x * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int r = ty; r < 32; r += 8) {
    const int64_t n = n0 + r, m = m0 + tx;
    const bool ok = n < N && m < M;
    sr[r][tx] = ok ? gr[n * M + m] : 0.f;
    si[r][tx] = ok ? gi[n * M + m] : 0.f;
  }
  __syncthreads();
  const int64_t n = n0 + tx;
  for (int r = ty; r < 32; r += 8) {
    const int64_t m = m0 + r;
    if (m >= M || n >= N) continue;
    const float vr = sr[tx][r], vi = si[tx][r];
    const float hr = tf32_rne(vr), hi = tf32_rne(vi);
    const float lr = tf32_rne(vr - hr), li = tf32_rne(vi - hi);
    // row 2m: (gr, -gi) at k = (2n, 2n + 1); row 2m + 1: (gi, gr)
    bhi[2 * m * N + n] = make_float2(hr, -hi);
    blo[2 * m * N + n] = make_float2(lr, -li);
    bhi[(2 * m + 1) * N + n] = make_float2(hi, hr);
    blo[(2 * m + 1) * N + n] = make_float2(li, lr);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, found through the runtime's
// entry-point query (no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A row-major f32 matrix [outer, inner] as TMA boxes of {TC_BK, 128}
// with the 128-byte swizzle; inner * 4 must be a multiple of 16.
bool make_map(EncodeTiled enc, CUtensorMap* map, const float* p,
              long long inner, long long outer) {
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)inner * 4};
  const cuuint32_t box[2] = {TC_BK, TC_BM};
  const cuuint32_t step[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(p),
             dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// SIMT variant. a [B, N, 2], gr/gi [N, M], y [B, M, 2]. Returns
// cudaGetLastError() after the launch.
extern "C" int cgemm_f32_simt(const float* a, const float* gr,
                              const float* gi, float* y, long long B,
                              long long N, long long M, void* stream) {
  if (B > 0 && M > 0) {
    const dim3 grid((unsigned)((B + BM - 1) / BM),
                    (unsigned)((M + BN - 1) / BN));
    cgemm_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        a, gr, gi, y, B, N, M);
  }
  return (int)cudaGetLastError();
}

// gr/gi [N, M] -> bt_hi, bt_lo [2M, 2N], the tensor-core variant's
// operator. Returns cudaGetLastError() after the launch.
extern "C" int cgemm_operator_tf32(const float* gr, const float* gi,
                                   float* bt_hi, float* bt_lo, long long N,
                                   long long M, void* stream) {
  if (N > 0 && M > 0) {
    const dim3 grid((unsigned)((M + 31) / 32), (unsigned)((N + 31) / 32));
    tf32_operator_kernel<<<grid, dim3(32, 8), 0,
                           static_cast<cudaStream_t>(stream)>>>(
        gr, gi, reinterpret_cast<float2*>(bt_hi),
        reinterpret_cast<float2*>(bt_lo), N, M);
  }
  return (int)cudaGetLastError();
}

// Tensor-core variant. a [B, N, 2] (16-byte aligned, N even), bt_hi and
// bt_lo [2M, 2N] from cgemm_operator_tf32, y [B, M, 2]; B, 2N, 2M and
// the tile count below 2^31. Returns a CUDA error code: cudaGetLastError()
// after the launch, or the failure of a set-up step.
extern "C" int cgemm_f32_tc(const float* a, const float* bt_hi,
                            const float* bt_lo, float* y, long long B,
                            long long N, long long M, void* stream) {
  if (B <= 0 || M <= 0 || N <= 0) return (int)cudaGetLastError();
  const EncodeTiled enc = encode_tiled();
  if (!enc) return (int)cudaErrorNotSupported;
  CUtensorMap ma, mh, ml;
  if (!make_map(enc, &ma, a, 2 * N, B) ||
      !make_map(enc, &mh, bt_hi, 2 * N, 2 * M) ||
      !make_map(enc, &ml, bt_lo, 2 * N, 2 * M))
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      cgemm_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TC_SMEM);
  if (e != cudaSuccess) return (int)e;
  const long long col_tiles = (2 * M + TC_BN - 1) / TC_BN;
  const long long tiles = col_tiles * ((B + TC_BM - 1) / TC_BM);
  cgemm_tc_kernel<<<(unsigned)tiles, TC_THREADS, TC_SMEM,
                    static_cast<cudaStream_t>(stream)>>>(
      ma, mh, ml, y, (int)B, (int)(2 * N), (int)(2 * M), (int)col_tiles);
  return (int)cudaGetLastError();
}
