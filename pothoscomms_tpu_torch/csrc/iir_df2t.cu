// I1: the direct form II transposed (DF-II-T) IIR recurrence over rows of
// float32 samples, complex (two interleaved planes) or real, with its state
// carried in and out.
//
// It replaces no Pallas kernel: the JAX package runs this IIR as the XLA
// ops of `iir_blocked_step` (pothoscomms_tpu/ops/filter.py), a blocked
// state-space form, and the port ran the same form as torch ops (two block
// products, a log-depth scan of block states, adds and planar permutes).
// On an H100 that form took ~3.15 ms of the 3:2 resampler bank's ~4.52 ms
// step at [256, 196608] complex samples, order 6: a [256, 256] Toeplitz
// product that spends 256 MACs an output where the recurrence needs 13,
// and copies in and out of the planar layout; the benchmark's
// `kernel_roofline_pct.iir` read 6.98%, which asked for this kernel. The
// stage needs 0.240 ms: it reads and writes 805 MB (3.35 TB/s); its
// 2.6 GFLOP are negligible.
//
// What it computes, for each row and plane (kernels/iir_df2t.py
// `iir_df2t_plain`), with b, a normalised (a[0] = 1) and z the state:
//   y = b0 x + z[0];   z' = b[1:] x - a[1:] y + (z[1:], 0)
// which is scipy's `lfilter` with `zi`. Every product is a float32 FMA.
//
// Design. The bound is memory (16 bytes an output), so a row is read once
// and written once in its interleaved layout. A block owns one row and
// walks it tile by tile (kThreads * kChunk samples): where the rows are too
// few to fill the card, a block owns a segment of a row instead, and a
// first launch gives each segment's end state from a zero state (reading
// x once more, writing nothing else), from which each block of the second
// finds its start (z <- A^(segment) z + end, over the earlier segments,
// from the row's carried state). Tiles are staged into
// a ring of two shared-memory slots by cp.async, one tile in flight ahead
// of the one computed, and the state is carried from
// tile to tile inside the block. Within a tile each thread owns a chunk of
// kChunk samples (a slot pads each chunk by 16 bytes, so the threads'
// 16-byte reads fall in distinct banks):
//  1. the chunk's end state from a zero state, s = G x (G[:, j] =
//     A^(L-1-j) g, A the recurrence's state matrix): O FMAs a sample and
//     plane, no dependent chain;
//  2. the chunks' true start states, z_{k+1} = A^L z_k + s_k, by a
//     Hillis-Steele scan across the block's threads in shared memory, one
//     round a doubling with the powers A^(L 2^r) (computed in float64, cast
//     to float32), the tile's carried-in state joining the first chunk;
//  3. the recurrence re-run over the chunk from its true start state; y
//     overwrites x in the slot, and the block stores the slot to y in
//     coalesced 16-byte stores.
// The state carried to the next tile (and out of the row) is the scan's
// end state of the chunk holding the tile's last sample, or, where that
// sample ends no chunk (a row's ragged end), the recurrence's. The scan's
// is the more accurate: the recurrence runs the taps rounded to float32,
// which for the resampler bank's elliptic order-6 filter moves its state
// ~6e-6 of max |z| within a chunk (as a float32 sequential DF-II-T does);
// the scan's maps G and A^L, computed in float64 and rounded, move it
// ~1e-7.
// The coefficients, G and the powers travel as a kernel parameter, so every
// FMA reads them as constant-bank operands. The order (1 to kMaxOrder) and
// the row's planes W (1 or 2) are template parameters: the library holds
// all 16 kernels and `iir_df2t_f32` picks one at run time. Any T >= 1 runs,
// the last tile's zero-filled tail discarded. The wrapper launches only
// taps whose tables are finite in float32 and on which this algorithm
// stays within 1e-5 of the float64 recursion (kernels/iir_df2t.py
// `strays`): a high-order direct form with clustered poles, such as an
// elliptic low-pass of order 7 or 8, strays further through the rounded
// scan powers and taps, and keeps the blocked form.
//
// Measured on an H100 (700 W) at [256, 196608, 2], order 6: 0.297-0.304 ms
// on the card, 79-81% of the byte bound and ~90% of a `clone` of x
// (0.268-0.271 ms). 256 rows make 256 blocks, two an SM. Slower there:
// 64 threads a block (0.48-0.57: too few warps), chunks of 16 (0.31-0.36),
// and any plan whose shared memory leaves one block an SM (0.47-0.50:
// the rows then take two waves); a deeper ring never helped. So a block
// has kThreads threads, a chunk kChunk samples, the ring kSlots tiles. One
// block a row on one row of 25,165,824 samples took 28.4 ms; in 256
// segments, 0.364 ms.

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 32;               // samples a thread
constexpr int kThreads = 128;            // threads a block
constexpr int kRounds = 7;               // log2(kThreads): the scan's rounds
constexpr int kSlots = 2;                // tiles of the ring
constexpr int kMaxOrder = 8;

static_assert((1 << kRounds) == kThreads, "a scan round a doubling");

template <int O, int L>
struct Coef {
  float b[O + 1];              // feed-forward taps
  float na[O + 1];             // minus the feedback taps (na[0] unused)
  float g[O][L];               // a chunk's end state of a unit sample at j
  float p[kRounds][O][O];      // (A^L)^(2^r)
  float pseg[O][O];            // A^(a segment's samples)
};

struct Args {
  const float* __restrict__ x;  // [R, T, W]
  const float* __restrict__ z;  // [O, R, W]
  float* __restrict__ y;        // [R, T, W]
  float* __restrict__ zout;     // [O, R, W]
  long long R;
  int T;
  int ntiles;     // tiles a row: ceil(T / tile)
  int segs;       // segments a row, one block each
  int seg_tiles;  // tiles a segment (the last may have fewer)
  bool vec;       // rows 16-byte aligned: copies of 16 bytes
  bool ends_only; // the first pass of a row in segments: end states only
  const float* __restrict__ ends_in;  // [R, segs, O, W]: segments' ends
  float* __restrict__ ends_out;       // from a zero state
};

__device__ __forceinline__ void copy16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void copy4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until none of this thread's copy groups is pending
__device__ __forceinline__ void wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

constexpr int kTile = kThreads * kChunk;  // samples a tile

// float f of a tile lies at f + 4 (f / (kChunk W)) of its slot
template <int W>
__device__ __forceinline__ int at(int f) {
  return f + 4 * (f / (kChunk * W));
}

// Stage tile i of row xr into slot, zeros past the row's end.
template <int W>
__device__ __forceinline__ void stage(const Args& a, float* slot,
                                      const float* xr, int i) {
  const int t0 = i * kTile;
  const int nf = min(kTile, a.T - t0) * W;  // floats of the row
  const int tf = kTile * W;
  const float* src = xr + (long long)t0 * W;
  if (a.vec) {
    for (int f = 4 * threadIdx.x; f < tf; f += 4 * kThreads) {
      float* dst = slot + at<W>(f);
      if (f < nf)
        copy16(dst, src + f);
      else
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int f = threadIdx.x; f < tf; f += kThreads) {
      float* dst = slot + at<W>(f);
      if (f < nf)
        copy4(dst, src + f);
      else
        *dst = 0.f;
    }
  }
}

// Store tile i of the slot to row yr, up to the row's end.
template <int W>
__device__ __forceinline__ void store(const Args& a, const float* slot,
                                      float* yr, int i) {
  const int t0 = i * kTile;
  const int nf = min(kTile, a.T - t0) * W;
  float* dst = yr + (long long)t0 * W;
  if (a.vec) {
    for (int f = 4 * threadIdx.x; f < nf; f += 4 * kThreads)
      __stcs(reinterpret_cast<float4*>(dst + f),
             *reinterpret_cast<const float4*>(slot + at<W>(f)));
  } else {
    for (int f = threadIdx.x; f < nf; f += kThreads)
      __stcs(dst + f, slot[at<W>(f)]);
  }
}

// w += P v, P = c.p[r]
template <int O, int W, int L>
__device__ __forceinline__ void add_power(const Coef<O, L>& c, int r,
                                          float (&w)[O][W],
                                          const float (&v)[O][W]) {
#pragma unroll
  for (int o = 0; o < O; ++o)
#pragma unroll
    for (int m = 0; m < O; ++m)
#pragma unroll
      for (int ch = 0; ch < W; ++ch)
        w[o][ch] = fmaf(c.p[r][o][m], v[m][ch], w[o][ch]);
}

// one sample of one plane through the recurrence
template <int O, int L>
__device__ __forceinline__ float df2t(const Coef<O, L>& c, float x,
                                      float (&z)[O]) {
  const float y = fmaf(c.b[0], x, z[0]);
#pragma unroll
  for (int i = 0; i + 1 < O; ++i)
    z[i] = fmaf(c.na[i + 1], y, fmaf(c.b[i + 1], x, z[i + 1]));
  z[O - 1] = fmaf(c.na[O], y, c.b[O] * x);
  return y;
}

template <int O, int W>
__global__ void __launch_bounds__(kThreads)
    iir_df2t_kernel(const Args a, const Coef<O, kChunk> c) {
  constexpr int L = kChunk;
  constexpr int CW = L * W;  // floats a chunk
  constexpr int OW = O * W;
  extern __shared__ float4 smem4[];
  constexpr int nt = kThreads;
  constexpr int slotf = nt * (CW + 4);
  const int tid = threadIdx.x;
  float* ring = reinterpret_cast<float*>(smem4);
  float* scan = ring + kSlots * slotf;  // [2][OW][nt]
  float* zc = scan + 2 * OW * nt;       // the carried state, [O][W]
  const long long row = blockIdx.x / a.segs;
  const int seg = blockIdx.x - (int)(row * a.segs);
  // the first pass needs no end state of a row's last segment
  if (a.ends_only && seg == a.segs - 1) return;
  const int f0 = seg * a.seg_tiles;                // my first tile
  const int f1 = min(a.ntiles, f0 + a.seg_tiles);  // past my last
  const float* xr = a.x + row * a.T * W;
  float* yr = a.y + row * a.T * W;

  // my start state: zero in the first pass; else the row's state carried
  // in, then each earlier segment's: z <- A^(segment) z + its zero-state end
  if (a.ends_only) {
    if (tid < OW) zc[tid] = 0.f;
  } else if (tid == 0) {
    float acc[O][W];
#pragma unroll
    for (int o = 0; o < O; ++o)
#pragma unroll
      for (int ch = 0; ch < W; ++ch)
        acc[o][ch] = a.z[((long long)o * a.R + row) * W + ch];
    for (int s = 0; s < seg; ++s) {
      const float* e = a.ends_in + (row * a.segs + s) * OW;
      float v[O][W];
#pragma unroll
      for (int o = 0; o < O; ++o)
#pragma unroll
        for (int ch = 0; ch < W; ++ch) v[o][ch] = acc[o][ch];
#pragma unroll
      for (int o = 0; o < O; ++o)
#pragma unroll
        for (int ch = 0; ch < W; ++ch) {
          float sum = e[o * W + ch];
#pragma unroll
          for (int m = 0; m < O; ++m) sum = fmaf(c.pseg[o][m], v[m][ch], sum);
          acc[o][ch] = sum;
        }
    }
#pragma unroll
    for (int o = 0; o < O; ++o)
#pragma unroll
      for (int ch = 0; ch < W; ++ch) zc[o * W + ch] = acc[o][ch];
  }
  stage<W>(a, ring, xr, f0);
  commit();

  for (int i = f0; i < f1; ++i) {
    wait_all();
    __syncthreads();  // tile i staged; tile i - 1 stored
    float* slot = ring + ((i - f0) % kSlots) * slotf;
    if (i + 1 < f1)
      stage<W>(a, ring + ((i + 1 - f0) % kSlots) * slotf, xr, i + 1);
    commit();

    float* q = slot + tid * (CW + 4);
    const int n = min(kTile, a.T - i * kTile);  // samples of the tile
    const int mine = min(L, n - tid * L);       // of my chunk

    // 1. my chunk's end state from a zero state
    float w[O][W];
#pragma unroll
    for (int o = 0; o < O; ++o)
#pragma unroll
      for (int ch = 0; ch < W; ++ch) w[o][ch] = 0.f;
#pragma unroll
    for (int u = 0; u < CW / 4; ++u) {
      const float4 v4 = *reinterpret_cast<const float4*>(q + 4 * u);
      const float e[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = (4 * u + k) / W, ch = (4 * u + k) % W;
#pragma unroll
        for (int o = 0; o < O; ++o)
          w[o][ch] = fmaf(c.g[o][j], e[k], w[o][ch]);
      }
    }

    // 2. the chunks' end states: the carried state joins chunk 0, then a
    // Hillis-Steele scan, w_k += A^(L d) w_{k-d}
    float zin[O][W];
    if (tid == 0) {
#pragma unroll
      for (int o = 0; o < O; ++o)
#pragma unroll
        for (int ch = 0; ch < W; ++ch) zin[o][ch] = zc[o * W + ch];
      add_power<O, W, L>(c, 0, w, zin);
    }
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const int d = 1 << r;
      float* buf = scan + (r & 1) * OW * nt;
#pragma unroll
      for (int o = 0; o < O; ++o)
#pragma unroll
        for (int ch = 0; ch < W; ++ch)
          buf[(o * W + ch) * nt + tid] = w[o][ch];
      __syncthreads();
      if (tid >= d) {
        float v[O][W];
#pragma unroll
        for (int o = 0; o < O; ++o)
#pragma unroll
          for (int ch = 0; ch < W; ++ch)
            v[o][ch] = buf[(o * W + ch) * nt + tid - d];
        add_power<O, W, L>(c, r, w, v);
      }
    }
    // my start state: chunk tid - 1's end, the carried state for chunk 0
    {
      float* buf = scan + (kRounds & 1) * OW * nt;
#pragma unroll
      for (int o = 0; o < O; ++o)
#pragma unroll
        for (int ch = 0; ch < W; ++ch) buf[(o * W + ch) * nt + tid] = w[o][ch];
      __syncthreads();
      if (tid > 0) {
#pragma unroll
        for (int o = 0; o < O; ++o)
#pragma unroll
          for (int ch = 0; ch < W; ++ch)
            zin[o][ch] = buf[(o * W + ch) * nt + tid - 1];
      }
    }

    // 3. the recurrence from the true start state, y over x in the slot
    float zs[W][O];
#pragma unroll
    for (int o = 0; o < O; ++o)
#pragma unroll
      for (int ch = 0; ch < W; ++ch) zs[ch][o] = zin[o][ch];
    if (a.ends_only) {
      // the first pass stops at the scan: its segments end at chunk ends
    } else if (mine == L) {
#pragma unroll
      for (int u = 0; u < CW / 4; ++u) {
        float4 v4 = *reinterpret_cast<const float4*>(q + 4 * u);
        float e[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
        for (int k = 0; k < 4; ++k)
          e[k] = df2t<O, L>(c, e[k], zs[(4 * u + k) % W]);
        *reinterpret_cast<float4*>(q + 4 * u) =
            make_float4(e[0], e[1], e[2], e[3]);
      }
    } else if (mine > 0) {
      for (int j = 0; j < mine; ++j)
#pragma unroll
        for (int ch = 0; ch < W; ++ch)
          q[j * W + ch] = df2t<O, L>(c, q[j * W + ch], zs[ch]);
    }
    // the state after the tile's last sample, carried to the next tile
    // (and out after the last): the scan's end state of my chunk where
    // the sample ends it, else the recurrence's state after my samples
    if (mine > 0 && tid * L + mine == n) {
      if (mine == L) {
#pragma unroll
        for (int o = 0; o < O; ++o)
#pragma unroll
          for (int ch = 0; ch < W; ++ch) zs[ch][o] = w[o][ch];
      }
#pragma unroll
      for (int o = 0; o < O; ++o)
#pragma unroll
        for (int ch = 0; ch < W; ++ch) zc[o * W + ch] = zs[ch][o];
      if (a.ends_only && i == f1 - 1) {
#pragma unroll
        for (int o = 0; o < O; ++o)
#pragma unroll
          for (int ch = 0; ch < W; ++ch)
            a.ends_out[((row * a.segs + seg) * O + o) * W + ch] = zs[ch][o];
      } else if (!a.ends_only && i == a.ntiles - 1) {
#pragma unroll
        for (int o = 0; o < O; ++o)
#pragma unroll
          for (int ch = 0; ch < W; ++ch)
            a.zout[((long long)o * a.R + row) * W + ch] = zs[ch][o];
      }
    }
    if (!a.ends_only) {
      __syncthreads();
      store<W>(a, slot, yr, i);
    }
  }
}

// the shared memory of a block: the ring (each chunk padded by 16 bytes),
// the scan's two buffers and the carried state
constexpr int smem_bytes(int order, int width) {
  return 4 * (kSlots * kThreads * (kChunk * width + 4) +
              2 * order * width * kThreads + (order * width + 3) / 4 * 4);
}

static_assert(2 * (smem_bytes(kMaxOrder, 2) + 1024) <= 233472,
              "two blocks an SM");

template <int O, int W>
int launch(const Args& a, const float* coef, cudaStream_t stream) {
  Coef<O, kChunk> c;
  const float* p = coef;
  for (int i = 0; i <= O; ++i) c.b[i] = *p++;
  for (int i = 0; i <= O; ++i) c.na[i] = *p++;
  for (int o = 0; o < O; ++o)
    for (int j = 0; j < kChunk; ++j) c.g[o][j] = *p++;
  for (int r = 0; r < kRounds; ++r)
    for (int o = 0; o < O; ++o)
      for (int m = 0; m < O; ++m) c.p[r][o][m] = *p++;
  for (int o = 0; o < O; ++o)
    for (int m = 0; m < O; ++m) c.pseg[o][m] = *p++;
  auto kernel = iir_df2t_kernel<O, W>;
  constexpr int smem = smem_bytes(O, W);
  static bool opted[64] = {};
  int devno = 0;
  cudaGetDevice(&devno);
  if (devno < 0 || devno >= 64) return (int)cudaErrorInvalidDevice;
  if (!opted[devno]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    opted[devno] = true;
  }
  // a row in segments: their end states from a zero state first
  const unsigned grid = (unsigned)(a.R * a.segs);
  if (a.segs > 1) {
    Args first = a;
    first.ends_only = true;
    kernel<<<grid, kThreads, smem, stream>>>(first, c);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, kThreads, smem, stream>>>(a, c);
  return (int)cudaGetLastError();
}

template <int W>
int launch_order(int order, const Args& a, const float* coef,
                 cudaStream_t stream) {
  switch (order) {
    case 1: return launch<1, W>(a, coef, stream);
    case 2: return launch<2, W>(a, coef, stream);
    case 3: return launch<3, W>(a, coef, stream);
    case 4: return launch<4, W>(a, coef, stream);
    case 5: return launch<5, W>(a, coef, stream);
    case 6: return launch<6, W>(a, coef, stream);
    case 7: return launch<7, W>(a, coef, stream);
    case 8: return launch<8, W>(a, coef, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x [R, T, W], z [O, R, W] -> y [R, T, W], zout [O, R, W]: contiguous
// float32, 4-byte aligned, y and zout fresh (no alias of x or z);
// 1 <= order <= 8, W 1 or 2, 1 <= T, T W < 2^31, R segs < 2^31; coef the
// host array of kernels/iir_df2t.py `tables` (2 (O + 1) + O kChunk +
// (kRounds + 1) O^2 floats: b, -a, G, the scan's powers, A^(seg_tiles
// tile)); a row in segs segments of seg_tiles tiles (none empty), ends
// scratch of R segs O W floats where segs > 1. A row in segments takes two
// launches: the segments' end states from a zero state, then the rows.
// Returns cudaGetLastError() after them.
extern "C" int iir_df2t_f32(const float* x, const float* z, float* y,
                            float* zout, float* ends, long long R,
                            long long T, int order, int width,
                            const float* coef, int ncoef, int segs,
                            int seg_tiles, void* stream) {
  if (R == 0) return (int)cudaGetLastError();
  const long long ntiles = T >= 1 ? (T + kTile - 1) / kTile : 0;
  if (order < 1 || order > kMaxOrder || (width != 1 && width != 2) ||
      R < 0 || T < 1 || T * width >= (1LL << 31) ||
      ncoef != 2 * (order + 1) + order * kChunk +
                   (kRounds + 1) * order * order ||
      segs < 1 || seg_tiles < 1 ||
      segs != (ntiles + seg_tiles - 1) / seg_tiles ||
      R * segs >= (1LL << 31) || (segs > 1 && ends == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = x;
  a.z = z;
  a.y = y;
  a.zout = zout;
  a.R = R;
  a.T = (int)T;
  a.ntiles = (int)ntiles;
  a.segs = segs;
  a.seg_tiles = seg_tiles;
  a.vec = (T * width) % 4 == 0 && (size_t)x % 16 == 0 &&
          (size_t)y % 16 == 0;
  a.ends_only = false;
  a.ends_in = ends;
  a.ends_out = ends;
  const auto s = static_cast<cudaStream_t>(stream);
  return width == 1 ? launch_order<1>(order, a, coef, s)
                    : launch_order<2>(order, a, coef, s);
}
