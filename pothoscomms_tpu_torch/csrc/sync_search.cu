// S1: the frame-sync search, every candidate offset of every channel.
//
// Not a Pallas kernel: it replaces the XLA program that the JAX package
// runs for the search, `sync_search_planar`
// (pothoscomms_tpu/ops/framing.py:37-119; numerics of the reference's
// digital/FrameSync.cpp:595-693). For offset i of channel c of x [C, L, 2]
// it computes
//   * the envelope-consistency test and the scale estimate: |x| at i + dw
//     and i + sw - dw, and the mean |x| over [i + dw, i + w/2) and
//     [i + sw - w/2, i + sw - dw), against the threshold and each other;
//   * delta_fc = atan2(K) / (w/2), K the sum of x[j] conj(x[j + w/2]) for
//     j in [i + off + dw, i + off + w/2 - dw), off = w (npre - 1);
//   * the dechirped correlation Ls = sum over j < sw of
//     x[i + j] (cos, sin)(delta_fc j) conj(p[j / w]), L = Ls scale;
//   * phase_off = -atan2(L) and corr_peak = floor|L| (0 where scale is 0).
// The four outputs go to out[k, c, i], k = scale, delta_fc, phase_off,
// corr_peak.
//
// The correlation by Horner's rule. With z = (cos, sin)(delta_fc), the
// taps of one block [lo, hi) of a preamble symbol s sum to
// z^lo conj(p_s) H, H = sum over r < hi - lo of x[i + lo + r] z^r, and H
// is taken from the block's last tap down as acc = acc z + x: one complex
// multiply-add (4 FMAs) a tap, where the first design took a
// full-precision sincosf a tap. A block is kHornerBlock = 20 taps or the
// rest of its symbol, whichever is shorter; each block after the first
// costs one sincosf (full precision: __sincosf loses accuracy near 2 pi)
// for its anchor z^lo, and one complex product. At the link's
// sw = w = 80 an offset takes four sincosf: z and three anchors. Horner's
// drift grows with the block (|z| and arg z are each rounded once and
// compound over its taps): whole 80-tap symbols held the float64
// oracle's bounds but had 3.3x the first design's error in |L| at the
// automaton's candidate peaks, enough to move a floored peak across an
// integer and FrameSync's estimates to the next offset; blocks of 20
// come within 1.03x of it (tests/test_torch_redesign_s1.py emulates
// these sums in float32 and fixes kHornerBlock there).
//
// The other sums stay direct, in the first design's order: each window
// sum adds the staged magnitudes one by one (the JAX program's float32
// prefix sums lose the windows at 32768 samples), and K adds one product
// x[j] conj(x[j + w/2]) a term, whose imaginary part is the difference of
// two rounded products, so it is exactly 0 where the two samples are
// opposite (a noiseless frame at zero frequency offset, where K lies on
// the negative real axis and atan2 would otherwise take either side).
//
// Layout and reuse. A block of T threads takes a tile of T k offsets of
// one channel, each thread k consecutive offsets (k = 1 or 2 dividing
// w / 2; the template serves any k, and benches_torch/
// probe_sync_search_parts.py builds k = 4 in its own copy). The block stages x[c, t0 : t0 + T k + sw] and its magnitudes
// once in shared memory, deinterleaved by k: sample p of the tile at row
// p % k, column p / k. Thread t's offset q reads tap j at p = k t + q + j,
// so one staged read (row m % k, column t + m / k, m = q + j) serves every
// offset of the thread whose tap it is, x[m + w/2] lies w / (2k) columns
// after x[m], and a warp's 32 threads read 32 consecutive words of one
// row: no bank conflicts. The window sums and K are shared the same way:
// a thread computes each product of K once and adds it into the sums of
// the offsets that take it.
//
// What bounds it on the H100. The search's least work is 806 float32
// operations an offset at the link's parameters (8 a correlation tap;
// K's product, 6, and |x|, 4, once a sample; 2 a term of K and 1 a term
// of each window sum; ~20 for the rest: ops_per_offset in
// kernels/sync_search.py): 0.0999 ms at [256, 32768] on 67 TFLOP/s; its
// bytes (x once, four [C, n] outputs) take 0.060 ms. The first design
// issued ~48 instructions a tap, most of them its sincosf, and took
// 1.512 ms on the card there. This one is bound by instruction
// issue still, at ~1100 issued instructions an offset: Horner's 4 FMAs and
// half a shared read a tap (~370), K's products and sums (~180), the
// window sums (~150), seven IEEE divisions, two atan2f and four sincosf
// (~320) and the staging and stores; benches_torch/probe_sync_search_parts.py
// times it with each part taken out, and at every plan (PERF.md). Shared
// memory is not the limit: k = 1 (no read shared between offsets) is only
// 21-22% slower than k = 2.
//
// The launch's plan (sync_search_plan, the one place that chooses it):
// k = 2 (1 where 2 does not divide w / 2) and 128 threads, k and then the
// threads halved while the grid has fewer than kMinBlocks blocks. At
// [256, 32768] k = 2 at 128 threads and k = 4 at 256 tie, the other seven
// plans 1-24% slower, and k = 2 holds fewer registers; a launch at C = 1
// ([1, 32768], [1, 65536]: FrameSync) has too few offsets to fill the
// card, and k = 1 there is 1.6-2.4x faster than k = 4.
// 50 registers a thread at k = 2, 48 at k = 1, no spills (-Xptxas -v).
// It never skips an offset: the work does not depend on the data, and
// where scale is 0 the outputs are the function's (scale, delta_fc and
// corr_peak 0, phase_off -atan2 of the zero-scaled L).
//
// Times on the card, NVIDIA H100 80GB HBM3 at 700 W: PERF.md, "S1".

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHornerBlock = 20;  // taps between two anchors of the rotation
constexpr int kThreads = 128;     // the plan's most threads a block
constexpr int kMinBlocks = 264;   // two blocks for each of the 132 SMs

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, -(a.y * b.y)), fmaf(a.x, b.y, a.y * b.x));
}

// acc = acc z + v, 4 FMAs
__device__ __forceinline__ void horner(float2& acc, float2 z, float2 v) {
  const float re = fmaf(acc.x, z.x, fmaf(-acc.y, z.y, v.x));
  const float im = fmaf(acc.x, z.y, fmaf(acc.y, z.x, v.y));
  acc = make_float2(re, im);
}

// Where a thread's staged sample m (m >= 0) lies in the [K][S] layout,
// from the thread's own column: row m % K, column m / K.
template <int K>
__device__ __forceinline__ int staged(int m, int S) {
  return (int)((unsigned)m % K * S + (unsigned)m / K);
}

// Calls add(q, load(at)) for every offset q < K and every term
// k' in [lo, hi), in ascending k', with at = staged(m) of the sample
// m = k' + q that the term reads for that offset: one load serves every q
// it belongs to. In the main range the K consecutive samples m .. m + K - 1
// lie in the K rows, so the next K lie one column on: their indices are
// kept, not recomputed.
template <int K, class Load, class Add>
__device__ __forceinline__ void slide(int lo, int hi, int S, Load load,
                                      Add add) {
#pragma unroll
  for (int t = 0; t < K - 1; ++t) {  // head: q <= t
    const int m = lo + t;
    const auto v = load(staged<K>(m, S));
#pragma unroll
    for (int q = 0; q <= t; ++q)
      if (m - q < hi) add(q, v);
  }
  int m = lo + K - 1, at[K];
#pragma unroll
  for (int t = 0; t < K; ++t) at[t] = staged<K>(m + t, S);
  for (; m + K <= hi; m += K) {  // every q
#pragma unroll
    for (int t = 0; t < K; ++t) {
      const auto v = load(at[t]++);
#pragma unroll
      for (int q = 0; q < K; ++q) add(q, v);
    }
  }
#pragma unroll
  for (int t = 0; t < K - 1; ++t) {  // the main range's last m, every q
    if (m + t < hi) {
      const auto v = load(at[t]);
#pragma unroll
      for (int q = 0; q < K; ++q) add(q, v);
    }
  }
  const int m0 = max(hi, lo + K - 1);
#pragma unroll
  for (int t = 0; t < K - 1; ++t) {  // tail: m in [m0, hi + K - 1)
    const int mt = m0 + t;
    if (mt < hi + K - 1) {
      const auto v = load(staged<K>(mt, S));
#pragma unroll
      for (int q = 0; q < K; ++q)
        if (mt - q >= lo && mt - q < hi) add(q, v);
    }
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads, 4)
sync_search_kernel(const float2* __restrict__ x, const float2* __restrict__ pre,
                   float* __restrict__ out, long long L, long long n, int sw,
                   int w, int dw, int npre, float thr) {
  extern __shared__ float smem[];
  const int threads = blockDim.x;
  const int tid = threadIdx.x;
  // the taps of the tile's offsets, and |x| at i + sw - dw (dw may be 0)
  const int span = threads * K + sw;
  const int S = threads + (sw + K - 1) / K;  // a row of the layout
  float2* xs = reinterpret_cast<float2*>(smem);       // [K][S]
  float* ax = reinterpret_cast<float*>(xs + K * S);   // [K][S]
  const int c = blockIdx.y;
  const long long t0 = (long long)blockIdx.x * threads * K;
  const float2* xc = x + (long long)c * L;
  for (int p = tid; p < span; p += threads) {
    const long long g = t0 + p;
    float2 v = make_float2(0.f, 0.f);
    if (g < L) v = xc[g];
    const int at = (p % K) * S + p / K;
    xs[at] = v;
    ax[at] = sqrtf(fmaf(v.x, v.x, v.y * v.y));
  }
  __syncthreads();
  const long long i0 = t0 + (long long)K * tid;
  if (i0 >= n) return;

  // this thread's staged samples (p = K tid + m) and magnitudes, by their
  // index staged(m) in the layout
  const float2* xt = xs + tid;
  const float* axt = ax + tid;
  auto A = [&](int i) { return axt[i]; };
  const int half = w / 2;

  // envelope consistency + scale estimate (reference :596-634)
  float sum0[K], sum1[K];
#pragma unroll
  for (int q = 0; q < K; ++q) sum0[q] = sum1[q] = 0.f;
  slide<K>(dw, half, S, A, [&](int q, float v) { sum0[q] += v; });
  slide<K>(sw - half, sw - dw, S, A, [&](int q, float v) { sum1[q] += v; });
  const float2 pf = pre[0], pl = pre[npre - 1];
  const float p_abs_f = sqrtf(fmaf(pf.x, pf.x, pf.y * pf.y));
  const float p_abs_l = sqrtf(fmaf(pl.x, pl.x, pl.y * pl.y));
  float scale[K];
#pragma unroll
  for (int q = 0; q < K; ++q) {
    const float s0w = sum0[q] / (float)(half - dw);
    const float s1w = sum1[q] / (float)(half - dw);
    bool ok = (axt[staged<K>(q + dw, S)] >= thr) &&
              (axt[staged<K>(q + sw - dw, S)] >= thr);
    ok = ok && (s0w >= thr);
    const float s0 = s0w / p_abs_f;
    ok = ok && (s1w >= thr);
    const float s1 = s1w / p_abs_l;
    const float ratio = (s1 != 0.f) ? s0 / s1 : __int_as_float(0x7f800000);
    ok = ok && (ratio <= 2.f) && (ratio >= 0.5f);
    scale[q] = ok ? 2.f / (s0 + s1) : 0.f;
  }

  // frequency-offset estimate (reference :640-664): each product
  // x[m] conj(x[m + half]) once, added into every offset that takes it;
  // K divides half, so x[m + half] lies half / K columns after x[m]
  float2 kk[K];
#pragma unroll
  for (int q = 0; q < K; ++q) kk[q] = make_float2(0.f, 0.f);
  const int klo = w * (npre - 1) + dw, hk = half / K;
  slide<K>(klo, klo + half - 2 * dw, S,
           [&](int i) {
             const float2 a = xt[i], b = xt[i + hk];
             return make_float2(fmaf(a.x, b.x, a.y * b.y),
                                __fsub_rn(__fmul_rn(a.y, b.x),
                                          __fmul_rn(a.x, b.y)));
           },
           [&](int q, float2 y) {
             kk[q].x += y.x;
             kk[q].y += y.y;
           });
  float dfc[K];
  float2 z[K], acc[K], lsum[K];
#pragma unroll
  for (int q = 0; q < K; ++q) {
    dfc[q] = scale[q] != 0.f ? atan2f(kk[q].y, kk[q].x) / (float)half : 0.f;
    float sn, cs;
    sincosf(dfc[q], &sn, &cs);
    z[q] = make_float2(cs, sn);
    lsum[q] = make_float2(0.f, 0.f);
  }

  // dechirped correlation (reference :670-693), block by block from the
  // last tap down; a block's bounds are multiples of K
  const float2* row[K];
#pragma unroll
  for (int r = 0; r < K; ++r) row[r] = xt + r * S;
  for (int s = npre - 1; s >= 0; --s) {
    const float2 p = pre[s];
    const float2 cp = make_float2(p.x, -p.y);
    for (int u = (w - 1) / kHornerBlock * kHornerBlock; u >= 0;
         u -= kHornerBlock) {
      const int lo = s * w + u, hi = min(lo + kHornerBlock, (s + 1) * w);
#pragma unroll
      for (int q = 0; q < K; ++q) acc[q] = make_float2(0.f, 0.f);
      // top chunk, m = hi + r: offset q takes tap hi + r - q where r < q
#pragma unroll
      for (int r = K - 2; r >= 0; --r) {
        const float2 v = row[r][hi / K];
#pragma unroll
        for (int q = r + 1; q < K; ++q) horner(acc[q], z[q], v);
      }
      // whole chunks, m = g K + r: every offset
      for (int g = hi / K - 1; g > lo / K; --g) {
#pragma unroll
        for (int r = K - 1; r >= 0; --r) {
          const float2 v = row[r][g];
#pragma unroll
          for (int q = 0; q < K; ++q) horner(acc[q], z[q], v);
        }
      }
      // bottom chunk, m = lo + r: offset q takes tap lo + r - q where r >= q
#pragma unroll
      for (int r = K - 1; r >= 0; --r) {
        const float2 v = row[r][lo / K];
#pragma unroll
        for (int q = 0; q <= r; ++q) horner(acc[q], z[q], v);
      }
#pragma unroll
      for (int q = 0; q < K; ++q) {
        float2 an = cp;
        if (lo != 0) {
          float sn, cs;
          sincosf(dfc[q] * (float)lo, &sn, &cs);
          an = cmul(make_float2(cs, sn), cp);
        }
        lsum[q].x = fmaf(an.x, acc[q].x, fmaf(-an.y, acc[q].y, lsum[q].x));
        lsum[q].y = fmaf(an.x, acc[q].y, fmaf(an.y, acc[q].x, lsum[q].y));
      }
    }
  }

  const long long plane = (long long)gridDim.y * n;
#pragma unroll
  for (int q = 0; q < K; ++q) {
    const long long i = i0 + q;
    if (i < n) {
      const float lr = lsum[q].x * scale[q], li = lsum[q].y * scale[q];
      const float mag = sqrtf(fmaf(lr, lr, li * li));
      const long long o = (long long)c * n + i;
      out[o] = scale[q];
      out[plane + o] = dfc[q];
      out[2 * plane + o] = -atan2f(li, lr);
      out[3 * plane + o] = scale[q] != 0.f ? floorf(mag) : 0.f;
    }
  }
}

template <int K>
int launch(const void* x, const void* pre, void* out, long long C,
           long long L, long long n, long long sw, long long w, long long dw,
           long long npre, float thr, int threads, cudaStream_t stream) {
  const int S = threads + (int)((sw + K - 1) / K);
  const size_t smem = (size_t)K * S * 12;
  cudaError_t err = cudaFuncSetAttribute(
      sync_search_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long tile = (long long)threads * K;
  const dim3 grid((unsigned)((n + tile - 1) / tile), (unsigned)C);
  sync_search_kernel<K><<<grid, threads, smem, stream>>>(
      (const float2*)x, (const float2*)pre, (float*)out, L, n, (int)sw,
      (int)w, (int)dw, (int)npre, thr);
  return (int)cudaGetLastError();
}

}  // namespace

// The launch's plan for C channels of n offsets at symbol width w:
// k offsets a thread and the threads a block.
extern "C" void sync_search_plan(long long C, long long n, long long w,
                                 int* k, int* threads) {
  int kk = w % 4 == 0 ? 2 : 1, t = kThreads;
  auto blocks = [&] { return C * ((n + (long long)kk * t - 1) / (kk * t)); };
  while (blocks() < kMinBlocks && kk > 1) kk /= 2;
  while (blocks() < kMinBlocks && t > 64) t /= 2;
  *k = kk;
  *threads = t;
}

extern "C" int sync_search_f32(const void* x, const void* pre, void* out,
                               long long C, long long L, long long n,
                               long long sw, long long w, long long dw,
                               long long npre, float thr, void* stream) {
  int k, threads;
  sync_search_plan(C, n, w, &k, &threads);
  const cudaStream_t st = (cudaStream_t)stream;
  if (k == 2)
    return launch<2>(x, pre, out, C, L, n, sw, w, dw, npre, thr, threads, st);
  return launch<1>(x, pre, out, C, L, n, sw, w, dw, npre, thr, threads, st);
}
