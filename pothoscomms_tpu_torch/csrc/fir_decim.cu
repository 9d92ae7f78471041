// K4: the decimating complex FIR of the FIR -> FFT chain, with its K-1
// sample carry, over [C, T] blocks of interleaved complex float32.
//
// It replaces no TPU kernel: the JAX package runs this FIR as `lax.conv`
// with a stride (`fir_multichannel`, pothoscomms_tpu/parallel/chain.py),
// and the port ran it as cuDNN's `conv1d` on a permuted view of
// `cat(history, x)`, a permute back and a carry copy. On an H100 that
// took ~96% of the decimating channelizer's device time at C = 256,
// T = 131072, K = 64, D = 2 (cuDNN's grouped direct kernel 2.42 ms at
// 3.55 TFLOP/s, the `cat` and the permute copies ~0.5 ms more), where
// the stage needs 0.120 ms of bytes.
//
// What it computes, for row c (kernels/fir_decim.py `fir_decim_plain`):
//   y[n] = sum_k h[k] xt[D n - k],  0 <= n < M = T / D,
// xt[s] = x[s] for s >= 0, carry[K - 1 + s] for -(K-1) <= s < 0: the
// carry followed by x, the phase of `conv1d(stride=D)` on
// `cat(carry, x)`. Every product and sum is a float32 FMA. The new carry
// is xt[T - (K-1) .. T - 1], copied bit for bit.
//
// Bounds at [256, 131072], D = 2, K = 64: the bytes (x and the carry in,
// y and the carry out: 402.9 MB) take 0.120 ms at 3.35 TB/s; the 4.29 G
// real FMAs (4 a tap an output, at the T / D outputs kept) take 0.128 ms
// at 67 TFLOP/s float32 off the tensor cores. The stage is balanced
// between the two, so the kernel has to issue FMAs nearly every cycle
// while the loads stream under them.
//
// Design. A block takes L = 8 * threads consecutive outputs of one row.
// It stages what they read, split by phase: phase p (p < min(D, K)) is
// the row Q_p[m] = xt[D m - p], and tap p + D j of output n reads
// Q_p[n - j]. Each phase row holds L + JP samples (JP the phase's tap
// count rounded up to 8) with one float2 of padding after every 8, and
// the taps sit beside them phase-major, zero past K. The samples come
// straight from device memory into shared memory (cp.async, no
// registers), consecutive threads on consecutive samples, every copy of
// the block in flight at once; the block reads its inputs once, plus a
// halo of JP samples a phase (3% at L = 1024, JP = 32).
// A thread owns R = 8 consecutive outputs. For each phase it walks the
// taps in chunks of 8: the 8 outputs of tap j read Q_p[n0 - j ..
// n0 - j + 7], a window that moves down one sample a tap, so one new
// shared load feeds 32 FMAs, and a chunk's 8 taps come in 4 broadcast
// 16-byte loads. Neighbouring threads' windows lie 9 float2 apart (the
// padding), so the loads are free of bank conflicts, and every address
// is a per-chunk base plus a constant. Each thread stores its 8 outputs
// from its registers as four 16-byte stores, so y is written once in the
// layout the FFT reads. Ten blocks stay resident on an SM (20 KB of
// shared memory and at most 51 registers a thread at the shape above),
// so one block's staging runs under another's FMAs.
//
// Measured on an H100 (700 W) at the shape above: ~0.205 ms, 59% of the
// byte bound. The FMA loop issues ~94% FFMA, but the compute alone (with
// y's writes) takes ~0.178 ms and the staging alone ~0.139 ms, and a
// block's stage-then-compute overlaps the two only in part. Slower there:
// loads through registers (0.227), y through shared memory (0.213),
// Gauss's three-product multiply (0.217: its taps' loads then bound the
// shared memory), two sub-tiles a block (0.220, 0.229), a persistent block
// that prefetches its next tile (0.244).

#include <cuda_runtime.h>

namespace {

constexpr int kR = 8;               // consecutive outputs a thread
constexpr int kMaxThreads = 128;    // threads a block, at most
constexpr int kMaxSmem = 232448;    // an H100 block's shared memory

// padded float2 of sample m of a phase row: one after every 8
__device__ __forceinline__ int pad(int m) { return m + (m >> 3); }

struct Args {
  const float2* __restrict__ x;      // [C, T]
  const float2* __restrict__ carry;  // [C, K - 1]
  const float2* __restrict__ taps;   // [K]
  float2* __restrict__ y;            // [C, M]
  float2* __restrict__ carry_out;    // [C, K - 1]
  int T, M, K, D;
  int P;       // phases with taps: min(D, K)
  int JP;      // taps a phase, rounded up to a multiple of 8
  int L;       // outputs a block: 8 * blockDim.x
  int rowq;    // padded float2 of a phase row: pad(L + JP)
  int ntiles;  // blocks a row: ceil(M / L)
};

// xt[s] of row c, zero before the carry and from T on
__device__ __forceinline__ float2 sample(const Args& a, long long c, int s) {
  if (s >= a.T) return make_float2(0.f, 0.f);
  if (s >= 0) return a.x[c * a.T + s];
  const int k1 = a.K - 1;
  return s >= -k1 ? a.carry[c * k1 + k1 + s] : make_float2(0.f, 0.f);
}

// Copy 8 bytes from device to shared memory without registers
// (cp.async; the caller waits for them with cp.async.wait_all).
__device__ __forceinline__ void copy8(float2* dst, const float2* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
               "l"(src));
}

// Stage the phase rows of the block whose first staged m is mlo, every
// copy in flight at once. D2: the sample pair xt[2i], xt[2i + 1] goes to
// Q_0[i] and Q_1[i + 1]. Samples outside x (the carry, zeros) are stored
// directly.
template <bool D2>
__device__ __forceinline__ void stage(const Args& a, float2* q, long long c,
                                      int mlo) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int n = a.L + a.JP;  // samples a phase row
  const float2* xr = a.x + c * a.T;
  if (D2) {
    float2* q1 = q + a.rowq;
    const bool two = a.P > 1;
    for (int v = tid; v <= n; v += nt) {
      const int s = 2 * (mlo - 1 + v);
      if (s >= 0 && s + 1 < a.T) {
        if (v > 0) copy8(q + pad(v - 1), xr + s);
        if (two && v < n) copy8(q1 + pad(v), xr + s + 1);
      } else {
        if (v > 0) q[pad(v - 1)] = sample(a, c, s);
        if (two && v < n) q1[pad(v)] = sample(a, c, s + 1);
      }
    }
  } else {
    // xt[D mlo - (D - 1) + u] is Q_p[mlo + u / D] with p = D - 1 - u % D
    const int s0 = a.D * mlo - (a.D - 1);
    for (int u = tid; u < a.D * n; u += nt) {
      const int p = a.D - 1 - u % a.D;
      if (p >= a.P) continue;
      float2* dst = q + p * a.rowq + pad(u / a.D);
      const int s = s0 + u;
      if (s >= 0 && s < a.T)
        copy8(dst, xr + s);
      else
        *dst = sample(a, c, s);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);
}

// acc += h * w, complex, in four float32 FMAs
__device__ __forceinline__ void mac(float2& acc, float2 h, float2 w) {
  acc.x = fmaf(h.x, w.x, acc.x);
  acc.x = fmaf(-h.y, w.y, acc.x);
  acc.y = fmaf(h.x, w.y, acc.y);
  acc.y = fmaf(h.y, w.x, acc.y);
}

template <bool D2>
__global__ void __launch_bounds__(kMaxThreads, 10)
    fir_decim_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  float2* h = reinterpret_cast<float2*>(smem4);  // [P][JP]
  float2* q = h + a.P * a.JP;                    // [P][rowq]
  const int tid = threadIdx.x, nt = blockDim.x;
  const long long c = blockIdx.x / a.ntiles;
  const int tile = blockIdx.x - (int)c * a.ntiles;
  const int nb = tile * a.L;  // the block's first output
  const int mlo = nb - a.JP;  // its first staged m

  for (int i = tid; i < a.P * a.JP; i += nt) {
    const int p = i / a.JP, k = p + a.D * (i - p * a.JP);
    h[i] = k < a.K ? a.taps[k] : make_float2(0.f, 0.f);
  }
  stage<D2>(a, q, c, mlo);
  __syncthreads();

  // outputs nb + t0 .. + 7; Q_p[n0 - j] is padded word pad(t0 + JP) - 9 ch
  // - 1 - jj of the phase row, for j = 8 ch + jj (t0 + JP is a multiple
  // of 8)
  const int t0 = tid * kR;
  float2 acc[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) acc[r] = make_float2(0.f, 0.f);
  const int nchunks = a.JP / 8;
  for (int p = 0; p < a.P; ++p) {
    const float2* qp = q + p * a.rowq + pad(t0 + a.JP);
    const float4* hp = reinterpret_cast<const float4*>(h + p * a.JP);
    float2 w[kR];  // w[r] = Q_p[n0 + r - j]
#pragma unroll
    for (int r = 0; r < kR; ++r) w[r] = qp[r];
    for (int ch = 0; ch < nchunks; ++ch, qp -= 9, hp += 4) {
      float2 hh[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 v = hp[i];
        hh[2 * i] = make_float2(v.x, v.y);
        hh[2 * i + 1] = make_float2(v.z, v.w);
      }
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        if (jj > 0) {
#pragma unroll
          for (int r = kR - 1; r > 0; --r) w[r] = w[r - 1];
          w[0] = qp[-1 - jj];
        }
#pragma unroll
        for (int r = 0; r < kR; ++r) mac(acc[r], hh[jj], w[r]);
      }
#pragma unroll
      for (int r = kR - 1; r > 0; --r) w[r] = w[r - 1];
      w[0] = qp[-9];
    }
  }

  // y straight from the registers: a thread's 8 outputs are 64 bytes of
  // a row, four 16-byte stores where the row keeps that alignment
  float2* yr = a.y + c * a.M + nb + t0;
  const int nown = min(kR, a.M - nb - t0);
  if (nown == kR && (c * a.M) % 2 == 0) {
#pragma unroll
    for (int r = 0; r < kR; r += 2)
      *reinterpret_cast<float4*>(yr + r) =
          make_float4(acc[r].x, acc[r].y, acc[r + 1].x, acc[r + 1].y);
  } else {
    for (int r = 0; r < nown; ++r) yr[r] = acc[r];
  }

  if (tile == a.ntiles - 1) {
    const int k1 = a.K - 1;
    for (int i = tid; i < k1; i += nt)
      a.carry_out[c * k1 + i] = sample(a, c, a.T - k1 + i);
  }
}

}  // namespace

// x [C, T, 2], carry [C, K-1, 2], taps [K, 2] -> y [C, T/D, 2], carry_out
// [C, K-1, 2]; contiguous float32, 8-byte aligned (y 16-byte aligned),
// carry_out no alias of carry. 1 <= K <= 256, D >= 2, T a multiple of D, 1 <= T < 2^31;
// threads in {32, 64, 128}, jp = ceil(ceil(K / D) / 8) * 8, and the
// shared memory of kernels/fir_decim.py `plan` within an H100 block's.
// D = 2 takes the paired staging. Returns cudaGetLastError() after the
// launch.
extern "C" int fir_decim_f32(const float* x, const float* carry,
                             const float* taps, float* y, float* carry_out,
                             long long C, long long T, int K, int D,
                             int threads, int jp, int smem, void* stream) {
  if (C <= 0) return (int)cudaGetLastError();
  const long long M = D > 0 ? T / D : 0;
  const int P = D < K ? D : K;
  const int L = kR * threads;
  const long long ntiles = (M + L - 1) / L;
  const long long need =
      8LL * ((long long)P * jp + (long long)P * (L + jp + (L + jp) / 8));
  if (K < 1 || K > 256 || D < 2 || T < 1 || T % D || T >= (1LL << 31) ||
      (threads != 32 && threads != 64 && threads != 128) || jp % 8 ||
      jp < (K + D - 1) / D || jp >= (K + D - 1) / D + 8 || smem != need ||
      smem > kMaxSmem || C * ntiles >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const bool d2 = D == 2;
  auto kernel = d2 ? fir_decim_kernel<true> : fir_decim_kernel<false>;
  static bool opted[2][64] = {};
  int devno = 0;
  cudaGetDevice(&devno);
  if (devno < 0 || devno >= 64) return (int)cudaErrorInvalidDevice;
  if (!opted[d2][devno]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    opted[d2][devno] = true;
  }
  const Args a{reinterpret_cast<const float2*>(x),
               reinterpret_cast<const float2*>(carry),
               reinterpret_cast<const float2*>(taps),
               reinterpret_cast<float2*>(y),
               reinterpret_cast<float2*>(carry_out),
               (int)T,
               (int)M,
               K,
               D,
               P,
               jp,
               L,
               L + jp + (L + jp) / 8,
               (int)ntiles};
  kernel<<<(unsigned)(C * ntiles), threads, smem,
           static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
