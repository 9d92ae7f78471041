// K2: batched complex FFT, x [B, n] -> y [B, n], complex f32, forward
// (plain DFT) or unnormalized inverse, output in natural order.
//
// Replaces the TPU kernel `fft_fused_pallas` / `_fft_fused_kernel`
// (pothoscomms_tpu/parallel/pallas_kernels.py:97-185) and its wrapper
// `fft_planar_fused` (:200-227). The TPU kernel's 8x128 two-stage DFT
// split exists for the TPU's 128-wide matrix unit and is not copied.
//
// What bounds it on the H100: an FFT does ~5 n log2 n flops per 16 n
// bytes (8 read, 8 written per complex sample), under 4 flops per byte
// at n <= 4096, so it is HBM-bound (3.35 TB/s published). The design
// reads each sample once and writes it once, keeps every pass's data in
// registers, and moves it between passes through shared memory in an
// order that costs no bank conflicts where n is a power of two.
//
// Design: a mixed-radix Stockham auto-sort FFT (no bit reversal), one
// plan per n built on the host (kernels/fft.py `stockham_plan`): radices
// from {16, 8, 4, 2, 3, 5, 7}, largest first, for n = 2^a 3^b 5^c 7^d
// <= 4096 (16 * 16 * 4 for n = 1024: 3 passes and 2 exchanges, where a
// radix-2 FFT takes 10 passes).
// Pass p of radix R, with ns the product of the earlier radices, takes
// for each j < n / R the R samples j + r n/R, multiplies sample r by the
// twiddle W_{ns R}^{r (j mod ns)}, runs a radix-R DFT in registers, and
// writes the results to (j / ns) ns R + (j mod ns) + q ns. The first pass
// reads global memory and the last writes it, both coalesced (neighbour
// threads, neighbour samples); between passes the row goes through shared
// memory as two f32 planes (re, im), in two buffers taken in turn.
//  * Shared-memory layout (smem_layout.cuh): for n a power of two the XOR
//    swizzle smem::swz, under which every warp access of every exchange
//    hits 32 distinct banks; the addresses of a butterfly are its first
//    address XOR per-pass offsets precomputed on the host (the parts lie
//    on disjoint bits). For other n, smem::pad, which leaves 2- and
//    3-way conflicts on some accesses (1.2-1.9 times a conflict-free
//    access on average, counted in tests/test_torch_fft_plan.py).
//  * j / ns and j mod ns without a divide: smem::FastDiv from the plan.
//  * Twiddles: per-pass tables [(R - 1) x ns] computed in float64 on the
//    host and rounded to f32, one table per direction; nothing is
//    computed with sincosf on the card.
//  * Threads: trow = min(n / R_max, 256) per row, and 256 / trow rows per
//    block for small n; a ragged last block is masked.
//  * Full f32 arithmetic, no tensor cores.
// An n with a prime factor above 7 keeps the direct O(n^2) DFT below.
// Rows longer than 4096 are split into two factors by the caller
// (parallel/fft.py), each factor's FFTs running here.

#include <cuda_runtime.h>
#include <stdint.h>

#include "smem_layout.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPasses = 12;  // kernels/fft.py MAX_PASSES
constexpr int kMaxLog2Radix = 4;  // radix 16

// The plan as kernels/fft.py packs it: int32 arrays of kMaxPasses each.
struct PlanView {
  const int* p;
  __device__ int radix(int s) const { return __ldg(p + s); }
  __device__ int tw_off(int s) const { return __ldg(p + kMaxPasses + s); }
  __device__ smem::FastDiv ns(int s) const {
    return smem::FastDiv{(unsigned)__ldg(p + 2 * kMaxPasses + s),
                         (unsigned)__ldg(p + 3 * kMaxPasses + s),
                         (unsigned)__ldg(p + 4 * kMaxPasses + s)};
  }
  // for power-of-two n: swz((n / R) << b) and swz(ns << b), b < log2 R;
  // sample r's offset is the XOR of those of r's set bits (swz is linear)
  __device__ unsigned rbasis(int s, int b) const {
    return (unsigned)__ldg(p + 5 * kMaxPasses + s * kMaxLog2Radix + b);
  }
  __device__ unsigned wbasis(int s, int b) const {
    return (unsigned)__ldg(p + 5 * kMaxPasses + kMaxPasses * kMaxLog2Radix +
                           s * kMaxLog2Radix + b);
  }
};
constexpr int kPlanInts = 5 * kMaxPasses + 2 * kMaxPasses * kMaxLog2Radix;

__device__ __forceinline__ float2 operator+(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 operator-(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
// a * exp(-+i pi/2): -i forward, +i inverse
template <bool INV>
__device__ __forceinline__ float2 rot90(float2 a) {
  return INV ? make_float2(-a.y, a.x) : make_float2(a.y, -a.x);
}
// W_16^m = exp(-+2 pi i m / 16) for m = 0..9
template <bool INV>
__device__ __forceinline__ float2 w16(int m) {
  constexpr float c[10] = {1.0f, 0.92387953251128674f, 0.70710678118654752f,
                           0.38268343236508977f, 0.0f,
                           -0.38268343236508977f, -0.70710678118654752f,
                           -0.92387953251128674f, -1.0f,
                           -0.92387953251128674f};
  constexpr float s[10] = {0.0f, 0.38268343236508977f, 0.70710678118654752f,
                           0.92387953251128674f, 1.0f,
                           0.92387953251128674f, 0.70710678118654752f,
                           0.38268343236508977f, 0.0f,
                           -0.38268343236508977f};
  return make_float2(c[m], INV ? s[m] : -s[m]);
}

template <bool INV>
__device__ __forceinline__ void dft2(float2& a0, float2& a1) {
  const float2 t = a0 - a1;
  a0 = a0 + a1;
  a1 = t;
}

template <bool INV>
__device__ __forceinline__ void dft4(float2& a0, float2& a1, float2& a2,
                                     float2& a3) {
  const float2 t0 = a0 + a2, t1 = a0 - a2;
  const float2 t2 = a1 + a3, t3 = rot90<INV>(a1 - a3);
  a0 = t0 + t2;
  a2 = t0 - t2;
  a1 = t1 + t3;
  a3 = t1 - t3;
}

// radix 8 as 2 x 4: X[q + 4 s] = F0[q] + (-1)^s W8^q F1[q], with
// Fl = DFT4(v[l], v[l + 2], v[l + 4], v[l + 6]); in place, X[q + 4 s]
// lands in v[2 q + s] (slot<8>)
template <bool INV>
__device__ __forceinline__ void dft8(float2 (&v)[8]) {
  dft4<INV>(v[0], v[2], v[4], v[6]);
  dft4<INV>(v[1], v[3], v[5], v[7]);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 b = q == 0 ? v[1] : cmul(v[2 * q + 1], w16<INV>(2 * q));
    v[2 * q + 1] = v[2 * q] - b;
    v[2 * q] = v[2 * q] + b;
  }
}

// radix 16 as 4 x 4: Fl[q] = DFT4 over v[l + 4 m], times W16^(l q), then
// X[q + 4 s] = DFT4 over l of Fl[q]; in place, X[q + 4 s] lands in
// v[4 q + s] (slot<16>)
template <bool INV>
__device__ __forceinline__ void dft16(float2 (&v)[16]) {
#pragma unroll
  for (int l = 0; l < 4; ++l) dft4<INV>(v[l], v[l + 4], v[l + 8], v[l + 12]);
#pragma unroll
  for (int l = 1; l < 4; ++l)
#pragma unroll
    for (int q = 1; q < 4; ++q) v[l + 4 * q] = cmul(v[l + 4 * q], w16<INV>(l * q));
#pragma unroll
  for (int q = 0; q < 4; ++q)
    dft4<INV>(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
}

// the register that holds output k of dft<R>: radix 8 and 16 leave their
// outputs in place, transposed
template <int R>
__device__ __forceinline__ constexpr int slot(int k) {
  return R == 16 ? 4 * (k & 3) + (k >> 2) : R == 8 ? 2 * (k & 3) + (k >> 2)
                                                   : k;
}

template <int R>
__host__ __device__ constexpr int log2_radix() {
  return R == 16 ? 4 : R == 8 ? 3 : R == 4 ? 2 : R == 2 ? 1 : 0;
}

// XOR of basis[b] over the set bits b of r
template <int L>
__device__ __forceinline__ unsigned xor_basis(const unsigned (&basis)[L + 1],
                                              int r) {
  unsigned o = 0;
#pragma unroll
  for (int b = 0; b < L; ++b)
    if ((r >> b) & 1) o ^= basis[b];
  return o;
}

// cos and sin of 2 pi m / R for the odd radices
template <int R>
struct OddTable;
template <>
struct OddTable<3> {
  static __device__ __forceinline__ float c(int m) {
    constexpr float t[3] = {1.0f, -0.5f, -0.5f};
    return t[m];
  }
  static __device__ __forceinline__ float s(int m) {
    constexpr float t[3] = {0.0f, 0.86602540378443865f, -0.86602540378443865f};
    return t[m];
  }
};
template <>
struct OddTable<5> {
  static __device__ __forceinline__ float c(int m) {
    constexpr float t[5] = {1.0f, 0.30901699437494742f, -0.80901699437494742f,
                            -0.80901699437494742f, 0.30901699437494742f};
    return t[m];
  }
  static __device__ __forceinline__ float s(int m) {
    constexpr float t[5] = {0.0f, 0.95105651629515357f, 0.58778525229247313f,
                            -0.58778525229247313f, -0.95105651629515357f};
    return t[m];
  }
};
template <>
struct OddTable<7> {
  static __device__ __forceinline__ float c(int m) {
    constexpr float t[7] = {1.0f,
                            0.62348980185873353f,
                            -0.22252093395631440f,
                            -0.90096886790241913f,
                            -0.90096886790241913f,
                            -0.22252093395631440f,
                            0.62348980185873353f};
    return t[m];
  }
  static __device__ __forceinline__ float s(int m) {
    constexpr float t[7] = {0.0f,
                            0.78183148246802981f,
                            0.97492791218182361f,
                            0.43388373911755812f,
                            -0.43388373911755812f,
                            -0.97492791218182361f,
                            -0.78183148246802981f};
    return t[m];
  }
};

// odd radix R: with t_p = v[p] + v[R - p], d_p = v[p] - v[R - p],
// X[k] = v[0] + sum_p cos(2 pi p k / R) t_p -+ i sum_p sin(2 pi p k / R) d_p
template <int R, bool INV>
__device__ __forceinline__ void dft_odd(float2 (&v)[R]) {
  constexpr int H = (R - 1) / 2;
  float2 t[H], d[H];
#pragma unroll
  for (int p = 0; p < H; ++p) {
    t[p] = v[p + 1] + v[R - 1 - p];
    d[p] = v[p + 1] - v[R - 1 - p];
  }
  float2 o[R];
  o[0] = v[0];
#pragma unroll
  for (int p = 0; p < H; ++p) o[0] = o[0] + t[p];
#pragma unroll
  for (int k = 1; k < R; ++k) {
    float re = v[0].x, im = v[0].y, sr = 0.f, si = 0.f;
#pragma unroll
    for (int p = 0; p < H; ++p) {
      const int m = ((p + 1) * k) % R;
      re = fmaf(OddTable<R>::c(m), t[p].x, re);
      im = fmaf(OddTable<R>::c(m), t[p].y, im);
      sr = fmaf(OddTable<R>::s(m), d[p].x, sr);
      si = fmaf(OddTable<R>::s(m), d[p].y, si);
    }
    // -i (sr + i si) = si - i sr forward; +i (...) inverse
    o[k] = INV ? make_float2(re - si, im + sr) : make_float2(re + si, im - sr);
  }
#pragma unroll
  for (int i = 0; i < R; ++i) v[i] = o[i];
}

template <int R, bool INV>
__device__ __forceinline__ void dft(float2 (&v)[R]) {
  if constexpr (R == 2) {
    dft2<INV>(v[0], v[1]);
  } else if constexpr (R == 4) {
    dft4<INV>(v[0], v[1], v[2], v[3]);
  } else if constexpr (R == 8) {
    dft8<INV>(v);
  } else if constexpr (R == 16) {
    dft16<INV>(v);
  } else if constexpr (R == 3 || R == 5 || R == 7) {
    dft_odd<R, INV>(v);
  }  // R == 1: the copy pass of n = 1
}

struct Row {
  const float2* x;  // this thread's row of x, y
  float2* y;
  bool active;       // false in the masked tail of the last block
  unsigned base;     // the row's first word in a shared plane
  unsigned plane;    // words per plane (re, then im)
};

// one pass of radix R over this thread's butterflies j = t, t + trow, ...
template <int R, bool INV, bool POW2>
__device__ __forceinline__ void pass(const PlanView& plan, int s, int passes,
                                     int n, int t, int trow, const Row& row,
                                     float* sm, const float2* __restrict__ tw) {
  constexpr int kR = R;
  const int nb = n / kR;
  const bool first = s == 0, last = s == passes - 1;
  const float* src = sm + ((s - 1) & 1) * 2 * row.plane;
  float* dst = sm + (s & 1) * 2 * row.plane;
  const smem::FastDiv nsd = plan.ns(s);
  const unsigned ns = nsd.d;
  const float2* twp = tw + plan.tw_off(s);
  constexpr int kL = log2_radix<kR>();
  unsigned rb[kL + 1], wb[kL + 1];
  if (POW2) {
#pragma unroll
    for (int b = 0; b < kL; ++b) {
      rb[b] = first ? 0u : plan.rbasis(s, b);
      wb[b] = last ? 0u : plan.wbasis(s, b);
    }
  }
  for (int j = t; j < nb; j += trow) {
    float2 v[kR];
    if (first) {
#pragma unroll
      for (int r = 0; r < kR; ++r)
        v[r] = row.active ? row.x[j + r * nb] : make_float2(0.f, 0.f);
    } else if (POW2) {
      const unsigned a = smem::swz(row.base + j);
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const unsigned i = a ^ xor_basis<kL>(rb, r);
        v[r] = make_float2(src[i], src[row.plane + i]);
      }
    } else {
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const unsigned i = smem::pad(row.base + j + r * nb);
        v[r] = make_float2(src[i], src[row.plane + i]);
      }
    }
    const unsigned jd = smem::div((unsigned)j, nsd);
    const unsigned k = j - jd * ns;
    if (ns > 1) {
#pragma unroll
      for (int r = 1; r < kR; ++r)
        v[r] = cmul(v[r], __ldg(twp + (r - 1) * ns + k));
    }
    dft<kR, INV>(v);
    if (last) {  // ns R == n, so jd == 0 and k == j
      if (row.active) {
#pragma unroll
        for (int r = 0; r < kR; ++r) row.y[j + r * nb] = v[slot<kR>(r)];
      }
    } else if (POW2) {
      const unsigned a = smem::swz(row.base + jd * ns * kR + k);
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const unsigned i = a ^ xor_basis<kL>(wb, r);
        dst[i] = v[slot<kR>(r)].x;
        dst[row.plane + i] = v[slot<kR>(r)].y;
      }
    } else {
      const unsigned o = row.base + jd * ns * kR + k;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const unsigned i = smem::pad(o + r * ns);
        dst[i] = v[slot<kR>(r)].x;
        dst[row.plane + i] = v[slot<kR>(r)].y;
      }
    }
  }
}

template <bool INV, bool POW2>
__global__ void __launch_bounds__(kThreads, 2)
    stockham_kernel(const float2* __restrict__ x, float2* __restrict__ y,
                    const float2* __restrict__ tw,
                    const int* __restrict__ plan_ints, long long B, int n,
                    int passes, int trow, int rows, unsigned plane) {
  extern __shared__ float sm[];
  const PlanView plan{plan_ints};
  const int lrow = threadIdx.x / trow;
  const int t = threadIdx.x - lrow * trow;
  const long long grow = (long long)blockIdx.x * rows + lrow;
  Row row;
  row.active = grow < B;
  row.x = x + (row.active ? grow : 0) * n;
  row.y = y + (row.active ? grow : 0) * n;
  row.base = (unsigned)(lrow * n);
  row.plane = plane;
  for (int s = 0; s < passes; ++s) {
    switch (plan.radix(s)) {
      case 16: pass<16, INV, POW2>(plan, s, passes, n, t, trow, row, sm, tw); break;
      case 8: pass<8, INV, POW2>(plan, s, passes, n, t, trow, row, sm, tw); break;
      case 4: pass<4, INV, POW2>(plan, s, passes, n, t, trow, row, sm, tw); break;
      case 2: pass<2, INV, POW2>(plan, s, passes, n, t, trow, row, sm, tw); break;
      case 3: pass<3, INV, POW2>(plan, s, passes, n, t, trow, row, sm, tw); break;
      case 5: pass<5, INV, POW2>(plan, s, passes, n, t, trow, row, sm, tw); break;
      case 7: pass<7, INV, POW2>(plan, s, passes, n, t, trow, row, sm, tw); break;
      default: pass<1, INV, POW2>(plan, s, passes, n, t, trow, row, sm, tw); break;
    }
    if (s + 1 < passes) __syncthreads();
  }
}

// direct DFT for an n with a prime factor above 7: one block per row,
// each thread one output bin, the n-entry twiddle table W[j] (staged in
// shared memory) indexed by (j * k) mod n, accumulated incrementally
__global__ void dft_kernel(const float2* __restrict__ x,
                           float2* __restrict__ y,
                           const float2* __restrict__ tw, int n) {
  extern __shared__ float2 s2[];
  float2* sx = s2;       // the row
  float2* stw = s2 + n;  // the twiddle table
  const float2* xr = x + (int64_t)blockIdx.x * n;
  float2* yr = y + (int64_t)blockIdx.x * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    sx[i] = xr[i];
    stw[i] = tw[i];
  }
  __syncthreads();
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    float re = 0.f, im = 0.f;
    int idx = 0;  // (j * k) mod n
    for (int j = 0; j < n; ++j) {
      const float2 v = sx[j];
      const float2 w = stw[idx];
      re = fmaf(v.x, w.x, fmaf(-v.y, w.y, re));
      im = fmaf(v.x, w.y, fmaf(v.y, w.x, im));
      idx += k;
      if (idx >= n) idx -= n;
    }
    yr[k] = make_float2(re, im);
  }
}

template <typename K>
int launch_with_smem(K kernel, size_t smem) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // namespace

extern "C" int fft_plan_ints() { return kPlanInts; }

// Stockham path. x, y [B, n, 2]; tw the plan's twiddles for the
// direction; plan the packed int32 plan (kernels/fft.py, on the card);
// passes, trow, rows from the same plan. Returns cudaGetLastError() after
// the launch (or the error of raising the shared-memory limit), or
// cudaErrorInvalidValue for a plan the kernel does not take.
extern "C" int fft_stockham_f32(const float* x, float* y, const float* tw,
                                const int* plan, long long B, int n,
                                int passes, int trow, int rows, int inverse,
                                void* stream) {
  if (n < 1 || n > 4096 || passes < 1 || passes > kMaxPasses || trow < 1 ||
      rows < 1 || trow * rows > kThreads)
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool pow2 = (n & (n - 1)) == 0;
  const unsigned words = (unsigned)(rows * n);
  const unsigned plane = pow2 ? words : smem::pad(words - 1) + 1;
  const int buffers = passes >= 3 ? 2 : 1;
  const size_t smem = (size_t)buffers * 2 * plane * sizeof(float);
  const unsigned blocks = (unsigned)((B + rows - 1) / rows);
  const float2* x2 = reinterpret_cast<const float2*>(x);
  float2* y2 = reinterpret_cast<float2*>(y);
  const float2* tw2 = reinterpret_cast<const float2*>(tw);
  auto go = [&](auto kernel) {
    const int e = launch_with_smem(kernel, smem);
    if (e) return e;
    kernel<<<blocks, trow * rows, smem, st>>>(x2, y2, tw2, plan, B, n, passes,
                                              trow, rows, plane);
    return (int)cudaGetLastError();
  };
  if (inverse)
    return pow2 ? go(stockham_kernel<true, true>)
                : go(stockham_kernel<true, false>);
  return pow2 ? go(stockham_kernel<false, true>)
              : go(stockham_kernel<false, false>);
}

// Direct DFT. x, y [B, n, 2]; tw [n, 2] = exp(-+2 pi i j / n).
extern "C" int fft_dft_f32(const float* x, float* y, const float* tw,
                           long long B, int n, void* stream) {
  if (n < 1 || n > 4096) return (int)cudaErrorInvalidValue;
  if (B <= 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int threads = ((n + 31) / 32) * 32;
  if (threads > 256) threads = 256;
  const size_t smem = 2 * (size_t)n * sizeof(float2);
  const int e = launch_with_smem(dft_kernel, smem);
  if (e) return e;
  dft_kernel<<<(unsigned)B, threads, smem, st>>>(
      reinterpret_cast<const float2*>(x), reinterpret_cast<float2*>(y),
      reinterpret_cast<const float2*>(tw), n);
  return (int)cudaGetLastError();
}
