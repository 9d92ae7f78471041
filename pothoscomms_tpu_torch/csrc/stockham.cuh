// The device code of the mixed-radix Stockham FFT that K2 (fft.cu) and K3
// (fir_fft_fused.cu) share: the plan as kernels/fft.py packs it, the
// radix-R butterflies in registers, and one pass over a row's butterflies
// with its exchange through shared memory (smem_layout.cuh). fft.cu's
// header describes the algorithm and the layout.
//
// A pass takes two functors, so that a kernel can feed the first pass and
// take the last pass's results where it needs them:
//   in(idx)            sample idx of the row, for the first pass (and for
//                      a later one that is told to read from it);
//   out(it, r, idx, v) result v of bin idx in the last pass, the r-th
//                      output of the thread's it-th butterfly.
// K2 reads x and writes y; K3 also runs a row it built in shared memory
// through the same passes, keeps that row's last-pass results in registers
// (ITERS > 0 unrolls the butterfly loop, so `it` and `r` are constants
// there) and adds them in the epilogue of x's last pass.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "smem_layout.cuh"

namespace stockham {

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
  bool active;     // false in the masked tail of the last block
  unsigned base;   // the row's first word in a shared plane
  unsigned plane;  // words per plane (re, then im)
};

// One pass of radix R over this thread's butterflies j = t, t + trow, ...
// ITERS == 0: as many as the row has (K2). ITERS > 0: exactly ITERS, the
// loop unrolled, for a caller whose `out` indexes registers by `it` and
// `r`. from_in: a later pass also takes its samples from `in`, for a
// caller that knows what the passes before it would have left in the
// exchange buffer.
template <int R, bool INV, bool POW2, int ITERS = 0, class In, class Out>
__device__ __forceinline__ void pass(const PlanView& plan, int s, int passes,
                                     int n, int t, int trow, const Row& row,
                                     float* sm, const float2* __restrict__ tw,
                                     In in, Out out, bool from_in = false) {
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
  auto butterfly = [&](int j, int it) {
    float2 v[kR];
    if (first || from_in) {
#pragma unroll
      for (int r = 0; r < kR; ++r) v[r] = in(j + r * nb);
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
#pragma unroll
      for (int r = 0; r < kR; ++r) out(it, r, j + r * nb, v[slot<kR>(r)]);
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
  };
  if constexpr (ITERS > 0) {
#pragma unroll
    for (int it = 0; it < ITERS; ++it) butterfly(t + it * trow, it);
  } else {
    for (int j = t; j < nb; j += trow) butterfly(j, 0);
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

}  // namespace stockham
