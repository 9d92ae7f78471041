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
// What bounds it on the H100: operations. Each offset costs ~1.6e3
// float32 operations (sw = 80 taps of a rotation and two complex products,
// and the window sums), and reads ~sw + 2 w/2 staged samples; its bytes in
// and out of device memory are ~8 of input and 16 of output. The design:
//  * One block per (tile of kTile = 256 offsets, channel), one offset a
//    thread. The block stages x[c, t0 : t0 + 256 + sw - 1] and its
//    magnitudes in shared memory once (each sample is read from device
//    memory by one block, plus the sw - 1 halo), with the conjugated
//    repeated preamble. A warp's 32 threads read 32 consecutive samples of
//    one tap, so the shared reads are free of bank conflicts.
//  * Each thread forms its window sums directly from the staged
//    magnitudes, not as differences of prefix sums: the sums hold the
//    precision of the window, not of the whole bucket.
//  * The rotation of tap j is sincosf(delta_fc * j) in full float32, as
//    the JAX program's cos and sin of the same float32 product:
//    |delta_fc j| reaches ~2 pi, where the fast __sincosf loses accuracy.
//    It is most of the work per tap.
//  * The complex products keep the JAX order of operations
//    ((frame * rot) * conj(p)), summed tap by tap.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 256;  // offsets a block, one a thread

__global__ void __launch_bounds__(kTile)
sync_search_kernel(const float2* __restrict__ x, const float2* __restrict__ pre,
                   float* __restrict__ out, long long L, long long n, int sw,
                   int w, int dw, int npre, float thr) {
  extern __shared__ float smem[];
  const int span = kTile + sw - 1;
  float2* xs = reinterpret_cast<float2*>(smem);        // [span]
  float2* cp = xs + span;                              // [sw]
  float* ax = reinterpret_cast<float*>(cp + sw);       // [span]
  const int c = blockIdx.y;
  const long long t0 = (long long)blockIdx.x * kTile;
  const float2* xc = x + (long long)c * L;
  for (int k = threadIdx.x; k < span; k += kTile) {
    const long long g = t0 + k;
    float2 v = make_float2(0.f, 0.f);
    if (g < L) v = xc[g];
    xs[k] = v;
    ax[k] = __fsqrt_rn(__fadd_rn(__fmul_rn(v.x, v.x), __fmul_rn(v.y, v.y)));
  }
  for (int k = threadIdx.x; k < sw; k += kTile) {
    const float2 p = pre[k / w];
    cp[k] = make_float2(p.x, -p.y);
  }
  __syncthreads();
  const long long i = t0 + threadIdx.x;
  if (i >= n) return;
  const int li = threadIdx.x;
  const int half = w / 2;

  // envelope consistency + scale estimate (reference :596-634)
  float sum0 = 0.f, sum1 = 0.f;
  for (int k = dw; k < half; ++k) sum0 += ax[li + k];
  for (int k = sw - half; k < sw - dw; ++k) sum1 += ax[li + k];
  sum0 = sum0 / (float)(half - dw);
  sum1 = sum1 / (float)(half - dw);
  const float2 pf = pre[0], pl = pre[npre - 1];
  const float p_abs_f =
      __fsqrt_rn(__fadd_rn(__fmul_rn(pf.x, pf.x), __fmul_rn(pf.y, pf.y)));
  const float p_abs_l =
      __fsqrt_rn(__fadd_rn(__fmul_rn(pl.x, pl.x), __fmul_rn(pl.y, pl.y)));
  bool ok = (ax[li + dw] >= thr) && (ax[li + sw - dw] >= thr);
  ok = ok && (sum0 >= thr);
  const float s0 = sum0 / p_abs_f;
  ok = ok && (sum1 >= thr);
  const float s1 = sum1 / p_abs_l;
  const float ratio = (s1 != 0.f) ? s0 / s1 : __int_as_float(0x7f800000);
  ok = ok && (ratio <= 2.f) && (ratio >= 0.5f);
  const float scale = ok ? 2.f / (s0 + s1) : 0.f;

  // frequency-offset estimate (reference :640-664)
  const int lo = w * (npre - 1) + dw, hi = w * (npre - 1) + w - half - dw;
  float kr = 0.f, ki = 0.f;
  for (int k = lo; k < hi; ++k) {
    const float2 a = xs[li + k], b = xs[li + k + half];
    // a * conj(b)
    kr += __fadd_rn(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y));
    ki += __fsub_rn(__fmul_rn(a.y, b.x), __fmul_rn(a.x, b.y));
  }
  const float dfc = scale != 0.f ? atan2f(ki, kr) / (float)half : 0.f;

  // dechirped correlation (reference :670-693)
  float lr = 0.f, lim = 0.f;
  for (int j = 0; j < sw; ++j) {
    float s, co;
    sincosf(__fmul_rn(dfc, (float)j), &s, &co);
    const float2 f = xs[li + j];
    const float2 p = cp[j];
    // (f * rot) * conj(p), each product as the JAX cplx.mul
    const float rr = __fsub_rn(__fmul_rn(f.x, co), __fmul_rn(f.y, s));
    const float ri = __fadd_rn(__fmul_rn(f.x, s), __fmul_rn(f.y, co));
    lr += __fsub_rn(__fmul_rn(rr, p.x), __fmul_rn(ri, p.y));
    lim += __fadd_rn(__fmul_rn(rr, p.y), __fmul_rn(ri, p.x));
  }
  lr = __fmul_rn(lr, scale);
  lim = __fmul_rn(lim, scale);
  const float mag =
      __fsqrt_rn(__fadd_rn(__fmul_rn(lr, lr), __fmul_rn(lim, lim)));
  const long long plane = (long long)gridDim.y * n;
  const long long o = (long long)c * n + i;
  out[o] = scale;
  out[plane + o] = dfc;
  out[2 * plane + o] = -atan2f(lim, lr);
  out[3 * plane + o] = scale != 0.f ? floorf(mag) : 0.f;
}

}  // namespace

extern "C" int sync_search_f32(const void* x, const void* pre, void* out,
                               long long C, long long L, long long n,
                               long long sw, long long w, long long dw,
                               long long npre, float thr, void* stream) {
  const long long span = kTile + sw - 1;
  const size_t smem = (size_t)span * 12 + (size_t)sw * 8;
  cudaError_t err = cudaFuncSetAttribute(
      sync_search_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((n + kTile - 1) / kTile), (unsigned)C);
  sync_search_kernel<<<grid, kTile, smem, (cudaStream_t)stream>>>(
      (const float2*)x, (const float2*)pre, (float*)out, L, n, (int)sw,
      (int)w, (int)dw, (int)npre, thr);
  return (int)cudaGetLastError();
}
