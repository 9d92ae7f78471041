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
// from env0 (`envelope_scan`). The step keeps the JAX order of
// operations with round-to-nearest intrinsics, so nvcc does not contract
// it into an FMA.
//
// What bounds it on the H100: latency. Each row is a chain of Wr + L
// dependent steps (compare, select, two products, a sum); the rows run
// in parallel, one thread each, so the time is about (Wr + L) steps of
// that chain. Simple design: one warp per block (rows spread over every
// SM), each thread reads its row in order, so a warp's loads fall 4 L
// bytes apart and each cache line serves a thread 32 steps. Staging
// tiles through shared memory is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;

__device__ __forceinline__ float follow(float e, float x, float ga,
                                        float gr) {
  const float g = x > e ? ga : gr;
  return __fadd_rn(__fmul_rn(g, e), __fmul_rn(__fsub_rn(1.0f, g), x));
}

__global__ void envelope_rows_kernel(const float* __restrict__ mag,
                                     const float* __restrict__ env0,
                                     float* __restrict__ y,
                                     float* __restrict__ env_f, long long P,
                                     long long T, long long L, long long Wr,
                                     float ga, float gr) {
  const long long nb = T / L;
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= P * nb) return;
  const long long p = row / nb;
  const long long b = row - p * nb;
  const float* xp = mag + p * T;
  float* yp = y + p * T;
  const float e0 = env0[p];
  const long long base = b * L;  // step j reads xfull[p, base + j]
  float e = (b == 0 || base < Wr) ? e0 : xp[base - Wr];
  long long j = 0;
  for (; j < Wr && base + j < Wr; ++j) e = follow(e, e0, ga, gr);
  for (; j < Wr; ++j) e = follow(e, xp[base + j - Wr], ga, gr);
  for (; j < Wr + L; ++j) {
    e = follow(e, xp[base + j - Wr], ga, gr);
    yp[base + j - Wr] = e;
  }
  if (b == nb - 1) env_f[p] = e;
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
  const unsigned blocks = (unsigned)((rows + kThreads - 1) / kThreads);
  envelope_rows_kernel<<<blocks, kThreads, 0, st>>>(mag, env0, y, env_f, P,
                                                    T, L, Wr, ga, gr);
  return (int)cudaGetLastError();
}
