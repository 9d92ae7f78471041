// D1: the link's frame decode for every channel of a batch, on the card.
//
// It replaces no TPU kernel: the JAX package decodes each channel on the
// host, as parallel/link.py's `decode_frame` does on CPU tensors, and that
// host decode is the function D1 computes (and the card tests' oracle).
// One block takes one channel c and, from S1's four arrays
// [C, n_pad] (kernels/sync_search.py) and the window x [C, lp, 2] where
// they lie on the card:
//   1. walks the acceptance automaton of blocks/framing.py
//      (`run_sync_automaton_scalar`, FrameSync.cpp:488-502) over offsets
//      0 .. n_off - 1, n_off = lengths[c] - (lp - n_pad): a peak
//      cp > max and cp > mag sets the estimates; the count since it
//      reaching dur accepts frame_offset = i - count, a negative one is
//      skipped, and a refused header walks on;
//   2. decodes the header at an accepted offset (`process_header_bits`,
//      FrameSync.cpp:699-743): the first-bit search over [sw - w/2, fw),
//      58 sliced bits, Hamming(8,4), the checksum, the id and a non-zero
//      length; a header whose bits run past lengths[c] is refused;
//   3. gathers the header's `length` payload symbols at the bit clock,
//      takes the phase ramp out and slices them on the map [-1, 1]
//      (SymbolSlicer: the nearer point by |y - p|^2, the first on a tie);
//      a payload running past lengths[c] keeps the offset and estimates
//      and is not found;
//   4. descrambles: additive descrambling is an XOR with the LFSR's
//      keystream ks (made once by the receiver, with at least 4097 bits),
//      and `align_payload`'s shift s (0, 1, 2, the first that fits) reads
//      out[k] = rx[k] ^ ks[k + s]: the 8 - s pilot bits all zero and
//      n_bits payload bits after them.
// Each channel's record (out + c * rec): int64 frame offset (-1: no header
// decoded), float32 scale, delta_fc and phase_off at the accepted peak
// (NaN: none), int32 header rejects, int32 shift (-1: not found), then
// n_bits payload bits a byte (0 where not found), at byte 32.
//
// The arithmetic is the host's, operation for operation, so the decisions
// agree: the rotations, slicer distances and sign tests in float64 from
// the float32 samples and estimates widened, x * scale first rounded to
// float32 where numpy's complex64 product rounds it (the first-bit search
// and the payload), every product and sum rounded apart (the __d*_rn and
// __f*_rn intrinsics: nvcc would contract them into FMAs). Only sin and
// cos may differ from the host's libm in the last place.
//
// The walk. The automaton is serial, but almost every offset only counts:
// a block stages kTile offsets of corr_peak in shared memory as ints with
// one ballot word a 32 (cp > mag), and warp 0 walks them, all its lanes
// holding the same state: the next candidate from the words by a ballot
// over 32 words at a time, the count across a run of non-candidates by
// arithmetic, the acceptance inside such a run where the count reaches
// dur. An acceptance hands the offset to the whole block, which decodes
// the header: the first-bit search's values in parallel, then the first
// negative value and the first rise after it by atomicMin (the host's
// loop descends from its first negative value and stops at the first
// rise), the 58 bits a thread each, the codec on one thread. Nothing is
// written to device memory per offset.
//
// What bounds it on the H100: its bytes are the corr_peak arrays up to
// each channel's frame, the header and payload samples and the records,
// ~30 MB at [256, 32457] with frames late in the window (~10 us at
// 3.35 TB/s); its float64 work is ~4300 sincos a channel. The walk is one
// warp's latency: a tile's load, a few ballots a candidate. Times on the
// card, NVIDIA H100 80GB HBM3 at 700 W: PERF.md, "D1".

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 4096;                // offsets a block stages at once
constexpr int kWords = kTile / 32;         // candidate words of a tile
constexpr int kChunk = 1024;               // first-bit values at once
constexpr int kHeaderBits = 2 + (8 + 12 + 8) * 2;  // FrameHelper.hpp:9
constexpr int kMaxLength = (1 << 12) - 1;  // the header's 12-bit length
constexpr int kPilot = 8;                  // zero pilot bits ahead
constexpr int kRecordHead = 32;            // bytes before the bits

struct Args {
  const float* scale;  // S1's arrays, [C, n_pad] each
  const float* dfc;
  const float* phase;
  const float* peak;
  const float2* x;             // [C, lp]
  const long long* lengths;    // [C]
  const unsigned char* ks;     // the keystream
  unsigned char* out;          // [C, rec]
  long long n_pad, lp, rec, n_bits;
  long long sw, w, dw, mag, dur, header_id;
  double sym_re, sym_im;       // conj of the last preamble symbol
};

struct Shared {
  int cps[kTile];
  unsigned masks[kWords];
  double vals[kChunk + 1];     // vals[0]: the previous chunk's last
  unsigned char rx[kMaxLength + 1];
  unsigned char hbits[kHeaderBits];
  long long off, est;
  int event, neg, brk, length, shift;
};

struct Walker {
  long long i;    // next offset the automaton has not taken
  long long cnt;  // count_since_max after offset i - 1
  long long est;  // offset of the peak whose estimates stand
  int mx;         // max_corr_peak
  int pos;        // next offset of the tile to look for candidates at
};

// The first candidate at or after the tile's offset `pos`, else `end`.
__device__ long long next_candidate(const Shared& s, int pos, long long t0,
                                    long long end, int lane) {
  const int w0 = pos >> 5;
  for (int g = w0; g < kWords; g += 32) {
    const int wi = g + lane;
    unsigned m = wi < kWords ? s.masks[wi] : 0u;
    if (wi == w0) m &= ~0u << (pos & 31);
    const unsigned any = __ballot_sync(~0u, m != 0u);
    if (any) {
      const int src = __ffs(any) - 1;
      const unsigned mw = __shfl_sync(~0u, m, src);
      return t0 + ((long long)(g + src) << 5) + (__ffs(mw) - 1);
    }
  }
  return end;
}

// Warp 0's walk over the tile [t0, end) from where it stands: true with
// *off at the next acceptance whose frame offset is not negative, false
// at the tile's end.
__device__ bool walk(Walker& k, const Shared& s, long long t0, long long end,
                     const Args& a, int lane, long long* off) {
  for (;;) {
    const long long j = next_candidate(s, k.pos, t0, end, lane);
    if (k.mx >= a.mag) {  // a peak stands: accept where the count reaches dur
      const long long at = k.i + max(a.dur - k.cnt - 1, 0LL);
      if (at < j) {
        k.cnt += at - k.i + 1;
        k.i = at + 1;
        k.mx = 0;
        *off = at - k.cnt;
        if (*off >= 0) return true;
      }
    }
    k.cnt += j - k.i;
    k.i = j;
    if (j == end) return false;
    const int cp = s.cps[j - t0];
    if (cp > k.mx) {
      k.mx = cp;
      k.cnt = 0;
      k.est = j;
    }
    k.cnt += 1;
    k.i = j + 1;
    k.pos = (int)(j - t0) + 1;
    if (k.mx >= a.mag && k.cnt >= a.dur) {
      k.mx = 0;
      *off = j - k.cnt;
      if (*off >= 0) return true;
    }
  }
}

__device__ __forceinline__ double angle(double pho, double dfc, long long r) {
  return __dadd_rn(pho, __dmul_rn(dfc, (double)r));
}

// x scale e^{j(pho + dfc r)} conj(last preamble symbol), its real part:
// x * scale a complex64 product, the rest complex128 (the first-bit search).
__device__ __forceinline__ double first_bit_value(float2 x, float sf,
                                                  double dfc, double pho,
                                                  long long r,
                                                  const Args& a) {
  const double ar = __fmul_rn(x.x, sf), ai = __fmul_rn(x.y, sf);
  double sn, cs;
  sincos(angle(pho, dfc, r), &sn, &cs);
  const double pr = __dsub_rn(__dmul_rn(ar, cs), __dmul_rn(ai, sn));
  const double pi = __dadd_rn(__dmul_rn(ar, sn), __dmul_rn(ai, cs));
  return __dsub_rn(__dmul_rn(pr, a.sym_re), __dmul_rn(pi, a.sym_im));
}

// A header bit: x (scale e^{j(pho + dfc r)}) conj(last symbol) > 0, all in
// complex128 (process_header_bits' `rot` is formed before the product).
__device__ __forceinline__ unsigned char header_bit(float2 x, double scale,
                                                    double dfc, double pho,
                                                    long long r,
                                                    const Args& a) {
  double sn, cs;
  sincos(angle(pho, dfc, r), &sn, &cs);
  const double rr = __dmul_rn(scale, cs), ri = __dmul_rn(scale, sn);
  const double xr = x.x, xi = x.y;
  const double pr = __dsub_rn(__dmul_rn(xr, rr), __dmul_rn(xi, ri));
  const double pi = __dadd_rn(__dmul_rn(xr, ri), __dmul_rn(xi, rr));
  return __dsub_rn(__dmul_rn(pr, a.sym_re), __dmul_rn(pi, a.sym_im)) > 0.0;
}

// A payload bit: y = (x * scale) e^{j(pho + dfc r)}, sliced on [-1, 1].
__device__ __forceinline__ unsigned char payload_bit(float2 x, float sf,
                                                     double dfc, double pho,
                                                     long long r) {
  const double ar = __fmul_rn(x.x, sf), ai = __fmul_rn(x.y, sf);
  double sn, cs;
  sincos(angle(pho, dfc, r), &sn, &cs);
  const double yr = __dsub_rn(__dmul_rn(ar, cs), __dmul_rn(ai, sn));
  const double yi = __dadd_rn(__dmul_rn(ar, sn), __dmul_rn(ai, cs));
  const double d0 = hypot(__dadd_rn(yr, 1.0), yi);
  const double d1 = hypot(__dsub_rn(yr, 1.0), yi);
  return __dmul_rn(d1, d1) < __dmul_rn(d0, d0);
}

// Hamming(8,4) with single-bit correction (FrameHelper.hpp:82-120).
__device__ int unhamming(const unsigned char* b, bool* error) {
  unsigned char v[8];
  for (int i = 0; i < 8; ++i) v[i] = b[i] & 1;
  const int p0 = v[0] ^ v[2] ^ v[4] ^ v[6];
  const int p1 = v[1] ^ v[2] ^ v[5] ^ v[6];
  const int p2 = v[3] ^ v[4] ^ v[5] ^ v[6];
  const int p3 = v[0] ^ v[1] ^ v[2] ^ v[3] ^ v[4] ^ v[5] ^ v[6] ^ v[7];
  const int parity = p0 | (p1 << 1) | (p2 << 2) | (p3 << 3);
  if (parity != 0 && parity < 8) *error = true;
  if (parity >= 8) v[parity == 8 ? 7 : parity - 9] ^= 1;
  return v[2] | (v[4] << 1) | (v[5] << 2) | (v[6] << 3);
}

// The header's length where it decodes and passes the checks, else 0.
__device__ int read_header(const unsigned char* bits, long long header_id) {
  bool error = false;
  int v[7];
  for (int k = 0; k < 7; ++k) v[k] = unhamming(bits + 2 + 8 * k, &error);
  const int id = v[0] | (v[1] << 4);
  const int length = v[2] | (v[3] << 4) | (v[4] << 8);
  const int chksum = v[5] | (v[6] << 4);
  const int data[3] = {id & 0xFF, length & 0xFF, (length >> 8) & 0xFF};
  int acc = 0;  // checksum8 (FrameHelper.hpp:18-27)
  for (int i = 0; i < 3; ++i) {
    acc = ((acc >> 1) | ((acc & 1) << 7)) & 0xFF;
    acc = (acc + data[i]) & 0xFF;
  }
  if (error || chksum != acc || id != header_id || length == 0) return 0;
  return length;
}

// The whole block decodes the header of the frame at `off` with the
// estimates at offset `est`: returns its length, or 0 where the host's
// try_decode refuses it; *first_bit the bit clock's first sample.
__device__ int header(const Args& a, Shared& s, long long c, long long len,
                      long long off, long long est, long long* first_bit) {
  const int tid = threadIdx.x;
  const long long e = c * a.n_pad + est;
  const float sf = a.scale[e];
  const double dfc = a.dfc[e], pho = a.phase[e];
  const float2* xs = a.x + c * a.lp + off;
  const long long fw = a.sw + kHeaderBits * a.dw;
  const long long start = a.sw - a.w / 2;
  if (tid == 0) {
    s.neg = INT_MAX;
    s.brk = INT_MAX;
  }
  __syncthreads();
  for (long long base = start; base < fw; base += kChunk) {
    const int n = (int)min((long long)kChunk, fw - base);
    for (int k = tid; k < n; k += kThreads) {
      const double v = first_bit_value(xs[base + k], sf, dfc, pho, base + k, a);
      s.vals[k + 1] = v;
      if (v < 0.0) atomicMin(&s.neg, (int)(base + k));
    }
    __syncthreads();
    const int neg = s.neg;
    if (neg != INT_MAX)
      for (int k = tid; k < n; k += kThreads)
        if (base + k > neg && s.vals[k + 1] > s.vals[k])
          atomicMin(&s.brk, (int)(base + k));
    __syncthreads();
    if (s.brk != INT_MAX) break;
    if (tid == 0) s.vals[0] = s.vals[n];
    __syncthreads();
  }
  const int neg = s.neg, brk = s.brk;
  if (neg == INT_MAX) return 0;  // no negative value: the peak stayed 0
  const long long fb = (brk == INT_MAX ? fw : brk) - 1;
  *first_bit = fb;
  if (off + fb + (kHeaderBits - 1) * a.dw >= len) return 0;  // past the end
  if (tid < kHeaderBits)
    s.hbits[tid] = header_bit(xs[fb + tid * a.dw], (double)sf, dfc, pho,
                              fb + tid * a.dw, a);
  __syncthreads();
  if (tid == 0) s.length = read_header(s.hbits, a.header_id);
  __syncthreads();
  return s.length;
}

// The channel's record: the frame at `off` (-1: none) with the estimates
// at `est`, its rejects, and the payload of s.rx at `shift` (-1: none).
__device__ void write_record(const Args& a, const Shared& s, long long c,
                             long long off, long long est, int rejects,
                             int shift) {
  unsigned char* rec = a.out + c * a.rec;
  for (long long k = threadIdx.x; k < a.n_bits; k += kThreads)
    rec[kRecordHead + k] =
        shift >= 0 ? s.rx[kPilot - shift + k] ^ a.ks[kPilot + k] : 0;
  if (threadIdx.x == 0) {
    const float nan = __int_as_float(0x7fc00000);
    const long long e = c * a.n_pad + est;
    *reinterpret_cast<long long*>(rec) = off;
    float* f = reinterpret_cast<float*>(rec + 8);
    f[0] = off >= 0 ? a.scale[e] : nan;
    f[1] = off >= 0 ? a.dfc[e] : nan;
    f[2] = off >= 0 ? a.phase[e] : nan;
    int* n = reinterpret_cast<int*>(rec + 20);
    n[0] = rejects;
    n[1] = shift;
    n[2] = 0;
  }
}

// Slices the `length` payload symbols after the header into s.rx, picks
// align_payload's shift and writes the record.
__device__ void payload(const Args& a, Shared& s, long long c, long long len,
                        long long off, long long est, long long fb,
                        int length, int rejects) {
  const int tid = threadIdx.x;
  const long long rel0 = fb + kHeaderBits * a.dw;
  if (off + rel0 + (length - 1) * a.dw >= len) {  // runs past the end
    write_record(a, s, c, off, est, rejects, -1);
    return;
  }
  const long long e = c * a.n_pad + est;
  const float sf = a.scale[e];
  const double dfc = a.dfc[e], pho = a.phase[e];
  const float2* xs = a.x + c * a.lp + off;
  for (int k = tid; k < length; k += kThreads) {
    const long long r = rel0 + k * a.dw;
    s.rx[k] = payload_bit(xs[r], sf, dfc, pho, r);
  }
  __syncthreads();
  if (tid == 0) {
    s.shift = -1;
    for (int sh = 0; sh < 3 && s.shift < 0; ++sh) {
      bool zero = true;
      for (int k = 0; k < kPilot - sh && k < length; ++k)
        zero = zero && (s.rx[k] ^ a.ks[k + sh]) == 0;
      const long long avail = max((long long)length - (kPilot - sh), 0LL);
      if (zero && min(avail, a.n_bits) == a.n_bits) s.shift = sh;
    }
  }
  __syncthreads();
  write_record(a, s, c, off, est, rejects, s.shift);
}

__global__ void __launch_bounds__(kThreads) frame_decode_kernel(const Args a) {
  __shared__ Shared s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long c = blockIdx.x;
  const long long len = min(max(a.lengths[c], 0LL), a.lp);
  const long long n_off = len - (a.lp - a.n_pad);
  const float* cpr = a.peak + c * a.n_pad;
  Walker k{0, 0, -1, 0, 0};
  int rejects = 0;  // thread 0's count
  for (long long t0 = 0; t0 < n_off; t0 += kTile) {
    const long long end = min(t0 + kTile, n_off);
    for (int q = 0; q < kTile / kThreads; ++q) {
      const int p = q * kThreads + tid;
      const bool in = t0 + p < end;
      const int cp = in ? (int)cpr[t0 + p] : 0;
      s.cps[p] = cp;
      const unsigned m = __ballot_sync(~0u, in && cp > a.mag);
      if (lane == 0) s.masks[p >> 5] = m;
    }
    k.pos = 0;
    __syncthreads();
    for (;;) {
      if (warp == 0) {
        long long off = -1;
        const bool hit = walk(k, s, t0, end, a, lane, &off);
        if (lane == 0) {
          s.event = hit;
          s.off = off;
          s.est = k.est;
        }
      }
      __syncthreads();
      if (!s.event) break;
      const long long off = s.off, est = s.est;
      long long fb = 0;
      const int length = header(a, s, c, len, off, est, &fb);
      if (length > 0) {
        payload(a, s, c, len, off, est, fb, length, rejects);
        return;
      }
      if (tid == 0) ++rejects;
      __syncthreads();
    }
    __syncthreads();
  }
  write_record(a, s, c, -1, 0, rejects, -1);
}

}  // namespace

extern "C" int frame_decode_f32(const float* scale, const float* dfc,
                                const float* phase, const float* peak,
                                const float* x, const long long* lengths,
                                const unsigned char* ks, unsigned char* out,
                                long long C, long long n_pad, long long lp,
                                long long rec, long long n_bits,
                                long long n_ks, long long sw, long long w,
                                long long dw, long long mag, long long dur,
                                long long header_id, double sym_re,
                                double sym_im, void* stream) {
  if (C <= 0) return (int)cudaGetLastError();
  const long long fw = sw + kHeaderBits * dw;
  if (C >= (1LL << 31) || n_pad < 1 || lp - n_pad != fw - 1 || dw < 1 ||
      w < 2 || sw < w || mag < 0 || dur < 1 || n_bits < 0 ||
      rec < kRecordHead + n_bits || rec % 16 ||
      n_ks < kMaxLength + 2 || lp >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const Args a{scale, dfc, phase, peak, reinterpret_cast<const float2*>(x),
               lengths, ks, out, n_pad, lp, rec, n_bits, sw, w, dw, mag,
               dur, header_id, sym_re, sym_im};
  frame_decode_kernel<<<(unsigned)C, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
