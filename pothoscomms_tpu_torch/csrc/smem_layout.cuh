// Shared-memory address layouts for tiles of 32-bit words: the swizzle
// that P2 (layout_move.cu) and K2 (fft.cu) use for their exchanges.
//
// A warp's 32 loads or stores of 4-byte words are conflict-free when
// they hit 32 distinct banks (bank = word address mod 32). The kernels'
// exchanges move words at power-of-two strides (P2: 8, m and 8 m; K2's
// Stockham passes: the stride R of the first pass, and the stride of each
// later pass's writes), which pile onto a few banks in a plain layout.
//
//  * swz(i): a linear XOR swizzle over GF(2). Bits 5..12 of the word
//    index (which 32-word line it lies in) are mapped by the 8-entry
//    table kSwzTable to a 5-bit mask that is XORed into bits 0..4 (the
//    bank). It permutes the words of each 32-word line, so it is a
//    bijection on any tile of a multiple of 32 words up to 8192 words,
//    and it is linear: swz(a ^ b) == swz(a) ^ swz(b). Where an address
//    is a sum of parts on disjoint bits (power-of-two shapes), a kernel
//    swizzles the per-thread part once and XORs in precomputed offsets.
//    The table was found by a search over every warp access of P2's
//    three maps (N = 64 .. 8192) and of K2's exchanges (n = 2 .. 4096,
//    its thread layout): with it, every one of them hits 32 distinct
//    banks (tests/test_torch_fft_plan.py mirrors this function and
//    checks that).
//  * pad(i): one padding word after every 32, for shapes that are not
//    powers of two, where sums carry across bits and the XOR swizzle
//    loses its guarantee. Accesses at stride 8 or 16 spread over all
//    banks, but a contiguous run that crosses a 32-word line, and a warp
//    whose lanes span two rows, keep 2-way (at worst 3-way) conflicts:
//    it is not conflict-free (tests/test_torch_fft_plan.py counts them).
//    A tile of w words needs pad(w - 1) + 1.

#pragma once

#include <cuda_runtime.h>

namespace smem {

// bank mask contributed by bit 5 + b of a word index
__host__ __device__ __forceinline__ unsigned swz_table(int b) {
  constexpr unsigned kSwzTable[8] = {15u, 25u, 29u, 21u, 27u, 18u, 19u, 18u};
  return kSwzTable[b];
}

__host__ __device__ __forceinline__ unsigned swz(unsigned i) {
  const unsigned h = i >> 5;
  unsigned m = 0;
#pragma unroll
  for (int b = 0; b < 8; ++b) m ^= ((h >> b) & 1u) * swz_table(b);
  return i ^ m;
}

__host__ __device__ __forceinline__ unsigned pad(unsigned i) {
  return i + (i >> 5);
}

// Division by a runtime divisor d >= 1 without a divide instruction
// (the round-up method: Hacker's Delight 10-9): q = (umulhi(x, magic) + x)
// >> shift, exact for 0 <= x < 2^31. For d a power of two, magic == 1 and
// umulhi is 0, so q = x >> log2(d).
struct FastDiv {
  unsigned d, magic, shift;
};

__host__ __device__ inline FastDiv make_fastdiv(unsigned d) {
  unsigned l = 0;
  while ((1ull << l) < d) ++l;
  const unsigned long long num = (1ull << 32) * ((1ull << l) - d);
  return FastDiv{d, (unsigned)(num / d + 1), l};
}

__device__ __forceinline__ unsigned div(unsigned x, FastDiv f) {
  return (__umulhi(x, f.magic) + x) >> f.shift;
}

}  // namespace smem
