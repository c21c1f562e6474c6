// Attention-probability dropout drawn inside the kernels from a counter-based
// generator, Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy
// as 1, 2, 3", SC 2011), so that no keep mask is ever written to or read
// from device memory. The TPU kernels draw with the TPU's own bits; these
// are not those bits, so the port's tests feed the JAX reference the mask
// that ops/kernels.py::dropout_keep_plain computes from the same seed.
//
// The mapping, one function for every kernel that applies or
// differentiates the dropout (the bf16 and f32 training forwards in
// attention.cu, the bf16 and f32 backwards in attention_backward.cu, and
// e3d_dropout_keep) and for ops/kernels.py::dropout_keep_plain:
//   key       = (seed[0] mod 2^32, seed[1] mod 2^32), seed a 2-element int64
//               device tensor the wrapper draws from the trainer's generator
//               (read through its pointer: the host never syncs);
//   n         = ((b H + h) Lq + l) Lk + r, the flat index of element
//               (b, h, l, r) of the (B, H, Lq, Lk) probabilities;
//   counter   = (floor(n / 8) mod 2^32, floor(n / 2^35), 0, 0);
//   u         = 16-bit half n mod 2 (0: low) of word (n mod 8) / 2 of
//               Philox4x32-10(counter, key);
//   keep      = u >= threshold, threshold = round(p 2^16) (at most
//               2^16 - 1), computed in Python: the keep probability is
//               within 2^-17 of 1 - p.
// A kept probability is scaled by 1 / (1 - p), as flax's Dropout does.
//
// Cost: one Philox call (10 rounds of 2 32-bit multiplies high and low,
// xors and key adds) gives eight keep bits. The tensor-core kernels' lanes
// hold, for every 8-key tile, keys 2t and 2t + 1 of rows g and g + 8 of
// their 16-row tile (mma.sync's accumulator layout); with Lk a multiple of
// 8 an 8-key tile of one row is exactly one call. keep_frag2 gives a lane
// the bits of two neighbouring tiles from ONE call: the quad's four lanes
// compute the four (tile, row) calls the quad needs and trade their bytes
// with two shuffles. Other Lk take one call per element. The kernels draw
// the bits while their staging copies are in flight.
#pragma once

#include <stdint.h>

namespace {

struct PhiloxKey {
  uint32_t k0, k1;
};

__device__ __forceinline__ PhiloxKey philox_key(const int64_t* seed) {
  return PhiloxKey{static_cast<uint32_t>(seed[0]),
                   static_cast<uint32_t>(seed[1])};
}

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, PhiloxKey key) {
  constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
  constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
  uint32_t k0 = key.k0, k1 = key.k1;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t hi0 = __umulhi(kM0, c.x), lo0 = kM0 * c.x;
    const uint32_t hi1 = __umulhi(kM1, c.z), lo1 = kM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += kW0;
    k1 += kW1;
  }
  return c;
}

// the eight 16-bit draws of the call that covers elements 8 c .. 8 c + 7,
// compared with the threshold: bit i keeps element 8 c + i
__device__ __forceinline__ uint32_t keep_byte(PhiloxKey key, uint64_t c,
                                              uint32_t thr) {
  const uint4 w = philox4x32_10(
      make_uint4(static_cast<uint32_t>(c), static_cast<uint32_t>(c >> 32), 0u,
                 0u),
      key);
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
  uint32_t bits = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    bits |= static_cast<uint32_t>(((words[i / 2] >> (16 * (i % 2))) &
                                   0xffffu) >= thr)
            << i;
  return bits;
}

// keep bit of flat element n (one Philox call)
__device__ __forceinline__ bool dropout_keep(PhiloxKey key, uint64_t n,
                                             uint32_t thr) {
  return keep_byte(key, n >> 3, thr) >> (n & 7) & 1u;
}

// The keep bits of a lane's accumulator fragments for the 8-key tiles
// 2 m and 2 m + 1 (keys 16 m .. 16 m + 15): bits 4 i + e for tile 2 m + i,
// e = 0 (row g, key r), 1 (row g, key r + 1), 2 (row g + 8, key r),
// 3 (row g + 8, key r + 1), r = 8 (2 m + i) + 2 t; row_g is the flat index
// of (row g, key 0). Every lane of the warp must call it together (the
// Lk % 8 == 0 path shuffles).
__device__ __forceinline__ uint32_t keep_frag2(PhiloxKey key, uint64_t row_g,
                                               int Lk, int m, int t,
                                               uint32_t thr) {
  const uint64_t row_g8 = row_g + 8ull * static_cast<uint64_t>(Lk);
  uint32_t out = 0;
  if (Lk % 8 == 0) {
    // lane t draws tile 2 m + (t >> 1) of row g (t even) or g + 8 (t odd);
    // the quad's four bytes then reach every lane of the quad
    const uint64_t n0 = ((t & 1) ? row_g8 : row_g) + 16 * m + 8 * (t >> 1);
    uint32_t x = keep_byte(key, n0 >> 3, thr) << (8 * t);
    x |= __shfl_xor_sync(0xffffffffu, x, 1);
    x |= __shfl_xor_sync(0xffffffffu, x, 2);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint32_t lo = (x >> (16 * i + 2 * t)) & 3u;      // row g
      const uint32_t hi = (x >> (16 * i + 8 + 2 * t)) & 3u;  // row g + 8
      out |= (lo | hi << 2) << (4 * i);
    }
    return out;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 16 * m + 8 * i + 2 * t;
    out |= (static_cast<uint32_t>(dropout_keep(key, row_g + r, thr)) |
            static_cast<uint32_t>(dropout_keep(key, row_g + r + 1, thr)) << 1 |
            static_cast<uint32_t>(dropout_keep(key, row_g8 + r, thr)) << 2 |
            static_cast<uint32_t>(dropout_keep(key, row_g8 + r + 1, thr)) << 3)
           << (4 * i);
  }
  return out;
}


// The bits of a lane's fragments for all NK 16-key steps: bits 4 j + e of
// the result for 8-key tile j (keep_frag2), NK <= 8. A rolled loop: one
// copy of the ~100 instructions of a call in the kernel, not NK (measured
// faster on the H100 than unrolled, both with the key schedule computed
// per call and precomputed).
template <int NK>
__device__ __forceinline__ uint64_t keep_frags(const int64_t* seed,
                                               uint64_t row_g, int Lk, int t,
                                               uint32_t thr) {
  const PhiloxKey key = philox_key(seed);
  uint64_t kb = 0;
#pragma unroll 1
  for (int m = 0; m < NK; ++m)
    kb |= static_cast<uint64_t>(keep_frag2(key, row_g, Lk, m, t, thr))
          << (8 * m);
  return kb;
}

}  // namespace
