// Philox4x32-10 (Salmon et al., SC'11; the Random123 constants): the
// counter-based generator of kernel K5's dropout mask.
//
// keep[n, i, j] = philox4x32_10(counter = (j / 4, i, n, 0), key = seed)[j % 4] >= thr
//
// One call gives the four words of keys 4g .. 4g + 3 of one query row. The
// CUDA-core kernels (a thread per query row) spend one call per four logits
// of their row; the dk/dv pass of the CUDA-core backward builds a tile's bits
// in shared memory first. The tensor-core kernels (csrc/dropout_tc.cuh) call
// philox_keyed with the ten round keys computed once per thread
// (philox_round_keys): a round is then two 32x32 -> 64-bit products
// (IMAD.WIDE.U32) and two 3-way xors (LOP3). ops/flash_dropout_attention.py::
// philox4x32_10 computes the same words in plain PyTorch; the known-answer
// vector of Random123 (counter 0, key 0: 6627e8d5 e169c58d bc57ac4c 9b00dbd8)
// pins both.
#pragma once

#include <cstdint>

namespace vq {

// The round keys of Philox4x32-10 for key (k0, k1): round r xors k0 + r W0
// and k1 + r W1; they depend on the seed alone.
struct PhiloxKeys {
  uint32_t k0[10], k1[10];
};

__device__ __forceinline__ PhiloxKeys philox_round_keys(uint32_t k0, uint32_t k1) {
  PhiloxKeys keys;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    keys.k0[r] = k0 + static_cast<uint32_t>(r) * 0x9E3779B9u;
    keys.k1[r] = k1 + static_cast<uint32_t>(r) * 0xBB67AE85u;
  }
  return keys;
}

// philox4x32_10 on precomputed round keys: the same words
__device__ __forceinline__ uint4 philox_keyed(uint4 c, const PhiloxKeys& keys) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint64_t p0 = static_cast<uint64_t>(0xD2511F53u) * c.x;
    const uint64_t p1 = static_cast<uint64_t>(0xCD9E8D57u) * c.z;
    c = make_uint4(static_cast<uint32_t>(p1 >> 32) ^ c.y ^ keys.k0[r], static_cast<uint32_t>(p1),
                   static_cast<uint32_t>(p0 >> 32) ^ c.w ^ keys.k1[r], static_cast<uint32_t>(p0));
  }
  return c;
}

// The CUDA-core kernels' form: the round keys advanced in place
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// The 4 keep bits of keys 4g .. 4g + 3 of row i of n (bit r for key 4g + r).
__device__ __forceinline__ uint32_t keep4(uint32_t g, uint32_t i, uint32_t n, uint32_t k0,
                                          uint32_t k1, uint32_t thr) {
  const uint4 w = philox4x32_10(make_uint4(g, i, n, 0u), k0, k1);
  return static_cast<uint32_t>(w.x >= thr) | static_cast<uint32_t>(w.y >= thr) << 1 |
         static_cast<uint32_t>(w.z >= thr) << 2 | static_cast<uint32_t>(w.w >= thr) << 3;
}

}  // namespace vq
