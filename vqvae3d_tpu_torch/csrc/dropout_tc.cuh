// Kernel K5's dropout mask on the tensor-core C fragments (csrc/mma.cuh), for
// its bf16 forward (flash_dropout_fwd_tc) and both passes of its bf16
// backward (drop_dq_tc, drop_dkdv_tc).
//
// In the m16n8 C fragment, lane l = 4 g + t holds rows g and g + 8 of the
// warp's 16 and keys 2 t, 2 t + 1 of each 8-key block nb. One Philox call
// (csrc/philox.cuh, counter (j / 4, i, n, 0)) gives the keep bits of keys
// 4 G .. 4 G + 3 of one row, and those four keys of an 8-key block lie on the
// lane pair (l, l ^ 1). So over a 64-key tile the even lane of a pair computes
// the 8 calls of its row g, the odd lane those of row g + 8
// (lane_keep_word: one word, bit 4 nb + b for key 8 nb + 4 (t / 2) + b), and
// one __shfl_xor_sync(.., 1) gives each lane the other row's word
// (row_bits). Every call is made once, by one lane, and no lane idles.
//
// The query-major pass of the backward stores each lane's word as it is:
// tile (qt, kt) of stream n is TILE_WORDS words, word 32 w + l from lane l of
// warp w, i.e. bit 4 nb + b of word 32 w + 4 g + t is the keep bit of query
// 64 qt + 16 w + g + 8 (t % 2), key 64 kt + 8 nb + 4 (t / 2) + b
// (ops/flash_dropout_attention.py::unpack_tile_bits reads the same layout).
// The key-major pass stages a tile's 512 bytes beside Q and dO and reads its
// columns (column_bits).
#pragma once

#include "philox.cuh"

#include <cstdint>

namespace vq {
namespace dtc {

constexpr int TILE_WORDS = 128;  // the keep bits of a 64 x 64 tile: 512 bytes

// The tiles on or below the diagonal before query tile qt: tile (qt, kt) is
// number tile_index(qt) + kt of its stream.
__host__ __device__ __forceinline__ int64_t tile_index(int qt) {
  return static_cast<int64_t>(qt) * (qt + 1) / 2;
}

// The lane's word of key tile kt: 8 Philox calls for row `row` (the lane's
// r0 when it is even, r1 when odd), groups 16 kt + 2 nb + t / 2.
__device__ __forceinline__ uint32_t lane_keep_word(int kt, int t, uint32_t row, uint32_t n,
                                                   const PhiloxKeys& keys, uint32_t thr) {
  const uint32_t g0 = 16u * static_cast<uint32_t>(kt) + static_cast<uint32_t>(t >> 1);
  uint32_t w = 0u;
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) {
    const uint4 r = philox_keyed(make_uint4(g0 + 2u * nb, row, n, 0u), keys);
    w |= (static_cast<uint32_t>(r.x >= thr) | static_cast<uint32_t>(r.y >= thr) << 1 |
          static_cast<uint32_t>(r.z >= thr) << 2 | static_cast<uint32_t>(r.w >= thr) << 3)
         << (4 * nb);
  }
  return w;
}

// The words of rows r0 and r1 from the lane's own and its pair's, shifted so
// that bit 4 nb + (e & 1) is the keep bit of C element (nb, e) (e < 2: r0).
struct RowBits {
  uint32_t r0, r1;
};

__device__ __forceinline__ RowBits row_bits(uint32_t mine, int lane) {
  const uint32_t other = __shfl_xor_sync(0xffffffffu, mine, 1);
  const int sh = 2 * (lane & 1);  // the lane's keys are bits 2 (t % 2), +1 of its group
  return (lane & 1) ? RowBits{other >> sh, mine >> sh} : RowBits{mine >> sh, other >> sh};
}

__device__ __forceinline__ bool row_kept(const RowBits& rb, int nb, int e) {
  return ((e < 2 ? rb.r0 : rb.r1) & (1u << (4 * nb + (e & 1)))) != 0u;
}

// The key-major pass: lane (g, t) of warp w holds key rows 16 w + g, + 8 and
// queries 8 nb + 2 t, + 1 of the tile. Its C element (nb, e) is bit
// 8 w + 4 (e / 2) + g % 4 of staged word 32 (nb / 2) + 8 t + 4 (e & 1) +
// 2 (g / 4) + nb % 2: eight 8-byte loads, each word shifted once, so that
// column_kept reads bit 4 (e / 2).
__device__ __forceinline__ void column_bits(uint32_t (&wd)[8][2], const uint32_t* bs, int warp,
                                            int lane) {
  const int g = lane >> 2, t = lane & 3, sh = 8 * warp + (g & 3);
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int e1 = 0; e1 < 2; ++e1) {
      const uint2 v = *reinterpret_cast<const uint2*>(bs + 32 * m + 8 * t + 4 * e1 + 2 * (g >> 2));
      wd[2 * m][e1] = v.x >> sh;
      wd[2 * m + 1][e1] = v.y >> sh;
    }
}

__device__ __forceinline__ bool column_kept(const uint32_t (&wd)[8][2], int nb, int e) {
  return (wd[nb][e & 1] & (1u << (4 * (e >> 1)))) != 0u;
}

}  // namespace dtc
}  // namespace vq
