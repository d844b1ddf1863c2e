// The tensor-core tiles of the flash-attention backward passes (K8's
// bwd_dkdv_tc / bwd_dq_tc in csrc/flash_attention_bwd.cu, K5's drop_dq_tc /
// drop_dkdv_tc in csrc/flash_dropout_attention_bwd.cu): a CTA of 4 warps owns
// 64 rows, 16 a warp, held as A fragments; the other operand's tiles of 64
// rows are staged in shared memory at a padded row stride. Fragment maps in
// csrc/mma.cuh.
#pragma once

#include "mma.cuh"

namespace vq {
namespace ftc {

constexpr int TC_WARPS = 4, TC_T = 16 * TC_WARPS;  // 64 rows a CTA, tiles of 64
constexpr float LOG2E = 1.4426950408889634f;
using bf16 = __nv_bfloat16;

template <int D>
__host__ __device__ constexpr int row_stride() {  // shared row stride: ldmatrix without bank conflicts
  return D == 8 ? 8 : D + 8;
}

template <int D>
using AFrag = uint32_t[D == 8 ? 1 : D / 16][4];

__device__ __forceinline__ float ex2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(x));
  return r;
}

// the A fragments of rows r0 .. r0 + 15 of a row-major (S, D) tensor, straight
// from device memory (rows past S read as 0): lane (g, t) holds rows r0 + g and
// r0 + g + 8
template <int D>
__device__ __forceinline__ void load_a(AFrag<D>& a, const bf16* x, int r0, int S, int t) {
  const uint32_t* x32 = reinterpret_cast<const uint32_t*>(x);
  auto ld = [&](int row, int col) -> uint32_t {
    return row < S ? x32[(static_cast<size_t>(row) * D + col) / 2] : 0u;
  };
  if constexpr (D == 8) {
    a[0][0] = ld(r0, 2 * t);
    a[0][1] = ld(r0 + 8, 2 * t);
    a[0][2] = a[0][3] = 0u;
  } else {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      a[kk][0] = ld(r0, 16 * kk + 2 * t);
      a[kk][1] = ld(r0 + 8, 16 * kk + 2 * t);
      a[kk][2] = ld(r0, 16 * kk + 8 + 2 * t);
      a[kk][3] = ld(r0 + 8, 16 * kk + 8 + 2 * t);
    }
  }
}

// rows row0 .. row0 + 63 of a row-major (S, D) tensor into shared memory at
// the row stride, 16 bytes a copy, rows past S zero-filled
template <int D>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, int row0, int S,
                                           int tid) {
  constexpr int DB = D / 8;
#pragma unroll
  for (int e = tid; e < TC_T * DB; e += 32 * TC_WARPS) {
    const int row = e / DB, c = e % DB, j = row0 + row;
    vq::cp_async16(vq::smem_u32(dst + row * row_stride<D>() + 8 * c),
                   src + static_cast<size_t>(j < S ? j : S - 1) * D + 8 * c, j < S ? 16 : 0);
  }
}

// c (16 x 64) = a (16 x D) . x^T, x the 64 rows x D in shared memory: x's B
// fragments by plain ldmatrix (matrix m = nb DB + db holds rows 8 nb .. 8 nb + 7
// at d 8 db .. 8 db + 7); lane (g, t) gets rows (g, g + 8) x columns
// 8 nb + 2 t, +1
template <int D>
__device__ __forceinline__ void mma_abt(float (&c)[8][4], const AFrag<D>& a, const bf16* xs,
                                        int lane) {
  constexpr int DB = D / 8, RS = row_stride<D>();
  uint32_t xb[8 * DB];
#pragma unroll
  for (int cc = 0; cc < 2 * DB; ++cc) {
    const int m = 4 * cc + (lane >> 3), nb = m / DB, db = m % DB;
    uint32_t r[4];
    vq::ldsm_x4(r, vq::smem_u32(xs + (8 * nb + (lane & 7)) * RS + 8 * db));
#pragma unroll
    for (int i = 0; i < 4; ++i) xb[4 * cc + i] = r[i];
  }
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) {
    c[nb][0] = c[nb][1] = c[nb][2] = c[nb][3] = 0.f;
    if constexpr (D == 8) {
      vq::mma_1688(c[nb], a[0][0], a[0][1], xb[nb]);
    } else {
#pragma unroll
      for (int kk = 0; kk < DB / 2; ++kk)
        vq::mma_16816(c[nb], a[kk], xb[nb * DB + 2 * kk], xb[nb * DB + 2 * kk + 1]);
    }
  }
}

// acc (16 x D) += pa (16 x 64, A fragments: k-step kk = columns 16 kk ..
// 16 kk + 15) . x, x the 64 rows x D in shared memory: x's B fragments by
// ldmatrix.trans (x's rows down the k axis)
template <int D>
__device__ __forceinline__ void mma_px(float (&acc)[D / 8][4], const uint32_t (&pa)[4][4],
                                       const bf16* xs, int lane) {
  constexpr int DB = D / 8, RS = row_stride<D>();
  if constexpr (D == 8) {
#pragma unroll
    for (int kk = 0; kk < 4; kk += 2) {  // lane L addresses row 16 kk + L
      uint32_t r[4];
      vq::ldsm_x4_t(r, vq::smem_u32(xs + (16 * kk + lane) * RS));
      vq::mma_16816(acc[0], pa[kk], r[0], r[1]);
      vq::mma_16816(acc[0], pa[kk + 1], r[2], r[3]);
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int nd = 0; nd < DB; nd += 2) {  // lanes 16-31 address d block nd + 1
        uint32_t r[4];
        vq::ldsm_x4_t(r, vq::smem_u32(xs + (16 * kk + (lane & 15)) * RS +
                                      8 * (nd + (lane >> 4))));
        vq::mma_16816(acc[nd], pa[kk], r[0], r[1]);
        vq::mma_16816(acc[nd + 1], pa[kk], r[2], r[3]);
      }
  }
}

// rows (r0, r0 + 8) of acc (16 x D), rounded to bf16, into a row-major (S, D) tensor
template <int D>
__device__ __forceinline__ void store_rows(bf16* x, const float (&acc)[D / 8][4], int r0,
                                           int S, int t) {
  uint32_t* x32 = reinterpret_cast<uint32_t*>(x);
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    if (r0 < S)
      x32[(static_cast<size_t>(r0) * D + 8 * nd + 2 * t) / 2] = vq::pack_bf16(acc[nd][0], acc[nd][1]);
    if (r0 + 8 < S)
      x32[(static_cast<size_t>(r0 + 8) * D + 8 * nd + 2 * t) / 2] =
          vq::pack_bf16(acc[nd][2], acc[nd][3]);
  }
}

}  // namespace ftc
}  // namespace vq
