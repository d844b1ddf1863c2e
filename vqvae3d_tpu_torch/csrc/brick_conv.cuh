// A brick of output voxels with its one-voxel halo, and the 3x3x3 conv over
// it as an implicit GEMM on the tensor cores: the device pieces of K3's fused
// bf16 forward (preact_stack.cu), written so that K3's backward can take the
// same brick and conv tile for its recomputed conv and its transpose.
//
// Activations are channels-last (B, H, W, D, C); voxel v = ((b * H + ih) * W
// + iw) * D + id. A brick is bh x bw x bd output voxels at (h0, w0, d0) of
// batch b; its halo is the (bh + 2) x (bw + 2) x (bd + 2) voxels around it,
// halo row ((hh * (bw + 2)) + ww) * (bd + 2) + dd at voxel (h0 + hh - 1,
// w0 + ww - 1, d0 + dd - 1). A halo voxel outside the volume wraps one step
// ('wrap', the conv's circular pad) or reads as zero ('zeros' pads the conv's
// input, a2, not x); a brick voxel outside the volume is computed and not
// stored, so only such voxels read further out.
//
// The conv tile: a warp's 16 output voxels (brick rows m0 .. m0 + 15, row r
// at (r / (bw bd), r / bd % bw, r % bd)) times all N = 8 NT output channels,
//   acc[n] += sum over the 27 taps and the CBP input channels of
//             halo[row(r, tap)][k] * w[tap][n][k]
// with tap = (kh * 3 + kw) * 3 + kd reading halo row row(r, 0) + (kh (bw + 2)
// + kw) (bd + 2) + kd. A: ldmatrix.x4 with each lane addressing its own
// voxel's halo row (the implicit GEMM's gather); B: the weights [27][N][CBP]
// (k contiguous, zero-padded), two 32-bit loads a fragment; fp32 accumulate.
#pragma once

#include "common.cuh"
#include "mma.cuh"

namespace vqb {

using bf16 = __nv_bfloat16;

struct Brick {
  int64_t b;
  int h0, w0, d0;
  int bh, bw, bd;
  __device__ __forceinline__ int hw() const { return bw + 2; }
  __device__ __forceinline__ int hd() const { return bd + 2; }
  __device__ __forceinline__ int rows() const { return (bh + 2) * (bw + 2) * (bd + 2); }
};

// Brick `idx` of a volume cut into bricks of bh x bw x bd, d fastest.
__device__ __forceinline__ Brick brick_of(int64_t idx, int h, int w, int d, int bh, int bw,
                                          int bd) {
  Brick k;
  const int nbh = (h + bh - 1) / bh, nbw = (w + bw - 1) / bw, nbd = (d + bd - 1) / bd;
  k.d0 = static_cast<int>(idx % nbd) * bd;
  idx /= nbd;
  k.w0 = static_cast<int>(idx % nbw) * bw;
  idx /= nbw;
  k.h0 = static_cast<int>(idx % nbh) * bh;
  k.b = idx / nbh;
  k.bh = bh;
  k.bw = bw;
  k.bd = bd;
  return k;
}

// Coordinate c of an axis of extent n as the halo sees it: c inside, one
// step outside wrapped for 'wrap', else -1 (zero).
__device__ __forceinline__ int halo_axis(int c, int n, int wrap) {
  if (c >= 0 && c < n) return c;
  if (wrap && c == -1) return n - 1;
  if (wrap && c == n) return 0;
  return -1;
}

// The voxel of halo row r, or -1 where the halo reads zero.
__device__ __forceinline__ int64_t halo_voxel(const Brick& k, int r, int h, int w, int d,
                                              int wrap) {
  const int hh = halo_axis(k.h0 + r / (k.hd() * k.hw()) - 1, h, wrap);
  const int ww = halo_axis(k.w0 + r / k.hd() % k.hw() - 1, w, wrap);
  const int dd = halo_axis(k.d0 + r % k.hd() - 1, d, wrap);
  if (hh < 0 || ww < 0 || dd < 0) return -1;
  return ((k.b * h + hh) * w + ww) * static_cast<int64_t>(d) + dd;
}

// The voxel of brick row r (an output voxel), or -1 outside the volume.
__device__ __forceinline__ int64_t brick_voxel(const Brick& k, int r, int h, int w, int d) {
  const int hh = k.h0 + r / (k.bw * k.bd), ww = k.w0 + r / k.bd % k.bw, dd = k.d0 + r % k.bd;
  if (hh >= h || ww >= w || dd >= d) return -1;
  return ((k.b * h + hh) * w + ww) * static_cast<int64_t>(d) + dd;
}

// The halo row that brick row r reads at tap (0, 0, 0).
__device__ __forceinline__ int halo_base(const Brick& k, int r) {
  return ((r / (k.bw * k.bd)) * k.hw() + r / k.bd % k.bw) * k.hd() + r % k.bd;
}

// Channels c .. c + 7 of voxel v of a channels-last (nvox, cc) bf16 tensor as
// 16 bytes; channels past cc and v < 0 read as 0. vec: cc is a multiple of 8
// and the tensor 16-byte aligned, so the row is one load.
__device__ __forceinline__ uint4 load8(const bf16* src, int64_t v, int cc, int c, bool vec) {
  if (v < 0 || c >= cc) return make_uint4(0u, 0u, 0u, 0u);
  const bf16* p = src + v * cc + c;
  if (vec) return *reinterpret_cast<const uint4*>(p);
  uint32_t r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t lo = c + 2 * i < cc ? __bfloat16_as_ushort(p[2 * i]) : 0u;
    const uint32_t hi = c + 2 * i + 1 < cc ? __bfloat16_as_ushort(p[2 * i + 1]) : 0u;
    r[i] = lo | (hi << 16);
  }
  return make_uint4(r[0], r[1], r[2], r[3]);
}

__device__ __forceinline__ uint32_t ldg32(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

// acc[n] += A (16 x 16 at `a`, its ldmatrix fragments) . w[n rows][k0 .. k0 + 15]
// for the NT n-blocks of 8 output channels; w is [N][ks] (k contiguous).
template <int NT>
__device__ __forceinline__ void mma_row(float (&acc)[NT][4], const uint32_t (&a)[4],
                                        const bf16* __restrict__ w, int ks, int k0, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const bf16* p = w + static_cast<int64_t>(nt * 8 + g) * ks + k0 + 2 * t;
    vq::mma_16816(acc[nt], a, ldg32(p), ldg32(p + 8));
  }
}

// The conv tile (the header comment): halo is the brick's a2 in shared
// memory, rows of `as` bf16 (CBP channels, zero past Cb); w the weights
// [27][8 NT][CBP]; m0 the warp's first brick row.
template <int NT, int CBP>
__device__ __forceinline__ void conv_tile(float (&acc)[NT][4], const bf16* halo, int as,
                                          const Brick& k, int m0, const bf16* __restrict__ w,
                                          int lane) {
  const int r = m0 + (lane & 7) + 8 * ((lane >> 3) & 1);
  const int base = halo_base(k, r), hw = k.hw(), hd = k.hd();
  const uint32_t a0 = vq::smem_u32(halo + base * as + 8 * (lane >> 4));
#pragma unroll 1
  for (int kh = 0; kh < 3; ++kh)
#pragma unroll
    for (int kw = 0; kw < 3; ++kw)
#pragma unroll
      for (int kd = 0; kd < 3; ++kd) {
        const int tap = (kh * 3 + kw) * 3 + kd;
        const int off = (kh * hw + kw) * hd + kd;
#pragma unroll
        for (int k0 = 0; k0 < CBP; k0 += 16) {
          uint32_t a[4];
          vq::ldsm_x4(a, a0 + 2 * (off * as + k0));
          mma_row<NT>(acc, a, w + static_cast<int64_t>(tap) * NT * 8 * CBP, CBP, k0, lane);
        }
      }
}

}  // namespace vqb
