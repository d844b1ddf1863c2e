// A brick of output voxels with its one-voxel halo, and the 3x3x3 conv over
// it as an implicit GEMM on the tensor cores: the device pieces of K3's fused
// bf16 forward (preact_stack.cu), which K3's bf16 backward
// (preact_stack_bwd.cu brick_bwd_mid, brick_bwd_dgrad) calls too, so that its
// recomputed a1, t2, a2, t3 and a3 are the forward's bit for bit and its
// transposed conv is the same tile with the taps mirrored.
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

// The voxel of halo row r when it is one of the brick's own voxels inside
// the volume (not a wrapped neighbour), else -1.
__device__ __forceinline__ int64_t own_voxel(const Brick& k, int r, int h, int w, int d) {
  const int hh = r / (k.hd() * k.hw()) - 1, ww = r / k.hd() % k.hw() - 1, dd = r % k.hd() - 1;
  if (hh < 0 || hh >= k.bh || ww < 0 || ww >= k.bw || dd < 0 || dd >= k.bd ||
      k.h0 + hh >= h || k.w0 + ww >= w || k.d0 + dd >= d)
    return -1;
  return ((k.b * h + k.h0 + hh) * w + k.w0 + ww) * static_cast<int64_t>(d) + k.d0 + dd;
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

constexpr int kStage = 24;  // row stride (bf16) of a warp's 16 x 16 staging tile

// A block's 8 scalars as bf16 values and the forward's elementwise steps,
// each rounding its fp32 result to bf16 as the reference math does.
struct Scalars {
  float b1a, b1b, b2a, b2b, b3a, b3b, b4, scale;
  __device__ explicit Scalars(const float* sc)
      : b1a(vq::rnd<bf16>(sc[0])), b1b(vq::rnd<bf16>(sc[1])), b2a(vq::rnd<bf16>(sc[2])),
        b2b(vq::rnd<bf16>(sc[3])), b3a(vq::rnd<bf16>(sc[4])), b3b(vq::rnd<bf16>(sc[5])),
        b4(vq::rnd<bf16>(sc[6])), scale(vq::rnd<bf16>(sc[7])) {}
  // a1 of an x value; t2 and a2 of the 1x1x1 conv's fp32 sum; t3 and a3 of
  // the 3x3x3 conv's
  __device__ __forceinline__ float a1(float xv) const {
    return vq::rnd<bf16>(vq::rnd<bf16>(vq::elu(vq::rnd<bf16>(xv + b1a))) + b1b);
  }
  __device__ __forceinline__ float t2(float acc) const {
    return vq::rnd<bf16>(vq::rnd<bf16>(acc) + b2a);
  }
  __device__ __forceinline__ float a2(float acc) const {
    return vq::rnd<bf16>(vq::rnd<bf16>(vq::elu(t2(acc))) + b2b);
  }
  __device__ __forceinline__ float t3(float acc) const {
    return vq::rnd<bf16>(vq::rnd<bf16>(acc) + b3a);
  }
  __device__ __forceinline__ float a3_of_t3(float t) const {
    return vq::rnd<bf16>(vq::rnd<bf16>(vq::elu(t)) + b3b);
  }
  __device__ __forceinline__ float a3(float acc) const { return a3_of_t3(t3(acc)); }
  // y of the W3 product's fp32 sum and x
  __device__ __forceinline__ bf16 y(float acc, bf16 xv) const {
    return vq::from_f<bf16>(vq::rnd<bf16>(vq::rnd<bf16>(vq::rnd<bf16>(acc) * scale) + b4) +
                            vq::to_f<bf16>(xv));
  }
};

struct NoHook {
  template <typename... A>
  __device__ __forceinline__ void operator()(A&&...) const {}
};

// a2 of the brick's halo rows into `halo` (rows of `as` bf16, zero past Cb
// and where 'zeros' pads), 16 rows a warp at a time: x staged 16 rows x 16
// channels in the warp's tile `stg` (a1 made in registers), W1 [CBP][k1] on
// the tensor cores with M over halo rows. The hooks see what the backward
// keeps: on_a1(row, c0, pk) the packed a1 of channels c0 .. c0 + 7 of halo
// row `row`, on_t2(row, n, acc_lo, acc_hi, a2_pair) the 1x1x1 conv's fp32
// sums of channels n, n + 1 and their packed a2.
template <int NT, typename A1Hook = NoHook, typename T2Hook = NoHook>
__device__ __forceinline__ void halo_pre(bf16* halo, int as, bf16* stg, const Brick& k,
                                         const bf16* __restrict__ x, const bf16* __restrict__ w1,
                                         const Scalars& s, int h, int w, int d, int c, int cb,
                                         int k1, int wrap, int warp, int nwarps, int lane,
                                         A1Hook on_a1 = A1Hook(), T2Hook on_t2 = T2Hook()) {
  const int nh = k.rows(), g = lane >> 2, t = lane & 3;
  const bool vec = c % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  // the ldmatrix.x4 address of an A fragment: row (lane & 7) + 8 ((lane >> 3) & 1),
  // column 8 (lane >> 4)
  const int arow = (lane & 7) + 8 * ((lane >> 3) & 1), acol = 8 * (lane >> 4);
  for (int mt = warp; mt * 16 < nh; mt += nwarps) {
    float acc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
    const int sr = mt * 16 + (lane >> 1);  // the lane's staging row and channel half
    const int64_t sv = sr < nh ? halo_voxel(k, sr, h, w, d, wrap) : -1;
    for (int k0 = 0; k0 < k1; k0 += 16) {
      const int c0 = k0 + 8 * (lane & 1);
      const uint4 raw = load8(x, sv, c, c0, vec);
      const bf16* xv = reinterpret_cast<const bf16*>(&raw);
      uint32_t pk[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float lo = sv >= 0 && c0 + 2 * j < c ? s.a1(vq::to_f<bf16>(xv[2 * j])) : 0.f;
        const float hi = sv >= 0 && c0 + 2 * j + 1 < c ? s.a1(vq::to_f<bf16>(xv[2 * j + 1])) : 0.f;
        pk[j] = vq::pack_bf16(lo, hi);
      }
      if (sr < nh) on_a1(sr, c0, pk);
      *reinterpret_cast<uint4*>(stg + (lane >> 1) * kStage + 8 * (lane & 1)) =
          make_uint4(pk[0], pk[1], pk[2], pk[3]);
      __syncwarp();
      uint32_t a[4];
      vq::ldsm_x4(a, vq::smem_u32(stg + arow * kStage + acol));
      mma_row<NT>(acc, a, w1, k1, k0, lane);
      __syncwarp();
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = mt * 16 + g + 8 * half;
      if (r >= nh) continue;
      const bool inside = halo_voxel(k, r, h, w, d, wrap) >= 0;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = nt * 8 + 2 * t;
        const float lo = inside && n < cb ? s.a2(acc[nt][2 * half]) : 0.f;
        const float hi = inside && n + 1 < cb ? s.a2(acc[nt][2 * half + 1]) : 0.f;
        const uint32_t pair = vq::pack_bf16(lo, hi);
        *reinterpret_cast<uint32_t*>(halo + r * as + n) = pair;
        on_t2(r, n, acc[nt][2 * half], acc[nt][2 * half + 1], pair);
      }
    }
  }
}

// Channels n, n + 1 (n even) of voxel v of a channels-last (nvox, cc) bf16
// tensor from a packed pair: one 32-bit store when cc is even, else the
// channels below cc one by one.
__device__ __forceinline__ void store2(bf16* dst, int64_t v, int cc, int n, uint32_t pair) {
  if (n >= cc) return;
  bf16* p = dst + v * cc + n;
  if (cc % 2 == 0) {
    *reinterpret_cast<uint32_t*>(p) = pair;
    return;
  }
  p[0] = __ushort_as_bfloat16(static_cast<unsigned short>(pair & 0xffffu));
  if (n + 1 < cc) p[1] = __ushort_as_bfloat16(static_cast<unsigned short>(pair >> 16));
}

// Channels c0 .. c0 + 7 of voxel v of a channels-last (nvox, cc) bf16 tensor
// from 16 packed bytes: one store when vec (cc a multiple of 8, the tensor
// 16-byte aligned), else the channels below cc one by one.
__device__ __forceinline__ void store8(bf16* dst, int64_t v, int cc, int c0, const uint32_t (&pk)[4],
                                       bool vec) {
  if (c0 >= cc) return;
  bf16* p = dst + v * cc + c0;
  if (vec) {
    *reinterpret_cast<uint4*>(p) = make_uint4(pk[0], pk[1], pk[2], pk[3]);
    return;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (c0 + j < cc)
      p[j] = __ushort_as_bfloat16(static_cast<unsigned short>(pk[j / 2] >> (16 * (j % 2))));
}

// The lo (e = 0) or hi (e = 1) value of a packed bf16 pair.
__device__ __forceinline__ float unpack(uint32_t pair, int e) {
  return __uint_as_float(e ? pair & 0xffff0000u : pair << 16);
}

}  // namespace vqb
