// Shared device code of kernel K4's bf16 tensor-core route: the forward
// (causal_stack.cu tc_fwd_pre, tc_fwd_brick) and the backward
// (causal_stack_bwd.cu tc_pre, tc_mid, tc_dgrad) stage the same bricks with
// the same causal halos, make a2 by the same pre_tile and sum the union conv
// by the same union_t3, so the backward's recompute is the forward's
// arithmetic. Bricks of kVox = 128 voxels (bs0 x bs1 x bs2,
// ops/causal_kernel.py bwd_plan), 8 warps a CTA, warp w owning brick rows
// 16 w .. 16 w + 15; every product on mma.sync m16n8k16 (bf16 in, fp32
// accumulate) with the [N][K] packs of ops/causal_kernel.py
// pack_bwd_tc_weights.
#pragma once

#include "brick_conv.cuh"
#include "causal_union.cuh"

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kWarps = 8, kThr = 256, kVox = 128;
constexpr int CBP = 16, BS = CBP + 8;  // Cb padded to the mma's k; a 16-channel row's stride

struct UBrick {
  int64_t b;
  int i0, i1, i2, n0, n1, n2;
  __device__ int h1() const { return n1 + 2; }
  __device__ int h2() const { return n2 + 2; }
  __device__ int rows() const { return (n0 + 1) * (n1 + 2) * (n2 + 2); }
};

__device__ __forceinline__ UBrick ubrick(int64_t idx, int s0, int s1, int s2, int n0, int n1,
                                         int n2) {
  const vqb::Brick k = vqb::brick_of(idx, s0, s1, s2, n0, n1, n2);
  return UBrick{k.b, k.h0, k.w0, k.d0, n0, n1, n2};
}

// The voxel of brick row r, or -1 outside the grid.
__device__ __forceinline__ int64_t row_voxel(const UBrick& k, int r, int s0, int s1, int s2) {
  const int a = k.i0 + r / (k.n1 * k.n2), b = k.i1 + r / k.n2 % k.n1, c = k.i2 + r % k.n2;
  if (a >= s0 || b >= s1 || c >= s2) return -1;
  return ((k.b * s0 + a) * s1 + b) * static_cast<int64_t>(s2) + c;
}

// The voxel of halo row r (origin s0 offset o0: -1 forward, 0 transposed), or -1.
__device__ __forceinline__ int64_t halo_voxel(const UBrick& k, int r, int o0, int s0, int s1,
                                              int s2) {
  const int a = k.i0 + o0 + r / (k.h1() * k.h2()), b = k.i1 - 1 + r / k.h2() % k.h1(),
            c = k.i2 - 1 + r % k.h2();
  if (a < 0 || a >= s0 || b < 0 || b >= s1 || c < 0 || c >= s2) return -1;
  return ((k.b * s0 + a) * s1 + b) * static_cast<int64_t>(s2) + c;
}

__device__ __forceinline__ int halo_base(const UBrick& k, int r) {
  return ((r / (k.n1 * k.n2)) * k.h1() + r / k.n2 % k.n1) * k.h2() + r % k.n2;
}

// the halo offset of tap (j0, j1, j2) = (tap / 9, tap / 3 % 3, tap % 3): the
// forward conv reads row r + (j0, j1, j2) - 1, the transposed r - (j0, j1, j2) + 1
__device__ __forceinline__ int fwd_off(const UBrick& k, int tap) {
  return ((tap / 9) * k.h1() + tap / 3 % 3) * k.h2() + tap % 3;
}
__device__ __forceinline__ int bwd_off(const UBrick& k, int tap) {
  return ((1 - tap / 9) * k.h1() + 2 - tap / 3 % 3) * k.h2() + 2 - tap % 3;
}

// Rows [0, nrows) of a channels-last (nvox, width) bf16 tensor into shared
// rows of `stride` bf16: row r takes voxel vox(r) (zero for -1), channels
// zero past `width` up to `padded`; then also(r, c0, v, row) for each 8
// channels c0 .. c0 + 7 staged (a transform written beside them in the same
// pass). All threads.
struct NoAlso {
  __device__ void operator()(int, int, int64_t, uint4) const {}
};

template <typename F, typename A = NoAlso>
__device__ __forceinline__ void stage(bf16* dst, int stride, const bf16* src, int width,
                                      int padded, int nrows, F vox, A also = A()) {
  const bool vec = width % 8 == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  const int groups = padded / 8;
  for (int e = threadIdx.x; e < nrows * groups; e += kThr) {
    const int r = e / groups, c0 = 8 * (e % groups);
    const int64_t v = vox(r);
    const uint4 row = vqb::load8(src, v, width, c0, vec);
    *reinterpret_cast<uint4*>(dst + r * stride + c0) = row;
    also(r, c0, v, row);
  }
}

// 8 staged bf16 through f (channels past `width` and rows outside the grid give 0)
template <typename F>
__device__ __forceinline__ uint4 map8(uint4 row, int c0, int width, bool inside, F f) {
  const bf16* in = reinterpret_cast<const bf16*>(&row);
  uint32_t o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float lo = inside && c0 + 2 * j < width ? f(vq::to_f<bf16>(in[2 * j])) : 0.f;
    const float hi = inside && c0 + 2 * j + 1 < width ? f(vq::to_f<bf16>(in[2 * j + 1])) : 0.f;
    o[j] = vq::pack_bf16(lo, hi);
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

__device__ __forceinline__ float elu_grad(float t) { return t > 0.f ? 1.f : expf(t); }

struct Sc {
  float b1a, b1b, b2a, b2b, b3a, b3b, b4, scale;
  __device__ explicit Sc(const float* sc)
      : b1a(vq::rnd<bf16>(sc[0])), b1b(vq::rnd<bf16>(sc[1])), b2a(vq::rnd<bf16>(sc[2])),
        b2b(vq::rnd<bf16>(sc[3])), b3a(vq::rnd<bf16>(sc[4])), b3b(vq::rnd<bf16>(sc[5])),
        b4(vq::rnd<bf16>(sc[6])), scale(vq::rnd<bf16>(sc[7])) {}
  __device__ __forceinline__ float a1(float x) const {
    return vq::rnd<bf16>(vq::rnd<bf16>(vq::elu(vq::rnd<bf16>(x + b1a))) + b1b);
  }
};

// the A fragment of rows m0 .. m0 + 15 (row-major voxels x channels) at k0
__device__ __forceinline__ void lda(uint32_t (&a)[4], const bf16* s, int stride, int m0, int k0,
                                    int lane) {
  vq::ldsm_x4(a, vq::smem_u32(s + (m0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * stride + k0 +
                              8 * (lane >> 4)));
}

// x -> a2 (bf16 [nvox][16], Cb zero-padded) for voxels v0 .. v0 + 127: x
// staged with a1 made in the staging pass (a1s: [kVox][CUP + 8] in shared
// memory), W1e on the tensor cores, M over the voxels (warp w: 16 w ..
// 16 w + 15). The body of tc_pre (causal_stack_bwd.cu) and tc_fwd_pre
// (causal_stack.cu): the forward's a2 is the backward's, bit for bit.
template <int CUP>
__device__ __forceinline__ void pre_tile(bf16* a1s, const bf16* __restrict__ x,
                                         const bf16* __restrict__ w1e,
                                         const bf16* __restrict__ be,
                                         const float* __restrict__ sc, bf16* __restrict__ a2,
                                         int64_t nvox, int cu, int cb) {
  constexpr int XS = CUP + 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const Sc s(sc);
  const int64_t v0 = static_cast<int64_t>(blockIdx.x) * kVox;
  const auto a1 = [&](float v) { return s.a1(v); };
  stage(a1s, XS, x, cu, CUP, kVox, [&](int r) { return v0 + r < nvox ? v0 + r : int64_t{-1}; },
        [&](int r, int c0, int64_t v, uint4 row) {  // a1 over x, in place; zero past Cu
          *reinterpret_cast<uint4*>(a1s + r * XS + c0) = map8(row, c0, cu, v >= 0, a1);
        });
  __syncthreads();
  float acc[2][4] = {};
#pragma unroll
  for (int k0 = 0; k0 < CUP; k0 += 16) {
    uint32_t a[4];
    lda(a, a1s, XS, 16 * warp, k0, lane);
    vqb::mma_row<2>(acc, a, w1e, CUP, k0, lane);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int64_t v = v0 + 16 * warp + g + 8 * half;
    if (v >= nvox) continue;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      float o[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = nt * 8 + 2 * t + e;
        const float u = n < cb ? vq::rnd<bf16>(vq::rnd<bf16>(vq::rnd<bf16>(acc[nt][2 * half + e]) +
                                                             vq::to_f<bf16>(be[n])) + s.b2a)
                               : 0.f;
        o[e] = n < cb ? vq::rnd<bf16>(vq::rnd<bf16>(vq::elu(u)) + s.b2b) : 0.f;
      }
      *reinterpret_cast<uint32_t*>(a2 + v * CBP + nt * 8 + 2 * t) = vq::pack_bf16(o[0], o[1]);
    }
  }
}

// t3 of brick rows m0 .. m0 + 15 (warp fragments, Cb padded to 16): the union
// conv over the 18 taps as an implicit GEMM on the a2 halo (one s0-row
// behind, fwd_off), the keep mask / (1 - p), the condition's product (cs:
// [kVox][CCP + 8]) and bc, all in fp32 until `+ b3a`. K4's forward
// (tc_fwd_brick) and its backward's recompute (tc_mid) both take this tile,
// so they sum the conv in one order.
template <int CCP>
__device__ __forceinline__ void union_t3(float (&t3)[2][4], const bf16* halo, const bf16* cs,
                                         const UBrick& k, int m0, const bf16* __restrict__ wuf,
                                         const bf16* __restrict__ wct,
                                         const bf16* __restrict__ bc,
                                         const float* __restrict__ keep, float denom,
                                         bool has_cond, int cb, float b3a, int lane) {
  constexpr int CS = CCP + 8;
  const int t = lane & 3;
  float acc[2][4] = {}, cacc[2][4] = {};
  {
    const int r = m0 + (lane & 7) + 8 * ((lane >> 3) & 1);
    const uint32_t a0 = vq::smem_u32(halo + halo_base(k, r) * BS + 8 * (lane >> 4));
#pragma unroll
    for (int tap = 0; tap < vqc::kTaps; ++tap) {
      uint32_t a[4];
      vq::ldsm_x4(a, a0 + 2 * fwd_off(k, tap) * BS);
      vqb::mma_row<2>(acc, a, wuf + tap * CBP * CBP, CBP, 0, lane);
    }
  }
  if (has_cond) {
#pragma unroll
    for (int k0 = 0; k0 < CCP; k0 += 16) {
      uint32_t a[4];
      lda(a, cs, CS, m0, k0, lane);
      vqb::mma_row<2>(cacc, a, wct, CCP, k0, lane);
    }
  }
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = nt * 8 + 2 * t + (e & 1);
      float cv = acc[nt][e];
      if (keep != nullptr && n < cb) cv = keep[k.b * cb + n] > 0.f ? cv / denom : 0.f;
      if (has_cond && n < cb) cv = (cv + cacc[nt][e]) + vq::to_f<bf16>(bc[n]);
      t3[nt][e] = vq::rnd<bf16>(vq::rnd<bf16>(cv) + b3a);
    }
}

}  // namespace tc
