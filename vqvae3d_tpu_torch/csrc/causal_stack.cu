// Kernel K4: one mask-'B' block of PixelCNN's causal segment on the union
// stream, forward.
//
// Replaces vqvae3d_tpu/ops/causal_kernel.py:causal_stack_fused (its forward
// kernels _fwd_kernel / _fwd_kernel_nosave). The three causal streams of a
// PreActFixupCausalResBlock run as one union stream X = [d|h|w] of Cu = 3C
// channels, channels-last (B, s0, s1, s2, Cu), with the block's union weights
// (vqvae3d_tpu_torch/ops/causal_kernel.py:pack_causal_union):
//
//   a1 = elu(x + b1a) + b1b
//   a2 = elu(a1 W1e + be + b2a) + b2b                 W1e: Cu -> Cb (ExpandRF folded in)
//   c  = union_conv(a2) [* keep / (1 - p)] + cond wc + bc    (fp32; causal_union.cuh)
//   a3 = elu(c + b3a) + b3b
//   y  = (a3 W3) * scale + b4 + x                      W3: Cb -> Cu
//
// Rounding follows the reference math in the activation type T: every
// elementwise op rounds its fp32 result to T, every dot accumulates in fp32
// and rounds its output to T, the conv stays fp32 through the dropout and the
// condition and rounds before `+ b3a`; weights are read as T. For T = float
// that is plain fp32 math.
//
// What bounds it on the H100: at the published top prior (Cu = 48, Cb = 12,
// Cc = 16, 128x128x32 voxels) a block reads x and the condition and writes y,
// 224 B a voxel in bf16 (117 MB a block, 35 us at 3.35 TB/s), for ~7.9 kFLOP
// a voxel: device memory bounds it. This first version runs the products on
// the CUDA cores in fp32 and sends a2 and a3 through device memory (12.6 MB
// each in bf16, resident in the 50 MB L2), so it sits well above that bound.
//
// Two routes, chosen by the wrapper from the dtype and the widths before any
// launch (ops/conv3d.py causal_fwd_tensor_core_route): bf16 at Cb <= 16,
// Cu <= 64, Cc <= 32 (the top prior's 12 / 48 / 16) takes the tensor-core
// route at the end of this file; fp32 and other widths the first design.
//
// The first design: three kernels per block, each
// thread owning one voxel and a group of COB output channels, fp32
// accumulators in registers (the K3 pattern, csrc/preact_stack.cu):
//   pre:  x -> a2          (a1 recomputed per channel group)
//   conv: a2, cond -> a3   (18 taps read from device memory through L1/L2;
//                           the zero pads are index arithmetic, no padded copy)
//   post: a3, x -> y
// Weights are packed by the wrapper as [group][...][COB] so that a warp reads
// each weight once, as a broadcast. The TPU kernel's depth-chunk windows,
// DMA semaphores and VMEM residency have no counterpart here.
#include "causal_tc.cuh"

namespace {

constexpr int kThreads = 128;

template <typename T, int COB>
__global__ void fwd_pre(const T* __restrict__ x, const T* __restrict__ w1,
                        const T* __restrict__ be, const float* __restrict__ sc,
                        T* __restrict__ a2, int64_t nvox, int cu, int cb) {
  const int64_t v = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (v >= nvox) return;
  const int g = blockIdx.y;
  const T* xv = x + v * cu;
  const T* wg = w1 + static_cast<int64_t>(g) * cu * COB;  // [G][Cu][COB]
  const float b1a = vq::rnd<T>(sc[0]), b1b = vq::rnd<T>(sc[1]);
  const float b2a = vq::rnd<T>(sc[2]), b2b = vq::rnd<T>(sc[3]);
  float acc[COB];
#pragma unroll
  for (int j = 0; j < COB; ++j) acc[j] = 0.f;
  for (int ci = 0; ci < cu; ++ci) {
    const float t = vq::rnd<T>(vq::to_f<T>(xv[ci]) + b1a);
    const float a1 = vq::rnd<T>(vq::rnd<T>(vq::elu(t)) + b1b);
#pragma unroll
    for (int j = 0; j < COB; ++j) acc[j] = fmaf(a1, vq::to_f<T>(wg[ci * COB + j]), acc[j]);
  }
#pragma unroll
  for (int j = 0; j < COB; ++j) {
    const int k = g * COB + j;
    if (k < cb) {
      const float e = vq::rnd<T>(vq::rnd<T>(acc[j]) + vq::to_f<T>(be[k]));
      const float u = vq::rnd<T>(e + b2a);
      a2[v * cb + k] = vq::from_f<T>(vq::rnd<T>(vq::elu(u)) + b2b);
    }
  }
}

template <typename T, int COB>
__global__ void fwd_conv(const T* __restrict__ a2, const T* __restrict__ wu,
                         const float* __restrict__ keep, float denom, const T* __restrict__ cond,
                         const T* __restrict__ wc, const T* __restrict__ bc,
                         const float* __restrict__ sc, T* __restrict__ a3, int64_t nvox, int s0,
                         int s1, int s2, int cb, int cc) {
  const int64_t v = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (v >= nvox) return;
  const int g = blockIdx.y;
  const vqc::Vox p = vqc::decode(v, s0, s1, s2);
  float acc[COB];
  vqc::union_conv<T, COB>(a2, wu + static_cast<int64_t>(g) * vqc::kTaps * cb * COB, keep,
                          denom, cond,
                          cond == nullptr ? nullptr : wc + static_cast<int64_t>(g) * cc * COB,
                          bc, p, v, g, s0, s1, s2, cb, cc, acc);
  const float b3a = vq::rnd<T>(sc[4]), b3b = vq::rnd<T>(sc[5]);
#pragma unroll
  for (int j = 0; j < COB; ++j) {
    const int k = g * COB + j;
    if (k < cb) {
      const float u = vq::rnd<T>(vq::rnd<T>(acc[j]) + b3a);
      a3[v * cb + k] = vq::from_f<T>(vq::rnd<T>(vq::elu(u)) + b3b);
    }
  }
}

template <typename T, int COB>
__global__ void fwd_post(const T* __restrict__ x, const T* __restrict__ a3,
                         const T* __restrict__ w3, const float* __restrict__ sc,
                         T* __restrict__ y, int64_t nvox, int cu, int cb) {
  const int64_t v = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (v >= nvox) return;
  const int g = blockIdx.y;
  const T* av = a3 + v * cb;
  const T* wg = w3 + static_cast<int64_t>(g) * cb * COB;  // [G][Cb][COB]
  float acc[COB];
#pragma unroll
  for (int j = 0; j < COB; ++j) acc[j] = 0.f;
  for (int k = 0; k < cb; ++k) {
    const float a = vq::to_f<T>(av[k]);
#pragma unroll
    for (int j = 0; j < COB; ++j) acc[j] = fmaf(a, vq::to_f<T>(wg[k * COB + j]), acc[j]);
  }
  const float b4 = vq::rnd<T>(sc[6]), scale = vq::rnd<T>(sc[7]);
#pragma unroll
  for (int j = 0; j < COB; ++j) {
    const int co = g * COB + j;
    if (co < cu) {
      const float u = vq::rnd<T>(vq::rnd<T>(vq::rnd<T>(acc[j]) * scale) + b4);
      y[v * cu + co] = vq::from_f<T>(u + vq::to_f<T>(x[v * cu + co]));
    }
  }
}

inline dim3 grid_for(int64_t nvox, int groups) {
  return dim3(static_cast<unsigned>((nvox + kThreads - 1) / kThreads),
              static_cast<unsigned>(groups));
}

inline int groups_of(int n, int cob) { return (n + cob - 1) / cob; }

template <typename T>
cudaError_t block_fwd(const T* x, const T* cond, const float* keep, float denom, const T* w1,
                      const T* be, const T* wu, const T* w3, const T* wc, const T* bc,
                      const float* sc, T* a2, T* a3, T* y, int64_t batch, int s0, int s1,
                      int s2, int cu, int cb, int cc, int cob_b, int cob_u, cudaStream_t s) {
  const int64_t nvox = batch * s0 * s1 * static_cast<int64_t>(s2);
  if (nvox == 0) return cudaSuccess;
  if ((cond != nullptr) != (wc != nullptr && bc != nullptr && cc > 0))
    return cudaErrorInvalidValue;
  const dim3 gb = grid_for(nvox, groups_of(cb, cob_b));
  VQ_COB_DISPATCH(cob_b, fwd_pre, T, <<<gb, kThreads, 0, s>>>(x, w1, be, sc, a2, nvox, cu, cb))
  VQ_COB_DISPATCH(cob_b, fwd_conv, T,
                  <<<gb, kThreads, 0, s>>>(a2, wu, keep, denom, cond, wc, bc, sc, a3, nvox, s0,
                                           s1, s2, cb, cc))
  const dim3 gu = grid_for(nvox, groups_of(cu, cob_u));
  VQ_COB_DISPATCH(cob_u, fwd_post, T,
                  <<<gu, kThreads, 0, s>>>(x, a3, w3, sc, y, nvox, cu, cb))
  return cudaGetLastError();
}

}  // namespace

// One block of the segment. x, y (B, s0, s1, s2, Cu), cond (B, s0, s1, s2, Cc)
// or null, scratch a2, a3 (B, s0, s1, s2, Cb): contiguous, bf16 when is_bf16
// else fp32, as are the packed weights w1 [Gb][Cu][cob_b], wu [Gb][18][Cb][cob_b],
// w3 [Gu][Cb][cob_u], wc [Gb][Cc][cob_b] (null without a condition) and the
// biases be, bc (Cb). keep (B, Cb) fp32 0/1 or null; denom = 1 - p. sc holds
// the block's 8 fp32 scalars (b1a, b1b, b2a, b2b, b3a, b3b, b4, scale). y must
// not alias x.
extern "C" int vq_causal_block_fwd(int is_bf16, const void* x, const void* cond,
                                   const void* keep, float denom, const void* w1, const void* be,
                                   const void* wu, const void* w3, const void* wc,
                                   const void* bc, const void* sc, void* a2, void* a3, void* y,
                                   int64_t batch, int s0, int s1, int s2, int cu, int cb, int cc,
                                   int cob_b, int cob_u, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* scf = static_cast<const float*>(sc);
  const float* kp = static_cast<const float*>(keep);
  if (is_bf16) {
    using T = __nv_bfloat16;
    return block_fwd<T>(static_cast<const T*>(x), static_cast<const T*>(cond), kp, denom,
                        static_cast<const T*>(w1), static_cast<const T*>(be),
                        static_cast<const T*>(wu), static_cast<const T*>(w3),
                        static_cast<const T*>(wc), static_cast<const T*>(bc), scf,
                        static_cast<T*>(a2), static_cast<T*>(a3), static_cast<T*>(y), batch, s0,
                        s1, s2, cu, cb, cc, cob_b, cob_u, s);
  }
  using F = float;
  return block_fwd<F>(static_cast<const F*>(x), static_cast<const F*>(cond), kp, denom,
                      static_cast<const F*>(w1), static_cast<const F*>(be),
                      static_cast<const F*>(wu), static_cast<const F*>(w3),
                      static_cast<const F*>(wc), static_cast<const F*>(bc), scf,
                      static_cast<F*>(a2), static_cast<F*>(a3), static_cast<F*>(y), batch, s0, s1,
                      s2, cu, cb, cc, cob_b, cob_u, s);
}

// ---- bf16: the tensor-core route (ops/conv3d.py causal_fwd_tensor_core_route)
//
// Two kernels a block, on the device code of the backward's tensor-core
// route (causal_tc.cuh), so that the backward's recompute is this forward's
// arithmetic:
//   tc_fwd_pre:   x -> a2 (bf16, Cb padded to 16) by pre_tile, the body of the
//                 backward's tc_pre
//   tc_fwd_brick: a CTA a brick of 128 voxels (the backward's bricks): a2
//                 with its causal halo (one s0-row behind, +-1 on s1 and s2)
//                 and the condition staged in shared memory; the union conv,
//                 dropout, condition and bc by union_t3 (the backward's conv
//                 tile, fp32 until `+ b3a`), t3, a3 into shared memory, then
//                 y = (a3 W3) * scale + b4 + x with W3 on the tensor cores; a3
//                 never leaves the SM.
namespace tc {

template <int CUP>
__global__ void __launch_bounds__(kThr)
    tc_fwd_pre(const bf16* __restrict__ x, const bf16* __restrict__ w1e,
               const bf16* __restrict__ be, const float* __restrict__ sc, bf16* __restrict__ a2,
               int64_t nvox, int cu, int cb) {
  __shared__ __align__(16) bf16 a1s[kVox * (CUP + 8)];
  pre_tile<CUP>(a1s, x, w1e, be, sc, a2, nvox, cu, cb);
}

template <int CUP, int CCP>
__global__ void __launch_bounds__(kThr)
    tc_fwd_brick(const bf16* __restrict__ x, const bf16* __restrict__ a2,
                 const bf16* __restrict__ cond, const float* __restrict__ keep, float denom,
                 const bf16* __restrict__ wuf, const bf16* __restrict__ wct,
                 const bf16* __restrict__ bc, const bf16* __restrict__ w3t,
                 const float* __restrict__ sc, bf16* __restrict__ y, int s0, int s1, int s2,
                 int cu, int cb, int cc, int n0, int n1, int n2) {
  constexpr int CS = CCP + 8, NU = CUP / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int nh = (n0 + 1) * (n1 + 2) * (n2 + 2);
  bf16* halo = reinterpret_cast<bf16*>(smem);  // [nh][BS] a2
  bf16* cs = halo + nh * BS;                    // [kVox][CS] cond
  bf16* a3s = cs + kVox * CS;                   // [kVox][BS] a3
  const Sc s(sc);
  const bool has_cond = cond != nullptr;
  const UBrick k = ubrick(blockIdx.x, s0, s1, s2, n0, n1, n2);
  stage(halo, BS, a2, CBP, CBP, nh, [&](int r) { return halo_voxel(k, r, -1, s0, s1, s2); });
  if (has_cond)
    stage(cs, CS, cond, cc, CCP, kVox, [&](int r) { return row_voxel(k, r, s0, s1, s2); });
  __syncthreads();

  const int m0 = 16 * warp;
  const int64_t vr[2] = {row_voxel(k, m0 + g, s0, s1, s2), row_voxel(k, m0 + g + 8, s0, s1, s2)};
  float t3[2][4];
  union_t3<CCP>(t3, halo, cs, k, m0, wuf, wct, bc, keep, denom, has_cond, cb, s.b3a, lane);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = m0 + g + 8 * half;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      float a3v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = nt * 8 + 2 * t + e;
        a3v[e] = vr[half] >= 0 && n < cb
                     ? vq::rnd<bf16>(vq::rnd<bf16>(vq::elu(t3[nt][2 * half + e])) + s.b3b)
                     : 0.f;
      }
      *reinterpret_cast<uint32_t*>(a3s + r * BS + nt * 8 + 2 * t) = vq::pack_bf16(a3v[0], a3v[1]);
    }
  }
  __syncwarp();
  // y = (a3 W3) * scale + b4 + x
  float p[NU][4] = {};
  uint32_t a[4];
  lda(a, a3s, BS, m0, 0, lane);
  vqb::mma_row<NU>(p, a, w3t, CBP, 0, lane);
  const bool pair = cu % 2 == 0;  // x and y by bf16 pairs
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (vr[half] < 0) continue;
#pragma unroll
    for (int nt = 0; nt < NU; ++nt) {
      const int c0 = nt * 8 + 2 * t;
      if (c0 >= cu) continue;
      const int64_t o = vr[half] * cu + c0;
      float out[2] = {0.f, 0.f};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (c0 + e >= cu) continue;
        out[e] = vq::rnd<bf16>(vq::rnd<bf16>(vq::rnd<bf16>(p[nt][2 * half + e]) * s.scale) +
                               s.b4) +
                 vq::to_f<bf16>(x[o + e]);
      }
      if (pair) {
        *reinterpret_cast<uint32_t*>(y + o) = vq::pack_bf16(out[0], out[1]);
      } else {
        y[o] = vq::from_f<bf16>(out[0]);
        if (c0 + 1 < cu) y[o + 1] = vq::from_f<bf16>(out[1]);
      }
    }
  }
}

template <int CUP, int CCP>
cudaError_t block_fwd_tc(const bf16* x, const bf16* cond, const float* keep, float denom,
                         const bf16* w1e, const bf16* be, const bf16* wuf, const bf16* w3t,
                         const bf16* wct, const bf16* bc, const float* sc, bf16* a2, bf16* y,
                         int64_t batch, int s0, int s1, int s2, int cu, int cb, int cc, int n0,
                         int n1, int n2, cudaStream_t s) {
  const int64_t nvox = batch * s0 * s1 * static_cast<int64_t>(s2);
  const int64_t nbricks = batch * ((s0 + n0 - 1) / n0) * static_cast<int64_t>((s1 + n1 - 1) / n1) *
                          ((s2 + n2 - 1) / n2);
  if (nbricks > 0x7fffffff) return cudaErrorInvalidValue;
  tc_fwd_pre<CUP><<<static_cast<unsigned>((nvox + kVox - 1) / kVox), kThr, 0, s>>>(
      x, w1e, be, sc, a2, nvox, cu, cb);
  const int nh = (n0 + 1) * (n1 + 2) * (n2 + 2);
  const int smem = 2 * (nh * BS + kVox * (CCP + 8) + kVox * BS);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(tc_fwd_brick<CUP, CCP>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  tc_fwd_brick<CUP, CCP><<<static_cast<unsigned>(nbricks), kThr, smem, s>>>(
      x, a2, cond, keep, denom, wuf, wct, bc, w3t, sc, y, s0, s1, s2, cu, cb, cc, n0, n1, n2);
  return cudaGetLastError();
}

}  // namespace tc

// One block on the tensor-core route (bf16; Cb <= 16, Cu <= 64, Cc <= 32;
// ops/conv3d.py causal_fwd_tensor_core_route). x, y (B, s0, s1, s2, Cu),
// cond (B, s0, s1, s2, Cc) or null, bf16 contiguous; keep (B, Cb) fp32 or
// null, denom = 1 - p; the backward's bf16 packs (ops/causal_kernel.py
// pack_bwd_tc_weights), zero-padded to CUP = Cu, CCP = Cc and Cb rounded up
// to 16: w1e [16][CUP], wuf [18][16][16], w3t [CUP][16], wct [16][CCP]; be,
// bc (Cb); sc the 8 fp32 scalars; a2 scratch of nvox x 16 bf16; (n0, n1, n2)
// the brick, 128 voxels. y must not alias x.
extern "C" int vq_causal_block_fwd_tc(const void* x, const void* cond, const void* keep,
                                      float denom, const void* w1e, const void* be,
                                      const void* wuf, const void* w3t, const void* wct,
                                      const void* bc, const void* sc, void* a2, void* y,
                                      int64_t batch, int s0, int s1, int s2, int cu, int cb,
                                      int cc, int n0, int n1, int n2, void* stream) {
  using tc::bf16;
  const int cup = (cu + 15) / 16 * 16, ccp = cc > 0 ? (cc + 15) / 16 * 16 : 16;
  if (batch <= 0 || s0 <= 0 || s1 <= 0 || s2 <= 0 || cu <= 0 || cb <= 0 || cb > tc::CBP ||
      cup > 64 || ccp > 32 || n0 * n1 * n2 != tc::kVox || (cond == nullptr) != (cc == 0) ||
      (cond != nullptr && (wct == nullptr || bc == nullptr)))
    return cudaErrorInvalidValue;
#define VQ_FWD_TC(CUP, CCP)                                                                      \
  tc::block_fwd_tc<CUP, CCP>(                                                                    \
      static_cast<const bf16*>(x), static_cast<const bf16*>(cond),                               \
      static_cast<const float*>(keep), denom, static_cast<const bf16*>(w1e),                     \
      static_cast<const bf16*>(be), static_cast<const bf16*>(wuf), static_cast<const bf16*>(w3t), \
      static_cast<const bf16*>(wct), static_cast<const bf16*>(bc), static_cast<const float*>(sc), \
      static_cast<bf16*>(a2), static_cast<bf16*>(y), batch, s0, s1, s2, cu, cb, cc, n0, n1, n2,  \
      static_cast<cudaStream_t>(stream))
#define VQ_FWD_TC_C(CUP) (ccp == 16 ? VQ_FWD_TC(CUP, 16) : VQ_FWD_TC(CUP, 32))
  switch (cup) {
    case 16: return VQ_FWD_TC_C(16);
    case 32: return VQ_FWD_TC_C(32);
    case 48: return VQ_FWD_TC_C(48);
    case 64: return VQ_FWD_TC_C(64);
    default: return cudaErrorInvalidValue;
  }
#undef VQ_FWD_TC_C
#undef VQ_FWD_TC
}
