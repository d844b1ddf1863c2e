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
// Design (simple first; speed is later work): three kernels per block, each
// thread owning one voxel and a group of COB output channels, fp32
// accumulators in registers (the K3 pattern, csrc/preact_stack.cu):
//   pre:  x -> a2          (a1 recomputed per channel group)
//   conv: a2, cond -> a3   (18 taps read from device memory through L1/L2;
//                           the zero pads are index arithmetic, no padded copy)
//   post: a3, x -> y
// Weights are packed by the wrapper as [group][...][COB] so that a warp reads
// each weight once, as a broadcast. The TPU kernel's depth-chunk windows,
// DMA semaphores and VMEM residency have no counterpart here.
#include "causal_union.cuh"

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
