// Kernel K3: one 'same' PreActFixup block of a stack, serving forward.
//
// Replaces vqvae3d_tpu/ops/stack_kernel.py:preact_stack_fused (its no-save
// forward kernels) and, per block, the forward math of
// vqvae3d_tpu/ops/fused_block.py:preact_block_fused. For each block of an
// n-block stack, on channels-last (B, H, W, D, C) activations:
//
//   a1 = elu(x + b1a) + b1b
//   a2 = elu(conv1(a1) + b2a) + b2b          conv1: 1x1x1, C -> Cb
//   a3 = elu(conv3(a2) + b3a) + b3b          conv3: 3x3x3, Cb -> Cb, 'wrap' | 'zeros'
//   y  = conv1'(a3) * scale + b4 + x         conv1': 1x1x1, Cb -> C
//
// (vqvae3d_tpu/models/blocks.py:preact_fixup_same_ndhwc), with Cb = max(C/2, 1).
// 'zeros' pads a2, the conv's input, not x: a tap outside the volume adds
// nothing. 'wrap' is circular on all three axes, corners included.
//
// Rounding follows the reference math in the activation type T: every
// elementwise op rounds its fp32 result to T, every conv accumulates in fp32
// and rounds its output to T, weights and scalars are read as T. For
// T = float that is plain fp32 math.
//
// What bounds it on the H100: at the path's shapes the 3x3x3 conv is
// 27 * Cb^2 multiply-adds per voxel (Cb = 1..128) over 128 to 33.5 M voxels.
// The full-resolution C = 4 stack (33.5 M voxels, ~1.2 GB moved per block)
// should be bound by device memory; the wide stacks (C = 18 at 128x128x32,
// C = 72 at 32x32x8) by the CUDA cores' fp32 FMA rate and L1 traffic for the
// neighbours' a2 values; the coarse grids (down to 128 voxels) by latency,
// as they give too few threads to fill 132 SMs. This first version sits far
// from all three bounds (PERF.md, "Port on H100").
//
// Design (simple first; speed is later work): three kernels per block, each
// thread owning one voxel and a group of COB output channels, fp32
// accumulators in registers:
//   pre:  x -> a2    (pointwise; a1 is recomputed per channel group)
//   conv: a2 -> a3   (27 taps read straight from device memory through L1/L2,
//                     halo handled by index arithmetic, so no padded copy)
//   post: a3, x -> y
// Weights are packed by the wrapper as [group][...][COB] so that a warp (32
// voxels, one group) reads each weight once, as a broadcast. The a2 and a3
// scratch buffers hold Cb channels each; y ping-pongs between two buffers
// across the blocks of a stack, owned by the wrapper. All voxel offsets are
// 64-bit (the full-resolution stack has 134 M elements).
#include "common.cuh"

namespace {

constexpr int kThreads = 128;

template <typename T, int COB>
__global__ void pre_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                           const float* __restrict__ sc, T* __restrict__ a2,
                           int64_t nvox, int c, int cb) {
  const int64_t v = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (v >= nvox) return;
  const int g = blockIdx.y;
  const T* xv = x + v * c;
  const T* wg = w1 + static_cast<int64_t>(g) * c * COB;  // [G][C][COB]
  const float b1a = vq::rnd<T>(sc[0]), b1b = vq::rnd<T>(sc[1]);
  const float b2a = vq::rnd<T>(sc[2]), b2b = vq::rnd<T>(sc[3]);
  float acc[COB];
#pragma unroll
  for (int j = 0; j < COB; ++j) acc[j] = 0.f;
  for (int ci = 0; ci < c; ++ci) {
    const float t = vq::rnd<T>(vq::to_f<T>(xv[ci]) + b1a);
    const float a1 = vq::rnd<T>(vq::rnd<T>(vq::elu(t)) + b1b);
#pragma unroll
    for (int j = 0; j < COB; ++j) acc[j] = fmaf(a1, vq::to_f<T>(wg[ci * COB + j]), acc[j]);
  }
#pragma unroll
  for (int j = 0; j < COB; ++j) {
    const int k = g * COB + j;
    if (k < cb) {
      const float u = vq::rnd<T>(vq::rnd<T>(acc[j]) + b2a);
      a2[v * cb + k] = vq::from_f<T>(vq::rnd<T>(vq::elu(u)) + b2b);
    }
  }
}

template <typename T, int COB>
__global__ void conv_kernel(const T* __restrict__ a2, const T* __restrict__ w2,
                            const float* __restrict__ sc, T* __restrict__ a3,
                            int64_t nvox, int h, int w, int d, int cb, int wrap) {
  const int64_t v = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (v >= nvox) return;
  const int g = blockIdx.y;
  const int id = static_cast<int>(v % d);
  int64_t t = v / d;
  const int iw = static_cast<int>(t % w);
  t /= w;
  const int ih = static_cast<int>(t % h);
  const int64_t b = t / h;
  const T* wg = w2 + static_cast<int64_t>(g) * 27 * cb * COB;  // [G][27][Cb][COB]
  float acc[COB];
#pragma unroll
  for (int j = 0; j < COB; ++j) acc[j] = 0.f;
  for (int kh = 0; kh < 3; ++kh) {
    int hh = ih + kh - 1;
    if (hh < 0 || hh >= h) {
      if (!wrap) continue;
      hh = (hh + h) % h;
    }
    for (int kw = 0; kw < 3; ++kw) {
      int ww = iw + kw - 1;
      if (ww < 0 || ww >= w) {
        if (!wrap) continue;
        ww = (ww + w) % w;
      }
      for (int kd = 0; kd < 3; ++kd) {
        int dd = id + kd - 1;
        if (dd < 0 || dd >= d) {
          if (!wrap) continue;
          dd = (dd + d) % d;
        }
        const T* src = a2 + (((b * h + hh) * w + ww) * static_cast<int64_t>(d) + dd) * cb;
        const T* wt = wg + ((kh * 3 + kw) * 3 + kd) * cb * COB;
        for (int ci = 0; ci < cb; ++ci) {
          const float a = vq::to_f<T>(src[ci]);
#pragma unroll
          for (int j = 0; j < COB; ++j) acc[j] = fmaf(a, vq::to_f<T>(wt[ci * COB + j]), acc[j]);
        }
      }
    }
  }
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
__global__ void post_kernel(const T* __restrict__ x, const T* __restrict__ a3,
                            const T* __restrict__ w3, const float* __restrict__ sc,
                            T* __restrict__ y, int64_t nvox, int c, int cb) {
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
    if (co < c) {
      const float u = vq::rnd<T>(vq::rnd<T>(vq::rnd<T>(acc[j]) * scale) + b4);
      y[v * c + co] = vq::from_f<T>(u + vq::to_f<T>(x[v * c + co]));
    }
  }
}

inline dim3 grid_for(int64_t nvox, int groups) {
  return dim3(static_cast<unsigned>((nvox + kThreads - 1) / kThreads),
              static_cast<unsigned>(groups));
}

inline int groups_of(int n, int cob) { return (n + cob - 1) / cob; }

#define VQ_COB_DISPATCH(cob, KERNEL, T, ...)                        \
  switch (cob) {                                                   \
    case 1: KERNEL<T, 1>__VA_ARGS__; break;                        \
    case 2: KERNEL<T, 2>__VA_ARGS__; break;                        \
    case 4: KERNEL<T, 4>__VA_ARGS__; break;                        \
    case 8: KERNEL<T, 8>__VA_ARGS__; break;                        \
    default: return cudaErrorInvalidValue;                         \
  }

template <typename T>
cudaError_t block_fwd(const T* x, const T* w1, const T* w2, const T* w3,
                      const float* sc, T* a2, T* a3, T* y, int64_t batch, int h,
                      int w, int d, int c, int cb, int cob_b, int cob_c, int wrap,
                      cudaStream_t s) {
  const int64_t nvox = batch * h * w * static_cast<int64_t>(d);
  if (nvox == 0) return cudaSuccess;
  const dim3 gb = grid_for(nvox, groups_of(cb, cob_b));
  VQ_COB_DISPATCH(cob_b, pre_kernel, T,
                  <<<gb, kThreads, 0, s>>>(x, w1, sc, a2, nvox, c, cb))
  VQ_COB_DISPATCH(cob_b, conv_kernel, T,
                  <<<gb, kThreads, 0, s>>>(a2, w2, sc, a3, nvox, h, w, d, cb, wrap))
  const dim3 gc = grid_for(nvox, groups_of(c, cob_c));
  VQ_COB_DISPATCH(cob_c, post_kernel, T,
                  <<<gc, kThreads, 0, s>>>(x, a3, w3, sc, y, nvox, c, cb))
  return cudaGetLastError();
}

}  // namespace

// One block of a stack. Activations x, y (B, H, W, D, C) and scratch a2, a3
// (B, H, W, D, Cb) are contiguous, of type bf16 when is_bf16 else fp32, as are
// the packed weights w1 [Gb][C][cob_b], w2 [Gb][27][Cb][cob_b] and
// w3 [Gc][Cb][cob_c] (groups zero-padded; cob_b serves the Cb-wide outputs,
// cob_c the C-wide ones). sc holds the block's 8 fp32 scalars
// (b1a, b1b, b2a, b2b, b3a, b3b, b4, scale). y must not alias x.
extern "C" int vq_preact_block_fwd(int is_bf16, const void* x, const void* w1,
                                   const void* w2, const void* w3, const void* sc,
                                   void* a2, void* a3, void* y, int64_t batch,
                                   int h, int w, int d, int c, int cb, int cob_b,
                                   int cob_c, int wrap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* scf = static_cast<const float*>(sc);
  if (is_bf16) {
    using T = __nv_bfloat16;
    return block_fwd<T>(static_cast<const T*>(x), static_cast<const T*>(w1),
                        static_cast<const T*>(w2), static_cast<const T*>(w3), scf,
                        static_cast<T*>(a2), static_cast<T*>(a3), static_cast<T*>(y),
                        batch, h, w, d, c, cb, cob_b, cob_c, wrap, s);
  }
  return block_fwd<float>(static_cast<const float*>(x), static_cast<const float*>(w1),
                          static_cast<const float*>(w2), static_cast<const float*>(w3),
                          scf, static_cast<float*>(a2), static_cast<float*>(a3),
                          static_cast<float*>(y), batch, h, w, d, c, cb, cob_b, cob_c,
                          wrap, s);
}
