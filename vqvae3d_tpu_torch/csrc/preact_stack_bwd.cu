// Kernel K3 backward: one 'same' PreActFixup block of a stack, reverse sweep.
//
// Replaces the backward of vqvae3d_tpu/ops/stack_kernel.py:preact_stack_fused
// (_bwd_rule, its _bwd_kernel / _bwd_body) and, per block, the math of
// vqvae3d_tpu/ops/fused_block.py:_bwd_kernel. The training forward saves
// every block's input x (preact_stack.cu computes it); for each block, last
// to first, this recomputes the block's forward from x and, from the
// cotangent g of the block output, produces
//   dx (activation type T), dW1 (Cb, C), dW2 (27, Cb_out, Cb_in) and
//   dW3 (C, Cb) as fp32 sums over batch and voxels, and the 8 scalar grads
//   (b1a, b1b, b2a, b2b, b3a, b3b, b4, scale) in fp32.
// The forward (preact_stack.cu):
//   t1 = x + b1a;  a1 = elu(t1) + b1b
//   t2 = W1 a1 + b2a;  a2 = elu(t2) + b2b
//   t3 = conv3(a2) + b3a;  a3 = elu(t3) + b3b     ('wrap' | 'zeros')
//   y = (W3 a3) * scale + b4 + x
// and its reverse, elu'(t) = 1 for t > 0 else exp(t):
//   gu3 = g * scale;  ga3 = W3^T gu3;  gt3 = ga3 * elu'(t3)
//   ga2 = conv3^T(gt3);  gt2 = ga2 * elu'(t2)
//   ga1 = W1^T gt2;  gt1 = ga1 * elu'(t1);  dx = g + gt1
//   dW1 = sum gt2 a1^T, dW3 = sum gu3 a3^T, dW2[tap] = sum gt3 a2[v + tap]^T,
//   d_scale = sum g (W3 a3), d_b4 = sum g, d_b3b = sum ga3, d_b3a = sum gt3, ...
// The recompute rounds exactly as the forward kernel does; every gradient
// value is rounded to T where the PyTorch autograd of the plain block
// rounds it (for T = float, plain fp32 math).
//
// 'wrap' is circular on all three axes and the transposed conv reads the
// neighbour v - tap modulo each axis; 'zeros' skips every (v, v + tap) pair
// with v + tap outside the volume, in the forward recompute, the dW2 taps and
// the transposed conv alike: the index arithmetic is the forward's.
//
// What bounds it on the H100: like the forward, the 3x3x3 conv and its
// transpose (27 Cb^2 FMAs per voxel each, plus 27 Cb^2 for dW2) dominate;
// the full-resolution stacks should be bound by device memory, the wide
// ones by the CUDA cores' fp32 FMA rate, the coarse grids (down to 128
// voxels) by latency.
//
// Design (simple first; speed is later work). Per block, five elementwise
// kernels, each thread one voxel and a group of COB output channels (as the
// forward), write the per-voxel intermediates to scratch:
//   pre:   x -> a1, a2, t2                    (Cb-wide groups)
//   mid:   a2, g -> a3, gt3 (conv recompute)  (Cb-wide groups)
//   post:  a3, g -> gu3                       (C-wide groups)
//   dgrad: gt3, t2 -> gt2 (transposed conv)   (Cb-wide groups)
//   dx:    gt2, x, g -> dx                    (C-wide groups)
// each also writing its per-(voxel, group) share of two scalar grads. The
// weight and scalar gradients are then voxel contractions out[e] =
// sum_v A[v][p(e)] * B[v'(v, e)][q(e)], reduced deterministically in two
// passes (per-CTA partials over fixed voxel chunks, summed in a fixed order
// inside and across CTAs): no atomics, the same inputs give bit-identical
// gradients. The packed transposed weights (w1t, w2t, w3t) come from the
// wrapper, in the forward's [group][...][COB] layout.
//
// The weight contractions have two routes, chosen by the wrapper from the
// dtype before the launch (ops/conv3d.py::stack_bwd_tensor_core_route):
//  * fp32: contract_partial on the CUDA cores (tensor cores would round fp32
//    to TF32): a thread per (p, q) pair loops over its chunk's voxels, 27
//    neighbour indices a voxel for dW2.
//  * bf16: contract_tc, an implicit GEMM on mma.sync m16n8k16 in K7's design
//    (dw_conv3d.cu::dw_tc), on K3's channels-last scratch tensors. dW2 is the
//    weight gradient of the block's 3x3x3 conv: a persistent CTA walks
//    bricks of 4 x 4 x 16 output voxels (16 lines of 16 along D), stages
//    each brick's gt3 (positions x Cb_out) once and its a2 with the
//    one-voxel halo (6 x 6 x 18 positions x Cb_in) once in shared memory,
//    the halo by `shifted`'s arithmetic (circular for 'wrap', zero outside
//    the volume for 'zeros'); per tap dW2_tap += Gt3^T (Cb_out x 16) .
//    A2_tap (16 x Cb_in), gt3's A fragment loaded once a line for all 27
//    taps. dW1 and dW3 are the same GEMM with one tap over bricks of 256
//    consecutive voxels. A CTA takes a tile of at most 32 x 32 channels
//    (grid y: Cb runs up to 128 on the stem-2 path), its warps split the
//    taps (one kh each) and the m- and n-blocks (at least 8 warps stage the
//    tiles; those past the products' wait). The tensor cores' fp32 sums
//    are flushed into CUDA-core fp32 sums every brick (long chains lose
//    bits); each CTA writes one partial, which contract_reduce sums in chunk
//    order: the chunk count is a function of the shapes alone, passed in by
//    the wrapper (ops/stack_kernel.py::contract_chunks). bf16 x bf16
//    products are exact in fp32, so the route computes the CUDA-core route's
//    sums in another order.
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRed = 256;  // threads of a contraction CTA

__device__ __forceinline__ float elu_grad(float t) { return t > 0.f ? 1.f : expf(t); }

struct Vox {
  int64_t b;
  int h, w, d;
};

__device__ __forceinline__ Vox decode(int64_t v, int h, int w, int d) {
  Vox o;
  if (v <= 0x7fffffff) {  // 32-bit divisions where the index allows them
    unsigned t = static_cast<unsigned>(v);
    o.d = static_cast<int>(t % d);
    t /= d;
    o.w = static_cast<int>(t % w);
    t /= w;
    o.h = static_cast<int>(t % h);
    o.b = t / h;
    return o;
  }
  o.d = static_cast<int>(v % d);
  int64_t t = v / d;
  o.w = static_cast<int>(t % w);
  t /= w;
  o.h = static_cast<int>(t % h);
  o.b = t / h;
  return o;
}

// The voxel at p + s * (tap - 1) per axis (s = +1: the forward conv's
// neighbour; s = -1: the transposed conv's source), or -1 when 'zeros' puts
// it outside the volume.
__device__ __forceinline__ int64_t shifted(const Vox& p, int tap, int s, int h, int w, int d,
                                           int wrap) {
  int hh = p.h + s * (tap / 9 - 1);
  int ww = p.w + s * ((tap / 3) % 3 - 1);
  int dd = p.d + s * (tap % 3 - 1);
  if (hh < 0 || hh >= h || ww < 0 || ww >= w || dd < 0 || dd >= d) {
    if (!wrap) return -1;
    hh = (hh + h) % h;
    ww = (ww + w) % w;
    dd = (dd + d) % d;
  }
  return ((p.b * h + hh) * w + ww) * static_cast<int64_t>(d) + dd;
}

template <typename T, int COB>
__global__ void bwd_pre(const T* __restrict__ x, const T* __restrict__ w1,
                        const float* __restrict__ sc, T* __restrict__ a1, T* __restrict__ a2,
                        T* __restrict__ t2, int64_t nvox, int c, int cb) {
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
    const float a = vq::rnd<T>(vq::rnd<T>(vq::elu(t)) + b1b);
    if (g == 0) a1[v * c + ci] = vq::from_f<T>(a);
#pragma unroll
    for (int j = 0; j < COB; ++j) acc[j] = fmaf(a, vq::to_f<T>(wg[ci * COB + j]), acc[j]);
  }
#pragma unroll
  for (int j = 0; j < COB; ++j) {
    const int k = g * COB + j;
    if (k < cb) {
      const float u = vq::rnd<T>(vq::rnd<T>(acc[j]) + b2a);
      t2[v * cb + k] = vq::from_f<T>(u);
      a2[v * cb + k] = vq::from_f<T>(vq::rnd<T>(vq::elu(u)) + b2b);
    }
  }
}

template <typename T, int COB>
__global__ void bwd_mid(const T* __restrict__ a2, const T* __restrict__ w2,
                        const T* __restrict__ w3t, const T* __restrict__ gy,
                        const float* __restrict__ sc, T* __restrict__ a3, T* __restrict__ gt3,
                        float* __restrict__ sv, int nsv, int64_t nvox, int h, int w, int d,
                        int c, int cb, int wrap) {
  const int64_t v = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (v >= nvox) return;
  const int g = blockIdx.y;
  const Vox p = decode(v, h, w, d);
  const T* wg = w2 + static_cast<int64_t>(g) * 27 * cb * COB;  // [G][27][Cb][COB]
  float acc[COB];
#pragma unroll
  for (int j = 0; j < COB; ++j) acc[j] = 0.f;
  for (int tap = 0; tap < 27; ++tap) {
    const int64_t nb = shifted(p, tap, 1, h, w, d, wrap);
    if (nb < 0) continue;
    const T* src = a2 + nb * cb;
    const T* wt = wg + tap * cb * COB;
    for (int ci = 0; ci < cb; ++ci) {
      const float a = vq::to_f<T>(src[ci]);
#pragma unroll
      for (int j = 0; j < COB; ++j) acc[j] = fmaf(a, vq::to_f<T>(wt[ci * COB + j]), acc[j]);
    }
  }
  const float b3a = vq::rnd<T>(sc[4]), b3b = vq::rnd<T>(sc[5]), scale = vq::rnd<T>(sc[7]);
  float t3[COB], ga[COB];
#pragma unroll
  for (int j = 0; j < COB; ++j) {
    t3[j] = vq::rnd<T>(vq::rnd<T>(acc[j]) + b3a);
    ga[j] = 0.f;
  }
  // ga3 = W3^T (g * scale): w3t is [G][C][COB]
  const T* gv = gy + v * c;
  const T* wtg = w3t + static_cast<int64_t>(g) * c * COB;
  for (int co = 0; co < c; ++co) {
    const float gu = vq::rnd<T>(vq::to_f<T>(gv[co]) * scale);
#pragma unroll
    for (int j = 0; j < COB; ++j) ga[j] = fmaf(gu, vq::to_f<T>(wtg[co * COB + j]), ga[j]);
  }
  float s_ga = 0.f, s_gt = 0.f;
#pragma unroll
  for (int j = 0; j < COB; ++j) {
    const int k = g * COB + j;
    if (k < cb) {
      a3[v * cb + k] = vq::from_f<T>(vq::rnd<T>(vq::elu(t3[j])) + b3b);
      const float gak = vq::rnd<T>(ga[j]);
      const float gtk = vq::rnd<T>(gak * elu_grad(t3[j]));
      gt3[v * cb + k] = vq::from_f<T>(gtk);
      s_ga += gak;
      s_gt += gtk;
    }
  }
  sv[v * nsv + 2 * g] = s_ga;      // -> d_b3b
  sv[v * nsv + 2 * g + 1] = s_gt;  // -> d_b3a
}

template <typename T, int COB>
__global__ void bwd_post(const T* __restrict__ a3, const T* __restrict__ w3,
                         const T* __restrict__ gy, const float* __restrict__ sc,
                         T* __restrict__ gu3, float* __restrict__ sv, int nsv, int off,
                         int64_t nvox, int c, int cb) {
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
  const float scale = vq::rnd<T>(sc[7]);
  float s_g = 0.f, s_gu = 0.f;
#pragma unroll
  for (int j = 0; j < COB; ++j) {
    const int co = g * COB + j;
    if (co < c) {
      const float gval = vq::to_f<T>(gy[v * c + co]);
      gu3[v * c + co] = vq::from_f<T>(gval * scale);
      s_g += gval;
      s_gu += gval * vq::rnd<T>(acc[j]);
    }
  }
  sv[v * nsv + off + 2 * g] = s_g;       // -> d_b4
  sv[v * nsv + off + 2 * g + 1] = s_gu;  // -> d_scale
}

template <typename T, int COB>
__global__ void bwd_dgrad(const T* __restrict__ gt3, const T* __restrict__ w2t,
                          const T* __restrict__ t2, T* __restrict__ gt2, float* __restrict__ sv,
                          int nsv, int off, int64_t nvox, int h, int w, int d, int cb,
                          int wrap) {
  const int64_t v = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (v >= nvox) return;
  const int g = blockIdx.y;
  const Vox p = decode(v, h, w, d);
  const T* wg = w2t + static_cast<int64_t>(g) * 27 * cb * COB;  // [G(in)][27][Cb(out)][COB]
  float acc[COB];
#pragma unroll
  for (int j = 0; j < COB; ++j) acc[j] = 0.f;
  for (int tap = 0; tap < 27; ++tap) {
    const int64_t src_v = shifted(p, tap, -1, h, w, d, wrap);
    if (src_v < 0) continue;
    const T* src = gt3 + src_v * cb;
    const T* wt = wg + tap * cb * COB;
    for (int o = 0; o < cb; ++o) {
      const float gval = vq::to_f<T>(src[o]);
#pragma unroll
      for (int j = 0; j < COB; ++j) acc[j] = fmaf(gval, vq::to_f<T>(wt[o * COB + j]), acc[j]);
    }
  }
  float s_ga = 0.f, s_gt = 0.f;
#pragma unroll
  for (int j = 0; j < COB; ++j) {
    const int i = g * COB + j;
    if (i < cb) {
      const float gai = vq::rnd<T>(acc[j]);
      const float gti = vq::rnd<T>(gai * elu_grad(vq::to_f<T>(t2[v * cb + i])));
      gt2[v * cb + i] = vq::from_f<T>(gti);
      s_ga += gai;
      s_gt += gti;
    }
  }
  sv[v * nsv + off + 2 * g] = s_ga;      // -> d_b2b
  sv[v * nsv + off + 2 * g + 1] = s_gt;  // -> d_b2a
}

template <typename T, int COB>
__global__ void bwd_dx(const T* __restrict__ x, const T* __restrict__ gy,
                       const T* __restrict__ gt2, const T* __restrict__ w1t,
                       const float* __restrict__ sc, T* __restrict__ dx, float* __restrict__ sv,
                       int nsv, int off, int64_t nvox, int c, int cb) {
  const int64_t v = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (v >= nvox) return;
  const int g = blockIdx.y;
  const T* gv = gt2 + v * cb;
  const T* wg = w1t + static_cast<int64_t>(g) * cb * COB;  // [G][Cb][COB]
  float acc[COB];
#pragma unroll
  for (int j = 0; j < COB; ++j) acc[j] = 0.f;
  for (int k = 0; k < cb; ++k) {
    const float gval = vq::to_f<T>(gv[k]);
#pragma unroll
    for (int j = 0; j < COB; ++j) acc[j] = fmaf(gval, vq::to_f<T>(wg[k * COB + j]), acc[j]);
  }
  const float b1a = vq::rnd<T>(sc[0]);
  float s_ga = 0.f, s_gt = 0.f;
#pragma unroll
  for (int j = 0; j < COB; ++j) {
    const int ci = g * COB + j;
    if (ci < c) {
      const float gai = vq::rnd<T>(acc[j]);
      const float t1 = vq::rnd<T>(vq::to_f<T>(x[v * c + ci]) + b1a);
      const float gti = vq::rnd<T>(gai * elu_grad(t1));
      dx[v * c + ci] = vq::from_f<T>(vq::to_f<T>(gy[v * c + ci]) + gti);
      s_ga += gai;
      s_gt += gti;
    }
  }
  sv[v * nsv + off + 2 * g] = s_ga;      // -> d_b1b
  sv[v * nsv + off + 2 * g + 1] = s_gt;  // -> d_b1a
}

// Pass 1 of a voxel contraction out[t][p][q] = sum_v A[v][p] * B[v_t][q]
// for NT taps t: v_t = v for NT == 1, else v's forward-conv neighbour at tap
// t (skipped outside the volume for 'zeros'); B == nullptr reads B as 1.
// CTA (chunk, tile) sums voxels [chunk * len, (chunk + 1) * len) for the
// (p, q) pairs [tile * et, tile * et + et), each thread one pair and all NT
// taps (one voxel decode per NT products). With fewer than 256 pairs,
// sl = tid / et lanes split the chunk's voxels (lane sl takes v0 + sl,
// v0 + sl + lanes, ...) and are summed in lane order.
template <typename TA, typename TB, int NT>
__global__ void contract_partial(const TA* __restrict__ A, int P, const TB* __restrict__ B,
                                 int Q, float* __restrict__ part, int64_t nvox, int64_t len,
                                 int et, int h, int w, int d, int wrap) {
  __shared__ float red[NT * kRed];
  const int pairs = P * Q;
  const int tid = threadIdx.x;
  const int lanes = kRed / et;
  const int el = tid % et, sl = tid / et;
  const int e = blockIdx.y * et + el;
  float acc[NT];
#pragma unroll
  for (int t = 0; t < NT; ++t) acc[t] = 0.f;
  if (sl < lanes && e < pairs) {
    const int pi = e / Q, qi = e % Q;
    const int64_t v0 = static_cast<int64_t>(blockIdx.x) * len;
    const int64_t v1 = v0 + len < nvox ? v0 + len : nvox;
    for (int64_t v = v0 + sl; v < v1; v += lanes) {
      const float a = vq::to_f<TA>(A[v * P + pi]);
      if (B == nullptr) {
        acc[0] += a;
      } else if (NT == 1) {
        acc[0] = fmaf(a, vq::to_f<TB>(B[v * Q + qi]), acc[0]);
      } else {
        const Vox p = decode(v, h, w, d);
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          const int64_t vb = shifted(p, t, 1, h, w, d, wrap);
          if (vb >= 0) acc[t] = fmaf(a, vq::to_f<TB>(B[vb * Q + qi]), acc[t]);
        }
      }
    }
  }
#pragma unroll
  for (int t = 0; t < NT; ++t) red[t * kRed + tid] = acc[t];
  __syncthreads();
  if (sl == 0 && e < pairs) {
    float* out = part + static_cast<int64_t>(blockIdx.x) * NT * pairs;
    for (int t = 0; t < NT; ++t) {
      float s = 0.f;
      for (int r = 0; r < lanes; ++r) s += red[t * kRed + r * et + el];
      out[t * pairs + e] = s;
    }
  }
}

__global__ void contract_reduce(const float* __restrict__ part, float* __restrict__ out,
                                int64_t nchunks, int E) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  float s = 0.f;
  for (int64_t ch = 0; ch < nchunks; ++ch) s += part[ch * E + e];
  out[e] = s;
}

// Both passes of a contraction into out (NT * P * Q floats). The chunk count
// is a function of the shapes only (at most 2048, and at most 2^20 partial
// floats unless one chunk alone needs more), so the summation order is fixed.
template <typename TA, typename TB, int NT>
cudaError_t contract(const TA* A, int P, const TB* B, int Q, float* out, float* part,
                     int64_t part_len, int64_t nvox, int h, int w, int d, int wrap,
                     cudaStream_t s) {
  const int pairs = P * Q;
  const int64_t E = static_cast<int64_t>(NT) * pairs;
  const int et = pairs < kRed ? pairs : kRed;
  const int tiles = (pairs + kRed - 1) / kRed;
  int64_t nchunks = (nvox + kRed - 1) / kRed;
  if (nchunks > 2048) nchunks = 2048;
  if (nchunks > (int64_t{1} << 20) / E) nchunks = (int64_t{1} << 20) / E;
  if (nchunks < 1) nchunks = 1;
  if (nchunks * E > part_len) return cudaErrorInvalidValue;
  const int64_t len = (nvox + nchunks - 1) / nchunks;
  contract_partial<TA, TB, NT><<<dim3(static_cast<unsigned>(nchunks), tiles), kRed, 0, s>>>(
      A, P, B, Q, part, nvox, len, et, h, w, d, wrap);
  contract_reduce<<<static_cast<unsigned>((E + kRed - 1) / kRed), kRed, 0, s>>>(
      part, out, nchunks, static_cast<int>(E));
  return cudaGetLastError();
}

// ---- bf16 contractions on the tensor cores (contract_tc)

constexpr int TBH = 4, TBW = 4, TBD = 16;  // a dW2 brick (ops/stack_kernel.py TC_BRICK)
constexpr int XH = TBH + 2, XW = TBW + 2, XD = TBD + 2;  // its a2 tile with the halo
constexpr int XROWS = XH * XW * XD;
constexpr int GROWS = TBH * TBW * TBD;  // a brick's voxels; a 1-tap brick's too (TC_FLAT_BRICK)

template <int N8, int M16, int NTAPS>  // B's tile padded to 8, 16 or 32 channels, A's to 16 or 32
struct CtShape {
  static constexpr int NB = N8 / 8, MB = M16 / 16;  // n-blocks of 8, m-blocks of 16
  static constexpr int NBW = NB < 2 ? NB : 2;       // n-blocks a warp
  static constexpr int TW = NTAPS == 27 ? 3 : 1;    // tap groups (one kh each)
  static constexpr int TAPS = NTAPS == 27 ? 9 : 1;  // taps a warp
  static constexpr int WARPS = TW * MB * (NB / NBW);  // the warps of the products
  static constexpr int THREADS = WARPS < 8 ? 256 : 32 * WARPS;  // all of them stage the tiles
  static constexpr int BS = N8 == 8 ? 8 : N8 + 8;   // row strides (bf16): the 8 rows of
  static constexpr int AS = M16 + 8;                //   an ldmatrix on distinct banks
  static constexpr int BROWS = NTAPS == 27 ? XROWS : GROWS;
  static constexpr int SMEM = (BROWS * BS + GROWS * AS) * 2;
};

// Channels c .. c + 7 of voxel v of a channels-last (nvox, cc) bf16 tensor as
// one 16-byte shared row; channels past cc and v < 0 read as 0. vec: cc is a
// multiple of 8 and the tensor 16-byte aligned, so the row is one load.
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* src, int64_t v, int cc, int c,
                                       bool vec) {
  if (v < 0 || c >= cc) return make_uint4(0u, 0u, 0u, 0u);
  const __nv_bfloat16* p = src + v * cc + c;
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

// Coordinate c of an axis of extent n as a brick's halo sees it: c inside,
// c - n or c + n one step outside for 'wrap' (shifted's arithmetic), else -1
// (zero). Only voxels outside the volume, whose gt3 rows are zero, read
// further out.
__device__ __forceinline__ int halo_axis(int c, int n, int wrap) {
  if (c >= 0 && c < n) return c;
  if (wrap && c == -1) return n - 1;
  if (wrap && c == n) return 0;
  return -1;
}

// Pass 1 of out[t][p][q] = sum_v A[v][p] * B[v_t][q] on the tensor cores:
// CTA (chunk, tile) sums bricks chunk, chunk + gridDim.x, ... for the
// channels of its tile (grid y: m-tiles fastest) and writes them to its
// partial part[chunk][t][p][q].
template <int N8, int M16, int NTAPS>
__global__ void __launch_bounds__(CtShape<N8, M16, NTAPS>::THREADS)
    contract_tc(const __nv_bfloat16* __restrict__ A, int P, const __nv_bfloat16* __restrict__ B,
                int Q, float* __restrict__ part, int64_t batch, int h, int w, int d, int wrap) {
  using S = CtShape<N8, M16, NTAPS>;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* bs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* as = bs + S::BROWS * S::BS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ti = warp % S::TW, mb = warp / S::TW % S::MB, nb0 = warp / (S::TW * S::MB) * S::NBW;
  const int mtiles = (P + M16 - 1) / M16;
  const int pa = static_cast<int>(blockIdx.y) % mtiles * M16;
  const int qb = static_cast<int>(blockIdx.y) / mtiles * N8;
  const int64_t nvox = batch * h * w * static_cast<int64_t>(d);
  const int nbh = (h + TBH - 1) / TBH, nbw = (w + TBW - 1) / TBW, nbd = (d + TBD - 1) / TBD;
  const int64_t nbricks = NTAPS == 27 ? batch * nbh * nbw * nbd : (nvox + GROWS - 1) / GROWS;
  const bool avec = P % 8 == 0 && (reinterpret_cast<uintptr_t>(A) & 15) == 0;
  const bool bvec = Q % 8 == 0 && (reinterpret_cast<uintptr_t>(B) & 15) == 0;
  float tot[S::TAPS][S::NBW][4];
#pragma unroll
  for (int tp = 0; tp < S::TAPS; ++tp)
#pragma unroll
    for (int u = 0; u < S::NBW; ++u) tot[tp][u][0] = tot[tp][u][1] = tot[tp][u][2] = tot[tp][u][3] = 0.f;

  for (int64_t br = blockIdx.x; br < nbricks; br += gridDim.x) {
    int64_t b = 0;
    int h0 = 0, w0 = 0, d0 = 0;
    if (NTAPS == 27) {
      int64_t r = br;
      d0 = static_cast<int>(r % nbd) * TBD;
      r /= nbd;
      w0 = static_cast<int>(r % nbw) * TBW;
      r /= nbw;
      h0 = static_cast<int>(r % nbh) * TBH;
      b = r / nbh;
    }
    // A: the brick's voxels, row (hh * TBW + ww) * TBD + dd (a 1-tap brick: br * GROWS + row)
    for (int e = tid; e < GROWS * (M16 / 8); e += blockDim.x) {
      const int row = e % GROWS, cg = e / GROWS;
      int64_t v;
      if (NTAPS == 27) {
        const int hh = h0 + row / (TBD * TBW), ww = w0 + row / TBD % TBW, dd = d0 + row % TBD;
        v = hh < h && ww < w && dd < d ? ((b * h + hh) * w + ww) * static_cast<int64_t>(d) + dd : -1;
      } else {
        v = br * GROWS + row < nvox ? br * GROWS + row : -1;
      }
      *reinterpret_cast<uint4*>(as + row * S::AS + 8 * cg) = load8(A, v, P, pa + 8 * cg, avec);
    }
    // B: the brick's voxels with the halo, row (hh * XW + ww) * XD + dd at
    // voxel (h0 + hh - 1, w0 + ww - 1, d0 + dd - 1)
    for (int e = tid; e < S::BROWS * (N8 / 8); e += blockDim.x) {
      const int row = e % S::BROWS, cg = e / S::BROWS;
      int64_t v;
      if (NTAPS == 27) {
        const int hh = halo_axis(h0 + row / (XD * XW) - 1, h, wrap);
        const int ww = halo_axis(w0 + row / XD % XW - 1, w, wrap);
        const int dd = halo_axis(d0 + row % XD - 1, d, wrap);
        v = hh < 0 || ww < 0 || dd < 0 ? -1 : ((b * h + hh) * w + ww) * static_cast<int64_t>(d) + dd;
      } else {
        v = br * GROWS + row < nvox ? br * GROWS + row : -1;
      }
      *reinterpret_cast<uint4*>(bs + row * S::BS + 8 * cg) = load8(B, v, Q, qb + 8 * cg, bvec);
    }
    __syncthreads();

    float acc[S::TAPS][S::NBW][4];
#pragma unroll
    for (int tp = 0; tp < S::TAPS; ++tp)
#pragma unroll
      for (int u = 0; u < S::NBW; ++u) acc[tp][u][0] = acc[tp][u][1] = acc[tp][u][2] = acc[tp][u][3] = 0.f;
    for (int line = 0; line < (warp < S::WARPS ? GROWS / 16 : 0); ++line) {
      // A's fragment (p x 16 voxels): lanes 8q .. 8q+7 address voxels
      // 8 (q / 2) + 0..7 of the line at p 16 mb + 8 (q % 2)
      uint32_t a[4];
      vq::ldsm_x4_t(a, vq::smem_u32(as + (line * 16 + (lane & 7) + 8 * (lane >> 4)) * S::AS +
                                    16 * mb + 8 * ((lane >> 3) & 1)));
#pragma unroll
      for (int tp = 0; tp < S::TAPS; ++tp) {
        // the B row of the line's voxel 0 at tap (ti, tp / 3, tp % 3)
        const int xr = NTAPS == 27
                           ? ((line / TBW + ti) * XW + line % TBW + tp / 3) * XD + tp % 3
                           : line * 16;
        if constexpr (S::NBW == 2) {
          // lanes 8q .. 8q+7: voxels 8 (q % 2) + 0..7 at q-channels 8 (nb0 + q / 2)
          uint32_t bf[4];
          vq::ldsm_x4_t(bf, vq::smem_u32(bs + (xr + (lane & 7) + 8 * ((lane >> 3) & 1)) * S::BS +
                                         8 * (nb0 + (lane >> 4))));
          vq::mma_16816(acc[tp][0], a, bf[0], bf[1]);
          vq::mma_16816(acc[tp][1], a, bf[2], bf[3]);
        } else {
          uint32_t bf[2];
          vq::ldsm_x2_t(bf, vq::smem_u32(bs + (xr + (lane & 15)) * S::BS + 8 * nb0));
          vq::mma_16816(acc[tp][0], a, bf[0], bf[1]);
        }
      }
    }
#pragma unroll
    for (int tp = 0; tp < S::TAPS; ++tp)  // the per-brick flush
#pragma unroll
      for (int u = 0; u < S::NBW; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) tot[tp][u][e] += acc[tp][u][e];
    __syncthreads();  // the tiles are refilled for the next brick
  }

  if (warp >= S::WARPS) return;
  const int gq = lane >> 2, tq = lane & 3;
  float* out = part + static_cast<int64_t>(blockIdx.x) * NTAPS * P * Q;
#pragma unroll
  for (int tp = 0; tp < S::TAPS; ++tp) {
    const int tap = NTAPS == 27 ? ti * 9 + tp : 0;
#pragma unroll
    for (int u = 0; u < S::NBW; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = pa + 16 * mb + gq + 8 * (e >> 1), q = qb + 8 * (nb0 + u) + 2 * tq + (e & 1);
        if (p < P && q < Q) out[(static_cast<int64_t>(tap) * P + p) * Q + q] = tot[tp][u][e];
      }
  }
}

template <int N8, int M16, int NTAPS>
cudaError_t contract_tc_launch(const __nv_bfloat16* A, int P, const __nv_bfloat16* B, int Q,
                               float* out, float* part, int64_t part_len, int nchunks,
                               int64_t batch, int h, int w, int d, int wrap, cudaStream_t s) {
  using S = CtShape<N8, M16, NTAPS>;
  const int64_t E = static_cast<int64_t>(NTAPS) * P * Q;
  if (nchunks < 1 || nchunks * E > part_len) return cudaErrorInvalidValue;
  if (S::SMEM > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(contract_tc<N8, M16, NTAPS>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
    if (e != cudaSuccess) return e;
  }
  const int tiles = ((P + M16 - 1) / M16) * ((Q + N8 - 1) / N8);
  contract_tc<N8, M16, NTAPS><<<dim3(nchunks, tiles), S::THREADS, S::SMEM, s>>>(
      A, P, B, Q, part, batch, h, w, d, wrap);
  contract_reduce<<<static_cast<unsigned>((E + kRed - 1) / kRed), kRed, 0, s>>>(
      part, out, nchunks, static_cast<int>(E));
  return cudaGetLastError();
}

// The tile shapes: A's channels P padded to 16 or 32 (tiles of 32 past 32),
// B's Q to 8, 16 or 32 (likewise).
template <int NTAPS, int M16>
cudaError_t contract_tc_q(const __nv_bfloat16* A, int P, const __nv_bfloat16* B, int Q,
                          float* out, float* part, int64_t part_len, int nchunks, int64_t batch,
                          int h, int w, int d, int wrap, cudaStream_t s) {
  if (Q <= 8)
    return contract_tc_launch<8, M16, NTAPS>(A, P, B, Q, out, part, part_len, nchunks, batch, h,
                                             w, d, wrap, s);
  if (Q <= 16)
    return contract_tc_launch<16, M16, NTAPS>(A, P, B, Q, out, part, part_len, nchunks, batch,
                                              h, w, d, wrap, s);
  return contract_tc_launch<32, M16, NTAPS>(A, P, B, Q, out, part, part_len, nchunks, batch, h,
                                            w, d, wrap, s);
}

template <int NTAPS>
cudaError_t contract_tc_pq(const __nv_bfloat16* A, int P, const __nv_bfloat16* B, int Q,
                           float* out, float* part, int64_t part_len, int nchunks, int64_t batch,
                           int h, int w, int d, int wrap, cudaStream_t s) {
  if (P <= 16)
    return contract_tc_q<NTAPS, 16>(A, P, B, Q, out, part, part_len, nchunks, batch, h, w, d,
                                    wrap, s);
  return contract_tc_q<NTAPS, 32>(A, P, B, Q, out, part, part_len, nchunks, batch, h, w, d, wrap,
                                  s);
}

// The scalar sums, per (kernel, group) pair, -> the block's 8 scalar grads.
__global__ void scalars_kernel(const float* __restrict__ s, float* __restrict__ dsc, int gb,
                               int gc) {
  float r[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const int mid = 0, post = 2 * gb, dgrad = 2 * gb + 2 * gc, dxo = 4 * gb + 2 * gc;
  for (int g = 0; g < gb; ++g) {
    r[5] += s[mid + 2 * g];        // b3b
    r[4] += s[mid + 2 * g + 1];    // b3a
    r[3] += s[dgrad + 2 * g];      // b2b
    r[2] += s[dgrad + 2 * g + 1];  // b2a
  }
  for (int g = 0; g < gc; ++g) {
    r[6] += s[post + 2 * g];      // b4
    r[7] += s[post + 2 * g + 1];  // scale
    r[1] += s[dxo + 2 * g];       // b1b
    r[0] += s[dxo + 2 * g + 1];   // b1a
  }
  for (int i = 0; i < 8; ++i) dsc[i] = r[i];
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
cudaError_t block_bwd(const T* x, const T* gy, const T* w1, const T* w2, const T* w3,
                      const T* w1t, const T* w2t, const T* w3t, const float* sc, T* work,
                      float* sv, float* part, int64_t part_len, const int* tc_chunks, T* dx,
                      float* dw1, float* dw2, float* dw3, float* dsc, int64_t batch, int h, int w,
                      int d, int c, int cb, int cob_b, int cob_c, int wrap, cudaStream_t s) {
  const int64_t nvox = batch * h * w * static_cast<int64_t>(d);
  if (nvox == 0) return cudaErrorInvalidValue;
  T* a1 = work;
  T* a2 = a1 + nvox * c;
  T* t2 = a2 + nvox * cb;
  T* a3 = t2 + nvox * cb;
  T* gt3 = a3 + nvox * cb;
  T* gu3 = gt3 + nvox * cb;
  T* gt2 = gu3 + nvox * c;
  const int gb = groups_of(cb, cob_b), gc = groups_of(c, cob_c);
  const int nsv = 4 * gb + 4 * gc;  // scalar shares per voxel: mid, post, dgrad, dx
  if (part_len <= nsv) return cudaErrorInvalidValue;
  const dim3 grb = grid_for(nvox, gb), grc = grid_for(nvox, gc);
  VQ_COB_DISPATCH(cob_b, bwd_pre, T, <<<grb, kThreads, 0, s>>>(x, w1, sc, a1, a2, t2, nvox, c, cb))
  VQ_COB_DISPATCH(cob_b, bwd_mid, T,
                  <<<grb, kThreads, 0, s>>>(a2, w2, w3t, gy, sc, a3, gt3, sv, nsv, nvox, h, w,
                                            d, c, cb, wrap))
  VQ_COB_DISPATCH(cob_c, bwd_post, T,
                  <<<grc, kThreads, 0, s>>>(a3, w3, gy, sc, gu3, sv, nsv, 2 * gb, nvox, c, cb))
  VQ_COB_DISPATCH(cob_b, bwd_dgrad, T,
                  <<<grb, kThreads, 0, s>>>(gt3, w2t, t2, gt2, sv, nsv, 2 * gb + 2 * gc, nvox,
                                            h, w, d, cb, wrap))
  VQ_COB_DISPATCH(cob_c, bwd_dx, T,
                  <<<grc, kThreads, 0, s>>>(x, gy, gt2, w1t, sc, dx, sv, nsv, 4 * gb + 2 * gc,
                                            nvox, c, cb))
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t plen = part_len - nsv;  // the last nsv floats hold the scalar sums
  float* ssum = part + plen;
  if (tc_chunks != nullptr) {  // the tensor-core route (bf16 only)
    if constexpr (std::is_same_v<T, __nv_bfloat16>) {
      err = contract_tc_pq<1>(gt2, cb, a1, c, dw1, part, plen, tc_chunks[0], batch, h, w, d, wrap,
                              s);
      if (err != cudaSuccess) return err;
      err = contract_tc_pq<27>(gt3, cb, a2, cb, dw2, part, plen, tc_chunks[1], batch, h, w, d,
                               wrap, s);
      if (err != cudaSuccess) return err;
      err = contract_tc_pq<1>(gu3, c, a3, cb, dw3, part, plen, tc_chunks[2], batch, h, w, d, wrap,
                              s);
      if (err != cudaSuccess) return err;
    } else {
      return cudaErrorInvalidValue;
    }
  } else {
    err = contract<T, T, 1>(gt2, cb, a1, c, dw1, part, plen, nvox, h, w, d, wrap, s);
    if (err != cudaSuccess) return err;
    err = contract<T, T, 1>(gu3, c, a3, cb, dw3, part, plen, nvox, h, w, d, wrap, s);
    if (err != cudaSuccess) return err;
    err = contract<T, T, 27>(gt3, cb, a2, cb, dw2, part, plen, nvox, h, w, d, wrap, s);
    if (err != cudaSuccess) return err;
  }
  err = contract<float, float, 1>(sv, nsv, nullptr, 1, ssum, part, plen, nvox, h, w, d, wrap,
                                  s);
  if (err != cudaSuccess) return err;
  scalars_kernel<<<1, 1, 0, s>>>(ssum, dsc, gb, gc);
  return cudaGetLastError();
}

}  // namespace

// One block's backward. x (the block's saved input), gy (the cotangent of its
// output) and dx are (B, H, W, D, C) contiguous, of type bf16 when is_bf16
// else fp32, as are the packed weights: forward packs w1 [Gb][C][cob_b],
// w2 [Gb][27][Cb][cob_b], w3 [Gc][Cb][cob_c]; transposed packs
// w1t [Gc][Cb][cob_c] (W1^T), w2t [Gb][27][Cb][cob_b] (input-channel groups,
// inner over output channels), w3t [Gb][C][cob_b] (W3^T). sc holds the
// block's 8 fp32 scalars. work is scratch of nvox * (2C + 5Cb) elements of
// the activation type, sv nvox * (4Gb + 4Gc) floats, part part_len floats
// (>= max(2^20, 27 Cb^2, C Cb) + 4Gb + 4Gc is always enough on the CUDA-core
// route; the tensor-core route's partials need chunks x taps x P x Q more,
// ops/stack_kernel.py::contract_plan). tensor_cores (bf16 only) takes the
// tensor-core route with chunks_w1, chunks_w2, chunks_w3 CTAs a tile for the
// dW1, dW2 and dW3 contractions (the wrapper's contract_chunks). Outputs
// (fp32): dw1 (Cb, C), dw2 (27, Cb_out, Cb_in) with tap = (kh * 3 + kw) * 3 +
// kd, dw3 (C, Cb), dsc (8,). dx must not alias gy or x.
extern "C" int vq_preact_block_bwd(int is_bf16, int tensor_cores, const void* x, const void* gy,
                                   const void* w1, const void* w2, const void* w3,
                                   const void* w1t, const void* w2t, const void* w3t,
                                   const void* sc, void* work, void* sv, void* part,
                                   int64_t part_len, int chunks_w1, int chunks_w2, int chunks_w3,
                                   void* dx, void* dw1, void* dw2, void* dw3, void* dsc,
                                   int64_t batch, int h, int w, int d, int c, int cb, int cob_b,
                                   int cob_c, int wrap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* scf = static_cast<const float*>(sc);
  float* svf = static_cast<float*>(sv);
  float* pf = static_cast<float*>(part);
  float *d1 = static_cast<float*>(dw1), *d2 = static_cast<float*>(dw2),
        *d3 = static_cast<float*>(dw3), *ds = static_cast<float*>(dsc);
  if (tensor_cores && !is_bf16) return cudaErrorInvalidValue;
  const int chunks[3] = {chunks_w1, chunks_w2, chunks_w3};
  const int* tc = tensor_cores ? chunks : nullptr;
  if (is_bf16) {
    using T = __nv_bfloat16;
    return block_bwd<T>(static_cast<const T*>(x), static_cast<const T*>(gy),
                        static_cast<const T*>(w1), static_cast<const T*>(w2),
                        static_cast<const T*>(w3), static_cast<const T*>(w1t),
                        static_cast<const T*>(w2t), static_cast<const T*>(w3t), scf,
                        static_cast<T*>(work), svf, pf, part_len, tc, static_cast<T*>(dx), d1,
                        d2, d3, ds, batch, h, w, d, c, cb, cob_b, cob_c, wrap, s);
  }
  using F = float;
  return block_bwd<F>(static_cast<const F*>(x), static_cast<const F*>(gy),
                      static_cast<const F*>(w1), static_cast<const F*>(w2),
                      static_cast<const F*>(w3), static_cast<const F*>(w1t),
                      static_cast<const F*>(w2t), static_cast<const F*>(w3t), scf,
                      static_cast<F*>(work), svf, pf, part_len, nullptr, static_cast<F*>(dx), d1,
                      d2, d3, ds, batch, h, w, d, c, cb, cob_b, cob_c, wrap, s);
}
