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
// Two routes for the elementwise half, chosen by the wrapper from the dtype
// and Cb before any launch (ops/conv3d.py::stack_bwd_brick_route): bf16 at
// 5 <= Cb <= 128, the widths of the forward's fused_tc, takes the two brick
// kernels on the tensor cores near the end of this file (brick_bwd_mid,
// brick_bwd_dgrad); fp32 and the other bf16 widths the first design. Per
// block, five elementwise kernels, each thread one voxel and a group of COB
// output channels (as the forward), write the per-voxel intermediates to
// scratch:
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

#include "brick_conv.cuh"

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

using vqb::halo_axis;
using vqb::load8;

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

// ---- bf16 at 5 <= Cb <= 128: two brick kernels a block on the tensor cores
//
// The five elementwise kernels become two, each a CTA of 8 warps on a brick
// of output voxels with its one-voxel halo (the forward's bricks,
// ops/stack_kernel.py fused_brick / fused_voxels), every product on mma.sync
// m16n8k16 (bf16 in, fp32 accumulate) with brick_conv.cuh's device code:
//   brick_bwd_mid:   x (halo) -> a1, t2, a2 by the forward's halo_pre, t3 and
//                    a3 by its conv_tile and epilogue (the forward's values,
//                    bit for bit); gu3 = g * scale staged 16 rows a warp,
//                    ga3 = W3^T gu3, gt3 = ga3 * elu'(t3); the forward's W3
//                    product of a3 for d_scale
//   brick_bwd_dgrad: gt3 (halo) -> ga2 by conv_tile with the taps mirrored
//                    and w2's in/out channels swapped (halo row v + (1 - tap)
//                    is the neighbour v - (tap - 1) that the transposed conv
//                    reads; 'wrap' wraps it, 'zeros' reads it as zero),
//                    gt2 = ga2 * elu'(t2), ga1 = W1^T gt2, dx = g + ga1 *
//                    elu'(t1)
// They write only what later passes read: the contractions' operands (a1, a2,
// a3, gt3, gu3, gt2; contract_tc reads them as on the five kernels' route),
// t2 (for the second kernel) and dx. Each CTA sums its voxels' shares of the
// 8 scalar grads (lanes, then the warp by xor shuffles, then the warps in
// order) into its brick's partial sp[brick][8]; brick_scalars sums the
// partials in brick order. No per-voxel scalar buffer, no atomics: the same
// inputs give bit-identical gradients. Rounding is the five kernels' (the
// plain autograd's); only the order of the fp32 sums differs.
constexpr int kBrickThreads = 256, kBrickWarps = kBrickThreads / 32;

using vqb::bf16;

// the sum of v over a warp's 32 lanes, in a fixed order
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// sp[brick][o .. o + 3] = the CTA's four sums: lanes -> warp -> warps in order
__device__ __forceinline__ void brick_partial(float (&ssum)[4], float* red, float* sp, int o) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < 4; ++j) ssum[j] = warp_sum(ssum[j]);
  if (lane == 0)
#pragma unroll
    for (int j = 0; j < 4; ++j) red[warp * 4 + j] = ssum[j];
  __syncthreads();
  if (threadIdx.x < 4) {
    float v = 0.f;
    for (int wi = 0; wi < kBrickWarps; ++wi) v += red[wi * 4 + threadIdx.x];
    sp[static_cast<int64_t>(blockIdx.x) * 8 + o + threadIdx.x] = v;
  }
}

// Weights [N][K] (k contiguous, zero-padded; ops/stack_kernel.py
// pack_brick_bwd_weights): w1 [CBP][K1], w2 [27][CBP][CBP] and w3 [N3][CBP]
// as the fused forward's, w3t [CBP][K1] (W3^T). Writes a1, t2, a2, a3, gt3,
// gu3 of the brick's voxels and sp[brick][4 .. 7] = (b3a, b3b, b4, scale).
template <int CBP>
__global__ void __launch_bounds__(kBrickThreads, CBP <= 32 ? 2 : 1)
    brick_bwd_mid(const bf16* __restrict__ x, const bf16* __restrict__ gy,
                  const bf16* __restrict__ w1, const bf16* __restrict__ w2,
                  const bf16* __restrict__ w3, const bf16* __restrict__ w3t,
                  const float* __restrict__ sc, bf16* __restrict__ a1g, bf16* __restrict__ t2g,
                  bf16* __restrict__ a2g, bf16* __restrict__ a3g, bf16* __restrict__ gt3g,
                  bf16* __restrict__ gu3g, float* __restrict__ sp, int h, int w, int d, int c,
                  int cb, int k1, int wrap, int bh, int bw, int bd) {
  constexpr int NT = CBP / 8, AS = CBP + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const vqb::Brick k = vqb::brick_of(blockIdx.x, h, w, d, bh, bw, bd);
  const int nh = k.rows(), nv = bh * bw * bd;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  bf16* halo = reinterpret_cast<bf16*>(smem);  // [nh][AS]: a2 of the halo
  bf16* a3s = halo + nh * AS;                   // [nv][AS]: a3 of the brick
  bf16* stg = a3s + nv * AS + warp * 16 * vqb::kStage;
  float* red = reinterpret_cast<float*>(a3s + nv * AS + kBrickWarps * 16 * vqb::kStage);
  const vqb::Scalars s(sc);
  const bool cvec = c % 8 == 0 && (reinterpret_cast<uintptr_t>(a1g) & 15) == 0 &&
                    (reinterpret_cast<uintptr_t>(gu3g) & 15) == 0 &&
                    (reinterpret_cast<uintptr_t>(gy) & 15) == 0;
  const int arow = (lane & 7) + 8 * ((lane >> 3) & 1), acol = 8 * (lane >> 4);

  // a1, t2 and a2 of the brick's own voxels beside the forward's halo pass
  vqb::halo_pre<NT>(
      halo, AS, stg, k, x, w1, s, h, w, d, c, cb, k1, wrap, warp, kBrickWarps, lane,
      [&](int r, int c0, const uint32_t(&pk)[4]) {
        const int64_t v = vqb::own_voxel(k, r, h, w, d);
        if (v >= 0) vqb::store8(a1g, v, c, c0, pk, cvec);
      },
      [&](int r, int n, float lo, float hi, uint32_t a2pair) {
        const int64_t v = vqb::own_voxel(k, r, h, w, d);
        if (v < 0) return;
        vqb::store2(a2g, v, cb, n, a2pair);
        vqb::store2(t2g, v, cb, n, vq::pack_bf16(s.t2(lo), s.t2(hi)));
      });
  __syncthreads();

  float ssum[4] = {0.f, 0.f, 0.f, 0.f};  // b3a, b3b, b4, scale
  const int ntc = (c + 7) / 8;
  for (int mt = warp; mt * 16 < nv; mt += kBrickWarps) {
    const int m0 = mt * 16;
    const int64_t v[2] = {vqb::brick_voxel(k, m0 + g, h, w, d),
                          vqb::brick_voxel(k, m0 + g + 8, h, w, d)};
    // the forward's conv and a3; t3 (a bf16 value) kept packed
    uint32_t t3p[NT][2];
    {
      float acc[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
      vqb::conv_tile<NT, CBP>(acc, halo, AS, k, m0, w2, lane);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = m0 + g + 8 * half;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int n = nt * 8 + 2 * t;
          const float tlo = s.t3(acc[nt][2 * half]), thi = s.t3(acc[nt][2 * half + 1]);
          const uint32_t a3 = vq::pack_bf16(n < cb ? s.a3_of_t3(tlo) : 0.f,
                                            n + 1 < cb ? s.a3_of_t3(thi) : 0.f);
          *reinterpret_cast<uint32_t*>(a3s + r * AS + n) = a3;
          if (v[half] >= 0) vqb::store2(a3g, v[half], cb, n, a3);
          t3p[nt][half] = vq::pack_bf16(tlo, thi);
        }
      }
    }
    __syncwarp();
    // gu3 = g * scale, staged 16 rows a warp, and ga3 = W3^T gu3
    float ga[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) ga[nt][0] = ga[nt][1] = ga[nt][2] = ga[nt][3] = 0.f;
    {
      const int64_t sv = vqb::brick_voxel(k, m0 + (lane >> 1), h, w, d);
      for (int k0 = 0; k0 < k1; k0 += 16) {
        const int c0 = k0 + 8 * (lane & 1);
        const uint4 raw = load8(gy, sv, c, c0, cvec);
        const bf16* gv = reinterpret_cast<const bf16*>(&raw);
        uint32_t pk[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float e2[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const bool ok = sv >= 0 && c0 + 2 * j + e < c;
            const float gval = vq::to_f<bf16>(gv[2 * j + e]);
            if (ok) ssum[2] += gval;
            e2[e] = ok ? gval * s.scale : 0.f;
          }
          pk[j] = vq::pack_bf16(e2[0], e2[1]);
        }
        if (sv >= 0) vqb::store8(gu3g, sv, c, c0, pk, cvec);
        *reinterpret_cast<uint4*>(stg + (lane >> 1) * vqb::kStage + 8 * (lane & 1)) =
            make_uint4(pk[0], pk[1], pk[2], pk[3]);
        __syncwarp();
        uint32_t a[4];
        vq::ldsm_x4(a, vq::smem_u32(stg + arow * vqb::kStage + acol));
        vqb::mma_row<NT>(ga, a, w3t, k1, k0, lane);
        __syncwarp();
      }
    }
    // gt3 = ga3 * elu'(t3)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = nt * 8 + 2 * t;
        float o[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = v[half] >= 0 && n + e < cb;
          const float gak = vq::rnd<bf16>(ga[nt][2 * half + e]);
          o[e] = ok ? vq::rnd<bf16>(gak * elu_grad(vqb::unpack(t3p[nt][half], e))) : 0.f;
          if (ok) {
            ssum[0] += o[e];
            ssum[1] += gak;
          }
        }
        if (v[half] >= 0) vqb::store2(gt3g, v[half], cb, n, vq::pack_bf16(o[0], o[1]));
      }
    }
    // d_scale = sum g (a3 W3): the forward's W3 product, 64 channels at a time
    for (int n0 = 0; n0 < ntc; n0 += 8) {
      float acc2[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc2[j][0] = acc2[j][1] = acc2[j][2] = acc2[j][3] = 0.f;
#pragma unroll
      for (int k0 = 0; k0 < CBP; k0 += 16) {
        uint32_t a[4];
        vq::ldsm_x4(a, vq::smem_u32(a3s + (m0 + arow) * AS + k0 + acol));
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (n0 + j >= ntc) break;
          const bf16* p = w3 + static_cast<int64_t>((n0 + j) * 8 + g) * CBP + k0 + 2 * t;
          vq::mma_16816(acc2[j], a, vqb::ldg32(p), vqb::ldg32(p + 8));
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        if (v[half] < 0) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (n0 + j >= ntc) break;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int cc = (n0 + j) * 8 + 2 * t + e;
            if (cc < c)
              ssum[3] += vq::to_f<bf16>(gy[v[half] * c + cc]) * vq::rnd<bf16>(acc2[j][2 * half + e]);
          }
        }
      }
    }
  }
  brick_partial(ssum, red, sp, 4);
}

// Weights [N][K]: w2m [27][CBP][CBP] (tap', in, out) = w2[26 - tap'] with its
// channels swapped, w1n [N3][CBP] (W1^T). Writes gt2 and dx of the brick's
// voxels and sp[brick][0 .. 3] = (b1a, b1b, b2a, b2b).
template <int CBP>
__global__ void __launch_bounds__(kBrickThreads, CBP <= 32 ? 2 : 1)
    brick_bwd_dgrad(const bf16* __restrict__ x, const bf16* __restrict__ gy,
                    const bf16* __restrict__ gt3g, const bf16* __restrict__ t2g,
                    const bf16* __restrict__ w2m, const bf16* __restrict__ w1n,
                    const float* __restrict__ sc, bf16* __restrict__ gt2g, bf16* __restrict__ dx,
                    float* __restrict__ sp, int h, int w, int d, int c, int cb, int wrap, int bh,
                    int bw, int bd) {
  constexpr int NT = CBP / 8, AS = CBP + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const vqb::Brick k = vqb::brick_of(blockIdx.x, h, w, d, bh, bw, bd);
  const int nh = k.rows(), nv = bh * bw * bd;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  bf16* halo = reinterpret_cast<bf16*>(smem);  // [nh][AS]: gt3 of the halo
  bf16* gt2s = halo + nh * AS;                  // [nv][AS]: gt2 of the brick
  float* red = reinterpret_cast<float*>(gt2s + nv * AS);
  const vqb::Scalars s(sc);
  const bool vec = cb % 8 == 0 && (reinterpret_cast<uintptr_t>(gt3g) & 15) == 0;
  for (int e = threadIdx.x; e < nh * (CBP / 8); e += kBrickThreads) {
    const int r = e / (CBP / 8), c0 = 8 * (e % (CBP / 8));
    *reinterpret_cast<uint4*>(halo + r * AS + c0) =
        load8(gt3g, vqb::halo_voxel(k, r, h, w, d, wrap), cb, c0, vec);
  }
  __syncthreads();

  float ssum[4] = {0.f, 0.f, 0.f, 0.f};  // b1a, b1b, b2a, b2b
  const int ntc = (c + 7) / 8;
  const bool pair = c % 2 == 0;  // x, g and dx by bf16 pairs
  const int arow = (lane & 7) + 8 * ((lane >> 3) & 1), acol = 8 * (lane >> 4);
  for (int mt = warp; mt * 16 < nv; mt += kBrickWarps) {
    const int m0 = mt * 16;
    const int64_t v[2] = {vqb::brick_voxel(k, m0 + g, h, w, d),
                          vqb::brick_voxel(k, m0 + g + 8, h, w, d)};
    {  // ga2 = the transposed conv of gt3, gt2 = ga2 * elu'(t2)
      float acc[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
      vqb::conv_tile<NT, CBP>(acc, halo, AS, k, m0, w2m, lane);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = m0 + g + 8 * half;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int n = nt * 8 + 2 * t;
          float o[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const bool ok = v[half] >= 0 && n + e < cb;
            const float gai = vq::rnd<bf16>(acc[nt][2 * half + e]);
            o[e] = ok ? vq::rnd<bf16>(gai * elu_grad(vq::to_f<bf16>(t2g[v[half] * cb + n + e])))
                      : 0.f;
            if (ok) {
              ssum[3] += gai;
              ssum[2] += o[e];
            }
          }
          const uint32_t gt2 = vq::pack_bf16(o[0], o[1]);
          *reinterpret_cast<uint32_t*>(gt2s + r * AS + n) = gt2;
          if (v[half] >= 0) vqb::store2(gt2g, v[half], cb, n, gt2);
        }
      }
    }
    __syncwarp();
    // ga1 = W1^T gt2, gt1 = ga1 * elu'(t1), dx = g + gt1, 64 channels at a time
    for (int n0 = 0; n0 < ntc; n0 += 8) {
      float acc2[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc2[j][0] = acc2[j][1] = acc2[j][2] = acc2[j][3] = 0.f;
#pragma unroll
      for (int k0 = 0; k0 < CBP; k0 += 16) {
        uint32_t a[4];
        vq::ldsm_x4(a, vq::smem_u32(gt2s + (m0 + arow) * AS + k0 + acol));
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (n0 + j >= ntc) break;
          const bf16* p = w1n + static_cast<int64_t>((n0 + j) * 8 + g) * CBP + k0 + 2 * t;
          vq::mma_16816(acc2[j], a, vqb::ldg32(p), vqb::ldg32(p + 8));
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        if (v[half] < 0) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (n0 + j >= ntc) break;
          const int cc = (n0 + j) * 8 + 2 * t;
          if (cc >= c) continue;
          const int64_t o = v[half] * c + cc;
          float out[2] = {0.f, 0.f};
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (cc + e >= c) continue;
            const float gai = vq::rnd<bf16>(acc2[j][2 * half + e]);
            const float t1 = vq::rnd<bf16>(vq::to_f<bf16>(x[o + e]) + s.b1a);
            const float gti = vq::rnd<bf16>(gai * elu_grad(t1));
            out[e] = vq::to_f<bf16>(gy[o + e]) + gti;
            ssum[1] += gai;
            ssum[0] += gti;
          }
          if (pair) {
            *reinterpret_cast<uint32_t*>(dx + o) = vq::pack_bf16(out[0], out[1]);
          } else {
            dx[o] = vq::from_f<bf16>(out[0]);
            if (cc + 1 < c) dx[o + 1] = vq::from_f<bf16>(out[1]);
          }
        }
      }
    }
  }
  brick_partial(ssum, red, sp, 0);
}

// dsc[j] = sum over bricks, in brick order per lane and then by a fixed xor
// tree over the lanes, of sp[brick][j]: one warp a scalar.
__global__ void brick_scalars(const float* __restrict__ sp, int64_t nbricks,
                              float* __restrict__ dsc) {
  const int j = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float v = 0.f;
  for (int64_t b = lane; b < nbricks; b += 32) v += sp[b * 8 + j];
  v = warp_sum(v);
  if (lane == 0) dsc[j] = v;
}

template <typename K>
cudaError_t launch_brick(K kernel, int64_t bricks, int smem, cudaStream_t s, void** args) {
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const cudaError_t e = cudaLaunchKernel(reinterpret_cast<const void*>(kernel),
                                         dim3(static_cast<unsigned>(bricks)), dim3(kBrickThreads),
                                         args, static_cast<size_t>(smem), s);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <int CBP>
cudaError_t brick_kernels(const bf16* x, const bf16* gy, const bf16* w1, const bf16* w2,
                          const bf16* w3, const bf16* w3t, const bf16* w2m, const bf16* w1n,
                          const float* sc, bf16* const (&sx)[7], float* sp, bf16* dx,
                          int64_t bricks, int h, int w, int d, int c, int cb, int wrap, int bh,
                          int bw, int bd, cudaStream_t s) {
  constexpr int AS = CBP + 8;
  const int nh = (bh + 2) * (bw + 2) * (bd + 2), nv = bh * bw * bd;
  int k1 = (c + 15) / 16 * 16;
  bf16 *a1 = sx[0], *a2 = sx[1], *t2 = sx[2], *a3 = sx[3], *gt3 = sx[4], *gu3 = sx[5],
       *gt2 = sx[6];
  void* mid_args[] = {&x,   &gy,  &w1,  &w2, &w3, &w3t,  &sc, &a1, &t2, &a2, &a3, &gt3, &gu3,
                      &sp,  &h,   &w,   &d,  &c,  &cb,   &k1, &wrap, &bh, &bw, &bd};
  const int smem_m = ((nh + nv) * AS + kBrickWarps * 16 * vqb::kStage) * 2 + kBrickWarps * 4 * 4;
  cudaError_t e = launch_brick(brick_bwd_mid<CBP>, bricks, smem_m, s, mid_args);
  if (e != cudaSuccess) return e;
  void* dgrad_args[] = {&x, &gy, &gt3, &t2, &w2m, &w1n, &sc, &gt2, &dx, &sp,
                        &h, &w,  &d,   &c,  &cb,  &wrap, &bh, &bw, &bd};
  const int smem_d = (nh + nv) * AS * 2 + kBrickWarps * 4 * 4;
  return launch_brick(brick_bwd_dgrad<CBP>, bricks, smem_d, s, dgrad_args);
}

cudaError_t block_bwd_brick(const bf16* x, const bf16* gy, const bf16* w1, const bf16* w2,
                            const bf16* w3, const bf16* w3t, const bf16* w2m, const bf16* w1n,
                            const float* sc, bf16* work, float* sp, float* part, int64_t part_len,
                            const int (&chunks)[3], bf16* dx, float* dw1, float* dw2, float* dw3,
                            float* dsc, int64_t batch, int h, int w, int d, int c, int cb,
                            int cbp, int wrap, int bh, int bw, int bd, cudaStream_t s) {
  if (batch <= 0 || h <= 0 || w <= 0 || d <= 0 || c <= 0 || cb <= 0 || cbp < cb || bh <= 0 ||
      bw <= 0 || bd <= 0 || (bh * bw * bd != 128 && bh * bw * bd != 256))
    return cudaErrorInvalidValue;
  const int64_t nvox = batch * h * w * static_cast<int64_t>(d);
  const int64_t bricks = batch * ((h + bh - 1) / bh) * static_cast<int64_t>((w + bw - 1) / bw) *
                         ((d + bd - 1) / bd);
  if (bricks > 0x7fffffff) return cudaErrorInvalidValue;
  bf16* const sx[7] = {work, work + nvox * c, work + nvox * (c + cb), work + nvox * (c + 2 * cb),
                       work + nvox * (c + 3 * cb), work + nvox * (c + 4 * cb),
                       work + nvox * (2 * c + 4 * cb)};  // a1, a2, t2, a3, gt3, gu3, gt2
  cudaError_t err;
#define VQ_BRICK(CBP)                                                                            \
  brick_kernels<CBP>(x, gy, w1, w2, w3, w3t, w2m, w1n, sc, sx, sp, dx, bricks, h, w, d, c, cb, \
                     wrap, bh, bw, bd, s)
  switch (cbp) {
    case 16: err = VQ_BRICK(16); break;
    case 32: err = VQ_BRICK(32); break;
    case 48: err = VQ_BRICK(48); break;
    case 64: err = VQ_BRICK(64); break;
    case 80: err = VQ_BRICK(80); break;
    case 96: err = VQ_BRICK(96); break;
    case 112: err = VQ_BRICK(112); break;
    case 128: err = VQ_BRICK(128); break;
    default: return cudaErrorInvalidValue;
  }
#undef VQ_BRICK
  if (err != cudaSuccess) return err;
  err = contract_tc_pq<1>(sx[6], cb, sx[0], c, dw1, part, part_len, chunks[0], batch, h, w, d,
                          wrap, s);
  if (err != cudaSuccess) return err;
  err = contract_tc_pq<27>(sx[4], cb, sx[1], cb, dw2, part, part_len, chunks[1], batch, h, w, d,
                           wrap, s);
  if (err != cudaSuccess) return err;
  err = contract_tc_pq<1>(sx[5], c, sx[3], cb, dw3, part, part_len, chunks[2], batch, h, w, d,
                          wrap, s);
  if (err != cudaSuccess) return err;
  brick_scalars<<<1, 256, 0, s>>>(sp, bricks, dsc);
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

// One block's backward on the bf16 brick route (5 <= Cb <= 128; ops/conv3d.py
// stack_bwd_brick_route). x, gy, dx (B, H, W, D, C) bf16 contiguous; the
// weights bf16 [N][K] with Cb padded to cbp (16 .. 128 in steps of 16) and C
// to K1 (16) or N3 (8) (ops/stack_kernel.py pack_brick_bwd_weights): w1
// [cbp][K1], w2 [27][cbp][cbp], w3 [N3][cbp], w3t [cbp][K1], w2m
// [27][cbp][cbp], w1n [N3][cbp]; sc the block's 8 fp32 scalars; work
// nvox * (2C + 5Cb) bf16 (a1, a2, t2, a3, gt3, gu3, gt2, as on the other
// route); sp 8 floats a brick; part part_len floats for the contractions
// (chunks_w1, chunks_w2, chunks_w3: ops/stack_kernel.py contract_plan);
// (bh, bw, bd) the brick, 128 or 256 voxels. Outputs as vq_preact_block_bwd's.
extern "C" int vq_preact_block_bwd_brick(const void* x, const void* gy, const void* w1,
                                         const void* w2, const void* w3, const void* w3t,
                                         const void* w2m, const void* w1n, const void* sc,
                                         void* work, void* sp, void* part, int64_t part_len,
                                         int chunks_w1, int chunks_w2, int chunks_w3, void* dx,
                                         void* dw1, void* dw2, void* dw3, void* dsc,
                                         int64_t batch, int h, int w, int d, int c, int cb,
                                         int cbp, int wrap, int bh, int bw, int bd,
                                         void* stream) {
  using vqb::bf16;
  const int chunks[3] = {chunks_w1, chunks_w2, chunks_w3};
  return block_bwd_brick(
      static_cast<const bf16*>(x), static_cast<const bf16*>(gy), static_cast<const bf16*>(w1),
      static_cast<const bf16*>(w2), static_cast<const bf16*>(w3), static_cast<const bf16*>(w3t),
      static_cast<const bf16*>(w2m), static_cast<const bf16*>(w1n), static_cast<const float*>(sc),
      static_cast<bf16*>(work), static_cast<float*>(sp), static_cast<float*>(part), part_len,
      chunks, static_cast<bf16*>(dx), static_cast<float*>(dw1), static_cast<float*>(dw2),
      static_cast<float*>(dw3), static_cast<float*>(dsc), batch, h, w, d, c, cb, cbp, wrap, bh, bw,
      bd, static_cast<cudaStream_t>(stream));
}
