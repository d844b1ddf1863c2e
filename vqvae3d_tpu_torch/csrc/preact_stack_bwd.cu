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
#include "common.cuh"

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
                      float* sv, float* part, int64_t part_len, T* dx, float* dw1, float* dw2,
                      float* dw3, float* dsc, int64_t batch, int h, int w, int d, int c, int cb,
                      int cob_b, int cob_c, int wrap, cudaStream_t s) {
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
  err = contract<T, T, 1>(gt2, cb, a1, c, dw1, part, plen, nvox, h, w, d, wrap, s);
  if (err != cudaSuccess) return err;
  err = contract<T, T, 1>(gu3, c, a3, cb, dw3, part, plen, nvox, h, w, d, wrap, s);
  if (err != cudaSuccess) return err;
  err = contract<T, T, 27>(gt3, cb, a2, cb, dw2, part, plen, nvox, h, w, d, wrap, s);
  if (err != cudaSuccess) return err;
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
// (>= max(2^20, 27 Cb^2, C Cb) + 4Gb + 4Gc is always enough). Outputs (fp32):
// dw1 (Cb, C), dw2 (27, Cb_out, Cb_in) with tap = (kh * 3 + kw) * 3 + kd,
// dw3 (C, Cb), dsc (8,). dx must not alias gy or x.
extern "C" int vq_preact_block_bwd(int is_bf16, const void* x, const void* gy, const void* w1,
                                   const void* w2, const void* w3, const void* w1t,
                                   const void* w2t, const void* w3t, const void* sc, void* work,
                                   void* sv, void* part, int64_t part_len, void* dx, void* dw1,
                                   void* dw2, void* dw3, void* dsc, int64_t batch, int h, int w,
                                   int d, int c, int cb, int cob_b, int cob_c, int wrap,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* scf = static_cast<const float*>(sc);
  float* svf = static_cast<float*>(sv);
  float* pf = static_cast<float*>(part);
  float *d1 = static_cast<float*>(dw1), *d2 = static_cast<float*>(dw2),
        *d3 = static_cast<float*>(dw3), *ds = static_cast<float*>(dsc);
  if (is_bf16) {
    using T = __nv_bfloat16;
    return block_bwd<T>(static_cast<const T*>(x), static_cast<const T*>(gy),
                        static_cast<const T*>(w1), static_cast<const T*>(w2),
                        static_cast<const T*>(w3), static_cast<const T*>(w1t),
                        static_cast<const T*>(w2t), static_cast<const T*>(w3t), scf,
                        static_cast<T*>(work), svf, pf, part_len, static_cast<T*>(dx), d1, d2,
                        d3, ds, batch, h, w, d, c, cb, cob_b, cob_c, wrap, s);
  }
  using F = float;
  return block_bwd<F>(static_cast<const F*>(x), static_cast<const F*>(gy),
                      static_cast<const F*>(w1), static_cast<const F*>(w2),
                      static_cast<const F*>(w3), static_cast<const F*>(w1t),
                      static_cast<const F*>(w2t), static_cast<const F*>(w3t), scf,
                      static_cast<F*>(work), svf, pf, part_len, static_cast<F*>(dx), d1, d2, d3,
                      ds, batch, h, w, d, c, cb, cob_b, cob_c, wrap, s);
}
