// Kernel K4 backward: one mask-'B' block of PixelCNN's causal segment on the
// union stream, reverse sweep.
//
// Replaces the backward of vqvae3d_tpu/ops/causal_kernel.py:causal_stack_fused
// (_bwd_rule, its _bwd_kernel). The training forward saves every block's
// input x (causal_stack.cu computes it); for each block, last to first, this
// recomputes the block's forward from x and, from the cotangent g of the
// block output, produces dx (activation type T), the block's share of the
// condition's gradient added into gcond (type T, the JAX kernel's gcacc
// carry), and as fp32 sums over batch and voxels dW1e^T (Cb, Cu), dbe (Cb),
// dWU (18, Cb_out, Cb_in), dW3^T (Cu, Cb), dwc^T (Cb, Cc), dbc (Cb) and the
// 8 scalar grads (b1a, b1b, b2a, b2b, b3a, b3b, b4, scale).
// The forward (causal_stack.cu):
//   t1 = x + b1a;  a1 = elu(t1) + b1b
//   t2 = a1 W1e + be + b2a;  a2 = elu(t2) + b2b
//   c = union_conv(a2) [* keep / (1 - p)] + cond wc + bc;  t3 = c + b3a;  a3 = elu(t3) + b3b
//   y = (a3 W3) * scale + b4 + x
// and its reverse, elu'(t) = 1 for t > 0 else exp(t):
//   gu3 = g * scale;  ga3 = W3 gu3;  gt3 = ga3 * elu'(t3)
//   gm = gt3 [* keep / (1 - p)]   (the conv's output cotangent; the condition
//                                  adds after the dropout, so wc, bc and the
//                                  condition see gt3 unmasked)
//   gcond += wc gt3;  ga2 = union_conv^T(gm);  gt2 = ga2 * elu'(t2)
//   ga1 = W1e gt2;  gt1 = ga1 * elu'(t1);  dx = g + gt1
//   dW1e = sum a1 gt2^T, dbe = sum gt2, dWU[tap] = sum a2[v + tap] gm[v]^T,
//   dW3 = sum a3 gu3^T, dwc = sum cond gt3^T, dbc = sum gt3,
//   d_scale = sum g (a3 W3), d_b4 = sum g, d_b3b = sum ga3, d_b3a = sum gt3, ...
// The recompute rounds exactly as the forward kernel does; every gradient
// value is rounded to T where the PyTorch autograd of the plain block
// (ops/causal_kernel.py:causal_block_plain) rounds it, and gm stays fp32 as
// the autograd keeps the conv's fp32 output cotangent.
//
// The transposed causal conv reads gm at v - (tap - 1): at depth tap 0 that
// is one s0-row AHEAD, and the last row gets nothing from beyond the grid
// (vqc::tap_voxel with s = -1); the TPU kernel's carry row does the same.
//
// What bounds it on the H100: a block reads the saved x, g and the condition,
// reads and writes gcond and writes dx: 384 B a voxel in bf16 (201 MB a block
// at the top prior, 60 us at 3.35 TB/s), for ~3x the forward's products. This
// first version writes every intermediate to device memory and reduces on
// the CUDA cores in fp32, well above that bound.
//
// Design (simple first; speed is later work). Per block, six elementwise
// kernels, each thread one voxel and a group of COB output channels (as the
// forward), write the per-voxel intermediates to scratch:
//   pre:   x -> a1, t2, a2                            (Cb-wide groups)
//   mid:   a2, cond, g -> a3, gt3, gm (conv recompute) (Cb-wide groups)
//   post:  a3, g -> gu3                                (Cu-wide groups)
//   gcond: gt3 -> gcond += wc gt3                      (Cc-wide groups)
//   dgrad: gm, t2 -> gt2 (transposed conv)             (Cb-wide groups)
//   dx:    gt2, x, g -> dx                             (Cu-wide groups)
// each of mid, post, dgrad and dx also writing its per-(voxel, group) share
// of two scalar grads. The weight, bias and scalar gradients are then voxel
// contractions out[e] = sum_v A[v][p(e)] * B[v'(v, e)][q(e)], reduced
// deterministically in two passes (per-CTA partials over fixed voxel chunks,
// summed in a fixed order inside and across CTAs): no atomics, so the same
// inputs give bit-identical gradients, and the condition's gradient sums the
// blocks in one fixed order. dWU, the 18-tap contraction, has its own first
// pass (dwu_partial): a thread per (tap, out channel, 8 in channels) walks
// its CTA's voxels with one neighbour index a voxel (a thread per
// (out, in) pair walking all 18 taps computed 18 a voxel and left a third of
// its CTA idle; it took 5.6 ms of a top-prior block's 11.2). The transposed
// packs (w1t, wut, w3t, wct) come from the wrapper in the forward's
// [group][...][COB] layout.
#include "causal_union.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRed = 256;  // threads of a contraction CTA

__device__ __forceinline__ float elu_grad(float t) { return t > 0.f ? 1.f : expf(t); }

template <typename T, int COB>
__global__ void bwd_pre(const T* __restrict__ x, const T* __restrict__ w1,
                        const T* __restrict__ be, const float* __restrict__ sc,
                        T* __restrict__ a1, T* __restrict__ t2, T* __restrict__ a2, int64_t nvox,
                        int cu, int cb) {
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
    const float a = vq::rnd<T>(vq::rnd<T>(vq::elu(t)) + b1b);
    if (g == 0) a1[v * cu + ci] = vq::from_f<T>(a);
#pragma unroll
    for (int j = 0; j < COB; ++j) acc[j] = fmaf(a, vq::to_f<T>(wg[ci * COB + j]), acc[j]);
  }
#pragma unroll
  for (int j = 0; j < COB; ++j) {
    const int k = g * COB + j;
    if (k < cb) {
      const float e = vq::rnd<T>(vq::rnd<T>(acc[j]) + vq::to_f<T>(be[k]));
      const float u = vq::rnd<T>(e + b2a);
      t2[v * cb + k] = vq::from_f<T>(u);
      a2[v * cb + k] = vq::from_f<T>(vq::rnd<T>(vq::elu(u)) + b2b);
    }
  }
}

template <typename T, int COB>
__global__ void bwd_mid(const T* __restrict__ a2, const T* __restrict__ wu,
                        const float* __restrict__ keep, float denom, const T* __restrict__ cond,
                        const T* __restrict__ wc, const T* __restrict__ bc,
                        const T* __restrict__ w3t, const T* __restrict__ gy,
                        const float* __restrict__ sc, T* __restrict__ a3, T* __restrict__ gt3,
                        float* __restrict__ gm, float* __restrict__ sv, int nsv, int64_t nvox,
                        int s0, int s1, int s2, int cu, int cb, int cc) {
  const int64_t v = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (v >= nvox) return;
  const int g = blockIdx.y;
  const vqc::Vox p = vqc::decode(v, s0, s1, s2);
  float acc[COB];
  vqc::union_conv<T, COB>(a2, wu + static_cast<int64_t>(g) * vqc::kTaps * cb * COB, keep,
                          denom, cond,
                          cond == nullptr ? nullptr : wc + static_cast<int64_t>(g) * cc * COB,
                          bc, p, v, g, s0, s1, s2, cb, cc, acc);
  const float b3a = vq::rnd<T>(sc[4]), b3b = vq::rnd<T>(sc[5]), scale = vq::rnd<T>(sc[7]);
  float t3[COB], ga[COB];
#pragma unroll
  for (int j = 0; j < COB; ++j) {
    t3[j] = vq::rnd<T>(vq::rnd<T>(acc[j]) + b3a);
    ga[j] = 0.f;
  }
  // ga3 = W3 (g * scale): w3t is [G][Cu][COB]
  const T* gv = gy + v * cu;
  const T* wtg = w3t + static_cast<int64_t>(g) * cu * COB;
  for (int co = 0; co < cu; ++co) {
    const float gu = vq::rnd<T>(vq::to_f<T>(gv[co]) * scale);
#pragma unroll
    for (int j = 0; j < COB; ++j) ga[j] = fmaf(gu, vq::to_f<T>(wtg[co * COB + j]), ga[j]);
  }
  const float* kb = keep == nullptr ? nullptr : keep + p.b * cb;
  float s_ga = 0.f, s_gt = 0.f;
#pragma unroll
  for (int j = 0; j < COB; ++j) {
    const int k = g * COB + j;
    if (k < cb) {
      a3[v * cb + k] = vq::from_f<T>(vq::rnd<T>(vq::elu(t3[j])) + b3b);
      const float gak = vq::rnd<T>(ga[j]);
      const float gtk = vq::rnd<T>(gak * elu_grad(t3[j]));
      gt3[v * cb + k] = vq::from_f<T>(gtk);
      gm[v * cb + k] = kb == nullptr ? gtk : (kb[k] > 0.f ? gtk / denom : 0.f);
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
                         int64_t nvox, int cu, int cb) {
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
    if (co < cu) {
      const float gval = vq::to_f<T>(gy[v * cu + co]);
      gu3[v * cu + co] = vq::from_f<T>(gval * scale);
      s_g += gval;
      s_gu += gval * vq::rnd<T>(acc[j]);
    }
  }
  sv[v * nsv + off + 2 * g] = s_g;       // -> d_b4
  sv[v * nsv + off + 2 * g + 1] = s_gu;  // -> d_scale
}

template <typename T, int COB>
__global__ void bwd_gcond(const T* __restrict__ gt3, const T* __restrict__ wct,
                          T* __restrict__ gcond, int64_t nvox, int cb, int cc) {
  const int64_t v = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (v >= nvox) return;
  const int g = blockIdx.y;
  const T* gv = gt3 + v * cb;
  const T* wg = wct + static_cast<int64_t>(g) * cb * COB;  // [G][Cb][COB]
  float acc[COB];
#pragma unroll
  for (int j = 0; j < COB; ++j) acc[j] = 0.f;
  for (int k = 0; k < cb; ++k) {
    const float gval = vq::to_f<T>(gv[k]);
#pragma unroll
    for (int j = 0; j < COB; ++j) acc[j] = fmaf(gval, vq::to_f<T>(wg[k * COB + j]), acc[j]);
  }
#pragma unroll
  for (int j = 0; j < COB; ++j) {
    const int ci = g * COB + j;
    if (ci < cc) {
      T* dst = gcond + v * cc + ci;
      *dst = vq::from_f<T>(vq::to_f<T>(*dst) + vq::rnd<T>(acc[j]));
    }
  }
}

template <typename T, int COB>
__global__ void bwd_dgrad(const float* __restrict__ gm, const T* __restrict__ wut,
                          const T* __restrict__ t2, T* __restrict__ gt2, float* __restrict__ sv,
                          int nsv, int off, int64_t nvox, int s0, int s1, int s2, int cb) {
  const int64_t v = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (v >= nvox) return;
  const int g = blockIdx.y;
  const vqc::Vox p = vqc::decode(v, s0, s1, s2);
  // [G(in)][18][Cb(out)][COB]
  const T* wg = wut + static_cast<int64_t>(g) * vqc::kTaps * cb * COB;
  float acc[COB];
#pragma unroll
  for (int j = 0; j < COB; ++j) acc[j] = 0.f;
  for (int tap = 0; tap < vqc::kTaps; ++tap) {
    const int64_t q = vqc::tap_voxel(p, tap, -1, s0, s1, s2);
    if (q < 0) continue;
    const float* src = gm + q * cb;
    const T* wt = wg + tap * cb * COB;
    for (int o = 0; o < cb; ++o) {
      const float gval = src[o];
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
                       int nsv, int off, int64_t nvox, int cu, int cb) {
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
    if (ci < cu) {
      const float gai = vq::rnd<T>(acc[j]);
      const float t1 = vq::rnd<T>(vq::to_f<T>(x[v * cu + ci]) + b1a);
      const float gti = vq::rnd<T>(gai * elu_grad(t1));
      dx[v * cu + ci] = vq::from_f<T>(vq::to_f<T>(gy[v * cu + ci]) + gti);
      s_ga += gai;
      s_gt += gti;
    }
  }
  sv[v * nsv + off + 2 * g] = s_ga;      // -> d_b1b
  sv[v * nsv + off + 2 * g + 1] = s_gt;  // -> d_b1a
}

// Pass 1 of a voxel contraction out[p][q] = sum_v A[v][p] * B[v][q]
// (B == nullptr reads B as 1). CTA (chunk, tile) sums voxels
// [chunk * len, (chunk + 1) * len) for the (p, q) pairs
// [tile * et, tile * et + et), each thread one pair. With fewer than 256
// pairs, sl = tid / et lanes split the chunk's voxels (lane sl takes v0 + sl,
// v0 + sl + lanes, ...) and are summed in lane order.
template <typename TA, typename TB>
__global__ void contract_partial(const TA* __restrict__ A, int P, const TB* __restrict__ B,
                                 int Q, float* __restrict__ part, int64_t nvox, int64_t len,
                                 int et) {
  __shared__ float red[kRed];
  const int pairs = P * Q;
  const int tid = threadIdx.x;
  const int lanes = kRed / et;
  const int el = tid % et, sl = tid / et;
  const int e = blockIdx.y * et + el;
  float acc = 0.f;
  if (sl < lanes && e < pairs) {
    const int pi = e / Q, qi = e % Q;
    const int64_t v0 = static_cast<int64_t>(blockIdx.x) * len;
    const int64_t v1 = v0 + len < nvox ? v0 + len : nvox;
    for (int64_t v = v0 + sl; v < v1; v += lanes) {
      const float a = vq::to_f<TA>(A[v * P + pi]);
      acc = B == nullptr ? acc + a : fmaf(a, vq::to_f<TB>(B[v * Q + qi]), acc);
    }
  }
  red[tid] = acc;
  __syncthreads();
  if (sl == 0 && e < pairs) {
    float s = 0.f;
    for (int r = 0; r < lanes; ++r) s += red[r * et + el];
    part[static_cast<int64_t>(blockIdx.x) * pairs + e] = s;
  }
}

// Pass 1 of dWU[tap][o][i] = sum_v gm[v][o] * a2[v + tap][i], the union
// conv's weight gradient (zero outside the grid): thread e of CTA (chunk,
// tile) owns (tap, o, input channels 8 ig .. 8 ig + 7), e = (tap * Cb + o)
// * gi + ig, and sums the chunk's voxels in order into 8 accumulators.
template <typename TB>
__global__ void dwu_partial(const float* __restrict__ gm, const TB* __restrict__ a2,
                            float* __restrict__ part, int64_t nvox, int64_t len, int cb, int s0,
                            int s1, int s2) {
  const int gi = (cb + 7) / 8;
  const int e = blockIdx.y * blockDim.x + threadIdx.x;
  if (e >= vqc::kTaps * cb * gi) return;
  const int ig = e % gi, o = (e / gi) % cb, tap = e / (gi * cb);
  const int n = cb - 8 * ig < 8 ? cb - 8 * ig : 8;
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const int64_t v0 = static_cast<int64_t>(blockIdx.x) * len;
  const int64_t v1 = v0 + len < nvox ? v0 + len : nvox;
  for (int64_t v = v0; v < v1; ++v) {
    const int64_t vb = vqc::tap_voxel(vqc::decode(v, s0, s1, s2), tap, 1, s0, s1, s2);
    if (vb < 0) continue;
    const float a = gm[v * cb + o];
    const TB* src = a2 + vb * cb + 8 * ig;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (j < n) acc[j] = fmaf(a, vq::to_f<TB>(src[j]), acc[j]);
  }
  float* out = part + static_cast<int64_t>(blockIdx.x) * vqc::kTaps * cb * cb +
               (static_cast<int64_t>(tap) * cb + o) * cb + 8 * ig;
  for (int j = 0; j < n; ++j) out[j] = acc[j];
}

// Pass 2: out[e] = the sum over chunks of part[chunk][e] in a fixed order:
// lane y of a 32 x 8 CTA sums chunks y, y + 8, ..., then lanes 0..7 add up.
__global__ void contract_reduce(const float* __restrict__ part, float* __restrict__ out,
                                int64_t nchunks, int E) {
  __shared__ float red[8][33];
  const int e = blockIdx.x * 32 + threadIdx.x;
  float s = 0.f;
  if (e < E)
    for (int64_t ch = threadIdx.y; ch < nchunks; ch += 8) s += part[ch * E + e];
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && e < E) {
    float t = 0.f;
    for (int y = 0; y < 8; ++y) t += red[y][threadIdx.x];
    out[e] = t;
  }
}

// The chunk count of a contraction with E outputs: a function of the shapes
// only (at most 2048 chunks of at least `min_len` voxels, and at most
// part_len floats of partials), so the summation order is fixed.
inline int64_t chunks_for(int64_t nvox, int64_t E, int64_t part_len, int min_len) {
  int64_t n = (nvox + min_len - 1) / min_len;
  if (n > 2048) n = 2048;
  if (n > part_len / E) n = part_len / E;
  return n < 1 ? 1 : n;
}

inline cudaError_t reduce_chunks(const float* part, float* out, int64_t nchunks, int64_t E,
                                 cudaStream_t s) {
  contract_reduce<<<static_cast<unsigned>((E + 31) / 32), dim3(32, 8), 0, s>>>(
      part, out, nchunks, static_cast<int>(E));
  return cudaGetLastError();
}

// Both passes of a contraction into out (P * Q floats).
template <typename TA, typename TB>
cudaError_t contract(const TA* A, int P, const TB* B, int Q, float* out, float* part,
                     int64_t part_len, int64_t nvox, cudaStream_t s) {
  const int pairs = P * Q;
  const int et = pairs < kRed ? pairs : kRed;
  const int tiles = (pairs + kRed - 1) / kRed;
  const int64_t nchunks = chunks_for(nvox, pairs, part_len, kRed);
  if (nchunks * pairs > part_len) return cudaErrorInvalidValue;
  const int64_t len = (nvox + nchunks - 1) / nchunks;
  contract_partial<TA, TB><<<dim3(static_cast<unsigned>(nchunks), tiles), kRed, 0, s>>>(
      A, P, B, Q, part, nvox, len, et);
  return reduce_chunks(part, out, nchunks, pairs, s);
}

// Both passes of dWU into out (18 * Cb * Cb floats).
template <typename TB>
cudaError_t contract_dwu(const float* gm, const TB* a2, int cb, float* out, float* part,
                         int64_t part_len, int64_t nvox, int s0, int s1, int s2, cudaStream_t s) {
  const int64_t E = static_cast<int64_t>(vqc::kTaps) * cb * cb;
  const int threads = vqc::kTaps * cb * ((cb + 7) / 8);
  const int64_t nchunks = chunks_for(nvox, E, part_len, 128);
  if (nchunks * E > part_len) return cudaErrorInvalidValue;
  const int64_t len = (nvox + nchunks - 1) / nchunks;
  dwu_partial<TB><<<dim3(static_cast<unsigned>(nchunks), (threads + kRed - 1) / kRed), kRed, 0,
                    s>>>(gm, a2, part, nvox, len, cb, s0, s1, s2);
  return reduce_chunks(part, out, nchunks, E, s);
}

// The scalar sums, per (kernel, group) pair, -> the block's 8 scalar grads.
__global__ void scalars_kernel(const float* __restrict__ s, float* __restrict__ dsc, int gb,
                               int gu) {
  float r[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const int mid = 0, post = 2 * gb, dgrad = 2 * gb + 2 * gu, dxo = 4 * gb + 2 * gu;
  for (int g = 0; g < gb; ++g) {
    r[5] += s[mid + 2 * g];        // b3b
    r[4] += s[mid + 2 * g + 1];    // b3a
    r[3] += s[dgrad + 2 * g];      // b2b
    r[2] += s[dgrad + 2 * g + 1];  // b2a
  }
  for (int g = 0; g < gu; ++g) {
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

template <typename T>
cudaError_t block_bwd(const T* x, const T* gy, const T* cond, const float* keep, float denom,
                      const T* w1, const T* be, const T* wu, const T* w3, const T* wc,
                      const T* bc, const float* sc, const T* w1t, const T* wut, const T* w3t,
                      const T* wct, T* work, float* gm, float* sv, float* part, int64_t part_len,
                      T* dx, T* gcond, float* dw1, float* dbe, float* dwu, float* dw3, float* dwc,
                      float* dbc, float* dsc, int64_t batch, int s0, int s1, int s2, int cu,
                      int cb, int cc, int cob_b, int cob_u, int cob_c, cudaStream_t s) {
  const int64_t nvox = batch * s0 * s1 * static_cast<int64_t>(s2);
  if (nvox == 0) return cudaErrorInvalidValue;
  const bool has_cond = cond != nullptr;
  if (has_cond != (wc != nullptr && bc != nullptr && wct != nullptr && gcond != nullptr &&
                   cc > 0))
    return cudaErrorInvalidValue;
  T* a1 = work;
  T* t2 = a1 + nvox * cu;
  T* a2 = t2 + nvox * cb;
  T* a3 = a2 + nvox * cb;
  T* gt3 = a3 + nvox * cb;
  T* gu3 = gt3 + nvox * cb;
  T* gt2 = gu3 + nvox * cu;
  const int gb = groups_of(cb, cob_b), gu = groups_of(cu, cob_u);
  const int nsv = 4 * gb + 4 * gu;  // scalar shares per voxel: mid, post, dgrad, dx
  if (part_len <= nsv) return cudaErrorInvalidValue;
  const dim3 grb = grid_for(nvox, gb), gru = grid_for(nvox, gu);
  VQ_COB_DISPATCH(cob_b, bwd_pre, T,
                  <<<grb, kThreads, 0, s>>>(x, w1, be, sc, a1, t2, a2, nvox, cu, cb))
  VQ_COB_DISPATCH(cob_b, bwd_mid, T,
                  <<<grb, kThreads, 0, s>>>(a2, wu, keep, denom, cond, wc, bc, w3t, gy, sc, a3,
                                            gt3, gm, sv, nsv, nvox, s0, s1, s2, cu, cb, cc))
  VQ_COB_DISPATCH(cob_u, bwd_post, T,
                  <<<gru, kThreads, 0, s>>>(a3, w3, gy, sc, gu3, sv, nsv, 2 * gb, nvox, cu, cb))
  if (has_cond) {
    VQ_COB_DISPATCH(cob_c, bwd_gcond, T,
                    <<<grid_for(nvox, groups_of(cc, cob_c)), kThreads, 0, s>>>(gt3, wct, gcond,
                                                                               nvox, cb, cc))
  }
  VQ_COB_DISPATCH(cob_b, bwd_dgrad, T,
                  <<<grb, kThreads, 0, s>>>(gm, wut, t2, gt2, sv, nsv, 2 * gb + 2 * gu, nvox, s0,
                                            s1, s2, cb))
  VQ_COB_DISPATCH(cob_u, bwd_dx, T,
                  <<<gru, kThreads, 0, s>>>(x, gy, gt2, w1t, sc, dx, sv, nsv, 4 * gb + 2 * gu,
                                            nvox, cu, cb))
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t plen = part_len - nsv;  // the last nsv floats hold the scalar sums
  float* ssum = part + plen;
  const float* none = nullptr;
  err = contract<T, T>(gt2, cb, a1, cu, dw1, part, plen, nvox, s);
  if (err != cudaSuccess) return err;
  err = contract<T, float>(gt2, cb, none, 1, dbe, part, plen, nvox, s);
  if (err != cudaSuccess) return err;
  err = contract<T, T>(gu3, cu, a3, cb, dw3, part, plen, nvox, s);
  if (err != cudaSuccess) return err;
  err = contract_dwu<T>(gm, a2, cb, dwu, part, plen, nvox, s0, s1, s2, s);
  if (err != cudaSuccess) return err;
  if (has_cond) {
    err = contract<T, T>(gt3, cb, cond, cc, dwc, part, plen, nvox, s);
    if (err != cudaSuccess) return err;
    err = contract<T, float>(gt3, cb, none, 1, dbc, part, plen, nvox, s);
    if (err != cudaSuccess) return err;
  }
  err = contract<float, float>(sv, nsv, none, 1, ssum, part, plen, nvox, s);
  if (err != cudaSuccess) return err;
  scalars_kernel<<<1, 1, 0, s>>>(ssum, dsc, gb, gu);
  return cudaGetLastError();
}

}  // namespace

// One block's backward. x (the block's saved input), gy (the cotangent of its
// output) and dx are (B, s0, s1, s2, Cu) contiguous, cond and gcond
// (B, s0, s1, s2, Cc) or null, all bf16 when is_bf16 else fp32, as are the
// packed weights: forward packs w1 [Gb][Cu][cob_b], wu [Gb][18][Cb][cob_b],
// w3 [Gu][Cb][cob_u], wc [Gb][Cc][cob_b], biases be, bc (Cb); transposed packs
// w1t [Gu][Cb][cob_u] (W1e^T), wut [Gb][18][Cb][cob_b] (input-channel groups,
// inner over output channels), w3t [Gb][Cu][cob_b] (W3^T), wct [Gc][Cb][cob_c]
// (wc^T). keep (B, Cb) fp32 0/1 or null; denom = 1 - p. sc holds the block's
// 8 fp32 scalars. work is scratch of nvox * (2 Cu + 5 Cb) elements of the
// activation type, gm nvox * Cb floats, sv nvox * (4 Gb + 4 Gu) floats, part
// part_len floats (>= 2048 * max(18 Cb^2, Cu Cb, Cc Cb, 4 Gb + 4 Gu) + 4 Gb + 4 Gu
// gives every contraction its 2048 chunks; any length of at least one chunk
// works). gcond accumulates: this block's share is added to what it holds.
// Outputs (fp32): dw1 (Cb, Cu), dbe (Cb), dwu (18, Cb_out, Cb_in) with
// tap = (j0 * 3 + j1) * 3 + j2, dw3 (Cu, Cb), dwc (Cb, Cc) and dbc (Cb) (left
// untouched without a condition), dsc (8,). dx must not alias gy or x.
extern "C" int vq_causal_block_bwd(
    int is_bf16, const void* x, const void* gy, const void* cond, const void* keep, float denom,
    const void* w1, const void* be, const void* wu, const void* w3, const void* wc,
    const void* bc, const void* sc, const void* w1t, const void* wut, const void* w3t,
    const void* wct, void* work, void* gm, void* sv, void* part, int64_t part_len, void* dx,
    void* gcond, void* dw1, void* dbe, void* dwu, void* dw3, void* dwc, void* dbc, void* dsc,
    int64_t batch, int s0, int s1, int s2, int cu, int cb, int cc, int cob_b, int cob_u,
    int cob_c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* scf = static_cast<const float*>(sc);
  const float* kp = static_cast<const float*>(keep);
  float *gmf = static_cast<float*>(gm), *svf = static_cast<float*>(sv),
        *pf = static_cast<float*>(part);
  float *d1 = static_cast<float*>(dw1), *dbe_ = static_cast<float*>(dbe),
        *du = static_cast<float*>(dwu), *d3 = static_cast<float*>(dw3),
        *dc = static_cast<float*>(dwc), *dbc_ = static_cast<float*>(dbc),
        *ds = static_cast<float*>(dsc);
  if (is_bf16) {
    using T = __nv_bfloat16;
    return block_bwd<T>(
        static_cast<const T*>(x), static_cast<const T*>(gy), static_cast<const T*>(cond), kp,
        denom, static_cast<const T*>(w1), static_cast<const T*>(be), static_cast<const T*>(wu),
        static_cast<const T*>(w3), static_cast<const T*>(wc), static_cast<const T*>(bc), scf,
        static_cast<const T*>(w1t), static_cast<const T*>(wut), static_cast<const T*>(w3t),
        static_cast<const T*>(wct), static_cast<T*>(work), gmf, svf, pf, part_len,
        static_cast<T*>(dx), static_cast<T*>(gcond), d1, dbe_, du, d3, dc, dbc_, ds, batch, s0,
        s1, s2, cu, cb, cc, cob_b, cob_u, cob_c, s);
  }
  using F = float;
  return block_bwd<F>(
      static_cast<const F*>(x), static_cast<const F*>(gy), static_cast<const F*>(cond), kp,
      denom, static_cast<const F*>(w1), static_cast<const F*>(be), static_cast<const F*>(wu),
      static_cast<const F*>(w3), static_cast<const F*>(wc), static_cast<const F*>(bc), scf,
      static_cast<const F*>(w1t), static_cast<const F*>(wut), static_cast<const F*>(w3t),
      static_cast<const F*>(wct), static_cast<F*>(work), gmf, svf, pf, part_len,
      static_cast<F*>(dx), static_cast<F*>(gcond), d1, dbe_, du, d3, dc, dbc_, ds, batch, s0, s1,
      s2, cu, cb, cc, cob_b, cob_u, cob_c, s);
}
