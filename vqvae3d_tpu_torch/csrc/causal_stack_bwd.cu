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
// at the top prior, 60 us at 3.35 TB/s), for ~3x the forward's products. The
// CUDA-core route below (fp32, and bf16 at widths the tensor-core route at
// the end of this file does not take) writes every intermediate to device
// memory and reduces on the CUDA cores in fp32, well above that bound.
//
// The CUDA-core route (the first design). Per block, six elementwise
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
#include "causal_tc.cuh"

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

// ---- bf16: the tensor-core route (ops/conv3d.py causal_bwd_tensor_core_route)
//
// Three kernels a block and two reduce passes, every product on mma.sync
// m16n8k16 (bf16 in, fp32 accumulate), no activation-sized intermediate but
// a2 and the conv's cotangent gm in device memory:
//   tc_pre:   x -> a2 (bf16, Cb padded to 16)                    flat tiles
//   tc_mid:   a2 (halo), g, cond -> the conv recomputed, a3, gu3, gt3 and
//             gm (as bf16 hi + lo halves: gm = hi + lo to 2^-16, so the
//             products that read it keep fp32's precision), gcond += wc gt3;
//             per CTA, dWU, dW3, dwc, dbc and the b3a, b3b, b4, scale sums
//   tc_dgrad: gm (halo one s0-row ahead), x, g -> the transposed conv, t2
//             recomputed, gt2, ga1, dx; per CTA, dW1e, dbe and the b1a, b1b,
//             b2a, b2b sums
//   reduce:   the CTAs' partials summed in CTA order (fixed: a function of
//             the shapes), then scattered into the outputs.
// A CTA (8 warps, persistent over bricks blockIdx.x, + gridDim.x, ...) owns
// a brick of 128 voxels (bs0 x bs1 x bs2, ops/causal_kernel.py bwd_plan), its
// one-voxel halo staged into shared memory with the causal zero pads: the
// forward conv reads s0 rows i0 - 1 and i0 (halo origin (i0 - 1, i1 - 1,
// i2 - 1)), the transposed conv rows i0 and i0 + 1 (origin (i0, i1 - 1,
// i2 - 1)), both s1 and s2 - 1 .. + 1. Warp w owns brick rows 16 w .. 16 w +
// 15 (M of the voxel products); the weight gradients are products with K
// over the brick's voxels (A and B by ldmatrix.trans of the voxel tiles),
// flushed per brick into fp32 registers (as contract_tc), then per CTA into
// its partial: no atomics, so two calls are bit-identical. Rounding is the
// CUDA-core route's (the plain autograd's): every rounding point above is
// kept; only the order of the fp32 sums differs.
namespace tc {

// the A fragment of channels c0 .. c0 + 15 over voxels v0 .. v0 + 15 of a
// (voxels x channels) tile: the transposed tile, for a product with K over voxels
__device__ __forceinline__ void lda_t(uint32_t (&a)[4], const bf16* s, int stride, int v0,
                                      int c0, int lane) {
  vq::ldsm_x4_t(a, vq::smem_u32(s + (v0 + (lane & 7) + 8 * (lane >> 4)) * stride + c0 +
                                8 * ((lane >> 3) & 1)));
}

// the B fragments of two n-blocks (channels c0 .. c0 + 15) over the 16
// voxels whose shared rows the lanes name: row(i) for voxel i of the line
__device__ __forceinline__ void ldb_t(uint32_t (&b)[4], const bf16* s, int stride, int row,
                                      int c0, int lane) {
  vq::ldsm_x4_t(b, vq::smem_u32(s + row * stride + c0 + 8 * (lane >> 4)));
}

// m[r0 + row][c0 + col] += the C fragment a (16 x 8 at (r0, c0)) of this lane:
// each element has one owner, so the per-CTA sums in shared memory need no atomics
__device__ __forceinline__ void frag_add(float* m, int stride, int r0, int c0,
                                         const float (&a)[4], int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int e = 0; e < 4; ++e) m[(r0 + g + 8 * (e >> 1)) * stride + c0 + 2 * t + (e & 1)] += a[e];
}

// the sum of v over the 8 lanes of a warp that share lane % 4, in a fixed order
__device__ __forceinline__ float colsum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

template <int CUP>
__global__ void __launch_bounds__(kThr)
    tc_pre(const bf16* __restrict__ x, const bf16* __restrict__ w1e, const bf16* __restrict__ be,
           const float* __restrict__ sc, bf16* __restrict__ a2, int64_t nvox, int cu, int cb) {
  __shared__ __align__(16) bf16 a1s[kVox * (CUP + 8)];
  pre_tile<CUP>(a1s, x, w1e, be, sc, a2, nvox, cu, cb);
}

// Partial layout of tc_mid: dWU [18][Cb][Cb] (tap, out, in), dW3^T [Cu][Cb],
// dwc^T [Cb][Cc], dbc [Cb], then b3a, b3b, b4, scale.
__host__ __device__ inline int mid_len(int cu, int cb, int cc) {
  return vqc::kTaps * cb * cb + cu * cb + cb * cc + (cc > 0 ? cb : 0) + 4;
}

template <int CUP, int CCP>
__global__ void __launch_bounds__(kThr, 2)
    tc_mid(const bf16* __restrict__ a2, const bf16* __restrict__ gy, const bf16* __restrict__ cond,
           const float* __restrict__ keep, float denom, const bf16* __restrict__ wuf,
           const bf16* __restrict__ wct, const bf16* __restrict__ bc,
           const bf16* __restrict__ w3, const bf16* __restrict__ w3t,
           const bf16* __restrict__ wcn, const float* __restrict__ sc, bf16* __restrict__ gmh,
           bf16* __restrict__ gml, bf16* __restrict__ gcond, float* __restrict__ part,
           int64_t nbricks, int s0, int s1, int s2, int cu, int cb, int cc, int n0, int n1,
           int n2) {
  constexpr int GS = CUP + 8, CS = CCP + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int nh = (n0 + 1) * (n1 + 2) * (n2 + 2);
  bf16* halo = reinterpret_cast<bf16*>(smem);  // [nh][BS] a2
  bf16* gs = halo + nh * BS;                    // [kVox][GS] g
  bf16* gus = gs + kVox * GS;                   // [kVox][GS] gu3 = g * scale
  bf16* cs = gus + kVox * GS;                   // [kVox][CS] cond
  bf16* a3s = cs + kVox * CS;                   // [kVox][BS] a3, gt3, gm's halves
  bf16* gt3s = a3s + kVox * BS;
  bf16* ghs = gt3s + kVox * BS;
  bf16* gls = ghs + kVox * BS;
  float* red = reinterpret_cast<float*>(gls + kVox * BS);  // [kWarps][CBP + 4]
  float* su = red + kWarps * (CBP + 4);  // the CTA's sums: dWU [18][16][16] (tap, out, in),
  float* s3 = su + vqc::kTaps * CBP * CBP;  //   dW3^T [CUP][16],
  float* scw = s3 + CUP * CBP;              //   dwc^T [16][CCP]
  for (int e = threadIdx.x; e < vqc::kTaps * CBP * CBP + CUP * CBP + CBP * CCP; e += kThr)
    su[e] = 0.f;
  const Sc s(sc);
  const bool has_cond = cond != nullptr;
  const float b3a = s.b3a, b3b = s.b3b;
  const auto gu3 = [&](float v) { return v * s.scale; };
  // per-thread sums over the CTA's bricks: b3a, b3b, b4, scale; dbc's 4 channels
  float ssum[4] = {}, dbc_s[4] = {};
  const int m0 = 16 * warp;
  for (int64_t bi = blockIdx.x; bi < nbricks; bi += gridDim.x) {
    const UBrick k = ubrick(bi, s0, s1, s2, n0, n1, n2);
    stage(halo, BS, a2, CBP, CBP, nh, [&](int r) { return halo_voxel(k, r, -1, s0, s1, s2); });
    stage(gs, GS, gy, cu, CUP, kVox, [&](int r) { return row_voxel(k, r, s0, s1, s2); },
          [&](int r, int c0, int64_t v, uint4 row) {  // gu3 = g * scale beside g
            *reinterpret_cast<uint4*>(gus + r * GS + c0) = map8(row, c0, cu, v >= 0, gu3);
          });
    if (has_cond)
      stage(cs, CS, cond, cc, CCP, kVox, [&](int r) { return row_voxel(k, r, s0, s1, s2); });
    __syncthreads();

    // the conv recomputed, the dropout, the condition: c, t3 (the forward's tile)
    const int64_t vr[2] = {row_voxel(k, m0 + g, s0, s1, s2), row_voxel(k, m0 + g + 8, s0, s1, s2)};
    float t3[2][4];
    union_t3<CCP>(t3, halo, cs, k, m0, wuf, wct, bc, keep, denom, has_cond, cb, b3a, lane);
    // ga3 = W3 gu3, gt3, gm
    float ga[2][4] = {};
#pragma unroll
    for (int k0 = 0; k0 < CUP; k0 += 16) {
      uint32_t a[4];
      lda(a, gus, GS, m0, k0, lane);
      vqb::mma_row<2>(ga, a, w3, CUP, k0, lane);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = m0 + g + 8 * half;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        float a3v[2], gtv[2], hv[2], lv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = nt * 8 + 2 * t + e;
          const bool ok = vr[half] >= 0 && n < cb;
          const float tt = t3[nt][2 * half + e];
          const float gak = vq::rnd<bf16>(ga[nt][2 * half + e]);
          const float gtk = ok ? vq::rnd<bf16>(gak * elu_grad(tt)) : 0.f;
          a3v[e] = ok ? vq::rnd<bf16>(vq::rnd<bf16>(vq::elu(tt)) + b3b) : 0.f;
          gtv[e] = gtk;
          const float gmv = keep == nullptr ? gtk : (keep[k.b * cb + n] > 0.f ? gtk / denom : 0.f);
          hv[e] = ok ? vq::rnd<bf16>(gmv) : 0.f;
          lv[e] = ok ? gmv - hv[e] : 0.f;
          if (ok) {
            ssum[0] += gtk;
            ssum[1] += gak;
            dbc_s[nt * 2 + e] += gtk;
          }
        }
        const int n = nt * 8 + 2 * t;
        *reinterpret_cast<uint32_t*>(a3s + r * BS + n) = vq::pack_bf16(a3v[0], a3v[1]);
        *reinterpret_cast<uint32_t*>(gt3s + r * BS + n) = vq::pack_bf16(gtv[0], gtv[1]);
        const uint32_t ph = vq::pack_bf16(hv[0], hv[1]), pl = vq::pack_bf16(lv[0], lv[1]);
        *reinterpret_cast<uint32_t*>(ghs + r * BS + n) = ph;
        *reinterpret_cast<uint32_t*>(gls + r * BS + n) = pl;
        if (vr[half] >= 0) {
          *reinterpret_cast<uint32_t*>(gmh + vr[half] * CBP + n) = ph;
          *reinterpret_cast<uint32_t*>(gml + vr[half] * CBP + n) = pl;
        }
      }
    }
    __syncwarp();
    // d_scale = sum g (a3 W3), d_b4 = sum g
    {
      constexpr int NU = CUP / 8;
      float p[NU][4] = {};
      uint32_t a[4];
      lda(a, a3s, BS, m0, 0, lane);
      vqb::mma_row<NU>(p, a, w3t, CBP, 0, lane);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        if (vr[half] < 0) continue;
        const int r = m0 + g + 8 * half;
#pragma unroll
        for (int nt = 0; nt < NU; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int co = nt * 8 + 2 * t + e;
            if (co >= cu) continue;
            const float gv = vq::to_f<bf16>(gs[r * GS + co]);
            ssum[2] += gv;
            ssum[3] += gv * vq::rnd<bf16>(p[nt][2 * half + e]);
          }
      }
    }
    // gcond += wc gt3
    if (has_cond) {
      constexpr int NC = CCP / 8;
      float p[NC][4] = {};
      uint32_t a[4];
      lda(a, gt3s, BS, m0, 0, lane);
      vqb::mma_row<NC>(p, a, wcn, CBP, 0, lane);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        if (vr[half] < 0) continue;
#pragma unroll
        for (int nt = 0; nt < NC; ++nt) {
          const int ci = nt * 8 + 2 * t;
          bf16* dst = gcond + vr[half] * cc + ci;
          if (cc % 2 == 0 && ci < cc) {  // the pair (ci, ci + 1) as one 32-bit access
            __nv_bfloat162 old2 = *reinterpret_cast<__nv_bfloat162*>(dst);
            *reinterpret_cast<uint32_t*>(dst) = vq::pack_bf16(
                __low2float(old2) + vq::rnd<bf16>(p[nt][2 * half]),
                __high2float(old2) + vq::rnd<bf16>(p[nt][2 * half + 1]));
            continue;
          }
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (ci + e >= cc) continue;
            dst[e] = vq::from_f<bf16>(vq::to_f<bf16>(dst[e]) + vq::rnd<bf16>(p[nt][2 * half + e]));
          }
        }
      }
    }
    __syncthreads();

    // the weight gradients over the brick's voxels
    {  // dWU[tap][o][i] = sum gm[v][o] a2[v + tap][i]: taps warp, warp + 8, warp + 16
      float au[3][2][4] = {};
      for (int line = 0; line < kVox / 16; ++line) {
        uint32_t ah[4], al[4];
        lda_t(ah, ghs, BS, 16 * line, 0, lane);
        lda_t(al, gls, BS, 16 * line, 0, lane);
        const int base = halo_base(k, 16 * line + (lane & 7) + 8 * ((lane >> 3) & 1));
#pragma unroll
        for (int ti = 0; ti < 3; ++ti) {
          const int tap = warp + 8 * ti;
          if (tap >= vqc::kTaps) break;
          uint32_t b[4];
          ldb_t(b, halo, BS, base + fwd_off(k, tap), 0, lane);
          vq::mma_16816(au[ti][0], ah, b[0], b[1]);
          vq::mma_16816(au[ti][0], al, b[0], b[1]);
          vq::mma_16816(au[ti][1], ah, b[2], b[3]);
          vq::mma_16816(au[ti][1], al, b[2], b[3]);
        }
      }
#pragma unroll
      for (int ti = 0; ti < 3; ++ti) {  // the per-brick flush into the CTA's sums
        const int tap = warp + 8 * ti;
        if (tap >= vqc::kTaps) break;
        frag_add(su + tap * CBP * CBP, CBP, 0, 0, au[ti][0], lane);
        frag_add(su + tap * CBP * CBP, CBP, 0, 8, au[ti][1], lane);
      }
    }
    if (warp < CUP / 16) {  // dW3^T[co][k] = sum gu3[v][co] a3[v][k]: co in 16 warp ..
      float a3c[2][4] = {};
      for (int line = 0; line < kVox / 16; ++line) {
        uint32_t a[4], b[4];
        lda_t(a, gus, GS, 16 * line, 16 * warp, lane);
        ldb_t(b, a3s, BS, 16 * line + (lane & 7) + 8 * ((lane >> 3) & 1), 0, lane);
        vq::mma_16816(a3c[0], a, b[0], b[1]);
        vq::mma_16816(a3c[1], a, b[2], b[3]);
      }
      frag_add(s3, CBP, 16 * warp, 0, a3c[0], lane);
      frag_add(s3, CBP, 16 * warp, 8, a3c[1], lane);
    } else if (has_cond && warp >= 4 && warp - 4 < CCP / 16) {  // dwc^T[k][ci] = sum gt3[v][k] cond[v][ci]
      float acc_c[2][4] = {};
      for (int line = 0; line < kVox / 16; ++line) {
        uint32_t a[4], b[4];
        lda_t(a, gt3s, BS, 16 * line, 0, lane);
        ldb_t(b, cs, CS, 16 * line + (lane & 7) + 8 * ((lane >> 3) & 1), 16 * (warp - 4), lane);
        vq::mma_16816(acc_c[0], a, b[0], b[1]);
        vq::mma_16816(acc_c[1], a, b[2], b[3]);
      }
      frag_add(scw, CCP, 0, 16 * (warp - 4), acc_c[0], lane);
      frag_add(scw, CCP, 0, 16 * (warp - 4) + 8, acc_c[1], lane);
    }
    __syncthreads();  // the tiles are refilled for the next brick
  }

  // this CTA's partial
  float* out = part + static_cast<int64_t>(blockIdx.x) * mid_len(cu, cb, cc);
  float* o3 = out + vqc::kTaps * cb * cb;
  float* oc = o3 + cu * cb;
  float* obc = oc + cb * cc;
  for (int e = threadIdx.x; e < vqc::kTaps * cb * cb; e += kThr) {
    const int tap = e / (cb * cb), o = e / cb % cb, i = e % cb;
    out[e] = su[(tap * CBP + o) * CBP + i];
  }
  for (int e = threadIdx.x; e < cu * cb; e += kThr) o3[e] = s3[(e / cb) * CBP + e % cb];
  for (int e = threadIdx.x; e < cb * cc; e += kThr) oc[e] = scw[(e / cc) * CCP + e % cc];
  // dbc and the scalar sums: lanes -> warp (fixed xor order) -> CTA (warp order)
#pragma unroll
  for (int j = 0; j < 4; ++j) dbc_s[j] = colsum(dbc_s[j]);
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) ssum[j] += __shfl_xor_sync(0xffffffffu, ssum[j], off);
  if (lane < 4) {
#pragma unroll
    for (int j = 0; j < 4; ++j) red[warp * (CBP + 4) + (j >> 1) * 8 + 2 * lane + (j & 1)] = dbc_s[j];
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) red[warp * (CBP + 4) + CBP + j] = ssum[j];
  }
  __syncthreads();
  if (threadIdx.x < CBP + 4) {
    const int j = threadIdx.x;
    float v = 0.f;
    for (int w = 0; w < kWarps; ++w) v += red[w * (CBP + 4) + j];
    if (j < CBP) {
      if (has_cond && j < cb) obc[j] = v;
    } else {
      obc[(has_cond ? cb : 0) + j - CBP] = v;
    }
  }
}

// Partial layout of tc_dgrad: dW1e^T [Cb][Cu], dbe [Cb], then b1a, b1b, b2a, b2b.
__host__ __device__ inline int dgrad_len(int cu, int cb) { return cb * cu + cb + 4; }

template <int CUP>
__global__ void __launch_bounds__(kThr, 3)
    tc_dgrad(const bf16* __restrict__ x, const bf16* __restrict__ gy,
             const bf16* __restrict__ gmh, const bf16* __restrict__ gml,
             const bf16* __restrict__ w1e, const bf16* __restrict__ be,
             const bf16* __restrict__ wut, const bf16* __restrict__ w1n,
             const float* __restrict__ sc, bf16* __restrict__ dx, float* __restrict__ part,
             int64_t nbricks, int s0, int s1, int s2, int cu, int cb, int n0, int n1, int n2) {
  constexpr int XS = CUP + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int nh = (n0 + 1) * (n1 + 2) * (n2 + 2);
  bf16* hh = reinterpret_cast<bf16*>(smem);  // [nh][BS] gm's hi half, one s0-row ahead
  bf16* hl = hh + nh * BS;                    // [nh][BS] its lo half
  bf16* xs = hl + nh * BS;                    // [kVox][XS] x
  bf16* a1s = xs + kVox * XS;                 // [kVox][XS] a1
  bf16* gt2s = a1s + kVox * XS;               // [kVox][BS] gt2
  float* red = reinterpret_cast<float*>(gt2s + kVox * BS);  // [kWarps][CBP + 4]
  const Sc s(sc);
  const auto a1 = [&](float v) { return s.a1(v); };
  float ssum[4] = {}, dbe_s[4] = {};  // b1a, b1b, b2a, b2b; dbe's 4 channels
  float tot_1[2][4] = {};
  const int m0 = 16 * warp;
  for (int64_t bi = blockIdx.x; bi < nbricks; bi += gridDim.x) {
    const UBrick k = ubrick(bi, s0, s1, s2, n0, n1, n2);
    stage(hh, BS, gmh, CBP, CBP, nh, [&](int r) { return halo_voxel(k, r, 0, s0, s1, s2); });
    stage(hl, BS, gml, CBP, CBP, nh, [&](int r) { return halo_voxel(k, r, 0, s0, s1, s2); });
    stage(xs, XS, x, cu, CUP, kVox, [&](int r) { return row_voxel(k, r, s0, s1, s2); },
          [&](int r, int c0, int64_t v, uint4 row) {  // a1 beside x
            *reinterpret_cast<uint4*>(a1s + r * XS + c0) = map8(row, c0, cu, v >= 0, a1);
          });
    __syncthreads();

    const int64_t vr[2] = {row_voxel(k, m0 + g, s0, s1, s2), row_voxel(k, m0 + g + 8, s0, s1, s2)};
    // t2 recomputed (as tc_pre), ga2 = the transposed conv of gm (hi + lo)
    float e1[2][4] = {}, ga[2][4] = {};
#pragma unroll
    for (int k0 = 0; k0 < CUP; k0 += 16) {
      uint32_t a[4];
      lda(a, a1s, XS, m0, k0, lane);
      vqb::mma_row<2>(e1, a, w1e, CUP, k0, lane);
    }
    {
      const int r = m0 + (lane & 7) + 8 * ((lane >> 3) & 1);
      const int base = halo_base(k, r) * BS + 8 * (lane >> 4);
      const uint32_t ah0 = vq::smem_u32(hh + base), al0 = vq::smem_u32(hl + base);
#pragma unroll
      for (int tap = 0; tap < vqc::kTaps; ++tap) {
        uint32_t ah[4], al[4];
        vq::ldsm_x4(ah, ah0 + 2 * bwd_off(k, tap) * BS);
        vq::ldsm_x4(al, al0 + 2 * bwd_off(k, tap) * BS);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {  // one B fragment for both halves
          const bf16* wp = wut + (tap * CBP + nt * 8 + g) * CBP + 2 * t;
          const uint32_t b0 = vqb::ldg32(wp), b1 = vqb::ldg32(wp + 8);
          vq::mma_16816(ga[nt], ah, b0, b1);
          vq::mma_16816(ga[nt], al, b0, b1);
        }
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = m0 + g + 8 * half;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        float o[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = nt * 8 + 2 * t + e;
          const bool ok = vr[half] >= 0 && n < cb;
          float gti = 0.f;
          if (ok) {
            const float t2 = vq::rnd<bf16>(vq::rnd<bf16>(vq::rnd<bf16>(e1[nt][2 * half + e]) +
                                                         vq::to_f<bf16>(be[n])) + s.b2a);
            const float gai = vq::rnd<bf16>(ga[nt][2 * half + e]);
            gti = vq::rnd<bf16>(gai * elu_grad(t2));
            ssum[3] += gai;
            ssum[2] += gti;
            dbe_s[nt * 2 + e] += gti;
          }
          o[e] = gti;
        }
        *reinterpret_cast<uint32_t*>(gt2s + r * BS + nt * 8 + 2 * t) = vq::pack_bf16(o[0], o[1]);
      }
    }
    __syncwarp();
    // ga1 = W1e gt2, gt1, dx = g + gt1
    {
      constexpr int NU = CUP / 8;
      float p[NU][4] = {};
      uint32_t a[4];
      lda(a, gt2s, BS, m0, 0, lane);
      vqb::mma_row<NU>(p, a, w1n, CBP, 0, lane);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        if (vr[half] < 0) continue;
        const int r = m0 + g + 8 * half;
#pragma unroll
        for (int nt = 0; nt < NU; ++nt) {
          const int c0 = nt * 8 + 2 * t;
          if (c0 >= cu) continue;
          const int64_t o = vr[half] * cu + c0;
          const bool pair = cu % 2 == 0;  // (c0, c0 + 1) as one 32-bit access
          const __nv_bfloat162 g2 = pair ? *reinterpret_cast<const __nv_bfloat162*>(gy + o)
                                         : __halves2bfloat162(gy[o], gy[o]);
          float d[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (c0 + e >= cu) continue;
            const float gai = vq::rnd<bf16>(p[nt][2 * half + e]);
            const float t1 = vq::rnd<bf16>(vq::to_f<bf16>(xs[r * XS + c0 + e]) + s.b1a);
            const float gti = vq::rnd<bf16>(gai * elu_grad(t1));
            d[e] = (e == 0 ? __low2float(g2) : pair ? __high2float(g2)
                                                    : vq::to_f<bf16>(gy[o + 1])) + gti;
            ssum[1] += gai;
            ssum[0] += gti;
          }
          if (pair) {
            *reinterpret_cast<uint32_t*>(dx + o) = vq::pack_bf16(d[0], d[1]);
          } else {
            dx[o] = vq::from_f<bf16>(d[0]);
            if (c0 + 1 < cu) dx[o + 1] = vq::from_f<bf16>(d[1]);
          }
        }
      }
    }
    __syncthreads();
    if (warp < CUP / 16) {  // dW1e^T[k][ci] = sum gt2[v][k] a1[v][ci]: ci in 16 warp ..
      float acc[2][4] = {};
      for (int line = 0; line < kVox / 16; ++line) {
        uint32_t a[4], b[4];
        lda_t(a, gt2s, BS, 16 * line, 0, lane);
        ldb_t(b, a1s, XS, 16 * line + (lane & 7) + 8 * ((lane >> 3) & 1), 16 * warp, lane);
        vq::mma_16816(acc[0], a, b[0], b[1]);
        vq::mma_16816(acc[1], a, b[2], b[3]);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) tot_1[u][e] += acc[u][e];
    }
    __syncthreads();
  }

  float* out = part + static_cast<int64_t>(blockIdx.x) * dgrad_len(cu, cb);
  if (warp < CUP / 16) {
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kk = g + 8 * (e >> 1), ci = 16 * warp + 8 * u + 2 * t + (e & 1);
        if (kk < cb && ci < cu) out[kk * cu + ci] = tot_1[u][e];
      }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) dbe_s[j] = colsum(dbe_s[j]);
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) ssum[j] += __shfl_xor_sync(0xffffffffu, ssum[j], off);
  if (lane < 4) {
#pragma unroll
    for (int j = 0; j < 4; ++j) red[warp * (CBP + 4) + (j >> 1) * 8 + 2 * lane + (j & 1)] = dbe_s[j];
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) red[warp * (CBP + 4) + CBP + j] = ssum[j];
  }
  __syncthreads();
  if (threadIdx.x < CBP + 4) {
    const int j = threadIdx.x;
    float v = 0.f;
    for (int w = 0; w < kWarps; ++w) v += red[w * (CBP + 4) + j];
    if (j < CBP) {
      if (j < cb) out[cb * cu + j] = v;
    } else {
      out[cb * cu + cb + j - CBP] = v;
    }
  }
}

// out segments: the reduce pass writes element e of the summed partial to
// the segment that holds it
struct Segs {
  float* p[6];
  int n[6];
};

__global__ void reduce_segs(const float* __restrict__ part, int nchunks, int E, Segs sg) {
  int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  float v = 0.f;
  for (int ch = 0; ch < nchunks; ++ch) v += part[static_cast<int64_t>(ch) * E + e];
  for (int i = 0; i < 6; ++i) {
    if (e < sg.n[i]) {
      sg.p[i][e] = v;
      return;
    }
    e -= sg.n[i];
  }
}

template <typename K>
cudaError_t opt_in(K kernel, int smem) {
  return smem > 48 * 1024
             ? cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)
             : cudaSuccess;
}

template <int CUP, int CCP>
cudaError_t block_bwd_tc(const bf16* x, const bf16* gy, const bf16* cond, const float* keep,
                         float denom, const bf16* w1e, const bf16* be, const bf16* wuf,
                         const bf16* wut, const bf16* w3, const bf16* w3t, const bf16* wct,
                         const bf16* bc, const bf16* wcn, const bf16* w1n, const float* sc,
                         bf16* work, float* part, int64_t part_len, int ctas_m, int ctas_d,
                         bf16* dx,
                         bf16* gcond, float* dw1, float* dbe, float* dwu, float* dw3, float* dwc,
                         float* dbc, float* dsc, int64_t batch, int s0, int s1, int s2, int cu,
                         int cb, int cc, int n0, int n1, int n2, cudaStream_t s) {
  const int64_t nvox = batch * s0 * s1 * static_cast<int64_t>(s2);
  const int64_t nbricks = batch * ((s0 + n0 - 1) / n0) * static_cast<int64_t>((s1 + n1 - 1) / n1) *
                          ((s2 + n2 - 1) / n2);
  const int lm = mid_len(cu, cb, cc), ld = dgrad_len(cu, cb);
  if (ctas_m < 1 || ctas_m > nbricks || ctas_d < 1 || ctas_d > nbricks ||
      static_cast<int64_t>(ctas_m) * lm > part_len || static_cast<int64_t>(ctas_d) * ld > part_len)
    return cudaErrorInvalidValue;
  bf16* a2 = work;
  bf16* gmh = a2 + nvox * CBP;
  bf16* gml = gmh + nvox * CBP;
  const int nh = (n0 + 1) * (n1 + 2) * (n2 + 2);
  tc_pre<CUP><<<static_cast<unsigned>((nvox + kVox - 1) / kVox), kThr, 0, s>>>(x, w1e, be, sc, a2,
                                                                              nvox, cu, cb);
  const int smem_m = 2 * (nh * BS + 2 * kVox * (CUP + 8) + kVox * (CCP + 8) + 4 * kVox * BS) +
                     4 * (kWarps * (CBP + 4) + vqc::kTaps * CBP * CBP + CUP * CBP + CBP * CCP);
  cudaError_t err = opt_in(tc_mid<CUP, CCP>, smem_m);
  if (err != cudaSuccess) return err;
  tc_mid<CUP, CCP><<<ctas_m, kThr, smem_m, s>>>(a2, gy, cond, keep, denom, wuf, wct, bc, w3, w3t,
                                               wcn, sc, gmh, gml, gcond, part, nbricks, s0, s1,
                                               s2, cu, cb, cc, n0, n1, n2);
  const int tm = vqc::kTaps * cb * cb;
  Segs sm{{dwu, dw3, cond != nullptr ? dwc : dsc + 4, dbc, dsc + 4, nullptr},
          {tm, cu * cb, cond != nullptr ? cb * cc : 4, cond != nullptr ? cb : 0,
           cond != nullptr ? 4 : 0, 0}};
  reduce_segs<<<(lm + 255) / 256, 256, 0, s>>>(part, ctas_m, lm, sm);
  const int smem_d = 2 * (2 * nh * BS + 2 * kVox * (CUP + 8) + kVox * BS) + 4 * kWarps * (CBP + 4);
  err = opt_in(tc_dgrad<CUP>, smem_d);
  if (err != cudaSuccess) return err;
  float* part_d = part;  // reused: the mid's reduce pass has read it (stream order)
  tc_dgrad<CUP><<<ctas_d, kThr, smem_d, s>>>(x, gy, gmh, gml, w1e, be, wut, w1n, sc, dx, part_d,
                                           nbricks, s0, s1, s2, cu, cb, n0, n1, n2);
  Segs sd{{dw1, dbe, dsc, nullptr, nullptr, nullptr}, {cb * cu, cb, 4, 0, 0, 0}};
  reduce_segs<<<(ld + 255) / 256, 256, 0, s>>>(part_d, ctas_d, ld, sd);
  return cudaGetLastError();
}

template <int CUP>
cudaError_t block_bwd_tc_c(int ccp, const bf16* x, const bf16* gy, const bf16* cond,
                           const float* keep, float denom, const bf16* w1e, const bf16* be,
                           const bf16* wuf, const bf16* wut, const bf16* w3, const bf16* w3t,
                           const bf16* wct, const bf16* bc, const bf16* wcn, const bf16* w1n,
                           const float* sc, bf16* work, float* part, int64_t part_len, int ctas_m,
                           int ctas_d,
                           bf16* dx, bf16* gcond, float* dw1, float* dbe, float* dwu, float* dw3,
                           float* dwc, float* dbc, float* dsc, int64_t batch, int s0, int s1,
                           int s2, int cu, int cb, int cc, int n0, int n1, int n2,
                           cudaStream_t s) {
#define VQ_TC_ARGS                                                                           \
  x, gy, cond, keep, denom, w1e, be, wuf, wut, w3, w3t, wct, bc, wcn, w1n, sc, work, part,  \
      part_len, ctas_m, ctas_d, dx, gcond, dw1, dbe, dwu, dw3, dwc, dbc, dsc, batch, s0, s1, s2, \
      cu, cb, cc, n0, n1, n2, s
  if (ccp == 16) return block_bwd_tc<CUP, 16>(VQ_TC_ARGS);
  if (ccp == 32) return block_bwd_tc<CUP, 32>(VQ_TC_ARGS);
  return cudaErrorInvalidValue;
}

}  // namespace tc

// One block's backward on the tensor-core route (bf16; Cb <= 16, Cu <= 64,
// Cc <= 32; ops/conv3d.py causal_bwd_tensor_core_route). x, gy, dx
// (B, s0, s1, s2, Cu), cond, gcond (B, s0, s1, s2, Cc) or null, bf16
// contiguous; keep (B, Cb) fp32 or null, denom = 1 - p; bf16 weight packs,
// each [N][K] (k contiguous) zero-padded to CUP = Cu, CCP = Cc rounded up to
// 16 and Cb to 16 (ops/causal_kernel.py pack_bwd_tc_weights): w1e [16][CUP]
// (W1e^T), wuf [18][16][16] (the conv: tap, out, in), wut [18][16][16] (its
// transpose: tap, in, out), w3 [16][CUP] (W3), w3t [CUP][16] (W3^T), wct
// [16][CCP] (wc^T), wcn [CCP][16] (wc), w1n [CUP][16] (W1e); be, bc (Cb)
// bf16; sc the 8 fp32 scalars. work: 3 nvox x 16 bf16 (a2, gm's halves);
// part: at least ctas_m x tc::mid_len and ctas_d x tc::dgrad_len floats;
// ctas_m, ctas_d the persistent CTAs of tc_mid and tc_dgrad (<= the bricks);
// (n0, n1, n2) the brick, 128 voxels.
// Outputs as vq_causal_block_bwd's (gcond accumulates).
extern "C" int vq_causal_block_bwd_tc(
    const void* x, const void* gy, const void* cond, const void* keep, float denom,
    const void* w1e, const void* be, const void* wuf, const void* wut, const void* w3,
    const void* w3t, const void* wct, const void* bc, const void* wcn, const void* w1n,
    const void* sc, void* work, void* part, int64_t part_len, int ctas_m, int ctas_d, void* dx,
    void* gcond,
    void* dw1, void* dbe, void* dwu, void* dw3, void* dwc, void* dbc, void* dsc, int64_t batch,
    int s0, int s1, int s2, int cu, int cb, int cc, int n0, int n1, int n2, void* stream) {
  using tc::bf16;
  const int cup = (cu + 15) / 16 * 16, ccp = cc > 0 ? (cc + 15) / 16 * 16 : 16;
  if (batch <= 0 || s0 <= 0 || s1 <= 0 || s2 <= 0 || cu <= 0 || cb <= 0 || cb > tc::CBP ||
      cup > 64 || ccp > 32 || n0 * n1 * n2 != tc::kVox || (cond == nullptr) != (cc == 0) ||
      (cond != nullptr && (gcond == nullptr || wct == nullptr || wcn == nullptr || bc == nullptr)))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VQ_TC_CALL(CUP)                                                                        \
  tc::block_bwd_tc_c<CUP>(                                                                     \
      ccp, static_cast<const bf16*>(x), static_cast<const bf16*>(gy),                          \
      static_cast<const bf16*>(cond), static_cast<const float*>(keep), denom,                  \
      static_cast<const bf16*>(w1e), static_cast<const bf16*>(be),                             \
      static_cast<const bf16*>(wuf), static_cast<const bf16*>(wut),                            \
      static_cast<const bf16*>(w3), static_cast<const bf16*>(w3t),                             \
      static_cast<const bf16*>(wct), static_cast<const bf16*>(bc),                             \
      static_cast<const bf16*>(wcn), static_cast<const bf16*>(w1n),                            \
      static_cast<const float*>(sc), static_cast<bf16*>(work), static_cast<float*>(part),      \
      part_len, ctas_m, ctas_d, static_cast<bf16*>(dx), static_cast<bf16*>(gcond),             \
      static_cast<float*>(dw1), static_cast<float*>(dbe), static_cast<float*>(dwu),            \
      static_cast<float*>(dw3), static_cast<float*>(dwc), static_cast<float*>(dbc),            \
      static_cast<float*>(dsc), batch, s0, s1, s2, cu, cb, cc, n0, n1, n2, s)
  switch (cup) {
    case 16: return VQ_TC_CALL(16);
    case 32: return VQ_TC_CALL(32);
    case 48: return VQ_TC_CALL(48);
    case 64: return VQ_TC_CALL(64);
    default: return cudaErrorInvalidValue;
  }
}
