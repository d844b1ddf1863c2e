// Kernel K5, forward: causal flash attention with the reference's pre-mask
// logit dropout, PixelSNAIL's attention in training.
//
// Replaces vqvae3d_tpu/ops/flash_dropout_attention.py:flash_causal_dropout_attention
// (its Pallas _fwd_kernel; the backward is csrc/flash_dropout_attention_bwd.cu).
// The contract and the plain version are in ops/flash_dropout_attention.py: on
// (N, S, D) tensors, N = the three causal streams x batch x heads folded
// together (one attention block is one launch),
//
//   s'[i, j] = keep[i, j] ? (q[i] . k[j]) * scale * inv_keep : -1e3
//   o[i]     = sum_{j <= i} softmax_j(s'[i, j]) v[j]
//
// with keep from csrc/philox.cuh (counter (j / 4, i, n, 0), key = the two seed
// words, read from device memory so the host never syncs) and
// inv_keep = 1 / (1 - p). A dropped logit is -1e3, not -inf: a row whose every
// key is dropped averages its past values. The online softmax starts its max
// at -inf and excludes only keys past the row (by index), never a -1e3. It
// also writes lse[n, i] = m + log(l) (fp32) for the backward, and with
// COLLECT the keep bit of every (i, j <= i) into an (N, S, S) uint8 mask.
//
// Rounding: q, k, v are read as T (fp32 or bf16) and widened; the dots, the
// two scalings, the softmax and the P.V sums are fp32; o is rounded to T once.
//
// What bounds it on the H100: at the mid PixelSNAIL (N = 24, S = 8192, D = 8,
// bf16) one call has 0.8 G causal logits, each 4 D flops, one exp and a
// quarter of a Philox-10 (10 rounds of two 32x32 products and two 3-way xors)
// plus a compare, 11 integer operations a logit: 26 GFLOP of products (26 us
// at the bf16 tensor-core rate), 0.8 G exps and 8.9 G integer operations
// (0.26 ms at 33.5 T int32 operations/s: an SM's 64 INT32 lanes and the 64
// FMA lanes that take IMAD, at 1.98 GHz) against 12.6 MB of operands (3.8 us
// at 3.35 TB/s): the mask's integer work bounds it. This first version is
// K8's forward (csrc/flash_attention.cu: a thread a query row, BQ = 64 rows a
// block, BK = 64 keys staged in shared memory, an online softmax over chunks
// of 16 keys, all on the CUDA cores in fp32) with four Philox calls per chunk,
// skipped when p = 0 (thr = 0).
#include "common.cuh"
#include "philox.cuh"

#include <math_constants.h>

namespace {

constexpr int BQ = 64, BK = 64, CH = 16;

template <typename T, int D, bool COLLECT>
__global__ void __launch_bounds__(BQ)
    flash_dropout_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      T* __restrict__ o, float* __restrict__ lse,
                      const int64_t* __restrict__ seed, uint8_t* __restrict__ mask, int S,
                      float scale, uint32_t thr, float inv_keep) {
  __shared__ float ks[BK][D], vs[BK][D];
  const int n = blockIdx.y, q0 = blockIdx.x * BQ, tid = threadIdx.x;
  const int i = q0 + tid;
  const bool act = i < S;
  const uint32_t key0 = static_cast<uint32_t>(seed[0]), key1 = static_cast<uint32_t>(seed[1]);
  const size_t base = static_cast<size_t>(n) * S * D;
  float qr[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = act ? vq::to_f<T>(q[base + static_cast<size_t>(i) * D + d]) : 0.f;
    acc[d] = 0.f;
  }
  float m = -CUDART_INF_F, l = 0.f;
  const int kend = min(q0 + BQ, S);  // keys [0, kend) reach some row of this block
  for (int k0 = 0; k0 < kend; k0 += BK) {
    for (int e = tid; e < BK * D; e += BQ) {
      const int j = k0 + e / D, d = e % D;
      const bool in = j < S;
      const size_t off = base + static_cast<size_t>(j) * D + d;
      ks[e / D][d] = in ? vq::to_f<T>(k[off]) : 0.f;
      vs[e / D][d] = in ? vq::to_f<T>(v[off]) : 0.f;
    }
    __syncthreads();
    const int jn = act ? min(BK, i - k0 + 1) : 0;  // keys k0 .. k0 + jn - 1 are j <= i
    for (int c0 = 0; c0 < jn; c0 += CH) {
      uint32_t keep = 0xFFFFu;
      if (thr) {
        keep = 0u;
#pragma unroll
        for (int g = 0; g < CH / 4; ++g)
          keep |= vq::keep4((k0 + c0) / 4 + g, i, n, key0, key1, thr) << (4 * g);
      }
      float s[CH];
      float cm = -CUDART_INF_F;
#pragma unroll
      for (int jj = 0; jj < CH; ++jj) {
        const int j = c0 + jj;
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], ks[j < BK ? j : 0][d], dot);
        const bool kept = (keep >> jj) & 1u;
        s[jj] = j < jn ? (kept ? dot * scale * inv_keep : -1000.f) : -CUDART_INF_F;
        if (COLLECT && j < jn)
          mask[(static_cast<size_t>(n) * S + i) * S + k0 + j] = static_cast<uint8_t>(kept);
        cm = fmaxf(cm, s[jj]);
      }
      // the chunk holds key c0 <= i, so cm and mn are finite (>= -1e3);
      // m = -inf at the first chunk gives alpha = 0
      const float mn = fmaxf(m, cm);
      const float alpha = expf(m - mn);
      l *= alpha;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
      for (int jj = 0; jj < CH; ++jj) {
        const int j = c0 + jj;
        const float p = j < jn ? expf(s[jj] - mn) : 0.f;
        l += p;
#pragma unroll
        for (int d = 0; d < D; ++d) acc[d] = fmaf(p, vs[j < BK ? j : 0][d], acc[d]);
      }
      m = mn;
    }
    __syncthreads();
  }
  if (act) {
    const float inv = 1.f / l;
#pragma unroll
    for (int d = 0; d < D; ++d)
      o[base + static_cast<size_t>(i) * D + d] = vq::from_f<T>(acc[d] * inv);
    lse[static_cast<size_t>(n) * S + i] = m + logf(l);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse,
                   const int64_t* seed, uint8_t* mask, int N, int S, float scale, uint32_t thr,
                   float inv_keep, cudaStream_t stream) {
  const dim3 grid((S + BQ - 1) / BQ, N);
  const T *qt = static_cast<const T*>(q), *kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  if (mask)
    flash_dropout_fwd<T, D, true><<<grid, BQ, 0, stream>>>(
        qt, kt, vt, static_cast<T*>(o), lse, seed, mask, S, scale, thr, inv_keep);
  else
    flash_dropout_fwd<T, D, false><<<grid, BQ, 0, stream>>>(
        qt, kt, vt, static_cast<T*>(o), lse, seed, nullptr, S, scale, thr, inv_keep);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, float* lse,
                     const int64_t* seed, uint8_t* mask, int N, int S, int D, float scale,
                     uint32_t thr, float inv_keep, cudaStream_t s) {
  switch (D) {
    case 8: return launch<T, 8>(q, k, v, o, lse, seed, mask, N, S, scale, thr, inv_keep, s);
    case 16: return launch<T, 16>(q, k, v, o, lse, seed, mask, N, S, scale, thr, inv_keep, s);
    case 32: return launch<T, 32>(q, k, v, o, lse, seed, mask, N, S, scale, thr, inv_keep, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, o: (N, S, D) contiguous, fp32 or bf16 (is_bf16); lse (N, S) fp32;
// seed: two int64 on the device, the Philox key words in their low 32 bits;
// mask: null, or (N, S, S) uint8 to receive the keep bits of j <= i.
// D in {8, 16, 32}; grid.y = N <= 65535; thr = round(p 2^32); inv_keep = 1 / (1 - p).
extern "C" int vq_flash_dropout_fwd(int is_bf16, const void* q, const void* k, const void* v,
                                    void* o, float* lse, const int64_t* seed, uint8_t* mask,
                                    int N, int S, int D, float scale, uint32_t thr,
                                    float inv_keep, void* stream) {
  if (N <= 0 || N > 65535 || S <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(q, k, v, o, lse, seed, mask, N, S, D, scale, thr, inv_keep, s);
  return dispatch<float>(q, k, v, o, lse, seed, mask, N, S, D, scale, thr, inv_keep, s);
}
