// Kernel K8, forward: causal flash attention of PixelSNAIL's attention blocks.
//
// Replaces vqvae3d_tpu/models/causal_blocks.py:_flash_causal_attention (the
// bundled Pallas TPU flash_attention, causal, with its custom backward; the
// backward is csrc/flash_attention_bwd.cu). The contract and the plain
// version are in ops/flash_attention.py:
//
//   o[n, i] = sum_{j <= i} softmax_j(q[n, i] . k[n, j] * scale) v[n, j]
//
// on (N, S, D) tensors, N = the three causal streams x batch x heads folded
// together, so one attention block of the model is one launch. It also
// writes lse[n, i] = m + log(l) (fp32), the log-sum-exp the backward needs.
//
// Rounding: q, k, v are read as T (fp32 or bf16) and widened; the dots, the
// softmax and the P.V sums are fp32 (P is never rounded to T); o is rounded
// to T once at the end. flash_causal_attention_plain rounds at the same
// points.
//
// What bounds it on the H100: at the published mid PixelSNAIL (N = 24,
// S = 8192, D = 8, bf16) one call has N S (S + 1) / 2 = 0.8 G causal logits,
// each 4 D flops (q.k and p.v) and one exp: 26 GFLOP (26 us at the bf16
// tensor-core rate) and 0.8 G exps, against 12.6 MB of q, k, v and o
// (3.8 us at 3.35 TB/s): operations bound it, and at D = 8 the exps weigh as
// much as the products. This first version runs everything on the CUDA cores
// in fp32 (no tensor cores: a D = 8 product is a quarter of an mma's depth),
// so it sits well above that bound.
//
// Design: one thread per query row, BQ = 64 rows a block, grid (S / BQ, N).
// The block walks the key tiles up to its diagonal (causal: later tiles are
// never read), staging BK = 64 keys and values in shared memory (every
// thread then reads the same key, a broadcast). Each thread keeps q, the
// running max m, the running sum l and the D-wide accumulator in registers
// and runs the online softmax over chunks of 16 keys: the chunk's scores,
// their max, one rescale of l and the accumulator, then the exps and the
// P.V sums. Keys past the row (j > i) and past S are masked by index, so S
// need not be a multiple of the tiles (the TPU path pads S to 128; here no
// padded row or lane ever reaches a result). Rows past S load nothing and
// store nothing.
#include "common.cuh"

#include <math_constants.h>

namespace {

constexpr int BQ = 64, BK = 64, CH = 16;

template <typename T, int D>
__global__ void __launch_bounds__(BQ) flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
                                                const T* __restrict__ v, T* __restrict__ o,
                                                float* __restrict__ lse, int S, float scale) {
  __shared__ float ks[BK][D], vs[BK][D];
  const int n = blockIdx.y, q0 = blockIdx.x * BQ, tid = threadIdx.x;
  const int i = q0 + tid;
  const bool act = i < S;
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
      float s[CH];
      float cm = -CUDART_INF_F;
#pragma unroll
      for (int jj = 0; jj < CH; ++jj) {
        const int j = c0 + jj;
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], ks[j < BK ? j : 0][d], dot);
        s[jj] = j < jn ? dot * scale : -CUDART_INF_F;
        cm = fmaxf(cm, s[jj]);
      }
      // the chunk holds key c0 <= i, so cm and mn are finite; m = -inf at
      // the first chunk gives alpha = 0
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
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int N,
                   int S, float scale, cudaStream_t stream) {
  const dim3 grid((S + BQ - 1) / BQ, N);
  flash_fwd<T, D><<<grid, BQ, 0, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                           static_cast<const T*>(v), static_cast<T*>(o), lse,
                                           S, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, float* lse, int N,
                     int S, int D, float scale, cudaStream_t s) {
  switch (D) {
    case 8: return launch<T, 8>(q, k, v, o, lse, N, S, scale, s);
    case 16: return launch<T, 16>(q, k, v, o, lse, N, S, scale, s);
    case 32: return launch<T, 32>(q, k, v, o, lse, N, S, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, o: (N, S, D) contiguous, fp32 or bf16 (is_bf16); lse (N, S) fp32.
// D in {8, 16, 32}; grid.y = N <= 65535.
extern "C" int vq_flash_attn_fwd(int is_bf16, const void* q, const void* k, const void* v,
                                 void* o, float* lse, int N, int S, int D, float scale,
                                 void* stream) {
  if (N <= 0 || N > 65535 || S <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return dispatch<__nv_bfloat16>(q, k, v, o, lse, N, S, D, scale, s);
  return dispatch<float>(q, k, v, o, lse, N, S, D, scale, s);
}
