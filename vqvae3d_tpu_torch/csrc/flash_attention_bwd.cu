// Kernel K8, backward: the gradients of causal flash attention.
//
// Replaces the backward of vqvae3d_tpu/models/causal_blocks.py:
// _flash_causal_attention (the bundled Pallas flash_attention's custom VJP,
// its dq and dkv kernels). The forward is csrc/flash_attention.cu; the
// contract is in ops/flash_attention.py. With P[i, j] = exp(s[i, j] - lse[i])
// for j <= i, s = q.k * scale:
//
//   delta[i] = sum_d do[i, d] o[i, d]
//   dv[j]    = sum_{i >= j} P[i, j] do[i]
//   ds[i, j] = P[i, j] (do[i] . v[j] - delta[i])
//   dk[j]    = scale sum_{i >= j} ds[i, j] q[i]
//   dq[i]    = scale sum_{j <= i} ds[i, j] k[j]
//
// FlashAttention-2's split: one kernel for delta, one for dk and dv (a thread
// per key row, walking the query tiles from its diagonal to S), one for dq (a
// thread per query row, walking the key tiles up to its diagonal). P is
// recomputed from the saved lse in both. Every sum is taken by one thread in
// a fixed order, with no atomics, so two calls give bit-identical gradients.
// Inputs are read as T and widened; every sum is fp32; the gradients are
// rounded to T once at the end.
//
// What bounds it on the H100: at the published mid PixelSNAIL (N = 24,
// S = 8192, D = 8, bf16) the two passes recompute the 0.8 G causal logits
// twice: ~12 D flops a logit (q.k twice, do.v twice, dv, dk, dq) and two
// exps, 77 GFLOP (78 us at the bf16 tensor-core rate) against ~25 MB of
// operands and gradients. Operations bound it; this first version runs them
// on the CUDA cores in fp32.
#include "common.cuh"

namespace {

constexpr int BQ = 64, BK = 64;

template <typename T, int D>
__global__ void bwd_delta(const T* __restrict__ o, const T* __restrict__ dout,
                          float* __restrict__ delta, int64_t rows) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) acc = fmaf(vq::to_f<T>(dout[r * D + d]), vq::to_f<T>(o[r * D + d]), acc);
  delta[r] = acc;
}

// dk, dv: one thread per key row j; grid (S / BK, N).
template <typename T, int D>
__global__ void __launch_bounds__(BK) bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
                                               const T* __restrict__ v, const T* __restrict__ dout,
                                               const float* __restrict__ lse,
                                               const float* __restrict__ delta,
                                               T* __restrict__ dk, T* __restrict__ dv, int S,
                                               float scale) {
  __shared__ float qs[BQ][D], dos[BQ][D], ls[BQ], dls[BQ];
  const int n = blockIdx.y, k0 = blockIdx.x * BK, tid = threadIdx.x;
  const int j = k0 + tid;
  const bool act = j < S;
  const size_t base = static_cast<size_t>(n) * S * D;
  const float* lsen = lse + static_cast<size_t>(n) * S;
  const float* deln = delta + static_cast<size_t>(n) * S;
  float kr[D], vr[D], dka[D], dva[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    kr[d] = act ? vq::to_f<T>(k[base + static_cast<size_t>(j) * D + d]) : 0.f;
    vr[d] = act ? vq::to_f<T>(v[base + static_cast<size_t>(j) * D + d]) : 0.f;
    dka[d] = dva[d] = 0.f;
  }
  // query tiles from this key tile's diagonal (BQ == BK, aligned) to S
  for (int q0 = k0; q0 < S; q0 += BQ) {
    for (int e = tid; e < BQ * D; e += BK) {
      const int i = q0 + e / D, d = e % D;
      const bool in = i < S;
      const size_t off = base + static_cast<size_t>(i) * D + d;
      qs[e / D][d] = in ? vq::to_f<T>(q[off]) : 0.f;
      dos[e / D][d] = in ? vq::to_f<T>(dout[off]) : 0.f;
    }
    for (int e = tid; e < BQ; e += BK) {
      const bool in = q0 + e < S;
      ls[e] = in ? lsen[q0 + e] : 0.f;
      dls[e] = in ? deln[q0 + e] : 0.f;
    }
    __syncthreads();
    if (act) {
      // rows i = q0 + ii with j <= i < S
      const int ii0 = max(j - q0, 0), ii1 = min(BQ, S - q0);
      for (int ii = ii0; ii < ii1; ++ii) {
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          s = fmaf(qs[ii][d], kr[d], s);
          dp = fmaf(dos[ii][d], vr[d], dp);
        }
        const float p = expf(s * scale - ls[ii]);
        const float ds = p * (dp - dls[ii]);
#pragma unroll
        for (int d = 0; d < D; ++d) {
          dva[d] = fmaf(p, dos[ii][d], dva[d]);
          dka[d] = fmaf(ds, qs[ii][d], dka[d]);
        }
      }
    }
    __syncthreads();
  }
  if (act) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      dk[base + static_cast<size_t>(j) * D + d] = vq::from_f<T>(dka[d] * scale);
      dv[base + static_cast<size_t>(j) * D + d] = vq::from_f<T>(dva[d]);
    }
  }
}

// dq: one thread per query row i; grid (S / BQ, N).
template <typename T, int D>
__global__ void __launch_bounds__(BQ) bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
                                             const T* __restrict__ v, const T* __restrict__ dout,
                                             const float* __restrict__ lse,
                                             const float* __restrict__ delta, T* __restrict__ dq,
                                             int S, float scale) {
  __shared__ float ks[BK][D], vs[BK][D];
  const int n = blockIdx.y, q0 = blockIdx.x * BQ, tid = threadIdx.x;
  const int i = q0 + tid;
  const bool act = i < S;
  const size_t base = static_cast<size_t>(n) * S * D;
  float qr[D], dor[D], dqa[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = act ? vq::to_f<T>(q[base + static_cast<size_t>(i) * D + d]) : 0.f;
    dor[d] = act ? vq::to_f<T>(dout[base + static_cast<size_t>(i) * D + d]) : 0.f;
    dqa[d] = 0.f;
  }
  const float li = act ? lse[static_cast<size_t>(n) * S + i] : 0.f;
  const float di = act ? delta[static_cast<size_t>(n) * S + i] : 0.f;
  const int kend = min(q0 + BQ, S);
  for (int k0 = 0; k0 < kend; k0 += BK) {
    for (int e = tid; e < BK * D; e += BQ) {
      const int j = k0 + e / D, d = e % D;
      const bool in = j < S;
      const size_t off = base + static_cast<size_t>(j) * D + d;
      ks[e / D][d] = in ? vq::to_f<T>(k[off]) : 0.f;
      vs[e / D][d] = in ? vq::to_f<T>(v[off]) : 0.f;
    }
    __syncthreads();
    const int jn = act ? min(BK, i - k0 + 1) : 0;  // keys j <= i of this tile
    for (int jj = 0; jj < jn; ++jj) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        s = fmaf(qr[d], ks[jj][d], s);
        dp = fmaf(dor[d], vs[jj][d], dp);
      }
      const float p = expf(s * scale - li);
      const float ds = p * (dp - di);
#pragma unroll
      for (int d = 0; d < D; ++d) dqa[d] = fmaf(ds, ks[jj][d], dqa[d]);
    }
    __syncthreads();
  }
  if (act) {
#pragma unroll
    for (int d = 0; d < D; ++d)
      dq[base + static_cast<size_t>(i) * D + d] = vq::from_f<T>(dqa[d] * scale);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const float* lse, float* delta, void* dq, void* dk, void* dv, int N, int S,
                   float scale, cudaStream_t st) {
  const T *qt = static_cast<const T*>(q), *kt = static_cast<const T*>(k);
  const T *vt = static_cast<const T*>(v), *dot = static_cast<const T*>(dout);
  const int64_t rows = static_cast<int64_t>(N) * S;
  bwd_delta<T, D><<<static_cast<unsigned>((rows + 255) / 256), 256, 0, st>>>(
      static_cast<const T*>(o), dot, delta, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dkdv<T, D><<<dim3((S + BK - 1) / BK, N), BK, 0, st>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), S, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dq<T, D><<<dim3((S + BQ - 1) / BQ, N), BQ, 0, st>>>(qt, kt, vt, dot, lse, delta,
                                                          static_cast<T*>(dq), S, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, const void* o,
                     const void* dout, const float* lse, float* delta, void* dq, void* dk,
                     void* dv, int N, int S, int D, float scale, cudaStream_t s) {
  switch (D) {
    case 8: return launch<T, 8>(q, k, v, o, dout, lse, delta, dq, dk, dv, N, S, scale, s);
    case 16: return launch<T, 16>(q, k, v, o, dout, lse, delta, dq, dk, dv, N, S, scale, s);
    case 32: return launch<T, 32>(q, k, v, o, dout, lse, delta, dq, dk, dv, N, S, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, o, dout, dq, dk, dv: (N, S, D) contiguous, fp32 or bf16 (is_bf16);
// lse (N, S) fp32 from the forward; delta (N, S) fp32 scratch.
extern "C" int vq_flash_attn_bwd(int is_bf16, const void* q, const void* k, const void* v,
                                 const void* o, const void* dout, const float* lse, float* delta,
                                 void* dq, void* dk, void* dv, int N, int S, int D, float scale,
                                 void* stream) {
  if (N <= 0 || N > 65535 || S <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(q, k, v, o, dout, lse, delta, dq, dk, dv, N, S, D, scale, s);
  return dispatch<float>(q, k, v, o, dout, lse, delta, dq, dk, dv, N, S, D, scale, s);
}
