// Kernel K5, backward: the gradients of causal flash attention with
// pre-mask logit dropout.
//
// Replaces the backward of vqvae3d_tpu/ops/flash_dropout_attention.py:
// flash_causal_dropout_attention (its Pallas _bwd_kernel, which computes dq,
// dk and dv in one pass for the TPU's VMEM; this port keeps the function, not
// that form). The forward is csrc/flash_dropout_attention.cu; the contract is
// in ops/flash_dropout_attention.py. With s'[i, j] the post-dropout logit
// (keep ? q.k * scale * inv_keep : -1e3) and P[i, j] = exp(s'[i, j] - lse[i])
// for j <= i:
//
//   delta[i] = sum_d do[i, d] o[i, d]
//   dv[j]    = sum_{i >= j} P[i, j] do[i]           (dropped logits included)
//   ds[i, j] = keep ? P[i, j] (do[i] . v[j] - delta[i]) inv_keep : 0
//   dk[j]    = scale sum_{i >= j} ds[i, j] q[i]
//   dq[i]    = scale sum_{j <= i} ds[i, j] k[j]
//
// K8's FlashAttention-2 split (csrc/flash_attention_bwd.cu): one kernel for
// delta, one for dk and dv (a thread per key row, walking the query tiles
// from its diagonal to S), one for dq (a thread per query row, walking the key
// tiles up to its diagonal). Both regenerate the mask from the seed with the
// forward's per-logit counters (csrc/philox.cuh). The dq pass takes one
// Philox call per four keys of its row, as the forward does; the dk/dv pass
// needs a column of bits per thread, so each block first computes the
// (64 query x 64 key) tile's bits into shared memory, one row of 16 calls per
// thread, and every thread then reads its key's bit of each row. Every sum is
// taken by one thread in a fixed order, with no atomics, so two calls give
// bit-identical gradients. Inputs are read as T and widened; every sum is
// fp32; the gradients are rounded to T once at the end.
//
// What bounds it on the H100: at the mid PixelSNAIL (N = 24, S = 8192, D = 8,
// bf16) the gradients need, per causal logit (0.8 G), 10 D flops of products
// (q.k, do.v, dv, dk, dq), one exp and the mask once (a quarter of a
// Philox-10 and a compare, 11 integer operations): 64 GFLOP (65 us at the
// bf16 tensor-core rate) and 8.9 G integer operations (0.26 ms at 33.5 T
// int32 operations/s) against ~25 MB of operands and gradients. The mask's integer work bounds it; this version
// recomputes the logits and the mask in both passes, on the CUDA cores in
// fp32.
#include "common.cuh"
#include "philox.cuh"

namespace {

constexpr int BQ = 64, BK = 64;

template <typename T, int D>
__global__ void drop_delta(const T* __restrict__ o, const T* __restrict__ dout,
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
__global__ void __launch_bounds__(BK)
    drop_dkdv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const T* __restrict__ dout, const float* __restrict__ lse,
             const float* __restrict__ delta, const int64_t* __restrict__ seed,
             T* __restrict__ dk, T* __restrict__ dv, int S, float scale, uint32_t thr,
             float inv_keep) {
  __shared__ float qs[BQ][D], dos[BQ][D], ls[BQ], dls[BQ];
  __shared__ unsigned long long bits[BQ];  // bit jj of row ii: keep[q0 + ii, k0 + jj]
  const int n = blockIdx.y, k0 = blockIdx.x * BK, tid = threadIdx.x;
  const int j = k0 + tid;
  const bool act = j < S;
  const uint32_t key0 = static_cast<uint32_t>(seed[0]), key1 = static_cast<uint32_t>(seed[1]);
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
    {  // this thread's row of the tile's keep bits: 16 calls of 4 keys
      unsigned long long row = ~0ull;
      if (thr && q0 + tid < S) {
        row = 0ull;
        for (int g = 0; g < BK / 4; ++g)
          row |= static_cast<unsigned long long>(
                     vq::keep4(k0 / 4 + g, q0 + tid, n, key0, key1, thr))
                 << (4 * g);
      }
      bits[tid] = row;
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
        const bool kept = (bits[ii] >> tid) & 1ull;
        const float p = expf((kept ? s * scale * inv_keep : -1000.f) - ls[ii]);
        const float ds = kept ? p * (dp - dls[ii]) * inv_keep : 0.f;
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
__global__ void __launch_bounds__(BQ)
    drop_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const T* __restrict__ dout, const float* __restrict__ lse,
           const float* __restrict__ delta, const int64_t* __restrict__ seed,
           T* __restrict__ dq, int S, float scale, uint32_t thr, float inv_keep) {
  __shared__ float ks[BK][D], vs[BK][D];
  const int n = blockIdx.y, q0 = blockIdx.x * BQ, tid = threadIdx.x;
  const int i = q0 + tid;
  const bool act = i < S;
  const uint32_t key0 = static_cast<uint32_t>(seed[0]), key1 = static_cast<uint32_t>(seed[1]);
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
    for (int g0 = 0; g0 < jn; g0 += 4) {
      const uint32_t keep = thr ? vq::keep4((k0 + g0) / 4, i, n, key0, key1, thr) : 0xFu;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int jj = g0 + r;
        if (jj < jn && ((keep >> r) & 1u)) {  // a dropped logit has ds = 0
          float s = 0.f, dp = 0.f;
#pragma unroll
          for (int d = 0; d < D; ++d) {
            s = fmaf(qr[d], ks[jj][d], s);
            dp = fmaf(dor[d], vs[jj][d], dp);
          }
          const float p = expf(s * scale * inv_keep - li);
          const float ds = p * (dp - di) * inv_keep;
#pragma unroll
          for (int d = 0; d < D; ++d) dqa[d] = fmaf(ds, ks[jj][d], dqa[d]);
        }
      }
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
                   const float* lse, float* delta, const int64_t* seed, void* dq, void* dk,
                   void* dv, int N, int S, float scale, uint32_t thr, float inv_keep,
                   cudaStream_t st) {
  const T *qt = static_cast<const T*>(q), *kt = static_cast<const T*>(k);
  const T *vt = static_cast<const T*>(v), *dot = static_cast<const T*>(dout);
  const int64_t rows = static_cast<int64_t>(N) * S;
  drop_delta<T, D><<<static_cast<unsigned>((rows + 255) / 256), 256, 0, st>>>(
      static_cast<const T*>(o), dot, delta, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  drop_dkdv<T, D><<<dim3((S + BK - 1) / BK, N), BK, 0, st>>>(
      qt, kt, vt, dot, lse, delta, seed, static_cast<T*>(dk), static_cast<T*>(dv), S, scale,
      thr, inv_keep);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  drop_dq<T, D><<<dim3((S + BQ - 1) / BQ, N), BQ, 0, st>>>(
      qt, kt, vt, dot, lse, delta, seed, static_cast<T*>(dq), S, scale, thr, inv_keep);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, const void* o,
                     const void* dout, const float* lse, float* delta, const int64_t* seed,
                     void* dq, void* dk, void* dv, int N, int S, int D, float scale,
                     uint32_t thr, float inv_keep, cudaStream_t s) {
  switch (D) {
    case 8:
      return launch<T, 8>(q, k, v, o, dout, lse, delta, seed, dq, dk, dv, N, S, scale, thr,
                          inv_keep, s);
    case 16:
      return launch<T, 16>(q, k, v, o, dout, lse, delta, seed, dq, dk, dv, N, S, scale, thr,
                           inv_keep, s);
    case 32:
      return launch<T, 32>(q, k, v, o, dout, lse, delta, seed, dq, dk, dv, N, S, scale, thr,
                           inv_keep, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, o, dout, dq, dk, dv: (N, S, D) contiguous, fp32 or bf16 (is_bf16);
// lse (N, S) fp32 from the forward; delta (N, S) fp32 scratch; seed, thr and
// inv_keep as the forward's.
extern "C" int vq_flash_dropout_bwd(int is_bf16, const void* q, const void* k, const void* v,
                                    const void* o, const void* dout, const float* lse,
                                    float* delta, const int64_t* seed, void* dq, void* dk,
                                    void* dv, int N, int S, int D, float scale, uint32_t thr,
                                    float inv_keep, void* stream) {
  if (N <= 0 || N > 65535 || S <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(q, k, v, o, dout, lse, delta, seed, dq, dk, dv, N, S, D,
                                   scale, thr, inv_keep, s);
  return dispatch<float>(q, k, v, o, dout, lse, delta, seed, dq, dk, dv, N, S, D, scale, thr,
                         inv_keep, s);
}
