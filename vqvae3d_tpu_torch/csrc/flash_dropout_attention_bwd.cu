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
// K8's FlashAttention-2 split (csrc/flash_attention_bwd.cu) on both routes,
// chosen by ops/flash_dropout_attention.py::dropout_tensor_core_route before
// any launch (neither is a fallback of the other). Every sum is taken in a
// fixed order over a fixed partition, with no atomics, so two calls give
// bit-identical gradients.
//
// bf16 (the training path): tensor cores, on the tiles of K8's bwd_dq_tc and
// bwd_dkdv_tc (csrc/flash_tc.cuh), the mask computed once per logit:
//  * drop_dq_tc runs first, query-major as the forward: delta = rowsum(do o)
//    from its rows' A fragments (written for the second pass), S = Q K^T and
//    dP = dO V^T per key tile, the keep bits by the forward's lane-pair
//    Philox calls (csrc/dropout_tc.cuh), P = exp2(S c_keep - lse log2(e)),
//    dS = keep ? P (dP - delta) scale inv_keep : 0, dQ += bf16(dS) K. Each
//    lane stores its word of the tile's bits: 512 bytes a 64 x 64 tile on or
//    below the diagonal (at the mid call 24 x 8,256 tiles, 101 MB, scratch of
//    this call only).
//  * drop_dkdv_tc, key-major as K8's: S^T and dP^T per query tile, the
//    tile's 512 bytes staged by cp.async beside Q, dO, lse and delta and
//    read as columns (eight 8-byte loads a lane), P^T of the kept logits and
//    of the dropped ones (-1e3, which an all-dropped row averages), dS^T as
//    above, dV += bf16(P^T) dO, dK += bf16(dS^T) Q.
//  Rounding as the TPU kernel's backward (:206-227): P to bf16 for dV, dS
//  (with its scale) to bf16 for dK and dQ, every sum fp32, each gradient
//  rounded to bf16 once.
//
// fp32: the CUDA cores (tensor cores would round to TF32; the first design):
// drop_delta; drop_dkdv, a thread per key row walking the query tiles from
// its diagonal, each block first computing the (64 query x 64 key) tile's
// bits into shared memory, one row of 16 calls per thread; drop_dq, a thread
// per query row, one Philox call per four keys. Both regenerate the mask.
// Inputs widened, every sum fp32, the gradients rounded once.
//
// What bounds it on the H100: at the mid PixelSNAIL (N = 24, S = 8192, D = 8,
// bf16) the gradients need, per causal logit (0.8 G), 10 D flops of products
// (q.k, do.v, dv, dk, dq), one exp and the mask once (a quarter of a
// Philox-10 and a compare, 11 integer operations): 64 GFLOP (65 us at the
// bf16 tensor-core rate) and 8.9 G integer operations (0.26 ms at 33.5 T
// int32 operations/s) against ~25 MB of operands and gradients: the mask's
// integer work bounds it. On the tensor-core route the mask's Philox calls
// run once, in drop_dq_tc, and its packed bits add 101 MB written and read
// (~0.06 ms at 3.35 TB/s); the exps run twice, once a pass, as in K8.
#include "common.cuh"
#include "dropout_tc.cuh"
#include "flash_tc.cuh"
#include "philox.cuh"

#include <math_constants.h>

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

// ---- bf16: tensor cores ----

using namespace vq::ftc;

// (x0 y0 + x1 y1) of two registers of two bf16 each, in fp32
__device__ __forceinline__ float dot2(uint32_t x, uint32_t y, float acc) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&y));
  return fmaf(a.y, b.y, fmaf(a.x, b.x, acc));
}

// dq (and delta, and the keep bits): grid (N, S / 64); query tile
// qt = gridDim.y - 1 - blockIdx.y, heavy first. Runs before drop_dkdv_tc.
template <int D>
__global__ void __launch_bounds__(32 * TC_WARPS)
    drop_dq_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ o,
               const bf16* __restrict__ dout, const float* __restrict__ lse,
               float* __restrict__ delta, const int64_t* __restrict__ seed,
               uint32_t* __restrict__ bits, bf16* __restrict__ dq, int S, float c_keep,
               float c_ds, uint32_t thr) {
  constexpr int DB = D / 8;
  __shared__ __align__(16) bf16 ks[2][TC_T * row_stride<D>()], vs[2][TC_T * row_stride<D>()];
  const int n = blockIdx.x, qt = gridDim.y - 1 - blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, t = lane & 3;
  const size_t base = static_cast<size_t>(n) * S * D;
  const int r0 = qt * TC_T + 16 * warp + (lane >> 2), r1 = r0 + 8;  // this lane's two query rows
  const vq::PhiloxKeys keys =
      vq::philox_round_keys(static_cast<uint32_t>(seed[0]), static_cast<uint32_t>(seed[1]));
  const uint32_t row_mine = static_cast<uint32_t>((lane & 1) ? r1 : r0);
  // this CTA's tiles (qt, 0 .. qt) of the packed keep bits, this lane's word
  uint32_t* tile_bits =
      thr ? bits + (static_cast<int64_t>(n) * vq::dtc::tile_index(gridDim.y) +
                    vq::dtc::tile_index(qt)) * vq::dtc::TILE_WORDS + tid
          : nullptr;

  AFrag<D> qa, doa, oa;
  load_a<D>(qa, q + base, r0, S, t);
  load_a<D>(doa, dout + base, r0, S, t);
  load_a<D>(oa, o + base, r0, S, t);
  // delta = rowsum(do o) in fp32: the lane's columns, then over the quad
  float dl0 = 0.f, dl1 = 0.f;
#pragma unroll
  for (int kk = 0; kk < (D == 8 ? 1 : D / 16); ++kk) {
    dl0 = dot2(doa[kk][0], oa[kk][0], dl0);
    dl1 = dot2(doa[kk][1], oa[kk][1], dl1);
    if constexpr (D != 8) {
      dl0 = dot2(doa[kk][2], oa[kk][2], dl0);
      dl1 = dot2(doa[kk][3], oa[kk][3], dl1);
    }
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    dl0 += __shfl_xor_sync(0xffffffffu, dl0, off);
    dl1 += __shfl_xor_sync(0xffffffffu, dl1, off);
  }
  const size_t row = static_cast<size_t>(n) * S;
  if (t == 0) {
    if (r0 < S) delta[row + r0] = dl0;
    if (r1 < S) delta[row + r1] = dl1;
  }
  const float lb0 = r0 < S ? lse[row + r0] * LOG2E : 0.f, lb1 = r1 < S ? lse[row + r1] * LOG2E : 0.f;

  auto load_tile = [&](int kt, int st) {
    stage_rows<D>(ks[st], k + base, kt * TC_T, S, tid);
    stage_rows<D>(vs[st], v + base, kt * TC_T, S, tid);
    vq::cp_async_commit();
  };

  float dqa[DB][4];
#pragma unroll
  for (int nd = 0; nd < DB; ++nd) dqa[nd][0] = dqa[nd][1] = dqa[nd][2] = dqa[nd][3] = 0.f;

  load_tile(0, 0);
  for (int kt = 0; kt <= qt; ++kt) {
    const int st = kt & 1;
    if (kt < qt) load_tile(kt + 1, st ^ 1);
    // the tile's keep bits while the copies land, stored for the key-major pass
    vq::dtc::RowBits rb{~0u, ~0u};
    if (thr) {
      const uint32_t mine = vq::dtc::lane_keep_word(kt, t, row_mine, n, keys, thr);
      tile_bits[static_cast<int64_t>(kt) * vq::dtc::TILE_WORDS] = mine;
      rb = vq::dtc::row_bits(mine, lane);
    }
    if (kt < qt) {
      vq::cp_async_wait<1>();
    } else {
      vq::cp_async_wait<0>();
    }
    __syncthreads();

    // S and dP: lane holds rows (r0, r1) x keys kt 64 + 8 nb + 2 t, +1
    float s[8][4], dp[8][4];
    mma_abt<D>(s, qa, ks[st], lane);
    mma_abt<D>(dp, doa, vs[st], lane);
    if (kt == qt) {  // the diagonal tile: keys after the row masked by index (P = 0)
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (kt * TC_T + 8 * nb + 2 * t + (e & 1) > (e < 2 ? r0 : r1)) s[nb][e] = -CUDART_INF_F;
    }
    uint32_t sa[4][4];
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // the forward's kept logit; a dropped one has ds = 0
        const float p = ex2(fmaf(s[nb][e], c_keep, -(e < 2 ? lb0 : lb1)));
        ds[e] = vq::dtc::row_kept(rb, nb, e) ? p * (dp[nb][e] - (e < 2 ? dl0 : dl1)) * c_ds
                                              : 0.f;
      }
      sa[nb >> 1][2 * (nb & 1)] = vq::pack_bf16(ds[0], ds[1]);
      sa[nb >> 1][2 * (nb & 1) + 1] = vq::pack_bf16(ds[2], ds[3]);
    }
    mma_px<D>(dqa, sa, ks[st], lane);
    __syncthreads();
  }
  store_rows<D>(dq + base, dqa, r0, S, t);
}

// dk, dv: grid (N, S / 64); key tile kt = blockIdx.y, so the tiles with the
// most query tiles start first. Reads the delta and keep bits of drop_dq_tc.
template <int D>
__global__ void __launch_bounds__(32 * TC_WARPS)
    drop_dkdv_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 const uint32_t* __restrict__ bits, bf16* __restrict__ dk, bf16* __restrict__ dv,
                 int S, float c_keep, float neg_raw, float c_ds, uint32_t thr) {
  constexpr int DB = D / 8, RS = row_stride<D>();
  __shared__ __align__(16) bf16 qs[2][TC_T * RS], dos[2][TC_T * RS];
  __shared__ __align__(16) float ls[2][TC_T], dls[2][TC_T];
  __shared__ __align__(16) uint32_t bs[2][vq::dtc::TILE_WORDS];
  const int n = blockIdx.x, kt = blockIdx.y, nqt = gridDim.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const size_t base = static_cast<size_t>(n) * S * D;
  const float* lsen = lse + static_cast<size_t>(n) * S;
  const float* deln = delta + static_cast<size_t>(n) * S;
  const uint32_t* nbits = bits + static_cast<int64_t>(n) * vq::dtc::tile_index(nqt) *
                                     vq::dtc::TILE_WORDS;
  const int j0 = kt * TC_T + 16 * warp + g, j1 = j0 + 8;  // this lane's two key rows

  AFrag<D> ka, va;
  load_a<D>(ka, k + base, j0, S, t);
  load_a<D>(va, v + base, j0, S, t);

  // Q, dO, lse, delta and the keep bits of query tile qt into stage st; past S zero-filled
  auto load_tile = [&](int qt, int st) {
    stage_rows<D>(qs[st], q + base, qt * TC_T, S, tid);
    stage_rows<D>(dos[st], dout + base, qt * TC_T, S, tid);
    const int e = tid & (TC_T - 1), i = qt * TC_T + e;
    const float* src = (tid < TC_T ? lsen : deln) + (i < S ? i : S - 1);
    vq::cp_async4(vq::smem_u32((tid < TC_T ? ls[st] : dls[st]) + e), src, i < S ? 4 : 0);
    if (thr && tid < vq::dtc::TILE_WORDS / 4)
      vq::cp_async16(vq::smem_u32(bs[st] + 4 * tid),
                     nbits + (vq::dtc::tile_index(qt) + kt) * vq::dtc::TILE_WORDS + 4 * tid, 16);
    vq::cp_async_commit();
  };

  float dka[DB][4], dva[DB][4];
#pragma unroll
  for (int nd = 0; nd < DB; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[nd][e] = dva[nd][e] = 0.f;

  load_tile(kt, 0);
  for (int qt = kt; qt < nqt; ++qt) {
    const int st = (qt - kt) & 1;
    if (qt + 1 < nqt) {
      load_tile(qt + 1, st ^ 1);
      vq::cp_async_wait<1>();
    } else {
      vq::cp_async_wait<0>();
    }
    __syncthreads();

    // S^T and dP^T: lane holds keys (j0, j1) x queries qt 64 + 8 nb + 2 t, +1
    float s[8][4], dp[8][4];
    mma_abt<D>(s, ka, qs[st], lane);
    mma_abt<D>(dp, va, dos[st], lane);
    uint32_t wd[8][2];
    if (thr) {
      vq::dtc::column_bits(wd, bs[st], warp, lane);
    } else {
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) wd[nb][0] = wd[nb][1] = ~0u;
    }
    // P^T (dropped logits included) and dS^T in fp32, packed as the bf16 A
    // fragments of dV and dK
    uint32_t pa[4][4], sa[4][4];
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      const float2 l2 = *reinterpret_cast<const float2*>(ls[st] + 8 * nb + 2 * t);
      const float2 d2 = *reinterpret_cast<const float2*>(dls[st] + 8 * nb + 2 * t);
      const float lb0 = l2.x * LOG2E, lb1 = l2.y * LOG2E;
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool kept = vq::dtc::column_kept(wd, nb, e);
        float x = kept ? s[nb][e] : neg_raw;
        if (qt == kt && qt * TC_T + 8 * nb + 2 * t + (e & 1) < (e < 2 ? j0 : j1))
          x = -CUDART_INF_F;  // the diagonal tile: queries before the key
        p[e] = ex2(fmaf(x, c_keep, -((e & 1) ? lb1 : lb0)));
        ds[e] = kept ? p[e] * (dp[nb][e] - ((e & 1) ? d2.y : d2.x)) * c_ds : 0.f;
      }
      pa[nb >> 1][2 * (nb & 1)] = vq::pack_bf16(p[0], p[1]);
      pa[nb >> 1][2 * (nb & 1) + 1] = vq::pack_bf16(p[2], p[3]);
      sa[nb >> 1][2 * (nb & 1)] = vq::pack_bf16(ds[0], ds[1]);
      sa[nb >> 1][2 * (nb & 1) + 1] = vq::pack_bf16(ds[2], ds[3]);
    }
    mma_px<D>(dva, pa, dos[st], lane);
    mma_px<D>(dka, sa, qs[st], lane);
    __syncthreads();  // every warp is done with stage st before it is refilled
  }
  store_rows<D>(dk + base, dka, j0, S, t);
  store_rows<D>(dv + base, dva, j0, S, t);
}

template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v, const void* o,
                      const void* dout, const float* lse, float* delta, const int64_t* seed,
                      uint32_t* bits, void* dq, void* dk, void* dv, int N, int S, float scale,
                      uint32_t thr, float inv_keep, cudaStream_t st) {
  const bf16 *qt = static_cast<const bf16*>(q), *kt = static_cast<const bf16*>(k);
  const bf16 *vt = static_cast<const bf16*>(v), *dot = static_cast<const bf16*>(dout);
  const dim3 grid(N, (S + TC_T - 1) / TC_T);
  const float c_ds = scale * inv_keep, c_keep = c_ds * LOG2E, neg_raw = -1000.f / c_ds;
  drop_dq_tc<D><<<grid, 32 * TC_WARPS, 0, st>>>(qt, kt, vt, static_cast<const bf16*>(o), dot,
                                                lse, delta, seed, bits, static_cast<bf16*>(dq),
                                                S, c_keep, c_ds, thr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  drop_dkdv_tc<D><<<grid, 32 * TC_WARPS, 0, st>>>(qt, kt, vt, dot, lse, delta, bits,
                                                  static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                                                  S, c_keep, neg_raw, c_ds, thr);
  return cudaGetLastError();
}

cudaError_t dispatch_tc(const void* q, const void* k, const void* v, const void* o,
                        const void* dout, const float* lse, float* delta, const int64_t* seed,
                        uint32_t* bits, void* dq, void* dk, void* dv, int N, int S, int D,
                        float scale, uint32_t thr, float inv_keep, cudaStream_t s) {
  switch (D) {
    case 8:
      return launch_tc<8>(q, k, v, o, dout, lse, delta, seed, bits, dq, dk, dv, N, S, scale,
                          thr, inv_keep, s);
    case 16:
      return launch_tc<16>(q, k, v, o, dout, lse, delta, seed, bits, dq, dk, dv, N, S, scale,
                           thr, inv_keep, s);
    case 32:
      return launch_tc<32>(q, k, v, o, dout, lse, delta, seed, bits, dq, dk, dv, N, S, scale,
                           thr, inv_keep, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, o, dout, dq, dk, dv: (N, S, D) contiguous, fp32 or bf16 (is_bf16);
// lse (N, S) fp32 from the forward; delta (N, S) fp32 scratch; seed, thr and
// inv_keep as the forward's. tensor_cores (bf16 only; ops/
// flash_dropout_attention.py::dropout_tensor_core_route) takes drop_dq_tc and
// drop_dkdv_tc, whose 16-byte row copies need q, k, v, dout 16-byte aligned,
// and at thr > 0 `bits`: N x T x 128 uint32 scratch (T = nqt (nqt + 1) / 2,
// nqt = ceil(S / 64); 16-byte aligned) for the packed keep bits; otherwise
// the CUDA-core drop_delta, drop_dkdv, drop_dq, and bits is unused.
extern "C" int vq_flash_dropout_bwd(int is_bf16, int tensor_cores, const void* q, const void* k,
                                    const void* v, const void* o, const void* dout,
                                    const float* lse, float* delta, const int64_t* seed,
                                    uint32_t* bits, void* dq, void* dk, void* dv, int N, int S,
                                    int D, float scale, uint32_t thr, float inv_keep,
                                    void* stream) {
  if (N <= 0 || N > 65535 || S <= 0 || (tensor_cores && !is_bf16)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tensor_cores) {
    if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout) |
         reinterpret_cast<uintptr_t>(bits)) & 15) {
      return cudaErrorMisalignedAddress;
    }
    if (thr && !bits) return cudaErrorInvalidValue;
    return dispatch_tc(q, k, v, o, dout, lse, delta, seed, bits, dq, dk, dv, N, S, D, scale, thr,
                       inv_keep, s);
  }
  if (is_bf16)
    return dispatch<__nv_bfloat16>(q, k, v, o, dout, lse, delta, seed, dq, dk, dv, N, S, D,
                                   scale, thr, inv_keep, s);
  return dispatch<float>(q, k, v, o, dout, lse, delta, seed, dq, dk, dv, N, S, D, scale, thr,
                         inv_keep, s);
}
