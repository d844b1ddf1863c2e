// Kernel K8, backward: the gradients of causal flash attention.
//
// Replaces the backward of vqvae3d_tpu/models/causal_blocks.py:
// _flash_causal_attention (the bundled Pallas flash_attention's custom VJP,
// its dq and dkv kernels). The forward is csrc/flash_attention.cu; the
// contract and the plain version (flash_attention_bwd_plain) are in
// ops/flash_attention.py. With P[i, j] = exp(s[i, j] - lse[i]) for j <= i,
// s = q.k * scale:
//
//   delta[i] = sum_d do[i, d] o[i, d]
//   dv[j]    = sum_{i >= j} P[i, j] do[i]
//   ds[i, j] = P[i, j] (do[i] . v[j] - delta[i]) scale
//   dk[j]    = sum_{i >= j} ds[i, j] q[i]
//   dq[i]    = sum_{j <= i} ds[i, j] k[j]
//
// FlashAttention-2's split on both routes: one kernel for delta, one for dk
// and dv (key-major, walking the query tiles from its diagonal to S), one for
// dq (query-major, walking the key tiles up to its diagonal). P is recomputed
// from the saved lse in both. Every sum is taken in a fixed order over a
// fixed partition, with no atomics, so two calls give bit-identical
// gradients. Keys and queries past S are zero-filled and past the diagonal
// masked by index, so S need not be a multiple of the tiles. Two routes,
// chosen by the dtype before any launch:
//
// bf16 (the training path): tensor cores, bwd_dkdv_tc and bwd_dq_tc, laid out
// as the forward's flash_fwd_tc (4 warps x 16 rows a CTA, tiles of 64 on the
// other axis staged by cp.async in two stages, mma.sync m16n8k8 at D = 8 and
// m16n8k16 at D = 16, 32; fragment maps in csrc/mma.cuh).
//  * dk/dv: a warp holds 16 key rows' K and V as A fragments and, per query
//    tile, computes S^T = K Q^T and dP^T = V dO^T (Q's and dO's B fragments
//    by plain ldmatrix), P^T = exp2(S^T scale log2(e) - lse log2(e)) and
//    dS^T = P^T (dP^T - delta) scale in fp32 on the C fragments (lse and
//    delta of the tile's 64 queries staged beside Q and dO), then
//    dV += bf16(P^T) dO and dK += bf16(dS^T) Q: the C fragments packed into
//    A fragments in registers, dO's and Q's B fragments by ldmatrix.trans.
//  * dq: a warp holds 16 query rows' Q and dO as A fragments, computes S =
//    Q K^T and dP = dO V^T per key tile, P and dS as above (lse and delta of
//    its two rows in registers), dQ += bf16(dS) K with K by ldmatrix.trans.
//  Tiles wholly off the diagonal run unmasked; the diagonal tile masks by
//  index. Rounding as the TPU kernel's backward: P to bf16 for dV, dS (with
//  its scale) to bf16 for dK and for dQ, every accumulation fp32, each
//  gradient rounded to bf16 once.
//
// fp32: the CUDA cores, bwd_dkdv and bwd_dq (tensor cores would round to
// TF32): a thread per key row (dk/dv) or per query row (dq), the tiles staged
// in shared memory, nothing rounded but the gradients.
//
// What bounds it on the H100: at the published mid PixelSNAIL (N = 24,
// S = 8192, D = 8, bf16) one call has 0.8 G causal logits: 10 D flops each
// (q.k, do.v, dv, dk, dq; 26 us at the bf16 tensor-core rate) against ~25 MB
// of operands and gradients (7.5 us), and one exp a logit (0.19 ms at the
// special-function rate). This design's two passes evaluate each exp twice,
// so its own floor is ~0.39 ms, plus the ~10 CUDA-core instructions a logit
// of the two passes' softmax arithmetic and packing (~0.24 ms at 33.5 T/s).
#include "common.cuh"
#include "flash_tc.cuh"

#include <math_constants.h>

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

// ---- bf16: tensor cores ----

using namespace vq::ftc;

// dk, dv: grid (N, S / 64); key tile kt = blockIdx.y, so the tiles with the
// most query tiles start first
template <int D>
__global__ void __launch_bounds__(32 * TC_WARPS)
    bwd_dkdv_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                bf16* __restrict__ dk, bf16* __restrict__ dv, int S, float scale,
                float scale_log2) {
  constexpr int DB = D / 8, RS = row_stride<D>();
  __shared__ __align__(16) bf16 qs[2][TC_T * RS], dos[2][TC_T * RS];
  __shared__ __align__(16) float ls[2][TC_T], dls[2][TC_T];
  const int n = blockIdx.x, kt = blockIdx.y, nqt = (S + TC_T - 1) / TC_T;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const size_t base = static_cast<size_t>(n) * S * D;
  const float* lsen = lse + static_cast<size_t>(n) * S;
  const float* deln = delta + static_cast<size_t>(n) * S;
  const int j0 = kt * TC_T + 16 * warp + g, j1 = j0 + 8;  // this lane's two key rows

  AFrag<D> ka, va;
  load_a<D>(ka, k + base, j0, S, t);
  load_a<D>(va, v + base, j0, S, t);

  // Q, dO, lse and delta of query tile qt into stage st; past S zero-filled
  auto load_tile = [&](int qt, int st) {
    stage_rows<D>(qs[st], q + base, qt * TC_T, S, tid);
    stage_rows<D>(dos[st], dout + base, qt * TC_T, S, tid);
    const int e = tid & (TC_T - 1), i = qt * TC_T + e;
    const float* src = (tid < TC_T ? lsen : deln) + (i < S ? i : S - 1);
    vq::cp_async4(vq::smem_u32((tid < TC_T ? ls[st] : dls[st]) + e), src, i < S ? 4 : 0);
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
    if (qt == kt) {  // the diagonal tile: queries before the key masked by index
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (qt * TC_T + 8 * nb + 2 * t + (e & 1) < (e < 2 ? j0 : j1)) s[nb][e] = -CUDART_INF_F;
    }
    // P^T and dS^T in fp32, packed as the bf16 A fragments of dV and dK
    uint32_t pa[4][4], sa[4][4];
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      const float2 l2 = *reinterpret_cast<const float2*>(ls[st] + 8 * nb + 2 * t);
      const float2 d2 = *reinterpret_cast<const float2*>(dls[st] + 8 * nb + 2 * t);
      const float lb0 = l2.x * LOG2E, lb1 = l2.y * LOG2E;
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = ex2(fmaf(s[nb][e], scale_log2, -((e & 1) ? lb1 : lb0)));
        ds[e] = p[e] * (dp[nb][e] - ((e & 1) ? d2.y : d2.x)) * scale;
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

// dq: grid (N, S / 64); query tile qt = gridDim.y - 1 - blockIdx.y, heavy first
template <int D>
__global__ void __launch_bounds__(32 * TC_WARPS)
    bwd_dq_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dq, int S, float scale, float scale_log2) {
  constexpr int DB = D / 8, RS = row_stride<D>();
  __shared__ __align__(16) bf16 ks[2][TC_T * RS], vs[2][TC_T * RS];
  const int n = blockIdx.x, qt = gridDim.y - 1 - blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const size_t base = static_cast<size_t>(n) * S * D;
  const int r0 = qt * TC_T + 16 * warp + g, r1 = r0 + 8;  // this lane's two query rows

  AFrag<D> qa, doa;
  load_a<D>(qa, q + base, r0, S, t);
  load_a<D>(doa, dout + base, r0, S, t);
  const size_t row = static_cast<size_t>(n) * S;
  const float lb0 = r0 < S ? lse[row + r0] * LOG2E : 0.f, lb1 = r1 < S ? lse[row + r1] * LOG2E : 0.f;
  const float dl0 = r0 < S ? delta[row + r0] : 0.f, dl1 = r1 < S ? delta[row + r1] : 0.f;

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
    if (kt < qt) {
      load_tile(kt + 1, st ^ 1);
      vq::cp_async_wait<1>();
    } else {
      vq::cp_async_wait<0>();
    }
    __syncthreads();

    // S and dP: lane holds rows (r0, r1) x keys kt 64 + 8 nb + 2 t, +1
    float s[8][4], dp[8][4];
    mma_abt<D>(s, qa, ks[st], lane);
    mma_abt<D>(dp, doa, vs[st], lane);
    if (kt == qt) {  // the diagonal tile: keys after the row masked by index
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
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(fmaf(s[nb][e], scale_log2, -(e < 2 ? lb0 : lb1)));
        ds[e] = p * (dp[nb][e] - (e < 2 ? dl0 : dl1)) * scale;
      }
      sa[nb >> 1][2 * (nb & 1)] = vq::pack_bf16(ds[0], ds[1]);
      sa[nb >> 1][2 * (nb & 1) + 1] = vq::pack_bf16(ds[2], ds[3]);
    }
    mma_px<D>(dqa, sa, ks[st], lane);
    __syncthreads();
  }
  store_rows<D>(dq + base, dqa, r0, S, t);
}

template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v, const void* o,
                      const void* dout, const float* lse, float* delta, void* dq, void* dk,
                      void* dv, int N, int S, float scale, cudaStream_t st) {
  const bf16 *qt = static_cast<const bf16*>(q), *kt = static_cast<const bf16*>(k);
  const bf16 *vt = static_cast<const bf16*>(v), *dot = static_cast<const bf16*>(dout);
  const int64_t rows = static_cast<int64_t>(N) * S;
  bwd_delta<bf16, D><<<static_cast<unsigned>((rows + 255) / 256), 256, 0, st>>>(
      static_cast<const bf16*>(o), dot, delta, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid(N, (S + TC_T - 1) / TC_T);
  const float sl2 = scale * LOG2E;
  bwd_dkdv_tc<D><<<grid, 32 * TC_WARPS, 0, st>>>(qt, kt, vt, dot, lse, delta,
                                                 static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                                                 S, scale, sl2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dq_tc<D><<<grid, 32 * TC_WARPS, 0, st>>>(qt, kt, vt, dot, lse, delta,
                                               static_cast<bf16*>(dq), S, scale, sl2);
  return cudaGetLastError();
}

cudaError_t dispatch_tc(const void* q, const void* k, const void* v, const void* o,
                        const void* dout, const float* lse, float* delta, void* dq, void* dk,
                        void* dv, int N, int S, int D, float scale, cudaStream_t s) {
  switch (D) {
    case 8: return launch_tc<8>(q, k, v, o, dout, lse, delta, dq, dk, dv, N, S, scale, s);
    case 16: return launch_tc<16>(q, k, v, o, dout, lse, delta, dq, dk, dv, N, S, scale, s);
    case 32: return launch_tc<32>(q, k, v, o, dout, lse, delta, dq, dk, dv, N, S, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, o, dout, dq, dk, dv: (N, S, D) contiguous, fp32 or bf16 (is_bf16;
// the bf16 route copies 16-byte rows, so its q, k, v, dout start 16-byte
// aligned); lse (N, S) fp32 from the forward; delta (N, S) fp32 scratch.
// D in {8, 16, 32}; N <= 65535 (grid.y of the fp32 route).
extern "C" int vq_flash_attn_bwd(int is_bf16, const void* q, const void* k, const void* v,
                                 const void* o, const void* dout, const float* lse, float* delta,
                                 void* dq, void* dk, void* dv, int N, int S, int D, float scale,
                                 void* stream) {
  if (N <= 0 || N > 65535 || S <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout)) & 15) {
      return cudaErrorMisalignedAddress;
    }
    return dispatch_tc(q, k, v, o, dout, lse, delta, dq, dk, dv, N, S, D, scale, s);
  }
  return dispatch<float>(q, k, v, o, dout, lse, delta, dq, dk, dv, N, S, D, scale, s);
}
