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
// Two routes, chosen by ops/flash_dropout_attention.py::dropout_tensor_core_route
// before any launch (neither is a fallback of the other):
//
// bf16 (the training path): tensor cores, flash_dropout_fwd_tc, K8's
// flash_fwd_tc (csrc/flash_attention.cu: 4 warps x 16 query rows a CTA, key
// tiles of 64 staged by cp.async in two stages, S = Q.K^T on mma.sync, the
// online softmax on the fp32 C fragments, P re-packed in registers as the A
// fragments of P.V, the diagonal tile masked by index, heavy query tiles
// first) with the mask on S's C fragments: the logits in units of the dot,
// x = keep ? dot : -1e3 / (scale inv_keep), then -inf past the row, so the
// row max counts a dropped logit and never a masked one, and P is K8's one
// FFMA and exp2 with scale inv_keep log2(e) folded in. The
// bits come from csrc/dropout_tc.cuh: per 64-key tile each lane makes 8
// Philox calls (its row's groups of the keys its lane pair holds), one
// xor-1 shuffle trades rows with its pair, every call is made once, and the
// calls run while the tile's copies land. Rounding as the TPU kernel
// (:148-151) and K8's route: P rounded to bf16 for P.V, l and lse from the
// fp32 P, o rounded to bf16 once.
//
// fp32: the CUDA cores, flash_dropout_fwd (tensor cores would round to TF32;
// the first design): K8's CUDA-core forward (a thread a query row, BQ = 64 rows
// a block, BK = 64 keys staged in shared memory, an online softmax over
// chunks of 16 keys) with four Philox calls per chunk; q, k, v widened, every
// sum fp32, o rounded once.
//
// Both skip Philox at p = 0 (thr = 0). Keys past the row and past S are
// masked by index, rows past S store nothing; no atomics, so a second call is
// bit-identical.
//
// What bounds it on the H100: at the mid PixelSNAIL (N = 24, S = 8192, D = 8,
// bf16) one call has 0.8 G causal logits, each 4 D flops, one exp and a
// quarter of a Philox-10 (10 rounds of two 32x32 products and two 3-way xors)
// plus a compare, 11 integer operations a logit: 26 GFLOP of products (26 us
// at the bf16 tensor-core rate), 0.8 G exps (0.19 ms at the special-function
// rate) and 8.9 G integer operations (0.26 ms at 33.5 T int32 operations/s:
// an SM's 64 INT32 lanes and the 64 FMA lanes that take IMAD, at 1.98 GHz)
// against 12.6 MB of operands (3.8 us at 3.35 TB/s): the mask's integer work
// bounds it. The tensor-core route leaves the CUDA cores the mask and the
// softmax. A Philox call compiles to ~55 instructions (utils/sass_report.py:
// 18 IMAD.WIDE.U32, the first two rounds' second products hoisted since the
// row and the stream are fixed for a lane, and 20 LOP3); the IMAD.WIDE.U32
// run on the FMA pipe that the softmax's FP32 work shares, so the mask alone
// takes ~0.62 ms a mid call on the card and adds to the softmax (PERF.md).
#include "common.cuh"
#include "dropout_tc.cuh"
#include "mma.cuh"
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

// ---- bf16: tensor cores ----

constexpr int TC_WARPS = 4, TC_BQ = 16 * TC_WARPS, TC_BK = 64;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(x));
  return r;
}

// K8's flash_fwd_tc (csrc/flash_attention.cu) with the mask on its C
// fragments: grid (N, S / TC_BQ), query tile qt = gridDim.y - 1 - blockIdx.y,
// so the tiles with the most keys start first. Logits in units of the dot:
// x = keep ? dot : neg_raw (= -1e3 / (scale inv_keep)), then -inf past the
// row; m is their running max, P = exp2(x c_keep - m c_keep) with
// c_keep = scale inv_keep log2(e), one FFMA as in K8.
template <int D, bool COLLECT>
__global__ void __launch_bounds__(32 * TC_WARPS)
    flash_dropout_fwd_tc(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                         float* __restrict__ lse, const int64_t* __restrict__ seed,
                         uint8_t* __restrict__ mask, int S, float c_keep, float neg_raw,
                         float c_lse, uint32_t thr) {
  constexpr int DB = D / 8;               // 8-wide blocks of the head dim
  constexpr int RS = D == 8 ? 8 : D + 8;  // shared row stride: ldmatrix without bank conflicts
  __shared__ __align__(16) __nv_bfloat16 ks[2][TC_BK * RS], vs[2][TC_BK * RS];
  const int n = blockIdx.x, qt = gridDim.y - 1 - blockIdx.y, q0 = qt * TC_BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const size_t base = static_cast<size_t>(n) * S * D;
  const int r0 = q0 + 16 * warp + g, r1 = r0 + 8;  // this lane's two query rows
  const vq::PhiloxKeys keys =
      vq::philox_round_keys(static_cast<uint32_t>(seed[0]), static_cast<uint32_t>(seed[1]));
  const uint32_t row_mine = static_cast<uint32_t>((lane & 1) ? r1 : r0);

  // Q's A fragments, straight from device memory (rows past S read as 0)
  uint32_t qa[DB == 1 ? 1 : DB / 2][4];
  {
    const uint32_t* q32 = reinterpret_cast<const uint32_t*>(q + base);
    auto ld = [&](int row, int col) -> uint32_t {
      return row < S ? q32[(static_cast<size_t>(row) * D + col) / 2] : 0u;
    };
    if constexpr (D == 8) {
      qa[0][0] = ld(r0, 2 * t);
      qa[0][1] = ld(r1, 2 * t);
    } else {
#pragma unroll
      for (int kk = 0; kk < DB / 2; ++kk) {
        qa[kk][0] = ld(r0, 16 * kk + 2 * t);
        qa[kk][1] = ld(r1, 16 * kk + 2 * t);
        qa[kk][2] = ld(r0, 16 * kk + 8 + 2 * t);
        qa[kk][3] = ld(r1, 16 * kk + 8 + 2 * t);
      }
    }
  }

  // K and V rows k0 .. k0 + 63 into stage st, 16 bytes a copy; keys past S zero-filled
  auto load_tile = [&](int kt, int st) {
    const int k0 = kt * TC_BK;
#pragma unroll
    for (int e = tid; e < 2 * TC_BK * DB; e += 32 * TC_WARPS) {
      const int which = e / (TC_BK * DB), row = (e % (TC_BK * DB)) / DB, c = e % DB;
      const int j = k0 + row;
      const __nv_bfloat16* src =
          (which ? v : k) + base + static_cast<size_t>(j < S ? j : S - 1) * D + 8 * c;
      __nv_bfloat16* dst = (which ? vs[st] : ks[st]) + row * RS + 8 * c;
      vq::cp_async16(vq::smem_u32(dst), src, j < S ? 16 : 0);
    }
    vq::cp_async_commit();
  };

  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;
  float oacc[DB][4];
#pragma unroll
  for (int nd = 0; nd < DB; ++nd) oacc[nd][0] = oacc[nd][1] = oacc[nd][2] = oacc[nd][3] = 0.f;

  load_tile(0, 0);
  for (int kt = 0; kt <= qt; ++kt) {
    const int st = kt & 1;
    if (kt < qt) load_tile(kt + 1, st ^ 1);
    // the tile's keep bits while the copies land: every logit's Philox call once
    vq::dtc::RowBits rb{~0u, ~0u};
    if (thr) rb = vq::dtc::row_bits(vq::dtc::lane_keep_word(kt, t, row_mine, n, keys, thr), lane);
    if (kt < qt) {
      vq::cp_async_wait<1>();
    } else {
      vq::cp_async_wait<0>();
    }
    __syncthreads();

    // K's B fragments: matrix m = nb * DB + db holds keys 8 nb .. 8 nb + 7 at d 8 db .. 8 db + 7
    uint32_t kb[8 * DB];
#pragma unroll
    for (int c = 0; c < 2 * DB; ++c) {
      const int m = 4 * c + (lane >> 3), nb = m / DB, db = m % DB;
      uint32_t r[4];
      vq::ldsm_x4(r, vq::smem_u32(ks[st] + (8 * nb + (lane & 7)) * RS + 8 * db));
#pragma unroll
      for (int i = 0; i < 4; ++i) kb[4 * c + i] = r[i];
    }
    // S = Q K^T: 8 n-blocks of 8 keys; lane holds rows (r0, r1) x keys 8 nb + 2 t, +1
    float s[8][4];
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
      if constexpr (D == 8) {
        vq::mma_1688(s[nb], qa[0][0], qa[0][1], kb[nb]);
      } else {
#pragma unroll
        for (int kk = 0; kk < DB / 2; ++kk)
          vq::mma_16816(s[nb], qa[kk], kb[nb * DB + 2 * kk], kb[nb * DB + 2 * kk + 1]);
      }
    }
    // dropout, then the causal mask (the diagonal tile: keys after the row by index)
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = vq::dtc::row_kept(rb, nb, e) ? s[nb][e] : neg_raw;
    if (kt == qt) {
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (kt * TC_BK + 8 * nb + 2 * t + (e & 1) > (e < 2 ? r0 : r1)) s[nb][e] = -CUDART_INF_F;
    }
    if constexpr (COLLECT) {
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = kt * TC_BK + 8 * nb + 2 * t + (e & 1), row = e < 2 ? r0 : r1;
          if (j <= row && row < S)
            mask[(static_cast<size_t>(n) * S + row) * S + j] =
                static_cast<uint8_t>(vq::dtc::row_kept(rb, nb, e));
        }
    }
    // online softmax on the fragments: the row max over the quad counts a
    // dropped -1e3 and never a masked -inf (key 0 is in every row's first
    // tile, so m is finite from the first tile on; m = -inf before it gives
    // alpha = 0)
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      mx0 = fmaxf(mx0, fmaxf(s[nb][0], s[nb][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nb][2], s[nb][3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float al0 = ex2((m0 - mx0) * c_keep), al1 = ex2((m1 - mx1) * c_keep);
    m0 = mx0;
    m1 = mx1;
    const float mb0 = mx0 * c_keep, mb1 = mx1 * c_keep;
    // P = exp2(x c_keep - m c_keep): summed in fp32, packed as the bf16 A
    // fragments of P.V (k-step kk: n-blocks 2 kk and 2 kk + 1)
    float ls0 = 0.f, ls1 = 0.f;
    uint32_t pa[4][4];
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      const float p0 = ex2(fmaf(s[nb][0], c_keep, -mb0));
      const float p1 = ex2(fmaf(s[nb][1], c_keep, -mb0));
      const float p2 = ex2(fmaf(s[nb][2], c_keep, -mb1));
      const float p3 = ex2(fmaf(s[nb][3], c_keep, -mb1));
      ls0 += p0 + p1;
      ls1 += p2 + p3;
      pa[nb >> 1][2 * (nb & 1)] = vq::pack_bf16(p0, p1);
      pa[nb >> 1][2 * (nb & 1) + 1] = vq::pack_bf16(p2, p3);
    }
    l0 = fmaf(l0, al0, ls0);
    l1 = fmaf(l1, al1, ls1);
#pragma unroll
    for (int nd = 0; nd < DB; ++nd) {
      oacc[nd][0] *= al0;
      oacc[nd][1] *= al0;
      oacc[nd][2] *= al1;
      oacc[nd][3] *= al1;
    }
    // O += P V, V's B fragments by ldmatrix.trans (keys down the rows)
    if constexpr (D == 8) {
#pragma unroll
      for (int kk = 0; kk < 4; kk += 2) {  // lane L addresses key 16 kk + L
        uint32_t r[4];
        vq::ldsm_x4_t(r, vq::smem_u32(vs[st] + (16 * kk + lane) * RS));
        vq::mma_16816(oacc[0], pa[kk], r[0], r[1]);
        vq::mma_16816(oacc[0], pa[kk + 1], r[2], r[3]);
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int nd = 0; nd < DB; nd += 2) {  // lanes 16-31 address d block nd + 1
          uint32_t r[4];
          vq::ldsm_x4_t(r, vq::smem_u32(vs[st] + (16 * kk + (lane & 15)) * RS +
                                        8 * (nd + (lane >> 4))));
          vq::mma_16816(oacc[nd], pa[kk], r[0], r[1]);
          vq::mma_16816(oacc[nd + 1], pa[kk], r[2], r[3]);
        }
    }
    __syncthreads();  // every warp is done with stage st before it is refilled
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float i0 = 1.f / l0, i1 = 1.f / l1;
  uint32_t* o32 = reinterpret_cast<uint32_t*>(o + base);
#pragma unroll
  for (int nd = 0; nd < DB; ++nd) {
    if (r0 < S)
      o32[(static_cast<size_t>(r0) * D + 8 * nd + 2 * t) / 2] =
          vq::pack_bf16(oacc[nd][0] * i0, oacc[nd][1] * i0);
    if (r1 < S)
      o32[(static_cast<size_t>(r1) * D + 8 * nd + 2 * t) / 2] =
          vq::pack_bf16(oacc[nd][2] * i1, oacc[nd][3] * i1);
  }
  if (t == 0) {  // the natural log-sum-exp: m scale inv_keep + log(l)
    if (r0 < S) lse[static_cast<size_t>(n) * S + r0] = m0 * c_lse + logf(l0);
    if (r1 < S) lse[static_cast<size_t>(n) * S + r1] = m1 * c_lse + logf(l1);
  }
}

template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o, float* lse,
                      const int64_t* seed, uint8_t* mask, int N, int S, float scale,
                      uint32_t thr, float inv_keep, cudaStream_t stream) {
  using T = __nv_bfloat16;
  const dim3 grid(N, (S + TC_BQ - 1) / TC_BQ);
  const T *qt = static_cast<const T*>(q), *kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const float c_lse = scale * inv_keep, c_keep = c_lse * LOG2E, neg_raw = -1000.f / c_lse;
  if (mask)
    flash_dropout_fwd_tc<D, true><<<grid, 32 * TC_WARPS, 0, stream>>>(
        qt, kt, vt, static_cast<T*>(o), lse, seed, mask, S, c_keep, neg_raw, c_lse, thr);
  else
    flash_dropout_fwd_tc<D, false><<<grid, 32 * TC_WARPS, 0, stream>>>(
        qt, kt, vt, static_cast<T*>(o), lse, seed, nullptr, S, c_keep, neg_raw, c_lse, thr);
  return cudaGetLastError();
}

cudaError_t dispatch_tc(const void* q, const void* k, const void* v, void* o, float* lse,
                        const int64_t* seed, uint8_t* mask, int N, int S, int D, float scale,
                        uint32_t thr, float inv_keep, cudaStream_t s) {
  switch (D) {
    case 8: return launch_tc<8>(q, k, v, o, lse, seed, mask, N, S, scale, thr, inv_keep, s);
    case 16: return launch_tc<16>(q, k, v, o, lse, seed, mask, N, S, scale, thr, inv_keep, s);
    case 32: return launch_tc<32>(q, k, v, o, lse, seed, mask, N, S, scale, thr, inv_keep, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, o: (N, S, D) contiguous, fp32 or bf16 (is_bf16); lse (N, S) fp32;
// seed: two int64 on the device, the Philox key words in their low 32 bits;
// mask: null, or (N, S, S) uint8 to receive the keep bits of j <= i.
// tensor_cores (bf16 only; ops/flash_dropout_attention.py::
// dropout_tensor_core_route chooses it) takes flash_dropout_fwd_tc, whose
// 16-byte row copies need q, k, v 16-byte aligned; otherwise the CUDA-core
// flash_dropout_fwd. D in {8, 16, 32}; N <= 65535; thr = round(p 2^32);
// inv_keep = 1 / (1 - p).
extern "C" int vq_flash_dropout_fwd(int is_bf16, int tensor_cores, const void* q, const void* k,
                                    const void* v, void* o, float* lse, const int64_t* seed,
                                    uint8_t* mask, int N, int S, int D, float scale, uint32_t thr,
                                    float inv_keep, void* stream) {
  if (N <= 0 || N > 65535 || S <= 0 || (tensor_cores && !is_bf16)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tensor_cores) {
    if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
         reinterpret_cast<uintptr_t>(v)) & 15) {
      return cudaErrorMisalignedAddress;
    }
    return dispatch_tc(q, k, v, o, lse, seed, mask, N, S, D, scale, thr, inv_keep, s);
  }
  if (is_bf16)
    return dispatch<__nv_bfloat16>(q, k, v, o, lse, seed, mask, N, S, D, scale, thr, inv_keep, s);
  return dispatch<float>(q, k, v, o, lse, seed, mask, N, S, D, scale, thr, inv_keep, s);
}
