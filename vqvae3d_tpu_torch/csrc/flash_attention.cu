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
// Two routes, chosen by the dtype before any launch (neither is a fallback
// of the other):
//
// bf16 (the training path): tensor cores, flash_fwd_tc. A CTA of 4 warps owns
// 64 query rows, 16 a warp, and walks the key tiles of 64 keys up to its
// diagonal, staged in shared memory by cp.async in two stages. S = Q.K^T is
// mma.sync (m16n8k8 at D = 8, one or two m16n8k16 steps at D = 16, 32) with
// Q's A fragments in registers and K's B fragments by ldmatrix; the online
// softmax runs on the fp32 accumulator fragments (the row max over the quad
// by __shfl_xor_sync, exp2 of one FMA with scale * log2(e) folded in, the
// row sum kept per lane and summed over the quad once at the end); P's C
// fragments are packed in registers into the bf16 A fragments of the
// m16n8k16 P.V, V's B fragments by ldmatrix.trans. Tiles wholly below the
// diagonal run unmasked, the diagonal tile masks by index, tiles above it
// are never loaded; CTAs start on the longest query tiles. Rounding: P is
// rounded to bf16 for the P.V product (the TPU kernel's p.astype(v.dtype)),
// the sums l and lse come from the fp32 P, o is rounded to bf16 once.
//
// fp32: the CUDA cores, flash_fwd (tensor cores would round q, k, v and P to
// TF32). One thread per query row, BQ = 64 rows a block, grid (S / BQ, N);
// the block stages BK = 64 keys and values in shared memory (a broadcast to
// every thread), each thread runs the online softmax over chunks of 16 keys
// in fp32; nothing is rounded but o.
//
// Keys past the row (j > i) and past S are masked by index on both routes,
// so S need not be a multiple of the tiles (the TPU path pads S to 128; here
// no padded row or lane ever reaches a result). Rows past S store nothing.
// No atomics: a second call is bit-identical.
//
// What bounds it on the H100: at the published mid PixelSNAIL (N = 24,
// S = 8192, D = 8, bf16) one call has N S (S + 1) / 2 = 0.8 G causal logits,
// each one exp and 4 D flops (q.k and p.v). The exps run on the
// special-function units, 16 a clock an SM (~4.2 T/s): 0.19 ms; the softmax's
// other ~5 CUDA-core instructions a logit ~0.12 ms; the products 26 GFLOP,
// 26 us on the bf16 tensor cores; the 12.6 MB of q, k, v and o 3.8 us.
// Operations bound it, the exps first: the tensor-core route leaves the
// CUDA cores only the softmax.
#include "common.cuh"
#include "mma.cuh"

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

// ---- bf16: tensor cores ----

constexpr int TC_WARPS = 4, TC_BQ = 16 * TC_WARPS, TC_BK = 64;

__device__ __forceinline__ float ex2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(x));
  return r;
}

// grid (N, S / TC_BQ); query tile qt = gridDim.y - 1 - blockIdx.y, so the
// tiles with the most keys start first.
template <int D>
__global__ void __launch_bounds__(32 * TC_WARPS)
    flash_fwd_tc(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                 float* __restrict__ lse, int S, float scale, float scale_log2) {
  constexpr int DB = D / 8;               // 8-wide blocks of the head dim
  constexpr int RS = D == 8 ? 8 : D + 8;  // shared row stride: ldmatrix without bank conflicts
  __shared__ __align__(16) __nv_bfloat16 ks[2][TC_BK * RS], vs[2][TC_BK * RS];
  const int n = blockIdx.x, qt = gridDim.y - 1 - blockIdx.y, q0 = qt * TC_BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const size_t base = static_cast<size_t>(n) * S * D;
  const int r0 = q0 + 16 * warp + g, r1 = r0 + 8;  // this lane's two query rows

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
    if (kt < qt) {
      load_tile(kt + 1, st ^ 1);
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
    if (kt == qt) {  // the diagonal tile: keys after the row masked by index
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (kt * TC_BK + 8 * nb + 2 * t + (e & 1) > (e < 2 ? r0 : r1)) s[nb][e] = -CUDART_INF_F;
    }
    // online softmax on the fragments: the row max over the quad (key 0 is in
    // every row's first tile, so m is finite from the first tile on, and
    // m = -inf before it gives alpha = 0)
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
    const float al0 = ex2((m0 - mx0) * scale_log2), al1 = ex2((m1 - mx1) * scale_log2);
    m0 = mx0;
    m1 = mx1;
    const float mb0 = mx0 * scale_log2, mb1 = mx1 * scale_log2;
    // P = exp2(s scale log2(e) - m scale log2(e)): summed in fp32, packed as
    // the bf16 A fragments of P.V (k-step kk: n-blocks 2 kk and 2 kk + 1)
    float ls0 = 0.f, ls1 = 0.f;
    uint32_t pa[4][4];
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      const float p0 = ex2(fmaf(s[nb][0], scale_log2, -mb0));
      const float p1 = ex2(fmaf(s[nb][1], scale_log2, -mb0));
      const float p2 = ex2(fmaf(s[nb][2], scale_log2, -mb1));
      const float p3 = ex2(fmaf(s[nb][3], scale_log2, -mb1));
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
  if (t == 0) {
    if (r0 < S) lse[static_cast<size_t>(n) * S + r0] = m0 * scale + logf(l0);
    if (r1 < S) lse[static_cast<size_t>(n) * S + r1] = m1 * scale + logf(l1);
  }
}

template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o, float* lse, int N,
                      int S, float scale, cudaStream_t stream) {
  using T = __nv_bfloat16;
  const dim3 grid(N, (S + TC_BQ - 1) / TC_BQ);
  flash_fwd_tc<D><<<grid, 32 * TC_WARPS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, S, scale, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

cudaError_t dispatch_tc(const void* q, const void* k, const void* v, void* o, float* lse, int N,
                        int S, int D, float scale, cudaStream_t s) {
  switch (D) {
    case 8: return launch_tc<8>(q, k, v, o, lse, N, S, scale, s);
    case 16: return launch_tc<16>(q, k, v, o, lse, N, S, scale, s);
    case 32: return launch_tc<32>(q, k, v, o, lse, N, S, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, o: (N, S, D) contiguous, fp32 or bf16 (is_bf16; the bf16 route
// copies 16-byte rows, so its q, k, v start 16-byte aligned); lse (N, S)
// fp32. D in {8, 16, 32}; N <= 65535 (grid.y of the fp32 route).
extern "C" int vq_flash_attn_fwd(int is_bf16, const void* q, const void* k, const void* v,
                                 void* o, float* lse, int N, int S, int D, float scale,
                                 void* stream) {
  if (N <= 0 || N > 65535 || S <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
         reinterpret_cast<uintptr_t>(v)) & 15) {
      return cudaErrorMisalignedAddress;
    }
    return dispatch_tc(q, k, v, o, lse, N, S, D, scale, s);
  }
  return dispatch<float>(q, k, v, o, lse, N, S, D, scale, s);
}
