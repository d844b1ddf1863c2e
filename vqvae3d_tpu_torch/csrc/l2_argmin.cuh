// Shared device code of kernels K1a (l2_argmin.cu) and K1b (l2_argmin_stats.cu):
// the codebook in shared memory, the distance and the argmin.
//
// idx[n] = argmin_k (|e_k|^2 - 2 x_n . e_k) in fp32 FMA on the CUDA cores
// (never TF32: the TPU kernel runs at Precision.HIGHEST, and TF32 would
// assign other codes): one FMA chain a distance, from the code's norm, with
// the -2 folded into the row (exact), so D FMAs and a compare-select each.
// Ties go to the lowest k, as torch.argmin and
// jnp.argmin do: a thread walks its codes in increasing k with a strict '<',
// and every combine across threads takes the lexicographically smallest
// (dist, k) pair.
//
// The work split (chosen on the host from (N, K, D):
// vqvae3d_tpu_torch/ops/quantizer_ops.py::lookup_plan, which mirrors the
// constants here):
//   * a CTA of kThreads threads takes a tile of (kThreads / S) * R rows;
//   * S lanes of a warp (a row group, S a power of two <= 32) share R rows
//     and split the codebook: lane s takes codes s, s + S, s + 2S, ...;
//     the S lanes' pairs are combined by an xor butterfly of shuffles;
//   * row r of thread t is tile_base + r * (kThreads / S) + t / S.
// Large N (the level-0 lookup, 524288 rows) runs S = 1, R = kRows(DT): one
// shared-memory read of a code serves R rows in registers. Small N (levels
// 1 and 2: 8192 and 128 rows) runs R = 1 and S up to 32, so that many warps
// share the codebook and each lane keeps several codes' FMA chains in
// flight (kInFlight), not one 32-long dependent chain.
#pragma once

#include <math_constants.h>

#include "common.cuh"

namespace l2 {

constexpr int kThreads = 256;          // threads a CTA
constexpr int kSmemLimit = 232448;     // dynamic shared memory a CTA may opt into (H100)

// Rows a thread keeps in registers on the large-N route, by DT.
__host__ __device__ constexpr int kRows(int dt) {
  return dt <= 2 ? 8 : dt <= 8 ? 4 : dt <= 16 ? 2 : 1;
}

// Floats a code takes in shared memory: DT values (zero past d), its squared
// norm at [DT], padded to whole 16-byte units, an odd number of them, so the
// 8 lanes of a quarter warp that read 8 consecutive codes with 16-byte loads
// hit 8 different bank groups.
__host__ __device__ constexpr int code_stride(int dt) {
  return ((dt + 4) / 4) % 2 == 0 ? (dt + 4) / 4 * 4 + 4 : (dt + 4) / 4 * 4;
}

// Stage the codebook (k, d) into se (k, code_stride(DT)) and compute each
// code's squared norm there (products rounded, summed in j order). The
// copy loads kBatch values a thread before it stores any, so that many
// loads are in flight (16-byte loads where d is a multiple of 4): a
// one-load-at-a-time loop set the time of the small lookups. Ends with
// __syncthreads().
constexpr int kBatch = 8;

template <typename T, typename Store>
__device__ __forceinline__ void batched_copy(const T* __restrict__ src, int total, Store store) {
  const int tid = threadIdx.x, threads = blockDim.x;
  for (int base = 0; base < total; base += kBatch * threads) {
    T v[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) v[b] = __ldg(src + min(base + b * threads + tid, total - 1));
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int i = base + b * threads + tid;
      if (i < total) store(i, v[b]);
    }
  }
}

template <int DT>
__device__ void stage_codebook(const float* __restrict__ embed, float* se, int k, int d) {
  constexpr int W = code_stride(DT);
  if (d % 4 == 0 && (reinterpret_cast<uintptr_t>(embed) & 15) == 0) {
    const int q = d / 4;
    batched_copy(reinterpret_cast<const float4*>(embed), k * q, [&](int i, float4 v) {
      const int c = i / q;
      reinterpret_cast<float4*>(se + c * W)[i - c * q] = v;
    });
  } else {
    batched_copy(embed, k * d, [&](int i, float v) {
      const int c = i / d;
      se[c * W + i - c * d] = v;
    });
  }
  for (int i = threadIdx.x; i < k * (W - d); i += blockDim.x) {  // zeros past d
    const int c = i / (W - d);
    se[c * W + d + i - c * (W - d)] = 0.f;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < k; c += blockDim.x) {
    float e2 = 0.f;
    for (int j = 0; j < d; ++j) e2 = __fadd_rn(e2, __fmul_rn(se[c * W + j], se[c * W + j]));
    se[c * W + DT] = e2;
  }
  __syncthreads();
}

// This thread's R rows of the tile at tile_base and their values times -2
// (zero past d and for rows past n, which are computed but never written).
template <int DT, int R>
__device__ __forceinline__ void load_rows(const float* __restrict__ x, int64_t tile_base, int S,
                                          int64_t n, int d, int64_t (&row)[R],
                                          float (&xm)[R][DT]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    row[r] = tile_base + static_cast<int64_t>(r) * (kThreads / S) + threadIdx.x / S;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      xm[r][j] = row[r] < n && j < d ? -2.f * __ldg(x + row[r] * d + j) : 0.f;
    }
  }
}

__device__ __forceinline__ bool better(float d1, int k1, float d2, int k2) {
  return d1 < d2 || (d1 == d2 && k1 < k2);
}

__device__ __forceinline__ float lane_of(const float4& t, int q) {
  return q == 0 ? t.x : q == 1 ? t.y : q == 2 ? t.z : t.w;
}

// Codes i .. i + U - 1 of lane s (codes s + (i + u) S): U x R FMA chains in
// flight, each |e|^2 + sum_j (-2 x_j) e_j in j order, then the compares in
// code order.
template <int DT, int R, int U>
__device__ __forceinline__ void walk(const float (&xm)[R][DT], const float* se, int s, int S,
                                     int i, float (&bd)[R], int (&bk)[R]) {
  constexpr int W = code_stride(DT);
  float dist[U][R];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const float4 t = reinterpret_cast<const float4*>(se + (s + (i + u) * S) * W)[DT / 4];
#pragma unroll
    for (int r = 0; r < R; ++r) dist[u][r] = lane_of(t, DT % 4);
  }
#pragma unroll
  for (int v = 0; v < (DT + 3) / 4; ++v) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float4 t = reinterpret_cast<const float4*>(se + (s + (i + u) * S) * W)[v];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (4 * v + q < DT) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            dist[u][r] = fmaf(xm[r][4 * v + q], lane_of(t, q), dist[u][r]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (dist[u][r] < bd[r]) {
        bd[r] = dist[u][r];
        bk[r] = s + (i + u) * S;
      }
    }
  }
}

// The nearest code of each of this thread's R rows among the codes of lane
// s of S, then combined across the S lanes of its row group: every lane of
// the group ends with the group's result in bk. A lane starts from (inf, s),
// so rows whose distances are all inf or NaN get code 0, as a serial walk
// would give them.
template <int DT, int R>
__device__ __forceinline__ void nearest(const float (&xm)[R][DT], const float* se, int k, int s,
                                        int S, int (&bk)[R]) {
  constexpr int kInFlight = R >= 2 ? 2 : 4;  // codes whose FMA chains interleave
  float bd[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    bd[r] = CUDART_INF_F;
    bk[r] = s;
  }
  const int nc = s < k ? (k - 1 - s) / S + 1 : 0;  // this lane's codes
  int i = 0;
  for (; i + kInFlight <= nc; i += kInFlight) walk<DT, R, kInFlight>(xm, se, s, S, i, bd, bk);
  for (; i < nc; ++i) walk<DT, R, 1>(xm, se, s, S, i, bd, bk);
  for (int o = S >> 1; o > 0; o >>= 1) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float od = __shfl_xor_sync(0xffffffffu, bd[r], o);
      const int ok = __shfl_xor_sync(0xffffffffu, bk[r], o);
      if (better(od, ok, bd[r], bk[r])) {
        bd[r] = od;
        bk[r] = ok;
      }
    }
  }
}

// Opt a kernel into up to kSmemLimit bytes of dynamic shared memory, once.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  done = err == cudaSuccess;
  return err;
}

// Whether (R, S) is a split the kernels were built for at this DT.
__host__ __device__ constexpr bool valid_split(int dt, int rows, int lanes) {
  return (lanes == 1 || lanes == 2 || lanes == 4 || lanes == 8 || lanes == 16 || lanes == 32) &&
         (rows == 1 || (rows == kRows(dt) && lanes == 1));
}

}  // namespace l2
