// Kernel K1b: codebook lookup fused with the EMA cluster statistics (training).
//
// Replaces vqvae3d_tpu/ops/quantizer_ops.py:l2_argmin_stats_pallas (Pallas
// kernel _l2_argmin_stats_kernel): for flat rows x (N, D) and a codebook
// (K, D), idx[n] = argmin_k (|e_k|^2 - 2 x_n . e_k) in fp32 with ties to the
// lowest k (strict '<', the same arithmetic as l2_argmin.cu), plus
// counts[k] = |{n : idx_n = k}| and dw[k] = sum_{n : idx_n = k} x_n, with no
// (N, K) one-hot anywhere. Rows past N never enter the statistics.
//
// What bounds it on the H100: the training lookups are N = 524288 / 8192 /
// 128 rows against K = 128 / 256 / 512 codes of D = 2 / 8 / 32 (the stem-2
// full config at 512x512x128): at most 134 MFLOP and 4 MB of input, so the
// large lookup is bound by reading x (~1.3 us at 3.35 TB/s) and the small
// ones by latency.
//
// Design. The TPU kernel carries its sums across a sequential grid; here
// CTAs run in parallel and in no order, and fp32 atomics would make the EMA
// state differ from run to run. So the statistics are deterministic in two
// passes:
//   pass 1 (stats_partial): grid-stride over tiles of 256 rows, a fixed set
//     of tiles per CTA. Each thread finds one row's code (codebook and norms
//     in shared memory, as K1a) and parks the row and its index in shared
//     memory; then thread c owns codes c, c+256, ... and adds the tile's
//     rows of its codes in row order into a per-CTA (K, 1+D) accumulator.
//     Each CTA writes its accumulator to a partial slab.
//   pass 2 (stats_reduce): one thread per (k, column) sums the partial slabs
//     in CTA order.
// The same inputs and N give the same CTA count, the same order of every
// sum, and so bit-identical counts and dw. Counts are small integers in
// fp32, exact up to 2^24 rows.
#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <int DT>
__global__ void stats_partial(const float* __restrict__ x, const float* __restrict__ embed,
                              const float* __restrict__ e2, int64_t* __restrict__ idx,
                              float* __restrict__ part, int64_t n, int k, int d) {
  extern __shared__ float smem[];
  float* se = smem;                      // (k, d) codebook
  float* se2 = se + k * d;               // (k,) squared norms
  float* sx = se2 + k;                   // (kThreads, d) this tile's rows
  float* acc = sx + kThreads * d;        // (k, 1 + d): count, then sum of x
  int* sidx = reinterpret_cast<int*>(acc + k * (d + 1));  // (kThreads,)
  const int tid = threadIdx.x;
  for (int i = tid; i < k * d; i += kThreads) se[i] = embed[i];
  for (int i = tid; i < k; i += kThreads) se2[i] = e2[i];
  for (int i = tid; i < k * (d + 1); i += kThreads) acc[i] = 0.f;
  __syncthreads();

  const int64_t tiles = (n + kThreads - 1) / kThreads;
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int64_t row = t * kThreads + tid;
    int best_k = -1;  // rows past n match no code
    if (row < n) {
      float xr[DT];
#pragma unroll
      for (int j = 0; j < DT; ++j) xr[j] = j < d ? x[row * d + j] : 0.f;
      float best = CUDART_INF_F;
      best_k = 0;
      for (int c = 0; c < k; ++c) {
        const float* ec = se + c * d;
        float dot = 0.f;
#pragma unroll
        for (int j = 0; j < DT; ++j) {
          if (j < d) dot = fmaf(xr[j], ec[j], dot);
        }
        const float dist = se2[c] - 2.f * dot;
        if (dist < best) {
          best = dist;
          best_k = c;
        }
      }
      idx[row] = best_k;
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        if (j < d) sx[tid * d + j] = xr[j];
      }
    }
    sidx[tid] = best_k;
    __syncthreads();
    for (int c = tid; c < k; c += kThreads) {
      float* a = acc + c * (d + 1);
      for (int r = 0; r < kThreads; ++r) {
        if (sidx[r] == c) {
          a[0] += 1.f;
          for (int j = 0; j < d; ++j) a[1 + j] += sx[r * d + j];
        }
      }
    }
    __syncthreads();
  }
  float* out = part + static_cast<int64_t>(blockIdx.x) * k * (d + 1);
  for (int i = tid; i < k * (d + 1); i += kThreads) out[i] = acc[i];
}

__global__ void stats_reduce(const float* __restrict__ part, float* __restrict__ counts,
                             float* __restrict__ dw, int nblk, int k, int d) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int width = k * (d + 1);
  if (i >= width) return;
  float s = 0.f;
  for (int b = 0; b < nblk; ++b) s += part[static_cast<int64_t>(b) * width + i];
  const int c = i / (d + 1), col = i % (d + 1);
  if (col == 0) {
    counts[c] = s;
  } else {
    dw[c * d + col - 1] = s;
  }
}

size_t smem_bytes(int k, int d) {
  return (static_cast<size_t>(k) * d + k + kThreads * d + static_cast<size_t>(k) * (d + 1)) *
             sizeof(float) + kThreads * sizeof(int);
}

template <int DT>
cudaError_t launch(const float* x, const float* embed, const float* e2, int64_t* idx,
                   float* counts, float* dw, float* part, int nblk, int64_t n, int k, int d,
                   cudaStream_t s) {
  const size_t smem = smem_bytes(k, d);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        stats_partial<DT>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  stats_partial<DT><<<nblk, kThreads, smem, s>>>(x, embed, e2, idx, part, n, k, d);
  const int width = k * (d + 1);
  stats_reduce<<<(width + kThreads - 1) / kThreads, kThreads, 0, s>>>(part, counts, dw, nblk,
                                                                         k, d);
  return cudaGetLastError();
}

}  // namespace

// x (n, d) f32, embed (k, d) f32, e2 (k,) f32 -> idx (n,) int64, counts (k,)
// f32, dw (k, d) f32; part is scratch of nblk * k * (d + 1) floats, nblk >= 1
// the number of pass-1 CTAs (the caller's choice, a function of n only).
extern "C" int vq_l2_argmin_stats(const float* x, const float* embed, const float* e2,
                                  int64_t* idx, float* counts, float* dw, float* part,
                                  int nblk, int64_t n, int k, int d, void* stream) {
  if (k <= 0 || d <= 0 || d > 32 || nblk <= 0) return cudaErrorInvalidValue;
  if (smem_bytes(k, d) > 227 * 1024) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 2) return launch<2>(x, embed, e2, idx, counts, dw, part, nblk, n, k, d, s);
  if (d <= 4) return launch<4>(x, embed, e2, idx, counts, dw, part, nblk, n, k, d, s);
  if (d <= 8) return launch<8>(x, embed, e2, idx, counts, dw, part, nblk, n, k, d, s);
  if (d <= 16) return launch<16>(x, embed, e2, idx, counts, dw, part, nblk, n, k, d, s);
  return launch<32>(x, embed, e2, idx, counts, dw, part, nblk, n, k, d, s);
}
