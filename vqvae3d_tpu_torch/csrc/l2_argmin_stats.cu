// Kernel K1b: codebook lookup fused with the EMA cluster statistics (training).
//
// Replaces vqvae3d_tpu/ops/quantizer_ops.py:l2_argmin_stats_pallas (Pallas
// kernel _l2_argmin_stats_kernel): for flat rows x (N, D) and a codebook
// (K, D), idx[n] = argmin_k (|e_k|^2 - 2 x_n . e_k) in fp32 with ties to the
// lowest k (the lookup of l2_argmin.cuh, shared with K1a), plus
// counts[k] = |{n : idx_n = k}| and dw[k] = sum_{n : idx_n = k} x_n, with no
// (N, K) one-hot anywhere. Rows past N never enter the statistics.
//
// What bounds it on the H100: operations, as K1a (N = 524288 / 8192 / 128
// rows against K = 128 / 256 / 512 codes of D = 2 / 8 / 32 a stem-2 step);
// the statistics add N D flops and K (D + 1) floats a CTA.
//
// Design. The TPU kernel carries its sums across a sequential grid; here
// CTAs run in parallel and in no order, and fp32 atomics would make the EMA
// state differ from run to run. So every sum is taken in an order fixed by
// N and the split alone, at O(rows) work:
//   pass 1 (stats_partial): CTA b takes tiles b, b + nblk, ... of the split
//     of quantizer_ops.stats_plan. After a tile's lookup, the lanes that own
//     a row (lane s = 0 of each row group) are grouped by code with
//     __match_any_sync; the group's lowest lane sums the group's rows in
//     lane order and adds the count and the sum into a slab of
//     K (1 + D) floats in shared memory. A warp owns its slab, or, where
//     the slabs do not all fit (K = 512, D = 32), warps share slabs in turn
//     (warp w uses slab w % G in round w / G). Within a warp one lane
//     touches a code at a time, rows in a fixed order. At the end the CTA
//     sums its slabs in slab order into its partial.
//   pass 2 (stats_reduce): 32 (code, column) entries a CTA; warp w sums the
//     partials of CTAs w, w + 8, ... in CTA order, then warp 0 adds the 8
//     warps' sums in warp order.
// The same inputs and N give the same split, the same order of every sum,
// and so bit-identical counts and dw. Counts are small integers in fp32,
// exact up to 2^24 rows.
#include "l2_argmin.cuh"

namespace {

constexpr int kWarps = l2::kThreads / 32;

template <int DT, int R>
__global__ void __launch_bounds__(l2::kThreads)
    stats_partial(const float* __restrict__ x, const float* __restrict__ embed,
                  int64_t* __restrict__ idx, float* __restrict__ part, int64_t n, int k, int d,
                  int lanes, int slabs) {
  extern __shared__ float4 smem[];
  float* se = reinterpret_cast<float*>(smem);
  const int width = k * (d + 1);
  float* slab0 = se + k * l2::code_stride(DT);  // (slabs, k, 1 + d): count, then sum of x
  for (int i = threadIdx.x; i < slabs * width; i += l2::kThreads) slab0[i] = 0.f;
  l2::stage_codebook<DT>(embed, se, k, d);  // ends with __syncthreads()

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int s = threadIdx.x & (lanes - 1);
  const int rounds = kWarps / slabs;
  float* slab = slab0 + (warp % slabs) * width;
  const int64_t tile_rows = (l2::kThreads / lanes) * R;
  const int64_t tiles = (n + tile_rows - 1) / tile_rows;
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    int64_t row[R];
    float xm[R][DT];
    l2::load_rows<DT, R>(x, t * tile_rows, lanes, n, d, row, xm);
    int bk[R];
    l2::nearest<DT, R>(xm, se, k, s, lanes, bk);
    for (int round = 0; round < rounds; ++round) {
      if (warp / slabs == round) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const bool own = s == 0 && row[r] < n;
          if (own) idx[row[r]] = bk[r];
          const int c = own ? bk[r] : -1;
          const unsigned group = __match_any_sync(0xffffffffu, c);
          if (own && lane == __ffs(group) - 1) {
            float acc[DT];
#pragma unroll
            for (int j = 0; j < DT; ++j) acc[j] = 0.f;
            for (unsigned m = group; m; m &= m - 1) {
              // the owner lanes are multiples of S apart, one row group each
              const int64_t rl = row[r] + (__ffs(m) - 1 - lane) / lanes;
#pragma unroll
              for (int j = 0; j < DT; ++j) {
                if (j < d) acc[j] += __ldg(x + rl * d + j);
              }
            }
            float* a = slab + c * (d + 1);
            a[0] += static_cast<float>(__popc(group));
#pragma unroll
            for (int j = 0; j < DT; ++j) {
              if (j < d) a[1 + j] += acc[j];
            }
          }
          __syncwarp();
        }
      }
      if (rounds > 1) __syncthreads();
    }
  }
  __syncthreads();
  float* out = part + static_cast<int64_t>(blockIdx.x) * width;
  for (int i = threadIdx.x; i < width; i += l2::kThreads) {
    float v = slab0[i];
    for (int g = 1; g < slabs; ++g) v += slab0[g * width + i];
    out[i] = v;
  }
}

__global__ void __launch_bounds__(l2::kThreads)
    stats_reduce(const float* __restrict__ part, float* __restrict__ counts,
                 float* __restrict__ dw, int nblk, int k, int d) {
  __shared__ float sums[kWarps][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int i = blockIdx.x * 32 + lane;
  const int width = k * (d + 1);
  float v = 0.f;
  if (i < width) {
    for (int b = warp; b < nblk; b += kWarps) v += part[static_cast<int64_t>(b) * width + i];
  }
  sums[warp][lane] = v;
  __syncthreads();
  if (warp != 0 || i >= width) return;
  for (int w = 1; w < kWarps; ++w) v += sums[w][lane];
  const int c = i / (d + 1), col = i % (d + 1);
  if (col == 0) {
    counts[c] = v;
  } else {
    dw[c * d + col - 1] = v;
  }
}

template <int DT>
size_t smem_bytes(int k, int d, int slabs) {
  return (static_cast<size_t>(k) * l2::code_stride(DT) +
          static_cast<size_t>(slabs) * k * (d + 1)) * sizeof(float);
}

template <int DT, int R>
cudaError_t launch(const float* x, const float* embed, int64_t* idx, float* counts, float* dw,
                   float* part, int nblk, int64_t n, int k, int d, int lanes, int slabs,
                   cudaStream_t s) {
  static bool smem_set = false;
  const cudaError_t err = l2::allow_smem(stats_partial<DT, R>, smem_set);
  if (err != cudaSuccess) return err;
  stats_partial<DT, R><<<nblk, l2::kThreads, smem_bytes<DT>(k, d, slabs), s>>>(
      x, embed, idx, part, n, k, d, lanes, slabs);
  const int width = k * (d + 1);
  stats_reduce<<<(width + 31) / 32, l2::kThreads, 0, s>>>(part, counts, dw, nblk, k, d);
  return cudaGetLastError();
}

template <int DT>
cudaError_t dispatch(const float* x, const float* embed, int64_t* idx, float* counts, float* dw,
                     float* part, int nblk, int64_t n, int k, int d, int rows, int lanes,
                     int slabs, cudaStream_t s) {
  if (!l2::valid_split(DT, rows, lanes)) return cudaErrorInvalidValue;
  if (slabs != 1 && slabs != 2 && slabs != 4 && slabs != kWarps) return cudaErrorInvalidValue;
  if (smem_bytes<DT>(k, d, slabs) > l2::kSmemLimit) return cudaErrorInvalidValue;
  if (rows == 1) {
    return launch<DT, 1>(x, embed, idx, counts, dw, part, nblk, n, k, d, lanes, slabs, s);
  }
  return launch<DT, l2::kRows(DT)>(x, embed, idx, counts, dw, part, nblk, n, k, d, lanes, slabs,
                                   s);
}

}  // namespace

// x (n, d) f32, embed (k, d) f32 -> idx (n,) int64, counts (k,) f32, dw (k, d)
// f32; part is scratch of nblk * k * (d + 1) floats. nblk >= 1 pass-1 CTAs,
// rows and lanes (the lookup's split) and slabs (per CTA, dividing 8) are
// quantizer_ops.stats_plan's, a function of (n, k, d) only.
extern "C" int vq_l2_argmin_stats(const float* x, const float* embed, int64_t* idx,
                                  float* counts, float* dw, float* part, int nblk, int64_t n,
                                  int k, int d, int rows, int lanes, int slabs, void* stream) {
  if (k <= 0 || d <= 0 || d > 32 || nblk <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 2) {
    return dispatch<2>(x, embed, idx, counts, dw, part, nblk, n, k, d, rows, lanes, slabs, s);
  }
  if (d <= 4) {
    return dispatch<4>(x, embed, idx, counts, dw, part, nblk, n, k, d, rows, lanes, slabs, s);
  }
  if (d <= 8) {
    return dispatch<8>(x, embed, idx, counts, dw, part, nblk, n, k, d, rows, lanes, slabs, s);
  }
  if (d <= 16) {
    return dispatch<16>(x, embed, idx, counts, dw, part, nblk, n, k, d, rows, lanes, slabs, s);
  }
  return dispatch<32>(x, embed, idx, counts, dw, part, nblk, n, k, d, rows, lanes, slabs, s);
}
