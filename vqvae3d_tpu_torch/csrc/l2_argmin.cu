// Kernel K1a: codebook nearest-neighbour lookup, serving path.
//
// Replaces vqvae3d_tpu/ops/quantizer_ops.py:l2_argmin_pallas (Pallas kernel
// _l2_argmin_kernel): idx[n] = argmin_k (|e_k|^2 - 2 x_n . e_k), fp32, ties to
// the lowest k (as jnp.argmin and torch.argmin).
//
// What bounds it on the H100: operations. At batch 1 and full resolution the
// three lookups are N = 524288 / 8192 / 128 rows against K = 128 / 256 / 512
// codes of D = 2 / 8 / 32: 2 N K D FMA flops plus a compare a distance, at
// most 0.3 GFLOP and 4 MB of input, so fp32 issue and, for the small
// lookups, latency set the time.
//
// Design (shared with K1b: l2_argmin.cuh): one launch a lookup. Each CTA
// stages the codebook in shared memory and computes the code norms there
// (no separate |e|^2 pass). The split by shape comes from the host
// (quantizer_ops.lookup_plan): the large lookup keeps R rows a thread in
// registers, so one shared-memory read of a code serves R distances; the
// small ones split the codebook across S lanes of a warp, each lane with
// several codes' FMA chains in flight, and combine by shuffles, so the
// 128-row lookup runs on 16 CTAs, not one. Distances use fp32 FMA on the
// CUDA cores, never TF32. No (N, K) distance matrix exists anywhere.
#include "l2_argmin.cuh"

namespace {

template <int DT, int R>
__global__ void __launch_bounds__(l2::kThreads)
    argmin_kernel(const float* __restrict__ x, const float* __restrict__ embed,
                  int64_t* __restrict__ out, int64_t n, int k, int d, int lanes) {
  extern __shared__ float4 smem[];
  float* se = reinterpret_cast<float*>(smem);
  l2::stage_codebook<DT>(embed, se, k, d);
  const int64_t tile_rows = (l2::kThreads / lanes) * R;
  int64_t row[R];
  float xm[R][DT];
  l2::load_rows<DT, R>(x, blockIdx.x * tile_rows, lanes, n, d, row, xm);
  const int s = threadIdx.x & (lanes - 1);
  int bk[R];
  l2::nearest<DT, R>(xm, se, k, s, lanes, bk);
  if (s == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (row[r] < n) out[row[r]] = bk[r];
    }
  }
}

template <int DT, int R>
cudaError_t launch(const float* x, const float* embed, int64_t* out, int64_t n, int k, int d,
                   int lanes, cudaStream_t stream) {
  static bool smem_set = false;
  const cudaError_t err = l2::allow_smem(argmin_kernel<DT, R>, smem_set);
  if (err != cudaSuccess) return err;
  const int64_t tile_rows = (l2::kThreads / lanes) * R;
  const int64_t blocks = (n + tile_rows - 1) / tile_rows;
  const size_t smem = static_cast<size_t>(k) * l2::code_stride(DT) * sizeof(float);
  argmin_kernel<DT, R><<<static_cast<unsigned>(blocks), l2::kThreads, smem, stream>>>(
      x, embed, out, n, k, d, lanes);
  return cudaGetLastError();
}

template <int DT>
cudaError_t dispatch(const float* x, const float* embed, int64_t* out, int64_t n, int k, int d,
                     int rows, int lanes, cudaStream_t s) {
  if (!l2::valid_split(DT, rows, lanes)) return cudaErrorInvalidValue;
  if (static_cast<size_t>(k) * l2::code_stride(DT) * sizeof(float) > l2::kSmemLimit) {
    return cudaErrorInvalidValue;
  }
  if (rows == 1) return launch<DT, 1>(x, embed, out, n, k, d, lanes, s);
  return launch<DT, l2::kRows(DT)>(x, embed, out, n, k, d, lanes, s);
}

}  // namespace

// x (n, d) f32, embed (k, d) f32 -> out (n,) int64; all contiguous. rows and
// lanes are the split of quantizer_ops.lookup_plan (R rows a thread, S lanes
// a row group).
extern "C" int vq_l2_argmin(const float* x, const float* embed, int64_t* out, int64_t n, int k,
                            int d, int rows, int lanes, void* stream) {
  if (n == 0) return cudaSuccess;
  if (k <= 0 || d <= 0 || d > 64) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 2) return dispatch<2>(x, embed, out, n, k, d, rows, lanes, s);
  if (d <= 4) return dispatch<4>(x, embed, out, n, k, d, rows, lanes, s);
  if (d <= 8) return dispatch<8>(x, embed, out, n, k, d, rows, lanes, s);
  if (d <= 16) return dispatch<16>(x, embed, out, n, k, d, rows, lanes, s);
  if (d <= 32) return dispatch<32>(x, embed, out, n, k, d, rows, lanes, s);
  return dispatch<64>(x, embed, out, n, k, d, rows, lanes, s);
}
