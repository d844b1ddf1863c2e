// Kernel K1: codebook nearest-neighbour lookup, serving path.
//
// Replaces vqvae3d_tpu/ops/quantizer_ops.py:l2_argmin_pallas (Pallas kernel
// _l2_argmin_kernel): idx[n] = argmin_k (|e_k|^2 - 2 x_n . e_k), fp32, ties to
// the lowest k (strict '<', as jnp.argmin and torch.argmin).
//
// What bounds it on the H100: nothing much. At batch 1 and full resolution the
// three lookups are N = 524288 / 8192 / 128 rows against K = 128 / 256 / 512
// codes of D = 2 / 8 / 32: at most 134 MFLOP and 4 MB of input, so the larger
// lookups are bound by reading x and the smallest by latency (one block).
//
// Design: the codebook and its squared norms sit in shared memory (at most
// 512 x 32 x 4 B + 2 KB = 66 KB, dynamic shared memory above 48 KB). One
// thread owns one row, keeps it in registers and walks all K codes; all
// threads of a warp read the same code at once, which shared memory
// broadcasts. Distances use fp32 FMA on the CUDA cores, never TF32 (the TPU
// kernel runs at Precision.HIGHEST for the same reason). No (N, K) distance
// matrix exists anywhere.
#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <int DT>  // DT: register capacity for one row, d <= DT
__global__ void l2_argmin_kernel(const float* __restrict__ x,
                                 const float* __restrict__ embed,
                                 const float* __restrict__ e2,
                                 int64_t* __restrict__ out, int64_t n, int k,
                                 int d) {
  extern __shared__ float smem[];
  float* se = smem;           // (k, d) codebook
  float* se2 = smem + k * d;  // (k,) squared norms
  for (int i = threadIdx.x; i < k * d; i += blockDim.x) se[i] = embed[i];
  for (int i = threadIdx.x; i < k; i += blockDim.x) se2[i] = e2[i];
  __syncthreads();

  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (row >= n) return;
  float xr[DT];
#pragma unroll
  for (int j = 0; j < DT; ++j) xr[j] = j < d ? x[row * d + j] : 0.f;

  float best = CUDART_INF_F;
  int best_k = 0;
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
  out[row] = best_k;
}

template <int DT>
cudaError_t launch(const float* x, const float* embed, const float* e2,
                   int64_t* out, int64_t n, int k, int d, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(k) * (d + 1) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        l2_argmin_kernel<DT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  l2_argmin_kernel<DT><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      x, embed, e2, out, n, k, d);
  return cudaGetLastError();
}

}  // namespace

// x (n, d) f32, embed (k, d) f32, e2 (k,) f32 -> out (n,) int64; all contiguous.
extern "C" int vq_l2_argmin(const float* x, const float* embed, const float* e2,
                            int64_t* out, int64_t n, int k, int d, void* stream) {
  if (n == 0) return cudaSuccess;
  if (k <= 0 || d <= 0 || d > 64) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 2) return launch<2>(x, embed, e2, out, n, k, d, s);
  if (d <= 4) return launch<4>(x, embed, e2, out, n, k, d, s);
  if (d <= 8) return launch<8>(x, embed, e2, out, n, k, d, s);
  if (d <= 16) return launch<16>(x, embed, e2, out, n, k, d, s);
  if (d <= 32) return launch<32>(x, embed, e2, out, n, k, d, s);
  return launch<64>(x, embed, e2, out, n, k, d, s);
}
