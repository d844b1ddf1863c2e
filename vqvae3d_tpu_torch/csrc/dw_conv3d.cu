// Kernel K7: weight gradient of a stride-1 VALID 3-D conv with few channels.
//
// Replaces vqvae3d_tpu/ops/pallas_conv.py:dw_conv3d_pallas (Pallas kernel
// _dw_kernel) and the function it stands in for on a real TPU,
// vqvae3d_tpu/ops/conv3d.py:dw_conv3d_onedot: for a pre-padded input x
// (B, Cin, Hp, Wp, Dp) and the output cotangent g (B, Cout, Ho, Wo, Do),
// Ho = Hp - kh + 1 etc.,
//   dW[co][ci][i][j][l] = sum_{b, oh, ow, od} x[b][ci][oh+i][ow+j][od+l] * g[b][co][oh][ow][od]
// accumulated in fp32 (x and g fp32 or bf16), dW (Cout, Cin, kh, kw, kd).
//
// What bounds it on the H100: on the path (the 3x3x3 resize convs of the
// up blocks and the pre-quantization conv, Cin = Cout <= 16, up to
// 256x256x64 outputs) it is 27 * Cin * Cout FMAs per output voxel against
// (Cin + Cout) values read: ~7 to 100 FMAs per byte, near the CUDA cores'
// fp32 ridge, while the tensor cores would leave it bound by reading x and g
// once (~0.1 ms at 256x256x64, C = 9, bf16).
//
// Design (simple first). Pass 1: grid (chunk, tap); a CTA stages tiles of 64
// consecutive output positions of its chunk in shared memory (the g values
// and the x values at position + tap, for all channels) and each thread
// accumulates its (co, ci) pairs over the tile, in fp32 on the CUDA cores.
// With fewer than 256 pairs, lanes of threads split the tile's positions and
// are summed in lane order at the end of the chunk. Each CTA writes its
// per-tap partial; pass 2 sums the chunks in order. No atomics: the same
// inputs give a bit-identical dW (the TPU kernel accumulates in one
// sequential grid; here the chunks are the order-fixed substitute).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;    // output positions per shared-memory tile
constexpr int kMaxC = 32;    // channel cap of the small-channel path
constexpr int kMaxPairs = 4;  // (co, ci) pairs per thread: 4 * 256 >= 32 * 32

template <typename T>
__global__ void dw_partial(const T* __restrict__ x, const T* __restrict__ g,
                           float* __restrict__ part, int64_t npos, int64_t len, int cin,
                           int cout, int hp, int wp, int dp, int kh, int kw, int kd) {
  __shared__ float xs[kTile * kMaxC];
  __shared__ float gs[kTile * kMaxC];
  __shared__ int64_t xoff[kTile];
  __shared__ int64_t goff[kTile];
  __shared__ float red[kThreads];
  const int tid = threadIdx.x;
  const int tap = blockIdx.y;
  const int ti = tap / (kw * kd), tj = (tap / kd) % kw, tl = tap % kd;
  const int ho = hp - kh + 1, wo = wp - kw + 1, dout = dp - kd + 1;
  const int64_t xplane = static_cast<int64_t>(hp) * wp * dp;
  const int64_t gplane = static_cast<int64_t>(ho) * wo * dout;
  const int pairs = cin * cout;
  const int et = pairs < kThreads ? pairs : kThreads;
  const int lanes = kThreads / et;
  const int el = tid % et, sl = tid / et;
  float acc[kMaxPairs] = {0.f, 0.f, 0.f, 0.f};

  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * len;
  const int64_t p1 = p0 + len < npos ? p0 + len : npos;
  for (int64_t t0 = p0; t0 < p1; t0 += kTile) {
    const int tp = p1 - t0 < kTile ? static_cast<int>(p1 - t0) : kTile;
    if (tid < tp) {
      int64_t o = t0 + tid;
      const int od = static_cast<int>(o % dout);
      o /= dout;
      const int ow = static_cast<int>(o % wo);
      o /= wo;
      const int oh = static_cast<int>(o % ho);
      const int64_t b = o / ho;
      goff[tid] = b * cout * gplane + (static_cast<int64_t>(oh) * wo + ow) * dout + od;
      xoff[tid] = b * cin * xplane +
                  (static_cast<int64_t>(oh + ti) * wp + (ow + tj)) * dp + (od + tl);
    }
    __syncthreads();
    for (int i = tid; i < tp * cin; i += kThreads) {
      const int p = i % tp, ci = i / tp;
      xs[p * cin + ci] = vq::to_f<T>(x[xoff[p] + ci * xplane]);
    }
    for (int i = tid; i < tp * cout; i += kThreads) {
      const int p = i % tp, co = i / tp;
      gs[p * cout + co] = vq::to_f<T>(g[goff[p] + co * gplane]);
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kMaxPairs; ++r) {
      const int e = el + r * kThreads;
      if (sl < lanes && e < pairs) {
        const int co = e / cin, ci = e % cin;
        float a = acc[r];
        for (int p = sl; p < tp; p += lanes) a = fmaf(xs[p * cin + ci], gs[p * cout + co], a);
        acc[r] = a;
      }
    }
    __syncthreads();
  }
  const int kvol = kh * kw * kd;
  float* out = part + static_cast<int64_t>(blockIdx.x) * kvol * pairs +
               static_cast<int64_t>(tap) * pairs;
  if (lanes == 1) {
#pragma unroll
    for (int r = 0; r < kMaxPairs; ++r) {
      const int e = el + r * kThreads;
      if (e < pairs) out[e] = acc[r];
    }
    return;
  }
  red[tid] = acc[0];
  __syncthreads();
  if (sl == 0) {
    float s = 0.f;
    for (int r = 0; r < lanes; ++r) s += red[r * et + el];
    out[el] = s;
  }
}

// dW[co][ci][tap] = sum over chunks of part[chunk][tap][co * cin + ci].
__global__ void dw_reduce(const float* __restrict__ part, float* __restrict__ dw, int nchunks,
                          int pairs, int kvol) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= pairs * kvol) return;
  const int e = i / kvol, tap = i % kvol;
  const int64_t stride = static_cast<int64_t>(kvol) * pairs;
  float s = 0.f;
  for (int ch = 0; ch < nchunks; ++ch) s += part[ch * stride + static_cast<int64_t>(tap) * pairs + e];
  dw[i] = s;
}

template <typename T>
cudaError_t dw_conv3d(const T* x, const T* g, float* dw, float* part, int nchunks,
                      int64_t batch, int cin, int cout, int hp, int wp, int dp, int kh, int kw,
                      int kd, cudaStream_t s) {
  const int64_t npos = batch * static_cast<int64_t>(hp - kh + 1) * (wp - kw + 1) * (dp - kd + 1);
  const int64_t len = ((npos + nchunks - 1) / nchunks + kTile - 1) / kTile * kTile;
  const int kvol = kh * kw * kd;
  dw_partial<T><<<dim3(nchunks, kvol), kThreads, 0, s>>>(x, g, part, npos, len, cin, cout, hp,
                                                          wp, dp, kh, kw, kd);
  const int total = cin * cout * kvol;
  dw_reduce<<<(total + kThreads - 1) / kThreads, kThreads, 0, s>>>(part, dw, nchunks,
                                                                    cin * cout, kvol);
  return cudaGetLastError();
}

}  // namespace

// x (B, Cin, Hp, Wp, Dp) and g (B, Cout, Ho, Wo, Do) contiguous, bf16 when
// is_bf16 else fp32 -> dw (Cout, Cin, kh, kw, kd) fp32. part is scratch of
// nchunks * kh * kw * kd * Cin * Cout floats; nchunks >= 1 is the caller's
// choice (a function of the shapes only).
extern "C" int vq_dw_conv3d(int is_bf16, const void* x, const void* g, void* dw, void* part,
                            int nchunks, int64_t batch, int cin, int cout, int hp, int wp,
                            int dp, int kh, int kw, int kd, void* stream) {
  if (cin < 1 || cout < 1 || cin > kMaxC || cout > kMaxC || nchunks < 1) {
    return cudaErrorInvalidValue;
  }
  if (kh < 1 || kw < 1 || kd < 1 || kh > hp || kw > wp || kd > dp) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(dw);
  float* pf = static_cast<float*>(part);
  if (is_bf16) {
    using T = __nv_bfloat16;
    return dw_conv3d<T>(static_cast<const T*>(x), static_cast<const T*>(g), out, pf, nchunks,
                        batch, cin, cout, hp, wp, dp, kh, kw, kd, s);
  }
  return dw_conv3d<float>(static_cast<const float*>(x), static_cast<const float*>(g), out, pf,
                          nchunks, batch, cin, cout, hp, wp, dp, kh, kw, kd, s);
}
