// Kernel K3: one 'same' PreActFixup block of a stack, serving forward.
//
// Replaces vqvae3d_tpu/ops/stack_kernel.py:preact_stack_fused (its no-save
// forward kernels) and, per block, the forward math of
// vqvae3d_tpu/ops/fused_block.py:preact_block_fused. For each block of an
// n-block stack, on channels-last (B, H, W, D, C) activations:
//
//   a1 = elu(x + b1a) + b1b
//   a2 = elu(conv1(a1) + b2a) + b2b          conv1: 1x1x1, C -> Cb
//   a3 = elu(conv3(a2) + b3a) + b3b          conv3: 3x3x3, Cb -> Cb, 'wrap' | 'zeros'
//   y  = conv1'(a3) * scale + b4 + x         conv1': 1x1x1, Cb -> C
//
// (vqvae3d_tpu/models/blocks.py:preact_fixup_same_ndhwc), with Cb = max(C/2, 1).
// 'zeros' pads a2, the conv's input, not x: a tap outside the volume adds
// nothing. 'wrap' is circular on all three axes, corners included.
//
// Rounding follows the reference math in the activation type T: every
// elementwise op rounds its fp32 result to T, every conv accumulates in fp32
// and rounds its output to T, weights and scalars are read as T. For
// T = float that is plain fp32 math.
//
// What bounds it on the H100: at the path's shapes the 3x3x3 conv is
// 27 * Cb^2 multiply-adds per voxel (Cb = 1..128) over 128 to 33.5 M voxels.
// The full-resolution C = 4 stack (33.5 M voxels, ~1.2 GB moved per block)
// should be bound by device memory; the wide stacks (C = 18 at 128x128x32,
// C = 72 at 32x32x8) by the CUDA cores' fp32 FMA rate and L1 traffic for the
// neighbours' a2 values; the coarse grids (down to 128 voxels) by latency,
// as they give too few threads to fill 132 SMs. Both routes sit far from
// these bounds (PERF.md §6): bf16 runs one fused kernel a block (fused_tc,
// fused_cc below), fp32 and bf16 wider than Cb 128 the three kernels.
//
// The three kernels (the first design), per block, each
// thread owning one voxel and a group of COB output channels, fp32
// accumulators in registers:
//   pre:  x -> a2    (pointwise; a1 is recomputed per channel group)
//   conv: a2 -> a3   (27 taps read straight from device memory through L1/L2,
//                     halo handled by index arithmetic, so no padded copy)
//   post: a3, x -> y
// Weights are packed by the wrapper as [group][...][COB] so that a warp (32
// voxels, one group) reads each weight once, as a broadcast. The a2 and a3
// scratch buffers hold Cb channels each; y ping-pongs between two buffers
// across the blocks of a stack, owned by the wrapper. All voxel offsets are
// 64-bit (the full-resolution stack has 134 M elements).
#include "brick_conv.cuh"

namespace {

constexpr int kThreads = 128;

template <typename T, int COB>
__global__ void pre_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                           const float* __restrict__ sc, T* __restrict__ a2,
                           int64_t nvox, int c, int cb) {
  const int64_t v = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (v >= nvox) return;
  const int g = blockIdx.y;
  const T* xv = x + v * c;
  const T* wg = w1 + static_cast<int64_t>(g) * c * COB;  // [G][C][COB]
  const float b1a = vq::rnd<T>(sc[0]), b1b = vq::rnd<T>(sc[1]);
  const float b2a = vq::rnd<T>(sc[2]), b2b = vq::rnd<T>(sc[3]);
  float acc[COB];
#pragma unroll
  for (int j = 0; j < COB; ++j) acc[j] = 0.f;
  for (int ci = 0; ci < c; ++ci) {
    const float t = vq::rnd<T>(vq::to_f<T>(xv[ci]) + b1a);
    const float a1 = vq::rnd<T>(vq::rnd<T>(vq::elu(t)) + b1b);
#pragma unroll
    for (int j = 0; j < COB; ++j) acc[j] = fmaf(a1, vq::to_f<T>(wg[ci * COB + j]), acc[j]);
  }
#pragma unroll
  for (int j = 0; j < COB; ++j) {
    const int k = g * COB + j;
    if (k < cb) {
      const float u = vq::rnd<T>(vq::rnd<T>(acc[j]) + b2a);
      a2[v * cb + k] = vq::from_f<T>(vq::rnd<T>(vq::elu(u)) + b2b);
    }
  }
}

template <typename T, int COB>
__global__ void conv_kernel(const T* __restrict__ a2, const T* __restrict__ w2,
                            const float* __restrict__ sc, T* __restrict__ a3,
                            int64_t nvox, int h, int w, int d, int cb, int wrap) {
  const int64_t v = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (v >= nvox) return;
  const int g = blockIdx.y;
  const int id = static_cast<int>(v % d);
  int64_t t = v / d;
  const int iw = static_cast<int>(t % w);
  t /= w;
  const int ih = static_cast<int>(t % h);
  const int64_t b = t / h;
  const T* wg = w2 + static_cast<int64_t>(g) * 27 * cb * COB;  // [G][27][Cb][COB]
  float acc[COB];
#pragma unroll
  for (int j = 0; j < COB; ++j) acc[j] = 0.f;
  for (int kh = 0; kh < 3; ++kh) {
    int hh = ih + kh - 1;
    if (hh < 0 || hh >= h) {
      if (!wrap) continue;
      hh = (hh + h) % h;
    }
    for (int kw = 0; kw < 3; ++kw) {
      int ww = iw + kw - 1;
      if (ww < 0 || ww >= w) {
        if (!wrap) continue;
        ww = (ww + w) % w;
      }
      for (int kd = 0; kd < 3; ++kd) {
        int dd = id + kd - 1;
        if (dd < 0 || dd >= d) {
          if (!wrap) continue;
          dd = (dd + d) % d;
        }
        const T* src = a2 + (((b * h + hh) * w + ww) * static_cast<int64_t>(d) + dd) * cb;
        const T* wt = wg + ((kh * 3 + kw) * 3 + kd) * cb * COB;
        for (int ci = 0; ci < cb; ++ci) {
          const float a = vq::to_f<T>(src[ci]);
#pragma unroll
          for (int j = 0; j < COB; ++j) acc[j] = fmaf(a, vq::to_f<T>(wt[ci * COB + j]), acc[j]);
        }
      }
    }
  }
  const float b3a = vq::rnd<T>(sc[4]), b3b = vq::rnd<T>(sc[5]);
#pragma unroll
  for (int j = 0; j < COB; ++j) {
    const int k = g * COB + j;
    if (k < cb) {
      const float u = vq::rnd<T>(vq::rnd<T>(acc[j]) + b3a);
      a3[v * cb + k] = vq::from_f<T>(vq::rnd<T>(vq::elu(u)) + b3b);
    }
  }
}

template <typename T, int COB>
__global__ void post_kernel(const T* __restrict__ x, const T* __restrict__ a3,
                            const T* __restrict__ w3, const float* __restrict__ sc,
                            T* __restrict__ y, int64_t nvox, int c, int cb) {
  const int64_t v = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (v >= nvox) return;
  const int g = blockIdx.y;
  const T* av = a3 + v * cb;
  const T* wg = w3 + static_cast<int64_t>(g) * cb * COB;  // [G][Cb][COB]
  float acc[COB];
#pragma unroll
  for (int j = 0; j < COB; ++j) acc[j] = 0.f;
  for (int k = 0; k < cb; ++k) {
    const float a = vq::to_f<T>(av[k]);
#pragma unroll
    for (int j = 0; j < COB; ++j) acc[j] = fmaf(a, vq::to_f<T>(wg[k * COB + j]), acc[j]);
  }
  const float b4 = vq::rnd<T>(sc[6]), scale = vq::rnd<T>(sc[7]);
#pragma unroll
  for (int j = 0; j < COB; ++j) {
    const int co = g * COB + j;
    if (co < c) {
      const float u = vq::rnd<T>(vq::rnd<T>(vq::rnd<T>(acc[j]) * scale) + b4);
      y[v * c + co] = vq::from_f<T>(u + vq::to_f<T>(x[v * c + co]));
    }
  }
}

inline dim3 grid_for(int64_t nvox, int groups) {
  return dim3(static_cast<unsigned>((nvox + kThreads - 1) / kThreads),
              static_cast<unsigned>(groups));
}

inline int groups_of(int n, int cob) { return (n + cob - 1) / cob; }

#define VQ_COB_DISPATCH(cob, KERNEL, T, ...)                        \
  switch (cob) {                                                   \
    case 1: KERNEL<T, 1>__VA_ARGS__; break;                        \
    case 2: KERNEL<T, 2>__VA_ARGS__; break;                        \
    case 4: KERNEL<T, 4>__VA_ARGS__; break;                        \
    case 8: KERNEL<T, 8>__VA_ARGS__; break;                        \
    default: return cudaErrorInvalidValue;                         \
  }

template <typename T>
cudaError_t block_fwd(const T* x, const T* w1, const T* w2, const T* w3,
                      const float* sc, T* a2, T* a3, T* y, int64_t batch, int h,
                      int w, int d, int c, int cb, int cob_b, int cob_c, int wrap,
                      cudaStream_t s) {
  const int64_t nvox = batch * h * w * static_cast<int64_t>(d);
  if (nvox == 0) return cudaSuccess;
  const dim3 gb = grid_for(nvox, groups_of(cb, cob_b));
  VQ_COB_DISPATCH(cob_b, pre_kernel, T,
                  <<<gb, kThreads, 0, s>>>(x, w1, sc, a2, nvox, c, cb))
  VQ_COB_DISPATCH(cob_b, conv_kernel, T,
                  <<<gb, kThreads, 0, s>>>(a2, w2, sc, a3, nvox, h, w, d, cb, wrap))
  const dim3 gc = grid_for(nvox, groups_of(c, cob_c));
  VQ_COB_DISPATCH(cob_c, post_kernel, T,
                  <<<gc, kThreads, 0, s>>>(x, a3, w3, sc, y, nvox, c, cb))
  return cudaGetLastError();
}

// ---- bf16: one fused kernel a block (fused_tc, fused_cc)
//
// A CTA owns a brick of output voxels (ops/stack_kernel.py fused_brick): it
// computes a2 = pre(x) for the brick and its one-voxel halo into shared
// memory (zero where 'zeros' pads), the 3x3x3 conv of the brick from there,
// its ELU epilogue a3, then y = (a3 W3) * scale + b4 + x; a2 and a3 never
// leave the SM. fused_tc (5 <= Cb <= 128, ops/conv3d.py stack_fwd_route): 8
// warps, a brick of 128 voxels (256, two m-tiles a warp, at Cb <= 32 on
// volumes of at least 2^15 voxels: less halo to recompute; ops/stack_kernel.py
// fused_voxels), every product on the tensor cores (mma.sync
// m16n8k16, bf16 in, fp32 accumulate, brick_conv.cuh): the pre with M over
// halo rows (x staged 16 rows x 16 channels a warp, a1 made in registers),
// the conv as an implicit GEMM (M brick voxels, N Cb out, K 27 taps x Cb in,
// Cb padded to CBP, a multiple of 16), W3 with M brick voxels and N over C.
// fused_cc (Cb <= 4, where padding to 16 would waste the tensor cores): a
// brick of 256 voxels, one a thread (1,024, four a thread, on volumes of at
// least 2^15 voxels: 1.8 halo rows a voxel instead of 2.5), the products on
// the CUDA cores in the order of pre_kernel / conv_kernel / post_kernel
// (bit-identical to them), the conv's 27 taps unrolled over a shared copy
// of w2; its gain is the two memory passes saved. Weights come from the wrapper as
// [N][K] (k contiguous, zero-padded): w1 [CBP][K1], w2 [27][CBP][CBP],
// w3 [N3][CBP] with K1 = C rounded up to 16 and N3 to 8 (fused_tc) or C
// (fused_cc).
constexpr int kFusedThreads = 256;
constexpr int kTcVox = 128;  // a fused_tc brick: 8 warps x 16 voxels (or twice that)
constexpr int kCcVox = 256;  // a fused_cc brick: one voxel a thread (or four)

using bf16 = __nv_bfloat16;
using vqb::kStage;
using vqb::Scalars;

template <int CBP>
__global__ void __launch_bounds__(kFusedThreads, CBP <= 32 ? 4 : 1)
    fused_tc(const bf16* __restrict__ x, const bf16* __restrict__ w1, const bf16* __restrict__ w2,
             const bf16* __restrict__ w3, const float* __restrict__ sc, bf16* __restrict__ y,
             int h, int w, int d, int c, int cb, int k1, int wrap, int bh, int bw, int bd) {
  constexpr int NT = CBP / 8, AS = CBP + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const vqb::Brick k = vqb::brick_of(blockIdx.x, h, w, d, bh, bw, bd);
  const int nh = k.rows();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  bf16* halo = reinterpret_cast<bf16*>(smem);  // [nh][AS]: a2 of the halo
  bf16* a3s = halo + nh * AS;                   // [brick voxels][AS]: a3 of the brick
  bf16* stg = a3s + bh * bw * bd * AS + warp * 16 * kStage;
  const Scalars s(sc);
  // the ldmatrix.x4 address of an A fragment: row (lane & 7) + 8 ((lane >> 3) & 1),
  // column 8 (lane >> 4)
  const int arow = (lane & 7) + 8 * ((lane >> 3) & 1), acol = 8 * (lane >> 4);

  // 1. a2 of the halo rows, 16 a warp at a time
  vqb::halo_pre<NT>(halo, AS, stg, k, x, w1, s, h, w, d, c, cb, k1, wrap, warp,
                    kFusedThreads / 32, lane);
  __syncthreads();

  // 2.-3. per m-tile of the warp's (brick rows 16 mt .. 16 mt + 15): the
  // conv and its epilogue a3 into shared memory, then y = (a3 W3) * scale +
  // b4 + x, 64 channels at a time
  const int ntc = (c + 7) / 8;
  const bool pair = c % 2 == 0;  // y and x by bf16 pairs (c even: 4-byte aligned)
  for (int mt = warp; mt * 16 < k.bh * k.bw * k.bd; mt += kFusedThreads / 32) {
    const int m0 = mt * 16;
    float acc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
    vqb::conv_tile<NT, CBP>(acc, halo, AS, k, m0, w2, lane);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = m0 + g + 8 * half;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = nt * 8 + 2 * t;
        const float lo = n < cb ? s.a3(acc[nt][2 * half]) : 0.f;
        const float hi = n + 1 < cb ? s.a3(acc[nt][2 * half + 1]) : 0.f;
        *reinterpret_cast<uint32_t*>(a3s + r * AS + n) = vq::pack_bf16(lo, hi);
      }
    }
    __syncwarp();
    const int64_t v[2] = {vqb::brick_voxel(k, m0 + g, h, w, d),
                          vqb::brick_voxel(k, m0 + g + 8, h, w, d)};
    for (int n0 = 0; n0 < ntc; n0 += 8) {
      float acc2[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc2[j][0] = acc2[j][1] = acc2[j][2] = acc2[j][3] = 0.f;
#pragma unroll
      for (int k0 = 0; k0 < CBP; k0 += 16) {
        uint32_t a[4];
        vq::ldsm_x4(a, vq::smem_u32(a3s + (m0 + arow) * AS + k0 + acol));
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (n0 + j >= ntc) break;
          const bf16* p = w3 + static_cast<int64_t>((n0 + j) * 8 + g) * CBP + k0 + 2 * t;
          vq::mma_16816(acc2[j], a, vqb::ldg32(p), vqb::ldg32(p + 8));
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        if (v[half] < 0) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (n0 + j >= ntc) break;
          const int cc = (n0 + j) * 8 + 2 * t;
          if (cc >= c) continue;
          const int64_t o = v[half] * c + cc;
          if (pair) {
            const __nv_bfloat162 x2 = *reinterpret_cast<const __nv_bfloat162*>(x + o);
            __nv_bfloat162 y2;
            y2.x = s.y(acc2[j][2 * half], x2.x);
            y2.y = s.y(acc2[j][2 * half + 1], x2.y);
            *reinterpret_cast<__nv_bfloat162*>(y + o) = y2;
          } else {
            y[o] = s.y(acc2[j][2 * half], x[o]);
            if (cc + 1 < c) y[o + 1] = s.y(acc2[j][2 * half + 1], x[o + 1]);
          }
        }
      }
    }
  }
}

template <int CB>
__global__ void __launch_bounds__(kFusedThreads)
    fused_cc(const bf16* __restrict__ x, const bf16* __restrict__ w1, const bf16* __restrict__ w2,
             const bf16* __restrict__ w3, const float* __restrict__ sc, bf16* __restrict__ y,
             int h, int w, int d, int c, int cb, int wrap, int bh, int bw, int bd) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ws = reinterpret_cast<float*>(smem);  // w2 [27][CB][CB] as fp32
  float* halo = ws + 27 * CB * CB;              // [nh][CB]: a2 of the halo
  const vqb::Brick k = vqb::brick_of(blockIdx.x, h, w, d, bh, bw, bd);
  const int nh = k.rows(), nv = bh * bw * bd;
  const Scalars s(sc);
  for (int e = threadIdx.x; e < 27 * CB * CB; e += kFusedThreads) ws[e] = vq::to_f<bf16>(w2[e]);
  for (int r = threadIdx.x; r < nh; r += kFusedThreads) {
    const int64_t hv = vqb::halo_voxel(k, r, h, w, d, wrap);
    float acc[CB];
#pragma unroll
    for (int j = 0; j < CB; ++j) acc[j] = 0.f;
    if (hv >= 0)
      for (int ci = 0; ci < c; ++ci) {
        const float a = s.a1(vq::to_f<bf16>(x[hv * c + ci]));
#pragma unroll
        for (int j = 0; j < CB; ++j) acc[j] = fmaf(a, vq::to_f<bf16>(w1[j * c + ci]), acc[j]);
      }
#pragma unroll
    for (int j = 0; j < CB; ++j) halo[r * CB + j] = hv >= 0 && j < cb ? s.a2(acc[j]) : 0.f;
  }
  __syncthreads();
  const int hd = k.hd(), hwd = k.hw() * hd;
  for (int r = threadIdx.x; r < nv; r += kFusedThreads) {  // the brick's voxels, a few a thread
    const int64_t v = vqb::brick_voxel(k, r, h, w, d);
    if (v < 0) continue;
    const float* src0 = halo + vqb::halo_base(k, r) * CB;
    float acc[CB];
#pragma unroll
    for (int j = 0; j < CB; ++j) acc[j] = 0.f;
    // the taps in conv_kernel's order (kh, kw, kd, then the input channels; the
    // channels past Cb are zero, so their terms add nothing)
#pragma unroll
    for (int kh = 0; kh < 3; ++kh)
#pragma unroll
      for (int kw = 0; kw < 3; ++kw)
#pragma unroll
        for (int kd = 0; kd < 3; ++kd) {
          const float* src = src0 + (kh * hwd + kw * hd + kd) * CB;
          const float* wt = ws + ((kh * 3 + kw) * 3 + kd) * CB * CB;
          float a[CB];
          if constexpr (CB == 4) {
            const float4 q = *reinterpret_cast<const float4*>(src);
            a[0] = q.x, a[1] = q.y, a[2] = q.z, a[3] = q.w;
          } else if constexpr (CB == 2) {
            const float2 q = *reinterpret_cast<const float2*>(src);
            a[0] = q.x, a[1] = q.y;
          } else {
            a[0] = src[0];
          }
#pragma unroll
          for (int ci = 0; ci < CB; ++ci)
#pragma unroll
            for (int j = 0; j < CB; ++j) acc[j] = fmaf(a[ci], wt[j * CB + ci], acc[j]);
        }
    float a3[CB];
#pragma unroll
    for (int j = 0; j < CB; ++j) a3[j] = s.a3(acc[j]);
    for (int co = 0; co < c; ++co) {
      float o = 0.f;
      for (int kk = 0; kk < cb; ++kk) o = fmaf(a3[kk], vq::to_f<bf16>(w3[co * CB + kk]), o);
      y[v * c + co] = s.y(o, x[v * c + co]);
    }
  }
}

inline int cdiv(int64_t a, int64_t b) { return static_cast<int>((a + b - 1) / b); }

template <typename K>
cudaError_t launch_fused(K kernel, int64_t bricks, int smem, cudaStream_t s, void** args) {
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const cudaError_t e = cudaLaunchKernel(reinterpret_cast<const void*>(kernel),
                                         dim3(static_cast<unsigned>(bricks)), dim3(kFusedThreads),
                                         args, static_cast<size_t>(smem), s);
  return e != cudaSuccess ? e : cudaGetLastError();
}

cudaError_t block_fwd_fused(const bf16* x, const bf16* w1, const bf16* w2, const bf16* w3,
                            const float* sc, bf16* y, int64_t batch, int h, int w, int d, int c,
                            int cb, int cbp, int tensor_cores, int wrap, int bh, int bw, int bd,
                            cudaStream_t s) {
  if (batch <= 0 || h <= 0 || w <= 0 || d <= 0 || c <= 0 || cb <= 0 || cbp < cb || bh <= 0 ||
      bw <= 0 || bd <= 0 ||
      (tensor_cores ? bh * bw * bd != kTcVox && bh * bw * bd != 2 * kTcVox
                    : bh * bw * bd != kCcVox && bh * bw * bd != 4 * kCcVox))
    return cudaErrorInvalidValue;
  const int64_t bricks = batch * cdiv(h, bh) * cdiv(w, bw) * static_cast<int64_t>(cdiv(d, bd));
  if (bricks > 0x7fffffff) return cudaErrorInvalidValue;
  const int nh = (bh + 2) * (bw + 2) * (bd + 2);
  int k1 = (c + 15) / 16 * 16;
  void* args[] = {&x, &w1, &w2, &w3, &sc, &y, &h, &w, &d, &c, &cb, &k1, &wrap, &bh, &bw, &bd};
  void* cc_args[] = {&x, &w1, &w2, &w3, &sc, &y, &h, &w, &d, &c, &cb, &wrap, &bh, &bw, &bd};
  if (tensor_cores) {
    const int smem = ((nh + bh * bw * bd) * (cbp + 8) + kFusedThreads / 32 * 16 * kStage) * 2;
    switch (cbp) {
      case 16: return launch_fused(fused_tc<16>, bricks, smem, s, args);
      case 32: return launch_fused(fused_tc<32>, bricks, smem, s, args);
      case 48: return launch_fused(fused_tc<48>, bricks, smem, s, args);
      case 64: return launch_fused(fused_tc<64>, bricks, smem, s, args);
      case 80: return launch_fused(fused_tc<80>, bricks, smem, s, args);
      case 96: return launch_fused(fused_tc<96>, bricks, smem, s, args);
      case 112: return launch_fused(fused_tc<112>, bricks, smem, s, args);
      case 128: return launch_fused(fused_tc<128>, bricks, smem, s, args);
      default: return cudaErrorInvalidValue;
    }
  }
  const int smem = (27 * cbp * cbp + nh * cbp) * 4;
  switch (cbp) {
    case 1: return launch_fused(fused_cc<1>, bricks, smem, s, cc_args);
    case 2: return launch_fused(fused_cc<2>, bricks, smem, s, cc_args);
    case 4: return launch_fused(fused_cc<4>, bricks, smem, s, cc_args);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// One block of a stack. Activations x, y (B, H, W, D, C) and scratch a2, a3
// (B, H, W, D, Cb) are contiguous, of type bf16 when is_bf16 else fp32, as are
// the packed weights w1 [Gb][C][cob_b], w2 [Gb][27][Cb][cob_b] and
// w3 [Gc][Cb][cob_c] (groups zero-padded; cob_b serves the Cb-wide outputs,
// cob_c the C-wide ones). sc holds the block's 8 fp32 scalars
// (b1a, b1b, b2a, b2b, b3a, b3b, b4, scale). y must not alias x.
extern "C" int vq_preact_block_fwd(int is_bf16, const void* x, const void* w1,
                                   const void* w2, const void* w3, const void* sc,
                                   void* a2, void* a3, void* y, int64_t batch,
                                   int h, int w, int d, int c, int cb, int cob_b,
                                   int cob_c, int wrap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* scf = static_cast<const float*>(sc);
  if (is_bf16) {
    using T = __nv_bfloat16;
    return block_fwd<T>(static_cast<const T*>(x), static_cast<const T*>(w1),
                        static_cast<const T*>(w2), static_cast<const T*>(w3), scf,
                        static_cast<T*>(a2), static_cast<T*>(a3), static_cast<T*>(y),
                        batch, h, w, d, c, cb, cob_b, cob_c, wrap, s);
  }
  return block_fwd<float>(static_cast<const float*>(x), static_cast<const float*>(w1),
                          static_cast<const float*>(w2), static_cast<const float*>(w3),
                          scf, static_cast<float*>(a2), static_cast<float*>(a3),
                          static_cast<float*>(y), batch, h, w, d, c, cb, cob_b, cob_c,
                          wrap, s);
}

// One block of a stack on the bf16 route that fuses it into one kernel
// (fused_tc with tensor_cores, else fused_cc). x, y (B, H, W, D, C) bf16
// contiguous; the weights bf16 in the fused layouts (the comment above
// fused_tc) with Cb padded to cbp (fused_tc: 16 .. 128 in steps of 16;
// fused_cc: 1, 2 or 4); sc the block's 8 fp32 scalars; (bh, bw, bd) the brick,
// 128 voxels for fused_tc and 256 for fused_cc. y must not alias x.
extern "C" int vq_preact_block_fwd_fused(const void* x, const void* w1, const void* w2,
                                         const void* w3, const void* sc, void* y, int64_t batch,
                                         int h, int w, int d, int c, int cb, int cbp,
                                         int tensor_cores, int wrap, int bh, int bw, int bd,
                                         void* stream) {
  return block_fwd_fused(static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
                         static_cast<const bf16*>(w2), static_cast<const bf16*>(w3),
                         static_cast<const float*>(sc), static_cast<bf16*>(y), batch, h, w, d, c,
                         cb, cbp, tensor_cores, wrap, bh, bw, bd,
                         static_cast<cudaStream_t>(stream));
}
