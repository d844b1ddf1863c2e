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
// 256x256x64 outputs; the top prior's (2,3,3) and (1,2,3) causal convs at
// C = 16) it is 27 * Cin * Cout multiply-adds per output voxel against
// (Cin + Cout) values read: on the bf16 tensor cores it is bound by reading
// x and g once (~0.05 ms at 256x256x64, C = 9, bf16).
//
// Two routes, chosen before the launch by the dtype and the kernel size in
// ops/conv3d.py::dw_tensor_core_route and passed in (neither is a fallback
// of the other):
//
// bf16, kernels up to 3x3x3: an implicit GEMM on the tensor cores, dw_tc.
// A CTA walks bricks of 4 x 4 x 16 output positions (16 lines along D, the
// contiguous axis) in a persistent loop. Each brick's g (positions x Cout)
// and its x with the kernel's halo (6 x 6 x 18 positions x Cin) are staged
// once in shared memory, position-major with 8 channels a 16-byte row (two
// positions a 32-bit load where the D extent is even). Each
// tap is one product over the brick's positions, dW_tap (Cout x Cin) +=
// G (Cout x 16 positions) . X_tap (16 positions x Cin), on mma.sync
// m16n8k16 (M = Cout padded to 16, N = Cin padded to 8 or 16, K = 16
// positions of a line): G's A fragment is one ldmatrix.trans a line, reused
// by every tap, X's B fragments are ldmatrix.trans at the tap's shifted
// rows. The warps split the taps, one i of the kernel each (9 taps, all
// computed without a branch; those past a smaller kernel are not written),
// and the m- and n-blocks; each keeps its taps' fp32 sums in registers: a
// brick's sums start at zero and are added to the CTA's running sums after
// the brick. The tensor cores' fp32 accumulation loses bits over long
// chains (on an H100, one chain over all of a CTA's bricks at 256x256x64,
// C = 9, came near the 1e-5 tolerance; flushed a brick, ten times inside
// it), so no chain is longer than a brick's 16 lines.
// Positions past the output's extent stage g = 0 (and x past the input's
// 0), so ragged bricks need no other mask.
//
// fp32, or a kernel larger than 3 on an axis: the CUDA cores, dw_partial
// (tensor cores would round fp32 to TF32). Grid (chunk, tap); a CTA stages
// tiles of 64 consecutive output positions of its chunk in shared memory
// (the g values and the x values at position + tap, for all channels) and
// each thread accumulates its (co, ci) pairs over the tile, in fp32. With
// fewer than 256 pairs, lanes of threads split the tile's positions and are
// summed in lane order at the end of the chunk.
//
// Each CTA writes its per-tap partial; pass 2 (dw_reduce) sums the chunks in
// order. No atomics: the same inputs give a bit-identical dW (the TPU kernel
// accumulates in one sequential grid; here the chunks are the order-fixed
// substitute).
#include "common.cuh"
#include "mma.cuh"

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

// dW[co][ci][tap] = sum over chunks, in order, of part[chunk][tap][co * cin + ci];
// thread i reads element i of every chunk (coalesced)
__global__ void dw_reduce(const float* __restrict__ part, float* __restrict__ dw, int nchunks,
                          int pairs, int kvol) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= pairs * kvol) return;
  const int tap = i / pairs, e = i % pairs;
  const int64_t stride = static_cast<int64_t>(kvol) * pairs;
  float s = 0.f;
  for (int ch = 0; ch < nchunks; ++ch) s += part[ch * stride + i];
  dw[static_cast<int64_t>(e) * kvol + tap] = s;
}

// ---- bf16, kernels up to 3x3x3: tensor cores ----

constexpr int TBH = 4, TBW = 4, TBD = 16;  // output brick, 16 lines of 16 (ops/conv3d.py DW_BRICK)
constexpr int XH = TBH + 2, XW = TBW + 2, XD = TBD + 2;  // its x tile with a 3x3x3 halo
constexpr int XROWS = XH * XW * XD, GROWS = TBH * TBW * TBD;

template <int CI8, int CO16>  // Cin padded to 8, 16 or 32; Cout to 16 or 32
struct TcShape {
  static constexpr int NB = CI8 / 8, MB = CO16 / 16;  // n-blocks of 8 ci, m-blocks of 16 co
  static constexpr int NBW = NB < 2 ? NB : 2;         // n-blocks a warp
  static constexpr int WARPS = 3 * MB * (NB / NBW);   // (i, m-block, n-block pair)
  static constexpr int XS = CI8 == 8 ? 8 : CI8 + 8;   // row strides (bf16): the 8 rows of
  static constexpr int GS = CO16 + 8;                 //   an ldmatrix on distinct banks
  static constexpr int SMEM = (XROWS * XS + GROWS * GS) * 2;
};

// One position's channels c0 .. c0 + 7 of a (B, C, ...) bf16 tensor as one
// shared row of 16 bytes; channels past c and positions outside the extent
// read as 0.
__device__ __forceinline__ uint4 gather8(const __nv_bfloat16* src, int64_t plane, int c0, int c,
                                         bool in) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ca = c0 + 2 * i;
    const uint32_t lo = in && ca < c ? __bfloat16_as_ushort(src[ca * plane]) : 0u;
    const uint32_t hi = in && ca + 1 < c ? __bfloat16_as_ushort(src[(ca + 1) * plane]) : 0u;
    w[i] = lo | (hi << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The same for two positions d, d + 1 at once (rows r0, r1), one 32-bit load
// a channel: taken when the extent along D is even and the tensor 4-byte
// aligned, so every even d starts an aligned pair inside the extent.
__device__ __forceinline__ void gather8x2(const __nv_bfloat16* src, int64_t plane, int c0, int c,
                                          bool in, uint4& r0, uint4& r1) {
  uint32_t v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    v[i] = in && c0 + i < c ? *reinterpret_cast<const uint32_t*>(src + (c0 + i) * plane) : 0u;
  r0 = make_uint4(__byte_perm(v[0], v[1], 0x5410), __byte_perm(v[2], v[3], 0x5410),
                  __byte_perm(v[4], v[5], 0x5410), __byte_perm(v[6], v[7], 0x5410));
  r1 = make_uint4(__byte_perm(v[0], v[1], 0x7632), __byte_perm(v[2], v[3], 0x7632),
                  __byte_perm(v[4], v[5], 0x7632), __byte_perm(v[6], v[7], 0x7632));
}

template <int CI8, int CO16>
__global__ void __launch_bounds__(32 * TcShape<CI8, CO16>::WARPS,
                                  12 / TcShape<CI8, CO16>::WARPS)
    dw_tc(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ g,
          float* __restrict__ part, int64_t batch, int cin, int cout, int hp, int wp, int dp,
          int kh, int kw, int kd) {
  using C = TcShape<CI8, CO16>;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* gs = xs + XROWS * C::XS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ti = warp % 3, mb = warp / 3 % C::MB, nb0 = warp / (3 * C::MB) * C::NBW;
  const int ho = hp - kh + 1, wo = wp - kw + 1, dout = dp - kd + 1;
  const int nbh = (ho + TBH - 1) / TBH, nbw = (wo + TBW - 1) / TBW, nbd = (dout + TBD - 1) / TBD;
  const int64_t nbricks = batch * nbh * nbw * nbd;
  // pairs of positions a load where the D extents allow (XD and TBD are even)
  const bool xpair = (dp & 1) == 0 && (reinterpret_cast<uintptr_t>(x) & 3) == 0;
  const bool gpair = (dout & 1) == 0 && (reinterpret_cast<uintptr_t>(g) & 3) == 0;
  const int64_t xplane = static_cast<int64_t>(hp) * wp * dp;
  const int64_t gplane = static_cast<int64_t>(ho) * wo * dout;
  float tot[9][C::NBW][4];
#pragma unroll
  for (int tp = 0; tp < 9; ++tp)
#pragma unroll
    for (int w = 0; w < C::NBW; ++w) tot[tp][w][0] = tot[tp][w][1] = tot[tp][w][2] = tot[tp][w][3] = 0.f;

  for (int64_t br = blockIdx.x; br < nbricks; br += gridDim.x) {
    int64_t r = br;
    const int bd = static_cast<int>(r % nbd);
    r /= nbd;
    const int bw = static_cast<int>(r % nbw);
    r /= nbw;
    const int bh = static_cast<int>(r % nbh);
    const int64_t b = r / nbh;
    const int h0 = bh * TBH, w0 = bw * TBW, d0 = bd * TBD;
    // x tile: row (hh, ww, dd) of the brick's input window
    const __nv_bfloat16* xb = x + b * cin * xplane;
    if (xpair) {
#pragma unroll 1
      for (int e = tid; e < XROWS / 2 * (CI8 / 8); e += blockDim.x) {
        const int row = 2 * (e % (XROWS / 2)), cg = e / (XROWS / 2);
        const int dd = row % XD, ww = row / XD % XW, hh = row / (XD * XW);
        const int h = h0 + hh, w = w0 + ww, d = d0 + dd;
        const bool in = h < hp && w < wp && d < dp;
        uint4 r0, r1;
        gather8x2(xb + (static_cast<int64_t>(h) * wp + w) * dp + d, xplane, 8 * cg, cin, in, r0, r1);
        *reinterpret_cast<uint4*>(xs + row * C::XS + 8 * cg) = r0;
        *reinterpret_cast<uint4*>(xs + (row + 1) * C::XS + 8 * cg) = r1;
      }
    } else {
    for (int e = tid; e < XROWS * (CI8 / 8); e += blockDim.x) {
      const int row = e % XROWS, cg = e / XROWS;
      const int dd = row % XD, ww = row / XD % XW, hh = row / (XD * XW);
      const int h = h0 + hh, w = w0 + ww, d = d0 + dd;
      const bool in = h < hp && w < wp && d < dp;
      *reinterpret_cast<uint4*>(xs + row * C::XS + 8 * cg) =
          gather8(xb + (static_cast<int64_t>(h) * wp + w) * dp + d, xplane, 8 * cg, cin, in);
    }
    }
    // g tile: row line * TBD + dd, line = hh * TBW + ww
    const __nv_bfloat16* gb = g + b * cout * gplane;
    if (gpair) {
#pragma unroll 1
      for (int e = tid; e < GROWS / 2 * (CO16 / 8); e += blockDim.x) {
        const int row = 2 * (e % (GROWS / 2)), cg = e / (GROWS / 2);
        const int dd = row % TBD, ww = row / TBD % TBW, hh = row / (TBD * TBW);
        const int h = h0 + hh, w = w0 + ww, d = d0 + dd;
        const bool in = h < ho && w < wo && d < dout;
        uint4 r0, r1;
        gather8x2(gb + (static_cast<int64_t>(h) * wo + w) * dout + d, gplane, 8 * cg, cout, in, r0, r1);
        *reinterpret_cast<uint4*>(gs + row * C::GS + 8 * cg) = r0;
        *reinterpret_cast<uint4*>(gs + (row + 1) * C::GS + 8 * cg) = r1;
      }
    } else {
    for (int e = tid; e < GROWS * (CO16 / 8); e += blockDim.x) {
      const int row = e % GROWS, cg = e / GROWS;
      const int dd = row % TBD, ww = row / TBD % TBW, hh = row / (TBD * TBW);
      const int h = h0 + hh, w = w0 + ww, d = d0 + dd;
      const bool in = h < ho && w < wo && d < dout;
      *reinterpret_cast<uint4*>(gs + row * C::GS + 8 * cg) =
          gather8(gb + (static_cast<int64_t>(h) * wo + w) * dout + d, gplane, 8 * cg, cout, in);
    }
    }
    __syncthreads();

    float acc[9][C::NBW][4];
#pragma unroll
    for (int tp = 0; tp < 9; ++tp)
#pragma unroll
      for (int w = 0; w < C::NBW; ++w) acc[tp][w][0] = acc[tp][w][1] = acc[tp][w][2] = acc[tp][w][3] = 0.f;
    if (ti < kh) {
      for (int line = 0; line < TBH * TBW; ++line) {
        const int hh = line / TBW, ww = line % TBW;
        // G's A fragment (co x 16 positions): lanes 8q .. 8q+7 address positions
        // 8 (q / 2) + 0..7 at co 16 mb + 8 (q % 2)
        uint32_t a[4];
        vq::ldsm_x4_t(a, vq::smem_u32(gs + (line * TBD + (lane & 7) + 8 * (lane >> 4)) * C::GS +
                                      16 * mb + 8 * ((lane >> 3) & 1)));
        // all 9 taps, branch-free: a tap past the kernel reads rows inside the
        // tile and sums into a register that is never written out
#pragma unroll
        for (int j = 0; j < 3; ++j)
#pragma unroll
          for (int l = 0; l < 3; ++l) {
            const int xr = ((hh + ti) * XW + ww + j) * XD + l;  // x row of the line's position 0
            if constexpr (C::NBW == 2) {
              // lanes 8q .. 8q+7: positions 8 (q % 2) + 0..7 at ci 8 (nb0 + q / 2)
              uint32_t bf[4];
              vq::ldsm_x4_t(bf, vq::smem_u32(xs + (xr + (lane & 7) + 8 * ((lane >> 3) & 1)) * C::XS +
                                             8 * (nb0 + (lane >> 4))));
              vq::mma_16816(acc[3 * j + l][0], a, bf[0], bf[1]);
              vq::mma_16816(acc[3 * j + l][1], a, bf[2], bf[3]);
            } else {
              uint32_t bf[2];
              vq::ldsm_x2_t(bf, vq::smem_u32(xs + (xr + (lane & 15)) * C::XS + 8 * nb0));
              vq::mma_16816(acc[3 * j + l][0], a, bf[0], bf[1]);
            }
          }
      }
    }
#pragma unroll
    for (int tp = 0; tp < 9; ++tp)
#pragma unroll
      for (int w = 0; w < C::NBW; ++w)
#pragma unroll
        for (int e = 0; e < 4; ++e) tot[tp][w][e] += acc[tp][w][e];
    __syncthreads();  // the tiles are refilled for the next brick
  }

  if (ti >= kh) return;
  const int kvol = kh * kw * kd, gq = lane >> 2, tq = lane & 3;
  float* out = part + static_cast<int64_t>(blockIdx.x) * kvol * cin * cout;
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int l = 0; l < 3; ++l) {
      if (j >= kw || l >= kd) continue;
      const int tap = (ti * kw + j) * kd + l;
#pragma unroll
      for (int w = 0; w < C::NBW; ++w)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int co = 16 * mb + gq + 8 * (e >> 1), ci = 8 * (nb0 + w) + 2 * tq + (e & 1);
          if (co < cout && ci < cin)
            out[static_cast<int64_t>(tap) * cin * cout + co * cin + ci] = tot[3 * j + l][w][e];
        }
    }
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

template <int CI8, int CO16>
cudaError_t dw_conv3d_tc(const __nv_bfloat16* x, const __nv_bfloat16* g, float* dw, float* part,
                         int nchunks, int64_t batch, int cin, int cout, int hp, int wp, int dp,
                         int kh, int kw, int kd, cudaStream_t s) {
  using C = TcShape<CI8, CO16>;
  if (C::SMEM > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        dw_tc<CI8, CO16>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (e != cudaSuccess) return e;
  }
  dw_tc<CI8, CO16><<<nchunks, 32 * C::WARPS, C::SMEM, s>>>(x, g, part, batch, cin, cout, hp, wp,
                                                            dp, kh, kw, kd);
  const int kvol = kh * kw * kd, total = cin * cout * kvol;
  dw_reduce<<<(total + kThreads - 1) / kThreads, kThreads, 0, s>>>(part, dw, nchunks,
                                                                    cin * cout, kvol);
  return cudaGetLastError();
}

template <int CI8>
cudaError_t dw_conv3d_tc_co(const __nv_bfloat16* x, const __nv_bfloat16* g, float* dw,
                            float* part, int nchunks, int64_t batch, int cin, int cout, int hp,
                            int wp, int dp, int kh, int kw, int kd, cudaStream_t s) {
  if (cout <= 16)
    return dw_conv3d_tc<CI8, 16>(x, g, dw, part, nchunks, batch, cin, cout, hp, wp, dp, kh, kw,
                                 kd, s);
  return dw_conv3d_tc<CI8, 32>(x, g, dw, part, nchunks, batch, cin, cout, hp, wp, dp, kh, kw, kd,
                               s);
}

}  // namespace

// x (B, Cin, Hp, Wp, Dp) and g (B, Cout, Ho, Wo, Do) contiguous, bf16 when
// is_bf16 else fp32 -> dw (Cout, Cin, kh, kw, kd) fp32. The caller picks the
// route (ops/conv3d.py::dw_tensor_core_route) and the chunk count
// (ops/conv3d.py::dw_chunks, a function of the shapes only); this entry point
// only dispatches, and refuses a tensor-core launch its inputs or its brick
// (brick_h, brick_w, brick_d: the caller's DW_BRICK) do not fit. part is
// scratch of nchunks * kh * kw * kd * Cin * Cout floats: the CUDA-core
// route's chunks of output positions, or the tensor-core route's CTAs.
extern "C" int vq_dw_conv3d(int is_bf16, int tensor_cores, const void* x, const void* g,
                            void* dw, void* part, int nchunks, int64_t batch, int cin, int cout,
                            int hp, int wp, int dp, int kh, int kw, int kd, int brick_h,
                            int brick_w, int brick_d, void* stream) {
  if (cin < 1 || cout < 1 || cin > kMaxC || cout > kMaxC || nchunks < 1) {
    return cudaErrorInvalidValue;
  }
  if (kh < 1 || kw < 1 || kd < 1 || kh > hp || kw > wp || kd > dp) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(dw);
  float* pf = static_cast<float*>(part);
  if (tensor_cores) {
    if (!is_bf16 || kh > 3 || kw > 3 || kd > 3 || brick_h != TBH || brick_w != TBW ||
        brick_d != TBD) {
      return cudaErrorInvalidValue;
    }
    using T = __nv_bfloat16;
    const T* xb = static_cast<const T*>(x);
    const T* gb = static_cast<const T*>(g);
    if (cin <= 8)
      return dw_conv3d_tc_co<8>(xb, gb, out, pf, nchunks, batch, cin, cout, hp, wp, dp, kh, kw,
                                kd, s);
    if (cin <= 16)
      return dw_conv3d_tc_co<16>(xb, gb, out, pf, nchunks, batch, cin, cout, hp, wp, dp, kh, kw,
                                 kd, s);
    return dw_conv3d_tc_co<32>(xb, gb, out, pf, nchunks, batch, cin, cout, hp, wp, dp, kh, kw,
                               kd, s);
  }
  if (is_bf16) {
    using T = __nv_bfloat16;
    return dw_conv3d<T>(static_cast<const T*>(x), static_cast<const T*>(g), out, pf, nchunks,
                        batch, cin, cout, hp, wp, dp, kh, kw, kd, s);
  }
  return dw_conv3d<float>(static_cast<const float*>(x), static_cast<const float*>(g), out, pf,
                          nchunks, batch, cin, cout, hp, wp, dp, kh, kw, kd, s);
}
