// Kernel K6, wide: one row of cached PixelCNN ancestral sampling at the
// published mid and bottom widths.
//
// Replaces vqvae3d_tpu/ops/decode_row.py:row_decode (Pallas kernel
// _row_kernel) where csrc/row_decode.cu cannot: that kernel keeps every
// weight in shared memory and runs the voxel chain on one warp, lane c owning
// channel c, so it takes C <= 32 and br <= 8. The contract, the weight
// layouts and the plain version are in ops/decode_row.py, which picks the
// kernel from the shapes before any launch. fp32 throughout, CUDA cores.
//
// The published wide priors: mid (jobs/train_pixelcnn_mid.sh) L = 46,
// C = 256, br = 64, K = 256, conditioned, rows of s2 = 8 at batch 10 (1,024
// rows a 32x32x8 grid); bottom (jobs/train_pixelcnn_bottom.sh) L = 51,
// C = 512, br = 128, K = 512, unconditioned, s2 = 2 at batch 20 (64 rows an
// 8x8x2 grid).
//
// What bounds it on the H100: a layer's weights are ~0.4 M fp32 at mid and
// ~1.6 M at bottom: ~18 MB a model at mid (it fits the 50 MB L2) and ~80 MB
// at bottom (it does not), far past shared memory. Every voxel runs the
// whole chain (C -> br, the width taps, br -> C) through all L layers, one
// voxel after the other, and each layer's products need that layer's
// weights: 2 C br + 2 br^2 floats, 160 KB at mid and 640 KB at bottom, read
// again for every voxel of the row. The serial chain bounds it: per layer a
// few dependent steps, each waiting on L2 reads of its weights.
//
// Design (simple first; speed is later work): one block of 512 threads per
// batch element (grid B), the weights streamed from device memory (through
// L2) at every use, coalesced: thread t owns output column t % width of a
// product, and a product over C is split into NT / br partial sums reduced
// in shared memory in a fixed order (no atomics: the same inputs give the
// same bits). Shared memory holds the row's state: the h2w injections of
// every layer (phase 1 writes, phase 2 reads), the width taps' caches, the
// height stream's row and the voxel's C-wide width stream.
//  * phase 1, the height-row step: the row's s2 positions together, per
//    layer u = elu(.), the C -> br product, h2w, the new v-row (the v-row
//    caches are read into shared memory and updated IN PLACE in device
//    memory), the 2x3 height taps with zero fill along s2, the condition and
//    the br -> C output with its residual (layer 0: its skip conv).
//  * phase 2, the voxel chain: per voxel and layer u, the C -> br product,
//    v (with d2w and h2w), the two width taps [cached v, v], the condition,
//    the br -> C output; then the logits (K columns over C), and
//    argmax(logits / tau + gumbel) as a block reduction, ties to the lowest
//    index; a voxel with a non-finite logit gets -1 (the sampler reports
//    it, the next voxel reads code 0's embedding). The sampled code's
//    w_in row + b_in feeds the next voxel's layer 0.
// ELU is expm1 for x <= 0, as the plain version's.
#include "common.cuh"

#include <math_constants.h>

namespace {

constexpr int NT = 512;  // threads a block
constexpr int NW = NT / 32;

struct RowArgs {
  const float *w1, *wk, *w3, *b3, *sc;
  const float *hw1, *herf, *herfb, *hwk, *hw3, *hb3;
  const float *skw, *hskw;
  const float *w_in, *b_in, *w_out, *b_out;
  const float *d2h, *d2w, *cnd, *dfin, *sprev;
  float* vhc;
  const float* gum;
  const int* forced;
  int* out;
  float* logits;
  int L, B, s2, C, br, K, i1;
  float tau;
};

struct Smem {
  int hw, vc, h, u1, sp, tp, v1, vp, w3v1, w, sv, u, part, v, w3v, tot, total;
};

__host__ __device__ inline Smem smem_layout(int L, int s2, int C, int br) {
  Smem m;
  int o = 0;
  m.hw = o;   o += L * s2 * br;
  m.vc = o;   o += L * br;
  m.h = o;    o += s2 * C;
  m.u1 = o;   o += s2 * C;
  m.sp = o;   o += s2 * C;
  m.tp = o;   o += s2 * br;
  m.v1 = o;   o += s2 * br;
  m.vp = o;   o += s2 * br;
  m.w3v1 = o; o += s2 * br;
  m.w = o;    o += C;
  m.sv = o;   o += C;
  m.u = o;    o += C;
  m.part = o; o += NT;
  m.v = o;    o += br;
  m.w3v = o;  o += br;
  m.tot = o;  o += C;
  m.total = o;
  return m;
}

__global__ void __launch_bounds__(NT) row_decode_wide_kernel(RowArgs a) {
  extern __shared__ float sm[];
  __shared__ float red_v[NW];
  __shared__ int red_i[NW];
  __shared__ int idx_s;
  const int L = a.L, B = a.B, s2 = a.s2, C = a.C, br = a.br, K = a.K;
  const bool cond = a.cnd != nullptr, l0_skip = a.skw != nullptr;
  const Smem m = smem_layout(L, s2, C, br);
  const int b = blockIdx.x, tid = threadIdx.x;
  // the C -> br and 2br -> br products: NT / br partial sums of each column
  const int nparts = NT / br, part = tid / br, col = tid % br;
  const int cchunk = (C + nparts - 1) / nparts, tchunk = (2 * br + nparts - 1) / nparts;
  auto rowoff = [&](int li, int p) {  // (L, B, s2, br) row tensors
    return (static_cast<size_t>(li * B + b) * s2 + p) * br;
  };

  for (int e = tid; e < s2 * C; e += NT) sm[m.sp + e] = a.sprev[static_cast<size_t>(b) * s2 * C + e];
  for (int e = tid; e < s2 * C; e += NT) sm[m.h + e] = a.b_in[e % C];
  for (int e = tid; e < L * br; e += NT) sm[m.vc + e] = 0.f;
  __syncthreads();

  // ---- phase 1: the height-row step, the row's positions together
  for (int li = 0; li < L; ++li) {
    const float* s = a.sc + li * 8;
    const float s0 = s[0], s1 = s[1], s2a = s[2], s3 = s[3], s4 = s[4], s5 = s[5];
    for (int e = tid; e < s2 * C; e += NT) {
      float u = vq::elu((li == 0 ? sm[m.sp + e] : sm[m.h + e]) + s0) + s1;
      if (li == 0 && a.i1 == 0) u = 0.f;
      sm[m.u1 + e] = u;
    }
    __syncthreads();
    for (int e = tid; e < s2 * br; e += NT) {
      const int p = e / br, j = e % br;
      const float* w = a.hw1 + static_cast<size_t>(li) * C * br + j;
      const float* u = sm + m.u1 + p * C;
      float acc = 0.f;
      for (int c = 0; c < C; ++c) acc = fmaf(u[c], w[static_cast<size_t>(c) * br], acc);
      sm[m.tp + e] = acc;
    }
    __syncthreads();
    for (int e = tid; e < s2 * br; e += NT) {
      const int p = e / br, j = e % br;
      float hw = a.herfb[li * br + j];
      const float* w = a.herf + static_cast<size_t>(li) * br * br + j;
      for (int i = 0; i < br; ++i) hw = fmaf(sm[m.tp + p * br + i], w[i * br], hw);
      sm[m.hw + (li * s2 + p) * br + j] = hw;
      const size_t r = rowoff(li, p) + j;
      sm[m.v1 + e] = vq::elu(sm[m.tp + e] + a.d2h[r] + s2a) + s3;
      sm[m.vp + e] = a.vhc[r];
    }
    __syncthreads();
    for (int e = tid; e < s2 * br; e += NT) {
      const int p = e / br, o = e % br;
      const size_t r = rowoff(li, p) + o;
      a.vhc[r] = sm[m.v1 + e];  // in place: every read of it is above the barrier
      float b2 = 0.f;
      for (int j1 = 0; j1 < 3; ++j1) {
        const int q = p + j1 - 1;
        if (q < 0 || q >= s2) continue;  // zero fill outside the row
        const float* k0 = a.hwk + (static_cast<size_t>(li * 2 + 0) * 3 + j1) * br * br + o;
        const float* k1 = a.hwk + (static_cast<size_t>(li * 2 + 1) * 3 + j1) * br * br + o;
        for (int i = 0; i < br; ++i) {
          b2 = fmaf(sm[m.vp + q * br + i], k0[i * br], b2);
          b2 = fmaf(sm[m.v1 + q * br + i], k1[i * br], b2);
        }
      }
      const float cn = cond ? a.cnd[r] : 0.f;
      sm[m.w3v1 + e] = vq::elu(b2 + cn + s4) + s5;
    }
    __syncthreads();
    const bool skip = li == 0 && l0_skip;
    for (int e = tid; e < s2 * C; e += NT) {
      const int p = e / C, c = e % C;
      const float* w = a.hw3 + static_cast<size_t>(li) * br * C + c;
      float acc = a.hb3[li * C + c];
      for (int o = 0; o < br; ++o) acc = fmaf(sm[m.w3v1 + p * br + o], w[o * C], acc);
      if (skip) {
        for (int cc = 0; cc < C; ++cc)
          acc = fmaf(sm[m.sp + p * C + cc], a.hskw[static_cast<size_t>(cc) * C + c], acc);
      } else {
        acc += sm[m.h + e];
      }
      sm[m.h + e] = acc;  // h[e] is read and written by this thread only
    }
    __syncthreads();
  }
  // sm[m.h] now holds the height stream's final row

  // ---- phase 2: the voxel chain
  for (int c = tid; c < C; c += NT) sm[m.sv + c] = 0.f;  // no voxel before i2 = 0
  const bool forced = a.forced != nullptr;
  for (int i2 = 0; i2 < s2; ++i2) {
    for (int c = tid; c < C; c += NT) sm[m.w + c] = a.b_in[c];  // the unsampled voxel
    __syncthreads();
    for (int li = 0; li < L; ++li) {
      const float* s = a.sc + li * 8;
      const float s0 = s[0], s1 = s[1], s2a = s[2], s3 = s[3], s4 = s[4], s5 = s[5];
      for (int c = tid; c < C; c += NT) {
        float u = vq::elu((li == 0 ? sm[m.sv + c] : sm[m.w + c]) + s0) + s1;
        if (li == 0 && i2 == 0) u = 0.f;
        sm[m.u + c] = u;
      }
      __syncthreads();
      if (part < nparts) {  // t = u . w1, partial sums over a chunk of C
        const float* w = a.w1 + static_cast<size_t>(li) * C * br + col;
        const int c1 = min(C, (part + 1) * cchunk);
        float acc = 0.f;
        for (int c = part * cchunk; c < c1; ++c)
          acc = fmaf(sm[m.u + c], w[static_cast<size_t>(c) * br], acc);
        sm[m.part + part * br + col] = acc;
      }
      __syncthreads();
      if (tid < br) {
        float t = 0.f;
        for (int pp = 0; pp < nparts; ++pp) t += sm[m.part + pp * br + tid];
        const float x = t + a.d2w[rowoff(li, i2) + tid] + sm[m.hw + (li * s2 + i2) * br + tid];
        sm[m.v + tid] = vq::elu(x + s2a) + s3;
      }
      __syncthreads();
      if (part < nparts) {  // the width taps [cached v, v] . wk, partial sums
        const float* w = a.wk + static_cast<size_t>(li) * 2 * br * br + col;
        const int x1 = min(2 * br, (part + 1) * tchunk);
        float acc = 0.f;
        for (int x = part * tchunk; x < x1; ++x) {
          const float in = x < br ? sm[m.vc + li * br + x] : sm[m.v + x - br];
          acc = fmaf(in, w[static_cast<size_t>(x) * br], acc);
        }
        sm[m.part + part * br + col] = acc;
      }
      __syncthreads();
      if (tid < br) {
        float b2 = 0.f;
        for (int pp = 0; pp < nparts; ++pp) b2 += sm[m.part + pp * br + tid];
        const float cn = cond ? a.cnd[rowoff(li, i2) + tid] : 0.f;
        sm[m.w3v + tid] = vq::elu(b2 + cn + s4) + s5;
        sm[m.vc + li * br + tid] = sm[m.v + tid];  // the next voxel's cached tap
      }
      __syncthreads();
      const bool skip = li == 0 && l0_skip;
      for (int c = tid; c < C; c += NT) {
        const float* w = a.w3 + static_cast<size_t>(li) * br * C + c;
        float acc = a.b3[li * C + c];
        for (int o = 0; o < br; ++o) acc = fmaf(sm[m.w3v + o], w[o * C], acc);
        if (skip) {
          for (int cc = 0; cc < C; ++cc)
            acc = fmaf(sm[m.sv + cc], a.skw[static_cast<size_t>(cc) * C + c], acc);
        } else {
          acc += sm[m.w + c];
        }
        sm[m.w + c] = acc;  // w[c] is read and written by this thread only
      }
      // the next layer's first step reads w[c] on the same thread, and what
      // it writes (u) was last read before the barriers above
    }
    __syncthreads();
    for (int c = tid; c < C; c += NT)
      sm[m.tot + c] = a.dfin[(static_cast<size_t>(b) * s2 + i2) * C + c] + sm[m.h + i2 * C + c] +
                      sm[m.w + c];
    __syncthreads();
    float best = -CUDART_INF_F;
    int bk = K;
    bool bad = false;
    for (int k = tid; k < K; k += NT) {
      float lg = a.b_out[k];
      for (int c = 0; c < C; ++c) lg = fmaf(sm[m.tot + c], a.w_out[static_cast<size_t>(c) * K + k], lg);
      if (forced) {
        a.logits[(static_cast<size_t>(b) * s2 + i2) * K + k] = lg;
      } else {
        bad |= !isfinite(lg);
        const float z = lg / a.tau + a.gum[(static_cast<size_t>(i2) * B + b) * K + k];
        if (z > best) {  // k rises, so the first of equal z stays
          best = z;
          bk = k;
        }
      }
    }
    if (forced) {
      if (tid == 0) idx_s = a.forced[b * s2 + i2];
    } else {
      for (int off = 16; off >= 1; off >>= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best, off);
        const int ok = __shfl_xor_sync(0xffffffffu, bk, off);
        if (ob > best || (ob == best && ok < bk)) {
          best = ob;
          bk = ok;
        }
      }
      if ((tid & 31) == 0) {
        red_v[tid >> 5] = best;
        red_i[tid >> 5] = bk;
      }
    }
    const bool any_bad = __syncthreads_or(bad);
    if (!forced && tid == 0) {
      float bv = red_v[0];
      int bi = red_i[0];
      for (int w = 1; w < NW; ++w) {
        if (red_v[w] > bv || (red_v[w] == bv && red_i[w] < bi)) {
          bv = red_v[w];
          bi = red_i[w];
        }
      }
      idx_s = any_bad ? -1 : bi;
    }
    __syncthreads();
    const int idx = idx_s;
    if (tid == 0) a.out[b * s2 + i2] = idx;
    for (int c = tid; c < C; c += NT)
      sm[m.sv + c] = a.w_in[static_cast<size_t>(max(idx, 0)) * C + c] + a.b_in[c];
    __syncthreads();
  }
}

}  // namespace

// The contract of ops/decode_row.py (the same arguments as vq_row_decode);
// ws must be 2 (the k = 3 width conv), br <= 512, and the row's state must
// fit in shared memory (checked here).
extern "C" int vq_row_decode_wide(const float* w1, const float* wk, const float* w3,
                                  const float* b3, const float* sc, const float* hw1,
                                  const float* herf, const float* herfb, const float* hwk,
                                  const float* hw3, const float* hb3, const float* skw,
                                  const float* hskw, const float* w_in, const float* b_in,
                                  const float* w_out, const float* b_out, const float* d2h,
                                  const float* d2w, const float* cnd, const float* dfin,
                                  const float* sprev, float* vhc, const float* gum,
                                  const int* forced, int* out, float* logits, int L, int B,
                                  int s2, int C, int br, int ws, int K, int i1, float tau,
                                  void* stream) {
  if (L <= 0 || B <= 0 || s2 <= 0 || C <= 0 || br <= 0 || br > NT || ws != 2 || K <= 0 ||
      (forced == nullptr) != (logits == nullptr) || (skw == nullptr) != (hskw == nullptr))
    return cudaErrorInvalidValue;
  const Smem m = smem_layout(L, s2, C, br);
  const size_t bytes = static_cast<size_t>(m.total) * sizeof(float);
  if (bytes > 232448 - 1024) return cudaErrorInvalidValue;  // the static reduce buffers too
  constexpr int kMaxDevices = 64;
  static size_t opted[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (bytes > 48 * 1024 && bytes > opted[dev]) {
    err = cudaFuncSetAttribute(row_decode_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    opted[dev] = bytes;
  }
  RowArgs a{w1, wk, w3, b3, sc, hw1, herf, herfb, hwk, hw3, hb3, skw, hskw,
            w_in, b_in, w_out, b_out, d2h, d2w, cnd, dfin, sprev, vhc, gum, forced,
            out, logits, L, B, s2, C, br, K, i1, tau};
  row_decode_wide_kernel<<<B, NT, bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}
