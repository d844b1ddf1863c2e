// Kernel K6: one row of cached PixelCNN ancestral sampling.
//
// Replaces vqvae3d_tpu/ops/decode_row.py:row_decode (Pallas kernel
// _row_kernel). The contract, weight layouts and plain version are in
// ops/decode_row.py. fp32 throughout, on the CUDA cores.
//
// What bounds it on the H100: not bytes and not operations. At the published
// top config (L = 51 layers, C = 16, br = 4, K = 128, s2 = 32, B = 1) a row
// moves ~0.26 MB (the stacked weights ~0.11 MB, the row's injections and
// caches, the Gumbel table: ~0.08 us at 3.35 TB/s) and does ~1.5 MFLOP
// (~0.02 us at 67 TFLOP/s fp32). The bound that holds is the serial one: the 32 voxels of a
// row go through the 51 layers one after another, and each layer is a chain
// of dependent steps (ELU, a C->br product reduced across lanes in four
// shuffle rounds, ELU, the width taps, ELU, a br->C product), ~350 cycles by
// instruction latencies alone: 32 x 51 x 350 cycles is ~0.3 ms a row at
// 1.98 GHz, ~5 s for the 16,384 rows of a 128x128x32 grid. One warp runs the
// chain, with nothing to hide its latencies behind (chip_smoke.py prints the
// time per row beside both bounds). One row is one launch; B = 1 gives the
// card one block.
//
// Design (one block per batch element, 128+ threads):
//  * staging: the stacked weights, layer 0's skip conv, this row's d2w and
//    condition rows, w_in, w_out and the biases go to shared memory with
//    cp.async: ~188 KB at the top config, under the 227 KB opt-in (the
//    launcher refuses a config that does not fit). Read from device memory
//    inside the chain, every weight would put an L2 round trip on the serial
//    chain of every layer.
//  * the residual: the TPU kernel packs [w3*scale ; skip] into one matrix,
//    with an identity skip for every mask-'B' layer; here a layer adds its
//    input directly, and only layer 0 (mask 'A') runs its skip conv.
//  * ELU is exp(x) - 1 for x <= 0, as the TPU kernel computes it, with the
//    hardware exp2 (see elu below).
//  * phase 1 (the height-row step): thread p owns position p of the row and
//    keeps its C-wide height-stream value in registers. Per layer it computes
//    u, the C->br product, h2w into shared memory (phase 2 reads it), the new
//    v-row; a barrier; then the 2x3 height taps over (cached v-row, this
//    v-row), shifted along s2 with zero fill, read back from shared memory,
//    the condition, and the br->C output with the residual. The v-row caches are
//    updated IN PLACE in device memory: each position's cache is read before
//    the barrier and written after it.
//  * phase 2 (the voxel chain): one warp. Lane c owns channel c of the width
//    stream (C <= 32). Per layer each lane computes its share of the C->br
//    product and an xor-butterfly over the R = pow2 >= C lanes sums it; the
//    butterfly leaves bitwise the same sums in each of those lanes, so each
//    then computes the br-wide steps (ELU, width taps, ELU) itself, with no
//    more exchange, and its own output channel (lanes >= R, in another
//    group, compute sums of nothing; their values are never read). Layer 0's
//    skip conv gathers its input with shuffles. The width taps' caches live
//    in shared memory in two buffers by voxel parity, so one __syncwarp per
//    voxel orders them; lanes >= R write theirs to a scratch slot (were all
//    32 lanes to store to the cache, they would race). Logits: lane l owns
//    codes l, l+32, ...; argmax of logits / tau + gumbel with a warp
//    butterfly, ties to the lowest index. A voxel with a non-finite logit
//    gets index -1, which the sampler reports; the next voxel then reads
//    code 0's embedding. The sampled code's w_in row + b_in is the next
//    voxel's layer-0 input.
#include <cuda_pipeline.h>
#include <math_constants.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

struct RowArgs {
  const float *w1, *wk, *w3, *b3, *sc;
  const float *hw1, *herf, *herfb, *hwk, *hw3, *hb3;
  const float *skw, *hskw;  // layer 0's skip conv, (C, C) each; null without one
  const float *w_in, *b_in, *w_out, *b_out;
  const float *d2h, *d2w, *cnd, *dfin, *sprev;
  float* vhc;
  const float* gum;
  const int* forced;
  int* out;
  float* logits;
  int L, B, s2, C, br, ws, K, i1;
  float tau;
};

// Shared-memory layout, in floats; every region starts on 16 bytes (float4 reads).
struct Smem {
  int hw, d2w, cnd, w1, wk, w3, sc, b3, hw1, herf, herfb, hwk, hw3, hb3, skw, hskw, vc, hfin,
      v, vp, wout, win, bout, bin, junk, total;
};

__host__ __device__ inline Smem smem_layout(int L, int s2, int C, int br, int ws, int K,
                                            bool cond, bool l0_skip) {
  Smem m;
  int o = 0;
  m.hw = o;    o += L * s2 * br; o = (o + 3) & ~3;
  m.d2w = o;   o += L * s2 * br; o = (o + 3) & ~3;
  m.cnd = o;   o += cond ? L * s2 * br : 0; o = (o + 3) & ~3;
  m.w1 = o;    o += L * C * br; o = (o + 3) & ~3;
  m.wk = o;    o += L * ws * br * br; o = (o + 3) & ~3;
  m.w3 = o;    o += L * br * C; o = (o + 3) & ~3;
  m.sc = o;    o += L * 8; o = (o + 3) & ~3;
  m.b3 = o;    o += L * C; o = (o + 3) & ~3;
  m.hw1 = o;   o += L * C * br; o = (o + 3) & ~3;
  m.herf = o;  o += L * br * br; o = (o + 3) & ~3;
  m.herfb = o; o += L * br; o = (o + 3) & ~3;
  m.hwk = o;   o += L * 6 * br * br; o = (o + 3) & ~3;
  m.hw3 = o;   o += L * br * C; o = (o + 3) & ~3;
  m.hb3 = o;   o += L * C; o = (o + 3) & ~3;
  m.skw = o;   o += l0_skip ? C * C : 0; o = (o + 3) & ~3;
  m.hskw = o;  o += l0_skip ? C * C : 0; o = (o + 3) & ~3;
  m.vc = o;    o += 2 * L * (ws - 1) * br; o = (o + 3) & ~3;  // two buffers, by voxel parity
  m.hfin = o;  o += s2 * C; o = (o + 3) & ~3;
  m.v = o;     o += s2 * br; o = (o + 3) & ~3;
  m.vp = o;    o += s2 * br; o = (o + 3) & ~3;
  m.wout = o;  o += C * K; o = (o + 3) & ~3;
  m.win = o;   o += K * C; o = (o + 3) & ~3;
  m.bout = o;  o += K; o = (o + 3) & ~3;
  m.bin = o;   o += C; o = (o + 3) & ~3;
  m.junk = o;  o += 8;
  m.total = o;
  return m;
}

__device__ __forceinline__ void cp4(float* dst, const float* src) {
  __pipeline_memcpy_async(dst, src, sizeof(float));
}

__device__ __forceinline__ void stage(float* dst, const float* src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) cp4(dst + i, src + i);
}

// ELU as the TPU kernel computes it (vqvae3d_tpu/ops/fused_block.py:_elu):
// exp(x) - 1 for x <= 0, with the hardware exp2 (__expf: a multiply and
// MUFU.EX2, relative error ~2^-21). Three ELUs sit on each layer's chain,
// and expm1f or expf would add their range handling to it.
__device__ __forceinline__ float elu(float x) { return x > 0.f ? x : __expf(x) - 1.f; }

template <int MAXC, int MAXBR, int MAXKM, bool EXACT>
__global__ void __launch_bounds__(256) row_decode_kernel(RowArgs a) {
  extern __shared__ float sm[];
  const int L = a.L, B = a.B, s2 = a.s2;
  const int C = EXACT ? MAXC : a.C, br = EXACT ? MAXBR : a.br, K = EXACT ? 32 * MAXKM : a.K;
  constexpr int ws = 2;  // the k = 3 width conv of a mask-'B' branch
  const bool cond = a.cnd != nullptr, l0_skip = a.skw != nullptr;
  const Smem m = smem_layout(L, s2, C, br, ws, K, cond, l0_skip);
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;

  // ---- staging: weights and this row's d2w / condition rows, asynchronously
  const int row = s2 * br;
  for (int i = tid; i < L * row; i += nt) {
    const int li = i / row;
    const int off = (li * B + b) * row + (i - li * row);
    cp4(sm + m.d2w + i, a.d2w + off);
    if (cond) cp4(sm + m.cnd + i, a.cnd + off);
  }
  stage(sm + m.w1, a.w1, L * C * br);
  stage(sm + m.wk, a.wk, L * ws * br * br);
  stage(sm + m.w3, a.w3, L * br * C);
  stage(sm + m.sc, a.sc, L * 8);
  stage(sm + m.b3, a.b3, L * C);
  stage(sm + m.hw1, a.hw1, L * C * br);
  stage(sm + m.herf, a.herf, L * br * br);
  stage(sm + m.herfb, a.herfb, L * br);
  stage(sm + m.hwk, a.hwk, L * 6 * br * br);
  stage(sm + m.hw3, a.hw3, L * br * C);
  stage(sm + m.hb3, a.hb3, L * C);
  if (l0_skip) {
    stage(sm + m.skw, a.skw, C * C);
    stage(sm + m.hskw, a.hskw, C * C);
  }
  stage(sm + m.wout, a.w_out, C * K);
  stage(sm + m.win, a.w_in, K * C);
  stage(sm + m.bout, a.b_out, K);
  stage(sm + m.bin, a.b_in, C);
  for (int i = tid; i < 2 * L * br; i += nt) sm[m.vc + i] = 0.f;
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  // ---- phase 1: the height-row step, thread p = position p of the row
  const bool act = tid < s2;
  const int p = tid;
  float h[MAXC], sp[MAXC];
#pragma unroll
  for (int c = 0; c < MAXC; ++c) {
    h[c] = (act && c < C) ? sm[m.bin + c] : 0.f;
    sp[c] = (act && c < C) ? a.sprev[(b * s2 + p) * C + c] : 0.f;
  }
  for (int li = 0; li < L; ++li) {
    const float* scl = sm + m.sc + li * 8;
    const size_t cache = (static_cast<size_t>(li * B + b) * s2 + p) * br;
    float v[MAXBR];
    if (act) {
      float tp[MAXBR];
#pragma unroll
      for (int j = 0; j < MAXBR; ++j) tp[j] = 0.f;
      const float* hw1 = sm + m.hw1 + li * C * br;
#pragma unroll
      for (int c = 0; c < MAXC; ++c) {
        if (c < C) {
          float u = elu((li == 0 ? sp[c] : h[c]) + scl[0]) + scl[1];
          if (li == 0 && a.i1 == 0) u = 0.f;
#pragma unroll
          for (int j = 0; j < MAXBR; ++j)
            if (j < br) tp[j] = fmaf(u, hw1[c * br + j], tp[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < MAXBR; ++j) {
        if (j < br) {
          float hw = sm[m.herfb + li * br + j];
#pragma unroll
          for (int i = 0; i < MAXBR; ++i)
            if (i < br) hw = fmaf(tp[i], sm[m.herf + (li * br + i) * br + j], hw);
          sm[m.hw + (li * s2 + p) * br + j] = hw;
          v[j] = elu(tp[j] + a.d2h[cache + j] + scl[2]) + scl[3];
          sm[m.v + p * br + j] = v[j];
          sm[m.vp + p * br + j] = a.vhc[cache + j];
        }
      }
    }
    __syncthreads();
    if (act) {
      float b2[MAXBR];
#pragma unroll
      for (int j = 0; j < MAXBR; ++j) {
        b2[j] = 0.f;
        if (j < br) a.vhc[cache + j] = v[j];  // in place: every read of it is above the barrier
      }
#pragma unroll
      for (int j1 = 0; j1 < 3; ++j1) {
        const int q = p + j1 - 1;
        const bool in = q >= 0 && q < s2;  // zero fill outside the row
        const float* k0 = sm + m.hwk + ((li * 2 + 0) * 3 + j1) * br * br;
        const float* k1 = sm + m.hwk + ((li * 2 + 1) * 3 + j1) * br * br;
#pragma unroll
        for (int i = 0; i < MAXBR; ++i) {
          if (i < br) {
            const float vp = in ? sm[m.vp + q * br + i] : 0.f;
            const float vv = in ? sm[m.v + q * br + i] : 0.f;
#pragma unroll
            for (int o = 0; o < MAXBR; ++o) {
              if (o < br) {
                b2[o] = fmaf(vp, k0[i * br + o], b2[o]);
                b2[o] = fmaf(vv, k1[i * br + o], b2[o]);
              }
            }
          }
        }
      }
      float w3v[MAXBR];
#pragma unroll
      for (int o = 0; o < MAXBR; ++o) {
        const float c2 = (cond && o < br) ? sm[m.cnd + (li * s2 + p) * br + o] : 0.f;
        w3v[o] = o < br ? elu(b2[o] + c2 + scl[4]) + scl[5] : 0.f;
      }
      const float* w3 = sm + m.hw3 + li * br * C;
      const bool skip = li == 0 && l0_skip;  // layer 0's skip conv of the row above
      float hn[MAXC];
#pragma unroll
      for (int c = 0; c < MAXC; ++c) {
        if (c < C) {
          float acc = sm[m.hb3 + li * C + c];
#pragma unroll
          for (int o = 0; o < MAXBR; ++o)
            if (o < br) acc = fmaf(w3v[o], w3[o * C + c], acc);
          if (skip) {
#pragma unroll
            for (int cc = 0; cc < MAXC; ++cc)
              if (cc < C) acc = fmaf(sp[cc], sm[m.hskw + cc * C + c], acc);
          } else {
            acc += h[c];
          }
          hn[c] = acc;
        } else {
          hn[c] = 0.f;
        }
      }
#pragma unroll
      for (int c = 0; c < MAXC; ++c) h[c] = hn[c];
    }
    __syncthreads();
  }
  if (act) {
#pragma unroll
    for (int c = 0; c < MAXC; ++c)
      if (c < C) sm[m.hfin + p * C + c] = h[c];
  }
  __syncthreads();

  // ---- phase 2: the voxel chain, one warp, lane c = channel c
  if (tid >= 32) return;
  const int lane = tid;
  const bool cv = lane < C;
  const int cl = cv ? lane : 0;
  const int R = EXACT ? MAXC : (C <= 1 ? 1 : 1 << (32 - __clz(C - 1)));  // pow2 >= C
  const int km = (K + 31) / 32;
  const float bin_c = cv ? sm[m.bin + lane] : 0.f;
  const bool forced = a.forced != nullptr;
  const int nslot = L * br;  // width tap cache: one slot (ws = 2) per layer

  // One layer's operands of one voxel, in registers: a layer's loads go out
  // together, as float4 reads when the widths are EXACT. (Loading the next
  // layer's during this one's chain would make the loop body larger: with
  // one warp, instruction fetch sits on the chain too.)
  struct Layer {
    float s[8], w1[MAXBR], wk[2][MAXBR][MAXBR], w3[MAXBR], b3, d2w[MAXBR], hw[MAXBR],
        cn[MAXBR], vc[MAXBR];
  };
  auto ld4 = [](float* d, const float* src) {  // src 16-byte aligned
    const float4 q = *reinterpret_cast<const float4*>(src);
    d[0] = q.x, d[1] = q.y, d[2] = q.z, d[3] = q.w;
  };
  auto load = [&](int li, int i2, const float* vc_rd, Layer& w) {
    const int r = (li * s2 + i2) * br;
    if constexpr (EXACT && MAXBR == 4) {
      ld4(w.s, sm + m.sc + li * 8);
      ld4(w.s + 4, sm + m.sc + li * 8 + 4);
      ld4(w.w1, sm + m.w1 + (li * C + cl) * 4);
      ld4(w.d2w, sm + m.d2w + r);
      ld4(w.hw, sm + m.hw + r);
      if (cond) ld4(w.cn, sm + m.cnd + r);
      else w.cn[0] = w.cn[1] = w.cn[2] = w.cn[3] = 0.f;
      ld4(w.vc, vc_rd + li * 4);
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int i = 0; i < 4; ++i) ld4(w.wk[t][i], sm + m.wk + ((li * 2 + t) * 4 + i) * 4);
#pragma unroll
      for (int i = 0; i < 4; ++i) w.w3[i] = sm[m.w3 + (li * 4 + i) * C + cl];
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) w.s[k] = sm[m.sc + li * 8 + k];
#pragma unroll
      for (int i = 0; i < MAXBR; ++i) {
        const bool ok = i < br;
        w.w1[i] = ok ? sm[m.w1 + (li * C + cl) * br + i] : 0.f;
        w.w3[i] = ok ? sm[m.w3 + (li * br + i) * C + cl] : 0.f;
        w.d2w[i] = ok ? sm[m.d2w + r + i] : 0.f;
        w.hw[i] = ok ? sm[m.hw + r + i] : 0.f;
        w.cn[i] = (ok && cond) ? sm[m.cnd + r + i] : 0.f;
        w.vc[i] = ok ? vc_rd[li * br + i] : 0.f;
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int o = 0; o < MAXBR; ++o)
            w.wk[t][i][o] = (ok && o < br) ? sm[m.wk + ((li * 2 + t) * br + i) * br + o] : 0.f;
      }
    }
    w.b3 = sm[m.b3 + li * C + cl];
  };

  float sprev_c = 0.f;  // parse_input of the voxel before i2; zero at i2 = 0
  for (int i2 = 0; i2 < s2; ++i2) {
    // loads this voxel needs only after its chain: started now, used at the end
    float g[MAXKM];
#pragma unroll
    for (int mm = 0; mm < MAXKM; ++mm) {
      const int k = lane + 32 * mm;
      g[mm] = (!forced && mm < km && k < K) ? __ldg(a.gum + (i2 * B + b) * K + k) : 0.f;
    }
    const float dfin_c = cv ? __ldg(a.dfin + (b * s2 + i2) * C + lane) : 0.f;
    // width tap caches: voxel i2 reads buffer i2 % 2 and writes the other one
    const float* vc_rd = sm + m.vc + (i2 & 1) * nslot;
    float* vc_wr = sm + m.vc + ((i2 + 1) & 1) * nslot;

    float w_c = bin_c;  // parse_input of the unsampled voxel
    // layer 0 (mask 'A': its input is the voxel before, its skip conv) is
    // peeled off the loop, so the 50 mask-'B' layers' body holds none of it
    auto step = [&](int li, const Layer& cur, auto first) {
      constexpr bool kFirst = decltype(first)::value;
      float u = elu((kFirst ? sprev_c : w_c) + cur.s[0]) + cur.s[1];
      if ((kFirst && i2 == 0) || !cv) u = 0.f;
      float t[MAXBR];
#pragma unroll
      for (int j = 0; j < MAXBR; ++j) t[j] = u * cur.w1[j];
#pragma unroll
      for (int off = R >> 1; off >= 1; off >>= 1) {
#pragma unroll
        for (int j = 0; j < MAXBR; ++j) t[j] += __shfl_xor_sync(kFull, t[j], off);
      }
      float v[MAXBR], b2[MAXBR];
#pragma unroll
      for (int j = 0; j < MAXBR; ++j) {
        v[j] = j < br ? elu(t[j] + cur.d2w[j] + cur.hw[j] + cur.s[2]) + cur.s[3] : 0.f;
        b2[j] = 0.f;
      }
      // taps [cached v of the previous voxel, v]
#pragma unroll
      for (int i = 0; i < MAXBR; ++i) {
#pragma unroll
        for (int o = 0; o < MAXBR; ++o) {
          b2[o] = fmaf(cur.vc[i], cur.wk[0][i][o], b2[o]);
          b2[o] = fmaf(v[i], cur.wk[1][i][o], b2[o]);
        }
      }
      // lanes < R hold the same v; lanes >= R summed another group of lanes
      // and write theirs to a scratch slot (a select, not a branch)
      float* dst = lane < R ? vc_wr + li * br : sm + m.junk;
#pragma unroll
      for (int i = 0; i < MAXBR; ++i)
        if (i < br) dst[i] = v[i];
      float out = cur.b3;
#pragma unroll
      for (int o = 0; o < MAXBR; ++o) {
        const float w3v = elu(b2[o] + cur.cn[o] + cur.s[4]) + cur.s[5];
        if (o < br) out = fmaf(w3v, cur.w3[o], out);
      }
      float sk = w_c;  // the residual
      if constexpr (kFirst) {
        if (l0_skip) {  // layer 0's skip conv of the voxel before
          sk = 0.f;
          for (int cc = 0; cc < C; ++cc)
            sk = fmaf(__shfl_sync(kFull, sprev_c, cc), sm[m.skw + cc * C + cl], sk);
        }
      }
      w_c = cv ? out + sk : 0.f;
    };
    {
      Layer cur;
      load(0, i2, vc_rd, cur);
      step(0, cur, std::true_type{});
    }
    for (int li = 1; li < L; ++li) {
      Layer cur;
      load(li, i2, vc_rd, cur);
      step(li, cur, std::false_type{});
    }

    const float total = cv ? dfin_c + sm[m.hfin + i2 * C + lane] + w_c : 0.f;
    float lg[MAXKM];
#pragma unroll
    for (int mm = 0; mm < MAXKM; ++mm) {
      const int k = lane + 32 * mm;
      lg[mm] = (mm < km && k < K) ? sm[m.bout + k] : 0.f;
    }
    for (int cc = 0; cc < C; ++cc) {
      const float x = __shfl_sync(kFull, total, cc);
#pragma unroll
      for (int mm = 0; mm < MAXKM; ++mm) {
        const int k = lane + 32 * mm;
        if (mm < km && k < K) lg[mm] = fmaf(x, sm[m.wout + cc * K + k], lg[mm]);
      }
    }
    int idx;
    if (forced) {
#pragma unroll
      for (int mm = 0; mm < MAXKM; ++mm) {
        const int k = lane + 32 * mm;
        if (mm < km && k < K) a.logits[(b * s2 + i2) * K + k] = lg[mm];
      }
      idx = a.forced[b * s2 + i2];
    } else {
      float best = -CUDART_INF_F;
      int bk = K;
#pragma unroll
      for (int mm = 0; mm < MAXKM; ++mm) {
        const int k = lane + 32 * mm;
        if (mm < km && k < K) {
          const float z = lg[mm] / a.tau + g[mm];
          if (z > best) {
            best = z;
            bk = k;
          }
        }
      }
      for (int off = 16; off >= 1; off >>= 1) {
        const float ob = __shfl_xor_sync(kFull, best, off);
        const int ok = __shfl_xor_sync(kFull, bk, off);
        if (ob > best || (ob == best && ok < bk)) {
          best = ob;
          bk = ok;
        }
      }
      bool bad = false;
#pragma unroll
      for (int mm = 0; mm < MAXKM; ++mm)
        bad |= mm < km && lane + 32 * mm < K && !isfinite(lg[mm]);
      idx = __any_sync(kFull, bad) ? -1 : bk;
    }
    if (lane == 0) a.out[b * s2 + i2] = idx;
    sprev_c = cv ? sm[m.win + max(idx, 0) * C + lane] + bin_c : 0.f;
    // this voxel's tap writes are visible to the next voxel's reads, and its
    // reads are done before the next voxel writes the other buffer
    __syncwarp();
  }
}

template <int MAXC, int MAXBR, int MAXKM, bool EXACT>
cudaError_t launch(const RowArgs& a, cudaStream_t stream) {
  const Smem m = smem_layout(a.L, a.s2, a.C, a.br, a.ws, a.K, a.cnd != nullptr,
                             a.skw != nullptr);
  const size_t bytes = static_cast<size_t>(m.total) * sizeof(float);
  if (bytes > 232448) return cudaErrorInvalidValue;
  // the opt-in above 48 KB is a per-device attribute of the function
  constexpr int kMaxDevices = 64;
  static size_t opted[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (bytes > 48 * 1024 && bytes > opted[dev]) {
    err = cudaFuncSetAttribute(row_decode_kernel<MAXC, MAXBR, MAXKM, EXACT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    opted[dev] = bytes;
  }
  const int threads = a.s2 <= 128 ? 128 : ((a.s2 + 31) / 32) * 32;
  row_decode_kernel<MAXC, MAXBR, MAXKM, EXACT><<<a.B, threads, bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// The contract of ops/decode_row.py; every tensor fp32 (forced and out
// int32) and contiguous; cnd, skw and hskw (together), forced and logits may
// be null.
extern "C" int vq_row_decode(const float* w1, const float* wk, const float* w3,
                             const float* b3, const float* sc, const float* hw1,
                             const float* herf, const float* herfb, const float* hwk,
                             const float* hw3, const float* hb3, const float* skw,
                             const float* hskw, const float* w_in, const float* b_in,
                             const float* w_out,
                             const float* b_out, const float* d2h, const float* d2w,
                             const float* cnd, const float* dfin, const float* sprev,
                             float* vhc, const float* gum, const int* forced, int* out,
                             float* logits, int L, int B, int s2, int C, int br, int ws, int K,
                             int i1, float tau, void* stream) {
  if (L <= 0 || B <= 0 || s2 <= 0 || s2 > 256 || C <= 0 || C > 32 || br <= 0 || br > 8 ||
      ws != 2 || K <= 0 || K > 512 || (forced == nullptr) != (logits == nullptr) ||
      (skw == nullptr) != (hskw == nullptr))
    return cudaErrorInvalidValue;
  RowArgs a{w1, wk, w3, b3, sc, hw1, herf, herfb, hwk, hw3, hb3, skw, hskw,
            w_in, b_in, w_out, b_out, d2h, d2w, cnd, dfin, sprev, vhc, gum, forced,
            out, logits, L, B, s2, C, br, ws, K, i1, tau};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the published top config's widths exactly, and every other width
  if (C == 16 && br == 4 && K == 128) return launch<16, 4, 4, true>(a, s);
  return launch<32, 8, 16, false>(a, s);
}
