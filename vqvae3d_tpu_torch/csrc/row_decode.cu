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
// (~0.02 us at 67 TFLOP/s fp32). The bound that holds is the serial one: the
// 32 voxels of a row go through the 51 layers one after another, and each
// layer is a chain of dependent steps (ELU, a C->br product reduced across
// lanes, ELU, the width taps, ELU, a br->C product). One warp runs the chain,
// with nothing to hide its latencies behind; chip_smoke.py prints the time
// per row beside the bytes bound and the chain's cycles per layer-step, read
// by clock64() (the ``cycles`` argument). One row is one launch; B = 1 gives
// the card one block.
//
// Design (one block per batch element, 128+ threads):
//  * staging: the stacked weights, layer 0's skip conv, this row's d2w and
//    condition rows, w_in, w_out and the biases go to shared memory with
//    cp.async, 16 bytes a copy where the sizes allow: ~180 KB at the top config, under the 227 KB opt-in (the
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
//    u, the C->br product and h2w, the new v-row; a barrier; then the 2x3
//    height taps over (cached v-row, this v-row), shifted along s2 with zero
//    fill, read back from shared memory, the condition, and the br->C output
//    with the residual. The v-row caches are updated IN PLACE in device
//    memory: each position's cache is read before the barrier and written
//    after it. Phase 1 also leaves, for every (layer, voxel), the two addends
//    of the voxel chain that do not depend on the voxel before:
//    pre2 = d2w + h2w + s[2] (in place of d2w) and pre4 = cond + s[4] (in
//    place of the condition).
//  * phase 2 (the voxel chain): one warp, in groups of NL = MAXC / 2 lanes (8
//    at the published C = 16, else 16); lane q of a group owns channels 2q and
//    2q + 1 of the width stream. Per layer a lane computes its share of the
//    C->br product over its channels and an xor butterfly over the group's
//    lanes (3 or 4 rounds) sums it, bitwise the same in every lane of the
//    group; each lane then computes the br-wide steps (ELU, width taps, ELU)
//    itself and its own 2 output channels. The groups compute the same
//    values; lane 0 stores. Off the chain: the residual starts the
//    output's sum; the width taps' cached half, vc . wk[0], is computed by the
//    voxel before and stored in place of vc (two buffers by voxel parity, so
//    one __syncwarp per voxel orders them); each ELU's constants (see
//    elu_shift). Layer 0's skip conv reads the sampled embedding from shared
//    memory. Logits: the final channels go through shared memory, lane l owns
//    codes 4l .. 4l + 3 at the published widths, else l, l+32, ...; argmax of
//    logits / tau + gumbel with a warp butterfly, ties to the lowest index. A voxel with a non-finite logit gets index -1, which the
//    sampler reports; the next voxel then reads code 0's embedding. The
//    sampled code's w_in row + b_in is the next voxel's layer-0 input.
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
  long long* cycles;  // null, or (B, 4): phase 2, its layer loops, staging + phase 1, staging
  int L, B, s2, C, br, ws, K, i1;
  float tau;
};

// Shared-memory layout, in floats; every region starts on 16 bytes (float4 reads).
struct Smem {
  int pre2, pre4, w1, wk, w3, sc, b3, hw1, herf, herfb, hwk, hw3, hb3, skw, hskw, part, hfin,
      v, vp, wout, win, bout, bin, emb, tot, total;
};

__host__ __device__ inline Smem smem_layout(int L, int s2, int C, int br, int ws, int K,
                                            bool l0_skip) {
  Smem m;
  int o = 0;
  m.pre2 = o;  o += L * s2 * br; o = (o + 3) & ~3;  // d2w until phase 1 rewrites it
  m.pre4 = o;  o += L * s2 * br; o = (o + 3) & ~3;  // the condition until phase 1 rewrites it
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
  m.part = o;  o += 2 * L * ((br + 3) & ~3); o = (o + 3) & ~3;  // vc . wk[0], two buffers
  m.hfin = o;  o += s2 * C; o = (o + 3) & ~3;
  m.v = o;     o += s2 * br; o = (o + 3) & ~3;
  m.vp = o;    o += s2 * br; o = (o + 3) & ~3;
  m.wout = o;  o += C * K; o = (o + 3) & ~3;
  m.win = o;   o += K * C; o = (o + 3) & ~3;
  m.bout = o;  o += K; o = (o + 3) & ~3;
  m.bin = o;   o += C; o = (o + 3) & ~3;
  m.emb = o;   o += C; o = (o + 3) & ~3;  // the sampled code's embedding (layer 0's skip conv)
  m.tot = o;   o += C; o = (o + 3) & ~3;  // the final channels of a voxel (its logits)
  m.total = o;
  return m;
}

__device__ __forceinline__ void cp4(float* dst, const float* src) {
  __pipeline_memcpy_async(dst, src, sizeof(float));
}

// n floats device -> shared: 16 bytes a copy where both ends and n allow it, else 4
__device__ __forceinline__ void stage(float* dst, const float* src, int n) {
  if ((((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) & 15) | (n & 3)) == 0) {
    for (int i = 4 * threadIdx.x; i < n; i += 4 * blockDim.x)
      __pipeline_memcpy_async(dst + i, src + i, 16);
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) cp4(dst + i, src + i);
  }
}

// ELU as the TPU kernel computes it (vqvae3d_tpu/ops/fused_block.py:_elu,
// exp(x) - 1 for x <= 0), with the hardware exp2, in the form both phases'
// chains take: elu(a + c) + s with its operands split so the chain runs one
// FFMA, MUFU.EX2 (ex2.approx.ftz, relative error ~2^-22) and an FADD, then a
// select: for a + c > 0 it is a + (c + s), else exp2(a log2(e) + c log2(e)) +
// (s - 1). The constants come off the chain (``shift``). The same function
// as elu(a + c) + s in fp32 up to the rounding of the exponent's argument;
// __expf would add a range check and two multiplies to the chain, expm1f or
// expf their range handling.
struct Shift {
  float neg_c, c_s, c_l2e, s_m1;
};

__device__ __forceinline__ Shift shift(float c, float s) {
  return {-c, c + s, c * 1.4426950408889634f, s - 1.f};
}

__device__ __forceinline__ float elu_shift(float a, const Shift& k) {
  float e;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(e) : "f"(fmaf(a, 1.4426950408889634f, k.c_l2e)));
  return a > k.neg_c ? a + k.c_s : e + k.s_m1;
}

// lanes a group of the voxel chain, 2 channels a lane (at the top config 8
// lanes of 2 channels ran faster than 4 of 4, whose four ELUs a lane queue on
// MUFU; the generic widths (MAXC = 32) take 16 lanes, which spill fewer
// registers than 8 of 4)
template <int MAXC>
__host__ __device__ constexpr int group_lanes() {
  return MAXC / 2;
}

template <int MAXC, int MAXBR, int MAXKM, bool EXACT>
__global__ void __launch_bounds__(256) row_decode_kernel(RowArgs a) {
  extern __shared__ __align__(16) float sm[];
  // clock64() is read only when the caller asks for the cycles
  const bool probe = a.cycles != nullptr;
  const long long t_start = probe ? clock64() : 0;
  const int L = a.L, B = a.B, s2 = a.s2;
  const int C = EXACT ? MAXC : a.C, br = EXACT ? MAXBR : a.br, K = EXACT ? 32 * MAXKM : a.K;
  constexpr int ws = 2;  // the k = 3 width conv of a mask-'B' branch
  const bool cond = a.cnd != nullptr, l0_skip = a.skw != nullptr;
  const Smem m = smem_layout(L, s2, C, br, ws, K, l0_skip);
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int bs = (br + 3) & ~3;  // a layer's slot in the part buffers

  // ---- staging: weights and this row's d2w / condition rows, asynchronously
  const int row = s2 * br;
  for (int li = 0; li < L; ++li) {
    stage(sm + m.pre2 + li * row, a.d2w + static_cast<size_t>(li * B + b) * row, row);
    if (cond) stage(sm + m.pre4 + li * row, a.cnd + static_cast<size_t>(li * B + b) * row, row);
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
  for (int i = tid; i < 2 * L * bs; i += nt) sm[m.part + i] = 0.f;
  for (int i = tid; i < C; i += nt) sm[m.emb + i] = 0.f;
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  const long long t_staged = probe ? clock64() : 0;

  // ---- phase 1: the height-row step, thread p = position p of the row
  const bool act = tid < s2;
  const int p = tid;
  float h[MAXC], sp[MAXC];
#pragma unroll
  for (int c = 0; c < MAXC; ++c) {
    h[c] = (act && c < C) ? sm[m.bin + c] : 0.f;
    sp[c] = (act && c < C) ? a.sprev[(b * s2 + p) * C + c] : 0.f;
  }
  // this position's d2h and cached v-row of the next layer, loaded a layer ahead
  float nd2h[MAXBR], nvhc[MAXBR];
  auto fetch = [&](int li) {
    const size_t cache = (static_cast<size_t>(li * B + b) * s2 + p) * br;
#pragma unroll
    for (int j = 0; j < MAXBR; ++j) {
      nd2h[j] = (act && j < br) ? a.d2h[cache + j] : 0.f;
      nvhc[j] = (act && j < br) ? a.vhc[cache + j] : 0.f;
    }
  };
  fetch(0);
  for (int li = 0; li < L; ++li) {
    const float* scl = sm + m.sc + li * 8;
    const size_t cache = (static_cast<size_t>(li * B + b) * s2 + p) * br;
    float d2h[MAXBR], vhc[MAXBR];
#pragma unroll
    for (int j = 0; j < MAXBR; ++j) d2h[j] = nd2h[j], vhc[j] = nvhc[j];
    if (li + 1 < L) fetch(li + 1);  // another address than this layer's in-place write
    const int pos = (li * s2 + p) * br;  // this position's pre2 / pre4 of layer li
    float v[MAXBR];
    if (act) {
      float tp[MAXBR];
#pragma unroll
      for (int j = 0; j < MAXBR; ++j) tp[j] = 0.f;
      const float* hw1 = sm + m.hw1 + li * C * br;
      const Shift su = shift(scl[0], scl[1]);
#pragma unroll
      for (int c = 0; c < MAXC; ++c) {
        if (c < C) {
          float u = elu_shift(li == 0 ? sp[c] : h[c], su);
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
          sm[m.pre2 + pos + j] = sm[m.pre2 + pos + j] + hw + scl[2];  // d2w + h2w + s[2]
          v[j] = elu_shift(tp[j], shift(d2h[j] + scl[2], scl[3]));
          sm[m.v + p * br + j] = v[j];
          sm[m.vp + p * br + j] = vhc[j];
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
        const float c2 = (cond && o < br) ? sm[m.pre4 + pos + o] : 0.f;
        w3v[o] = o < br ? elu_shift(b2[o], shift(c2 + scl[4], scl[5])) : 0.f;
        if (o < br) sm[m.pre4 + pos + o] = c2 + scl[4];  // cond + s[4]
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

  // ---- phase 2: the voxel chain, one warp in groups of NL lanes
  if (tid >= 32) return;
  const long long t_chain = probe ? clock64() : 0;
  long long in_layers = 0;
  constexpr int NL = group_lanes<MAXC>(), CPL = MAXC / NL;
  static_assert(MAXC % NL == 0 && (NL & (NL - 1)) == 0, "lanes a group: a power of 2 dividing MAXC");
  const int lane = tid, c0 = (lane % NL) * CPL;  // this lane's channels c0 .. c0 + CPL - 1
  const int km = (K + 31) / 32;
  const bool forced = a.forced != nullptr;
  // the codes of lane l: 4 l .. 4 l + 3 at the published widths (one float4
  // of a w_out row), else l, l + 32, ...; either way in increasing order
  auto code = [&](int mm) { return EXACT ? 4 * lane + mm : lane + 32 * mm; };
  float bin[CPL];
#pragma unroll
  for (int i = 0; i < CPL; ++i) bin[i] = c0 + i < C ? sm[m.bin + c0 + i] : 0.f;

  // One layer's operands of one voxel, in registers (vector reads at the
  // published widths). Loaded one layer ahead of their use, the top row ran
  // slower (more registers live across the layer).
  struct Layer {
    float s[8], w1[CPL][MAXBR], wk[2][MAXBR][MAXBR], w3[MAXBR][CPL], b3[CPL], pre2[MAXBR],
        pre4[MAXBR], part[MAXBR];
  };
  auto ld4 = [](float* d, const float* src) {  // src 16-byte aligned
    const float4 q = *reinterpret_cast<const float4*>(src);
    d[0] = q.x, d[1] = q.y, d[2] = q.z, d[3] = q.w;
  };
  auto ld2 = [](float* d, const float* src) {  // src 8-byte aligned
    const float2 q = *reinterpret_cast<const float2*>(src);
    d[0] = q.x, d[1] = q.y;
  };
  auto load = [&](int li, int i2, const float* part_rd, Layer& w) {
    const int r = (li * s2 + i2) * br;
    if constexpr (EXACT && MAXBR == 4 && CPL == 2) {
      ld4(w.s, sm + m.sc + li * 8);
      ld4(w.s + 4, sm + m.sc + li * 8 + 4);
#pragma unroll
      for (int i = 0; i < CPL; ++i) ld4(w.w1[i], sm + m.w1 + (li * C + c0 + i) * 4);
      ld4(w.pre2, sm + m.pre2 + r);
      ld4(w.pre4, sm + m.pre4 + r);
      ld4(w.part, part_rd + li * 4);
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int i = 0; i < 4; ++i) ld4(w.wk[t][i], sm + m.wk + ((li * 2 + t) * 4 + i) * 4);
#pragma unroll
      for (int o = 0; o < 4; ++o) ld2(w.w3[o], sm + m.w3 + (li * 4 + o) * C + c0);
      ld2(w.b3, sm + m.b3 + li * C + c0);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) w.s[k] = sm[m.sc + li * 8 + k];
#pragma unroll
      for (int i = 0; i < MAXBR; ++i) {
        const bool ok = i < br;
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          const bool cok = ok && c0 + c < C;
          w.w1[c][i] = cok ? sm[m.w1 + (li * C + c0 + c) * br + i] : 0.f;
          w.w3[i][c] = cok ? sm[m.w3 + (li * br + i) * C + c0 + c] : 0.f;
        }
        w.pre2[i] = ok ? sm[m.pre2 + r + i] : 0.f;
        w.pre4[i] = ok ? sm[m.pre4 + r + i] : 0.f;
        w.part[i] = ok ? part_rd[li * bs + i] : 0.f;
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int o = 0; o < MAXBR; ++o)
            w.wk[t][i][o] = (ok && o < br) ? sm[m.wk + ((li * 2 + t) * br + i) * br + o] : 0.f;
      }
#pragma unroll
      for (int c = 0; c < CPL; ++c) w.b3[c] = c0 + c < C ? sm[m.b3 + li * C + c0 + c] : 0.f;
    }
  };

  float sprev[CPL];  // parse_input of the voxel before i2; zero at i2 = 0
#pragma unroll
  for (int i = 0; i < CPL; ++i) sprev[i] = 0.f;
  for (int i2 = 0; i2 < s2; ++i2) {
    // loads this voxel needs only after its chain: started now, used at the end
    float g[MAXKM];
#pragma unroll
    for (int mm = 0; mm < MAXKM; ++mm) {
      const int k = code(mm);
      g[mm] = (!forced && mm < km && k < K) ? __ldg(a.gum + (i2 * B + b) * K + k) : 0.f;
    }
    // the part buffers: voxel i2 reads buffer i2 % 2 and writes the other one
    const float* part_rd = sm + m.part + (i2 & 1) * L * bs;
    float* part_wr = sm + m.part + ((i2 + 1) & 1) * L * bs;

    float w[CPL];  // parse_input of the unsampled voxel
#pragma unroll
    for (int i = 0; i < CPL; ++i) w[i] = bin[i];
    // one layer: layer 0 (mask 'A': its input is the voxel before, its skip
    // conv) is peeled off the loop, so the 50 mask-'B' layers' body holds none of it
    auto step = [&](int li, const Layer& cur, auto first) {
      constexpr bool kFirst = decltype(first)::value;
      // the residual: this layer's output accumulates onto its input (layer
      // 0: onto its skip conv of the voxel before), started off the chain
      float out[CPL];
#pragma unroll
      for (int c = 0; c < CPL; ++c) out[c] = cur.b3[c] + w[c];
      if constexpr (kFirst) {
        if (l0_skip) {
#pragma unroll
          for (int c = 0; c < CPL; ++c) {
            float sk = 0.f;
            for (int cc = 0; cc < C; ++cc)
              sk = fmaf(sm[m.emb + cc], c0 + c < C ? sm[m.skw + cc * C + c0 + c] : 0.f, sk);
            out[c] = cur.b3[c] + sk;
          }
        }
      }
      // u = elu(w + s[0]) + s[1], then this lane's share of the C->br product,
      // in two partial sums (even and odd channels)
      const Shift su = shift(cur.s[0], cur.s[1]);
      float t[MAXBR], t2[MAXBR];
#pragma unroll
      for (int j = 0; j < MAXBR; ++j) t[j] = t2[j] = 0.f;
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        float u = elu_shift(kFirst ? sprev[c] : w[c], su);
        if (kFirst && i2 == 0) u = 0.f;
#pragma unroll
        for (int j = 0; j < MAXBR; ++j) {
          if (c & 1) t2[j] = fmaf(u, cur.w1[c][j], t2[j]);
          else t[j] = fmaf(u, cur.w1[c][j], t[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < MAXBR; ++j) t[j] += t2[j];
#pragma unroll
      for (int off = 1; off < NL; off <<= 1) {
#pragma unroll
        for (int j = 0; j < MAXBR; ++j) t[j] += __shfl_xor_sync(kFull, t[j], off);
      }
      // v = elu(t + pre2) + s[3]; the taps: the cached half [v of the voxel
      // before] . wk[0], computed by that voxel, + v . wk[1] (two partial sums);
      // and this voxel's v . wk[0] for the next one, off the chain
      float v[MAXBR], b2[MAXBR], b2o[MAXBR], nxt[MAXBR];
#pragma unroll
      for (int j = 0; j < MAXBR; ++j) {
        v[j] = j < br ? elu_shift(t[j], shift(cur.pre2[j], cur.s[3])) : 0.f;
        b2[j] = cur.part[j];
        b2o[j] = nxt[j] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < MAXBR; ++i) {
#pragma unroll
        for (int o = 0; o < MAXBR; ++o) {
          if (i & 1) b2o[o] = fmaf(v[i], cur.wk[1][i][o], b2o[o]);
          else b2[o] = fmaf(v[i], cur.wk[1][i][o], b2[o]);
          nxt[o] = fmaf(v[i], cur.wk[0][i][o], nxt[o]);
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int o = 0; o < MAXBR; ++o)
          if (o < br) part_wr[li * bs + o] = nxt[o];
      }
      // w3v = elu(b2 + pre4) + s[5], then this lane's CPL output channels
      float out2[CPL];
#pragma unroll
      for (int c = 0; c < CPL; ++c) out2[c] = 0.f;
#pragma unroll
      for (int o = 0; o < MAXBR; ++o) {
        const float w3v = elu_shift(b2[o] + b2o[o], shift(cur.pre4[o], cur.s[5]));
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          if (o < br) {
            if (o & 1) out2[c] = fmaf(w3v, cur.w3[o][c], out2[c]);
            else out[c] = fmaf(w3v, cur.w3[o][c], out[c]);
          }
        }
      }
#pragma unroll
      for (int c = 0; c < CPL; ++c) w[c] = c0 + c < C ? out[c] + out2[c] : 0.f;
    };
    const long long t0 = probe ? clock64() : 0;
    {
      Layer cur;
      load(0, i2, part_rd, cur);
      step(0, cur, std::true_type{});
    }
    for (int li = 1; li < L; ++li) {
      Layer cur;
      load(li, i2, part_rd, cur);
      step(li, cur, std::false_type{});
    }
    if (probe) in_layers += clock64() - t0;

    // the final channels through shared memory, then the logits
    if (lane < NL) {
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int ch = c0 + c;
        if (ch < C)
          sm[m.tot + ch] = __ldg(a.dfin + (b * s2 + i2) * C + ch) + sm[m.hfin + i2 * C + ch] + w[c];
      }
    }
    __syncwarp();
    float lg[MAXKM];
#pragma unroll
    for (int mm = 0; mm < MAXKM; ++mm) {
      const int k = code(mm);
      lg[mm] = (mm < km && k < K) ? sm[m.bout + k] : 0.f;
    }
    for (int cc = 0; cc < C; ++cc) {
      const float x = sm[m.tot + cc];
#pragma unroll
      for (int mm = 0; mm < MAXKM; ++mm) {
        const int k = code(mm);
        if (mm < km && k < K) lg[mm] = fmaf(x, sm[m.wout + cc * K + k], lg[mm]);
      }
    }
    int idx;
    if (forced) {
#pragma unroll
      for (int mm = 0; mm < MAXKM; ++mm) {
        const int k = code(mm);
        if (mm < km && k < K) a.logits[(b * s2 + i2) * K + k] = lg[mm];
      }
      idx = a.forced[b * s2 + i2];
    } else {
      float best = -CUDART_INF_F;
      int bk = K;
#pragma unroll
      for (int mm = 0; mm < MAXKM; ++mm) {
        const int k = code(mm);
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
        bad |= mm < km && code(mm) < K && !isfinite(lg[mm]);
      idx = __any_sync(kFull, bad) ? -1 : bk;
    }
    if (lane == 0) a.out[b * s2 + i2] = idx;
    const int e = max(idx, 0);
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int ch = c0 + c;
      sprev[c] = ch < C ? sm[m.win + e * C + ch] + bin[c] : 0.f;
      if (lane < NL && ch < C) sm[m.emb + ch] = sprev[c];
    }
    // this voxel's part and embedding writes are visible to the next voxel's
    // reads, and its reads are done before the next voxel writes
    __syncwarp();
  }
  if (probe && lane == 0) {
    long long* cy = a.cycles + 4 * b;
    cy[0] = clock64() - t_chain;
    cy[1] = in_layers;
    cy[2] = t_chain - t_start;
    cy[3] = t_staged - t_start;
  }
}

template <int MAXC, int MAXBR, int MAXKM, bool EXACT>
cudaError_t launch(const RowArgs& a, cudaStream_t stream) {
  const Smem m = smem_layout(a.L, a.s2, a.C, a.br, a.ws, a.K, a.skw != nullptr);
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
// be null. cycles: null, or (B, 4) int64 that receive, per batch element, the
// clock64() cycles of the voxel chain (phase 2), of its layer loops alone, of
// the staging and phase 1, and of the staging alone.
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
                             int i1, float tau, long long* cycles, void* stream) {
  if (L <= 0 || B <= 0 || s2 <= 0 || s2 > 256 || C <= 0 || C > 32 || br <= 0 || br > 8 ||
      ws != 2 || K <= 0 || K > 512 || (forced == nullptr) != (logits == nullptr) ||
      (skw == nullptr) != (hskw == nullptr))
    return cudaErrorInvalidValue;
  RowArgs a{w1, wk, w3, b3, sc, hw1, herf, herfb, hwk, hw3, hb3, skw, hskw,
            w_in, b_in, w_out, b_out, d2h, d2w, cnd, dfin, sprev, vhc, gum, forced,
            out, logits, cycles, L, B, s2, C, br, ws, K, i1, tau};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the published top config's widths exactly, and every other width
  if (C == 16 && br == 4 && K == 128) return launch<16, 4, 4, true>(a, s);
  return launch<32, 8, 16, false>(a, s);
}
