// Kernel K6, wide: one row of cached PixelCNN ancestral sampling at the
// published mid and bottom widths.
//
// Replaces vqvae3d_tpu/ops/decode_row.py:row_decode (Pallas kernel
// _row_kernel) where csrc/row_decode.cu cannot: that kernel keeps every
// weight in shared memory and runs the voxel chain on one warp, lane c owning
// channel c, so it takes C <= 32 and br <= 8. The contract, the weight
// layouts and the plain version are in ops/decode_row.py, which picks the
// kernel from the shapes before any launch. fp32 throughout, CUDA cores
// (TF32 would not hold the contract's tolerance over 46-51 layers).
//
// The published wide priors: mid (jobs/train_pixelcnn_mid.sh) L = 46,
// C = 256, br = 64, K = 256, conditioned, rows of s2 = 8 at batch 10 (1,024
// rows a 32x32x8 grid); bottom (jobs/train_pixelcnn_bottom.sh) L = 51,
// C = 512, br = 128, K = 512, unconditioned, s2 = 2 at batch 20 (64 rows an
// 8x8x2 grid).
//
// What bounds it on the H100: a layer's weights are ~0.4 M fp32 at mid and
// ~1.6 M at bottom (~18 MB a model at mid, ~80 MB at bottom, past the 50 MB
// L2). Every voxel runs the whole chain (C -> br, the width taps, br -> C)
// through all L layers, one voxel after the other, and each layer-step needs
// that layer's weights: 2 C br + 2 br^2 floats, 160 KB at mid and 640 KB at
// bottom. All B batch rows share them. The chain is serial, so what bounds a
// row is the latency of its layer-steps: the exchanges between the SMs that
// share the work, the products, the staging of each step's weights.
//
// Design: one thread-block cluster of n = 16 CTAs (non-portable; 1.31x
// faster than 8 at the mid widths, PERF.md) takes the whole row call, all B
// batch rows at once.
//  * phase 1, the height-row step (the row's s2 positions together): it has
//    no serial dependency across the batch, so CTA r takes whole batch rows
//    b = r, r + n, ... at full width, its weights read from device memory
//    (L2) once for its rows (product_rows: a warp task takes 8 or 4 rows):
//    per layer u = elu(.), the C -> br product, h2w, the new v-row (each
//    CTA's rows of the caches read, then updated IN PLACE in device memory),
//    the 2x3 height taps with zero fill along s2 (one product over their six
//    inputs side by side), the condition and the br -> C output with its
//    residual (layer 0: its skip conv). Each layer's h2w and the final row go
//    straight into the shared memory of the CTAs that own their columns in
//    phase 2; one cluster barrier at its end.
//  * phase 2, the voxel chain: CTA r owns a fixed slice of the output
//    columns of every product: jb = ceil(br / n) of the C -> br product, the
//    taps and v; jc = ceil(C / n) of the br -> C output and the residual;
//    jk = ceil(K / n) of the logits (the last slices may be short; columns
//    past the width are zero-filled and never stored). It computes its
//    slice for all B rows, (B x C_in) . (C_in x cols), so each layer-step's
//    weight slice is read once for all B rows; the next step's slices (with
//    the bias rows and the step's d2w, h2w and condition columns) are staged
//    by cp.async into shared memory while the current step computes (one
//    buffer a matrix, refilled once its product is done and its outputs are
//    sent, while the exchange is in flight). Per voxel
//    and layer u, the C -> br product, v (with d2w and h2w), the two width
//    taps [cached v, v] (one product computes both the tap of this voxel and
//    the cached half for the next), the condition, the br -> C output
//    (layer 0: its skip conv of the sampled code's embedding); then the
//    logits and argmax(logits / tau + gumbel): each CTA reduces its columns
//    per batch row, then every CTA reduces the n winners in rank order, ties
//    to the lowest index; a voxel with a non-finite logit gets -1 (the
//    sampler reports it, the next voxel reads code 0's embedding). The
//    sampled code's w_in row + b_in feeds the next voxel's layer 0.
//    The activations a product needs in full (u, v, w3v, the voxel's total,
//    the CTAs' winners) are exchanged through distributed shared memory:
//    each CTA stores its columns into every CTA's copy of the full rows by
//    st.async, each store completing its bytes on the receiver's mbarrier,
//    and a CTA waits on its own mbarrier for a phase's bytes: no cluster
//    barrier, whose fence of all memory and L1 invalidation cost ~1,600
//    cycles on the H100 (chip_smoke.py phase 15). A buffer is rewritten only
//    after its readers sent data the writer needed since, so one each
//    suffices.
// A product is a set of warp tasks: a task is two rows (phase 1: 8 or 4) x
// four columns (a float4 of the weights), its K inputs split over LP lanes
// (k = part, part + LP, ...) and loaded in batches, every load of a batch
// issued before its first use, the LP partial sums added by xor shuffles in
// a fixed order; the lane of part 0 stores. LP is a function of the shapes
// (lanes_for). No atomics: every output column is summed by one lane in a
// fixed order, so two calls give the same bits. ELU is expm1 for x <= 0, as
// the plain version's.
// The published rows (mid at batch 10, bottom at batch 20) run
// instantiations with their widths, batch, s2 and K as constants, so their
// index arithmetic folds and their loops have known trip counts; any other
// row runs the generic one.
#include <cooperative_groups.h>

#include "common.cuh"
#include "mma.cuh"

#include <math_constants.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;  // threads a CTA
constexpr int kCluster = 16;  // CTAs a cluster
constexpr int kU = 4;         // inputs a batch of a phase-2 product's loads
constexpr int kU1 = 8;        //   of a phase-1 product's (from device memory)
constexpr int NW = NT / 32;
constexpr int kMbars = 5;  // phase 2's exchanges: u, v, w3v, the voxel's total, the argmax

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

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int align4(int v) { return (v + 3) & ~3; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// Shared memory in floats, every region 16-byte aligned (br and C are
// multiples of 4, checked at the launch): the persistent state, then phase
// 1's buffers and, over them, phase 2's. jb4, jc4, jk4: the own column
// counts rounded up to 4 (the row strides of the slices).
struct Lay {
  int jb, jc, jk, jb4, jc4, jk4, rl;
  int hw, hf, xw, sc, out, mbar;
  int h1, u1, tp, v1, vp, w3v, pout, x6;
  int vc, g, gv2, g3, ww1, wwk, ww3, wb3, d2w, cnd2, own, bsk, xa, idx, zs, bad;
  int total;
};

__host__ __device__ inline Lay layout(int L, int B, int s2, int C, int br, int K, int n) {
  Lay m;
  m.jb = cdiv(br, n);
  m.jc = cdiv(C, n);
  m.jk = cdiv(K, n);
  m.jb4 = align4(m.jb);
  m.jc4 = align4(m.jc);
  m.jk4 = align4(m.jk);
  const int R = B * s2;
  m.rl = cdiv(B, n) * s2;  // phase 1's rows a CTA: its batch rows' positions
  int o = 0;
  m.hw = o;   o += L * R * m.jb4;     // h2w injections [li][b][p][jj] (own columns)
  m.hf = o;   o += R * m.jc4;         // the height stream's final row [b][p][cc] (own columns)
  m.xw = o;   o += B * m.jc4;         // the width stream [b][cc]
  m.sc = o;   o += align4(8 * L);     // every layer's scalars
  m.out = o;  o += imax(imax(2 * B * m.jb4, B * m.jk4), B * m.jc4);  // phase 2's products
  m.mbar = o; o += align4(2 * kMbars);  // its mbarriers (8 bytes each)
  const int base = o;
  m.h1 = o;   o += m.rl * C;          // phase 1, this CTA's rows at full width: h, u
  m.u1 = o;   o += m.rl * C;
  m.tp = o;   o += m.rl * br;         //   tp, v1, the cached v-row, w3v
  m.v1 = o;   o += m.rl * br;
  m.vp = o;   o += m.rl * br;
  m.w3v = o;  o += m.rl * br;
  m.pout = o; o += m.rl * imax(C, br);  // its products
  m.x6 = o;   o += m.rl * 6 * br;       // the height taps' six inputs side by side
  const int end1 = o;
  o = base;
  m.vc = o;   o += L * B * m.jb4;     // the cached taps' halves [li][b][jj]
  m.g = o;    o += align4(B * C);     // full rows, stored by every CTA: u, the voxel's total
  m.gv2 = o;  o += align4(B * br);    //   v
  m.g3 = o;   o += align4(B * br);    //   w3v
  m.ww1 = o;  o += C * m.jb4;
  m.wwk = o;  o += 2 * br * m.jb4;    // [i][wk[1] own | wk[0] own]
  m.ww3 = o;  o += br * m.jc4;
  m.wb3 = o;  o += m.jc4;
  m.d2w = o;  o += 2 * B * m.jb4;
  m.cnd2 = o; o += 2 * B * m.jb4;
  m.own = o;  o += B * imax(m.jc4, m.jb4);  // this CTA's columns before they are stored
  m.bsk = o;  o += m.jc4;             // b_in . skw (layer 0's skip conv of the bias)
  m.xa = o;   o += n * B * 4;         // every CTA's best z, its index, a non-finite flag [q][b]
  m.idx = o;  o += align4(2 * B);     // the sampled codes, and clamped to >= 0
  m.zs = o;   o += B * m.jk4;
  m.bad = o;  o += B * m.jk4;
  m.total = imax(end1, o);
  return m;
}

// mbarriers and st.async (PTX ISA: "mbarrier", "st.async"): a CTA's shared
// memory takes its peers' columns by st.async, each completing its bytes on
// the receiver's mbarrier; the receiver waits for a phase's bytes, at CTA
// scope. No cluster barrier: no fence of all memory, no L1 invalidation.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(vq::smem_u32(bar)));
}

// the receiver's one arrival of a phase, and the bytes it expects
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(vq::smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n .reg .pred p;\n LAB_WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra LAB_WAIT;\n}\n" ::"r"(vq::smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// the address of local shared memory p in CTA q's shared memory
__device__ __forceinline__ uint32_t peer(const void* p, int q) {
  uint32_t d;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(d) : "r"(vq::smem_u32(p)), "r"(q));
  return d;
}

// v into a peer's shared memory at d, its bytes completing on the peer's
// mbarrier at bar (both peer() addresses)
__device__ __forceinline__ void st_async(uint32_t d, uint32_t bar, float4 v) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, [%5];" ::"r"(d),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void st_async(uint32_t d, uint32_t bar, float v) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];" ::"r"(d),
               "r"(__float_as_uint(v)), "r"(bar)
               : "memory");
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return v < lo ? lo : v > hi ? hi : v; }

// ELU, called rather than inlined: one copy of expm1f in the kernel's code
__device__ __noinline__ float elu(float v) { return vq::elu(v); }

// rows x cols floats of src (row stride lds) into dst (row stride ldd) by
// cp.async; columns past `valid` are zero-filled and not read. 16 bytes a
// copy where the shapes and addresses allow it.
__device__ __forceinline__ void stage(float* dst, int ldd, const float* src, int64_t lds, int rows,
                                   int cols, int valid) {
  const bool vec = cols % 4 == 0 && valid == cols && lds % 4 == 0 && ldd % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(src) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(dst) & 15) == 0;
  if (vec) {
    const int c4 = cols / 4;
    for (int e = threadIdx.x; e < rows * c4; e += NT) {
      const int r = e / c4, c = e % c4 * 4;
      vq::cp_async16(vq::smem_u32(dst + r * ldd + c), src + r * lds + c, 16);
    }
    return;
  }
  for (int e = threadIdx.x; e < rows * cols; e += NT) {
    const int r = e / cols, c = e % cols;
    const bool ok = c < valid;
    vq::cp_async4(vq::smem_u32(dst + r * ldd + c), ok ? src + r * lds + c : src, ok ? 4 : 0);
  }
}

// The lanes a warp task splits its K inputs over: the cheapest of 4..32 by
// a count of the task's steps and its shuffles (a function of the shapes).
__device__ __forceinline__ int lanes_for(int rows, int k, int njt) {
  int best = 32, cost_best = 0x7fffffff;
  for (int lp = 32, lg = 5; lp >= 4; lp >>= 1, --lg) {
    const int tasks = cdiv(rows, 2) * cdiv(njt * lp, 32);
    const int cost = cdiv(tasks, NW) * (14 * cdiv(k, lp) + 16 * lg);
    if (cost < cost_best) {
      cost_best = cost;
      best = lp;
    }
  }
  return best;
}

__device__ __forceinline__ void fma4(float4& a, float x, const float4& w) {
  a.x = fmaf(x, w.x, a.x);
  a.y = fmaf(x, w.y, a.y);
  a.z = fmaf(x, w.z, a.z);
  a.w = fmaf(x, w.w, a.w);
}

__device__ __forceinline__ void add_xor(float4& a, int off) {
  a.x += __shfl_xor_sync(0xffffffffu, a.x, off);
  a.y += __shfl_xor_sync(0xffffffffu, a.y, off);
  a.z += __shfl_xor_sync(0xffffffffu, a.z, off);
  a.w += __shfl_xor_sync(0xffffffffu, a.w, off);
}

// A product's split of its work: its K inputs over lp lanes (G = 32 / lp
// column groups a warp, lgg = log2 G), njb column blocks, the warp tasks.
struct Plan {
  int lp, lgg, njb, tasks;
};

__device__ __forceinline__ Plan plan_for(int rows, int kd, int njt) {
  Plan p;
  p.lp = lanes_for(rows, kd, njt);
  p.lgg = 5 - (31 - __clz(p.lp));
  p.njb = cdiv(njt, 1 << p.lgg);
  p.tasks = cdiv(rows, 2) * p.njb;
  return p;
}

// out[r * ldo + j] (= or, with acc, +=) sum over k < kd of
// x[xr(r) * ldx + k] * w[k * ldw + j], for r < rows and j < 4 njt (w's
// columns past wvalid read as 0). xr(r) = xidx[r] where a row table is
// given, else r + shift, and a row whose position r % s2 + shift falls
// outside [0, s2) reads 0 (the height taps; s2 = 1, shift = 0 otherwise).
// Warp tasks of two rows x four columns, the K inputs split over pl.lp
// lanes (k = part, part + lp, ...), the partial sums added by xor shuffles
// in a fixed order; the lane of part 0 stores. The same plan maps every
// output to the same lane, so accumulating calls of one plan need no
// barrier between them.
__device__ __forceinline__ void product(const Plan& pl, const float* x, int ldx, const int* xidx,
                                        int rows, int s2, int shift, const float* w, int64_t ldw,
                                        int wvalid, int njt, int kd, float* out, int ldo,
                                        bool acc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lp = pl.lp, part = lane >> pl.lgg, g = lane & ((1 << pl.lgg) - 1);
  const bool wvec = wvalid == 4 * njt && ldw % 4 == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  for (int t = warp; t < pl.tasks; t += NW) {
    const int r0 = t / pl.njb * 2, jt = (t % pl.njb << pl.lgg) + g;
    const float* xs[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + i, p = r % s2 + shift;
      xs[i] = r >= rows || p < 0 || p >= s2
                  ? nullptr
                  : x + static_cast<int64_t>(xidx != nullptr ? xidx[r] : r + shift) * ldx;
    }
    float4 a0 = make_float4(0.f, 0.f, 0.f, 0.f), a1 = a0;
    if (jt < njt && (xs[0] != nullptr || xs[1] != nullptr)) {
      const float* wc = w + 4 * jt;
      const int c = 4 * jt;
      // kU inputs a batch, every load of a batch issued before its first
      // use: the addresses are clamped into the inputs (always valid), the
      // inputs past kd add nothing
      for (int k0 = part; k0 < kd; k0 += kU * lp) {
        float4 wv[kU];
        float x0[kU], x1[kU];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int k = min(k0 + u * lp, kd - 1);
          const float* wr = wc + k * ldw;
          wv[u] = wvec ? *reinterpret_cast<const float4*>(wr)
                       : make_float4(c < wvalid ? wr[0] : 0.f, c + 1 < wvalid ? wr[1] : 0.f,
                                     c + 2 < wvalid ? wr[2] : 0.f, c + 3 < wvalid ? wr[3] : 0.f);
          x0[u] = xs[0] != nullptr ? xs[0][k] : 0.f;
          x1[u] = xs[1] != nullptr ? xs[1][k] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          if (k0 + u * lp < kd) {
            fma4(a0, x0[u], wv[u]);
            fma4(a1, x1[u], wv[u]);
          }
        }
      }
    }
    for (int off = 1 << pl.lgg; off < 32; off <<= 1) {
      add_xor(a0, off);
      add_xor(a1, off);
    }
    if (part == 0 && jt < njt) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (r0 + i >= rows) break;
        float4* o = reinterpret_cast<float4*>(out + (r0 + i) * ldo + 4 * jt);
        const float4 v = i == 0 ? a0 : a1;
        if (acc) {
          float4 prev = *o;
          prev.x += v.x;
          prev.y += v.y;
          prev.z += v.z;
          prev.w += v.w;
          *o = prev;
        } else {
          *o = v;
        }
      }
    }
  }
}

// Phase 1's products, whose weights come from device memory (L2):
// out[r * ldo + j] (= or, with acc, +=) the sum over k < kd of
// xrow(r)[k] * w[k ldw + j], for r < rows and j < ncols (a multiple of 4). A
// warp task is RT rows x four columns, so a task reads each of its weights
// once for RT rows; the K inputs split over lp lanes (k = part, part + lp,
// ...), lp the most that keeps every task in one pass of the CTA's warps
// (the shortest serial chain of loads), loaded kU1 at a time, the partial
// sums added by xor shuffles in a fixed order; the lane of part 0 stores. lp
// depends on rows and ncols alone, so calls with the same rows and ncols map
// every output to the same lane and accumulate with no barrier between them.
template <int RT, class XRow>
__device__ __forceinline__ void product_rows(XRow xrow, int rows, const float* w, int64_t ldw,
                                             int ncols, int kd, float* out, int ldo, bool acc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int njt = ncols / 4, nrc = cdiv(rows, RT);
  int lp = 32;
  while (lp > 4 && nrc * njt * lp > NT) lp >>= 1;
  const int lgg = 5 - (31 - __clz(lp)), part = lane >> lgg, g = lane & ((1 << lgg) - 1);
  const int njb = cdiv(njt, 1 << lgg), tasks = nrc * njb;
  for (int t = warp; t < tasks; t += NW) {
    const int r0 = t / njb * RT, jt = (t % njb << lgg) + g;
    float4 s[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i) s[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (jt < njt) {
      const float* xs[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i) xs[i] = r0 + i < rows ? xrow(r0 + i) : nullptr;
      const float* wc = w + 4 * jt;
      // every load of a batch issued before its first use (addresses clamped
      // into the inputs; the inputs past kd add nothing): kU1 loads of each
      // lane in flight
      for (int k0 = part; k0 < kd; k0 += kU1 * lp) {
        float4 wv[kU1];
#pragma unroll
        for (int u = 0; u < kU1; ++u)
          wv[u] = __ldg(reinterpret_cast<const float4*>(wc + min(k0 + u * lp, kd - 1) * ldw));
#pragma unroll
        for (int u = 0; u < kU1; ++u) {
          const int k = k0 + u * lp;
          if (k < kd) {
#pragma unroll
            for (int i = 0; i < RT; ++i) fma4(s[i], xs[i] != nullptr ? xs[i][k] : 0.f, wv[u]);
          }
        }
      }
    }
    for (int off = 1 << lgg; off < 32; off <<= 1) {
#pragma unroll
      for (int i = 0; i < RT; ++i) add_xor(s[i], off);
    }
    if (part == 0 && jt < njt) {
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        if (r0 + i >= rows) break;
        float4* o = reinterpret_cast<float4*>(out + (r0 + i) * ldo + 4 * jt);
        if (acc) {
          float4 prev = *o;
          prev.x += s[i].x;
          prev.y += s[i].y;
          prev.z += s[i].z;
          prev.w += s[i].w;
          *o = prev;
        } else {
          *o = s[i];
        }
      }
    }
  }
}

// phase 1's product at the CTA's row count: tasks of 8 rows (the mid row's
// 8 positions of one batch row) or of 4 (the bottom row's 2 x 2)
template <class XRow>
__device__ __forceinline__ void product_p1(XRow xrow, int rows, const float* w, int64_t ldw,
                                           int ncols, int kd, float* out, int ldo, bool acc) {
  if (rows > 4)
    product_rows<8>(xrow, rows, w, ldw, ncols, kd, out, ldo, acc);
  else
    product_rows<4>(xrow, rows, w, ldw, ncols, kd, out, ldo, acc);
}

// CT, BRT, BT, S2T, KT: C, br, B, s2 and K as constants (0: the arguments')
template <int CT, int BRT, int BT, int S2T, int KT>
__global__ void __launch_bounds__(NT, 1) row_decode_wide_kernel(RowArgs a) {
  extern __shared__ __align__(16) float sm[];
  cg::cluster_group cl = cg::this_cluster();
  const int n = kCluster, rank = static_cast<int>(cl.block_rank());
  const int tid = threadIdx.x;
  const int L = a.L, B = BT ? BT : a.B, s2 = S2T ? S2T : a.s2, C = CT ? CT : a.C;
  const int br = BRT ? BRT : a.br, K = KT ? KT : a.K, R = B * s2;
  const Lay m = layout(L, B, s2, C, br, K, n);
  const int jb = m.jb, jc = m.jc, jk = m.jk, jb4 = m.jb4, jc4 = m.jc4, jk4 = m.jk4;
  const int j0 = rank * jb, c0 = rank * jc, k0 = rank * jk;
  const int nb = clampi(br - j0, 0, jb), ncl = clampi(C - c0, 0, jc), nk = clampi(K - k0, 0, jk);
  const int njb = jb4 / 4, njc = jc4 / 4, njk = jk4 / 4;
  const bool cond = a.cnd != nullptr, l0_skip = a.skw != nullptr;
  float *HW = sm + m.hw, *HF = sm + m.hf, *XW = sm + m.xw, *SC = sm + m.sc, *OUT = sm + m.out;
  uint64_t* MB = reinterpret_cast<uint64_t*>(sm + m.mbar);  // u, v, w3v, the total, the argmax
  for (int e = tid; e < 8 * L; e += NT) SC[e] = a.sc[e];
  if (tid == 0) {
    for (int i = 0; i < kMbars; ++i) mbar_init(MB + i);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }

  // ---- phase 1: the height-row step, the row's positions together. It has
  // no serial dependency across the batch, so CTA r takes whole batch rows
  // b = r, r + n, ... at full width, the weights read from device memory
  // (L2), and stores each layer's h2w and the final row into the columns'
  // owners' shared memory: no exchange and no barrier until its end.
  {
    float *H1 = sm + m.h1, *U1 = sm + m.u1, *TP = sm + m.tp, *V1 = sm + m.v1;
    float *VP = sm + m.vp, *W3V = sm + m.w3v, *PO = sm + m.pout, *X6 = sm + m.x6;
    const int nrow = rank < B ? cdiv(B - rank, n) : 0, rl = nrow * s2;
    auto grow = [&](int r) { return (rank + r / s2 * n) * s2 + r % s2; };  // (b, p) of local row r
    auto rows_of = [](const float* x, int ld) {  // local row r of x
      return [x, ld](int r) { return x + r * ld; };
    };
    for (int e = tid; e < rl * C; e += NT) H1[e] = a.b_in[e % C];
    for (int li = 0; li < L; ++li) {
      const float* s = a.sc + li * 8;
      const float s0 = s[0], s1 = s[1], s2a = s[2], s3 = s[3], s4 = s[4], s5 = s[5];
      const int64_t lrow = static_cast<int64_t>(li) * R;  // the (L, B, s2, br) row tensors
      for (int e = tid; e < rl * C; e += NT) {
        const int r = e / C, c = e % C;
        U1[e] = li == 0 && a.i1 == 0
                    ? 0.f
                    : elu((li == 0 ? a.sprev[static_cast<int64_t>(grow(r)) * C + c] : H1[e]) + s0) + s1;
      }
      for (int e = tid; e < rl * br; e += NT)  // this layer's caches, before this CTA writes them
        VP[e] = a.vhc[(lrow + grow(e / br)) * br + e % br];
      __syncthreads();
      // tp = u1 . hw1; v1
      product_p1(rows_of(U1, C), rl, a.hw1 + static_cast<int64_t>(li) * C * br, br, br, C, TP, br,
                 false);
      __syncthreads();
      for (int e = tid; e < rl * br; e += NT)
        V1[e] = elu(TP[e] + a.d2h[(lrow + grow(e / br)) * br + e % br] + s2a) + s3;
      // h2w = tp . herf + herfb, into the owners' columns
      product_p1(rows_of(TP, br), rl, a.herf + static_cast<int64_t>(li) * br * br, br, br, br, PO,
                 br, false);
      __syncthreads();
      for (int e = tid; e < rl * br; e += NT) {
        const int j = e % br, q = j / jb;
        cl.map_shared_rank(HW, q)[(lrow + grow(e / br)) * jb4 + j - q * jb] =
            a.herfb[li * br + j] + PO[e];
      }
      // the 2x3 height taps' inputs side by side: segment sg = row * 3 + j1
      // of a row is [the cached v-row, v1] at position p + j1 - 1, zero fill
      // along s2, so the taps are one product over 6 br inputs (hwk's six
      // (br, br) matrices of a layer are one (6 br, br) matrix)
      for (int e = tid; e < rl * 6 * br; e += NT) {
        const int r = e / (6 * br), sg = e / br % 6, i = e % br, sh = sg % 3 - 1, p = r % s2 + sh;
        X6[e] = p < 0 || p >= s2 ? 0.f : (sg < 3 ? VP : V1)[(r + sh) * br + i];
      }
      __syncthreads();
      product_p1(rows_of(X6, 6 * br), rl, a.hwk + static_cast<int64_t>(li) * 6 * br * br, br, br,
                 6 * br, PO, br, false);
      __syncthreads();
      for (int e = tid; e < rl * br; e += NT) {
        const int64_t row = (lrow + grow(e / br)) * br + e % br;
        W3V[e] = elu(PO[e] + (cond ? a.cnd[row] : 0.f) + s4) + s5;
        a.vhc[row] = V1[e];  // in place: this CTA's rows, read above
      }
      __syncthreads();
      // h = w3v . hw3 + hb3 + (h | layer 0's skip conv of sprev; the same
      // rows and columns: each output stays with its lane)
      const bool skip = li == 0 && l0_skip;
      product_p1(rows_of(W3V, br), rl, a.hw3 + static_cast<int64_t>(li) * br * C, C, C, br, PO, C,
                 false);
      if (skip)
        product_p1([&](int r) { return a.sprev + static_cast<int64_t>(grow(r)) * C; }, rl,
                   a.hskw, C, C, C, PO, C, true);
      __syncthreads();
      for (int e = tid; e < rl * C; e += NT)
        H1[e] = a.hb3[li * C + e % C] + PO[e] + (skip ? 0.f : H1[e]);
    }
    __syncthreads();
    for (int e = tid; e < rl * C; e += NT) {  // the final row, into the owners' columns
      const int c = e % C, q = c / jc;
      cl.map_shared_rank(HF, q)[grow(e / C) * jc4 + c - q * jc] = H1[e];
    }
  }
  cl.sync();  // every CTA's h2w and final row are in place; phase 2's buffers lie over phase 1's

  // ---- phase 2: the voxel chain
  float *VC = sm + m.vc, *G = sm + m.g, *GV2 = sm + m.gv2, *G3 = sm + m.g3;
  float *WW1 = sm + m.ww1, *WWK = sm + m.wwk, *WW3 = sm + m.ww3, *WB3 = sm + m.wb3;
  float *OWN = sm + m.own, *BSK = sm + m.bsk, *XA = sm + m.xa, *ZS = sm + m.zs, *BAD = sm + m.bad;
  int* IDX = reinterpret_cast<int*>(sm + m.idx);  // [0, B): the codes; [B, 2B): clamped to >= 0
  const int bjb = B * jb4;
  // one cp.async group of phase 2's operands: layer li of voxel i2, into parity par
  auto stage_p2 = [&](int grp, int li, int i2, int par) {
    if (i2 < s2) {
      const int64_t row = (static_cast<int64_t>(li) * B * s2 + i2) * br + j0;  // b = 0
      if (grp == 0) {
        stage(WW1, jb4, a.w1 + static_cast<int64_t>(li) * C * br + j0, br, C, jb4, nb);
        stage(sm + m.d2w + par * bjb, jb4, a.d2w + row, static_cast<int64_t>(s2) * br, B, jb4, nb);
      } else if (grp == 1) {
        const float* wk = a.wk + static_cast<int64_t>(li) * 2 * br * br + j0;
        stage(WWK, 2 * jb4, wk + br * br, br, br, jb4, nb);  // the tap of v now
        stage(WWK + jb4, 2 * jb4, wk, br, br, jb4, nb);      // the cached tap's
        if (cond)
          stage(sm + m.cnd2 + par * bjb, jb4, a.cnd + row, static_cast<int64_t>(s2) * br, B, jb4,
                nb);
      } else {
        stage(WW3, jc4, a.w3 + static_cast<int64_t>(li) * br * C + c0, C, br, jc4, ncl);
        stage(WB3, jc4, a.b3 + li * C + c0, 0, 1, jc4, ncl);
      }
    }
    vq::cp_async_commit();
  };
  // the bytes a phase of each mbarrier expects, its phases
  const int by[kMbars] = {B * C * 4, B * br * 4, B * br * 4, B * C * 4, n * B * 16};
  int ph[kMbars] = {0, 0, 0, 0, 0};
  // after every thread passed mbarrier i's wait: the next phase's arrival and bytes
  auto arm = [&](int i) {
    if (tid == 0) mbar_expect(MB + i, by[i]);
  };
  auto recv = [&](int i) { mbar_wait(MB + i, ph[i]++ & 1); };  // a phase's bytes are in
  // this CTA's columns (OWN [b][ldo], cols of them from column col0) into
  // every CTA's full rows (B x width) by st.async, completing on mbarrier i:
  // thread t stores into CTA t % n
  const int pq = tid % n;
  auto push = [&](float* full, int width, int ldo, int col0, int cols, int i) {
    const uint32_t d = peer(full + col0, pq), bar = peer(MB + i, pq);
    if (cols % 4 == 0 && col0 % 4 == 0) {
      const int c4 = cols / 4;
      for (int e = tid / n; e < B * c4; e += NT / n) {
        const int b = e / c4, c = e % c4 * 4;
        st_async(d + 4 * (b * width + c), bar, *reinterpret_cast<const float4*>(OWN + b * ldo + c));
      }
    } else {
      for (int e = tid / n; e < B * cols; e += NT / n) {
        const int b = e / cols, c = e % cols;
        st_async(d + 4 * (b * width + c), bar, OWN[b * ldo + c]);
      }
    }
  };
  // u of layer li (voxel i2) from the width stream or the sampled embedding,
  // into every CTA's rows
  auto push_u = [&](int li, int i2) {
    const float* s = SC + li * 8;
    for (int e = tid; e < B * ncl; e += NT) {
      const int b = e / ncl, cc = e % ncl;
      float u = 0.f;
      if (!(li == 0 && i2 == 0)) {
        const float x = li == 0 ? a.w_in[static_cast<int64_t>(IDX[B + b]) * C + c0 + cc] +
                                      a.b_in[c0 + cc]
                                : XW[b * jc4 + cc];
        u = elu(x + s[0]) + s[1];
      }
      OWN[b * jc4 + cc] = u;
    }
    __syncthreads();
    push(G, C, jc4, c0, ncl, 0);
  };
  for (int e = tid; e < L * bjb; e += NT) VC[e] = 0.f;  // no voxel before i2 = 0
  if (l0_skip) {  // b_in . skw: the bias's share of layer 0's skip conv
    product(plan_for(1, C, njc), a.b_in, C, nullptr, 1, 1, 0, a.skw + c0, C, ncl, njc, C, BSK, jc4,
            false);
  }
  for (int grp = 0; grp < 3; ++grp) stage_p2(grp, 0, 0, 0);
  for (int i = 0; i < kMbars; ++i) arm(i);
  const bool forced = a.forced != nullptr;
  const Plan pl_t = plan_for(B, C, njb), pl_tap = plan_for(B, br, 2 * njb);
  const Plan pl_w3 = plan_for(B, br, njc), pl_skip = plan_for(B, C, njc), pl_lg = plan_for(B, C, njk);
  int par = 0;
  for (int i2 = 0; i2 < s2; ++i2) {
    for (int e = tid; e < B * jc4; e += NT) XW[e] = e % jc4 < ncl ? a.b_in[c0 + e % jc4] : 0.f;
    push_u(0, i2);
    for (int li = 0; li < L; ++li) {
      const float* s = SC + li * 8;
      const float s2a = s[2], s3 = s[3], s4 = s[4], s5 = s[5];
      const int nli = li + 1 < L ? li + 1 : 0, ni2 = li + 1 < L ? i2 : i2 + 1;  // the next step
      const float *D2W = sm + m.d2w + par * bjb, *CND = sm + m.cnd2 + par * bjb;
      vq::cp_async_wait<2>();
      recv(0);
      __syncthreads();
      arm(0);
      // t = u . w1; v = elu(t + d2w + h2w + .), into every CTA's rows
      product(pl_t, G, C, nullptr, B, 1, 0, WW1, jb4, jb4, njb, C, OUT, jb4, false);
      __syncthreads();
      for (int o = tid; o < B * jb; o += NT) {
        const int b = o / jb, j = o % jb;
        const float x = OUT[b * jb4 + j] + D2W[b * jb4 + j] + HW[(li * R + b * s2 + i2) * jb4 + j];
        OWN[b * jb4 + j] = elu(x + s2a) + s3;
      }
      __syncthreads();
      push(GV2, br, jb4, j0, nb, 1);
      stage_p2(0, nli, ni2, par ^ 1);  // WW1 and d2w's other parity: read above the barrier
      vq::cp_async_wait<2>();
      recv(1);
      __syncthreads();
      arm(1);
      // the width taps: v . wk[1] now and v . wk[0], the next voxel's cached half
      product(pl_tap, GV2, br, nullptr, B, 1, 0, WWK, 2 * jb4, 2 * jb4, 2 * njb, br, OUT, 2 * jb4,
              false);
      __syncthreads();
      for (int o = tid; o < B * jb4; o += NT) {
        const int b = o / jb4, j = o % jb4;
        float* vc = VC + li * B * jb4 + o;
        const float b2 = *vc + OUT[b * 2 * jb4 + j];
        *vc = OUT[b * 2 * jb4 + jb4 + j];
        OWN[o] = elu(b2 + (cond ? CND[o] : 0.f) + s4) + s5;
      }
      __syncthreads();
      push(G3, br, jb4, j0, nb, 2);
      stage_p2(1, nli, ni2, par ^ 1);
      vq::cp_async_wait<2>();
      recv(2);
      __syncthreads();
      arm(2);
      // w = w3v . w3 + b3 + (w | layer 0's skip conv of the sampled embedding
      // w_in[idx] + b_in, 0 before the first voxel)
      const bool skip = li == 0 && l0_skip;
      product(pl_w3, G3, br, nullptr, B, 1, 0, WW3, jc4, jc4, njc, br, OUT, jc4, false);
      if (skip && i2 > 0) {
        __syncthreads();  // its outputs fall to other lanes
        product(pl_skip, a.w_in, C, IDX + B, B, 1, 0, a.skw + c0, C, ncl, njc, C, OUT, jc4, true);
      }
      __syncthreads();
      for (int o = tid; o < B * jc4; o += NT) {
        const float acc = WB3[o % jc4] + OUT[o];
        XW[o] = skip ? acc + (i2 > 0 ? BSK[o % jc4] : 0.f) : acc + XW[o];
      }
      __syncthreads();
      if (li + 1 < L) push_u(li + 1, i2);
      stage_p2(2, nli, ni2, par ^ 1);
      par ^= 1;
    }
    // the voxel's total into every CTA's rows, then the logits of this CTA's K / n columns
    for (int e = tid; e < B * ncl; e += NT) {
      const int b = e / ncl, cc = e % ncl;
      OWN[b * jc4 + cc] = a.dfin[(static_cast<int64_t>(b) * s2 + i2) * C + c0 + cc] +
                          HF[(b * s2 + i2) * jc4 + cc] + XW[b * jc4 + cc];
    }
    __syncthreads();
    push(G, C, jc4, c0, ncl, 3);
    recv(3);
    __syncthreads();
    arm(3);
    product(pl_lg, G, C, nullptr, B, 1, 0, a.w_out + k0, K, nk, njk, C, OUT, jk4, false);
    __syncthreads();
    for (int o = tid; o < B * nk; o += NT) {
      const int b = o / nk, kk = o % nk, k = k0 + kk;
      const float lg = a.b_out[k] + OUT[b * jk4 + kk];
      if (forced) a.logits[(static_cast<int64_t>(b) * s2 + i2) * K + k] = lg;
      ZS[b * jk4 + kk] = lg / a.tau + a.gum[(static_cast<int64_t>(i2) * B + b) * K + k];
      BAD[b * jk4 + kk] = isfinite(lg) ? 0.f : 1.f;
    }
    __syncthreads();
    // this CTA's best of each row (k rising: the first of equal z stays), to
    // every CTA; exchanged also when forced: no CTA stores the next voxel's u
    // into G before every CTA has read G
    for (int e = tid; e < n * B; e += NT) {
      const int q = e % n, row = e / n;
      float best = -CUDART_INF_F, bad = 0.f;
      int bk = K;
      for (int kk = 0; kk < nk; ++kk) {
        const float z = ZS[row * jk4 + kk];
        bad = fmaxf(bad, BAD[row * jk4 + kk]);
        if (z > best) {
          best = z;
          bk = k0 + kk;
        }
      }
      st_async(peer(XA + (rank * B + row) * 4, q), peer(MB + 4, q),
               make_float4(best, __int_as_float(bk), bad, 0.f));
    }
    recv(4);
    if (tid < B) {
      int idx;
      if (forced) {
        idx = a.forced[tid * s2 + i2];
      } else {  // the CTAs' winners in rank order, ties to the lowest index
        float best = -CUDART_INF_F;
        int bk = K;
        bool bad = false;
        for (int q = 0; q < n; ++q) {
          const float* xa = XA + (q * B + tid) * 4;
          const int k = __float_as_int(xa[1]);
          bad |= xa[2] != 0.f;
          if (xa[0] > best || (xa[0] == best && k < bk)) {
            best = xa[0];
            bk = k;
          }
        }
        idx = bad ? -1 : bk;
      }
      IDX[tid] = idx;
      IDX[B + tid] = max(idx, 0);
      if (rank == 0) a.out[tid * s2 + i2] = idx;
    }
    __syncthreads();
    arm(4);
  }
  cl.sync();  // no CTA leaves while a peer may read its shared memory
}

// iters rounds of a cluster barrier (exchange 0) or of the kernel's exchange
// (1: every CTA stores a float into every CTA by st.async and waits on its
// mbarrier for them)
__global__ void __launch_bounds__(NT) exchange_probe(int exchange, int iters) {
  __shared__ __align__(16) float buf[16];
  __shared__ __align__(8) uint64_t bar;
  cg::cluster_group cl = cg::this_cluster();
  const int n = kCluster, rank = static_cast<int>(cl.block_rank());
  if (threadIdx.x == 0) {
    mbar_init(&bar);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect(&bar, 4 * n);
  }
  cl.sync();
  for (int i = 0; i < iters; ++i) {
    if (exchange == 0) {
      cl.sync();
      continue;
    }
    if (threadIdx.x < n)
      st_async(peer(buf + rank, threadIdx.x), peer(&bar, threadIdx.x), static_cast<float>(i));
    mbar_wait(&bar, i & 1);
    __syncthreads();
    if (threadIdx.x == 0) mbar_expect(&bar, 4 * n);
  }
  cl.sync();
}

cudaError_t opt_in(const void* fn, int bytes) {
  cudaError_t err = cudaSuccess;
  if (bytes > 48 * 1024)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

cudaError_t launch_cluster(const void* fn, void** args, size_t bytes, void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t launch = cudaLaunchKernelExC(&cfg, fn, args);
  return launch != cudaSuccess ? launch : cudaGetLastError();
}

}  // namespace

// The contract of ops/decode_row.py (the same arguments as vq_row_decode),
// run by one cluster of 16 CTAs; ws must be 2 (the k = 3 width conv), C and
// br multiples of 4, B at most NT, and the row's state must fit a CTA's
// shared memory (layout(); a row that does not fit is refused here).
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
  if (L <= 0 || B <= 0 || B > NT || s2 <= 0 || C <= 0 || br <= 0 || C % 4 || br % 4 || ws != 2 ||
      K <= 0 || (forced == nullptr) != (logits == nullptr) || (skw == nullptr) != (hskw == nullptr))
    return cudaErrorInvalidValue;
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const size_t bytes = static_cast<size_t>(layout(L, B, s2, C, br, K, kCluster).total) * sizeof(float);
  if (bytes > static_cast<size_t>(limit)) return cudaErrorInvalidValue;
  const void* fn = C == 256 && br == 64 && B == 10 && s2 == 8 && K == 256
                       ? reinterpret_cast<const void*>(row_decode_wide_kernel<256, 64, 10, 8, 256>)
                   : C == 512 && br == 128 && B == 20 && s2 == 2 && K == 512
                       ? reinterpret_cast<const void*>(row_decode_wide_kernel<512, 128, 20, 2, 512>)
                       : reinterpret_cast<const void*>(row_decode_wide_kernel<0, 0, 0, 0, 0>);
  err = opt_in(fn, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  RowArgs a{w1, wk, w3, b3, sc, hw1, herf, herfb, hwk, hw3, hb3, skw, hskw,
            w_in, b_in, w_out, b_out, d2h, d2w, cnd, dfin, sprev, vhc, gum, forced,
            out, logits, L, B, s2, C, br, K, i1, tau};
  void* args[] = {&a};
  return launch_cluster(fn, args, bytes, stream);
}

// One cluster of the wide K6's size passing `iters` rounds of a cluster
// barrier (exchange 0) or of the kernel's st.async exchange (exchange 1) and
// nothing else: its time over iters is the latency that bounds the wide K6's
// layer-steps (chip_smoke.py phase 15).
extern "C" int vq_cluster_exchange_probe(int exchange, int iters, void* stream) {
  if (iters < 0) return cudaErrorInvalidValue;
  const void* fn = reinterpret_cast<const void*>(exchange_probe);
  const cudaError_t err = opt_in(fn, 0);
  if (err != cudaSuccess) return err;
  void* args[] = {&exchange, &iters};
  return launch_cluster(fn, args, 0, stream);
}
