// Shared device code of kernel K4 (causal_stack.cu, causal_stack_bwd.cu):
// the union stream's voxel geometry and the causal union conv.
//
// Activations are channels-last (B, s0, s1, s2, C) with s0 the slowest
// spatial axis; voxel v = ((b * s0 + i0) * s1 + i1) * s2 + i2. The union conv
// has 18 taps, tap = (j0 * 3 + j1) * 3 + j2 with j0 in {0, 1}, j1, j2 in
// {0, 1, 2}; tap (j0, j1, j2) of output voxel p reads a2 at
// p + (j0 - 1, j1 - 1, j2 - 1), zero outside the grid: the causal front pads
// (1, 0) on s0 and the symmetric (1, 1) on s1 and s2.
#pragma once

#include "common.cuh"

namespace vqc {

constexpr int kTaps = 18;

struct Vox {
  int64_t b;
  int i0, i1, i2;
};

__device__ __forceinline__ Vox decode(int64_t v, int s0, int s1, int s2) {
  Vox o;
  if (v <= 0x7fffffff) {  // 32-bit divisions where the index allows them
    unsigned t = static_cast<unsigned>(v);
    o.i2 = static_cast<int>(t % s2);
    t /= s2;
    o.i1 = static_cast<int>(t % s1);
    t /= s1;
    o.i0 = static_cast<int>(t % s0);
    o.b = t / s0;
    return o;
  }
  o.i2 = static_cast<int>(v % s2);
  int64_t t = v / s2;
  o.i1 = static_cast<int>(t % s1);
  t /= s1;
  o.i0 = static_cast<int>(t % s0);
  o.b = t / s0;
  return o;
}

// The voxel p + s * (j0 - 1, j1 - 1, j2 - 1) of tap `tap` (s = +1: the
// forward conv's input of output p; s = -1: the output that input p feeds,
// which the transposed conv reads), or -1 outside the grid. With s = -1 and
// j0 = 0 it is one s0-row AHEAD of p: the transposed causal conv looks
// forward, and the last row gets nothing from beyond the grid.
__device__ __forceinline__ int64_t tap_voxel(const Vox& p, int tap, int s, int s0, int s1,
                                             int s2) {
  const int a = p.i0 + s * (tap / 9 - 1);
  const int b = p.i1 + s * ((tap / 3) % 3 - 1);
  const int c = p.i2 + s * (tap % 3 - 1);
  if (a < 0 || a >= s0 || b < 0 || b >= s1 || c < 0 || c >= s2) return -1;
  return ((p.b * s0 + a) * s1 + b) * static_cast<int64_t>(s2) + c;
}

// c = union conv + dropout + condition for output channels g*COB + j of
// voxel v, in fp32, as the reference math keeps it until `+ b3a`:
//   acc  = sum over taps and input channels of a2[nbr] * wu   (wg: [18][Cb][COB])
//   acc  = keep ? (keep[k] > 0 ? acc / denom : 0) : acc        (denom = 1 - p)
//   acc  = (acc + cond[v] . wc[:, k]) + bc[k]                  (when conditioned)
template <typename T, int COB>
__device__ __forceinline__ void union_conv(const T* __restrict__ a2, const T* __restrict__ wg,
                                           const float* __restrict__ keep, float denom,
                                           const T* __restrict__ cond, const T* __restrict__ wcg,
                                           const T* __restrict__ bc, const Vox& p, int64_t v,
                                           int g, int s0, int s1, int s2, int cb, int cc,
                                           float acc[COB]) {
#pragma unroll
  for (int j = 0; j < COB; ++j) acc[j] = 0.f;
  for (int tap = 0; tap < kTaps; ++tap) {
    const int64_t nb = tap_voxel(p, tap, 1, s0, s1, s2);
    if (nb < 0) continue;
    const T* src = a2 + nb * cb;
    const T* wt = wg + tap * cb * COB;
    for (int ci = 0; ci < cb; ++ci) {
      const float a = vq::to_f<T>(src[ci]);
#pragma unroll
      for (int j = 0; j < COB; ++j) acc[j] = fmaf(a, vq::to_f<T>(wt[ci * COB + j]), acc[j]);
    }
  }
  if (keep != nullptr) {
    const float* kb = keep + p.b * cb;
#pragma unroll
    for (int j = 0; j < COB; ++j) {
      const int k = g * COB + j;
      if (k < cb) acc[j] = kb[k] > 0.f ? acc[j] / denom : 0.f;
    }
  }
  if (cond != nullptr) {
    float cacc[COB];
#pragma unroll
    for (int j = 0; j < COB; ++j) cacc[j] = 0.f;
    const T* cv = cond + v * cc;
    for (int ci = 0; ci < cc; ++ci) {
      const float a = vq::to_f<T>(cv[ci]);
#pragma unroll
      for (int j = 0; j < COB; ++j) cacc[j] = fmaf(a, vq::to_f<T>(wcg[ci * COB + j]), cacc[j]);
    }
#pragma unroll
    for (int j = 0; j < COB; ++j) {
      const int k = g * COB + j;
      if (k < cb) acc[j] = (acc[j] + cacc[j]) + vq::to_f<T>(bc[k]);
    }
  }
}

}  // namespace vqc

#define VQ_COB_DISPATCH(cob, KERNEL, T, ...)                        \
  switch (cob) {                                                   \
    case 1: KERNEL<T, 1>__VA_ARGS__; break;                        \
    case 2: KERNEL<T, 2>__VA_ARGS__; break;                        \
    case 4: KERNEL<T, 4>__VA_ARGS__; break;                        \
    case 8: KERNEL<T, 8>__VA_ARGS__; break;                        \
    default: return cudaErrorInvalidValue;                         \
  }
