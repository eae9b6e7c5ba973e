// What K9 convex_upsample (convex_upsample.cu) and K10
// convex_upsample_grad (convex_upsample_grad.cu) share: the mask logits'
// layout, the pairs of pixels a thread owns, their loads and stores, the
// 9-tap softmax, which K10 recomputes and so must compute exactly as K9
// does, and the launch (launch.cuh).
//
// Layout: mask logits [B, 144, H, W], channel k*16 + i*4 + j for tap k =
// (dy+1)*3 + (dx+1) and sub-pixel (i, j) of the x4 upsample.
//
// Pixels: a thread owns a pair of neighbouring coarse pixels of one row
// and one sub-row i. A row of W pixels holds ceil(W / 2) pairs, so where
// W is odd the row's last pair is one pixel (`two` false). The pair loads
// and stores one 4-byte (bf16) or 8-byte (f32) word per channel plane
// only on the paired path (kPaired): W even, so that H*W is even and
// every plane's pair starts on an even element, with the pointers
// aligned to two elements (the launchers check); off it each pixel is
// its own scalar access. Timed against one pixel per thread (PERF.md §6),
// pairs were faster in bf16 and as fast in f32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr int kScale = 4;
constexpr int kTaps = 9;
constexpr int kChannels = kTaps * kScale * kScale;
// A block: 32 pairs along the flattened (batch, row, pair) index, times
// the 4 sub-rows i.
constexpr int kGroups = 32;
constexpr int kThreads = kGroups * kScale;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// Pair gq of a [batch, h, w] map: its batch, row, first column and
// whether it holds a second pixel.
struct Pair {
  int b, y, x0;
  bool two;
  __device__ __forceinline__ Pair(int gq, int h, int w) {
    const int per_row = (w + 1) / 2;
    const int r = gq / per_row;
    x0 = (gq - r * per_row) * 2;
    b = r / h;
    y = r - b * h;
    two = x0 + 1 < w;
  }
};

// One load of a pair's values in one channel plane: on the paired path
// one word (4 bytes in bf16, 8 in f32), else each pixel on its own (the
// second only where `two`).
template <typename T, bool kPaired>
struct Word {
  T v[2];
  __device__ __forceinline__ void load(const T* p, bool two) {
    v[0] = __ldg(p);
    v[1] = two ? __ldg(p + 1) : v[0];
  }
  __device__ __forceinline__ float get(int e) const { return to_float(v[e]); }
};

template <>
struct Word<float, true> {
  float2 v;
  __device__ __forceinline__ void load(const float* p, bool) {
    v = __ldg(reinterpret_cast<const float2*>(p));
  }
  __device__ __forceinline__ float get(int e) const { return e == 0 ? v.x : v.y; }
};

template <>
struct Word<__nv_bfloat16, true> {
  __nv_bfloat162 v;
  __device__ __forceinline__ void load(const __nv_bfloat16* p, bool) {
    v = __ldg(reinterpret_cast<const __nv_bfloat162*>(p));
  }
  __device__ __forceinline__ float get(int e) const {
    return __bfloat162float(e == 0 ? v.x : v.y);
  }
};

// The pair's 9 logits of sub-pixel (i, j) as loaded, `plane` pointing at
// the pair in channel i*4 + j of tap 0. A thread loads all 4 sub-columns
// j of its sub-row before it computes any, 36 loads in flight per thread
// (with the loads of sub-column j + 1 issued only while j computed, the
// kernels took up to 11% longer at the training step's shape and as
// long at the map's, PERF.md §6).
template <typename T, bool kPaired>
struct Logits {
  Word<T, kPaired> word[kTaps];
  __device__ __forceinline__ void load(const T* plane, long long hw, bool two) {
#pragma unroll
    for (int k = 0; k < kTaps; ++k) word[k].load(plane + k * kScale * kScale * hw, two);
  }
  // Pixel e's 9 logits, as float32.
  __device__ __forceinline__ void get(int e, float (&v)[kTaps]) const {
#pragma unroll
    for (int k = 0; k < kTaps; ++k) v[k] = word[k].get(e);
  }
};

// A pair's two values at p[0] and p[1] (the second only where `two`).
template <bool kPaired>
__device__ __forceinline__ void store2(float* p, bool two, float a, float b) {
  if (kPaired) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    *p = a;
    if (two) p[1] = b;
  }
}

template <bool kPaired>
__device__ __forceinline__ void store2(__nv_bfloat16* p, bool two, float a, float b) {
  if (kPaired) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  } else {
    *p = __float2bfloat16_rn(a);
    if (two) p[1] = __float2bfloat16_rn(b);
  }
}

// In place: the softmax of one sub-pixel's 9 logits. The maximum, the
// sum of exp(l - max) in tap order, then each exp(l - max) times the
// sum's reciprocal: two roundings per weight (each within half an ulp),
// so within about one ulp of the quotient, where 9 IEEE divides
// (`__fdiv_rn`, each a reciprocal, its refinement and a slow-path test)
// cost several times the instructions of the rest of the softmax.
__device__ __forceinline__ void softmax9(float (&v)[kTaps]) {
  float m = v[0];
#pragma unroll
  for (int k = 1; k < kTaps; ++k) m = fmaxf(m, v[k]);
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < kTaps; ++k) {
    v[k] = expf(__fsub_rn(v[k], m));
    s = __fadd_rn(s, v[k]);
  }
  const float r = __frcp_rn(s);
#pragma unroll
  for (int k = 0; k < kTaps; ++k) v[k] = __fmul_rn(v[k], r);
}

// The 9-term sum of weights times the clamped neighbours, in tap order,
// each operation rounded on its own (no FMA contraction).
__device__ __forceinline__ float convex9(const float (&wt)[kTaps], const float (&t)[kTaps]) {
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < kTaps; ++k) acc = __fadd_rn(acc, __fmul_rn(wt[k], t[k]));
  return acc;
}

// The clamped 3x3 neighbourhoods of the pair's pixels, in tap order:
// rows y-1..y+1 and columns x0-1..x0+2, each clamped into the map, read
// once for the pair.
__device__ __forceinline__ void neighbourhoods(const float* __restrict__ plane, int y, int x0,
                                               int h, int w, float (&t)[2][kTaps]) {
  int xs[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) xs[c] = min(max(x0 - 1 + c, 0), w - 1);
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float* row = plane + min(max(y - 1 + r, 0), h - 1) * w;
    float v[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = __ldg(row + xs[c]);
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int c = 0; c < 3; ++c) t[e][r * 3 + c] = v[e + c];
  }
}

}  // namespace
