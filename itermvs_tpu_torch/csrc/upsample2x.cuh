// What the ×2 bilinear kernels share: FeatureNet's FPN kernels K19
// upsample2x_add (upsample2x_add.cu) and its backward K20 upsample2x_grad
// (upsample2x_grad.cu), the model's resizes K28 resize_bilinear and K29
// resize_bilinear_grad, and the init sweep's K30-K33 (sample_softmax.cuh).
//
// Both work on NCHW maps of T (float32 or bfloat16) and the ×2 bilinear
// resize of F.interpolate(align_corners=False): x [planes, h, w] up to
// [planes, 2h, 2w]. A thread owns kCols neighbouring columns of one row of
// x (K19) or of ∂x (K20), so the outputs or inputs it touches are runs of
// 2 * kCols neighbouring columns of up to four rows of the large map, plus
// one column on each side. kCols is kRun where w is a multiple of kRun
// and every pointer is 16-byte aligned (the runs are then whole words:
// float4, or eight bfloat16 in a uint4, four in a uint2), else 1 (scalar
// accesses).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "elementwise.cuh"

namespace {

constexpr int kRun = 4;

// n consecutive elements of T at p, as floats: 16-byte words where they
// fill them, an 8-byte word for four bfloat16, else one at a time.
template <typename T, int n>
__device__ __forceinline__ void load_run(const T* p, float* v) {
  constexpr int kBytes = n * static_cast<int>(sizeof(T));
  if constexpr (kBytes % 16 == 0) {
#pragma unroll
    for (int i = 0; i < kBytes / 16; ++i) {
      if constexpr (sizeof(T) == 4) {
        const float4 w = __ldg(reinterpret_cast<const float4*>(p) + i);
        v[4 * i] = w.x;
        v[4 * i + 1] = w.y;
        v[4 * i + 2] = w.z;
        v[4 * i + 3] = w.w;
      } else {
        bf16x8_to_float(__ldg(reinterpret_cast<const uint4*>(p) + i), v + 8 * i);
      }
    }
  } else if constexpr (kBytes == 8 && sizeof(T) == 2) {
    const float4 w = bf16x4_to_float4(__ldg(reinterpret_cast<const uint2*>(p)));
    v[0] = w.x;
    v[1] = w.y;
    v[2] = w.z;
    v[3] = w.w;
  } else {
#pragma unroll
    for (int i = 0; i < n; ++i) v[i] = tap_float(__ldg(p + i));
  }
}

// n consecutive values, already rounded to T, stored at p as load_run
// reads them.
template <typename T, int n>
__device__ __forceinline__ void store_run(T* p, const float* v) {
  constexpr int kBytes = n * static_cast<int>(sizeof(T));
  if constexpr (kBytes % 16 == 0) {
#pragma unroll
    for (int i = 0; i < kBytes / 16; ++i) {
      if constexpr (sizeof(T) == 4)
        reinterpret_cast<float4*>(p)[i] =
            make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
      else
        reinterpret_cast<uint4*>(p)[i] = float_to_bf16x8(v + 8 * i);
    }
  } else if constexpr (kBytes == 8 && sizeof(T) == 2) {
    *reinterpret_cast<uint2*>(p) = make_uint2(bf16_bits(v[0]) | (bf16_bits(v[1]) << 16),
                                              bf16_bits(v[2]) | (bf16_bits(v[3]) << 16));
  } else {
#pragma unroll
    for (int i = 0; i < n; ++i) store_one(p + i, v[i]);
  }
}

// The thread's plane, row i and first column j of the small map [planes,
// h, w], threads running along the rows' column groups first.
struct Cell {
  long long plane;
  int i, j;
  bool live;

  __device__ __forceinline__ Cell(long long planes, int h, int w, int cols) {
    const int groups = w / cols;
    const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
    const long long row = t / groups;
    j = static_cast<int>(t - row * groups) * cols;
    plane = row / h;
    i = static_cast<int>(row - plane * h);
    live = plane < planes;
  }
};

// The launch's blocks for the small map [planes, h, w] in runs of `cols`
// columns; 0 where the grid would not fit.
inline long long grid_of(long long planes, int h, int w, int cols) {
  const long long blocks = (planes * h * (w / cols) + kThreads - 1) / kThreads;
  return blocks > 0x7fffffffLL ? 0 : blocks;
}

// PyTorch's upsample_bilinear2d_out_frame formula, as its build contracts
// it: a * x + b * y as fma(a, x, b * y), inside and out.
__device__ __forceinline__ float bilinear(float h0, float h1, float w0, float w1, float x00,
                                          float x01, float x10, float x11) {
  const float top = __fmaf_rn(w0, x00, __fmul_rn(w1, x01));
  const float bottom = __fmaf_rn(w0, x10, __fmul_rn(w1, x11));
  return __fmaf_rn(h0, top, __fmul_rn(h1, bottom));
}

// The ×2 backward's weights of taps 2k - 1, 2k, 2k + 1, 2k + 2 for pixel k
// of n: (1/4, 3/4, 3/4, 1/4), the first dropped and the second 1 at the
// first pixel, the last dropped and the third 1 at the last.
__device__ __forceinline__ void fold_weights(int k, int n, double wt[4]) {
  wt[0] = k > 0 ? 0.25 : 0.0;
  wt[1] = k > 0 ? 0.75 : 1.0;
  wt[2] = k < n - 1 ? 0.75 : 1.0;
  wt[3] = k < n - 1 ? 0.25 : 0.0;
}

// Rows of ∂x in pairs: a thread owns rows 2p and 2p + 1 (the last pair of
// an odd h only its first).
__host__ __device__ __forceinline__ int pairs_of(int h) { return (h + 1) / 2; }

// A float64 sum rounded once to T, as a float.
template <typename T>
__device__ __forceinline__ float round_to(double v);
template <>
__device__ __forceinline__ float round_to<float>(double v) {
  return __double2float_rn(v);
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(double v) {
  return __bfloat162float(__double2bfloat16(v));
}

}  // namespace
