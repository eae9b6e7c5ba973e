// What FeatureNet's FPN kernels K19 upsample2x_add (upsample2x_add.cu) and
// its backward K20 upsample2x_grad (upsample2x_grad.cu) share.
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

}  // namespace
