// What the init sweep's two softmax tails share: K30 view_weight
// (view_weight.cu) and its backward K31 view_weight_grad
// (view_weight_grad.cu), K32 init_depth (init_depth.cu) and its backward
// K33 init_depth_grad (init_depth_grad.cu).
//
// Each reads a map x [planes, kSamples, h, w] (NCHW: a pixel's samples lie
// h·w apart) and takes, at each pixel, the softmax over its kSamples
// samples as PyTorch's spatial softmax kernel (cunn_SpatialSoftMaxForward)
// takes it for such a map, where its launch plan gives one thread per
// pixel: the max in sample order from the lowest float, Σ expf(x − max)
// in sample order from 0, then each expf(x − max) / Σ, every operation
// IEEE (a card probe, itermvs_tpu_torch/tools/probe_sample_softmax.py,
// found this bit-equal to torch.softmax, the max of the quotients equal to
// 1 / Σ, and PyTorch's sum over the samples to take four interleaved
// partial sums: `expectation` below).
//
// K30 and K32 also write the ×2 bilinear resize of their per-pixel value:
// a block computes a window of kHaloRows x kHaloCols pixels, its tile and a
// one-pixel halo around it clamped to the map as the resize clamps, one
// pixel per thread, into shared memory; each tile pixel then writes its
// 2 x 2 outputs with K28's ×2 formula (`write_up2`). A halo pixel is
// computed by the same code as in its own tile, so the two values are
// bit-identical.
#pragma once

#include <cfloat>

#include "upsample2x.cuh"

namespace {

constexpr int kSamples = 32;
constexpr int kHaloRows = 8, kHaloCols = 32;
constexpr int kTileRows = kHaloRows - 2, kTileCols = kHaloCols - 2;
static_assert(kHaloRows * kHaloCols == kThreads, "one window pixel per thread");

// One pixel's softmax: e[d] = expf(x_d − max) and sum = Σ e[d].
struct SampleSoftmax {
  float e[kSamples];
  float sum;

  template <typename T>
  __device__ __forceinline__ SampleSoftmax(const T* x, long long stride) {
    float mx = -FLT_MAX;
#pragma unroll
    for (int d = 0; d < kSamples; ++d) {
      e[d] = tap_float(__ldg(x + d * stride));
      mx = mx < e[d] ? e[d] : mx;
    }
    sum = 0.0f;
#pragma unroll
    for (int d = 0; d < kSamples; ++d) {
      e[d] = expf(__fsub_rn(e[d], mx));
      sum = __fadd_rn(sum, e[d]);
    }
  }

  // The probability of sample d.
  __device__ __forceinline__ float p(int d) const { return __fdiv_rn(e[d], sum); }
};

// Σ_d d · p[d], each product rounded, summed as PyTorch's reduction sums
// 32 values of a strided dimension: four partial sums, of the samples
// 4k + a, combined in order.
__device__ __forceinline__ float expectation(const float p[kSamples]) {
  float acc[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) acc[a] = __fmul_rn(static_cast<float>(a), p[a]);
#pragma unroll
  for (int d = 4; d < kSamples; ++d)
    acc[d % 4] = __fadd_rn(acc[d % 4], __fmul_rn(static_cast<float>(d), p[d]));
  return __fadd_rn(__fadd_rn(__fadd_rn(acc[0], acc[1]), acc[2]), acc[3]);
}

// The init depth from the expectation e, as the eager chain rounds it:
// e / 31 as a product with the float reciprocal (CUDA's division by a
// Python scalar), then 1 / (idmax + n · (idmin − idmax)), `diff` = idmin −
// idmax.
constexpr float kIndexScale = 1.0f / static_cast<float>(kSamples - 1);

__device__ __forceinline__ float init_depth_of(float e, float idmax, float diff) {
  const float n = __fmul_rn(e, kIndexScale);
  return __fdiv_rn(1.0f, __fadd_rn(idmax, __fmul_rn(n, diff)));
}

// This thread's pixel of its block's window: (r, c) in the window, (ti, tj)
// the map pixel it stands for (rows from blockIdx.y, columns from
// blockIdx.x; outside the map at the halo), (i, j) that pixel clamped to
// the map, where it reads.
struct Window {
  int r, c, ti, tj, i, j;

  __device__ __forceinline__ Window(int h, int w) {
    r = threadIdx.x / kHaloCols;
    c = threadIdx.x % kHaloCols;
    ti = static_cast<int>(blockIdx.y) * kTileRows - 1 + r;
    tj = static_cast<int>(blockIdx.x) * kTileCols - 1 + c;
    i = min(max(ti, 0), h - 1);
    j = min(max(tj, 0), w - 1);
  }

  // Whether the pixel is in the tile and in the map: it writes outputs.
  __device__ __forceinline__ bool inner(int h, int w) const {
    return r > 0 && r < kHaloRows - 1 && c > 0 && c < kHaloCols - 1 && ti < h && tj < w;
  }
};

// A launch's blocks over [planes, h, w]; grid.x 0 where it would not fit.
inline dim3 window_grid(long long planes, int h, int w) {
  const long long gx = (w + kTileCols - 1) / kTileCols, gy = (h + kTileRows - 1) / kTileRows;
  if (planes > 65535 || gy > 65535 || gx > 0x7fffffffLL) return dim3(0, 1, 1);
  return dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy),
              static_cast<unsigned>(planes));
}

// The 2 x 2 outputs of the ×2 resize at map pixel (i, j) of [h, w], window
// pixel (r, c) of the window's values v, into out [2h, 2w] of its plane:
// K28's ×2 formula (resize_bilinear.cu), bit-equal to F.interpolate.
// Output row 2i + a reads rows (i - 1, i) with (1/4, 3/4) for a = 0 but
// at row 0, (0, min(1, h - 1)) with (1, 0); rows (i, min(i + 1, h - 1))
// with (3/4, 1/4) for a = 1; the columns alike. The halo holds the clamped
// neighbours.
__device__ __forceinline__ void write_up2(const float (*v)[kHaloCols], int r, int c, int i,
                                          int j, float* out, int w) {
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const bool up = a == 0 && i > 0;
    const float h0 = a ? 0.75f : (i > 0 ? 0.25f : 1.0f);
    const float h1 = a ? 0.25f : (i > 0 ? 0.75f : 0.0f);
    const float* t = v[up ? r - 1 : r];
    const float* b = v[up ? r : r + 1];
    const float even = j > 0 ? bilinear(h0, h1, 0.25f, 0.75f, t[c - 1], t[c], b[c - 1], b[c])
                             : bilinear(h0, h1, 1.0f, 0.0f, t[c], t[c + 1], b[c], b[c + 1]);
    const float odd = bilinear(h0, h1, 0.75f, 0.25f, t[c], t[c + 1], b[c], b[c + 1]);
    *reinterpret_cast<float2*>(out + (2LL * i + a) * 2 * w + 2 * j) = make_float2(even, odd);
  }
}

// ∂x of the ×2 resize at pixel (i, j) of [h, w] from ∂out g [2h, 2w] of
// its plane: K29's 4 x 4 gather (resize_bilinear_grad.cu), each tap
// converted to float64 and summed down its column in row order, then the
// columns summed in order, each step an FMA, rounded once: the value K29
// writes there.
__device__ __forceinline__ float gather_up2(const float* g, int i, int j, int h, int w) {
  double rows[4], cols[4], col[4] = {0.0, 0.0, 0.0, 0.0};
  fold_weights(i, h, rows);
  fold_weights(j, w, cols);
  const int ow = 2 * w;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    if (rows[r] == 0.0) continue;
    const float* row = g + static_cast<long long>(2 * i - 1 + r) * ow;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int x = 2 * j - 1 + t;
      const double d = x >= 0 && x < ow ? static_cast<double>(__ldg(row + x)) : 0.0;
      col[t] = __fma_rn(rows[r], d, col[t]);
    }
  }
  double s = 0.0;
#pragma unroll
  for (int t = 0; t < 4; ++t) s = __fma_rn(cols[t], col[t], s);
  return __double2float_rn(s);
}

}  // namespace
