// K20 upsample2x_grad: the backward of FeatureNet's FPN top-down add K19
// with respect to x: ∂x [planes, h, w] of the ×2 bilinear upsample
// (F.interpolate, align_corners=False) for ∂out g [planes, 2h, 2w], in
// the compute dtype T (float32 or bfloat16), NCHW. (∂l is g itself: the
// autograd function hands it back with no kernel.)
//
// Replaces: the autodiff of the XLA fusion at
// itermvs_tpu/models/feature_net.py:98-102 (the transposed resize
// contractions). In the port: PyTorch's upsample_bilinear2d_backward,
// which zeroes ∂x and scatters every g into its four neighbours with
// atomics, in an order that changes from run to run.
//
// What bounds it on an H100: memory in float32. It reads g once and
// writes ∂x once (5 elements per element of ∂x); the 16 multiply-adds per
// ∂x run in float64. In bfloat16, with half the bytes, the float64 work,
// the conversions to float64 above all, comes first.
//
// Design (upsample2x.cuh): a gather, no atomics. Each ∂x pixel is the sum
// over its 4 x 4 window of g with the separable weights (1/4, 3/4, 3/4,
// 1/4) along each axis, where at the first row (column) the first weight
// drops and the second is 1, and at the last the last drops and the third
// is 1 (h = 1: (1, 1)). The terms are exact in float64 (g has at most 24
// significant bits, the weights 2), so the float64 sum rounded once to T
// is within one unit in the last place of the exact sum: a float32 sum of
// 16 terms that cancel is not. The order is fixed, so two launches are
// bit-equal. To convert each g value once per pair, a thread owns rows i0,
// i0 + 1 of ∂x at kCols neighbouring columns j .. j + kCols - 1: it
// converts each of the 6 g rows 2 i0 - 1 .. 2 i0 + 4 that exist, at
// columns 2j - 1 .. 2j + 2 kCols, once, sums them down the columns for
// each of its two rows, then across.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "upsample2x.cuh"

namespace {

// The weights of taps 2k - 1, 2k, 2k + 1, 2k + 2 for pixel k of n.
__device__ __forceinline__ void fold_weights(int k, int n, double wt[4]) {
  wt[0] = k > 0 ? 0.25 : 0.0;
  wt[1] = k > 0 ? 0.75 : 1.0;
  wt[2] = k < n - 1 ? 0.75 : 1.0;
  wt[3] = k < n - 1 ? 0.25 : 0.0;
}

// Rows of ∂x in pairs: a thread owns rows 2p and 2p + 1 (the last pair of
// an odd h only its first).
__host__ __device__ __forceinline__ int pairs_of(int h) { return (h + 1) / 2; }

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

template <typename T, int kCols>
__global__ void __launch_bounds__(kThreads)
upsample2x_grad_kernel(const T* __restrict__ g, T* __restrict__ dx, long long planes, int h,
                       int w) {
  const Cell at(planes, pairs_of(h), w, kCols);
  if (!at.live) return;
  const int i0 = 2 * at.i, j = at.j, ow = 2 * w;
  const bool second = i0 + 1 < h;  // the pair's second row exists
  double rows[2][4], cols[kCols][4];
  fold_weights(i0, h, rows[0]);
  fold_weights(i0 + 1, h, rows[1]);
#pragma unroll
  for (int e = 0; e < kCols; ++e) fold_weights(j + e, w, cols[e]);
  // col[a][t]: the column 2j - 1 + t of g summed over ∂x row i0 + a's
  // four g rows, 2(i0 + a) - 1 .. 2(i0 + a) + 2: the pair reads g rows
  // 2 i0 - 1 .. 2 i0 + 4, each converted once.
  double col[2][2 * kCols + 2];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int t = 0; t < 2 * kCols + 2; ++t) col[a][t] = 0.0;
  const T* gp = g + at.plane * 2 * h * ow;
#pragma unroll
  for (int r = 0; r < 6; ++r) {
    // Rows with weight 0 are off the map (row -1 or 2h) or, for the
    // second row, absent.
    const double w0 = r < 4 ? rows[0][r] : 0.0;
    const double w1 = r >= 2 && second ? rows[1][r - 2] : 0.0;
    if (w0 == 0.0 && w1 == 0.0) continue;
    const T* row = gp + static_cast<long long>(2 * i0 - 1 + r) * ow;
    float v[2 * kCols + 2];
    v[0] = j > 0 ? tap_float(__ldg(row + 2 * j - 1)) : 0.0f;
    load_run<T, 2 * kCols>(row + 2 * j, v + 1);
    v[2 * kCols + 1] = j + kCols < w ? tap_float(__ldg(row + 2 * (j + kCols))) : 0.0f;
#pragma unroll
    for (int t = 0; t < 2 * kCols + 2; ++t) {
      const double d = static_cast<double>(v[t]);
      if (w0 != 0.0) col[0][t] = __fma_rn(w0, d, col[0][t]);
      if (w1 != 0.0) col[1][t] = __fma_rn(w1, d, col[1][t]);
    }
  }
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    if (a == 1 && !second) break;
    float res[kCols];
#pragma unroll
    for (int e = 0; e < kCols; ++e) {
      double s = 0.0;
#pragma unroll
      for (int t = 0; t < 4; ++t) s = __fma_rn(cols[e][t], col[a][2 * e + t], s);
      res[e] = round_to<T>(s);
    }
    store_run<T, kCols>(dx + (at.plane * h + i0 + a) * w + j, res);
  }
}

template <typename T>
int launch(const void* g, void* dx, long long planes, int h, int w, void* stream) {
  if (planes <= 0 || h <= 0 || w <= 0) return 0;
  const bool runs = w % kRun == 0 && aligned16(g) && aligned16(dx);
  const int cols = runs ? kRun : 1;
  const long long grid = grid_of(planes, pairs_of(h), w, cols);
  if (grid == 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* gv = static_cast<const T*>(g);
  T* dv = static_cast<T*>(dx);
  if (runs)
    upsample2x_grad_kernel<T, kRun><<<static_cast<unsigned>(grid), kThreads, 0, st>>>(
        gv, dv, planes, h, w);
  else
    upsample2x_grad_kernel<T, 1><<<static_cast<unsigned>(grid), kThreads, 0, st>>>(
        gv, dv, planes, h, w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// g: [planes, 2h, 2w], dx: [planes, h, w], contiguous, of float32
// (itermvs_upsample2x_grad) or bfloat16 (_bf16). Returns the launch's
// error (0 on success).
extern "C" int itermvs_upsample2x_grad(const void* g, void* dx, long long planes, int h, int w,
                                       void* stream) {
  return launch<float>(g, dx, planes, h, w, stream);
}

extern "C" int itermvs_upsample2x_grad_bf16(const void* g, void* dx, long long planes, int h,
                                            int w, void* stream) {
  return launch<__nv_bfloat16>(g, dx, planes, h, w, stream);
}
