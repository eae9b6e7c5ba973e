// K29 resize_bilinear_grad: the backward of K28 resize_bilinear with
// respect to x, ∂x [planes, h, w] from ∂out g in T (float32 or bfloat16),
// NCHW, for the two ratios that carry a gradient in the model:
//     ×2  (g [planes, 2h, 2w]: the init sweep's depth, the hidden state,
//          the level-3 reference features)
//     ×½  (g [planes, h/2, w/2]: the level-1 reference features)
// With act = 1 (the hidden state's tanh) g first becomes
//     ∂pre = tanh_backward(g, y) = g * (1 - y * y)      (rounded to T)
// from K28's saved output y, computed as PyTorch's CUDA tanh_backward
// (conv_gru.cuh).
//
// Replaces: the autodiff of the XLA fusions K28 replaces (the transposed
// interpolation contractions of itermvs_tpu/ops/resize.py:41-56, and
// tanh's derivative). In the port: PyTorch's upsample_bilinear2d_backward,
// which zeroes ∂x and scatters every g into its four neighbours with
// atomics, in an order that changes from run to run, and an eager
// tanh_backward before it.
//
// What bounds it on an H100: memory. It reads g (and y) once and writes
// ∂x once; ×2 takes 16 multiply-adds per ∂x in float64, bound by their
// rate in bfloat16 (as K20).
//
// Design, ×2: K20's gather (upsample2x_grad.cu), a thread per pair of ∂x
// rows and kCols columns summing its 4 x 4 window of ∂pre with the
// separable weights (1/4, 3/4, 3/4, 1/4), the first dropped and the
// second 1 at the first row or column, the last dropped and the third 1
// at the last, in float64, rounded once: within one unit in the last
// place of the exact sum, no atomics, two launches bit-equal. ×½: each ∂x
// pixel has exactly one output, with weight 1/2 · 1/2, so ∂x = 0 + ¼ ∂pre
// rounded to T, PyTorch's atomic sum onto zeros bit for bit; a thread per
// kCols ∂out columns of one row writes the 2 x 2 kCols ∂x below them.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "conv_gru.cuh"
#include "upsample2x.cuh"

namespace {

// ∂pre at one element: g, or tanh_backward(g, y) for act.
template <typename T, bool kAct>
__device__ __forceinline__ float pre(float g, float y) {
  if constexpr (kAct)
    return tanh_backward<T>(g, y);
  else
    return g;
}

// n consecutive ∂pre values from g (and y) at offset o.
template <typename T, int n, bool kAct>
__device__ __forceinline__ void load_pre(const T* g, const T* y, long long o, float* v) {
  load_run<T, n>(g + o, v);
  if constexpr (kAct) {
    float t[n];
    load_run<T, n>(y + o, t);
#pragma unroll
    for (int e = 0; e < n; ++e) v[e] = pre<T, true>(v[e], t[e]);
  }
}

template <typename T, bool kAct>
__device__ __forceinline__ float load_pre_one(const T* g, const T* y, long long o) {
  return pre<T, kAct>(tap_float(__ldg(g + o)), kAct ? tap_float(__ldg(y + o)) : 0.0f);
}

// ×2: ∂x rows i0, i0 + 1 at columns j .. j + kCols - 1 from ∂pre rows
// 2 i0 - 1 .. 2 i0 + 4, columns 2j - 1 .. 2j + 2 kCols, each converted
// to float64 once.
template <typename T, int kCols, bool kAct>
__global__ void __launch_bounds__(kThreads)
resize_bilinear_grad_up2_kernel(const T* __restrict__ g, const T* __restrict__ y,
                                T* __restrict__ dx, long long planes, int h, int w) {
  const Cell at(planes, pairs_of(h), w, kCols);
  if (!at.live) return;
  const int i0 = 2 * at.i, j = at.j, ow = 2 * w;
  const bool second = i0 + 1 < h;
  double rows[2][4], cols[kCols][4];
  fold_weights(i0, h, rows[0]);
  fold_weights(i0 + 1, h, rows[1]);
#pragma unroll
  for (int e = 0; e < kCols; ++e) fold_weights(j + e, w, cols[e]);
  double col[2][2 * kCols + 2];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int t = 0; t < 2 * kCols + 2; ++t) col[a][t] = 0.0;
  const long long base = at.plane * 2 * h * ow;
#pragma unroll
  for (int r = 0; r < 6; ++r) {
    const double w0 = r < 4 ? rows[0][r] : 0.0;
    const double w1 = r >= 2 && second ? rows[1][r - 2] : 0.0;
    if (w0 == 0.0 && w1 == 0.0) continue;
    const long long row = base + static_cast<long long>(2 * i0 - 1 + r) * ow;
    float v[2 * kCols + 2];
    v[0] = j > 0 ? load_pre_one<T, kAct>(g, y, row + 2 * j - 1) : 0.0f;
    load_pre<T, 2 * kCols, kAct>(g, y, row + 2 * j, v + 1);
    v[2 * kCols + 1] = j + kCols < w ? load_pre_one<T, kAct>(g, y, row + 2 * (j + kCols)) : 0.0f;
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

// ×½: ∂out row i, columns j .. j + kCols - 1 of [planes, oh, ow] to ∂x
// rows 2i, 2i + 1, columns 2j .. 2j + 2 kCols - 1 of [planes, 2 oh, 2 ow].
template <typename T, int kCols, bool kAct>
__global__ void __launch_bounds__(kThreads)
resize_bilinear_grad_down2_kernel(const T* __restrict__ g, const T* __restrict__ y,
                                  T* __restrict__ dx, long long planes, int oh, int ow) {
  const Cell at(planes, oh, ow, kCols);
  if (!at.live) return;
  float v[kCols];
  load_pre<T, kCols, kAct>(g, y, (at.plane * oh + at.i) * ow + at.j, v);
  float res[2 * kCols];
#pragma unroll
  for (int e = 0; e < kCols; ++e)
    res[2 * e] = res[2 * e + 1] = add<T>(0.0f, rnd<T>(__fmul_rn(0.25f, v[e])));
  const long long o = (at.plane * 2 * oh + 2 * at.i) * 2 * ow + 2 * at.j;
  store_run<T, 2 * kCols>(dx + o, res);
  store_run<T, 2 * kCols>(dx + o + 2 * ow, res);
}

template <typename T, int kCols, bool kAct>
void launch_form(bool up, unsigned grid, cudaStream_t st, const T* g, const T* y, T* dx,
                 long long planes, int h, int w) {
  if (up)
    resize_bilinear_grad_up2_kernel<T, kCols, kAct><<<grid, kThreads, 0, st>>>(g, y, dx,
                                                                              planes, h, w);
  else
    resize_bilinear_grad_down2_kernel<T, kCols, kAct><<<grid, kThreads, 0, st>>>(
        g, y, dx, planes, h / 2, w / 2);
}

template <typename T, int kCols>
void launch_act(bool act, bool up, unsigned grid, cudaStream_t st, const T* g, const T* y,
                T* dx, long long planes, int h, int w) {
  if (act)
    launch_form<T, kCols, true>(up, grid, st, g, y, dx, planes, h, w);
  else
    launch_form<T, kCols, false>(up, grid, st, g, y, dx, planes, h, w);
}

template <typename T>
int launch(const void* g, const void* y, void* dx, long long planes, int h, int w, int up,
           int act, void* stream) {
  if (planes <= 0 || h <= 0 || w <= 0) return 0;
  if (!up && (h % 2 || w % 2)) return static_cast<int>(cudaErrorInvalidValue);
  // The run is along ∂x for ×2, along ∂out for ×½.
  const int along = up ? w : w / 2;
  const bool runs = along % kRun == 0 && aligned16(g) && aligned16(dx) && (!act || aligned16(y));
  const int cols = runs ? kRun : 1;
  const long long grid =
      up ? grid_of(planes, pairs_of(h), w, cols) : grid_of(planes, h / 2, w / 2, cols);
  if (grid == 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* gv = static_cast<const T*>(g);
  const T* yv = static_cast<const T*>(y);
  T* dv = static_cast<T*>(dx);
  const unsigned n = static_cast<unsigned>(grid);
  if (runs)
    launch_act<T, kRun>(act != 0, up != 0, n, st, gv, yv, dv, planes, h, w);
  else
    launch_act<T, 1>(act != 0, up != 0, n, st, gv, yv, dv, planes, h, w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dx: [planes, h, w]; g (and y, read where act is 1): [planes, 2h, 2w]
// where up is 1, [planes, h/2, w/2] where it is 0 (h and w even); all
// contiguous, of float32 (itermvs_resize_bilinear_grad) or bfloat16
// (_bf16). Returns the launch's error (0 on success).
extern "C" int itermvs_resize_bilinear_grad(const void* g, const void* y, void* dx,
                                            long long planes, int h, int w, int up, int act,
                                            void* stream) {
  return launch<float>(g, y, dx, planes, h, w, up, act, stream);
}

extern "C" int itermvs_resize_bilinear_grad_bf16(const void* g, const void* y, void* dx,
                                                 long long planes, int h, int w, int up,
                                                 int act, void* stream) {
  return launch<__nv_bfloat16>(g, y, dx, planes, h, w, up, act, stream);
}
