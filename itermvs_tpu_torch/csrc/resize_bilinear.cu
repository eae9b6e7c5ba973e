// K28 resize_bilinear: the model's bilinear resizes outside FeatureNet,
// F.interpolate(x, size=(oh, ow), mode="bilinear", align_corners=False)
// of x [n, c, ih, iw] in T (float32 or bfloat16), NCHW, each batch entry
// contiguous and `batch_stride` elements after the one before (the
// reference view's slice of FeatureNet's [n, views, c, ih, iw] output is
// read where it lies), out [n, c, oh, ow] contiguous, with an optional
// tanh after it:
//     out = round_T(resize(x))                  (act = 0)
//     out = round_T(tanhf(round_T(resize(x))))  (act = 1)
//
// Replaces: the XLA fusions of the resize's two interpolation-matrix
// contractions (itermvs_tpu/ops/resize.py:41-56) at the init sweep's view
// weights and depth (itermvs_tpu/models/itermvs.py:255, 266), the hidden
// state's ×2 resize and tanh (:394-395), the reference features on the
// 1/4 grid (:524, 527) and the confidence's ×4 resize (:578, 590). In the
// port: F.interpolate (PyTorch's upsample_bilinear2d_out_frame) and, for
// the hidden state, an eager tanh, which wrote the resized map and read
// it back.
//
// What bounds it on an H100: memory. It reads x once and writes out once;
// each output is 6 multiplies and 3 adds (plus tanhf).
//
// Design: a thread per kCols neighbouring output columns of one output
// row (kCols = kRun where ow is a multiple of kRun and both pointers are
// 16-byte aligned, stored as one word: float4, or four bfloat16 in a
// uint2; else 1). Each output is PyTorch's CUDA formula, its source row
// and column from the float scale in/out:
//     src = max(scale * (dst + 0.5) - 0.5, 0), i0 = (int)src,
//     i1 = i0 + (i0 < in - 1), l1 = src - i0, l0 = 1 - l1
//     h0 * (w0 * x[i0][j0] + w1 * x[i0][j1]) + h1 * (w0 * x[i1][j0] + w1 * x[i1][j1])
// contracted into FMAs as PyTorch's build contracts it (`bilinear`, the
// contraction K19 found bit-equal on the card), so the output is bit-equal
// to F.interpolate there; the tanh is tanhf, PyTorch's. Two ratios on the
// run path have forms of their own:
//   ×½ (the reference features of level 1): a thread's 2 kCols source
//     columns are whole words and are loaded as such (load_run);
//   ×2 (the view weights, the init depth, the hidden state, the level-3
//     reference features): K19's layout (upsample2x_add.cu) without the
//     lateral, a thread per kCols columns of one row of x, loading rows
//     i - 1 .. i + 1 once and writing output rows 2i and 2i + 1, whose
//     weights in {0, 1/4, 3/4, 1} are the formula's at ×2.
// Elsewhere the four taps of each output are scalar loads, which
// neighbouring outputs share through L1.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "conv_gru.cuh"
#include "upsample2x.cuh"

namespace {

// One output index's two source indices and weights along an axis of
// `in` samples (PyTorch's area_pixel_compute_source_index, its
// `scale * (dst + 0.5) - 0.5` contracted into one FMA).
struct Taps {
  int i0, i1;
  float l0, l1;

  __device__ __forceinline__ Taps(float scale, int dst, int in) {
    const float src = fmaxf(__fmaf_rn(scale, __fadd_rn(static_cast<float>(dst), 0.5f), -0.5f),
                            0.0f);
    i0 = static_cast<int>(src);
    i1 = i0 + (i0 < in - 1 ? 1 : 0);
    l1 = __fsub_rn(src, static_cast<float>(i0));
    l0 = __fsub_rn(1.0f, l1);
  }
};

// kHalf: iw == 2 ow and ih == 2 oh, each source run whole words.
template <typename T, int kCols, bool kHalf, bool kAct>
__global__ void __launch_bounds__(kThreads)
resize_bilinear_kernel(const T* __restrict__ x, T* __restrict__ out, long long planes, int c,
                       long long batch_stride, int ih, int iw, int oh, int ow, float scale_h,
                       float scale_w) {
  const Cell at(planes, oh, ow, kCols);
  if (!at.live) return;
  const Taps rows(scale_h, at.i, ih);
  const T* xp = x + at.plane / c * batch_stride + at.plane % c * ih * iw;
  const T* top = xp + static_cast<long long>(rows.i0) * iw;
  const T* bottom = xp + static_cast<long long>(rows.i1) * iw;
  float res[kCols];
  if constexpr (kHalf) {
    // Output column j reads source columns 2j and 2j + 1 (weights 1/2).
    float a[2 * kCols], b[2 * kCols];
    load_run<T, 2 * kCols>(top + 2 * at.j, a);
    load_run<T, 2 * kCols>(bottom + 2 * at.j, b);
#pragma unroll
    for (int e = 0; e < kCols; ++e) {
      const Taps cols(scale_w, at.j + e, iw);
      res[e] = bilinear(rows.l0, rows.l1, cols.l0, cols.l1, a[2 * e], a[2 * e + 1], b[2 * e],
                        b[2 * e + 1]);
    }
  } else {
#pragma unroll
    for (int e = 0; e < kCols; ++e) {
      const Taps cols(scale_w, at.j + e, iw);
      res[e] = bilinear(rows.l0, rows.l1, cols.l0, cols.l1, tap_float(__ldg(top + cols.i0)),
                        tap_float(__ldg(top + cols.i1)), tap_float(__ldg(bottom + cols.i0)),
                        tap_float(__ldg(bottom + cols.i1)));
    }
  }
#pragma unroll
  for (int e = 0; e < kCols; ++e) {
    res[e] = rnd<T>(res[e]);
    if constexpr (kAct) res[e] = tanh_<T>(res[e]);
  }
  store_run<T, kCols>(out + (at.plane * oh + at.i) * ow + at.j, res);
}

// ×2: rows i - 1 .. i + 1 (clamped) of x at columns j - 1 .. j + kCols
// (clamped) give output rows 2i, 2i + 1 at columns 2j .. 2j + 2 kCols - 1.
template <typename T, int kCols, bool kAct>
__global__ void __launch_bounds__(kThreads)
resize_bilinear_up2_kernel(const T* __restrict__ x, T* __restrict__ out, long long planes, int c,
                           long long batch_stride, int h, int w) {
  const Cell at(planes, h, w, kCols);
  if (!at.live) return;
  const int i = at.i, j = at.j;
  float v[3][kCols + 2];
  const T* xp = x + at.plane / c * batch_stride + at.plane % c * h * w;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const T* row = xp + static_cast<long long>(min(max(i - 1 + r, 0), h - 1)) * w;
    v[r][0] = tap_float(__ldg(row + max(j - 1, 0)));
    load_run<T, kCols>(row + j, &v[r][1]);
    v[r][kCols + 1] = tap_float(__ldg(row + min(j + kCols, w - 1)));
  }
  const int ow = 2 * w;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    // Output row 2i + a: rows (i - 1, i) with (1/4, 3/4) for a = 0 but at
    // row 0, (0, min(1, h - 1)) with (1, 0); rows (i, min(i + 1, h - 1))
    // with (3/4, 1/4) for a = 1.
    const bool up = a == 0 && i > 0;
    const float h0 = a ? 0.75f : (i > 0 ? 0.25f : 1.0f);
    const float h1 = a ? 0.25f : (i > 0 ? 0.75f : 0.0f);
    float res[2 * kCols];
#pragma unroll
    for (int e = 0; e < kCols; ++e) {
      const int k = e + 1;  // column j + e in v
      const float t0 = up ? v[0][k - 1] : v[1][k - 1], t1 = up ? v[0][k] : v[1][k],
                  t2 = up ? v[0][k + 1] : v[1][k + 1];
      const float b0 = up ? v[1][k - 1] : v[2][k - 1], b1 = up ? v[1][k] : v[2][k],
                  b2 = up ? v[1][k + 1] : v[2][k + 1];
      // Output column 2(j + e): columns (j + e - 1, j + e) with (1/4, 3/4),
      // at column 0 (0, min(1, w - 1)) with (1, 0); column 2(j + e) + 1:
      // (j + e, min(j + e + 1, w - 1)) with (3/4, 1/4).
      res[2 * e] = j + e > 0 ? bilinear(h0, h1, 0.25f, 0.75f, t0, t1, b0, b1)
                             : bilinear(h0, h1, 1.0f, 0.0f, t1, t2, b1, b2);
      res[2 * e + 1] = bilinear(h0, h1, 0.75f, 0.25f, t1, t2, b1, b2);
    }
#pragma unroll
    for (int e = 0; e < 2 * kCols; ++e) {
      res[e] = rnd<T>(res[e]);
      if constexpr (kAct) res[e] = tanh_<T>(res[e]);
    }
    store_run<T, 2 * kCols>(out + (at.plane * 2 * h + 2 * i + a) * ow + 2 * j, res);
  }
}

template <typename T, int kCols, bool kHalf>
void launch_form(bool act, unsigned grid, cudaStream_t st, const T* x, T* out,
                 long long planes, int c, long long bs, int ih, int iw, int oh, int ow, float sh,
                 float sw) {
  if (act)
    resize_bilinear_kernel<T, kCols, kHalf, true><<<grid, kThreads, 0, st>>>(
        x, out, planes, c, bs, ih, iw, oh, ow, sh, sw);
  else
    resize_bilinear_kernel<T, kCols, kHalf, false><<<grid, kThreads, 0, st>>>(
        x, out, planes, c, bs, ih, iw, oh, ow, sh, sw);
}

template <typename T>
int launch(const void* x, void* out, long long n, int c, long long batch_stride, int ih, int iw,
           int oh, int ow, int act, void* stream) {
  const long long planes = n * c;
  if (planes <= 0 || oh <= 0 || ow <= 0) return 0;
  if (ih <= 0 || iw <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool runs = ow % kRun == 0 && aligned16(x) && aligned16(out);
  // The word loads need every source row 16-byte aligned.
  const bool rows16 = batch_stride * static_cast<long long>(sizeof(T)) % 16 == 0;
  const bool half = runs && iw == 2 * ow && ih == 2 * oh && rows16;
  const bool up2 = ow == 2 * iw && oh == 2 * ih && iw % kRun == 0 && aligned16(x) &&
                   aligned16(out) && rows16;
  const int cols = runs ? kRun : 1;
  const long long grid = up2 ? grid_of(planes, ih, iw, kRun) : grid_of(planes, oh, ow, cols);
  if (grid == 0) return static_cast<int>(cudaErrorInvalidValue);
  // PyTorch's scale: the float quotient in / out.
  const float sh = static_cast<float>(ih) / static_cast<float>(oh);
  const float sw = static_cast<float>(iw) / static_cast<float>(ow);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* xv = static_cast<const T*>(x);
  T* ov = static_cast<T*>(out);
  const unsigned g = static_cast<unsigned>(grid);
  const long long bs = batch_stride;
  if (up2 && act)
    resize_bilinear_up2_kernel<T, kRun, true><<<g, kThreads, 0, st>>>(xv, ov, planes, c, bs, ih,
                                                                      iw);
  else if (up2)
    resize_bilinear_up2_kernel<T, kRun, false><<<g, kThreads, 0, st>>>(xv, ov, planes, c, bs,
                                                                       ih, iw);
  else if (half)
    launch_form<T, kRun, true>(act != 0, g, st, xv, ov, planes, c, bs, ih, iw, oh, ow, sh, sw);
  else if (runs)
    launch_form<T, kRun, false>(act != 0, g, st, xv, ov, planes, c, bs, ih, iw, oh, ow, sh, sw);
  else
    launch_form<T, 1, false>(act != 0, g, st, xv, ov, planes, c, bs, ih, iw, oh, ow, sh, sw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: [n, c, ih, iw], each batch entry contiguous, batch_stride elements
// apart; out: [n, c, oh, ow], contiguous; of float32
// (itermvs_resize_bilinear) or bfloat16 (_bf16); act 1 takes tanh of the
// resized value. Returns the launch's error (0 on success).
extern "C" int itermvs_resize_bilinear(const void* x, void* out, long long n, int c,
                                       long long batch_stride, int ih, int iw, int oh, int ow,
                                       int act, void* stream) {
  return launch<float>(x, out, n, c, batch_stride, ih, iw, oh, ow, act, stream);
}

extern "C" int itermvs_resize_bilinear_bf16(const void* x, void* out, long long n, int c,
                                            long long batch_stride, int ih, int iw, int oh,
                                            int ow, int act, void* stream) {
  return launch<__nv_bfloat16>(x, out, n, c, batch_stride, ih, iw, oh, ow, act, stream);
}
