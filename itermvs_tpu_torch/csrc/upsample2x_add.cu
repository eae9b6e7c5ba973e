// K19 upsample2x_add: FeatureNet's FPN top-down add, the ×2 bilinear
// upsample of x [planes, h, w] (F.interpolate, align_corners=False) plus
// the lateral l [planes, 2h, 2w], in the compute dtype T (float32 or
// bfloat16), NCHW:
//     out = round_T(round_T(up2(x)) + l)
//
// Replaces: the XLA fusion of the resize's two interpolation-matrix
// contractions (itermvs_tpu/ops/resize.py:40-56) and the add at
// itermvs_tpu/models/feature_net.py:98-102. In the port: F.interpolate
// (PyTorch's upsample_bilinear2d_out_frame) and an eager add, two launches
// and the upsampled map written and read back once.
//
// What bounds it on an H100: memory. It reads x and l once and writes out
// once (9 elements per element of x), with 10 operations per output.
//
// Design (upsample2x.cuh): a thread per kCols neighbouring columns of one
// row i of x; it loads rows i - 1, i, i + 1 (clamped) at columns j - 1 ..
// j + kCols (clamped) and writes output rows 2i and 2i + 1 at columns 2j ..
// 2j + 2 kCols - 1, reading l there; the upsampled values never reach
// device memory. Each output is PyTorch's CUDA formula with its own two
// source rows and columns and weights in {0, 1/4, 3/4, 1}, the clamped
// neighbour and its weight 0 included:
//     h0 * (w0 * x00 + w1 * x01) + h1 * (w0 * x10 + w1 * x11)
// contracted into FMAs as PyTorch's build contracts it (a card probe
// compared every contraction of the formula with F.interpolate: `bilinear`
// below is the one that matched bit for bit in both dtypes), rounded to
// T, then the add in float32, rounded to T. So the output is bit-equal to
// upsample2x_add_plain on the card.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "upsample2x.cuh"

namespace {

// PyTorch's upsample_bilinear2d_out_frame formula, as its build contracts
// it: a * x + b * y as fma(a, x, b * y), inside and out.
__device__ __forceinline__ float bilinear(float h0, float h1, float w0, float w1, float x00,
                                          float x01, float x10, float x11) {
  const float top = __fmaf_rn(w0, x00, __fmul_rn(w1, x01));
  const float bottom = __fmaf_rn(w0, x10, __fmul_rn(w1, x11));
  return __fmaf_rn(h0, top, __fmul_rn(h1, bottom));
}

template <typename T, int kCols>
__global__ void __launch_bounds__(kThreads)
upsample2x_add_kernel(const T* __restrict__ x, const T* __restrict__ lat, T* __restrict__ out,
                      long long planes, int h, int w) {
  const Cell at(planes, h, w, kCols);
  if (!at.live) return;
  const int i = at.i, j = at.j;
  // v[r][e]: x at row i - 1 + r and column j - 1 + e, both clamped.
  float v[3][kCols + 2];
  const T* xp = x + at.plane * h * w;
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
    const long long o = (at.plane * 2 * h + 2 * i + a) * ow + 2 * j;
    float res[2 * kCols];
    load_run<T, 2 * kCols>(lat + o, res);
#pragma unroll
    for (int e = 0; e < kCols; ++e) {
      const int c = e + 1;  // column j + e in v
      const float t0 = up ? v[0][c - 1] : v[1][c - 1], t1 = up ? v[0][c] : v[1][c],
                  t2 = up ? v[0][c + 1] : v[1][c + 1];
      const float b0 = up ? v[1][c - 1] : v[2][c - 1], b1 = up ? v[1][c] : v[2][c],
                  b2 = up ? v[1][c + 1] : v[2][c + 1];
      // Output column 2(j + e): columns (j + e - 1, j + e) with (1/4, 3/4),
      // at column 0 (0, min(1, w - 1)) with (1, 0).
      const bool left = j + e > 0;
      const float even = left ? bilinear(h0, h1, 0.25f, 0.75f, t0, t1, b0, b1)
                              : bilinear(h0, h1, 1.0f, 0.0f, t1, t2, b1, b2);
      // Output column 2(j + e) + 1: columns (j + e, min(j + e + 1, w - 1))
      // with (3/4, 1/4).
      const float odd = bilinear(h0, h1, 0.75f, 0.25f, t1, t2, b1, b2);
      res[2 * e] = add<T>(rnd<T>(even), res[2 * e]);
      res[2 * e + 1] = add<T>(rnd<T>(odd), res[2 * e + 1]);
    }
    store_run<T, 2 * kCols>(out + o, res);
  }
}

template <typename T>
int launch(const void* x, const void* lat, void* out, long long planes, int h, int w,
           void* stream) {
  if (planes <= 0 || h <= 0 || w <= 0) return 0;
  const bool runs = w % kRun == 0 && aligned16(x) && aligned16(lat) && aligned16(out);
  const int cols = runs ? kRun : 1;
  const long long grid = grid_of(planes, h, w, cols);
  if (grid == 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* xv = static_cast<const T*>(x);
  const T* lv = static_cast<const T*>(lat);
  T* ov = static_cast<T*>(out);
  if (runs)
    upsample2x_add_kernel<T, kRun><<<static_cast<unsigned>(grid), kThreads, 0, st>>>(
        xv, lv, ov, planes, h, w);
  else
    upsample2x_add_kernel<T, 1><<<static_cast<unsigned>(grid), kThreads, 0, st>>>(
        xv, lv, ov, planes, h, w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: [planes, h, w], lateral and out: [planes, 2h, 2w], contiguous, of
// float32 (itermvs_upsample2x_add) or bfloat16 (_bf16). Returns the
// launch's error (0 on success).
extern "C" int itermvs_upsample2x_add(const void* x, const void* lateral, void* out,
                                      long long planes, int h, int w, void* stream) {
  return launch<float>(x, lateral, out, planes, h, w, stream);
}

extern "C" int itermvs_upsample2x_add_bf16(const void* x, const void* lateral, void* out,
                                           long long planes, int h, int w, void* stream) {
  return launch<__nv_bfloat16>(x, lateral, out, planes, h, w, stream);
}
