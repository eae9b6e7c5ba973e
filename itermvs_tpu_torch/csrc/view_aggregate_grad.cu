// K12 view_aggregate_grad: the backward of K11 view_aggregate. With
// g = dL/dout [B, n*G, P], S = 1e-5 + ((w_0 + w_1) + ...) and K11's
// output out:
//     dc_v = (g / S) * w_v                                 [B, n*G, P]
//     dw_v = sum over the n*G rows of (g / S) * (c_v - out)   [B, P]
// the second only where the weights need a gradient (kWeightGrad: the
// init branch, through PixelViewWeight; the iterations stop it).
//
// Replaces: the XLA autodiff of the fusions K11 replaces
// (itermvs_tpu/models/itermvs.py:251-252, 347-349).
//
// What bounds it on an H100: memory. It reads g, the weights and, with
// dw, each view's correlation and out; it writes each view's dc (and
// dw), with a few operations per element.
//
// Design: a thread owns kVec neighbouring pixels (float4 where the
// launcher finds P % 4 == 0 and aligned pointers) of one view v and
// batch row b (threads along P, v and b on the grid's y and z), forms S
// as K11 does (view_aggregate.cuh), then walks the n*G rows in order:
// g / S, its product with w_v into dc_v, and with dw the product with
// c_v - out summed in registers. No atomics, so the result is the same
// from launch to launch; dc_v is rounded as autograd of the plain
// forward rounds it (__fdiv_rn, then __fmul_rn), so bit-equal to
// view_aggregate_grad_plain, and dw is summed in another order than the
// plain version's reduction. Each view's dc is its own [B, n*G, P] block
// of one [V-1, B, n*G, P] output, so each view's sweep backward (K4, K5)
// reads it as it is. g and out are read once per view, the repeats from
// L2.
#include <cuda_runtime.h>

#include "view_aggregate.cuh"

namespace {

template <int kVec, bool kWeightGrad>
__global__ void __launch_bounds__(kThreads)
view_aggregate_grad_kernel(const __grid_constant__ Views views,
                           const float* __restrict__ weights, const float* __restrict__ grad,
                           const float* __restrict__ out, float* __restrict__ d_corr,
                           float* __restrict__ d_weights, int nv, int rows, int p,
                           long long batch_stride) {
  const int q = (blockIdx.x * kThreads + threadIdx.x) * kVec;
  if (q >= p) return;
  const int v = blockIdx.y;
  const int b = blockIdx.z;
  const long long pp = p;
  const float* w = weights + static_cast<long long>(b) * nv * pp + q;
  const Lane<kVec> s = weight_sum<kVec>(w, nv, pp);
  Lane<kVec> wv;
  wv.load(w + v * pp);

  const long long block = (static_cast<long long>(b) * rows) * pp + q;
  const float* g = grad + block;
  float* dc = d_corr + static_cast<long long>(v) * gridDim.z * rows * pp + block;
  const float* c = nullptr;
  const float* o = nullptr;
  float acc[kVec];
  if constexpr (kWeightGrad) {
    c = views.corr[v] + b * batch_stride + q;
    o = out + block;
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[e] = 0.0f;
  }
#pragma unroll 4
  for (int r = 0; r < rows; ++r) {
    Lane<kVec> gs;
    gs.load(g + r * pp);
    Lane<kVec> cv, ov;
    if constexpr (kWeightGrad) {
      cv.load(c + r * pp);
      ov.load(o + r * pp);
    }
    Lane<kVec> d;
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      gs.v[e] = __fdiv_rn(gs.v[e], s.v[e]);
      d.v[e] = __fmul_rn(gs.v[e], wv.v[e]);
      if constexpr (kWeightGrad)
        acc[e] = __fadd_rn(acc[e], __fmul_rn(gs.v[e], __fsub_rn(cv.v[e], ov.v[e])));
    }
    d.store(dc + r * pp);
  }
  if constexpr (kWeightGrad) {
    Lane<kVec> dw;
#pragma unroll
    for (int e = 0; e < kVec; ++e) dw.v[e] = acc[e];
    dw.store(d_weights + (static_cast<long long>(b) * nv + v) * pp + q);
  }
}

template <int kVec>
void launch(dim3 grid, cudaStream_t st, const Views& views, const float* weights,
            const float* grad, const float* out, float* d_corr, float* d_weights, int nv,
            int rows, int p, long long batch_stride) {
  if (d_weights != nullptr)
    view_aggregate_grad_kernel<kVec, true><<<grid, kThreads, 0, st>>>(
        views, weights, grad, out, d_corr, d_weights, nv, rows, p, batch_stride);
  else
    view_aggregate_grad_kernel<kVec, false><<<grid, kThreads, 0, st>>>(
        views, weights, grad, out, d_corr, d_weights, nv, rows, p, batch_stride);
}

}  // namespace

// weights: [batch, nv, p], grad: [batch, rows, p], float32 contiguous.
// d_corr: [nv, batch, rows, p] float32. With d_weights [batch, nv, p]
// (not null), also dw, which reads corr (nv host-side pointers to the
// views' [batch, rows, p] correlations, rows p apart, batch rows
// batch_stride apart) and out ([batch, rows, p], K11's output); without
// it corr and out are not read (corr may be null). 1 <= nv <= 256.
// Returns the launch's error (0 on success).
extern "C" int itermvs_view_aggregate_grad(const void* const* corr, int nv,
                                           const float* weights, const float* grad,
                                           const float* out, float* d_corr,
                                           float* d_weights, int batch, int rows, int p,
                                           long long batch_stride, void* stream) {
  if (batch <= 0 || rows <= 0 || p <= 0) return 0;
  if (nv < 1 || nv > kMaxViews || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool weight_grad = d_weights != nullptr;
  if (weight_grad && (corr == nullptr || out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  bool vec4 = p % 4 == 0 && aligned16(weights) && aligned16(grad) && aligned16(d_corr);
  if (weight_grad)
    vec4 = vec4 && views_vec4(corr, nv, p, batch_stride) && aligned16(out) &&
           aligned16(d_weights);
  const int vec = vec4 ? 4 : 1;
  const dim3 grid(static_cast<unsigned>((p / vec + kThreads - 1) / kThreads),
                  static_cast<unsigned>(nv), static_cast<unsigned>(batch));
  const Views views = weight_grad ? make_views(corr, nv) : Views{};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec4)
    launch<4>(grid, st, views, weights, grad, out, d_corr, d_weights, nv, rows, p,
              batch_stride);
  else
    launch<1>(grid, st, views, weights, grad, out, d_corr, d_weights, nv, rows, p,
              batch_stride);
  return static_cast<int>(cudaGetLastError());
}
