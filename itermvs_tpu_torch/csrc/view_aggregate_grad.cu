// K12 view_aggregate_grad: the backward of K11 view_aggregate. With
// g = dL/dout [B, n*G, P], S = 1e-5 + ((w_0 + w_1) + ...) and K11's
// output out:
//     dc_v = (g / S) * w_v                                    [B, n*G, P]
//     dw_v = sum over the n*G rows of (g / S) * (c_v - out)   [B, P]
// the second only where the weights need a gradient (kWeightGrad: the
// init branch, through PixelViewWeight; the iterations stop it).
//
// Replaces: the XLA autodiff of the fusions K11 replaces
// (itermvs_tpu/models/itermvs.py:251-252 in the init branch, 347-349 in
// the iterations; 297-298, 314-316 in the interleave branch).
//
// What bounds it on an H100: memory. It reads g and the weights (with dw
// also each view's correlation and out) and writes every view's dc (with
// dw also dw), a few operations per element. At a 640x512 batch-4
// training step the init call (256 rows, with dw) moves 210 MB and each
// iteration call (16-32 rows, 4 views, no dw) 27-54 MB. The first
// design, one thread per (view, 4 pixels) walking every row, re-formed S
// and re-read g in each view's thread, and its init call ran 20480
// threads (160 blocks on 132 SMs) walking 256 rows each: 0.34 of its
// bound.
//
// Design. A thread owns kVec neighbouring pixels (float4 where the
// launcher finds P % 4 == 0 and aligned pointers) of a group of up to
// kGroupViews views (the grid's y walks the groups) and some rows. It
// forms S once, as K11 does (view_aggregate.cuh), then per row loads g
// once, divides it by S once and writes each view's
// dc_v = __fmul_rn(__fdiv_rn(g, S), w_v): autograd's two rounded
// operations in its order, so bit-equal to view_aggregate_grad_plain.
// - Without dw (the iterations) a block is kWords words x 4 threads
//   along the rows and covers kChunkRows rows, kRows per thread, all of
//   a thread's loads of g issued before its first store; the grid's y
//   also walks the row chunks (640 blocks at the step's iteration calls).
// - With dw (the init call) a block is kDwWords words x 8 threads along
//   the rows and covers every row of its words, thread `slice` the rows
//   slice, slice + 8, ..., summing (g / S) (c_v - out) in row order in
//   registers; the 8 sums of a pixel meet in shared memory and are added
//   in slice order, and dw is written once. At the step's init call that
//   is 320 blocks, one wave at 128 registers a thread (4 blocks per SM);
//   8 words x 16 threads (640 blocks, 1.2 waves) took 8-9% longer. No
//   scratch, no second kernel, no atomics: two launches give the same
//   bits. dw is summed in another order than the plain version's
//   reduction.
// The kernel is a programmatic dependent launch (kProgrammatic): its
// blocks may start while the stream's previous kernel drains, and wait
// in cudaGridDependencySynchronize() before touching memory. Each view's
// dc is its own [B, n*G, P] block of one [V-1, B, n*G, P] output, so each
// view's sweep backward (K4, K5) reads it as it is.
#include <cuda_runtime.h>

#include "launch.cuh"
#include "view_aggregate.cuh"

namespace {

// Whether the kernel is a programmatic dependent launch; PERF.md §6 has
// the timings that chose it (and kDwWords, kRows).
constexpr bool kProgrammatic = true;
// The views a thread owns: the nv views in groups of this many.
constexpr int kGroupViews = 4;
// Without dw: words of P per block, rows per thread, rows per block.
constexpr int kWords = 32;
constexpr int kRows = 8;
constexpr int kChunkRows = kThreads / kWords * kRows;
// With dw: words of P per block (kThreads / kDwWords threads per word).
constexpr int kDwWords = 16;

template <int kVec, bool kWeightGrad>
__global__ void __launch_bounds__(kThreads)
view_aggregate_grad_kernel(const __grid_constant__ Views views,
                           const float* __restrict__ weights, const float* __restrict__ grad,
                           const float* __restrict__ out, float* __restrict__ d_corr,
                           float* __restrict__ d_weights, int nv, int rows, int p,
                           long long batch_stride) {
  constexpr int kBlockWords = kWeightGrad ? kDwWords : kWords;
  constexpr int kSlices = kThreads / kBlockWords;
  const int word = threadIdx.x % kBlockWords;
  const int slice = threadIdx.x / kBlockWords;
  const int q = (blockIdx.x * kBlockWords + word) * kVec;
  const int groups = (nv + kGroupViews - 1) / kGroupViews;
  const int v0 = blockIdx.y % groups * kGroupViews;
  const int nvg = min(kGroupViews, nv - v0);
  const int b = blockIdx.z;
  const long long pp = p;
  const long long view_stride = static_cast<long long>(gridDim.z) * rows * pp;
  const long long block = static_cast<long long>(b) * rows * pp + q;
  const float* w = weights + static_cast<long long>(b) * nv * pp + q;
  const float* g = grad + block;
  float* dc = d_corr + v0 * view_stride + block;
  // Until the stream's previous kernel has completed (at once where this
  // is an ordinary launch).
  cudaGridDependencySynchronize();

  if constexpr (!kWeightGrad) {
    if (q >= p) return;
    const int first = blockIdx.y / groups * kChunkRows;
    const int end = min(rows, first + kChunkRows);
    const Lane<kVec> s = weight_sum<kVec>(w, nv, pp);
    Lane<kVec> wv[kGroupViews];
#pragma unroll
    for (int j = 0; j < kGroupViews; ++j)
      if (j < nvg) wv[j].load(w + (v0 + j) * pp);
    Lane<kVec> gr[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int r = first + slice + k * kSlices;
      if (r < end) gr[k].load(g + r * pp);
    }
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int r = first + slice + k * kSlices;
      if (r >= end) continue;
#pragma unroll
      for (int e = 0; e < kVec; ++e) gr[k].v[e] = __fdiv_rn(gr[k].v[e], s.v[e]);
#pragma unroll
      for (int j = 0; j < kGroupViews; ++j) {
        if (j >= nvg) continue;
        Lane<kVec> d;
#pragma unroll
        for (int e = 0; e < kVec; ++e) d.v[e] = __fmul_rn(gr[k].v[e], wv[j].v[e]);
        d.store(dc + j * view_stride + r * pp);
      }
    }
  } else {
    __shared__ float sums[kSlices][kGroupViews][kBlockWords * kVec];
    float acc[kGroupViews][kVec];
#pragma unroll
    for (int j = 0; j < kGroupViews; ++j)
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[j][e] = 0.0f;
    if (q < p) {
      const Lane<kVec> s = weight_sum<kVec>(w, nv, pp);
      Lane<kVec> wv[kGroupViews];
      const float* c[kGroupViews];
#pragma unroll
      for (int j = 0; j < kGroupViews; ++j) {
        if (j >= nvg) continue;
        wv[j].load(w + (v0 + j) * pp);
        c[j] = views.corr[v0 + j] + b * batch_stride + q;
      }
      const float* o = out + block;
#pragma unroll 2
      for (int r = slice; r < rows; r += kSlices) {
        Lane<kVec> gr, ov, cv[kGroupViews];
        gr.load(g + r * pp);
        ov.load(o + r * pp);
#pragma unroll
        for (int j = 0; j < kGroupViews; ++j)
          if (j < nvg) cv[j].load(c[j] + r * pp);
        Lane<kVec> d[kGroupViews];
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const float gs = __fdiv_rn(gr.v[e], s.v[e]);
#pragma unroll
          for (int j = 0; j < kGroupViews; ++j) {
            if (j >= nvg) continue;
            d[j].v[e] = __fmul_rn(gs, wv[j].v[e]);
            acc[j][e] = __fadd_rn(acc[j][e], __fmul_rn(gs, __fsub_rn(cv[j].v[e], ov.v[e])));
          }
        }
#pragma unroll
        for (int j = 0; j < kGroupViews; ++j)
          if (j < nvg) d[j].store(dc + j * view_stride + r * pp);
      }
    }
#pragma unroll
    for (int j = 0; j < kGroupViews; ++j)
#pragma unroll
      for (int e = 0; e < kVec; ++e) sums[slice][j][word * kVec + e] = acc[j][e];
    __syncthreads();
    for (int t = threadIdx.x; t < kGroupViews * kBlockWords * kVec; t += kThreads) {
      const int j = t / (kBlockWords * kVec);
      const int k = t % (kBlockWords * kVec);
      const int px = blockIdx.x * kBlockWords * kVec + k;
      if (j >= nvg || px >= p) continue;
      float total = sums[0][j][k];
      for (int sl = 1; sl < kSlices; ++sl) total = __fadd_rn(total, sums[sl][j][k]);
      d_weights[(static_cast<long long>(b) * nv + v0 + j) * pp + px] = total;
    }
  }
}

template <int kVec>
cudaError_t launch(int batch, int rows, int p, bool weight_grad, cudaStream_t st,
                   const Views& views, const float* weights, const float* grad,
                   const float* out, float* d_corr, float* d_weights, int nv,
                   long long batch_stride) {
  const long long words = p / kVec;
  const int block_words = weight_grad ? kDwWords : kWords;
  const long long groups = (nv + kGroupViews - 1) / kGroupViews;
  const long long chunks = weight_grad ? 1 : (rows + kChunkRows - 1) / kChunkRows;
  if (chunks * groups > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>((words + block_words - 1) / block_words),
                  static_cast<unsigned>(chunks * groups), static_cast<unsigned>(batch));
  return launch_kernel(kProgrammatic,
                       weight_grad ? view_aggregate_grad_kernel<kVec, true>
                                   : view_aggregate_grad_kernel<kVec, false>,
                       grid, dim3(kThreads), st, views, weights, grad, out, d_corr, d_weights,
                       nv, rows, p, batch_stride);
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
  const Views views = weight_grad ? make_views(corr, nv) : Views{};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      vec4 ? launch<4>(batch, rows, p, weight_grad, st, views, weights, grad, out, d_corr,
                       d_weights, nv, batch_stride)
           : launch<1>(batch, rows, p, weight_grad, st, views, weights, grad, out, d_corr,
                       d_weights, nv, batch_stride));
}

// 1 where the kernel is a programmatic dependent launch, else 0.
extern "C" int itermvs_view_aggregate_grad_programmatic() { return kProgrammatic; }
