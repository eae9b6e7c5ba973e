// K33 init_depth_grad: the backward of K32 init_depth with respect to the
// score s [batch, 32, h, w] float32, from ∂out [batch, 1, 2h, 2w] float32
// (the loss's gradient of the init depth, K24's ∂initial). The bounds
// carry no gradient. Per pixel of s's plane:
//     g     = ×2 resize's backward of ∂out          (rounded to float32)
//     ∂e    = −g · depth² · (idmin − idmax) / 31
//     ∂s_d  = p_d · ∂e · (d − Σ_k k · p_k)
// with p, depth and the scale as K32 computes them (the reciprocal's,
// the unnormalization's and the product's backward, then the
// expectation's and the softmax's), in float64 from g on, rounded once
// to float32.
//
// Replaces: the autodiff of the XLA fusions K32 replaces
// (itermvs_tpu/models/itermvs.py:257-266). In the port: K29
// resize_bilinear_grad at this site, then the eager chain's backward (the
// reciprocal's, the products', the sum's and the softmax's), each a
// launch through device memory.
//
// What bounds it on an H100: memory. It reads ∂out and s once and writes
// ∂s once; per pixel the 16 float64 multiply-adds of the gather, 32 expf
// and quotients, and some 100 float64 operations.
//
// Design: a thread per pixel of s's plane. It gathers g from its 4 x 4
// window of ∂out as K29 does (sample_softmax.cuh `gather_up2`: the same
// float64 order, so g is the value K29 wrote at this site), recomputes
// the pixel's softmax and depth with K32's code, then evaluates the
// backward in float64, where d − Σ_k k · p_k leaves no cancellation to
// speak of. A warp's pixels are neighbours, so each sample's loads and
// stores are contiguous.
#include <cuda_runtime.h>

#include "sample_softmax.cuh"

namespace {

__global__ void __launch_bounds__(kThreads)
init_depth_grad_kernel(const float* __restrict__ g, const float* __restrict__ s,
                       const float* __restrict__ idmin, const float* __restrict__ idmax,
                       float* __restrict__ d_s, long long pixels, int h, int wd) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= pixels) return;
  const long long hw = static_cast<long long>(h) * wd;
  const long long b = t / hw, q = t - b * hw;
  const int i = static_cast<int>(q / wd), j = static_cast<int>(q - static_cast<long long>(i) * wd);
  const double grad = gather_up2(g + b * 4 * hw, i, j, h, wd);
  const long long base = b * kSamples * hw + q;
  const SampleSoftmax sm(s + base, hw);
  float p[kSamples];
#pragma unroll
  for (int d = 0; d < kSamples; ++d) p[d] = sm.p(d);
  const float hi = __ldg(idmax + b), diff = __fsub_rn(__ldg(idmin + b), hi);
  const double depth = init_depth_of(expectation(p), hi, diff);
  const double d_e = __dmul_rn(__dmul_rn(__dmul_rn(-grad, __dmul_rn(depth, depth)),
                                         static_cast<double>(diff)),
                               static_cast<double>(kIndexScale));
  double mean = 0.0;
#pragma unroll
  for (int d = 0; d < kSamples; ++d)
    mean = __fma_rn(static_cast<double>(d), static_cast<double>(p[d]), mean);
#pragma unroll
  for (int d = 0; d < kSamples; ++d)
    d_s[base + d * hw] = __double2float_rn(__dmul_rn(
        static_cast<double>(p[d]), __dmul_rn(d_e, __dsub_rn(static_cast<double>(d), mean))));
}

}  // namespace

// g: [batch, 1, 2h, 2w]; s, d_s: [batch, 32, h, w]; idmin, idmax: [batch];
// float32, contiguous. Returns the launch's error (0 on success).
extern "C" int itermvs_init_depth_grad(const void* g, const void* s, const void* idmin,
                                       const void* idmax, void* d_s, long long batch, int h,
                                       int wd, void* stream) {
  const long long pixels = batch * h * static_cast<long long>(wd);
  if (pixels <= 0) return 0;
  const long long grid = (pixels + kThreads - 1) / kThreads;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  init_depth_grad_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const float*>(s),
      static_cast<const float*>(idmin), static_cast<const float*>(idmax),
      static_cast<float*>(d_s), pixels, h, wd);
  return static_cast<int>(cudaGetLastError());
}
