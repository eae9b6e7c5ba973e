// K31 view_weight_grad: the backward of K30 view_weight with respect to the
// logits x [planes, 32, h, w] in T (float32 or bfloat16), from ∂w
// [planes, h, w] float32, the gradient K12 gives the init sweep's view
// weights (K30's ×2 output carries none: the iterations read it
// detached). With p = softmax(float(x)) over the 32 samples, taken as K30
// takes it, and the samples where p equals its max (ties: k of them):
//     ∂p_d = ∂w / k at a tie, else 0        (amax's backward)
//     ∂x_d = p_d · (∂p_d − Σ_e ∂p_e · p_e)  (softmax's)
// in float64, rounded once to T (the bfloat16 cast's backward rounds
// there too).
//
// Replaces: the autodiff of the XLA fusion K30 replaces
// (itermvs_tpu/models/itermvs.py:154-155: JAX's max splits its gradient
// evenly over the ties). In the port: amax's backward (eq, sum, div, mul),
// PyTorch's softmax backward (a product, then its spatial kernel) and,
// in bfloat16, the cast's, each through device memory.
//
// What bounds it on an H100: memory. It reads x and ∂w once and writes ∂x
// once; per pixel 32 expf and quotients, and 64 float64 multiply-adds.
//
// Design: a thread per pixel. It recomputes the pixel's softmax with K30's
// code (sample_softmax.cuh), so it counts ties on the very p values K30's
// max was taken over (a tie is common: where a source view does not see
// a pixel its 32 logits are equal, p = 1/32 everywhere, and ∂w splits 32
// ways), then evaluates the backward in float64 from those p, which
// leaves no cancellation in ∂p_d − Σ for a peaked softmax. A warp's
// pixels are neighbours, so each sample's loads and stores are contiguous.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sample_softmax.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(kThreads)
view_weight_grad_kernel(const float* __restrict__ d_w, const T* __restrict__ x,
                        T* __restrict__ d_x, long long pixels, long long hw) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= pixels) return;
  const long long plane = t / hw;
  const long long base = plane * kSamples * hw + (t - plane * hw);
  const SampleSoftmax sm(x + base, hw);
  float p[kSamples];
  float best = sm.p(0);
#pragma unroll
  for (int d = 0; d < kSamples; ++d) {
    p[d] = sm.p(d);
    best = fmaxf(best, p[d]);
  }
  int ties = 0;
#pragma unroll
  for (int d = 0; d < kSamples; ++d) ties += p[d] == best;
  const double g = static_cast<double>(__ldg(d_w + t)) / ties;
  double dot = 0.0;
#pragma unroll
  for (int d = 0; d < kSamples; ++d)
    if (p[d] == best) dot = __fma_rn(g, static_cast<double>(p[d]), dot);
#pragma unroll
  for (int d = 0; d < kSamples; ++d) {
    const double gd = p[d] == best ? g : 0.0;
    store_one(d_x + base + d * hw,
              round_to<T>(__dmul_rn(static_cast<double>(p[d]), __dsub_rn(gd, dot))));
  }
}

template <typename T>
int launch(const void* d_w, const void* x, void* d_x, long long planes, int h, int wd,
           void* stream) {
  const long long hw = static_cast<long long>(h) * wd, pixels = planes * hw;
  if (pixels <= 0) return 0;
  const long long grid = (pixels + kThreads - 1) / kThreads;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  view_weight_grad_kernel<T><<<static_cast<unsigned>(grid), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(d_w), static_cast<const T*>(x), static_cast<T*>(d_x), pixels,
      hw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// d_w: [planes, h, w] float32; x, d_x: [planes, 32, h, w] of float32
// (itermvs_view_weight_grad) or bfloat16 (_bf16); all contiguous. Returns
// the launch's error (0 on success).
extern "C" int itermvs_view_weight_grad(const void* d_w, const void* x, void* d_x,
                                        long long planes, int h, int wd, void* stream) {
  return launch<float>(d_w, x, d_x, planes, h, wd, stream);
}

extern "C" int itermvs_view_weight_grad_bf16(const void* d_w, const void* x, void* d_x,
                                             long long planes, int h, int wd, void* stream) {
  return launch<__nv_bfloat16>(d_w, x, d_x, planes, h, wd, stream);
}
