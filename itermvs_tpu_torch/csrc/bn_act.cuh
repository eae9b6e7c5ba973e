// What FeatureNet's BatchNorm epilogue K17 bn_act (bn_act.cu) and its
// backward K18 bn_act_grad (bn_act_grad.cu) share.
//
// The epilogue of a convolution's output y [N, C, H, W] has three forms:
//     kPlain       out = act(bn(y))                 (ConvBnReLU; a lone BN)
//     kResidual    out = act(bn(y) + skip)          (ResidualBlock, stride 1)
//     kDownsample  out = act(bn(y) + bn'(xd))       (ResidualBlock, stride 2)
// with act the ReLU or the identity, and bn flax's normalise:
//     mul = rsqrt(var + 1e-5) * w          (per channel, float32)
//     bn(y) = (y - mean) * mul + b         (float32, then rounded to T)
// The add and the ReLU run in the compute dtype T (float32 or bfloat16):
// each BN output is rounded to T first, as the plain version rounds it.
//
// Arithmetic: PyTorch's CUDA formulas in PyTorch's order, each operation
// rounded on its own: rsqrt is rsqrtf (PyTorch's ::rsqrt), the ReLU
// clamp_min's (NaN passes, else fmaxf(v, 0)) and its backward
// threshold_backward's (0 where out <= 0, else g).
//
// Blocking: a block owns one span of one (n, c) plane, so w, b, mean and
// var are scalars per block. The plane's H * W elements split into
// `spans` spans of `span` elements (a multiple of kVec); a thread walks
// its span in steps of kThreads words.
#pragma once

#include <cuda_runtime.h>

#include "elementwise.cuh"

namespace {

enum Form : int { kPlain = 0, kResidual = 1, kDownsample = 2 };

constexpr float kEps = 1e-5f;
// The elements of a span that the launchers aim at (ops/bn_act.py's SPAN).
constexpr long long kSpan = 4096;

// One BatchNorm's per-channel float32 vectors ([C] each; b unused by K18).
struct Channel {
  const float* w;
  const float* b;
  const float* mean;
  const float* var;
};

// rsqrt(var + eps) * w of channel c.
__device__ __forceinline__ float bn_mul(const Channel& ch, int c) {
  return __fmul_rn(rsqrtf(__fadd_rn(__ldg(ch.var + c), kEps)), __ldg(ch.w + c));
}

// (y - mean) * mul + b, rounded to T.
template <typename T>
__device__ __forceinline__ float normalise(float y, float mean, float mul, float b) {
  return rnd<T>(__fadd_rn(__fmul_rn(__fsub_rn(y, mean), mul), b));
}

__device__ __forceinline__ float relu(float v) { return isnan(v) ? v : fmaxf(v, 0.0f); }

// The span of `spans` over p elements, rounded up to whole words.
inline long long span_of(long long p, int spans, int vec) {
  const long long span = (p + spans - 1) / spans;
  return (span + vec - 1) / vec * vec;
}

// The block's plane and its span's [begin, end) in it.
struct Span {
  long long plane, begin, end;
  int channel;

  __device__ __forceinline__ Span(int channels, long long p, int spans, long long span) {
    plane = blockIdx.x / spans;
    channel = static_cast<int>(plane % channels);
    begin = (blockIdx.x - plane * spans) * span;
    end = min(p, begin + span);
  }
};

}  // namespace
