// K17 bn_act: FeatureNet's BatchNorm epilogue (bn_act.cuh gives its
// three forms and their arithmetic): a convolution's output y, flax's
// normalise with the per-channel w, b, mean and var as the module holds
// them (the running statistics in eval, the batch's in training), then
// the residual add and the ReLU, in the compute dtype (float32 or
// bfloat16), NCHW.
//
// Replaces: the XLA fusion, one per convolution, of flax's BatchNorm
// normalise, its cast to the compute dtype, the ReLU and the residual
// add at itermvs_tpu/models/blocks.py:90-120 and :152-165 (nn.relu(x +
// y) at :165). In the port: x.float(), cuDNN's batch norm, the cast
// back, then an eager add and ReLU, up to five launches per call.
//
// What bounds it on an H100: memory. It reads y (and the skip) and writes
// the output, with 4 to 8 operations per element.
//
// Design: a block per span of an (n, c) plane (bn_act.cuh), a thread per
// 16-byte word of each tensor where H * W is a multiple of the word's
// elements and every pointer is aligned; else one element. The bfloat16
// input converts to float32 in registers. Every operation is rounded as
// the plain version rounds it, so the output is bit-equal to
// bn_act_plain on the card.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bn_act.cuh"

namespace {

template <typename T, int kForm, bool kRelu, int kVec>
__global__ void __launch_bounds__(kThreads)
bn_act_kernel(const T* __restrict__ y, const T* __restrict__ skip, T* __restrict__ out,
              Channel a, Channel d, int channels, long long p, int spans, long long span) {
  const Span at(channels, p, spans, span);
  const float mul = bn_mul(a, at.channel);
  const float mean = __ldg(a.mean + at.channel), bias = __ldg(a.b + at.channel);
  float mul2 = 0.0f, mean2 = 0.0f, bias2 = 0.0f;
  if constexpr (kForm == kDownsample) {
    mul2 = bn_mul(d, at.channel);
    mean2 = __ldg(d.mean + at.channel);
    bias2 = __ldg(d.b + at.channel);
  }
  const long long base = at.plane * p;
#pragma unroll 4
  for (long long i = at.begin + threadIdx.x * kVec; i < at.end; i += kThreads * kVec) {
    Lanes<T, kVec> v, k;
    v.load(y + base + i);
    if constexpr (kForm != kPlain) k.load(skip + base + i);
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      float t = normalise<T>(v.v[e], mean, mul, bias);
      if constexpr (kForm == kResidual) t = add<T>(t, k.v[e]);
      if constexpr (kForm == kDownsample) t = add<T>(t, normalise<T>(k.v[e], mean2, mul2, bias2));
      if constexpr (kRelu) t = relu(t);
      v.v[e] = t;
    }
    v.store(out + base + i);
  }
}

template <typename T, int kForm, bool kRelu>
void launch_form(const T* y, const T* skip, T* out, const Channel& a, const Channel& d,
                 int planes, int channels, long long p, cudaStream_t st) {
  constexpr int kWord = word<T>();
  const int spans = static_cast<int>((p + kSpan - 1) / kSpan);
  const unsigned grid = static_cast<unsigned>(planes) * spans;
  if (p % kWord == 0 && aligned16(y) && aligned16(out) &&
      (kForm == kPlain || aligned16(skip)))
    bn_act_kernel<T, kForm, kRelu, kWord><<<grid, kThreads, 0, st>>>(
        y, skip, out, a, d, channels, p, spans, span_of(p, spans, kWord));
  else
    bn_act_kernel<T, kForm, kRelu, 1><<<grid, kThreads, 0, st>>>(
        y, skip, out, a, d, channels, p, spans, span_of(p, spans, 1));
}

template <typename T>
int launch(const void* y, const void* skip, void* out, const float* w, const float* b,
           const float* mean, const float* var, const float* w2, const float* b2,
           const float* mean2, const float* var2, int n, int c, long long p, int form,
           int relu, void* stream) {
  if (n <= 0 || c <= 0 || p <= 0) return 0;
  const long long grid = static_cast<long long>(n) * c * ((p + kSpan - 1) / kSpan);
  if (form < kPlain || form > kDownsample || grid > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const T* yv = static_cast<const T*>(y);
  const T* sk = static_cast<const T*>(skip);
  T* o = static_cast<T*>(out);
  const Channel a{w, b, mean, var}, d{w2, b2, mean2, var2};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int planes = n * c;
  switch (form * 2 + (relu != 0)) {
    case 0: launch_form<T, kPlain, false>(yv, sk, o, a, d, planes, c, p, st); break;
    case 1: launch_form<T, kPlain, true>(yv, sk, o, a, d, planes, c, p, st); break;
    case 2: launch_form<T, kResidual, false>(yv, sk, o, a, d, planes, c, p, st); break;
    case 3: launch_form<T, kResidual, true>(yv, sk, o, a, d, planes, c, p, st); break;
    case 4: launch_form<T, kDownsample, false>(yv, sk, o, a, d, planes, c, p, st); break;
    default: launch_form<T, kDownsample, true>(yv, sk, o, a, d, planes, c, p, st); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y, skip (form 1: the identity skip; form 2: the downsample
// convolution's output xd; form 0: unused), out: [n, c, p] contiguous,
// of float32 (itermvs_bn_act) or bfloat16 (_bf16). w, b, mean, var: the
// BN of y, w2, b2, mean2, var2 that of xd (form 2 only): float32 [c].
// relu: 1 to apply the ReLU. Returns the launch's error (0 on success).
extern "C" int itermvs_bn_act(const void* y, const void* skip, void* out, const float* w,
                              const float* b, const float* mean, const float* var,
                              const float* w2, const float* b2, const float* mean2,
                              const float* var2, int n, int c, long long p, int form, int relu,
                              void* stream) {
  return launch<float>(y, skip, out, w, b, mean, var, w2, b2, mean2, var2, n, c, p, form, relu,
                       stream);
}

extern "C" int itermvs_bn_act_bf16(const void* y, const void* skip, void* out, const float* w,
                                   const float* b, const float* mean, const float* var,
                                   const float* w2, const float* b2, const float* mean2,
                                   const float* var2, int n, int c, long long p, int form,
                                   int relu, void* stream) {
  return launch<__nv_bfloat16>(y, skip, out, w, b, mean, var, w2, b2, mean2, var2, n, c, p,
                               form, relu, stream);
}
