// What the ConvGRU's four elementwise kernels share: K13 gru_reset
// (gru_reset.cu), K14 gru_update (gru_update.cu) and their backwards,
// K15 gru_update_grad (gru_update_grad.cu) and K16 gru_reset_grad
// (gru_reset_grad.cu). The convolutions convz, convr and convq between
// them stay in cuDNN.
//
// Arithmetic: the plain version is the chain as PyTorch's CUDA
// elementwise kernels compute it, one operation per kernel, so every
// intermediate is rounded to the compute dtype T (float32 or bfloat16)
// before the next one reads it. Here each operation computes in float32
// and rounds to T on its own (rnd<T>), in the plain version's order;
// float32 operations are the _rn intrinsics, so nothing is contracted
// into an FMA except where PyTorch's own build contracts it
// (tanh_backward in float32). The formulas are PyTorch's:
//     sigmoid(x)             1 / (1 + expf(-x))
//     tanh(x)                tanhf(x)
//     sigmoid_backward(g, s) g * (1 - s) * s        (each op in T)
//     tanh_backward(g, t)    g * (1 - t * t)        (float32: g * fma(-t, t, 1))
// A bfloat16 product of two bfloat16 values is exact in float32, so one
// rounding gives PyTorch's bfloat16 result.
//
// Layout, lanes and rounding helpers: elementwise.cuh.
#pragma once

#include <cuda_runtime.h>

#include "elementwise.cuh"

namespace {

template <typename T>
__device__ __forceinline__ float sigmoid(float x) {
  return rnd<T>(__fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x))));
}
template <typename T>
__device__ __forceinline__ float tanh_(float x) {
  return rnd<T>(tanhf(x));
}
template <typename T>
__device__ __forceinline__ float sigmoid_backward(float g, float s) {
  return mul<T>(mul<T>(g, sub<T>(1.0f, s)), s);
}
template <typename T>
__device__ __forceinline__ float tanh_backward(float g, float t) {
  return mul<T>(g, sub<T>(1.0f, mul<T>(t, t)));
}
template <>
__device__ __forceinline__ float tanh_backward<float>(float g, float t) {
  return __fmul_rn(g, __fmaf_rn(-t, t, 1.0f));
}

}  // namespace
