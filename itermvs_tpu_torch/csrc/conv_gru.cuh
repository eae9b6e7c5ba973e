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
// Layout: NCHW, contiguous. A thread owns kVec neighbouring elements,
// one 16-byte word per tensor (float4, or eight bfloat16 in a uint4)
// where the launcher finds every pointer 16-byte aligned and the lengths
// multiples of kVec; else one element.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bf16_lanes.cuh"

namespace {

constexpr int kThreads = 256;

// x rounded to T (to nearest even), as a float.
template <typename T>
__device__ __forceinline__ float rnd(float x);
template <>
__device__ __forceinline__ float rnd<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float rnd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename T>
__device__ __forceinline__ float mul(float a, float b) {
  return rnd<T>(__fmul_rn(a, b));
}
template <typename T>
__device__ __forceinline__ float sub(float a, float b) {
  return rnd<T>(__fsub_rn(a, b));
}
template <typename T>
__device__ __forceinline__ float add(float a, float b) {
  return rnd<T>(__fadd_rn(a, b));
}
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

__device__ __forceinline__ void store_one(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_one(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// kVec elements of T at one address, as floats.
template <typename T, int kVec>
struct Lanes {
  static_assert(kVec == 1 || kVec * sizeof(T) == 16, "one element or one 16-byte word");
  float v[kVec];

  __device__ __forceinline__ void load(const T* p) {
    if constexpr (kVec == 1) {
      v[0] = tap_float(__ldg(p));
    } else if constexpr (sizeof(T) == 4) {
      const float4 w = __ldg(reinterpret_cast<const float4*>(p));
      v[0] = w.x;
      v[1] = w.y;
      v[2] = w.z;
      v[3] = w.w;
    } else {
      bf16x8_to_float(__ldg(reinterpret_cast<const uint4*>(p)), v);
    }
  }

  // Stores values already rounded to T.
  __device__ __forceinline__ void store(T* p) const {
    if constexpr (kVec == 1) {
      store_one(p, v[0]);
    } else if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      *reinterpret_cast<uint4*>(p) = float_to_bf16x8(v);
    }
  }
};

// kVec elements moved bit for bit (the channels of x that pass through).
template <typename T, int kVec>
__device__ __forceinline__ void copy(const T* src, T* dst) {
  if constexpr (kVec == 1)
    *dst = __ldg(src);
  else
    *reinterpret_cast<uint4*>(dst) = __ldg(reinterpret_cast<const uint4*>(src));
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0;
}

// Elements in one 16-byte word.
template <typename T>
constexpr int word() {
  return static_cast<int>(16 / sizeof(T));
}

// Blocks of kThreads threads of kVec elements over n elements.
inline unsigned blocks(long long n, int vec) {
  return static_cast<unsigned>((n / vec + kThreads - 1) / kThreads);
}

}  // namespace
