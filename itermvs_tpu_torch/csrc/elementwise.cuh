// The elementwise kernels' common parts: the ConvGRU's gates K13-K16
// (conv_gru.cuh) and FeatureNet's BatchNorm epilogue K17/K18
// (bn_act.cuh). Each operation computes in float32 and rounds to the
// compute dtype T (float32 or bfloat16) on its own (rnd<T>), with the _rn
// intrinsics, so that nothing is contracted into an FMA.
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
