// Eight bfloat16 values in one 16-byte vector (uint4): the vector lane of
// the port's bfloat16 kernels, as float4 is the lane of the float32 ones
// (and four in a uint2, where a kernel keeps float32's 4-channel lanes).
// Values convert to and from float32 with the conversion intrinsics of
// cuda_bf16.h only (__bfloat162float, __float2bfloat16_rn: round to
// nearest even, PyTorch's rounding); the bit moves around them do not
// change a value. Element 2i is the low half of word i: memory order.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

__device__ __forceinline__ void bf16x8_to_float(const uint4 u, float f[8]) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(w[i] & 0xffffu)));
    f[2 * i + 1] = __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(w[i] >> 16)));
  }
}

// Four bfloat16 values in 8 bytes (uint2), as a float4.
__device__ __forceinline__ float4 bf16x4_to_float4(const uint2 u) {
  return make_float4(
      __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(u.x & 0xffffu))),
      __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(u.x >> 16))),
      __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(u.y & 0xffffu))),
      __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(u.y >> 16))));
}

// `f` rounded to bfloat16, its 16 bits in the low half.
__device__ __forceinline__ unsigned bf16_bits(float f) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(f));
}

__device__ __forceinline__ uint4 float_to_bf16x8(const float f[8]) {
  uint4 u;
  u.x = bf16_bits(f[0]) | (bf16_bits(f[1]) << 16);
  u.y = bf16_bits(f[2]) | (bf16_bits(f[3]) << 16);
  u.z = bf16_bits(f[4]) | (bf16_bits(f[5]) << 16);
  u.w = bf16_bits(f[6]) | (bf16_bits(f[7]) << 16);
  return u;
}

// A tap weight as float32, from either element type.
__device__ __forceinline__ float tap_float(float t) { return t; }
__device__ __forceinline__ float tap_float(__nv_bfloat16 t) { return __bfloat162float(t); }
