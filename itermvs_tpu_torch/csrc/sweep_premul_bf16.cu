// K2 sweep_premul, bfloat16 form: the plane sweep's bilinear corner
// gather, multiplied by the tap weights and the reference features, on
// bfloat16 tables.
//
// Replaces: the XLA chain itermvs_tpu/ops/grid_sample.py `gather_corners`
// followed by itermvs_tpu/ops/sweep_epilogue.py `premultiply` in the JAX
// package's bfloat16 mode, where the tables, the taps
// (ops/warping.py `fused_sweep_taps(table_dtype=...)`) and the products
// are bfloat16:
//     premul[b, p, k*C + ch] = bf16(bf16(src[b, y_k, x_k, ch] * tap_k[b, p])
//                                   * ref[b, p % HW, ch])
// for corners k = (y, x), (y, x+1), (y+1, x), (y+1, x+1) of the clamped
// base index base[b, p] = y*W1 + x, each product rounded to nearest even:
// the order and rounding of the plain version (ops/sweep.py
// `sweep_premul_plain`, two bfloat16 multiplies), so the two are equal bit
// for bit. A +1 corner past the image edge reads 0, the zero fill of
// `pack_corners`. Entry point: itermvs_sweep_premul_bf16 (the float32
// form is csrc/sweep_premul.cu).
//
// What bounds it on an H100: memory, as in float32. The [B, P, 4C] output
// (4C values per row against ~5 words of index and taps read) dominates;
// in bfloat16 it is half the bytes: 354 MB per view for the init sweep at
// 1600x1152.
//
// Design: the float32 kernel's, with 16-byte lanes of 8 bfloat16 values:
// threads run across the 4C outputs of a row, C/8 lanes per corner, so the
// NHWC source reads of one corner, the reference reads and the output
// writes are coalesced 16-byte accesses. A block holds 256/(C/2) rows.
// Products are formed in float32 from the converted values and rounded
// after each multiply. A base index outside [0, H1*W1) writes NaN, so an
// upstream error shows instead of reading out of bounds.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "bf16_lanes.cuh"

namespace {

__global__ void sweep_premul_bf16_kernel(const uint4* __restrict__ src,
                                         const int* __restrict__ base,
                                         const __nv_bfloat16* __restrict__ taps,
                                         const uint4* __restrict__ ref,
                                         uint4* __restrict__ out,
                                         int batch, long long p, int hw,
                                         int h1, int w1, int c8) {
  const long long rows = static_cast<long long>(batch) * p;
  const long long row = static_cast<long long>(blockIdx.x) * blockDim.y + threadIdx.y;
  if (row >= rows) return;
  const int k = threadIdx.x / c8;      // corner
  const int cc = threadIdx.x - k * c8; // 8-value lane within the channels
  const int b = static_cast<int>(row / p);
  const long long pp = row - static_cast<long long>(b) * p;
  const int pix = static_cast<int>(pp % hw);

  const int idx = base[row];
  float v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = 0.f;
  if (idx < 0 || idx >= h1 * w1) {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = CUDART_NAN_F;
  } else {
    const int y = idx / w1 + (k >> 1);
    const int x = idx % w1 + (k & 1);
    if (y < h1 && x < w1) {
      bf16x8_to_float(src[((static_cast<long long>(b) * h1 + y) * w1 + x) * c8 + cc], v);
    }
  }
  const float t = __bfloat162float(taps[static_cast<long long>(k) * rows + row]);
  float r[8];
  bf16x8_to_float(ref[(static_cast<long long>(b) * hw + pix) * c8 + cc], r);
  // (value * tap) rounded, then * ref rounded: the plain version's order.
  float o[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    o[j] = __bfloat162float(__float2bfloat16_rn(v[j] * t)) * r[j];
  }
  out[row * (4LL * c8) + threadIdx.x] = float_to_bf16x8(o);
}

}  // namespace

// src: [batch, h1, w1, c] bf16 NHWC. base: [batch, p] int32. taps: [4,
// batch, p] bf16. ref: [batch, hw, c] bf16. out: [batch, p, 4c] bf16. All
// contiguous, src and ref 16-byte aligned; c % 8 == 0 and c <= 256.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int itermvs_sweep_premul_bf16(const void* src, const int* base,
                                         const void* taps, const void* ref,
                                         void* out, int batch, long long p,
                                         int hw, int h1, int w1, int c,
                                         void* stream) {
  const long long rows = static_cast<long long>(batch) * p;
  if (rows <= 0) return 0;
  const int c8 = c / 8;
  const int lanes = 4 * c8;                 // threads per row
  const int rows_per_block = lanes >= 256 ? 1 : 256 / lanes;
  const dim3 block(lanes, rows_per_block);
  const long long blocks = (rows + rows_per_block - 1) / rows_per_block;
  sweep_premul_bf16_kernel<<<static_cast<unsigned>(blocks), block, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(src), base, static_cast<const __nv_bfloat16*>(taps),
      static_cast<const uint4*>(ref), static_cast<uint4*>(out), batch, p, hw, h1, w1, c8);
  return static_cast<int>(cudaGetLastError());
}
