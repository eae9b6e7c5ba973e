// K2 sweep_premul: bilinear corner gather of the plane sweep, multiplied
// by the tap weights and the reference features.
//
// Replaces: the XLA chain itermvs_tpu/ops/grid_sample.py `gather_corners`
// (a row gather of the 4-corner packed source table) followed by
// itermvs_tpu/ops/sweep_epilogue.py `premultiply`:
//     premul[b, p, k*C + ch] = src[b, y_k, x_k, ch] * tap_k[b, p]
//                              * ref[b, p % HW, ch]
// with corners k = (y, x), (y, x+1), (y+1, x), (y+1, x+1) of the clamped
// base index base[b, p] = y*W1 + x. A +1 corner past the image edge reads
// 0, the zero fill that the TPU corner packing (`pack_corners`) gives.
// The TPU packings (banded, superpixel, pair) are not ported: they exist
// for a row-count cliff of XLA's TPU gather that Hopper does not have.
//
// What bounds it on an H100: memory. The least traffic is the source and
// reference maps read once plus 5 words of index and taps per row and the
// [B, P, 4C] output written once; the output dominates (4C floats per
// row against ~5 read), and there are 2 multiplies per output float.
//
// Design: threads run across the 4C output floats of a row as float4
// lanes, so the NHWC source reads of one corner (C contiguous floats),
// the reference reads and the output writes are all coalesced 16-byte
// accesses. A block holds 256/C rows (C/4 float4 lanes x 4 corners = C
// threads per row). Offsets are 64-bit: B*P*4C reaches 1.8e8 floats at
// 1600x1152. A base index outside [0, H1*W1) writes NaN, so an upstream
// error shows instead of reading out of bounds.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

__global__ void sweep_premul_kernel(const float4* __restrict__ src,
                                    const int* __restrict__ base,
                                    const float* __restrict__ taps,
                                    const float4* __restrict__ ref,
                                    float4* __restrict__ out,
                                    int batch, long long p, int hw,
                                    int h1, int w1, int c4) {
  const long long rows = static_cast<long long>(batch) * p;
  const long long row = static_cast<long long>(blockIdx.x) * blockDim.y + threadIdx.y;
  if (row >= rows) return;
  const int k = threadIdx.x / c4;      // corner
  const int cc = threadIdx.x - k * c4; // float4 lane within the channels
  const int b = static_cast<int>(row / p);
  const long long pp = row - static_cast<long long>(b) * p;
  const int pix = static_cast<int>(pp % hw);

  const int idx = base[row];
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (idx < 0 || idx >= h1 * w1) {
    v = make_float4(CUDART_NAN_F, CUDART_NAN_F, CUDART_NAN_F, CUDART_NAN_F);
  } else {
    const int y = idx / w1 + (k >> 1);
    const int x = idx % w1 + (k & 1);
    if (y < h1 && x < w1) {
      v = src[((static_cast<long long>(b) * h1 + y) * w1 + x) * c4 + cc];
    }
  }
  const float t = taps[static_cast<long long>(k) * rows + row];
  const float4 r = ref[(static_cast<long long>(b) * hw + pix) * c4 + cc];
  // (value * tap) * ref: the order of the plain version.
  out[row * (4LL * c4) + threadIdx.x] =
      make_float4(v.x * t * r.x, v.y * t * r.y, v.z * t * r.z, v.w * t * r.w);
}

}  // namespace

// src: [batch, h1, w1, c] f32 NHWC. base: [batch, p] int32. taps: [4,
// batch, p] f32. ref: [batch, hw, c] f32. out: [batch, p, 4c] f32. All
// contiguous and 16-byte aligned; c % 4 == 0 and c <= 256.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int itermvs_sweep_premul(const float* src, const int* base,
                                    const float* taps, const float* ref,
                                    float* out, int batch, long long p,
                                    int hw, int h1, int w1, int c,
                                    void* stream) {
  const long long rows = static_cast<long long>(batch) * p;
  if (rows <= 0) return 0;
  const int c4 = c / 4;
  const int lanes = 4 * c4;                 // threads per row
  const int rows_per_block = lanes >= 256 ? 1 : 256 / lanes;
  const dim3 block(lanes, rows_per_block);
  const long long blocks = (rows + rows_per_block - 1) / rows_per_block;
  sweep_premul_kernel<<<static_cast<unsigned>(blocks), block, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(src), base, taps,
      reinterpret_cast<const float4*>(ref), reinterpret_cast<float4*>(out),
      batch, p, hw, h1, w1, c4);
  return static_cast<int>(cudaGetLastError());
}
