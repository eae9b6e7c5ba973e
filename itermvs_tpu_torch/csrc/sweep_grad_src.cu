// K5 sweep_grad_src: gradient of the plane-sweep group correlation with
// respect to the source features.
//
// Replaces: the source-feature half of the XLA autodiff of
// itermvs_tpu/models/itermvs.py `chunked_warp_corr` (the scatter-add that
// transposes gather_corners of the pack_bilinear table), i.e. the
// transpose of K2 sweep_premul followed by K1 corr_epilogue. With g' =
// grad_corr[b, s, grp(ch), pix] / (C/G):
//     d_src[b, y_k, x_k, ch] += tap_k[b, s, pix] * ref[b, pix, ch] * g'
// for the 4 corners k = (y, x), (y, x+1), (y+1, x), (y+1, x+1) of the base
// index base[b, s*HW + pix] = y*W1 + x. A +1 corner past the image edge is
// dropped: it read the zero fill of `pack_corners` in the forward pass, a
// constant.
//
// What bounds it on an H100: memory, and the atomic adds into L2. Per
// (sample, pixel) it reads one index, 4 taps and G gradient words and
// the reference row, and per channel it does 9 flops and 4 atomic adds.
//
// Design: one thread per (batch, sample, pixel, float4 lane of the
// channels), as K2 lays out its rows: threads of a pixel read the C
// reference floats as coalesced 16-byte loads and add into the C
// contiguous floats of each corner. Several (sample, pixel) rows land on
// the same source cell, so the adds are f32 atomicAdd (compiled to RED,
// the result unused). The order in which the adds of one cell arrive
// changes from run to run, and f32 addition is not associative: d_src
// differs between runs in its last bits (its tolerance against the plain
// version is stated where it is checked). d_src must be zeroed before the
// launch. Offsets are 64-bit. A base index outside [0, H1*W1) is an
// upstream fault: the row adds NaN to its lane of the batch's first
// cell, so the fault shows in d_src instead of being skipped.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

__global__ void sweep_grad_src_kernel(const float4* __restrict__ ref,
                                      const int* __restrict__ base,
                                      const float* __restrict__ taps,
                                      const float* __restrict__ grad,
                                      float* __restrict__ d_src,
                                      int batch, int n, int hw, int h1, int w1,
                                      int c4, int groups) {
  const long long p = static_cast<long long>(n) * hw;
  const long long rows = static_cast<long long>(batch) * p;
  const long long row = static_cast<long long>(blockIdx.x) * blockDim.y + threadIdx.y;
  if (row >= rows) return;
  const int cc = threadIdx.x;          // float4 lane within the channels
  const int b = static_cast<int>(row / p);
  const long long pp = row - static_cast<long long>(b) * p;
  const int s = static_cast<int>(pp / hw);
  const int pix = static_cast<int>(pp - static_cast<long long>(s) * hw);
  const int c = 4 * c4;
  const int cg = c / groups;
  const float cg_f = static_cast<float>(cg);
  const int cells = h1 * w1;
  float* dst = d_src + static_cast<long long>(b) * cells * c + 4 * cc;

  const int idx = base[row];
  if (idx < 0 || idx >= cells) {
    for (int i = 0; i < 4; ++i) atomicAdd(dst + i, CUDART_NAN_F);
    return;
  }
  const float* gs = grad + (static_cast<long long>(b) * n + s) * groups * hw + pix;
  const float4 r = ref[(static_cast<long long>(b) * hw + pix) * c4 + cc];
  const float rg0 = r.x * (gs[static_cast<long long>((4 * cc + 0) / cg) * hw] / cg_f);
  const float rg1 = r.y * (gs[static_cast<long long>((4 * cc + 1) / cg) * hw] / cg_f);
  const float rg2 = r.z * (gs[static_cast<long long>((4 * cc + 2) / cg) * hw] / cg_f);
  const float rg3 = r.w * (gs[static_cast<long long>((4 * cc + 3) / cg) * hw] / cg_f);
  const int y = idx / w1;
  const int x = idx - y * w1;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int yk = y + (k >> 1);
    const int xk = x + (k & 1);
    if (yk < h1 && xk < w1) {
      const float t = taps[k * rows + row];
      float* o = dst + (static_cast<long long>(yk) * w1 + xk) * c;
      atomicAdd(o + 0, t * rg0);
      atomicAdd(o + 1, t * rg1);
      atomicAdd(o + 2, t * rg2);
      atomicAdd(o + 3, t * rg3);
    }
  }
}

}  // namespace

// ref: [batch, hw, c] f32. base: [batch, n*hw] int32. taps: [4, batch,
// n*hw] f32. grad: [batch, n, groups, hw] f32. d_src: [batch, h1, w1, c]
// f32, zeroed by the caller. All contiguous, ref 16-byte aligned;
// c % 4 == 0, c <= 1024, c % groups == 0.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int itermvs_sweep_grad_src(const float* ref, const int* base,
                                      const float* taps, const float* grad,
                                      float* d_src, int batch, int n, int hw,
                                      int h1, int w1, int c, int groups,
                                      void* stream) {
  const long long rows = static_cast<long long>(batch) * n * hw;
  if (rows <= 0) return 0;
  const int c4 = c / 4;
  const int rows_per_block = c4 >= 256 ? 1 : 256 / c4;
  const dim3 block(c4, rows_per_block);
  const long long blocks = (rows + rows_per_block - 1) / rows_per_block;
  sweep_grad_src_kernel<<<static_cast<unsigned>(blocks), block, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(ref), base, taps, grad, d_src,
      batch, n, hw, h1, w1, c4, groups);
  return static_cast<int>(cudaGetLastError());
}
