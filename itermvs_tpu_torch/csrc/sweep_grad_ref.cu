// K4 sweep_grad_ref: gradient of the plane-sweep group correlation with
// respect to the reference features.
//
// Replaces: the reference-feature half of the XLA autodiff of
// itermvs_tpu/models/itermvs.py `chunked_warp_corr` (gather_corners of the
// pack_bilinear table, then group_corr), i.e. the transpose of K2
// sweep_premul followed by K1 corr_epilogue. With g' = grad_corr[b, s,
// grp(ch), pix] / (C/G) (the transpose of K1's group mean, a broadcast
// over corners and channels):
//     d_ref[b, pix, ch] = sum_s sum_k tap_k[b, s, pix]
//                         * src[b, y_k, x_k, ch] * g'
// over corners k = (y, x), (y, x+1), (y+1, x), (y+1, x+1) of the base
// index base[b, s*HW + pix] = y*W1 + x. A +1 corner past the image edge
// read 0 in the forward pass (the zero fill of `pack_corners`) and adds
// nothing here.
//
// What bounds it on an H100: memory. Per (sample, pixel) it reads one
// index, 4 taps and G gradient words, and per channel about 9 flops over
// the 4 corners, so ~0.6 flop per byte of those streams. The source map
// (re-read from L2 by neighbouring samples) and d_ref are small beside
// them.
//
// Design: one thread per (batch, pixel, float4 lane of the channels);
// threads of a pixel read a corner's C contiguous source floats as
// coalesced 16-byte loads, and consecutive pixels read consecutive index,
// tap and gradient words. The sum over samples and corners stays in
// registers and each thread writes its float4 of d_ref once: a gather, no
// atomics, so the result does not depend on thread order. Offsets are
// 64-bit. A base index outside [0, H1*W1) is an upstream fault: the
// pixel's d_ref becomes NaN instead of the sample being skipped.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

__global__ void sweep_grad_ref_kernel(const float4* __restrict__ src,
                                      const int* __restrict__ base,
                                      const float* __restrict__ taps,
                                      const float* __restrict__ grad,
                                      float4* __restrict__ d_ref,
                                      int batch, int n, int hw, int h1, int w1,
                                      int c4, int groups) {
  const long long rows = static_cast<long long>(batch) * hw;
  const long long row = static_cast<long long>(blockIdx.x) * blockDim.y + threadIdx.y;
  if (row >= rows) return;
  const int cc = threadIdx.x;          // float4 lane within the channels
  const int b = static_cast<int>(row / hw);
  const int pix = static_cast<int>(row - static_cast<long long>(b) * hw);
  const int cg = 4 * c4 / groups;
  const float cg_f = static_cast<float>(cg);
  const long long gstride[4] = {
      static_cast<long long>((4 * cc + 0) / cg) * hw,
      static_cast<long long>((4 * cc + 1) / cg) * hw,
      static_cast<long long>((4 * cc + 2) / cg) * hw,
      static_cast<long long>((4 * cc + 3) / cg) * hw};
  const long long p = static_cast<long long>(n) * hw;     // rows of one batch
  const long long plane = static_cast<long long>(batch) * p;  // one corner's taps
  const int cells = h1 * w1;
  const float4* src_b = src + static_cast<long long>(b) * cells * c4;

  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  bool fault = false;
  for (int s = 0; s < n; ++s) {
    const long long r = static_cast<long long>(b) * p + static_cast<long long>(s) * hw + pix;
    const int idx = base[r];
    if (idx < 0 || idx >= cells) {
      fault = true;
      continue;
    }
    const float* gs = grad + (static_cast<long long>(b) * n + s) * groups * hw + pix;
    const float g0 = gs[gstride[0]] / cg_f;
    const float g1 = gs[gstride[1]] / cg_f;
    const float g2 = gs[gstride[2]] / cg_f;
    const float g3 = gs[gstride[3]] / cg_f;
    const int y = idx / w1;
    const int x = idx - y * w1;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int yk = y + (k >> 1);
      const int xk = x + (k & 1);
      if (yk < h1 && xk < w1) {
        const float t = taps[k * plane + r];
        const float4 v = src_b[(static_cast<long long>(yk) * w1 + xk) * c4 + cc];
        acc.x += t * v.x * g0;
        acc.y += t * v.y * g1;
        acc.z += t * v.z * g2;
        acc.w += t * v.w * g3;
      }
    }
  }
  if (fault) {
    acc = make_float4(CUDART_NAN_F, CUDART_NAN_F, CUDART_NAN_F, CUDART_NAN_F);
  }
  d_ref[row * c4 + cc] = acc;
}

}  // namespace

// src: [batch, h1, w1, c] f32 NHWC. base: [batch, n*hw] int32. taps: [4,
// batch, n*hw] f32. grad: [batch, n, groups, hw] f32. d_ref: [batch, hw,
// c] f32 (every element written). All contiguous, src and d_ref 16-byte
// aligned; c % 4 == 0, c <= 1024, c % groups == 0.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int itermvs_sweep_grad_ref(const float* src, const int* base,
                                      const float* taps, const float* grad,
                                      float* d_ref, int batch, int n, int hw,
                                      int h1, int w1, int c, int groups,
                                      void* stream) {
  const long long rows = static_cast<long long>(batch) * hw;
  if (rows <= 0) return 0;
  const int c4 = c / 4;
  const int rows_per_block = c4 >= 256 ? 1 : 256 / c4;
  const dim3 block(c4, rows_per_block);
  const long long blocks = (rows + rows_per_block - 1) / rows_per_block;
  sweep_grad_ref_kernel<<<static_cast<unsigned>(blocks), block, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(src), base, taps, grad,
      reinterpret_cast<float4*>(d_ref), batch, n, hw, h1, w1, c4, groups);
  return static_cast<int>(cudaGetLastError());
}
