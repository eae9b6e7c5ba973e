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
// them. The first version of this kernel read the streams from the
// thread of each (pixel, float4 lane): a warp covered 32/(C/4) pixels, so
// each of its 9 scalar loads per sample took a few words of a sector, and
// came only after the sample's index (a branch on it guarded them). With
// one such round trip after another per sample it moved the streams far
// below the card's rate; splitting the samples across threads did not
// help by itself, and neither did staging the source window in shared
// memory.
//
// Design: a block takes `pt` consecutive pixels of one batch and walks
// the samples in chunks. For each chunk it first copies every stream word
// it needs (index, 4 taps, G gradient words per (sample, pixel)) into
// shared memory, field by field, consecutive threads on consecutive
// pixels: whole sectors, all loads independent. Then one thread per
// (pixel, float4 lane) walks the chunk's samples in order: it reads its
// records from shared memory (a broadcast across the lanes of a pixel)
// and gathers the 4 corners of each sample (coalesced 16-byte loads
// across the lanes), the sample loop unrolled, summing in registers, and
// writes its float4 of d_ref once: no atomics, so the result does not
// depend on thread order. Splitting each pixel's samples over 2 or 4
// threads, their sums met in a fixed order in shared memory, was as exact
// and slower at every shape. A base index outside [0, H1*W1) is an
// upstream fault: the pixel's d_ref becomes NaN instead of the sample
// being skipped.
#include <cuda_runtime.h>
#include <math_constants.h>

#include "sweep_records.cuh"

namespace {

__global__ void sweep_grad_ref_kernel(const float4* __restrict__ src,
                                      const int* __restrict__ base,
                                      const float* __restrict__ taps,
                                      const float* __restrict__ grad,
                                      float4* __restrict__ d_ref,
                                      int batch, int n, int hw, int h1, int w1,
                                      int c4, int groups, int pt, int chunk) {
  extern __shared__ float rec[];
  const int fields = 5 + groups;
  const int tiles = (hw + pt - 1) / pt;
  const int b = blockIdx.x / tiles;
  const int pix0 = (blockIdx.x - b * tiles) * pt;
  const int npix = min(pt, hw - pix0);
  const int cells = h1 * w1;
  const long long plane = static_cast<long long>(batch) * n * hw;   // one corner's taps
  const int cc = threadIdx.x % c4;     // float4 lane within the channels
  const int q = threadIdx.x / c4;      // pixel within the block
  const int cg = 4 * c4 / groups;
  const float cg_f = static_cast<float>(cg);
  const int gf[4] = {(5 + (4 * cc + 0) / cg) * pt, (5 + (4 * cc + 1) / cg) * pt,
                     (5 + (4 * cc + 2) / cg) * pt, (5 + (4 * cc + 3) / cg) * pt};
  const float4* src_b = src + static_cast<long long>(b) * cells * c4 + cc;

  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  bool fault = false;
  for (int s0 = 0; s0 < n; s0 += chunk) {
    const int ns = min(chunk, n - s0);
    stage_records(rec, base, taps, grad, b, n, hw, groups, plane, pix0, npix, pt, s0, ns);
    __syncthreads();
    if (q < npix) {
#pragma unroll 4
      for (int u = 0; u < ns; ++u) {
        const float* r = rec + u * fields * pt + q;
        const int idx = __float_as_int(r[0]);
        if (idx < 0 || idx >= cells) {
          fault = true;
          continue;
        }
        const float g0 = r[gf[0]] / cg_f;
        const float g1 = r[gf[1]] / cg_f;
        const float g2 = r[gf[2]] / cg_f;
        const float g3 = r[gf[3]] / cg_f;
        const int y = idx / w1;
        const int x = idx - y * w1;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int yk = y + (k >> 1);
          const int xk = x + (k & 1);
          if (yk < h1 && xk < w1) {
            const float t = r[(1 + k) * pt];
            const float4 v = src_b[static_cast<long long>(yk * w1 + xk) * c4];
            acc.x += t * v.x * g0;
            acc.y += t * v.y * g1;
            acc.z += t * v.z * g2;
            acc.w += t * v.w * g3;
          }
        }
      }
    }
    __syncthreads();
  }
  if (q >= npix) return;
  if (fault) acc = make_float4(CUDART_NAN_F, CUDART_NAN_F, CUDART_NAN_F, CUDART_NAN_F);
  d_ref[(static_cast<long long>(b) * hw + pix0 + q) * c4 + cc] = acc;
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
  if (static_cast<long long>(batch) * hw <= 0) return 0;
  const int c4 = c / 4;
  const RecordTiles t(n, c4, groups);
  const long long blocks = static_cast<long long>(batch) * ((hw + t.pt - 1) / t.pt);
  sweep_grad_ref_kernel<<<static_cast<unsigned>(blocks), t.pt * c4, t.smem_bytes(),
                          static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(src), base, taps, grad,
      reinterpret_cast<float4*>(d_ref), batch, n, hw, h1, w1, c4, groups, t.pt, t.chunk);
  return static_cast<int>(cudaGetLastError());
}
