// K5 sweep_grad_src, bfloat16 form: gradient of the plane-sweep group
// correlation with respect to bfloat16 source features.
//
// Replaces: the source-feature half of the XLA autodiff of
// itermvs_tpu/models/itermvs.py `chunked_warp_corr` in the JAX package's
// bfloat16 mode (the scatter-add that transposes gather_corners of the
// bfloat16 pack_bilinear table). With g' = grad_corr[b, s, grp(ch), pix]
// / (C/G), float32:
//     d_src[b, y_k, x_k, ch] += tap_k[b, s, pix] * ref[b, pix, ch] * g'
// for the 4 corners k of the base index base[b, s*HW + pix] = y*W1 + x,
// summed in float32 and rounded to bfloat16 once at the end, as the plain
// version (ops/sweep_grad.py `sweep_grad_src_plain`) does. A +1 corner
// past the image edge is dropped. Entry point:
// itermvs_sweep_grad_src_bf16 (the float32 form is csrc/sweep_grad_src.cu).
//
// What bounds it on an H100: as in float32, the float4 reductions the L2
// serves (see csrc/sweep_grad_src.cu); the streams are read once.
//
// Design: the float32 kernel's (csrc/sweep_grad_src.cu), the same float4
// lanes of 4 channels, with bfloat16 loads: a block stages the per-row
// streams of `pt` pixels in shared memory (sweep_records.cuh, taps
// converted to float32), one thread per (pixel, 4-channel lane) reads its 4
// reference values once (8 bytes) and walks the samples in order, summing
// runs of consecutive samples on one base cell in float32 registers, and
// each run goes into its up to 4 corners with one float4 vector reduction
// (red.global.add.v4.f32) per corner into a float32 scratch map that the
// launcher zero-fills. bfloat16 atomics would accumulate in bfloat16, so
// they are not used. A second kernel then rounds the scratch to bfloat16
// into d_src, 8 values a thread. A first form with lanes of 8 channels (two
// reductions per corner, 125 registers a thread against 70) took 1.9 times
// the float32 kernel's time at every shape. The order in which runs of
// different threads arrive changes from run to run, so the scratch's last
// bits do, and now and then a rounded value. A base index outside [0,
// H1*W1) adds NaN to its lane of the batch's first cell.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "bf16_lanes.cuh"
#include "sweep_records.cuh"

namespace {

// One float4 reduction per corner of base cell `cell` on the map.
__device__ __forceinline__ void add_corners(float4* dst, int cell, const float4* a, int h1,
                                            int w1, int c4) {
  if (cell < 0) return;
  const int y = cell / w1;
  const int x = cell - y * w1;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int yk = y + (k >> 1);
    const int xk = x + (k & 1);
    if (yk < h1 && xk < w1) atomicAdd(dst + static_cast<long long>(yk * w1 + xk) * c4, a[k]);
  }
}

__global__ void sweep_grad_src_bf16_kernel(const uint2* __restrict__ ref,
                                           const int* __restrict__ base,
                                           const __nv_bfloat16* __restrict__ taps,
                                           const float* __restrict__ grad,
                                           float4* __restrict__ scratch, int batch, int n,
                                           int hw, int h1, int w1, int c4, int groups,
                                           int pt, int chunk) {
  extern __shared__ float rec[];
  const int fields = 5 + groups;
  const int tiles = (hw + pt - 1) / pt;
  const int b = blockIdx.x / tiles;
  const int pix0 = (blockIdx.x - b * tiles) * pt;
  const int npix = min(pt, hw - pix0);
  const int cells = h1 * w1;
  const long long plane = static_cast<long long>(batch) * n * hw;   // one corner's taps
  const int cc = threadIdx.x % c4;     // 4-channel lane within the channels
  const int q = threadIdx.x / c4;      // pixel within the block
  const int cg = 4 * c4 / groups;
  const float cg_f = static_cast<float>(cg);
  const int gf[4] = {(5 + (4 * cc + 0) / cg) * pt, (5 + (4 * cc + 1) / cg) * pt,
                     (5 + (4 * cc + 2) / cg) * pt, (5 + (4 * cc + 3) / cg) * pt};
  float4* dst = scratch + static_cast<long long>(b) * cells * c4 + cc;
  const float4 r =
      q < npix ? bf16x4_to_float4(ref[(static_cast<long long>(b) * hw + pix0 + q) * c4 + cc])
               : make_float4(0.f, 0.f, 0.f, 0.f);

  int cur = -1;        // base cell of the run being summed
  float4 a[4];         // the run's sum per corner
  for (int s0 = 0; s0 < n; s0 += chunk) {
    const int ns = min(chunk, n - s0);
    stage_records(rec, base, taps, grad, b, n, hw, groups, plane, pix0, npix, pt, s0, ns);
    __syncthreads();
    if (q < npix) {
      for (int u = 0; u < ns; ++u) {
        const float* rc = rec + u * fields * pt + q;
        const int idx = __float_as_int(rc[0]);
        if (idx < 0 || idx >= cells) {
          atomicAdd(dst, make_float4(CUDART_NAN_F, CUDART_NAN_F, CUDART_NAN_F, CUDART_NAN_F));
          continue;
        }
        const float4 rg = make_float4(r.x * (rc[gf[0]] / cg_f), r.y * (rc[gf[1]] / cg_f),
                                      r.z * (rc[gf[2]] / cg_f), r.w * (rc[gf[3]] / cg_f));
        if (idx != cur) {
          add_corners(dst, cur, a, h1, w1, c4);
          cur = idx;
#pragma unroll
          for (int k = 0; k < 4; ++k) a[k] = make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float t = rc[(1 + k) * pt];
          a[k].x += t * rg.x;
          a[k].y += t * rg.y;
          a[k].z += t * rg.z;
          a[k].w += t * rg.w;
        }
      }
    }
    __syncthreads();
  }
  if (q < npix) add_corners(dst, cur, a, h1, w1, c4);
}

// d_src = bf16(scratch), 8 values a thread.
__global__ void round_to_bf16_kernel(const float4* __restrict__ scratch,
                                     uint4* __restrict__ d_src, long long vecs) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= vecs) return;
  const float4 lo = scratch[2 * i];
  const float4 hi = scratch[2 * i + 1];
  const float f[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  d_src[i] = float_to_bf16x8(f);
}

}  // namespace

// ref: [batch, hw, c] bf16. base: [batch, n*hw] int32. taps: [4, batch,
// n*hw] bf16. grad: [batch, n, groups, hw] f32. scratch: [batch, h1, w1,
// c] f32, zero-filled here. d_src: [batch, h1, w1, c] bf16. All
// contiguous, ref, scratch and d_src 16-byte aligned; c % 8 == 0, c <=
// 1024, c % groups == 0.
// Returns the memset's error or cudaGetLastError() after the launches (0
// on success).
extern "C" int itermvs_sweep_grad_src_bf16(const void* ref, const int* base,
                                           const void* taps, const float* grad,
                                           float* scratch, void* d_src, int batch,
                                           int n, int hw, int h1, int w1, int c,
                                           int groups, void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long values = static_cast<long long>(batch) * h1 * w1 * c;
  if (values == 0) return 0;
  const cudaError_t err =
      cudaMemsetAsync(scratch, 0, static_cast<size_t>(values) * sizeof(float), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int c4 = c / 4;
  if (static_cast<long long>(n) * hw > 0) {
    const RecordTiles t(n, c4, groups);
    const long long blocks = static_cast<long long>(batch) * ((hw + t.pt - 1) / t.pt);
    sweep_grad_src_bf16_kernel<<<static_cast<unsigned>(blocks), t.pt * c4, t.smem_bytes(),
                                 stream>>>(
        static_cast<const uint2*>(ref), base, static_cast<const __nv_bfloat16*>(taps), grad,
        reinterpret_cast<float4*>(scratch), batch, n, hw, h1, w1, c4, groups, t.pt,
        t.chunk);
    const cudaError_t launched = cudaGetLastError();
    if (launched != cudaSuccess) return static_cast<int>(launched);
  }
  const long long vecs = values / 8;
  round_to_bf16_kernel<<<static_cast<unsigned>((vecs + 255) / 256), 256, 0, stream>>>(
      reinterpret_cast<const float4*>(scratch), static_cast<uint4*>(d_src), vecs);
  return static_cast<int>(cudaGetLastError());
}
