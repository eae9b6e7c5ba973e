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
// What bounds it on an H100: not its bytes (0.371 ms per 640x512, batch 4
// training step) but the float4 reductions the L2 serves, ~0.43 G per step
// (csrc/sweep_grad_src.cu), and the latency of short blocks: without its
// reductions the kernel still took ~70% of its time. The scratch this
// form sums into costs a zero fill and a rounding pass, ~0.3 ms per step.
//
// Design: the float32 kernel's, with one change. A block stages the
// per-row streams of `pt` pixels in shared memory (sweep_records.cuh,
// taps converted to float32); one thread per (pixel, 4-channel lane) reads
// its 4 reference values once (8 bytes), walks the samples in order and
// sums runs of consecutive samples on one base cell in float32 registers,
// which also keeps a pile-up accurate. Each run goes to its up to 4
// corners with one float4 vector reduction (red.global.add.v4.f32) per
// corner into a float32 scratch map that the launcher zero-fills, and a
// second kernel rounds the scratch to bfloat16 into d_src, 8 values a
// thread (bfloat16 atomics would accumulate in bfloat16). The change:
// before a run goes out, the runs of neighbouring pixels that end at the
// same sample merge in registers through warp shuffles where their corners
// meet (flush_runs): one reduction where there were two. In the sweep's
// regular pattern that halves the reductions where the source map has the
// reference grid's resolution or half of it (the init sweep, levels 2
// and 3); at level 1 (twice the resolution) no corners meet. A source
// window in shared memory, merging all of a block's runs there before they
// reach the L2, was built and measured slower in both forms: summed with
// shared float atomics (compare-and-swap loops on this card, no faster per
// value than a float4 reduction) 8.5 ms per step, and in lock step without
// atomics 5.6 ms, against 3.6 without either. All-zero sums are
// skipped (exact: the scratch starts at +0). The order in which reductions
// land changes from run to run, so the scratch's last bits do, and now and
// then a rounded value. A base index outside [0, H1*W1) adds NaN to its
// lane of the batch's first cell. Measured on "NVIDIA H100 80GB HBM3,
// 700.00 W" (tools/time_sweep_grad.py --dtype bfloat16): 3.26 ms per
// training step, against 3.62 without the merge and 3.26-3.30 for the
// float32 kernel; on the sweeps of a real step (`--captures`) 3.09
// against 3.15.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "bf16_lanes.cuh"
#include "sweep_records.cuh"

namespace {

// One float4 reduction into cell (y, x) where it lies on the map; an
// all-zero sum is skipped (exact: the scratch starts at +0).
__device__ __forceinline__ void add_corner(float4* dst, int y, int x, const float4 v, int h1,
                                           int w1, int c4) {
  if (y < h1 && x < w1 && (v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f))
    atomicAdd(dst + static_cast<long long>(y * w1 + x) * c4, v);
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float4 shfl4(float4 v, int lane) {
  return make_float4(__shfl_sync(0xffffffffu, v.x, lane), __shfl_sync(0xffffffffu, v.y, lane),
                     __shfl_sync(0xffffffffu, v.z, lane), __shfl_sync(0xffffffffu, v.w, lane));
}

// Warp-wide: every thread passes the cell of the run it ends now (-1: none)
// and the run's corner sums. Before they go to the scratch, the runs of
// neighbouring pixels (the same lane, `c4` threads apart in the warp) that
// end together merge where their corners meet: an odd pixel on its even
// left neighbour's cell hands it all 4 corners; a pixel one cell right of
// its left neighbour, on the same map row, hands it its left column (the
// neighbour's right column). A pixel that hands over all takes nothing, so
// nothing is handed on twice.
__device__ __forceinline__ void flush_runs(float4* dst, int cell, const float4* a, int q,
                                           int h1, int w1, int c4) {
  if (!__any_sync(0xffffffffu, cell >= 0)) return;
  const int lane = threadIdx.x & 31;
  const bool has_l = lane >= c4, has_ll = lane >= 2 * c4, has_r = lane + c4 < 32;
  const int cell_l = __shfl_sync(0xffffffffu, cell, has_l ? lane - c4 : lane);
  const int cell_ll = __shfl_sync(0xffffffffu, cell, has_ll ? lane - 2 * c4 : lane);
  const int cell_r = __shfl_sync(0xffffffffu, cell, has_r ? lane + c4 : lane);
  float4 ar[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) ar[k] = shfl4(a[k], has_r ? lane + c4 : lane);
  if (cell < 0) return;
  const int y = cell / w1;
  const int x = cell - y * w1;
  const bool gives_all = (q & 1) && has_l && cell_l == cell;
  const bool left_gives_all = !(q & 1) && has_ll && cell_l >= 0 && cell_ll == cell_l;
  const bool takes_all = !(q & 1) && has_r && cell_r == cell;
  const bool gives_col = has_l && !left_gives_all && cell_l >= 0 && x > 0 &&
                         cell_l == cell - 1;
  const bool takes_col = has_r && !gives_all && cell_r >= 0 && x + 1 < w1 &&
                         cell_r == cell + 1;
  if (gives_all) return;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float4 v = gives_col && !(k & 1) ? make_float4(0.f, 0.f, 0.f, 0.f) : a[k];
    if (takes_all) v = add4(v, ar[k]);
    if (takes_col && (k & 1)) v = add4(v, ar[k - 1]);
    add_corner(dst, y + (k >> 1), x + (k & 1), v, h1, w1, c4);
  }
}

// At most 64 registers a thread (80 unbounded, 20 bytes spilled): 4 blocks
// of 256 threads an SM in place of 3; 1.5-2.5% faster per training step.
__global__ void __launch_bounds__(256, 4) sweep_grad_src_bf16_kernel(
    const uint2* __restrict__ ref, const int* __restrict__ base,
    const __nv_bfloat16* __restrict__ taps, const float* __restrict__ grad,
    float4* __restrict__ scratch, int batch, int n, int hw, int h1, int w1, int c4,
    int groups, int pt, int chunk) {
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
#pragma unroll
  for (int k = 0; k < 4; ++k) a[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s0 = 0; s0 < n; s0 += chunk) {
    const int ns = min(chunk, n - s0);
    stage_records(rec, base, taps, grad, b, n, hw, groups, plane, pix0, npix, pt, s0, ns);
    __syncthreads();
    for (int u = 0; u < ns; ++u) {
      const float* rc = rec + u * fields * pt + q;
      const int idx = q < npix ? __float_as_int(rc[0]) : -1;
      const bool row = idx >= 0 && idx < cells;
      if (q < npix && !row)
        atomicAdd(dst, make_float4(CUDART_NAN_F, CUDART_NAN_F, CUDART_NAN_F, CUDART_NAN_F));
      const bool ends = row && idx != cur;
      flush_runs(dst, ends ? cur : -1, a, q, h1, w1, c4);
      if (!row) continue;
      if (ends) {
        cur = idx;
#pragma unroll
        for (int k = 0; k < 4; ++k) a[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      const float4 rg = make_float4(r.x * (rc[gf[0]] / cg_f), r.y * (rc[gf[1]] / cg_f),
                                    r.z * (rc[gf[2]] / cg_f), r.w * (rc[gf[3]] / cg_f));
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float t = rc[(1 + k) * pt];
        a[k].x += t * rg.x;
        a[k].y += t * rg.y;
        a[k].z += t * rg.z;
        a[k].w += t * rg.w;
      }
    }
    __syncthreads();
  }
  flush_runs(dst, cur, a, q, h1, w1, c4);
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
