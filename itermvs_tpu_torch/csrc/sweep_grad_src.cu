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
// What bounds it on an H100: its bytes (each stream read once, d_src
// written once) are ~13 us per launch at the init sweep of a 640x512
// training step, but a scatter is bound first by the reductions the L2
// serves. The first version of this kernel issued 4*C scalar f32 atomics
// per row, ~2e9 per training step at ~160 G/s, as fast where 128 adds
// land on one cell (the init sweep) as where barely any collide (the
// finest level): the count of operations, not contention, bound it.
//
// Design: a quarter of the operations, and fewer rows. A block takes
// `pt` pixels and stages their per-row streams in shared memory
// (sweep_records.cuh). One thread per (pixel, float4 lane) reads its
// reference float4 once and walks the samples in order; consecutive
// samples on the same base cell (a sub-pixel disparity step) are summed
// in registers, and each run is added into its up to 4 corners with one
// float4 vector reduction (red.global.add.v4.f32, compute capability 9.x)
// per corner and lane, into the d_src the launcher zero-fills. Summing
// runs first also keeps a pile-up accurate: 163,840 rows on one cell land
// as 5,120 partial sums. The order in which runs of different threads
// arrive changes from run to run: d_src's last bits do too. An
// atomic-free transpose (a counting sort of the rows by base cell, then
// one thread per cell and lane summing its rows in row order: bit-equal
// from run to run) was 2.6 times slower per training step: its gather
// reads the row streams 4 times, in bucket order, scattered. A base index
// outside [0, H1*W1) is an upstream fault: the row adds NaN to its lane
// of the batch's first cell, so the fault shows in d_src instead of being
// skipped.
#include <cuda_runtime.h>
#include <math_constants.h>

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

__global__ void sweep_grad_src_kernel(const float4* __restrict__ ref,
                                      const int* __restrict__ base,
                                      const float* __restrict__ taps,
                                      const float* __restrict__ grad,
                                      float4* __restrict__ d_src, int batch, int n, int hw,
                                      int h1, int w1, int c4, int groups, int pt, int chunk) {
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
  float4* dst = d_src + static_cast<long long>(b) * cells * c4 + cc;
  const float4 r = q < npix ? ref[(static_cast<long long>(b) * hw + pix0 + q) * c4 + cc]
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

}  // namespace

// ref: [batch, hw, c] f32. base: [batch, n*hw] int32. taps: [4, batch,
// n*hw] f32. grad: [batch, n, groups, hw] f32. d_src: [batch, h1, w1, c]
// f32, zero-filled here. All contiguous, ref and d_src 16-byte aligned;
// c % 4 == 0, c <= 1024, c % groups == 0.
// Returns the memset's error or cudaGetLastError() after the launch (0 on
// success).
extern "C" int itermvs_sweep_grad_src(const float* ref, const int* base,
                                      const float* taps, const float* grad,
                                      float* d_src, int batch, int n, int hw,
                                      int h1, int w1, int c, int groups,
                                      void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const size_t bytes = static_cast<size_t>(batch) * h1 * w1 * c * sizeof(float);
  if (bytes == 0) return 0;
  const cudaError_t err = cudaMemsetAsync(d_src, 0, bytes, stream);
  if (err != cudaSuccess || static_cast<long long>(n) * hw == 0) return static_cast<int>(err);
  const int c4 = c / 4;
  const RecordTiles t(n, c4, groups);
  const long long blocks = static_cast<long long>(batch) * ((hw + t.pt - 1) / t.pt);
  sweep_grad_src_kernel<<<static_cast<unsigned>(blocks), t.pt * c4, t.smem_bytes(),
                          stream>>>(
      reinterpret_cast<const float4*>(ref), base, taps, grad, reinterpret_cast<float4*>(d_src),
      batch, n, hw, h1, w1, c4, groups, t.pt, t.chunk);
  return static_cast<int>(cudaGetLastError());
}
