// K4 sweep_grad_ref, bfloat16 form: gradient of the plane-sweep group
// correlation with respect to bfloat16 reference features.
//
// Replaces: the reference-feature half of the XLA autodiff of
// itermvs_tpu/models/itermvs.py `chunked_warp_corr` in the JAX package's
// bfloat16 mode (bfloat16 tables and taps, float32 correlation), i.e. the
// transpose of K2 sweep_premul followed by K1 corr_epilogue. With g' =
// grad_corr[b, s, grp(ch), pix] / (C/G), float32:
//     d_ref[b, pix, ch] = bf16( sum_s g' * sum_k tap_k[b, s, pix]
//                                          * src[b, y_k, x_k, ch] )
// over corners k = (y, x), (y, x+1), (y+1, x), (y+1, x+1) of the base
// index base[b, s*HW + pix] = y*W1 + x, summed in float32 in the plain
// version's order (ops/sweep_grad.py `sweep_grad_ref_plain`: the corners,
// then g', then the samples) and rounded to bfloat16 once. A +1 corner
// past the image edge adds nothing. Entry point:
// itermvs_sweep_grad_ref_bf16 (the float32 form is csrc/sweep_grad_ref.cu).
//
// What bounds it on an H100: its bytes would (per (sample, pixel) one
// index, 4 bfloat16 taps and G float32 gradient words; 0.371 ms per
// 640x512, batch 4 training step), but the float32 kernel's design, which
// this one had, spent its time elsewhere: without its corner gathers it
// still took 88% of its time. Each thread divided its 8 gradient words by
// C/G and split the index for every sample, the lanes of a pixel read
// words of different groups from one shared-memory bank, and at the init
// sweep 48 KB of staged records held 4 blocks on an SM.
//
// Design: a block takes `pt` consecutive pixels of one batch and stages
// the rows of a chunk of samples in shared memory with grad_rows.cuh,
// which splits each index into (y, x) and divides each gradient word once
// per row, pads each field so the lanes' words fall in different banks,
// and keeps a chunk within 24 KB. One thread per (pixel, 8-value lane)
// walks the chunk's samples in order, gathers the 4 corners of each as one
// 16-byte load each (from L1, which holds a block's source cells: a copy
// of them in shared memory was measured slower), sums tap * src over the
// corners, multiplies by g' and adds into float32 registers, and writes
// its 8 values of d_ref once, rounded: no atomics, the same bits every
// launch. At most 51 registers a thread (48 used, 4 bytes spilled): where
// C = 16 a block has 64 threads and the registers decide how many an SM
// holds. A base
// index outside [0, H1*W1) makes the pixel's d_ref NaN. Measured on
// "NVIDIA H100 80GB HBM3, 700.00 W" (tools/time_sweep_grad.py --dtype
// bfloat16): 1.47 ms per training step (1.25 of device time), against
// 1.62-1.79 (1.54-1.56) for the float32 kernel's design in the same run;
// on the sweeps of a real step (`--captures`) 1.32 against 1.72-1.78.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "bf16_lanes.cuh"
#include "grad_rows.cuh"

namespace {

// Shared memory for the staged rows, bytes.
constexpr int kRowBytes = 24 * 1024;

__global__ void __launch_bounds__(256, 5) sweep_grad_ref_bf16_kernel(
    const uint4* __restrict__ src, const int* __restrict__ base,
    const __nv_bfloat16* __restrict__ taps, const float* __restrict__ grad,
    uint4* __restrict__ d_ref, int batch, int n, int hw, int h1, int w1, int c8, int groups,
    int pt, int chunk) {
  extern __shared__ float row[];
  const int fields = kRowGrad + groups;
  const int pitch = pt + 4;            // words of a field (grad_rows.cuh)
  const int tiles = (hw + pt - 1) / pt;
  const int b = blockIdx.x / tiles;
  const int pix0 = (blockIdx.x - b * tiles) * pt;
  const int npix = min(pt, hw - pix0);
  const long long plane = static_cast<long long>(batch) * n * hw;   // one corner's taps
  const int cc = threadIdx.x % c8;     // 8-value lane within the channels
  const int q = threadIdx.x / c8;      // pixel within the block
  const int cg = 8 * c8 / groups;
  int gf[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) gf[j] = (kRowGrad + (8 * cc + j) / cg) * pitch;
  const uint4* src_b = src + static_cast<long long>(b) * h1 * w1 * c8 + cc;

  float acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0.f;
  bool fault = false;
  for (int s0 = 0; s0 < n; s0 += chunk) {
    const int ns = min(chunk, n - s0);
    stage_rows(row, base, taps, grad, b, n, hw, h1, w1, groups, static_cast<float>(cg), plane,
               pix0, npix, pt, s0, ns);
    __syncthreads();
    if (q < npix) {
#pragma unroll 2
      for (int u = 0; u < ns; ++u) {
        const float* f = row + u * fields * pitch + q;
        const int y = __float_as_int(f[kRowY * pitch]);
        if (y < 0) {
          fault = true;
          continue;
        }
        const int x = __float_as_int(f[kRowX * pitch]);
        // sum_k tap_k * src[corner k], then times g': the plain version's order.
        float s[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) s[j] = 0.f;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int yk = y + (k >> 1);
          const int xk = x + (k & 1);
          if (yk < h1 && xk < w1) {
            const float t = f[(kRowTap + k) * pitch];
            float v[8];
            bf16x8_to_float(src_b[static_cast<long long>(yk * w1 + xk) * c8], v);
#pragma unroll
            for (int j = 0; j < 8; ++j) s[j] += t * v[j];
          }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[j] += s[j] * f[gf[j]];
      }
    }
    __syncthreads();
  }
  if (q >= npix) return;
  if (fault) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = CUDART_NAN_F;
  }
  d_ref[(static_cast<long long>(b) * hw + pix0 + q) * c8 + cc] = float_to_bf16x8(acc);
}

}  // namespace

// src: [batch, h1, w1, c] bf16 NHWC. base: [batch, n*hw] int32. taps: [4,
// batch, n*hw] bf16. grad: [batch, n, groups, hw] f32. d_ref: [batch, hw,
// c] bf16 (every element written). All contiguous, src and d_ref 16-byte
// aligned; c % 8 == 0, c <= 1024, c % groups == 0.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int itermvs_sweep_grad_ref_bf16(const void* src, const int* base,
                                           const void* taps, const float* grad,
                                           void* d_ref, int batch, int n, int hw,
                                           int h1, int w1, int c, int groups,
                                           void* stream) {
  if (static_cast<long long>(batch) * hw <= 0) return 0;
  const int c8 = c / 8;
  const RowTiles t(n, c8, groups, kRowBytes);
  const long long blocks = static_cast<long long>(batch) * ((hw + t.pt - 1) / t.pt);
  sweep_grad_ref_bf16_kernel<<<static_cast<unsigned>(blocks), t.pt * c8, t.smem_bytes(),
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(src), base, static_cast<const __nv_bfloat16*>(taps), grad,
      static_cast<uint4*>(d_ref), batch, n, hw, h1, w1, c8, groups, t.pt, t.chunk);
  return static_cast<int>(cudaGetLastError());
}
