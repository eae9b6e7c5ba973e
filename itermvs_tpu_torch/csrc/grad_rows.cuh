// The per-row streams of K4 sweep_grad_ref_bf16 (the plane sweep's
// bfloat16 backward for the reference features), staged in shared memory a
// block at a time, with the work that depends on the row alone done once
// per row.
//
// The kernel reads, per (sample, pixel) row, the base index, 4 bfloat16
// taps and G float32 gradient words: base [B, n*HW], taps [4, B, n*HW],
// grad [B, n, G, HW]. A block takes `pt` consecutive pixels of one batch
// and copies these words for a chunk of samples into shared memory, field
// by field, consecutive threads on consecutive pixels, as
// sweep_records.cuh does for the float32 kernels, but the staging thread
// also splits the index into its row and column and divides each gradient
// word by C/G (g' = grad / (C/G), the IEEE division the plain version
// makes): the threads of the row's channel lanes read the results, where
// each made its own integer division and one float division per channel
// before. K5 stages its rows with sweep_records.cuh: done once per row on
// the way to the block's barrier, the same work made it slower (4.0
// against 3.6 ms per training step on an H100). A field takes `pt + 4`
// words, not `pt`: the lanes of one pixel read the gradient words of
// different groups at once, and at a pitch of 32 words those all fell in
// one bank (an 8-way conflict at C = 32); 4 more words put the groups 4
// banks apart, past the pixels of a warp at C = 32.
#pragma once

#include <cuda_runtime.h>

#include "bf16_lanes.cuh"

// Fields of a row: y (-1 for a base index outside the map), x, taps 0-3,
// then g' of each group.
constexpr int kRowY = 0;
constexpr int kRowX = 1;
constexpr int kRowTap = 2;
constexpr int kRowGrad = 6;

// Block shape: `pt` pixels (a power of two, at most 32, with at most 256
// threads of `lanes` lanes each) and `chunk` samples of rows (at most 32,
// within `bytes`).
struct RowTiles {
  int pt = 1;
  int chunk = 1;
  int fields;

  RowTiles(int n, int lanes, int groups, int bytes) : fields(kRowGrad + groups) {
    while (2 * pt <= 32 && 2 * pt * lanes <= 256) pt *= 2;
    chunk = bytes / (fields * (pt + 4) * static_cast<int>(sizeof(float)));
    chunk = chunk > 32 ? 32 : chunk < 1 ? 1 : chunk;
    chunk = n > 0 && chunk > n ? n : chunk;
  }
  size_t smem_bytes() const {
    return static_cast<size_t>(chunk) * fields * (pt + 4) * sizeof(float);
  }
};

// Samples [s0, s0 + ns) of pixels [pix0, pix0 + npix) of batch b:
// row[(u * fields + f) * (pt + 4) + q] for sample s0 + u, pixel pix0 + q
// and field f.
__device__ __forceinline__ void stage_rows(float* row, const int* __restrict__ base,
                                           const __nv_bfloat16* __restrict__ taps,
                                           const float* __restrict__ grad, int b, int n,
                                           int hw, int h1, int w1, int groups, float cg,
                                           long long plane, int pix0, int npix, int pt,
                                           int s0, int ns) {
  const int fields = kRowGrad + groups;
  const int pitch = pt + 4;
  const long long p = static_cast<long long>(n) * hw;
  for (int i = threadIdx.x; i < ns * pt; i += blockDim.x) {
    const int u = i / pt;
    const int q = i - u * pt;
    if (q >= npix) continue;
    const int s = s0 + u;
    const long long r = b * p + static_cast<long long>(s) * hw + pix0 + q;
    float* f = row + u * fields * pitch + q;
    const int idx = base[r];
    const int y = idx / w1;
    const bool on_map = idx >= 0 && idx < h1 * w1;
    f[kRowY * pitch] = __int_as_float(on_map ? y : -1);
    f[kRowX * pitch] = __int_as_float(idx - y * w1);
#pragma unroll
    for (int k = 0; k < 4; ++k) f[(kRowTap + k) * pitch] = tap_float(taps[k * plane + r]);
    const float* g = grad + (static_cast<long long>(b) * n + s) * groups * hw + pix0 + q;
    for (int j = 0; j < groups; ++j)
      f[(kRowGrad + j) * pitch] = g[static_cast<long long>(j) * hw] / cg;
  }
}
