// The per-row streams of the plane sweep's backward (K4 sweep_grad_ref,
// K5 sweep_grad_src), staged in shared memory a block at a time.
//
// Both kernels read, per (sample, pixel) row, the base index, 4 taps and
// G gradient words: base [B, n*HW], taps [4, B, n*HW], grad [B, n, G, HW].
// A block takes `pt` consecutive pixels of one batch and copies these
// words for a chunk of samples into shared memory, field by field, with
// consecutive threads on consecutive pixels: whole sectors, every load
// independent of the others. Read from the thread of each (pixel, float4
// lane) instead, a warp covered only 32/(C/4) pixels per load and waited
// for the index before the rest.
//
// The taps are float32 or bfloat16 (the features' dtype); the records
// hold them as float32 either way.
#pragma once

#include <cuda_runtime.h>

#include "bf16_lanes.cuh"

// Block shape: `pt` pixels (a power of two, at most 32, at most 256
// threads of `c4` vector lanes each; C/4 lanes, float32 and K5's bfloat16
// form: 32 pixels at C = 16 or 32, 16 at C = 48; C/8 lanes, K4's bfloat16
// form: 32 pixels) and `chunk` samples of records (at most 32, within 48
// KB).
struct RecordTiles {
  int pt = 1;
  int chunk = 1;
  int fields;

  RecordTiles(int n, int c4, int groups) : fields(5 + groups) {
    while (2 * pt <= 32 && 2 * pt * c4 <= 256) pt *= 2;
    chunk = 48 * 1024 / (fields * pt * static_cast<int>(sizeof(float)));
    chunk = chunk > 32 ? 32 : chunk;
    chunk = n > 0 && chunk > n ? n : chunk;
  }
  size_t smem_bytes() const { return static_cast<size_t>(chunk) * fields * pt * sizeof(float); }
};

// Samples [s0, s0 + ns) of pixels [pix0, pix0 + npix) of batch b:
// rec[(u * fields + f) * pt + q] for sample s0 + u, pixel pix0 + q and
// field f: the index (its bits), tap k at 1 + k, gradient word j at 5 + j.
template <typename Tap>
__device__ __forceinline__ void stage_records(float* rec, const int* __restrict__ base,
                                              const Tap* __restrict__ taps,
                                              const float* __restrict__ grad, int b, int n,
                                              int hw, int groups, long long plane, int pix0,
                                              int npix, int pt, int s0, int ns) {
  const int fields = 5 + groups;
  const long long p = static_cast<long long>(n) * hw;
  for (int i = threadIdx.x; i < ns * pt; i += blockDim.x) {
    const int u = i / pt;
    const int q = i - u * pt;
    if (q >= npix) continue;
    const int s = s0 + u;
    const long long row = b * p + static_cast<long long>(s) * hw + pix0 + q;
    float* r = rec + u * fields * pt + q;
    r[0] = __int_as_float(base[row]);
#pragma unroll
    for (int k = 0; k < 4; ++k) r[(1 + k) * pt] = tap_float(taps[k * plane + row]);
    const float* g = grad + (static_cast<long long>(b) * n + s) * groups * hw + pix0 + q;
    for (int j = 0; j < groups; ++j) r[(5 + j) * pt] = g[static_cast<long long>(j) * hw];
  }
}
