// K9 convex_upsample: the 9-tap softmax of the mask logits and the x4
// convex upsample of the coarse normalized depth, one thread per (pair of
// neighbouring coarse pixels, sub-row).
//
// Replaces: the XLA chain of itermvs_tpu/ops/upsample.py:13
// `convex_upsample` with the `jax.nn.softmax` of the mask logits before
// it (itermvs_tpu/models/itermvs.py:445-451 `_upsample_weights`). On the
// port's NCHW layout, per coarse pixel (y, x) and sub-pixel (i, j):
//     w_k            = softmax_k(l[k*16 + i*4 + j, y, x])  over the 9 taps
//     t_k            = x[clamp(y + dy), clamp(x + dx)]     (edge padding)
//     up[4y+i, 4x+j] = sum_k w_k t_k
// with tap k = (dy+1)*3 + (dx+1). The softmax and the output are float32,
// whatever the logits' dtype (the bf16 form reads bf16 logits as they
// are).
//
// What bounds it on an H100: memory, once the per-sub-pixel work is
// small. Per coarse pixel it reads 144 logits (576 B in f32, 288 B in
// bf16) and the 3x3 neighbourhood of the map, and writes 64 B. A first
// form (one thread per pixel and sub-row, scalar loads, 9 IEEE divides
// per softmax) ran bf16 only 1.18x faster than f32 on 1.8x fewer bytes:
// its pace was set by instructions, not bytes.
//
// Design (upsample_taps.cuh): the softmax with one reciprocal and 9
// products in place of 9 divides; a block of 32 pairs x the 4 sub-rows,
// a thread one pair and one sub-row i. On the paired path each of its 36
// logit loads is one 4-byte (bf16) or 8-byte (f32) word holding both
// pixels' logit of one channel, a warp's 32 threads on neighbouring
// words, all 36 issued before any is used; the pair's 3x4 neighbourhood
// is read once; its 8 sub-columns of output row 4y+i go out as two float4
// stores (32 contiguous bytes). The launch is a programmatic dependent
// launch (kProgrammatic): the blocks start while the stream's previous
// kernel drains and wait in cudaGridDependencySynchronize() before they
// read. The softmax follows the plain version's order (the maximum, the
// sum of exp(l - max) in tap order), and the 9-term sum runs in tap
// order, each operation rounded on its own (no FMA contraction; the build
// has no fast math).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>

#include "upsample_taps.cuh"

namespace {

// Whether the kernel is a programmatic dependent launch; PERF.md §6 has
// the timings that chose it.
constexpr bool kProgrammatic = true;

template <typename T, bool kPaired>
__global__ void __launch_bounds__(kThreads)
convex_upsample_kernel(const T* __restrict__ logits, const float* __restrict__ x,
                       float* __restrict__ up, int h, int w, int pairs) {
  const int gq = blockIdx.x * kGroups + threadIdx.x;
  if (gq >= pairs) return;
  const int i = threadIdx.y;
  const Pair g(gq, h, w);
  const long long hw = static_cast<long long>(h) * w;
  // Until the stream's previous kernel has completed (at once where this
  // is an ordinary launch).
  cudaGridDependencySynchronize();

  float tap[2][kTaps];
  neighbourhoods(x + g.b * hw, g.y, g.x0, h, w, tap);
  const T* l = logits + g.b * kChannels * hw + static_cast<long long>(g.y) * w + g.x0 +
               i * kScale * hw;
  Logits<T, kPaired> words[kScale];
#pragma unroll
  for (int j = 0; j < kScale; ++j) words[j].load(l + j * hw, hw, g.two);
  float out[2][kScale];
#pragma unroll
  for (int j = 0; j < kScale; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v[kTaps];
      words[j].get(e, v);
      softmax9(v);
      out[e][j] = convex9(v, tap[e]);
    }
  const long long row = (static_cast<long long>(g.b) * h + g.y) * kScale + i;
  float4* dst = reinterpret_cast<float4*>(up + row * kScale * w + kScale * g.x0);
  dst[0] = make_float4(out[0][0], out[0][1], out[0][2], out[0][3]);
  if (g.two) dst[1] = make_float4(out[1][0], out[1][1], out[1][2], out[1][3]);
}

template <typename T>
int launch(const void* logits, const float* x, float* up, int batch, int h, int w,
           void* stream) {
  const long long pairs = static_cast<long long>(batch) * h * ((w + 1) / 2);
  if (pairs <= 0) return 0;
  if (static_cast<long long>(batch) * h * w > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<unsigned long long>(up) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const bool paired =
      w % 2 == 0 && reinterpret_cast<unsigned long long>(logits) % (2 * sizeof(T)) == 0;
  return static_cast<int>(launch_kernel(
      kProgrammatic, paired ? convex_upsample_kernel<T, true> : convex_upsample_kernel<T, false>,
      dim3(static_cast<unsigned>((pairs + kGroups - 1) / kGroups)), dim3(kGroups, kScale),
      static_cast<cudaStream_t>(stream), static_cast<const T*>(logits), x, up, h, w,
      static_cast<int>(pairs)));
}

}  // namespace

// logits: [batch, 144, h, w] contiguous (float32 or bfloat16). x: [batch,
// h, w] float32. up: [batch, 4h, 4w] float32, 16-byte aligned. Returns
// the launch's error (0 on success).
extern "C" int itermvs_convex_upsample(const void* logits, const float* x, float* up,
                                       int batch, int h, int w, void* stream) {
  return launch<float>(logits, x, up, batch, h, w, stream);
}

extern "C" int itermvs_convex_upsample_bf16(const void* logits, const float* x, float* up,
                                            int batch, int h, int w, void* stream) {
  return launch<__nv_bfloat16>(logits, x, up, batch, h, w, stream);
}
