// K32 init_depth: the init sweep's depth in training, from the CorrNet score
// s [batch, 32, h, w] float32 and each image's inverse depth bounds idmin,
// idmax [batch], in one launch:
//     p     = softmax(s) over the 32 samples
//     e     = Σ_d d · p_d
//     depth = 1 / (idmax + (e / 31) · (idmin − idmax))
//     out   = F.interpolate(depth, ×2)        [batch, 1, 2h, 2w] float32
// each operation rounded where the eager chain rounds it (sample_softmax.cuh:
// PyTorch's softmax, its order of the sum, the division by 31 as a product
// with the float reciprocal, 1 / x as an IEEE quotient), with no FMA
// across those roundings, so that out is bit-equal to it on the card.
//
// Replaces: the XLA fusion of the init depth's softmax, expectation and
// unnormalization (itermvs_tpu/models/itermvs.py:257-265) and of its ×2
// resize (:266). In the port: softmax, arange, three products, a sum, the
// division, a subtraction, an addition, a reciprocal and K28
// resize_bilinear, each a launch through device memory.
//
// What bounds it on an H100: memory. It reads s once and writes out once
// (36 floats per pixel of s's plane); per pixel 32 expf and quotients,
// 64 products and sums.
//
// Design: K30's (view_weight.cu): a block per 6 x 30 tile of one image, a
// thread per pixel of the tile and its one-pixel halo computing its
// depth into shared memory, then each tile pixel writing its 2 x 2
// outputs with K28's ×2 formula. The 1/8-scale depth never reaches device
// memory.
#include <cuda_runtime.h>

#include "sample_softmax.cuh"

namespace {

__global__ void __launch_bounds__(kThreads)
init_depth_kernel(const float* __restrict__ s, const float* __restrict__ idmin,
                  const float* __restrict__ idmax, float* __restrict__ out, int h, int wd) {
  __shared__ float v[kHaloRows][kHaloCols];
  const Window at(h, wd);
  const long long hw = static_cast<long long>(h) * wd;
  const long long b = blockIdx.z;
  const SampleSoftmax sm(s + b * kSamples * hw + static_cast<long long>(at.i) * wd + at.j, hw);
  float p[kSamples];
#pragma unroll
  for (int d = 0; d < kSamples; ++d) p[d] = sm.p(d);
  const float hi = __ldg(idmax + b);
  v[at.r][at.c] = init_depth_of(expectation(p), hi, __fsub_rn(__ldg(idmin + b), hi));
  __syncthreads();
  if (!at.inner(h, wd)) return;
  write_up2(v, at.r, at.c, at.ti, at.tj, out + b * 4 * hw, wd);
}

}  // namespace

// s: [batch, 32, h, w]; idmin, idmax: [batch]; out: [batch, 1, 2h, 2w];
// float32, contiguous. Returns the launch's error (0 on success).
extern "C" int itermvs_init_depth(const void* s, const void* idmin, const void* idmax, void* out,
                                  long long batch, int h, int wd, void* stream) {
  if (batch <= 0 || h <= 0 || wd <= 0) return 0;
  const dim3 grid = window_grid(batch, h, wd);
  if (grid.x == 0 || reinterpret_cast<unsigned long long>(out) % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  init_depth_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(s), static_cast<const float*>(idmin),
      static_cast<const float*>(idmax), static_cast<float*>(out), h, wd);
  return static_cast<int>(cudaGetLastError());
}
