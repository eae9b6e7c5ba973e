// K30 view_weight: the tail of PixelViewWeight in the init sweep, the
// per-pixel weight of each source view from its 32 samples' logits x
// [planes, 32, h, w] in T (float32 or bfloat16, as the last convolution
// leaves them; planes = batch · sources), and its ×2 bilinear resize, in
// one launch:
//     w  = max_d softmax_d(float(x))     [planes, h, w]      float32
//     up = F.interpolate(w, ×2)          [planes, 2h, 2w]    float32
// w is what K11 aggregates the init sweep's views with, up what the
// iterations read.
//
// Replaces: the XLA fusions of PixelViewWeight's softmax and max
// (itermvs_tpu/models/itermvs.py:154-155) and of the view weights' ×2
// resize (:255). In the port: `.float()` (bfloat16 only), torch.softmax,
// amax and K28 resize_bilinear, 3 launches in float32 and 4 in bfloat16,
// each writing its result to device memory and the next reading it.
//
// What bounds it on an H100: memory. It reads x once and writes w and up
// once; per pixel 32 expf, 32 subtractions, sums, quotients and
// comparisons, and per output the ×2 formula's 9 operations.
//
// Design (sample_softmax.cuh): a block per 6 x 30 tile of one plane and a
// thread per pixel of the tile and its one-pixel halo. Each thread reads
// its pixel's 32 samples (a warp reads 32 neighbouring pixels of each
// sample, 128 or 64 contiguous bytes), takes their softmax as PyTorch's
// spatial softmax does and the max of the 32 quotients (so w is
// bit-equal to the eager chain on the card), puts it in shared memory and,
// inside the tile, stores it to w; after one barrier each tile pixel
// writes its 2 x 2 outputs of up (two float2 stores). A halo pixel costs
// a second read of its samples, mostly from L2: the window is 256
// pixels for 180 of tile.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sample_softmax.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(kThreads)
view_weight_kernel(const T* __restrict__ x, float* __restrict__ w, float* __restrict__ up,
                   int h, int wd) {
  __shared__ float v[kHaloRows][kHaloCols];
  const Window at(h, wd);
  const long long hw = static_cast<long long>(h) * wd;
  const long long plane = blockIdx.z;
  const SampleSoftmax sm(x + plane * kSamples * hw + static_cast<long long>(at.i) * wd + at.j,
                         hw);
  float best = sm.p(0);
#pragma unroll
  for (int d = 1; d < kSamples; ++d) best = fmaxf(best, sm.p(d));
  v[at.r][at.c] = best;
  __syncthreads();
  if (!at.inner(h, wd)) return;
  w[plane * hw + static_cast<long long>(at.ti) * wd + at.tj] = best;
  write_up2(v, at.r, at.c, at.ti, at.tj, up + plane * 4 * hw, wd);
}

template <typename T>
int launch(const void* x, void* w, void* up, long long planes, int h, int wd, void* stream) {
  if (planes <= 0 || h <= 0 || wd <= 0) return 0;
  const dim3 grid = window_grid(planes, h, wd);
  if (grid.x == 0 || reinterpret_cast<unsigned long long>(up) % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  view_weight_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<float*>(w), static_cast<float*>(up), h, wd);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: [planes, 32, h, w] of float32 (itermvs_view_weight) or bfloat16
// (_bf16); w: [planes, h, w] and up: [planes, 2h, 2w], float32; all
// contiguous. Returns the launch's error (0 on success).
extern "C" int itermvs_view_weight(const void* x, void* w, void* up, long long planes, int h,
                                   int wd, void* stream) {
  return launch<float>(x, w, up, planes, h, wd, stream);
}

extern "C" int itermvs_view_weight_bf16(const void* x, void* w, void* up, long long planes,
                                        int h, int wd, void* stream) {
  return launch<__nv_bfloat16>(x, w, up, planes, h, wd, stream);
}
