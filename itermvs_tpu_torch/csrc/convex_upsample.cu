// K9 convex_upsample: the 9-tap softmax of the mask logits and the x4
// convex upsample of the coarse normalized depth, one thread per (coarse
// pixel, sub-row).
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
// What bounds it on an H100: memory. Per coarse pixel it reads 144
// logits (576 B in f32, 288 B in bf16) and the 3x3 neighbourhood of the
// map, and writes 64 B; about 150 operations per pixel, far below the
// card's balance point.
//
// Design (simple and right): one thread per (coarse pixel, sub-row i),
// threads along W, so that each of a thread's 36 logit loads is a
// warp's 32 neighbouring pixels of one channel plane (coalesced, at
// stride H*W between planes). The thread reads its clamped 3x3
// neighbourhood once (neighbouring threads share it in L1) and writes
// its 4 sub-columns as one float4: consecutive threads write
// consecutive 16-byte pieces of an output row. The softmax follows the
// plain version's order (the maximum, the sum of exp(l - max) in tap
// order, then exp(l - max) / sum), and the 9-term sum runs in tap order,
// each operation rounded on its own (no FMA contraction; the build has
// no fast math).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kScale = 4;
constexpr int kTaps = 9;
constexpr int kChannels = kTaps * kScale * kScale;
constexpr int kThreads = 128;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// In place: the softmax of one sub-pixel's 9 logits.
__device__ __forceinline__ void softmax9(float (&v)[kTaps]) {
  float m = v[0];
#pragma unroll
  for (int k = 1; k < kTaps; ++k) m = fmaxf(m, v[k]);
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < kTaps; ++k) {
    v[k] = expf(__fsub_rn(v[k], m));
    s = __fadd_rn(s, v[k]);
  }
#pragma unroll
  for (int k = 0; k < kTaps; ++k) v[k] = __fdiv_rn(v[k], s);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
convex_upsample_kernel(const T* __restrict__ logits, const float* __restrict__ x,
                       float* __restrict__ up, int h, int w, int threads) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= threads) return;
  const int xc = t % w;
  int r = t / w;
  const int i = r % kScale;
  r /= kScale;
  const int y = r % h;
  const int b = r / h;
  const long long hw = static_cast<long long>(h) * w;

  // The clamped 3x3 neighbourhood, in tap order.
  const float* plane = x + b * hw;
  const int ys[3] = {max(y - 1, 0), y, min(y + 1, h - 1)};
  const int xs[3] = {max(xc - 1, 0), xc, min(xc + 1, w - 1)};
  float tap[kTaps];
#pragma unroll
  for (int k = 0; k < kTaps; ++k) tap[k] = __ldg(plane + ys[k / 3] * w + xs[k % 3]);

  const T* l = logits + b * kChannels * hw + static_cast<long long>(y) * w + xc;
  float out[kScale];
#pragma unroll
  for (int j = 0; j < kScale; ++j) {
    float v[kTaps];
#pragma unroll
    for (int k = 0; k < kTaps; ++k)
      v[k] = to_float(l[static_cast<long long>(k * kScale * kScale + i * kScale + j) * hw]);
    softmax9(v);
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < kTaps; ++k) acc = __fadd_rn(acc, __fmul_rn(v[k], tap[k]));
    out[j] = acc;
  }
  const long long row = (static_cast<long long>(b) * h + y) * kScale + i;
  *reinterpret_cast<float4*>(up + row * kScale * w + kScale * xc) =
      make_float4(out[0], out[1], out[2], out[3]);
}

template <typename T>
int launch(const void* logits, const float* x, float* up, int batch, int h, int w,
           void* stream) {
  const long long threads = static_cast<long long>(batch) * h * kScale * w;
  if (threads <= 0) return 0;
  if (threads > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<unsigned long long>(up) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const long long blocks = (threads + kThreads - 1) / kThreads;
  convex_upsample_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(logits), x, up, h, w, static_cast<int>(threads));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// logits: [batch, 144, h, w] contiguous (float32 or bfloat16). x: [batch,
// h, w] float32. up: [batch, 4h, 4w] float32, 16-byte aligned. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int itermvs_convex_upsample(const void* logits, const float* x, float* up,
                                       int batch, int h, int w, void* stream) {
  return launch<float>(logits, x, up, batch, h, w, stream);
}

extern "C" int itermvs_convex_upsample_bf16(const void* logits, const float* x, float* up,
                                            int batch, int h, int w, void* stream) {
  return launch<__nv_bfloat16>(logits, x, up, batch, h, w, stream);
}
