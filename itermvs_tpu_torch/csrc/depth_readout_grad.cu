// K7 depth_readout_grad: the backward of K6 (depth_readout.cu), the
// gradient of the depth-head logits through the 256-bin softmax and the
// windowed expectation, one pixel per thread.
//
// Replaces: XLA's autodiff of itermvs_tpu/models/itermvs.py:75
// `windowed_expectation` and of the `jax.nn.softmax` before it (:402,
// :413), with the argmax held constant (stop-gradient). With r, S and idx
// from the forward, the window weights w_k, c = dd / (255 (1e-6 + S)):
//     g_k  = dp_k + c w_k (k - r)
//     dl_k = p_k (g_k - sum_j p_j g_j)
// dp is the gradient of the probability (the loss's cross-entropy reads
// it), dd that of the normalized depth; either may be absent (null: 0).
// dl comes out in the logits' dtype, rounded once (bf16: round to nearest
// even, the gradient of the forward's float32 cast).
//
// What bounds it on an H100: memory. Per pixel it reads 256 values of p
// and of dp and writes 256 of dl (3 KB in f32), with a few operations per
// byte.
//
// Design (simple and right): one thread per pixel, coalesced across a
// warp's pixels at stride H*W. A first pass sums p_k g_k; a second reads
// p and dp again, from the last bin down (the first pass's last bins are
// the likeliest to be still in L2), and writes dl. The rest of the
// second read comes from device memory, so the kernel moves up to 5/3 of
// its bound's bytes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBins = 256;
constexpr int kRadius = 4;
constexpr int kThreads = 128;
constexpr int kChunk = 16;

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// g_k's window term: w_k (k - r), 0 outside the window.
__device__ __forceinline__ float window_term(int k, int idx, float r) {
  const int d = k - idx;
  if (d < -kRadius || d > kRadius) return 0.f;
  int w = 1;
  if (k == 0) w += max(0, kRadius - idx);
  if (k == kBins - 1) w += max(0, idx + kRadius - (kBins - 1));
  return static_cast<float>(w) * (static_cast<float>(k) - r);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
depth_readout_grad_kernel(const float* __restrict__ prob, const float* __restrict__ d_prob,
                          const float* __restrict__ d_depth, const int* __restrict__ index,
                          const float* __restrict__ mass, const float* __restrict__ regress,
                          T* __restrict__ d_logits, int hw, long long pixels) {
  const long long pix = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (pix >= pixels) return;
  const long long b = pix / hw;
  const long long q = pix - b * hw;
  const long long plane = b * kBins * hw + q;
  const float* p = prob + plane;
  const float* dp = d_prob == nullptr ? nullptr : d_prob + plane;
  const int idx = index[pix];
  const float r = regress[pix];
  const float c = d_depth == nullptr ? 0.f : d_depth[pix] / (255.f * (1e-6f + mass[pix]));

  float dot = 0.f;
  for (int k0 = 0; k0 < kBins; k0 += kChunk) {
    float pv[kChunk], gv[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const long long o = static_cast<long long>(k0 + j) * hw;
      pv[j] = p[o];
      gv[j] = dp == nullptr ? 0.f : dp[o];
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
      dot += pv[j] * (gv[j] + c * window_term(k0 + j, idx, r));
  }

  // From the last bin down: the first pass's last bins are still in L2.
  T* out = d_logits + plane;
  for (int k0 = kBins - kChunk; k0 >= 0; k0 -= kChunk) {
    float pv[kChunk], gv[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const long long o = static_cast<long long>(k0 + j) * hw;
      pv[j] = p[o];
      gv[j] = dp == nullptr ? 0.f : dp[o];
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const float g = gv[j] + c * window_term(k0 + j, idx, r);
      store(out + static_cast<long long>(k0 + j) * hw, pv[j] * (g - dot));
    }
  }
}

template <typename T>
int launch(const float* prob, const float* d_prob, const float* d_depth, const int* index,
           const float* mass, const float* regress, void* d_logits, int batch, int hw,
           void* stream) {
  const long long pixels = static_cast<long long>(batch) * hw;
  if (pixels <= 0) return 0;
  const long long blocks = (pixels + kThreads - 1) / kThreads;
  depth_readout_grad_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      prob, d_prob, d_depth, index, mass, regress, static_cast<T*>(d_logits), hw, pixels);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// prob, d_prob: [batch, 256, hw] float32, contiguous (d_prob may be null).
// d_depth ([batch, hw] float32, may be null), index ([batch, hw] int32),
// mass, regress ([batch, hw] float32): as K6 wrote them. d_logits:
// [batch, 256, hw], float32 or bfloat16 by the symbol.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int itermvs_depth_readout_grad(const float* prob, const float* d_prob,
                                          const float* d_depth, const int* index,
                                          const float* mass, const float* regress,
                                          void* d_logits, int batch, int hw, void* stream) {
  return launch<float>(prob, d_prob, d_depth, index, mass, regress, d_logits, batch, hw,
                       stream);
}

extern "C" int itermvs_depth_readout_grad_bf16(const float* prob, const float* d_prob,
                                               const float* d_depth, const int* index,
                                               const float* mass, const float* regress,
                                               void* d_logits, int batch, int hw,
                                               void* stream) {
  return launch<__nv_bfloat16>(prob, d_prob, d_depth, index, mass, regress, d_logits,
                               batch, hw, stream);
}
