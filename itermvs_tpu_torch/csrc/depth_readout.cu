// K6 depth_readout: the 256-bin depth-head softmax and the windowed
// expectation of the normalized depth, one pixel per thread.
//
// Replaces: the XLA chain of itermvs_tpu/models/itermvs.py:75
// `windowed_expectation` with the `jax.nn.softmax` of the depth-head
// logits before it (:402, :413). On the port's NCHW layout, per pixel:
//     p_k   = exp(l_k - max l) / sum_j exp(l_j - max l)
//     idx   = argmax_k p_k (the first on ties), held constant
//     w_k   = [|k - idx| <= 4] + max(0, 4 - idx) [k == 0]
//             + max(0, idx + 4 - 255) [k == 255]
//     S     = sum_k w_k p_k,   r = sum_k w_k p_k k / (1e-6 + S)
//     depth = r / 255
// In training the kernel also writes p (the loss reads it) and idx, S and
// r, which the backward (K7, depth_readout_grad.cu) reads instead of
// searching the argmax again. In eval nothing reads p and it is not
// written.
//
// What bounds it on an H100: memory. Per pixel it reads 256 logits (1 KB
// in f32, 512 B in bf16) and writes 4 bytes, plus 1 KB of p in training;
// a few hundred operations per pixel, far below the card's balance point.
//
// Design (simple and right): one thread per pixel, so that a warp's loads
// of one bin are 32 neighbouring pixels, coalesced at stride H*W. A first
// pass over the logits, from the last bin down, finds the maximum, its
// first bin and the largest logit before that bin; a second sums
// exp(l - max) in float32 from bin 0 up (where the first pass ended, so
// part of it is still in L2), as PyTorch's softmax over a non-minor dimension does at these
// sizes (one thread per position), so that p = exp(l - max) / sum
// matches the plain version bit for bit where the two expf agree; then
// the 9 window bins are read again. (An online one-pass form reads the
// logits once, but its rescaled sum differs from the plain version's:
// a float32 sum of 256 terms in bin order is itself off by up to ~1e-6,
// beyond the gate on p.) The plain version's argmax is that of p:
// logits within about 2^-25 of the maximum give exp = 1 and tie in p, and
// then the first such bin wins, not the largest logit. p does not
// decrease with the logit, so when the largest logit before the first
// maximum does not tie it in p, that maximum is the argmax; otherwise the
// bins before it are read once more to find the first tie. Training adds
// a pass that writes p. Softmax in f32 with expf (no fast math: the build
// has none). The logits are read two times (three in training), so the
// kernel moves about twice its bound's bytes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kBins = 256;
constexpr int kRadius = 4;
constexpr int kThreads = 128;
constexpr int kChunk = 16;       // logits loaded ahead per thread

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// Window weight of bin k around argmax idx (0 outside the window).
__device__ __forceinline__ float window_weight(int k, int idx) {
  const int d = k - idx;
  if (d < -kRadius || d > kRadius) return 0.f;
  int w = 1;
  if (k == 0) w += max(0, kRadius - idx);
  if (k == kBins - 1) w += max(0, idx + kRadius - (kBins - 1));
  return static_cast<float>(w);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
depth_readout_kernel(const T* __restrict__ logits, float* __restrict__ depth,
                     float* __restrict__ prob, int* __restrict__ index,
                     float* __restrict__ mass, float* __restrict__ regress,
                     int hw, long long pixels) {
  const long long pix = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (pix >= pixels) return;
  const long long b = pix / hw;
  const long long q = pix - b * hw;
  const long long plane = b * kBins * hw + q;
  const T* x = logits + plane;

  // Pass 1, from the last bin down (so that the sum's pass, from bin 0
  // up, finds the bins read last still in L2): the maximum, its first
  // bin, and the largest logit before that bin, restarted whenever an
  // earlier bin reaches the maximum.
  float m = -INFINITY;
  float before = -INFINITY;
  int first = kBins - 1;
  for (int k0 = kBins - kChunk; k0 >= 0; k0 -= kChunk) {
    float v[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) v[j] = to_float(x[static_cast<long long>(k0 + j) * hw]);
#pragma unroll
    for (int j = kChunk - 1; j >= 0; --j) {
      if (k0 + j == kBins - 1 || v[j] >= m) {
        m = v[j];
        first = k0 + j;
        before = -INFINITY;
      } else {
        before = fmaxf(before, v[j]);
      }
    }
  }
  // Pass 2: sum exp(l - max), float32, in bin order.
  float s = 0.f;
  for (int k0 = 0; k0 < kBins; k0 += kChunk) {
    float v[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) v[j] = to_float(x[static_cast<long long>(k0 + j) * hw]);
#pragma unroll
    for (int j = 0; j < kChunk; ++j) s = __fadd_rn(s, expf(__fsub_rn(v[j], m)));
  }
  // argmax of p: p is non-decreasing in the logit, so the ties of the
  // maximum are the logits at or above some threshold, and `before` is
  // the largest logit ahead of `first`.
  const float p_max = __fdiv_rn(1.f, s);
  int idx = first;
  if (first > 0 && __fdiv_rn(expf(__fsub_rn(before, m)), s) == p_max) {
    for (int k = 0; k < first; ++k) {
      if (__fdiv_rn(expf(__fsub_rn(to_float(x[static_cast<long long>(k) * hw]), m)), s) == p_max) {
        idx = k;
        break;
      }
    }
  }

  // The window, in the plain version's order (p * w, then the
  // product with the bin index).
  const int lo = max(idx - kRadius, 0);
  const int hi = min(idx + kRadius, kBins - 1);
  float total = 0.f, moment = 0.f;
  for (int k = lo; k <= hi; ++k) {
    const float p = __fdiv_rn(expf(__fsub_rn(to_float(x[static_cast<long long>(k) * hw]), m)), s);
    const float pw = __fmul_rn(p, window_weight(k, idx));
    total = __fadd_rn(total, pw);
    moment = __fadd_rn(moment, __fmul_rn(pw, static_cast<float>(k)));
  }
  const float r = __fdiv_rn(moment, __fadd_rn(1e-6f, total));
  depth[pix] = __fmul_rn(r, 1.0f / 255.0f);
  if (prob == nullptr) return;

  // Training: p itself, and what the backward reads.
  index[pix] = idx;
  mass[pix] = total;
  regress[pix] = r;
  float* out = prob + plane;
  for (int k0 = 0; k0 < kBins; k0 += kChunk) {
    float v[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) v[j] = to_float(x[static_cast<long long>(k0 + j) * hw]);
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
      out[static_cast<long long>(k0 + j) * hw] = __fdiv_rn(expf(__fsub_rn(v[j], m)), s);
  }
}

template <typename T>
int launch(const void* logits, float* depth, float* prob, int* index, float* mass,
           float* regress, int batch, int hw, void* stream) {
  const long long pixels = static_cast<long long>(batch) * hw;
  if (pixels <= 0) return 0;
  const long long blocks = (pixels + kThreads - 1) / kThreads;
  depth_readout_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(logits), depth, prob, index, mass, regress, hw, pixels);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// logits: [batch, 256, hw] contiguous (float32 or bfloat16). depth: [batch,
// hw] float32. prob ([batch, 256, hw] float32), index ([batch, hw] int32),
// mass and regress ([batch, hw] float32): all four, or all null (eval).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int itermvs_depth_readout(const void* logits, float* depth, float* prob,
                                     int* index, float* mass, float* regress,
                                     int batch, int hw, void* stream) {
  return launch<float>(logits, depth, prob, index, mass, regress, batch, hw, stream);
}

extern "C" int itermvs_depth_readout_bf16(const void* logits, float* depth, float* prob,
                                          int* index, float* mass, float* regress,
                                          int batch, int hw, void* stream) {
  return launch<__nv_bfloat16>(logits, depth, prob, index, mass, regress, batch, hw,
                               stream);
}
