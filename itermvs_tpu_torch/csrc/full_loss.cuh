// Shared by K23 full_loss and K24 full_loss_grad (ops/full_loss.py): the
// launch shape, the inputs, and the loss's per-pixel arithmetic, each
// operation rounded in float32 as PyTorch's kernels round the eager loss's
// (no contraction: the _rn intrinsics), so that the masks, the GT bin, the
// argmax window and the confidence target decide as the eager loss does.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLevel0 = 4;          // level-0 pixels per thread
constexpr int kMaxPred = 16;        // predictions (pointer arrays by value)
constexpr int kMaxTerms = 2 + 3 * kMaxPred;
constexpr int kBins = 256;
constexpr int kRadius = 4;
constexpr float kPMin = 1e-5f;
constexpr float kConfThreshold = 0.002f;

// One float32 plane per prediction.
struct Planes {
  const float* p[kMaxPred];
};

// The loss's inputs other than the per-prediction ones: level 2 is
// [b, hw2], level 0 [b, hw0], the depth range [b].
struct Inputs {
  const float* initial;
  const float* up;
  const float* gt2;
  const float* m2;
  const float* gt0;
  const float* m0;
  const float* dmin;
  const float* dmax;
  int b;
  long long hw2, hw0;
};

// p[i] of a kernel parameter's array, read without a run-time index (one
// would copy the whole array into each thread's local memory).
template <typename T>
__device__ __forceinline__ T pick(const T (&p)[kMaxPred], int i) {
  T out = p[0];
#pragma unroll
  for (int j = 1; j < kMaxPred; ++j) out = j == i ? p[j] : out;
  return out;
}

// torch's reciprocal: 1 / x, rounded to nearest.
__device__ __forceinline__ float recip(float x) { return __frcp_rn(x); }

// ops/depth_range.py depth_normalization: ((1 / (d + 1e-5)) - idmax) / (idmin - idmax).
__device__ __forceinline__ float normalize(float d, float idmin, float idmax) {
  return __fdiv_rn(__fsub_rn(recip(__fadd_rn(d, 1e-5f)), idmax), __fsub_rn(idmin, idmax));
}

__device__ __forceinline__ float mask_of(float m) { return m > 0.5f ? 1.0f : 0.0f; }

// floor(clamp(norm_gt, 0, 1) * 255 * m1), kept within the bins.
__device__ __forceinline__ int gt_bin(float ngt, float m1) {
  const float c = ngt < 0.0f ? 0.0f : ngt > 1.0f ? 1.0f : ngt;
  const int bin = static_cast<int>(floorf(__fmul_rn(__fmul_rn(c, 255.0f), m1)));
  return min(max(bin, 0), kBins - 1);
}

// torch.sgn of a real value: -1, 0 or 1, and 0 for NaN.
__device__ __forceinline__ float sgn(float x) {
  return static_cast<float>((x > 0.0f) - (x < 0.0f));
}

// torch.clamp(x, min=lo): NaN stays NaN.
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }

__device__ __forceinline__ void depth_range(const Inputs& in, int bi, float& idmin,
                                            float& idmax) {
  idmin = recip(in.dmin[bi]);
  idmax = recip(in.dmax[bi]);
}

inline Planes planes(const void* const* ptrs, int n) {
  Planes out = {};
  for (int i = 0; i < n && ptrs != nullptr; ++i) out.p[i] = static_cast<const float*>(ptrs[i]);
  return out;
}

inline Inputs inputs(const float* initial, const float* up, const float* gt2, const float* m2,
                     const float* gt0, const float* m0, const float* dmin, const float* dmax,
                     int b, long long hw2, long long hw0) {
  return Inputs{initial, up, gt2, m2, gt0, m0, dmin, dmax, b, hw2, hw0};
}

}  // namespace
