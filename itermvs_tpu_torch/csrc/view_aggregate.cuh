// What K11 view_aggregate (view_aggregate.cu) and K12 view_aggregate_grad
// (view_aggregate_grad.cu) share: the per-view pointers, the words a
// thread reads and writes along P, and the per-pixel weight sum
//     S = 1e-5 + ((w_0 + w_1) + w_2) + ...
// which K12 recomputes and so must fold exactly as K11 does.
//
// Layout: view v's correlation is [B, rows, P] with rows = n*G, its rows
// P apart and its batch rows `batch_stride` floats apart (rows*P for a
// tensor of its own, (V-1)*rows*P for a slice of the init branch's
// stacked [B, V-1, n, G, P]); the weights are [B, V-1, P] contiguous.
// A thread owns kVec neighbouring pixels of P: float4 words where P % 4
// == 0 and every pointer is 16-byte aligned (the launchers check), else
// one float.
#pragma once

#include <cuda_runtime.h>

namespace {

// Up to 256 source views; the base pointers pass by value in the kernel
// parameters (2 KB of the 4 KB), read in place (__grid_constant__).
constexpr int kMaxViews = 256;
constexpr int kThreads = 128;

struct Views {
  const float* corr[kMaxViews];
};

template <int kVec>
struct Lane {
  float v[kVec];

  __device__ __forceinline__ void load(const float* p) {
    if constexpr (kVec == 4) {
      const float4 w = __ldg(reinterpret_cast<const float4*>(p));
      v[0] = w.x;
      v[1] = w.y;
      v[2] = w.z;
      v[3] = w.w;
    } else {
      v[0] = __ldg(p);
    }
  }

  __device__ __forceinline__ void store(float* p) const {
    if constexpr (kVec == 4) {
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      p[0] = v[0];
    }
  }
};

// 1e-5 + the view-ordered sum of the nv weights at w, w + p, ...
template <int kVec>
__device__ __forceinline__ Lane<kVec> weight_sum(const float* w, int nv, long long p) {
  Lane<kVec> s;
  s.load(w);
  for (int v = 1; v < nv; ++v) {
    Lane<kVec> wv;
    wv.load(w + v * p);
#pragma unroll
    for (int e = 0; e < kVec; ++e) s.v[e] = __fadd_rn(s.v[e], wv.v[e]);
  }
#pragma unroll
  for (int e = 0; e < kVec; ++e) s.v[e] = __fadd_rn(1e-5f, s.v[e]);
  return s;
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0;
}

// Whether the views' words can be float4: P % 4 == 0 (then every row and
// batch offset is a multiple of 4 floats) and every view's base aligned.
inline bool views_vec4(const void* const* corr, int nv, int p, long long batch_stride) {
  if (p % 4 != 0 || batch_stride % 4 != 0) return false;
  for (int v = 0; v < nv; ++v)
    if (!aligned16(corr[v])) return false;
  return true;
}

inline Views make_views(const void* const* corr, int nv) {
  Views views{};
  for (int v = 0; v < nv; ++v) views.corr[v] = static_cast<const float*>(corr[v]);
  return views;
}

}  // namespace
