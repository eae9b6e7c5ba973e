// K10 convex_upsample_grad: the backward of K9 (convex_upsample.cu), the
// gradients of the mask logits and of the coarse map through the 9-tap
// softmax and the x4 convex upsample.
//
// Replaces: XLA's autodiff of itermvs_tpu/ops/upsample.py:13
// `convex_upsample` and of the `jax.nn.softmax` of the mask logits
// before it (itermvs_tpu/models/itermvs.py:445-451). With w_k, t_k and up
// as in K9 and g = dL/dup, per coarse pixel p and sub-pixel (i, j):
//     dl_k(i, j) = g w_k (t_k - up)
//     P_k[p]     = sum_(i,j) g w_k
//     dx[q]      = sum of P_k[p] over every (p, k) whose clamped tap
//                  lands on q (at a border, more than one p per tap).
// The softmax is recomputed from the logits (nothing of the forward is
// saved) with K9's code (upsample_taps.cuh), so it gives K9's weights. dl
// comes out in the logits' dtype, rounded once (bf16: round to nearest
// even, the gradient of the forward's float32 cast); dx is float32.
//
// What bounds it on an H100: memory, once the per-sub-pixel work is
// small. Per coarse pixel it reads 144 logits, 16 values of g and the 3x3
// neighbourhood, and writes 144 values of dl and one of dx (1224 B in
// f32, 648 B in bf16). A first form (one thread per pixel walking its 4
// sub-rows in series, scalar 2-byte loads and stores in bf16, 9 IEEE
// divides per softmax) ran bf16 only 1.26x faster than f32 on 1.9x fewer
// bytes: a thread's chain of 4 load rounds and its instructions set the
// pace, with 19 resident warps per SM at the training shape.
//
// Design (deterministic: no atomics). Two kernels, launched back to back
// by one launcher. The first runs one thread per (pair of neighbouring
// pixels of a row, sub-row i), 32 pairs x the 4 sub-rows a block
// (upsample_taps.cuh): on the paired path each of its 36 logit loads (all
// issued before any is used) and 36 dl stores is one word holding the
// pair's values of one channel, its 8 values of g are two float4 (32
// contiguous bytes), and it sums g w_k over its 4 sub-columns j in order.
// The block then adds the 4 sub-rows' sums through shared memory in the
// order i = 0..3 and writes the scratch P [B, 9, H, W] float32 (36 B per
// pixel, written once and read once). The second, one thread per coarse
// pixel q, gathers P_k from the pixels whose clamped taps land on q (all
// its loads at once), taps in order and each range in order, so that
// every launch on the same inputs writes the same bits. Both are
// programmatic dependent launches (kProgrammatic): the first kernel's
// blocks start while the stream's previous kernel drains, the fold's
// while the first kernel drains, and each waits in
// cudaGridDependencySynchronize() until the kernel before it has
// completed. Each operation is rounded on its own, in the plain
// version's order where that is cheap.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>

#include "upsample_taps.cuh"

namespace {

// Whether both kernels are programmatic dependent launches; PERF.md §6
// has the timings that chose it.
constexpr bool kProgrammatic = true;

template <typename T, bool kPaired>
__global__ void __launch_bounds__(kThreads)
convex_upsample_grad_kernel(const T* __restrict__ logits, const float* __restrict__ x,
                            const float* __restrict__ grad, T* __restrict__ d_logits,
                            float* __restrict__ partial, int h, int w, int pairs) {
  __shared__ float sums[kScale][kTaps][2][kGroups];
  const int gq = blockIdx.x * kGroups + threadIdx.x;
  const bool active = gq < pairs;
  const int i = threadIdx.y;
  const Pair g(active ? gq : 0, h, w);
  const long long hw = static_cast<long long>(h) * w;
  const long long q = static_cast<long long>(g.y) * w + g.x0;
  // Until the stream's previous kernel has completed (at once where this
  // is an ordinary launch).
  cudaGridDependencySynchronize();

  if (active) {
    float tap[2][kTaps];
    neighbourhoods(x + g.b * hw, g.y, g.x0, h, w, tap);
    const long long row = (static_cast<long long>(g.b) * h + g.y) * kScale + i;
    const float4* g4 = reinterpret_cast<const float4*>(grad + row * kScale * w) + g.x0;
    float gr[2][kScale];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float4 v = (e == 0 || g.two) ? __ldg(g4 + e) : make_float4(0.f, 0.f, 0.f, 0.f);
      gr[e][0] = v.x;
      gr[e][1] = v.y;
      gr[e][2] = v.z;
      gr[e][3] = v.w;
    }
    const long long base = g.b * kChannels * hw + q + i * kScale * hw;
    Logits<T, kPaired> words[kScale];
#pragma unroll
    for (int j = 0; j < kScale; ++j) words[j].load(logits + base + j * hw, hw, g.two);
    float part[2][kTaps];
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int k = 0; k < kTaps; ++k) part[e][k] = 0.f;
#pragma unroll
    for (int j = 0; j < kScale; ++j) {
      float v[2][kTaps];
      float up[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        words[j].get(e, v[e]);
        softmax9(v[e]);
        up[e] = convex9(v[e], tap[e]);
      }
#pragma unroll
      for (int k = 0; k < kTaps; ++k) {
        float dl[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float gw = __fmul_rn(gr[e][j], v[e][k]);
          dl[e] = __fmul_rn(gw, __fsub_rn(tap[e][k], up[e]));
          part[e][k] = __fadd_rn(part[e][k], gw);
        }
        store2<kPaired>(d_logits + base + j * hw + k * kScale * kScale * hw, g.two, dl[0],
                        dl[1]);
      }
    }
#pragma unroll
    for (int k = 0; k < kTaps; ++k)
#pragma unroll
      for (int e = 0; e < 2; ++e) sums[i][k][e][threadIdx.x] = part[e][k];
  }
  __syncthreads();
  if (active) {
    // Sub-row thread i writes P of taps i, i + 4, i + 8 for its pair.
#pragma unroll
    for (int k = 0; k < kTaps; ++k) {
      if (k % kScale != i) continue;
      float p[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        p[e] = sums[0][k][e][threadIdx.x];
#pragma unroll
        for (int r = 1; r < kScale; ++r) p[e] = __fadd_rn(p[e], sums[r][k][e][threadIdx.x]);
      }
      store2<kPaired>(partial + (static_cast<long long>(g.b) * kTaps + k) * hw + q, g.two,
                      p[0], p[1]);
    }
  }
  // P is written: the fold's blocks may start.
  cudaTriggerProgrammaticLaunchCompletion();
}

// The rows (or columns) p in [0, n) whose tap at offset d clamps onto
// q: q - d alone inside the map; at the first (last) index also the
// ones that clamp from beyond it. So from `lo`, 0, 1 or 2 of them.
__device__ __forceinline__ void tap_range(int q, int d, int n, int& lo, int& count) {
  lo = max(q == 0 ? 0 : q - d, 0);
  count = min(q == n - 1 ? n - 1 : q - d, n - 1) - lo + 1;
}

// T names the dtype form that launched it (the profile tells the two
// forms apart by it); the fold itself is float32 in both. A tap's range
// spans at most 2 x 2 pixels, so all 36 candidate values of P are loaded
// at once (9 of them inside the map's border), then added in the order
// taps, rows, columns.
template <typename T>
__global__ void __launch_bounds__(kThreads)
convex_upsample_grad_fold_kernel(const float* __restrict__ partial, float* __restrict__ d_x,
                                 int h, int w, int pixels) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  const int xc = p % w;
  const int y = (p / w) % h;
  const int b = p / w / h;
  const long long hw = static_cast<long long>(h) * w;
  int y0[3], ny[3], x0[3], nx[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    tap_range(y, d - 1, h, y0[d], ny[d]);
    tap_range(xc, d - 1, w, x0[d], nx[d]);
  }
  // Until the first kernel has completed and its P is visible (at once
  // where this is an ordinary launch).
  cudaGridDependencySynchronize();
  if (p >= pixels) return;
  float v[kTaps][2][2];
#pragma unroll
  for (int k = 0; k < kTaps; ++k) {
    const float* pk = partial + (static_cast<long long>(b) * kTaps + k) * hw +
                      y0[k / 3] * w + x0[k % 3];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        v[k][r][c] = r < ny[k / 3] && c < nx[k % 3] ? __ldg(pk + r * w + c) : 0.f;
  }
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < kTaps; ++k)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        if (r < ny[k / 3] && c < nx[k % 3]) acc = __fadd_rn(acc, v[k][r][c]);
  d_x[p] = acc;
}

template <typename T>
int launch(const void* logits, const float* x, const float* grad, void* d_logits,
           float* partial, float* d_x, int batch, int h, int w, void* stream) {
  const long long pixels = static_cast<long long>(batch) * h * w;
  if (pixels <= 0) return 0;
  if (pixels > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<unsigned long long>(grad) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const auto aligned = [](const void* p, unsigned long long n) {
    return reinterpret_cast<unsigned long long>(p) % n == 0;
  };
  const bool paired = w % 2 == 0 && aligned(logits, 2 * sizeof(T)) &&
                      aligned(d_logits, 2 * sizeof(T)) && aligned(partial, 8);
  const long long pairs = static_cast<long long>(batch) * h * ((w + 1) / 2);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t first = launch_kernel(
      kProgrammatic,
      paired ? convex_upsample_grad_kernel<T, true> : convex_upsample_grad_kernel<T, false>,
      dim3(static_cast<unsigned>((pairs + kGroups - 1) / kGroups)), dim3(kGroups, kScale), st,
      static_cast<const T*>(logits), x, grad, static_cast<T*>(d_logits), partial, h, w,
      static_cast<int>(pairs));
  if (first != cudaSuccess) return static_cast<int>(first);
  return static_cast<int>(launch_kernel(
      kProgrammatic, convex_upsample_grad_fold_kernel<T>,
      dim3(static_cast<unsigned>((pixels + kThreads - 1) / kThreads)), dim3(kThreads), st,
      static_cast<const float*>(partial), d_x, h, w, static_cast<int>(pixels)));
}

}  // namespace

// logits: [batch, 144, h, w] contiguous (float32 or bfloat16). x: [batch,
// h, w] float32. grad: [batch, 4h, 4w] float32, 16-byte aligned.
// d_logits: [batch, 144, h, w] in the logits' dtype. partial: [batch, 9,
// h, w] float32 scratch. d_x: [batch, h, w] float32. Runs both kernels
// on `stream`; returns the first launch error (0 on success). A failed
// launch is reported, never retried another way.
extern "C" int itermvs_convex_upsample_grad(const void* logits, const float* x,
                                            const float* grad, void* d_logits,
                                            float* partial, float* d_x, int batch, int h,
                                            int w, void* stream) {
  return launch<float>(logits, x, grad, d_logits, partial, d_x, batch, h, w, stream);
}

extern "C" int itermvs_convex_upsample_grad_bf16(const void* logits, const float* x,
                                                 const float* grad, void* d_logits,
                                                 float* partial, float* d_x, int batch,
                                                 int h, int w, void* stream) {
  return launch<__nv_bfloat16>(logits, x, grad, d_logits, partial, d_x, batch, h, w,
                               stream);
}

// 1 where the fold (and the first kernel) is a programmatic dependent
// launch, else 0.
extern "C" int itermvs_convex_upsample_grad_programmatic() { return kProgrammatic; }
