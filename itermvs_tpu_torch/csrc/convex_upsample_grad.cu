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
// saved). dl comes out in the logits' dtype, rounded once (bf16: round
// to nearest even, the gradient of the forward's float32 cast); dx is
// float32.
//
// What bounds it on an H100: memory. Per coarse pixel it reads 144
// logits, 16 values of g and the 3x3 neighbourhood, and writes 144
// values of dl and one of dx (1224 B in f32, 648 B in bf16).
//
// Design (simple and right, and deterministic: no atomics). Two
// kernels, launched back to back by one launcher. The first runs one
// thread per coarse pixel, threads along W: for each sub-row i it reads
// its 36 logits (coalesced across the warp, as K9) and its 4 values of g
// as one float4, writes the 36 values of dl, and sums g w_k over the
// 16 sub-pixels in a fixed order into the scratch P [B, 9, H, W] float32
// (36 B per pixel, written once and read once). The second, one thread
// per coarse pixel q, gathers P_k from the pixels whose clamped taps
// land on q, taps in order and each range in order, so that every
// launch on the same inputs writes the same bits. Each operation is
// rounded on its own, in the plain version's order where that is cheap.
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

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// In place: the softmax of one sub-pixel's 9 logits (K9's order).
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
convex_upsample_grad_kernel(const T* __restrict__ logits, const float* __restrict__ x,
                            const float* __restrict__ grad, T* __restrict__ d_logits,
                            float* __restrict__ partial, int h, int w, int pixels) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= pixels) return;
  const int xc = p % w;
  const int y = (p / w) % h;
  const int b = p / w / h;
  const long long hw = static_cast<long long>(h) * w;
  const long long q = static_cast<long long>(y) * w + xc;

  const float* plane = x + b * hw;
  const int ys[3] = {max(y - 1, 0), y, min(y + 1, h - 1)};
  const int xs[3] = {max(xc - 1, 0), xc, min(xc + 1, w - 1)};
  float tap[kTaps];
#pragma unroll
  for (int k = 0; k < kTaps; ++k) tap[k] = __ldg(plane + ys[k / 3] * w + xs[k % 3]);

  const long long base = b * kChannels * hw + q;
  float part[kTaps];
#pragma unroll
  for (int k = 0; k < kTaps; ++k) part[k] = 0.f;
#pragma unroll 1
  for (int i = 0; i < kScale; ++i) {
    const long long row = (static_cast<long long>(b) * h + y) * kScale + i;
    const float4 g4 = __ldg(reinterpret_cast<const float4*>(grad + row * kScale * w) + xc);
    const float g[kScale] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
    for (int j = 0; j < kScale; ++j) {
      const int c0 = i * kScale + j;
      float v[kTaps];
#pragma unroll
      for (int k = 0; k < kTaps; ++k)
        v[k] = to_float(logits[base + (k * kScale * kScale + c0) * hw]);
      softmax9(v);
      float up = 0.f;
#pragma unroll
      for (int k = 0; k < kTaps; ++k) up = __fadd_rn(up, __fmul_rn(v[k], tap[k]));
#pragma unroll
      for (int k = 0; k < kTaps; ++k) {
        const float gw = __fmul_rn(g[j], v[k]);
        store(d_logits + base + (k * kScale * kScale + c0) * hw,
              __fmul_rn(gw, __fsub_rn(tap[k], up)));
        part[k] = __fadd_rn(part[k], gw);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kTaps; ++k)
    partial[(static_cast<long long>(b) * kTaps + k) * hw + q] = part[k];
}

// The rows (or columns) p in [0, n) whose tap at offset d clamps onto
// q: q - d alone inside the map; at the first (last) index also the
// ones that clamp from beyond it.
__device__ __forceinline__ void tap_range(int q, int d, int n, int& lo, int& hi) {
  lo = max(q == 0 ? 0 : q - d, 0);
  hi = min(q == n - 1 ? n - 1 : q - d, n - 1);
}

// T names the dtype form that launched it (the profile tells the two
// forms apart by it); the fold itself is float32 in both.
template <typename T>
__global__ void __launch_bounds__(kThreads)
convex_upsample_grad_fold_kernel(const float* __restrict__ partial, float* __restrict__ d_x,
                                 int h, int w, int pixels) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= pixels) return;
  const int xc = p % w;
  const int y = (p / w) % h;
  const int b = p / w / h;
  const long long hw = static_cast<long long>(h) * w;
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < kTaps; ++k) {
    int y0, y1, x0, x1;
    tap_range(y, k / 3 - 1, h, y0, y1);
    tap_range(xc, k % 3 - 1, w, x0, x1);
    const float* pk = partial + (static_cast<long long>(b) * kTaps + k) * hw;
    for (int py = y0; py <= y1; ++py)
      for (int px = x0; px <= x1; ++px)
        acc = __fadd_rn(acc, pk[static_cast<long long>(py) * w + px]);
  }
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
  const unsigned blocks = static_cast<unsigned>((pixels + kThreads - 1) / kThreads);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  convex_upsample_grad_kernel<T><<<blocks, kThreads, 0, st>>>(
      static_cast<const T*>(logits), x, grad, static_cast<T*>(d_logits), partial, h, w,
      static_cast<int>(pixels));
  const cudaError_t first = cudaGetLastError();
  if (first != cudaSuccess) return static_cast<int>(first);
  convex_upsample_grad_fold_kernel<T><<<blocks, kThreads, 0, st>>>(
      partial, d_x, h, w, static_cast<int>(pixels));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// logits: [batch, 144, h, w] contiguous (float32 or bfloat16). x: [batch,
// h, w] float32. grad: [batch, 4h, 4w] float32, 16-byte aligned.
// d_logits: [batch, 144, h, w] in the logits' dtype. partial: [batch, 9,
// h, w] float32 scratch. d_x: [batch, h, w] float32. Runs both kernels
// on `stream`; returns cudaGetLastError() after them (0 on success).
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
