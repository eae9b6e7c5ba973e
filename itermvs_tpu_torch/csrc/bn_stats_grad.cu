// K22 bn_stats_grad: the batch statistics' term of BatchNorm's input
// gradient, added in place to K18's ∂y. For a convolution's output y
// [N, C, H, W] in the compute dtype T (float32 or bfloat16), its batch
// mean (float32 [C], K21's), the per-channel gradients ∂mean and ∂var of
// the loss (K18's rows, summed over a process group where the statistics
// were the group's) and r = 1 / count rounded to float32:
//     ∂y <- T( (f32(∂y) + ∂mean * r) + ((2 * ∂var) * r) * (f32(y) - mean) )
// each operation in float32, rounded on its own, in this order (the
// plain version's), then rounded to T once. In form c (ResidualBlock,
// stride 2) the same launch adds the downsample BN's term to ∂skip (its
// input xd, mean', ∂mean', ∂var').
//
// Replaces: the statistics' part of the autodiff of flax's BatchNorm at
// itermvs_tpu/models/blocks.py:90-103, which XLA fuses into the
// normalise's backward. In the port: autograd through torch.var_mean
// (its backward recomputes the mean, then about six eager launches) and
// the add onto K18's ∂y, one or two more in bfloat16 for the casts.
//
// What bounds it on an H100: memory. It reads ∂y and y and writes ∂y
// (twice that in form c), with 4 operations per element.
//
// Design: K17's blocking (bn_act.cuh: a block per span of an (n, c)
// plane, so the channel's coefficients are scalars of the block), a
// thread per 16-byte word where the plane and every pointer allow, else
// one element. ∂y is read without the read-only cache, since the kernel
// writes it. Elementwise, so bit-equal to bn_stats_grad_plain on the
// card, and two launches on the same inputs are.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bn_act.cuh"

namespace {

// One BatchNorm's statistics and their gradients ([C] each, float32).
struct Term {
  const float* mean;
  const float* d_mean;
  const float* d_var;
};

// kVec elements of T at p, which this kernel also writes, as floats.
template <typename T, int kVec>
__device__ __forceinline__ void load_rw(const T* p, float (&v)[kVec]) {
  if constexpr (kVec == 1) {
    v[0] = tap_float(*p);
  } else if constexpr (sizeof(T) == 4) {
    const float4 w = *reinterpret_cast<const float4*>(p);
    v[0] = w.x;
    v[1] = w.y;
    v[2] = w.z;
    v[3] = w.w;
  } else {
    bf16x8_to_float(*reinterpret_cast<const uint4*>(p), v);
  }
}

// One word of ∂x += the term of (mean, cm = ∂mean * r, cv = 2∂var * r).
template <typename T, int kVec>
__device__ __forceinline__ void add_term(T* d_x, const T* x, float mean, float cm, float cv) {
  Lanes<T, kVec> g, v;
  load_rw<T, kVec>(d_x, g.v);
  v.load(x);
#pragma unroll
  for (int e = 0; e < kVec; ++e)
    g.v[e] = rnd<T>(__fadd_rn(__fadd_rn(g.v[e], cm), __fmul_rn(cv, __fsub_rn(v.v[e], mean))));
  g.store(d_x);
}

template <typename T, bool kSecond, int kVec>
__global__ void __launch_bounds__(kThreads)
bn_stats_grad_kernel(T* __restrict__ d_y, const T* __restrict__ y, T* __restrict__ d_skip,
                     const T* __restrict__ xd, Term a, Term d, float r, int channels,
                     long long p, int spans, long long span) {
  const Span at(channels, p, spans, span);
  const int ch = at.channel;
  const float mean = __ldg(a.mean + ch), cm = __fmul_rn(__ldg(a.d_mean + ch), r);
  const float cv = __fmul_rn(__fmul_rn(2.0f, __ldg(a.d_var + ch)), r);
  float mean2 = 0.0f, cm2 = 0.0f, cv2 = 0.0f;
  if constexpr (kSecond) {
    mean2 = __ldg(d.mean + ch);
    cm2 = __fmul_rn(__ldg(d.d_mean + ch), r);
    cv2 = __fmul_rn(__fmul_rn(2.0f, __ldg(d.d_var + ch)), r);
  }
  const long long base = at.plane * p;
#pragma unroll 4
  for (long long i = at.begin + threadIdx.x * kVec; i < at.end; i += kThreads * kVec) {
    add_term<T, kVec>(d_y + base + i, y + base + i, mean, cm, cv);
    if constexpr (kSecond) add_term<T, kVec>(d_skip + base + i, xd + base + i, mean2, cm2, cv2);
  }
}

template <typename T, bool kSecond>
void launch_form(T* dy, const T* y, T* ds, const T* xd, const Term& a, const Term& d, float r,
                 int planes, int channels, long long p, cudaStream_t st) {
  constexpr int kWord = word<T>();
  const int spans = static_cast<int>((p + kSpan - 1) / kSpan);
  const unsigned grid = static_cast<unsigned>(planes) * spans;
  if (p % kWord == 0 && aligned16(dy) && aligned16(y) &&
      (!kSecond || (aligned16(ds) && aligned16(xd))))
    bn_stats_grad_kernel<T, kSecond, kWord><<<grid, kThreads, 0, st>>>(
        dy, y, ds, xd, a, d, r, channels, p, spans, span_of(p, spans, kWord));
  else
    bn_stats_grad_kernel<T, kSecond, 1><<<grid, kThreads, 0, st>>>(
        dy, y, ds, xd, a, d, r, channels, p, spans, span_of(p, spans, 1));
}

template <typename T>
int launch(void* d_y, const void* y, const float* mean, const float* d_mean,
           const float* d_var, void* d_skip, const void* xd, const float* mean2,
           const float* d_mean2, const float* d_var2, float r, int n, int c, long long p,
           void* stream) {
  if (n <= 0 || c <= 0 || p <= 0) return 0;
  if (static_cast<long long>(n) * c * ((p + kSpan - 1) / kSpan) > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  T* dy = static_cast<T*>(d_y);
  const T* yv = static_cast<const T*>(y);
  T* ds = static_cast<T*>(d_skip);
  const T* x = static_cast<const T*>(xd);
  const Term a{mean, d_mean, d_var}, d{mean2, d_mean2, d_var2};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d_skip != nullptr)
    launch_form<T, true>(dy, yv, ds, x, a, d, r, n * c, c, p, st);
  else
    launch_form<T, false>(dy, yv, ds, x, a, d, r, n * c, c, p, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// d_y (in and out), y: [n, c, p] contiguous, of float32
// (itermvs_bn_stats_grad) or bfloat16 (_bf16); mean, d_mean, d_var:
// float32 [c]. d_skip (in and out) and xd with mean2, d_mean2, d_var2:
// the downsample BN's (form c), or all null. r: 1 / count in float32.
// Returns the launch's error (0 on success).
extern "C" int itermvs_bn_stats_grad(void* d_y, const void* y, const float* mean,
                                     const float* d_mean, const float* d_var, void* d_skip,
                                     const void* xd, const float* mean2, const float* d_mean2,
                                     const float* d_var2, float r, int n, int c, long long p,
                                     void* stream) {
  return launch<float>(d_y, y, mean, d_mean, d_var, d_skip, xd, mean2, d_mean2, d_var2, r, n,
                       c, p, stream);
}

extern "C" int itermvs_bn_stats_grad_bf16(void* d_y, const void* y, const float* mean,
                                          const float* d_mean, const float* d_var,
                                          void* d_skip, const void* xd, const float* mean2,
                                          const float* d_mean2, const float* d_var2, float r,
                                          int n, int c, long long p, void* stream) {
  return launch<__nv_bfloat16>(d_y, y, mean, d_mean, d_var, d_skip, xd, mean2, d_mean2,
                               d_var2, r, n, c, p, stream);
}
