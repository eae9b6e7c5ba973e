// K18 bn_act_grad: the backward of K17 bn_act (bn_act.cuh). From the
// gradient g of out and the saved out, y (and xd), with g' = g masked by
// the ReLU (0 where out <= 0; g' = g without the ReLU) and mul, mul'
// recomputed from w, var (w', var'):
//     d_y    = g' * mul                         (compute dtype)
//     d_skip = g'                               (kResidual)
//            = g' * mul'                        (kDownsample: d_xd)
// and per channel, in float32, for each BN (y's; in kDownsample also
// xd's, with x = xd and its vectors) five rows
//     s1 = sum g'           (the bias's gradient; the same for both BNs)
//     s2 = sum g' * (x - mean)
//     d_w = s2 * rstd,  d_mean = -(s1 * mul),  d_var = -0.5 * s2 * w * rstd^3
// with rstd = rsqrt(var + eps), the sums over n, h and w: [5, c], or
// [10, c] in kDownsample. ops/bn_act.py's BnAct.backward hands them to
// autograd, which carries d_mean and d_var on through the statistics.
//
// Replaces: the backward of the XLA fusion at
// itermvs_tpu/models/blocks.py:90-120, :152-165 (jax.grad through BN's
// normalise, the ReLU and the residual add). In the port: autograd's
// ReLU and add backwards and cuDNN's batch-norm backward.
//
// What bounds it on an H100: memory. It reads g, out, y (and xd) and
// writes d_y (and d_skip), with 6 to 10 operations per element.
//
// Design: two kernels from one launcher, no atomics. The first is K17's
// blocking (a block per span of an (n, c) plane): each thread writes its
// words' gradients and sums its elements' terms in order; the block folds
// its threads' sums in a fixed tree (warp shuffles, then the warps in
// shared memory) into one partial per span. The second folds each
// channel's n * spans partials, a block per channel, in the same fixed
// way, and its first thread writes the channel's rows. So the rows are
// bit-identical launch to launch; d_y and d_skip are bit-equal to
// bn_act_grad_plain, whose sums add the same terms in another order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bn_act.cuh"

namespace {

constexpr int kWarps = kThreads / 32;

// The block's kSums sums, folded in a fixed order, left in thread 0's `s`.
template <int kSums>
__device__ __forceinline__ void block_sum(float (&s)[kSums]) {
  __shared__ float warp_sums[kSums][kWarps];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int k = 0; k < kSums; ++k) {
    float v = s[k];
#pragma unroll
    for (int off = 16; off > 0; off /= 2) v = __fadd_rn(v, __shfl_xor_sync(~0u, v, off));
    if (lane == 0) warp_sums[k][warp] = v;
  }
  __syncthreads();
  if (warp != 0) return;
#pragma unroll
  for (int k = 0; k < kSums; ++k) {
    float v = lane < kWarps ? warp_sums[k][lane] : 0.0f;
#pragma unroll
    for (int off = kWarps / 2; off > 0; off /= 2) v = __fadd_rn(v, __shfl_xor_sync(~0u, v, off));
    s[k] = v;
  }
}

// One BN's five rows of channel c (see the top): s1, s2 and the gradients
// of w, mean and var, at rows[0], rows[stride], ... rows[4 * stride].
__device__ __forceinline__ void write_rows(float s1, float s2, const Channel& ch, int c,
                                           float* rows, int stride) {
  const float w = __ldg(ch.w + c);
  const float rstd = rsqrtf(__fadd_rn(__ldg(ch.var + c), kEps));
  rows[0] = s1;
  rows[stride] = s2;
  rows[2 * stride] = __fmul_rn(s2, rstd);
  rows[3 * stride] = -__fmul_rn(s1, __fmul_rn(rstd, w));
  rows[4 * stride] =
      __fmul_rn(__fmul_rn(__fmul_rn(-0.5f, s2), w), __fmul_rn(__fmul_rn(rstd, rstd), rstd));
}

template <typename T, int kForm, bool kRelu, int kVec>
__global__ void __launch_bounds__(kThreads)
bn_act_grad_kernel(const T* __restrict__ grad, const T* __restrict__ out,
                   const T* __restrict__ y, const T* __restrict__ xd, T* __restrict__ d_y,
                   T* __restrict__ d_skip, float* __restrict__ partials, Channel a, Channel d,
                   int channels, long long p, int spans, long long span) {
  constexpr int kSums = kForm == kDownsample ? 3 : 2;
  const Span at(channels, p, spans, span);
  const float mul = bn_mul(a, at.channel), mean = __ldg(a.mean + at.channel);
  float mul2 = 0.0f, mean2 = 0.0f;
  if constexpr (kForm == kDownsample) {
    mul2 = bn_mul(d, at.channel);
    mean2 = __ldg(d.mean + at.channel);
  }
  float s[kSums] = {};
  const long long base = at.plane * p;
#pragma unroll 2
  for (long long i = at.begin + threadIdx.x * kVec; i < at.end; i += kThreads * kVec) {
    Lanes<T, kVec> g, o, v, x;
    g.load(grad + base + i);
    if constexpr (kRelu) o.load(out + base + i);
    v.load(y + base + i);
    if constexpr (kForm == kDownsample) x.load(xd + base + i);
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      const float gm = kRelu && o.v[e] <= 0.0f ? 0.0f : g.v[e];
      s[0] = __fadd_rn(s[0], gm);
      s[1] = __fadd_rn(s[1], __fmul_rn(gm, __fsub_rn(v.v[e], mean)));
      v.v[e] = rnd<T>(__fmul_rn(gm, mul));
      if constexpr (kForm == kResidual) o.v[e] = gm;
      if constexpr (kForm == kDownsample) {
        s[kSums - 1] = __fadd_rn(s[kSums - 1], __fmul_rn(gm, __fsub_rn(x.v[e], mean2)));
        o.v[e] = rnd<T>(__fmul_rn(gm, mul2));
      }
    }
    v.store(d_y + base + i);
    if constexpr (kForm != kPlain) o.store(d_skip + base + i);
  }
  block_sum<kSums>(s);
  if (threadIdx.x != 0) return;
#pragma unroll
  for (int k = 0; k < kSums; ++k)
    partials[k * static_cast<long long>(gridDim.x) + blockIdx.x] = s[k];
}

// Channel blockIdx.x's sums over its n * spans partials (plane n * c +
// channel, span s at (plane * spans + s)), in a fixed order, then its
// rows (5 per BN, `rows` [5 or 10, channels]). T only names the dtype of
// the form it belongs to.
template <typename T, int kSums>
__global__ void __launch_bounds__(kThreads)
bn_act_grad_fold_kernel(const float* __restrict__ partials, float* __restrict__ rows,
                        Channel a, Channel d, int n, int channels, int spans) {
  const int c = blockIdx.x;
  const long long stride = static_cast<long long>(n) * channels * spans;
  const int terms = n * spans;
  float s[kSums] = {};
  for (int j = threadIdx.x; j < terms; j += kThreads) {
    const int nn = j / spans;
    const long long at = (static_cast<long long>(nn) * channels + c) * spans + (j - nn * spans);
#pragma unroll
    for (int k = 0; k < kSums; ++k) s[k] = __fadd_rn(s[k], partials[k * stride + at]);
  }
  block_sum<kSums>(s);
  if (threadIdx.x != 0) return;
  write_rows(s[0], s[1], a, c, rows + c, channels);
  if constexpr (kSums == 3) write_rows(s[0], s[2], d, c, rows + 5 * channels + c, channels);
}

struct Args {
  const void *grad, *out, *y, *xd;
  void *d_y, *d_skip;
  float *rows, *partials;
  Channel a, d;
  int n, c;
  long long p;
  int spans;
};

template <typename T, int kForm, bool kRelu>
void launch_form(const Args& r, cudaStream_t st) {
  constexpr int kWord = word<T>();
  constexpr int kSums = kForm == kDownsample ? 3 : 2;
  const T* g = static_cast<const T*>(r.grad);
  const T* o = static_cast<const T*>(r.out);
  const T* y = static_cast<const T*>(r.y);
  const T* x = static_cast<const T*>(r.xd);
  T* dy = static_cast<T*>(r.d_y);
  T* ds = static_cast<T*>(r.d_skip);
  const unsigned grid = static_cast<unsigned>(r.n) * r.c * r.spans;
  if (r.p % kWord == 0 && aligned16(g) && aligned16(y) && aligned16(dy) &&
      (!kRelu || aligned16(o)) && (kForm != kDownsample || aligned16(x)) &&
      (kForm == kPlain || aligned16(ds)))
    bn_act_grad_kernel<T, kForm, kRelu, kWord><<<grid, kThreads, 0, st>>>(
        g, o, y, x, dy, ds, r.partials, r.a, r.d, r.c, r.p, r.spans,
        span_of(r.p, r.spans, kWord));
  else
    bn_act_grad_kernel<T, kForm, kRelu, 1><<<grid, kThreads, 0, st>>>(
        g, o, y, x, dy, ds, r.partials, r.a, r.d, r.c, r.p, r.spans, span_of(r.p, r.spans, 1));
  bn_act_grad_fold_kernel<T, kSums><<<r.c, kThreads, 0, st>>>(r.partials, r.rows, r.a, r.d,
                                                               r.n, r.c, r.spans);
}

template <typename T>
int launch(const Args& r, int form, int relu, void* stream) {
  if (r.n <= 0 || r.c <= 0 || r.p <= 0) return 0;
  if (form < kPlain || form > kDownsample || r.spans <= 0 || r.spans > r.p ||
      static_cast<long long>(r.n) * r.c * r.spans > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (form * 2 + (relu != 0)) {
    case 0: launch_form<T, kPlain, false>(r, st); break;
    case 1: launch_form<T, kPlain, true>(r, st); break;
    case 2: launch_form<T, kResidual, false>(r, st); break;
    case 3: launch_form<T, kResidual, true>(r, st); break;
    case 4: launch_form<T, kDownsample, false>(r, st); break;
    default: launch_form<T, kDownsample, true>(r, st); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// grad, out (relu only), y, xd (form 2 only) in; d_y, d_skip (forms 1
// and 2) out: [n, c, p] contiguous, of float32 (itermvs_bn_act_grad) or
// bfloat16 (_bf16). rows: float32 [5, c] (form 2: [10, c]) out; partials:
// float32 scratch of 2 (form 2: 3) times n * c * spans. w, mean, var (and
// w2, mean2, var2 in form 2): float32 [c]. spans: the spans per plane (1
// to p). Returns the launch's error (0 on success).
extern "C" int itermvs_bn_act_grad(const void* grad, const void* out, const void* y,
                                   const void* xd, void* d_y, void* d_skip, float* rows,
                                   float* partials, const float* w, const float* mean,
                                   const float* var, const float* w2, const float* mean2,
                                   const float* var2, int n, int c, long long p, int spans,
                                   int form, int relu, void* stream) {
  const Args r{grad, out, y, xd, d_y, d_skip, rows, partials,
               Channel{w, nullptr, mean, var}, Channel{w2, nullptr, mean2, var2}, n, c, p,
               spans};
  return launch<float>(r, form, relu, stream);
}

extern "C" int itermvs_bn_act_grad_bf16(const void* grad, const void* out, const void* y,
                                        const void* xd, void* d_y, void* d_skip, float* rows,
                                        float* partials, const float* w, const float* mean,
                                        const float* var, const float* w2, const float* mean2,
                                        const float* var2, int n, int c, long long p,
                                        int spans, int form, int relu, void* stream) {
  const Args r{grad, out, y, xd, d_y, d_skip, rows, partials,
               Channel{w, nullptr, mean, var}, Channel{w2, nullptr, mean2, var2}, n, c, p,
               spans};
  return launch<__nv_bfloat16>(r, form, relu, stream);
}
