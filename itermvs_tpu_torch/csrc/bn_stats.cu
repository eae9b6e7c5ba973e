// K21 bn_stats: BatchNorm's training statistics in one pass, per channel
// of a convolution's output y [N, C, H, W] in the compute dtype (float32
// or bfloat16), over n = N * H * W elements:
//     out[0][c] = sum y / count
//     out[1][c] = sum (y - mean)^2 / count      (mean = sum y / n)
// in float32, or where `wide` in float64. With count = n these are the
// batch's mean and biased variance; in a process group the launch runs
// with count 1, wide, and the ranks' sums are merged by Chan's rule in
// float64 (models/blocks.py: in float32 the rounding of a rank's mean
// would enter the variance at first order).
//
// Replaces: flax's `_compute_stats` (the mean and variance of
// nn.BatchNorm in training, one XLA fusion) at
// itermvs_tpu/models/blocks.py:90-103. In the port: torch.var_mean on a
// float32 copy of y, or two eager sums in a process group.
//
// What bounds it on an H100: memory. It reads y once, in its own dtype
// (converted in registers: no float32 copy of a bfloat16 y), with 4
// operations per element.
//
// Design: two kernels from one launcher, no atomics. The first is K17's
// blocking (bn_act.cuh: a block per span of an (n, c) plane, at most
// kSpan elements, 16-byte words where the plane allows). Each thread
// loads its at most 16 elements into registers once and sums them in
// float32; the block folds the threads' sums in float64 in a fixed tree
// (warp shuffles, then the warps in shared memory) into the span's sum
// S, takes a = float(S / m) over its m elements, sums (y - a)^2 from the
// same registers in float32 per thread and folds those the same way
// into Q. Its partial is (S, Q, a). The second kernel folds each
// channel's N * spans partials, a block per channel, in float64 in the
// same fixed way: first the sum of S, whose mean is mu, then
//     sum (y - mu)^2 = sum Q - 2 (mu - a) (S - m a) + m (mu - a)^2
// over the partials, exact for any shift a (Chan's rule with the span's
// own shift). So y is read once, two launches are bit-equal, and the
// float32 sums of at most 16 terms are the only rounding before the last.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bn_act.cuh"

namespace {

constexpr int kWarps = kThreads / 32;

// The block's float64 sum of `v`, folded in a fixed order, in every
// thread. `shared` holds kWarps + 1 doubles; two calls in a row are
// safe (the second writes the warps' slots only after every thread has
// passed the first's last barrier).
__device__ __forceinline__ double block_sum(double v, double* shared) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int off = 16; off > 0; off /= 2) v = __dadd_rn(v, __shfl_xor_sync(~0u, v, off));
  if (lane == 0) shared[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? shared[lane] : 0.0;
#pragma unroll
    for (int off = kWarps / 2; off > 0; off /= 2) v = __dadd_rn(v, __shfl_xor_sync(~0u, v, off));
    if (lane == 0) shared[kWarps] = v;
  }
  __syncthreads();
  return shared[kWarps];
}

// The partials of block b: S at [b], Q at [blocks + b], a at [2 blocks + b].
template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads)
bn_stats_kernel(const T* __restrict__ y, double* __restrict__ partials, int channels,
                long long p, int spans, long long span) {
  constexpr int kIters = static_cast<int>(kSpan / (kThreads * kVec));
  __shared__ double shared[kWarps + 1];
  const Span at(channels, p, spans, span);
  const T* base = y + at.plane * p;
  Lanes<T, kVec> v[kIters];
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < kIters; ++j) {
    const long long i = at.begin + (static_cast<long long>(j) * kThreads + threadIdx.x) * kVec;
    if (i < at.end) v[j].load(base + i);
  }
#pragma unroll
  for (int j = 0; j < kIters; ++j) {
    const long long i = at.begin + (static_cast<long long>(j) * kThreads + threadIdx.x) * kVec;
    if (i < at.end) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) s = __fadd_rn(s, v[j].v[e]);
    }
  }
  const double sum = block_sum(static_cast<double>(s), shared);
  const long long m = at.end > at.begin ? at.end - at.begin : 0;
  const float a = m > 0 ? static_cast<float>(__ddiv_rn(sum, static_cast<double>(m))) : 0.0f;
  float q = 0.0f;
#pragma unroll
  for (int j = 0; j < kIters; ++j) {
    const long long i = at.begin + (static_cast<long long>(j) * kThreads + threadIdx.x) * kVec;
    if (i < at.end) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float d = __fsub_rn(v[j].v[e], a);
        q = __fmaf_rn(d, d, q);
      }
    }
  }
  const double sq = block_sum(static_cast<double>(q), shared);
  if (threadIdx.x == 0) {
    const unsigned blocks = gridDim.x;
    partials[blockIdx.x] = sum;
    partials[blocks + blockIdx.x] = sq;
    partials[2ull * blocks + blockIdx.x] = static_cast<double>(a);
  }
}

// Channel blockIdx.x's mean and centred square sum over its n * spans
// partials (plane n * c + channel, span s at (plane * spans + s)), in a
// fixed order, each divided by `count`, written to `out` as float32 or,
// where `wide`, float64. T only names the dtype of the form it belongs
// to.
template <typename T>
__global__ void __launch_bounds__(kThreads)
bn_stats_fold_kernel(const double* __restrict__ partials, void* __restrict__ out, int wide,
                     int n, int channels, long long p, int spans, long long span,
                     double count) {
  __shared__ double shared[kWarps + 1];
  const int c = blockIdx.x;
  const int terms = n * spans;
  const long long blocks = static_cast<long long>(n) * channels * spans;
  auto index = [&](int j) {
    const int nn = j / spans;
    return (static_cast<long long>(nn) * channels + c) * spans + (j - nn * spans);
  };
  double s = 0.0;
  for (int j = threadIdx.x; j < terms; j += kThreads) s = __dadd_rn(s, partials[index(j)]);
  s = block_sum(s, shared);
  const double mu = __ddiv_rn(s, static_cast<double>(n) * static_cast<double>(p));
  double q = 0.0;
  for (int j = threadIdx.x; j < terms; j += kThreads) {
    const long long b = index(j), begin = (j % spans) * span;
    const double m = static_cast<double>(max(0LL, min(p, begin + span) - begin));
    const double sb = partials[b], qb = partials[blocks + b], a = partials[2 * blocks + b];
    const double d = __dsub_rn(mu, a);
    const double cross = __dmul_rn(__dmul_rn(2.0, d), __dsub_rn(sb, __dmul_rn(m, a)));
    q = __dadd_rn(q, __dadd_rn(__dsub_rn(qb, cross), __dmul_rn(m, __dmul_rn(d, d))));
  }
  q = block_sum(q, shared);
  if (threadIdx.x == 0) {
    const double mean = __ddiv_rn(s, count), var = __ddiv_rn(fmax(q, 0.0), count);
    if (wide) {
      static_cast<double*>(out)[c] = mean;
      static_cast<double*>(out)[channels + c] = var;
    } else {
      static_cast<float*>(out)[c] = static_cast<float>(mean);
      static_cast<float*>(out)[channels + c] = static_cast<float>(var);
    }
  }
}

template <typename T>
int launch(const void* y, void* out, int wide, double* partials, int n, int c, long long p,
           int spans, double count, void* stream) {
  if (n <= 0 || c <= 0 || p <= 0) return 0;
  if (spans <= 0 || spans > p || (p + spans - 1) / spans > kSpan || !(count > 0.0) ||
      static_cast<long long>(n) * c * spans > 0x7fffffffLL ||
      static_cast<long long>(n) * spans > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kWord = word<T>();
  const T* yv = static_cast<const T*>(y);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(n) * c * spans;
  const bool words = p % kWord == 0 && aligned16(yv);
  const long long span = span_of(p, spans, words ? kWord : 1);
  if (words)
    bn_stats_kernel<T, kWord><<<grid, kThreads, 0, st>>>(yv, partials, c, p, spans, span);
  else
    bn_stats_kernel<T, 1><<<grid, kThreads, 0, st>>>(yv, partials, c, p, spans, span);
  bn_stats_fold_kernel<T><<<c, kThreads, 0, st>>>(partials, out, wide, n, c, p, spans, span,
                                                  count);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y: [n, c, p] contiguous, of float32 (itermvs_bn_stats) or bfloat16
// (_bf16). out: [2, c], the sums of y and of (y - mean)^2 over `count`
// (> 0), float32, or float64 where `wide` is 1. partials: float64
// scratch of 3 * n * c * spans. spans: the spans per plane (1 to p, at
// most kSpan elements each). Returns the launch's error (0 on success).
extern "C" int itermvs_bn_stats(const void* y, void* out, int wide, double* partials, int n,
                                int c, long long p, int spans, double count, void* stream) {
  return launch<float>(y, out, wide, partials, n, c, p, spans, count, stream);
}

extern "C" int itermvs_bn_stats_bf16(const void* y, void* out, int wide, double* partials,
                                     int n, int c, long long p, int spans, double count,
                                     void* stream) {
  return launch<__nv_bfloat16>(y, out, wide, partials, n, c, p, spans, count, stream);
}
