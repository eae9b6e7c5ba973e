// K23 full_loss: the training loss's terms in one read of each
// probability (ops/full_loss.py has the terms, their layout and the tie
// rules). For n predictions over b images of hw2 level-2 pixels (and hw0
// level-0 pixels) it writes stats [2, T] float64: each term's sum over the
// pixels (row 0) and its count (row 1), T = 2 + 3n in stage 2 (regress),
// 2 + n in stage 1; and for K24: p at the GT bin [n, b * hw2] float32, and
// flags [n + 1, b * hw2] uint8 (row 0 the GT bin, row 1 + i prediction
// i's argmax window, 0 in stage 1); where `argmax` is given, each
// prediction's argmax [n, b * hw2] int32.
//
// Replaces: the XLA fusion of the JAX loss, itermvs_tpu/models/losses.py:24-97
// (`_masked_mean`, `_bce_with_logits`, `full_loss` under jit). In the port:
// about 580 eager aten ops per training step, forward and backward, six of
// them full passes over each [b, 256, h, w] probability (clamp, log,
// argmax, gather's backward, log's and clamp's backward).
//
// What bounds it on an H100: memory. It reads each probability once
// (b * 256 * hw2 * 4 bytes per prediction; in stage 1 only the GT bin), and
// a few bytes per pixel besides; a comparison per bin.
//
// Design: two kernels from one launcher, no atomics. The first runs a
// block per prediction and kThreads level-2 pixels, a thread per pixel,
// reading the probability's NCHW storage with the bins strided by hw2 (the
// warp's loads coalesce across its pixels). The argmax takes the first
// maximum of clamp(p, 1e-5), NaN counting as maximal, as torch.argmax
// (`argmax_bin`); p at the GT bin is read again after the scan.
// Each thread's terms are float32 values as the eager loss forms them,
// summed per block in float64 in a fixed order (warp butterflies, then
// the warps in order) into 6 slots: ce_i, win_i, bce_i, the window count
// of prediction i, and in prediction 0's blocks the init term and the
// mask count. Blocks after those take kThreads * kLevel0 level-0 pixels
// each (slots: the upsampled term, its mask count). The second kernel
// folds each term's slots, a block per term, in float64 in a fixed order.
// So two launches are bit-equal.
#include <cuda_runtime.h>

#include "full_loss.cuh"

namespace {

constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 6;

// The block's sums of v, folded in a fixed order, written by the first
// kSlots threads to out[0, kSlots).
__device__ __forceinline__ void block_sums(double (&v)[kSlots], double* shared, double* out) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off /= 2) v[k] = __dadd_rn(v[k], __shfl_xor_sync(~0u, v[k], off));
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < kSlots; ++k) shared[warp * kSlots + k] = v[k];
  }
  __syncthreads();
  if (threadIdx.x < kSlots) {
    double s = 0.0;
    for (int w = 0; w < kWarps; ++w) s = __dadd_rn(s, shared[w * kSlots + threadIdx.x]);
    out[threadIdx.x] = s;
  }
}

// The block's float64 sum of `v`, folded in a fixed order, in every thread
// (shared: kWarps + 1 doubles; two calls in a row are safe).
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

// The first maximum of clamp(p[k * stride], 1e-5) over the bins, a NaN
// counting as maximal (torch.argmax). The scan compares without NaN
// rules (4 operations per bin) and sums the bins; only where that sum is
// NaN (a NaN bin, or infinities of both signs) is the column scanned
// again with them.
__device__ __forceinline__ int argmax_bin(const float* __restrict__ p, long long stride) {
  const float first = __ldg(p);
  float best = fmaxf(first, kPMin), sum = first;
  int arg = 0;
#pragma unroll 16
  for (int k = 1; k < kBins; ++k) {
    const float raw = __ldg(p + k * stride);
    const float c = fmaxf(raw, kPMin);
    arg = c > best ? k : arg;
    best = fmaxf(c, best);
    sum += raw;
  }
  if (!isnan(sum)) return arg;
  best = clamp_min(p[0], kPMin);
  arg = 0;
  for (int k = 1; k < kBins; ++k) {
    const float c = clamp_min(p[k * stride], kPMin);
    if (!isnan(best) && (c > best || isnan(c))) {
      best = c;
      arg = k;
    }
  }
  return arg;
}

__global__ void __launch_bounds__(kThreads)
full_loss_kernel(Planes prob, Planes combine, Planes conf, int n, int regress, Inputs in,
                 int blocks2, float* __restrict__ p_gt, unsigned char* __restrict__ flags,
                 int* __restrict__ argmax, double* __restrict__ partials) {
  __shared__ double shared[kWarps * kSlots];
  double v[kSlots] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  const long long n2 = static_cast<long long>(in.b) * in.hw2;
  const int block = blockIdx.x;
  if (block < n * blocks2) {
    const int i = block / blocks2;
    const long long pix = static_cast<long long>(block - i * blocks2) * kThreads + threadIdx.x;
    if (pix < n2) {
      const int bi = static_cast<int>(pix / in.hw2);
      const long long q = pix - bi * in.hw2;
      float idmin, idmax;
      depth_range(in, bi, idmin, idmax);
      const float m1 = mask_of(in.m2[pix]);
      const float ngt = normalize(in.gt2[pix], idmin, idmax);
      const int gt = gt_bin(ngt, m1);
      const float* __restrict__ p =
          pick(prob.p, i) + static_cast<long long>(bi) * kBins * in.hw2 + q;
      unsigned char window = 0;
      if (regress) {
        const int arg = argmax_bin(p, in.hw2);
        window = gt >= arg - kRadius && gt <= arg + kRadius;
        const float mw = __fmul_rn(m1, window ? 1.0f : 0.0f);
        const float delta = __fsub_rn(normalize(pick(combine.p, i)[pix], idmin, idmax), ngt);
        const float l1 = fabsf(delta);
        v[1] = __fmul_rn(l1, mw);
        v[3] = mw;
        const float t = l1 < kConfThreshold ? 1.0f : 0.0f;
        const float l = pick(conf.p, i)[pix];
        const float bce = __fadd_rn(__fsub_rn(clamp_min(l, 0.0f), __fmul_rn(l, t)),
                                    log1pf(expf(-fabsf(l))));
        v[2] = __fmul_rn(bce, m1);
        if (argmax != nullptr) argmax[i * n2 + pix] = arg;
      }
      const float pg = p[static_cast<long long>(gt) * in.hw2];
      flags[(1 + i) * n2 + pix] = window;
      p_gt[i * n2 + pix] = pg;
      v[0] = __fmul_rn(-logf(clamp_min(pg, kPMin)), m1);
      if (i == 0) {
        const float delta = __fsub_rn(normalize(in.initial[pix], idmin, idmax), ngt);
        v[4] = __fmul_rn(fabsf(delta), m1);
        v[5] = m1;
        flags[pix] = static_cast<unsigned char>(gt);
      }
    }
  } else {
    const long long n0 = static_cast<long long>(in.b) * in.hw0;
    const long long base =
        static_cast<long long>(block - n * blocks2) * kThreads * kLevel0 + threadIdx.x;
#pragma unroll
    for (int j = 0; j < kLevel0; ++j) {
      const long long pix = base + static_cast<long long>(j) * kThreads;
      if (pix < n0) {
        float idmin, idmax;
        depth_range(in, static_cast<int>(pix / in.hw0), idmin, idmax);
        const float m0 = mask_of(in.m0[pix]);
        const float delta = __fsub_rn(normalize(in.up[pix], idmin, idmax),
                                      normalize(in.gt0[pix], idmin, idmax));
        v[0] = __dadd_rn(v[0], static_cast<double>(__fmul_rn(fabsf(delta), m0)));
        v[1] = __dadd_rn(v[1], static_cast<double>(m0));
      }
    }
  }
  block_sums(v, shared, partials + static_cast<long long>(block) * kSlots);
}

// Term t's sum and count over its blocks' slots (see full_loss_kernel),
// into stats[t] and stats[T + t], T = gridDim.x.
__global__ void __launch_bounds__(kThreads)
full_loss_fold_kernel(const double* __restrict__ partials, double* __restrict__ stats, int n,
                      int regress, int blocks2, int blocks0) {
  __shared__ double shared[kWarps + 1];
  const int t = blockIdx.x;
  int first = 0, count = blocks2, slot = 4, cfirst = 0, cslot = 5;
  if (t == 1) {
    first = cfirst = n * blocks2;
    count = blocks0;
    slot = 0;
    cslot = 1;
  } else if (t > 1) {
    const int per = regress ? 3 : 1, kind = (t - 2) % per;
    first = (t - 2) / per * blocks2;
    slot = kind;
    if (kind == 1) {
      cfirst = first;
      cslot = 3;
    }
  }
  double s = 0.0, c = 0.0;
  for (int j = threadIdx.x; j < count; j += kThreads) {
    s = __dadd_rn(s, partials[static_cast<long long>(first + j) * kSlots + slot]);
    c = __dadd_rn(c, partials[static_cast<long long>(cfirst + j) * kSlots + cslot]);
  }
  s = block_sum(s, shared);
  c = block_sum(c, shared);
  if (threadIdx.x == 0) {
    stats[t] = s;
    stats[gridDim.x + t] = c;
  }
}

}  // namespace

// prob: n pointers to [b, 256, hw2] float32 (dense NCHW); combine, conf: n
// pointers to [b, hw2] in stage 2 (regress = 1), unused in stage 1;
// initial, gt2, m2: [b, hw2]; up, gt0, m0: [b, hw0]; dmin, dmax: [b].
// Writes p_gt, flags, argmax (may be null; stage 2 only) and stats [2, T]
// (see the top of this file), with partials, float64 scratch of 6 per block:
// n * ceil(b * hw2 / 256) + ceil(b * hw0 / 1024) blocks. Returns the
// launch's error (0 on success).
extern "C" int itermvs_full_loss(const void* const* prob, const void* const* combine,
                                 const void* const* conf, int n, int regress,
                                 const float* initial, const float* up, const float* gt2,
                                 const float* m2, const float* gt0, const float* m0,
                                 const float* dmin, const float* dmax, int b, long long hw2,
                                 long long hw0, float* p_gt, unsigned char* flags, int* argmax,
                                 double* partials, double* stats, void* stream) {
  if (n < 1 || n > kMaxPred || b < 1 || hw2 < 1 || hw0 < 1 || prob == nullptr ||
      (regress && (combine == nullptr || conf == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks2 = (b * hw2 + kThreads - 1) / kThreads;
  const long long blocks0 = (b * hw0 + kThreads * kLevel0 - 1) / (kThreads * kLevel0);
  if (n * blocks2 + blocks0 > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Inputs in = inputs(initial, up, gt2, m2, gt0, m0, dmin, dmax, b, hw2, hw0);
  full_loss_kernel<<<static_cast<unsigned>(n * blocks2 + blocks0), kThreads, 0, st>>>(
      planes(prob, n), planes(regress ? combine : nullptr, n),
      planes(regress ? conf : nullptr, n), n, regress, in, static_cast<int>(blocks2), p_gt,
      flags, argmax, partials);
  const int terms = 2 + n * (regress ? 3 : 1);
  full_loss_fold_kernel<<<terms, kThreads, 0, st>>>(partials, stats, n, regress,
                                                    static_cast<int>(blocks2),
                                                    static_cast<int>(blocks0));
  return static_cast<int>(cudaGetLastError());
}
