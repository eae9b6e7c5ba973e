// K24 full_loss_grad: the training loss's gradient (ops/full_loss.py has
// the formulas and the tie rules) from the upstream gradient g, each
// term's coefficient and global count, and K23's saved p at the GT bin and
// flags. With each term's u = where(count > 0, g * coeff, 0) / max(count, 1),
// rounded in float32 as autograd rounds it, it writes
//   d_prob: per prediction i, [b, 256, hw2] float32, dense NCHW (the layout
//     K7 reads in place): 0 except at the GT bin, (0 + -(u * m1)) / max(p,
//     1e-5) where p >= 1e-5;
//   d_small [1 + 2n', b * hw2]: d initial, then (stage 2, n' = n) each
//     d combine and each d confidence;
//   d_up [b * hw0]: d upsampled.
// Every zero of d_prob is written here: no memset before it.
//
// Replaces: autodiff of the JAX loss (itermvs_tpu/models/losses.py:24-97),
// which XLA fuses. In the port: autograd's backward of the eager loss,
// which writes each d_prob through gather's backward (a zeroed tensor and
// a scatter), log's and clamp's backward, full passes each.
//
// What bounds it on an H100: memory: the dense d_prob it writes, b * 256 *
// hw2 * 4 bytes per prediction, and a few bytes per pixel it reads.
//
// Design: one kernel of three block ranges. The first writes d_prob: a
// block per prediction, kChunk bins and kThreads pixels, a thread per
// pixel (its value from p, the GT bin and the mask) storing one float per
// bin, so that a warp writes 128 contiguous bytes of each bin's plane (a
// first form storing float4s of 4 pixels per thread took 1.8 times as
// long on an H100). The second takes a level-2 pixel per
// thread (the L1 terms' chain through |.|, the normalisation's divide and
// reciprocal; the BCE's three paths added as autograd adds them), the
// third kLevel0 level-0 pixels per thread. Each block first forms the
// terms' u in shared memory.
#include <cuda_runtime.h>

#include "full_loss.cuh"

namespace {

constexpr int kChunk = 32;              // bins per thread of d_prob
constexpr int kChunks = kBins / kChunk;

struct OutPlanes {
  float* p[kMaxPred];
};

// d of an L1 term's depth d: v = u * mask, delta = norm(d) - reference,
// den = idmin - idmax: -((v * sgn(delta)) / den) * (r * r), r = 1 / (d + 1e-5).
__device__ __forceinline__ float l1_grad(float v, float delta, float den, float d) {
  const float r = recip(__fadd_rn(d, 1e-5f));
  return __fmul_rn(-__fdiv_rn(__fmul_rn(v, sgn(delta)), den), __fmul_rn(r, r));
}

// d of bce(l, t) * m1 with v = u * m1: the paths through |l| (log1p, exp,
// neg, abs) and through l * t, added, then the clamp's.
__device__ __forceinline__ float bce_grad(float v, float l, float t) {
  const float x = expf(-fabsf(l));
  const float through_abs = __fmul_rn(-__fmul_rn(__fdiv_rn(v, __fadd_rn(x, 1.0f)), x), sgn(l));
  const float through_mul = __fmul_rn(-v, t);
  return __fadd_rn(__fadd_rn(through_abs, through_mul), l >= 0.0f ? v : 0.0f);
}

__global__ void __launch_bounds__(kThreads)
full_loss_grad_kernel(Planes combine, Planes conf, int n, int regress, Inputs in,
                      const float* __restrict__ p_gt, const unsigned char* __restrict__ flags,
                      const float* __restrict__ grad, const double* __restrict__ coeff,
                      const double* __restrict__ counts, OutPlanes d_prob,
                      float* __restrict__ d_small, float* __restrict__ d_up, int blocks2) {
  __shared__ float u[kMaxTerms];
  const int per = regress ? 3 : 1, terms = 2 + n * per;
  if (threadIdx.x < terms) {
    const float count = static_cast<float>(counts[threadIdx.x]);
    const float scaled = __fmul_rn(grad[0], static_cast<float>(coeff[threadIdx.x]));
    u[threadIdx.x] = __fdiv_rn(count > 0.0f ? scaled : 0.0f, fmaxf(count, 1.0f));
  }
  __syncthreads();
  const long long n2 = static_cast<long long>(in.b) * in.hw2;
  int block = blockIdx.x;
  if (block < n * kChunks * blocks2) {
    const int i = block / (kChunks * blocks2);
    const int rest = block - i * kChunks * blocks2;
    const int chunk = rest / blocks2;
    const long long pix = static_cast<long long>(rest - chunk * blocks2) * kThreads + threadIdx.x;
    if (pix >= n2) return;
    const int bi = static_cast<int>(pix / in.hw2);
    const int gt = flags[pix];
    const float p = p_gt[i * n2 + pix];
    const float g = __fadd_rn(0.0f, -__fmul_rn(u[2 + per * i], mask_of(in.m2[pix])));
    const float val = p >= kPMin ? __fdiv_rn(g, clamp_min(p, kPMin)) : 0.0f;
    float* out = pick(d_prob.p, i) + (static_cast<long long>(bi) * kBins + chunk * kChunk) * in.hw2
                 + (pix - bi * in.hw2);
#pragma unroll 8
    for (int k = 0; k < kChunk; ++k) out[k * in.hw2] = gt == chunk * kChunk + k ? val : 0.0f;
    return;
  }
  block -= n * kChunks * blocks2;
  if (block < blocks2) {
    const long long pix = static_cast<long long>(block) * kThreads + threadIdx.x;
    if (pix >= n2) return;
    float idmin, idmax;
    depth_range(in, static_cast<int>(pix / in.hw2), idmin, idmax);
    const float den = __fsub_rn(idmin, idmax);
    const float m1 = mask_of(in.m2[pix]);
    const float ngt = normalize(in.gt2[pix], idmin, idmax);
    const float init = in.initial[pix];
    d_small[pix] = l1_grad(__fmul_rn(u[0], m1), __fsub_rn(normalize(init, idmin, idmax), ngt),
                           den, init);
    if (!regress) return;
    for (int i = 0; i < n; ++i) {
      const float mw = __fmul_rn(m1, flags[(1 + i) * n2 + pix] ? 1.0f : 0.0f);
      const float d = pick(combine.p, i)[pix];
      const float delta = __fsub_rn(normalize(d, idmin, idmax), ngt);
      d_small[(1 + i) * n2 + pix] = l1_grad(__fmul_rn(u[3 + 3 * i], mw), delta, den, d);
      const float t = fabsf(delta) < kConfThreshold ? 1.0f : 0.0f;
      d_small[(1 + n + i) * n2 + pix] = bce_grad(__fmul_rn(u[4 + 3 * i], m1),
                                                 pick(conf.p, i)[pix], t);
    }
    return;
  }
  block -= blocks2;
  const long long n0 = static_cast<long long>(in.b) * in.hw0;
  const long long base = static_cast<long long>(block) * kThreads * kLevel0 + threadIdx.x;
#pragma unroll
  for (int j = 0; j < kLevel0; ++j) {
    const long long pix = base + static_cast<long long>(j) * kThreads;
    if (pix < n0) {
      float idmin, idmax;
      depth_range(in, static_cast<int>(pix / in.hw0), idmin, idmax);
      const float d = in.up[pix];
      const float delta = __fsub_rn(normalize(d, idmin, idmax),
                                    normalize(in.gt0[pix], idmin, idmax));
      d_up[pix] = l1_grad(__fmul_rn(u[1], mask_of(in.m0[pix])), delta,
                          __fsub_rn(idmin, idmax), d);
    }
  }
}

}  // namespace

// combine, conf: n pointers to [b, hw2] in stage 2 (regress = 1), unused in
// stage 1; initial, gt2, m2: [b, hw2]; up, gt0, m0: [b, hw0]; dmin, dmax:
// [b]; p_gt, flags: K23's; grad: the upstream gradient, one float32;
// coeff, counts: each term's coefficient and global count, float64 [T].
// Writes d_prob (n pointers to [b, 256, hw2] float32), d_small and d_up
// (see the top of this file). Returns the launch's error (0 on success).
extern "C" int itermvs_full_loss_grad(const void* const* combine, const void* const* conf,
                                      int n, int regress, const float* initial,
                                      const float* up, const float* gt2, const float* m2,
                                      const float* gt0, const float* m0, const float* dmin,
                                      const float* dmax, int b, long long hw2, long long hw0,
                                      const float* p_gt, const unsigned char* flags,
                                      const float* grad, const double* coeff,
                                      const double* counts, float* const* d_prob,
                                      float* d_small, float* d_up, void* stream) {
  if (n < 1 || n > kMaxPred || b < 1 || hw2 < 1 || hw0 < 1 || d_prob == nullptr ||
      (regress && (combine == nullptr || conf == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  OutPlanes out = {};
  for (int i = 0; i < n; ++i) out.p[i] = d_prob[i];
  const long long blocks2 = (b * hw2 + kThreads - 1) / kThreads;
  const long long blocks0 = (b * hw0 + kThreads * kLevel0 - 1) / (kThreads * kLevel0);
  const long long grid = (n * kChunks + 1) * blocks2 + blocks0;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  full_loss_grad_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      planes(regress ? combine : nullptr, n), planes(regress ? conf : nullptr, n), n, regress,
      inputs(initial, up, gt2, m2, gt0, m0, dmin, dmax, b, hw2, hw0), p_gt, flags, grad, coeff,
      counts, out, d_small, d_up, static_cast<int>(blocks2));
  return static_cast<int>(cudaGetLastError());
}
