// K26 clip_adam: optax's clip -> decayed weights -> Adam update, in place
// on every parameter p and its Adam moments m and v, in one pass. With n
// the global norm K25 wrote (its float64 square root rounded to float32)
// and t the step after its increment (b1t = b1^t, b2t = b2^t from the
// host), each element, every operation rounded in float32 in optax's
// order:
//     g1 = n < max_norm ? g : (g / n) * max_norm
//     g2 = g1 + wd * p                          (only where wd > 0)
//     m  = c1 * g2 + b1 * m                     (c1 = 1 - b1, rounded once)
//     v  = c2 * (g2 * g2) + b2 * v              (c2 = 1 - b2)
//     u  = (m / (1 - b1t)) / (sqrt(v / (1 - b2t)) + eps)
//     p  = p + (-lr) * u
// Every operation is a _rn intrinsic, so nvcc contracts nothing into an
// FMA and the result is bit-equal to the plain version, which runs each
// operation as one PyTorch kernel (ops/clip_adam.py clip_adam_plain_).
//
// Replaces: the rest of the jitted update of
// itermvs_tpu/engine/train_loop.py:50-58 (`optax.chain(clip_by_global_norm,
// add_decayed_weights, adam)`, applied at :95-96), which XLA fuses into
// the step. In the port: a div, mul, where and copy_ per gradient, then
// torch.optim.Adam's foreach kernels.
//
// What bounds it on an H100: it reads g, p, m, v and writes p, m, v, 28
// bytes per element, 9.56 MB at the model's 341,333 parameters, 2.85 us at
// 3.35 TB/s; one launch's latency is of that order.
//
// Design: one elementwise pass over the tensor table (clip_adam.cuh), a
// block per kBlockElems elements of one tensor, coalesced float32 loads.
// lr, wd, the betas and their powers come as float32 launch arguments: the
// step count is host state, so nothing syncs.
#include <cuda_runtime.h>

#include "clip_adam.cuh"

namespace {

struct Hyper {
  float max_norm, neg_lr, wd, b1, c1, b2, c2, eps, b1t, b2t;
};

__global__ void __launch_bounds__(kThreads)
clip_adam_kernel(const __grid_constant__ Table table, const double* __restrict__ norm,
                 const Hyper h) {
  const int b = blockIdx.x;
  const int t = tensor_of(table, b);
  float* __restrict__ p = table.p[t];
  const float* __restrict__ g = table.g[t];
  float* __restrict__ m = table.m[t];
  float* __restrict__ v = table.v[t];
  const long long n = table.numel[t];
  const float gn = __double2float_rn(norm[1]);
  const bool keep = gn < h.max_norm;
  const bool decay = h.wd > 0.0f;
  const float bc1 = __fsub_rn(1.0f, h.b1t), bc2 = __fsub_rn(1.0f, h.b2t);
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const long long i = element(table, t, b, j);
    if (i >= n) continue;
    const float pi = p[i];
    float gi = g[i];
    if (!keep) gi = __fmul_rn(__fdiv_rn(gi, gn), h.max_norm);
    if (decay) gi = __fadd_rn(gi, __fmul_rn(h.wd, pi));
    const float mi = __fadd_rn(__fmul_rn(h.c1, gi), __fmul_rn(h.b1, m[i]));
    const float vi = __fadd_rn(__fmul_rn(h.c2, __fmul_rn(gi, gi)), __fmul_rn(h.b2, v[i]));
    const float u = __fdiv_rn(__fdiv_rn(mi, bc1),
                              __fadd_rn(__fsqrt_rn(__fdiv_rn(vi, bc2)), h.eps));
    m[i] = mi;
    v[i] = vi;
    p[i] = __fadd_rn(pi, __fmul_rn(h.neg_lr, u));
  }
}

}  // namespace

// tables: `launches` host Tables (clip_adam.cuh) over p, g, m, v. norm:
// K25's float64 [2] output (its [1], the global norm, is read). The float
// arguments as the update above names them (neg_lr = -lr). One launch per
// table. Returns the launches' error (0 on success), cudaErrorInvalidValue
// for a malformed table.
extern "C" int itermvs_clip_adam(const void* tables, int launches, const double* norm,
                                 float max_norm, float neg_lr, float wd, float b1, float c1,
                                 float b2, float c2, float eps, float b1t, float b2t,
                                 void* stream) {
  const Table* t = static_cast<const Table*>(tables);
  if (checked_blocks(t, launches, -1) < 0) return static_cast<int>(cudaErrorInvalidValue);
  const Hyper h{max_norm, neg_lr, wd, b1, c1, b2, c2, eps, b1t, b2t};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int l = 0; l < launches; ++l) {
    clip_adam_kernel<<<static_cast<unsigned>(t[l].first[t[l].count]), kThreads, 0, st>>>(
        t[l], norm, h);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
