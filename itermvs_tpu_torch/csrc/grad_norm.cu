// K25 grad_norm: the squared global norm of the gradients, sum over every
// element of every tensor of g^2, in float64, and its square root:
//     out[0] = sum g^2,   out[1] = sqrt(out[0])   (both float64)
// K26 clip_adam reads out[1] from device memory, so the norm never goes
// through the host.
//
// Replaces: `optax.clip_by_global_norm(2.0)`'s global norm
// (optax/_src/linear_algebra.py global_norm) inside the jitted update of
// itermvs_tpu/engine/train_loop.py:50-58, which XLA fuses into the step.
// In the port: 101 `torch.linalg.vector_norm` launches and a stack.
//
// What bounds it on an H100: at the model's 100 gradients (341,333
// elements, 1.37 MB) the byte bound is 0.41 us, far below two launches'
// latency; launch latency bounds it.
//
// Design: two kernels from one launcher, no atomics. The first walks the
// tensor table (clip_adam.cuh, by value in the kernel parameters, chunked
// by the caller where it exceeds kMaxTensors): a block per kBlockElems
// elements of one tensor, each thread squares and sums its elements in
// float64 (exact squares of float32 values), the block folds its threads
// in a fixed tree into one partial. The second, one block, adds the
// partials in a fixed order. So two launches are bit-equal, and the only
// rounding is float64's.
#include <cuda_runtime.h>

#include "clip_adam.cuh"

namespace {

constexpr int kWarps = kThreads / 32;

// The block's float64 sum of `v`, folded in a fixed order, in every thread.
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

// Block b's partial sum of g^2 at partials[block0 + b].
__global__ void __launch_bounds__(kThreads)
grad_norm_partial_kernel(const __grid_constant__ Table table, double* __restrict__ partials) {
  __shared__ double shared[kWarps + 1];
  const int b = blockIdx.x;
  const int t = tensor_of(table, b);
  const float* __restrict__ g = table.g[t];
  const long long n = table.numel[t];
  double s = 0.0;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const long long i = element(table, t, b, j);
    if (i < n) {
      const double x = static_cast<double>(g[i]);
      s = __dadd_rn(s, __dmul_rn(x, x));
    }
  }
  s = block_sum(s, shared);
  if (threadIdx.x == 0) partials[table.block0 + b] = s;
}

// out[0] = the partials' sum in a fixed order, out[1] its square root.
__global__ void __launch_bounds__(kThreads)
grad_norm_fold_kernel(const double* __restrict__ partials, int blocks, double* __restrict__ out) {
  __shared__ double shared[kWarps + 1];
  double s = 0.0;
  for (int j = threadIdx.x; j < blocks; j += kThreads) s = __dadd_rn(s, partials[j]);
  s = block_sum(s, shared);
  if (threadIdx.x == 0) {
    out[0] = s;
    out[1] = __dsqrt_rn(s);
  }
}

}  // namespace

// tables: `launches` host Tables (clip_adam.cuh) over the gradients, their
// blocks numbered on from one launch to the next, `blocks` in all.
// partials: float64 scratch of `blocks`. out: float64 [2], written with the
// sum of g^2 and its square root (0 and 0 for no tensor). One launch of
// the first kernel per table, then the fold. Returns the launches' error
// (0 on success), cudaErrorInvalidValue for a malformed table.
extern "C" int itermvs_grad_norm(const void* tables, int launches, double* partials, int blocks,
                                 double* out, void* stream) {
  const Table* t = static_cast<const Table*>(tables);
  if (checked_blocks(t, launches, blocks) < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int l = 0; l < launches; ++l) {
    grad_norm_partial_kernel<<<static_cast<unsigned>(t[l].first[t[l].count]), kThreads, 0, st>>>(
        t[l], partials);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  grad_norm_fold_kernel<<<1, kThreads, 0, st>>>(partials, blocks, out);
  return static_cast<int>(cudaGetLastError());
}
