// K27 depth_metrics: the training step's depth metrics (ops/depth_metrics.py
// has their list, order and semantics). For n predictions at level 2 (b
// images of hw2 pixels, with their GT and mask) and the upsampled depth at
// level 0 (hw0 pixels, GT, mask) it writes means [M] float32, the M = 5 +
// 2n batch means, and table [M, 2] float64, each metric's (n, total):
//     m = (mask > 0.5), e = |est - gt| in float32, v = e or [e > t];
//     per image: count = sum m, mean = sum v*m / max(count, 1) where
//     count > 0, else 0, in float32; per metric: n = the images with
//     count > 0, total = the sum of their means, both in float64, and the
//     metric total / max(n, 1) rounded to float32.
// v*m is a float32 product, so a NaN or infinite estimate at a masked-out
// pixel makes that image's mean error NaN, as the JAX code's product does.
//
// Replaces: the XLA fusion of itermvs_tpu/engine/metrics.py:13-63
// (`depth_metrics`, inside the jitted train and val steps). In the port:
// 348 eager launches per step at 4 iterations (15 metrics).
//
// What bounds it on an H100: memory, and at the training step's 18 MB
// (5.4 us of bytes) the latency of two launches.
//
// Design: two kernels from one launcher, no atomics. The first runs, per
// image, blocks of kThreads * kLevel2 level-2 pixels, then blocks of
// kThreads * kLevel0 level-0 pixels. A level-2 thread reads each pixel's
// GT and mask once and every prediction there, a level-0 thread its
// pixels' depth, GT and mask; each sums its terms in float64 (each term a
// float32 value, so exact there), and the block folds its threads in a
// fixed order into one row of partials. The second kernel, one block,
// adds each image's rows in a fixed order, rounds each image's sums to
// float32 and divides them in float32, as the eager code divides its
// float32 sums (so each image's outlier rate is bit-equal to it while the
// counts stay below 2^24), then sums the images' means in float64, which
// holds a batch of float32 means exactly, in any order. So the outlier
// rates are bit-equal to the eager code's, and two launches are too.
#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLevel2 = 4;                  // level-2 pixels per thread
constexpr int kLevel0 = 8;                  // level-0 pixels per thread
constexpr int kMaxPred = 16;                // predictions (pointers by value)
// A level-2 row: the mask count, then per prediction j sum m*e (1 + 2j)
// and sum m*[e > 1] (2 + 2j). A level-0 row: sum m*e, sum m*[e > t] for
// t = 1, 2, 4, 8, the mask count.
constexpr int kSlots2 = 1 + 2 * kMaxPred;
constexpr int kSlots0 = 6;

// One float32 plane per prediction.
struct Planes {
  const float* p[kMaxPred];
};

__device__ __forceinline__ float mask_of(float m) { return m > 0.5f ? 1.0f : 0.0f; }

__device__ __forceinline__ float abs_error(float est, float gt) {
  return fabsf(__fsub_rn(est, gt));
}

// m * [e > t]: NaN > t is false.
__device__ __forceinline__ double outlier(float e, float t, float m) {
  return static_cast<double>(__fmul_rn(e > t ? 1.0f : 0.0f, m));
}

// The block's sums of v[0, used), folded in a fixed order (warp
// butterflies, then the warps in order), written by the first `used`
// threads to out[0, used). Every index into v is a constant, so v stays
// in registers.
template <int S>
__device__ __forceinline__ void block_sums(double (&v)[S], int used, double* shared,
                                           double* out) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int k = 0; k < S; ++k) {
    if (k < used) {
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        v[k] = __dadd_rn(v[k], __shfl_xor_sync(~0u, v[k], off));
      if (lane == 0) shared[warp * S + k] = v[k];
    }
  }
  __syncthreads();
  if (threadIdx.x < used) {
    double s = 0.0;
    for (int w = 0; w < kWarps; ++w) s = __dadd_rn(s, shared[w * S + threadIdx.x]);
    out[threadIdx.x] = s;
  }
}

__global__ void __launch_bounds__(kThreads)
depth_metrics_pixel_kernel(Planes pred, int n, const float* __restrict__ gt2,
                           const float* __restrict__ m2, const float* __restrict__ up,
                           const float* __restrict__ gt0, const float* __restrict__ m0,
                           long long hw2, long long hw0, int blocks2, int blocks0, int images,
                           double* __restrict__ partials2, double* __restrict__ partials0) {
  __shared__ double shared[kWarps * kSlots2];
  const int level2 = images * blocks2;
  if (static_cast<int>(blockIdx.x) < level2) {
    const int image = blockIdx.x / blocks2;
    const long long first =
        static_cast<long long>(blockIdx.x - image * blocks2) * kThreads * kLevel2 + threadIdx.x;
    const long long base = image * hw2;
    double v[kSlots2];
#pragma unroll
    for (int k = 0; k < kSlots2; ++k) v[k] = 0.0;
#pragma unroll
    for (int p = 0; p < kLevel2; ++p) {
      const long long q = first + p * kThreads;
      if (q < hw2) {
        const long long i = base + q;
        const float m = mask_of(m2[i]);
        const float g = gt2[i];
        v[0] = __dadd_rn(v[0], static_cast<double>(m));
#pragma unroll
        for (int j = 0; j < kMaxPred; ++j) {
          if (j < n) {
            const float e = abs_error(pred.p[j][i], g);
            v[1 + 2 * j] = __dadd_rn(v[1 + 2 * j], static_cast<double>(__fmul_rn(e, m)));
            v[2 + 2 * j] = __dadd_rn(v[2 + 2 * j], outlier(e, 1.0f, m));
          }
        }
      }
    }
    block_sums(v, 1 + 2 * n, shared, partials2 + static_cast<long long>(blockIdx.x) * kSlots2);
  } else {
    const int block = blockIdx.x - level2;
    const int image = block / blocks0;
    const long long first =
        static_cast<long long>(block - image * blocks0) * kThreads * kLevel0 + threadIdx.x;
    const long long base = image * hw0;
    double v[kSlots0] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
#pragma unroll
    for (int p = 0; p < kLevel0; ++p) {
      const long long q = first + p * kThreads;
      if (q < hw0) {
        const long long i = base + q;
        const float m = mask_of(m0[i]);
        const float e = abs_error(up[i], gt0[i]);
        v[0] = __dadd_rn(v[0], static_cast<double>(__fmul_rn(e, m)));
        v[1] = __dadd_rn(v[1], outlier(e, 1.0f, m));
        v[2] = __dadd_rn(v[2], outlier(e, 2.0f, m));
        v[3] = __dadd_rn(v[3], outlier(e, 4.0f, m));
        v[4] = __dadd_rn(v[4], outlier(e, 8.0f, m));
        v[5] = __dadd_rn(v[5], static_cast<double>(m));
      }
    }
    block_sums(v, kSlots0, shared, partials0 + static_cast<long long>(block) * kSlots0);
  }
}

// Metric k's value and count, as indices into an image's row of sums (the
// level-2 slots, then the level-0 ones from per2), in the order of
// ops/depth_metrics.py metric_names.
__device__ __forceinline__ void metric_source(int k, int per2, int& value, int& count) {
  count = 0;
  if (k < 2) {                      // abs_error_initial, thres1mm_initial
    value = 1 + k;
  } else if (k < 7) {               // abs_error_final_full, thres{1,2,4,8}mm_final_full
    value = per2 + k - 2;
    count = per2 + 5;
  } else {                          // thres1mm_gru_j, abs_error_gru_j
    const int j = 1 + (k - 7) / 2;
    value = (k - 7) % 2 == 0 ? 2 + 2 * j : 1 + 2 * j;
  }
}

// Each image's sums over its blocks' rows (into sums [images, per]), then
// per metric the batch mean (see the top of this file).
__global__ void __launch_bounds__(kThreads)
depth_metrics_fold_kernel(const double* __restrict__ partials2,
                          const double* __restrict__ partials0, int n, int images, int blocks2,
                          int blocks0, double* __restrict__ sums, float* __restrict__ means,
                          double* __restrict__ table) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int per2 = 1 + 2 * n, per = per2 + kSlots0, tasks = images * per;
  // A warp per (image, sum); every warp runs the same rounds, so each
  // round's shuffles have all their lanes.
  for (int round = 0; round * kWarps < tasks; ++round) {
    const int t = round * kWarps + warp;
    double s = 0.0;
    if (t < tasks) {
      const int image = t / per, k = t - image * per;
      const bool low = k < per2;
      const double* src = low ? partials2 + static_cast<long long>(image) * blocks2 * kSlots2 + k
                              : partials0 + static_cast<long long>(image) * blocks0 * kSlots0 +
                                    (k - per2);
      const int rows = low ? blocks2 : blocks0, stride = low ? kSlots2 : kSlots0;
      for (int r = lane; r < rows; r += 32) s = __dadd_rn(s, src[static_cast<long long>(r) * stride]);
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2) s = __dadd_rn(s, __shfl_xor_sync(~0u, s, off));
    if (t < tasks && lane == 0) sums[t] = s;
  }
  __syncthreads();
  const int metrics = 5 + 2 * n;
  for (int k = threadIdx.x; k < metrics; k += kThreads) {
    int value, count;
    metric_source(k, per2, value, count);
    double valid = 0.0, total = 0.0;
    for (int image = 0; image < images; ++image) {
      const double* row = sums + static_cast<long long>(image) * per;
      const float c = __double2float_rn(row[count]);
      const float has = c > 0.0f ? 1.0f : 0.0f;
      const float mean = c > 0.0f ? __fdiv_rn(__double2float_rn(row[value]), fmaxf(c, 1.0f))
                                  : 0.0f;
      valid = __dadd_rn(valid, static_cast<double>(has));
      total = __dadd_rn(total, static_cast<double>(__fmul_rn(mean, has)));
    }
    // Where valid is 0 so is total: the metric is 0, as JAX's where gives it.
    means[k] = __double2float_rn(__ddiv_rn(total, fmax(valid, 1.0)));
    table[2 * k] = valid;
    table[2 * k + 1] = total;
  }
}

}  // namespace

// pred: n pointers to [images, hw2] float32; gt2, m2: [images, hw2]; up,
// gt0, m0: [images, hw0]. scratch: float64, at least
// images * (blocks2 * 33 + blocks0 * 6 + 2n + 7) of it, blocks2 =
// ceil(hw2 / 1024), blocks0 = ceil(hw0 / 2048). means: float32 [5 + 2n];
// table: float64 [5 + 2n, 2] (see the top of this file). Returns the
// launches' error (0 on success), cudaErrorInvalidValue for arguments out
// of range.
extern "C" int itermvs_depth_metrics(const void* const* pred, int n, const float* gt2,
                                     const float* m2, const float* up, const float* gt0,
                                     const float* m0, int images, long long hw2, long long hw0,
                                     double* scratch, long long scratch_len, float* means,
                                     double* table, void* stream) {
  if (n < 1 || n > kMaxPred || images < 1 || hw2 < 1 || hw0 < 1 || pred == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks2 = (hw2 + kThreads * kLevel2 - 1) / (kThreads * kLevel2);
  const long long blocks0 = (hw0 + kThreads * kLevel0 - 1) / (kThreads * kLevel0);
  const long long grid = images * (blocks2 + blocks0);
  const long long need = images * (blocks2 * kSlots2 + blocks0 * kSlots0 + 1 + 2 * n + kSlots0);
  if (grid > INT_MAX || scratch_len < need) return static_cast<int>(cudaErrorInvalidValue);
  Planes planes;
  for (int j = 0; j < kMaxPred; ++j)
    planes.p[j] = j < n ? static_cast<const float*>(pred[j]) : nullptr;
  double* partials2 = scratch;
  double* partials0 = partials2 + images * blocks2 * kSlots2;
  double* sums = partials0 + images * blocks0 * kSlots0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  depth_metrics_pixel_kernel<<<static_cast<unsigned>(grid), kThreads, 0, st>>>(
      planes, n, gt2, m2, up, gt0, m0, hw2, hw0, static_cast<int>(blocks2),
      static_cast<int>(blocks0), images, partials2, partials0);
  depth_metrics_fold_kernel<<<1, kThreads, 0, st>>>(partials2, partials0, n, images,
                                                    static_cast<int>(blocks2),
                                                    static_cast<int>(blocks0), sums, means,
                                                    table);
  return static_cast<int>(cudaGetLastError());
}
