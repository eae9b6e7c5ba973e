// K6 depth_readout: the 256-bin depth-head softmax and the windowed
// expectation of the normalized depth, one pixel per thread, each block's
// logits staged once in shared memory.
//
// Replaces: the XLA chain of itermvs_tpu/models/itermvs.py:75
// `windowed_expectation` with the `jax.nn.softmax` of the depth-head
// logits before it (:402, :413). On the port's NCHW layout, per pixel:
//     p_k   = exp(l_k - max l) / sum_j exp(l_j - max l)
//     idx   = argmax_k p_k (the first on ties), held constant
//     w_k   = [|k - idx| <= 4] + max(0, 4 - idx) [k == 0]
//             + max(0, idx + 4 - 255) [k == 255]
//     S     = sum_k w_k p_k,   r = sum_k w_k p_k k / (1e-6 + S)
//     depth = r / 255
// In training the kernel also writes p (the loss reads it) and idx, S and
// r, which the backward (K7, depth_readout_grad.cu) reads instead of
// searching the argmax again. In eval nothing reads p and it is not
// written.
//
// What bounds it on an H100: memory. Per pixel it reads 256 logits (1 KB
// in f32, 512 B in bf16) and writes 4 bytes, plus 1 KB of p in training;
// a few hundred operations per pixel, below the card's balance point.
//
// The per-pixel arithmetic: a first pass finds the maximum (kChunk
// running maxima: a maximum is exact in any order); a second sums
// exp(l - max) in float32 from bin 0 up, as PyTorch's softmax over a
// non-minor dimension does at these sizes (one thread per position), so
// that p = exp(l - max) / sum matches the plain version bit for bit where
// the two expf agree. (An online one-pass form reads the logits once, but
// its rescaled sum differs from the plain version's: a float32 sum of 256
// terms in bin order is itself off by up to ~1e-6, beyond the gate on p.)
// The plain version's argmax is that of p: logits within about 2^-25 of
// the maximum give exp = 1 and tie in p, and then the first such bin
// wins, not the largest logit. The second pass also notes the first bin
// whose exp(l - max) reaches kNearTie; no bin before it can tie, so the
// argmax is the first bin from there whose p equals 1 / sum (a maximum's
// bin at the latest, usually the first one tried). Then the 9 window
// bins are read again, and training adds a pass that writes p. Softmax
// in f32 with expf (no fast math: the build has none). The order in
// which the maximum and the first tie are searched changes no bit of the
// depth, the probability or the argmax for finite logits.
//
// Design: every pass reads the logits again, so a block of kTile
// threads first copies its kTile consecutive pixels x 256 bins into
// shared memory, in the logits' own dtype (64 KB in f32, 32 KB in bf16),
// with 16-byte cp.async copies, a warp's copies covering whole 256-byte
// (128-byte in bf16) runs of a bin's row; then every pass runs from
// there, thread = pixel, bins down the column (consecutive threads on
// consecutive words: no bank conflicts). Device memory sees each logit
// once. Above 48 KB the tile needs dynamic shared memory, which the
// launcher opts in to; three f32 blocks (six bf16 ones) fit on an SM, and
// one block's copy overlaps the others' passes. The passes, not the
// copies, set the pace: on an H100 a persistent form with two buffers per
// block (the next tile copied while this one is read) ran slower, as did
// two bf16 pixels per thread, since both halve the resident warps. A
// block's tile lies in one batch entry: the last tile of each entry is
// ragged when H*W is not a multiple of kTile, and its threads past the
// end only copy. Where a row of the tile is not 16-byte aligned (H*W
// times the dtype's size not a multiple of 16) each thread copies its own
// column element by element instead.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kBins = 256;
constexpr int kRadius = 4;
constexpr int kTile = 64;        // pixels (and threads) per block
constexpr int kChunk = 32;       // logits loaded ahead per thread
// A bin whose exp(l - max) lies below kNearTie has p < p_max: s >= 1, so
// its quotient by s lies more than 8 float32 steps below 1 / s (a step is
// at most 2^-23 of the value), which two round-to-nearest divides cannot
// close. Only bins at or above it can tie the maximum's p.
constexpr float kNearTie = 0.999999f;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void copy16_async(void* shared, const void* global) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(shared));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(global));
}

__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Window weight of bin k around argmax idx (0 outside the window).
__device__ __forceinline__ float window_weight(int k, int idx) {
  const int d = k - idx;
  if (d < -kRadius || d > kRadius) return 0.f;
  int w = 1;
  if (k == 0) w += max(0, kRadius - idx);
  if (k == kBins - 1) w += max(0, idx + kRadius - (kBins - 1));
  return static_cast<float>(w);
}

template <typename T, bool kAligned>
__global__ void __launch_bounds__(kTile)
depth_readout_kernel(const T* __restrict__ logits, float* __restrict__ depth,
                     float* __restrict__ prob, int* __restrict__ index,
                     float* __restrict__ mass, float* __restrict__ regress,
                     int hw, int tiles) {
  extern __shared__ __align__(16) unsigned char shared[];
  T* tile = reinterpret_cast<T*>(shared);          // [kBins][kTile]
  const int b = blockIdx.x / tiles;
  const int q0 = (blockIdx.x - b * tiles) * kTile;
  const int n = min(kTile, hw - q0);
  const long long plane0 = static_cast<long long>(b) * kBins * hw + q0;
  const T* src = logits + plane0;
  if (kAligned) {
    // A bin's row of the tile is kCols 16-byte pieces; the block fills
    // kRows rows at a time.
    constexpr int kPer = 16 / sizeof(T);
    constexpr int kCols = kTile / kPer;
    constexpr int kRows = kTile / kCols;
    const int e = (threadIdx.x % kCols) * kPer;
    if (e < n) {
      for (int k = threadIdx.x / kCols; k < kBins; k += kRows)
        copy16_async(tile + k * kTile + e, src + static_cast<long long>(k) * hw + e);
    }
    wait_copies();
  } else if (static_cast<int>(threadIdx.x) < n) {
    for (int k = 0; k < kBins; ++k)
      tile[k * kTile + threadIdx.x] = src[static_cast<long long>(k) * hw + threadIdx.x];
  }
  __syncthreads();
  if (static_cast<int>(threadIdx.x) >= n) return;
  const long long pix = static_cast<long long>(b) * hw + q0 + threadIdx.x;
  const T* x = tile + threadIdx.x;                 // bin k at x[k * kTile]

  // Pass 1: the maximum, as kChunk running maxima (exact in any order).
  float mx[kChunk];
#pragma unroll
  for (int j = 0; j < kChunk; ++j) mx[j] = -INFINITY;
  for (int k0 = 0; k0 < kBins; k0 += kChunk) {
#pragma unroll
    for (int j = 0; j < kChunk; ++j) mx[j] = fmaxf(mx[j], to_float(x[(k0 + j) * kTile]));
  }
  float m = mx[0];
#pragma unroll
  for (int j = 1; j < kChunk; ++j) m = fmaxf(m, mx[j]);
  // Pass 2: sum exp(l - max), float32, in bin order, and find the first
  // bin whose exp(l - max) reaches kNearTie.
  float s = 0.f;
  int near = kBins;
  for (int k0 = 0; k0 < kBins; k0 += kChunk) {
    float v[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) v[j] = to_float(x[(k0 + j) * kTile]);
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const float e = expf(__fsub_rn(v[j], m));
      s = __fadd_rn(s, e);
      if (e >= kNearTie) near = min(near, k0 + j);
    }
  }
  // argmax of p, the first bin whose p equals p_max = 1 / s (that of a
  // maximum's bin, where exp(0) = 1): no bin before `near` can tie it.
  const float p_max = __fdiv_rn(1.f, s);
  int idx = min(near, kBins - 1);
  while (idx < kBins - 1 &&
         __fdiv_rn(expf(__fsub_rn(to_float(x[idx * kTile]), m)), s) != p_max)
    ++idx;

  // The window, in the plain version's order (p * w, then the
  // product with the bin index).
  const int lo = max(idx - kRadius, 0);
  const int hi = min(idx + kRadius, kBins - 1);
  float total = 0.f, moment = 0.f;
  for (int k = lo; k <= hi; ++k) {
    const float p = __fdiv_rn(expf(__fsub_rn(to_float(x[k * kTile]), m)), s);
    const float pw = __fmul_rn(p, window_weight(k, idx));
    total = __fadd_rn(total, pw);
    moment = __fadd_rn(moment, __fmul_rn(pw, static_cast<float>(k)));
  }
  const float r = __fdiv_rn(moment, __fadd_rn(1e-6f, total));
  depth[pix] = __fmul_rn(r, 1.0f / 255.0f);
  if (prob == nullptr) return;

  // Training: p itself, and what the backward reads.
  index[pix] = idx;
  mass[pix] = total;
  regress[pix] = r;
  float* out = prob + plane0 + threadIdx.x;
  for (int k0 = 0; k0 < kBins; k0 += kChunk) {
    float v[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) v[j] = to_float(x[(k0 + j) * kTile]);
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
      out[static_cast<long long>(k0 + j) * hw] = __fdiv_rn(expf(__fsub_rn(v[j], m)), s);
  }
}

template <typename T, bool kAligned>
int launch_tiles(const T* logits, float* depth, float* prob, int* index, float* mass,
                 float* regress, int batch, int hw, cudaStream_t stream) {
  constexpr int kShared = kBins * kTile * static_cast<int>(sizeof(T));
  // Once per form: the opt-in above 48 KB, and all of the SM's unified
  // L1/shared memory as shared memory, so that three f32 tiles fit.
  static const cudaError_t opted = [] {
    cudaError_t err = cudaFuncSetAttribute(depth_readout_kernel<T, kAligned>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           kShared);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(depth_readout_kernel<T, kAligned>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    return err;
  }();
  if (opted != cudaSuccess) return static_cast<int>(opted);
  const int tiles = (hw + kTile - 1) / kTile;
  const long long blocks = static_cast<long long>(batch) * tiles;
  depth_readout_kernel<T, kAligned><<<static_cast<unsigned>(blocks), kTile, kShared, stream>>>(
      logits, depth, prob, index, mass, regress, hw, tiles);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* logits, float* depth, float* prob, int* index, float* mass,
           float* regress, int batch, int hw, void* stream) {
  if (static_cast<long long>(batch) * hw <= 0) return 0;
  const T* x = static_cast<const T*>(logits);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool aligned = reinterpret_cast<unsigned long long>(logits) % 16 == 0 &&
                       (static_cast<long long>(hw) * sizeof(T)) % 16 == 0;
  return aligned ? launch_tiles<T, true>(x, depth, prob, index, mass, regress, batch, hw, st)
                 : launch_tiles<T, false>(x, depth, prob, index, mass, regress, batch, hw, st);
}

}  // namespace

// logits: [batch, 256, hw] contiguous (float32 or bfloat16). depth: [batch,
// hw] float32. prob ([batch, 256, hw] float32), index ([batch, hw] int32),
// mass and regress ([batch, hw] float32): all four, or all null (eval).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int itermvs_depth_readout(const void* logits, float* depth, float* prob,
                                     int* index, float* mass, float* regress,
                                     int batch, int hw, void* stream) {
  return launch<float>(logits, depth, prob, index, mass, regress, batch, hw, stream);
}

extern "C" int itermvs_depth_readout_bf16(const void* logits, float* depth, float* prob,
                                          int* index, float* mass, float* regress,
                                          int batch, int hw, void* stream) {
  return launch<__nv_bfloat16>(logits, depth, prob, index, mass, regress, batch, hw,
                               stream);
}
