// K7 depth_readout_grad: the backward of K6 (depth_readout.cu), the
// gradient of the depth-head logits through the 256-bin softmax and the
// windowed expectation, a block per tile of kTile pixels x 256 bins.
//
// Replaces: XLA's autodiff of itermvs_tpu/models/itermvs.py:75
// `windowed_expectation` and of the `jax.nn.softmax` before it (:402,
// :413), with the argmax held constant (stop-gradient). With r, S and idx
// from the forward, the window weights w_k, c = dd / (255 (1e-6 + S)):
//     g_k  = dp_k + c w_k (k - r)
//     dl_k = p_k (g_k - sum_j p_j g_j)
// dp is the gradient of the probability (the loss's cross-entropy reads
// it), dd that of the normalized depth; either may be absent (null: 0).
// dl comes out in the logits' dtype, rounded once (bf16: round to nearest
// even, the gradient of the forward's float32 cast).
//
// What bounds it on an H100: memory. Per pixel it reads 256 values of p
// and of dp and writes 256 of dl (3 KB in f32), with a few operations per
// byte.
//
// Layouts: p and dl are [batch, 256, hw] (NCHW). dp comes in either of
// two layouts, read where it lies: dense NCHW (bin stride hw, pixel stride
// 1; what the training loss hands back, its clamp's backward taking the
// layout of the probability) or channels-last (bin stride 1, pixel stride
// 256: each pixel's 256 bins contiguous, the layout the loss reads the
// probability in).
//
// Design: each input is read from device memory once. A block of
// kThreads threads owns kTile consecutive pixels of one batch entry (the
// last tile of each entry is ragged when hw is not a multiple of kTile)
// and stages p and dp in shared memory, both as [bin][pixel]: p with
// 16-byte cp.async copies along the pixels, dp with 16-byte loads along
// whichever axis is contiguous, stored a float at a time into rows padded
// to kTile + 1 floats, so that the transposing stores of the
// channels-last layout and the column reads below are free of bank
// conflicts. Then warp w sums p_k g_k over its 16 bins for the 32 pixels
// (lane = pixel), the 16 partial sums are added in warp order (a fixed
// order: two launches write the same bits; no atomics), and every thread
// writes dl for 4 neighbouring pixels of a bin: one float4 (or two
// __nv_bfloat162) per store, 8 threads on a bin's 32 pixels. Where hw is
// not a multiple of 4 or a pointer not 16-byte aligned, the same passes
// run a float at a time. The tile's 67 KB of shared memory (p and dp)
// need the opt-in above 48 KB; three blocks fit on an SM, 48 warps (at
// most 42 registers a thread). On an H100 this beat 256 threads a block
// (24 warps per SM) by 5-9% in both dtypes and layouts.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBins = 256;
constexpr int kRadius = 4;
constexpr int kTile = 32;                    // pixels per block
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kWarpBins = kBins / kWarps;    // bins per warp in the sum
constexpr int kRow = kTile + 1;              // dp's padded row, floats
// 16-byte pieces of a tile array per thread (kTile * kBins / 4 / kThreads).
constexpr int kLoads = kTile * kBins / 4 / kThreads;
static_assert(kWarpBins * kWarps == kBins && kTile == 32, "lane = pixel in the sum");

enum Layout { kNone, kDense, kLast };        // dp absent, NCHW, channels-last

// Shared memory, in floats: p [kBins][kTile], per pixel c, r, idx and the
// dot product, the warps' partial sums, then dp [kBins][kRow].
constexpr int kPOff = 0;
constexpr int kCOff = kBins * kTile;
constexpr int kROff = kCOff + kTile;
constexpr int kIdxOff = kROff + kTile;
constexpr int kDotOff = kIdxOff + kTile;
constexpr int kPartOff = kDotOff + kTile;
constexpr int kDpOff = kPartOff + kWarps * kTile;
constexpr int shared_bytes(Layout layout) {
  return 4 * (kDpOff + (layout == kNone ? 0 : kBins * kRow));
}

__device__ __forceinline__ void copy16_async(void* shared, const void* global) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(shared));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(global));
}

__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// g_k's window term: w_k (k - r), 0 outside the window.
__device__ __forceinline__ float window_term(int k, int idx, float r) {
  const int d = k - idx;
  if (d < -kRadius || d > kRadius) return 0.f;
  int w = 1;
  if (k == 0) w += max(0, kRadius - idx);
  if (k == kBins - 1) w += max(0, idx + kRadius - (kBins - 1));
  return static_cast<float>(w) * (static_cast<float>(k) - r);
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b, float c,
                                       float d) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b), hi = __floats2bfloat162_rn(c, d);
  uint2 v;
  v.x = *reinterpret_cast<const unsigned*>(&lo);
  v.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = v;
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T, Layout kLayout, bool kVec>
__global__ void __launch_bounds__(kThreads, 3)
depth_readout_grad_kernel(const float* __restrict__ prob, const float* __restrict__ d_prob,
                          const float* __restrict__ d_depth, const int* __restrict__ index,
                          const float* __restrict__ mass, const float* __restrict__ regress,
                          T* __restrict__ d_logits, int hw, int tiles, long long dp_batch) {
  extern __shared__ __align__(16) float shared[];
  float* sp = shared + kPOff;
  float* sdp = shared + kDpOff;
  const int tid = threadIdx.x;
  const int b = blockIdx.x / tiles;
  const int q0 = (blockIdx.x - b * tiles) * kTile;
  const int n = min(kTile, hw - q0);
  const long long plane0 = static_cast<long long>(b) * kBins * hw + q0;
  const float* src_p = prob + plane0;
  // dp of pixel q0 (dense: of bin 0 too).
  const float* src_dp =
      kLayout == kNone ? nullptr
                       : d_prob + b * dp_batch + (kLayout == kDense ? q0 : q0 * kBins);

  // Stage p and dp.
  if (kVec) {
    // p and dense dp: 8 threads copy a bin's 32 pixels, 32 bins a pass.
    const int e = (tid % 8) * 4;
    if (e < n) {
      for (int k = tid / 8; k < kBins; k += kThreads / 8)
        copy16_async(sp + k * kTile + e, src_p + static_cast<long long>(k) * hw + e);
    }
    if (kLayout == kDense && e < n) {
      // Every load in flight before the first store.
      float4 v[kLoads];
#pragma unroll
      for (int i = 0; i < kLoads; ++i) {
        const int k = tid / 8 + i * (kThreads / 8);
        v[i] = __ldg(reinterpret_cast<const float4*>(src_dp + static_cast<long long>(k) * hw + e));
      }
#pragma unroll
      for (int i = 0; i < kLoads; ++i) {
        float* row = sdp + (tid / 8 + i * (kThreads / 8)) * kRow + e;
        row[0] = v[i].x, row[1] = v[i].y, row[2] = v[i].z, row[3] = v[i].w;
      }
    }
    if (kLayout == kLast) {
      // A warp reads 8 16-byte pieces (32 bins) of 4 pixels: whole 128-byte
      // lines, and stores of bin k, pixel q at k * kRow + q fall in 32
      // distinct banks.
      const int lane = tid % 32;
      float4 v[kLoads];
#pragma unroll
      for (int i = 0; i < kLoads; ++i) {
        const int g = tid / 32 + i * kWarps;
        const int q = (g % 8) * 4 + lane / 8;
        const int k = ((g / 8) * 8 + lane % 8) * 4;
        if (q < n) v[i] = __ldg(reinterpret_cast<const float4*>(src_dp + q * kBins + k));
      }
#pragma unroll
      for (int i = 0; i < kLoads; ++i) {
        const int g = tid / 32 + i * kWarps;
        const int q = (g % 8) * 4 + lane / 8;
        const int k = ((g / 8) * 8 + lane % 8) * 4;
        if (q < n) {
          float* col = sdp + k * kRow + q;
          col[0] = v[i].x, col[kRow] = v[i].y, col[2 * kRow] = v[i].z, col[3 * kRow] = v[i].w;
        }
      }
    }
    wait_copies();
  } else {
    // A float at a time, lane = pixel.
    const int q = tid % kTile;
    if (q < n) {
      for (int k = tid / kTile; k < kBins; k += kThreads / kTile) {
        sp[k * kTile + q] = src_p[static_cast<long long>(k) * hw + q];
        if (kLayout != kNone)
          sdp[k * kRow + q] =
              src_dp[kLayout == kDense ? static_cast<long long>(k) * hw + q : q * kBins + k];
      }
    }
  }
  if (tid < n) {
    const long long pix = static_cast<long long>(b) * hw + q0 + tid;
    shared[kCOff + tid] =
        d_depth == nullptr ? 0.f : d_depth[pix] / (255.f * (1e-6f + mass[pix]));
    shared[kROff + tid] = regress[pix];
    reinterpret_cast<int*>(shared)[kIdxOff + tid] = index[pix];
  }
  __syncthreads();

  // sum_k p_k g_k: warp w over bins [w * kWarpBins, (w + 1) * kWarpBins),
  // lane = pixel, then the warps' sums in warp order.
  {
    const int lane = tid % 32, w = tid / 32;
    if (lane < n) {
      const float c = shared[kCOff + lane], r = shared[kROff + lane];
      const int idx = reinterpret_cast<const int*>(shared)[kIdxOff + lane];
      float acc = 0.f;
#pragma unroll 8
      for (int k = w * kWarpBins; k < (w + 1) * kWarpBins; ++k) {
        const float g = (kLayout == kNone ? 0.f : sdp[k * kRow + lane]) +
                        c * window_term(k, idx, r);
        acc += sp[k * kTile + lane] * g;
      }
      shared[kPartOff + w * kTile + lane] = acc;
    }
  }
  __syncthreads();
  if (tid < n) {
    float dot = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) dot += shared[kPartOff + w * kTile + tid];
    shared[kDotOff + tid] = dot;
  }
  __syncthreads();

  // dl_k = p_k (g_k - dot), coalesced along the pixels.
  T* out = d_logits + plane0;
  if (kVec) {
    const int e = (tid % 8) * 4;                 // this thread's 4 pixels
    if (e >= n) return;
    float c[4], r[4], dot[4];
    int idx[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      c[i] = shared[kCOff + e + i];
      r[i] = shared[kROff + e + i];
      dot[i] = shared[kDotOff + e + i];
      idx[i] = reinterpret_cast<const int*>(shared)[kIdxOff + e + i];
    }
#pragma unroll 4
    for (int k = tid / 8; k < kBins; k += kThreads / 8) {
      const float4 p = *reinterpret_cast<const float4*>(sp + k * kTile + e);
      const float pv[4] = {p.x, p.y, p.z, p.w};
      float v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float g = (kLayout == kNone ? 0.f : sdp[k * kRow + e + i]) +
                        c[i] * window_term(k, idx[i], r[i]);
        v[i] = pv[i] * (g - dot[i]);
      }
      store4(out + static_cast<long long>(k) * hw + e, v[0], v[1], v[2], v[3]);
    }
  } else {
    const int q = tid % kTile;
    if (q >= n) return;
    const float c = shared[kCOff + q], r = shared[kROff + q], dot = shared[kDotOff + q];
    const int idx = reinterpret_cast<const int*>(shared)[kIdxOff + q];
    for (int k = tid / kTile; k < kBins; k += kThreads / kTile) {
      const float g = (kLayout == kNone ? 0.f : sdp[k * kRow + q]) + c * window_term(k, idx, r);
      store(out + static_cast<long long>(k) * hw + q, sp[k * kTile + q] * (g - dot));
    }
  }
}

template <typename T, Layout kLayout, bool kVec>
int launch_tiles(const float* prob, const float* d_prob, const float* d_depth,
                 const int* index, const float* mass, const float* regress, T* d_logits,
                 int batch, int hw, long long dp_batch, cudaStream_t stream) {
  constexpr int kShared = shared_bytes(kLayout);
  // Once per form: the opt-in above 48 KB, and all of the SM's unified
  // L1/shared memory as shared memory, so that three tiles fit.
  static const cudaError_t opted = [] {
    cudaError_t err = cudaFuncSetAttribute(depth_readout_grad_kernel<T, kLayout, kVec>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           kShared);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(depth_readout_grad_kernel<T, kLayout, kVec>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    return err;
  }();
  if (opted != cudaSuccess) return static_cast<int>(opted);
  const int tiles = (hw + kTile - 1) / kTile;
  const long long blocks = static_cast<long long>(batch) * tiles;
  depth_readout_grad_kernel<T, kLayout, kVec>
      <<<static_cast<unsigned>(blocks), kThreads, kShared, stream>>>(
          prob, d_prob, d_depth, index, mass, regress, d_logits, hw, tiles, dp_batch);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, Layout kLayout>
int launch_layout(bool vec, const float* prob, const float* d_prob, const float* d_depth,
                  const int* index, const float* mass, const float* regress, T* d_logits,
                  int batch, int hw, long long dp_batch, cudaStream_t stream) {
  return vec ? launch_tiles<T, kLayout, true>(prob, d_prob, d_depth, index, mass, regress,
                                              d_logits, batch, hw, dp_batch, stream)
             : launch_tiles<T, kLayout, false>(prob, d_prob, d_depth, index, mass, regress,
                                               d_logits, batch, hw, dp_batch, stream);
}

bool aligned16(const void* p) { return reinterpret_cast<std::uintptr_t>(p) % 16 == 0; }

template <typename T>
int launch(const float* prob, const float* d_prob, const float* d_depth, const int* index,
           const float* mass, const float* regress, void* d_logits, int batch, int hw,
           long long dp_batch, long long dp_bin, long long dp_pixel, void* stream) {
  if (static_cast<long long>(batch) * hw <= 0) return 0;
  Layout layout = kNone;
  if (d_prob != nullptr) {
    if (dp_bin == hw && dp_pixel == 1)
      layout = kDense;
    else if (dp_bin == 1 && dp_pixel == kBins)
      layout = kLast;
    else
      return static_cast<int>(cudaErrorInvalidValue);
  }
  T* out = static_cast<T*>(d_logits);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = hw % 4 == 0 && aligned16(prob) && aligned16(d_logits) &&
                   (d_prob == nullptr || (aligned16(d_prob) && dp_batch % 4 == 0));
  switch (layout) {
    case kDense:
      return launch_layout<T, kDense>(vec, prob, d_prob, d_depth, index, mass, regress, out,
                                      batch, hw, dp_batch, st);
    case kLast:
      return launch_layout<T, kLast>(vec, prob, d_prob, d_depth, index, mass, regress, out,
                                     batch, hw, dp_batch, st);
    default:
      return launch_layout<T, kNone>(vec, prob, d_prob, d_depth, index, mass, regress, out,
                                     batch, hw, dp_batch, st);
  }
}

}  // namespace

// prob: [batch, 256, hw] float32, contiguous. d_prob: [batch, 256, hw]
// float32 with element strides (dp_batch, dp_bin, dp_pixel): dense NCHW
// (dp_bin = hw, dp_pixel = 1) or channels-last (dp_bin = 1, dp_pixel =
// 256); any other layout returns cudaErrorInvalidValue; may be null.
// d_depth ([batch, hw] float32, may be null), index ([batch, hw] int32),
// mass, regress ([batch, hw] float32): as K6 wrote them. d_logits:
// [batch, 256, hw], float32 or bfloat16 by the symbol.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int itermvs_depth_readout_grad(const float* prob, const float* d_prob,
                                          const float* d_depth, const int* index,
                                          const float* mass, const float* regress,
                                          void* d_logits, int batch, int hw,
                                          long long dp_batch, long long dp_bin,
                                          long long dp_pixel, void* stream) {
  return launch<float>(prob, d_prob, d_depth, index, mass, regress, d_logits, batch, hw,
                       dp_batch, dp_bin, dp_pixel, stream);
}

extern "C" int itermvs_depth_readout_grad_bf16(const float* prob, const float* d_prob,
                                               const float* d_depth, const int* index,
                                               const float* mass, const float* regress,
                                               void* d_logits, int batch, int hw,
                                               long long dp_batch, long long dp_bin,
                                               long long dp_pixel, void* stream) {
  return launch<__nv_bfloat16>(prob, d_prob, d_depth, index, mass, regress, d_logits,
                               batch, hw, dp_batch, dp_bin, dp_pixel, stream);
}
