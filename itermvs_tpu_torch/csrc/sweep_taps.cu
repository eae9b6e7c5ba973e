// K8 sweep_taps: base-corner indices and bilinear taps of a multi-level,
// multi-view plane sweep, one thread per (batch, view, sample, pixel).
//
// Replaces: the XLA chain itermvs_tpu/ops/warping.py:158
// `fused_sweep_taps`. For the sample's level l, the pixel (x, y) of the
// H x W sweep grid and the sample's depth d:
//     (gx, gy)  = (x * (W_l / W), y * (H_l / H))       source-pixel units
//     xyz       = (rot . (gx, gy, 1)) * d + t           rel. projection
//     (px, py)  = xyz.xy / xyz.z, or (W, H) where xyz.z <= 1e-2
// then along each axis the clamped base and its two taps (`axis_taps` of
// itermvs_tpu_torch/ops/warping.py), flat_idx = by * W_l + bx, and the 4
// taps (y, x), (y, x+1), (y+1, x), (y+1, x+1) as products of the axes'.
//
// Bit-equal to the plain version: that one runs each operation as its
// own elementwise kernel, one float32 rounding per operation, so every
// product and sum here is __fmul_rn / __fadd_rn (which nvcc never fuses
// into an FMA), in the plain version's order, the divides IEEE
// (__fdiv_rn), and the grid scales the float32 values of W_l / W and
// H_l / H that PyTorch multiplies by. A single FMA moves floor() at pixel
// boundaries.
//
// What bounds it on an H100: memory. Per output it reads a depth (4 B,
// shared by the views) and writes an int32 index and 4 taps (16 B in f32,
// 8 in bf16) with ~40 operations: below the balance point.
//
// Design: one thread per output, consecutive threads on consecutive
// pixels of one (batch, view, sample) plane (grid x over pixels, y over
// samples, z over batch x views), so that every store is coalesced. The
// per-sample level, size and grid scales come by value in a SampleTable
// (at most 32 samples); the relative projections are read from device
// memory, one 4x4 per (batch, view, level), the same for a whole block.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

constexpr int kMaxSamples = 32;

// The per-sample table (ops/warping.py `SampleTable`). At namespace scope:
// the exported launchers take it, and a type of an unnamed namespace would
// give them internal linkage.
struct SampleTable {
  int level[kMaxSamples];
  int height[kMaxSamples];
  int width[kMaxSamples];
  float scale_y[kMaxSamples];
  float scale_x[kMaxSamples];
};

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// `axis_taps`: floor, base clamped into [0, size - 1] (fmax turns a NaN
// into 0), weights (1 - frac, frac) at an in-range floor, (frac, 0) at
// floor == -1, (0, 0) outside.
__device__ __forceinline__ void axis_taps(float p, float size, int* base, float* wa,
                                          float* wb) {
  const float p0 = floorf(p);
  const float b = fminf(fmaxf(p0, 0.f), __fsub_rn(size, 1.f));
  const float frac = __fsub_rn(p, p0);
  const bool at_base = p0 == b;
  *wa = at_base ? __fsub_rn(1.f, frac) : (__fadd_rn(p0, 1.f) == b ? frac : 0.f);
  *wb = at_base ? frac : 0.f;
  *base = static_cast<int>(b);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
sweep_taps_kernel(const float* __restrict__ rel, const float* __restrict__ depth,
                  int* __restrict__ flat_idx, T* __restrict__ taps, SampleTable table,
                  int views, int levels, int n, int h, int w, long long sb, long long sn,
                  long long sh, long long sw) {
  const int hw = h * w;
  const int pix = blockIdx.x * kThreads + threadIdx.x;
  if (pix >= hw) return;
  const int s = blockIdx.y;
  const int bv = blockIdx.z;
  const int b = bv / views;
  const int level = table.level[s];
  const float* m = rel + (static_cast<long long>(bv) * levels + level) * 16;

  const int y = pix / w;
  const int x = pix - y * w;
  const float gx = __fmul_rn(static_cast<float>(x), table.scale_x[s]);
  const float gy = __fmul_rn(static_cast<float>(y), table.scale_y[s]);
  const float d = depth[b * sb + s * sn + y * sh + x * sw];
  float xyz[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float rot = __fadd_rn(__fadd_rn(__fmul_rn(m[4 * i], gx), __fmul_rn(m[4 * i + 1], gy)),
                                m[4 * i + 2]);
    xyz[i] = __fadd_rn(__fmul_rn(rot, d), m[4 * i + 3]);
  }
  const bool valid = xyz[2] > 1e-2f;
  const float pz = valid ? xyz[2] : 1.f;
  const float px = __fdiv_rn(valid ? xyz[0] : static_cast<float>(w), pz);
  const float py = __fdiv_rn(valid ? xyz[1] : static_cast<float>(h), pz);

  int bx, by;
  float wxa, wxb, wya, wyb;
  axis_taps(px, static_cast<float>(table.width[s]), &bx, &wxa, &wxb);
  axis_taps(py, static_cast<float>(table.height[s]), &by, &wya, &wyb);

  const long long o = (static_cast<long long>(bv) * n + s) * hw + pix;
  const long long plane = static_cast<long long>(gridDim.z) * n * hw;
  flat_idx[o] = by * table.width[s] + bx;
  store(taps + o, __fmul_rn(wya, wxa));
  store(taps + plane + o, __fmul_rn(wya, wxb));
  store(taps + 2 * plane + o, __fmul_rn(wyb, wxa));
  store(taps + 3 * plane + o, __fmul_rn(wyb, wxb));
}

template <typename T>
int launch(const float* rel, const float* depth, int* flat_idx, void* taps,
           const SampleTable* table, int batch, int views, int levels, int n, int h, int w,
           long long sb, long long sn, long long sh, long long sw, void* stream) {
  if (batch <= 0 || views <= 0 || n <= 0 || h <= 0 || w <= 0) return 0;
  if (n > kMaxSamples) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((h * w + kThreads - 1) / kThreads), n,
                  batch * views);
  sweep_taps_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      rel, depth, flat_idx, static_cast<T*>(taps), *table, views, levels, n, h, w, sb, sn,
      sh, sw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// rel: [batch, views, levels, 4, 4] float32, contiguous. depth: [batch, n,
// h, w] float32 with element strides (sb, sn, sh, sw) (the init sweep's
// samples are a broadcast view). table: the n samples' level, source size
// and grid scales (host memory, passed by value). flat_idx: [batch, views,
// n, h*w] int32; taps: [4, batch, views, n, h*w] float32 or bfloat16 by
// the symbol. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int itermvs_sweep_taps(const float* rel, const float* depth, int* flat_idx,
                                  void* taps, const SampleTable* table, int batch,
                                  int views, int levels, int n, int h, int w, long long sb,
                                  long long sn, long long sh, long long sw, void* stream) {
  return launch<float>(rel, depth, flat_idx, taps, table, batch, views, levels, n, h, w,
                       sb, sn, sh, sw, stream);
}

extern "C" int itermvs_sweep_taps_bf16(const float* rel, const float* depth, int* flat_idx,
                                       void* taps, const SampleTable* table, int batch,
                                       int views, int levels, int n, int h, int w,
                                       long long sb, long long sn, long long sh,
                                       long long sw, void* stream) {
  return launch<__nv_bfloat16>(rel, depth, flat_idx, taps, table, batch, views, levels, n,
                               h, w, sb, sn, sh, sw, stream);
}
