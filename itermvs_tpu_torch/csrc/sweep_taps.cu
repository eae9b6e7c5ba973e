// K8 sweep_taps: base-corner indices and bilinear taps of a multi-level,
// multi-view plane sweep. A thread owns kPix neighbouring pixels of one
// row and the samples of one group of kGroup.
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
// What bounds it on an H100: memory, if the per-output work is kept
// small. Per output it reads a depth (4 B, shared by the views) and
// writes an int32 index and 4 taps (16 B in f32, 8 in bf16) with ~40
// operations: below the balance point. A first form with one thread per
// output took as long in bf16 as in f32 (40% fewer bytes): its pace was
// set by the per-output overhead (a divide for the row, 12 loads of the
// projection, 64-bit offsets, the rotation term, 2-byte stores).
//
// Design: what depends on (pixel, view, level) and not on the depth, the
// grid point and rot . (gx, gy, 1), is computed once per run of samples
// of one level (the sweeps list a level's samples together: 4 / 4 / 2 in
// an iteration sweep, 32 in the init sweep) and reused for each of its
// samples. A block is kRows rows x kCols threads, a thread kPix
// neighbouring pixels of a row (x and y from the block and thread
// indices, no divide), and one z index of the grid is a (batch, view,
// group of kGroup samples); the group's projections are staged once in
// shared memory. Where W is even a thread's pixels go out as one int2
// and, per corner, one float2 or __nv_bfloat162 (one pack for two taps).
// Offsets inside a (batch, view) plane are 32-bit from 64-bit plane bases
// (the wrapper checks that a plane fits).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
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

constexpr int kCols = 32;      // threads along a row
constexpr int kRows = 4;       // rows per block
constexpr int kPix = 2;        // neighbouring pixels per thread
constexpr int kGroup = 4;      // samples per grid z index
constexpr int kThreads = kCols * kRows;
static_assert(kGroup * 16 <= kThreads, "one thread per staged projection entry");

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

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
                  int views, int levels, int n, int h, int w, long long sb, int sn, int sh,
                  int sw, long long corner_stride) {
  __shared__ float4 proj[kGroup][4];               // the group's projections, by row
  const int groups = (n + kGroup - 1) / kGroup;
  const int bv = blockIdx.z / groups;
  const int s0 = (blockIdx.z - bv * groups) * kGroup;
  const int tid = threadIdx.y * kCols + threadIdx.x;
  if (tid < kGroup * 16 && s0 + tid / 16 < n) {
    const int j = tid / 16;
    reinterpret_cast<float*>(proj[j])[tid % 16] =
        rel[(static_cast<long long>(bv) * levels + table.level[s0 + j]) * 16 + tid % 16];
  }
  __syncthreads();
  const int x0 = (blockIdx.x * kCols + threadIdx.x) * kPix;
  const int y = blockIdx.y * kRows + threadIdx.y;
  if (y >= h || x0 >= w) return;
  const int npix = min(kPix, w - x0);
  const bool vec = npix == kPix && (w & 1) == 0;   // 8-byte aligned pairs

  const int hw = h * w;
  const float* dep = depth + (bv / views) * sb;
  const long long plane = static_cast<long long>(bv) * n * hw;
  int* idx_out = flat_idx + plane;
  T* tap_out[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) tap_out[c] = taps + c * corner_stride + plane;

  int level = -1;
  float rot[kPix][3], t[3], size_x = 0.f, size_y = 0.f;
  int width = 0;
#pragma unroll
  for (int j = 0; j < kGroup; ++j) {
    const int s = s0 + j;
    if (s >= n) break;
    if (table.level[s] != level) {
      // A new level: the grid point and rot . (gx, gy, 1) of each pixel.
      level = table.level[s];
      const float4 m[3] = {proj[j][0], proj[j][1], proj[j][2]};
      const float gy = __fmul_rn(static_cast<float>(y), table.scale_y[s]);
#pragma unroll
      for (int p = 0; p < kPix; ++p) {
        const float gx = __fmul_rn(static_cast<float>(x0 + p), table.scale_x[s]);
#pragma unroll
        for (int i = 0; i < 3; ++i)
          rot[p][i] = __fadd_rn(__fadd_rn(__fmul_rn(m[i].x, gx), __fmul_rn(m[i].y, gy)),
                                m[i].z);
      }
#pragma unroll
      for (int i = 0; i < 3; ++i) t[i] = m[i].w;
      width = table.width[s];
      size_x = static_cast<float>(width);
      size_y = static_cast<float>(table.height[s]);
    }

    int idx[kPix];
    float tap[4][kPix];
#pragma unroll
    for (int p = 0; p < kPix; ++p) {
      const float d = p < npix ? dep[s * sn + y * sh + (x0 + p) * sw] : 0.f;
      float xyz[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) xyz[i] = __fadd_rn(__fmul_rn(rot[p][i], d), t[i]);
      const bool valid = xyz[2] > 1e-2f;
      const float pz = valid ? xyz[2] : 1.f;
      const float px = __fdiv_rn(valid ? xyz[0] : static_cast<float>(w), pz);
      const float py = __fdiv_rn(valid ? xyz[1] : static_cast<float>(h), pz);
      int bx, by;
      float wxa, wxb, wya, wyb;
      axis_taps(px, size_x, &bx, &wxa, &wxb);
      axis_taps(py, size_y, &by, &wya, &wyb);
      idx[p] = by * width + bx;
      tap[0][p] = __fmul_rn(wya, wxa);
      tap[1][p] = __fmul_rn(wya, wxb);
      tap[2][p] = __fmul_rn(wyb, wxa);
      tap[3][p] = __fmul_rn(wyb, wxb);
    }

    const int o = s * hw + y * w + x0;
    if (vec) {
      *reinterpret_cast<int2*>(idx_out + o) = make_int2(idx[0], idx[1]);
#pragma unroll
      for (int c = 0; c < 4; ++c) store2(tap_out[c] + o, tap[c][0], tap[c][1]);
    } else {
#pragma unroll
      for (int p = 0; p < kPix; ++p) {
        if (p < npix) {
          idx_out[o + p] = idx[p];
#pragma unroll
          for (int c = 0; c < 4; ++c) store(tap_out[c] + o + p, tap[c][p]);
        }
      }
    }
  }
}

template <typename T>
int launch(const float* rel, const float* depth, int* flat_idx, void* taps,
           const SampleTable* table, int batch, int views, int levels, int n, int h, int w,
           long long sb, long long sn, long long sh, long long sw, void* stream) {
  if (batch <= 0 || views <= 0 || n <= 0 || h <= 0 || w <= 0) return 0;
  // 32-bit offsets inside a plane: the output plane and the depth's
  // per-batch offsets must fit.
  const long long reach = (n - 1) * sn + (h - 1) * sh + (w - 1) * sw;
  if (n > kMaxSamples || static_cast<long long>(n) * h * w > INT_MAX || reach > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int groups = (n + kGroup - 1) / kGroup;
  const dim3 grid(static_cast<unsigned>((w + kCols * kPix - 1) / (kCols * kPix)),
                  static_cast<unsigned>((h + kRows - 1) / kRows),
                  static_cast<unsigned>(batch * views * groups));
  const long long corner_stride = static_cast<long long>(batch) * views * n * h * w;
  sweep_taps_kernel<T><<<grid, dim3(kCols, kRows), 0, static_cast<cudaStream_t>(stream)>>>(
      rel, depth, flat_idx, static_cast<T*>(taps), *table, views, levels, n, h, w, sb,
      static_cast<int>(sn), static_cast<int>(sh), static_cast<int>(sw), corner_stride);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// rel: [batch, views, levels, 4, 4] float32, contiguous. depth: [batch, n,
// h, w] float32 with element strides (sb, sn, sh, sw) (the init sweep's
// samples are a broadcast view), n * h * w and the offsets of one batch
// entry's depths below 2^31. table: the n samples' level, source size and
// grid scales (host memory, passed by value). flat_idx: [batch, views, n,
// h*w] int32; taps: [4, batch, views, n, h*w] float32 or bfloat16 by the
// symbol. Returns cudaGetLastError() after the launch (0 on success).
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
