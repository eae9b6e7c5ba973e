// K3 fusion_consistency: per-pixel geometric and photometric check of one
// reference depth map against S source depth maps, the core of fusion.
//
// Replaces: the XLA chain itermvs_tpu/fusion.py `_consistency_kernel` (up
// to the map-wide min/max and uint16 rounding, which stay torch ops). For
// each reference pixel (x, y) with depth d and each source v:
//   xyz_ref = (K_ref^-1 (x, y, 1)) * d
//   xyz_src = R_r2s[v] xyz_ref + t_r2s[v];  k = K_src[v] xyz_src
//   (px, py) = (k.x / k.z, k.y / k.z)
//   s = bilinear sample of source depth v at (px, py), zeros outside
//   xyz_rep = R_s2r[v] ((K_src[v]^-1 (px, py, 1)) * s) + t_s2r[v]
//   k' = K_ref xyz_rep;  (rx, ry) = (k'.x, k'.y) / (k'.z + 1e-6)
//   consistent = sqrt((rx-x)^2 + (ry-y)^2) < pix_thres
//                and |xyz_rep.z - d| / d < depth_thres
// then count = #consistent, avg = (sum of consistent xyz_rep.z + d) /
// (count + 1), and bits = photo | geo << 1 | (photo & geo) << 2 with
// photo = conf > photo_thres, geo = count >= geo_mask_thres.
//
// What bounds it on an H100: issue slots. The function needs about 116
// f32 instructions per (pixel, source) with a*b+c fused and each IEEE
// divide or sqrt at its arithmetic (MUFU + Newton steps, chip_smoke.py
// counts them); the bytes (the S source maps read once, the reference
// depth and confidence read, the average and bits written) take less
// time. To stay bit-equal to its plain version the kernel may not fuse,
// so its sm_90a SASS issues about 220 instructions per (pixel, source):
// about 105 unfused f32 products and sums, 60 in the 5 divides and the
// sqrt (their arithmetic and the branch around each slow path), 12
// LDS.128 of the record, the rest taps and corner reads. The design
// spends as few of them as that allows, at full occupancy:
// * One pixel per thread, at most 32 registers: 64 warps per SM hide the
//   latency of the corner reads and of the MUFU + Newton chains. Two and
//   four adjacent pixels per thread share the record's loads, but their
//   registers cost occupancy, or spills, and they ran slower on an H100.
// * The record: each source's 42 floats padded to 48, 16-byte aligned, so
//   they reach registers as LDS.128 broadcasts from warp-uniform
//   addresses; K_ref and K_ref^-1 are read once per thread.
// * Branch-free taps, every in-range corner read without a weight test,
//   and 32-bit corner offsets from each source's own base pointer.
//
// Traps, each covered by a test:
// * Precision. The TPU code runs every einsum at precision=HIGHEST because
//   the TPU rounds matmul operands to bf16; the card's counterpart is TF32.
//   Here all of it is f32 arithmetic in registers, no tensor core. Every
//   product, sum, divide and sqrt is an explicitly rounded IEEE operation
//   (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn), in the order of the
//   plain version: nvcc would otherwise contract a*b+c into one FMA, and a
//   pixel whose distance or relative depth sits on a threshold then counts
//   a source the plain version does not (seen on the card: the same mask
//   bits, but averages 1.3e-4 apart). The library is built without
//   --use_fast_math (kernels/__init__.py), or the `dist < 1 px` test
//   flips on many pixels.
// * Two different divides: the source projection divides by z with NO
//   epsilon; the reprojection adds 1e-6. Both are kept as they are.
// * Non-finite coordinates. z == 0 gives an inf or NaN coordinate; the
//   JAX sampler then has zero weights and a clamped base, so the sample is
//   0. A NaN or inf converted to int is out of range here, so the base is
//   clamped as a float (fmaxf/fminf drop a NaN operand): the corners read
//   are in range and their zero weights zero them, as in the plain
//   version, which reads and weights every corner too.
//   A zero or non-finite reference depth makes `relative` NaN or inf; the
//   `<` comparisons fail on those, as nothing here is rewritten.
// * Exact comparisons: photo is `conf > photo_thres` (strict), geo is
//   `count >= geo_mask_thres`.
// * Index width: S*H*W is below 2^31 at every dataset size (1.6e8 at S=64
//   on ETH3D); the wrapper checks it, so offsets are 32-bit.
#include <cuda_runtime.h>

namespace {

constexpr int kHead = 24;      // K_ref (9), K_ref^-1 (9), 6 of padding
constexpr int kStride = 48;    // R|t r2s (12), R|t s2r (12), K_src (9), K_src^-1 (9), 6 of padding
constexpr int kThreads = 256;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }

// m[0]*a + m[1]*b + m[2]*c, summed left to right.
__device__ __forceinline__ float dot3(const float* m, float a, float b, float c) {
  return add(add(mul(m[0], a), mul(m[1], b)), mul(m[2], c));
}

// m[0]*a + m[1]*b + m[2]: a row of a 3x3 matrix times (a, b, 1).
__device__ __forceinline__ float dot2h(const float* m, float a, float b) {
  return add(add(mul(m[0], a), mul(m[1], b)), m[2]);
}

// The first 4*N floats at `src` (shared memory) as N 16-byte loads, into
// an array that constant indices keep in registers.
template <int N>
__device__ __forceinline__ void load_float4s(const float4* src, float (&dst)[4 * N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float4 q = src[i];
    dst[4 * i] = q.x;
    dst[4 * i + 1] = q.y;
    dst[4 * i + 2] = q.z;
    dst[4 * i + 3] = q.w;
  }
}

// Clamped base and the two tap weights along one axis (JAX `_axis_taps`):
// floor(p) in range -> (1-frac, frac); floor(p) == -1 -> (frac, 0) on
// corner 0; otherwise (0, 0), NaN and inf included. `base` is always a
// valid index. Selects only, no branch.
__device__ __forceinline__ void axis_taps(float p, float last, int& base,
                                          float& w_a, float& w_b) {
  const float p0 = floorf(p);
  const float b = fminf(fmaxf(p0, 0.f), last);
  const float frac = sub(p, p0);
  const bool at_base = p0 == b;
  const float w_edge = p0 == -1.f ? frac : 0.f;
  w_a = at_base ? sub(1.f, frac) : w_edge;
  w_b = at_base ? frac : 0.f;
  base = static_cast<int>(b);
}

// One pixel's projection into a source: its coordinates, the weights and
// the values of its four corners. The work of a (pixel, source) is split
// in two at the sample, project() then reproject(), and each half loads
// only its half of the record: in one piece, with the whole record live,
// the loop spills at 32 registers and runs far slower on an H100.
struct Sample {
  float px, py, w00, w01, w10, w11, v00, v01, v10, v11;

  // Corners summed in the order (y, x), (y, x+1), (y+1, x), (y+1, x+1).
  __device__ __forceinline__ float value() const {
    return add(add(add(mul(v00, w00), mul(v01, w01)), mul(v10, w10)), mul(v11, w11));
  }
};

// r2s: R|t ref->src (3 rows of 4), ks: K_src. A +1 corner past the edge
// reads 0 (the zero fill of the TPU corner packing); every other corner is
// read, in range since the base is clamped, and a zero weight zeroes it
// as in the plain version.
__device__ __forceinline__ void project(const float* r2s, const float* ks,
                                        const float* __restrict__ map, int h, int w,
                                        float h_last, float w_last, float xr,
                                        float yr, float zr, Sample& t) {
  // Rows of R|t are 4 floats: dot3 of the rotation, then + t.
  const float xs = add(dot3(r2s, xr, yr, zr), r2s[3]);
  const float ys = add(dot3(r2s + 4, xr, yr, zr), r2s[7]);
  const float zs = add(dot3(r2s + 8, xr, yr, zr), r2s[11]);
  const float kz = dot3(ks + 6, xs, ys, zs);
  t.px = div(dot3(ks, xs, ys, zs), kz);      // no epsilon (fusion.py:112)
  t.py = div(dot3(ks + 3, xs, ys, zs), kz);
  int bx, by;
  float wx_a, wx_b, wy_a, wy_b;
  axis_taps(t.px, w_last, bx, wx_a, wx_b);
  axis_taps(t.py, h_last, by, wy_a, wy_b);
  t.w00 = mul(wy_a, wx_a);
  t.w01 = mul(wy_a, wx_b);
  t.w10 = mul(wy_b, wx_a);
  t.w11 = mul(wy_b, wx_b);
  const float* row0 = map + static_cast<unsigned>(by * w + bx);
  const float* row1 = row0 + w;
  const bool x1 = bx + 1 < w, y1 = by + 1 < h;
  t.v00 = row0[0];
  t.v01 = x1 ? row0[1] : 0.f;
  t.v10 = y1 ? row1[0] : 0.f;
  t.v11 = x1 && y1 ? row1[1] : 0.f;
}

// The rest of one (pixel, source): reprojection into the reference and
// the two tests. ksi: K_src^-1, s2r: R|t src->ref, kr: K_ref.
__device__ __forceinline__ void reproject(const Sample& t, const float* ksi,
                                          const float* s2r, const float* kr, float gx,
                                          float gy, float d, float pix_thres,
                                          float depth_thres, int& count, float& sum) {
  const float sd = t.value();
  const float x2 = mul(dot2h(ksi, t.px, t.py), sd);
  const float y2 = mul(dot2h(ksi + 3, t.px, t.py), sd);
  const float z2 = mul(dot2h(ksi + 6, t.px, t.py), sd);
  const float xp = add(dot3(s2r, x2, y2, z2), s2r[3]);
  const float yp = add(dot3(s2r + 4, x2, y2, z2), s2r[7]);
  const float zp = add(dot3(s2r + 8, x2, y2, z2), s2r[11]);
  const float kzr = add(dot3(kr + 6, xp, yp, zp), 1e-6f);  // (fusion.py:130)
  const float dx = sub(div(dot3(kr, xp, yp, zp), kzr), gx);
  const float dy = sub(div(dot3(kr + 3, xp, yp, zp), kzr), gy);
  const float dist = __fsqrt_rn(add(mul(dx, dx), mul(dy, dy)));
  const float relative = div(fabsf(sub(zp, d)), d);
  if (dist < pix_thres && relative < depth_thres) {
    ++count;
    sum = add(sum, zp);
  }
}

// 8 resident blocks of 256 threads (64 warps, the most an SM holds) leave
// each thread 32 registers.
__global__ void __launch_bounds__(kThreads, 8)
fusion_consistency_kernel(const float* __restrict__ ref_depth,
                          const float* __restrict__ conf,
                          const float* __restrict__ src_depths,
                          const float4* __restrict__ params, float* __restrict__ depth_avg,
                          unsigned char* __restrict__ bits, int s, int h, int w,
                          float pix_thres, float depth_thres, float photo_thres,
                          int geo_mask_thres) {
  extern __shared__ float4 sp[];
  const int n4 = (kHead + kStride * s) / 4;
  for (int i = threadIdx.x; i < n4; i += blockDim.x) sp[i] = params[i];
  __syncthreads();

  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= h * w) return;
  const int y = p / w;
  const float gx = static_cast<float>(p - y * w), gy = static_cast<float>(y);
  const float h_last = static_cast<float>(h - 1), w_last = static_cast<float>(w - 1);

  float head[20];
  load_float4s<5>(sp, head);
  const float* kr = head;
  const float* kri = head + 9;
  const float d = ref_depth[p];
  const float xr = mul(dot2h(kri, gx, gy), d);
  const float yr = mul(dot2h(kri + 3, gx, gy), d);
  const float zr = mul(dot2h(kri + 6, gx, gy), d);
  int count = 0;
  float sum = 0.f;

  const float* map = src_depths;
  for (int v = 0; v < s; ++v, map += h * w) {
    // Source v's record: R|t r2s at 0, R|t s2r at 12, K_src at 24,
    // K_src^-1 at 33, read as float4 broadcasts.
    const float4* rec = sp + (kHead + kStride * v) / 4;
    float r2s[12], ks[12], s2r[12], ksi[12];
    load_float4s<3>(rec, r2s);
    load_float4s<3>(rec + 6, ks);
    Sample t;
    project(r2s, ks, map, h, w, h_last, w_last, xr, yr, zr, t);
    load_float4s<3>(rec + 3, s2r);
    load_float4s<3>(rec + 8, ksi);       // floats 32..43: K_src^-1 from 1
    reproject(t, ksi + 1, s2r, kr, gx, gy, d, pix_thres, depth_thres, count, sum);
  }

  depth_avg[p] = div(add(sum, d), static_cast<float>(count + 1));
  const unsigned char photo = conf[p] > photo_thres;
  const unsigned char geo = count >= geo_mask_thres;
  bits[p] = photo | (geo << 1) | ((photo & geo) << 2);
}

}  // namespace

// ref_depth, conf: [h, w] f32. src_depths: [s, h, w] f32. params: the
// record, [24 + 48 s] f32, 16-byte aligned: K_ref, K_ref^-1 row-major and
// 6 zeros, then per source the top 3x4 of E_src E_ref^-1, the top 3x4 of
// E_ref E_src^-1, K_src, K_src^-1 and 6 zeros; each block stages it in
// shared memory (above 48 KB, from 256 sources, the kernel opts in to
// more, up to Hopper's 227 KB). depth_avg: [h, w] f32 out. bits: [h, w]
// u8 out. All contiguous; s*h*w < 2^31. Returns cudaGetLastError() after
// the launch (0 on success), or cudaErrorInvalidValue for s < 0.
extern "C" int itermvs_fusion_consistency(
    const float* ref_depth, const float* conf, const float* src_depths,
    const float* params, float* depth_avg, unsigned char* bits, int s, int h,
    int w, float pix_thres, float depth_thres, float photo_thres,
    int geo_mask_thres, void* stream) {
  if (s < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (h <= 0 || w <= 0) return 0;
  const size_t smem = sizeof(float) * (kHead + kStride * static_cast<size_t>(s));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fusion_consistency_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // One thread per pixel, blocks of 256. At 32 registers an SM holds 8
  // blocks, so a 1600x1152 view is 7200 blocks, 6.82 waves of 1056. No
  // grid makes that whole: 132 SMs carry a factor 11 that 1600x1152
  // pixels lack. Block shapes of 96 to 352 threads whose last wave is
  // fuller ran no faster on an H100, and a one-wave grid-stride launch ran
  // slower: its last round of pixels falls on a few threads of each SM, at
  // low occupancy. Here the block scheduler refills SMs as blocks end.
  const int blocks = static_cast<int>((static_cast<long long>(h) * w + kThreads - 1) / kThreads);
  fusion_consistency_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      ref_depth, conf, src_depths, reinterpret_cast<const float4*>(params), depth_avg,
      bits, s, h, w, pix_thres, depth_thres, photo_thres, geo_mask_thres);
  return static_cast<int>(cudaGetLastError());
}
