// K2 sweep_premul, bfloat16 form: the plane sweep's bilinear corner
// gather, multiplied by the tap weights and the reference features, on
// bfloat16 tables.
//
// Replaces: the XLA chain itermvs_tpu/ops/grid_sample.py `gather_corners`
// followed by itermvs_tpu/ops/sweep_epilogue.py `premultiply` in the JAX
// package's bfloat16 mode, where the tables, the taps
// (ops/warping.py `fused_sweep_taps(table_dtype=...)`) and the products
// are bfloat16:
//     premul[b, p, k*C + ch] = bf16(bf16(src[b, y_k, x_k, ch] * tap_k[b, p])
//                                   * ref[b, p % HW, ch])
// for corners k = (y, x), (y, x+1), (y+1, x), (y+1, x+1) of the clamped
// base index base[b, p] = y*W1 + x, each product rounded to nearest even:
// the order and rounding of the plain version (ops/sweep.py
// `sweep_premul_plain`, two bfloat16 multiplies), so the two are equal bit
// for bit. A +1 corner past the image edge reads 0, the zero fill of
// `pack_corners`. Entry point: itermvs_sweep_premul_bf16 (the float32
// form is csrc/sweep_premul.cu).
//
// What bounds it on an H100: memory. The [B, P, 4C] output (4C values per
// row against ~5 words of index and taps read) dominates: 354 MB per view
// for the init sweep at 1600x1152. Per 16 bytes written the kernel issues
// two multiplies and two roundings per value, so the index work around
// them has to stay small, or issue slots bound it before memory does.
//
// Design: a block owns a run of consecutive pixels of one (batch, sample)
// plane (grid z = batch, y = sample, x = pixel run), so batch, sample and
// pixel come from block indices, with no 64-bit divide, and a thread's
// offsets are 32-bit from the block's base pointers. A thread owns one
// 8-channel lane (16 bytes) of one row across all four corners: one base
// index, one reference vector, four taps, four independent 16-byte
// gathers in flight, then four 16-byte stores. The corner offsets follow
// from the base index itself ((y, x+1) is base+1, (y+1, x) is base+W1),
// so its only divide is the column test base % W1. The C/8 lanes of a row
// are neighbouring threads: each gather and store instruction of a warp
// covers whole 32-byte sectors where C % 16 == 0 (every C the model
// uses). Products are formed in float32 from the converted values and
// rounded after each multiply, two values to one conversion. A base index
// outside [0, H1*W1) writes NaN, so an upstream error shows instead of
// reading out of bounds. Staging a block's rows in shared memory for one
// bulk store (cp.async.bulk) was no faster on the H100.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// Two bfloat16 NaNs in one word.
constexpr unsigned kNan2 = 0x7fc07fc0u;

__device__ __forceinline__ float lo_float(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_float(unsigned w) { return __uint_as_float(w & 0xffff0000u); }

// Two floats rounded to bfloat16 (nearest even), packed low then high.
__device__ __forceinline__ unsigned pack_rn(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// bf16(bf16(v * t) * r) for the two values of each word.
__device__ __forceinline__ unsigned premul_word(unsigned v, float t, unsigned r) {
  const unsigned vt = pack_rn(lo_float(v) * t, hi_float(v) * t);
  return pack_rn(lo_float(vt) * lo_float(r), hi_float(vt) * hi_float(r));
}

__device__ __forceinline__ uint4 premul_vec(uint4 v, float t, uint4 r) {
  return make_uint4(premul_word(v.x, t, r.x), premul_word(v.y, t, r.y),
                    premul_word(v.z, t, r.z), premul_word(v.w, t, r.w));
}

__global__ void __launch_bounds__(kThreads)
sweep_premul_bf16_kernel(const uint4* __restrict__ src,
                         const int* __restrict__ base,
                         const unsigned short* __restrict__ taps,
                         const uint4* __restrict__ ref,
                         uint4* __restrict__ out,
                         int n, int hw, int h1, int w1, int c8,
                         long long rows) {
  const int pix0 = blockIdx.x * blockDim.y;
  const int r = threadIdx.y;
  if (pix0 + r >= hw) return;             // the ragged last run
  const int lane = threadIdx.x;
  const int cells = h1 * w1;
  // The block's base pointers: its first row, its batch's source map.
  const long long row0 = (static_cast<long long>(blockIdx.z) * n + blockIdx.y) * hw + pix0;
  const unsigned short* tap = taps + row0 + r;
  const uint4* ref_b = ref + (static_cast<long long>(blockIdx.z) * hw + pix0) * c8;
  const uint4* src_b = src + static_cast<long long>(blockIdx.z) * cells * c8;
  uint4* out_b = out + row0 * (4LL * c8);

  const int idx = base[row0 + r];
  const unsigned t0 = tap[0], t1 = tap[rows], t2 = tap[2 * rows], t3 = tap[3 * rows];
  const uint4 rv = ref_b[r * c8 + lane];
  uint4 v0 = make_uint4(0u, 0u, 0u, 0u), v1 = v0, v2 = v0, v3 = v0;
  if (static_cast<unsigned>(idx) >= static_cast<unsigned>(cells)) {
    v0 = v1 = v2 = v3 = make_uint4(kNan2, kNan2, kNan2, kNan2);
  } else {
    const unsigned off = static_cast<unsigned>(idx) * c8 + lane;
    const bool x1 = (static_cast<unsigned>(idx) + 1u) % w1 != 0u;  // (y, x+1) on the map
    const bool y1 = idx + w1 < cells;                               // (y+1, x) on the map
    v0 = src_b[off];
    if (x1) v1 = src_b[off + c8];
    if (y1) v2 = src_b[off + static_cast<unsigned>(w1) * c8];
    if (x1 && y1) v3 = src_b[off + static_cast<unsigned>(w1 + 1) * c8];
  }
  uint4* o = out_b + r * 4 * c8 + lane;
  o[0] = premul_vec(v0, lo_float(t0), rv);
  o[c8] = premul_vec(v1, lo_float(t1), rv);
  o[2 * c8] = premul_vec(v2, lo_float(t2), rv);
  o[3 * c8] = premul_vec(v3, lo_float(t3), rv);
}

}  // namespace

// src: [batch, h1, w1, c] bf16 NHWC. base: [batch, p] int32. taps: [4,
// batch, p] bf16. ref: [batch, hw, c] bf16. out: [batch, p, 4c] bf16. All
// contiguous, src and ref 16-byte aligned; c % 8 == 0, c <= 256, p = n*hw
// for a whole number of samples n, h1*w1*c < 2^31.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int itermvs_sweep_premul_bf16(const void* src, const int* base,
                                         const void* taps, const void* ref,
                                         void* out, int batch, long long p,
                                         int hw, int h1, int w1, int c,
                                         void* stream) {
  const long long rows = static_cast<long long>(batch) * p;
  if (rows <= 0) return 0;
  const int c8 = c / 8;
  const int n = static_cast<int>(p / hw);
  const int run = kThreads / c8;           // pixels per block
  const dim3 block(c8, run);
  const dim3 grid(static_cast<unsigned>((hw + run - 1) / run), n, batch);
  sweep_premul_bf16_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(src), base, static_cast<const unsigned short*>(taps),
      static_cast<const uint4*>(ref), static_cast<uint4*>(out), n, hw, h1, w1, c8, rows);
  return static_cast<int>(cudaGetLastError());
}
