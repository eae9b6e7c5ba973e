// K1 corr_epilogue, bfloat16 form: corner sum + per-group channel mean
// of a bfloat16 premultiplied plane-sweep block, summed in float32.
//
// Replaces: the Pallas kernel itermvs_tpu/ops/sweep_epilogue.py
// `_epilogue_kernel` (launched by `_epilogue_call`) on a bfloat16 premul
// block, which contracts it in bfloat16 with float32 accumulation:
//     corr[g, p] = (1/cg) * sum_{j<cg} sum_{k<4} premul[p, k*C + g*cg + j]
// written G-major, [G, P] = [G, n, HW] float32. The sum and the division
// by cg run in float32, as the JAX main path's group mean
// (ops/warping.py `group_corr`, `jnp.mean(..., dtype=float32)`), not with
// the Pallas call's mean matrix rounded to bfloat16 (1/6, at level 3, is
// inexact there by 2e-3 relative). Entry point: itermvs_corr_epilogue_bf16
// (the float32 form is csrc/corr_epilogue.cu).
//
// What bounds it on an H100: memory. Per row it reads 4C bfloat16 and
// writes G floats, about 4C adds: ~0.5 flop per byte. The least time is
// (P*4C*2 + G*P*4) bytes over 3.35 TB/s.
//
// Design: the float32 kernel's. A block stages ROWS=32 rows in shared
// memory as float32, read as 16-byte vectors of 8 bfloat16 (consecutive
// threads on consecutive vectors; a vector never straddles a row, since 8
// divides 4C) and converted; then thread (row, group) sums its group's 4
// corners x cg channels in float32, in the float32 kernel's order, and
// writes out[g, row]. Rows are padded by one float in shared memory.
#include <cuda_runtime.h>

#include "bf16_lanes.cuh"

namespace {

constexpr int kRows = 32;

__global__ void corr_epilogue_bf16_kernel(const uint4* __restrict__ premul,
                                          float* __restrict__ out,
                                          long long rows, int c, int groups) {
  extern __shared__ float tile[];
  const int c4 = 4 * c;
  const int pitch = c4 + 1;
  const int vecs = c4 / 8;             // 16-byte vectors per row
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  const long long left = rows - row0;
  const int nrows = left < kRows ? static_cast<int>(left) : kRows;

  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  const uint4* src = premul + row0 * vecs;
  const int count = nrows * vecs;
  for (int e = tid; e < count; e += nthreads) {
    const int r = e / vecs;
    float f[8];
    bf16x8_to_float(src[e], f);
    float* dst = tile + r * pitch + (e - r * vecs) * 8;
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[j] = f[j];
  }
  __syncthreads();

  const int r = threadIdx.x;
  const int g = threadIdx.y;
  if (r >= nrows) return;
  const int cg = c / groups;
  const float* t = tile + r * pitch + g * cg;
  // Same order as the float32 kernel and the plain version: corner sum
  // per channel, then the channel sum of the group, in float32.
  float acc = 0.f;
  for (int j = 0; j < cg; ++j) {
    acc += ((t[j] + t[c + j]) + t[2 * c + j]) + t[3 * c + j];
  }
  out[static_cast<long long>(g) * rows + row0 + r] = acc / static_cast<float>(cg);
}

}  // namespace

// premul: [rows, 4c] bf16, contiguous, 16-byte aligned; c % 2 == 0.
// out: [groups, rows] f32. Returns cudaGetLastError() after the launch (0
// on success).
extern "C" int itermvs_corr_epilogue_bf16(const void* premul, float* out,
                                          long long rows, int c, int groups,
                                          void* stream) {
  if (rows <= 0) return 0;
  const dim3 block(kRows, groups);
  const long long blocks = (rows + kRows - 1) / kRows;
  const size_t smem = static_cast<size_t>(kRows) * (4 * c + 1) * sizeof(float);
  corr_epilogue_bf16_kernel<<<static_cast<unsigned>(blocks), block, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(premul), out, rows, c, groups);
  return static_cast<int>(cudaGetLastError());
}
