// K1 corr_epilogue: corner sum + per-group channel mean of a premultiplied
// plane-sweep block.
//
// Replaces: the Pallas kernel itermvs_tpu/ops/sweep_epilogue.py
// `_epilogue_kernel` (launched by `_epilogue_call`), which computes
//     corr[G, P] = M4[G, 4C] . premul[P, 4C]^T
// with M4 the corner-tiled block-diagonal 1/cg group-mean matrix, i.e.
//     corr[g, p] = (1/cg) * sum_{j<cg} sum_{k<4} premul[p, k*C + g*cg + j].
// The output is G-major, [G, P] = [G, n, HW] for rows ordered
// sample-major.
//
// What bounds it on an H100: memory. Per row it reads 4C floats and
// writes G floats and does about 4C adds, so it needs ~0.25 flop per byte,
// far below the card's ~20 flop/byte f32 balance point. The least time is
// (P*4C*4 + G*P*4) bytes over 3.35 TB/s.
//
// Design: one block stages ROWS=32 rows of premul in shared memory with
// coalesced loads (consecutive threads read consecutive floats), then
// thread (x, y) = (row, group) sums its group's 4 corners x cg channels in
// f32 and writes out[g, row]: consecutive x threads write consecutive
// addresses. Rows are padded by one float in shared memory because the
// row length 4C is a multiple of 32 for every C the model uses, which
// would put all 32 rows of a warp on one bank. The matrix-unit form of
// the TPU kernel is not used: M4 is 7/8 zeros and the work is bound by
// bytes, not operations.
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 32;

__global__ void corr_epilogue_kernel(const float* __restrict__ premul,
                                     float* __restrict__ out,
                                     long long rows, int c, int groups) {
  extern __shared__ float tile[];
  const int c4 = 4 * c;
  const int pitch = c4 + 1;
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  const long long left = rows - row0;
  const int nrows = left < kRows ? static_cast<int>(left) : kRows;

  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  const float* src = premul + row0 * c4;
  const int count = nrows * c4;
  for (int e = tid; e < count; e += nthreads) {
    const int r = e / c4;
    tile[r * pitch + (e - r * c4)] = src[e];
  }
  __syncthreads();

  const int r = threadIdx.x;
  const int g = threadIdx.y;
  if (r >= nrows) return;
  const int cg = c / groups;
  const float* t = tile + r * pitch + g * cg;
  // Same order as the plain version: corner sum per channel, then the
  // channel sum of the group, in f32.
  float acc = 0.f;
  for (int j = 0; j < cg; ++j) {
    acc += ((t[j] + t[c + j]) + t[2 * c + j]) + t[3 * c + j];
  }
  out[static_cast<long long>(g) * rows + row0 + r] = acc / static_cast<float>(cg);
}

}  // namespace

// premul: [rows, 4c] f32, contiguous. out: [groups, rows] f32.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int itermvs_corr_epilogue(const float* premul, float* out,
                                     long long rows, int c, int groups,
                                     void* stream) {
  if (rows <= 0) return 0;
  const dim3 block(kRows, groups);
  const long long blocks = (rows + kRows - 1) / kRows;
  const size_t smem = static_cast<size_t>(kRows) * (4 * c + 1) * sizeof(float);
  corr_epilogue_kernel<<<static_cast<unsigned>(blocks), block, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      premul, out, rows, c, groups);
  return static_cast<int>(cudaGetLastError());
}
