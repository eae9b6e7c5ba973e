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
// Design: registers only, no shared memory and no barrier. A thread owns
// U consecutive 16-byte vectors (8 channels each) of one row in all four
// corners, U = lcm(8, cg)/8, so its 8U channels are whole groups (at G =
// 8: one vector and four groups at C = 16, one and two at C = 32, three
// and four at C = 48; C/(8U) threads a row, neighbouring lanes). It issues
// its 4U loads at once (independent, 64-192 bytes in flight a thread),
// sums the corners per channel and then the channels of each group in
// float32, in the plain version's order, and writes out[g, row]: each
// store instruction of a warp writes runs of consecutive rows of a group.
// Where U = 1 and a row has two threads or more, each load instruction
// of a warp reads whole 32-byte sectors, and the loads stream past L1
// (L1::no_allocate); otherwise (C = 48) a thread's loads read sector
// halves whose other halves its next load reads, and L1 keeps them. Both
// ask L2 for 256-byte fetches. On the H100 that choice was worth 6-10%
// per shape; a TMA ring feeding mma.sync with the 0/1 corner-and-group
// matrix, and striped lanes at C = 48 (whole sectors, groups summed
// across the row's threads with shuffles), were slower. cg is a template
// argument: the wrapper takes C % 8 == 0 and lcm(8, cg) <= 32.
#include <cuda_runtime.h>

#include "bf16_lanes.cuh"

namespace {

constexpr int kThreads = 256;

__host__ __device__ constexpr int gcd(int a, int b) { return b == 0 ? a : gcd(b, a % b); }

// A 16-byte load that allocates in L1 (a sector half read now is read
// again by the thread's next load), or one that streams past it (each
// load instruction of the warp covers whole sectors). Both ask L2 for
// 256 bytes.
template <bool kStream>
__device__ __forceinline__ uint4 load16(const uint4* p) {
  uint4 v;
  if constexpr (kStream) {
    asm("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];"
        : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  } else {
    asm("ld.global.nc.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];"
        : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  }
  return v;
}

// CG channels a group; kStream: load with load16<true>.
template <int CG, bool kStream>
__global__ void __launch_bounds__(kThreads)
corr_epilogue_bf16_kernel(const uint4* __restrict__ premul, float* __restrict__ out,
                          long long rows, int c8) {
  constexpr int kSpan = 8 * CG / gcd(8, CG);   // lcm(8, cg): channels a thread owns
  constexpr int kU = kSpan / 8;                // vectors a corner
  constexpr int kGroups = kSpan / CG;          // groups a thread writes
  const long long row = static_cast<long long>(blockIdx.x) * blockDim.y + threadIdx.y;
  if (row >= rows) return;
  const int t = threadIdx.x;
  const uint4* p = premul + row * (4LL * c8) + t * kU;

  uint4 v[4][kU];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int u = 0; u < kU; ++u) v[k][u] = load16<kStream>(p + k * c8 + u);
  }
  // Corner sum per channel, then the channel sum of each group, in
  // float32: the plain version's order.
  float s[kSpan];
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    float f0[8], f1[8], f2[8], f3[8];
    bf16x8_to_float(v[0][u], f0);
    bf16x8_to_float(v[1][u], f1);
    bf16x8_to_float(v[2][u], f2);
    bf16x8_to_float(v[3][u], f3);
#pragma unroll
    for (int j = 0; j < 8; ++j) s[8 * u + j] = ((f0[j] + f1[j]) + f2[j]) + f3[j];
  }
  float* o = out + static_cast<long long>(t) * kGroups * rows + row;
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < CG; ++j) acc += s[g * CG + j];
    o[g * rows] = acc / static_cast<float>(CG);
  }
}

template <int CG, bool kStream>
int launch_as(const void* premul, float* out, long long rows, int c, int tpr,
              cudaStream_t stream) {
  const int rows_per_block = kThreads / tpr;
  const dim3 block(tpr, rows_per_block);
  const long long blocks = (rows + rows_per_block - 1) / rows_per_block;
  corr_epilogue_bf16_kernel<CG, kStream><<<static_cast<unsigned>(blocks), block, 0, stream>>>(
      static_cast<const uint4*>(premul), out, rows, c / 8);
  return static_cast<int>(cudaGetLastError());
}

template <int CG>
int launch(const void* premul, float* out, long long rows, int c, cudaStream_t stream) {
  constexpr int kU = CG / gcd(8, CG);
  const int tpr = c / (8 * kU);                  // threads a row
  // One vector a corner and at least two threads a row: every load
  // instruction of a warp reads whole 32-byte sectors.
  if constexpr (kU == 1) {
    if (tpr >= 2) return launch_as<CG, true>(premul, out, rows, c, tpr, stream);
  }
  return launch_as<CG, false>(premul, out, rows, c, tpr, stream);
}

}  // namespace

// premul: [rows, 4c] bf16, contiguous, 16-byte aligned; c % 8 == 0 and
// cg = c / groups with lcm(8, cg) <= 32 (cg in 1, 2, 3, 4, 6, 8, 12, 16,
// 24, 32). out: [groups, rows] f32. Returns cudaGetLastError() after the
// launch (0 on success), cudaErrorInvalidValue for another cg.
extern "C" int itermvs_corr_epilogue_bf16(const void* premul, float* out,
                                          long long rows, int c, int groups,
                                          void* stream) {
  if (rows <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (c % 8 == 0 && c % groups == 0 ? c / groups : 0) {
    case 1: return launch<1>(premul, out, rows, c, st);
    case 2: return launch<2>(premul, out, rows, c, st);
    case 3: return launch<3>(premul, out, rows, c, st);
    case 4: return launch<4>(premul, out, rows, c, st);
    case 6: return launch<6>(premul, out, rows, c, st);
    case 8: return launch<8>(premul, out, rows, c, st);
    case 12: return launch<12>(premul, out, rows, c, st);
    case 16: return launch<16>(premul, out, rows, c, st);
    case 24: return launch<24>(premul, out, rows, c, st);
    case 32: return launch<32>(premul, out, rows, c, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
