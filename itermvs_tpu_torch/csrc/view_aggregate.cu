// K11 view_aggregate: the view-weighted correlation aggregation
//     out = (((c_0 w_0 + c_1 w_1) + c_2 w_2) + ...) / (1e-5 + ((w_0 + w_1) + ...))
// over the V-1 source views' group correlations c_v [B, n, G, P] and
// per-pixel view weights w [B, V-1, P], float32.
//
// Replaces: the XLA fusions of itermvs_tpu/models/itermvs.py:251-252 (the
// init branch's einsum over views divided by 1e-5 + the weight sum) and
// :297-298, 314-316, 347-349 (the iteration branch's unrolled
// agg + corr_v * wv fold and agg / weight_sum). In the port they were
// about 110 eager launches per 1600x1152 map.
//
// What bounds it on an H100: memory. Each view's correlation is read
// once, the weights once per block row, the output written once, with
// 2 operations per view and element: far below one operation per byte.
//
// Design: a thread owns kVec neighbouring pixels (float4 where the
// launcher finds P % 4 == 0 and aligned pointers) of 8 consecutive rows
// (one sample's G = 8 groups), threads along P so that a warp reads 512
// contiguous bytes per row and view. It walks the views in order,
// loading the weight word and the 8 correlation words of view v before
// folding them, and keeps the 8 sums and the weight sum in registers;
// so one launch serves any number of views up to kMaxViews, read
// through their own base pointers (no stacking copy) with one batch
// stride. Every operation is rounded on its own in the plain version's
// order (__fmul_rn / __fadd_rn / __fdiv_rn: no FMA contraction), so
// the output is bit-equal to view_aggregate_plain.
#include <cuda_runtime.h>

#include "view_aggregate.cuh"

namespace {

constexpr int kRows = 8;  // rows of [n*G] per thread

template <int kVec>
__global__ void __launch_bounds__(kThreads)
view_aggregate_kernel(const __grid_constant__ Views views, const float* __restrict__ weights,
                      float* __restrict__ out, int nv, int rows, int p,
                      long long batch_stride) {
  const int q = (blockIdx.x * kThreads + threadIdx.x) * kVec;
  if (q >= p) return;
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * kRows;
  const long long pp = p;
  const long long offset = b * batch_stride + r0 * pp + q;
  const float* w = weights + static_cast<long long>(b) * nv * pp + q;

  Lane<kVec> acc[kRows];
  for (int v = 0; v < nv; ++v) {
    Lane<kVec> wv;
    wv.load(w + v * pp);
    const float* c = views.corr[v] + offset;
    Lane<kVec> cv[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) cv[r].load(c + r * pp);
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float t = __fmul_rn(cv[r].v[e], wv.v[e]);
        acc[r].v[e] = v == 0 ? t : __fadd_rn(acc[r].v[e], t);
      }
  }
  const Lane<kVec> s = weight_sum<kVec>(w, nv, pp);
  float* o = out + (static_cast<long long>(b) * rows + r0) * pp + q;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[r].v[e] = __fdiv_rn(acc[r].v[e], s.v[e]);
    acc[r].store(o + r * pp);
  }
}

}  // namespace

// corr: nv host-side pointers to the views' [batch, rows, p] float32
// correlations (rows p apart, batch rows batch_stride apart). weights:
// [batch, nv, p] float32 contiguous. out: [batch, rows, p] float32.
// rows must be a multiple of 8, 1 <= nv <= 256. Returns the launch's
// error (0 on success).
extern "C" int itermvs_view_aggregate(const void* const* corr, int nv, const float* weights,
                                      float* out, int batch, int rows, int p,
                                      long long batch_stride, void* stream) {
  if (batch <= 0 || rows <= 0 || p <= 0) return 0;
  if (nv < 1 || nv > kMaxViews || rows % kRows != 0 || batch > 65535 || rows / kRows > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec4 = views_vec4(corr, nv, p, batch_stride) && aligned16(weights) &&
                    aligned16(out);
  const int vec = vec4 ? 4 : 1;
  const dim3 grid(static_cast<unsigned>((p / vec + kThreads - 1) / kThreads),
                  static_cast<unsigned>(rows / kRows), static_cast<unsigned>(batch));
  const Views views = make_views(corr, nv);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec4)
    view_aggregate_kernel<4><<<grid, kThreads, 0, st>>>(views, weights, out, nv, rows, p,
                                                        batch_stride);
  else
    view_aggregate_kernel<1><<<grid, kThreads, 0, st>>>(views, weights, out, nv, rows, p,
                                                        batch_stride);
  return static_cast<int>(cudaGetLastError());
}
