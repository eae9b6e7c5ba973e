// K13 gru_reset: the input of the ConvGRU's convq,
//     rh_x = [sigmoid(r_l) * h, x]
// from the logits r_l [B, hidden, H, W] of convr and hx = [h, x]
// [B, channels, H, W] (the input of convz and convr), in the compute
// dtype (float32 or bfloat16). It writes the concatenation itself, so
// no torch.cat runs after it.
//
// Replaces: the XLA fusion of itermvs_tpu/models/blocks.py:178-180 (the
// sigmoid of convr, r * h and the concatenation with x), one per GRU
// iteration (itermvs_tpu/models/itermvs.py:408). In the port these were
// three eager launches per call (sigmoid, r * h, cat).
//
// What bounds it on an H100: memory. It reads r_l and hx and writes
// rh_x, with about 30 operations per hidden element and none for the
// channels of x, which are copied.
//
// Design: a flat pass over each sample's channels * H * W elements of
// rh_x (blockIdx.y the sample), a thread per 16-byte word where H * W is
// a multiple of the word's elements (then no word straddles the hidden
// channels and x's) and every pointer is aligned; else one element. The
// hidden channels are rounded to the compute dtype after the sigmoid and
// after the product, as the plain version's two launches round them, so
// rh_x is bit-equal to gru_reset_plain; x's channels move bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "conv_gru.cuh"

namespace {

template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads)
gru_reset_kernel(const T* __restrict__ r_l, const T* __restrict__ hx, T* __restrict__ out,
                 long long hidden_n, long long channels_n) {
  const long long i = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * kVec;
  if (i >= channels_n) return;
  const long long at = blockIdx.y * channels_n + i;
  if (i >= hidden_n) {
    copy<T, kVec>(hx + at, out + at);
    return;
  }
  Lanes<T, kVec> r, hv;
  r.load(r_l + blockIdx.y * hidden_n + i);
  hv.load(hx + at);
#pragma unroll
  for (int e = 0; e < kVec; ++e) r.v[e] = mul<T>(sigmoid<T>(r.v[e]), hv.v[e]);
  r.store(out + at);
}

template <typename T>
int launch(const void* r_l, const void* hx, void* out, int batch, int hidden, int channels,
           int p, void* stream) {
  if (batch <= 0 || p <= 0) return 0;
  if (hidden <= 0 || channels <= hidden || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const T* r = static_cast<const T*>(r_l);
  const T* src = static_cast<const T*>(hx);
  T* o = static_cast<T*>(out);
  const long long hidden_n = static_cast<long long>(hidden) * p;
  const long long channels_n = static_cast<long long>(channels) * p;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  constexpr int kWord = word<T>();
  if (p % kWord == 0 && aligned16(r) && aligned16(src) && aligned16(o)) {
    const dim3 grid(blocks(channels_n, kWord), static_cast<unsigned>(batch));
    gru_reset_kernel<T, kWord><<<grid, kThreads, 0, st>>>(r, src, o, hidden_n, channels_n);
  } else {
    const dim3 grid(blocks(channels_n, 1), static_cast<unsigned>(batch));
    gru_reset_kernel<T, 1><<<grid, kThreads, 0, st>>>(r, src, o, hidden_n, channels_n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// r_l: [batch, hidden, p]; hx, out: [batch, channels, p], contiguous, of
// float32 (itermvs_gru_reset) or bfloat16 (_bf16); hidden < channels,
// batch <= 65535. Returns the launch's error (0 on success).
extern "C" int itermvs_gru_reset(const void* r_l, const void* hx, void* out, int batch,
                                 int hidden, int channels, int p, void* stream) {
  return launch<float>(r_l, hx, out, batch, hidden, channels, p, stream);
}

extern "C" int itermvs_gru_reset_bf16(const void* r_l, const void* hx, void* out, int batch,
                                      int hidden, int channels, int p, void* stream) {
  return launch<__nv_bfloat16>(r_l, hx, out, batch, hidden, channels, p, stream);
}
