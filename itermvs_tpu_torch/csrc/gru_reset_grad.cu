// K16 gru_reset_grad: the backward of K13 gru_reset. From the gradient G
// [B, channels, H, W] of rh_x = [r * h, x], with r = sigmoid(r_l)
// recomputed from the saved logits and h the hidden channels of hx:
//     d_r_l = sigmoid_backward(G[:hidden] * h, r)     [B, hidden, H, W]
//     d_hx  = [G[:hidden] * r, G[hidden:]]            [B, channels, H, W]
// in the compute dtype (float32 or bfloat16). Autograd adds d_hx to the
// input gradients of convz and convr.
//
// Replaces: the backward of the XLA fusion of
// itermvs_tpu/models/blocks.py:178-180 (jax.grad through the
// concatenation, r * h and the sigmoid). In the port, eager autograd's
// backward of sigmoid, r * h and cat: four launches per call.
//
// What bounds it on an H100: memory. It reads G, r_l and h and writes
// d_r_l and d_hx, with about 30 operations per hidden element.
//
// Design: K13's (gru_reset.cu), a flat pass over each sample's channels *
// H * W elements of d_hx, blockIdx.y the sample; the hidden channels
// write d_r_l and d_hx, the channels of x copy G into d_hx bit for bit.
// Each operation rounds on its own in autograd's order, so both outputs
// are bit-equal to gru_reset_grad_plain.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "conv_gru.cuh"

namespace {

template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads)
gru_reset_grad_kernel(const T* __restrict__ grad, const T* __restrict__ r_l,
                      const T* __restrict__ hx, T* __restrict__ d_r_l, T* __restrict__ d_hx,
                      long long hidden_n, long long channels_n) {
  const long long i = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * kVec;
  if (i >= channels_n) return;
  const long long at = blockIdx.y * channels_n + i;
  if (i >= hidden_n) {
    copy<T, kVec>(grad + at, d_hx + at);
    return;
  }
  const long long hat = blockIdx.y * hidden_n + i;
  Lanes<T, kVec> g, r, hv;
  g.load(grad + at);
  r.load(r_l + hat);
  hv.load(hx + at);
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    const float rr = sigmoid<T>(r.v[e]);
    r.v[e] = sigmoid_backward<T>(mul<T>(g.v[e], hv.v[e]), rr);
    hv.v[e] = mul<T>(g.v[e], rr);
  }
  r.store(d_r_l + hat);
  hv.store(d_hx + at);
}

template <typename T>
int launch(const void* grad, const void* r_l, const void* hx, void* d_r_l, void* d_hx,
           int batch, int hidden, int channels, int p, void* stream) {
  if (batch <= 0 || p <= 0) return 0;
  if (hidden <= 0 || channels <= hidden || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const T* g = static_cast<const T*>(grad);
  const T* r = static_cast<const T*>(r_l);
  const T* src = static_cast<const T*>(hx);
  T* dr = static_cast<T*>(d_r_l);
  T* dhx = static_cast<T*>(d_hx);
  const long long hidden_n = static_cast<long long>(hidden) * p;
  const long long channels_n = static_cast<long long>(channels) * p;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  constexpr int kWord = word<T>();
  if (p % kWord == 0 && aligned16(g) && aligned16(r) && aligned16(src) && aligned16(dr) &&
      aligned16(dhx)) {
    const dim3 grid(blocks(channels_n, kWord), static_cast<unsigned>(batch));
    gru_reset_grad_kernel<T, kWord><<<grid, kThreads, 0, st>>>(g, r, src, dr, dhx, hidden_n,
                                                               channels_n);
  } else {
    const dim3 grid(blocks(channels_n, 1), static_cast<unsigned>(batch));
    gru_reset_grad_kernel<T, 1><<<grid, kThreads, 0, st>>>(g, r, src, dr, dhx, hidden_n,
                                                           channels_n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// grad, hx, d_hx: [batch, channels, p]; r_l, d_r_l: [batch, hidden, p];
// contiguous, of float32 (itermvs_gru_reset_grad) or bfloat16 (_bf16);
// hidden < channels, batch <= 65535. Returns the launch's error (0 on
// success).
extern "C" int itermvs_gru_reset_grad(const void* grad, const void* r_l, const void* hx,
                                      void* d_r_l, void* d_hx, int batch, int hidden,
                                      int channels, int p, void* stream) {
  return launch<float>(grad, r_l, hx, d_r_l, d_hx, batch, hidden, channels, p, stream);
}

extern "C" int itermvs_gru_reset_grad_bf16(const void* grad, const void* r_l, const void* hx,
                                           void* d_r_l, void* d_hx, int batch, int hidden,
                                           int channels, int p, void* stream) {
  return launch<__nv_bfloat16>(grad, r_l, hx, d_r_l, d_hx, batch, hidden, channels, p,
                               stream);
}
