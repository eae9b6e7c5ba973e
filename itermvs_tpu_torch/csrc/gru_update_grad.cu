// K15 gru_update_grad: the backward of K14 gru_update. From the gradient
// g of h' = (1 - z) * h + z * q, with z = sigmoid(z_l) and q =
// tanh(q_l) recomputed from the saved logits (no z or q is kept from the
// forward):
//     d_z_l = sigmoid_backward(g * q - g * h, z)
//     d_q_l = tanh_backward(g * z, q)
//     d_h   = g * (1 - z)
// all [B, hidden, H, W] in the compute dtype (float32 or bfloat16).
//
// Replaces: the backward of the XLA fusion of
// itermvs_tpu/models/blocks.py:176-183 (jax.grad through the update, the
// sigmoid and the tanh). In the port, eager autograd's backward of the
// six-launch chain: some ten launches per call.
//
// What bounds it on an H100: memory. It reads four tensors and writes
// three, with about 50 operations per element: some 7 per byte in
// float32, far below the card's ratio.
//
// Design: a flat elementwise pass (conv_gru.cuh), a thread per 16-byte
// word of each tensor. Autograd's order, each operation rounded on its
// own: d_z_l's two terms come from the product z * q (g * q) and from
// 1 - z (-(g * h)), summed once; so all three are bit-equal to
// gru_update_grad_plain, which calls the same sigmoid_backward and
// tanh_backward as autograd.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "conv_gru.cuh"

namespace {

template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads)
gru_update_grad_kernel(const T* __restrict__ grad, const T* __restrict__ z_l,
                       const T* __restrict__ q_l, const T* __restrict__ h,
                       T* __restrict__ d_z_l, T* __restrict__ d_q_l, T* __restrict__ d_h,
                       long long n) {
  const long long i = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * kVec;
  if (i >= n) return;
  Lanes<T, kVec> g, z, q, hv;
  g.load(grad + i);
  z.load(z_l + i);
  q.load(q_l + i);
  hv.load(h + i);
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    const float zz = sigmoid<T>(z.v[e]);
    const float qq = tanh_<T>(q.v[e]);
    const float ge = g.v[e];
    const float gz = sub<T>(mul<T>(ge, qq), mul<T>(ge, hv.v[e]));
    z.v[e] = sigmoid_backward<T>(gz, zz);
    q.v[e] = tanh_backward<T>(mul<T>(ge, zz), qq);
    hv.v[e] = mul<T>(ge, sub<T>(1.0f, zz));
  }
  z.store(d_z_l + i);
  q.store(d_q_l + i);
  hv.store(d_h + i);
}

template <typename T>
int launch(const void* grad, const void* z_l, const void* q_l, const void* h, void* d_z_l,
           void* d_q_l, void* d_h, long long n, void* stream) {
  if (n <= 0) return 0;
  const T* g = static_cast<const T*>(grad);
  const T* z = static_cast<const T*>(z_l);
  const T* q = static_cast<const T*>(q_l);
  const T* hv = static_cast<const T*>(h);
  T* dz = static_cast<T*>(d_z_l);
  T* dq = static_cast<T*>(d_q_l);
  T* dh = static_cast<T*>(d_h);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  constexpr int kWord = word<T>();
  if (n % kWord == 0 && aligned16(g) && aligned16(z) && aligned16(q) && aligned16(hv) &&
      aligned16(dz) && aligned16(dq) && aligned16(dh))
    gru_update_grad_kernel<T, kWord><<<blocks(n, kWord), kThreads, 0, st>>>(
        g, z, q, hv, dz, dq, dh, n);
  else
    gru_update_grad_kernel<T, 1><<<blocks(n, 1), kThreads, 0, st>>>(g, z, q, hv, dz, dq,
                                                                      dh, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// grad, z_l, q_l, h in; d_z_l, d_q_l, d_h out: n elements each ([B,
// hidden, H, W] contiguous), of float32 (itermvs_gru_update_grad) or
// bfloat16 (_bf16). Returns the launch's error (0 on success).
extern "C" int itermvs_gru_update_grad(const void* grad, const void* z_l, const void* q_l,
                                       const void* h, void* d_z_l, void* d_q_l, void* d_h,
                                       long long n, void* stream) {
  return launch<float>(grad, z_l, q_l, h, d_z_l, d_q_l, d_h, n, stream);
}

extern "C" int itermvs_gru_update_grad_bf16(const void* grad, const void* z_l,
                                            const void* q_l, const void* h, void* d_z_l,
                                            void* d_q_l, void* d_h, long long n,
                                            void* stream) {
  return launch<__nv_bfloat16>(grad, z_l, q_l, h, d_z_l, d_q_l, d_h, n, stream);
}
