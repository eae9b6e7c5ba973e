// K14 gru_update: the ConvGRU's new hidden state
//     h' = (1 - sigmoid(z_l)) * h + sigmoid(z_l) * tanh(q_l)
// from the logits of convz and convq and the hidden state, all
// [B, hidden, H, W] in the compute dtype (float32 or bfloat16).
//
// Replaces: the XLA fusion of itermvs_tpu/models/blocks.py:176-183 (the
// sigmoid of convz, the tanh of convq and the update), one per GRU
// iteration (itermvs_tpu/models/itermvs.py:408). In the port these were
// six eager launches per call (sigmoid, tanh, 1 - z, (1 - z) * h, z * q,
// the sum).
//
// What bounds it on an H100: memory. It reads three tensors and writes
// one, with about 40 operations per element in float32 (expf and tanhf
// included): some 10 per byte in float32, 20 in bfloat16, far below the
// card's ratio of operations to bytes.
//
// Design: a flat elementwise pass (conv_gru.cuh), a thread per 16-byte
// word of each tensor. Every operation is rounded to the compute dtype on
// its own in the plain version's order, so the output is bit-equal to
// gru_update_plain: z and q, then 1 - z, (1 - z) * h, z * q and the sum.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "conv_gru.cuh"

namespace {

template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads)
gru_update_kernel(const T* __restrict__ z_l, const T* __restrict__ q_l,
                  const T* __restrict__ h, T* __restrict__ out, long long n) {
  const long long i = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * kVec;
  if (i >= n) return;
  Lanes<T, kVec> z, q, hv;
  z.load(z_l + i);
  q.load(q_l + i);
  hv.load(h + i);
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    const float zz = sigmoid<T>(z.v[e]);
    const float qq = tanh_<T>(q.v[e]);
    z.v[e] = add<T>(mul<T>(sub<T>(1.0f, zz), hv.v[e]), mul<T>(zz, qq));
  }
  z.store(out + i);
}

template <typename T>
int launch(const void* z_l, const void* q_l, const void* h, void* out, long long n,
           void* stream) {
  if (n <= 0) return 0;
  const T* z = static_cast<const T*>(z_l);
  const T* q = static_cast<const T*>(q_l);
  const T* hv = static_cast<const T*>(h);
  T* o = static_cast<T*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  constexpr int kWord = word<T>();
  if (n % kWord == 0 && aligned16(z) && aligned16(q) && aligned16(hv) && aligned16(o))
    gru_update_kernel<T, kWord><<<blocks(n, kWord), kThreads, 0, st>>>(z, q, hv, o, n);
  else
    gru_update_kernel<T, 1><<<blocks(n, 1), kThreads, 0, st>>>(z, q, hv, o, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// z_l, q_l, h, out: n elements each ([B, hidden, H, W] contiguous), of
// float32 (itermvs_gru_update) or bfloat16 (_bf16). Returns the launch's
// error (0 on success).
extern "C" int itermvs_gru_update(const void* z_l, const void* q_l, const void* h, void* out,
                                  long long n, void* stream) {
  return launch<float>(z_l, q_l, h, out, n, stream);
}

extern "C" int itermvs_gru_update_bf16(const void* z_l, const void* q_l, const void* h,
                                       void* out, long long n, void* stream) {
  return launch<__nv_bfloat16>(z_l, q_l, h, out, n, stream);
}
