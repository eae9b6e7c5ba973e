// Shared by K25 grad_norm and K26 clip_adam (ops/clip_adam.py): the table
// of tensors both kernels walk, passed by value as a kernel parameter, and
// the split of each tensor into blocks of kBlockElems elements.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;
constexpr int kBlockElems = kThreads * kPerThread;
// Tensors per launch. The table is 5.6 KB of kernel parameters (CUDA 12.1
// and later take up to 32764 bytes on sm_70 and newer); the model's 100
// parameters fit one launch, and a longer list is cut into launches of
// this many (ops/clip_adam.py tensor_tables).
constexpr int kMaxTensors = 128;

// One launch's tensors: the parameters p, their gradients g and Adam's
// moments m and v (K25 reads g alone), their element counts, and the first
// block of each within the launch (first[count] is the launch's block
// count); block0 is the launch's first block among all launches of one
// call. Every tensor is float32 and contiguous, none empty.
struct Table {
  float* p[kMaxTensors];
  const float* g[kMaxTensors];
  float* m[kMaxTensors];
  float* v[kMaxTensors];
  long long numel[kMaxTensors];
  int first[kMaxTensors + 1];
  int count;
  int block0;
};

// The entry of block b of a launch: the last t < count with first[t] <= b.
// `table` is a __grid_constant__ kernel parameter: read in place (an
// indexed load from the parameter bank), never copied per thread.
__device__ __forceinline__ int tensor_of(const Table& table, int b) {
  int lo = 0, hi = table.count;
  while (hi - lo > 1) {
    const int mid = (lo + hi) / 2;
    if (table.first[mid] <= b) lo = mid;
    else hi = mid;
  }
  return lo;
}

// The element of entry t that thread `threadIdx.x` of block b takes in its
// j-th step (coalesced: a step covers kThreads consecutive elements).
__device__ __forceinline__ long long element(const Table& table, int t, int b, int j) {
  return static_cast<long long>(b - table.first[t]) * kBlockElems +
         static_cast<long long>(j) * kThreads + threadIdx.x;
}

// Whether `tables[0 .. launches)` are well formed: counts within
// [1, kMaxTensors], first[] from 0 and not decreasing, and each launch's
// blocks after the last one's (block0), all within `blocks` where it is
// not negative. Returns the total of their blocks, or -1.
inline long long checked_blocks(const Table* tables, int launches, long long blocks) {
  if (launches < 0 || (launches > 0 && tables == nullptr)) return -1;
  long long total = 0;
  for (int l = 0; l < launches; ++l) {
    const Table& t = tables[l];
    if (t.count < 1 || t.count > kMaxTensors || t.first[0] != 0 || t.block0 != total) return -1;
    for (int i = 0; i < t.count; ++i) {
      const long long need = (t.numel[i] + kBlockElems - 1) / kBlockElems;
      if (t.numel[i] <= 0 || t.first[i + 1] - t.first[i] != need) return -1;
    }
    total += t.first[t.count];
  }
  if (total > 0x7fffffffLL || (blocks >= 0 && total != blocks)) return -1;
  return total;
}

}  // namespace
