// The kernels' launch, shared by K9, K10 (upsample_taps.cuh) and K12
// (view_aggregate_grad.cu).
#pragma once

#include <cuda_runtime.h>

namespace {

// Launches `kernel` on `stream`; where `programmatic`, as a programmatic
// dependent launch: its blocks may start while the stream's previous
// kernel drains, so they must call cudaGridDependencySynchronize()
// before they touch global memory. Returns the launch's error; a failed
// launch is reported, never retried another way.
template <typename... Params, typename... Args>
cudaError_t launch_kernel(bool programmatic, void (*kernel)(Params...), dim3 grid, dim3 block,
                          cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t config = {};
  config.gridDim = grid;
  config.blockDim = block;
  config.stream = stream;
  cudaLaunchAttribute attribute[1];
  attribute[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attribute[0].val.programmaticStreamSerializationAllowed = 1;
  config.attrs = attribute;
  config.numAttrs = programmatic ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&config, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace
