// Launch-side opt-in to more than 48 KB of dynamic shared memory, shared
// by the kernels of this directory.
#pragma once

#include <cuda_runtime.h>

// Dynamic shared memory above 48 KB needs an explicit opt-in per kernel
// and per device. `allowed` is the caller's record for this kernel (one
// static per template instantiation) of the bytes opted in on each device,
// so the attribute is set only when a launch on the current device needs
// more than an earlier one did (the size may depend on run-time arguments).
constexpr int kSmemDevices = 64;   // devices remembered; others always set
struct SmemAllowed { int bytes[kSmemDevices]; };

template <typename K>
static cudaError_t allow_smem(K kernel, size_t bytes, SmemAllowed* allowed) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool known = dev >= 0 && dev < kSmemDevices;
  if (known && (int)bytes <= allowed->bytes[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (known && err == cudaSuccess) allowed->bytes[dev] = (int)bytes;
  return err;
}
