// Shared helpers for the kernels in this directory. Each .cu file exports
// plain C entry points (no PyTorch headers) that enqueue on the caller's
// stream and return cudaGetLastError().
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#define DYNFU_API extern "C" __attribute__((visibility("default")))

// shared memory a block may use on sm_90, static and dynamic together
// (dynamic beyond 48 KB after cudaFuncAttributeMaxDynamicSharedMemorySize)
#define DYNFU_MAX_SMEM 232448

static inline int dynfu_blocks(long long n, int threads) {
  return (int)((n + threads - 1) / threads);
}
