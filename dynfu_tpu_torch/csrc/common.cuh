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

// Raise a kernel's dynamic shared-memory limit to at least `bytes` on the
// current device. cudaFuncSetAttribute costs host time on every call, so
// the limit set is kept per device and raised only when a launch needs
// more.
template <auto Kernel>
static inline cudaError_t dynfu_smem_limit(size_t bytes) {
  static size_t set[16] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 16 && bytes <= set[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
  if (e == cudaSuccess && dev < 16) set[dev] = bytes;
  return e;
}

// dispatch a runtime k in 1..8 to the template instance
#define DYNFU_DISPATCH_K(k, ...)                 \
  switch (k) {                                   \
    case 1: { constexpr int KK = 1; __VA_ARGS__; } break; \
    case 2: { constexpr int KK = 2; __VA_ARGS__; } break; \
    case 3: { constexpr int KK = 3; __VA_ARGS__; } break; \
    case 4: { constexpr int KK = 4; __VA_ARGS__; } break; \
    case 5: { constexpr int KK = 5; __VA_ARGS__; } break; \
    case 6: { constexpr int KK = 6; __VA_ARGS__; } break; \
    case 7: { constexpr int KK = 7; __VA_ARGS__; } break; \
    case 8: { constexpr int KK = 8; __VA_ARGS__; } break; \
    default: return (int)cudaErrorInvalidValue;          \
  }
