// Shared device helpers for the SpMV kernels: value loads widened to float32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

template <typename T>
__device__ __forceinline__ float to_f32(T v);

template <>
__device__ __forceinline__ float to_f32<float>(float v) {
  return v;
}

template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Round a requested thread count to a whole number of warps in [32, 1024].
static inline int clamp_threads(long long threads) {
  if (threads < 32) threads = 32;
  if (threads > 1024) threads = 1024;
  return (int)((threads + 31) / 32 * 32);
}

// Instantiate `CALL(TD, TX)` for the four (data, x) value-type pairs.
#define DISPATCH_VALUE_TYPES(data_bf16, x_bf16, CALL) \
  do {                                                 \
    if (data_bf16) {                                   \
      if (x_bf16) {                                    \
        CALL(__nv_bfloat16, __nv_bfloat16);            \
      } else {                                         \
        CALL(__nv_bfloat16, float);                    \
      }                                                \
    } else {                                           \
      if (x_bf16) {                                    \
        CALL(float, __nv_bfloat16);                    \
      } else {                                         \
        CALL(float, float);                            \
      }                                                \
    }                                                  \
  } while (0)
