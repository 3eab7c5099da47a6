// Shared helpers of the SpMV and SpMM kernels: value loads widened to
// float32, the SpMM row group's shuffle mask, and the launch-shape checks and
// template dispatch of the C entry points.  Every launch shape is
// chosen by the Python wrappers (kernels/_common.py); an entry point only
// checks it.
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

// Mask of the aligned group of `lanes` threads (a power of two <= 32) that
// holds the calling thread: the SpMM kernels shuffle within such a group, and
// groups of one warp may take different paths.
__device__ __forceinline__ unsigned group_mask(int lanes) {
  if (lanes >= 32) return 0xffffffffu;
  const int first = (threadIdx.x % 32) / lanes * lanes;
  return ((1u << lanes) - 1u) << first;
}

// Whether a block of `threads` threads in groups of `lanes` is one the
// kernels take: `lanes` a power of two <= 32, `threads` a whole number of
// warps <= 1024 (so also a whole number of groups).
static inline bool valid_block(int lanes, long long threads) {
  return lanes >= 1 && lanes <= 32 && (lanes & (lanes - 1)) == 0 &&
         threads >= 32 && threads <= 1024 && threads % 32 == 0;
}

// Whether an SpMM column tile is one the kernels take: `kt` columns per
// block, covered by `lanes` threads of `per_lane` columns each.
static inline bool valid_rhs_tile(int kt, int lanes, int per_lane) {
  return kt >= 1 && (long long)kt <= (long long)lanes * per_lane;
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

// Instantiate `LAUNCH(TD, TX, P)` for the columns per thread an SpMM kernel
// keeps in registers, P in {1, 2, 4}; any other value makes the calling entry
// point return cudaErrorInvalidValue.
#define DISPATCH_PER_LANE(per_lane, LAUNCH, TD, TX)  \
  switch (per_lane) {                                \
    case 1: LAUNCH(TD, TX, 1); break;                \
    case 2: LAUNCH(TD, TX, 2); break;                \
    case 4: LAUNCH(TD, TX, 4); break;                \
    default: return (int)cudaErrorInvalidValue;      \
  }

// Instantiate `LAUNCH(TD, TX, L)` for the lanes per row of an SpMV kernel,
// L in {2, 4, 8, 16, 32}; any other value makes the calling entry point
// return cudaErrorInvalidValue.
#define DISPATCH_LANES(lanes, LAUNCH, TD, TX)        \
  switch (lanes) {                                   \
    case 2: LAUNCH(TD, TX, 2); break;                \
    case 4: LAUNCH(TD, TX, 4); break;                \
    case 8: LAUNCH(TD, TX, 8); break;                \
    case 16: LAUNCH(TD, TX, 16); break;              \
    case 32: LAUNCH(TD, TX, 32); break;              \
    default: return (int)cudaErrorInvalidValue;      \
  }
