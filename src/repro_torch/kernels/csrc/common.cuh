// Shared helpers of the SpMV and SpMM kernels: value loads widened to
// float32 (one at a time, as 16-byte chunks of a stream, or as the PER
// consecutive values of an X row), vector atomics, the SpMM row group's
// shuffle mask, and the launch-shape checks and template dispatch of the C
// entry points.  Every launch shape is
// chosen by the Python wrappers (kernels/_common.py); an entry point only
// checks it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

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

// CHUNK consecutive entries from an address aligned for the vector loads.
template <int CHUNK>
__device__ __forceinline__ void load_chunk(const int* p, int (&v)[CHUNK]) {
#pragma unroll
  for (int q = 0; q < CHUNK / 4; ++q) {
    const int4 w = __ldcs(reinterpret_cast<const int4*>(p) + q);
    v[4 * q] = w.x;
    v[4 * q + 1] = w.y;
    v[4 * q + 2] = w.z;
    v[4 * q + 3] = w.w;
  }
}

template <int CHUNK>
__device__ __forceinline__ void load_chunk(const float* p, float (&v)[CHUNK]) {
#pragma unroll
  for (int q = 0; q < CHUNK / 4; ++q) {
    const float4 w = __ldcs(reinterpret_cast<const float4*>(p) + q);
    v[4 * q] = w.x;
    v[4 * q + 1] = w.y;
    v[4 * q + 2] = w.z;
    v[4 * q + 3] = w.w;
  }
}

// bfloat16: four values in 8 bytes; a bfloat16 is the top half of a float32.
template <int CHUNK>
__device__ __forceinline__ void load_chunk(const __nv_bfloat16* p,
                                           float (&v)[CHUNK]) {
#pragma unroll
  for (int q = 0; q < CHUNK / 4; ++q) {
    const uint2 w = __ldcs(reinterpret_cast<const uint2*>(p) + q);
    v[4 * q] = __uint_as_float(w.x << 16);
    v[4 * q + 1] = __uint_as_float(w.x & 0xffff0000u);
    v[4 * q + 2] = __uint_as_float(w.y << 16);
    v[4 * q + 3] = __uint_as_float(w.y & 0xffff0000u);
  }
}

// PER consecutive values of one X row, from an address aligned for them.
template <int PER>
__device__ __forceinline__ void load_row(const float* p, float (&v)[PER]) {
  if constexpr (PER == 4) {
    const float4 w = *reinterpret_cast<const float4*>(p);
    v[0] = w.x;
    v[1] = w.y;
    v[2] = w.z;
    v[3] = w.w;
  } else if constexpr (PER == 2) {
    const float2 w = *reinterpret_cast<const float2*>(p);
    v[0] = w.x;
    v[1] = w.y;
  } else {
    v[0] = *p;
  }
}

// bfloat16: a bfloat16 is the top half of a float32.
template <int PER>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p,
                                         float (&v)[PER]) {
  if constexpr (PER == 4) {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    v[0] = __uint_as_float(w.x << 16);
    v[1] = __uint_as_float(w.x & 0xffff0000u);
    v[2] = __uint_as_float(w.y << 16);
    v[3] = __uint_as_float(w.y & 0xffff0000u);
  } else if constexpr (PER == 2) {
    const unsigned w = *reinterpret_cast<const unsigned*>(p);
    v[0] = __uint_as_float(w << 16);
    v[1] = __uint_as_float(w & 0xffff0000u);
  } else {
    v[0] = __bfloat162float(*p);
  }
}

// One vector atomic add of PER consecutive floats (sm_90 adds float2 and
// float4 atomics to global memory).
template <int PER>
__device__ __forceinline__ void add_row(float* p, const float (&v)[PER]) {
  if constexpr (PER == 4) {
    atomicAdd(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  } else if constexpr (PER == 2) {
    atomicAdd(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
  } else {
    atomicAdd(p, v[0]);
  }
}

// Mask of the aligned group of `lanes` threads (a power of two <= 32) that
// holds the calling thread: the SpMM kernels shuffle within such a group, and
// groups of one warp may take different paths.
__device__ __forceinline__ unsigned group_mask(int lanes) {
  if (lanes >= 32) return 0xffffffffu;
  const int first = (threadIdx.x % 32) / lanes * lanes;
  return ((1u << lanes) - 1u) << first;
}

// Whether a pointer is aligned for a 16-byte load.
static inline bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
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
