// ELL SpMV for Hopper (sm_90a): y[r] = sum_w data[r, w] * x[cols[r, w]].
//
// Replaces the TPU kernel repro/kernels/ell_spmv.py:ell_spmv, whose grid
// walks the whole padded band block by block.
//
// The panel is addressed through (row_stride, col_stride) in elements, so the
// same entry point serves ELL-Row storage (n_rows, width), ELL-Col storage
// (width, n_rows) viewed transposed, and SELL buckets, with no transpose copy.
// Padded slots hold (val +-0, col 0).  Accumulation is float32 in a
// register; one store per row.
//
// Bound on an H100: bytes.  A band padded to its longest row is mostly pads
// (xenon2: 43 slots for 24.6 entries a row), so the design reads each row's
// live extent only: extent[r] is 1 + the last slot of row r that is not a
// (+-0, column 0) pad (kernels/ell_spmv.py:ell_extent, computed once per
// panel when the panel is bound).  Lanes of a row stop there, and a row with
// extent[r] < width adds 0 * x[0] once: the values that adding every pad
// gives, but for the sign of a zero sum (a finite x[0] makes the term +-0,
// an infinite or NaN one makes it NaN once or many times).  So exactly the
// rows whose band holds a pad turn NaN when x[0] is not finite, as in the
// plain version.  Whole sectors past most rows' extents are never fetched:
// the least the card must move is the live slots, the extents, x and y.
// Without an extent (extent == nullptr) every slot of the band is read.
//
//  * lanes == 1: one thread per row, correct for any strides.  For
//    row_stride == 1 (ELL-Col) consecutive threads read consecutive addresses
//    at every band step, so panel loads coalesce.
//  * lanes > 1 (col_stride == 1, ELL-Row): LANES lanes per row stride along
//    the band so that a group reads one contiguous run, then a shuffle
//    reduction.
// A thread reading up to an extent, and the lanes of a band of more than two
// slots a lane, load 4 slots each before gathering their x values, so that
// many panel loads are in flight; elsewhere a slot at a time, which was
// faster on small bands (PERF.md §6).  The wrapper
// (kernels/ell_spmv.py, through kernels/_common.py) picks the lanes from the
// strides and the band width.
#include "common.cuh"

// The slots w0, w0 + step, ... below `stop` of one row, added to acc.  U == 1:
// one after the other; else U at a time, their data and columns loaded
// first, then their x values, so that many panel loads are in flight.
template <typename TD, typename TX, int U>
__device__ __forceinline__ float ell_row(const TD* __restrict__ d,
                                         const int* __restrict__ c,
                                         const TX* __restrict__ x, int w0,
                                         int step, int stop,
                                         long long col_stride) {
  float acc = 0.f;
  if constexpr (U == 1) {
    for (int w = w0; w < stop; w += step) {
      const long long o = w * col_stride;
      acc += to_f32<TD>(d[o]) * to_f32<TX>(x[c[o]]);
    }
  } else {
    for (; w0 < stop; w0 += U * step) {
      float dv[U];
      int cv[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long o = (long long)(w0 + u * step) * col_stride;
        dv[u] = w0 + u * step < stop ? to_f32<TD>(d[o]) : 0.f;
        cv[u] = w0 + u * step < stop ? c[o] : -1;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (cv[u] >= 0) acc += dv[u] * to_f32<TX>(x[cv[u]]);
      }
    }
  }
  return acc;
}

// U: 4 where an extent is read (the slots past it are never loaded, so
// unrolling fetches nothing more), else 1.
template <typename TD, typename TX, int U>
__global__ void ell_spmv_thread_per_row(const TD* __restrict__ data,
                                        const int* __restrict__ cols,
                                        const int* __restrict__ extent,
                                        const TX* __restrict__ x,
                                        float* __restrict__ y, int n_rows,
                                        int width, long long row_stride,
                                        long long col_stride) {
  const long long r = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (r >= n_rows) return;
  const int stop = extent ? extent[r] : width;
  float acc = ell_row<TD, TX, U>(data + r * row_stride, cols + r * row_stride,
                                 x, 0, 1, stop, col_stride);
  if (stop < width) acc += 0.f * to_f32<TX>(x[0]);  // the pads' term, once
  y[r] = acc;
}

// U: 4 for a band of more than two slots a lane, else 1.
template <typename TD, typename TX, int LANES, int U>
__global__ void ell_spmv_lanes_per_row(const TD* __restrict__ data,
                                       const int* __restrict__ cols,
                                       const int* __restrict__ extent,
                                       const TX* __restrict__ x,
                                       float* __restrict__ y, int n_rows,
                                       int width, long long row_stride) {
  const int lane = threadIdx.x % LANES;
  const long long r =
      (blockIdx.x * (long long)blockDim.x + threadIdx.x) / LANES;
  float acc = 0.f;
  if (r < n_rows) {
    const int stop = extent ? extent[r] : width;
    acc = ell_row<TD, TX, U>(data + r * row_stride, cols + r * row_stride,
                             x, lane, LANES, stop, 1);
    if (lane == 0 && stop < width) acc += 0.f * to_f32<TX>(x[0]);
  }
  // every thread of the warp takes part; groups of LANES reduce separately
  for (int off = LANES / 2; off > 0; off >>= 1) {
    acc += __shfl_down_sync(0xffffffffu, acc, off, LANES);
  }
  if (r < n_rows && lane == 0) y[r] = acc;
}

// extent: (n_rows,) int32 live extents, or null to read the whole band;
// lanes: threads per row, 1 or a power of two in [2, 32] (then col_stride
// must be 1); rows_per_block * lanes: threads per block (a whole number of
// warps, <= 1024).  Returns cudaGetLastError().
extern "C" int ell_spmv_launch(const void* data, const void* cols,
                               const void* extent, const void* x, void* y,
                               int n_rows, int width, long long row_stride,
                               long long col_stride, int lanes,
                               int rows_per_block, int data_bf16, int x_bf16,
                               void* stream) {
  if (n_rows <= 0) return 0;
  const long long threads = (long long)rows_per_block * lanes;
  if (!valid_block(lanes, threads) || (lanes > 1 && col_stride != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned grid =
      (unsigned)(((long long)n_rows + rows_per_block - 1) / rows_per_block);
  if (lanes == 1) {
#define CALL(TD, TX)                                                        \
  do {                                                                      \
    if (extent) {                                                           \
      ell_spmv_thread_per_row<TD, TX, 4><<<grid, (unsigned)threads, 0, s>>>( \
          (const TD*)data, (const int*)cols, (const int*)extent,            \
          (const TX*)x, (float*)y, n_rows, width, row_stride, col_stride);  \
    } else {                                                                \
      ell_spmv_thread_per_row<TD, TX, 1><<<grid, (unsigned)threads, 0, s>>>( \
          (const TD*)data, (const int*)cols, (const int*)extent,            \
          (const TX*)x, (float*)y, n_rows, width, row_stride, col_stride);  \
    }                                                                       \
  } while (0)
    DISPATCH_VALUE_TYPES(data_bf16, x_bf16, CALL);
#undef CALL
  } else {
#define LAUNCH(TD, TX, L)                                                   \
  do {                                                                      \
    if (width > 2 * (L)) {                                                  \
      ell_spmv_lanes_per_row<TD, TX, L, 4><<<grid, (unsigned)threads, 0,    \
                                             s>>>(                          \
          (const TD*)data, (const int*)cols, (const int*)extent,            \
          (const TX*)x, (float*)y, n_rows, width, row_stride);              \
    } else {                                                                \
      ell_spmv_lanes_per_row<TD, TX, L, 1><<<grid, (unsigned)threads, 0,    \
                                             s>>>(                          \
          (const TD*)data, (const int*)cols, (const int*)extent,            \
          (const TX*)x, (float*)y, n_rows, width, row_stride);              \
    }                                                                       \
  } while (0)
#define CALL(TD, TX) DISPATCH_LANES(lanes, LAUNCH, TD, TX)
    DISPATCH_VALUE_TYPES(data_bf16, x_bf16, CALL);
#undef CALL
#undef LAUNCH
  }
  return (int)cudaGetLastError();
}
