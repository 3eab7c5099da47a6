// ELL SpMV for Hopper (sm_90a): y[r] = sum_w data[r, w] * x[cols[r, w]].
//
// The panel is addressed through (row_stride, col_stride) in elements, so the
// same entry point serves ELL-Row storage (n_rows, width), ELL-Col storage
// (width, n_rows) viewed transposed, and SELL buckets, with no transpose copy.
// Padded slots hold (val 0, col 0) and add zero.  Accumulation is float32 in a
// register; one store per row.  Memory-bound: each panel byte is read once,
// x is gathered through L2.
//
//  * lanes == 1: one thread per row, correct for any strides.  For
//    row_stride == 1 (ELL-Col) consecutive threads read consecutive addresses
//    at every band step, so panel loads coalesce.
//  * lanes > 1 (col_stride == 1, ELL-Row): LANES lanes per row stride along
//    the band so that a group reads one contiguous run, then a shuffle
//    reduction.
// The wrapper (kernels/ell_spmv.py, through kernels/_common.py) picks the
// lanes from the strides and the band width.
#include "common.cuh"

template <typename TD, typename TX>
__global__ void ell_spmv_thread_per_row(const TD* __restrict__ data,
                                        const int* __restrict__ cols,
                                        const TX* __restrict__ x,
                                        float* __restrict__ y, int n_rows,
                                        int width, long long row_stride,
                                        long long col_stride) {
  const long long r = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (r >= n_rows) return;
  const TD* d = data + r * row_stride;
  const int* c = cols + r * row_stride;
  float acc = 0.f;
  for (int w = 0; w < width; ++w) {
    const long long o = w * col_stride;
    acc += to_f32<TD>(d[o]) * to_f32<TX>(x[c[o]]);
  }
  y[r] = acc;
}

template <typename TD, typename TX, int LANES>
__global__ void ell_spmv_lanes_per_row(const TD* __restrict__ data,
                                       const int* __restrict__ cols,
                                       const TX* __restrict__ x,
                                       float* __restrict__ y, int n_rows,
                                       int width, long long row_stride) {
  const int lane = threadIdx.x % LANES;
  const long long r =
      (blockIdx.x * (long long)blockDim.x + threadIdx.x) / LANES;
  float acc = 0.f;
  if (r < n_rows) {
    const TD* d = data + r * row_stride;
    const int* c = cols + r * row_stride;
    for (int w = lane; w < width; w += LANES) {
      acc += to_f32<TD>(d[w]) * to_f32<TX>(x[c[w]]);
    }
  }
  // every thread of the warp takes part; groups of LANES reduce separately
  for (int off = LANES / 2; off > 0; off >>= 1) {
    acc += __shfl_down_sync(0xffffffffu, acc, off, LANES);
  }
  if (r < n_rows && lane == 0) y[r] = acc;
}

// lanes: threads per row, 1 or a power of two in [2, 32] (then col_stride
// must be 1); rows_per_block * lanes: threads per block (a whole number of
// warps, <= 1024).  Returns cudaGetLastError().
extern "C" int ell_spmv_launch(const void* data, const void* cols,
                               const void* x, void* y, int n_rows, int width,
                               long long row_stride, long long col_stride,
                               int lanes, int rows_per_block, int data_bf16,
                               int x_bf16, void* stream) {
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
  ell_spmv_thread_per_row<TD, TX><<<grid, (unsigned)threads, 0, s>>>(       \
      (const TD*)data, (const int*)cols, (const TX*)x, (float*)y, n_rows,   \
      width, row_stride, col_stride)
    DISPATCH_VALUE_TYPES(data_bf16, x_bf16, CALL);
#undef CALL
  } else {
#define LAUNCH(TD, TX, L)                                                   \
  ell_spmv_lanes_per_row<TD, TX, L><<<grid, (unsigned)threads, 0, s>>>(     \
      (const TD*)data, (const int*)cols, (const TX*)x, (float*)y, n_rows,   \
      width, row_stride)
#define CALL(TD, TX) DISPATCH_LANES(lanes, LAUNCH, TD, TX)
    DISPATCH_VALUE_TYPES(data_bf16, x_bf16, CALL);
#undef CALL
#undef LAUNCH
  }
  return (int)cudaGetLastError();
}
