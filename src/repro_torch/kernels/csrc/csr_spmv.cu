// CSR SpMV for Hopper (sm_90a): y[r] = sum_{k in [IRP[r], IRP[r+1])}
// data[k] * x[cols[k]].
//
// CSR-vector: a group of LANES lanes (a whole warp for long rows, a part of
// one for short rows) owns a row, strides over its entries as read from IRP
// at run time, reduces with warp shuffles, and lane 0 stores.  The loop
// bounds come from memory, so no static bound on a row's length is needed
// and heavy-tail rows are simply a longer loop for their group.  Entries
// past IRP[n_rows] are never read.  Memory-bound: VAL/ICOL are streamed once
// (coalesced within a group), x is gathered through L2.
#include "common.cuh"

template <typename TD, typename TX, int LANES>
__global__ void csr_spmv_vector(const TD* __restrict__ data,
                                const int* __restrict__ cols,
                                const int* __restrict__ indptr,
                                const TX* __restrict__ x,
                                float* __restrict__ y, int n_rows) {
  const int lane = threadIdx.x % LANES;
  const long long r =
      (blockIdx.x * (long long)blockDim.x + threadIdx.x) / LANES;
  float acc = 0.f;
  if (r < n_rows) {
    const int start = indptr[r];
    const int end = indptr[r + 1];
    for (int k = start + lane; k < end; k += LANES) {
      acc += to_f32<TD>(data[k]) * to_f32<TX>(x[cols[k]]);
    }
  }
  // every thread of the warp takes part; groups of LANES reduce separately
  for (int off = LANES / 2; off > 0; off >>= 1) {
    acc += __shfl_down_sync(0xffffffffu, acc, off, LANES);
  }
  if (r < n_rows && lane == 0) y[r] = acc;
}

// lanes: lanes per row, one of 2, 4, 8, 16, 32.  block_rows: rows per CUDA
// block (0 = default).  Returns cudaGetLastError().
extern "C" int csr_spmv_launch(const void* data, const void* cols,
                               const void* indptr, const void* x, void* y,
                               int n_rows, int lanes, int data_bf16,
                               int x_bf16, int block_rows, void* stream) {
  if (n_rows <= 0) return 0;
  if (lanes != 2 && lanes != 4 && lanes != 8 && lanes != 16 && lanes != 32) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const int threads =
      clamp_threads(block_rows > 0 ? (long long)block_rows * lanes : 256);
  const int rows_per_block = threads / lanes;
  const unsigned grid =
      (unsigned)(((long long)n_rows + rows_per_block - 1) / rows_per_block);
#define LAUNCH(TD, TX, L)                                                  \
  csr_spmv_vector<TD, TX, L><<<grid, threads, 0, s>>>(                     \
      (const TD*)data, (const int*)cols, (const int*)indptr, (const TX*)x, \
      (float*)y, n_rows)
#define CALL(TD, TX)                  \
  switch (lanes) {                    \
    case 2: LAUNCH(TD, TX, 2); break; \
    case 4: LAUNCH(TD, TX, 4); break; \
    case 8: LAUNCH(TD, TX, 8); break; \
    case 16: LAUNCH(TD, TX, 16); break; \
    default: LAUNCH(TD, TX, 32); break; \
  }
  DISPATCH_VALUE_TYPES(data_bf16, x_bf16, CALL);
#undef CALL
#undef LAUNCH
  return (int)cudaGetLastError();
}
