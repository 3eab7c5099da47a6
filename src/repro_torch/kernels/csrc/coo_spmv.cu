// COO SpMV for Hopper (sm_90a): y[rows[k]] += data[k] * x[cols[k]] for
// entries in any order.
//
// One thread per stored entry; each block owns a contiguous run of
// `block_nnz` entries and its threads stride over it, so VAL/IROW/ICOL loads
// coalesce.  Contributions meet in global memory through float32 atomicAdd,
// which is why the caller hands in a zero-filled y and why the sum order
// (and the last bits of the result) change from run to run.  Padded entries
// are (row 0, col 0, val 0.0) and add 0.0 to y[0].  Memory-bound on the
// three streams, then on atomic throughput where many entries share a row.
#include "common.cuh"

template <typename TD, typename TX>
__global__ void coo_spmv_atomic(const TD* __restrict__ data,
                                const int* __restrict__ rows,
                                const int* __restrict__ cols,
                                const TX* __restrict__ x,
                                float* __restrict__ y, long long nnz,
                                int block_nnz) {
  const long long base = blockIdx.x * (long long)block_nnz;
  long long end = base + block_nnz;
  if (end > nnz) end = nnz;
  for (long long k = base + threadIdx.x; k < end; k += blockDim.x) {
    atomicAdd(y + rows[k], to_f32<TD>(data[k]) * to_f32<TX>(x[cols[k]]));
  }
}

// threads: threads per block (a whole number of warps, <= 1024); block_nnz:
// entries per block.  The wrapper (kernels/coo_spmv.py) picks them.  y must
// be zero-filled by the caller.  Returns cudaGetLastError().
extern "C" int coo_spmv_launch(const void* data, const void* rows,
                               const void* cols, const void* x, void* y,
                               long long nnz, int threads, int block_nnz,
                               int data_bf16, int x_bf16, void* stream) {
  if (nnz <= 0) return 0;
  if (!valid_block(1, threads) || block_nnz < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned grid = (unsigned)((nnz + block_nnz - 1) / block_nnz);
#define CALL(TD, TX)                                                      \
  coo_spmv_atomic<TD, TX><<<grid, threads, 0, s>>>(                       \
      (const TD*)data, (const int*)rows, (const int*)cols, (const TX*)x,  \
      (float*)y, nnz, block_nnz)
  DISPATCH_VALUE_TYPES(data_bf16, x_bf16, CALL);
#undef CALL
  return (int)cudaGetLastError();
}
