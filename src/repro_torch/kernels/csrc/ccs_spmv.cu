// CCS SpMV for Hopper (sm_90a): y[rows[k]] += data[k] * x[c] for
// IRP_T[c] <= k < IRP_T[c+1].
//
// Replaces the TPU kernel repro/kernels/ccs_spmv.py:ccs_spmv, whose grid
// (col_blocks, slabs) walks a static slab schedule over a (block_cols,) x
// tile and keeps the whole (n_rows,) y resident on chip.  Here a group of
// `lanes` lanes owns a column: it reads x[c] once, walks the column's
// entries between IRP_T[c] and IRP_T[c+1] as read at run time (no slab
// schedule, so a dense column is just a longer loop for its group), and adds
// each contribution into y with a float32 atomicAdd — columns scatter to
// arbitrary rows and blocks run in no order, so they meet in global memory.
// y must be zero-filled by the caller.  Slots past IRP_T[n_cols] (pads of
// (0, row 0)) are never read.  The atomics make the order of the sum, and so
// the last bits, change from run to run: results are compared to a
// tolerance.
//
// Bound on an H100: bytes — nnz * (val + 4) for VAL/IROW,
// 4 * (n_cols + 1) for IRP_T, val * n_cols for x and 4 * n_rows for y, over
// 3.35 TB/s; in practice also L2's atomic throughput where many entries
// share a row.  VAL/IROW are read once, coalesced within a group.
#include "common.cuh"

template <typename TD, typename TX>
__global__ void ccs_spmv_columns(const TD* __restrict__ data,
                                 const int* __restrict__ rows,
                                 const int* __restrict__ indptr,
                                 const TX* __restrict__ x,
                                 float* __restrict__ y, int n_cols,
                                 int lanes) {
  const int lane = threadIdx.x % lanes;
  const long long c =
      (blockIdx.x * (long long)blockDim.x + threadIdx.x) / lanes;
  if (c >= n_cols) return;
  const int start = indptr[c];
  const int end = indptr[c + 1];
  if (start == end) return;
  const float xc = to_f32<TX>(x[c]);
  for (int k = start + lane; k < end; k += lanes) {
    atomicAdd(y + rows[k], to_f32<TD>(data[k]) * xc);
  }
}

// lanes: lanes per column, a power of two in [2, 32]; cols_per_block * lanes:
// threads per block (a whole number of warps, <= 1024).  y must be
// zero-filled by the caller.  The wrapper (kernels/ccs_spmv.py) picks them.
// Returns cudaGetLastError().
extern "C" int ccs_spmv_launch(const void* data, const void* rows,
                               const void* indptr, const void* x, void* y,
                               int n_cols, int lanes, int cols_per_block,
                               int data_bf16, int x_bf16, void* stream) {
  if (n_cols <= 0) return 0;
  const long long threads = (long long)cols_per_block * lanes;
  if (!valid_block(lanes, threads) || lanes < 2) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned grid =
      (unsigned)(((long long)n_cols + cols_per_block - 1) / cols_per_block);
#define CALL(TD, TX)                                                     \
  ccs_spmv_columns<TD, TX><<<grid, (unsigned)threads, 0, s>>>(           \
      (const TD*)data, (const int*)rows, (const int*)indptr, (const TX*)x, \
      (float*)y, n_cols, lanes)
  DISPATCH_VALUE_TYPES(data_bf16, x_bf16, CALL);
#undef CALL
  return (int)cudaGetLastError();
}
