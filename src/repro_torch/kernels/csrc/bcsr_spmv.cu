// BCSR SpMV for Hopper (sm_90a): y[br*b + i] = sum over the stored blocks p
// of block row br (IRP[br] <= p < IRP[br+1]) of
// sum_j data[p, i, j] * x[bc[p]*b + j].
//
// Replaces the TPU kernel repro/kernels/bcsr_spmv.py:bcsr_spmv, whose grid
// (block_row_tiles, slabs) streams on-chip slabs of whole b x b tiles under a
// static slab schedule and writes an (nbr * b,) strip that the caller
// slices to n_rows, after padding x to a multiple of b.  Here one thread
// owns one scalar row: the b threads of a block row walk its blocks as read
// from the block IRP at run time, each keeps its row's partial sum in a
// register and writes it straight into the (n_rows,) y.  Block rows are
// disjoint, so there are no atomics and the result is deterministic.  Rows
// of the last block row past n_rows have no thread; x is not padded: a
// column bc*b + j >= n_cols is masked (its block value is zero, but the
// read would fall past x).  The block offset p*b*b is taken in 64 bits.
// b is a run-time value; b = 4, 8 and 16 have unrolled instantiations.
//
// Bound on an H100: bytes — nblocks * (b*b*val + 4) for the blocks and
// their block columns, 4 * (nbr + 1) for IRP, val * n_cols for x and
// 4 * n_rows for y, over 3.35 TB/s (the b*b values of a block include its
// explicit zeros: bcsr_fill_ratio says how many).  The b threads of a block
// row read its tiles' consecutive rows, so a block's b*b values are read by
// neighbouring threads.
#include "common.cuh"

template <typename TD, typename TX, int BS>
__global__ void bcsr_spmv_rows(const TD* __restrict__ data,
                               const int* __restrict__ block_cols,
                               const int* __restrict__ indptr,
                               const TX* __restrict__ x,
                               float* __restrict__ y, int n_rows, int n_cols,
                               int b_rt) {
  const int b = BS > 0 ? BS : b_rt;
  const long long r = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (r >= n_rows) return;
  const long long br = r / b;
  const int i = (int)(r - br * b);
  const int start = indptr[br];
  const int end = indptr[br + 1];
  float acc = 0.f;
  for (int p = start; p < end; ++p) {
    const TD* row = data + ((long long)p * b + i) * b;
    const long long c0 = (long long)block_cols[p] * b;
    if (c0 + b <= n_cols) {
      if constexpr (BS > 0) {
#pragma unroll
        for (int j = 0; j < BS; ++j) {
          acc += to_f32<TD>(row[j]) * to_f32<TX>(x[c0 + j]);
        }
      } else {
        for (int j = 0; j < b; ++j) {
          acc += to_f32<TD>(row[j]) * to_f32<TX>(x[c0 + j]);
        }
      }
    } else {  // the ragged last block column
      for (int j = 0; c0 + j < n_cols; ++j) {
        acc += to_f32<TD>(row[j]) * to_f32<TX>(x[c0 + j]);
      }
    }
  }
  y[r] = acc;
}

// block: b (>= 1); threads: threads per block (a whole number of warps,
// <= 1024), one per scalar row.  The wrapper (kernels/bcsr_spmv.py) picks
// them.  Returns cudaGetLastError().
extern "C" int bcsr_spmv_launch(const void* data, const void* block_cols,
                                const void* indptr, const void* x, void* y,
                                int n_rows, int n_cols, int block, int threads,
                                int data_bf16, int x_bf16, void* stream) {
  if (n_rows <= 0) return 0;
  if (block < 1 || !valid_block(1, threads)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned grid =
      (unsigned)(((long long)n_rows + threads - 1) / threads);
#define LAUNCH(TD, TX, BS)                                                  \
  bcsr_spmv_rows<TD, TX, BS><<<grid, (unsigned)threads, 0, s>>>(            \
      (const TD*)data, (const int*)block_cols, (const int*)indptr,          \
      (const TX*)x, (float*)y, n_rows, n_cols, block)
#define CALL(TD, TX)                          \
  switch (block) {                            \
    case 4: LAUNCH(TD, TX, 4); break;         \
    case 8: LAUNCH(TD, TX, 8); break;         \
    case 16: LAUNCH(TD, TX, 16); break;       \
    default: LAUNCH(TD, TX, 0); break;        \
  }
  DISPATCH_VALUE_TYPES(data_bf16, x_bf16, CALL);
#undef CALL
#undef LAUNCH
  return (int)cudaGetLastError();
}
