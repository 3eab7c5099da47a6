// CCS SpMM for Hopper (sm_90a): Y[rows[k], b] += data[k] * X[c, b] for
// IRP_T[c] <= k < IRP_T[c+1], X (n_cols, B) and Y (n_rows, B) row-major.
//
// Replaces the TPU kernel repro/kernels/ccs_spmv.py:ccs_spmm, whose grid
// (k_blocks, col_blocks, slabs) accumulates into an (n_rows, block_k) panel
// held on chip.  Here a group of `lanes` threads owns a column and sits
// along the right-hand-side columns (grid.y walks column tiles of kt, each
// thread keeps PER columns in registers), as in csr_spmm.cu: the group
// loads its slice of the X row of its column once, keeps it in registers,
// walks the column's entries between IRP_T[c] and IRP_T[c+1] as read at run
// time (lane j loads entry e0 + j and the group shares it by shuffle), and
// adds each entry's kt contributions into Y with float32 atomicAdd on
// consecutive addresses of one Y row.  Y must be zero-filled by the caller.
// The order of the sum changes from run to run: compared to a tolerance.
//
// Bound on an H100: bytes — nnz * (val + 4) + 4 * (n_cols + 1) for A,
// val * n_cols * B for X and 4 * n_rows * B for Y, over 3.35 TB/s, against
// 2 * nnz * B flops at 67 TF/s; in practice the nnz * B atomics into Y,
// as for coo_spmm.cu.
#include "common.cuh"

template <typename TD, typename TX, int PER>
__global__ void ccs_spmm_columns(const TD* __restrict__ data,
                                 const int* __restrict__ rows,
                                 const int* __restrict__ indptr,
                                 const TX* __restrict__ x,
                                 float* __restrict__ y, int n_cols, int B,
                                 int kt, int lanes) {
  const int lane = threadIdx.x % lanes;
  const long long c =
      (long long)blockIdx.x * (blockDim.x / lanes) + threadIdx.x / lanes;
  if (c >= n_cols) return;  // the whole group leaves together
  const int start = indptr[c];
  const int end = indptr[c + 1];
  if (start == end) return;
  const unsigned mask = group_mask(lanes);
  const int k0 = blockIdx.y * kt;
  const int k_end = min(k0 + kt, B);
  const TX* xr = x + c * (long long)B;
  float xv[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int b = k0 + lane + i * lanes;
    xv[i] = b < k_end ? to_f32<TX>(xr[b]) : 0.f;
  }
  for (int e0 = start; e0 < end; e0 += lanes) {
    const int e = e0 + lane;
    float dv = 0.f;
    int rv = 0;
    if (e < end) {
      dv = to_f32<TD>(data[e]);
      rv = rows[e];
    }
    const int n = min(lanes, end - e0);
    for (int j = 0; j < n; ++j) {
      const float dj = __shfl_sync(mask, dv, j, lanes);
      const int rj = __shfl_sync(mask, rv, j, lanes);
      float* yr = y + (long long)rj * B;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int b = k0 + lane + i * lanes;
        if (b < k_end) atomicAdd(yr + b, dj * xv[i]);
      }
    }
  }
}

// kt, lanes, per_lane as for ell_spmm_launch; cols_per_block: column groups
// per block (cols_per_block * lanes threads, a whole number of warps
// <= 1024).  y must be zero-filled by the caller.  The wrapper
// (kernels/ccs_spmv.py) picks them.  Returns cudaGetLastError().
extern "C" int ccs_spmm_launch(const void* data, const void* rows,
                               const void* indptr, const void* x, void* y,
                               int n_cols, int B, int kt, int lanes,
                               int per_lane, int cols_per_block, int data_bf16,
                               int x_bf16, void* stream) {
  if (n_cols <= 0 || B <= 0) return 0;
  const long long threads = (long long)cols_per_block * lanes;
  if (!valid_block(lanes, threads) || !valid_rhs_tile(kt, lanes, per_lane)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(
      (unsigned)(((long long)n_cols + cols_per_block - 1) / cols_per_block),
      (unsigned)((B + kt - 1) / kt));
#define LAUNCH(TD, TX, P)                                                    \
  ccs_spmm_columns<TD, TX, P><<<grid, (unsigned)threads, 0, s>>>(            \
      (const TD*)data, (const int*)rows, (const int*)indptr, (const TX*)x,   \
      (float*)y, n_cols, B, kt, lanes)
#define CALL(TD, TX) DISPATCH_PER_LANE(per_lane, LAUNCH, TD, TX)
  DISPATCH_VALUE_TYPES(data_bf16, x_bf16, CALL);
#undef CALL
#undef LAUNCH
  return (int)cudaGetLastError();
}
