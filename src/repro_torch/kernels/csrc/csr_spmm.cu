// CSR SpMM for Hopper (sm_90a): Y[r, b] = sum_{k in [IRP[r], IRP[r+1])}
// data[k] * X[cols[k], b], X (n_cols, B) and Y (n_rows, B) row-major.
//
// Replaces the TPU kernel repro/kernels/csr_spmv.py:csr_spmm, whose grid
// (row_blocks, k_blocks, slabs) walks a static slab schedule because a TPU
// grid is fixed before the run.  Here a row's bounds are read from IRP at run
// time, so a heavy-tail row is a longer loop for its group and slots past
// IRP[n_rows] are never read.
//
// Layout as in ell_spmm.cu: a group of `lanes` threads owns a row and sits
// along the right-hand-side columns (coalesced X gathers and Y stores), each
// thread keeps PER columns in registers, grid.y walks column tiles of kt.
// The group reads VAL/ICOL once: lane j loads entry k0 + j and the group
// shares it by shuffle (the loop bounds are the same for the whole group, so
// each group shuffles on its own mask).
//
// Bound on an H100: bytes — nnz * (val + 4) + 4 * (n_rows + 1) for A,
// val * n_cols * B for X, 4 * n_rows * B for Y, over 3.35 TB/s, against
// 2 * nnz * B flops at 67 TF/s.  As for ELL, X is gathered row by row and its
// reuse through L2 depends on the matrix's column locality.
#include "common.cuh"

template <typename TD, typename TX, int PER>
__global__ void csr_spmm_rows(const TD* __restrict__ data,
                              const int* __restrict__ cols,
                              const int* __restrict__ indptr,
                              const TX* __restrict__ x, float* __restrict__ y,
                              int n_rows, int B, int kt, int lanes) {
  const int lane = threadIdx.x % lanes;
  const long long r =
      (long long)blockIdx.x * (blockDim.x / lanes) + threadIdx.x / lanes;
  if (r >= n_rows) return;  // the whole group leaves together
  const unsigned mask = group_mask(lanes);
  const int k0 = blockIdx.y * kt;
  const int k_end = min(k0 + kt, B);
  const int start = indptr[r];
  const int end = indptr[r + 1];
  float acc[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) acc[i] = 0.f;
  for (int e0 = start; e0 < end; e0 += lanes) {
    const int e = e0 + lane;
    float dv = 0.f;
    int cv = 0;
    if (e < end) {
      dv = to_f32<TD>(data[e]);
      cv = cols[e];
    }
    const int n = min(lanes, end - e0);
    for (int j = 0; j < n; ++j) {
      const float dj = __shfl_sync(mask, dv, j, lanes);
      const int cj = __shfl_sync(mask, cv, j, lanes);
      const TX* xr = x + (long long)cj * B;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int b = k0 + lane + i * lanes;
        if (b < k_end) acc[i] += dj * to_f32<TX>(xr[b]);
      }
    }
  }
  float* yr = y + r * (long long)B;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int b = k0 + lane + i * lanes;
    if (b < k_end) yr[b] = acc[i];
  }
}

// Launch parameters as for ell_spmm_launch (the wrapper in
// kernels/csr_spmv.py picks them).  Returns cudaGetLastError().
extern "C" int csr_spmm_launch(const void* data, const void* cols,
                               const void* indptr, const void* x, void* y,
                               int n_rows, int B, int kt, int lanes,
                               int per_lane, int rows_per_block, int data_bf16,
                               int x_bf16, void* stream) {
  if (n_rows <= 0 || B <= 0) return 0;
  const long long threads = (long long)rows_per_block * lanes;
  if (!valid_block(lanes, threads) || !valid_rhs_tile(kt, lanes, per_lane)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(
      (unsigned)(((long long)n_rows + rows_per_block - 1) / rows_per_block),
      (unsigned)((B + kt - 1) / kt));
#define LAUNCH(TD, TX, P)                                                  \
  csr_spmm_rows<TD, TX, P><<<grid, (unsigned)threads, 0, s>>>(             \
      (const TD*)data, (const int*)cols, (const int*)indptr, (const TX*)x, \
      (float*)y, n_rows, B, kt, lanes)
#define CALL(TD, TX) DISPATCH_PER_LANE(per_lane, LAUNCH, TD, TX)
  DISPATCH_VALUE_TYPES(data_bf16, x_bf16, CALL);
#undef CALL
#undef LAUNCH
  return (int)cudaGetLastError();
}
