// COO SpMM for Hopper (sm_90a): Y[rows[k], b] += data[k] * X[cols[k], b] for
// entries in any order, X (n_cols, B) and Y (n_rows, B) row-major.
//
// Replaces the TPU kernel repro/kernels/coo_spmv.py:coo_spmm, which walks the
// nnz slabs sequentially into a Y panel held on chip.  Blocks here run in no
// order, so contributions meet in global memory: one thread per (entry,
// column) adds with float32 atomicAdd into a zero-filled Y.  The B atomics of
// one entry go to B distinct consecutive addresses, so a warp's atomics
// coalesce.  The summation order, and so the last bits, change from run to
// run: results are compared to a tolerance.  Pads (0, 0, 0.0) add 0 to row 0.
//
// Layout: each block owns a contiguous run of block_nnz entries; a group of
// `lanes` threads sits along the right-hand-side columns (PER columns per
// thread, grid.y walks column tiles of kt), takes `lanes` entries at a time
// with one coalesced load per stream, and shares them by shuffle.
//
// Bound on an H100: bytes — nnz * (val + 8) for the three streams,
// val * n_cols * B for X and 4 * n_rows * B for Y, over 3.35 TB/s, against
// 2 * nnz * B flops at 67 TF/s; in practice also the atomic throughput of L2
// where many entries share a row.
#include "common.cuh"

template <typename TD, typename TX, int PER>
__global__ void coo_spmm_atomic(const TD* __restrict__ data,
                                const int* __restrict__ rows,
                                const int* __restrict__ cols,
                                const TX* __restrict__ x,
                                float* __restrict__ y, long long nnz, int B,
                                int kt, int lanes, int block_nnz) {
  const int lane = threadIdx.x % lanes;
  const int group = threadIdx.x / lanes;
  const int n_groups = blockDim.x / lanes;
  const unsigned mask = group_mask(lanes);
  const long long base = blockIdx.x * (long long)block_nnz;
  long long end = base + block_nnz;
  if (end > nnz) end = nnz;
  const int k0 = blockIdx.y * kt;
  const int k_end = min(k0 + kt, B);
  for (long long e0 = base + (long long)group * lanes; e0 < end;
       e0 += (long long)n_groups * lanes) {
    const long long e = e0 + lane;
    float dv = 0.f;
    int rv = 0, cv = 0;
    if (e < end) {
      dv = to_f32<TD>(data[e]);
      rv = rows[e];
      cv = cols[e];
    }
    const int n = (int)min((long long)lanes, end - e0);
    for (int j = 0; j < n; ++j) {
      const float dj = __shfl_sync(mask, dv, j, lanes);
      const int rj = __shfl_sync(mask, rv, j, lanes);
      const int cj = __shfl_sync(mask, cv, j, lanes);
      const TX* xr = x + (long long)cj * B;
      float* yr = y + (long long)rj * B;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int b = k0 + lane + i * lanes;
        if (b < k_end) atomicAdd(yr + b, dj * to_f32<TX>(xr[b]));
      }
    }
  }
}

// kt, lanes, per_lane as for ell_spmm_launch; threads: threads per block (a
// whole number of warps, <= 1024); block_nnz: entries per block.  y must be
// zero-filled by the caller.  The wrapper (kernels/coo_spmv.py) picks them.
// Returns cudaGetLastError().
extern "C" int coo_spmm_launch(const void* data, const void* rows,
                               const void* cols, const void* x, void* y,
                               long long nnz, int B, int kt, int lanes,
                               int per_lane, int threads, int block_nnz,
                               int data_bf16, int x_bf16, void* stream) {
  if (nnz <= 0 || B <= 0) return 0;
  if (!valid_block(lanes, threads) || !valid_rhs_tile(kt, lanes, per_lane) ||
      block_nnz < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((unsigned)((nnz + block_nnz - 1) / block_nnz),
                  (unsigned)((B + kt - 1) / kt));
#define LAUNCH(TD, TX, P)                                                   \
  coo_spmm_atomic<TD, TX, P><<<grid, threads, 0, s>>>(                      \
      (const TD*)data, (const int*)rows, (const int*)cols, (const TX*)x,    \
      (float*)y, nnz, B, kt, lanes, block_nnz)
#define CALL(TD, TX) DISPATCH_PER_LANE(per_lane, LAUNCH, TD, TX)
  DISPATCH_VALUE_TYPES(data_bf16, x_bf16, CALL);
#undef CALL
#undef LAUNCH
  return (int)cudaGetLastError();
}
