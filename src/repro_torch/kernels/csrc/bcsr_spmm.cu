// BCSR SpMM for Hopper (sm_90a): Y[br*b + i, c] = sum over the stored
// blocks p of block row br of sum_j data[p, i, j] * X[bc[p]*b + j, c],
// X (n_cols, B) and Y (n_rows, B) row-major.
//
// Replaces the TPU kernel repro/kernels/bcsr_spmv.py:bcsr_spmm, whose grid
// (row_tiles, k_blocks, slabs) contracts on-chip slabs of b x b tiles against
// (b, block_k) slices of an X padded to whole blocks ("pij,pjc->pic").  Here
// a group of `lanes` threads owns one (block row, column tile) pair and sits
// along the right-hand-side columns (PER columns a thread, grid.y walks
// column tiles of kt), as in csr_spmm.cu.  For each stored block it loads
// the b x kt slice of X row by row, coalesced along B, and keeps b x PER
// float32 accumulators in registers; the block's values are read by every
// lane of the group (one address per load: a broadcast).  Block rows are
// disjoint, so there are no atomics and the result is deterministic.  X is
// not padded: rows bc*b + j >= n_cols are masked, and rows of the last
// block row past n_rows are not written.  b = 4, 8 and 16 keep one block's
// accumulators in registers at once; any other b walks the block in chunks
// of 8 rows.
//
// Bound on an H100: bytes — nblocks * (b*b*val + 4) + 4 * (nbr + 1) for A,
// val * n_cols * B for X and 4 * n_rows * B for Y, over 3.35 TB/s, against
// 2 * nblocks * b*b * B flops at 67 TF/s (the explicit zeros of a block are
// multiplied too).  Each block gathers b X rows for its up to b*b entries,
// where CSR gathers one per entry.
#include "common.cuh"

template <typename TD, typename TX, int BS, int PER>
__global__ void bcsr_spmm_rows(const TD* __restrict__ data,
                               const int* __restrict__ block_cols,
                               const int* __restrict__ indptr,
                               const TX* __restrict__ x, float* __restrict__ y,
                               int n_rows, int n_cols, int B, int kt,
                               int lanes, int b_rt, int nbr) {
  constexpr int RC = BS > 0 ? BS : 8;  // rows of a block held at once
  const int b = BS > 0 ? BS : b_rt;
  const int lane = threadIdx.x % lanes;
  const long long br =
      (long long)blockIdx.x * (blockDim.x / lanes) + threadIdx.x / lanes;
  if (br >= nbr) return;
  const int k0 = blockIdx.y * kt;
  const int k_end = min(k0 + kt, B);
  const int start = indptr[br];
  const int end = indptr[br + 1];
  for (int r0 = 0; r0 < b; r0 += RC) {
    const int nr = min(RC, b - r0);
    float acc[RC][PER];
#pragma unroll
    for (int rr = 0; rr < RC; ++rr) {
#pragma unroll
      for (int i = 0; i < PER; ++i) acc[rr][i] = 0.f;
    }
    for (int p = start; p < end; ++p) {
      const long long c0 = (long long)block_cols[p] * b;
      const int jmax = (int)min((long long)b, n_cols - c0);
      const TD* blk = data + (long long)p * b * b + (long long)r0 * b;
      for (int j = 0; j < jmax; ++j) {
        const TX* xr = x + (c0 + j) * B;
        float xv[PER];
#pragma unroll
        for (int i = 0; i < PER; ++i) {
          const int c = k0 + lane + i * lanes;
          xv[i] = c < k_end ? to_f32<TX>(xr[c]) : 0.f;
        }
#pragma unroll
        for (int rr = 0; rr < RC; ++rr) {
          if (rr < nr) {
            const float d = to_f32<TD>(blk[rr * b + j]);
#pragma unroll
            for (int i = 0; i < PER; ++i) acc[rr][i] += d * xv[i];
          }
        }
      }
    }
#pragma unroll
    for (int rr = 0; rr < RC; ++rr) {
      const long long row = br * b + r0 + rr;
      if (rr < nr && row < n_rows) {
        float* yr = y + row * B;
#pragma unroll
        for (int i = 0; i < PER; ++i) {
          const int c = k0 + lane + i * lanes;
          if (c < k_end) yr[c] = acc[rr][i];
        }
      }
    }
  }
}

// block: b (>= 1); kt, lanes, per_lane as for ell_spmm_launch;
// rows_per_block: block-row groups per CUDA block (rows_per_block * lanes
// threads, a whole number of warps <= 1024).  The wrapper
// (kernels/bcsr_spmv.py) picks them.  Returns cudaGetLastError().
extern "C" int bcsr_spmm_launch(const void* data, const void* block_cols,
                                const void* indptr, const void* x, void* y,
                                int n_rows, int n_cols, int n_block_rows,
                                int block, int B, int kt, int lanes,
                                int per_lane, int rows_per_block,
                                int data_bf16, int x_bf16, void* stream) {
  if (n_rows <= 0 || B <= 0 || n_block_rows <= 0) return 0;
  const long long threads = (long long)rows_per_block * lanes;
  if (block < 1 || !valid_block(lanes, threads) ||
      !valid_rhs_tile(kt, lanes, per_lane)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((unsigned)(((long long)n_block_rows + rows_per_block - 1) /
                             rows_per_block),
                  (unsigned)((B + kt - 1) / kt));
#define LAUNCH_B(TD, TX, BS, P)                                              \
  bcsr_spmm_rows<TD, TX, BS, P><<<grid, (unsigned)threads, 0, s>>>(          \
      (const TD*)data, (const int*)block_cols, (const int*)indptr,           \
      (const TX*)x, (float*)y, n_rows, n_cols, B, kt, lanes, block,          \
      n_block_rows)
#define LAUNCH(TD, TX, P)                              \
  switch (block) {                                     \
    case 4: LAUNCH_B(TD, TX, 4, P); break;             \
    case 8: LAUNCH_B(TD, TX, 8, P); break;             \
    case 16: LAUNCH_B(TD, TX, 16, P); break;           \
    default: LAUNCH_B(TD, TX, 0, P); break;            \
  }
#define CALL(TD, TX) DISPATCH_PER_LANE(per_lane, LAUNCH, TD, TX)
  DISPATCH_VALUE_TYPES(data_bf16, x_bf16, CALL);
#undef CALL
#undef LAUNCH
#undef LAUNCH_B
  return (int)cudaGetLastError();
}
