// COO SpMM for Hopper (sm_90a): Y[rows[k], b] += data[k] * X[cols[k], b] for
// entries in any order, X (n_cols, B) and Y (n_rows, B) row-major.
//
// Replaces the TPU kernel repro/kernels/coo_spmv.py:coo_spmm, which walks the
// nnz slabs sequentially into a Y panel held on chip.  Blocks here run in no
// order, so partial rows meet in global memory through float32 atomics into a
// zero-filled Y; the design keeps a row's partial sum on the chip for as long
// as its entries keep coming.
//
// Layout: each block owns a contiguous run of block_nnz entries, cut into one
// sub-run of `run` consecutive entries per group of `lanes` threads.  The
// group sits along the right-hand-side columns (PER columns per thread,
// grid.y walks column tiles of kt), walks its sub-run in order, loads `lanes`
// entries at a time with one coalesced load per stream and shares them by
// shuffle, and keeps Y[row, tile] in registers while the row does not change.
// When the row changes, and at the end of the sub-run, it flushes with one
// atomicAdd per (run, column).  Where B allows, a thread's PER columns are
// consecutive, so an entry's X row is one 16-byte load a thread (float32,
// PER = 4) and a flush one float4 atomic (sm_90); otherwise each column is
// one coalesced scalar access.  Sorted rows give about one flush per row plus
// one per sub-run, where a thread per (entry, column) issued one atomic per
// entry; in any order the sum is the same and unsorted entries just flush
// more often.  The summation order, and so the last bits, change from run to
// run: results are compared to a tolerance.  Pads (0, 0, 0.0) add 0 to row
// 0.  Interior runs are still flushed with atomics: the kernel is not told
// whether the rows are sorted.
//
// Bound on an H100: bytes — nnz * (val + 8) for the three streams,
// val * n_cols * B for X and 4 * n_rows * B for Y, over 3.35 TB/s, against
// 2 * nnz * B flops at 67 TF/s.  As for CSR, X is gathered row by row and its
// reuse through L2 depends on the matrix's column locality.
#include "common.cuh"

// VEC: a thread's PER columns are consecutive, k0 + lane * PER + i, and are
// read and added as one vector (the entry point checks B, kt and the
// pointers); otherwise they are k0 + lane + i * lanes, one coalesced scalar
// access per column.  U: entries whose X rows are gathered together (U * PER
// loads in flight a thread), at most the group's width.
template <typename TD, typename TX, int PER, bool VEC, int U>
__global__ void coo_spmm_runs(const TD* __restrict__ data,
                              const int* __restrict__ rows,
                              const int* __restrict__ cols,
                              const TX* __restrict__ x,
                              float* __restrict__ y, long long nnz, int B,
                              int kt, int lanes, int block_nnz, int run) {
  const int lane = threadIdx.x % lanes;
  const int group = threadIdx.x / lanes;
  const unsigned mask = group_mask(lanes);
  const long long base = blockIdx.x * (long long)block_nnz;
  const long long start = base + (long long)group * run;
  const long long stop =
      min(start + run, min(base + (long long)block_nnz, nnz));
  const int k0 = blockIdx.y * kt;
  const int k_end = min(k0 + kt, B);
  const int b0 = VEC ? k0 + lane * PER : k0 + lane;
  const int stride = VEC ? 1 : lanes;  // from one of its columns to the next
  float acc[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) acc[i] = 0.f;
  int cur = -1;  // the row acc holds; -1 before the first entry
  auto flush = [&]() {
    if (cur < 0) return;
    float* yr = y + (long long)cur * B + b0;
    if (VEC) {
      if (b0 < k_end) add_row<PER>(yr, acc);
    } else {
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        if (b0 + i * stride < k_end) atomicAdd(yr + i * stride, acc[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < PER; ++i) acc[i] = 0.f;
  };
  // the loops are uniform over the group: its lanes shuffle together
  for (long long e0 = start; e0 < stop; e0 += lanes) {
    const long long e = e0 + lane;
    float dv = 0.f;
    int rv = -1, cv = 0;
    if (e < stop) {
      dv = to_f32<TD>(data[e]);
      rv = __ldcs(rows + e);
      cv = __ldcs(cols + e);
    }
    const int n = (int)min((long long)lanes, stop - e0);
    for (int j0 = 0; j0 < n; j0 += U) {
      float dj[U], xv[U][PER];
      int rj[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        // j past the group's width wraps to another lane: masked by j < n
        const int j = j0 + u;
        dj[u] = __shfl_sync(mask, dv, j, lanes);
        rj[u] = __shfl_sync(mask, rv, j, lanes);
        const int cj = __shfl_sync(mask, cv, j, lanes);
        const TX* xr = x + (long long)cj * B + b0;
        if (VEC) {
          if (j < n && b0 < k_end) {
            load_row<PER>(xr, xv[u]);
          } else {
#pragma unroll
            for (int i = 0; i < PER; ++i) xv[u][i] = 0.f;
          }
        } else {
#pragma unroll
          for (int i = 0; i < PER; ++i) {
            xv[u][i] = j < n && b0 + i * stride < k_end
                           ? to_f32<TX>(xr[i * stride])
                           : 0.f;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (j0 + u < n) {
          if (rj[u] != cur) {
            flush();
            cur = rj[u];
          }
#pragma unroll
          for (int i = 0; i < PER; ++i) acc[i] += dj[u] * xv[u][i];
        }
      }
    }
  }
  flush();
}

// kt, lanes, per_lane as for ell_spmm_launch; threads: threads per block (a
// whole number of warps, <= 1024); block_nnz: entries per block; run:
// entries per group (threads / lanes groups must cover block_nnz).  y must be
// zero-filled by the caller.  The wrapper (kernels/coo_spmv.py) picks them.
// Returns cudaGetLastError().
extern "C" int coo_spmm_launch(const void* data, const void* rows,
                               const void* cols, const void* x, void* y,
                               long long nnz, int B, int kt, int lanes,
                               int per_lane, int threads, int block_nnz,
                               int run, int data_bf16, int x_bf16,
                               void* stream) {
  if (nnz <= 0 || B <= 0) return 0;
  if (!valid_block(lanes, threads) || !valid_rhs_tile(kt, lanes, per_lane) ||
      block_nnz < 1 || run < 1 ||
      (long long)run * (threads / lanes) < block_nnz) {
    return (int)cudaErrorInvalidValue;
  }
  // one vector per thread and row: B and the tile hold whole vectors and
  // the panels are aligned to them
  const int vec_bytes = per_lane * (x_bf16 ? 2 : 4);
  const bool vec = per_lane > 1 && B % per_lane == 0 && kt % per_lane == 0 &&
                   (std::uintptr_t)x % vec_bytes == 0 &&
                   (std::uintptr_t)y % (per_lane * 4) == 0;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((unsigned)((nnz + block_nnz - 1) / block_nnz),
                  (unsigned)((B + kt - 1) / kt));
#define LAUNCH(TD, TX, P, V, U)                                             \
  coo_spmm_runs<TD, TX, P, V, U><<<grid, threads, 0, s>>>(                  \
      (const TD*)data, (const int*)rows, (const int*)cols, (const TX*)x,    \
      (float*)y, nnz, B, kt, lanes, block_nnz, run)
  // four X loads in flight a thread: 4 entries of one column, 2 of two, 1 of
  // four (one vector); a thread alone on its row loads one entry at a time
#define CALL(TD, TX)                    \
  switch (per_lane) {                   \
    case 1:                             \
      if (lanes == 1) {                 \
        LAUNCH(TD, TX, 1, false, 1);    \
      } else {                          \
        LAUNCH(TD, TX, 1, false, 4);    \
      }                                 \
      break;                            \
    case 2:                             \
      if (vec) {                        \
        LAUNCH(TD, TX, 2, true, 2);     \
      } else {                          \
        LAUNCH(TD, TX, 2, false, 2);    \
      }                                 \
      break;                            \
    case 4:                             \
      if (vec) {                        \
        LAUNCH(TD, TX, 4, true, 1);     \
      } else {                          \
        LAUNCH(TD, TX, 4, false, 1);    \
      }                                 \
      break;                            \
    default:                            \
      return (int)cudaErrorInvalidValue; \
  }
  DISPATCH_VALUE_TYPES(data_bf16, x_bf16, CALL);
#undef CALL
#undef LAUNCH
  return (int)cudaGetLastError();
}
