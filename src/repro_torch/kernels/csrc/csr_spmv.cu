// CSR SpMV for Hopper (sm_90a): y[r] = sum_{k in [IRP[r], IRP[r+1])}
// data[k] * x[cols[k]], the same bits from run to run.
//
// Replaces the TPU kernel repro/kernels/csr_spmv.py:csr_spmv, whose grid
// walks row blocks and their slabs of entries in order.  Here the work is cut
// by entries, not by rows, so a row of thousands of entries costs what as
// many short rows cost (merge-path style), in three kernels:
//
//  1. csr_spmv_bounds — one warp a slice boundary finds, by a 32-way search
//     over IRP, the first row that starts at or past it; slice b owns the
//     rows [row_start[b], row_start[b+1]) (those whose first entry lies in
//     it; the last slice also owns the empty rows at the end).
//  2. csr_spmv_slices — each block owns a slice of block_nnz entries.  Its
//     threads request their first CHUNK (4 or 8) consecutive entries at once,
//     with 16-byte cache-streaming loads where the pointers allow, gather x
//     and find each entry's row by a binary search over IRP between the
//     slice's bounds (a few cache lines, read through L1).  A row
//     begun and ended inside a chunk is stored at once.  The rows that cross
//     chunks meet in a segmented inclusive scan over the warp keyed by row (5
//     shuffle steps); the lane that ends a row inside the warp's span stores
//     it.  The first and last rows of each warp's span go to shared memory,
//     where warp 0 joins them across the block by the same scan and stores
//     each finished row.  Every store is a plain store: no atomics.
//  3. csr_spmv_carry — a row that crosses a slice's edge is stored by the
//     slice it starts in, over that slice's entries; every later slice that
//     it spans leaves its partial sum (and the row) in a carry buffer.  One
//     thread per chain of carries adds them, in slice order, to y.
//
// So every sum is taken in an order fixed by the launch shape alone, and y
// is bit for bit the same in every run (CSR is held to that; only COO and
// CCS, whose kernels meet through atomics, are held to a tolerance).  No
// bound on a row's length is needed: a row spans as many slices as it has
// entries.  Empty rows are written 0 by the slice that owns them.  No entry
// past IRP[n_rows] is used (the first pass's loads may reach up to nnz_pad).
//
// Bound on an H100: bytes — nnz * (val + 4) for the two streams,
// 4 * (n_rows + 1) for IRP, val * n_cols for x and 4 * n_rows for y, over
// 3.35 TB/s; the slices' bounds and carries are 12 bytes a slice.
#include "common.cuh"

#define CSR_MAX_WARPS 32

// The first i in [lo, hi] with ip[i] >= key, given that ip is ascending and
// ip[hi] >= key, found by the calling warp: each round tests the last entry
// of 32 equal buckets of [lo, hi) and keeps the first bucket that reaches
// key, so n rows take about log32(n) rounds of one load a lane.
__device__ __forceinline__ int warp_lower_bound(const int* ip, int lo, int hi,
                                                int key) {
  const int lane = threadIdx.x % 32;
  while (lo < hi) {
    const int step = (hi - lo + 31) / 32;
    const int first = lo + lane * step;
    const bool reach = first < hi && ip[min(first + step, hi) - 1] >= key;
    const unsigned m = __ballot_sync(0xffffffffu, reach);
    if (m == 0) return hi;
    const int f = lo + (__ffs(m) - 1) * step;
    hi = min(f + step, hi) - 1;
    lo = f;
  }
  return lo;
}

// One warp a slice boundary: row_start[b] is the first row whose first entry
// lies at or past b * block_nnz (0 for b = 0, n_rows past the last entry), so
// slice b owns rows [row_start[b], row_start[b + 1]).
__global__ void csr_spmv_bounds(const int* __restrict__ indptr,
                                int* __restrict__ row_start, int n_rows,
                                int n_slices, int block_nnz) {
  const long long b =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  if (b > n_slices) return;  // the whole warp leaves together
  const int nnz = indptr[n_rows];
  const long long s = b * block_nnz;
  const int r = b == 0 ? 0
                : s >= nnz ? n_rows
                           : warp_lower_bound(indptr, 0, n_rows, (int)s);
  if (threadIdx.x % 32 == 0) row_start[b] = r;
}

// VEC: every chunk's first entry is aligned for load_chunk (the entry point
// checks the pointers and block_nnz).
template <typename TD, typename TX, int CHUNK, bool VEC>
__global__ void __launch_bounds__(1024)
    csr_spmv_slices(const TD* __restrict__ data, const int* __restrict__ cols,
                    const int* __restrict__ indptr, const TX* __restrict__ x,
                    float* __restrict__ y, const int* __restrict__ row_start,
                    int* __restrict__ carry_row, float* __restrict__ carry_val,
                    int n_rows, int nnz_pad, int block_nnz) {
  constexpr unsigned FULL = 0xffffffffu;
  constexpr int SPAN = 32 * CHUNK;  // entries a warp takes at a time
  // per pass (two, alternating): the first and last row of each warp's span
  // and its sums there; row -1: the span is one row
  __shared__ int seg_row[2][2 * CSR_MAX_WARPS];
  __shared__ float seg_val[2][2 * CSR_MAX_WARPS];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int warps = blockDim.x / 32;
  const int slice = blockIdx.x;
  const long long s0l = (long long)slice * block_nnz;
  // the first pass's entries are requested before anything else, so their
  // latency runs alongside that of the bounds (slots up to nnz_pad are
  // memory of the arrays; none past IRP[n_rows] is used)
  int c[CHUNK];
  float d[CHUNK];
  auto load = [&](long long k, long long stop) {
    const int n = (int)max(0LL, min((long long)CHUNK, stop - k));
    if (VEC && n == CHUNK) {
      load_chunk<CHUNK>(cols + k, c);
      load_chunk<CHUNK>(data + k, d);
    } else {
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) {
        c[j] = j < n ? __ldcs(cols + k + j) : 0;
        d[j] = j < n ? to_f32<TD>(data[k + j]) : 0.f;
      }
    }
  };
  load(s0l + warp * SPAN + lane * CHUNK,
       min(s0l + block_nnz, (long long)nnz_pad));
  const int nnz = indptr[n_rows];
  const int r_begin = row_start[slice], r_end = row_start[slice + 1];
  if (s0l >= nnz && slice > 0) {  // past the last entry: nothing to own
    if (tid == 0) carry_row[slice] = -1;
    return;
  }
  const int s0 = (int)s0l;
  const int s1 = (int)min(s0l + block_nnz, (long long)nnz);

  // the rows of the slice's entries lie in [r_lo, r_end]: r_lo is the row
  // that entry s0 may continue; their IRP stays in L1 (a slice of 2048
  // entries of rows of ~25 spans ~80 rows, about three cache lines)
  const int r_lo = max(r_begin - 1, 0);
  // the row entry s0 continues from an earlier slice (-1: none)
  const int cont = __ldg(indptr + r_begin) > s0 ? r_begin - 1 : -1;
  if (tid == 0 && cont < 0) carry_row[slice] = -1;

  // a finished row: stored, or (the row continued from an earlier slice)
  // left in the carry buffer
  auto close = [&](int row, float val) {
    if (row < 0) return;
    if (row == cont) {
      carry_row[slice] = row;
      carry_val[slice] = val;
    } else {
      y[row] = val;
    }
  };
  // lane 0 of warp 0: the row the join holds open across passes, and its sum
  int open_row = -1;
  float open_val = 0.f;
  int buf = 0;
  for (int p0 = s0; p0 < s1; p0 += warps * SPAN, buf ^= 1) {
    const int w0 = p0 + warp * SPAN;
    if (w0 < s1) {  // uniform over the warp: every lane reaches every shuffle
      const int k = w0 + lane * CHUNK;
      const int n = max(0, min(CHUNK, s1 - k));
      if (p0 != s0) load(k, s1);
      float p[CHUNK];  // every x gather in flight before the row search
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) {
        p[j] = j < n ? d[j] * to_f32<TX>(x[c[j]]) : 0.f;
      }
      // the row of each entry: a binary search for the first, then a walk
      // (over empty rows too)
      int r[CHUNK];
      int row = -1, next = 0;
      if (n > 0) {
        int lo = r_lo + 1, hi = r_end;  // the first row starting past k
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (__ldg(indptr + mid) > k) {
            hi = mid;
          } else {
            lo = mid + 1;
          }
        }
        row = lo - 1;
        next = __ldg(indptr + lo);
      }
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) {
        if (j < n) {
          while (next <= k + j) next = __ldg(indptr + ++row + 1);
          r[j] = row;
        } else {
          r[j] = -1;  // no entry
        }
      }
      // the chunk's runs of rows: the head (first) and the tail (last) wait
      // for the scan; a row between them begins and ends here
      const int head = r[0];
      int tail = head;
      float head_sum = 0.f, acc = p[0];
      bool uniform = true;  // one row: head == tail
#pragma unroll
      for (int j = 1; j < CHUNK; ++j) {
        if (j < n && r[j] != tail) {
          if (uniform) {
            head_sum = acc;
            uniform = false;
          } else {
            y[tail] = acc;
          }
          tail = r[j];
          acc = 0.f;
        }
        acc += p[j];
      }
      // segmented inclusive scan of the tail sums over the warp: a lane whose
      // chunk is one row, the previous lane's tail row, continues its segment
      const int prev_tail = __shfl_up_sync(FULL, tail, 1);
      bool open = lane > 0 && uniform && tail >= 0 && prev_tail == tail;
      float v = acc;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v_up = __shfl_up_sync(FULL, v, off);
        const int open_up = __shfl_up_sync(FULL, (int)open, off);
        if (lane >= off && open) {
          v += v_up;
          open = open_up;
        }
      }
      const float carry = __shfl_up_sync(FULL, v, 1);
      const int next_head = __shfl_down_sync(FULL, head, 1);
      const bool tail_ends = tail >= 0 && (lane == 31 || next_head != tail);
      if (!uniform && lane > 0 && prev_tail == head) head_sum += carry;
      // a row that ends in this lane: the span's first or last row goes to
      // the block-level join, any other is finished and stored
      const int first_row = __shfl_sync(FULL, head, 0);
      const int last_lane = 31 - __clz(__ballot_sync(FULL, n > 0));
      const int last_row = __shfl_sync(FULL, tail, last_lane);
      if (lane == 0) {
        seg_row[buf][2 * warp + 1] = first_row;  // if the span is one row
        seg_val[buf][2 * warp + 1] = 0.f;
      }
      __syncwarp();
      auto finish = [&](int rw, float val) {
        if (rw == first_row) {
          seg_row[buf][2 * warp] = rw;
          seg_val[buf][2 * warp] = val;
        } else if (rw == last_row) {
          seg_row[buf][2 * warp + 1] = rw;
          seg_val[buf][2 * warp + 1] = val;
        } else {
          y[rw] = val;
        }
      };
      if (!uniform) finish(head, head_sum);
      if (tail_ends) finish(tail, v);
    }
    __syncthreads();
    if (warp == 0) {
      // join the spans' edge rows in entry order: a segmented scan over the
      // 2 * (warps of this pass) segments, whose rows do not decrease
      const int n_seg = 2 * min(warps, (s1 - p0 + SPAN - 1) / SPAN);
      int rw = lane < n_seg ? seg_row[buf][lane] : -2 - lane;
      float v = lane < n_seg ? seg_val[buf][lane] : 0.f;
      if (lane == 0) {  // the row held open by the previous pass
        if (rw == open_row) {
          v += open_val;
        } else {
          close(open_row, open_val);
        }
      }
      const int prev_rw = __shfl_up_sync(FULL, rw, 1);
      bool open = lane > 0 && rw == prev_rw;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v_up = __shfl_up_sync(FULL, v, off);
        const int open_up = __shfl_up_sync(FULL, (int)open, off);
        if (lane >= off && open) {
          v += v_up;
          open = open_up;
        }
      }
      const int next_rw = __shfl_down_sync(FULL, rw, 1);
      if (lane < n_seg - 1 && next_rw != rw) close(rw, v);
      open_row = __shfl_sync(FULL, rw, n_seg - 1);
      open_val = __shfl_sync(FULL, v, n_seg - 1);
    }
  }
  if (tid == 0) close(open_row, open_val);
  for (int r = r_begin + tid; r < r_end; r += blockDim.x) {
    if (__ldg(indptr + r) == __ldg(indptr + r + 1)) y[r] = 0.f;  // empty
  }
}

// One thread per slice: the first of a chain of slices that continue one row
// adds their carries, in slice order, to the partial sum the row's own slice
// stored.
__global__ void csr_spmv_carry(const int* __restrict__ carry_row,
                               const float* __restrict__ carry_val,
                               float* __restrict__ y, int n_slices) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n_slices) return;
  const int row = carry_row[s];
  if (row < 0 || (s > 0 && carry_row[s - 1] == row)) return;
  float acc = carry_val[s];
  for (int t = s + 1; t < n_slices && carry_row[t] == row; ++t) {
    acc += carry_val[t];
  }
  y[row] += acc;
}

// scratch: 3 * n_slices + 1 ints (the slices' first rows, the carries' rows,
// then their float32 sums); n_slices = ceil(nnz_pad / block_nnz), at least 1;
// threads: a whole number of warps <= 1024; chunk: consecutive entries a
// thread sums (4 or 8).  The wrapper (kernels/csr_spmv.py) picks them.
// Launches the three kernels on `stream`; returns cudaGetLastError().
extern "C" int csr_spmv_launch(const void* data, const void* cols,
                               const void* indptr, const void* x, void* y,
                               void* scratch, int n_rows, int nnz_pad,
                               int n_slices, int threads, int block_nnz,
                               int chunk, int data_bf16, int x_bf16,
                               void* stream) {
  if (n_rows <= 0) return 0;
  if (!valid_block(1, threads) || threads > 32 * CSR_MAX_WARPS ||
      n_slices < 1 || block_nnz < 1 || (chunk != 4 && chunk != 8) ||
      nnz_pad < 0 ||
      (long long)n_slices * block_nnz < nnz_pad) {
    return (int)cudaErrorInvalidValue;
  }
  const bool vec =
      block_nnz % chunk == 0 && aligned16(data) && aligned16(cols);
  int* row_start = (int*)scratch;
  int* carry_row = row_start + n_slices + 1;
  float* carry_val = (float*)(carry_row + n_slices);
  cudaStream_t s = (cudaStream_t)stream;
  csr_spmv_bounds<<<(unsigned)(((long long)n_slices + 1 + 7) / 8), 256, 0,
                    s>>>((const int*)indptr, row_start, n_rows, n_slices,
                         block_nnz);
#define LAUNCH(TD, TX, C, V)                                               \
  csr_spmv_slices<TD, TX, C, V><<<n_slices, threads, 0, s>>>(              \
      (const TD*)data, (const int*)cols, (const int*)indptr, (const TX*)x, \
      (float*)y, row_start, carry_row, carry_val, n_rows, nnz_pad,         \
      block_nnz)
#define CALL(TD, TX)              \
  if (chunk == 4) {               \
    if (vec) {                    \
      LAUNCH(TD, TX, 4, true);    \
    } else {                      \
      LAUNCH(TD, TX, 4, false);   \
    }                             \
  } else {                        \
    if (vec) {                    \
      LAUNCH(TD, TX, 8, true);    \
    } else {                      \
      LAUNCH(TD, TX, 8, false);   \
    }                             \
  }
  DISPATCH_VALUE_TYPES(data_bf16, x_bf16, CALL);
#undef CALL
#undef LAUNCH
  if (n_slices > 1) {
    csr_spmv_carry<<<(n_slices + 255) / 256, 256, 0, s>>>(carry_row, carry_val,
                                                          (float*)y, n_slices);
  }
  return (int)cudaGetLastError();
}
