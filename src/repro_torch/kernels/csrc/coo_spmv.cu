// COO SpMV for Hopper (sm_90a): y[rows[k]] += data[k] * x[cols[k]] for
// entries in any order.
//
// Replaces the TPU kernel repro/kernels/coo_spmv.py:coo_spmv, which walks the
// nnz slabs in sequence into a y held on chip.  Blocks here run in no order,
// so partial sums meet in global memory through float32 atomics, and the
// design is about issuing few of them: a run of equal rows is reduced on the
// chip before anything reaches y.
//
// Each block owns a contiguous run of block_nnz entries; a warp takes 32 *
// CHUNK of them at a time, each thread CHUNK (4 or 8) consecutive entries,
// read with 16-byte cache-streaming loads where the pointers allow (the
// streams are read once; x and y keep the L2).  A thread sums each run of
// equal rows of its chunk in a register.  The run that ends the chunk enters
// a segmented inclusive scan over the warp keyed by row (5 shuffle steps, a
// reduce-by-key); the run that starts the chunk takes the previous lane's
// scanned sum when the rows match.  Only the lane that ends a run issues its
// atomicAdd (the result unused: red.global.add.f32), so a warp flushes one
// atomic per maximal run of equal rows in its span: sorted rows give about
// one per row plus one per warp span, and every lane ends at most one run.
// Unsorted entries just make more runs, and the sum is the same in any
// order.  Where a lane ends several runs (short runs: column-sorted entries
// end one at every entry), the warp stages its flushes in shared memory and
// issues them in entry order, so the 32 atomics of one instruction go to
// neighbouring entries' rows, as a thread per entry would, and not to rows
// CHUNK entries apart.  The summation order, and so the last bits, still
// change from run to run.  Pads (0, 0, 0.0) are a run of row 0 that adds 0.
//
// Bound on an H100: bytes — nnz * (val + 8) for the three streams,
// val * n_cols for x and 4 * n_rows for y, over 3.35 TB/s.
#include "common.cuh"

// VEC: every chunk's first entry is aligned for load_chunk (the entry point
// checks the pointers and block_nnz); a chunk cut by the end of the block
// is read entry by entry either way.  The block's dynamic shared memory holds
// 8 bytes per entry of a pass (threads * CHUNK): each warp's staged flushes.
template <typename TD, typename TX, int CHUNK, bool VEC>
__global__ void coo_spmv_runs(const TD* __restrict__ data,
                              const int* __restrict__ rows,
                              const int* __restrict__ cols,
                              const TX* __restrict__ x,
                              float* __restrict__ y, long long nnz,
                              int block_nnz) {
  constexpr unsigned FULL = 0xffffffffu;
  constexpr int SPAN = 32 * CHUNK;  // entries a warp takes at a time
  extern __shared__ int stage[];
  int* stage_row = stage + (threadIdx.x / 32) * 2 * SPAN;
  float* stage_val = reinterpret_cast<float*>(stage_row + SPAN);
  const int lane = threadIdx.x % 32;
  const long long base = blockIdx.x * (long long)block_nnz;
  const long long end = min(base + block_nnz, nnz);
  const long long step = (long long)(blockDim.x / 32) * SPAN;
  // the loop is uniform over a warp: every lane reaches every shuffle
  for (long long w0 = base + (long long)(threadIdx.x / 32) * SPAN; w0 < end;
       w0 += step) {
    const long long k = w0 + (long long)lane * CHUNK;
    const int n = (int)max(0LL, min((long long)CHUNK, end - k));
    int r[CHUNK], c[CHUNK];
    float d[CHUNK];
    if (VEC && n == CHUNK) {
      load_chunk<CHUNK>(rows + k, r);
      load_chunk<CHUNK>(cols + k, c);
      load_chunk<CHUNK>(data + k, d);
    } else {
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) {
        r[j] = j < n ? __ldcs(rows + k + j) : -1;  // -1: no entry
        c[j] = j < n ? __ldcs(cols + k + j) : 0;
        d[j] = j < n ? to_f32<TD>(data[k + j]) : 0.f;
      }
    }
    float p[CHUNK];  // every x gather in flight before the sums
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      p[j] = j < n ? d[j] * to_f32<TX>(x[c[j]]) : 0.f;
    }
    // the runs of equal rows inside the chunk: the head run (the first) and
    // the tail run (the last) wait for the scan; a run between them ends
    // inside the chunk and is staged at once in the warp's shared memory, its
    // row and sum at the entry that ends it (row -1: no run ends there)
    int* my_row = stage_row + lane * CHUNK;
    float* my_val = stage_val + lane * CHUNK;
#pragma unroll
    for (int q = 0; q < CHUNK / 4; ++q) {
      reinterpret_cast<int4*>(my_row)[q] = make_int4(-1, -1, -1, -1);
    }
    const int head = r[0];
    int tail = head, head_end = 0, n_inner = 0;
    float head_sum = 0.f, acc = p[0];
    bool uniform = true;  // one run: head == tail
#pragma unroll
    for (int j = 1; j < CHUNK; ++j) {
      if (j < n && r[j] != tail) {
        if (uniform) {
          head_sum = acc;
          head_end = j - 1;
          uniform = false;
        } else {
          my_row[j - 1] = tail;
          my_val[j - 1] = acc;
          ++n_inner;
        }
        tail = r[j];
        acc = 0.f;
      }
      acc += p[j];
    }
    // segmented inclusive scan of the tail sums over the warp: a lane whose
    // chunk is one run of the previous lane's tail row continues its segment
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
    // the previous lane's segment so far joins this chunk's head run; the
    // tail run ends here unless the next lane's head run continues it
    const float carry = __shfl_up_sync(FULL, v, 1);
    const int next_head = __shfl_down_sync(FULL, head, 1);
    const bool tail_ends = tail >= 0 && (lane == 31 || next_head != tail);
    if (!uniform && lane > 0 && prev_tail == head) head_sum += carry;
    if (__any_sync(FULL, n_inner + !uniform + tail_ends > 1)) {
      // short runs: issue the warp's atomics in entry order through shared
      // memory, so one instruction's 32 atomics go to neighbouring entries'
      // rows (as a thread per entry would) and not to rows CHUNK apart
      if (!uniform) {
        my_row[head_end] = head;
        my_val[head_end] = head_sum;
      }
      if (tail_ends) {
        my_row[n - 1] = tail;
        my_val[n - 1] = v;
      }
      __syncwarp();
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) {
        const int row = stage_row[j * 32 + lane];
        if (row >= 0) atomicAdd(y + row, stage_val[j * 32 + lane]);
      }
      __syncwarp();
    } else {
      // at most one run ends in each chunk: one atomic instruction
      const int row = !uniform ? head : tail_ends ? tail : -1;
      if (row >= 0) atomicAdd(y + row, !uniform ? head_sum : v);
    }
  }
}

// threads: threads per block (a whole number of warps, <= 1024); block_nnz:
// entries per block; chunk: consecutive entries a thread sums (4 or 8).  The
// wrapper (kernels/coo_spmv.py) picks them.  y must be zero-filled by the
// caller.  Returns cudaGetLastError().
extern "C" int coo_spmv_launch(const void* data, const void* rows,
                               const void* cols, const void* x, void* y,
                               long long nnz, int threads, int block_nnz,
                               int chunk, int data_bf16, int x_bf16,
                               void* stream) {
  if (nnz <= 0) return 0;
  if (!valid_block(1, threads) || block_nnz < 1 || (chunk != 4 && chunk != 8)) {
    return (int)cudaErrorInvalidValue;
  }
  const bool vec = block_nnz % chunk == 0 && aligned16(data) &&
                   aligned16(rows) && aligned16(cols);
  const size_t smem = (size_t)threads * chunk * 8;  // staged flushes
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned grid = (unsigned)((nnz + block_nnz - 1) / block_nnz);
#define LAUNCH(TD, TX, C, V)                                              \
  coo_spmv_runs<TD, TX, C, V><<<grid, threads, smem, s>>>(                \
      (const TD*)data, (const int*)rows, (const int*)cols, (const TX*)x,  \
      (float*)y, nnz, block_nnz)
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
  return (int)cudaGetLastError();
}
