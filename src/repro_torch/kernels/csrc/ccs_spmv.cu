// CCS SpMV for Hopper (sm_90a): y[rows[k]] += data[k] * x[c] for
// IRP_T[c] <= k < IRP_T[c+1].
//
// Replaces the TPU kernel repro/kernels/ccs_spmv.py:ccs_spmv, whose grid
// (col_blocks, slabs) walks a static slab schedule over a (block_cols,) x
// tile and keeps the whole (n_rows,) y resident on chip.  Blocks here run in
// no order and meet in y through float32 atomics into a zero-filled y, so the
// design is about issuing few of them without paying more than an atomic for
// each entry it saves.  Adjacent columns share rows (in a band, 32 adjacent
// columns hold ~14 entries on each row they touch), so:
//
// - A warp owns a run of `cols_per_warp` adjacent columns.  Their entries are
//   one contiguous range, IRP_T[c0] .. IRP_T[c0 + cols_per_warp], which the
//   warp walks 32 entries a pass with coalesced rows/data loads (the next
//   pass's loads are issued before the current pass is added).  It takes
//   its columns 32 at a time: lane j holds IRP_T and x of column j of the
//   32, and a lane finds its entry's column by shuffles over those starts
//   (two steps from the pass's first column when the pass spans at most
//   four columns, else a five-step binary search), then x of it by one more.
// - The warp keeps private windows of `window` rows of y in shared memory,
//   centred on the rows its columns map to (c * n_rows / n_cols): one window
//   per column mod 4, and a touched flag a row.  An entry inside the window
//   is added to its column's window with a plain read-add-write.  Two lanes
//   of a pass may not add to one place in one store: a pass of at most four
//   columns puts each column in its own window, and within a column rows
//   rise strictly (checked by one shuffle a pass).  A pass that breaks
//   either (a column's rows in another order, one row twice, a pass over
//   five columns or more) takes the slow path: lanes on one window slot are
//   found by __match_any_sync and summed by shuffles into the lowest of
//   them, which alone stores.  Passes are ordered by __syncwarp.  No
//   shared-memory float atomic (a compare-and-swap loop on this card) and
//   no block-wide step: warps share nothing.
// - An entry outside the window goes straight to y with one global
//   atomicAdd, as a column-a-group design would.
// - At the end the warp adds each touched window row (its four windows
//   summed) to y: one global atomic a row, lanes striding the window.
//
// So a banded matrix issues about one global atomic per touched row and warp
// instead of one per entry, and a scattered one what the one-column-a-group
// design issued.  Correctness does not depend on the window's place, only
// the cost does.  Slots past IRP_T[n_cols] (pads of (0, row 0)) are never
// read.  The global atomics make the order of the sum, and so the last bits,
// change from run to run: results are compared to a tolerance.
//
// What the pass costs (PERF.md §6; experiments/torch_k7_designs.py swaps
// the block between the "window store" marks for the other designs and
// times them): running __match_any_sync on every pass was slower than this
// check, shared-memory float atomics into one window faster; the walk
// itself, with no collision handling at all, is the floor.
//
// Bound on an H100: bytes — nnz * (val + 4) for VAL/IROW,
// 4 * (n_cols + 1) for IRP_T, val * n_cols for x and 4 * n_rows for y, over
// 3.35 TB/s; in practice also L2's atomic throughput where entries fall
// outside the windows.
#include "common.cuh"

// One value of a stream read once (evict-first), widened to float32.
template <typename T>
__device__ __forceinline__ float load_once(const T* p);

template <>
__device__ __forceinline__ float load_once<float>(const float* p) {
  return __ldcs(p);
}

template <>
__device__ __forceinline__ float load_once<__nv_bfloat16>(
    const __nv_bfloat16* p) {
  return __uint_as_float(
      (unsigned)__ldcs(reinterpret_cast<const unsigned short*>(p)) << 16);
}

// The last of the 32 columns whose start (lane j holds column j's) is at or
// before entry e: a binary search by shuffles.
__device__ __forceinline__ int column_of(int start, int e) {
  int j = 0;
#pragma unroll
  for (int step = 16; step > 0; step >>= 1) {
    if (__shfl_sync(0xffffffffu, start, j + step) <= e) j += step;
  }
  return j;
}

#define CCS_WINDOWS 4  // windows a warp keeps, one per column mod 4
// threads of a block: the wrapper's CCS_SPMV_WARPS (kernels/_common.py) warps
#define CCS_SPMV_MAX_THREADS 256

// The shared memory holds each warp's CCS_WINDOWS windows (`window` floats
// each), then each warp's touched flags (`window` bytes).
template <typename TD, typename TX>
__global__ void __launch_bounds__(CCS_SPMV_MAX_THREADS)
    ccs_spmv_warps(const TD* __restrict__ data, const int* __restrict__ rows,
                   const int* __restrict__ indptr, const TX* __restrict__ x,
                   float* __restrict__ y, int n_rows, int n_cols,
                   int cols_per_warp, int window) {
  constexpr unsigned FULL = 0xffffffffu;
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int warps = blockDim.x / 32;
  const long long c0 =
      ((long long)blockIdx.x * warps + warp) * cols_per_warp;
  if (c0 >= n_cols) return;  // the whole warp leaves together
  float* win = smem + warp * CCS_WINDOWS * window;
  unsigned char* touched =
      reinterpret_cast<unsigned char*>(smem + warps * CCS_WINDOWS * window) +
      warp * window;
  const int c_end = (int)min((long long)n_cols, c0 + cols_per_warp);
  const long long centre =
      (2 * c0 + cols_per_warp) * (long long)n_rows / (2LL * n_cols);
  const int base =
      (int)max(0LL, min(centre - window / 2, (long long)n_rows - window));
  for (int i = lane; i < CCS_WINDOWS * window; i += 32) win[i] = 0.f;
  for (int i = lane; i < window; i += 32) touched[i] = 0;
  __syncwarp();

  for (int cc = (int)c0; cc < c_end; cc += 32) {
    const int n = min(32, c_end - cc);
    const int end = indptr[cc + n];
    const int start = lane < n ? indptr[cc + lane] : end;
    const float xc = lane < n ? to_f32<TX>(x[cc + lane]) : 0.f;
    const int first = __shfl_sync(FULL, start, 0);
    int j0 = column_of(start, first);  // the column of the pass's first entry
    int e = first + lane;
    int r = 0;
    float v = 0.f;
    if (e < end) {
      r = __ldcs(rows + e);
      v = load_once<TD>(data + e);
    }
    for (int p = first; p < end; p += 32, e += 32) {
      const bool live = e < end;
      int r_next = 0;
      float v_next = 0.f;
      if (e + 32 < end) {
        r_next = __ldcs(rows + e + 32);
        v_next = load_once<TD>(data + e + 32);
      }
      // few: the pass lies in columns j0 .. j0 + 3 — then a two-step search
      // finds an entry's column, and no two of its columns share a window
      const int last = min(p + 31, end - 1);
      const bool few =
          j0 + 4 > 31 || __shfl_sync(FULL, start, min(j0 + 4, 31)) > last;
      int j;
      if (few) {
        j = j0;
        int t = min(j0 + 2, 31);
        if (__shfl_sync(FULL, start, t) <= e) j = t;
        t = min(j + 1, 31);
        if (__shfl_sync(FULL, start, t) <= e) j = t;
      } else {
        j = column_of(start, e);
      }
      const float sum = v * __shfl_sync(FULL, xc, j);
      // window store: begin
      const int w = r - base;
      const bool inside = live && (unsigned)w < (unsigned)window;
      // rows rise strictly within each column of the pass: no two lanes
      // add to one place (a column's rows in another order, or one row
      // twice, take the slow path)
      const int r_up = __shfl_up_sync(FULL, r, 1);
      const int j_up = __shfl_up_sync(FULL, j, 1);
      const bool clash = live && lane > 0 && j_up == j && r_up >= r;
      float* mine = win + (j % CCS_WINDOWS) * window;
      if (few && !__any_sync(FULL, clash)) {
        if (inside) {
          mine[w] += sum;
          touched[w] = 1;
        }
      } else {
        // lanes on one window slot: summed by shuffles into the lowest
        const unsigned peers = __match_any_sync(
            FULL, inside ? (j % CCS_WINDOWS) * window + w : -1 - lane);
        const unsigned below = (1u << lane) - 1u;
        unsigned above = peers & ~below & ~(1u << lane);
        unsigned rank = __popc(peers & below);
        const bool lead = inside && rank == 0;
        float total = sum;
        while (__any_sync(FULL, above)) {
          // a tree over each group of peers: each lane adds the next peer
          // above it still in play; odd ranks then leave
          const int next = __ffs(above);
          const float t = __shfl_sync(FULL, total, (next - 1) & 31);
          if (next) total += t;
          above &= ~__ballot_sync(FULL, rank & 1u);
          rank >>= 1;
        }
        if (lead) {
          mine[w] += total;
          touched[w] = 1;
        }
      }
      // window store: end
      if (live && !inside) atomicAdd(y + r, sum);
      __syncwarp();
      j0 = __shfl_sync(FULL, j, 31);
      r = r_next;
      v = v_next;
    }
  }
  // each touched window row, added to y once
  for (int i = lane; i < window; i += 32) {
    if (touched[i]) {
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < CCS_WINDOWS; ++q) s += win[q * window + i];
      atomicAdd(y + base + i, s);
    }
  }
}

// threads: threads per block (a whole number of warps, <= 256);
// cols_per_warp: adjacent columns a warp owns (>= 1); window: rows of a
// warp's windows, 1 .. min(n_rows, 1024), with warps * window * 17 bytes of
// shared memory under 48 KB.  y must be zero-filled by the caller.  The
// wrapper (kernels/ccs_spmv.py) picks them.  Returns cudaGetLastError().
extern "C" int ccs_spmv_launch(const void* data, const void* rows,
                               const void* indptr, const void* x, void* y,
                               int n_rows, int n_cols, int threads,
                               int cols_per_warp, int window, int data_bf16,
                               int x_bf16, void* stream) {
  if (n_cols <= 0 || n_rows <= 0) return 0;
  if (!valid_block(32, threads) || threads > CCS_SPMV_MAX_THREADS ||
      cols_per_warp < 1 || window < 1 ||
      window > n_rows || window > 1024) {
    return (int)cudaErrorInvalidValue;
  }
  const int warps = threads / 32;
  const size_t smem = (size_t)warps * window * (CCS_WINDOWS * sizeof(float) + 1);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long cols_per_block = (long long)warps * cols_per_warp;
  const unsigned grid =
      (unsigned)(((long long)n_cols + cols_per_block - 1) / cols_per_block);
#define CALL(TD, TX)                                                     \
  ccs_spmv_warps<TD, TX><<<grid, (unsigned)threads, smem, s>>>(          \
      (const TD*)data, (const int*)rows, (const int*)indptr, (const TX*)x, \
      (float*)y, n_rows, n_cols, cols_per_warp, window)
  DISPATCH_VALUE_TYPES(data_bf16, x_bf16, CALL);
#undef CALL
  return (int)cudaGetLastError();
}
