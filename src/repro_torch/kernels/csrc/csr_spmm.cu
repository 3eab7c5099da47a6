// CSR SpMM for Hopper (sm_90a): Y[r, b] = sum_{k in [IRP[r], IRP[r+1])}
// data[k] * X[cols[k], b], X (n_cols, B) and Y (n_rows, B) row-major.
//
// Replaces the TPU kernel repro/kernels/csr_spmv.py:csr_spmm, whose grid
// (row_blocks, k_blocks, slabs) walks a static slab schedule because a TPU
// grid is fixed before the run.  Here a row's bounds are read from IRP at run
// time, so a heavy-tail row is a longer loop for its group and slots past
// IRP[n_rows] are never read.
//
// Bound on an H100: bytes — nnz * (val + 4) + 4 * (n_rows + 1) for A,
// val * n_cols * B for X, 4 * n_rows * B for Y, over 3.35 TB/s, against
// 2 * nnz * B flops at 67 TF/s.  What keeps a row-per-group kernel from it is
// the X gather: every stored entry fetches a whole X row (512 bytes at
// B = 128 float32) through L2, 7.9 GB a product on xenon2 at scale 4, from
// an X of 322 MB that does not fit the 50 MB L2.
//
// The window kernel (csr_spmm_window): a CUDA block owns rows_per_block
// consecutive rows and keeps `window` consecutive X rows of its column tile
// in shared memory.  Adjacent rows of a banded matrix share most of their
// columns (32 rows of xenon2 touch ~75 X rows, 24.6 entries a row), so one
// fetch of each X row serves ~10 entries.
//  1. IRP of the block's rows, and as many of its entries as the stage
//     holds (value and column, one 8-byte slot each), go to shared memory.
//  2. The window starts at the least first column of the block's rows that
//     fit in a window (one read a row; right for any matrix: an entry
//     outside is read from global), moved left where it would pass the
//     last column.  The block keeps it only if more of its staged entries
//     fall inside than it has X rows to fetch, so a hash-scattered matrix
//     pays no fill.
//  3. The window is filled by bulk asynchronous copies (cp.async.bulk, one
//     thread, completion on an mbarrier) where its rows are whole 16-byte
//     runs — the tile is all of X's row (one contiguous copy) or a 16-byte
//     multiple (one copy a row) — else by plain loads of all threads.
//  4. Groups of `lanes` threads (a warp from B = 17) sit along the tile's
//     columns and walk the block's rows, group g rows g, g + G, ...: a
//     staged entry is one shared-memory broadcast, the rest are loaded
//     `lanes` at a time and shared by shuffle.  A group takes CSR_UNROLL
//     entries together, each X row from the window when its column lies
//     there, else from global (x_row: one 16-byte load a thread where B
//     allows), so four X rows are in flight.  No atomics: a row belongs to
//     one group and Y is stored once.
//  5. A row longer than the window is heavy: every group sums a slice of
//     it, and the slices' sums are added in group order through shared
//     memory, so a row of thousands of entries costs the block, not one
//     warp, its time (torso1: 857 rows of 4959 entries).
// The row-group kernel of the first port (csr_spmm_rows) runs where the
// window kernel does not pay (kernels/_common.py:csr_spmm_window): a group
// of `lanes` threads a row, every X row from global.  The window kernel
// pays on a band from B = 64 (at B = 32 its set-up costs more than the
// window saves) and on a matrix with heavy rows at every B; on a
// hash-scattered matrix, whose blocks keep no window, it is slower than the
// row groups (PERF.md §6).
#include <climits>

#include "common.cuh"

#define CSR_UNROLL 4  // entries whose X rows a group loads together

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

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// Bytes of shared memory a window of `window` rows of kt values takes,
// rounded up so that what follows it is 16-byte aligned.
static inline __host__ __device__ long long window_bytes(int window, int kt,
                                                         int x_size) {
  return ((long long)window * kt * x_size + 15) / 16 * 16;
}

// Bytes of the rows' IRP (rows + 1 ints), rounded up to 16.
static inline __host__ __device__ long long irp_bytes(int rows) {
  return (4LL * (rows + 1) + 15) / 16 * 16;
}

// What a lane group needs to add one entry's X row: the window (xw: X rows
// lo .. lo + wrows - 1 of the tile, wrows 0 for none) or X itself, and its
// columns of the tile.
template <typename TX>
struct XSource {
  const TX* xw;
  const TX* x;
  int lo, wrows, kt, B, b0, wb0, stride, k_end, wend;
};

// CSR_UNROLL entries' X rows (column c[u], weight d[u]; u >= n: none) added
// to acc: from the window where the column lies there, else from global,
// all loads issued before the adds.
template <typename TX, int PER, bool VEC>
__device__ __forceinline__ void add_rows(const XSource<TX>& s,
                                         const float (&d)[CSR_UNROLL],
                                         const int (&c)[CSR_UNROLL], int n,
                                         float (&acc)[PER]) {
  float xv[CSR_UNROLL][PER];
#pragma unroll
  for (int u = 0; u < CSR_UNROLL; ++u) {
    const bool in = u < n;
    if ((unsigned)(c[u] - s.lo) < (unsigned)s.wrows) {
      x_row<TX, PER, VEC>(s.xw, c[u] - s.lo, s.kt, s.wb0, s.stride,
                          in ? s.wend : s.wb0, xv[u]);
    } else {
      x_row<TX, PER, VEC>(s.x, c[u], s.B, s.b0, s.stride,
                          in ? s.k_end : s.b0, xv[u]);
    }
  }
#pragma unroll
  for (int u = 0; u < CSR_UNROLL; ++u) {
    if (u < n) {
#pragma unroll
      for (int i = 0; i < PER; ++i) acc[i] = fmaf(d[u], xv[u][i], acc[i]);
    }
  }
}

// Staged entries e .. stop - 1 into acc: value and column read from the
// stage (one broadcast a entry).  Uniform over the lane group.
template <typename TX, int PER, bool VEC>
__device__ __forceinline__ void add_staged(const int2* __restrict__ stage,
                                           int e, int stop,
                                           const XSource<TX>& s,
                                           float (&acc)[PER]) {
  for (; e < stop; e += CSR_UNROLL) {
    float d[CSR_UNROLL];
    int c[CSR_UNROLL];
#pragma unroll
    for (int u = 0; u < CSR_UNROLL; ++u) {
      const int2 v = e + u < stop ? stage[e + u] : make_int2(0, 0);
      d[u] = __int_as_float(v.x);
      c[u] = v.y;
    }
    add_rows<TX, PER, VEC>(s, d, c, stop - e, acc);
  }
}

// Entries a .. b - 1 from global into acc: `lanes` of them loaded at a time
// (one coalesced load a lane, the next chunk's issued before this one is
// summed) and shared by shuffle.  Uniform over the lane group.
template <typename TD, typename TX, int PER, bool VEC>
__device__ __forceinline__ void add_chunks(const TD* __restrict__ data,
                                           const int* __restrict__ cols,
                                           long long a, long long b,
                                           int lane, int lanes, unsigned mask,
                                           const XSource<TX>& s,
                                           float (&acc)[PER]) {
  float dv = 0.f;
  int cv = 0;
  if (a + lane < b) {
    dv = to_f32<TD>(data[a + lane]);
    cv = cols[a + lane];
  }
  for (long long e0 = a; e0 < b; e0 += lanes) {
    float ndv = 0.f;
    int ncv = 0;
    if (e0 + lanes + lane < b) {
      ndv = to_f32<TD>(data[e0 + lanes + lane]);
      ncv = cols[e0 + lanes + lane];
    }
    const int n = (int)min((long long)lanes, b - e0);
    for (int j = 0; j < n; j += CSR_UNROLL) {
      float d[CSR_UNROLL];
      int c[CSR_UNROLL];
#pragma unroll
      for (int u = 0; u < CSR_UNROLL; ++u) {
        // j + u past the group's width wraps to another lane: masked by n
        d[u] = __shfl_sync(mask, dv, j + u, lanes);
        c[u] = __shfl_sync(mask, cv, j + u, lanes);
      }
      add_rows<TX, PER, VEC>(s, d, c, n - j, acc);
    }
    dv = ndv;
    cv = ncv;
  }
}

template <typename TD, typename TX, int PER, bool VEC>
__global__ void __launch_bounds__(256)
    csr_spmm_window(const TD* __restrict__ data, const int* __restrict__ cols,
                    const int* __restrict__ indptr, const TX* __restrict__ x,
                    float* __restrict__ y, int n_rows, int n_cols, int B,
                    int kt, int lanes, int rows_per_block, int window,
                    int stage_cap, int bulk) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned long long bar;
  __shared__ int s_lo, s_hits;
  // window row i: X[lo + i, k0:]; the rows' IRP; the stage (the block's
  // first entries as (value bits, column)); a heavy row's partial sums
  TX* xw = reinterpret_cast<TX*>(smem);
  const long long wbytes = window_bytes(window, kt, (int)sizeof(TX));
  int* ip = reinterpret_cast<int*>(smem + wbytes);
  int2* stage =
      reinterpret_cast<int2*>(smem + wbytes + irp_bytes(rows_per_block));
  float* part = reinterpret_cast<float*>(stage + stage_cap);
  const int r0 = blockIdx.x * rows_per_block;
  const int nr = min(rows_per_block, n_rows - r0);
  const int k0 = blockIdx.y * kt;
  const int k_end = min(k0 + kt, B);
  const int wl = threadIdx.x % 32;

  // 1. the rows' IRP
  if (threadIdx.x == 0) {
    s_lo = INT_MAX;
    s_hits = 0;
  }
  for (int t = threadIdx.x; t <= nr; t += blockDim.x) ip[t] = indptr[r0 + t];
  __syncthreads();
  // 2. the block's entries, as many as the stage holds; the window starts
  //    at the least first column of the rows that fit in a window (a longer
  //    row is heavy: the whole block sums it, below)
  const long long base = ip[0];
  const int staged = (int)min((long long)stage_cap, (long long)ip[nr] - base);
  for (int i = threadIdx.x; i < staged; i += blockDim.x) {
    stage[i] = make_int2(__float_as_int(to_f32<TD>(data[base + i])),
                         cols[base + i]);
  }
  int lo = INT_MAX;
  for (int t = threadIdx.x; t < nr; t += blockDim.x) {
    const int len = ip[t + 1] - ip[t];
    if (len >= 1 && len <= window) lo = min(lo, cols[ip[t]]);
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  if (wl == 0 && lo != INT_MAX) atomicMin(&s_lo, lo);
  __syncthreads();
  // 3. keep the window (moved left where it would pass the last column) if
  //    more of the staged entries fall inside it than it has X rows
  lo = min(s_lo, max(0, n_cols - window));
  const int held = s_lo == INT_MAX ? 0 : min(window, n_cols - lo);
  int hits = 0;
  for (int i = threadIdx.x; i < staged; i += blockDim.x) {
    hits += (unsigned)(stage[i].y - lo) < (unsigned)held;
  }
  hits = __reduce_add_sync(0xffffffffu, hits);
  if (wl == 0 && hits > 0) atomicAdd(&s_hits, hits);
  __syncthreads();
  const int wrows = s_hits > 0 && s_hits >= held ? held : 0;  // 0: no window
  if (wrows > 0) {
    // 4. fill it
    const int tile = k_end - k0;
    if (bulk) {
      const unsigned b = smem_u32(&bar);
      if (threadIdx.x == 0) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(b)
                     : "memory");
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      }
      __syncthreads();
      if (threadIdx.x < 32) {
        const unsigned row_bytes = (unsigned)(tile * sizeof(TX));
        if (threadIdx.x == 0) {
          asm volatile(
              "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                  b),
              "r"((unsigned)wrows * row_bytes)
              : "memory");
        }
        __syncwarp();
        // the whole tile of X's rows: one run; else one copy a row
        const int copies = kt == B ? 1 : wrows;
        const unsigned bytes = kt == B ? (unsigned)wrows * row_bytes
                                       : row_bytes;
        for (int i = threadIdx.x; i < copies; i += 32) {
          asm volatile(
              "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::"
              "bytes [%0], [%1], %2, [%3];" ::"r"(smem_u32(xw + (long long)i * kt)),
              "l"(x + (long long)(lo + i) * B + k0), "r"(bytes), "r"(b)
              : "memory");
        }
      }
      asm volatile(
          "{\n"
          ".reg .pred p;\n"
          "WAIT:\n"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], 0;\n"
          "@!p bra WAIT;\n"
          "}\n" ::"r"(b)
          : "memory");
    } else {
      for (int i = threadIdx.x; i < wrows * kt; i += blockDim.x) {
        const int b = i % kt;
        if (b < tile) xw[i] = x[(long long)(lo + i / kt) * B + k0 + b];
      }
      __syncthreads();
    }
  }

  // 5. the rows that fit in a window, a lane group each: group g rows g,
  //    g + G, ...; staged entries from the stage, the rest from global
  const int lane = threadIdx.x % lanes;
  const int group = threadIdx.x / lanes, groups = blockDim.x / lanes;
  const unsigned mask = group_mask(lanes);
  const int b0 = VEC ? k0 + lane * PER : k0 + lane;
  XSource<TX> src;
  src.xw = xw;
  src.x = x;
  src.lo = lo;
  src.wrows = wrows;
  src.kt = kt;
  src.B = B;
  src.b0 = b0;
  src.wb0 = b0 - k0;
  src.stride = VEC ? 1 : lanes;  // from one of its columns to the next
  src.k_end = k_end;
  src.wend = k_end - k0;
  for (int t = group; t < nr; t += groups) {
    const int e0 = (int)(ip[t] - base), e1 = (int)(ip[t + 1] - base);
    if (e1 - e0 > window) continue;
    const int mid = max(e0, min(e1, staged));
    float acc[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) acc[i] = 0.f;
    add_staged<TX, PER, VEC>(stage, e0, mid, src, acc);
    add_chunks<TD, TX, PER, VEC>(data, cols, base + mid, base + e1, lane,
                                 lanes, mask, src, acc);
    store_row<PER, VEC>(y + (long long)(r0 + t) * B, b0, src.stride, k_end,
                        acc);
  }
  // 6. heavy rows: each group sums a slice of the row's entries, and the
  //    slices' sums are added in group order (the same bits every launch)
  for (int t = 0; t < nr; ++t) {
    const long long e0 = ip[t], e1 = ip[t + 1];
    if (e1 - e0 <= window) continue;
    const long long slice = (e1 - e0 + groups * lanes - 1) /
                            (groups * lanes) * lanes;
    float acc[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) acc[i] = 0.f;
    add_chunks<TD, TX, PER, VEC>(data, cols, min(e1, e0 + group * slice),
                                 min(e1, e0 + (group + 1) * slice), lane,
                                 lanes, mask, src, acc);
    __syncthreads();  // the previous heavy row's sums are read
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int b = b0 - k0 + i * src.stride;
      if (b < src.wend) part[group * kt + b] = acc[i];
    }
    __syncthreads();
    for (int b = threadIdx.x; b < src.wend; b += blockDim.x) {
      float sum = 0.f;
      for (int g = 0; g < groups; ++g) sum += part[g * kt + b];
      y[(long long)(r0 + t) * B + k0 + b] = sum;
    }
  }
}

// kt, lanes, per_lane as for ell_spmm_launch; threads: threads per block (a
// whole number of warps, <= 1024; with window == 0 rows_per_block * lanes);
// rows_per_block: rows a CUDA block owns; window: X rows of the block's
// shared-memory window (0: the row-group kernel, every X row from global;
// else threads <= 256); stage: entries of the block staged in shared memory
// (the rest are read from global).  The wrapper (kernels/csr_spmv.py, through
// kernels/_common.py:csr_spmm_launch) picks them.  Returns
// cudaGetLastError().
extern "C" int csr_spmm_launch(const void* data, const void* cols,
                               const void* indptr, const void* x, void* y,
                               int n_rows, int n_cols, int B, int kt,
                               int lanes, int per_lane, int threads,
                               int rows_per_block, int window, int stage,
                               int data_bf16, int x_bf16, void* stream) {
  if (n_rows <= 0 || B <= 0) return 0;
  if (!valid_block(lanes, threads) || !valid_rhs_tile(kt, lanes, per_lane) ||
      rows_per_block < 1 || window < 0 || stage < 0 ||
      (window == 0 && (long long)rows_per_block * lanes != threads) ||
      (window > 0 && threads > 256)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(
      (unsigned)(((long long)n_rows + rows_per_block - 1) / rows_per_block),
      (unsigned)((B + kt - 1) / kt));
  if (window == 0) {
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
  const int x_size = x_bf16 ? 2 : 4;
  // the window, the rows' IRP, the stage and a heavy row's partial sums
  const long long smem = window_bytes(window, kt, x_size) +
                         irp_bytes(rows_per_block) + 8LL * stage +
                         4LL * (threads / lanes) * kt;
  // the window's rows are whole 16-byte runs at 16-byte aligned addresses
  const int tile_bytes = (B < kt ? B : kt) * x_size;
  const int bulk = aligned16(x) && (long long)B * x_size % 16 == 0 &&
                   tile_bytes % 16 == 0;
  const bool vec = vector_rows(per_lane, B, kt, x, x_size, y);
  cudaError_t err = cudaSuccess;
#define LAUNCH(TD, TX, P, V)                                                \
  do {                                                                      \
    if (smem > 48 * 1024) {                                                 \
      err = cudaFuncSetAttribute(csr_spmm_window<TD, TX, P, V>,             \
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, \
                                 (int)smem);                                \
      if (err != cudaSuccess) return (int)err;                              \
    }                                                                       \
    csr_spmm_window<TD, TX, P, V><<<grid, (unsigned)threads, (size_t)smem,  \
                                    s>>>(                                   \
        (const TD*)data, (const int*)cols, (const int*)indptr, (const TX*)x, \
        (float*)y, n_rows, n_cols, B, kt, lanes, rows_per_block, window,    \
        stage, bulk);                                                       \
  } while (0)
#define CALL(TD, TX)                   \
  switch (per_lane) {                  \
    case 1:                            \
      LAUNCH(TD, TX, 1, false);        \
      break;                           \
    case 2:                            \
      if (vec) {                       \
        LAUNCH(TD, TX, 2, true);       \
      } else {                         \
        LAUNCH(TD, TX, 2, false);      \
      }                                \
      break;                           \
    case 4:                            \
      if (vec) {                       \
        LAUNCH(TD, TX, 4, true);       \
      } else {                         \
        LAUNCH(TD, TX, 4, false);      \
      }                                \
      break;                           \
    default:                           \
      return (int)cudaErrorInvalidValue; \
  }
  DISPATCH_VALUE_TYPES(data_bf16, x_bf16, CALL);
#undef CALL
#undef LAUNCH
  return (int)cudaGetLastError();
}
