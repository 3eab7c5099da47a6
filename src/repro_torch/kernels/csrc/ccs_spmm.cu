// CCS SpMM for Hopper (sm_90a): Y[rows[k], b] += data[k] * X[c, b] for
// IRP_T[c] <= k < IRP_T[c+1], X (n_cols, B) and Y (n_rows, B) row-major.
//
// Replaces the TPU kernel repro/kernels/ccs_spmv.py:ccs_spmm, whose grid
// (k_blocks, col_blocks, slabs) accumulates into an (n_rows, block_k) panel
// held on chip.  Blocks here run in no order and meet in Y through float32
// atomics into a zero-filled Y, so the design is about issuing few of them.
// Within a column the rows are distinct, so nothing sums before it leaves
// the column; but adjacent columns share rows (in a band around the diagonal,
// 32 adjacent columns hold ~790 entries on ~56 rows).  So:
//
// - A block owns cols_per_block adjacent columns and a tile of kt
//   right-hand-side columns (grid.y walks the tiles).  It stages IRP_T of
//   its columns and their X rows (the tile, in float32) in shared memory:
//   X is read from device memory once.
// - Its window is `window` consecutive rows of Y, centred on the rows its
//   columns map to (c * n_rows / n_cols).  The block's entries are contiguous
//   (IRP_T[c0] .. IRP_T[c0 + cols_per_block]); it takes them in chunks of
//   EPT a thread.  Each thread reads its entries (coalesced), finds their
//   columns by a binary search over the staged IRP_T and sorts them by
//   window row: a count a row (shared-memory integer atomics), a block-wide
//   scan, a scatter.  An entry outside the window joins a list instead.
// - The block's threads form groups of `lanes` along the tile (PER columns a
//   thread: kt <= lanes * PER).  Group g owns window rows g, g + G, ...
//   (RPG of them) and keeps their tile in registers: for each of its rows it
//   walks that row's entries, adding value * X row (from shared memory).  No
//   two threads ever add to one place, so there is no atomic on the chip,
//   and a row's sum stays in registers across chunks.  The groups then take
//   the entries outside the window in turn, each straight to Y with global
//   atomics.
// - At the end each group adds each row it owns that an entry touched to Y:
//   one atomic a thread and row (a float4 where B allows).
//
// So a banded matrix issues about one global atomic per touched row and
// block instead of one per entry, and a scattered one (every entry outside)
// what the one-column-a-group design issued.  Correctness does not depend on
// the window's place, only the cost does.  The order of the sum changes from
// run to run (the sort's atomics): compared to a tolerance.
//
// Below 17 right-hand-side columns a tile (lanes < 32) an entry's work is a
// few multiply-adds, and the sort costs more than the atomics it saves (a
// scattered matrix loses most): there ccs_spmm_columns runs, a lane group a
// column that keeps the column's X slice in registers and adds each entry's
// contributions straight to Y (window 0 from the wrapper).
//
// Bound on an H100: bytes — nnz * (val + 4) + 4 * (n_cols + 1) for A,
// val * n_cols * B for X and 4 * n_rows * B for Y, over 3.35 TB/s, against
// 2 * nnz * B flops at 67 TF/s.
#include "common.cuh"

#define CCS_EPT 4  // entries a thread sorts per chunk

// Narrow tiles: a group of `lanes` threads owns a column (one column of the
// tile a thread), loads its X slice once and walks the column's entries
// (lane j loads entry e0 + j, the group shares it by shuffle), adding each
// entry's contributions to Y with float32 atomics.
template <typename TD, typename TX>
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
  const int b = blockIdx.y * kt + lane;
  const bool live = b < min(blockIdx.y * kt + kt, B);
  const float xv = live ? to_f32<TX>(x[c * (long long)B + b]) : 0.f;
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
      if (live) atomicAdd(y + (long long)rj * B + b, dj * xv);
    }
  }
}

// Exclusive prefix sum of a[0..n) in place by the whole block (n <= 16 *
// blockDim.x, blockDim.x a whole number of warps); `warp_sums` holds 32 ints.
__device__ void block_exclusive_scan(int* a, int n, int* warp_sums) {
  constexpr unsigned FULL = 0xffffffffu;
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int lo = min(t * per, n), hi = min(lo + per, n);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += a[i];
  int inc = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int up = __shfl_up_sync(FULL, inc, off);
    if (lane >= off) inc += up;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int mine = lane < (int)(blockDim.x / 32) ? warp_sums[lane] : 0;
    int w_inc = mine;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int up = __shfl_up_sync(FULL, w_inc, off);
      if (lane >= off) w_inc += up;
    }
    if (lane < (int)(blockDim.x / 32)) warp_sums[lane] = w_inc - mine;
  }
  __syncthreads();
  int run = warp_sums[warp] + inc - sum;
  for (int i = lo; i < hi; ++i) {
    const int v = a[i];
    a[i] = run;
    run += v;
  }
  __syncthreads();
}

// The lane's PER columns of a staged X row (`xr`, the tile in order).
template <int PER, bool VEC>
__device__ __forceinline__ void tile_row(const float* xr, int lane, int lanes,
                                         float (&v)[PER]) {
  if constexpr (VEC && PER == 4) {
    const float4 w = reinterpret_cast<const float4*>(xr)[lane];
    v[0] = w.x;
    v[1] = w.y;
    v[2] = w.z;
    v[3] = w.w;
  } else if constexpr (VEC && PER == 2) {
    const float2 w = reinterpret_cast<const float2*>(xr)[lane];
    v[0] = w.x;
    v[1] = w.y;
  } else {
#pragma unroll
    for (int i = 0; i < PER; ++i) v[i] = xr[lane + i * lanes];
  }
}

// VEC: a thread's PER columns are consecutive, k0 + lane * PER + i, and its
// adds to Y are one vector (the entry point checks B, kt and the pointers);
// otherwise they are k0 + lane + i * lanes.  RPG: window rows a group owns.
// The dynamic shared memory holds the X rows (cols_per_block * lanes * PER
// floats), IRP_T of the columns, a count a window row, and the chunk's
// sorted entries and outside list (5 words an entry of a chunk).
template <int PER, bool VEC, int RPG>
__global__ void __launch_bounds__(256, 3)
    ccs_spmm_window(const void* __restrict__ data, const int* __restrict__ rows,
                    const int* __restrict__ indptr, const void* __restrict__ x,
                    float* __restrict__ y, int n_rows, int n_cols, int B,
                    int kt, int lanes, int cols_per_block, int window,
                    int data_bf16, int x_bf16, int x_vec) {
  constexpr unsigned FULL = 0xffffffffu;
  extern __shared__ __align__(16) float smem[];
  __shared__ int out_n;
  __shared__ int warp_sums[32];
  const int T = blockDim.x, t = threadIdx.x;
  const int lane = t % lanes, g = t / lanes, G = T / lanes;
  const int width = lanes * PER;
  const int cpb = cols_per_block;
  const int cap = CCS_EPT * T;
  float* xs = smem;                                 // cpb * width
  int* colp = reinterpret_cast<int*>(xs + cpb * width);  // cpb + 1
  int* bucket = colp + cpb + 1;                     // window
  float* in_val = reinterpret_cast<float*>(bucket + window);  // cap
  int* in_col = reinterpret_cast<int*>(in_val + cap);         // cap
  int* out_row = in_col + cap;                                // cap
  float* out_val = reinterpret_cast<float*>(out_row + cap);   // cap
  int* out_col = reinterpret_cast<int*>(out_val + cap);       // cap

  const long long c0 = (long long)blockIdx.x * cpb;
  const int ncols = (int)min((long long)cpb, n_cols - c0);
  long long base = (2 * c0 + cpb) * (long long)n_rows / (2LL * n_cols) -
                   window / 2;
  base = max(0LL, min(base, (long long)n_rows - window));
  const int k0 = blockIdx.y * kt;
  const int k_end = min(k0 + kt, B);
  const int b0 = VEC ? k0 + lane * PER : k0 + lane;
  const int stride = VEC ? 1 : lanes;  // from one of its columns to the next

  // the block's columns: IRP_T and the X rows of the tile, in float32
  for (int i = t; i <= ncols; i += T) colp[i] = indptr[c0 + i];
  // x_vec consecutive values a load (8 bfloat16 or 4 float32 in 16 bytes,
  // where B, the tile and the pointer allow; else 1)
  for (int i = t * x_vec; i < cpb * width; i += T * x_vec) {
    const int cl = i / width, b = k0 + i - cl * width;
    const long long at = (c0 + cl) * (long long)B + b;
    if (x_vec > 1 && cl < ncols && b + x_vec <= k_end) {
      const uint4 w = __ldcs(reinterpret_cast<const uint4*>(
          x_bf16 ? (const void*)(reinterpret_cast<const __nv_bfloat16*>(x) +
                                 at)
                 : (const void*)(reinterpret_cast<const float*>(x) + at)));
      float4* out = reinterpret_cast<float4*>(xs + i);
      if (x_bf16) {
        out[0] = make_float4(__uint_as_float(w.x << 16),
                             __uint_as_float(w.x & 0xffff0000u),
                             __uint_as_float(w.y << 16),
                             __uint_as_float(w.y & 0xffff0000u));
        out[1] = make_float4(__uint_as_float(w.z << 16),
                             __uint_as_float(w.z & 0xffff0000u),
                             __uint_as_float(w.w << 16),
                             __uint_as_float(w.w & 0xffff0000u));
      } else {
        out[0] = make_float4(__uint_as_float(w.x), __uint_as_float(w.y),
                             __uint_as_float(w.z), __uint_as_float(w.w));
      }
    } else {
      for (int j = 0; j < x_vec; ++j) {
        float v = 0.f;
        if (cl < ncols && b + j < k_end) {
          v = x_bf16 ? __bfloat162float(
                           reinterpret_cast<const __nv_bfloat16*>(x)[at + j])
                     : reinterpret_cast<const float*>(x)[at + j];
        }
        xs[i + j] = v;
      }
    }
  }
  __syncthreads();
  const int e_begin = colp[0], e_end = colp[ncols];

  float acc[RPG][PER];
#pragma unroll
  for (int j = 0; j < RPG; ++j) {
#pragma unroll
    for (int i = 0; i < PER; ++i) acc[j][i] = 0.f;
  }
  unsigned touched = 0;  // bit j: row j * G + g has an entry
  for (int ch = e_begin; ch < e_end; ch += cap) {
    const int ch_end = min(ch + cap, e_end);
    for (int i = t; i < window; i += T) bucket[i] = 0;
    if (t == 0) out_n = 0;
    __syncthreads();
    // each thread's entries: window row (or -1), value, column in the block
    int kw[CCS_EPT], kc[CCS_EPT];
    float kv[CCS_EPT];
#pragma unroll
    for (int q = 0; q < CCS_EPT; ++q) {
      const int e = ch + t + q * T;
      int r = 0, cl = 0;
      float v = 0.f;
      kw[q] = -1;
      bool outside = false;
      if (e < ch_end) {
        r = __ldcs(rows + e);
        v = data_bf16
                ? __uint_as_float(
                      (unsigned)__ldcs(
                          reinterpret_cast<const unsigned short*>(data) + e)
                      << 16)
                : __ldcs(reinterpret_cast<const float*>(data) + e);
        int lo = 0, hi = ncols - 1;  // the last column starting at or before e
        while (lo < hi) {
          const int mid = (lo + hi + 1) >> 1;
          if (colp[mid] <= e) {
            lo = mid;
          } else {
            hi = mid - 1;
          }
        }
        cl = lo;
        const long long w = r - base;
        if (w >= 0 && w < window) {
          kw[q] = (int)w;
          atomicAdd(bucket + w, 1);
        } else {
          outside = true;
        }
      }
      kv[q] = v;
      kc[q] = cl;
      // the outside list, one shared atomic a warp
      const unsigned m = __ballot_sync(FULL, outside);
      if (m) {
        const int leader = __ffs(m) - 1, me = t % 32;
        int o = 0;
        if (me == leader) o = atomicAdd(&out_n, __popc(m));
        o = __shfl_sync(FULL, o, leader) + __popc(m & ((1u << me) - 1u));
        if (outside) {
          out_row[o] = r;
          out_val[o] = v;
          out_col[o] = cl;
        }
      }
    }
    __syncthreads();
    block_exclusive_scan(bucket, window, warp_sums);
    // the sort: bucket[w] moves from the row's first slot to its end
#pragma unroll
    for (int q = 0; q < CCS_EPT; ++q) {
      if (kw[q] >= 0) {
        const int at = atomicAdd(bucket + kw[q], 1);
        in_val[at] = kv[q];
        in_col[at] = kc[q];
      }
    }
    __syncthreads();
    // each group sums the entries of its rows into registers
#pragma unroll
    for (int j = 0; j < RPG; ++j) {
      const int w = j * G + g;
      if (w < window) {  // uniform over the group
        const int lo = w > 0 ? bucket[w - 1] : 0, hi = bucket[w];
        if (hi > lo) touched |= 1u << j;
#pragma unroll 4
        for (int at = lo; at < hi; ++at) {
          float xv[PER];
          tile_row<PER, VEC>(xs + in_col[at] * width, lane, lanes, xv);
          const float v = in_val[at];
#pragma unroll
          for (int i = 0; i < PER; ++i) acc[j][i] = fmaf(v, xv[i], acc[j][i]);
        }
      }
    }
    // the entries outside the window, straight to Y
    const int n_out = out_n;
    for (int o = g; o < n_out; o += G) {
      float xv[PER];
      tile_row<PER, VEC>(xs + out_col[o] * width, lane, lanes, xv);
      const float v = out_val[o];
#pragma unroll
      for (int i = 0; i < PER; ++i) xv[i] *= v;
      float* yr = y + (long long)out_row[o] * B + b0;
      if (VEC) {
        if (b0 < k_end) add_row<PER>(yr, xv);
      } else {
#pragma unroll
        for (int i = 0; i < PER; ++i) {
          if (b0 + i * stride < k_end) atomicAdd(yr + i * stride, xv[i]);
        }
      }
    }
    __syncthreads();
  }

  // each touched row the group owns, added to Y once
#pragma unroll
  for (int j = 0; j < RPG; ++j) {
    if (!(touched >> j & 1u)) continue;
    float* yr = y + (base + j * G + g) * (long long)B + b0;
    if (VEC) {
      if (b0 < k_end) add_row<PER>(yr, acc[j]);
    } else {
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        if (b0 + i * stride < k_end) atomicAdd(yr + i * stride, acc[j][i]);
      }
    }
  }
}

// kt, lanes, per_lane as for ell_spmm_launch; threads: threads per block (a
// whole number of groups and of warps); cols_per_block: the block's columns;
// window: rows of its window, 0 for the column kernel (then threads =
// cols_per_block * lanes and per_lane = 1); else threads <= 256, window at
// most rows_per_group * threads / lanes and at most n_rows, rows_per_group
// 2, 4, 8 or 16.  The window kernel's shared memory stays under 48 KB for
// every shape the wrapper picks (at most 16 KB of X rows, 4 KB of IRP_T,
// 16 KB of counts, 20 KB of entries).  y must be zero-filled by the caller.
// The wrapper (kernels/ccs_spmv.py) picks them.  Returns cudaGetLastError().
extern "C" int ccs_spmm_launch(const void* data, const void* rows,
                               const void* indptr, const void* x, void* y,
                               int n_rows, int n_cols, int B, int kt,
                               int lanes, int per_lane, int threads,
                               int cols_per_block, int window,
                               int rows_per_group, int data_bf16, int x_bf16,
                               void* stream) {
  if (n_cols <= 0 || n_rows <= 0 || B <= 0) return 0;
  if (!valid_block(lanes, threads) || !valid_rhs_tile(kt, lanes, per_lane) ||
      cols_per_block < 1 || window < 0 || window > n_rows) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(
      (unsigned)(((long long)n_cols + cols_per_block - 1) / cols_per_block),
      (unsigned)((B + kt - 1) / kt));
  if (window == 0) {
    if (per_lane != 1 || (long long)cols_per_block * lanes != threads) {
      return (int)cudaErrorInvalidValue;
    }
#define CALL(TD, TX)                                                         \
  ccs_spmm_columns<TD, TX><<<grid, (unsigned)threads, 0, s>>>(               \
      (const TD*)data, (const int*)rows, (const int*)indptr, (const TX*)x,   \
      (float*)y, n_cols, B, kt, lanes)
    DISPATCH_VALUE_TYPES(data_bf16, x_bf16, CALL);
#undef CALL
    return (int)cudaGetLastError();
  }
  if (threads > 256 ||
      (long long)window > (long long)rows_per_group * (threads / lanes)) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem =
      sizeof(float) * ((size_t)cols_per_block * lanes * per_lane +
                       cols_per_block + 1 + window + 5 * CCS_EPT * threads);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  // one vector per thread and row: B and the tile hold whole vectors and Y
  // is aligned to them
  const bool vec = per_lane > 1 && B % per_lane == 0 && kt % per_lane == 0 &&
                   (std::uintptr_t)y % (per_lane * 4) == 0;
  // X rows staged 16 bytes a load where B, the tile and X allow
  const int x_vec_max = x_bf16 ? 8 : 4;
  const int x_vec = aligned16(x) && B % x_vec_max == 0 &&
                            kt % x_vec_max == 0 &&
                            (lanes * per_lane) % x_vec_max == 0
                        ? x_vec_max
                        : 1;
#define LAUNCH(P, V, R)                                                   \
  ccs_spmm_window<P, V, R><<<grid, (unsigned)threads, smem, s>>>(         \
      data, (const int*)rows, (const int*)indptr, x, (float*)y, n_rows,   \
      n_cols, B, kt, lanes, cols_per_block, window, data_bf16, x_bf16,    \
      x_vec)
#define ROWS(P, V)                               \
  switch (rows_per_group) {                      \
    case 2: LAUNCH(P, V, 2); break;              \
    case 4: LAUNCH(P, V, 4); break;              \
    case 8: LAUNCH(P, V, 8); break;              \
    case 16: LAUNCH(P, V, 16); break;            \
    default: return (int)cudaErrorInvalidValue; \
  }
  switch (per_lane) {
    case 1:
      ROWS(1, false);
      break;
    case 2:
      if (vec) {
        ROWS(2, true);
      } else {
        ROWS(2, false);
      }
      break;
    case 4:
      if (vec) {
        ROWS(4, true);
      } else {
        ROWS(4, false);
      }
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef ROWS
#undef LAUNCH
  return (int)cudaGetLastError();
}
