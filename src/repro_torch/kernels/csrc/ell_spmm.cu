// ELL SpMM for Hopper (sm_90a): Y[r, b] = sum_w data[r, w] * X[cols[r, w], b]
// with X (n_cols, B) and Y (n_rows, B), both row-major.
//
// Replaces the TPU kernel repro/kernels/ell_spmv.py:ell_spmm, whose grid
// (row_blocks, k_blocks, w_blocks) walks the band sequentially because a TPU
// runs its grid in order.  Here the band loop is inside the thread.
//
// Layout: a group of `lanes` threads (a power of two <= 32) owns one row and
// sits along the right-hand-side columns, so one gathered row X[c, :] is
// read, and one Y row is written, with coalesced accesses.  Each thread keeps
// PER columns in registers, so a group covers kt = lanes * PER columns of a
// column tile; grid.y walks the tiles.  Where B, the tile and the pointers
// allow (VEC), a thread's PER columns are consecutive, k0 + lane * PER + i,
// and it reads them as one vector load (16 bytes for 4 float32, 8 for 4
// bfloat16) and stores them as one; otherwise they are k0 + lane + i * lanes.
// The band is read once per group: lane j loads entry w0 + j of the row and
// the group shares it by shuffle, so data/cols cost one coalesced load per
// `lanes` entries (ELL-Row), whatever B is.  The panel is addressed through
// (row_stride, col_stride) in elements, so ELL-Row, ELL-Col (viewed
// transposed) and SELL buckets need no transpose copy.
//
// A warp-wide group (lanes == 32: B >= 17) gathers no X row for a padded
// slot (value +-0, column 0): a ballot over the 32 slots it loaded drops
// them, the rest move to the front (lane q takes the q-th by __fns and a
// shuffle), so its walk has no branch, and it takes the slots ELL_UNROLL at
// a time, issuing their X loads before their adds.  A row that had such a
// slot adds 0 * X[0, b] once after its band.  That gives the values that
// adding it at each such slot gives, but for the sign of a zero: for a
// finite X[0, b] the term is +-0, which leaves a non-zero sum unchanged, and
// for an infinite or NaN X[0, b] it is NaN once or many times.  A zero sum
// may change sign: an fmaf whose product underflows can leave -0 before a
// pad's +0 term (which then keeps it -0), where the term added once at the
// end gives +0.  So exactly the rows whose band holds such a slot turn NaN
// when X[0] is not finite, on both paths.  Stored zeros at other
// columns are still multiplied.  In a band padded to its longest row
// (xenon2: 43 slots for 24.6 entries a row) that saves 43 % of the gathers.
// A narrower group walks every slot one by one: there an X row is a few
// bytes, the pads' hit the same cached row X[0], and skipping them (or
// unrolling) cost more than it saved (PERF.md §6).
//
// Bound on an H100: bytes.  The least the card must move is the panel once
// (n_rows * width * (val + 4)), X once (val * n_cols * B) and Y once
// (4 * n_rows * B) over 3.35 TB/s, against 2 * nnz * B flops at 67 TF/s: at
// B = 128 that is still ~2 flops per byte, under the ~20 the card can feed.
// What the design cannot promise is that X is read only once: each stored
// entry gathers a whole X row, and whether a second touch of that row hits
// L2 depends on the matrix's column locality.
#include "common.cuh"

#define ELL_UNROLL 4  // slots whose X rows a warp-wide group loads together

template <typename TD, typename TX, int PER, bool VEC>
__global__ void ell_spmm_rows(const TD* __restrict__ data,
                              const int* __restrict__ cols,
                              const TX* __restrict__ x, float* __restrict__ y,
                              int n_rows, int width, long long row_stride,
                              long long col_stride, int B, int kt, int lanes) {
  const int lane = threadIdx.x % lanes;
  const long long r =
      (long long)blockIdx.x * (blockDim.x / lanes) + threadIdx.x / lanes;
  if (r >= n_rows) return;  // the whole group leaves together
  const unsigned mask = group_mask(lanes);
  const int k0 = blockIdx.y * kt;
  const int k_end = min(k0 + kt, B);
  const int b0 = VEC ? k0 + lane * PER : k0 + lane;
  const int stride = VEC ? 1 : lanes;  // from one of its columns to the next
  const TD* d = data + r * row_stride;
  const int* c = cols + r * row_stride;
  float acc[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) acc[i] = 0.f;
  bool pad = false;  // a (+-0, column 0) slot was skipped
  for (int w0 = 0; w0 < width; w0 += lanes) {
    const int w = w0 + lane;
    float dv = 0.f;
    int cv = 0;
    const bool in = w < width;
    if (in) {
      dv = to_f32<TD>(d[w * col_stride]);
      cv = c[w * col_stride];
    }
    int n = min(lanes, width - w0);
    if (lanes == 32) {
      // a warp-wide group drops its padded slots: the rest move to the
      // front (lane q takes the q-th), so the walk below has no branch
      const bool padslot = in && cv == 0 && dv == 0.f;
      const unsigned live = __ballot_sync(mask, in && !padslot);
      pad |= __any_sync(mask, padslot);
      n = __popc(live);
      const int src = lane < n ? (int)__fns(live, 0, lane + 1) : lane;
      dv = __shfl_sync(mask, dv, src, lanes);
      cv = __shfl_sync(mask, cv, src, lanes);
    }
    int j = 0;
    for (; lanes == 32 && j + ELL_UNROLL <= n; j += ELL_UNROLL) {
      float dj[ELL_UNROLL], xv[ELL_UNROLL][PER];
#pragma unroll
      for (int u = 0; u < ELL_UNROLL; ++u) {
        dj[u] = __shfl_sync(mask, dv, j + u, lanes);
        const int cj = __shfl_sync(mask, cv, j + u, lanes);
        x_row<TX, PER, VEC>(x, cj, B, b0, stride, k_end, xv[u]);
      }
#pragma unroll
      for (int u = 0; u < ELL_UNROLL; ++u) {
#pragma unroll
        for (int i = 0; i < PER; ++i) acc[i] = fmaf(dj[u], xv[u][i], acc[i]);
      }
    }
    for (; j < n; ++j) {
      const float dj = __shfl_sync(mask, dv, j, lanes);
      const int cj = __shfl_sync(mask, cv, j, lanes);
      float xv[PER];
      x_row<TX, PER, VEC>(x, cj, B, b0, stride, k_end, xv);
#pragma unroll
      for (int i = 0; i < PER; ++i) acc[i] = fmaf(dj, xv[i], acc[i]);
    }
  }
  if (pad) {
    float xv[PER];
    x_row<TX, PER, VEC>(x, 0, B, b0, stride, k_end, xv);
#pragma unroll
    for (int i = 0; i < PER; ++i) acc[i] = fmaf(0.f, xv[i], acc[i]);
  }
  store_row<PER, VEC>(y + r * (long long)B, b0, stride, k_end, acc);
}

// kt: right-hand-side columns per CUDA block; lanes: threads per row (power
// of two <= 32); per_lane: columns per thread (1, 2 or 4; lanes * per_lane >=
// kt); rows_per_block * lanes: threads per block (a whole number of warps,
// <= 1024).  The wrapper (kernels/ell_spmv.py) picks them.  Returns
// cudaGetLastError().
extern "C" int ell_spmm_launch(const void* data, const void* cols,
                               const void* x, void* y, int n_rows, int width,
                               long long row_stride, long long col_stride,
                               int B, int kt, int lanes, int per_lane,
                               int rows_per_block, int data_bf16, int x_bf16,
                               void* stream) {
  if (n_rows <= 0 || B <= 0) return 0;
  const long long threads = (long long)rows_per_block * lanes;
  if (!valid_block(lanes, threads) || !valid_rhs_tile(kt, lanes, per_lane)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(
      (unsigned)(((long long)n_rows + rows_per_block - 1) / rows_per_block),
      (unsigned)((B + kt - 1) / kt));
  const bool vec = vector_rows(per_lane, B, kt, x, x_bf16 ? 2 : 4, y);
#define LAUNCH(TD, TX, P, V)                                                 \
  ell_spmm_rows<TD, TX, P, V><<<grid, (unsigned)threads, 0, s>>>(            \
      (const TD*)data, (const int*)cols, (const TX*)x, (float*)y, n_rows,    \
      width, row_stride, col_stride, B, kt, lanes)
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
