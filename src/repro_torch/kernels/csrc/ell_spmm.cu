// ELL SpMM for Hopper (sm_90a): Y[r, b] = sum_w data[r, w] * X[cols[r, w], b]
// with X (n_cols, B) and Y (n_rows, B), both row-major.
//
// Replaces the TPU kernel repro/kernels/ell_spmv.py:ell_spmm, whose grid
// (row_blocks, k_blocks, w_blocks) walks the band sequentially because a TPU
// runs its grid in order.  Here the band loop is inside the thread.
//
// Layout: a group of `lanes` threads (a power of two <= 32) owns one row and
// sits along the right-hand-side columns, so consecutive threads touch
// consecutive b: one gathered row X[c, :] is read, and one Y row is written,
// with coalesced accesses.  Each thread keeps PER columns (b = k0 + lane +
// i * lanes) in registers, so a group covers kt = lanes * PER columns of a
// column tile; grid.y walks the tiles.  The band is read once per group: lane
// j loads entry w0 + j of the row and the group shares it by shuffle, so
// data/cols cost one coalesced load per `lanes` entries (ELL-Row), whatever
// B is.  The panel is addressed through (row_stride, col_stride) in elements,
// so ELL-Row, ELL-Col (viewed transposed) and SELL buckets need no transpose
// copy.  Padded slots (val 0, col 0) add zero.
//
// Bound on an H100: bytes.  The least the card must move is the panel once
// (n_rows * width * (val + 4)), X once (val * n_cols * B) and Y once
// (4 * n_rows * B) over 3.35 TB/s, against 2 * nnz * B flops at 67 TF/s: at
// B = 128 that is still ~2 flops per byte, under the ~20 the card can feed.
// What the design cannot promise is that X is read only once: each stored
// entry gathers a whole X row, and whether a second touch of that row hits
// L2 depends on the matrix's column locality.
#include "common.cuh"

template <typename TD, typename TX, int PER>
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
  const TD* d = data + r * row_stride;
  const int* c = cols + r * row_stride;
  float acc[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) acc[i] = 0.f;
  for (int w0 = 0; w0 < width; w0 += lanes) {
    const int w = w0 + lane;
    float dv = 0.f;
    int cv = 0;
    if (w < width) {
      dv = to_f32<TD>(d[w * col_stride]);
      cv = c[w * col_stride];
    }
    const int n = min(lanes, width - w0);
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
#define LAUNCH(TD, TX, P)                                                    \
  ell_spmm_rows<TD, TX, P><<<grid, (unsigned)threads, 0, s>>>(               \
      (const TD*)data, (const int*)cols, (const TX*)x, (float*)y, n_rows,    \
      width, row_stride, col_stride, B, kt, lanes)
#define CALL(TD, TX) DISPATCH_PER_LANE(per_lane, LAUNCH, TD, TX)
  DISPATCH_VALUE_TYPES(data_bf16, x_bf16, CALL);
#undef CALL
#undef LAUNCH
  return (int)cudaGetLastError();
}
