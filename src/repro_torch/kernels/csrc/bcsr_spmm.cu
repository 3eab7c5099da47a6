// BCSR SpMM for Hopper (sm_90a): Y[br*b + i, c] = sum over the stored
// blocks p of block row br of sum_j data[p, i, j] * X[bc[p]*b + j, c],
// X (n_cols, B) and Y (n_rows, B) row-major, float32 sums and output.
//
// Replaces the TPU kernel repro/kernels/bcsr_spmv.py:bcsr_spmm, whose grid
// (row_tiles, k_blocks, slabs) contracts on-chip slabs of b x b tiles against
// (b, block_k) slices of an X padded to whole blocks ("pij,pjc->pic").  X is
// not padded here: rows bc*b + j >= n_cols are masked, and rows of the last
// block row past n_rows are not written.  Block rows are disjoint, so there
// are no atomics and the result is deterministic.
//
// Bound on an H100: bytes — nblocks * (b*b*val + 4) + 4 * (nbr + 1) for A,
// val * n_cols * B for X and 4 * n_rows * B for Y, over 3.35 TB/s, against
// 2 * nblocks * b*b * B flops (the explicit zeros of a block are multiplied
// too).  What kept the first port's kernel (bcsr_spmm_rows, below) at half
// of it: a lane group owned a block row and every column of the tile, and for
// each stored block every thread issued b*b single-address loads of the
// block's values, b loads of X and b*b*PER FFMA; and each block gathered its
// b X rows afresh through L2 (five times the X panel on xenon2 at scale 4).
//
// The tensor-core kernel (bcsr_spmm_mma), for b = 4, 8 and 16 at a column
// tile of at least BCSR_MMA_MIN_COLS (kernels/_common.py picks it):
//  1. A block row's product is written transposed, Y^T (B x b) = sum_p
//     X^T_{bc_p} (B x b) . A_p^T (b x b), so an 8 x 8 block is one
//     mma.sync.m16n8k8 (M = 16 columns of the tile, N = the block's 8 rows,
//     K = its 8 columns) per 16 columns; b = 16 is 2 x 2 such tiles, b = 4
//     pads N and K with zeros.  A float32 operand goes in as 3xTF32: hi =
//     v cut to TF32's 10 mantissa bits, lo = v - hi, and the product is
//     hi.hi + hi.lo + lo.hi, within ~3 * 2^-20 of a.x (a single TF32
//     product keeps ~3 digits and misses the 1e-4 of sum |a.x| the kernel
//     is held to); a bfloat16 operand is exact in TF32, so a mixed pair is
//     two mma.  A bf16 x bf16 product runs mma.sync.m16n8k16 on the
//     operands as stored: two stored blocks of a block row (b = 8) or one
//     block (b = 16, N = 2 x 8) are one K = 16 step, X^T's fragments come
//     by ldmatrix.trans from the slice rows.  A non-finite value gives a
//     non-finite output (NaN where the plain version may give an infinity).
//  2. A block's X slice (b consecutive rows of the panel's column tile) and
//     its b*b values come to shared memory by bulk asynchronous copies
//     (cp.async.bulk, completion on an mbarrier), one a slice row into rows
//     padded so the fragment loads hit every bank (row pitch = 8 words mod
//     32 for float32 X, 4 for bfloat16).  Each warp owns consecutive block
//     rows and walks their blocks as one stream through a ring of
//     `slots / warps` slices, so the next blocks' slices are in flight while
//     the current ones are multiplied.
// Where X's rows are not 16-byte runs (B * val % 16) the slices are filled
// by plain loads of the warp.  Rows of a slice past n_cols are zeros.
#include <type_traits>

#include "common.cuh"

#define BCSR_MMA_THREADS 256   // most threads of a tensor-core block
#define BCSR_MMA_MAX_SLOTS 32  // most slices (and mbarriers) it holds
// static shared memory of such a block, at most (its mbarriers): a launch
// needs the attribute once static and dynamic pass 48 KB
#define BCSR_MMA_STATIC_SMEM 1024

// ---------------------------------------------------------------------------
// the first port's kernel: any b, and the narrow column tiles
// ---------------------------------------------------------------------------
// A group of `lanes` threads owns one (block row, column tile) pair and sits
// along the right-hand-side columns (PER columns a thread, grid.y walks
// column tiles of kt), as in csr_spmm.cu.  For each stored block it loads the
// b x kt slice of X row by row, coalesced along B, and keeps b x PER float32
// accumulators in registers; the block's values are read by every lane of
// the group (one address per load: a broadcast).  b = 4, 8 and 16 keep one
// block's accumulators in registers at once; any other b walks the block in
// chunks of 8 rows.

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


// ---------------------------------------------------------------------------
// the tensor-core kernel
// ---------------------------------------------------------------------------
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// One arrival that also expects `bytes` of bulk copies on the barrier.
__device__ __forceinline__ void bar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global to
// shared memory, completed on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// An operand as TF32: hi = v with its 13 low mantissa bits cleared and,
// for a float32 operand (SPLIT), lo = v - hi (exact), of which the tensor
// core reads the top 19 bits: |v - hi - lo'| < 2^-20 |v|; a bfloat16
// widened to float32 is exact in TF32.
template <bool SPLIT>
__device__ __forceinline__ void tf32_split(float v, unsigned& hi,
                                           unsigned& lo) {
  if constexpr (SPLIT) {
    hi = __float_as_uint(v) & 0xffffe000u;
    lo = __float_as_uint(v - __uint_as_float(hi));
  } else {
    hi = __float_as_uint(v);
    lo = 0u;
  }
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One stored block: acc[mt][nt] (columns mt*16.. of the tile, rows nt*8.. of
// the block) += X slice (xs: b rows of sx values, zeros past n_cols) times
// the block's values (ds: b x b, row-major), for the nmt 16-column tiles the
// tile holds.  Lane (g = lane / 4, t = lane % 4) holds, as mma.sync lays
// them out: A = X^T, rows g and g + 8 (columns of the tile), columns t and
// t + 4 (rows of the slice); B = A_p^T, column g (a row of the block), rows
// t and t + 4; C rows g and g + 8, columns 2t and 2t + 1.
template <typename TD, typename TX, int BS>
__device__ __forceinline__ void block_mma(const TX* __restrict__ xs, int sx,
                                          const TD* __restrict__ ds, int nmt,
                                          int g, int t,
                                          float (&acc)[8][(BS + 7) / 8][4]) {
  constexpr int NT = (BS + 7) / 8;
  constexpr bool FX = std::is_same<TX, float>::value;
  constexpr bool FD = std::is_same<TD, float>::value;
#pragma unroll
  for (int ks = 0; ks < NT; ++ks) {
    unsigned bh[NT][2], bl[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = ks * 8 + t + 4 * h, n = nt * 8 + g;
        const float v = (k < BS && n < BS) ? to_f32<TD>(ds[n * BS + k]) : 0.f;
        tf32_split<FD>(v, bh[nt][h], bl[nt][h]);
      }
    }
#pragma unroll
    for (int mt = 0; mt < 8; ++mt) {
      if (mt < nmt) {
        const TX* xr = xs + (ks * 8 + t) * sx + mt * 16 + g;
        float av[4];
        av[0] = to_f32<TX>(xr[0]);
        av[1] = to_f32<TX>(xr[8]);
        if constexpr (BS > 4) {
          av[2] = to_f32<TX>(xr[4 * sx]);
          av[3] = to_f32<TX>(xr[4 * sx + 8]);
        } else {
          av[2] = av[3] = 0.f;
        }
        unsigned ah[4], al[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) tf32_split<FX>(av[i], ah[i], al[i]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          // the small terms first
          if constexpr (FX) mma_tf32(acc[mt][nt], al, bh[nt]);
          if constexpr (FD) mma_tf32(acc[mt][nt], ah, bl[nt]);
          mma_tf32(acc[mt][nt], ah, bh[nt]);
        }
      }
    }
  }
}

// Four 8 x 8 tiles of 16-bit values, transposed, from shared memory: lane l
// gives the address of row l % 8 of tile l / 8 and receives, of tile i,
// a[i] = (row 2t, column g) and (row 2t + 1, column g) — the A fragment of
// an m16n8k16 mma whose rows are the tiles' columns.
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&a)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(smem_u32(p)));
}

// The same for two tiles (lanes 0-15 give the addresses).
__device__ __forceinline__ void ldsm_x2_trans(unsigned& a0, unsigned& a1,
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];"
      : "=r"(a0), "=r"(a1)
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One K = 16 step of bf16 x bf16 products: acc[mt][nt] += X^T (the 16
// slice rows k: 0-7 from x0, 8-15 from x1, rows `stride` bytes apart) times
// the values (rows n of the block row, k 0-7 at d0 + n * BS, 8-15 at d1 +
// n * BS).  b = 8: two stored blocks (x1, d1 the second's; null: none, its
// half of K is zeros); b = 16: one block, x1 = x0 + 8 rows, d1 = d0 + 8.
// Lane (g, t) holds B = values[n = nt * 8 + g][k = 2t, 2t + 1 (+ 8)].
template <int BS>
__device__ __forceinline__ void block_mma_bf16(
    const unsigned char* x0, const unsigned char* x1, int stride,
    const __nv_bfloat16* d0, const __nv_bfloat16* d1, int nmt, int lane,
    float (&acc)[8][(BS + 7) / 8][4]) {
  constexpr int NT = (BS + 7) / 8;
  const int g = lane >> 2, t = lane & 3;
  const int tile = lane >> 3, r = lane & 7;
  unsigned b0[NT], b1[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int at = (nt * 8 + g) * BS + 2 * t;
    b0[nt] = *reinterpret_cast<const unsigned*>(d0 + at);
    b1[nt] = d1 ? *reinterpret_cast<const unsigned*>(d1 + at) : 0u;
  }
  // lane's row address: tiles 0, 1 the columns 0-7, 8-15 of rows x0,
  // tiles 2, 3 those of x1
  const unsigned char* row =
      (tile < 2 ? x0 : (x1 ? x1 : x0)) + r * stride + (tile & 1) * 16;
#pragma unroll
  for (int mt = 0; mt < 8; ++mt) {
    if (mt < nmt) {
      unsigned a[4];
      if (x1) {
        ldsm_x4_trans(a, row + mt * 32);
      } else {
        ldsm_x2_trans(a[0], a[1], row + mt * 32);
        a[2] = a[3] = 0u;
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mt][nt], a, b0[nt], b1[nt]);
    }
  }
}

template <int BS>
__device__ __forceinline__ void zero_acc(float (&acc)[8][(BS + 7) / 8][4]) {
#pragma unroll
  for (int mt = 0; mt < 8; ++mt) {
#pragma unroll
    for (int nt = 0; nt < (BS + 7) / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
    }
  }
}

// A block row's b rows of Y (from row0), columns c0 .. c_end - 1.
template <int BS>
__device__ __forceinline__ void store_block_row(
    float* __restrict__ y, const float (&acc)[8][(BS + 7) / 8][4],
    long long row0, int n_rows, int B, int c0, int c_end, int nmt, int g,
    int t) {
#pragma unroll
  for (int mt = 0; mt < 8; ++mt) {
    if (mt < nmt) {
#pragma unroll
      for (int nt = 0; nt < (BS + 7) / 8; ++nt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = c0 + mt * 16 + g + 8 * h;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = nt * 8 + 2 * t + e;
            if (c < c_end && i < BS && row0 + i < n_rows) {
              y[(row0 + i) * B + c] = acc[mt][nt][2 * h + e];
            }
          }
        }
      }
    }
  }
}

// A CUDA block of `warps` warps owns rows_per_cta consecutive block rows
// (warp w the w-th run of ceil(rows_per_cta / warps)) and one column tile of
// kt.  Its dynamic shared memory holds `slots` slices of b rows of `stride`
// bytes and b*b values, `slots / warps` a warp.  bulk: whether X's rows
// and the values are 16-byte runs at 16-byte aligned addresses.
template <typename TD, typename TX, int BS>
__global__ void __launch_bounds__(BCSR_MMA_THREADS)
    bcsr_spmm_mma(const TD* __restrict__ data,
                  const int* __restrict__ block_cols,
                  const int* __restrict__ indptr, const TX* __restrict__ x,
                  float* __restrict__ y, int n_rows, int n_cols, int nbr,
                  int B, int kt, int rows_per_cta, int slots, int stride,
                  int bulk) {
  constexpr int NT = (BS + 7) / 8;
  constexpr int DBLK = BS * BS * (int)sizeof(TD);  // bytes of a block
  // bf16 x bf16 at b = 8 or 16: m16n8k16 on the stored values; at b = 8
  // two blocks of a block row a step (PAIR)
  constexpr bool BF16 = std::is_same<TD, __nv_bfloat16>::value &&
                        std::is_same<TX, __nv_bfloat16>::value &&
                        (BS == 8 || BS == 16);
  constexpr bool PAIR = BF16 && BS == 8;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) unsigned long long bars[BCSR_MMA_MAX_SLOTS];

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int warps = blockDim.x / 32;
  const int g = lane >> 2, t = lane & 3;
  const int br0 = blockIdx.x * rows_per_cta;
  const int nr = min(rows_per_cta, nbr - br0);
  const int k0 = blockIdx.y * kt;
  const int tile = min(kt, B - k0);
  const int nmt = (tile + 15) / 16;
  const unsigned tile_bytes = (unsigned)tile * sizeof(TX);
  const int sx = stride / (int)sizeof(TX);  // values a slice row holds
  const int xslice = BS * stride;           // bytes of a slice's X rows
  const int rpw = (rows_per_cta + warps - 1) / warps;
  const int wr0 = min(nr, warp * rpw), wr1 = min(nr, wr0 + rpw);
  if (wr0 >= wr1) return;
  float acc[8][NT][4];

  // each warp streams the blocks of its block rows through `ns` slices,
  // the next ones in flight while it multiplies
  const int ns = slots / warps;
  const int slice = xslice + DBLK;
  unsigned char* ring = smem + (long long)warp * ns * slice;
  const unsigned bar0 = smem_u32(&bars[warp * ns]);
  if (bulk && lane < ns) bar_init(bar0 + 8 * lane);
  __syncwarp();
  const int Q0 = indptr[br0 + wr0], Q1 = indptr[br0 + wr1];
  // the block columns of the next 32 blocks to fetch, a lane each
  int cbase = Q0;
  int cnext = Q0 + lane < Q1 ? block_cols[Q0 + lane] : 0;
  auto fetch = [&](int s, int q) {
    if (q - cbase >= 32) {
      cbase += 32;
      cnext = cbase + lane < Q1 ? block_cols[cbase + lane] : 0;
    }
    const int c = __shfl_sync(0xffffffffu, cnext, q - cbase);
    const int jmax = min(BS, n_cols - c * BS);
    unsigned char* dst = ring + (long long)s * slice;
    const TX* src = x + (long long)c * BS * B + k0;
    if (bulk) {
      const unsigned bar = bar0 + 8 * s;
      if (lane == 0) bar_expect(bar, (unsigned)jmax * tile_bytes + DBLK);
      __syncwarp();
      // the warp's reads of the slice this copy overwrites come first
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      if (lane < jmax) {
        bulk_copy(dst + (long long)lane * stride, src + (long long)lane * B,
                  tile_bytes, bar);
      }
      if (lane == 31) {
        bulk_copy(dst + xslice, data + (long long)q * BS * BS, DBLK, bar);
      }
    } else {
      for (int i = lane; i < jmax * tile; i += 32) {
        const int r = i / tile, cc = i - r * tile;
        reinterpret_cast<TX*>(dst + (long long)r * stride)[cc] =
            src[(long long)r * B + cc];
      }
      for (int i = lane; i < BS * BS; i += 32) {
        reinterpret_cast<TD*>(dst + xslice)[i] =
            data[(long long)q * BS * BS + i];
      }
    }
    for (int i = lane; i < (BS - jmax) * (stride / 4); i += 32) {
      reinterpret_cast<unsigned*>(dst + (long long)jmax * stride)[i] = 0u;
    }
  };
  for (int s = 0; s < ns && Q0 + s < Q1; ++s) fetch(s, Q0 + s);
  int q = Q0, i = 0;
  for (int r = wr0; r < wr1; ++r) {
    const int qe = indptr[br0 + r + 1];
    zero_acc<BS>(acc);
    while (q < qe) {
      const int s = i % ns;
      if (bulk) bar_wait(bar0 + 8 * s, (unsigned)(i / ns) & 1u);
      const unsigned char* src = ring + (long long)s * slice;
      if constexpr (BF16) {
        // the block row's next block shares the step (b = 8, a ring of 2+)
        const bool two = PAIR && ns >= 2 && q + 1 < qe;
        const int s1 = (i + 1) % ns;
        if (two && bulk) {
          bar_wait(bar0 + 8 * s1, (unsigned)((i + 1) / ns) & 1u);
        }
        __syncwarp();
        const unsigned char* src1 = ring + (long long)s1 * slice;
        const auto* d0 = reinterpret_cast<const __nv_bfloat16*>(src + xslice);
        if constexpr (PAIR) {
          block_mma_bf16<BS>(
              src, two ? src1 : nullptr, stride, d0,
              two ? reinterpret_cast<const __nv_bfloat16*>(src1 + xslice)
                  : nullptr,
              nmt, lane, acc);
        } else {
          block_mma_bf16<BS>(src, src + 8 * stride, stride, d0, d0 + 8, nmt,
                             lane, acc);
        }
        __syncwarp();
        if (q + ns < Q1) fetch(s, q + ns);
        if (two && q + 1 + ns < Q1) fetch(s1, q + 1 + ns);
        q += 1 + two;
        i += 1 + two;
      } else {
        __syncwarp();
        block_mma<TD, TX, BS>(reinterpret_cast<const TX*>(src), sx,
                              reinterpret_cast<const TD*>(src + xslice), nmt,
                              g, t, acc);
        __syncwarp();
        if (q + ns < Q1) fetch(s, q + ns);
        ++q;
        ++i;
      }
    }
    store_block_row<BS>(y, acc, (long long)(br0 + r) * BS, n_rows, B, k0,
                        k0 + tile, nmt, g, t);
  }
}

// block: b (>= 1); kt: right-hand-side columns a CUDA block owns.
// mma_threads == 0: the first port's kernel — lanes, per_lane as for
// ell_spmm_launch, rows_per_block block-row groups per CUDA block
// (rows_per_block * lanes threads, a whole number of warps <= 1024).
// mma_threads > 0 (b = 4, 8 or 16): the tensor-core kernel — that many
// threads (whole warps, at most 256), rows_per_block block rows a CUDA block,
// `slots` slices (at least one a warp, at most 32) of rows of `stride` bytes
// (a multiple of 16 holding kt rounded up to 16 values).  The wrapper
// (kernels/bcsr_spmv.py, shapes from kernels/_common.py) picks them.
// Returns cudaGetLastError().
extern "C" int bcsr_spmm_launch(const void* data, const void* block_cols,
                                const void* indptr, const void* x, void* y,
                                int n_rows, int n_cols, int n_block_rows,
                                int block, int B, int kt, int lanes,
                                int per_lane, int rows_per_block,
                                int mma_threads, int slots, int stride,
                                int data_bf16, int x_bf16,
                                void* stream) {
  if (n_rows <= 0 || B <= 0 || n_block_rows <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (mma_threads > 0) {
    const int x_size = x_bf16 ? 2 : 4, d_size = data_bf16 ? 2 : 4;
    const int kt16 = (kt + 15) / 16 * 16;
    if ((block != 4 && block != 8 && block != 16) || kt < 1 || kt > 128 ||
        mma_threads % 32 != 0 || mma_threads > BCSR_MMA_THREADS ||
        rows_per_block < 1 || slots < mma_threads / 32 ||
        slots > BCSR_MMA_MAX_SLOTS || stride % 16 != 0 ||
        stride < kt16 * x_size) {
      return (int)cudaErrorInvalidValue;
    }
    const long long smem =
        (long long)slots * (block * stride + block * block * d_size);
    const int bulk = aligned16(x) && aligned16(data) &&
                     (long long)B * x_size % 16 == 0 &&
                     (long long)kt * x_size % 16 == 0;
    const dim3 grid((unsigned)(((long long)n_block_rows + rows_per_block - 1) /
                               rows_per_block),
                    (unsigned)((B + kt - 1) / kt));
    cudaError_t err = cudaSuccess;
#define LAUNCH_M(TD, TX, BS)                                                  \
  do {                                                                        \
    if (smem + BCSR_MMA_STATIC_SMEM > 48 * 1024) {                            \
      err = cudaFuncSetAttribute(bcsr_spmm_mma<TD, TX, BS>,                   \
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, \
                                 (int)smem);                                  \
      if (err != cudaSuccess) return (int)err;                                \
    }                                                                         \
    bcsr_spmm_mma<TD, TX, BS><<<grid, (unsigned)mma_threads, (size_t)smem,    \
                                s>>>(                                         \
        (const TD*)data, (const int*)block_cols, (const int*)indptr,          \
        (const TX*)x, (float*)y, n_rows, n_cols, n_block_rows, B, kt,         \
        rows_per_block, slots, stride, bulk);                         \
  } while (0)
#define CALL_M(TD, TX)                      \
  switch (block) {                          \
    case 4: LAUNCH_M(TD, TX, 4); break;     \
    case 8: LAUNCH_M(TD, TX, 8); break;     \
    default: LAUNCH_M(TD, TX, 16); break;   \
  }
    DISPATCH_VALUE_TYPES(data_bf16, x_bf16, CALL_M);
#undef CALL_M
#undef LAUNCH_M
    return (int)cudaGetLastError();
  }
  const long long threads = (long long)rows_per_block * lanes;
  if (block < 1 || !valid_block(lanes, threads) ||
      !valid_rhs_tile(kt, lanes, per_lane)) {
    return (int)cudaErrorInvalidValue;
  }
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
