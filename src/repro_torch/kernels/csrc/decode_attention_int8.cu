// Fused int8-KV decode attention for Hopper (sm_90a): one query token per
// sequence against a KV cache stored as int8 codes with one bfloat16 scale
// per (slot, kv head).  For query rows q[b, h, g, :] (G rows per kv head h):
//
//   s[t]   = (q * Dh^-1/2) . (k_q[b, t, h, :] * k_s[b, t, h])
//   s[t]   = cap * tanh(s[t] / cap)   (only when a softcap cap > 0 is given)
//   s[t]   = -1e30 unless key_pos[b,t] >= 0, key_pos[b,t] <= q_pos[b]
//            (and key_pos[b,t] > q_pos[b] - window when a window is given)
//   out    = sum_t softmax(s)[t] * (v_q[b, t, h, :] * v_s[b, t, h])
//
// in float32, the output cast to q's type, and beside it each row's
// natural-log log-sum-exp lse = log sum_t exp(s[t]) in float32 (-1e30 for a
// row with no valid slot), with which partial results over disjoint slot
// ranges merge (context parallelism).  Masked slots take -1e30, not
// -inf: a row with no valid slot gets weight 1 on every slot, i.e. the mean
// of V over all S slots — what the reference gives, and never NaN.
//
// Replaces the TPU kernel repro/kernels/decode_attention.py:
// decode_attention_int8 (_kernel), whose grid (B, KV, S_chunks) walks the
// sequence in order and carries the online-softmax state (m, l, acc) across
// chunks in VMEM scratch.  Hopper blocks share no state and run in no order,
// so this is split-S flash-decoding: one block per (kv head and tile of query
// rows, sequence, S split) writes one partial (m, l, acc) per query row in
// float32 to scratch the wrapper allocates, and counts itself on an int
// counter of its (sequence, head, row tile); the last of its splits to
// arrive merges their partials and writes acc / l (no second kernel).
//
// Bound on an H100: bytes.  A row that has a valid slot needs the codes and
// scales of its valid slots only: a masked slot's weight exp(-1e30 - m) is
// exactly 0.  At the served shape (B 8, S 8192, KV 8, G 2, Dh 128, about a
// third of the cache valid) that is ~45 MB, ~13.5 us at 3.35 TB/s; the whole
// cache is ~136 MB.  The flops (4 * G * Dh a valid slot and head) are small.
// The first port's kernel read every slot, and each pass of its loop waited
// for its own loads and then ran a serial chain (unpack, shuffles, an online
// softmax step per key).  This one:
//  - skips masked slots: a block first reads its split's key_pos (coalesced,
//    all at once), compacts the valid slots into a list in shared memory by
//    warp ballots, and then loads codes and scales for those only; a split
//    with none writes an empty partial (l = 0) and exits;
//  - deals the listed keys to its warps in tiles of 2 keys a lane group;
//    each warp streams its tiles through its own ring of DA_STAGES tiles of
//    K and V codes in shared memory, filled by cp.async (16 bytes a lane),
//    so four tiles are in flight while one is computed and no tile waits on
//    another warp;
//  - rescales once a tile: a warp computes its tile's scores, takes one max
//    over the tile, rescales acc and l (only where the max moved) and adds
//    p * V; the warps' partials meet once, at the end;
//  - widens int8 codes by byte permutes (2^23 + (code ^ 0x80) as float bits,
//    less 2^23 + 128: exact), not by conversions.
// A row with no valid slot gets weight 1 on every slot, i.e. the mean of V
// over all S slots — what the reference gives, never NaN: a split that finds
// no valid slot of its own looks for one in the rest of the row's key_pos,
// and only where there is none reads its slots' V (not K), as the masked
// slots' true partial (m = -1e30, l = its slots, acc = the sum of V).  A slot
// t >= S (the ragged tail of the last split) is not a key at all.  The
// number of splits (so that the grid fills the card, with at most DA_KPT
// keys a thread in a split), the threads and every other launch value are
// chosen by the wrapper (kernels/_common.py).
#include "common.cuh"

#include <stdint.h>

#define DA_MAX_THREADS 256
#define DA_NEG_INF (-1e30f)
#define DA_STAGES 3            // tiles of codes in a warp's ring
#define DA_KPG 2               // keys a lane group scores in a tile
#define DA_WTILE_BYTES (DA_KPG * 32 * 16)  // K (or V) codes of a warp's tile
#define DA_KPT 8               // keys of a split a thread lists, at most
#define DA_MAX_HEAD_DIM 512
#define DA_COMBINE_CHUNK 256   // splits whose weights a merging warp holds

template <typename T>
__device__ __forceinline__ T from_f32(float v);

template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}

template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// The 16 int8 codes of one 16-byte load, widened to float32: each byte
// x ^ 0x80 = x + 128 becomes the low byte of the float 2^23 + (x + 128).
__device__ __forceinline__ void unpack16(const int4 raw, float (&out)[16]) {
  const unsigned w[4] = {(unsigned)raw.x ^ 0x80808080u,
                         (unsigned)raw.y ^ 0x80808080u,
                         (unsigned)raw.z ^ 0x80808080u,
                         (unsigned)raw.w ^ 0x80808080u};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      out[4 * j + k] =
          __uint_as_float(__byte_perm(w[j], 0x4B000000u, 0x7650u + k)) -
          8388736.f;
    }
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// The last split of a (sequence, kv head, tile of query rows) to finish
// merges the splits' partials, a warp a query row: out = sum over the splits
// with l > 0 of exp2(m - max m) * acc / (the same sum of l).  A warp folds
// its row's (m, l) pairs online and by shuffles, puts the splits' weights in
// shared memory (w: DA_COMBINE_CHUNK floats a warp) a chunk at a time, and
// sums acc with loads that do not wait on one another.  The partials of the
// other splits were written by other blocks: read through L2.
template <typename TQ, int GT>
__device__ __forceinline__ void merge_splits(
    const float* __restrict__ part_m, const float* __restrict__ part_l,
    const float* __restrict__ part_acc, TQ* __restrict__ out,
    float* __restrict__ lse, long long row0, int rows, int Dh, int splits,
    float* w) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nwarps = blockDim.x / 32;
  w += warp * DA_COMBINE_CHUNK;
  for (int g = warp; g < rows; g += nwarps) {
    const long long p0 = (row0 + g) * splits;
    float m = DA_NEG_INF, l = 0.f;
    for (int sp = lane; sp < splits; sp += 32) {
      const float lv = __ldcg(part_l + p0 + sp);
      if (lv > 0.f) {
        const float mv = __ldcg(part_m + p0 + sp);
        const float hi = fmaxf(m, mv);
        l = l * exp2f(m - hi) + lv * exp2f(mv - hi);
        m = hi;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m, off);
      const float lo = __shfl_xor_sync(0xffffffffu, l, off);
      const float hi = fmaxf(m, mo);
      l = l * exp2f(m - hi) + lo * exp2f(mo - hi);
      m = hi;
    }
    const float inv = 1.f / l;
    // the row's natural-log log-sum-exp, m + log l in log2 units times
    // ln 2; a row with no valid slot (m = -1e30) gives -1e30 itself
    if (lane == 0) {
      lse[row0 + g] = m == DA_NEG_INF
                          ? DA_NEG_INF
                          : (m + log2f(l)) * 0.6931471805599453f;
    }
    float a[DA_MAX_HEAD_DIM / 32];
#pragma unroll
    for (int k = 0; k < DA_MAX_HEAD_DIM / 32; ++k) a[k] = 0.f;
    for (int c0 = 0; c0 < splits; c0 += DA_COMBINE_CHUNK) {
      const int nc = min(DA_COMBINE_CHUNK, splits - c0);
      __syncwarp();
      for (int sp = lane; sp < nc; sp += 32) {
        const float lv = __ldcg(part_l + p0 + c0 + sp);
        w[sp] = lv > 0.f ? exp2f(__ldcg(part_m + p0 + c0 + sp) - m) * inv
                         : 0.f;
      }
      __syncwarp();
#pragma unroll
      for (int k = 0; k < DA_MAX_HEAD_DIM / 32; ++k) {
        const int d = lane + 32 * k;
        if (d < Dh) {
          const float* pa = part_acc + (p0 + c0) * Dh + d;
#pragma unroll 4
          for (int sp = 0; sp < nc; ++sp) {
            const float ws = w[sp];
            if (ws != 0.f) {
              a[k] = fmaf(ws, __ldcg(pa + (long long)sp * Dh), a[k]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < DA_MAX_HEAD_DIM / 32; ++k) {
      const int d = lane + 32 * k;
      if (d < Dh) out[(row0 + g) * Dh + d] = from_f32<TQ>(a[k]);
    }
  }
}

// After a block's partials are written: count it among its (sequence, kv
// head, row tile)'s splits; the last to arrive merges them and sets the
// count back to 0 for the next launch.  Returns whether this block merged.
template <typename TQ, int GT>
__device__ __forceinline__ void finish_split(
    const float* part_m, const float* part_l, const float* part_acc,
    TQ* out, float* lse, int* counters, long long tile, long long row0,
    int rows, int Dh, int splits, float* w, int* s_last) {
  __threadfence();  // this block's partials, before its count
  __syncthreads();
  if (threadIdx.x == 0) {
    *s_last = atomicAdd(counters + tile, 1) == splits - 1;
  }
  __syncthreads();
  if (!*s_last) return;
  __threadfence();  // every other split's partials, after its count
  merge_splits<TQ, GT>(part_m, part_l, part_acc, out, lse, row0, rows, Dh,
                       splits, w);
  if (threadIdx.x == 0) counters[tile] = 0;
}

// CAP: the scores are capped (a template flag, so the uncapped kernel pays
// nothing for it).
template <typename TQ, int GT, bool CAP>
__global__ void __launch_bounds__(DA_MAX_THREADS)
decode_int8_split(const TQ* __restrict__ q, const int8_t* __restrict__ k_q,
                  const __nv_bfloat16* __restrict__ k_s,
                  const int8_t* __restrict__ v_q,
                  const __nv_bfloat16* __restrict__ v_s,
                  const int* __restrict__ key_pos,
                  const int* __restrict__ q_pos, float* __restrict__ part_m,
                  float* __restrict__ part_l, float* __restrict__ part_acc,
                  TQ* __restrict__ out, float* __restrict__ lse,
                  int* __restrict__ counters, int S, int KV, int G, int Dh, int lanes, int g_tiles,
                  int keys_per_split, int splits, int window, int has_window,
                  float scale, float softcap) {
  // dynamic: each warp's ring (DA_STAGES tiles of K codes and of V codes),
  // then the valid slots and their scales (bfloat16 bits), DA_KPT a thread
  extern __shared__ __align__(16) unsigned char da_smem[];
  __shared__ int s_cnt[DA_KPT][DA_MAX_THREADS / 32];
  __shared__ float s_m[DA_MAX_THREADS / 32];
  __shared__ int s_last;

  // splits vary slowest: the blocks of a cache's first slots, which a
  // decoding sequence fills first, start first
  const int split = blockIdx.z;
  const int h = blockIdx.x / g_tiles;
  const int g0 = (blockIdx.x - h * g_tiles) * GT;
  const int b = blockIdx.y;
  const int tid = threadIdx.x, wl = tid % 32, warp = tid / 32;
  const int nthreads = blockDim.x, nwarps = nthreads / 32;
  const int lane = tid % lanes;
  const int group = tid / lanes;           // the key group of this thread
  const int groups = nthreads / lanes;
  const int d0 = lane * 16;
  const bool active = d0 < Dh;             // lanes * 16 may exceed Dh
  const int s_begin = split * keys_per_split;
  const int n_keys = min(S, s_begin + keys_per_split) - s_begin;
  const int qp = q_pos[b];
  // scores in log2 units (q times Dh^-1/2 log2(e)): p = exp2(s - m)
  const float qscale = scale * 1.4426950408889634f;
  const long long row0 = ((long long)b * KV + h) * G + g0;
  const int rows = min(GT, G - g0);                       // query rows here
  const long long tile = ((long long)b * KV + h) * g_tiles + g0 / GT;
  const int ring_bytes = DA_STAGES * 2 * DA_WTILE_BYTES;  // a warp's
  unsigned short* s_idx =
      reinterpret_cast<unsigned short*>(da_smem + nwarps * ring_bytes);
  unsigned short* s_ks = s_idx + DA_KPT * nthreads;
  unsigned short* s_vs = s_ks + DA_KPT * nthreads;

  // 1. the split's valid slots, in slot order, as offsets from s_begin
  unsigned vbits = 0;
  {
    int kp[DA_KPT];
#pragma unroll
    for (int j = 0; j < DA_KPT; ++j) {
      const int o = j * nthreads + tid;
      kp[j] = o < n_keys ? key_pos[(long long)b * S + s_begin + o] : -1;
    }
#pragma unroll
    for (int j = 0; j < DA_KPT; ++j) {
      const bool valid =
          kp[j] >= 0 && kp[j] <= qp && (!has_window || kp[j] > qp - window);
      vbits |= (unsigned)valid << j;
    }
  }
#pragma unroll
  for (int j = 0; j < DA_KPT; ++j) {
    const unsigned m = __ballot_sync(0xffffffffu, (vbits >> j) & 1u);
    if (wl == 0) s_cnt[j][warp] = __popc(m);
  }
  __syncthreads();
  int n = 0;  // valid slots listed so far (the same in every thread)
  const unsigned below = (1u << wl) - 1u;
#pragma unroll
  for (int j = 0; j < DA_KPT; ++j) {
    const unsigned m = __ballot_sync(0xffffffffu, (vbits >> j) & 1u);
    int at = n;
    for (int w = 0; w < nwarps; ++w) {
      const int c = s_cnt[j][w];
      if (w < warp) at += c;
      n += c;
    }
    if ((vbits >> j) & 1u) {
      s_idx[at + __popc(m & below)] = (unsigned short)(j * nthreads + tid);
    }
  }
  // a split with no valid slot writes an empty partial (l = 0), which the
  // merge skips — unless its row has no valid slot at all: then every slot
  // weighs exp(-1e30 - -1e30) = 1 (the reference's weights), and the split's
  // partial is m = -1e30, l = its slots, acc = the sum of their V
  bool masked_row = false;
  if (n == 0) {
    bool found = false;
    for (int c0 = 0; c0 < S && !found; c0 += DA_KPT * nthreads) {
      int kp[DA_KPT];
#pragma unroll
      for (int j = 0; j < DA_KPT; ++j) {
        const int o = c0 + j * nthreads + tid;
        kp[j] = o < S ? key_pos[(long long)b * S + o] : -1;
      }
      bool any = false;
#pragma unroll
      for (int j = 0; j < DA_KPT; ++j) {
        any |= kp[j] >= 0 && kp[j] <= qp &&
               (!has_window || kp[j] > qp - window);
      }
      found = __syncthreads_or(any);
    }
    if (found) {
      if (tid < rows) {
        const long long p = (row0 + tid) * splits + split;
        part_m[p] = DA_NEG_INF;
        part_l[p] = 0.f;
      }
      finish_split<TQ, GT>(part_m, part_l, part_acc, out, lse, counters, tile,
                           row0, rows, Dh, splits,
                           reinterpret_cast<float*>(da_smem), &s_last);
      return;
    }
    masked_row = true;
    n = n_keys;
    for (int i = tid; i < n; i += nthreads) s_idx[i] = (unsigned short)i;
  }
  __syncthreads();

  // 2. each warp takes tiles w, w + 4, ... of the list (a tile: DA_KPG keys
  //    a lane group) through its own ring of DA_STAGES tiles, the first
  //    ones in flight before the listed slots' scales are read
  const int wtile = DA_KPG * (32 / lanes);  // keys a warp's tile holds
  const int ntiles = (n + wtile - 1) / wtile;
  const int mine = warp < ntiles ? (ntiles - warp + nwarps - 1) / nwarps : 0;
  int8_t* ring = reinterpret_cast<int8_t*>(da_smem) + warp * ring_bytes;
  const int wgroup = wl / lanes;            // the lane group in the warp
  // a lane copies the 16-byte chunk `lane` of keys wgroup, wgroup + 32 /
  // lanes, ... of a tile: slot t's chunk lies at (its first slot) + t * slot
  const long long slot = (long long)KV * Dh;
  const long long first = (((long long)b * S + s_begin) * KV + h) * Dh + d0;
  auto fetch = [&](int k) {
    const int st = k % DA_STAGES;
    const int i0 = (warp + k * nwarps) * wtile;
    const int nk = min(wtile, n - i0);
    int8_t* kd = ring + st * 2 * DA_WTILE_BYTES + d0;
    int8_t* vd = kd + DA_WTILE_BYTES;
    if (!active) return;
    for (int key = wgroup; key < nk; key += 32 / lanes) {
      const long long at = first + s_idx[i0 + key] * slot;
      if (!masked_row) cp_async16(kd + key * Dh, k_q + at);
      cp_async16(vd + key * Dh, v_q + at);
    }
  };
#pragma unroll
  for (int k = 0; k < DA_STAGES - 1; ++k) {
    if (k < mine) fetch(k);
    cp_async_commit();
  }
  const unsigned short* ks_raw = reinterpret_cast<const unsigned short*>(k_s);
  const unsigned short* vs_raw = reinterpret_cast<const unsigned short*>(v_s);
  {
    // every load issued before the first store
    unsigned short ksr[DA_KPT], vsr[DA_KPT];
#pragma unroll
    for (int j = 0; j < DA_KPT; ++j) {
      const int i = j * nthreads + tid;
      ksr[j] = vsr[j] = 0;
      if (i < n) {
        const long long row =
            ((long long)b * S + s_begin + s_idx[i]) * KV + h;
        if (!masked_row) ksr[j] = ks_raw[row];
        vsr[j] = vs_raw[row];
      }
    }
#pragma unroll
    for (int j = 0; j < DA_KPT; ++j) {
      const int i = j * nthreads + tid;
      if (i < n) {
        s_ks[i] = ksr[j];
        s_vs[i] = vsr[j];
      }
    }
  }

  float qr[GT][16];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    const bool row = active && g0 + g < G;
    const TQ* qg = q + (row0 + g) * Dh + d0;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      qr[g][i] = row ? to_f32<TQ>(qg[i]) * qscale : 0.f;
    }
  }
  float m_run[GT], l[GT], acc[GT][16];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m_run[g] = DA_NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[g][i] = 0.f;
  }
  __syncthreads();  // the scales

  // 3. the warp's tiles: scores, one max a tile (the warp's), p * V
  for (int k = 0; k < mine; ++k) {
    cp_async_wait<DA_STAGES - 2>();
    __syncwarp();  // tile k landed for every lane; tile k - 1 read
    if (k + DA_STAGES - 1 < mine) fetch(k + DA_STAGES - 1);
    cp_async_commit();
    const int8_t* kd = ring + (k % DA_STAGES) * 2 * DA_WTILE_BYTES;
    const int8_t* vd = kd + DA_WTILE_BYTES;
    const int i0 = (warp + k * nwarps) * wtile;
    const int nk = min(wtile, n - i0);
    float sc[DA_KPG][GT];
    float mx[GT];
#pragma unroll
    for (int g = 0; g < GT; ++g) mx[g] = DA_NEG_INF;
#pragma unroll
    for (int kk = 0; kk < DA_KPG; ++kk) {
      const int key = wgroup + kk * (32 / lanes);
      if (masked_row) {  // the same in every thread: no K to read
#pragma unroll
        for (int g = 0; g < GT; ++g) sc[kk][g] = DA_NEG_INF;
        continue;
      }
      int4 raw = make_int4(0, 0, 0, 0);
      if (key < nk && active) {
        raw = *reinterpret_cast<const int4*>(kd + key * Dh + d0);
      }
      float kf[16];
      unpack16(raw, kf);
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        // two chains of 8, not one of 16
        float s0 = 0.f, s1 = 0.f;
#pragma unroll
        for (int i = 0; i < 16; i += 2) {
          s0 = fmaf(qr[g][i], kf[i], s0);
          s1 = fmaf(qr[g][i + 1], kf[i + 1], s1);
        }
        sc[kk][g] = s0 + s1;
      }
      for (int off = lanes / 2; off > 0; off >>= 1) {
#pragma unroll
        for (int g = 0; g < GT; ++g) {
          sc[kk][g] += __shfl_xor_sync(0xffffffffu, sc[kk][g], off);
        }
      }
      const float ksc =
          key < nk ? __uint_as_float((unsigned)s_ks[i0 + key] << 16) : 0.f;
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        float s = sc[kk][g] * ksc;
        if (CAP) {
          s = 1.4426950408889634f * softcap *
              tanhf(s * (0.6931471805599453f / softcap));
        }
        sc[kk][g] = key < nk ? s : DA_NEG_INF;
        mx[g] = fmaxf(mx[g], sc[kk][g]);
      }
    }
    // the tile's max over the warp; acc and l rescaled where it moved
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      for (int off = lanes; off < 32; off <<= 1) {
        mx[g] = fmaxf(mx[g], __shfl_xor_sync(0xffffffffu, mx[g], off));
      }
      if (mx[g] > m_run[g]) {  // the same in every lane of the warp
        const float alpha = exp2f(m_run[g] - mx[g]);
        l[g] *= alpha;
#pragma unroll
        for (int i = 0; i < 16; ++i) acc[g][i] *= alpha;
        m_run[g] = mx[g];
      }
    }
#pragma unroll
    for (int kk = 0; kk < DA_KPG; ++kk) {
      const int key = wgroup + kk * (32 / lanes);
      if (key < nk) {
        int4 raw = make_int4(0, 0, 0, 0);
        if (active) raw = *reinterpret_cast<const int4*>(vd + key * Dh + d0);
        float vf[16];
        unpack16(raw, vf);
        const float vsc = __uint_as_float((unsigned)s_vs[i0 + key] << 16);
#pragma unroll
        for (int g = 0; g < GT; ++g) {
          const float p = exp2f(sc[kk][g] - m_run[g]);
          l[g] += p;
          const float pv = p * vsc;
#pragma unroll
          for (int i = 0; i < 16; ++i) acc[g][i] = fmaf(pv, vf[i], acc[g][i]);
        }
      }
    }
  }

  // 4. merge the warps (each its own m) and their key groups, one query row
  //    at a time, in the shared memory of the rings
  cp_async_wait<0>();
  __syncthreads();
  float* sm_acc = reinterpret_cast<float*>(da_smem);  // threads x 16
  float* sm_l = sm_acc + nthreads * 16;                 // groups
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    if (wl == 0) s_m[warp] = m_run[g];
    __syncthreads();
    float big = DA_NEG_INF;
    for (int w = 0; w < nwarps; ++w) big = fmaxf(big, s_m[w]);
    // a warp with no tile (m = -1e30) weighs 0 beside one with a key,
    // and 1 beside none (a fully masked split's warps all have keys)
    const float f = exp2f(m_run[g] - big);
    if (lane == 0) sm_l[group] = l[g] * f;
#pragma unroll
    for (int i = 0; i < 16; ++i) sm_acc[tid * 16 + i] = acc[g][i] * f;
    __syncthreads();
    if (g0 + g < G) {
      const long long p = (row0 + g) * splits + split;
      for (int d = tid; d < Dh; d += nthreads) {
        // element d lives with lane d / 16 of every group
        float a = 0.f;
        for (int k = 0; k < groups; ++k) {
          a += sm_acc[(k * lanes + d / 16) * 16 + d % 16];
        }
        part_acc[p * Dh + d] = a;
      }
      if (tid == 0) {
        float sum = 0.f;
        for (int k = 0; k < groups; ++k) sum += sm_l[k];
        part_m[p] = big;
        part_l[p] = sum;
      }
    }
    __syncthreads();
  }
  finish_split<TQ, GT>(part_m, part_l, part_acc, out, lse, counters, tile, row0,
                       rows, Dh, splits, reinterpret_cast<float*>(da_smem),
                       &s_last);
}

// q (B, KV, G, Dh) float32 or bfloat16; k_q, v_q (B, S, KV, Dh) int8, 16-byte
// aligned; k_s, v_s (B, S, KV) bfloat16; key_pos (B, S), q_pos (B,) int32;
// part_m, part_l (B, KV, G, splits) and part_acc (B, KV, G, splits, Dh)
// float32 scratch; out like q; lse (B, KV, G) float32: each query row's
// natural-log log-sum-exp of its masked, capped scores; counters: B * KV * ceil(G / g_tile) int32, 0
// on entry and left 0 (one launch on them at a time).  lanes: threads per
// key, a power of two <= 32 with lanes * 16 >= Dh (Dh <= 512); threads:
// whole warps, 128 to 256; g_tile: query rows a block keeps in registers
// (1, 2 or 4); splits * keys_per_split >= S, keys_per_split <= 8 * threads;
// softcap: the cap of the scores, 0 for none.  The wrapper
// (kernels/decode_attention.py) picks them.  Launches the kernel on
// `stream`; returns cudaGetLastError().
extern "C" int decode_attention_int8_launch(
    const void* q, const void* k_q, const void* k_s, const void* v_q,
    const void* v_s, const void* key_pos, const void* q_pos, void* part_m,
    void* part_l, void* part_acc, void* out, void* lse, void* counters,
    int B, int S,
    int KV, int G,
    int Dh, int lanes, int threads, int g_tile, int keys_per_split,
    int splits, int window, int has_window, float scale, float softcap,
    int q_bf16, void* stream) {
  if (B <= 0 || KV <= 0 || G <= 0) return 0;
  const int g_tiles = (G + g_tile - 1) / g_tile;
  if (S <= 0 || Dh <= 0 || Dh % 16 != 0 || !valid_block(lanes, threads) ||
      threads < 128 || threads > DA_MAX_THREADS || lanes * 16 < Dh ||
      Dh > DA_MAX_HEAD_DIM ||
      splits < 1 ||
      keys_per_split < 1 || keys_per_split > DA_KPT * threads ||
      (long long)splits * keys_per_split < S ||
      splits > 65535 || B > 65535 || !(softcap >= 0.f)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((unsigned)(KV * g_tiles), (unsigned)B, (unsigned)splits);
  // the warps' rings, the valid slots and their two scales
  const int smem = threads / 32 * DA_STAGES * 2 * DA_WTILE_BYTES +
                   3 * 2 * DA_KPT * threads;
  cudaError_t err = cudaSuccess;
#define SPLIT_CAP(TQ, GT, CAP)                                              \
  if (smem + 1024 > 48 * 1024) {                                            \
    err = cudaFuncSetAttribute(decode_int8_split<TQ, GT, CAP>,              \
                               cudaFuncAttributeMaxDynamicSharedMemorySize, \
                               smem);                                       \
    if (err != cudaSuccess) return (int)err;                                \
  }                                                                         \
  decode_int8_split<TQ, GT, CAP><<<grid, (unsigned)threads, smem, s>>>(     \
      (const TQ*)q, (const int8_t*)k_q, (const __nv_bfloat16*)k_s,          \
      (const int8_t*)v_q, (const __nv_bfloat16*)v_s, (const int*)key_pos,   \
      (const int*)q_pos, (float*)part_m, (float*)part_l, (float*)part_acc,  \
      (TQ*)out, (float*)lse, (int*)counters, S, KV, G, Dh, lanes, g_tiles, \
      keys_per_split, splits, window, has_window, scale, softcap)
#define SPLIT(TQ, GT)              \
  if (softcap > 0.f) {             \
    SPLIT_CAP(TQ, GT, true);       \
  } else {                         \
    SPLIT_CAP(TQ, GT, false);      \
  }
#define CALL(TQ)                                 \
  switch (g_tile) {                              \
    case 1: SPLIT(TQ, 1); break;                 \
    case 2: SPLIT(TQ, 2); break;                 \
    case 4: SPLIT(TQ, 4); break;                 \
    default: return (int)cudaErrorInvalidValue;  \
  }
  if (q_bf16) {
    CALL(__nv_bfloat16);
  } else {
    CALL(float);
  }
#undef CALL
#undef SPLIT
#undef SPLIT_CAP
  return (int)cudaGetLastError();
}
