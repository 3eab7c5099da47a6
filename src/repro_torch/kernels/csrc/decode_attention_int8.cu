// Fused int8-KV decode attention for Hopper (sm_90a): one query token per
// sequence against a KV cache stored as int8 codes with one bfloat16 scale
// per (slot, kv head).  For query rows q[b, h, g, :] (G rows per kv head h):
//
//   s[t]   = (q * Dh^-1/2) . (k_q[b, t, h, :] * k_s[b, t, h])
//   s[t]   = -1e30 unless key_pos[b,t] >= 0, key_pos[b,t] <= q_pos[b]
//            (and key_pos[b,t] > q_pos[b] - window when a window is given)
//   out    = sum_t softmax(s)[t] * (v_q[b, t, h, :] * v_s[b, t, h])
//
// in float32, the output cast to q's type.  Masked slots take -1e30, not
// -inf: a row with no valid slot gets weight 1 on every slot, i.e. the mean
// of V over all S slots — what the reference gives, and never NaN.
//
// Replaces the TPU kernel repro/kernels/decode_attention.py:
// decode_attention_int8 (_kernel), whose grid (B, KV, S_chunks) walks the
// sequence in order and carries the online-softmax state (m, l, acc) across
// chunks in VMEM scratch.  Hopper blocks share no state and run in no order,
// so this is split-S flash-decoding in two kernels:
//
//  1. decode_int8_split — one block per (S split, kv head and tile of query
//     rows, sequence).  Each key is read by a group of `lanes` threads, each
//     thread one 16-byte load of its 16 int8 codes of K and then of V,
//     dequantized in registers (no float copy of the cache is ever written
//     to device memory).  The group's dot product is summed by warp shuffle;
//     every group keeps its own online softmax (m, l, acc) for the keys it
//     reads, and the block merges its groups through shared memory into one
//     partial (m, l, acc) per query row, written in float32 to scratch the
//     wrapper allocates.
//  2. decode_int8_combine — one block per (sequence, kv head) merges the
//     splits' partials and writes acc / max(l, 1e-30).
//
// A slot t >= S (the ragged tail of the last split) is not a key at all and
// contributes nothing; a masked slot t < S contributes as above.
//
// Bound on an H100: bytes.  The kernel reads every slot's codes and scales
// once, 2 * S * (Dh + 2) bytes per (sequence, kv head), plus 4 * S of
// key_pos; the partials are G * (Dh + 2) floats per split.  At the served
// shape (B 8, S 8192, KV 8, Dh 128) that is ~136 MB, ~41 us at 3.35 TB/s;
// the flops (4 * B * KV * G * S * Dh) are negligible.  A row that has valid
// slots needs only those (a masked slot's weight underflows to exactly 0),
// so the least bytes of a partly filled cache are fewer than the kernel
// reads: skipping the masked slots, TMA and a shared-memory ring are later
// work.  The number of splits (so that the grid fills the card) and every
// other launch value are chosen by the wrapper (kernels/_common.py).
#include "common.cuh"

#include <stdint.h>

#define DA_MAX_THREADS 256
#define DA_NEG_INF (-1e30f)

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

// The 16 int8 codes of one 16-byte load, widened to float32.
__device__ __forceinline__ void unpack16(const int4 raw, float* out) {
  const int w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      out[4 * j + k] = (float)(signed char)(w[j] >> (8 * k));
    }
  }
}

template <typename TQ, int GT>
__global__ void __launch_bounds__(DA_MAX_THREADS)
decode_int8_split(const TQ* __restrict__ q, const int8_t* __restrict__ k_q,
                  const __nv_bfloat16* __restrict__ k_s,
                  const int8_t* __restrict__ v_q,
                  const __nv_bfloat16* __restrict__ v_s,
                  const int* __restrict__ key_pos,
                  const int* __restrict__ q_pos, float* __restrict__ part_m,
                  float* __restrict__ part_l, float* __restrict__ part_acc,
                  int S, int KV, int G, int Dh, int lanes, int g_tiles,
                  int keys_per_split, int splits, int window, int has_window,
                  float scale) {
  __shared__ float sm_m[DA_MAX_THREADS];
  __shared__ float sm_l[DA_MAX_THREADS];
  __shared__ float sm_acc[DA_MAX_THREADS * 16];

  const int split = blockIdx.x;
  const int h = blockIdx.y / g_tiles;
  const int g0 = (blockIdx.y - h * g_tiles) * GT;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid % lanes;
  const int slot = tid / lanes;           // the key group of this thread
  const int groups = blockDim.x / lanes;  // keys read per iteration
  const int d0 = lane * 16;
  const bool active = d0 < Dh;            // lanes * 16 may exceed Dh

  float qr[GT][16];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    const bool row = active && g0 + g < G;
    const TQ* qg = q + (((long long)b * KV + h) * G + g0 + g) * Dh + d0;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      qr[g][i] = row ? to_f32<TQ>(qg[i]) * scale : 0.f;
    }
  }
  float m[GT], l[GT], acc[GT][16];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = DA_NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[g][i] = 0.f;
  }

  const int qp = q_pos[b];
  const int s_begin = split * keys_per_split;
  const int s_end = min(S, s_begin + keys_per_split);
  // every thread takes the same number of iterations, so the shuffles
  // below always find the whole warp
  for (int base = s_begin; base < s_end; base += groups) {
    const int t = base + slot;
    const bool present = t < s_end;
    bool valid = false;
    float ksc = 0.f, vsc = 0.f;
    int4 kraw = make_int4(0, 0, 0, 0), vraw = make_int4(0, 0, 0, 0);
    if (present) {
      const long long row = ((long long)b * S + t) * KV + h;
      const int kp = key_pos[(long long)b * S + t];
      valid = kp >= 0 && kp <= qp && (!has_window || kp > qp - window);
      ksc = __bfloat162float(k_s[row]);
      vsc = __bfloat162float(v_s[row]);
      if (active) {
        kraw = *reinterpret_cast<const int4*>(k_q + row * Dh + d0);
        vraw = *reinterpret_cast<const int4*>(v_q + row * Dh + d0);
      }
    }
    float kf[16];
    unpack16(kraw, kf);
    float dot[GT];
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < 16; ++i) s = fmaf(qr[g][i], kf[i], s);
      dot[g] = s;
    }
    for (int off = lanes / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], off);
      }
    }
    if (present) {
      float vf[16];
      unpack16(vraw, vf);
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        const float s = valid ? dot[g] * ksc : DA_NEG_INF;
        const float m_new = fmaxf(m[g], s);
        const float alpha = expf(m[g] - m_new);
        const float p = expf(s - m_new);
        l[g] = l[g] * alpha + p;
        const float pv = p * vsc;
#pragma unroll
        for (int i = 0; i < 16; ++i) acc[g][i] = fmaf(pv, vf[i], acc[g][i] * alpha);
        m[g] = m_new;
      }
    }
  }

  // merge the key groups of the block, one query row at a time
  const long long row0 = ((long long)b * KV + h) * G + g0;
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    if (lane == 0) {
      sm_m[slot] = m[g];
      sm_l[slot] = l[g];
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) sm_acc[tid * 16 + i] = acc[g][i];
    __syncthreads();
    float big = DA_NEG_INF;
    for (int k = 0; k < groups; ++k) big = fmaxf(big, sm_m[k]);
    if (g0 + g < G) {
      const long long p = (row0 + g) * splits + split;
      for (int d = tid; d < Dh; d += blockDim.x) {
        // element d lives with lane d / 16 of every group
        float a = 0.f;
        for (int k = 0; k < groups; ++k) {
          a += expf(sm_m[k] - big) * sm_acc[(k * lanes + d / 16) * 16 + d % 16];
        }
        part_acc[p * Dh + d] = a;
      }
      if (tid == 0) {
        float sum = 0.f;
        for (int k = 0; k < groups; ++k) sum += expf(sm_m[k] - big) * sm_l[k];
        part_m[p] = big;
        part_l[p] = sum;
      }
    }
    __syncthreads();
  }
}

template <typename TQ>
__global__ void decode_int8_combine(const float* __restrict__ part_m,
                                    const float* __restrict__ part_l,
                                    const float* __restrict__ part_acc,
                                    TQ* __restrict__ out, int G, int Dh,
                                    int splits) {
  const long long bh = blockIdx.x;
  for (int g = 0; g < G; ++g) {
    const long long p0 = (bh * G + g) * splits;
    float big = DA_NEG_INF;
    for (int sp = 0; sp < splits; ++sp) big = fmaxf(big, part_m[p0 + sp]);
    float sum = 0.f;
    for (int sp = 0; sp < splits; ++sp) {
      sum += expf(part_m[p0 + sp] - big) * part_l[p0 + sp];
    }
    const float inv = 1.f / fmaxf(sum, 1e-30f);
    for (int d = threadIdx.x; d < Dh; d += blockDim.x) {
      float a = 0.f;
      for (int sp = 0; sp < splits; ++sp) {
        a += expf(part_m[p0 + sp] - big) * part_acc[(p0 + sp) * Dh + d];
      }
      out[(bh * G + g) * Dh + d] = from_f32<TQ>(a * inv);
    }
  }
}

// q (B, KV, G, Dh) float32 or bfloat16; k_q, v_q (B, S, KV, Dh) int8, 16-byte
// aligned; k_s, v_s (B, S, KV) bfloat16; key_pos (B, S), q_pos (B,) int32;
// part_m, part_l (B, KV, G, splits) and part_acc (B, KV, G, splits, Dh)
// float32 scratch; out like q.  lanes: threads per key, a power of two <= 32
// with lanes * 16 >= Dh; threads: a whole number of warps <= 256; g_tile:
// query rows a block keeps in registers (1, 2 or 4); splits * keys_per_split
// >= S.  The wrapper (kernels/decode_attention.py) picks them.  Launches both
// kernels on `stream`; returns cudaGetLastError().
extern "C" int decode_attention_int8_launch(
    const void* q, const void* k_q, const void* k_s, const void* v_q,
    const void* v_s, const void* key_pos, const void* q_pos, void* part_m,
    void* part_l, void* part_acc, void* out, int B, int S, int KV, int G,
    int Dh, int lanes, int threads, int g_tile, int keys_per_split,
    int splits, int window, int has_window, float scale, int q_bf16,
    void* stream) {
  if (B <= 0 || KV <= 0 || G <= 0) return 0;
  const int g_tiles = (G + g_tile - 1) / g_tile;
  if (S <= 0 || Dh <= 0 || Dh % 16 != 0 || !valid_block(lanes, threads) ||
      threads > DA_MAX_THREADS || lanes * 16 < Dh || splits < 1 ||
      keys_per_split < 1 || (long long)splits * keys_per_split < S ||
      (long long)KV * g_tiles > 65535 || B > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((unsigned)splits, (unsigned)(KV * g_tiles), (unsigned)B);
#define SPLIT(TQ, GT)                                                       \
  decode_int8_split<TQ, GT><<<grid, (unsigned)threads, 0, s>>>(             \
      (const TQ*)q, (const int8_t*)k_q, (const __nv_bfloat16*)k_s,          \
      (const int8_t*)v_q, (const __nv_bfloat16*)v_s, (const int*)key_pos,   \
      (const int*)q_pos, (float*)part_m, (float*)part_l, (float*)part_acc,  \
      S, KV, G, Dh, lanes, g_tiles, keys_per_split, splits, window,         \
      has_window, scale)
#define CALL(TQ)                                                 \
  switch (g_tile) {                                              \
    case 1: SPLIT(TQ, 1); break;                                 \
    case 2: SPLIT(TQ, 2); break;                                 \
    case 4: SPLIT(TQ, 4); break;                                 \
    default: return (int)cudaErrorInvalidValue;                  \
  }                                                              \
  decode_int8_combine<TQ><<<(unsigned)(B * KV), 128, 0, s>>>(    \
      (const float*)part_m, (const float*)part_l,                \
      (const float*)part_acc, (TQ*)out, G, Dh, splits)
  if (q_bf16) {
    CALL(__nv_bfloat16);
  } else {
    CALL(float);
  }
#undef CALL
#undef SPLIT
  return (int)cudaGetLastError();
}
