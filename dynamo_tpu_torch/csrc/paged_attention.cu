// Paged decode attention for Hopper (sm_90a): one query token per sequence
// over its KV blocks in head-major flat caches.
//
// Replaces the TPU kernel dynamo_tpu/ops/paged_attention.py:216
// paged_attention_pallas (body _paged_attn_kernel :87-213, pl.pallas_call
// :300) and computes the function of its plain reference,
// paged_attention_reference (same file, :35-84):
//
//   q            [B, n_q, 128]              f32 or bf16
//   k_cache      [n_kv, total_slots, 128]   bf16, or int8 with
//   v_cache      [n_kv, total_slots, 128]   k_scale/v_scale [n_kv, total_slots] f32
//   block_tables [B, max_blocks] i32        slot = table[pos / bs] * bs + pos % bs
//   seq_lens     [B] i32                    cached tokens, without the self position
//   k_self       [B, n_kv, 128] f32         optional: the current token's K/V,
//   v_self       [B, n_kv, 128] f32         an always-valid extra key folded in last
//   out          [B, n_q, 128]              q's dtype: acc / max(l, 1e-30)
//
// Sequence b attends positions 0 .. min(seq_lens[b], max_blocks * bs) - 1
// and, when given, its self position. Softmax runs online, in f32.
//
// Design (first, simple and right): one 128-thread block per (sequence, kv
// head), as the TPU grid (B, n_kv). The block stages the `group` query
// heads of its kv head in shared memory, so they share every K/V read, and
// walks the table 64 positions per tile; a page is a contiguous
// block_size x 128 slab of one head, so consecutive positions of a page
// are consecutive rows. Per tile:
//   scores  each warp takes positions, each lane 4 of the 128 dims of the
//           K row (one coalesced 256-byte bf16 row, or 128-byte int8 row,
//           per warp), a shuffle sum per query head;
//   softmax online (running max and sum per head) in f32;
//   values  thread d accumulates dim d of every head over the tile's V rows.
// int8 pages are dequantized in registers, in f32, with the slot's scale:
// the score is scale_k * (q . k_int8), the scale applied to the warp's
// sum; the value pass accumulates p * scale_v * v_int8. The self position
// is folded in after the last tile, one extra key per head.
//
// What bounds it on the H100: each (sequence, kv head) reads its visible K
// and V rows once, 512 bytes per position in bf16 and 264 in int8 (scales
// included), against 3.35 TB/s; the operations (4 * positions * n_q * 128)
// are far below the tensor cores' rate. The design reads each row once but
// runs only B * n_kv blocks and walks each sequence serially with narrow,
// unpipelined loads, so it is latency-bound at decode widths. Split-KV and
// cp.async/TMA page pipelines are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 128;
constexpr int kMaxGroup = 8;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float out[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(k2[0]);
  const float2 b = __bfloat1622float2(k2[1]);
  out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
}

__device__ __forceinline__ void load4(const int8_t* p, float out[4]) {
  const char4 raw = *reinterpret_cast<const char4*>(p);
  out[0] = raw.x; out[1] = raw.y; out[2] = raw.z; out[3] = raw.w;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(int8_t v) { return (float)v; }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Q is float or __nv_bfloat16; KV is __nv_bfloat16 or int8_t (then the
// scales are set).
template <typename Q, typename KV>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(
    const Q* __restrict__ q,
    const KV* __restrict__ k_cache,
    const KV* __restrict__ v_cache,
    const float* __restrict__ k_scale,
    const float* __restrict__ v_scale,
    const float* __restrict__ k_self,
    const float* __restrict__ v_self,
    const int* __restrict__ block_tables,
    const int* __restrict__ seq_lens,
    Q* __restrict__ out,
    int n_q, int n_kv, long long total_slots, int block_size, int max_blocks,
    float scale) {
  constexpr bool kQuant = sizeof(KV) == 1;
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int group = n_q / n_kv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  __shared__ float q_s[kMaxGroup][kHeadDim];
  __shared__ float p_s[kMaxGroup][kTile];
  __shared__ long long slot_s[kTile];
  __shared__ float ks_s[kTile];  // int8: the K and V scales of each slot
  __shared__ float vs_s[kTile];
  __shared__ float m_s[kMaxGroup];
  __shared__ float l_s[kMaxGroup];
  __shared__ float alpha_s[kMaxGroup];
  __shared__ float pself_s[kMaxGroup];

  const size_t row0 = ((size_t)b * n_q + (size_t)h * group) * kHeadDim;
  for (int g = 0; g < group; ++g) q_s[g][tid] = to_float(q[row0 + g * kHeadDim + tid]);
  if (tid < group) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  float acc[kMaxGroup];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) acc[g] = 0.f;

  const int n_vis = max(0, min(seq_lens[b], max_blocks * block_size));
  const int* table = block_tables + (size_t)b * max_blocks;
  const KV* k_head = k_cache + (size_t)h * total_slots * kHeadDim;
  const KV* v_head = v_cache + (size_t)h * total_slots * kHeadDim;
  __syncthreads();

  for (int base = 0; base < n_vis; base += kTile) {
    const int n = min(kTile, n_vis - base);
    if (tid < n) {
      const int pos = base + tid;
      const int pg = pos / block_size;
      const long long slot = (long long)table[pg] * block_size + (pos - pg * block_size);
      slot_s[tid] = slot;
      if (kQuant) {
        ks_s[tid] = k_scale[(size_t)h * total_slots + slot];
        vs_s[tid] = v_scale[(size_t)h * total_slots + slot];
      }
    }
    __syncthreads();

    // Scores: q . k * scale for every head of the group.
    for (int p = warp; p < n; p += kWarps) {
      float k4[4];
      load4(k_head + (size_t)slot_s[p] * kHeadDim + lane * 4, k4);
      const float k_mul = kQuant ? ks_s[p] * scale : scale;
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) {
        if (g < group) {
          const float* qg = &q_s[g][lane * 4];
          float part = qg[0] * k4[0] + qg[1] * k4[1] + qg[2] * k4[2] + qg[3] * k4[3];
          part = warp_sum(part);
          if (lane == 0) p_s[g][p] = part * k_mul;
        }
      }
    }
    __syncthreads();

    // Online softmax: one warp per head.
    for (int g = warp; g < group; g += kWarps) {
      float mx = -INFINITY;
      for (int p = lane; p < n; p += 32) mx = fmaxf(mx, p_s[g][p]);
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int p = lane; p < n; p += 32) {
        const float e = expf(p_s[g][p] - m_new);
        p_s[g][p] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float a = expf(m_old - m_new);
        alpha_s[g] = a;
        l_s[g] = l_s[g] * a + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // Values: thread tid owns output dim tid of every head.
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
      if (g < group) acc[g] *= alpha_s[g];
    }
    for (int p = 0; p < n; ++p) {
      float v = to_float(v_head[(size_t)slot_s[p] * kHeadDim + tid]);
      if (kQuant) v *= vs_s[p];
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) {
        if (g < group) acc[g] += p_s[g][p] * v;
      }
    }
    __syncthreads();
  }

  if (k_self != nullptr) {  // the self position: one always-valid extra key
    const size_t self_row = ((size_t)b * n_kv + h) * kHeadDim;
    for (int g = warp; g < group; g += kWarps) {
      const float* qg = &q_s[g][lane * 4];
      const float* ks = k_self + self_row + lane * 4;
      float part = qg[0] * ks[0] + qg[1] * ks[1] + qg[2] * ks[2] + qg[3] * ks[3];
      part = warp_sum(part);
      if (lane == 0) {
        const float s = part * scale;
        const float m_new = fmaxf(m_s[g], s);
        const float p = expf(s - m_new);
        const float a = expf(m_s[g] - m_new);
        alpha_s[g] = a;
        pself_s[g] = p;
        l_s[g] = l_s[g] * a + p;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
    const float vs = v_self[self_row + tid];
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
      if (g < group) acc[g] = acc[g] * alpha_s[g] + pself_s[g] * vs;
    }
  }

#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    if (g < group) store(&out[row0 + g * kHeadDim + tid], acc[g] / fmaxf(l_s[g], 1e-30f));
  }
}

template <typename Q, typename KV>
int launch(const void* q, const void* k_cache, const void* v_cache,
           const void* k_scale, const void* v_scale, const void* k_self,
           const void* v_self, const void* block_tables, const void* seq_lens,
           void* out, int batch, int n_q, int n_kv, long long total_slots,
           int block_size, int max_blocks, float scale, cudaStream_t stream) {
  const dim3 grid(batch, n_kv);
  paged_attention_kernel<Q, KV><<<grid, kThreads, 0, stream>>>(
      (const Q*)q, (const KV*)k_cache, (const KV*)v_cache, (const float*)k_scale,
      (const float*)v_scale, (const float*)k_self, (const float*)v_self,
      (const int*)block_tables, (const int*)seq_lens, (Q*)out, n_q, n_kv,
      total_slots, block_size, max_blocks, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes): q in f32 (q_bf16 = 0) or bf16,
// pages in bf16 (kv_int8 = 0) or int8 with scales; k_self/v_self may be
// null. Launches on `stream` and returns cudaGetLastError(): nonzero when
// the launch was refused.
extern "C" int paged_attention_launch(
    const void* q, const void* k_cache, const void* v_cache,
    const void* k_scale, const void* v_scale, const void* k_self,
    const void* v_self, const void* block_tables, const void* seq_lens,
    void* out, int batch, int n_q, int n_kv, long long total_slots,
    int block_size, int max_blocks, int q_bf16, int kv_int8, float scale,
    void* stream) {
  if (n_kv <= 0 || n_q % n_kv != 0 || n_q / n_kv > kMaxGroup || block_size <= 0 ||
      max_blocks <= 0 || (kv_int8 && (k_scale == nullptr || v_scale == nullptr)) ||
      ((k_self == nullptr) != (v_self == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (batch <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (q_bf16) {
    if (kv_int8)
      return launch<__nv_bfloat16, int8_t>(q, k_cache, v_cache, k_scale, v_scale, k_self,
                                           v_self, block_tables, seq_lens, out, batch, n_q,
                                           n_kv, total_slots, block_size, max_blocks, scale, s);
    return launch<__nv_bfloat16, __nv_bfloat16>(q, k_cache, v_cache, k_scale, v_scale, k_self,
                                                v_self, block_tables, seq_lens, out, batch, n_q,
                                                n_kv, total_slots, block_size, max_blocks, scale, s);
  }
  if (kv_int8)
    return launch<float, int8_t>(q, k_cache, v_cache, k_scale, v_scale, k_self, v_self,
                                 block_tables, seq_lens, out, batch, n_q, n_kv, total_slots,
                                 block_size, max_blocks, scale, s);
  return launch<float, __nv_bfloat16>(q, k_cache, v_cache, k_scale, v_scale, k_self, v_self,
                                      block_tables, seq_lens, out, batch, n_q, n_kv, total_slots,
                                      block_size, max_blocks, scale, s);
}
