// Ragged paged attention for Hopper (sm_90a): one launch per layer.
//
// Replaces the TPU kernel the JAX package calls at
// dynamo_tpu/ops/ragged_attention.py:163-188 (the JAX library's Pallas
// ragged paged attention) and computes exactly the function of its plain
// reference, ragged_paged_attention_ref (same file, :60-114):
//
//   q            [T, n_q, 128]                 bf16
//   kv_pages     [n_pages, page_size, 2*n_kv, 128] bf16, K at even and V
//                at odd combined heads (read in place); or int8 with
//   kv_scales    [n_pages, page_size, 2*n_kv] f32 (the int8 entry point)
//   kv_lens      [S] i32   tokens of sequence s in cache (incl. this step)
//   page_indices [S, pages_per_seq] i32
//   cu_q_lens    [S+1] i32 sequence s owns q rows cu[s] .. cu[s+1]-1
//   num_seqs     [1] i32   valid sequences, read here from device memory
//   out          [T, n_q, 128] bf16
//
// Query row t of sequence s sits at abs = kv_lens[s] - q_len_s + (t - cu[s])
// and attends cache positions p <= abs and p < kv_lens[s] (causal GQA).
// Rows at or past cu[num_seqs] are written as zeros. Softmax runs in f32.
//
// Design (first, simple and right): one thread block of 128 threads per
// (query row, kv head). The block stages the `group` query heads that
// share the kv head in shared memory, then walks the sequence's pages only
// up to the row's last visible position (table entries past it point at
// the garbage page and are never read), 64 positions per tile:
//   scores  each warp takes positions, each lane 4 of the 128 dims of the
//           K row (one coalesced 256-byte row per warp), a shuffle sum per
//           query head;
//   softmax online (running max and sum per head) in f32 registers and
//           shared memory;
//   values  thread d accumulates dim d of every head over the tile's V rows.
// A row with no visible position (a query ahead of its own cache, which
// the engine never builds) is written as zeros.
//
// int8 pages (kv_scales mode, a second instance of the same template):
// each position then moves 128 bytes of K, 128 of V and 8 bytes of scales
// per kv head instead of 512. Values are dequantized in registers, in
// f32: the score is scale_k * (q . k_int8), the scale applied once to the
// warp's sum, not to each element; the value pass accumulates
// p * scale_v * v_int8. A warp reads one int8 K row as 32 lanes x 4 bytes,
// one coalesced 128-byte load. This computes the function of the plain
// reference (dequantize-on-gather, ragged_attention.py:92-101), not the
// TPU serving path's: on the TPU the JAX package first dequantizes the
// referenced pages to bf16 and then calls the library kernel (:141-162).
//
// What bounds it on the H100: decode reads every visible K and V row once
// per (row, kv head), 512 bytes per position, against 3.35 TB/s; the query
// heads of one kv head share that read, so GQA costs no extra bytes. This
// design keeps that property but issues narrow loads without overlap and
// runs at most T * n_kv blocks, so a small decode batch leaves most SMs
// idle, long decode rows are walked serially (no split-KV), and prefill
// rows of one sequence each re-read its K/V (no query tiling, no tensor
// cores). wgmma, TMA pipelines, split-KV and query tiling are later work.

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

__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(int8_t v) { return (float)v; }

// KV is __nv_bfloat16 (kv_scales == nullptr) or int8_t (kv_scales set).
template <typename KV>
__global__ void __launch_bounds__(kThreads)
ragged_paged_attention_kernel(
    const __nv_bfloat16* __restrict__ q,
    const KV* __restrict__ kv,
    const float* __restrict__ kv_scales,
    const int* __restrict__ kv_lens,
    const int* __restrict__ page_indices,
    const int* __restrict__ cu_q_lens,
    const int* __restrict__ num_seqs,
    __nv_bfloat16* __restrict__ out,
    int n_q, int n_kv, int page_size, int pages_per_seq, int max_seqs,
    float sm_scale) {
  constexpr bool kQuant = sizeof(KV) == 1;
  const int t = blockIdx.x;
  const int h = blockIdx.y;
  const int group = n_q / n_kv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  __shared__ float q_s[kMaxGroup][kHeadDim];
  __shared__ float p_s[kMaxGroup][kTile];
  __shared__ int slot_s[kTile];
  __shared__ float ks_s[kTile];  // int8: the K and V scales of each slot
  __shared__ float vs_s[kTile];
  __shared__ float m_s[kMaxGroup];
  __shared__ float l_s[kMaxGroup];
  __shared__ float alpha_s[kMaxGroup];

  __nv_bfloat16* out_row = out + ((size_t)t * n_q + (size_t)h * group) * kHeadDim;

  // Locate the row's sequence: s = #{i in 1..S : cu[i] <= t}, clamped.
  int s = 0;
  for (int i = 1; i <= max_seqs; ++i) s += (cu_q_lens[i] <= t);
  if (s > max_seqs - 1) s = max_seqs - 1;
  const int end_rows = cu_q_lens[num_seqs[0]];
  const int q_len = cu_q_lens[s + 1] - cu_q_lens[s];
  const int kv_len = kv_lens[s];
  const int abs_pos = kv_len - q_len + (t - cu_q_lens[s]);
  const int n_vis = min(abs_pos + 1, kv_len);

  if (t >= end_rows || n_vis <= 0) {  // uniform over the block
    for (int g = 0; g < group; ++g) out_row[g * kHeadDim + tid] = __float2bfloat16(0.f);
    return;
  }

  const __nv_bfloat16* q_row = q + ((size_t)t * n_q + (size_t)h * group) * kHeadDim;
  for (int g = 0; g < group; ++g) q_s[g][tid] = __bfloat162float(q_row[g * kHeadDim + tid]);
  if (tid < group) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  float acc[kMaxGroup];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) acc[g] = 0.f;

  const int* table = page_indices + (size_t)s * pages_per_seq;
  const size_t row_stride = (size_t)2 * n_kv * kHeadDim;
  const KV* k_base = kv + (size_t)(2 * h) * kHeadDim;
  const KV* v_base = k_base + kHeadDim;

  for (int base = 0; base < n_vis; base += kTile) {
    const int n = min(kTile, n_vis - base);
    if (tid < n) {
      const int pos = base + tid;
      const int pg = pos / page_size;
      const int slot = table[pg] * page_size + (pos - pg * page_size);
      slot_s[tid] = slot;
      if (kQuant) {
        const float* sc = kv_scales + (size_t)slot * 2 * n_kv + 2 * h;
        ks_s[tid] = sc[0];
        vs_s[tid] = sc[1];
      }
    }
    __syncthreads();

    // Scores: q . k * sm_scale for every head of the group.
    for (int p = warp; p < n; p += kWarps) {
      float k4[4];
      load4(k_base + (size_t)slot_s[p] * row_stride + lane * 4, k4);
      const float k_scale = kQuant ? ks_s[p] * sm_scale : sm_scale;
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) {
        if (g < group) {
          const float* qg = &q_s[g][lane * 4];
          float part = qg[0] * k4[0] + qg[1] * k4[1] + qg[2] * k4[2] + qg[3] * k4[3];
          part = warp_sum(part);
          if (lane == 0) p_s[g][p] = part * k_scale;
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
      float v = to_float(v_base[(size_t)slot_s[p] * row_stride + tid]);
      if (kQuant) v *= vs_s[p];
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) {
        if (g < group) acc[g] += p_s[g][p] * v;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    if (g < group) out_row[g * kHeadDim + tid] = __float2bfloat16(acc[g] / l_s[g]);
  }
}

template <typename KV>
int launch(const void* q, const void* kv_pages, const void* kv_scales,
           const void* kv_lens, const void* page_indices, const void* cu_q_lens,
           const void* num_seqs, void* out, int num_tokens, int n_q, int n_kv,
           int page_size, int pages_per_seq, int max_seqs, float sm_scale,
           void* stream) {
  if (n_kv <= 0 || n_q % n_kv != 0 || n_q / n_kv > kMaxGroup || max_seqs <= 0)
    return (int)cudaErrorInvalidValue;
  if (num_tokens <= 0) return 0;
  const dim3 grid(num_tokens, n_kv);
  ragged_paged_attention_kernel<KV><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const KV*)kv_pages, (const float*)kv_scales,
      (const int*)kv_lens, (const int*)page_indices, (const int*)cu_q_lens,
      (const int*)num_seqs, (__nv_bfloat16*)out, n_q, n_kv, page_size,
      pages_per_seq, max_seqs, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each launches on `stream`
// and returns cudaGetLastError(): nonzero when the launch was refused.
extern "C" int ragged_paged_attention_launch(
    const void* q, const void* kv_pages, const void* kv_lens,
    const void* page_indices, const void* cu_q_lens, const void* num_seqs,
    void* out, int num_tokens, int n_q, int n_kv, int page_size,
    int pages_per_seq, int max_seqs, float sm_scale, void* stream) {
  return launch<__nv_bfloat16>(q, kv_pages, nullptr, kv_lens, page_indices,
                               cu_q_lens, num_seqs, out, num_tokens, n_q, n_kv,
                               page_size, pages_per_seq, max_seqs, sm_scale, stream);
}

extern "C" int ragged_paged_attention_int8_launch(
    const void* q, const void* kv_pages, const void* kv_scales,
    const void* kv_lens, const void* page_indices, const void* cu_q_lens,
    const void* num_seqs, void* out, int num_tokens, int n_q, int n_kv,
    int page_size, int pages_per_seq, int max_seqs, float sm_scale, void* stream) {
  return launch<int8_t>(q, kv_pages, kv_scales, kv_lens, page_indices, cu_q_lens,
                        num_seqs, out, num_tokens, n_q, n_kv, page_size,
                        pages_per_seq, max_seqs, sm_scale, stream);
}
