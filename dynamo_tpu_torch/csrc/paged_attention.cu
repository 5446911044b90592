// Paged decode attention for Hopper (sm_90a): K2, one query token per
// sequence over its KV blocks in head-major flat caches.
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
//   v_self       [B, n_kv, 128] f32         an always-valid extra key, folded in once
//   out          [B, n_q, 128]              q's dtype: acc / max(l, 1e-30)
//
// Sequence b attends positions 0 .. min(seq_lens[b], max_blocks * bs) - 1
// and, when given, its self position; with neither, its output is zeros
// (as _paged_attn_kernel writes it). Softmax runs online, in f32, in base 2
// (scores carry log2(e)). int8 pages are dequantized in registers with the
// slot's scales: score = k_scale * (q . k_int8) * scale, value = v_scale *
// v_int8.
//
// What bounds it on the H100: bytes. Each (sequence, kv head) reads its
// visible K and V rows once: 512 bytes per position in bf16, 264 in int8
// (256 + two f32 scales), at 3.35 TB/s; it does 4 * group operations per
// position and dim, far below what the card computes in that time. The
// caches are head-major, so one page of one kv head is one contiguous run
// (block_size x 256 bytes of K and as much of V in bf16) and its scales are
// block_size x 4 contiguous bytes. What the design does:
//   - grid (B, n_kv, n_splits): the wrapper (ops/paged_attention.py
//     paged_split_plan) cuts each table into n_splits chunks of whole pages,
//     enough that the card is filled as if every row were full; a block
//     whose chunk starts past its sequence's last visible position exits at
//     once;
//   - the block copies its chunk's table entries to shared memory once, up
//     front (cp.async, in flight beside the seq_lens load), so no tile waits
//     on a dependent table load;
//   - a ring of kStages tiles of kTile positions in dynamic shared memory
//     (K tile, V tile and, for int8, the K and V scale runs) filled by
//     cp.async, 16 bytes per thread, so the next tiles are in flight while
//     the current one is scored; copies past the visible range zero-fill,
//     so 0 x garbage never becomes NaN; one __syncthreads per tile;
//   - scores: a half-warp per position, each lane 8 of the 128 dims, the
//     group's query heads (kept in registers) sharing each K/V read, a
//     4-step shuffle sum; each half-warp keeps its own online softmax over
//     its positions, merged in shared memory at the end;
//   - each split writes f32 partials (m, l, o[group][128]) to scratch the
//     wrapper allocates, and the combine kernel merges a sequence's used
//     splits by log-sum-exp; the self position is folded in exactly once,
//     by the combine, or by the block itself when n_splits == 1, which then
//     writes the output directly.
//
// Geometry (the compiler's -Xptxas -v numbers are in PERF.md): 128 threads;
// a stage is 32 positions x 512 B = 16 KB (bf16) or 32 x 256 B + 256 B of
// scales (int8); the table run takes (pages_per_split + 1) x 4 B before the
// ring; the end-of-block merge reuses the ring (8 x kG x 130 f32);
// registers ~ 8 q + 8 acc floats per head of the group (the kG template:
// group rounded up to 1, 2, 4 or 8).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 128;
constexpr int kMaxGroup = 8;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kHalfWarps = kThreads / 16;
constexpr int kTile = 32;             // positions per ring stage
constexpr int kStages = 4;            // ring depth
constexpr int kMaxSplitPages = 1024;  // table entries a split may hold
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

// Bytes of the split's table run at the head of dynamic shared memory: one
// entry more than the split's pages, rounded to 16 so the ring stays aligned.
__host__ __device__ constexpr int table_bytes(int pages_per_split) {
  return ((pages_per_split + 1) * 4 + 15) / 16 * 16;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; `valid == false` fills the 16 bytes with zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Eight consecutive elements (32 B of f32, 16 B of bf16, 8 B of int8), as floats.
__device__ __forceinline__ void load8(const float* p, float f[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float f[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 v = __bfloat1622float2(b[k]);
    f[2 * k] = v.x;
    f[2 * k + 1] = v.y;
  }
}

__device__ __forceinline__ void load8(const int8_t* p, float f[8]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int k = 0; k < 8; ++k) f[k] = (float)b[k];
}

// The self score of each head of the group (base 2) into s_out[g]; every
// thread of the block calls it.
template <typename Q>
__device__ void self_scores(const Q* __restrict__ q_row, const float* __restrict__ k_self_row,
                            int group, float scale_log2, float* s_out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int g = warp; g < group; g += kWarps) {
    float d = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      d = fmaf(to_float(q_row[g * kHeadDim + lane * 4 + j]), k_self_row[lane * 4 + j], d);
    d = warp_sum(d);
    if (lane == 0) s_out[g] = d * scale_log2;
  }
  __syncthreads();
}

// One output element of one head from its merged state (o, l, m): the self
// position (score *s_self, value v_self_d) folded in when given, then
// acc / max(l, 1e-30).
template <typename Q>
__device__ __forceinline__ void write_out(Q* dst, float o, float l, float m,
                                          const float* s_self, float v_self_d) {
  if (s_self != nullptr) {
    const float s = *s_self;
    const float m_new = fmaxf(m, s);
    const float a = exp2f(m - m_new);  // 0 when nothing was visible (m = -inf)
    const float p = exp2f(s - m_new);
    o = o * a + p * v_self_d;
    l = l * a + p;
  }
  store(dst, o / fmaxf(l, 1e-30f));
}

// Q is float or __nv_bfloat16; KV is __nv_bfloat16 or int8_t (then the
// scales are set); kG >= group.
template <typename Q, typename KV, int kG>
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
    float* __restrict__ part_o,   // [B, n_kv, n_splits, group, 128], n_splits > 1
    float* __restrict__ part_ml,  // [B, n_kv, n_splits, group, 2]
    int n_q, int n_kv, long long total_slots, int block_size, int max_blocks,
    int n_splits, int pages_per_split, float scale_log2) {
  constexpr bool kQuant = sizeof(KV) == 1;
  constexpr int kRowBytes = kHeadDim * (int)sizeof(KV);
  constexpr int kRowChunks = kRowBytes / 16;          // 16-byte copies per row
  constexpr int kRowsPerPass = kThreads / kRowChunks;  // rows one pass of the block copies
  constexpr int kCopies = kTile / kRowsPerPass;        // K (and V) copies per thread per tile
  constexpr int kTileBytes = kTile * kRowBytes;
  constexpr int kStageBytes = 2 * kTileBytes + (kQuant ? 2 * kTile * 4 : 0);
  constexpr int kPer = kTile / kHalfWarps;             // positions per half-warp per tile
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float s_self_s[kMaxGroup];
  int* const table_s = reinterpret_cast<int*>(smem);
  unsigned char* const ring = smem + table_bytes(pages_per_split);

  const int b = blockIdx.x, h = blockIdx.y, split = blockIdx.z;
  const int group = n_q / n_kv;
  const int tid = threadIdx.x, lane = tid & 31;
  const int l16 = lane & 15;
  const int hw = tid >> 4;  // this half-warp: positions hw, hw + 8, ... of a tile

  // The split's table entries, in flight beside the seq_lens load.
  const int split_len = pages_per_split * block_size;
  const int span = max_blocks * block_size;
  const int c0 = split * split_len;
  const int c_end = min((split + 1) * split_len, span);
  const int page0 = c0 / block_size;
  const int n_pages = (c_end + block_size - 1) / block_size - page0;
  const int* table = block_tables + (size_t)b * max_blocks + page0;
  for (int i = tid; i < n_pages; i += kThreads) cp_async4(table_s + i, table + i, true);
  cp_async_commit();

  const int n_vis = max(0, min(seq_lens[b], span));
  if (c0 >= n_vis && n_splits > 1) {  // nothing visible in this chunk (uniform over the block)
    cp_async_wait<0>();
    return;
  }
  const int c1 = min(c_end, n_vis);
  const int n_tiles = c1 > c0 ? (c1 - c0 + kTile - 1) / kTile : 0;
  const size_t head_slots = (size_t)h * total_slots;
  const KV* k_head = k_cache + head_slots * kHeadDim;
  const KV* v_head = v_cache + head_slots * kHeadDim;

  // The group's query rows, this lane's 8 dims, scaled into the base-2 domain.
  const size_t row0 = (size_t)b * n_q + (size_t)h * group;
  float qf[kG][8];
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    if (g < group) {
      load8(q + (row0 + g) * kHeadDim + l16 * 8, qf[g]);
#pragma unroll
      for (int j = 0; j < 8; ++j) qf[g][j] *= scale_log2;
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) qf[g][j] = 0.f;
    }
  }
  float m[kG], l[kG], acc[kG][8];
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[g][j] = 0.f;
  }

  auto slot_of = [&](int pos) -> size_t {
    const int pg = pos / block_size;
    return (size_t)table_s[pg - page0] * block_size + (pos - pg * block_size);
  };
  auto fetch = [&](int it) {
    unsigned char* st = ring + (it % kStages) * kStageBytes;
    const int base = c0 + it * kTile;
    const int part = tid % kRowChunks;
#pragma unroll
    for (int i = 0; i < kCopies; ++i) {
      const int p = tid / kRowChunks + i * kRowsPerPass;
      const bool ok = base + p < c1;
      const size_t off = (ok ? slot_of(base + p) : 0) * kRowBytes + part * 16;
      cp_async16(st + p * kRowBytes + part * 16,
                 reinterpret_cast<const unsigned char*>(k_head) + off, ok);
      cp_async16(st + kTileBytes + p * kRowBytes + part * 16,
                 reinterpret_cast<const unsigned char*>(v_head) + off, ok);
    }
    if constexpr (kQuant) {  // K scales, then V scales, of the tile's slots
      if (tid < 2 * kTile) {
        const int p = tid % kTile;
        const bool ok = base + p < c1;
        const float* src =
            (tid < kTile ? k_scale : v_scale) + head_slots + (ok ? slot_of(base + p) : 0);
        cp_async4(st + 2 * kTileBytes + tid * 4, src, ok);
      }
    }
  };

  cp_async_wait<0>();
  __syncthreads();  // the table run is in
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_tiles) fetch(i);
    cp_async_commit();
  }
  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile `it` is in; every thread is done with tile it - 1
    if (it + kStages - 1 < n_tiles) fetch(it + kStages - 1);
    cp_async_commit();

    const unsigned char* st = ring + (it % kStages) * kStageBytes;
    const float* sc = reinterpret_cast<const float*>(st + 2 * kTileBytes);
    const int base = c0 + it * kTile;
    float s_[kPer][kG];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int p = hw + i * kHalfWarps;
      float kf[8];
      load8(reinterpret_cast<const KV*>(st + p * kRowBytes) + l16 * 8, kf);
      const float ksc = kQuant ? sc[p] : 1.f;
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        float d = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) d = fmaf(qf[g][j], kf[j], d);
        d += __shfl_xor_sync(kFull, d, 8);
        d += __shfl_xor_sync(kFull, d, 4);
        d += __shfl_xor_sync(kFull, d, 2);
        d += __shfl_xor_sync(kFull, d, 1);
        s_[i][g] = base + p < c1 ? d * ksc : -INFINITY;
      }
    }
    // Online softmax per head over this half-warp's positions of the tile.
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      float mx = s_[0][g];
#pragma unroll
      for (int i = 1; i < kPer; ++i) mx = fmaxf(mx, s_[i][g]);
      const float m_new = fmaxf(m[g], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2f(m[g] - m_use);
      m[g] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        s_[i][g] = exp2f(s_[i][g] - m_use);
        sum += s_[i][g];
      }
      l[g] = l[g] * alpha + sum;
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[g][j] *= alpha;
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int p = hw + i * kHalfWarps;
      float vf[8];
      load8(reinterpret_cast<const KV*>(st + kTileBytes + p * kRowBytes) + l16 * 8, vf);
      const float vsc = kQuant ? sc[kTile + p] : 1.f;
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        const float w = s_[i][g] * vsc;
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[g][j] = fmaf(w, vf[j], acc[g][j]);
      }
    }
  }

  // Merge the eight half-warps' states through shared memory (the table
  // run and the ring are free once every copy has landed and every thread
  // is past its last tile).
  cp_async_wait<0>();
  __syncthreads();
  float* red_o = reinterpret_cast<float*>(smem);       // [8][kG][128]
  float* red_ml = red_o + kHalfWarps * kG * kHeadDim;  // [8][kG][2]
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    float4* dst = reinterpret_cast<float4*>(red_o + (hw * kG + g) * kHeadDim + l16 * 8);
    dst[0] = make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
    dst[1] = make_float4(acc[g][4], acc[g][5], acc[g][6], acc[g][7]);
    if (l16 == 0) {
      red_ml[(hw * kG + g) * 2] = m[g];
      red_ml[(hw * kG + g) * 2 + 1] = l[g];
    }
  }
  __syncthreads();
  const bool direct = n_splits == 1;
  if (direct && k_self != nullptr)
    self_scores(q + row0 * kHeadDim, k_self + ((size_t)b * n_kv + h) * kHeadDim, group,
                scale_log2, s_self_s);
  for (int g = 0; g < group; ++g) {
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kHalfWarps; ++w) mx = fmaxf(mx, red_ml[(w * kG + g) * 2]);
    const float m_use = mx == -INFINITY ? 0.f : mx;
    float sum = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kHalfWarps; ++w) {
      const float e = exp2f(red_ml[(w * kG + g) * 2] - m_use);
      sum += e * red_ml[(w * kG + g) * 2 + 1];
      o += e * red_o[(w * kG + g) * kHeadDim + tid];
    }
    if (direct) {
      const bool with_self = k_self != nullptr;
      write_out(out + (row0 + g) * kHeadDim + tid, o, sum, mx,
                with_self ? &s_self_s[g] : nullptr,
                with_self ? v_self[((size_t)b * n_kv + h) * kHeadDim + tid] : 0.f);
    } else {
      const size_t at = (((size_t)b * n_kv + h) * n_splits + split) * group + g;
      part_o[at * kHeadDim + tid] = o;
      if (tid == 0) {
        part_ml[at * 2] = mx;
        part_ml[at * 2 + 1] = sum;
      }
    }
  }
}

// Merges a sequence's used split partials by log-sum-exp, folds in the self
// position once, and writes the output in q's dtype; a sequence with no
// visible position and no self position gets zeros.
template <typename Q>
__global__ void __launch_bounds__(kThreads)
paged_attention_combine_kernel(
    const Q* __restrict__ q,
    const float* __restrict__ k_self,
    const float* __restrict__ v_self,
    const int* __restrict__ seq_lens,
    const float* __restrict__ part_o,
    const float* __restrict__ part_ml,
    Q* __restrict__ out,
    int n_q, int n_kv, int block_size, int max_blocks, int n_splits, int split_len,
    float scale_log2) {
  __shared__ float s_self_s[kMaxGroup];
  const int b = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int group = n_q / n_kv;
  const size_t row0 = (size_t)b * n_q + (size_t)h * group;
  const size_t self_row = ((size_t)b * n_kv + h) * kHeadDim;
  const int n_vis = max(0, min(seq_lens[b], max_blocks * block_size));
  // Splits that hold at least one visible position; the others never ran.
  const int n_used = min(n_splits, (n_vis + split_len - 1) / split_len);
  const bool with_self = k_self != nullptr;
  if (with_self) self_scores(q + row0 * kHeadDim, k_self + self_row, group, scale_log2, s_self_s);
  const size_t at0 = ((size_t)b * n_kv + h) * n_splits * group;
  for (int g = 0; g < group; ++g) {
    float mx = -INFINITY;
    for (int i = 0; i < n_used; ++i) mx = fmaxf(mx, part_ml[(at0 + i * group + g) * 2]);
    const float m_use = mx == -INFINITY ? 0.f : mx;
    float sum = 0.f, o = 0.f;
    for (int i = 0; i < n_used; ++i) {
      const size_t at = at0 + i * group + g;
      const float e = exp2f(part_ml[at * 2] - m_use);
      sum += e * part_ml[at * 2 + 1];
      o += e * part_o[at * kHeadDim + tid];
    }
    write_out(out + (row0 + g) * kHeadDim + tid, o, sum, mx,
              with_self ? &s_self_s[g] : nullptr, with_self ? v_self[self_row + tid] : 0.f);
  }
}

// -- host side ---------------------------------------------------------------------

struct Args {
  const void *q, *k_cache, *v_cache, *k_scale, *v_scale, *k_self, *v_self;
  const void *block_tables, *seq_lens;
  void *out, *part_o, *part_ml;
  int batch, n_q, n_kv, block_size, max_blocks, n_splits, pages_per_split;
  long long total_slots;
  float scale_log2;
  cudaStream_t stream;
};

template <typename Q, typename KV, int kG>
int launch_g(const Args& a) {
  constexpr int kStage = 2 * kTile * kHeadDim * (int)sizeof(KV) + (sizeof(KV) == 1 ? 2 * kTile * 4 : 0);
  constexpr int kRing = kStages * kStage;
  constexpr int kMerge = kHalfWarps * kG * (kHeadDim + 2) * 4;
  constexpr int kSmemMax = table_bytes(kMaxSplitPages) + kRing > kMerge
                               ? table_bytes(kMaxSplitPages) + kRing : kMerge;
  auto kernel = paged_attention_kernel<Q, KV, kG>;
  static bool smem_set = false;  // this instance opted into kSmemMax once
  if (!smem_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  const int need = table_bytes(a.pages_per_split) + kRing;
  const int smem = need > kMerge ? need : kMerge;
  kernel<<<dim3(a.batch, a.n_kv, a.n_splits), kThreads, smem, a.stream>>>(
      (const Q*)a.q, (const KV*)a.k_cache, (const KV*)a.v_cache, (const float*)a.k_scale,
      (const float*)a.v_scale, (const float*)a.k_self, (const float*)a.v_self,
      (const int*)a.block_tables, (const int*)a.seq_lens, (Q*)a.out, (float*)a.part_o,
      (float*)a.part_ml, a.n_q, a.n_kv, a.total_slots, a.block_size, a.max_blocks, a.n_splits,
      a.pages_per_split, a.scale_log2);
  if (a.n_splits > 1) {
    paged_attention_combine_kernel<Q><<<dim3(a.batch, a.n_kv), kThreads, 0, a.stream>>>(
        (const Q*)a.q, (const float*)a.k_self, (const float*)a.v_self, (const int*)a.seq_lens,
        (const float*)a.part_o, (const float*)a.part_ml, (Q*)a.out, a.n_q, a.n_kv,
        a.block_size, a.max_blocks, a.n_splits, a.pages_per_split * a.block_size,
        a.scale_log2);
  }
  return (int)cudaGetLastError();
}

template <typename Q, typename KV>
int launch_qkv(const Args& a) {
  const int group = a.n_q / a.n_kv;
  if (group <= 1) return launch_g<Q, KV, 1>(a);
  if (group <= 2) return launch_g<Q, KV, 2>(a);
  if (group <= 4) return launch_g<Q, KV, 4>(a);
  return launch_g<Q, KV, 8>(a);
}

}  // namespace

// Plain C entry point (loaded with ctypes): q in f32 (q_bf16 = 0) or bf16,
// pages in bf16 (kv_int8 = 0) or int8 with scales; k_self/v_self may be
// null. The plan (n_splits, pages_per_split) and, when n_splits > 1, the
// f32 scratch part_o / part_ml come from ops/paged_attention.py. Launches
// on `stream` and returns cudaGetLastError(): nonzero when a launch was
// refused.
extern "C" int paged_attention_launch(
    const void* q, const void* k_cache, const void* v_cache,
    const void* k_scale, const void* v_scale, const void* k_self,
    const void* v_self, const void* block_tables, const void* seq_lens,
    void* out, void* part_o, void* part_ml, int batch, int n_q, int n_kv,
    int block_size, int max_blocks, int n_splits, int pages_per_split,
    long long total_slots, int q_bf16, int kv_int8, float scale, void* stream) {
  if (n_kv <= 0 || n_q % n_kv != 0 || n_q / n_kv > kMaxGroup || n_q / n_kv < 1 ||
      block_size <= 0 || max_blocks <= 0 || n_splits < 1 || pages_per_split < 1 ||
      pages_per_split > kMaxSplitPages || (long long)n_splits * pages_per_split < max_blocks ||
      (long long)(n_splits - 1) * pages_per_split >= max_blocks ||
      (long long)n_splits * pages_per_split * block_size > 0x7fffffffLL ||
      (kv_int8 && (k_scale == nullptr || v_scale == nullptr)) ||
      ((k_self == nullptr) != (v_self == nullptr)) ||
      (n_splits > 1 && (part_o == nullptr || part_ml == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (batch <= 0) return 0;
  const Args a{q, k_cache, v_cache, k_scale, v_scale, k_self, v_self, block_tables, seq_lens,
               out, part_o, part_ml, batch, n_q, n_kv, block_size, max_blocks, n_splits,
               pages_per_split, total_slots, scale * kLog2e, (cudaStream_t)stream};
  if (q_bf16) {
    if (kv_int8) return launch_qkv<__nv_bfloat16, int8_t>(a);
    return launch_qkv<__nv_bfloat16, __nv_bfloat16>(a);
  }
  if (kv_int8) return launch_qkv<float, int8_t>(a);
  return launch_qkv<float, __nv_bfloat16>(a);
}
