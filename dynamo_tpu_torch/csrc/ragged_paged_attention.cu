// Ragged paged attention for Hopper (sm_90a): K1, one launch per layer.
//
// Replaces the TPU kernel the JAX package calls at
// dynamo_tpu/ops/ragged_attention.py:163-188 (the JAX library's Pallas
// ragged paged attention) and computes exactly the function of its plain
// reference, ragged_paged_attention_ref (same file, :60-114):
//
//   q            [T, n_q, D]                   bf16, D = head_dim, 64 or 128
//   kv_pages     [n_pages, page_size, 2*n_kv, D] bf16, K at even and V
//                at odd combined heads (read in place); or int8 with
//   kv_scales    [n_pages, page_size, 2*n_kv] f32 (the int8 entry points)
//   kv_lens      [S] i32   tokens of sequence s in cache (incl. this step)
//   page_indices [S, pages_per_seq] i32
//   cu_q_lens    [S+1] i32 sequence s owns q rows cu[s] .. cu[s+1]-1
//   num_seqs     [1] i32   valid sequences, read here from device memory
//   out          [T, n_q, D] bf16
//
// Query row t of sequence s sits at abs = kv_lens[s] - q_len_s + (t - cu[s])
// and attends cache positions p <= abs and p < kv_lens[s] (causal GQA).
// Rows at or past cu[num_seqs], and rows with no visible position (a query
// ahead of its own cache, which the engine never builds), are written as
// zeros. Softmax runs in f32 (in base 2: scores carry log2(e)).
//
// int8 pages compute the plain reference's function (dequantize-on-gather,
// ragged_attention.py:92-101), not the TPU serving path's (which first
// dequantizes the referenced pages to bf16 and calls the library kernel,
// :141-162): score = k_scale * (q . k_int8) * sm_scale, value = v_scale *
// v_int8, both scales applied in f32.
//
// Two kernels; the caller states which (ops/ragged_attention.py): the
// engine's decode form, one query row per sequence, takes the split-KV
// decode kernel, every other forward (prefill waves, mixed steps) the tiled
// kernel. Each is right on every ragged batch, but the decode kernel walks
// each query row's positions on its own: a chunk's rows through it cost
// many times the tiled kernel's time, so the form is stated, not read off
// T == S (a mixed step's token bucket can equal its row count).
//
// Every kernel is a template over the head dim D: an instance for 128
// (llama3-8b, Qwen2-7B, Mixtral; the figures below are its own) and one for
// 64 (Llama-3.2-1B's published 32 x 64 heads, TinyLlama, Qwen2.5-0.5B,
// SmolLM2), each with its own C entry points. At 64 a position's K (or V)
// row is 8 chunks of 16 bytes: the decode kernel scores it with 8 lanes (16
// positions at once, in place of 8), and the tiled kernel's tiles and
// fragments halve; the swizzle below stays a permutation of a row's chunks.
//
// 1. Split-KV decode (ragged_paged_attention_decode_kernel + _combine_kernel).
//    What bounds it: bytes. A decode row reads every visible K and V row of
//    its kv head once, 4 * D bytes per position (bf16; 2 * D + 8 of scales
//    for int8), and does 4 operations per byte: far below the 295 the tensor
//    cores need, so HBM at 3.35 TB/s is the limit. What the design does:
//    - grid (T rows, n_kv, n_splits): the wrapper cuts each row's pages into
//      n_splits chunks of whole pages, at least 256 positions each
//      (ops/ragged_attention.py decode_split_plan, up to 16 blocks per SM if
//      every row were full), so a short batch still fills the card and no
//      block walks far; a block whose chunk starts past the row's last
//      visible position exits at once;
//    - the group's query heads share each K/V row read (GQA costs no bytes);
//    - a ring of kDecStages page tiles in shared memory filled by cp.async,
//      16 bytes per thread (one position's K and V rows of a kv head are one
//      contiguous 4 * D-byte run: a warp copies it in one instruction), so the
//      next tiles are in flight while the current one is scored; one
//      __syncthreads per 32-position tile;
//    - scores: D / 8 lanes per position (a half-warp at 128, a quarter at
//      64), each lane 8 dims (16 B of bf16 K, 8 B of int8), a shuffle sum
//      over them; each lane group keeps its own online softmax over its
//      positions, merged in shared memory at the end;
//    - the block writes a partial (m, l, o[group][D]) in f32 to scratch and
//      the combine kernel merges a row's splits by log-sum-exp into the bf16
//      output (splits past the row's last visible position are skipped);
//      with n_splits == 1 the block writes the output itself.
//
// 2. Query-tiled tensor-core kernel (ragged_paged_attention_tiled_kernel),
//    prefill waves and mixed batches. What bounds it: operations for a long
//    prefill (4 * visible positions * n_q * D on the bf16 tensor cores),
//    bytes for short rows. What the design does (FlashAttention-2 in shape):
//    - a block of 8 warps takes kTileM = 128 "M rows": kTileM / group query
//      rows of one sequence times the group's heads (row-major, m = r * group
//      + head), so every K/V tile it loads serves all of them (on an H100,
//      128 M rows ran the prefill wave in 0.76 ms against 1.10 for 64;
//      PERF.md);
//      grid (q tiles, n_kv),
//      sized on the host from the bound ceil(T / BM) + S; each block finds
//      its (sequence, tile) from cu_q_lens with one warp scan, and the
//      blocks past the real tiles write the padded rows' zeros;
//    - K/V tiles of kTileN = 64 positions, cp.async into a double-buffered
//      ring (int8: the raw pages, then converted to bf16 in shared memory;
//      int8 values are exact in bf16 and the scales are applied in f32 to
//      the score and probability columns), XOR-swizzled so ldmatrix reads
//      are free of bank conflicts;
//    - QK^T and PV on the tensor cores, mma.sync.m16n8k16 bf16 -> f32, the
//      Q fragments held in registers for the whole walk; online softmax in
//      f32; P rounded to bf16 for PV (FlashAttention's register reuse);
//    - causal tile skipping: the walk stops at the tile's last visible
//      position, and the mask is applied only on tiles that cross the first
//      row's boundary or kv_len.
//
// Geometry and budgets at D = 128 (the compiler's -Xptxas -v numbers are in
// PERF.md; at 64 every tile and stage is half as large, the decode merge
// 16 x kG x 66 f32, the tiled kernel 48 KB / 49 KB):
//   decode: 128 threads; stage = 32 positions x 512 B (bf16) = 16 KB or
//           32 x 256 B + 256 B of scales (int8); 3 stages = 48 KB / 24.75 KB
//           of dynamic shared memory (the end-of-block merge reuses it:
//           8 x kG x 130 f32); registers ~ 8 q + 8 acc floats per head of
//           the group (the kG template: group rounded up to 1, 2, 4 or 8).
//   tiled:  256 threads (8 warps x 16 M rows); BM = 128 / group query rows;
//           Q tile 32 KB + 2 x (K 16 KB + V 16 KB) = 96 KB (bf16), or Q 32 KB
//           + K, V 32 KB + 2 x 16 KB raw int8 + 1 KB scales = 97 KB (int8);
//           registers: O 64 + S 32 + Q fragments 32 per thread (~210 in all:
//           one block per SM; capping them for two blocks spills and runs no
//           faster).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxGroup = 8;
constexpr int kThreads = 128;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

constexpr int kDecTile = 32;    // positions per decode pipeline stage
constexpr int kDecStages = 3;   // decode ring depth

constexpr int kTileM = 128;     // tiled: M rows (query row x group head) per block
constexpr int kTileN = 64;      // tiled: K/V positions per tile
constexpr int kTiledThreads = kTileM * 2;  // one warp per 16 M rows

// -- small helpers -------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; `valid == false` fills the 16 bytes with zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 8 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

// D += A (16x16 bf16, row) * B (16x8 bf16, col), f32 accumulators.
__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Eight consecutive elements (16 B of bf16, 8 B of int8), as floats.
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

// The sequence that owns query row t < cu[ns]: the s with cu[s] <= t < cu[s+1]
// (binary search; sequences with q_len 0 own no row).
__device__ __forceinline__ int find_seq(const int* __restrict__ cu, int ns, int t) {
  int lo = 0, hi = ns - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (cu[mid + 1] > t) hi = mid; else lo = mid + 1;
  }
  return lo;
}

// Cache slot of position pos of a sequence whose block table is `table`.
__device__ __forceinline__ size_t slot_of(const int* __restrict__ table, int pos, int page_size) {
  const int pg = pos / page_size;
  return (size_t)table[pg] * page_size + (pos - pg * page_size);
}

// Index (in 16-byte units) of chunk c of row `row` in a swizzled [rows][D]
// bf16 tile of kChunks = D / 8 chunks a row (16 or 8): chunk c is stored at
// c ^ (row & 7), a permutation of the row's chunks for either count, so the
// eight rows an ldmatrix reads fall in eight different bank groups.
template <int kChunks>
__device__ __forceinline__ int swz(int row, int c) { return row * kChunks + (c ^ (row & 7)); }

// -- 1. split-KV decode ----------------------------------------------------------

template <typename KV, int kG, int kD>
__global__ void __launch_bounds__(kThreads)
ragged_paged_attention_decode_kernel(
    const __nv_bfloat16* __restrict__ q,
    const KV* __restrict__ kv,
    const float* __restrict__ kv_scales,
    const int* __restrict__ kv_lens,
    const int* __restrict__ page_indices,
    const int* __restrict__ cu_q_lens,
    const int* __restrict__ num_seqs,
    __nv_bfloat16* __restrict__ out,
    float* __restrict__ part_o,   // [T, n_kv, n_splits, group, kD], n_splits > 1
    float* __restrict__ part_ml,  // [T, n_kv, n_splits, group, 2]
    int n_q, int n_kv, int page_size, int pages_per_seq, int max_seqs,
    int n_splits, int split_len, float scale_log2) {
  static_assert(kD == 64 || kD == 128, "head_dim 64 or 128");
  constexpr bool kQuant = sizeof(KV) == 1;
  constexpr int kLanes = kD / 8;               // lanes per position, 8 dims each
  constexpr int kGroups = kThreads / kLanes;   // positions scored at once (8 or 16)
  constexpr int kRowBytes = 2 * kD * (int)sizeof(KV);  // K then V of one head
  constexpr int kStageBytes = kDecTile * kRowBytes;
  constexpr int kRowCopies = kRowBytes / 16;
  constexpr int kCopies = kStageBytes / 16 / kThreads;
  static_assert(kCopies * kThreads * 16 == kStageBytes, "whole 16-byte copies per thread");
  extern __shared__ __align__(16) unsigned char dec_smem[];
  unsigned char* const ring = dec_smem;
  float* const scale_s = reinterpret_cast<float*>(ring + kDecStages * kStageBytes);

  const int t = blockIdx.x, h = blockIdx.y, split = blockIdx.z;
  const int group = n_q / n_kv;
  const int tid = threadIdx.x, lane = tid & 31;
  const int sub = lane & (kLanes - 1);  // this lane's 8 dims of a row
  const int grp = tid / kLanes;  // this lane group: positions grp, grp + kGroups, ... of a tile

  const int ns = min(num_seqs[0], max_seqs);
  int s = 0, dec_vis = 0;
  if (t < cu_q_lens[ns]) {
    s = find_seq(cu_q_lens, ns, t);
    const int kv_len = kv_lens[s];
    const int abs_pos = kv_len - (cu_q_lens[s + 1] - cu_q_lens[s]) + (t - cu_q_lens[s]);
    dec_vis = min(abs_pos + 1, kv_len);
  }
  __nv_bfloat16* out_row = out + ((size_t)t * n_q + (size_t)h * group) * kD;
  const int c0 = split * split_len;
  if (c0 >= dec_vis) {  // nothing visible in this chunk (uniform over the block)
    if (n_splits == 1) {
      for (int i = tid; i < group * kD; i += kThreads) out_row[i] = __float2bfloat16(0.f);
    }
    return;
  }
  const int c1 = min(c0 + split_len, dec_vis);
  const int n_tiles = (c1 - c0 + kDecTile - 1) / kDecTile;
  const int* table = page_indices + (size_t)s * pages_per_seq;
  const size_t slot_stride = (size_t)2 * n_kv * kD;
  const KV* head = kv + (size_t)(2 * h) * kD;

  auto fetch = [&](int it) {
    unsigned char* st = ring + (it % kDecStages) * kStageBytes;
    const int base = c0 + it * kDecTile;
#pragma unroll
    for (int i = 0; i < kCopies; ++i) {
      const int c = tid + i * kThreads;
      const int p = c / kRowCopies, part = c % kRowCopies;
      const bool ok = base + p < c1;
      const KV* src = ok ? head + slot_of(table, base + p, page_size) * slot_stride : head;
      cp_async16(st + p * kRowBytes + part * 16,
                 reinterpret_cast<const unsigned char*>(src) + part * 16, ok);
    }
    if (kQuant && tid < kDecTile) {
      const bool ok = base + tid < c1;
      const float* src = ok ? kv_scales + slot_of(table, base + tid, page_size) * 2 * n_kv + 2 * h
                            : kv_scales;
      cp_async8(scale_s + ((it % kDecStages) * kDecTile + tid) * 2, src, ok);
    }
  };

  // The group's query rows, this lane's 8 dims, scaled into the base-2 domain.
  float qf[kG][8];
  const __nv_bfloat16* q_row = q + ((size_t)t * n_q + (size_t)h * group) * kD + sub * 8;
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    if (g < group) {
      load8(q_row + g * kD, qf[g]);
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

#pragma unroll
  for (int i = 0; i < kDecStages - 1; ++i) {
    if (i < n_tiles) fetch(i);
    cp_async_commit();
  }
  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<kDecStages - 2>();
    __syncthreads();  // tile `it` is in; every thread is done with tile it - 1
    if (it + kDecStages - 1 < n_tiles) fetch(it + kDecStages - 1);
    cp_async_commit();

    const unsigned char* st = ring + (it % kDecStages) * kStageBytes;
    const float* sc = scale_s + (it % kDecStages) * kDecTile * 2;
    const int base = c0 + it * kDecTile;
    constexpr int kPer = kDecTile / kGroups;  // positions per lane group per tile
    float s_[kPer][kG];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int p = grp + i * kGroups;
      float kf[8];
      load8(reinterpret_cast<const KV*>(st + p * kRowBytes) + sub * 8, kf);
      const float ksc = kQuant ? sc[p * 2] : 1.f;
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        float d = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) d = fmaf(qf[g][j], kf[j], d);
#pragma unroll
        for (int o = kLanes / 2; o > 0; o >>= 1) d += __shfl_xor_sync(kFull, d, o);
        s_[i][g] = base + p < c1 ? d * ksc : -INFINITY;
      }
    }
    // Online softmax per head over this lane group's positions of the tile.
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
      const int p = grp + i * kGroups;
      float vf[8];
      load8(reinterpret_cast<const KV*>(st + p * kRowBytes) + kD + sub * 8, vf);
      const float vsc = kQuant ? sc[p * 2 + 1] : 1.f;
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        const float w = s_[i][g] * vsc;
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[g][j] = fmaf(w, vf[j], acc[g][j]);
      }
    }
  }

  // Merge the lane groups' states through shared memory (the ring is free
  // once every copy has landed and every thread is past its last tile).
  cp_async_wait<0>();
  __syncthreads();
  float* red_o = reinterpret_cast<float*>(ring);        // [kGroups][kG][kD]
  float* red_ml = red_o + kGroups * kG * kD;             // [kGroups][kG][2]
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    float4* dst = reinterpret_cast<float4*>(red_o + (grp * kG + g) * kD + sub * 8);
    dst[0] = make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
    dst[1] = make_float4(acc[g][4], acc[g][5], acc[g][6], acc[g][7]);
    if (sub == 0) {
      red_ml[(grp * kG + g) * 2] = m[g];
      red_ml[(grp * kG + g) * 2 + 1] = l[g];
    }
  }
  __syncthreads();
  // Thread tid merges dim tid % kD of heads tid / kD, + kHeads, ... (at
  // kD = 128, dim tid of every head: folded to constants, the instance's
  // registers stay those it had before the head dim was a parameter).
  constexpr int kHeads = kThreads / kD;  // heads merged at once
  const int dim = kHeads == 1 ? tid : tid % kD;
  for (int g = kHeads == 1 ? 0 : tid / kD; g < group; g += kHeads) {
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kGroups; ++w) mx = fmaxf(mx, red_ml[(w * kG + g) * 2]);
    float sum = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kGroups; ++w) {
      const float e = exp2f(red_ml[(w * kG + g) * 2] - mx);
      sum += e * red_ml[(w * kG + g) * 2 + 1];
      o += e * red_o[(w * kG + g) * kD + dim];
    }
    if (n_splits == 1) {
      out_row[g * kD + dim] = __float2bfloat16(o / sum);
    } else {
      const size_t at = (((size_t)t * n_kv + h) * n_splits + split) * group + g;
      part_o[at * kD + dim] = o;
      if (dim == 0) {
        part_ml[at * 2] = mx;
        part_ml[at * 2 + 1] = sum;
      }
    }
  }
}

// Merges a row's split partials by log-sum-exp into the bf16 output; rows
// past cu[num_seqs] and rows with no visible position are written as zeros.
// Thread tid takes dim tid % kD of heads tid / kD, + kHeads, ...
template <int kD>
__global__ void __launch_bounds__(kThreads)
ragged_paged_attention_combine_kernel(
    const float* __restrict__ part_o,
    const float* __restrict__ part_ml,
    const int* __restrict__ kv_lens,
    const int* __restrict__ cu_q_lens,
    const int* __restrict__ num_seqs,
    __nv_bfloat16* __restrict__ out,
    int n_q, int n_kv, int max_seqs, int n_splits, int split_len) {
  const int t = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int group = n_q / n_kv;
  const int ns = min(num_seqs[0], max_seqs);
  int row_vis = 0;
  if (t < cu_q_lens[ns]) {
    const int s = find_seq(cu_q_lens, ns, t);
    const int kv_len = kv_lens[s];
    const int row_abs = kv_len - (cu_q_lens[s + 1] - cu_q_lens[s]) + (t - cu_q_lens[s]);
    row_vis = min(row_abs + 1, kv_len);
  }
  // Splits that hold at least one visible position; the others never ran.
  const int n_used = row_vis <= 0 ? 0 : min(n_splits, (row_vis + split_len - 1) / split_len);
  __nv_bfloat16* out_row = out + ((size_t)t * n_q + (size_t)h * group) * kD;
  const size_t at0 = ((size_t)t * n_kv + h) * n_splits * group;
  constexpr int kHeads = kThreads / kD;  // heads merged at once
  const int dim = kHeads == 1 ? tid : tid % kD;
  for (int g = kHeads == 1 ? 0 : tid / kD; g < group; g += kHeads) {
    float mx = -INFINITY;
    for (int i = 0; i < n_used; ++i) mx = fmaxf(mx, part_ml[(at0 + i * group + g) * 2]);
    float sum = 0.f, o = 0.f;
    for (int i = 0; i < n_used; ++i) {
      const size_t at = at0 + i * group + g;
      const float e = exp2f(part_ml[at * 2] - mx);
      sum += e * part_ml[at * 2 + 1];
      o += e * part_o[at * kD + dim];
    }
    out_row[g * kD + dim] = __float2bfloat16(n_used > 0 ? o / sum : 0.f);
  }
}

// -- 2. query-tiled tensor-core kernel ---------------------------------------------

template <typename KV, int kD>
__global__ void __launch_bounds__(kTiledThreads)
ragged_paged_attention_tiled_kernel(
    const __nv_bfloat16* __restrict__ q,
    const KV* __restrict__ kv,
    const float* __restrict__ kv_scales,
    const int* __restrict__ kv_lens,
    const int* __restrict__ page_indices,
    const int* __restrict__ cu_q_lens,
    const int* __restrict__ num_seqs,
    __nv_bfloat16* __restrict__ out,
    int num_tokens, int n_q, int n_kv, int page_size, int pages_per_seq, int max_seqs,
    int rows_per_tile, float scale_log2) {
  static_assert(kD == 64 || kD == 128, "head_dim 64 or 128");
  constexpr bool kQuant = sizeof(KV) == 1;
  constexpr int kChunks = kD / 8;          // 16-byte chunks of one bf16 row (16 or 8)
  constexpr int kRawChunks = 2 * kD / 16;  // 16-byte chunks of one position's int8 K and V
  constexpr int kTileElems = kTileN * kD;
  extern __shared__ __align__(16) unsigned char tiled_smem[];
  // bf16: q_s | k_s[2] | v_s[2].  int8: q_s | k_s | v_s | raw[2] | scales[2].
  __nv_bfloat16* const q_s = reinterpret_cast<__nv_bfloat16*>(tiled_smem);
  __nv_bfloat16* const kv_s = q_s + kTileM * kD;
  int8_t* const raw_s = reinterpret_cast<int8_t*>(kv_s + 2 * kTileElems);
  float* const sc_s = reinterpret_cast<float*>(raw_s + 2 * kTileN * 2 * kD);
  __shared__ int info_s[3];

  const int h = blockIdx.y, j = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int group = n_q / n_kv;
  const int bm = rows_per_tile;
  const int ns = min(num_seqs[0], max_seqs);

  // Block j's (sequence, tile): tiles are numbered sequence after sequence,
  // ceil(q_len / bm) each; one warp scans 32 sequences at a time.
  if (warp == 0) {
    int base = 0, found_s = -1, found_tile = 0;
    for (int s0 = 0; s0 < ns; s0 += 32) {
      const int s = s0 + lane;
      const int nt = s < ns ? (cu_q_lens[s + 1] - cu_q_lens[s] + bm - 1) / bm : 0;
      int inc = nt;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(kFull, inc, o);
        if (lane >= o) inc += v;
      }
      const int start = base + inc - nt;
      const unsigned hit = __ballot_sync(kFull, nt > 0 && j >= start && j < start + nt);
      if (hit) {
        const int src = __ffs(hit) - 1;
        found_s = __shfl_sync(kFull, s, src);
        found_tile = __shfl_sync(kFull, j - start, src);
        break;
      }
      base += __shfl_sync(kFull, inc, 31);
    }
    if (lane == 0) {
      info_s[0] = found_s;
      info_s[1] = found_tile;
      info_s[2] = base;  // the real tiles' count when nothing was found
    }
  }
  __syncthreads();
  const int s = info_s[0];
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);

  if (s < 0) {  // past the real tiles: zero this block's share of the padded rows
    const int r0 = cu_q_lens[ns] + (j - info_s[2]) * bm;
    const int r1 = min(r0 + bm, num_tokens);
    const int per_row = group * kD / 8;  // 16-byte stores per row
    for (int i = tid; i < (r1 - r0) * per_row; i += kTiledThreads) {
      const int r = r0 + i / per_row;
      reinterpret_cast<uint4*>(out + ((size_t)r * n_q + (size_t)h * group) * kD)[i % per_row] = zero4;
    }
    return;
  }

  const int q_len = cu_q_lens[s + 1] - cu_q_lens[s];
  const int row0 = cu_q_lens[s] + info_s[1] * bm;
  const int n_rows = min(bm, q_len - info_s[1] * bm);
  const int kv_len = kv_lens[s];
  const int abs0 = kv_len - q_len + info_s[1] * bm;  // the tile's first row
  // Row r of the tile sees cache positions p < min(abs0 + r + 1, kv_len).
  const int vis_first = min(abs0 + 1, kv_len);
  const int vis_last = min(abs0 + n_rows, kv_len);
  const int n_kv_tiles = vis_last > 0 ? (vis_last + kTileN - 1) / kTileN : 0;

  // This thread's two M rows (mma rows lane/4 and lane/4 + 8 of its warp).
  int mrow[2], vis_row[2];
  bool keep[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mrow[i] = 16 * warp + (lane >> 2) + 8 * i;
    const int r = mrow[i] / group;
    keep[i] = mrow[i] < bm * group && r < n_rows;
    vis_row[i] = min(abs0 + r + 1, kv_len);
  }

  if (n_kv_tiles == 0) {  // no row of the tile sees anything: zeros
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (!keep[i]) continue;
      const int r = mrow[i] / group, hh = mrow[i] - r * group;
      __nv_bfloat16* o = out + ((size_t)(row0 + r) * n_q + (size_t)h * group + hh) * kD;
      for (int nt = 0; nt < kD / 8; ++nt)
        *reinterpret_cast<uint32_t*>(o + nt * 8 + 2 * (lane & 3)) = 0u;
    }
    return;
  }

  const int* table = page_indices + (size_t)s * pages_per_seq;
  const size_t slot_stride = (size_t)2 * n_kv * kD;

  // Q tile: M row m = r * group + hh is q[row0 + r, h * group + hh, :];
  // M rows past the tile's rows are zero-filled.
  for (int c = tid; c < kTileM * kChunks; c += kTiledThreads) {
    const int m = c / kChunks, part = c % kChunks;
    const int r = m / group;
    const bool ok = m < bm * group && r < n_rows;
    const __nv_bfloat16* src =
        ok ? q + ((size_t)(row0 + r) * n_q + (size_t)h * group + (m - r * group)) * kD + part * 8 : q;
    cp_async16(q_s + swz<kChunks>(m, part) * 8, src, ok);
  }
  // K/V tile kt: positions kt*kTileN .. +kTileN-1, those past vis_last zero-filled.
  auto fetch = [&](int kt) {
    const int b = kt & 1;
    const int base = kt * kTileN;
    if constexpr (!kQuant) {
      __nv_bfloat16* k_dst = kv_s + b * kTileElems;
      __nv_bfloat16* v_dst = kv_s + (2 + b) * kTileElems;
      for (int c = tid; c < kTileN * 2 * kChunks; c += kTiledThreads) {
        const int p = c / (2 * kChunks), part = c % (2 * kChunks);
        const bool ok = base + p < vis_last;
        const KV* src = ok ? kv + slot_of(table, base + p, page_size) * slot_stride + (size_t)(2 * h) * kD
                           : kv;
        __nv_bfloat16* dst = part < kChunks ? k_dst : v_dst;
        cp_async16(dst + swz<kChunks>(p, part % kChunks) * 8, src + part * 8, ok);
      }
    } else {
      int8_t* dst = raw_s + b * kTileN * 2 * kD;  // [kTileN][K kD | V kD] int8
      for (int c = tid; c < kTileN * kRawChunks; c += kTiledThreads) {
        const int p = c / kRawChunks, part = c % kRawChunks;
        const bool ok = base + p < vis_last;
        const KV* src = ok ? kv + slot_of(table, base + p, page_size) * slot_stride + (size_t)(2 * h) * kD
                           : kv;
        cp_async16(dst + p * 2 * kD + part * 16, src + part * 16, ok);
      }
      if (tid < kTileN) {
        const bool ok = base + tid < vis_last;
        const float* src = ok ? kv_scales + slot_of(table, base + tid, page_size) * 2 * n_kv + 2 * h
                              : kv_scales;
        cp_async8(sc_s + (b * kTileN + tid) * 2, src, ok);
      }
    }
  };

  fetch(0);
  cp_async_commit();

  uint32_t qa[kD / 16][4];  // Q fragments for the kD / 16 k-steps over dims
  float o_acc[kD / 8][4];   // O: kD / 8 n-tiles of 8 dims
#pragma unroll
  for (int nt = 0; nt < kD / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o_acc[nt][e] = 0.f;
  float row_m[2] = {-INFINITY, -INFINITY}, row_l[2] = {0.f, 0.f};

  for (int kt = 0; kt < n_kv_tiles; ++kt) {
    cp_async_wait<0>();
    __syncthreads();  // tile kt is in; every thread is done with tile kt - 1
    const int b = kt & 1;
    const __nv_bfloat16* k_t;
    const __nv_bfloat16* v_t;
    const float* tsc = sc_s + b * kTileN * 2;
    if constexpr (kQuant) {
      // int8 -> bf16 (exact) into the single K/V tile; scales stay in f32.
      k_t = kv_s;
      v_t = kv_s + kTileElems;
      const int8_t* src = raw_s + b * kTileN * 2 * kD;
      for (int c = tid; c < kTileN * kRawChunks; c += kTiledThreads) {
        const int p = c / kRawChunks, part = c % kRawChunks;
        const uint4 raw = *reinterpret_cast<const uint4*>(src + p * 2 * kD + part * 16);
        const int8_t* x = reinterpret_cast<const int8_t*>(&raw);
        uint4 lo, hi;
        lo.x = pack_bf16(x[0], x[1]);   lo.y = pack_bf16(x[2], x[3]);
        lo.z = pack_bf16(x[4], x[5]);   lo.w = pack_bf16(x[6], x[7]);
        hi.x = pack_bf16(x[8], x[9]);   hi.y = pack_bf16(x[10], x[11]);
        hi.z = pack_bf16(x[12], x[13]); hi.w = pack_bf16(x[14], x[15]);
        __nv_bfloat16* dst = const_cast<__nv_bfloat16*>(part < kRawChunks / 2 ? k_t : v_t);
        const int c2 = 2 * (part % (kRawChunks / 2));
        *reinterpret_cast<uint4*>(dst + swz<kChunks>(p, c2) * 8) = lo;
        *reinterpret_cast<uint4*>(dst + swz<kChunks>(p, c2 + 1) * 8) = hi;
      }
      __syncthreads();
    } else {
      k_t = kv_s + b * kTileElems;
      v_t = kv_s + (2 + b) * kTileElems;
    }
    if (kt + 1 < n_kv_tiles) fetch(kt + 1);  // overlaps this tile's products
    cp_async_commit();

    if (kt == 0) {
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
        ldmatrix_x4(qa[kk], q_s + swz<kChunks>(16 * warp + (lane & 7) + ((lane >> 3) & 1) * 8,
                                               2 * kk + (lane >> 4)) * 8);
    }

    // S = Q K^T: 16 M rows x 64 positions per warp.
    float s_acc[kTileN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kTileN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s_acc[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < kTileN / 16; ++np) {
        uint32_t bk[4];
        ldmatrix_x4(bk, k_t + swz<kChunks>(16 * np + (lane & 7) + ((lane >> 4) << 3),
                                           2 * kk + ((lane >> 3) & 1)) * 8);
        mma_bf16(s_acc[2 * np], qa[kk], bk[0], bk[1]);
        mma_bf16(s_acc[2 * np + 1], qa[kk], bk[2], bk[3]);
      }
    }

    // Scale (and the int8 K scales), mask where the tile needs it.
    const bool need_mask = (kt + 1) * kTileN > vis_first;
#pragma unroll
    for (int nt = 0; nt < kTileN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * (lane & 3) + (e & 1);
        float x = s_acc[nt][e] * scale_log2;
        if constexpr (kQuant) x *= tsc[col * 2];
        if (need_mask && kt * kTileN + col >= vis_row[e >> 1]) x = -INFINITY;
        s_acc[nt][e] = x;
      }
    }

    // Online softmax: each row's max over the quad that holds it.
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < kTileN / 8; ++nt) mx = fmaxf(mx, fmaxf(s_acc[nt][2 * i], s_acc[nt][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      const float m_new = fmaxf(row_m[i], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      alpha[i] = exp2f(row_m[i] - m_use);
      row_m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < kTileN / 8; ++nt) {
        s_acc[nt][2 * i] = exp2f(s_acc[nt][2 * i] - m_use);
        s_acc[nt][2 * i + 1] = exp2f(s_acc[nt][2 * i + 1] - m_use);
        sum += s_acc[nt][2 * i] + s_acc[nt][2 * i + 1];
      }
      row_l[i] = row_l[i] * alpha[i] + sum;  // this thread's share; summed at the end
    }
#pragma unroll
    for (int nt = 0; nt < kD / 8; ++nt) {
      o_acc[nt][0] *= alpha[0];
      o_acc[nt][1] *= alpha[0];
      o_acc[nt][2] *= alpha[1];
      o_acc[nt][3] *= alpha[1];
    }

    // O += P V: P from the score registers, rounded to bf16 (int8: the V
    // scale of each position folded into its column first).
#pragma unroll
    for (int kk = 0; kk < kTileN / 16; ++kk) {
      float pv[2][4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s_acc[2 * kk + half][e];
          if constexpr (kQuant) x *= tsc[((2 * kk + half) * 8 + 2 * (lane & 3) + (e & 1)) * 2 + 1];
          pv[half][e] = x;
        }
      }
      const uint32_t pa[4] = {pack_bf16(pv[0][0], pv[0][1]), pack_bf16(pv[0][2], pv[0][3]),
                              pack_bf16(pv[1][0], pv[1][1]), pack_bf16(pv[1][2], pv[1][3])};
#pragma unroll
      for (int dp = 0; dp < kD / 16; ++dp) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, v_t + swz<kChunks>(16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8,
                                                 2 * dp + (lane >> 4)) * 8);
        mma_bf16(o_acc[2 * dp], pa, bv[0], bv[1]);
        mma_bf16(o_acc[2 * dp + 1], pa, bv[2], bv[3]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float sum = row_l[i];
    sum += __shfl_xor_sync(kFull, sum, 1);
    sum += __shfl_xor_sync(kFull, sum, 2);
    if (!keep[i]) continue;
    const float inv = sum > 0.f ? 1.f / sum : 0.f;  // no visible position: zeros
    const int r = mrow[i] / group, hh = mrow[i] - r * group;
    __nv_bfloat16* o = out + ((size_t)(row0 + r) * n_q + (size_t)h * group + hh) * kD;
#pragma unroll
    for (int nt = 0; nt < kD / 8; ++nt)
      *reinterpret_cast<uint32_t*>(o + nt * 8 + 2 * (lane & 3)) =
          pack_bf16(o_acc[nt][2 * i] * inv, o_acc[nt][2 * i + 1] * inv);
  }
}

// -- host side ---------------------------------------------------------------------

// Opts a kernel into `bytes` of dynamic shared memory, once per instance
// (`done` is that instance's own flag).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  done = err == cudaSuccess;
  return err;
}

bool geometry_ok(int n_q, int n_kv, int max_seqs) {
  return n_kv > 0 && n_q % n_kv == 0 && n_q / n_kv <= kMaxGroup && max_seqs > 0;
}

template <typename KV, int kG, int kD>
int launch_decode_g(const void* q, const void* kv, const void* kv_scales, const void* kv_lens,
                    const void* page_indices, const void* cu_q_lens, const void* num_seqs,
                    void* out, void* part_o, void* part_ml, int num_tokens, int n_q, int n_kv,
                    int page_size, int pages_per_seq, int max_seqs, int n_splits,
                    int pages_per_split, float sm_scale, cudaStream_t stream) {
  constexpr int kStage = kDecTile * 2 * kD * (int)sizeof(KV);
  constexpr int kRing = kDecStages * kStage + (sizeof(KV) == 1 ? kDecStages * kDecTile * 8 : 0);
  constexpr int kMerge = kThreads / (kD / 8) * kG * (kD + 2) * 4;  // [lane groups][kG][kD + 2]
  constexpr int kSmem = kRing > kMerge ? kRing : kMerge;
  auto kernel = ragged_paged_attention_decode_kernel<KV, kG, kD>;
  static bool smem_set = false;
  const cudaError_t err = allow_smem(kernel, kSmem, smem_set);
  if (err != cudaSuccess) return (int)err;
  const int split_len = pages_per_split * page_size;
  kernel<<<dim3(num_tokens, n_kv, n_splits), kThreads, kSmem, stream>>>(
      (const __nv_bfloat16*)q, (const KV*)kv, (const float*)kv_scales, (const int*)kv_lens,
      (const int*)page_indices, (const int*)cu_q_lens, (const int*)num_seqs,
      (__nv_bfloat16*)out, (float*)part_o, (float*)part_ml, n_q, n_kv, page_size,
      pages_per_seq, max_seqs, n_splits, split_len, sm_scale * kLog2e);
  if (n_splits > 1) {
    ragged_paged_attention_combine_kernel<kD><<<dim3(num_tokens, n_kv), kThreads, 0, stream>>>(
        (const float*)part_o, (const float*)part_ml, (const int*)kv_lens,
        (const int*)cu_q_lens, (const int*)num_seqs, (__nv_bfloat16*)out, n_q, n_kv,
        max_seqs, n_splits, split_len);
  }
  return (int)cudaGetLastError();
}

template <typename KV, int kD>
int launch_decode(const void* q, const void* kv, const void* kv_scales, const void* kv_lens,
                  const void* page_indices, const void* cu_q_lens, const void* num_seqs,
                  void* out, void* part_o, void* part_ml, int num_tokens, int n_q, int n_kv,
                  int page_size, int pages_per_seq, int max_seqs, int n_splits,
                  int pages_per_split, float sm_scale, void* stream) {
  if (!geometry_ok(n_q, n_kv, max_seqs) || n_splits < 1 || pages_per_split < 1 ||
      (long long)n_splits * pages_per_split < pages_per_seq ||
      (n_splits > 1 && (part_o == nullptr || part_ml == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (num_tokens <= 0) return 0;
  const int group = n_q / n_kv;
  auto run = [&](auto fn) {
    return fn(q, kv, kv_scales, kv_lens, page_indices, cu_q_lens, num_seqs, out, part_o,
              part_ml, num_tokens, n_q, n_kv, page_size, pages_per_seq, max_seqs, n_splits,
              pages_per_split, sm_scale, (cudaStream_t)stream);
  };
  if (group <= 1) return run(launch_decode_g<KV, 1, kD>);
  if (group <= 2) return run(launch_decode_g<KV, 2, kD>);
  if (group <= 4) return run(launch_decode_g<KV, 4, kD>);
  return run(launch_decode_g<KV, 8, kD>);
}

template <typename KV, int kD>
int launch_tiled(const void* q, const void* kv, const void* kv_scales, const void* kv_lens,
                 const void* page_indices, const void* cu_q_lens, const void* num_seqs,
                 void* out, int num_tokens, int n_q, int n_kv, int page_size,
                 int pages_per_seq, int max_seqs, int n_blocks, int rows_per_tile,
                 float sm_scale, void* stream) {
  if (!geometry_ok(n_q, n_kv, max_seqs) || rows_per_tile < 1 ||
      rows_per_tile * (n_q / n_kv) > kTileM || n_blocks < 1)
    return (int)cudaErrorInvalidValue;
  if (num_tokens <= 0) return 0;
  constexpr int kQ = kTileM * kD * 2;
  constexpr int kTile = kTileN * kD * 2;
  constexpr int kSmem = sizeof(KV) == 1
      ? kQ + 2 * kTile + 2 * kTileN * 2 * kD + 2 * kTileN * 8
      : kQ + 4 * kTile;
  auto kernel = ragged_paged_attention_tiled_kernel<KV, kD>;
  static bool smem_set = false;
  const cudaError_t err = allow_smem(kernel, kSmem, smem_set);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(n_blocks, n_kv), kTiledThreads, kSmem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const KV*)kv, (const float*)kv_scales, (const int*)kv_lens,
      (const int*)page_indices, (const int*)cu_q_lens, (const int*)num_seqs,
      (__nv_bfloat16*)out, num_tokens, n_q, n_kv, page_size, pages_per_seq, max_seqs,
      rows_per_tile, sm_scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (loaded with ctypes), two per page type and head
// dim: the head_dim-128 instances under the names they had before head_dim
// 64 was built, the head_dim-64 ones with `_hd64` before `_launch`. Each
// launches on `stream` and returns cudaGetLastError(): nonzero when a
// launch was refused. The plans (n_splits and pages_per_split; n_blocks
// and rows_per_tile) come from ops/ragged_attention.py, which also
// allocates the decode scratch.
#define K1_BF16_ENTRY_POINTS(SUFFIX, D)                                                         \
  extern "C" int ragged_paged_attention_decode##SUFFIX##_launch(                                \
      const void* q, const void* kv_pages, const void* kv_lens, const void* page_indices,       \
      const void* cu_q_lens, const void* num_seqs, void* out, void* part_o, void* part_ml,      \
      int num_tokens, int n_q, int n_kv, int page_size, int pages_per_seq, int max_seqs,        \
      int n_splits, int pages_per_split, float sm_scale, void* stream) {                        \
    return launch_decode<__nv_bfloat16, D>(q, kv_pages, nullptr, kv_lens, page_indices,         \
                                           cu_q_lens, num_seqs, out, part_o, part_ml,           \
                                           num_tokens, n_q, n_kv, page_size, pages_per_seq,     \
                                           max_seqs, n_splits, pages_per_split, sm_scale,       \
                                           stream);                                             \
  }                                                                                             \
  extern "C" int ragged_paged_attention_tiled##SUFFIX##_launch(                                 \
      const void* q, const void* kv_pages, const void* kv_lens, const void* page_indices,       \
      const void* cu_q_lens, const void* num_seqs, void* out, int num_tokens, int n_q,          \
      int n_kv, int page_size, int pages_per_seq, int max_seqs, int n_blocks,                   \
      int rows_per_tile, float sm_scale, void* stream) {                                        \
    return launch_tiled<__nv_bfloat16, D>(q, kv_pages, nullptr, kv_lens, page_indices,          \
                                          cu_q_lens, num_seqs, out, num_tokens, n_q, n_kv,      \
                                          page_size, pages_per_seq, max_seqs, n_blocks,         \
                                          rows_per_tile, sm_scale, stream);                     \
  }

#define K1_INT8_ENTRY_POINTS(SUFFIX, D)                                                         \
  extern "C" int ragged_paged_attention_int8_decode##SUFFIX##_launch(                           \
      const void* q, const void* kv_pages, const void* kv_scales, const void* kv_lens,          \
      const void* page_indices, const void* cu_q_lens, const void* num_seqs, void* out,         \
      void* part_o, void* part_ml, int num_tokens, int n_q, int n_kv, int page_size,            \
      int pages_per_seq, int max_seqs, int n_splits, int pages_per_split, float sm_scale,       \
      void* stream) {                                                                           \
    return launch_decode<int8_t, D>(q, kv_pages, kv_scales, kv_lens, page_indices, cu_q_lens,   \
                                    num_seqs, out, part_o, part_ml, num_tokens, n_q, n_kv,      \
                                    page_size, pages_per_seq, max_seqs, n_splits,               \
                                    pages_per_split, sm_scale, stream);                         \
  }                                                                                             \
  extern "C" int ragged_paged_attention_int8_tiled##SUFFIX##_launch(                            \
      const void* q, const void* kv_pages, const void* kv_scales, const void* kv_lens,          \
      const void* page_indices, const void* cu_q_lens, const void* num_seqs, void* out,         \
      int num_tokens, int n_q, int n_kv, int page_size, int pages_per_seq, int max_seqs,        \
      int n_blocks, int rows_per_tile, float sm_scale, void* stream) {                          \
    return launch_tiled<int8_t, D>(q, kv_pages, kv_scales, kv_lens, page_indices, cu_q_lens,    \
                                   num_seqs, out, num_tokens, n_q, n_kv, page_size,             \
                                   pages_per_seq, max_seqs, n_blocks, rows_per_tile, sm_scale,  \
                                   stream);                                                     \
  }

K1_BF16_ENTRY_POINTS(, 128)
K1_INT8_ENTRY_POINTS(, 128)
K1_BF16_ENTRY_POINTS(_hd64, 64)
K1_INT8_ENTRY_POINTS(_hd64, 64)
