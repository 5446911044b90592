// Ragged paged attention for Hopper (sm_90a): K1's generic instance.
//
// Replaces, for the models K1's fast instances (ragged_paged_attention.cu:
// bf16 q, head_dim 64 or 128, a GQA group up to 8) do not take, the TPU
// kernel the JAX package calls at dynamo_tpu/ops/ragged_attention.py:163-188
// and, for the shapes that kernel does not take (head_dim not a multiple of
// 128), the XLA reference it runs instead (:60; its docstring, :123-126).
// It computes exactly the function of the plain reference,
// ragged_paged_attention_ref (ops/ragged_attention.py):
//
//   q            [T, n_q, D]                     f32, fp16 or bf16 (QT)
//   kv_pages     [n_pages, page_size, 2*n_kv, D] QT, K at even and V at odd
//                combined heads (read in place); or int8 with
//   kv_scales    [n_pages, page_size, 2*n_kv]    f32 (the *_int8 entry points)
//   kv_lens      [S] i32   tokens of sequence s in cache (incl. this step)
//   page_indices [S, pages_per_seq] i32
//   cu_q_lens    [S+1] i32 sequence s owns q rows cu[s] .. cu[s+1]-1
//   num_seqs     [1] i32   valid sequences, read here from device memory
//   out          [T, n_q, D] QT
//
// D is a runtime value, any multiple of 8 up to kMaxHeadDim = 256 (Falcon3's
// 256, 96, the tiny presets' 16); the group n_q / n_kv is any whole number
// (Mistral-Large-2's 12, Llama-3.1-405B's 16 on a tp = 8 rank). Query row t
// of sequence s sits at abs = kv_lens[s] - q_len_s + (t - cu[s]) and attends
// cache positions p <= abs and p < kv_lens[s]. Rows at or past cu[num_seqs]
// and rows with no visible position are written as zeros.
//
// Arithmetic: everything on the CUDA cores in f32 FMA. Each K/V row is read
// into shared memory as f32 (int8: times its scale, the reference's
// dequantization, value for value); scores, an online softmax in base 2
// (scores carry log2(e)) and PV in f32; P is never rounded, so the f32
// instance is the plain version up to the order of f32 sums. Only the output
// is rounded to QT. No tensor core is used, so no launch can beat its bytes
// over 3.35 TB/s or its operations over the 67 TFLOP/s of f32 FMA (fp16 and
// bf16 launches are still held to the tensor cores' 989 TFLOP/s). An
// f32 engine's matrix products around this kernel run in full f32 as well:
// PyTorch's default (torch.backends.cuda.matmul.allow_tf32 = False) stays,
// and no module of the port turns TF32 on (tests/test_torch_k1_generic.py).
//
// The head dim is a runtime value with a compile-time maximum of 256: one
// instance per operand type and form, the tiled kernel's register tile in
// two sizes (D <= 128, D <= 256), 21 kernels in 18 s of nvcc on the card's
// machine; a template over a set of head dims would build one set per value.
//
// Two kernels, the forms the engine's forwards state (kernel="decode" or
// "tiled"), each right on every ragged layout:
//
// 1. Split-KV decode (generic_decode_kernel + generic_combine_kernel): grid
//    (T rows, n_kv x head chunks, n_splits), the splits planned by
//    decode_split_plan as for the fast instance; a block takes one query row,
//    up to kDecHeads heads of one KV head's group (a group above 16 takes
//    more blocks along y) and one split of whole pages. It walks the split in
//    tiles of kTileN positions staged in shared memory: lane p of each warp
//    scores position p for the warp's heads (every K row read once for the
//    block's heads), each warp keeps its heads' online softmax, and every
//    thread then adds P x V into its share of the block's o[heads][D]. With
//    more than one split the partials (m, l, o) go to f32 scratch and the
//    combine kernel merges a row's splits by log-sum-exp.
// 2. Query-tiled (generic_tiled_kernel): grid (row tiles, n_kv) from
//    tiled_plan with a tile of generic_tile_m(D) M rows (query row x group
//    head: 128 up to D = 128, 64 above). A block finds its (sequence, tile)
//    with a warp scan of cu_q_lens, stages its Q rows in shared memory as f32
//    and walks the K/V tiles up to its last row's visible position; each of
//    its 256 threads holds a register tile of kRows M rows x 4 positions of S
//    and kRows M rows x D / 8 dims of O, so every K/V tile it loads serves all
//    of the block's rows. A group whose heads outnumber the tile (above 128,
//    or 64 at D > 128) takes several passes over the K/V walk.
//
// What bounds it on this card: decode rows read every visible K/V row once
// (bytes, 4 D bytes a position in bf16); prefill tiles do 4 D operations a
// position per M row on the f32 FMA units (operations). The design keeps
// each K/V row to one read per block and the scores in registers; it does no
// pipelining of the tile loads and uses no tensor core (later work).
//
// Shared memory (f32): decode kDecHeads x D (q) + kTileN x (D + 1) (K) +
// kTileN x D (V) + kDecHeads x (kTileN + 1) (P): 84 KB at D = 256; tiled
// kM x (D + 1) (q) + the same K and V + kM x (kTileN + 1) (P): 116 KB at
// D = 128, 140 KB at 256. The K and q rows have an odd stride, so the eight
// or thirty-two rows a warp reads at once fall in distinct banks.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxHeadDim = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kTileN = 32;          // K/V positions per tile (both kernels)

constexpr int kDecThreads = 128;    // 4 warps
constexpr int kDecHeads = 16;       // group heads per decode block (4 per warp)
constexpr int kDecAcc = kDecHeads * kMaxHeadDim / kDecThreads;  // o elements per thread

constexpr int kTiledThreads = 256;  // 32 row groups x 8 column groups

// -- small helpers -------------------------------------------------------------

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __half from_f<__half>(float x) { return __float2half_rn(x); }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Eight consecutive elements as floats (32 B of f32, 16 B of fp16/bf16, 8 B
// of int8; each at a multiple of 8 elements from a 16-byte aligned base).
__device__ __forceinline__ void load8(const float* p, float f[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

__device__ __forceinline__ void load8(const __half* p, float f[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __half2* h = reinterpret_cast<const __half2*>(&raw);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 v = __half22float2(h[k]);
    f[2 * k] = v.x;
    f[2 * k + 1] = v.y;
  }
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

// The sequence that owns query row t < cu[ns] (binary search; sequences with
// q_len 0 own no row).
__device__ __forceinline__ int find_seq(const int* __restrict__ cu, int ns, int t) {
  int lo = 0, hi = ns - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (cu[mid + 1] > t) hi = mid; else lo = mid + 1;
  }
  return lo;
}

// Cache positions visible to the query row `i` rows into a sequence of
// q_len rows with kv_len tokens in cache: those p <= its own position.
__device__ __forceinline__ int visible(int kv_len, int q_len, int i) {
  return min(kv_len - q_len + i + 1, kv_len);
}

// Cache slot of position pos of a sequence whose block table is `table`.
__device__ __forceinline__ size_t slot_of(const int* __restrict__ table, int pos, int page_size) {
  const int pg = pos / page_size;
  return (size_t)table[pg] * page_size + (pos - pg * page_size);
}

// K and V rows of kv head h for positions base .. base + kTileN - 1 into
// k_s ([kTileN][d + 1]) and v_s ([kTileN][d]) as f32, int8 rows times their
// scales; positions at or past `end` are zeros. `nthreads` threads take
// 8-element chunks, a position's K then V row (2 d contiguous elements).
template <typename KV>
__device__ __forceinline__ void load_kv_tile(
    const KV* __restrict__ kv, const float* __restrict__ kv_scales, const int* __restrict__ table,
    int base, int end, int h, int n_kv, int d, int page_size, float* k_s, float* v_s,
    int tid, int nthreads) {
  constexpr bool kQuant = sizeof(KV) == 1;
  const int chunks = d / 8;
  const size_t slot_stride = (size_t)2 * n_kv * d;
  for (int i = tid; i < kTileN * 2 * chunks; i += nthreads) {
    const int p = i / (2 * chunks), part = i - p * 2 * chunks;
    const int is_v = part >= chunks;  // 0: K, 1: V
    const int c = part - is_v * chunks;
    float f[8];
    if (base + p < end) {
      const size_t slot = slot_of(table, base + p, page_size);
      load8(kv + slot * slot_stride + (size_t)(2 * h + is_v) * d + c * 8, f);
      if (kQuant) {
        const float sc = kv_scales[slot * 2 * n_kv + 2 * h + is_v];
#pragma unroll
        for (int j = 0; j < 8; ++j) f[j] *= sc;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) f[j] = 0.f;
    }
    float* dst = is_v ? v_s + p * d + c * 8 : k_s + p * (d + 1) + c * 8;
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[j] = f[j];
  }
}

// -- 1. split-KV decode ----------------------------------------------------------

template <typename QT, typename KV>
__global__ void __launch_bounds__(kDecThreads)
generic_decode_kernel(
    const QT* __restrict__ q, const KV* __restrict__ kv, const float* __restrict__ kv_scales,
    const int* __restrict__ kv_lens, const int* __restrict__ page_indices,
    const int* __restrict__ cu_q_lens, const int* __restrict__ num_seqs, QT* __restrict__ out,
    float* __restrict__ part_o,   // [T, n_kv, n_splits, group, d], n_splits > 1
    float* __restrict__ part_ml,  // [T, n_kv, n_splits, group, 2]
    int n_q, int n_kv, int d, int page_size, int pages_per_seq, int max_seqs, int n_splits,
    int split_len, float scale_log2) {
  extern __shared__ __align__(16) float dec_smem[];
  float* const q_s = dec_smem;                         // [kDecHeads][d]
  float* const k_s = q_s + kDecHeads * d;              // [kTileN][d + 1]
  float* const v_s = k_s + kTileN * (d + 1);           // [kTileN][d]
  float* const p_s = v_s + kTileN * d;                 // [kDecHeads][kTileN + 1]
  __shared__ float alpha_s[kDecHeads];
  __shared__ float ml_s[kDecHeads][2];

  const int group = n_q / n_kv;
  const int n_chunks = (group + kDecHeads - 1) / kDecHeads;
  const int t = blockIdx.x, split = blockIdx.z;
  const int h = blockIdx.y / n_chunks, g0 = (blockIdx.y - h * n_chunks) * kDecHeads;
  const int gc = min(kDecHeads, group - g0);  // this block's heads
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nh = max(0, (gc - warp + 3) / 4);  // this warp's heads: warp, warp + 4, ...

  const int ns = min(num_seqs[0], max_seqs);
  int s = 0, vis = 0;
  if (t < cu_q_lens[ns]) {
    s = find_seq(cu_q_lens, ns, t);
    vis = visible(kv_lens[s], cu_q_lens[s + 1] - cu_q_lens[s], t - cu_q_lens[s]);
  }
  QT* out_row = out + ((size_t)t * n_q + (size_t)h * group + g0) * d;
  const int c0 = split * split_len;
  if (c0 >= vis) {  // nothing visible in this split (uniform over the block)
    if (n_splits == 1) {
      for (int i = tid; i < gc * d; i += kDecThreads) out_row[i] = from_f<QT>(0.f);
    }
    return;
  }
  const int c1 = min(c0 + split_len, vis);
  const int* table = page_indices + (size_t)s * pages_per_seq;

  const QT* q_rows = q + ((size_t)t * n_q + (size_t)h * group + g0) * d;
  for (int i = tid; i < gc * d; i += kDecThreads) q_s[i] = to_f(q_rows[i]) * scale_log2;

  float m[4], l[4], acc[kDecAcc];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
#pragma unroll
  for (int c = 0; c < kDecAcc; ++c) acc[c] = 0.f;

  for (int base = c0; base < c1; base += kTileN) {
    __syncthreads();  // q_s is in; every thread is done with the previous tile
    load_kv_tile(kv, kv_scales, table, base, c1, h, n_kv, d, page_size, k_s, v_s, tid,
                 kDecThreads);
    __syncthreads();

    // Scores: lane = position, this warp's heads.
    float dot[4] = {0.f, 0.f, 0.f, 0.f};
    const float* kp = k_s + lane * (d + 1);
#pragma unroll 4
    for (int j = 0; j < d; ++j) {
      const float kj = kp[j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (i < nh) dot[i] = fmaf(q_s[(warp + 4 * i) * d + j], kj, dot[i]);
    }
    const bool live = base + lane < c1;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i >= nh) break;  // uniform over the warp
      const int g = warp + 4 * i;
      const float x = live ? dot[i] : -INFINITY;
      float mx = x;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float e = exp2f(x - m_use);
      float sum = e;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(kFull, sum, o);
      const float alpha = exp2f(m[i] - m_use);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
      p_s[g * (kTileN + 1) + lane] = e;
      if (lane == 0) alpha_s[g] = alpha;
    }
    __syncthreads();

    // O += P V: element idx = tid + kDecThreads * c of o[gc][d].
#pragma unroll
    for (int c = 0; c < kDecAcc; ++c) {
      const int idx = tid + kDecThreads * c;
      if (idx < gc * d) {
        const int g = idx / d, j = idx - g * d;
        const float* pg = p_s + g * (kTileN + 1);
        float o = acc[c] * alpha_s[g];
#pragma unroll 8
        for (int p = 0; p < kTileN; ++p) o = fmaf(pg[p], v_s[p * d + j], o);
        acc[c] = o;
      }
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i < nh) {
        ml_s[warp + 4 * i][0] = m[i];
        ml_s[warp + 4 * i][1] = l[i];
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < kDecAcc; ++c) {
    const int idx = tid + kDecThreads * c;
    if (idx < gc * d) {
      const int g = idx / d, j = idx - g * d;
      if (n_splits == 1) {
        const float lg = ml_s[g][1];
        out_row[idx] = from_f<QT>(lg > 0.f ? acc[c] / lg : 0.f);
      } else {
        const size_t at = (((size_t)t * n_kv + h) * n_splits + split) * group + g0 + g;
        part_o[at * d + j] = acc[c];
        if (j == 0) {
          part_ml[at * 2] = ml_s[g][0];
          part_ml[at * 2 + 1] = ml_s[g][1];
        }
      }
    }
  }
}

// Merges a row's split partials by log-sum-exp into the output; rows past
// cu[num_seqs] and rows with no visible position are written as zeros.
template <typename QT>
__global__ void __launch_bounds__(kDecThreads)
generic_combine_kernel(
    const float* __restrict__ part_o, const float* __restrict__ part_ml,
    const int* __restrict__ kv_lens, const int* __restrict__ cu_q_lens,
    const int* __restrict__ num_seqs, QT* __restrict__ out, int n_q, int n_kv, int d,
    int max_seqs, int n_splits, int split_len) {
  const int t = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int group = n_q / n_kv;
  const int ns = min(num_seqs[0], max_seqs);
  int row_vis = 0;
  if (t < cu_q_lens[ns]) {
    const int s = find_seq(cu_q_lens, ns, t);
    row_vis = visible(kv_lens[s], cu_q_lens[s + 1] - cu_q_lens[s], t - cu_q_lens[s]);
  }
  // Splits that hold at least one visible position; the others never ran.
  const int n_used = row_vis <= 0 ? 0 : min(n_splits, (row_vis + split_len - 1) / split_len);
  QT* out_row = out + ((size_t)t * n_q + (size_t)h * group) * d;
  const size_t at0 = ((size_t)t * n_kv + h) * n_splits * group;
  for (int idx = tid; idx < group * d; idx += kDecThreads) {
    const int g = idx / d, j = idx - g * d;
    float mx = -INFINITY;
    for (int i = 0; i < n_used; ++i) mx = fmaxf(mx, part_ml[(at0 + (size_t)i * group + g) * 2]);
    float sum = 0.f, o = 0.f;
    for (int i = 0; i < n_used; ++i) {
      const size_t at = at0 + (size_t)i * group + g;
      const float e = exp2f(part_ml[at * 2] - mx);
      sum += e * part_ml[at * 2 + 1];
      o += e * part_o[at * d + j];
    }
    out_row[idx] = from_f<QT>(n_used > 0 && sum > 0.f ? o / sum : 0.f);
  }
}

// -- 2. query-tiled -----------------------------------------------------------------

// kRows M rows of S and O per thread: 4 (a pass of 128 M rows) up to
// D = 128, 2 (64) above; O's register tile is kRows x kCols = 64 floats.
template <typename QT, typename KV, int kRows>
__global__ void __launch_bounds__(kTiledThreads)
generic_tiled_kernel(
    const QT* __restrict__ q, const KV* __restrict__ kv, const float* __restrict__ kv_scales,
    const int* __restrict__ kv_lens, const int* __restrict__ page_indices,
    const int* __restrict__ cu_q_lens, const int* __restrict__ num_seqs, QT* __restrict__ out,
    int num_tokens, int n_q, int n_kv, int d, int page_size, int pages_per_seq, int max_seqs,
    int rows_per_tile, float scale_log2) {
  constexpr int kM = 32 * kRows;    // M rows (query row x group head) per pass
  constexpr int kCols = 64 / kRows; // O dims per thread: tx, tx + 8, ... (d <= 8 kCols)
  extern __shared__ __align__(16) float tiled_smem[];
  const int ks = d + 1;
  float* const q_s = tiled_smem;                 // [kM][d + 1]
  float* const k_s = q_s + kM * ks;              // [kTileN][d + 1]
  float* const v_s = k_s + kTileN * ks;          // [kTileN][d]
  float* const p_s = v_s + kTileN * d;           // [kM][kTileN + 1]
  __shared__ int info_s[3];

  const int h = blockIdx.y, jb = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ty = tid >> 3, tx = tid & 7;  // M rows ty + 32 i; positions / dims tx + 8 k
  const int group = n_q / n_kv;
  const int bm = rows_per_tile;
  const int ns = min(num_seqs[0], max_seqs);

  // Block jb's (sequence, tile): tiles are numbered sequence after sequence,
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
      const unsigned hit = __ballot_sync(kFull, nt > 0 && jb >= start && jb < start + nt);
      if (hit) {
        const int src = __ffs(hit) - 1;
        found_s = __shfl_sync(kFull, s, src);
        found_tile = __shfl_sync(kFull, jb - start, src);
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
  const int row_elems = group * d;  // one row's heads of this kv head, contiguous

  if (s < 0) {  // past the real tiles: zero this block's share of the padded rows
    const int r0 = cu_q_lens[ns] + (jb - info_s[2]) * bm;
    const int r1 = min(r0 + bm, num_tokens);
    for (int i = tid; i < (r1 - r0) * row_elems; i += kTiledThreads) {
      const int r = r0 + i / row_elems;
      out[((size_t)r * n_q + (size_t)h * group) * d + i % row_elems] = from_f<QT>(0.f);
    }
    return;
  }

  const int q_len = cu_q_lens[s + 1] - cu_q_lens[s];
  const int row0 = cu_q_lens[s] + info_s[1] * bm;  // the tile's first row
  const int i0 = info_s[1] * bm;                   // ... its index in the sequence
  const int n_rows = min(bm, q_len - i0);
  const int kv_len = kv_lens[s];
  const int* table = page_indices + (size_t)s * pages_per_seq;
  const int m_total = n_rows * group;

  for (int m0 = 0; m0 < m_total; m0 += kM) {  // one pass unless the group outnumbers kM
    const int m_end = min(m0 + kM, m_total);
    const int vis_first = visible(kv_len, q_len, i0 + m0 / group);
    const int vis_last = visible(kv_len, q_len, i0 + (m_end - 1) / group);
    int vis_row[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int mm = m0 + ty + 32 * i;
      vis_row[i] = mm < m_end ? visible(kv_len, q_len, i0 + mm / group) : 0;
    }

    __syncthreads();  // the previous pass is done with q_s
    for (int i = tid; i < kM * d; i += kTiledThreads) {
      const int mq = i / d, jj = i - mq * d, mm = m0 + mq;
      float val = 0.f;
      if (mm < m_end) {
        const int r = mm / group, hh = mm - r * group;
        val = to_f(q[((size_t)(row0 + r) * n_q + (size_t)h * group + hh) * d + jj]) * scale_log2;
      }
      q_s[mq * ks + jj] = val;
    }

    float o[kRows][kCols], row_m[kRows], row_l[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      row_m[i] = -INFINITY;
      row_l[i] = 0.f;
#pragma unroll
      for (int c = 0; c < kCols; ++c) o[i][c] = 0.f;
    }
    const int n_kv_tiles = vis_last > 0 ? (vis_last + kTileN - 1) / kTileN : 0;
    for (int kt = 0; kt < n_kv_tiles; ++kt) {
      const int base = kt * kTileN;
      __syncthreads();  // q_s is in; every thread is done with the previous tile
      load_kv_tile(kv, kv_scales, table, base, vis_last, h, n_kv, d, page_size, k_s, v_s, tid,
                   kTiledThreads);
      __syncthreads();

      // S = Q K^T for this thread's kRows x 4 (M row, position) pairs.
      float sc[kRows][4];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) sc[i][k] = 0.f;
#pragma unroll 2
      for (int jj = 0; jj < d; ++jj) {
        float qv[kRows], kvv[4];
#pragma unroll
        for (int i = 0; i < kRows; ++i) qv[i] = q_s[(ty + 32 * i) * ks + jj];
#pragma unroll
        for (int k = 0; k < 4; ++k) kvv[k] = k_s[(tx + 8 * k) * ks + jj];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int k = 0; k < 4; ++k) sc[i][k] = fmaf(qv[i], kvv[k], sc[i][k]);
      }

      // Mask where the tile crosses the first row's boundary, then the
      // online softmax of each M row over the 8 lanes that hold it.
      const bool need_mask = base + kTileN > vis_first;
      float alpha[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (need_mask && base + tx + 8 * k >= vis_row[i]) sc[i][k] = -INFINITY;
          mx = fmaxf(mx, sc[i][k]);
        }
#pragma unroll
        for (int off = 1; off < 8; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
        const float m_new = fmaxf(row_m[i], mx);
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        alpha[i] = exp2f(row_m[i] - m_use);
        row_m[i] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float e = exp2f(sc[i][k] - m_use);
          p_s[(ty + 32 * i) * (kTileN + 1) + tx + 8 * k] = e;
          sum += e;
        }
#pragma unroll
        for (int off = 1; off < 8; off <<= 1) sum += __shfl_xor_sync(kFull, sum, off);
        row_l[i] = row_l[i] * alpha[i] + sum;
#pragma unroll
        for (int c = 0; c < kCols; ++c) o[i][c] *= alpha[i];
      }
      __syncwarp();  // a row's P is written and read by the 8 lanes of one warp

      // O += P V: this thread's kRows M rows x dims tx + 8 c.
#pragma unroll 4
      for (int p = 0; p < kTileN; ++p) {
        float pv[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i) pv[i] = p_s[(ty + 32 * i) * (kTileN + 1) + p];
        const float* vp = v_s + p * d;
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int j = tx + 8 * c;
          if (j < d) {
            const float vv = vp[j];
#pragma unroll
            for (int i = 0; i < kRows; ++i) o[i][c] = fmaf(pv[i], vv, o[i][c]);
          }
        }
      }
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int mm = m0 + ty + 32 * i;
      if (mm >= m_end) continue;
      const float inv = row_l[i] > 0.f ? 1.f / row_l[i] : 0.f;  // nothing visible: zeros
      const int r = mm / group, hh = mm - r * group;
      QT* orow = out + ((size_t)(row0 + r) * n_q + (size_t)h * group + hh) * d;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int j = tx + 8 * c;
        if (j < d) orow[j] = from_f<QT>(o[i][c] * inv);
      }
    }
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

int decode_smem_bytes(int d) {
  return (kDecHeads * d + kTileN * (d + 1) + kTileN * d + kDecHeads * (kTileN + 1)) * 4;
}

int tiled_smem_bytes(int d, int rows) {
  const int m = 32 * rows;
  return (m * (d + 1) + kTileN * (d + 1) + kTileN * d + m * (kTileN + 1)) * 4;
}

bool geometry_ok(int n_q, int n_kv, int d, int max_seqs, bool quant, const void* kv_scales) {
  return n_kv > 0 && n_q > 0 && n_q % n_kv == 0 && d >= 8 && d % 8 == 0 && d <= kMaxHeadDim &&
         max_seqs > 0 && (!quant || kv_scales != nullptr);
}

template <typename QT, typename KV>
int launch_decode(const void* q, const void* kv, const void* kv_scales, const void* kv_lens,
                  const void* page_indices, const void* cu_q_lens, const void* num_seqs,
                  void* out, void* part_o, void* part_ml, int num_tokens, int n_q, int n_kv,
                  int d, int page_size, int pages_per_seq, int max_seqs, int n_splits,
                  int pages_per_split, float sm_scale, void* stream) {
  if (!geometry_ok(n_q, n_kv, d, max_seqs, sizeof(KV) == 1, kv_scales) || n_splits < 1 ||
      pages_per_split < 1 || (long long)n_splits * pages_per_split < pages_per_seq ||
      (n_splits > 1 && (part_o == nullptr || part_ml == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (num_tokens <= 0) return 0;
  auto kernel = generic_decode_kernel<QT, KV>;
  static bool smem_set = false;
  const cudaError_t err = allow_smem(kernel, decode_smem_bytes(kMaxHeadDim), smem_set);
  if (err != cudaSuccess) return (int)err;
  const int group = n_q / n_kv;
  const int n_chunks = (group + kDecHeads - 1) / kDecHeads;
  const int split_len = pages_per_split * page_size;
  const cudaStream_t st = (cudaStream_t)stream;
  kernel<<<dim3(num_tokens, n_kv * n_chunks, n_splits), kDecThreads, decode_smem_bytes(d), st>>>(
      (const QT*)q, (const KV*)kv, (const float*)kv_scales, (const int*)kv_lens,
      (const int*)page_indices, (const int*)cu_q_lens, (const int*)num_seqs, (QT*)out,
      (float*)part_o, (float*)part_ml, n_q, n_kv, d, page_size, pages_per_seq, max_seqs,
      n_splits, split_len, sm_scale * kLog2e);
  if (n_splits > 1) {
    generic_combine_kernel<QT><<<dim3(num_tokens, n_kv), kDecThreads, 0, st>>>(
        (const float*)part_o, (const float*)part_ml, (const int*)kv_lens, (const int*)cu_q_lens,
        (const int*)num_seqs, (QT*)out, n_q, n_kv, d, max_seqs, n_splits, split_len);
  }
  return (int)cudaGetLastError();
}

template <typename QT, typename KV, int kRows>
int launch_tiled_rows(const void* q, const void* kv, const void* kv_scales, const void* kv_lens,
                      const void* page_indices, const void* cu_q_lens, const void* num_seqs,
                      void* out, int num_tokens, int n_q, int n_kv, int d, int page_size,
                      int pages_per_seq, int max_seqs, int n_blocks, int rows_per_tile,
                      float sm_scale, cudaStream_t stream) {
  auto kernel = generic_tiled_kernel<QT, KV, kRows>;
  static bool smem_set = false;
  const cudaError_t err =
      allow_smem(kernel, tiled_smem_bytes(kRows == 4 ? 128 : kMaxHeadDim, kRows), smem_set);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(n_blocks, n_kv), kTiledThreads, tiled_smem_bytes(d, kRows), stream>>>(
      (const QT*)q, (const KV*)kv, (const float*)kv_scales, (const int*)kv_lens,
      (const int*)page_indices, (const int*)cu_q_lens, (const int*)num_seqs, (QT*)out,
      num_tokens, n_q, n_kv, d, page_size, pages_per_seq, max_seqs, rows_per_tile,
      sm_scale * kLog2e);
  return (int)cudaGetLastError();
}

template <typename QT, typename KV>
int launch_tiled(const void* q, const void* kv, const void* kv_scales, const void* kv_lens,
                 const void* page_indices, const void* cu_q_lens, const void* num_seqs,
                 void* out, int num_tokens, int n_q, int n_kv, int d, int page_size,
                 int pages_per_seq, int max_seqs, int n_blocks, int rows_per_tile,
                 float sm_scale, void* stream) {
  if (!geometry_ok(n_q, n_kv, d, max_seqs, sizeof(KV) == 1, kv_scales) || rows_per_tile < 1 ||
      n_blocks < 1)
    return (int)cudaErrorInvalidValue;
  if (num_tokens <= 0) return 0;
  auto run = [&](auto fn) {
    return fn(q, kv, kv_scales, kv_lens, page_indices, cu_q_lens, num_seqs, out, num_tokens,
              n_q, n_kv, d, page_size, pages_per_seq, max_seqs, n_blocks, rows_per_tile,
              sm_scale, (cudaStream_t)stream);
  };
  return d <= 128 ? run(launch_tiled_rows<QT, KV, 4>) : run(launch_tiled_rows<QT, KV, 2>);
}

}  // namespace

// Plain C entry points (loaded with ctypes), two per operand type: q and
// out in f32, fp16 or bf16 (f32, f16, bf16), pages of the same type or int8
// with f32 scales (_int8). Each takes kv_scales (null for pages of q's type)
// and head_dim, launches on `stream` and returns cudaGetLastError(): nonzero
// when a launch was refused. The plans (n_splits and pages_per_split;
// n_blocks and rows_per_tile) come from ops/ragged_attention.py, which also
// allocates the decode scratch.
#define K1_GENERIC_ENTRY_POINTS(TAG, QT, KV)                                                    \
  extern "C" int ragged_paged_attention_generic_##TAG##_decode_launch(                         \
      const void* q, const void* kv_pages, const void* kv_scales, const void* kv_lens,         \
      const void* page_indices, const void* cu_q_lens, const void* num_seqs, void* out,        \
      void* part_o, void* part_ml, int num_tokens, int n_q, int n_kv, int head_dim,            \
      int page_size, int pages_per_seq, int max_seqs, int n_splits, int pages_per_split,       \
      float sm_scale, void* stream) {                                                          \
    return launch_decode<QT, KV>(q, kv_pages, kv_scales, kv_lens, page_indices, cu_q_lens,     \
                                 num_seqs, out, part_o, part_ml, num_tokens, n_q, n_kv,        \
                                 head_dim, page_size, pages_per_seq, max_seqs, n_splits,       \
                                 pages_per_split, sm_scale, stream);                           \
  }                                                                                            \
  extern "C" int ragged_paged_attention_generic_##TAG##_tiled_launch(                          \
      const void* q, const void* kv_pages, const void* kv_scales, const void* kv_lens,         \
      const void* page_indices, const void* cu_q_lens, const void* num_seqs, void* out,        \
      int num_tokens, int n_q, int n_kv, int head_dim, int page_size, int pages_per_seq,       \
      int max_seqs, int n_blocks, int rows_per_tile, float sm_scale, void* stream) {           \
    return launch_tiled<QT, KV>(q, kv_pages, kv_scales, kv_lens, page_indices, cu_q_lens,      \
                                num_seqs, out, num_tokens, n_q, n_kv, head_dim, page_size,     \
                                pages_per_seq, max_seqs, n_blocks, rows_per_tile, sm_scale,    \
                                stream);                                                       \
  }

K1_GENERIC_ENTRY_POINTS(f32, float, float)
K1_GENERIC_ENTRY_POINTS(f16, __half, __half)
K1_GENERIC_ENTRY_POINTS(bf16, __nv_bfloat16, __nv_bfloat16)
K1_GENERIC_ENTRY_POINTS(f32_int8, float, int8_t)
K1_GENERIC_ENTRY_POINTS(f16_int8, __half, int8_t)
K1_GENERIC_ENTRY_POINTS(bf16_int8, __nv_bfloat16, int8_t)
