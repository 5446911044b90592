"""Ragged paged attention: one attention call for prefill, decode, and
mixed batches over the paged KV cache.

Counterpart of ``dynamo_tpu/ops/ragged_attention.py`` with the same
operands and semantics:

- ``q``: ``[T, n_q_heads, d]`` — every scheduled token this step,
  concatenated across sequences.
- ``kv_pages``: ``[n_pages, page_size, 2 * n_kv_heads, d]`` — ONE layer's
  paged cache, K at even and V at odd combined heads. The new tokens' K/V
  must already be written.
- ``kv_lens[s]``: tokens of sequence ``s`` in cache (including this step's
  chunk); ``page_indices``: ``[S, pages_per_seq]`` block table.
- ``cu_q_lens``: ``[S + 1]`` cumulative query lengths; entries past
  ``num_seqs`` repeat ``cu[num_seqs]``. ``num_seqs``: ``i32[1]``.
- ``kv_scales``: ``[n_pages, page_size, 2 * n_kv_heads]`` f32 marks int8
  pages (``engine/kv_quant.py``): ``kv ~= kv_pages * kv_scales[..., None]``.

Query token ``i`` of sequence ``s`` sits at ``kv_lens[s] - q_len_s + i``
and attends every cache position ``<=`` its own.

:func:`ragged_paged_attention` dispatches on the tensors' device: CPU
tensors take the plain PyTorch version :func:`ragged_paged_attention_ref`
(the tests), CUDA tensors launch a hand-written kernel of
``csrc/ragged_paged_attention.cu`` (its bf16 or its int8 instance) or
raise. Nothing falls back. The source has two kernels, picked from the
shapes alone (:func:`kernel_for`, no host sync): ``T == S``, the engine's
decode form, takes the split-KV decode kernel, planned by
:func:`decode_split_plan`; anything else the query-tiled tensor-core
kernel, planned by :func:`tiled_plan`. The planning functions are plain
Python so the CPU tests reach them; :func:`ragged_paged_attention_split_ref`
is the plain version of the split-and-combine arithmetic (tests only).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from dynamo_tpu_torch.engine.kv_quant import dequantize_kv
from dynamo_tpu_torch.ops import _build

_NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)

# The kernels' fixed geometry (csrc/ragged_paged_attention.cu).
KERNEL_HEAD_DIM = 128
KERNEL_MAX_GROUP = 8
TILE_M = 128               # tiled kernel: query rows x group heads per block
DECODE_BLOCKS_PER_SM = 16  # decode plan: blocks it aims for, per SM
MIN_SPLIT_POSITIONS = 256  # decode plan: the least cache positions per split

# The C entry point of each (kernel, int8 pages) pair.
ENTRY_NAMES = {
    (kernel, int8): f"ragged_paged_attention_{'int8_' if int8 else ''}{kernel}_launch"
    for kernel in ("decode", "tiled") for int8 in (False, True)
}
# Kernel launches since the last reset, by C entry point: the wrapper adds
# one per launch and nowhere else, so a run can show which path it took.
# ``launches`` and ``launches_int8`` (module attributes) are their sums by
# page type.
kernel_launches = dict.fromkeys(ENTRY_NAMES.values(), 0)


def reset_launches() -> None:
    for name in kernel_launches:
        kernel_launches[name] = 0


def __getattr__(name: str) -> int:
    if name in ("launches", "launches_int8"):
        int8 = name == "launches_int8"
        return sum(kernel_launches[e] for (_, i8), e in ENTRY_NAMES.items() if i8 == int8)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def kernel_for(num_tokens: int, max_seqs: int) -> str:
    """The kernel the wrapper picks from the shapes: ``T == S`` is the
    engine's decode form (``model.decode_tokens``) and takes the split-KV
    decode kernel; anything else the tiled kernel."""
    return "decode" if num_tokens == max_seqs else "tiled"


def decode_split_plan(num_tokens: int, n_kv: int, pages_per_seq: int, page_size: int,
                      sm_count: int) -> tuple[int, int]:
    """``(n_splits, pages_per_split)`` of the split-KV decode grid
    ``(T, n_kv, n_splits)``: enough splits for about
    ``DECODE_BLOCKS_PER_SM`` blocks per SM if every row were full, each a
    whole number of pages and at least ``MIN_SPLIT_POSITIONS`` positions;
    ``n_splits * pages_per_split`` covers the block table."""
    pairs = max(1, num_tokens * n_kv)
    want = -(-DECODE_BLOCKS_PER_SM * sm_count // pairs)
    min_pages = max(1, -(-MIN_SPLIT_POSITIONS // page_size))
    n = max(1, min(want, pages_per_seq // min_pages))
    per = -(-pages_per_seq // n)
    return -(-pages_per_seq // per), per


def decode_scratch_shapes(num_tokens: int, n_q: int, n_kv: int,
                          n_splits: int) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """Shapes of the decode kernel's f32 partials: ``o`` and ``(m, l)`` of
    every (row, kv head, split, group head)."""
    head = (num_tokens, n_kv, n_splits, n_q // n_kv)
    return (*head, KERNEL_HEAD_DIM), (*head, 2)


def tiled_plan(num_tokens: int, max_seqs: int, group: int) -> tuple[int, int]:
    """``(n_blocks, rows_per_tile)`` of the tiled grid ``(n_blocks, n_kv)``:
    a block takes ``rows_per_tile = TILE_M // group`` query rows of one
    sequence; sequence s has ``ceil(q_len_s / rows_per_tile)`` tiles, at
    most ``ceil(T / rows_per_tile) + S`` in all, and the blocks past the
    real tiles zero the padded rows."""
    rows = TILE_M // group
    return -(-num_tokens // rows) + max_seqs, rows


def ragged_paged_attention_ref(
    q: torch.Tensor,             # [T, n_q, d]
    kv_pages: torch.Tensor,      # [n_pages, page_size, 2*n_kv, d]
    kv_lens: torch.Tensor,       # [S] i32
    page_indices: torch.Tensor,  # [S, pages_per_seq] i32
    cu_q_lens: torch.Tensor,     # [S+1] i32
    num_seqs: torch.Tensor,      # [1] i32
    *,
    sm_scale: float,
    kv_scales: torch.Tensor | None = None,
) -> torch.Tensor:               # [T, n_q, d]
    """Plain PyTorch version: gathers each row's whole block table and
    masks, exactly as the JAX reference does (materialises
    ``[T, pages_per_seq * page_size, 2*n_kv, d]`` in f32). int8 pages are
    dequantized on the gather with their scales."""
    if kv_scales is not None and kv_scales.shape != kv_pages.shape[:-1]:
        raise ValueError(
            f"kv_scales must be [n_pages, page_size, 2*n_kv] = "
            f"{tuple(kv_pages.shape[:-1])}, got {tuple(kv_scales.shape)}"
        )
    T, n_q, d = q.shape
    n_pages, page_size, n_comb, _ = kv_pages.shape
    n_kv = n_comb // 2
    group = n_q // n_kv
    S, pages_per_seq = page_indices.shape
    span = pages_per_seq * page_size
    dev = q.device

    cu = cu_q_lens.long()
    lens = kv_lens.long()
    t = torch.arange(T, dtype=torch.long, device=dev)
    # seq_id[t] = s such that cu[s] <= t < cu[s+1]
    seq_id = (t[:, None] >= cu[None, 1:]).sum(dim=1).clamp(max=S - 1)
    valid_row = t < cu.index_select(0, num_seqs.long())

    q_len = cu[seq_id + 1] - cu[seq_id]
    abs_pos = lens[seq_id] - q_len + (t - cu[seq_id])

    tables_t = page_indices.long()[seq_id]                 # [T, pages_per_seq]
    offs = torch.arange(page_size, dtype=torch.long, device=dev)
    slots = (tables_t[:, :, None] * page_size + offs[None, None, :]).reshape(T, span)
    flat = kv_pages.reshape(n_pages * page_size, n_comb, d)
    if kv_scales is not None:
        scf = kv_scales.reshape(n_pages * page_size, n_comb)[slots]
        kvf = dequantize_kv(flat[slots], scf)              # [T, span, 2*n_kv, d]
    else:
        kvf = flat[slots].float()
    k = kvf[:, :, 0::2, :]
    v = kvf[:, :, 1::2, :]

    qg = q.reshape(T, n_kv, group, d).float()
    s = torch.einsum("thgd,tshd->thgs", qg, k) * sm_scale  # [T, n_kv, group, span]
    pos = torch.arange(span, dtype=torch.long, device=dev)
    mask = (pos[None, :] <= abs_pos[:, None]) & (pos[None, :] < lens[seq_id][:, None])
    mask = mask & valid_row[:, None]
    s = torch.where(mask[:, None, None, :], s, torch.full_like(s, _NEG_INF))
    w = torch.softmax(s, dim=-1)
    w = torch.where(valid_row[:, None, None, None], w, torch.zeros_like(w))
    out = torch.einsum("thgs,tshd->thgd", w, v)
    return out.reshape(T, n_q, d).to(q.dtype)


def ragged_paged_attention_split_ref(
    q, kv_pages, kv_lens, page_indices, cu_q_lens, num_seqs, *, sm_scale: float,
    n_splits: int, pages_per_split: int, kv_scales=None,
) -> torch.Tensor:
    """Plain version of the split-KV decode arithmetic on the same plan:
    each split's partial ``(m, l, o)`` over its chunk of the visible
    positions, then the log-sum-exp merge of the splits that hold one.
    Rows with no visible position and rows past ``cu[num_seqs]`` are zeros
    (the kernels' rule; the reference averages over the masked span). Tests
    only: nothing on the main path calls it."""
    T, n_q, d = q.shape
    n_pages, page_size, n_comb, _ = kv_pages.shape
    n_kv = n_comb // 2
    group = n_q // n_kv
    S, pps = page_indices.shape
    split_len = pages_per_split * page_size
    span = n_splits * split_len
    if span < pps * page_size:
        raise ValueError(f"{n_splits} splits of {pages_per_split} pages miss the table's {pps}")
    dev = q.device
    cu, lens = cu_q_lens.long(), kv_lens.long()
    t = torch.arange(T, dtype=torch.long, device=dev)
    seq_id = (t[:, None] >= cu[None, 1:]).sum(dim=1).clamp(max=S - 1)
    valid_row = t < cu.index_select(0, num_seqs.long())
    abs_pos = lens[seq_id] - (cu[seq_id + 1] - cu[seq_id]) + (t - cu[seq_id])
    n_vis = torch.minimum(abs_pos + 1, lens[seq_id]).clamp(min=0) * valid_row

    # The table padded with its own garbage entries to the plan's span.
    pages = page_indices.long()[seq_id]                                 # [T, pps]
    pages = torch.cat([pages, pages[:, -1:].expand(T, span // page_size - pps)], dim=1)
    offs = torch.arange(page_size, dtype=torch.long, device=dev)
    slots = (pages[:, :, None] * page_size + offs).reshape(T, span)
    flat = kv_pages.reshape(n_pages * page_size, n_comb, d)
    if kv_scales is not None:
        kvf = dequantize_kv(flat[slots], kv_scales.reshape(-1, n_comb)[slots])
    else:
        kvf = flat[slots].float()
    k = kvf[:, :, 0::2].reshape(T, n_splits, split_len, n_kv, d)
    v = kvf[:, :, 1::2].reshape(T, n_splits, split_len, n_kv, d)
    qg = q.reshape(T, n_kv, group, d).float()
    s = torch.einsum("thgd,tcphd->tchgp", qg, k) * sm_scale            # [T, c, h, g, p]
    pos = torch.arange(span, dtype=torch.long, device=dev).reshape(n_splits, split_len)
    seen = pos[None] < n_vis[:, None, None]                             # [T, c, p]
    s = s.masked_fill(~seen[:, :, None, None, :], float("-inf"))

    # Partials per split; a split with no visible position has l = 0.
    has = seen.any(dim=-1)                                              # [T, c]
    m = s.amax(dim=-1).masked_fill(~has[:, :, None, None], 0.0)         # [T, c, h, g]
    p = torch.exp(s - m[..., None])
    l_part = p.sum(dim=-1)
    o_part = torch.einsum("tchgp,tcphd->tchgd", p, v)
    # Merge by log-sum-exp over the splits that hold a position.
    m_all = m.masked_fill(~has[:, :, None, None], float("-inf")).amax(dim=1, keepdim=True)
    m_all = torch.nan_to_num(m_all, neginf=0.0)                        # rows with none
    w = torch.where(has[:, :, None, None], torch.exp(m - m_all), 0.0)
    num = (w[..., None] * o_part).sum(dim=1)                            # [T, h, g, d]
    den = (w * l_part).sum(dim=1)
    out = torch.where(den[..., None] > 0, num / den.clamp(min=1e-30)[..., None], 0.0)
    return out.reshape(T, n_q, d).to(q.dtype)


def _check_cuda_operands(q, kv_pages, kv_lens, page_indices, cu_q_lens, num_seqs,
                         kv_scales=None):
    dev = q.device
    page_dtype = torch.bfloat16 if kv_scales is None else torch.int8
    if q.dtype != torch.bfloat16 or kv_pages.dtype != page_dtype:
        raise TypeError(
            f"ragged_paged_attention kernel takes bf16 q and {page_dtype} pages "
            f"{'with' if kv_scales is not None else 'without'} kv_scales, got "
            f"{q.dtype} / {kv_pages.dtype}"
        )
    if kv_scales is not None:
        if kv_scales.dtype != torch.float32:
            raise TypeError(f"kv_scales must be float32, got {kv_scales.dtype}")
        if kv_scales.shape != kv_pages.shape[:-1]:
            raise ValueError(
                f"kv_scales must be [n_pages, page_size, 2*n_kv] = "
                f"{tuple(kv_pages.shape[:-1])}, got {tuple(kv_scales.shape)}"
            )
        if kv_scales.device != dev or not kv_scales.is_contiguous() or kv_scales.data_ptr() % 8:
            raise ValueError(f"kv_scales must be contiguous and 8-byte aligned on {dev}")
    for name, a in (
        ("kv_lens", kv_lens), ("page_indices", page_indices),
        ("cu_q_lens", cu_q_lens), ("num_seqs", num_seqs),
    ):
        if a.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {a.dtype}")
    for name, a in (
        ("q", q), ("kv_pages", kv_pages), ("kv_lens", kv_lens),
        ("page_indices", page_indices), ("cu_q_lens", cu_q_lens),
        ("num_seqs", num_seqs),
    ):
        if a.device != dev:
            raise ValueError(f"{name} is on {a.device}, q on {dev}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dim() != 3 or kv_pages.dim() != 4:
        raise ValueError(
            f"q must be [T, n_q, d] and kv_pages [n_pages, page_size, 2*n_kv, d], "
            f"got {tuple(q.shape)} / {tuple(kv_pages.shape)}"
        )
    T, n_q, d = q.shape
    n_comb = kv_pages.shape[2]
    if d != KERNEL_HEAD_DIM or kv_pages.shape[3] != d:
        raise ValueError(
            f"the CUDA kernel is built for head_dim {KERNEL_HEAD_DIM}, got {d}"
        )
    if n_comb % 2 or n_q % (n_comb // 2) or n_q // (n_comb // 2) > KERNEL_MAX_GROUP:
        raise ValueError(
            f"unsupported head layout: n_q={n_q}, combined kv heads={n_comb} "
            f"(need an even count and a GQA group <= {KERNEL_MAX_GROUP})"
        )
    S = page_indices.shape[0]
    if page_indices.dim() != 2 or kv_lens.shape != (S,) or cu_q_lens.shape != (S + 1,):
        raise ValueError(
            f"inconsistent batch operands: page_indices {tuple(page_indices.shape)}, "
            f"kv_lens {tuple(kv_lens.shape)}, cu_q_lens {tuple(cu_q_lens.shape)}"
        )
    if num_seqs.shape != (1,) or S < 1:
        raise ValueError("num_seqs must be i32[1] and S >= 1")
    if kv_pages.data_ptr() % 16 or q.data_ptr() % 16:
        raise ValueError("q and kv_pages must be 16-byte aligned")


class Entries(NamedTuple):
    """The two C entry points of one page type of a built
    ``ragged_paged_attention.cu``, typed."""

    decode: object  # split-KV decode (+ combine)
    tiled: object   # query-tiled tensor-core kernel


def bind(lib: ctypes.CDLL, int8: bool = False) -> Entries:
    """The C entry points of a built ``ragged_paged_attention.cu``: the
    bf16-page ones, or with ``int8`` the ones that also take ``kv_scales``."""
    pages = [ctypes.c_void_p] * (2 if int8 else 1)
    decode = getattr(lib, ENTRY_NAMES["decode", int8])
    decode.argtypes = [ctypes.c_void_p] + pages + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_void_p,
    ]
    tiled = getattr(lib, ENTRY_NAMES["tiled", int8])
    tiled.argtypes = [ctypes.c_void_p] + pages + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_void_p,
    ]
    for fn in (decode, tiled):
        fn.restype = ctypes.c_int
    return Entries(decode, tiled)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def launch_plan(kernel: str, num_tokens: int, n_q: int, n_kv: int, page_size: int,
                pages_per_seq: int, max_seqs: int, sms: int) -> tuple[tuple[int, ...], int, int]:
    """What ``kernel``'s C entry point takes besides pointers, worked out
    once per shape: its int arguments (the dims, then the plan), and the
    f32 counts of the decode plan's ``o`` and ``(m, l)`` partials (0 when
    it writes the output directly, and for the tiled kernel)."""
    dims = (num_tokens, n_q, n_kv, page_size, pages_per_seq, max_seqs)
    if kernel == "tiled":
        return (*dims, *tiled_plan(num_tokens, max_seqs, n_q // n_kv)), 0, 0
    if kernel != "decode":
        raise ValueError(f"kernel must be 'decode' or 'tiled', got {kernel!r}")
    n_splits, per = decode_split_plan(num_tokens, n_kv, pages_per_seq, page_size, sms)
    if n_splits == 1:
        return (*dims, n_splits, per), 0, 0
    o_shape, ml_shape = decode_scratch_shapes(num_tokens, n_q, n_kv, n_splits)
    return (*dims, n_splits, per), math.prod(o_shape), math.prod(ml_shape)


def launch(entries: Entries, q, kv_pages, kv_lens, page_indices, cu_q_lens, num_seqs, *,
           sm_scale: float, kernel: str, kv_scales=None) -> torch.Tensor:
    """Run ``kernel`` ("decode" or "tiled") from ``entries`` (bound with
    ``int8=kv_scales is not None``) on checked operands, on the current
    stream, into a fresh output; the decode plan's scratch is one f32
    allocation here, ``(m, l)`` after ``o``."""
    T, n_q, _ = q.shape
    S, pps = page_indices.shape
    ints, n_o, n_ml = launch_plan(kernel, T, n_q, kv_pages.shape[2] // 2, kv_pages.shape[1],
                                  pps, S, sm_count(q.get_device()))
    out = torch.empty_like(q)
    ptrs = [q.data_ptr(), kv_pages.data_ptr()]
    if kv_scales is not None:
        ptrs.append(kv_scales.data_ptr())
    ptrs += [kv_lens.data_ptr(), page_indices.data_ptr(), cu_q_lens.data_ptr(),
             num_seqs.data_ptr(), out.data_ptr()]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if kernel == "decode":
        part = [None, None]
        if n_o:
            scratch = torch.empty(n_o + n_ml, dtype=torch.float32, device=q.device)
            part = [scratch.data_ptr(), scratch.data_ptr() + 4 * n_o]
        rc = entries.decode(*ptrs, *part, *ints, float(sm_scale), stream)
    else:
        rc = entries.tiled(*ptrs, *ints, float(sm_scale), stream)
    if rc != 0:
        raise RuntimeError(
            f"ragged_paged_attention {kernel} kernel launch failed: CUDA error {rc}"
        )
    return out


_kernels: dict[bool, Entries] = {}  # bound once each, at the first CUDA call


def ragged_paged_attention_cuda(
    q, kv_pages, kv_lens, page_indices, cu_q_lens, num_seqs, *, sm_scale: float,
    kv_scales=None, kernel: str | None = None,
) -> torch.Tensor:
    """Launch a hand-written Hopper kernel on the current stream: the
    bf16-page instance, or the int8 one when ``kv_scales`` is given; the
    split-KV decode kernel when ``T == S``, else the tiled one (``kernel``
    forces either)."""
    if not q.is_cuda:
        raise ValueError("ragged_paged_attention_cuda needs CUDA tensors")
    _check_cuda_operands(q, kv_pages, kv_lens, page_indices, cu_q_lens, num_seqs, kv_scales)
    if q.shape[0] == 0:
        return torch.empty_like(q)
    int8 = kv_scales is not None
    entries = _kernels.get(int8)
    if entries is None:
        entries = _kernels[int8] = bind(_build.load("ragged_paged_attention"), int8)
    kernel = kernel or kernel_for(q.shape[0], page_indices.shape[0])
    out = launch(
        entries, q, kv_pages, kv_lens, page_indices, cu_q_lens, num_seqs,
        sm_scale=sm_scale, kv_scales=kv_scales, kernel=kernel,
    )
    kernel_launches[ENTRY_NAMES[kernel, int8]] += 1
    return out


def ragged_paged_attention(
    q, kv_pages, kv_lens, page_indices, cu_q_lens, num_seqs, *,
    sm_scale: float, kv_scales=None,
) -> torch.Tensor:
    """Device dispatch: the plain version for CPU tensors, the CUDA kernel
    for CUDA tensors (or an error). ``kv_scales`` selects int8 pages on
    both."""
    if q.device.type == "cpu":
        return ragged_paged_attention_ref(
            q, kv_pages, kv_lens, page_indices, cu_q_lens, num_seqs,
            sm_scale=sm_scale, kv_scales=kv_scales,
        )
    return ragged_paged_attention_cuda(
        q, kv_pages, kv_lens, page_indices, cu_q_lens, num_seqs,
        sm_scale=sm_scale, kv_scales=kv_scales,
    )
