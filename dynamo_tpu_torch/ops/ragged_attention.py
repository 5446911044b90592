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
(the tests), CUDA tensors launch a hand-written kernel or raise; nothing
falls back. :func:`k1_instance` names the instance: a fast one of
``csrc/ragged_paged_attention.cu`` (bf16 q, bf16 or int8 pages, head_dim
64 or 128 (:data:`KERNEL_HEAD_DIMS`), a GQA group up to
:data:`KERNEL_MAX_GROUP`), else the generic one of
``csrc/ragged_paged_attention_generic.cu`` (q in f32, fp16 or bf16, pages
of q's type or int8, any head_dim that is a multiple of 8 up to
:data:`GENERIC_MAX_HEAD_DIM`, any group; f32 CUDA-core arithmetic, P
unrounded). Each source has two kernels, each right on any
ragged layout: the split-KV decode kernel, planned by
:func:`decode_split_plan`, a block per (query row, kv head, split), fast
where each sequence has one query row (the engine's decode form,
``model.decode_tokens``), and the query-tiled tensor-core kernel, planned
by :func:`tiled_plan`, for chunks of many rows. The caller states the form
(``kernel=``): the shapes cannot tell a decode batch from a mixed batch
whose token bucket equals its row count, whose chunk rows would take the
decode kernel at many times the tiled kernel's cost. A direct call that
states none gets :func:`kernel_for`'s choice from the shapes. The planning functions are plain
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

# The fast kernels' geometry (csrc/ragged_paged_attention.cu): an
# instance of each kernel per head dim here, and one GQA group limit.
KERNEL_HEAD_DIMS = (64, 128)
KERNEL_MAX_GROUP = 8
# The generic instance (csrc/ragged_paged_attention_generic.cu): q and out
# in these types (their tags name its entry points), pages of q's type or
# int8, head_dim a multiple of 8 up to this, any group. Its f32 instance
# keeps everything in f32 (P unrounded), and the matrix products around it
# stay full f32: nothing in the port turns TF32 on.
GENERIC_Q_DTYPES = {torch.float32: "f32", torch.float16: "f16", torch.bfloat16: "bf16"}
GENERIC_MAX_HEAD_DIM = 256
TILE_M = 128               # tiled kernel: query rows x group heads per block
TILE_N = 64                # tiled kernel: K/V positions per tile
LOG2E = 1.4426950408889634
DECODE_BLOCKS_PER_SM = 16  # decode plan: blocks it aims for, per SM
MIN_SPLIT_POSITIONS = 256  # decode plan: the least cache positions per split


# The C entry point of each instance, by (kernel, int8 pages, head dim):
# head_dim 128's names carry no head dim.
INSTANCE_NAMES = {
    (kernel, int8, d): (f"ragged_paged_attention_{'int8_' if int8 else ''}{kernel}"
                        f"{'' if d == 128 else f'_hd{d}'}_launch")
    for d in KERNEL_HEAD_DIMS for kernel in ("decode", "tiled") for int8 in (False, True)
}
# The generic instance's C entry points, by (kernel, q type tag, int8 pages).
GENERIC_INSTANCE_NAMES = {
    (kernel, tag, int8): f"ragged_paged_attention_generic_{tag}{'_int8' if int8 else ''}_{kernel}_launch"
    for tag in GENERIC_Q_DTYPES.values() for kernel in ("decode", "tiled") for int8 in (False, True)
}
_PAGE_INT8 = {**{e: i8 for (_, i8, _), e in INSTANCE_NAMES.items()},
              **{e: i8 for (_, _, i8), e in GENERIC_INSTANCE_NAMES.items()}}
# Kernel launches since the last reset, by C entry point (one per
# instance, fast and generic): the wrapper adds one per launch and nowhere
# else, so a run can show which path, and which instance, it took.
# ``launches`` and ``launches_int8`` (module attributes) are their sums by
# page type over all instances.
kernel_launches = dict.fromkeys(_PAGE_INT8, 0)


def reset_launches() -> None:
    for name in kernel_launches:
        kernel_launches[name] = 0


def __getattr__(name: str) -> int:
    if name in ("launches", "launches_int8"):
        int8 = name == "launches_int8"
        return sum(n for e, n in kernel_launches.items() if _PAGE_INT8[e] == int8)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def card_refusals(q_dtype: torch.dtype, head_dim: int, n_q: int, n_kv: int) -> list[str]:
    """Why no K1 instance runs attention of this type and head layout on
    the card (empty when one does): a q dtype outside
    :data:`GENERIC_Q_DTYPES`, a head_dim that is not a multiple of 8 up to
    :data:`GENERIC_MAX_HEAD_DIM`, query heads that are not whole groups of
    the KV heads. The JAX package serves such models through its plain
    reference; the port refuses them on the card."""
    why = []
    if q_dtype not in GENERIC_Q_DTYPES:
        why.append(f"dtype {str(q_dtype).removeprefix('torch.')} (K1 takes float32, float16 "
                   f"or bfloat16)")
    if head_dim < 8 or head_dim % 8 or head_dim > GENERIC_MAX_HEAD_DIM:
        why.append(f"head_dim {head_dim} (K1 takes a multiple of 8 up to {GENERIC_MAX_HEAD_DIM})")
    if n_kv < 1 or n_q % n_kv:
        why.append(f"{n_q} query heads over {n_kv} KV heads (K1 takes whole GQA groups)")
    return why


def k1_instance(q_dtype: torch.dtype, int8: bool, head_dim: int, group: int,
                kernel: str = "decode") -> str:
    """The C entry point (and launch counter) that runs ``kernel``
    ("decode" or "tiled") on the card for q of ``q_dtype`` over bf16 pages
    or, with ``int8``, int8 pages, at ``head_dim`` and a GQA ``group``: a
    fast instance exactly where one runs (bf16 q, head_dim in
    :data:`KERNEL_HEAD_DIMS`, group up to :data:`KERNEL_MAX_GROUP`), the
    generic instance elsewhere; raises ``ValueError`` naming what no
    instance runs (:func:`card_refusals`)."""
    if kernel not in ("decode", "tiled"):
        raise ValueError(f"kernel must be 'decode' or 'tiled', got {kernel!r}")
    if (q_dtype == torch.bfloat16 and head_dim in KERNEL_HEAD_DIMS
            and 1 <= group <= KERNEL_MAX_GROUP):
        return INSTANCE_NAMES[kernel, int8, head_dim]
    why = card_refusals(q_dtype, head_dim, group, 1)
    if group < 1:
        why.append(f"a GQA group of {group}")
    if why:
        raise ValueError(f"no K1 instance runs on the card: {'; '.join(why)}")
    return GENERIC_INSTANCE_NAMES[kernel, GENERIC_Q_DTYPES[q_dtype], int8]


def generic_tile_m(head_dim: int) -> int:
    """M rows (query row x group head) of one pass of the generic tiled
    kernel: its register tile holds 64 O floats a thread, so 128 rows up to
    head_dim 128 and 64 above."""
    return 128 if head_dim <= 128 else 64


def kernel_for(num_tokens: int, max_seqs: int) -> str:
    """The default form of a call that states none: ``T == S`` takes the
    split-KV decode kernel, anything else the tiled kernel. Both are right
    on any layout, but this is the fast choice only where ``T == S`` means
    one query row per sequence; the engine's forwards state their form
    instead."""
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


def decode_scratch_shapes(num_tokens: int, n_q: int, n_kv: int, n_splits: int,
                          head_dim: int = 128) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """Shapes of the decode kernel's f32 partials: ``o`` and ``(m, l)`` of
    every (row, kv head, split, group head)."""
    head = (num_tokens, n_kv, n_splits, n_q // n_kv)
    return (*head, head_dim), (*head, 2)


def tiled_plan(num_tokens: int, max_seqs: int, group: int,
               tile_m: int = TILE_M) -> tuple[int, int]:
    """``(n_blocks, rows_per_tile)`` of the tiled grid ``(n_blocks, n_kv)``:
    a block takes ``rows_per_tile = tile_m // group`` query rows of one
    sequence (at least 1: a group above ``tile_m`` takes the generic
    kernel's passes); sequence s has ``ceil(q_len_s / rows_per_tile)``
    tiles, at most ``ceil(T / rows_per_tile) + S`` in all, and the blocks
    past the real tiles zero the padded rows."""
    rows = max(1, tile_m // group)
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
    kernel: str | None = None,
) -> torch.Tensor:               # [T, n_q, d]
    """Plain PyTorch version: gathers each row's whole block table and
    masks, exactly as the JAX reference does (materialises
    ``[T, pages_per_seq * page_size, 2*n_kv, d]`` in f32). int8 pages are
    dequantized on the gather with their scales. It serves every layout,
    so the stated kernel form (``kernel``) changes nothing here."""
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


def ragged_paged_attention_tiled_ref(
    q, kv_pages, kv_lens, page_indices, cu_q_lens, num_seqs, *, sm_scale: float,
    kv_scales=None, kernel=None, p_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Plain version of the tiled kernel's arithmetic on the reference's
    gather: scores in the log2 domain (int8 pages: times each position's
    K scale), an online softmax over ``TILE_N``-position tiles from
    position 0 (each tile's P taken against the running max through it),
    P rounded to ``p_dtype`` for PV (int8 pages: P times each position's
    V scale, then rounded, against the raw int8 V), and the row sum of the
    unrounded P. At ``p_dtype=torch.float32`` it is
    :func:`ragged_paged_attention_ref` up to f32 order; at bf16 it differs
    from it by the kernel's rounding of P alone, so where that rounding
    decides something (a greedy pick at a near-tie) the kernel is held to
    this. Like the reference it serves every layout (``kernel`` changes
    nothing). Tests and ``chip_smoke.py`` only: nothing on the main path
    calls it."""
    T, n_q, d = q.shape
    n_pages, page_size, n_comb, _ = kv_pages.shape
    n_kv = n_comb // 2
    group = n_q // n_kv
    S, pps = page_indices.shape
    span = pps * page_size
    n_tiles = -(-span // TILE_N)
    dev = q.device
    cu, lens = cu_q_lens.long(), kv_lens.long()
    t = torch.arange(T, dtype=torch.long, device=dev)
    seq_id = (t[:, None] >= cu[None, 1:]).sum(dim=1).clamp(max=S - 1)
    valid_row = t < cu.index_select(0, num_seqs.long())
    abs_pos = lens[seq_id] - (cu[seq_id + 1] - cu[seq_id]) + (t - cu[seq_id])

    offs = torch.arange(page_size, dtype=torch.long, device=dev)
    slots = (page_indices.long()[seq_id][:, :, None] * page_size + offs).reshape(T, span)
    raw = kv_pages.reshape(n_pages * page_size, n_comb, d)[slots]   # [T, span, 2*n_kv, d]
    k, v = raw[:, :, 0::2].float(), raw[:, :, 1::2].float()
    qg = q.reshape(T, n_kv, group, d).float()
    x = torch.einsum("thgd,tshd->thgs", qg, k) * (sm_scale * LOG2E)  # [T, n_kv, group, span]
    if kv_scales is not None:
        sc = kv_scales.reshape(n_pages * page_size, n_comb)[slots]     # [T, span, 2*n_kv]
        x = x * sc[:, :, 0::2].transpose(1, 2)[:, :, None, :]
        v_scale = sc[:, :, 1::2].transpose(1, 2)[:, :, None, :]
    pos = torch.arange(span, dtype=torch.long, device=dev)
    seen = (pos <= abs_pos[:, None]) & (pos < lens[seq_id][:, None]) & valid_row[:, None]
    x = x.masked_fill(~seen[:, None, None, :], float("-inf"))
    tiles = lambda a, fill: torch.nn.functional.pad(  # noqa: E731
        a, (0, n_tiles * TILE_N - span), value=fill).unflatten(-1, (n_tiles, TILE_N))
    x = tiles(x, float("-inf"))                                          # [..., tiles, TILE_N]
    run = torch.cummax(x.amax(dim=-1), dim=-1).values
    m = torch.nan_to_num(run, neginf=0.0)    # the kernel's m_use: 0 while nothing is seen
    p = torch.exp2(x - m[..., None])
    # Each tile's share scaled to the final max, as the kernel's alphas do.
    rescale = torch.exp2((m - m[..., -1:]).clamp(max=0.0))[..., None]
    l_row = (p * rescale).sum(dim=(-2, -1))
    if kv_scales is not None:
        p = p * tiles(v_scale, 0.0)
    p = (p.to(p_dtype).float() * rescale).flatten(-2)[..., :span]
    o = torch.einsum("thgs,tshd->thgd", p, v)
    out = torch.where(l_row[..., None] > 0, o / l_row.clamp(min=1e-30)[..., None], 0.0)
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
                         kv_scales=None, kernel: str = "decode") -> str:
    """Raise on operands that no K1 instance takes; return the C entry
    point that runs ``kernel`` on them (:func:`k1_instance`, the one owner
    of the instances' limits)."""
    dev = q.device
    if q.dim() != 3 or kv_pages.dim() != 4:
        raise ValueError(
            f"q must be [T, n_q, d] and kv_pages [n_pages, page_size, 2*n_kv, d], "
            f"got {tuple(q.shape)} / {tuple(kv_pages.shape)}"
        )
    T, n_q, d = q.shape
    n_comb = kv_pages.shape[2]
    if n_comb % 2 or n_q % (n_comb // 2):
        raise ValueError(
            f"unsupported head layout: n_q={n_q}, combined kv heads={n_comb} "
            f"(need an even count whose half divides n_q)"
        )
    name = k1_instance(q.dtype, kv_scales is not None, d, n_q // (n_comb // 2), kernel)
    if kv_scales is not None and kv_pages.dtype != torch.int8:
        raise TypeError(f"ragged_paged_attention kernel takes int8 pages with kv_scales, "
                        f"got {kv_pages.dtype} pages")
    if kv_scales is None and kv_pages.dtype != q.dtype:
        raise TypeError(f"ragged_paged_attention kernel takes pages of q's type without "
                        f"kv_scales, got {q.dtype} / {kv_pages.dtype}")
    if kv_pages.shape[3] != d:
        raise ValueError(f"head_dim: q's {d} and kv_pages' {kv_pages.shape[3]} differ")
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
    for arg, a in (
        ("kv_lens", kv_lens), ("page_indices", page_indices),
        ("cu_q_lens", cu_q_lens), ("num_seqs", num_seqs),
    ):
        if a.dtype != torch.int32:
            raise TypeError(f"{arg} must be int32, got {a.dtype}")
    for arg, a in (
        ("q", q), ("kv_pages", kv_pages), ("kv_lens", kv_lens),
        ("page_indices", page_indices), ("cu_q_lens", cu_q_lens),
        ("num_seqs", num_seqs),
    ):
        if a.device != dev:
            raise ValueError(f"{arg} is on {a.device}, q on {dev}")
        if not a.is_contiguous():
            raise ValueError(f"{arg} must be contiguous")
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
    return name


class Entries(NamedTuple):
    """The two C entry points of one instance, typed: of one page type and
    head dim of a built ``ragged_paged_attention.cu``, or (``generic``) of
    one q type and page type of ``ragged_paged_attention_generic.cu``."""

    decode: object  # split-KV decode (+ combine)
    tiled: object   # query-tiled kernel
    generic: bool = False  # takes the generic plan (:func:`generic_launch_plan`)


def bind(lib: ctypes.CDLL, int8: bool = False, head_dim: int = 128) -> Entries:
    """The C entry points of a built ``ragged_paged_attention.cu`` at
    ``head_dim``: the bf16-page ones, or with ``int8`` the ones that also
    take ``kv_scales``."""
    pages = [ctypes.c_void_p] * (2 if int8 else 1)
    decode = getattr(lib, INSTANCE_NAMES["decode", int8, head_dim])
    decode.argtypes = [ctypes.c_void_p] + pages + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_void_p,
    ]
    tiled = getattr(lib, INSTANCE_NAMES["tiled", int8, head_dim])
    tiled.argtypes = [ctypes.c_void_p] + pages + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_void_p,
    ]
    for fn in (decode, tiled):
        fn.restype = ctypes.c_int
    return Entries(decode, tiled)


def bind_generic(lib: ctypes.CDLL, q_dtype: torch.dtype, int8: bool = False) -> Entries:
    """The C entry points of a built ``ragged_paged_attention_generic.cu``
    for q (and out) of ``q_dtype`` over pages of that type or, with
    ``int8``, int8 pages: each takes ``kv_scales`` (null without int8) and
    the head dim."""
    tag = GENERIC_Q_DTYPES[q_dtype]
    decode = getattr(lib, GENERIC_INSTANCE_NAMES["decode", tag, int8])
    decode.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + [ctypes.c_float,
                                                                      ctypes.c_void_p]
    tiled = getattr(lib, GENERIC_INSTANCE_NAMES["tiled", tag, int8])
    tiled.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [ctypes.c_float,
                                                                    ctypes.c_void_p]
    for fn in (decode, tiled):
        fn.restype = ctypes.c_int
    return Entries(decode, tiled, generic=True)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def launch_plan(kernel: str, num_tokens: int, n_q: int, n_kv: int, page_size: int,
                pages_per_seq: int, max_seqs: int, sms: int,
                head_dim: int = 128) -> tuple[tuple[int, ...], int, int]:
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
    o_shape, ml_shape = decode_scratch_shapes(num_tokens, n_q, n_kv, n_splits, head_dim)
    return (*dims, n_splits, per), math.prod(o_shape), math.prod(ml_shape)


@functools.lru_cache(maxsize=None)
def generic_launch_plan(kernel: str, num_tokens: int, n_q: int, n_kv: int, head_dim: int,
                        page_size: int, pages_per_seq: int, max_seqs: int,
                        sms: int) -> tuple[tuple[int, ...], int, int]:
    """:func:`launch_plan` for the generic instance: the head dim follows
    ``n_kv`` in its ints, and its tiled plan takes :func:`generic_tile_m`
    M rows a block."""
    ints, n_o, n_ml = launch_plan(kernel, num_tokens, n_q, n_kv, page_size, pages_per_seq,
                                  max_seqs, sms, head_dim)
    if kernel == "tiled":
        ints = (*ints[:6], *tiled_plan(num_tokens, max_seqs, n_q // n_kv,
                                       generic_tile_m(head_dim)))
    return (*ints[:3], head_dim, *ints[3:]), n_o, n_ml


def launch(entries: Entries, q, kv_pages, kv_lens, page_indices, cu_q_lens, num_seqs, *,
           sm_scale: float, kernel: str, kv_scales=None) -> torch.Tensor:
    """Run ``kernel`` ("decode" or "tiled") from ``entries`` (bound with
    ``int8=kv_scales is not None`` at q's head dim, or by
    :func:`bind_generic` for q's type) on checked operands, on the current
    stream, into a fresh output; the decode plan's scratch is one f32
    allocation here, ``(m, l)`` after ``o``."""
    T, n_q, d = q.shape
    S, pps = page_indices.shape
    n_kv, page, sms = kv_pages.shape[2] // 2, kv_pages.shape[1], sm_count(q.get_device())
    if entries.generic:
        ints, n_o, n_ml = generic_launch_plan(kernel, T, n_q, n_kv, d, page, pps, S, sms)
    else:
        ints, n_o, n_ml = launch_plan(kernel, T, n_q, n_kv, page, pps, S, sms, d)
    out = torch.empty_like(q)
    ptrs = [q.data_ptr(), kv_pages.data_ptr()]
    if kv_scales is not None or entries.generic:
        ptrs.append(None if kv_scales is None else kv_scales.data_ptr())
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


_GENERIC_NAMES = frozenset(GENERIC_INSTANCE_NAMES.values())
# Bound at first use: the fast instances by (int8, head dim), the generic
# one by ("generic", q dtype, int8).
_kernels: dict[tuple, Entries] = {}


def ragged_paged_attention_cuda(
    q, kv_pages, kv_lens, page_indices, cu_q_lens, num_seqs, *, sm_scale: float,
    kv_scales=None, kernel: str | None = None,
) -> torch.Tensor:
    """Launch a hand-written Hopper kernel on the current stream: the
    instance :func:`k1_instance` names for q's type, the page type (int8
    when ``kv_scales`` is given), the head dim and the group (a fast one, or
    the generic one; what neither runs raises ``ValueError``); ``kernel``
    ("decode" or "tiled") picks the kernel, None the one :func:`kernel_for`
    picks from the shapes."""
    if not q.is_cuda:
        raise ValueError("ragged_paged_attention_cuda needs CUDA tensors")
    kernel = kernel or kernel_for(q.shape[0], page_indices.shape[0])
    name = _check_cuda_operands(q, kv_pages, kv_lens, page_indices, cu_q_lens, num_seqs,
                                kv_scales, kernel)
    if q.shape[0] == 0:
        return torch.empty_like(q)
    int8, d, generic = kv_scales is not None, q.shape[2], name in _GENERIC_NAMES
    key = ("generic", q.dtype, int8) if generic else (int8, d)
    entries = _kernels.get(key)
    if entries is None:
        entries = _kernels[key] = (
            bind_generic(_build.load("ragged_paged_attention_generic"), q.dtype, int8) if generic
            else bind(_build.load("ragged_paged_attention"), int8, d))
    out = launch(
        entries, q, kv_pages, kv_lens, page_indices, cu_q_lens, num_seqs,
        sm_scale=sm_scale, kv_scales=kv_scales, kernel=kernel,
    )
    kernel_launches[name] += 1
    return out


def ragged_paged_attention(
    q, kv_pages, kv_lens, page_indices, cu_q_lens, num_seqs, *,
    sm_scale: float, kv_scales=None, kernel: str | None = None,
) -> torch.Tensor:
    """Device dispatch: the plain version for CPU tensors, the CUDA kernel
    for CUDA tensors (or an error). ``kv_scales`` selects int8 pages on
    both; ``kernel`` states the form on the card ("decode": one query row
    per sequence, "tiled": chunks of many rows; None: :func:`kernel_for`)."""
    if q.device.type == "cpu":
        return ragged_paged_attention_ref(
            q, kv_pages, kv_lens, page_indices, cu_q_lens, num_seqs,
            sm_scale=sm_scale, kv_scales=kv_scales, kernel=kernel,
        )
    return ragged_paged_attention_cuda(
        q, kv_pages, kv_lens, page_indices, cu_q_lens, num_seqs,
        sm_scale=sm_scale, kv_scales=kv_scales, kernel=kernel,
    )


def sharded_ragged_attention(
    mesh, q, kv_pages, kv_lens, page_indices, cu_q_lens, num_seqs, *,
    sm_scale: float, kv_scales=None, kernel: str | None = None,
) -> torch.Tensor:
    """Ragged attention under tensor parallelism, the JAX function's
    counterpart: each rank holds its query heads and the matching block
    of the combined KV heads (int8 scale pages on the same axis), so it
    runs :func:`ragged_paged_attention` on them with no collective; the
    output holds the rank's heads. ``mesh`` is a
    ``parallel.sharding.Mesh``."""
    n_q, n_kv = q.shape[1], kv_pages.shape[2] // 2
    if n_q % n_kv:
        raise ValueError(f"rank {mesh.rank}: {n_q} query heads over {n_kv} KV heads")
    return ragged_paged_attention(
        q, kv_pages, kv_lens, page_indices, cu_q_lens, num_seqs,
        sm_scale=sm_scale, kv_scales=kv_scales, kernel=kernel,
    )
