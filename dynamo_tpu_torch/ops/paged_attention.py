"""Paged attention for decode: one new query token per sequence attends
over that sequence's KV blocks, scattered through a head-major flat cache.

Counterpart of ``dynamo_tpu/ops/paged_attention.py`` with the same
operands and semantics:

- ``q``: ``[B, n_q, d]``;
- ``k_cache``, ``v_cache``: ``[n_kv, total_slots, d]`` with
  ``slot = block * block_size + offset``;
- ``block_tables``: ``[B, max_blocks]`` i32 (padding points at a garbage
  block); ``seq_lens``: ``[B]`` i32, cached tokens WITHOUT the self
  position;
- optional ``k_self``/``v_self`` ``[B, n_kv, d]``: the current token's K/V,
  attended as one extra, always-valid position;
- optional ``k_scale``/``v_scale`` ``[n_kv, total_slots]`` f32: int8 caches,
  ``k ~= k_cache * k_scale[..., None]``.

:func:`paged_attention` dispatches on the tensors' device: CPU tensors take
the plain PyTorch version :func:`paged_attention_reference`, CUDA tensors
launch the hand-written kernel ``csrc/paged_attention.cu`` or raise. The
JAX dispatcher's ``DYNAMO_TPU_PAGED_ATTN`` knob, which picks between
XLA's gather path and the Pallas kernel on a TPU, is not carried over:
the device of the tensors decides, and nothing falls back.

The kernel splits each block table into chunks of whole pages (grid
``(B, n_kv, n_splits)``) and merges the chunks' f32 partials in a combine
kernel. :func:`paged_split_plan` picks the chunks and :func:`launch_plan`
caches the C entry point's int arguments per shape; both are plain Python
so the CPU tests reach them. :func:`paged_attention_split_ref` is the plain
version of the split-and-combine arithmetic (tests only).

As in the JAX package, nothing in the engine calls this op: its callers
are the int8-page against bf16-page decode-attention comparison and the
tests. The engine's attention is ``ops/ragged_attention.py``.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from dynamo_tpu_torch.engine.kv_quant import dequantize_kv
from dynamo_tpu_torch.ops import _build
from dynamo_tpu_torch.ops.ragged_attention import sm_count

_NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)

# The kernel's fixed geometry (csrc/paged_attention.cu).
KERNEL_HEAD_DIM = 128
KERNEL_MAX_GROUP = 8
KERNEL_Q_DTYPES = (torch.float32, torch.bfloat16)
KERNEL_MAX_SPLIT_PAGES = 1024  # table entries one split holds in shared memory
# The split plan, from timings on an H100 (PERF.md): splits of about
# SPLIT_POSITIONS cache positions, and at most MAX_SPLIT_BLOCKS_PER_SM
# blocks per SM if every row were full.
SPLIT_POSITIONS = 480
MAX_SPLIT_BLOCKS_PER_SM = 32

# Kernel launches since the last reset, bf16 pages and int8 pages apart:
# the wrapper adds one per launch and nowhere else.
launches = 0
launches_int8 = 0


def paged_attention_reference(
    q: torch.Tensor,             # [B, n_q, d]
    k_cache: torch.Tensor,       # [n_kv, total_slots, d]
    v_cache: torch.Tensor,       # [n_kv, total_slots, d]
    block_tables: torch.Tensor,  # [B, max_blocks] i32
    seq_lens: torch.Tensor,      # [B] i32, cached tokens (excl. self)
    *,
    block_size: int,
    scale: float | None = None,
    k_self: torch.Tensor | None = None,   # [B, n_kv, d]
    v_self: torch.Tensor | None = None,
    k_scale: torch.Tensor | None = None,  # [n_kv, total_slots] f32 (int8)
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:               # [B, n_q, d]
    """Plain PyTorch version: gathers every sequence's whole table
    (``[n_kv, B, max_blocks * block_size, d]`` in f32), masks past
    ``seq_lens`` and appends the self position, as the JAX reference does."""
    B, n_q, d = q.shape
    n_kv = k_cache.shape[0]
    group = n_q // n_kv
    S = block_tables.shape[1] * block_size
    scale = scale if scale is not None else d ** -0.5

    offsets = torch.arange(block_size, dtype=torch.long, device=q.device)
    slots = (block_tables.long()[:, :, None] * block_size + offsets).reshape(B, S)
    k = k_cache[:, slots]  # [n_kv, B, S, d]
    v = v_cache[:, slots]
    if k_scale is not None:
        k = dequantize_kv(k, k_scale[:, slots])
        v = dequantize_kv(v, v_scale[:, slots])

    qg = q.reshape(B, n_kv, group, d).float()
    logits = torch.einsum("bhgd,hbsd->bhgs", qg, k.float()) * scale
    mask = torch.arange(S, device=q.device)[None, :] < seq_lens.long()[:, None]
    logits = torch.where(mask[:, None, None, :], logits, torch.full_like(logits, _NEG_INF))
    vf = v.float()
    if k_self is not None:
        s_self = torch.einsum("bhgd,bhd->bhg", qg, k_self.float()) * scale
        logits = torch.cat([logits, s_self[..., None]], dim=-1)
        vf = torch.cat([vf, v_self.float().transpose(0, 1)[:, :, None, :]], dim=2)
    weights = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgs,hbsd->bhgd", weights, vf)
    return out.reshape(B, n_q, d).to(q.dtype)


def paged_split_plan(batch: int, n_kv: int, max_blocks: int, block_size: int,
                     sm_count: int) -> tuple[int, int]:
    """``(n_splits, pages_per_split)`` of the kernel's grid
    ``(B, n_kv, n_splits)``: splits of whole pages, about
    ``SPLIT_POSITIONS`` positions each (a table that short is one split:
    the block writes the output, with no partials and no combine), but no
    more splits than ``MAX_SPLIT_BLOCKS_PER_SM`` blocks per SM if every row
    were full, and at most ``KERNEL_MAX_SPLIT_PAGES`` pages each; the
    splits cover the block table and each starts inside it."""
    pairs = max(1, batch * n_kv)
    most = -(-MAX_SPLIT_BLOCKS_PER_SM * sm_count // pairs)
    want = -(-max_blocks * block_size // SPLIT_POSITIONS)
    return _whole_pages(max_blocks, max(1, min(want, most)))


def _whole_pages(max_blocks: int, n_splits: int) -> tuple[int, int]:
    """About ``n_splits`` chunks of equal whole pages that cover the table,
    none empty (at most ``n_splits`` unless a chunk would pass
    ``KERNEL_MAX_SPLIT_PAGES`` pages)."""
    per = min(-(-max_blocks // n_splits), KERNEL_MAX_SPLIT_PAGES)
    return -(-max_blocks // per), per


def paged_scratch_shapes(batch: int, n_q: int, n_kv: int,
                         n_splits: int) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """Shapes of the kernel's f32 partials: ``o`` and ``(m, l)`` of every
    (sequence, kv head, split, group head)."""
    head = (batch, n_kv, n_splits, n_q // n_kv)
    return (*head, KERNEL_HEAD_DIM), (*head, 2)


@functools.lru_cache(maxsize=None)
def launch_plan(batch: int, n_q: int, n_kv: int, block_size: int, max_blocks: int,
                sms: int, n_splits: int | None = None) -> tuple[tuple[int, ...], int, int]:
    """What the C entry point takes besides pointers, worked out once per
    shape: its int arguments (the dims, then the plan), and the f32 counts
    of the ``o`` and ``(m, l)`` partials (0 when one split writes the
    output directly). ``n_splits`` forces the split count (at most that
    many chunks of whole pages) in place of :func:`paged_split_plan`."""
    if n_splits is None:
        n, per = paged_split_plan(batch, n_kv, max_blocks, block_size, sms)
    elif n_splits < 1:
        raise ValueError(f"n_splits must be >= 1, got {n_splits}")
    else:
        n, per = _whole_pages(max_blocks, n_splits)
    ints = (batch, n_q, n_kv, block_size, max_blocks, n, per)
    if n == 1:
        return ints, 0, 0
    o_shape, ml_shape = paged_scratch_shapes(batch, n_q, n_kv, n)
    return ints, math.prod(o_shape), math.prod(ml_shape)


def paged_attention_split_ref(
    q, k_cache, v_cache, block_tables, seq_lens, *, block_size: int, n_splits: int,
    pages_per_split: int, scale: float | None = None, k_self=None, v_self=None,
    k_scale=None, v_scale=None,
) -> torch.Tensor:
    """Plain version of the kernel's split-and-combine arithmetic on the same
    plan: each split's partial ``(m, l, o)`` over its chunk of the visible
    positions, the log-sum-exp merge of the splits that hold one, the self
    position folded in once, ``acc / max(l, 1e-30)``. A sequence with no
    visible position and no self position is zeros (the kernel's rule; the
    reference averages over the masked span). Tests only: nothing on the
    op's path calls it."""
    B, n_q, d = q.shape
    n_kv = k_cache.shape[0]
    group = n_q // n_kv
    max_blocks = block_tables.shape[1]
    if n_splits * pages_per_split < max_blocks:
        raise ValueError(f"{n_splits} splits of {pages_per_split} pages miss the table's {max_blocks}")
    split_len = pages_per_split * block_size
    span = n_splits * split_len
    scale = scale if scale is not None else d ** -0.5
    n_vis = seq_lens.long().clamp(0, max_blocks * block_size)

    # The table padded with its own last entry to the plan's span.
    pages = block_tables.long()
    pages = torch.cat([pages, pages[:, -1:].expand(B, span // block_size - max_blocks)], dim=1)
    offs = torch.arange(block_size, dtype=torch.long, device=q.device)
    slots = (pages[:, :, None] * block_size + offs).reshape(B, span)
    k, v = k_cache[:, slots], v_cache[:, slots]                       # [n_kv, B, span, d]
    if k_scale is not None:
        k = dequantize_kv(k, k_scale[:, slots])
        v = dequantize_kv(v, v_scale[:, slots])
    k = k.float().reshape(n_kv, B, n_splits, split_len, d)
    v = v.float().reshape(n_kv, B, n_splits, split_len, d)
    qg = q.reshape(B, n_kv, group, d).float()
    s = torch.einsum("bhgd,hbcpd->bchgp", qg, k) * scale               # [B, c, h, g, p]
    pos = torch.arange(span, device=q.device).reshape(n_splits, split_len)
    seen = pos[None] < n_vis[:, None, None]                             # [B, c, p]
    s = s.masked_fill(~seen[:, :, None, None, :], float("-inf"))

    # Partials per split; a split with no visible position has l = 0.
    has = seen.any(dim=-1)[:, :, None, None]                            # [B, c, 1, 1]
    m = s.amax(dim=-1).masked_fill(~has, 0.0)                           # [B, c, h, g]
    p = torch.exp(s - m[..., None])
    l_part = p.sum(dim=-1)
    o_part = torch.einsum("bchgp,hbcpd->bchgd", p, v)
    # Merge by log-sum-exp over the splits that hold a position, then self.
    m_all = m.masked_fill(~has, float("-inf")).amax(dim=1)              # [B, h, g]
    if k_self is not None:
        s_self = torch.einsum("bhgd,bhd->bhg", qg, k_self.float()) * scale
        m_all = torch.maximum(m_all, s_self)
    m_all = torch.nan_to_num(m_all, neginf=0.0)                        # nothing at all
    w = torch.where(has, torch.exp(m - m_all[:, None]), 0.0)
    num = (w[..., None] * o_part).sum(dim=1)                            # [B, h, g, d]
    den = (w * l_part).sum(dim=1)
    if k_self is not None:
        p_self = torch.exp(s_self - m_all)
        num = num + p_self[..., None] * v_self.float()[:, :, None, :]
        den = den + p_self
    out = num / den.clamp(min=1e-30)[..., None]
    return out.reshape(B, n_q, d).to(q.dtype)


def kernel_supported(q_dtype, page_dtype, head_dim: int, group: int) -> bool:
    """What the CUDA kernel takes (the port of the JAX ``pallas_supported``,
    which checks TPU tiling): head_dim 128, a GQA group of at most 8, q in
    f32 or bf16, pages in bf16 or int8."""
    return (
        head_dim == KERNEL_HEAD_DIM
        and 1 <= group <= KERNEL_MAX_GROUP
        and q_dtype in KERNEL_Q_DTYPES
        and page_dtype in (torch.bfloat16, torch.int8)
    )


def _check_cuda_operands(q, k_cache, v_cache, block_tables, seq_lens, k_self, v_self,
                         k_scale, v_scale) -> None:
    if q.dim() != 3 or k_cache.dim() != 3 or v_cache.shape != k_cache.shape:
        raise ValueError(
            f"q must be [B, n_q, d] and k_cache/v_cache one [n_kv, total_slots, d], "
            f"got {tuple(q.shape)} / {tuple(k_cache.shape)} / {tuple(v_cache.shape)}"
        )
    B, n_q, d = q.shape
    n_kv = k_cache.shape[0]
    if k_cache.shape[2] != d or n_q % n_kv:
        raise ValueError(f"head layout: q {tuple(q.shape)}, caches {tuple(k_cache.shape)}")
    quant = k_scale is not None
    if (v_scale is not None) != quant or (v_self is None) != (k_self is None):
        raise ValueError("k_scale/v_scale and k_self/v_self come in pairs")
    page_dtype = torch.int8 if quant else torch.bfloat16
    if k_cache.dtype != page_dtype or v_cache.dtype != page_dtype:
        raise TypeError(
            f"paged_attention kernel takes {page_dtype} pages "
            f"{'with' if quant else 'without'} scales, got {k_cache.dtype} / {v_cache.dtype}"
        )
    if not kernel_supported(q.dtype, page_dtype, d, n_q // n_kv):
        raise ValueError(
            f"the CUDA kernel takes head_dim {KERNEL_HEAD_DIM}, a GQA group <= "
            f"{KERNEL_MAX_GROUP} and f32 or bf16 q; got d={d}, group={n_q // n_kv}, {q.dtype}"
        )
    if block_tables.dim() != 2 or block_tables.shape[0] != B or seq_lens.shape != (B,):
        raise ValueError(
            f"block_tables must be [B, max_blocks] and seq_lens [B], got "
            f"{tuple(block_tables.shape)} / {tuple(seq_lens.shape)}"
        )
    for name, a in (("block_tables", block_tables), ("seq_lens", seq_lens)):
        if a.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {a.dtype}")
    if quant:
        for name, a in (("k_scale", k_scale), ("v_scale", v_scale)):
            if a.dtype != torch.float32 or a.shape != k_cache.shape[:2]:
                raise ValueError(f"{name} must be f32 [n_kv, total_slots], got {a.dtype} {tuple(a.shape)}")
    if k_self is not None:
        for name, a in (("k_self", k_self), ("v_self", v_self)):
            if a.shape != (B, n_kv, d) or not a.is_floating_point() or a.device != q.device:
                raise ValueError(
                    f"{name} must be a float [B, n_kv, d] on {q.device}, got "
                    f"{a.dtype} {tuple(a.shape)} on {a.device}"
                )
    named = [("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
             ("block_tables", block_tables), ("seq_lens", seq_lens),
             ("k_scale", k_scale), ("v_scale", v_scale)]
    for name, a in named:
        if a is None:
            continue
        if a.device != q.device:
            raise ValueError(f"{name} is on {a.device}, q on {q.device}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if a.data_ptr() % 16 and name in ("q", "k_cache", "v_cache"):  # 16-byte copies
            raise ValueError(f"{name} must be 16-byte aligned")


def bind(lib: ctypes.CDLL):
    """The C entry point of a built ``paged_attention.cu``, typed."""
    fn = lib.paged_attention_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 7 + [ctypes.c_longlong] + [
        ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_void_p]
    return fn


_kernel = None  # bound once, at the first CUDA call


def launch(fn, q, k_cache, v_cache, block_tables, seq_lens, *, block_size: int,
           scale: float | None = None, k_self=None, v_self=None, k_scale=None,
           v_scale=None, n_splits: int | None = None) -> torch.Tensor:
    """Run the C entry point ``fn`` on checked operands, on the current
    stream, into a fresh output; the plan's scratch is one f32 allocation
    here, ``(m, l)`` after ``o``. The self rows go to the kernel in f32."""
    B, n_q, d = q.shape
    ints, n_o, n_ml = launch_plan(B, n_q, k_cache.shape[0], block_size, block_tables.shape[1],
                                  sm_count(q.get_device()), n_splits)
    out = torch.empty_like(q)
    part = (None, None)
    if n_o:
        scratch = torch.empty(n_o + n_ml, dtype=torch.float32, device=q.device)
        part = (scratch.data_ptr(), scratch.data_ptr() + 4 * n_o)
    if k_self is not None:
        k_self = k_self.float().contiguous()
        v_self = v_self.float().contiguous()
    ptr = lambda a: None if a is None else a.data_ptr()  # noqa: E731
    rc = fn(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), ptr(k_scale), ptr(v_scale),
        ptr(k_self), ptr(v_self), block_tables.data_ptr(), seq_lens.data_ptr(),
        out.data_ptr(), *part, *ints, k_cache.shape[1], int(q.dtype == torch.bfloat16),
        int(k_scale is not None), float(scale if scale is not None else d ** -0.5),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA error {rc}")
    return out


def paged_attention_cuda(q, k_cache, v_cache, block_tables, seq_lens, *, block_size: int,
                         scale=None, k_self=None, v_self=None, k_scale=None,
                         v_scale=None, n_splits: int | None = None) -> torch.Tensor:
    """Launch the hand-written Hopper kernel on the current stream
    (``n_splits`` forces the split count; default: :func:`paged_split_plan`)."""
    global launches, launches_int8, _kernel
    if not q.is_cuda:
        raise ValueError("paged_attention_cuda needs CUDA tensors")
    _check_cuda_operands(q, k_cache, v_cache, block_tables, seq_lens, k_self, v_self,
                         k_scale, v_scale)
    if _kernel is None:
        _kernel = bind(_build.load("paged_attention"))
    out = launch(
        _kernel, q, k_cache, v_cache, block_tables, seq_lens, block_size=block_size,
        scale=scale, k_self=k_self, v_self=v_self, k_scale=k_scale, v_scale=v_scale,
        n_splits=n_splits,
    )
    if k_scale is not None:
        launches_int8 += 1
    else:
        launches += 1
    return out


def paged_attention(q, k_cache, v_cache, block_tables, seq_lens, *, block_size: int,
                    scale=None, k_self=None, v_self=None, k_scale=None,
                    v_scale=None) -> torch.Tensor:
    """Device dispatch: the plain version for CPU tensors, the CUDA kernel
    for CUDA tensors (or an error)."""
    fn = paged_attention_reference if q.device.type == "cpu" else paged_attention_cuda
    return fn(
        q, k_cache, v_cache, block_tables, seq_lens, block_size=block_size, scale=scale,
        k_self=k_self, v_self=v_self, k_scale=k_scale, v_scale=v_scale,
    )
