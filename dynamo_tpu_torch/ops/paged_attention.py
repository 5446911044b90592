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

As in the JAX package, nothing in the engine calls this op: its callers
are the int8-page against bf16-page decode-attention comparison and the
tests. The engine's attention is ``ops/ragged_attention.py``.
"""

from __future__ import annotations

import ctypes

import torch

from dynamo_tpu_torch.engine.kv_quant import dequantize_kv
from dynamo_tpu_torch.ops import _build

_NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)

# The kernel's fixed geometry (csrc/paged_attention.cu).
KERNEL_HEAD_DIM = 128
KERNEL_MAX_GROUP = 8
KERNEL_Q_DTYPES = (torch.float32, torch.bfloat16)

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


def bind(lib: ctypes.CDLL):
    """The C entry point of a built ``paged_attention.cu``, typed."""
    fn = lib.paged_attention_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3 + [ctypes.c_longlong] + [
        ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    return fn


_kernel = None  # bound once, at the first CUDA call


def launch(fn, q, k_cache, v_cache, block_tables, seq_lens, *, block_size: int,
           scale: float | None = None, k_self=None, v_self=None, k_scale=None,
           v_scale=None) -> torch.Tensor:
    """Run the C entry point ``fn`` on checked operands, on the current
    stream, into a fresh output. The self rows go to the kernel in f32."""
    out = torch.empty_like(q)
    if k_self is not None:
        k_self = k_self.float().contiguous()
        v_self = v_self.float().contiguous()
    ptr = lambda a: None if a is None else a.data_ptr()  # noqa: E731
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    rc = fn(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), ptr(k_scale), ptr(v_scale),
        ptr(k_self), ptr(v_self), block_tables.data_ptr(), seq_lens.data_ptr(),
        out.data_ptr(), q.shape[0], q.shape[1], k_cache.shape[0], k_cache.shape[1],
        block_size, block_tables.shape[1], int(q.dtype == torch.bfloat16),
        int(k_scale is not None), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA error {rc}")
    return out


def paged_attention_cuda(q, k_cache, v_cache, block_tables, seq_lens, *, block_size: int,
                         scale=None, k_self=None, v_self=None, k_scale=None,
                         v_scale=None) -> torch.Tensor:
    """Launch the hand-written Hopper kernel on the current stream."""
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
