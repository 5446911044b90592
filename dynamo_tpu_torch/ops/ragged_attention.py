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

Query token ``i`` of sequence ``s`` sits at ``kv_lens[s] - q_len_s + i``
and attends every cache position ``<=`` its own.

:func:`ragged_paged_attention` dispatches on the tensors' device: CPU
tensors take the plain PyTorch version :func:`ragged_paged_attention_ref`
(the tests), CUDA tensors launch the hand-written kernel
``csrc/ragged_paged_attention.cu`` or raise. Nothing falls back.
"""

from __future__ import annotations

import ctypes

import torch

from dynamo_tpu_torch.ops import _build

_NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)

# The kernel's fixed geometry (csrc/ragged_paged_attention.cu).
KERNEL_HEAD_DIM = 128
KERNEL_MAX_GROUP = 8

# Kernel launches since the last reset: the wrapper adds one per launch
# and nowhere else, so a run can show which path it took.
launches = 0


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
    ``[T, pages_per_seq * page_size, 2*n_kv, d]`` in f32)."""
    if kv_scales is not None:
        raise NotImplementedError(
            "int8 KV pages (kv_scales) are not ported yet (ROADMAP.md A9)"
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
    kvf = flat[slots].float()                              # [T, span, 2*n_kv, d]
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


def _check_cuda_operands(q, kv_pages, kv_lens, page_indices, cu_q_lens, num_seqs):
    dev = q.device
    if q.dtype != torch.bfloat16 or kv_pages.dtype != torch.bfloat16:
        raise TypeError(
            f"ragged_paged_attention kernel takes bf16 q and pages, got "
            f"{q.dtype} / {kv_pages.dtype}"
        )
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


def bind(lib: ctypes.CDLL):
    """The C entry point of a built ``ragged_paged_attention.cu``, typed."""
    fn = lib.ragged_paged_attention_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_void_p,
    ]
    return fn


_kernel = None  # bound once, at the first CUDA call


def launch(fn, q, kv_pages, kv_lens, page_indices, cu_q_lens, num_seqs, *,
           sm_scale: float) -> torch.Tensor:
    """Run the C entry point ``fn`` on checked operands, on the current
    stream, into a fresh output."""
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(
        q.data_ptr(), kv_pages.data_ptr(), kv_lens.data_ptr(),
        page_indices.data_ptr(), cu_q_lens.data_ptr(), num_seqs.data_ptr(),
        out.data_ptr(), q.shape[0], q.shape[1], kv_pages.shape[2] // 2,
        kv_pages.shape[1], page_indices.shape[1], page_indices.shape[0],
        float(sm_scale), stream,
    )
    if rc != 0:
        raise RuntimeError(f"ragged_paged_attention kernel launch failed: CUDA error {rc}")
    return out


def ragged_paged_attention_cuda(
    q, kv_pages, kv_lens, page_indices, cu_q_lens, num_seqs, *, sm_scale: float,
) -> torch.Tensor:
    """Launch the hand-written Hopper kernel on the current stream."""
    global launches, _kernel
    if not q.is_cuda:
        raise ValueError("ragged_paged_attention_cuda needs CUDA tensors")
    _check_cuda_operands(q, kv_pages, kv_lens, page_indices, cu_q_lens, num_seqs)
    if q.shape[0] == 0:
        return torch.empty_like(q)
    if _kernel is None:
        _kernel = bind(_build.load("ragged_paged_attention"))
    out = launch(
        _kernel, q, kv_pages, kv_lens, page_indices, cu_q_lens, num_seqs,
        sm_scale=sm_scale,
    )
    launches += 1
    return out


def ragged_paged_attention(
    q, kv_pages, kv_lens, page_indices, cu_q_lens, num_seqs, *,
    sm_scale: float, kv_scales=None,
) -> torch.Tensor:
    """Device dispatch: the plain version for CPU tensors, the CUDA kernel
    for CUDA tensors (or an error). ``kv_scales`` (int8 pages) is refused
    on both until the int8 slice lands."""
    if q.device.type == "cpu":
        return ragged_paged_attention_ref(
            q, kv_pages, kv_lens, page_indices, cu_q_lens, num_seqs,
            sm_scale=sm_scale, kv_scales=kv_scales,
        )
    if kv_scales is not None:
        raise NotImplementedError(
            "int8 KV pages (kv_scales) are not ported yet (ROADMAP.md A9)"
        )
    return ragged_paged_attention_cuda(
        q, kv_pages, kv_lens, page_indices, cu_q_lens, num_seqs,
        sm_scale=sm_scale,
    )
