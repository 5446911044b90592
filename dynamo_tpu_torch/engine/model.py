"""Llama-family transformer over a paged KV cache, built around ONE ragged
forward for prefill, decode and mixed batches.

Counterpart of ``dynamo_tpu/engine/model.py`` (the dense path). Plain
tensor functions over a parameter dict with the JAX package's names and
layouts, so the JAX params pytree converts leaf for leaf
(``engine/convert.py``):

- ``embed [V, h]``, ``final_norm [h]``, ``lm_head [h, V]`` (untied only);
- ``layers``: stacked ``[L, ...]`` tensors ``attn_norm``, ``mlp_norm``,
  ``wqkv [L, h, q+2kv]`` (fused ``[q | k | v]`` columns), ``bqkv`` (Qwen2
  only), ``wo [L, q, h]``, ``wgu [L, h, 2i]`` (fused ``[gate | up]``),
  ``w_down [L, i, h]``. Weights are ``[in, out]`` so ``x @ w`` is
  ``jnp.dot(x, w)``.

The cache is a TUPLE of per-layer pages ``[n_pages, page_size, 2*n_kv, d]``
with K at even and V at odd combined heads; the last page is the garbage
page that absorbs padded-position writes. JAX's functions are pure and
donate the cache; here :func:`write_kv` scatters the new rows into the
layer's pages IN PLACE, which is what the donation bought there.

Order of operations mirrors the JAX code exactly: products accumulate in
f32 and are cast back to the model dtype at the same points, rms_norm
casts before the weight multiply, rope rotates halves.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.ops.ragged_attention import ragged_paged_attention

Params = dict[str, Any]


def _dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with an f32 result (``jnp.dot(..., preferred_element_type=
    f32)``). bf16 operands on the card accumulate in f32 and return f32
    without an upcast copy of the weight."""
    if x.dtype == torch.float32:
        return x @ w
    if x.is_cuda:
        return torch.mm(x, w, out_dtype=torch.float32)
    return (x @ w).float()


# -- fused-projection layout ------------------------------------------------

def fuse_qkv(wq, wk, wv) -> torch.Tensor:
    """Concatenate ``[q | k | v]`` along the output axis. Inputs
    ``[..., h, out]``."""
    return torch.cat([wq, wk, wv], dim=-1)


def fuse_gu(wg, wu) -> torch.Tensor:
    return torch.cat([wg, wu], dim=-1)


def split_qkv(qkv: torch.Tensor, cfg: ModelConfig):
    """Inverse of :func:`fuse_qkv` on activations ``[T, q+2kv]``."""
    return torch.split(qkv, [cfg.q_size, cfg.kv_size, cfg.kv_size], dim=-1)


def split_gu(gu: torch.Tensor):
    return torch.chunk(gu, 2, dim=-1)


# -- initialization --------------------------------------------------------

def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> Params:
    """Random init from a seeded ``torch.Generator`` on ``device`` (serving
    smoke runs and benchmarks; real weights come through a converter).
    Each stacked weight is filled one layer at a time, so the f32
    transient is one layer's worth, and the fused projections are drawn
    at their fused shapes (random fused == fused random)."""
    if cfg.is_moe:
        raise ValueError("MoE presets are not ported yet (ROADMAP.md A11)")
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = cfg.torch_dtype
    h, i, v, L = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size, cfg.num_layers
    qkv = cfg.q_size + 2 * cfg.kv_size

    def dense(shape, fan_in, stacked=True):
        out = torch.empty(shape, dtype=dt, device=dev)
        for part in (out if stacked else (out,)):
            noise = torch.randn(part.shape, generator=gen, device=dev, dtype=torch.float32)
            part.copy_(noise * fan_in ** -0.5)
        return out

    layers: dict[str, torch.Tensor] = {
        "attn_norm": torch.ones((L, h), dtype=dt, device=dev),
        "mlp_norm": torch.ones((L, h), dtype=dt, device=dev),
        "wqkv": dense((L, h, qkv), h),
        "wo": dense((L, cfg.q_size, h), cfg.q_size),
        "wgu": dense((L, h, 2 * i), h),
        "w_down": dense((L, i, h), i),
    }
    if cfg.attn_qkv_bias:
        layers["bqkv"] = dense((L, qkv), 1)
    params: Params = {
        "embed": dense((v, h), h, stacked=False),
        "layers": layers,
        "final_norm": torch.ones((h,), dtype=dt, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense((h, v), h, stacked=False)
    return params


def init_cache(cfg: ModelConfig, engine: EngineConfig, device="cuda") -> tuple[torch.Tensor, ...]:
    """Combined KV cache: a tuple of per-layer page tensors
    ``[n_pages, page_size, 2*n_kv, d]``; the last page is the garbage page.
    Per-layer tensors hand the attention kernel its own contiguous buffer."""
    if engine.kv_quantized:
        raise ValueError("int8 KV pages are not ported yet (ROADMAP.md A9)")
    shape = (engine.num_kv_blocks + 1, engine.block_size, 2 * cfg.num_kv_heads, cfg.head_dim)
    return tuple(
        torch.zeros(shape, dtype=cfg.torch_dtype, device=torch.device(device))
        for _ in range(cfg.num_layers)
    )


# -- building blocks -------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * weight


def rope_tables(positions: torch.Tensor, d: int, theta: float):
    """(cos, sin) ``[T, d/2]`` f32, computed once per forward."""
    exps = -torch.arange(0, d // 2, dtype=torch.float32, device=positions.device) / (d // 2)
    freqs = torch.pow(theta, exps)
    angles = positions.float()[:, None] * freqs
    return torch.cos(angles), torch.sin(angles)


def rope_apply(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate ``x`` ``[T, n, d]`` by ``[T, d/2]`` tables (halves, not
    interleaved pairs)."""
    cos, sin = cos[:, None, :], sin[:, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def _mlp(x: torch.Tensor, lp: dict) -> torch.Tensor:
    g, u = split_gu(_dot(x, lp["wgu"]))
    act = (F.silu(g) * u).to(x.dtype)
    return _dot(act, lp["w_down"]).to(x.dtype)


def _logits(x: torch.Tensor, params: Params, cfg: ModelConfig) -> torch.Tensor:
    """f32 logits. Tied embeddings contract ``embed [V, h]`` in its stored
    layout (a transposed view, never a copy)."""
    if cfg.tie_embeddings:
        return _dot(x, params["embed"].t())
    return _dot(x, params["lm_head"])


def write_kv(cache_l: torch.Tensor, write_pages, write_offs, kvn: torch.Tensor) -> torch.Tensor:
    """Scatter this step's interleaved K/V rows ``[T, 2*n_kv, d]`` into one
    layer's pages, in place. Indices are int64 tensors."""
    cache_l[write_pages, write_offs] = kvn
    return cache_l


def _interleave_kv(k: torch.Tensor, v: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """[T, kv_size] x2 -> [T, 2*n_kv, d] with K at even, V at odd heads."""
    T = k.shape[0]
    return torch.stack(
        [
            k.reshape(T, cfg.num_kv_heads, cfg.head_dim),
            v.reshape(T, cfg.num_kv_heads, cfg.head_dim),
        ],
        dim=2,
    ).reshape(T, 2 * cfg.num_kv_heads, cfg.head_dim)


def dense_layer(
    x: torch.Tensor,             # [T, h]
    lp: dict,                    # ONE layer's params
    cache_l: torch.Tensor,       # ONE layer's pages (written in place)
    write_pages: torch.Tensor,   # [T] int64
    write_offs: torch.Tensor,    # [T] int64
    kv_lens: torch.Tensor,
    block_tables: torch.Tensor,
    cu_q_lens: torch.Tensor,
    num_seqs: torch.Tensor,
    cfg: ModelConfig,
    rope_cs: tuple[torch.Tensor, torch.Tensor],
    attention=ragged_paged_attention,
) -> torch.Tensor:
    """One transformer block over a ragged token batch: attn-norm → fused
    qkv → rope → page scatter → ragged paged attention → wo → mlp.
    ``attention`` has the operands of :func:`ragged_paged_attention`."""
    T = x.shape[0]
    y = rms_norm(x, lp["attn_norm"], cfg.rms_norm_eps)
    qkv = _dot(y, lp["wqkv"])
    if "bqkv" in lp:  # Qwen2-family qkv bias (fused column order)
        qkv = qkv + lp["bqkv"]
    q, k, v = split_qkv(qkv.to(x.dtype), cfg)
    q = rope_apply(q.reshape(T, cfg.num_heads, cfg.head_dim), *rope_cs)
    k = rope_apply(k.reshape(T, cfg.num_kv_heads, cfg.head_dim), *rope_cs)
    write_kv(cache_l, write_pages, write_offs, _interleave_kv(k.reshape(T, cfg.kv_size), v, cfg))
    attn = attention(
        q, cache_l, kv_lens, block_tables, cu_q_lens, num_seqs,
        sm_scale=cfg.head_dim ** -0.5,
    )
    x = x + _dot(attn.reshape(T, cfg.q_size), lp["wo"]).to(x.dtype)
    return x + _mlp(rms_norm(x, lp["mlp_norm"], cfg.rms_norm_eps), lp)


# -- the unified forward ----------------------------------------------------

def forward_hidden(
    params: Params,
    cache: tuple,
    tokens: torch.Tensor,        # [T] i32
    positions: torch.Tensor,     # [T] i32
    write_pages: torch.Tensor,   # [T] i32 (garbage page for pads)
    write_offs: torch.Tensor,    # [T] i32
    kv_lens: torch.Tensor,       # [S] i32
    block_tables: torch.Tensor,  # [S, pages_per_seq] i32
    cu_q_lens: torch.Tensor,     # [S+1] i32
    num_seqs: torch.Tensor,      # [1] i32
    cfg: ModelConfig,
    attention=ragged_paged_attention,
) -> torch.Tensor:
    """The transformer stack up to the final norm: hidden states [T, h].
    The cache is written in place."""
    x = params["embed"][tokens.long()]
    rope_cs = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    wp, wo = write_pages.long(), write_offs.long()
    layers = params["layers"]
    for l in range(cfg.num_layers):
        lp = {name: w[l] for name, w in layers.items()}
        x = dense_layer(
            x, lp, cache[l], wp, wo, kv_lens, block_tables, cu_q_lens,
            num_seqs, cfg, rope_cs, attention,
        )
    return rms_norm(x, params["final_norm"], cfg.rms_norm_eps)


def forward_tokens(
    params: Params,
    cache: tuple,
    tokens: torch.Tensor,
    positions: torch.Tensor,
    write_pages: torch.Tensor,
    write_offs: torch.Tensor,
    kv_lens: torch.Tensor,
    block_tables: torch.Tensor,
    cu_q_lens: torch.Tensor,
    num_seqs: torch.Tensor,
    last_rows: torch.Tensor,     # [S] — row of each sequence's last token
    cfg: ModelConfig,
    attention=ragged_paged_attention,
) -> torch.Tensor:
    """One step over every scheduled token: last-token logits [S, V] f32.
    Prefill chunks, decode tokens and mixed batches are all this call."""
    x = forward_hidden(
        params, cache, tokens, positions, write_pages, write_offs,
        kv_lens, block_tables, cu_q_lens, num_seqs, cfg, attention,
    )
    return _logits(x[last_rows.long()], params, cfg)


def decode_tokens(
    params: Params,
    cache: tuple,
    tokens: torch.Tensor,        # [B] i32 — one new token per sequence
    block_tables: torch.Tensor,  # [B, pages_per_seq] i32
    positions: torch.Tensor,     # [B] i32 — position of `tokens`
    active: torch.Tensor,        # [B] bool
    cfg: ModelConfig,
    engine: EngineConfig,
) -> torch.Tensor:
    """Pure-decode step: B sequences of one token each, assembled on the
    device so a megastep advances positions without the host. Inactive
    lanes write the garbage block and keep ``kv_lens = 1``."""
    B = tokens.shape[0]
    bs = engine.block_size
    dev = tokens.device
    page = torch.gather(block_tables, 1, (positions // bs).long()[:, None])[:, 0]
    write_pages = torch.where(active, page, engine.garbage_block)
    write_offs = positions % bs
    kv_lens = torch.where(active, positions + 1, 1).to(torch.int32)
    cu = torch.arange(B + 1, dtype=torch.int32, device=dev)
    num_seqs = torch.full((1,), B, dtype=torch.int32, device=dev)
    rows = torch.arange(B, device=dev)
    return forward_tokens(
        params, cache, tokens, positions, write_pages, write_offs,
        kv_lens, block_tables, cu, num_seqs, rows, cfg,
    )
