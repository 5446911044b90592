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
- MoE presets (Mixtral-style) replace ``wgu``/``w_down`` with
  ``w_router [L, h, E]`` and the expert stacks ``w_gate``/``w_up
  [L, E, h, i]`` and ``w_down [L, E, i, h]`` (:func:`_moe_mlp`).
- int8 weight-only quantization (``quant="int8"``): the projections and
  ``lm_head`` become ``{"w": int8, "scale": f32 [..., 1, out]}`` leaves,
  per output channel (:func:`quantize_weight`); embeddings, norms and
  biases stay in the model dtype.

The cache is a TUPLE of per-layer pages ``[n_pages, page_size, 2*n_kv, d]``
with K at even and V at odd combined heads; the last page is the garbage
page that absorbs padded-position writes. With ``kv_dtype="int8"`` each
element is ``{"kv": int8 pages, "scale": f32 [n_pages, page_size, 2*n_kv]}``
(``engine/kv_quant.py``). JAX's functions are pure and donate the cache;
here :func:`write_kv` scatters the new rows into the layer's pages IN
PLACE, which is what the donation bought there.

Order of operations mirrors the JAX code exactly: products accumulate in
f32 and are cast back to the model dtype at the same points, rms_norm
casts before the weight multiply, rope rotates halves.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.kv_quant import INV_127, quantize_kv
from dynamo_tpu_torch.ops.ragged_attention import ragged_paged_attention

Params = dict[str, Any]


# -- int8 weight-only quantization ------------------------------------------

def quantize_weight(w: torch.Tensor) -> dict[str, torch.Tensor]:
    """Per-output-channel symmetric int8: ``w ~= w_int8 * scale[out]``,
    amax over the input axis (-2). The arithmetic of the JAX function as
    XLA compiles it (``/ 127`` as a product with ``f32(1/127)``)."""
    w32 = w.float()
    scale = w32.abs().amax(dim=-2, keepdim=True) * INV_127
    scale = torch.clamp_min(scale, 1e-8)
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return {"w": q, "scale": scale}


def _dot(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` with an f32 result (``jnp.dot(..., preferred_element_type=
    f32)``). bf16 operands on the card accumulate in f32 and return f32
    without an upcast copy of the weight; on the CPU, which has no such
    product, they are upcast (exact) and multiplied in f32, so the result
    is not rounded to bf16 before it is returned, as in JAX. An int8 ``{w, scale}`` leaf is
    cast to ``x``'s dtype and its product scaled per output column, as in
    JAX (a plain matrix product, left to ``torch.matmul``)."""
    if isinstance(w, dict):
        return _dot(x, w["w"].to(x.dtype)) * w["scale"].reshape(1, -1)
    if x.dtype == torch.float32:
        return x @ w
    if x.is_cuda:
        return torch.mm(x, w, out_dtype=torch.float32)
    return x.float() @ w.float()


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
    at their fused shapes (random fused == fused random). A MoE preset's
    expert stacks are drawn one layer at a time too (for Mixtral-8x7B the
    f32 transient of one layer's ``[8, 4096, 14336]`` is 1.88 GB)."""
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
    }
    if cfg.is_moe:
        E = cfg.num_experts
        layers["w_router"] = dense((L, h, E), h)
        layers["w_gate"] = dense((L, E, h, i), h)
        layers["w_up"] = dense((L, E, h, i), h)
        layers["w_down"] = dense((L, E, i, h), i)
    else:
        layers["wgu"] = dense((L, h, 2 * i), h)
        layers["w_down"] = dense((L, i, h), i)
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


def init_params_quantized(cfg: ModelConfig, seed: int = 0, device="cuda") -> Params:
    """Random init straight into the int8 layout (JAX
    ``init_params_quantized``): each stacked projection is drawn one layer
    at a time at the model dtype, as :func:`init_params` draws it, and
    quantized at once, so the model-dtype transient is one layer's worth.
    Embeddings and norms stay in the model dtype; ``lm_head`` (untied
    only) is quantized too."""
    if cfg.is_moe:
        raise ValueError(
            f"int8 weights for the MoE preset {cfg.name!r} are not served: the JAX "
            "package has no int8 MoE init either (its init_params_quantized raises "
            "for MoE presets)"
        )
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = cfg.torch_dtype
    h, i, v, L = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size, cfg.num_layers
    qkv = cfg.q_size + 2 * cfg.kv_size

    def draw(shape, fan_in):
        noise = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        return (noise * fan_in ** -0.5).to(dt)

    def qdense(shape, fan_in):
        out = {
            "w": torch.empty((L, *shape), dtype=torch.int8, device=dev),
            "scale": torch.empty((L, 1, shape[-1]), dtype=torch.float32, device=dev),
        }
        for l in range(L):
            q = quantize_weight(draw(shape, fan_in))
            out["w"][l].copy_(q["w"])
            out["scale"][l].copy_(q["scale"])
        return out

    layers: dict[str, Any] = {
        "attn_norm": torch.ones((L, h), dtype=dt, device=dev),
        "mlp_norm": torch.ones((L, h), dtype=dt, device=dev),
        "wqkv": qdense((h, qkv), h),
        "wo": qdense((cfg.q_size, h), cfg.q_size),
        "wgu": qdense((h, 2 * i), h),
        "w_down": qdense((i, h), i),
    }
    if cfg.attn_qkv_bias:
        layers["bqkv"] = draw((L, qkv), 1)  # biases stay unquantized
    params: Params = {
        "embed": draw((v, h), h),
        "layers": layers,
        "final_norm": torch.ones((h,), dtype=dt, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = quantize_weight(draw((h, v), h))
    return params


def quantize_params(params: Params) -> Params:
    """int8-quantize the layer projections (wqkv/wo/wgu/w_down) and
    lm_head; embeddings and norms stay in the model dtype. Stacked
    weights are quantized one layer at a time (the f32 transient is one
    layer's), which gives the scales of the whole-tensor JAX call."""
    out = dict(params)
    layers = dict(params["layers"])
    for k in ("wqkv", "wo", "wgu", "w_down"):
        if k in layers and not isinstance(layers[k], dict):
            per_layer = [quantize_weight(w) for w in layers[k]]
            layers[k] = {
                name: torch.stack([q[name] for q in per_layer]) for name in ("w", "scale")
            }
    out["layers"] = layers
    if "lm_head" in params and not isinstance(params["lm_head"], dict):
        out["lm_head"] = quantize_weight(params["lm_head"])
    return out


def init_cache(cfg: ModelConfig, engine: EngineConfig, device="cuda") -> tuple:
    """Combined KV cache: a tuple of per-layer page tensors
    ``[n_pages, page_size, 2*n_kv, d]``; the last page is the garbage page.
    Per-layer tensors hand the attention kernel its own contiguous buffer.
    With ``engine.kv_dtype == "int8"`` each layer is instead
    ``{"kv": int8 pages, "scale": f32 [n_pages, page_size, 2*n_kv]}``."""
    dev = torch.device(device)
    shape = (engine.num_kv_blocks + 1, engine.block_size, 2 * cfg.num_kv_heads, cfg.head_dim)
    if engine.kv_quantized:
        return tuple(
            {
                "kv": torch.zeros(shape, dtype=torch.int8, device=dev),
                "scale": torch.zeros(shape[:-1], dtype=torch.float32, device=dev),
            }
            for _ in range(cfg.num_layers)
        )
    return tuple(
        torch.zeros(shape, dtype=cfg.torch_dtype, device=dev)
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


def _mlp(x: torch.Tensor, lp: dict, cfg: ModelConfig) -> torch.Tensor:
    if cfg.is_moe:
        return _moe_mlp(x, lp, cfg)
    g, u = split_gu(_dot(x, lp["wgu"]))
    act = (F.silu(g) * u).to(x.dtype)
    return _dot(act, lp["w_down"]).to(x.dtype)


def _bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched ``a @ b`` with an f32 result (``jnp.einsum(...,
    preferred_element_type=f32)``), as :func:`_dot` for one product."""
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a, b).float()


def _moe_capacity(N: int, cfg: ModelConfig) -> int:
    """Per-expert token capacity for a dispatch of N tokens (static)."""
    k, E = cfg.num_experts_per_tok, cfg.num_experts
    return max(1, min(N, int(-(-N * k * cfg.moe_capacity_factor // E))))


def _moe_dispatch_local(xf, w_router, w_gate, w_up, w_down, cfg: ModelConfig) -> torch.Tensor:
    """Sparse top-k MoE over every expert on one device: capacity-bounded
    gather/scatter dispatch, each expert a dense ``[C, h]`` batch of its
    assigned tokens. The JAX function's semantics exactly (its expert
    slice of a mesh shard waits for A12):

    - C comes from N, the forward's padded width (bucket padding rows
      route and take slots too);
    - entries are ordered token-major, top-k rank minor, and an entry's
      slot is its rank among the entries of its expert;
    - ``keep = pos < C``: an entry past its expert's capacity is dropped
      and adds zero (it lands in a garbage row);
    - the top-k values go through a softmax in f32, SiLU runs on f32
      products, and the combine adds in f32 and casts at the end.

    Every shape is static (no ``nonzero``, no boolean-mask indexing, no
    host read), so the dispatch captures into a CUDA graph. Ties among
    router logits take the lower expert first, as ``jax.lax.top_k``."""
    N, h = xf.shape
    k, E = cfg.num_experts_per_tok, cfg.num_experts
    C = _moe_capacity(N, cfg)
    dev = xf.device

    router = _dot(xf, w_router)                                   # [N, E] f32
    vals, idx = torch.sort(router, dim=-1, descending=True, stable=True)
    probs = torch.softmax(vals[:, :k], dim=-1)

    flat_e = idx[:, :k].reshape(-1)                               # [N*k] expert ids
    flat_t = torch.arange(N * k, device=dev) // k                  # token of each entry
    oh = (flat_e[:, None] == torch.arange(E, device=dev)[None, :]).to(torch.int32)
    pos = (torch.cumsum(oh, dim=0) * oh).sum(dim=1) - 1           # [N*k]
    keep = pos < C
    # Each kept entry's row in the experts' [E * C, h] batch; a dropped
    # one lands in the garbage row after it (the JAX function's garbage
    # expert row and capacity slot).
    slot = torch.where(keep, flat_e * C + pos, E * C)

    gathered = torch.zeros((E * C + 1, h), dtype=xf.dtype, device=dev)
    gathered[slot] = xf[flat_t]
    g = gathered[: E * C].view(E, C, h)
    gate = _bmm(g, w_gate)                                        # f32
    up = _bmm(g, w_up)
    act = F.silu(gate, inplace=True).mul_(up).to(xf.dtype)
    del gate, up
    down = _bmm(act, w_down).view(E * C, h)                       # f32

    # A dropped entry reads a clamped row and adds zero.
    entry_out = torch.where(keep[:, None], down[slot.clamp(max=E * C - 1)], 0.0)
    w_masked = torch.where(keep, probs.reshape(-1), 0.0)
    out = (w_masked[:, None] * entry_out).reshape(N, k, h).sum(dim=1)
    return out.to(xf.dtype)


def _moe_mlp(x: torch.Tensor, lp: dict, cfg: ModelConfig) -> torch.Tensor:
    """Mixtral-style sparse MoE on one device: softmax over the top-k
    router logits, weighted sum of the expert SwiGLUs
    (:func:`_moe_dispatch_local` over every expert). The JAX function's
    mesh branches (replicated and all-to-all expert parallelism) wait
    for a mesh (``ROADMAP.md`` A12); without one both ``moe_dispatch``
    values are this local dispatch, as in JAX."""
    shape = x.shape
    out = _moe_dispatch_local(
        x.reshape(-1, shape[-1]), lp["w_router"], lp["w_gate"], lp["w_up"], lp["w_down"], cfg,
    )
    return out.reshape(shape)


def _logits(x: torch.Tensor, params: Params, cfg: ModelConfig) -> torch.Tensor:
    """f32 logits. Tied embeddings contract ``embed [V, h]`` in its stored
    layout (a transposed view, never a copy)."""
    if cfg.tie_embeddings:
        return _dot(x, params["embed"].t())
    return _dot(x, params["lm_head"])


def write_kv(cache_l, write_pages, write_offs, kvn: torch.Tensor):
    """Scatter this step's interleaved K/V rows ``[T, 2*n_kv, d]`` into one
    layer's pages, in place. Indices are int64 tensors. A quantized
    ``{kv, scale}`` layer quantizes the rows HERE, the one and only
    quantization a row ever sees."""
    if isinstance(cache_l, dict):
        q8, sc = quantize_kv(kvn)
        cache_l["kv"][write_pages, write_offs] = q8
        cache_l["scale"][write_pages, write_offs] = sc
        return cache_l
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
    cache_l,                     # ONE layer's pages or {kv, scale} (in place)
    write_pages: torch.Tensor,   # [T] int64
    write_offs: torch.Tensor,    # [T] int64
    kv_lens: torch.Tensor,
    block_tables: torch.Tensor,
    cu_q_lens: torch.Tensor,
    num_seqs: torch.Tensor,
    cfg: ModelConfig,
    rope_cs: tuple[torch.Tensor, torch.Tensor],
    attention=ragged_paged_attention,
    kernel: str = "tiled",
) -> torch.Tensor:
    """One transformer block over a ragged token batch: attn-norm → fused
    qkv → rope → page scatter → ragged paged attention → wo → mlp.
    ``attention`` has the operands of :func:`ragged_paged_attention`;
    ``kernel`` is the form it is told the batch has ("tiled": chunks of
    many rows, "decode": one query row per sequence)."""
    T = x.shape[0]
    y = rms_norm(x, lp["attn_norm"], cfg.rms_norm_eps)
    qkv = _dot(y, lp["wqkv"])
    if "bqkv" in lp:  # Qwen2-family qkv bias (fused column order)
        qkv = qkv + lp["bqkv"]
    q, k, v = split_qkv(qkv.to(x.dtype), cfg)
    q = rope_apply(q.reshape(T, cfg.num_heads, cfg.head_dim), *rope_cs)
    k = rope_apply(k.reshape(T, cfg.num_kv_heads, cfg.head_dim), *rope_cs)
    write_kv(cache_l, write_pages, write_offs, _interleave_kv(k.reshape(T, cfg.kv_size), v, cfg))
    if isinstance(cache_l, dict):
        kv_pages, kv_scales = cache_l["kv"], cache_l["scale"]
    else:
        kv_pages, kv_scales = cache_l, None
    attn = attention(
        q, kv_pages, kv_lens, block_tables, cu_q_lens, num_seqs,
        sm_scale=cfg.head_dim ** -0.5, kv_scales=kv_scales, kernel=kernel,
    )
    x = x + _dot(attn.reshape(T, cfg.q_size), lp["wo"]).to(x.dtype)
    return x + _mlp(rms_norm(x, lp["mlp_norm"], cfg.rms_norm_eps), lp, cfg)


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
    kernel: str = "tiled",
    mm_embeds: torch.Tensor | None = None,  # [T, h] f32 multimodal rows
    mm_mask: torch.Tensor | None = None,    # [T] bool: rows they replace
) -> torch.Tensor:
    """The transformer stack up to the final norm: hidden states [T, h].
    The cache is written in place; every layer's attention is told
    ``kernel``. ``mm_embeds``/``mm_mask`` override the token-embedding
    rows at multimodal placeholder positions with encoder output
    (``llm/multimodal.py``), as the JAX function's ``want_mm`` variant."""
    x = params["embed"][tokens.long()]
    if mm_embeds is not None:
        x = torch.where(mm_mask[:, None], mm_embeds.to(x.dtype), x)
    rope_cs = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    wp, wo = write_pages.long(), write_offs.long()
    layers = params["layers"]
    for l in range(cfg.num_layers):
        lp = {
            name: {k: t[l] for k, t in w.items()} if isinstance(w, dict) else w[l]
            for name, w in layers.items()
        }
        x = dense_layer(
            x, lp, cache[l], wp, wo, kv_lens, block_tables, cu_q_lens,
            num_seqs, cfg, rope_cs, attention, kernel,
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
    kernel: str = "tiled",
    mm_embeds: torch.Tensor | None = None,
    mm_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """One step over every scheduled token: last-token logits [S, V] f32.
    Prefill chunks, decode tokens and mixed batches are all this call.
    Its attention takes the tiled form unless the caller states that
    every sequence has one query row (``kernel="decode"``,
    :func:`decode_tokens`): a mixed batch's token bucket may equal its row
    count, and its chunks' rows through the decode kernel would be right
    but many times slower."""
    x = forward_hidden(
        params, cache, tokens, positions, write_pages, write_offs,
        kv_lens, block_tables, cu_q_lens, num_seqs, cfg, attention, kernel,
        mm_embeds, mm_mask,
    )
    return _logits(x[last_rows.long()], params, cfg)


def embed_forward(
    params: Params,
    scratch: tuple,              # a scratch paged cache of its own (in place)
    tokens: torch.Tensor,        # [T] i32, one sequence, bucket-padded
    valid: torch.Tensor,         # [T] bool: the prompt's rows
    write_pages: torch.Tensor,   # [T] i32 into the scratch cache (garbage for pads)
    block_tables: torch.Tensor,  # [1, scratch_pages] i32
    cfg: ModelConfig,
    engine: EngineConfig,
    attention=ragged_paged_attention,
) -> torch.Tensor:
    """Causal LLM-as-embedder: one forward over the prompt and masked mean
    pooling of the final-norm hidden states; returns the ``[h]`` f32
    embedding. Bucket-padded rows write the garbage page and sit after
    every valid row, so causal masking keeps them out of the valid rows'
    attention; pooling masks them out of the mean."""
    T = tokens.shape[0]
    dev = tokens.device
    positions = torch.arange(T, dtype=torch.int32, device=dev)
    x = forward_hidden(
        params, scratch, tokens, positions, write_pages, positions % engine.block_size,
        torch.full((1,), T, dtype=torch.int32, device=dev), block_tables,
        torch.tensor([0, T], dtype=torch.int32, device=dev),
        torch.ones(1, dtype=torch.int32, device=dev), cfg, attention,
    )
    w = valid.float()[:, None]
    return (x.float() * w).sum(dim=0) / torch.clamp_min(w.sum(), 1.0)


def decode_tokens(
    params: Params,
    cache: tuple,
    tokens: torch.Tensor,        # [B] i32 — one new token per sequence
    block_tables: torch.Tensor,  # [B, pages_per_seq] i32
    positions: torch.Tensor,     # [B] i32 — position of `tokens`
    active: torch.Tensor,        # [B] bool
    cfg: ModelConfig,
    engine: EngineConfig,
    attention=ragged_paged_attention,
) -> torch.Tensor:
    """Pure-decode step: B sequences of one token each, assembled on the
    device so a megastep advances positions without the host. Inactive
    lanes write the garbage block and keep ``kv_lens = 1``. Its attention
    takes the decode form."""
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
        kv_lens, block_tables, cu, num_seqs, rows, cfg, attention, "decode",
    )


def verify_tokens(
    params: Params,
    cache: tuple,
    tokens: torch.Tensor,        # [S, R] i32 — pending + draft per lane, junk-padded
    block_tables: torch.Tensor,  # [S, pages_per_seq] i32
    positions: torch.Tensor,     # [S] i32 — position of slot 0
    draft_len: torch.Tensor,     # [S] i32 — live draft slots (0 = plain decode row)
    active: torch.Tensor,        # [S] bool
    cfg: ModelConfig,
    engine: EngineConfig,
    attention=ragged_paged_attention,
    kernel: str = "tiled",
) -> torch.Tensor:
    """Verify-shaped step: every lane is a fixed-width ``R = spec_k + 1``
    ragged row (pending token + up to R - 1 drafted tokens), assembled on
    the device so the drafting megastep verifies a fresh draft each
    iteration. Returns ``[S * R, V]`` logits; lane s's slots are rows
    ``s * R .. s * R + R - 1``.

    Slot j writes K/V at ``positions + j`` only while live (``active`` and
    ``j <= draft_len``); dead slots write the garbage page, so a rejected
    draft's K/V never lands past the live prefix. Rows are R wide even
    when the draft is shorter, so ``kv_lens = positions + R`` puts query i
    of every row at its true position ``positions + i``; a dead slot
    attends only what dead slots wrote and yields logits that
    ``resolve_verify`` never selects. ``kernel`` is the form K1 is told
    (both are right on this layout; see ``PERF.md`` for their times at
    ``T = S * R``)."""
    S, R = tokens.shape
    bs = engine.block_size
    dev = tokens.device
    j = torch.arange(R, dtype=torch.int32, device=dev)[None, :]
    pos = positions[:, None] + j                                  # [S, R]
    live = active[:, None] & (j <= draft_len[:, None])
    # A dead slot's page index may fall past the table; it writes the
    # garbage page whatever the gather reads.
    page_idx = torch.clamp(pos // bs, max=block_tables.shape[1] - 1).long()
    page = torch.gather(block_tables, 1, page_idx)
    write_pages = torch.where(live, page, engine.garbage_block).reshape(-1)
    write_offs = (pos % bs).reshape(-1)
    kv_lens = torch.where(active, positions + R, R).to(torch.int32)
    cu = R * torch.arange(S + 1, dtype=torch.int32, device=dev)
    num_seqs = torch.full((1,), S, dtype=torch.int32, device=dev)
    rows = torch.arange(S * R, device=dev)
    return forward_tokens(
        params, cache, tokens.reshape(-1), pos.reshape(-1), write_pages, write_offs,
        kv_lens, block_tables, cu, num_seqs, rows, cfg, attention, kernel,
    )
