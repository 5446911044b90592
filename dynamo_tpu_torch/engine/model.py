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
  [L, E, h, i]`` and ``w_down [L, E, i, h]`` (:func:`_moe_mlp`; under
  tp a rank holds ``E / tp`` experts, dispatched replicated or
  all-to-all).
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

Beside the ragged forward, :func:`forward_ring_prefill` prefills one
long prompt over a sequence-parallel group (``ops/ring_attention.py``).

Order of operations mirrors the JAX code exactly: products accumulate in
f32 and are cast back to the model dtype at the same points, rms_norm
casts before the weight multiply, rope rotates halves.
"""

from __future__ import annotations

import functools
from typing import Any

import torch
import torch.nn.functional as F

from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.kv_quant import INV_127, quantize_kv
from dynamo_tpu_torch.ops.ragged_attention import (
    ragged_paged_attention,
    sharded_ragged_attention,
)
from dynamo_tpu_torch.parallel import comm
from dynamo_tpu_torch.parallel.sharding import (
    expand_specs_for_params,
    fused_sizes,
    param_partition_specs,
    rank_config,
    reblock,
    take_shard,
)

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

def fuse_qkv(wq, wk, wv, tp: int = 1) -> torch.Tensor:
    """Concatenate per-shard blocks ``[q_s | k_s | v_s]`` along the output
    axis; with tp = 1 this is plain ``[q | k | v]``. Inputs ``[..., h,
    out]``."""
    qs, ks, vs = (torch.chunk(w, tp, dim=-1) for w in (wq, wk, wv))
    return torch.cat([blk for s in range(tp) for blk in (qs[s], ks[s], vs[s])], dim=-1)


def fuse_gu(wg, wu, tp: int = 1) -> torch.Tensor:
    gs, us = torch.chunk(wg, tp, dim=-1), torch.chunk(wu, tp, dim=-1)
    return torch.cat([blk for s in range(tp) for blk in (gs[s], us[s])], dim=-1)


def split_qkv(qkv: torch.Tensor, cfg: ModelConfig, tp: int = 1):
    """Inverse of :func:`fuse_qkv` on activations ``[T, q+2kv]``: (q, k, v)
    in natural head order. A rank runs it at tp = 1 on its own block with
    its :func:`~dynamo_tpu_torch.parallel.sharding.rank_config`."""
    if tp == 1:
        return torch.split(qkv, [cfg.q_size, cfg.kv_size, cfg.kv_size], dim=-1)
    T = qkv.shape[0]
    qs, kvs = cfg.q_size // tp, cfg.kv_size // tp
    blocks = qkv.reshape(T, tp, qs + 2 * kvs)
    return (blocks[:, :, :qs].reshape(T, cfg.q_size),
            blocks[:, :, qs : qs + kvs].reshape(T, cfg.kv_size),
            blocks[:, :, qs + kvs :].reshape(T, cfg.kv_size))


def split_gu(gu: torch.Tensor, tp: int = 1):
    if tp == 1:
        return torch.chunk(gu, 2, dim=-1)
    T = gu.shape[0]
    half = gu.shape[-1] // (2 * tp)
    blocks = gu.reshape(T, tp, 2 * half)
    return blocks[:, :, :half].reshape(T, -1), blocks[:, :, half:].reshape(T, -1)


def _layout(name: str, spec: tuple, cfg: ModelConfig, tp: int, rank: int | None):
    """What an init keeps of a leaf drawn at its tp = 1 layout (one layer
    of a stacked leaf): its fused columns reblocked for ``tp`` and, for a
    ``rank``, that rank's block along the spec's tp axis."""
    sizes = fused_sizes(name, cfg)

    def post(t: torch.Tensor) -> torch.Tensor:
        if sizes is not None:
            t = reblock(t, sizes, tp)
        return t if rank is None else take_shard(t, spec, tp, rank)

    return post


def params_fuse_tp(params: Params) -> int:
    """The tp the params' fused projections were laid out for (1 where the
    dict carries no ``fuse_tp``)."""
    return int(params.get("fuse_tp", 1))


# -- initialization --------------------------------------------------------

def init_params(cfg: ModelConfig, seed: int = 0, device="cuda", tp: int = 1,
                rank: int | None = None, layer_span: tuple[int, int] | None = None) -> Params:
    """Random init from a seeded ``torch.Generator`` on ``device`` (serving
    smoke runs and benchmarks; real weights come through a converter).
    Each stacked weight is filled one layer at a time, so the f32
    transient is one layer's worth, and the fused projections are drawn
    at their fused shapes (random fused == fused random). A MoE preset's
    expert stacks are drawn one layer at a time too (for Mixtral-8x7B the
    f32 transient of one layer's ``[8, 4096, 14336]`` is 1.88 GB).

    ``tp`` lays the fused projections out shard-blocked for that many
    ranks (the dict then carries ``fuse_tp``); with ``rank`` the dict
    holds only that rank's shard (``parallel.sharding.shard_params`` of
    the full one). The draw is the same whatever ``tp`` and ``rank``, so
    every layout holds the weights of the tp = 1 init. ``layer_span``
    ``(lo, hi)`` keeps only those layers of each stacked leaf (a pipeline
    stage's, ``parallel.pipeline.stage_span``): every layer is drawn, so
    the kept ones are those of the whole init."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = cfg.torch_dtype
    h, i, v, L = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size, cfg.num_layers
    lo, hi = layer_span or (0, L)
    qkv = cfg.q_size + 2 * cfg.kv_size
    specs = param_partition_specs(cfg, tp)

    def dense(shape, fan_in, name=None, stacked=True):
        spec = (specs["layers"] if stacked else specs)[name]
        post = _layout(name, spec, cfg, tp, rank) if tp > 1 else None
        out = None
        for l in range(shape[0]) if stacked else (None,):
            noise = torch.randn(shape[1:] if stacked else shape, generator=gen, device=dev,
                                dtype=torch.float32)
            if l is not None and not lo <= l < hi:
                continue
            part = noise * fan_in ** -0.5
            if post is not None:
                part = post(part.to(dt))
            if out is None:
                out = torch.empty(((hi - lo,) if stacked else ()) + tuple(part.shape),
                                  dtype=dt, device=dev)
            (out if l is None else out[l - lo]).copy_(part)
        return out

    layers: dict[str, torch.Tensor] = {
        "attn_norm": torch.ones((hi - lo, h), dtype=dt, device=dev),
        "mlp_norm": torch.ones((hi - lo, h), dtype=dt, device=dev),
        "wqkv": dense((L, h, qkv), h, "wqkv"),
        "wo": dense((L, cfg.q_size, h), cfg.q_size, "wo"),
    }
    if cfg.is_moe:
        E = cfg.num_experts
        layers["w_router"] = dense((L, h, E), h, "w_router")
        layers["w_gate"] = dense((L, E, h, i), h, "w_gate")
        layers["w_up"] = dense((L, E, h, i), h, "w_up")
        layers["w_down"] = dense((L, E, i, h), i, "w_down")
    else:
        layers["wgu"] = dense((L, h, 2 * i), h, "wgu")
        layers["w_down"] = dense((L, i, h), i, "w_down")
    if cfg.attn_qkv_bias:
        layers["bqkv"] = dense((L, qkv), 1, "bqkv")
    params: Params = {
        "embed": dense((v, h), h, "embed", stacked=False),
        "layers": layers,
        "final_norm": torch.ones((h,), dtype=dt, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense((h, v), h, "lm_head", stacked=False)
    if tp > 1:
        params["fuse_tp"] = tp
    return params


def init_params_quantized(cfg: ModelConfig, seed: int = 0, device="cuda", tp: int = 1,
                          rank: int | None = None,
                          layer_span: tuple[int, int] | None = None) -> Params:
    """Random init straight into the int8 layout (JAX
    ``init_params_quantized``): each stacked projection is drawn one layer
    at a time at the model dtype, as :func:`init_params` draws it, and
    quantized at once, so the model-dtype transient is one layer's worth.
    Embeddings and norms stay in the model dtype; ``lm_head`` (untied
    only) is quantized too. ``tp`` and ``rank`` as in
    :func:`init_params`: a layer is quantized at its full width and then
    sliced, so a row-parallel weight keeps the full scales. ``layer_span``
    as in :func:`init_params`."""
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
    lo, hi = layer_span or (0, L)
    qkv = cfg.q_size + 2 * cfg.kv_size

    specs = param_partition_specs(cfg, tp)

    def draw(shape, fan_in, name=None, spec=None):
        noise = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        w = (noise * fan_in ** -0.5).to(dt)
        return w if tp == 1 else _layout(name, spec, cfg, tp, None)(w)

    def sliced(q: dict, spec: tuple) -> dict:
        if rank is None:
            return q
        spec = spec[len(spec) - q["w"].dim():]  # one layer of a stacked leaf
        qs = expand_specs_for_params({"x": spec}, {"x": q})["x"]
        return {k: take_shard(q[k], qs[k], tp, rank) for k in q}

    def qdense(shape, fan_in, name):
        spec = specs["layers"][name]
        out = None
        for l in range(L):
            w = draw(shape, fan_in, name, spec)
            if not lo <= l < hi:
                continue
            q = sliced(quantize_weight(w), spec)
            if out is None:
                out = {k: torch.empty((hi - lo, *t.shape), dtype=t.dtype, device=dev)
                       for k, t in q.items()}
            out["w"][l - lo].copy_(q["w"])
            out["scale"][l - lo].copy_(q["scale"])
        return out

    layers: dict[str, Any] = {
        "attn_norm": torch.ones((hi - lo, h), dtype=dt, device=dev),
        "mlp_norm": torch.ones((hi - lo, h), dtype=dt, device=dev),
        "wqkv": qdense((h, qkv), h, "wqkv"),
        "wo": qdense((cfg.q_size, h), cfg.q_size, "wo"),
        "wgu": qdense((h, 2 * i), h, "wgu"),
        "w_down": qdense((i, h), i, "w_down"),
    }
    if cfg.attn_qkv_bias:  # biases stay unquantized
        b = draw((L, qkv), 1, "bqkv", specs["layers"]["bqkv"])[lo:hi]
        layers["bqkv"] = b if rank is None else take_shard(b, specs["layers"]["bqkv"], tp, rank)
    params: Params = {
        "embed": draw((v, h), h),
        "layers": layers,
        "final_norm": torch.ones((h,), dtype=dt, device=dev),
    }
    if not cfg.tie_embeddings:
        lm = quantize_weight(draw((h, v), h))
        params["lm_head"] = sliced(lm, specs["lm_head"])
    if tp > 1:
        params["fuse_tp"] = tp
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


def init_cache(cfg: ModelConfig, engine: EngineConfig, device="cuda", tp: int = 1) -> tuple:
    """Combined KV cache: a tuple of per-layer page tensors
    ``[n_pages, page_size, 2*n_kv, d]``; the last page is the garbage page.
    Per-layer tensors hand the attention kernel its own contiguous buffer.
    With ``engine.kv_dtype == "int8"`` each layer is instead
    ``{"kv": int8 pages, "scale": f32 [n_pages, page_size, 2*n_kv]}``.
    Under tensor parallelism a rank holds its own KV heads (``n_kv / tp``)."""
    dev = torch.device(device)
    cfg = rank_config(cfg, tp)
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


def _mlp(x: torch.Tensor, lp: dict, cfg: ModelConfig, mesh=None) -> torch.Tensor:
    """SwiGLU; under a mesh over this rank's columns of ``wgu`` and rows of
    ``w_down``, the partial products summed over the ranks."""
    if cfg.is_moe:
        return _moe_mlp(x, lp, cfg, mesh)
    g, u = split_gu(_dot(x, lp["wgu"]))
    act = (F.silu(g) * u).to(x.dtype)
    return comm.all_reduce(_dot(act, lp["w_down"]), mesh).to(x.dtype)


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


def _moe_pair_capacity(n: int, cfg: ModelConfig, tp: int) -> int:
    """The all-to-all dispatch's send capacity from one rank's ``n`` tokens
    to each destination rank (static)."""
    k = cfg.num_experts_per_tok
    return max(1, min(n * k, int(-(-n * k * cfg.moe_capacity_factor // tp))))


def _moe_route(xf, w_router, k: int):
    """Top-k routing of ``xf`` ``[N, h]``: the f32 softmax over each token's
    top-k router logits and the chosen expert ids, ``[N*k]`` each,
    token-major with the top-k rank minor. Ties among router logits take
    the lower expert first, as ``jax.lax.top_k``."""
    router = _dot(xf, w_router)                                   # [N, E] f32
    vals, idx = torch.sort(router, dim=-1, descending=True, stable=True)
    return torch.softmax(vals[:, :k], dim=-1).reshape(-1), idx[:, :k].reshape(-1)


def _slots(ids: torch.Tensor, valid: torch.Tensor, n: int) -> torch.Tensor:
    """Each entry's rank among the valid entries of its id (ids ``< n``), in
    entry order: the one-hot cumsum of the JAX functions."""
    oh = ((ids[:, None] == torch.arange(n, device=ids.device)[None, :])
          & valid[:, None]).to(torch.int32)
    return (torch.cumsum(oh, dim=0) * oh).sum(dim=1) - 1


def _experts(g: torch.Tensor, w_gate, w_up, w_down, dtype) -> torch.Tensor:
    """The expert SwiGLUs of ``g`` ``[E', C, h]`` (one batch per expert of
    the stacks): products in f32, SiLU on f32, the activation cast to the
    model dtype before the down product; returns ``[E' * C, h]`` f32."""
    gate = _bmm(g, w_gate)
    up = _bmm(g, w_up)
    act = F.silu(gate, inplace=True).mul_(up).to(dtype)
    del gate, up
    return _bmm(act, w_down).reshape(-1, g.shape[-1])


def _moe_dispatch_local(xf, w_router, w_gate, w_up, w_down, cfg: ModelConfig,
                        e_offset: int = 0, E_local: int | None = None) -> torch.Tensor:
    """Sparse top-k MoE over the contiguous slice of ``E_local`` experts
    from ``e_offset`` (every expert by default): capacity-bounded
    gather/scatter dispatch, each expert a dense ``[C, h]`` batch of its
    assigned tokens. Returns the f32 ``[N, h]`` sum of the slice's
    weighted outputs (under expert parallelism the caller sums the
    shards' partials). The JAX function's semantics exactly:

    - C comes from N, the forward's padded width (bucket padding rows
      route and take slots too), and the global expert count;
    - entries are ordered token-major, top-k rank minor, and an entry's
      slot is its rank among the entries of its expert;
    - ``keep = local & pos < C``: an entry of another shard's expert, or
      past its expert's capacity, adds zero (it lands in a garbage row);
    - the top-k values go through a softmax in f32, SiLU runs on f32
      products, and the combine adds in f32.

    Every shape is static (no ``nonzero``, no boolean-mask indexing, no
    host read), so the dispatch captures into a CUDA graph."""
    N, h = xf.shape
    k = cfg.num_experts_per_tok
    E_local = cfg.num_experts if E_local is None else E_local
    C = _moe_capacity(N, cfg)
    dev = xf.device

    probs, flat_e = _moe_route(xf, w_router, k)
    flat_e = flat_e - e_offset                                    # [N*k] local expert ids
    flat_t = torch.arange(N * k, device=dev) // k                  # token of each entry
    local = (flat_e >= 0) & (flat_e < E_local)
    pos = _slots(flat_e, local, E_local)
    keep = local & (pos < C)
    # Each kept entry's row in the experts' [E_local * C, h] batch; the
    # others land in the garbage row after it (the JAX function's garbage
    # expert row and capacity slot).
    slot = torch.where(keep, flat_e * C + pos, E_local * C)

    gathered = torch.zeros((E_local * C + 1, h), dtype=xf.dtype, device=dev)
    gathered[slot] = xf[flat_t]
    down = _experts(gathered[: E_local * C].view(E_local, C, h), w_gate, w_up, w_down, xf.dtype)

    # A dropped entry reads a clamped row and adds zero.
    entry_out = torch.where(keep[:, None], down[slot.clamp(max=E_local * C - 1)], 0.0)
    w_masked = torch.where(keep, probs, 0.0)
    return (w_masked[:, None] * entry_out).reshape(N, k, h).sum(dim=1)


def _pack_a2a(x: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """``x`` ``[tp, Cs, h]`` and the expert ids ``e`` ``[tp, Cs]`` i32 as one
    byte tensor ``[tp, Cs, bytes]``: the outbound all-to-all is one call."""
    return torch.cat([x.contiguous().view(torch.uint8).reshape(*x.shape[:2], -1),
                      e.to(torch.int32).contiguous().view(torch.uint8)
                      .reshape(*e.shape, 4)], dim=-1)


def _unpack_a2a(buf: torch.Tensor, h: int, dtype: torch.dtype):
    nb = buf.shape[-1] - 4
    x = buf[..., :nb].contiguous().view(dtype).reshape(*buf.shape[:2], h)
    return x, buf[..., nb:].contiguous().view(torch.int32).reshape(buf.shape[:2])


def _moe_dispatch_a2a(xl, w_router, w_gate, w_up, w_down, cfg: ModelConfig, mesh,
                      E_local: int) -> torch.Tensor:
    """Token all-to-all EP dispatch over one tp rank's token slice ``xl``
    ``[n, h]`` (the JAX function inside its ``shard_map``): the rank routes
    its own tokens, packs one send buffer per destination rank, bounded by
    the per-(source, destination) capacity ``Cs``, and one all-to-all
    delivers each token (with its expert id) to the rank holding its
    expert; after the expert SwiGLUs a second all-to-all returns the
    outputs, in the model dtype, for the weighted f32 combine at the
    source. Drops differ from the replicated mode's: capacity binds per
    (source, destination) pair here, per expert there, so the two agree
    only while nothing overflows (:func:`moe_overflow` tells)."""
    n, h = xl.shape
    tp = mesh.tp
    k = cfg.num_experts_per_tok
    Cs = _moe_pair_capacity(n, cfg, tp)
    dev = xl.device

    probs, flat_e = _moe_route(xl, w_router, k)                   # global expert ids
    flat_t = torch.arange(n * k, device=dev) // k
    dest = flat_e // E_local                                      # destination rank
    pos = _slots(dest, torch.ones_like(dest, dtype=torch.bool), tp)
    keep = pos < Cs
    slot = torch.where(keep, dest * Cs + pos, tp * Cs)

    send_x = torch.zeros((tp * Cs + 1, h), dtype=xl.dtype, device=dev)
    send_x[slot] = xl[flat_t]
    send_e = torch.full((tp * Cs + 1,), -1, dtype=torch.int32, device=dev)
    send_e[slot] = (flat_e % E_local).to(torch.int32)
    recv = comm.all_to_all(_pack_a2a(send_x[: tp * Cs].view(tp, Cs, h),
                                     send_e[: tp * Cs].view(tp, Cs)), mesh)
    r_x, r_e = _unpack_a2a(recv, h, xl.dtype)

    # Local expert compute over everything received ([M, h], M = tp * Cs).
    # No second capacity bound: the buffers are already source-bounded.
    M = tp * Cs
    r_x, r_e = r_x.reshape(M, h), r_e.reshape(M)
    valid = r_e >= 0
    pos2 = _slots(r_e, valid, E_local)
    slot2 = torch.where(valid, r_e * M + pos2, E_local * M)
    gathered = torch.zeros((E_local * M + 1, h), dtype=xl.dtype, device=dev)
    gathered[slot2] = r_x
    down = _experts(gathered[: E_local * M].view(E_local, M, h), w_gate, w_up, w_down, xl.dtype)
    out_entries = torch.where(valid[:, None], down[slot2.clamp(max=E_local * M - 1)],
                              0.0).to(xl.dtype)
    back = comm.all_to_all(out_entries.view(tp, Cs, h), mesh).reshape(M, h)

    entry_vals = torch.where(keep[:, None], back[slot.clamp(max=M - 1)].float(), 0.0)
    w_masked = torch.where(keep, probs, 0.0)
    return (w_masked[:, None] * entry_vals).reshape(n, k, h).sum(dim=1).to(xl.dtype)


def moe_overflow(x: torch.Tensor, w_router, cfg: ModelConfig, tp: int = 1) -> dict:
    """Whether any routed entry of the tokens ``x`` ``[N, h]`` (a whole
    dispatch's) overflows its capacity: per expert (the replicated mode's
    C from N) and per (source, destination) pair of ``tp`` token slices
    (the all-to-all mode's Cs). The two modes drop differently under
    saturation; this tells whether either dropped."""
    N = x.shape[0]
    k, E = cfg.num_experts_per_tok, cfg.num_experts
    _, flat_e = _moe_route(x, w_router, k)
    per_expert = torch.bincount(flat_e, minlength=E)
    out = {"capacity": _moe_capacity(N, cfg), "max_per_expert": int(per_expert.max())}
    out["replicated"] = out["max_per_expert"] > out["capacity"]
    if tp > 1:
        n = -(-N // tp)  # the all-to-all mode's slices, zero rows padding the last
        _, ids = _moe_route(F.pad(x, (0, 0, 0, n * tp - N)), w_router, k)
        dest = ids.view(tp, n * k) // (E // tp)
        pair = torch.stack([torch.bincount(d, minlength=tp) for d in dest])
        Cs = _moe_pair_capacity(n, cfg, tp)
        out.update(pair_capacity=Cs, max_per_pair=int(pair.max()),
                   alltoall=int(pair.max()) > Cs)
    return out


def _moe_mlp(x: torch.Tensor, lp: dict, cfg: ModelConfig, mesh=None) -> torch.Tensor:
    """Mixtral-style sparse MoE: softmax over the top-k router logits,
    weighted sum of the expert SwiGLUs, capacity-bounded dispatch. Under
    a mesh of tp ranks (expert parallelism: a rank holds ``E / tp``
    experts, ``parallel/sharding.py``) the JAX function's two modes
    (``cfg.moe_dispatch``):

    - ``"replicated"`` (the default): every rank dispatches every token
      to its own experts and the f32 partials are summed over tp (JAX
      sums the shards' bf16 partials; gloo has no bf16 sum, and one
      rounding of the f32 sum is the nearer result);
    - ``"alltoall"``: the token axis, padded to a multiple of tp, splits
      over the ranks, each slice travels to its experts and back
      (:func:`_moe_dispatch_a2a`), and the slices are gathered over tp.

    JAX hands the dispatch the whole batch on every device, so the
    capacity comes from the whole N; under a dp rank's lane view the
    lanes are gathered over dp first, dispatched whole, and the rank
    keeps its block."""
    shape = x.shape
    xf = x.reshape(-1, shape[-1])
    lanes = mesh is not None and mesh.lanes and mesh.dp > 1
    if lanes:
        n_own = xf.shape[0]
        xf = comm.dp_gather(xf, mesh)
    w = (lp["w_router"], lp["w_gate"], lp["w_up"], lp["w_down"])
    tp = mesh.tp if mesh is not None else 1
    E_local = cfg.num_experts // tp
    if tp == 1:
        out = _moe_dispatch_local(xf, *w, cfg).to(xf.dtype)
    elif cfg.moe_dispatch == "alltoall":
        N = xf.shape[0]
        n = -(-N // tp)  # the token axis must split evenly over tp
        xp = F.pad(xf, (0, 0, 0, n * tp - N))
        part = _moe_dispatch_a2a(xp[mesh.tp_rank * n : (mesh.tp_rank + 1) * n], *w, cfg, mesh,
                                 E_local)
        out = comm.all_gather(part, mesh, dim=0)[:N]
    else:
        part = _moe_dispatch_local(xf, *w, cfg, mesh.tp_rank * E_local, E_local)
        out = comm.all_reduce(part, mesh).to(xf.dtype)
    if lanes:
        out = out[mesh.dp_rank * n_own : (mesh.dp_rank + 1) * n_own]
    return out.reshape(shape)


def _logits(x: torch.Tensor, params: Params, cfg: ModelConfig, mesh=None) -> torch.Tensor:
    """f32 logits. Tied embeddings contract ``embed [V, h]`` in its stored
    layout (a transposed view, never a copy), replicated on every rank;
    an untied ``lm_head`` is vocab-split under a mesh and its columns are
    gathered, so every rank holds the full row and samples the same
    token."""
    if cfg.tie_embeddings:
        return _dot(x, params["embed"].t())
    return comm.all_gather(_dot(x, params["lm_head"]), mesh)


def logits_slice(x: torch.Tensor, params: Params, cfg: ModelConfig, stage: int,
                 pp: int) -> torch.Tensor:
    """Stage ``stage``'s ``V/pp`` columns of the f32 logits (the pipeline's
    exit, JAX's ``_pp_decode_round_body``): the same rows of tied
    embeddings, or columns of ``lm_head`` (an int8 leaf's ``w`` and
    ``scale`` alike), contracted as :func:`_logits` contracts the whole."""
    Vp = cfg.vocab_size // pp
    lo, hi = stage * Vp, (stage + 1) * Vp
    if cfg.tie_embeddings:
        return _dot(x, params["embed"][lo:hi].t())
    lm = params["lm_head"]
    if isinstance(lm, dict):
        return _dot(x, {k: v[..., lo:hi] for k, v in lm.items()})
    return _dot(x, lm[:, lo:hi])


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


def _attention_inputs(x: torch.Tensor, lp: dict, cfg: ModelConfig,
                      rope_cs: tuple[torch.Tensor, torch.Tensor]):
    """A layer's part before attention: attn-norm → fused qkv (with the
    Qwen2-family bias) → rope. Returns q ``[T, H, d]``, k ``[T, n_kv,
    d]`` and v ``[T, kv_size]``."""
    T = x.shape[0]
    y = rms_norm(x, lp["attn_norm"], cfg.rms_norm_eps)
    qkv = _dot(y, lp["wqkv"])
    if "bqkv" in lp:  # Qwen2-family qkv bias (fused column order)
        qkv = qkv + lp["bqkv"]
    q, k, v = split_qkv(qkv.to(x.dtype), cfg)
    q = rope_apply(q.reshape(T, cfg.num_heads, cfg.head_dim), *rope_cs)
    k = rope_apply(k.reshape(T, cfg.num_kv_heads, cfg.head_dim), *rope_cs)
    return q, k, v


def _attention_outputs(x: torch.Tensor, attn: torch.Tensor, lp: dict, cfg: ModelConfig,
                       mesh=None, mlp=None) -> torch.Tensor:
    """A layer's part after attention: ``wo`` (its partial products
    summed over a mesh's ranks) into the residual, then mlp-norm → the MLP
    (``mlp`` in place of :func:`_mlp`) into the residual."""
    x = x + comm.all_reduce(_dot(attn.reshape(x.shape[0], cfg.q_size), lp["wo"]),
                            mesh).to(x.dtype)
    y = rms_norm(x, lp["mlp_norm"], cfg.rms_norm_eps)
    return x + (_mlp(y, lp, cfg, mesh) if mlp is None else mlp(y))


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
    mesh=None,
) -> torch.Tensor:
    """One transformer block over a ragged token batch: attn-norm → fused
    qkv → rope → page scatter → ragged paged attention → wo → mlp.
    ``attention`` has the operands of :func:`ragged_paged_attention`;
    ``kernel`` is the form it is told the batch has ("tiled": chunks of
    many rows, "decode": one query row per sequence). Under a ``mesh``,
    ``cfg`` is the rank's (``rank_config``) and ``lp`` its shard: the
    attention runs on the rank's heads with no collective, and the
    row-parallel ``wo`` and ``w_down`` products are summed over the ranks.
    Under a mesh's lane view (a dp rank's block of a decode batch) the
    K/V rows are gathered over dp before they are written, and
    ``write_pages``/``write_offs`` are every lane's."""
    T = x.shape[0]
    q, k, v = _attention_inputs(x, lp, cfg, rope_cs)
    kvn = _interleave_kv(k.reshape(T, cfg.kv_size), v, cfg)
    if mesh is not None and mesh.lanes:
        # Every dp rank writes every lane's rows: the caches stay equal.
        kvn = comm.dp_gather(kvn, mesh)
    write_kv(cache_l, write_pages, write_offs, kvn)
    if isinstance(cache_l, dict):
        kv_pages, kv_scales = cache_l["kv"], cache_l["scale"]
    else:
        kv_pages, kv_scales = cache_l, None
    if mesh is not None and attention is ragged_paged_attention:
        attention = functools.partial(sharded_ragged_attention, mesh)
    attn = attention(
        q, kv_pages, kv_lens, block_tables, cu_q_lens, num_seqs,
        sm_scale=cfg.head_dim ** -0.5, kv_scales=kv_scales, kernel=kernel,
    )
    return _attention_outputs(x, attn, lp, cfg, mesh)


# -- the unified forward ----------------------------------------------------

def layer_params(layers: dict, l: int) -> dict:
    """Layer ``l``'s slice of the stacked leaves (an int8 leaf's ``w`` and
    ``scale`` alike)."""
    return {name: {k: t[l] for k, t in w.items()} if isinstance(w, dict) else w[l]
            for name, w in layers.items()}


def forward_layers(
    x: torch.Tensor,             # [T, h]
    layers: dict,                # stacked [L', ...] leaves of the layers held
    cache: tuple,                # the L' layers' pages
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
    mesh=None,
) -> torch.Tensor:
    """The layers this process holds over one ragged batch: every layer of
    the model, or a pipeline stage's slice (``parallel/pipeline.py``), each
    :func:`dense_layer` in turn on its own pages; returns the hidden
    states [T, h] after them. Under a mesh's lane view the rows' write
    targets are gathered over dp once, for every layer's K/V rows."""
    rope_cs = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    wp, wo = write_pages.long(), write_offs.long()
    if mesh is not None and mesh.lanes:
        wp, wo = comm.dp_gather(torch.stack([wp, wo]), mesh, dim=1).unbind(0)
    lcfg = rank_config(cfg, mesh.tp) if mesh is not None else cfg
    for l in range(len(cache)):
        x = dense_layer(
            x, layer_params(layers, l), cache[l], wp, wo, kv_lens, block_tables, cu_q_lens,
            num_seqs, lcfg, rope_cs, attention, kernel, mesh,
        )
    return x


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
    mesh=None,
) -> torch.Tensor:
    """The transformer stack up to the final norm: hidden states [T, h].
    The cache is written in place; every layer's attention is told
    ``kernel``. ``mm_embeds``/``mm_mask`` override the token-embedding
    rows at multimodal placeholder positions with encoder output
    (``llm/multimodal.py``), as the JAX function's ``want_mm`` variant.
    Under a ``mesh`` (``parallel.sharding.Mesh``) ``params`` and ``cache``
    are this rank's shard and the hidden states are replicated."""
    x = params["embed"][tokens.long()]
    if mm_embeds is not None:
        x = torch.where(mm_mask[:, None], mm_embeds.to(x.dtype), x)
    x = forward_layers(
        x, params["layers"], cache, positions, write_pages, write_offs, kv_lens,
        block_tables, cu_q_lens, num_seqs, cfg, attention, kernel, mesh,
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
    mesh=None,
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
        mm_embeds, mm_mask, mesh,
    )
    return _logits(x[last_rows.long()], params, cfg, mesh)


def _sp_moe_mlp(y: torch.Tensor, lp: dict, cfg: ModelConfig, sp_mesh, rows: slice):
    """An sp rank's MoE MLP: the rows gathered over the sp ranks,
    dispatched whole, the rank's ``rows`` kept."""
    return _moe_mlp(comm.sp_gather(y, sp_mesh), lp, cfg)[rows]


def forward_ring_prefill(
    params: Params,
    cache: tuple,                # every layer's pages (written in place)
    tokens: torch.Tensor,        # [T] i32: ONE prompt, bucket-padded, the same on every rank
    write_pages: torch.Tensor,   # [T] i32 (garbage page for pad rows)
    write_offs: torch.Tensor,    # [T] i32
    last_row: int,               # row of the prompt's last token
    cfg: ModelConfig,
    sp_mesh=None,
) -> torch.Tensor:
    """Sequence-parallel long-context prefill of one prompt (the JAX
    function of this name): sp rank ``r`` computes rows ``[r*T/sp,
    (r+1)*T/sp)`` through every layer (rms_norm, the fused qkv, rope at
    the global positions, ring attention over the sp ranks, ``wo``, the
    MLP) and returns the last-token logits ``[1, V]`` f32, the same on
    every rank. Causal masking makes bucket padding safe: pad rows sit
    after the last real token.

    - Every rank writes every chunk's K/V rows into its own pages: its
      own chunk, and each chunk as it passes through the ring, in the
      bytes the owning rank computed. After the prefill every rank's
      cache holds the whole prompt, the same bytes on every rank, and
      decode goes on on the paged path everywhere (an int8 cache
      quantizes the same rows alike).
    - The rank whose chunk holds ``last_row`` computes the logits and
      broadcasts them to the group, so every rank samples the same token.
    - A MoE preset's capacity and slots depend on all T tokens in order
      (JAX dispatches the whole prompt at once): the MoE input is
      gathered over the sp ranks, dispatched whole, and each rank keeps
      its rows."""
    from dynamo_tpu_torch.ops.ring_attention import _ring_attention_local

    T = tokens.shape[0]
    sp, r = (sp_mesh.sp, sp_mesh.rank) if sp_mesh is not None else (1, 0)
    if T % sp:
        raise ValueError(f"sequence {T} not divisible by {sp}-way sp")
    n = T // sp
    rows = slice(r * n, (r + 1) * n)
    positions = torch.arange(T, dtype=torch.int32, device=tokens.device)[rows]
    wp, wo = write_pages.long(), write_offs.long()
    x = params["embed"][tokens[rows].long()]
    rope_cs = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    for l in range(cfg.num_layers):
        lp = layer_params(params["layers"], l)
        q, k, v = _attention_inputs(x, lp, cfg, rope_cs)

        def write(src: int, kc: torch.Tensor, vc: torch.Tensor, cache_l=cache[l]) -> None:
            seg = slice(src * n, (src + 1) * n)
            kvn = _interleave_kv(kc.reshape(n, cfg.kv_size), vc.reshape(n, cfg.kv_size), cfg)
            write_kv(cache_l, wp[seg], wo[seg], kvn)

        attn = _ring_attention_local(q, k, v.reshape(n, cfg.num_kv_heads, cfg.head_dim),
                                     sp_mesh, on_chunk=write)
        x = _attention_outputs(x, attn, lp, cfg, mlp=functools.partial(
            _sp_moe_mlp, lp=lp, cfg=cfg, sp_mesh=sp_mesh, rows=rows) if cfg.is_moe and sp > 1
            else None)
    owner = last_row // n
    if r == owner:
        last = x[last_row - owner * n : last_row - owner * n + 1]
        logits = _logits(rms_norm(last, params["final_norm"], cfg.rms_norm_eps), params, cfg)
    else:
        logits = torch.empty((1, cfg.vocab_size), dtype=torch.float32, device=x.device)
    return comm.sp_broadcast(logits, owner, sp_mesh) if sp > 1 else logits


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
    mesh=None,
) -> torch.Tensor:
    """Causal LLM-as-embedder: one forward over the prompt and masked mean
    pooling of the final-norm hidden states; returns the ``[h]`` f32
    embedding. Bucket-padded rows write the garbage page and sit after
    every valid row, so causal masking keeps them out of the valid rows'
    attention; pooling masks them out of the mean. Under a tp ``mesh``
    (``parallel.sharding.Mesh``) ``params`` and ``scratch`` are this rank's
    heads; under a pipeline's (``parallel.pipeline.PPMesh``) this stage's
    layers: stage 0 embeds the tokens, each stage runs its layers on what
    the one before sent it, the last pools, and the exit broadcast hands
    every stage the embedding."""
    T = tokens.shape[0]
    dev = tokens.device
    positions = torch.arange(T, dtype=torch.int32, device=dev)
    ops = (positions, write_pages, positions % engine.block_size,
           torch.full((1,), T, dtype=torch.int32, device=dev), block_tables,
           torch.tensor([0, T], dtype=torch.int32, device=dev),
           torch.ones(1, dtype=torch.int32, device=dev))
    w = valid.float()[:, None]
    if getattr(mesh, "pp", 1) == 1:
        x = forward_hidden(params, scratch, tokens, *ops, cfg, attention, mesh=mesh)
        return (x.float() * w).sum(dim=0) / torch.clamp_min(w.sum(), 1.0)
    if mesh.stage == 0:
        x = params["embed"][tokens.long()]
    else:
        x = comm.recv_prev((T, cfg.hidden_size), cfg.torch_dtype, mesh)
    x = forward_layers(x, params["layers"], scratch, *ops, cfg, attention)
    pooled = torch.zeros(cfg.hidden_size, dtype=torch.float32, device=dev)
    if mesh.stage < mesh.pp - 1:
        comm.wait_sends([comm.send_next(x, mesh)])
    else:
        x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
        pooled = (x.float() * w).sum(dim=0) / torch.clamp_min(w.sum(), 1.0)
    return comm.exit_broadcast(pooled, mesh)


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
    mesh=None,
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
        kv_lens, block_tables, cu, num_seqs, rows, cfg, attention, "decode", mesh=mesh,
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
    mesh=None,
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
        kv_lens, block_tables, cu, num_seqs, rows, cfg, attention, kernel, mesh=mesh,
    )
