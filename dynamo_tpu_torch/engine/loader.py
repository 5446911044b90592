"""Hugging Face checkpoint loading: llama and qwen2 families, safetensors
or torch ``.bin`` files, into the port's stacked parameter layout.

Counterpart of ``dynamo_tpu/engine/loader.py``, with the same config
mapping and the same resulting values, read another way:

- Safetensors files are read by :func:`read_safetensors` (the 8-byte
  header length, the JSON header, then each tensor taken from a private
  map of the file at its offsets with ``torch.frombuffer``), not by the
  ``safetensors`` package; ``pytorch_model*.bin`` files by ``torch.load``
  with ``mmap=True``.
- The model is streamed, never materialized in f32 on the host: each
  stacked leaf is allocated once on ``device`` at the model dtype and
  filled one checkpoint tensor at a time, shard after shard (the HF
  ``[out, in]`` weight transposed to ``[in, out]``, q|k|v and gate|up at
  their column offsets of ``wqkv`` and ``wgu``). A bf16 source copies
  exactly; f16 and f32 sources round to bf16 to nearest even, as the JAX
  loader's cast does.
- ``quant="int8"`` quantizes each projection tensor as it arrives, from
  its f32 values, with the JAX loader's arithmetic (``_quantize_np``:
  ``scale = max(amax / 127.0, 1e-8)`` as a true division, round half to
  even, clip to +-127), so the device never holds a projection group at
  the model dtype. ``model.quantize_weight`` multiplies by ``f32(1/127)``
  instead, as the JAX engine's compiled quantizer does; the two can
  differ in the last bit of a scale.

HF llama and qwen2 checkpoints use the half-split ("rotate_half") RoPE
convention, which is ``model.rope``, so the weights need no permutation.
``rope_scaling`` is read by neither package. Local files only.
"""

from __future__ import annotations

import json
import logging
import math
import mmap
import struct
from pathlib import Path
from typing import Any

import torch

from dynamo_tpu_torch.engine.config import ModelConfig
from dynamo_tpu_torch.engine.core import resolve_device
from dynamo_tpu_torch.engine.model import Params
from dynamo_tpu_torch.parallel.sharding import param_partition_specs, rank_config

log = logging.getLogger("dynamo_tpu_torch.loader")

# Safetensors dtypes the loader reads; any other raises.
SAFETENSORS_DTYPES = {"BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32}
# Leaves that int8 weight-only quantization turns into {"w", "scale"}.
QUANTIZED_LEAVES = ("wqkv", "wo", "wgu", "w_down", "lm_head")


def config_from_hf(path: str | Path) -> ModelConfig:
    """The checkpoint's ``config.json`` as the port's ModelConfig, field
    for field the JAX package's mapping."""
    with open(Path(path) / "config.json") as f:
        hf = json.load(f)
    head_dim = hf.get("head_dim") or hf["hidden_size"] // hf["num_attention_heads"]
    return ModelConfig(
        name=hf.get("model_type", "llama"),
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=hf["num_attention_heads"],
        num_kv_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
        head_dim=head_dim,
        rope_theta=hf.get("rope_theta", 10000.0),
        rms_norm_eps=hf.get("rms_norm_eps", 1e-5),
        tie_embeddings=hf.get("tie_word_embeddings", False),
        # Qwen2-family checkpoints carry qkv biases (qwen3 dropped them).
        attn_qkv_bias=hf.get("model_type") == "qwen2",
    )


def read_safetensors(path: str | Path) -> dict[str, torch.Tensor]:
    """Every tensor of one safetensors file, as CPU tensors over a private
    (copy-on-write) map of the file: nothing is read until used, and the
    map lives as long as the tensors do."""
    path = Path(path)
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    base = 8 + n
    out: dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dt = SAFETENSORS_DTYPES.get(info["dtype"])
        if dt is None:
            raise ValueError(
                f"{path}: tensor {name!r} has safetensors dtype {info['dtype']}; "
                f"the loader reads {', '.join(SAFETENSORS_DTYPES)}"
            )
        begin, end = info["data_offsets"]
        count = math.prod(info["shape"])
        if end - begin != count * dt.itemsize or base + end > len(mm):
            raise ValueError(
                f"{path}: tensor {name!r} spans bytes {begin}..{end}, which do not "
                f"hold {info['shape']} {info['dtype']} inside the file"
            )
        t = (torch.frombuffer(mm, dtype=dt, count=count, offset=base + begin)
             if count else torch.empty(0, dtype=dt))
        out[name] = t.reshape(info["shape"])
    return out


def _check_index(path: Path) -> None:
    """A sharded checkpoint's index names its shards: each must exist."""
    for index in ("model.safetensors.index.json", "pytorch_model.bin.index.json"):
        if (path / index).exists():
            with open(path / index) as f:
                shards = sorted(set(json.load(f)["weight_map"].values()))
            missing = [s for s in shards if not (path / s).exists()]
            if missing:
                raise FileNotFoundError(f"{path / index} names missing shards: {missing}")


def _shards(path: Path) -> list[Path]:
    _check_index(path)
    files = sorted(path.glob("*.safetensors")) or sorted(path.glob("pytorch_model*.bin"))
    if not files:
        raise FileNotFoundError(f"no safetensors or torch checkpoints in {path}")
    return files


def _read_shard(f: Path) -> dict[str, torch.Tensor]:
    if f.suffix == ".safetensors":
        return read_safetensors(f)
    return torch.load(f, map_location="cpu", weights_only=True, mmap=True)


def _quantize(w32: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The JAX loader's ``_quantize_np`` on an f32 ``[in, out]`` weight:
    per-output-channel symmetric int8, ``/ 127.0`` as a true division. The
    divisor is a tensor on the weight's device: PyTorch's CUDA division by
    a Python number multiplies by its reciprocal, which is
    ``model.quantize_weight``'s arithmetic, not this one."""
    amax = w32.abs().amax(dim=-2, keepdim=True)
    scale = torch.clamp_min(amax / torch.full((), 127.0, device=w32.device), 1e-8)
    q = (w32 / scale).round_().clamp_(-127, 127).to(torch.int8)
    return q, scale


def _placements(cfg: ModelConfig, tp: int = 1, rank: int | None = None,
                layer_span: tuple[int, int] | None = None) -> dict[str, tuple]:
    """Each checkpoint tensor the model needs: HF name -> (leaf, layer or
    None, pieces). A piece ``(axis, s0, s1, d0, d1)`` copies positions
    ``s0:s1`` of the tensor along ``axis`` (after a 2-D weight is
    transposed to ``[in, out]``) to ``d0:d1`` of the leaf: q|k|v and
    gate|up at their column offsets of ``wqkv`` and ``wgu`` in the
    shard-blocked layout of ``tp`` (``model.fuse_qkv``), ``wo`` and
    ``w_down`` by rows, ``lm_head`` by vocab columns. With ``rank`` only
    that rank's blocks are placed, into leaves of its own width; without,
    every rank's, into the full tp-fused leaves. With ``layer_span``
    ``(lo, hi)`` only those layers are placed, layer ``lo`` at index 0."""
    q, kv, i, h, V = (cfg.q_size, cfg.kv_size, cfg.intermediate_size, cfg.hidden_size,
                      cfg.vocab_size)
    ranks = list(range(tp)) if rank is None else [rank]

    def cols(width: int, off: int, block: int) -> list[tuple]:
        # Column-parallel: each rank's 1/tp of the columns at ``off`` in
        # its block of ``block`` columns of the leaf.
        n = width // tp
        return [(-1, r * n, (r + 1) * n, j * block + off, j * block + off + n)
                for j, r in enumerate(ranks)]

    def rows(width: int) -> list[tuple]:
        n = width // tp
        return [(0, r * n, (r + 1) * n, j * n, (j + 1) * n) for j, r in enumerate(ranks)]

    def full(width: int) -> list[tuple]:
        return [(-1, 0, width, 0, width)]

    qb, kvb, ib = q // tp, kv // tp, i // tp
    out: dict[str, tuple] = {
        "model.embed_tokens.weight": ("embed", None, full(h)),
        "model.norm.weight": ("final_norm", None, full(h)),
    }
    if not cfg.tie_embeddings:
        out["lm_head.weight"] = ("lm_head", None, cols(V, 0, V // tp))
    qkv = {
        "q_proj": cols(q, 0, qb + 2 * kvb),
        "k_proj": cols(kv, qb, qb + 2 * kvb),
        "v_proj": cols(kv, qb + kvb, qb + 2 * kvb),
    }
    lo, hi = layer_span or (0, cfg.num_layers)
    for layer in range(lo, hi):
        pre = f"model.layers.{layer}."
        places = {
            "input_layernorm.weight": ("attn_norm", full(h)),
            "post_attention_layernorm.weight": ("mlp_norm", full(h)),
            **{f"self_attn.{n}.weight": ("wqkv", pieces) for n, pieces in qkv.items()},
            "self_attn.o_proj.weight": ("wo", rows(q)),
            "mlp.gate_proj.weight": ("wgu", cols(i, 0, 2 * ib)),
            "mlp.up_proj.weight": ("wgu", cols(i, ib, 2 * ib)),
            "mlp.down_proj.weight": ("w_down", rows(i)),
        }
        if cfg.attn_qkv_bias:
            places |= {f"self_attn.{n}.bias": ("bqkv", pieces) for n, pieces in qkv.items()}
        for name, (leaf, pieces) in places.items():
            out[pre + name] = (leaf, layer - lo, pieces)
    return out


def _allocate(cfg: ModelConfig, dt: torch.dtype, quant: str | None, dev, tp: int = 1,
              rank: int | None = None, n_layers: int | None = None) -> Params:
    """Every leaf of the parameter tree, uninitialised, on ``dev``: a
    rank's widths with ``rank``, else the full ones; ``n_layers`` layers
    (all by default)."""
    local = rank_config(cfg, tp) if rank is not None else cfg
    h, i, L = cfg.hidden_size, local.intermediate_size, n_layers or cfg.num_layers
    v = cfg.vocab_size // tp if rank is not None else cfg.vocab_size
    qkv = local.q_size + 2 * local.kv_size

    def weight(name, shape):
        if quant == "int8" and name in QUANTIZED_LEAVES:
            return {"w": torch.empty(shape, dtype=torch.int8, device=dev),
                    "scale": torch.empty((*shape[:-2], 1, shape[-1]), dtype=torch.float32,
                                         device=dev)}
        return torch.empty(shape, dtype=dt, device=dev)

    layers: dict[str, Any] = {
        "attn_norm": weight("attn_norm", (L, h)),
        "mlp_norm": weight("mlp_norm", (L, h)),
        "wqkv": weight("wqkv", (L, h, qkv)),
        "wo": weight("wo", (L, local.q_size, h)),
        "wgu": weight("wgu", (L, h, 2 * i)),
        "w_down": weight("w_down", (L, i, h)),
    }
    if cfg.attn_qkv_bias:
        layers["bqkv"] = weight("bqkv", (L, qkv))
    params: Params = {
        "embed": weight("embed", (cfg.vocab_size, h)),
        "layers": layers,
        "final_norm": weight("final_norm", (h,)),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = weight("lm_head", (h, v))
    if tp > 1:
        params["fuse_tp"] = tp
    return params


def _place(params: Params, where: tuple, src: torch.Tensor, dev: torch.device) -> None:
    """Write one checkpoint tensor's pieces into its leaf on ``dev``."""
    leaf_name, layer, pieces = where
    leaf = (params if layer is None else params["layers"])[leaf_name]
    src = src.to(dev)
    if src.dim() == 2 and leaf_name != "embed":
        src = src.T  # HF [out, in] -> [in, out]
    if isinstance(leaf, dict):  # int8: quantized from its full f32 values
        w, scale = (leaf["w"], leaf["scale"]) if layer is None else (
            leaf["w"][layer], leaf["scale"][layer])
        src, s = _quantize(src.float())
        for axis, s0, s1, d0, d1 in pieces:
            # A row block keeps its weight's full scales (one per column).
            ss = s.narrow(-1, s0, s1 - s0) if axis == -1 else s
            (scale.narrow(-1, d0, d1 - d0) if axis == -1 else scale).copy_(ss)
        leaf = w
    elif layer is not None:
        leaf = leaf[layer]
    for axis, s0, s1, d0, d1 in pieces:
        leaf.narrow(axis, d0, d1 - d0).copy_(src.narrow(axis, s0, s1 - s0))


def load_hf_llama(
    path: str | Path, dtype: torch.dtype | None = None, tp: int = 1,
    quant: str | None = None, device="cuda", rank: int | None = None,
    layer_span: tuple[int, int] | None = None,
) -> tuple[ModelConfig, Params]:
    """``(ModelConfig, params)`` from an HF llama or qwen2 checkpoint
    directory, the params on ``device`` (the card unless the caller passes
    ``device="cpu"``; without a card ``"cuda"`` raises) at ``dtype`` (the
    config's, bf16, when None), equal leaf for leaf to the JAX loader's
    params carried across by ``convert.params_from_numpy``.
    ``quant="int8"`` gives the projections and ``lm_head`` as int8
    ``{"w", "scale"}`` leaves; embeddings, norms and biases stay at
    ``dtype``. ``tie_word_embeddings`` drops ``lm_head``. A missing
    shard or tensor, or a dtype the reader does not know, raises.

    ``tp`` lays the fused projections out shard-blocked for that many
    ranks, as the JAX loader's ``_fuse_np``; with ``rank`` only that
    rank's shard is streamed onto ``device`` (its columns of ``wqkv``,
    ``wgu``, ``bqkv`` and ``lm_head``, its rows of ``wo`` and ``w_down``;
    int8 scales from each full weight), equal to
    ``parallel.sharding.shard_params`` of the full tp-fused params.
    ``layer_span`` ``(lo, hi)`` streams only those layers (a pipeline
    stage's, ``parallel.pipeline.stage_span``), equal to
    ``parallel.pipeline.stage_params`` of the whole."""
    if quant not in (None, "int8"):
        raise ValueError(f"unknown quantization {quant!r}")
    if tp < 1 or (rank is not None and not 0 <= rank < tp):
        raise ValueError(f"rank {rank} of tp={tp}")
    dev = resolve_device(device)
    path = Path(path)
    cfg = config_from_hf(path)
    dt = dtype or cfg.torch_dtype
    param_partition_specs(cfg, tp)  # tp must divide the heads and the MLP
    shards = _shards(path)
    lo, hi = layer_span or (0, cfg.num_layers)
    if not 0 <= lo < hi <= cfg.num_layers:
        raise ValueError(f"layers {lo}:{hi} of a {cfg.num_layers}-layer model")
    wanted = _placements(cfg, tp, rank, (lo, hi))
    params = _allocate(cfg, dt, quant, dev, tp, rank, hi - lo)
    filled: set[str] = set()
    for shard in shards:
        tensors = _read_shard(shard)
        for name in [n for n in tensors if n in wanted]:
            _place(params, wanted[name], tensors.pop(name), dev)
            filled.add(name)
        del tensors  # drops this shard's map before the next is read
    missing = [n for n in wanted if n not in filled]
    if missing:
        raise KeyError(f"{path}: the checkpoint lacks {len(missing)} tensors, e.g. {missing[:4]}")
    log.info(
        "loaded %s: %d layers, vocab %d%s%s%s", path, cfg.num_layers, cfg.vocab_size,
        " (int8 weight-only)" if quant == "int8" else "",
        f", tp={tp} rank {rank}" if rank is not None else f", tp={tp} layout" if tp > 1 else "",
        f", layers {lo}:{hi}" if (lo, hi) != (0, cfg.num_layers) else "",
    )
    return cfg, params
