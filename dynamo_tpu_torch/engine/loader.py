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


def _placements(cfg: ModelConfig) -> dict[str, tuple[str, int | None, int, int]]:
    """Each checkpoint tensor the model needs: HF name -> (leaf, layer or
    None, first and last output column in the leaf). 2-D weights are
    transposed into place; 1-D norms and biases are copied."""
    q, kv, i = cfg.q_size, cfg.kv_size, cfg.intermediate_size
    out: dict[str, tuple[str, int | None, int, int]] = {
        "model.embed_tokens.weight": ("embed", None, 0, cfg.hidden_size),
        "model.norm.weight": ("final_norm", None, 0, cfg.hidden_size),
    }
    if not cfg.tie_embeddings:
        out["lm_head.weight"] = ("lm_head", None, 0, cfg.vocab_size)
    for layer in range(cfg.num_layers):
        pre = f"model.layers.{layer}."
        cols = {
            "input_layernorm.weight": ("attn_norm", 0, cfg.hidden_size),
            "post_attention_layernorm.weight": ("mlp_norm", 0, cfg.hidden_size),
            "self_attn.q_proj.weight": ("wqkv", 0, q),
            "self_attn.k_proj.weight": ("wqkv", q, q + kv),
            "self_attn.v_proj.weight": ("wqkv", q + kv, q + 2 * kv),
            "self_attn.o_proj.weight": ("wo", 0, cfg.hidden_size),
            "mlp.gate_proj.weight": ("wgu", 0, i),
            "mlp.up_proj.weight": ("wgu", i, 2 * i),
            "mlp.down_proj.weight": ("w_down", 0, cfg.hidden_size),
        }
        if cfg.attn_qkv_bias:
            cols |= {
                "self_attn.q_proj.bias": ("bqkv", 0, q),
                "self_attn.k_proj.bias": ("bqkv", q, q + kv),
                "self_attn.v_proj.bias": ("bqkv", q + kv, q + 2 * kv),
            }
        for name, (leaf, c0, c1) in cols.items():
            out[pre + name] = (leaf, layer, c0, c1)
    return out


def _allocate(cfg: ModelConfig, dt: torch.dtype, quant: str | None, dev) -> Params:
    """Every leaf of the parameter tree, uninitialised, on ``dev``."""
    h, i, v, L = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size, cfg.num_layers
    qkv = cfg.q_size + 2 * cfg.kv_size

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
        "wo": weight("wo", (L, cfg.q_size, h)),
        "wgu": weight("wgu", (L, h, 2 * i)),
        "w_down": weight("w_down", (L, i, h)),
    }
    if cfg.attn_qkv_bias:
        layers["bqkv"] = weight("bqkv", (L, qkv))
    params: Params = {
        "embed": weight("embed", (v, h)),
        "layers": layers,
        "final_norm": weight("final_norm", (h,)),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = weight("lm_head", (h, v))
    return params


def _place(params: Params, where: tuple[str, int | None, int, int], src: torch.Tensor,
           dev: torch.device) -> None:
    """Write one checkpoint tensor into its leaf on ``dev``."""
    leaf_name, layer, c0, c1 = where
    leaf = (params if layer is None else params["layers"])[leaf_name]
    src = src.to(dev)
    if src.dim() == 2 and leaf_name != "embed":
        src = src.T  # HF [out, in] -> [in, out]
    if isinstance(leaf, dict):  # int8: quantized from its f32 values
        w, scale = (leaf["w"], leaf["scale"]) if layer is None else (
            leaf["w"][layer], leaf["scale"][layer])
        q, s = _quantize(src.float())
        w[..., c0:c1].copy_(q)
        scale[..., c0:c1].copy_(s)
    else:
        (leaf if layer is None else leaf[layer])[..., c0:c1].copy_(src)


def load_hf_llama(
    path: str | Path, dtype: torch.dtype | None = None, tp: int = 1,
    quant: str | None = None, device="cuda",
) -> tuple[ModelConfig, Params]:
    """``(ModelConfig, params)`` from an HF llama or qwen2 checkpoint
    directory, the params on ``device`` (the card unless the caller passes
    ``device="cpu"``; without a card ``"cuda"`` raises) at ``dtype`` (the
    config's, bf16, when None), equal leaf for leaf to the JAX loader's
    params carried across by ``convert.params_from_numpy``.
    ``quant="int8"`` gives the projections and ``lm_head`` as int8
    ``{"w", "scale"}`` leaves; embeddings, norms and biases stay at
    ``dtype``. ``tie_word_embeddings`` drops ``lm_head``. A missing
    shard or tensor, or a dtype the reader does not know, raises."""
    if quant not in (None, "int8"):
        raise ValueError(f"unknown quantization {quant!r}")
    if tp != 1:
        raise ValueError(
            f"tp={tp}: the port loads the tp=1 layout only, until tensor "
            "parallelism lands (ROADMAP.md A12)"
        )
    dev = resolve_device(device)
    path = Path(path)
    cfg = config_from_hf(path)
    dt = dtype or cfg.torch_dtype
    shards = _shards(path)
    wanted = _placements(cfg)
    params = _allocate(cfg, dt, quant, dev)
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
        "loaded %s: %d layers, vocab %d%s", path, cfg.num_layers, cfg.vocab_size,
        " (int8 weight-only)" if quant == "int8" else "",
    )
    return cfg, params
