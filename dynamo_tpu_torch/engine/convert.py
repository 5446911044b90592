"""Carry the JAX package's weights and KV pages across to the port.

The input is the JAX params pytree mapped through ``np.asarray`` (or any
tree of numpy arrays with the same names): ``embed``, ``layers.{attn_norm,
mlp_norm, wqkv, bqkv?, wo, wgu, w_down}``, ``final_norm``, ``lm_head?`` and
the ``fuse_tp`` marker. The port keeps the same ``[in, out]`` layouts, so
every leaf converts as it is. int8-quantized weights (``{"w": int8,
"scale": f32}`` leaves, JAX ``quantize_params`` / ``init_params_quantized``)
and int8 cache pages (``{"kv": int8, "scale": f32}`` per layer) cross as
dicts of tensors, byte for byte.

Every function here puts its tensors on the card unless the caller passes
``device="cpu"``.

bf16 arrays come out of JAX as ``ml_dtypes.bfloat16``, which
``torch.from_numpy`` rejects; they travel as a ``uint16`` view and are
reinterpreted as ``torch.bfloat16`` bit for bit.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from dynamo_tpu_torch.engine.config import ModelConfig
from dynamo_tpu_torch.engine.model import Params


def tensor_from_numpy(a: Any, device="cuda") -> torch.Tensor:
    """One array to a tensor on ``device``; bf16 keeps its exact bits."""
    a = np.array(a)  # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(torch.device(device))


def _leaf(a: Any, device):
    """One leaf: an array, or a ``{name: array}`` dict of int8 storage."""
    if isinstance(a, dict):
        return {k: tensor_from_numpy(v, device) for k, v in a.items()}
    return tensor_from_numpy(a, device)


def params_from_numpy(tree: dict, cfg: ModelConfig, device="cuda") -> Params:
    """The JAX params pytree (numpy leaves) as the port's parameter dict."""
    tp = int(np.asarray(tree.get("fuse_tp", 1)))
    if tp != 1:
        raise ValueError(
            f"params were fused for tp={tp}; the port serves one device "
            "(tp=1 layouts) until tensor parallelism lands (ROADMAP.md A12)"
        )
    if cfg.is_moe:
        raise ValueError("MoE presets are not ported yet (ROADMAP.md A11)")
    params: Params = {
        "embed": tensor_from_numpy(tree["embed"], device),
        "layers": {name: _leaf(w, device) for name, w in tree["layers"].items()},
        "final_norm": tensor_from_numpy(tree["final_norm"], device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = _leaf(tree["lm_head"], device)
    return params


def cache_from_numpy(pages: tuple, device="cuda") -> tuple:
    """A per-layer page tuple (``init_cache`` layout, bf16 pages or int8
    ``{kv, scale}`` dicts) as the port's cache."""
    return tuple(_leaf(p, device) for p in pages)
