"""Carry the JAX package's weights and KV pages across to the port.

The input is the JAX params pytree mapped through ``np.asarray`` (or any
tree of numpy arrays with the same names): ``embed``, ``layers.{attn_norm,
mlp_norm, wqkv, bqkv?, wo, wgu, w_down}``, ``final_norm``, ``lm_head?`` and
the ``fuse_tp`` marker. The port keeps the same ``[in, out]`` layouts, so
every leaf converts as it is.

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


def tensor_from_numpy(a: Any, device="cpu") -> torch.Tensor:
    """One array to a tensor on ``device``; bf16 keeps its exact bits."""
    a = np.array(a)  # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(torch.device(device))


def params_from_numpy(tree: dict, cfg: ModelConfig, device="cpu") -> Params:
    """The JAX params pytree (numpy leaves) as the port's parameter dict."""
    tp = int(np.asarray(tree.get("fuse_tp", 1)))
    if tp != 1:
        raise ValueError(
            f"params were fused for tp={tp}; the port serves one device "
            "(tp=1 layouts) until tensor parallelism lands (ROADMAP.md A12)"
        )
    if cfg.is_moe:
        raise ValueError("MoE presets are not ported yet (ROADMAP.md A11)")
    for name, w in tree["layers"].items():
        if isinstance(w, dict):
            raise ValueError(
                f"layers.{name} is int8-quantized; int8 weights are not "
                "ported yet (ROADMAP.md A9)"
            )
    params: Params = {
        "embed": tensor_from_numpy(tree["embed"], device),
        "layers": {
            name: tensor_from_numpy(w, device) for name, w in tree["layers"].items()
        },
        "final_norm": tensor_from_numpy(tree["final_norm"], device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = tensor_from_numpy(tree["lm_head"], device)
    return params


def cache_from_numpy(pages: tuple, device="cpu") -> tuple[torch.Tensor, ...]:
    """A per-layer page tuple (``init_cache`` layout) as the port's cache."""
    return tuple(tensor_from_numpy(p, device) for p in pages)
