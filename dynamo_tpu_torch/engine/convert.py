"""Carry the JAX package's weights and KV pages across to the port.

The input is the JAX params pytree mapped through ``np.asarray`` (or any
tree of numpy arrays with the same names): ``embed``, ``layers.{attn_norm,
mlp_norm, wqkv, bqkv?, wo, wgu, w_down}`` (a MoE preset's ``w_router``,
``w_gate``, ``w_up`` and ``w_down`` expert stacks in place of ``wgu`` and
``w_down``), ``final_norm``, ``lm_head?`` and the ``fuse_tp`` marker. The
port keeps the same ``[in, out]`` layouts, so every leaf converts as it
is. int8-quantized weights (``{"w": int8,
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

from types import SimpleNamespace
from typing import Any

import numpy as np
import torch

from dynamo_tpu_torch.engine.config import ModelConfig
from dynamo_tpu_torch.engine.model import Params
from dynamo_tpu_torch.parallel.sharding import shard_params


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


def params_from_numpy(tree: dict, cfg: ModelConfig, device="cuda",
                      rank: int | None = None) -> Params:
    """The JAX params pytree (numpy leaves) as the port's parameter dict.
    A pytree fused for tp > 1 (its ``fuse_tp``) keeps that layout and
    marker; with ``rank`` only that rank's shard reaches ``device``
    (``parallel.sharding.shard_params``, sliced on the host first)."""
    tp = int(np.asarray(tree.get("fuse_tp", 1)))
    if rank is not None and not 0 <= rank < tp:
        raise ValueError(f"rank {rank} of params fused for tp={tp}")
    shard = rank is not None and tp > 1
    host = "cpu" if shard else device
    params: Params = {
        "embed": tensor_from_numpy(tree["embed"], host),
        "layers": {name: _leaf(w, host) for name, w in tree["layers"].items()},
        "final_norm": tensor_from_numpy(tree["final_norm"], host),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = _leaf(tree["lm_head"], host)
    if tp > 1:
        params["fuse_tp"] = tp
    if not shard:
        return params
    return to_device(shard_params(params, cfg, SimpleNamespace(tp=tp, rank=rank)), device)


def to_device(params: Params, device) -> Params:
    """A params dict with every tensor on ``device``."""
    def move(x):
        if isinstance(x, dict):
            return {k: move(v) for k, v in x.items()}
        return x.to(torch.device(device)) if isinstance(x, torch.Tensor) else x

    return move(params)


def cache_from_numpy(pages: tuple, device="cuda") -> tuple:
    """A per-layer page tuple (``init_cache`` layout, bf16 pages or int8
    ``{kv, scale}`` dicts) as the port's cache."""
    return tuple(_leaf(p, device) for p in pages)
