"""Memory placement planning: does a (model, engine, mesh) fit the cards?

Counterpart of ``dynamo_tpu/parallel/placement.py``: per-card parameter
bytes under the tp sharding (``parallel/sharding.py``: projections split
over tp, embeddings and norms replicated, every dp replica a full copy),
per-card KV-cache bytes (the combined ``[pages, bs, 2*kv, d]`` pages split
their head axis over tp), plus a headroom fraction for activations and
scratch. The card is an H100 with 80 GB.

The shapes are the port's own: each leaf's shape as ``model.init_params``
allocates it and its spec from ``param_partition_specs``, with no device
memory touched; the byte counts equal the JAX function's for the same
inputs.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.parallel.sharding import TP, param_partition_specs

# H100 SXM: 80 GB of HBM3 per card (80 GiB as nvidia-smi's total reports
# it, less what the driver keeps).
H100_HBM_BYTES = 80 * 1024**3


@dataclass
class MemoryPlan:
    param_bytes_per_chip: int
    cache_bytes_per_chip: int
    headroom_frac: float

    @property
    def total_per_chip(self) -> int:
        return math.ceil(
            (self.param_bytes_per_chip + self.cache_bytes_per_chip) * (1.0 + self.headroom_frac)
        )

    def fits(self, hbm_bytes: int = H100_HBM_BYTES) -> bool:
        return self.total_per_chip <= hbm_bytes

    def describe(self, hbm_bytes: int = H100_HBM_BYTES) -> str:
        gib = 1024**3
        return (
            f"params {self.param_bytes_per_chip / gib:.2f} GiB/card + "
            f"kv {self.cache_bytes_per_chip / gib:.2f} GiB/card "
            f"(+{self.headroom_frac:.0%} headroom) = "
            f"{self.total_per_chip / gib:.2f} / {hbm_bytes / gib:.0f} GiB"
        )


def param_shapes(cfg: ModelConfig) -> dict:
    """Shape and itemsize of every leaf of ``model.init_params(cfg)``, in
    its structure (``fuse_tp`` a scalar int32)."""
    h, i, v, L = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size, cfg.num_layers
    qkv = cfg.q_size + 2 * cfg.kv_size
    it = cfg.torch_dtype.itemsize
    layers = {
        "attn_norm": ((L, h), it),
        "mlp_norm": ((L, h), it),
        "wqkv": ((L, h, qkv), it),
        "wo": ((L, cfg.q_size, h), it),
    }
    if cfg.attn_qkv_bias:
        layers["bqkv"] = ((L, qkv), it)
    if cfg.is_moe:
        E = cfg.num_experts
        layers["w_router"] = ((L, h, E), it)
        layers["w_gate"] = ((L, E, h, i), it)
        layers["w_up"] = ((L, E, h, i), it)
        layers["w_down"] = ((L, E, i, h), it)
    else:
        layers["wgu"] = ((L, h, 2 * i), it)
        layers["w_down"] = ((L, i, h), it)
    shapes = {"embed": ((v, h), it), "layers": layers, "final_norm": ((h,), it),
              "fuse_tp": ((), 4)}
    if not cfg.tie_embeddings:
        shapes["lm_head"] = ((h, v), it)
    return shapes


def memory_plan(
    model: ModelConfig,
    engine: EngineConfig,
    tp: int,
    dp: int = 1,
    quant: str | None = None,
    headroom_frac: float = 0.15,
) -> MemoryPlan:
    """Per-card memory plan for serving ``model`` on a dp x tp mesh: each
    leaf's per-card share divides by tp where its spec names the tp axis.
    ``quant='int8'`` counts each tp-split matrix at 1 byte per element plus
    one f32 scale per output column (as the JAX plan counts it); dp never
    divides, every replica holds the full params and its own cache."""
    shapes, specs = param_shapes(model), param_partition_specs(model, tp)
    param_bytes = 0
    for group in ("embed", "final_norm", "fuse_tp", "lm_head", "layers"):
        if group not in shapes:
            continue
        leaves = (shapes[group].items() if group == "layers" else [(group, shapes[group])])
        spec_of = specs["layers"] if group == "layers" else specs
        for name, (shape, itemsize) in leaves:
            on_tp = TP in spec_of[name]
            div = tp if on_tp else 1
            n = math.prod(shape) if shape else 1
            if quant == "int8" and len(shape) >= 2 and on_tp:
                param_bytes += math.ceil(n / div)              # 1 byte / element
                param_bytes += math.ceil(shape[-1] / div) * 4  # f32 scales
            else:
                param_bytes += math.ceil(n / div) * itemsize
    page = (engine.num_kv_blocks + 1, engine.block_size, 2 * model.num_kv_heads, model.head_dim)
    if engine.kv_quantized:
        per_layer = (math.ceil(math.prod(page) / tp)
                     + math.ceil(math.prod(page[:-1]) / tp) * 4)
    else:
        per_layer = math.ceil(math.prod(page) / tp) * model.torch_dtype.itemsize
    return MemoryPlan(
        param_bytes_per_chip=param_bytes,
        cache_bytes_per_chip=model.num_layers * per_layer,
        headroom_frac=headroom_frac,
    )
