"""Model and engine configuration for the PyTorch/CUDA serving engine.

Counterpart of ``dynamo_tpu/engine/config.py``: the same dataclasses, the
same field defaults and the same presets, so a configuration means the
same model and the same engine shape on both packages. The one change is
the dtype accessor: ``torch_dtype`` replaces ``jax_dtype``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float16": torch.float16,
}


@dataclass(frozen=True)
class ModelConfig:
    """Llama-family decoder-only transformer hyperparameters."""

    name: str = "llama"
    vocab_size: int = 128256
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    rope_theta: float = 500000.0
    rms_norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    # Byte-level models (test tokenizer) tie embeddings to save params.
    tie_embeddings: bool = False
    # Qwen2-family attention: biases on the fused qkv projection only.
    attn_qkv_bias: bool = False
    # Sparse MoE (Mixtral-style): 0 experts = dense MLP. Per-expert
    # capacity = ceil(N * top_k / E * factor); tokens past it drop for
    # that expert. ``moe_dispatch`` picks the expert-parallel mode under a
    # mesh of tp ranks (``model._moe_mlp``); on one device both values
    # are the local dispatch.
    num_experts: int = 0
    num_experts_per_tok: int = 2
    moe_capacity_factor: float = 2.0
    moe_dispatch: str = "replicated"

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def q_size(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_size(self) -> int:
        return self.num_kv_heads * self.head_dim

    def param_bytes(self) -> int:
        """Approximate parameter footprint at the configured dtype."""
        h, i, v = self.hidden_size, self.intermediate_size, self.vocab_size
        per_layer = (
            h * (self.q_size + 2 * self.kv_size)  # wq, wk, wv
            + self.q_size * h                     # wo
            + 3 * h * i                           # gate, up, down
            + 2 * h                               # norms
        )
        total = v * h + self.num_layers * per_layer + h + (0 if self.tie_embeddings else h * v)
        return total * self.torch_dtype.itemsize

    def quantized_param_bytes(self) -> int:
        """Footprint with int8 weight-only quantization (projections and
        lm_head at 1 byte, embeddings and norms at the model dtype)."""
        h, i, v = self.hidden_size, self.intermediate_size, self.vocab_size
        proj_per_layer = (
            h * (self.q_size + 2 * self.kv_size) + self.q_size * h + 3 * h * i
        )
        bytes_per = self.torch_dtype.itemsize
        int8_bytes = self.num_layers * proj_per_layer
        bf16_bytes = (v * h + 2 * h * self.num_layers + h) * bytes_per
        if not self.tie_embeddings:
            int8_bytes += h * v
        return int8_bytes + bf16_bytes


@dataclass(frozen=True)
class EngineConfig:
    """Serving-engine shape and capacity knobs.

    Field for field the JAX package's ``EngineConfig``; see that class for
    the meaning of each knob. The port's ``EngineCore`` serves the subset
    listed in ``ROADMAP.md`` and refuses the rest by name.
    """

    num_kv_blocks: int = 2048
    block_size: int = 32
    kv_dtype: str = "bf16"
    max_num_seqs: int = 64
    max_model_len: int = 8192
    prefill_buckets: tuple[int, ...] = (128, 512, 2048, 8192)
    prefill_batch: int = 8
    host_kv_blocks: int = 0
    disk_kv_dir: str | None = None
    disk_kv_blocks: int = 4096
    enable_prefix_caching: bool = True
    decode_buckets: tuple[int, ...] = (8, 16, 32, 64)
    # Legacy alias of megastep_k (see megastep).
    decode_chain: int = 8
    # Decode iterations per device dispatch; 0 inherits decode_chain.
    megastep_k: int = 0
    # Prompt tokens from which an engine with an sp group prefills round
    # the ring (``EngineCore._maybe_ring_prefill``); 0 turns it off.
    ring_prefill_threshold: int = 0
    scheduling: str = "waves"
    prefill_chunk: int = 0
    max_num_batched_tokens: int = 0
    async_exec: bool = False
    held_block_ttl_s: float = 180.0
    fair_scheduling: bool = False
    fair_quantum: int = 0
    max_waiting: int = 0
    spec_decode: str = "off"
    spec_k: int = 4
    spec_ngram_min: int = 1
    spec_ngram_max: int = 3
    spec_window: int = 1024
    spec_device_draft: bool = False

    @property
    def kv_quantized(self) -> bool:
        return self.kv_dtype == "int8"

    @property
    def megastep(self) -> int:
        """Resolved decode-megastep length: ``megastep_k`` when set (>= 1),
        else the legacy ``decode_chain`` knob it supersedes."""
        return self.megastep_k if self.megastep_k >= 1 else self.decode_chain

    @property
    def max_blocks_per_seq(self) -> int:
        return (self.max_model_len + self.block_size - 1) // self.block_size

    @property
    def token_budget(self) -> int:
        return self.max_num_batched_tokens or self.prefill_buckets[-1]

    @property
    def fair_quantum_resolved(self) -> int:
        return self.fair_quantum or self.token_budget

    @property
    def chunk_size(self) -> int:
        if self.prefill_chunk:
            return self.prefill_chunk
        target = max(self.token_budget // 4, self.prefill_buckets[0])
        fitting = [b for b in self.prefill_buckets if b <= target]
        return fitting[-1] if fitting else self.prefill_buckets[0]

    @property
    def total_slots(self) -> int:
        # One extra garbage block at index `num_kv_blocks` absorbs writes
        # from padded positions.
        return (self.num_kv_blocks + 1) * self.block_size

    @property
    def garbage_block(self) -> int:
        return self.num_kv_blocks


# -- presets ---------------------------------------------------------------

def llama3_8b() -> ModelConfig:
    return ModelConfig(name="llama3-8b")


def llama3_70b() -> ModelConfig:
    return ModelConfig(
        name="llama3-70b",
        hidden_size=8192,
        intermediate_size=28672,
        num_layers=80,
        num_heads=64,
        num_kv_heads=8,
    )


def llama3_1b() -> ModelConfig:
    """Llama-3.2-1B-proportioned preset (16 heads x 128 head_dim, the JAX
    package's TPU-aligned variant of upstream's 32 x 64)."""
    return ModelConfig(
        name="llama3-1b",
        hidden_size=2048,
        intermediate_size=8192,
        num_layers=16,
        num_heads=16,
        num_kv_heads=8,
        head_dim=128,
        tie_embeddings=True,
    )


def qwen2_7b() -> ModelConfig:
    """Qwen2.5-7B: GQA llama-family body plus qkv biases."""
    return ModelConfig(
        name="qwen2-7b",
        vocab_size=152064,
        hidden_size=3584,
        intermediate_size=18944,
        num_layers=28,
        num_heads=28,
        num_kv_heads=4,
        head_dim=128,
        rope_theta=1000000.0,
        rms_norm_eps=1e-6,
        attn_qkv_bias=True,
    )


def mixtral_8x7b() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b",
        vocab_size=32000,
        hidden_size=4096,
        intermediate_size=14336,
        num_layers=32,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        rope_theta=1000000.0,
        num_experts=8,
        num_experts_per_tok=2,
    )


def tiny_moe(vocab_size: int = 384) -> ModelConfig:
    return ModelConfig(
        name="tiny-moe",
        vocab_size=vocab_size,
        hidden_size=64,
        intermediate_size=96,
        num_layers=2,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        rope_theta=10000.0,
        dtype="float32",
        tie_embeddings=True,
        num_experts=4,
        num_experts_per_tok=2,
    )


def tiny_model(vocab_size: int = 384) -> ModelConfig:
    """Byte-tokenizer-sized model for tests and CPU smoke runs."""
    return ModelConfig(
        name="tiny",
        vocab_size=vocab_size,
        hidden_size=64,
        intermediate_size=128,
        num_layers=2,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        rope_theta=10000.0,
        dtype="float32",
        tie_embeddings=True,
    )


def tiny_engine(**overrides) -> EngineConfig:
    defaults = dict(
        num_kv_blocks=64,
        block_size=8,
        max_num_seqs=8,
        max_model_len=256,
        prefill_buckets=(32, 64, 128),  # < max_model_len: exercises chunking
        decode_buckets=(4, 8),
    )
    defaults.update(overrides)
    return EngineConfig(**defaults)


PRESETS = {
    "llama3-8b": llama3_8b,
    "llama3-70b": llama3_70b,
    "llama3-1b": llama3_1b,
    "qwen2-7b": qwen2_7b,
    "mixtral-8x7b": mixtral_8x7b,
    "tiny": tiny_model,
    "tiny-moe": tiny_moe,
}
