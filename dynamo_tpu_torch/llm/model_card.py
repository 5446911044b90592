"""Model Deployment Card (MDC): everything a frontend needs to serve a model.

The port's copy of ``dynamo_tpu/llm/model_card.py``, held to it by
``tests/test_torch_copies.py``.

Workers build an MDC at registration time; frontends fetch it via the
control plane's object store and use it to construct the preprocessor,
decoder, and router for that model — no worker round-trip on the request
path.

Capability parity: reference `lib/llm/src/model_card.rs:91,147-236`
(ModelDeploymentCard: tokenizer kind, prompt formatter, context length, kv
block size, migration limit, runtime config; stored in NATS object store;
``mdcsum`` checksum).
"""

from __future__ import annotations

import hashlib
from dataclasses import asdict, dataclass, field
from typing import Any

import msgpack

MDC_BUCKET = "mdc"


@dataclass
class ModelRuntimeConfig:
    """Worker-engine facts the router/planner need (parity:
    `local_model/runtime_config.rs` + vllm main.py:227-247)."""

    total_kv_blocks: int | None = None
    max_num_seqs: int | None = None
    max_num_batched_tokens: int | None = None
    extra: dict[str, Any] = field(default_factory=dict)


@dataclass
class ModelDeploymentCard:
    name: str
    tokenizer: str = "byte"            # "byte" | local HF path
    model_path: str | None = None      # weights location for workers
    model_type: str = "chat"           # "chat" | "completions" | "embedding" | "backend"
    context_length: int = 8192
    kv_block_size: int = 32
    migration_limit: int = 3
    runtime_config: ModelRuntimeConfig = field(default_factory=ModelRuntimeConfig)

    def to_wire(self) -> bytes:
        return msgpack.packb(asdict(self))

    @classmethod
    def from_wire(cls, raw: bytes) -> "ModelDeploymentCard":
        d = msgpack.unpackb(raw, raw=False)
        rc = d.pop("runtime_config", {}) or {}
        return cls(**d, runtime_config=ModelRuntimeConfig(**rc))

    def checksum(self) -> str:
        """mdcsum — content address of the card."""
        return hashlib.blake2b(self.to_wire(), digest_size=16).hexdigest()

    async def publish(self, store) -> str:
        """Store under the object bucket; returns the checksum key."""
        key = self.checksum()
        await store.obj_put(MDC_BUCKET, key, self.to_wire())
        return key

    @classmethod
    async def fetch(cls, store, checksum: str) -> "ModelDeploymentCard":
        raw = await store.obj_get(MDC_BUCKET, checksum)
        if raw is None:
            raise KeyError(f"no model card {checksum}")
        return cls.from_wire(raw)
