"""KV-aware routing: the indexer, the router and its scheduler, and the
worker-side KV event and load-metrics publishers.

The port's copy of ``dynamo_tpu/llm/kv_router/__init__.py``, held to it by
``tests/test_torch_copies.py``.
"""

from dynamo_tpu_torch.llm.kv_router.indexer import KvIndexer, RadixTree
from dynamo_tpu_torch.llm.kv_router.protocols import (
    ForwardPassMetrics,
    KvCacheEvent,
    RouterConfig,
    RouterEvent,
)
from dynamo_tpu_torch.llm.kv_router.router import KvPushRouter, KvRouter
from dynamo_tpu_torch.llm.kv_router.scheduler import DefaultWorkerSelector, softmax_sample
from dynamo_tpu_torch.llm.kv_router.sequence import ActiveSequences

__all__ = [
    "ActiveSequences",
    "DefaultWorkerSelector",
    "ForwardPassMetrics",
    "KvCacheEvent",
    "KvIndexer",
    "KvPushRouter",
    "KvRouter",
    "RadixTree",
    "RouterConfig",
    "RouterEvent",
    "softmax_sample",
]
