"""The worker side of KV-aware routing: the KV event and load-metrics
publishers and their wire types.

The router, the indexer and the scheduler of ``dynamo_tpu/llm/kv_router``
run in the frontend, which the port does not have yet (``ROADMAP.md`` A6b).
"""

from dynamo_tpu_torch.llm.kv_router.protocols import (
    ForwardPassMetrics,
    KvCacheEvent,
    RouterEvent,
)
from dynamo_tpu_torch.llm.kv_router.publisher import KvEventPublisher, WorkerMetricsPublisher

__all__ = [
    "ForwardPassMetrics",
    "KvCacheEvent",
    "KvEventPublisher",
    "RouterEvent",
    "WorkerMetricsPublisher",
]
