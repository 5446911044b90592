"""Worker load monitor: mark workers busy above a KV-usage threshold.

The port's copy of ``dynamo_tpu/runtime/worker_monitor.py``, held to it by
``tests/test_torch_copies.py``.

Capability parity: reference `lib/runtime/src/utils/worker_monitor.rs:50-89`
— the frontend watches per-worker ForwardPassMetrics and routes around
workers whose KV usage exceeds ``busy_threshold`` (busy-aware routing).

Built on :class:`~dynamo_tpu.llm.kv_router.publisher.MetricsAggregator`
(the one subscription to the load-metrics subject): the aggregator owns
the latest-metrics view and ProcessedEndpoints snapshots; this monitor is
the incremental busy-set policy on top of it. One subject subscription,
one busy implementation.
"""

from __future__ import annotations

import logging
from typing import Callable

from dynamo_tpu_torch.llm.kv_router.protocols import ForwardPassMetrics
from dynamo_tpu_torch.llm.kv_router.publisher import MetricsAggregator

log = logging.getLogger("dynamo_tpu.worker_monitor")


class WorkerMonitor:
    # Class-level default: tests (and older callers) build partial
    # monitors via __new__ without running __init__.
    queue_threshold: int | None = None

    def __init__(
        self,
        store,
        namespace: str,
        component: str,
        busy_threshold: float = 0.95,
        queue_threshold: int | None = None,
        on_busy_change: Callable[[int, bool], None] | None = None,
        aggregator: MetricsAggregator | None = None,
    ):
        self.aggregator = aggregator or MetricsAggregator(store, namespace, component)
        self.busy_threshold = busy_threshold
        # Saturation-aware routing (ISSUE 10): a worker is also busy when
        # its scheduler queue is saturated — at `queue_threshold` queued
        # requests, or (None = auto) at the bounded-queue limit the
        # worker itself exports in WorkerStats.queue_limit. Routing to a
        # worker that is about to shed just burns a dial + a migration.
        self.queue_threshold = queue_threshold
        self.on_busy_change = on_busy_change or (lambda w, b: None)
        self.busy: set[int] = set()
        self.aggregator.on_update.append(self._on_metrics)

    @property
    def metrics(self) -> dict[int, ForwardPassMetrics]:
        return self.aggregator.latest

    @property
    def degraded(self) -> bool:
        """True while the control plane is dark (ISSUE 15): the busy set
        and metrics view freeze at last-known-good — silence on the
        metrics subject is an outage symptom, not a fleet-wide idle."""
        return self.aggregator.degraded

    async def start(self) -> None:
        await self.aggregator.start()

    async def stop(self) -> None:
        await self.aggregator.stop()

    def _saturated(self, fpm: ForwardPassMetrics) -> bool:
        w = fpm.worker
        limit = self.queue_threshold
        if limit is None:
            limit = w.queue_limit or 0
        return bool(limit) and w.num_requests_waiting >= limit

    def _on_metrics(self, fpm: ForwardPassMetrics) -> None:
        worker_id = fpm.worker_id
        usage = fpm.kv.gpu_cache_usage_perc
        was_busy = worker_id in self.busy
        now_busy = usage >= self.busy_threshold or self._saturated(fpm)
        if now_busy != was_busy:
            (self.busy.add if now_busy else self.busy.discard)(worker_id)
            log.info(
                "worker %d busy=%s (kv %.0f%%, queued %d)",
                worker_id, now_busy, usage * 100,
                fpm.worker.num_requests_waiting,
            )
            self.on_busy_change(worker_id, now_busy)

    def eligible(self, workers: list[int]) -> list[int]:
        """Filter busy workers out (all-busy falls back to the full set —
        shedding beats rejecting)."""
        free = [w for w in workers if w not in self.busy]
        return free or workers

    def remove_worker(self, worker_id: int) -> None:
        self.aggregator.remove_worker(worker_id)
        self.busy.discard(worker_id)
