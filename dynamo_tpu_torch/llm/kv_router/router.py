"""The KV router: prefix-overlap-aware request dispatch.

The port's copy of ``dynamo_tpu/llm/kv_router/router.py``, held to it by
``tests/test_torch_copies.py``.

``KvRouter`` owns the index (event-driven or approximate), the active
sequence bookkeeping, and the selector. ``KvPushRouter`` binds it to an
endpoint client: every request is hashed into blocks, scored, dispatched
``direct`` to the chosen worker, and its bookkeeping freed when the stream
ends — including the worker-death path, which also drops the dead worker
from the index.

Capability parity: reference `lib/llm/src/kv_router.rs:158` (KvRouter),
`:342` (KvPushRouter); per-request overrides `:79`.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, AsyncIterator

from dynamo_tpu_torch import tracing
from dynamo_tpu_torch.llm.kv_router.indexer import ApproxKvIndexer, KvIndexer
from dynamo_tpu_torch.llm.kv_router.protocols import (
    RouterConfig,
    kv_events_subject,
    kv_resync_subject,
)
from dynamo_tpu_torch.llm.kv_router.scheduler import DefaultWorkerSelector, SelectionResult
from dynamo_tpu_torch.llm.kv_router.sequence import ActiveSequences
from dynamo_tpu_torch.runtime.component import EndpointClient, NoInstancesError
from dynamo_tpu_torch.tokens import compute_seq_hashes

log = logging.getLogger("dynamo_tpu.kv_router")


def best_peer_hint(overlaps: dict[int, int]) -> tuple[int, int]:
    """The peer worth pulling a cached prefix from: most overlap blocks,
    ties broken DETERMINISTICALLY by lowest worker_id. A bare
    ``max(..., key=value)`` breaks ties by dict insertion order, which
    varies with KV-event arrival — routing traces and chaos replays must
    reproduce, so the tie-break is pinned (test_kv_router)."""
    return max(overlaps.items(), key=lambda kv: (kv[1], -kv[0]))


class KvRouter:
    def __init__(
        self,
        store,
        namespace: str,
        component: str,
        config: RouterConfig | None = None,
    ):
        config = config or RouterConfig()
        if config.block_size is None:
            # Default on a copy — never mutate the caller's config object.
            config = dataclasses.replace(config, block_size=32)
        self.config = config
        self.active = ActiveSequences(block_size=self.config.block_size)
        # Network-aware scoring (NetKV, ISSUE 14): measured transfer cost
        # + queue depth extend the overlap cost. The netcost model's
        # fleet view is wired by KvPushRouter from its WorkerMonitor.
        self.netcost = None
        if self.config.network_aware:
            from dynamo_tpu_torch.llm.kv_router.netcost import (
                NetCostModel,
                NetworkAwareSelector,
            )

            self.netcost = NetCostModel(
                recompute_ms_per_block=self.config.recompute_ms_per_block
            )
            self.selector: DefaultWorkerSelector = NetworkAwareSelector(
                self.netcost
            )
        else:
            self.selector = DefaultWorkerSelector()
        if self.config.use_kv_events:
            self.indexer: KvIndexer | ApproxKvIndexer = KvIndexer(
                store,
                kv_events_subject(namespace, component),
                resync_subject=kv_resync_subject(namespace, component),
            )
        else:
            self.indexer = ApproxKvIndexer()
        self.sync = None
        if self.config.replica_sync:
            from dynamo_tpu_torch.llm.kv_router.replica_sync import ReplicaSync

            self.sync = ReplicaSync(store, namespace, component, self)

    async def start(self) -> None:
        if isinstance(self.indexer, KvIndexer):
            await self.indexer.start()
        if self.sync is not None:
            await self.sync.start()

    async def stop(self) -> None:
        if self.sync is not None:
            await self.sync.stop()
        if isinstance(self.indexer, KvIndexer):
            await self.indexer.stop()

    # -- replica-sync introspection ---------------------------------------

    def indexer_tree(self):
        return self.indexer.tree if isinstance(self.indexer, KvIndexer) else None

    def known_workers(self) -> set[int]:
        return (
            set(self.indexer.known_workers)
            if isinstance(self.indexer, KvIndexer)
            else set()
        )

    def apply_radix_event(self, event) -> None:
        """Feed a bootstrap radix event through the indexer's one apply
        path (KvIndexer.apply); a no-op for the approx indexer."""
        if isinstance(self.indexer, KvIndexer):
            self.indexer.apply(event)

    def find_best_match(
        self,
        request_id: str,
        token_ids: list[int],
        workers: list[int],
        config_override: RouterConfig | None = None,
    ) -> SelectionResult:
        config = config_override or self.config
        seq_hashes = compute_seq_hashes(token_ids, self.config.block_size)
        overlaps = self.indexer.find_matches(seq_hashes)
        result = self.selector.select_worker(
            workers, overlaps, len(token_ids), self.active, config
        )
        result.overlaps = dict(overlaps)
        self.active.add_request(
            request_id, result.worker_id, len(token_ids), result.overlap_blocks
        )
        if self.sync is not None:
            self.sync.publish_add(
                request_id, result.worker_id, len(token_ids), result.overlap_blocks
            )
        if isinstance(self.indexer, ApproxKvIndexer):
            self.indexer.process_routing_decision(result.worker_id, seq_hashes)
        return result

    def note_pinned(self, request_id: str, worker_id: int, prompt_tokens: int) -> None:
        """Bookkeeping for a caller-pinned worker (no selection ran)."""
        self.active.add_request(request_id, worker_id, prompt_tokens, 0)
        if self.sync is not None:
            self.sync.publish_add(request_id, worker_id, prompt_tokens, 0)

    def mark_prefill_done(self, request_id: str) -> None:
        self.active.mark_prefill_done(request_id)
        if self.sync is not None:
            self.sync.publish_prefill_done(request_id)

    def free(self, request_id: str) -> None:
        self.active.free(request_id)
        if self.sync is not None:
            self.sync.publish_free(request_id)

    def remove_worker(self, worker_id: int) -> list[str]:
        self.indexer.remove_worker(worker_id)
        return self.active.remove_worker(worker_id)

    def peer_hint(self, selection: SelectionResult) -> tuple[int, int] | None:
        """The peer-prefix pull hint for a selection: network-aware mode
        uses the selector's cost-decided source (None when no pull beats
        recomputing — a slow peer is left alone even if it overlaps
        best); overlap-only mode keeps the historical most-blocks hint."""
        if self.config.network_aware:
            return selection.pull_hint
        if not selection.overlaps:
            return None
        peer, blocks = best_peer_hint(selection.overlaps)
        if peer != selection.worker_id and blocks > selection.overlap_blocks:
            return peer, blocks
        return None


class KvPushRouter:
    """EndpointClient + KvRouter glued into one `generate` surface."""

    def __init__(self, client: EndpointClient, router: KvRouter, monitor=None):
        self.client = client
        self.router = router
        # Optional WorkerMonitor (runtime/worker_monitor.py): busy-aware
        # routing when the config sets a busy_threshold; its aggregator
        # also feeds ProcessedEndpoints snapshots to observers.
        self.monitor = monitor
        if monitor is not None and getattr(router, "netcost", None) is not None:
            # The netcost model reads queue depths and every worker's
            # measured per-peer pull costs from the monitor's
            # ForwardPassMetrics view (one subscription, shared).
            router.netcost.fleet_view = lambda: monitor.metrics
        self._tracer = tracing.get_tracer("router")
        client.on_instance_removed.append(self._on_worker_gone)

    def _on_worker_gone(self, worker_id: int) -> None:
        if self.monitor is not None:
            self.monitor.remove_worker(worker_id)
        orphans = self.router.remove_worker(worker_id)
        if orphans:
            log.info("worker %d died with %d in-flight requests", worker_id, len(orphans))

    async def generate(
        self,
        payload: dict,
        request_id: str,
        token_ids: list[int],
        headers: dict[str, str] | None = None,
        router_overrides: dict[str, Any] | None = None,
        exclude: set[int] | None = None,
    ) -> AsyncIterator[Any]:
        overrides = router_overrides or {}
        # Route-decision span: closed before dispatch, so the routing cost
        # never overlaps the worker's prefill phase in the waterfall.
        with self._tracer.span(
            "route", headers=headers, attrs={"request_id": request_id}
        ) as route_span:
            workers = self.client.instance_ids()
            if exclude:
                # Migration retries must not re-dial a worker that just failed —
                # its cached prefix makes it the router's top pick otherwise.
                workers = [w for w in workers if w not in exclude] or workers
            if self.monitor is not None:
                # Busy/saturation-aware routing: the monitor marks
                # workers busy on KV pressure (busy_threshold) or queue
                # saturation (queue_threshold / worker-exported queue
                # limit); an all-busy fleet falls back to the full set.
                workers = self.monitor.eligible(workers)
            if not workers:
                raise NoInstancesError(self.client.endpoint.path)
            pinned = overrides.get("backend_instance_id")
            if pinned is not None:
                selection = SelectionResult(
                    worker_id=pinned, overlap_blocks=0, required_prefill_tokens=len(token_ids), costs={}
                )
                self.router.note_pinned(request_id, pinned, len(token_ids))
            else:
                config = self.router.config
                if "overlap_weight" in overrides or "router_temperature" in overrides:
                    # replace() keeps every other knob (network_aware,
                    # queue_weight, thresholds) at the router's values.
                    config = dataclasses.replace(
                        config,
                        overlap_weight=overrides.get(
                            "overlap_weight", config.overlap_weight
                        ),
                        temperature=overrides.get(
                            "router_temperature", config.temperature
                        ),
                    )
                selection = self.router.find_best_match(request_id, token_ids, workers, config)
                if route_span.recording and selection.score_end_s > selection.score_start_s:
                    # The selector has no trace context; it stamps the
                    # scoring-pass bounds and we file them here, parented
                    # to the route span.
                    self._tracer.record(
                        "overlap_score",
                        selection.score_start_s,
                        selection.score_end_s,
                        parent=route_span,
                        attrs={"workers": len(workers)},
                    )
            route_span.set("worker_id", selection.worker_id)
            route_span.set("overlap_blocks", selection.overlap_blocks)
            route_span.set("required_prefill_tokens", selection.required_prefill_tokens)
            if selection.costs:
                route_span.set("cost", selection.costs.get(selection.worker_id))
        payload = dict(payload)
        payload.setdefault("meta", {})["overlap_blocks"] = selection.overlap_blocks
        # Cross-worker prefix pull (reference KVBM-distributed semantics,
        # block_manager/distributed/leader.rs:64): when routing lands on
        # a worker with LESS of this prompt cached than some peer —
        # busy-avoidance, temperature sampling, migration exclusion — the
        # hint lets the chosen worker pull the peer's blocks (device or
        # offload tiers) over the data plane instead of recomputing. In
        # network-aware mode the hint is cost-decided: a slow/loaded peer
        # is skipped even when it overlaps best (router.peer_hint).
        hint = self.router.peer_hint(selection)
        if hint is not None:
            peer, blocks = hint
            payload["kv_transfer_params"] = dict(
                payload.get("kv_transfer_params") or {},
                peer_prefix={"worker_id": peer, "blocks": blocks},
            )

        first = True
        stream = None
        done = False
        try:
            try:
                stream = await self.client.direct(
                    selection.worker_id, payload, headers
                )
            except (ConnectionError, NoInstancesError) as e:
                # Dial-time failure: tag the instance so migration
                # excludes it on replay (a dead worker's cached prefix
                # would otherwise make it the router's top pick again).
                e.worker_id = selection.worker_id  # type: ignore[attr-defined]
                raise
            while True:
                try:
                    item = await stream.__anext__()
                except StopAsyncIteration:
                    done = True
                    break
                except (ConnectionError, NoInstancesError) as e:
                    done = True  # the worker side is already gone
                    # Tag the failure with the worker so migration can
                    # exclude it on replay.
                    e.worker_id = selection.worker_id  # type: ignore[attr-defined]
                    raise
                except Exception:
                    done = True  # stream-delivered error: server closed it
                    raise
                # CancelledError/GeneratorExit (consumer vanished while
                # awaiting a frame) fall through with done=False — the
                # finally forwards the kill.
                if first:
                    first = False
                    self.router.mark_prefill_done(request_id)
                # The one suspension the CONSUMER can abandon us at
                # (client disconnect -> GeneratorExit/CancelledError
                # thrown here): `done` stays False and the finally
                # forwards the kill.
                yield item
        finally:
            self.router.free(request_id)
            if stream is not None and not done:
                # Consumer vanished mid-stream: forward the kill so the
                # worker drops the request — queued or running — instead
                # of serving a ghost. Fire-and-forget: this finally may
                # be unwinding a cancellation and must not await.
                from dynamo_tpu_torch.runtime.tasks import spawn_logged

                spawn_logged(
                    stream.kill_quietly(),
                    name=f"router-kill-{request_id}",
                    logger=log,
                )

    @property
    def worker_ids(self) -> list[int]:
        return self.client.instance_ids()
