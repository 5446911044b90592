"""Worker-side publishers: KV cache events and load metrics.

The port's copy of ``dynamo_tpu/llm/kv_router/publisher.py``, held to it by
``tests/test_torch_copies.py``.

The engine (real or mock) calls ``stored``/``removed`` as its paged cache
mutates; events batch onto the control-plane subject consumed by
:class:`~dynamo_tpu.llm.kv_router.indexer.KvIndexer`. Metrics publish on a
fixed cadence for the router's load term and the planner.

Event delivery is a BOUNDED buffer drained by one publisher task: the
engine side enqueues (never blocks, never awaits the store) and the drain
task publishes in order. When the buffer overflows — the stream backed up
faster than the store could take it — events are dropped *visibly*
(``events_dropped_total``, the ``kv_events_dropped_total`` gauge) and the
publisher schedules an ANTI-ENTROPY RESYNC: a ``cleared`` event followed
by a full re-publish of the worker's current inventory (the
``inventory_source`` snapshot), which supersedes whatever the drops
desynchronized. Indexers that detect an event-id gap can also *request*
a resync on the ``kv_events_resync`` subject (see ``start``).

Capability parity: reference `lib/llm/src/kv_router/publisher.rs:100-482`
(KvEventPublisher, WorkerMetricsPublisher). The reference listens to the
engine over ZMQ because vLLM is a foreign process; our JAX engine is
in-process, so publishing is a direct call — one IPC hop gone.
"""

from __future__ import annotations

import asyncio
import logging
from collections import deque
from dataclasses import dataclass, field
from typing import Awaitable, Callable

import msgpack

from dynamo_tpu_torch.llm.kv_router.protocols import (
    ForwardPassMetrics,
    KvCacheEvent,
    RouterEvent,
    kv_events_subject,
    kv_resync_subject,
    load_metrics_subject,
)

log = logging.getLogger("dynamo_tpu.kv_router.publisher")


# A full-inventory snapshot entry: (tier, block_hash, parent_hash).
InventoryEntry = "tuple[str, int, int | None]"


class KvEventPublisher:
    """Ordered, bounded, tier-aware KV event publisher for one worker.

    Every mutation entry point is loop-affine (``*_nowait`` from the event
    loop, or hopped there via ``call_soon_threadsafe`` by the engine
    callbacks); the single drain task preserves publish order, so
    per-worker event ids are monotonic in delivery order.
    """

    def __init__(
        self,
        store,
        namespace: str,
        component: str,
        worker_id: int,
        buffer: int = 4096,
    ):
        self._store = store
        self._subject = kv_events_subject(namespace, component)
        self._resync_subject = kv_resync_subject(namespace, component)
        self.worker_id = worker_id
        self._event_id = 0
        self._buffer = max(1, buffer)
        self._buf: deque[KvCacheEvent] = deque()
        self._wakeup = asyncio.Event()
        self._task: asyncio.Task | None = None
        self._resync_sub = None
        self._resync_task: asyncio.Task | None = None
        self._idle = asyncio.Event()
        self._idle.set()
        # Observability (kv_pool_* / kv_events_* gauges).
        self.events_published_total = 0
        self.events_dropped_total = 0
        self.resyncs_total = 0
        self._needs_resync = False
        # Net stored-minus-removed per tier: this worker's contribution
        # to the cluster-wide pool index, as advertised so far.
        self.published_blocks: dict[str, int] = {}
        # Full-inventory snapshot for the resync path: a callable
        # returning [(tier, hash, parent), ...] in chain order. Unset =
        # resync degrades to a bare `cleared` (consumers drop this
        # worker rather than serving stale hints).
        self.inventory_source: Callable[[], list] | None = None
        # True (default): the snapshot blocks (the jax kv_inventory takes
        # the engine step lock) and runs under to_thread. Set False for
        # loop-affine sources (the mocker's kv manager mutates only on
        # the loop — reading it from a thread would race the sim loop).
        self.inventory_blocking = True

    # -- lifecycle ---------------------------------------------------------

    async def start(self) -> None:
        """Optional: listen for indexer-initiated resync requests. The
        drain task itself starts lazily on the first enqueue."""
        self._resync_sub = await self._store.subscribe(self._resync_subject)
        self._resync_task = asyncio.create_task(self._resync_loop())

    async def stop(self) -> None:
        if self._task:
            self._task.cancel()
        if self._resync_task:
            self._resync_task.cancel()
        if self._resync_sub:
            await self._resync_sub.unsubscribe()

    async def _resync_loop(self) -> None:
        assert self._resync_sub is not None
        async for ev in self._resync_sub:
            try:
                d = msgpack.unpackb(ev["p"], raw=False)
            except (TypeError, ValueError, msgpack.UnpackException):
                continue
            if isinstance(d, dict) and d.get("w") == self.worker_id:
                log.info(
                    "kv publisher %d: resync requested by an indexer",
                    self.worker_id,
                )
                self.request_resync()

    # -- enqueue side (loop-affine, non-blocking) --------------------------

    def _enqueue(self, event: KvCacheEvent) -> None:
        if len(self._buf) >= self._buffer:
            # Backed-up stream: drop visibly and schedule anti-entropy —
            # a silent drop here is a stale router hint forever.
            self.events_dropped_total += len(event.block_hashes) or 1
            self._needs_resync = True
        else:
            self._buf.append(event)
        self._idle.clear()
        self._wakeup.set()
        if self._task is None or self._task.done():
            self._task = asyncio.get_running_loop().create_task(self._drain())

    def stored_nowait(
        self,
        block_hashes: list[int],
        parent_hash: int | None,
        tier: str = "device",
    ) -> None:
        if block_hashes:
            self._enqueue(
                KvCacheEvent(
                    op="stored",
                    block_hashes=tuple(block_hashes),
                    parent_hash=parent_hash,
                    tier=tier,
                )
            )

    def removed_nowait(self, block_hashes: list[int], tier: str = "device") -> None:
        if block_hashes:
            self._enqueue(
                KvCacheEvent(
                    op="removed", block_hashes=tuple(block_hashes), tier=tier
                )
            )

    def cleared_nowait(self) -> None:
        self._enqueue(KvCacheEvent(op="cleared"))

    def request_resync(self) -> None:
        """Force a full-inventory re-publish on the next drain cycle."""
        self._needs_resync = True
        self._idle.clear()
        self._wakeup.set()
        if self._task is None or self._task.done():
            self._task = asyncio.get_running_loop().create_task(self._drain())

    # Async wrappers (historic surface; enqueue-and-return).

    async def stored(
        self,
        block_hashes: list[int],
        parent_hash: int | None,
        tier: str = "device",
    ) -> None:
        self.stored_nowait(block_hashes, parent_hash, tier)

    async def removed(self, block_hashes: list[int], tier: str = "device") -> None:
        self.removed_nowait(block_hashes, tier)

    async def cleared(self) -> None:
        self.cleared_nowait()

    # -- drain task --------------------------------------------------------

    async def _publish(self, event: KvCacheEvent) -> None:
        self._event_id += 1
        router_event = RouterEvent(self.worker_id, self._event_id, event)
        try:
            await self._store.publish(self._subject, router_event.to_wire())
            self.events_published_total += 1
            self._account(event)
        except ConnectionError:
            log.warning("kv event publish failed (store down?)")

    def _account(self, event: KvCacheEvent) -> None:
        if event.op == "stored":
            self.published_blocks[event.tier] = (
                self.published_blocks.get(event.tier, 0) + len(event.block_hashes)
            )
        elif event.op == "removed":
            self.published_blocks[event.tier] = max(
                0,
                self.published_blocks.get(event.tier, 0) - len(event.block_hashes),
            )
        elif event.op == "cleared":
            self.published_blocks.clear()

    async def _drain(self) -> None:
        while True:
            if self._needs_resync:
                self._needs_resync = False
                await self._do_resync()
                continue
            if not self._buf:
                self._idle.set()
                self._wakeup.clear()
                await self._wakeup.wait()
                continue
            await self._publish(self._buf.popleft())

    async def _do_resync(self) -> None:
        """Anti-entropy: `cleared` + the full current inventory. Whatever
        the dropped events desynchronized, the snapshot supersedes —
        buffered (pre-snapshot) events are superseded too, so the buffer
        is flushed rather than published out of order."""
        self.resyncs_total += 1
        self._buf.clear()
        inventory = []
        if self.inventory_source is not None:
            try:
                # Off the loop when blocking: the jax snapshot takes the
                # engine's step lock (and the offload condition) —
                # blocking here would freeze the loop for a device step
                # and starve the store lease keepalive. Loop-affine
                # sources (mocker) run inline instead — their state is
                # only coherent on the loop.
                if self.inventory_blocking:
                    inventory = list(await asyncio.to_thread(self.inventory_source))
                else:
                    inventory = list(self.inventory_source())
            except Exception:  # noqa: BLE001 — a bare clear beats a dead drain task
                log.exception("kv inventory snapshot failed; publishing bare clear")
        await self._publish(KvCacheEvent(op="cleared"))
        # Chain order matters: the snapshot is (tier, hash, parent) in
        # prefix order per sequence, so each stored event's parent is
        # already published when the indexer applies it. Contiguous
        # same-tier chain runs batch into ONE multi-hash event — a
        # thousand-block resync is tens of store round trips, not
        # thousands serialized on the drain task.
        run: list[int] = []
        run_tier = ""
        run_parent: int | None = None
        n = 0

        async def _flush_run() -> None:
            if run:
                await self._publish(
                    KvCacheEvent(
                        op="stored", block_hashes=tuple(run),
                        parent_hash=run_parent, tier=run_tier,
                    )
                )

        for tier, h, parent in inventory:
            n += 1
            if run and tier == run_tier and parent == run[-1]:
                run.append(h)
                continue
            await _flush_run()
            run, run_tier, run_parent = [h], tier, parent
        await _flush_run()
        log.info(
            "kv publisher %d: resynced %d inventory blocks after gap/drop",
            self.worker_id, n,
        )

    async def flush(self, timeout: float = 5.0) -> bool:
        """Wait until every enqueued event (and any pending resync) has
        been published; True on success, False on timeout. Drain-path
        callers flush before revoking the lease so retraction events
        actually reach the store."""
        if self._task is None and not self._buf and not self._needs_resync:
            return True
        try:
            await asyncio.wait_for(self._idle.wait(), timeout)
            return True
        except asyncio.TimeoutError:
            log.warning(
                "kv publisher %d: flush timed out with %d event(s) queued",
                self.worker_id, len(self._buf),
            )
            return False

    # -- observability -----------------------------------------------------

    def stats(self) -> dict:
        return {
            "events_published": self.events_published_total,
            "events_dropped": self.events_dropped_total,
            "events_queued": len(self._buf),
            "resyncs": self.resyncs_total,
            "published_blocks": sum(self.published_blocks.values()),
            **{
                f"published_{tier}_blocks": n
                for tier, n in sorted(self.published_blocks.items())
            },
        }


class WorkerMetricsPublisher:
    def __init__(
        self,
        store,
        namespace: str,
        component: str,
        worker_id: int,
        collect: Callable[[], ForwardPassMetrics],
        interval_s: float = 1.0,
    ):
        self._store = store
        self._subject = load_metrics_subject(namespace, component)
        self.worker_id = worker_id
        self._collect = collect
        self._interval = interval_s
        self._task: asyncio.Task | None = None

    async def start(self) -> None:
        self._task = asyncio.create_task(self._loop())

    async def stop(self) -> None:
        if self._task:
            self._task.cancel()

    async def publish_now(self) -> None:
        metrics = self._collect()
        metrics.worker_id = self.worker_id
        try:
            await self._store.publish(self._subject, metrics.to_wire())
        except ConnectionError:
            pass

    async def _loop(self) -> None:
        while True:
            await self.publish_now()
            await asyncio.sleep(self._interval)


class MetricsAggregator:
    """Router/planner-side: latest ForwardPassMetrics per worker.

    Parity: reference `kv_router/metrics_aggregator.rs` + `scoring.rs:93`
    (ProcessedEndpoints).
    """

    def __init__(self, store, namespace: str, component: str):
        self._store = store
        self._subject = load_metrics_subject(namespace, component)
        self.latest: dict[int, ForwardPassMetrics] = {}
        self._task: asyncio.Task | None = None
        self._sub = None
        self.on_update: list[Callable[[ForwardPassMetrics], None]] = []

    @property
    def degraded(self) -> bool:
        """True while the control-plane session is down (ISSUE 15):
        ``latest`` is a last-known-good snapshot, not a live feed —
        busy-set and routing consumers keep it rather than treating
        fleet-wide silence on the metrics subject as death."""
        # getattr twice over: tests build partial aggregators via __new__.
        store = getattr(self, "_store", None)
        return not getattr(store, "connected", True)

    async def start(self) -> None:
        self._sub = await self._store.subscribe(self._subject)
        self._task = asyncio.create_task(self._loop())

    async def stop(self) -> None:
        if self._task:
            self._task.cancel()
        if self._sub:
            await self._sub.unsubscribe()

    async def _loop(self) -> None:
        assert self._sub is not None
        async for ev in self._sub:
            try:
                metrics = ForwardPassMetrics.from_wire(ev["p"])
                self.latest[metrics.worker_id] = metrics
                for cb in self.on_update:
                    cb(metrics)
            except Exception:  # noqa: BLE001
                log.exception("bad metrics payload")

    def remove_worker(self, worker_id: int) -> None:
        self.latest.pop(worker_id, None)

    def snapshot(self) -> "ProcessedEndpoints":
        """Cluster-wide aggregate view for scheduler/planner consumers
        (reference scoring.rs:93 ProcessedEndpoints)."""
        workers = dict(self.latest)
        usages = {w: m.kv.gpu_cache_usage_perc for w, m in workers.items()}
        slots_total = sum(m.worker.request_total_slots for m in workers.values())
        slots_active = sum(m.worker.request_active_slots for m in workers.values())
        waiting = sum(m.worker.num_requests_waiting for m in workers.values())
        return ProcessedEndpoints(
            worker_ids=sorted(workers),
            kv_usage=usages,
            avg_kv_usage=(sum(usages.values()) / len(usages)) if usages else 0.0,
            max_kv_usage=max(usages.values(), default=0.0),
            total_slots=slots_total,
            active_slots=slots_active,
            requests_waiting=waiting,
        )

@dataclass
class ProcessedEndpoints:
    """One coherent scrape of the worker fleet's load."""

    worker_ids: list[int] = field(default_factory=list)
    kv_usage: dict[int, float] = field(default_factory=dict)
    avg_kv_usage: float = 0.0
    max_kv_usage: float = 0.0
    total_slots: int = 0
    active_slots: int = 0
    requests_waiting: int = 0
