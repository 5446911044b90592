"""Metric snapshots over the store/event plane: the wire + the publisher.

The port's copy of ``dynamo_tpu/obs/snapshot.py``, held to it by
``tests/test_torch_copies.py``.

Workers (and frontends) publish one compact :class:`MetricSnapshot` per
interval on ``obs_snapshots.{namespace}`` — the same pub/sub plane the KV
events and load metrics already ride (reference ``components/metrics``
over NATS, PAPER.md §L0/L1). The fleet aggregator composes them into
``/metrics`` series with ``worker_id`` labels and rollups.

The publish path is OFF the hot step: a periodic asyncio task reads the
engines' existing stats dicts (the exact callables the status-server
gauges already bind), the tracer's cumulative per-phase totals, and the
finished-request phase records — no host sync, no step-lock hold, no
work added to plan/dispatch. Snapshots ride a bounded loop-affine buffer
(``_snapbuf``) drained by one ordered task, mirroring the KvEventPublisher
shape; overflow drops the OLDEST snapshot visibly (latest-wins — a
snapshot is a point-in-time state, unlike a KV event there is nothing to
resync).
"""

from __future__ import annotations

import asyncio
import logging
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable

import msgpack

from dynamo_tpu_torch.runtime import wire

log = logging.getLogger("dynamo_tpu.obs.snapshot")


def obs_subject(namespace: str) -> str:
    """One subject per namespace: every component's snapshots land here
    (the snapshot itself carries role + component)."""
    return f"obs_snapshots.{namespace}"


@dataclass
class MetricSnapshot:
    """One publisher's point-in-time metric state.

    ``families`` maps a family name ("scheduler", "kv_cache", "spec",
    "kv_pool", "frontend", ...) to a flat numeric dict — the same keys
    the status-server gauge tables export, so the aggregator re-labels
    without translation. ``phases`` carries CUMULATIVE per-phase
    ``(count, sum_seconds)`` pairs keyed ``service/phase`` (the
    aggregator diffs consecutive snapshots into per-window means).
    ``requests`` carries finished per-request phase records (SLO
    attribution) observed since the previous snapshot. ``retired=True``
    is the drain retraction: the aggregator drops every series for this
    worker immediately instead of waiting for staleness/lease expiry.
    """

    worker_id: int
    role: str = "worker"  # "worker" | "frontend"
    component: str = ""
    seq: int = 0
    t: float = 0.0
    # Publisher incarnation (stamped once per SnapshotPublisher): a
    # restarted process re-using a pinned worker_id starts seq over at 1,
    # and the aggregator must not drop its fresh snapshots as
    # out-of-order against the dead incarnation's higher seq.
    epoch: float = 0.0
    retired: bool = False
    families: dict[str, dict[str, float]] = field(default_factory=dict)
    tenants: dict[str, dict[str, float]] = field(default_factory=dict)
    phases: dict[str, tuple[float, float]] = field(default_factory=dict)
    requests: list[dict] = field(default_factory=list)
    # Aggregator-local arrival stamp (NOT on the wire): staleness is
    # judged against the aggregator's own clock, so cross-host clock skew
    # can never retire a live, publishing worker.
    received_at: float = 0.0

    def to_wire(self) -> bytes:
        d: dict[str, Any] = {
            wire.SNAP_WORKER: self.worker_id,
            wire.SNAP_ROLE: self.role,
            wire.SNAP_COMPONENT: self.component,
            wire.SNAP_SEQ: self.seq,
            wire.SNAP_TIME: self.t,
            wire.SNAP_EPOCH: self.epoch,
            wire.SNAP_FAMILIES: self.families,
            wire.SNAP_TENANTS: self.tenants,
            wire.SNAP_PHASES: {k: [c, s] for k, (c, s) in self.phases.items()},
            wire.SNAP_REQUESTS: self.requests,
        }
        if self.retired:
            d[wire.SNAP_RETIRED] = 1
        return msgpack.packb(d, use_bin_type=True)

    @classmethod
    def from_wire(cls, raw: bytes) -> "MetricSnapshot":
        d = msgpack.unpackb(raw, raw=False)
        return cls(
            worker_id=d[wire.SNAP_WORKER],
            role=d.get(wire.SNAP_ROLE, "worker"),
            component=d.get(wire.SNAP_COMPONENT, ""),
            seq=d.get(wire.SNAP_SEQ, 0),
            t=d.get(wire.SNAP_TIME, 0.0),
            epoch=d.get(wire.SNAP_EPOCH, 0.0),
            retired=bool(d.get(wire.SNAP_RETIRED, 0)),
            families=d.get(wire.SNAP_FAMILIES, {}),
            tenants=d.get(wire.SNAP_TENANTS, {}),
            phases={k: (v[0], v[1]) for k, v in (d.get(wire.SNAP_PHASES) or {}).items()},
            requests=list(d.get(wire.SNAP_REQUESTS) or []),
        )


def numeric_only(d: dict) -> dict[str, float]:
    """Snapshot families carry numbers only (strings like kv_dtype stay
    on the worker's own /metrics as info gauges)."""
    return {k: float(v) for k, v in d.items() if isinstance(v, (int, float))}


# Frontend metric families mirrored into the "frontend" snapshot family:
# prometheus sample name -> snapshot key. Cumulative, like every family —
# the aggregator diffs windows (MetricsObserver's math, event-plane fed).
_FRONTEND_SAMPLES = {
    "dynamo_frontend_requests_total": "requests_total",
    "dynamo_frontend_requests_shed_total": "shed_total",
    "dynamo_frontend_inflight_requests": "inflight",
    "dynamo_frontend_time_to_first_token_seconds_sum": "ttft_sum",
    "dynamo_frontend_time_to_first_token_seconds_count": "ttft_count",
    "dynamo_frontend_inter_token_latency_seconds_sum": "itl_sum",
    "dynamo_frontend_inter_token_latency_seconds_count": "itl_count",
    "dynamo_frontend_input_sequence_tokens_sum": "isl_sum",
    "dynamo_frontend_input_sequence_tokens_count": "isl_count",
    "dynamo_frontend_output_sequence_tokens_sum": "osl_sum",
    "dynamo_frontend_output_sequence_tokens_count": "osl_count",
}


def frontend_totals(metrics) -> dict[str, float]:
    """Sum the frontend's request/latency series (labels collapsed) from
    its live MetricsRegistry — the "frontend" snapshot family that feeds
    the fleet observer's planner Observation."""
    totals: dict[str, float] = {}
    for metric in metrics.registry.collect():
        for sample in metric.samples:
            key = _FRONTEND_SAMPLES.get(sample.name)
            if key is not None:
                totals[key] = totals.get(key, 0.0) + float(sample.value)
    return totals


class SnapshotPublisher:
    """Periodic snapshot publisher for one process.

    ``collectors`` maps family name -> zero-arg callable returning a
    stats dict (the same callables the status-server gauges bind);
    ``tenant_source`` the per-tenant fair-queue stats; ``phase_source``
    the tracer's cumulative per-phase totals; ``request_source`` the
    finished-request phase records since last call (SLO attribution).

    All buffer mutation is loop-affine: the tick task builds + enqueues,
    the single drain task publishes in order (KvEventPublisher's shape).
    """

    def __init__(
        self,
        store,
        namespace: str,
        worker_id: int,
        role: str = "worker",
        component: str = "",
        interval_s: float = 1.0,
        buffer: int = 64,
    ):
        self._store = store
        self._subject = obs_subject(namespace)
        self.worker_id = worker_id
        self.role = role
        self.component = component
        self.interval_s = max(0.01, interval_s)
        self._buffer = max(1, buffer)
        # Incarnation stamp: lets the aggregator tell a restarted
        # publisher (seq reset) from an out-of-order redelivery.
        self.epoch = time.time()
        self._snapbuf: deque[MetricSnapshot] = deque()
        self._wakeup = asyncio.Event()
        self._idle = asyncio.Event()
        self._idle.set()
        self._seq = 0
        self._tick_task: asyncio.Task | None = None
        self._drain_task: asyncio.Task | None = None
        self.collectors: dict[str, Callable[[], dict]] = {}
        self.tenant_source: Callable[[], dict] | None = None
        self.phase_source: Callable[[], dict] | None = None
        self.request_source: Callable[[], list] | None = None
        # Observability of the observability: publish/drop counters.
        self.snapshots_published_total = 0
        self.snapshots_dropped_total = 0
        self.publish_errors_total = 0

    # -- snapshot build (loop-affine, non-blocking) ------------------------

    def build(self, retired: bool = False) -> MetricSnapshot:
        self._seq += 1
        families: dict[str, dict[str, float]] = {}
        for name, collect in self.collectors.items():
            try:
                families[name] = numeric_only(collect())
            except Exception:  # noqa: BLE001 — one bad family must not kill the tick
                log.exception("snapshot collector %r failed", name)
        tenants: dict[str, dict[str, float]] = {}
        if self.tenant_source is not None:
            try:
                tenants = {
                    str(t): numeric_only(st)
                    for t, st in self.tenant_source().items()
                }
            except Exception:  # noqa: BLE001
                log.exception("snapshot tenant source failed")
        phases: dict[str, tuple[float, float]] = {}
        if self.phase_source is not None:
            phases = dict(self.phase_source())
        requests: list = []
        if self.request_source is not None:
            try:
                requests = list(self.request_source())
            except Exception:  # noqa: BLE001
                log.exception("snapshot request source failed")
        return MetricSnapshot(
            worker_id=self.worker_id,
            role=self.role,
            component=self.component,
            seq=self._seq,
            t=time.time(),
            epoch=self.epoch,
            retired=retired,
            families=families,
            tenants=tenants,
            phases=phases,
            requests=requests,
        )

    def publish_nowait(self, retired: bool = False) -> None:
        snap = self.build(retired=retired)
        if len(self._snapbuf) >= self._buffer:
            # Latest-wins: a snapshot is point-in-time state, so the
            # OLDEST is the one to drop — visibly.
            self._snapbuf.popleft()
            self.snapshots_dropped_total += 1
        self._snapbuf.append(snap)
        self._idle.clear()
        self._wakeup.set()
        if self._drain_task is None or self._drain_task.done():
            self._drain_task = asyncio.get_running_loop().create_task(
                self._drain()
            )

    # -- lifecycle ---------------------------------------------------------

    async def start(self) -> None:
        if self._tick_task is None or self._tick_task.done():
            self._tick_task = asyncio.create_task(self._tick_loop())

    async def stop(self) -> None:
        if self._tick_task:
            self._tick_task.cancel()
        if self._drain_task:
            self._drain_task.cancel()

    async def retire(self, timeout: float = 5.0) -> bool:
        """Drain retraction: publish one final ``retired`` snapshot and
        flush, so the aggregator removes this worker's series NOW rather
        than at staleness/lease expiry (the PR 11 inventory-retirement
        shape). Called from ``runtime.on_drain``."""
        if self._tick_task:
            self._tick_task.cancel()
        self.publish_nowait(retired=True)
        return await self.flush(timeout)

    async def flush(self, timeout: float = 5.0) -> bool:
        if not self._snapbuf and (
            self._drain_task is None or self._drain_task.done()
        ):
            return True
        try:
            await asyncio.wait_for(self._idle.wait(), timeout)
            return True
        except asyncio.TimeoutError:
            log.warning(
                "snapshot publisher %d: flush timed out (%d queued)",
                self.worker_id, len(self._snapbuf),
            )
            return False

    # -- tasks -------------------------------------------------------------

    async def _tick_loop(self) -> None:
        while True:
            self.publish_nowait()
            await asyncio.sleep(self.interval_s)

    async def _drain(self) -> None:
        while True:
            if not self._snapbuf:
                self._idle.set()
                self._wakeup.clear()
                await self._wakeup.wait()
                continue
            snap = self._snapbuf.popleft()
            try:
                await self._store.publish(self._subject, snap.to_wire())
                self.snapshots_published_total += 1
            except ConnectionError:
                self.publish_errors_total += 1
                log.warning("snapshot publish failed (store down?)")
            except Exception:  # noqa: BLE001 — the drain task must survive any
                # one bad publish: dying here strands _idle cleared, so
                # every later flush()/retire() burns its full timeout.
                self.publish_errors_total += 1
                log.exception("snapshot publish failed")

    # -- observability -----------------------------------------------------

    def stats(self) -> dict:
        return {
            "snapshots_published": self.snapshots_published_total,
            "snapshots_dropped": self.snapshots_dropped_total,
            "publish_errors": self.publish_errors_total,
            "queued": len(self._snapbuf),
        }
