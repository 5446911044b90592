"""The fleet aggregator: compose worker snapshots into one fleet view.

The port's copy of ``dynamo_tpu/obs/aggregator.py``, held to it by
``tests/test_torch_copies.py``.

Subscribes to ``obs_snapshots.{namespace}`` and keeps the latest
:class:`~dynamo_tpu.obs.snapshot.MetricSnapshot` per worker. Exposure:

- **Fleet /metrics** — every worker's gauge families re-exported with a
  ``worker_id`` label (the SAME metric names and keys the per-worker
  status servers export, via the shared gauge tables in
  ``runtime/status_server.py``), plus ``dynamo_fleet_*`` rollups
  (sum / max / p50 / p99 across live workers).
- **Series retirement** — a worker's series are REMOVED (not zeroed) on:
  a ``retired`` snapshot (graceful drain), a discovery instance-removal
  event (lease loss — wire via :meth:`attach_client`), or snapshot
  staleness (no publish for ``stale_after_s``; the backstop for a
  chaos-killed process the watch hasn't caught yet). The PR 11
  inventory-retirement shape, applied to metrics.
- **Tenant cardinality cap** — fleet per-tenant queue gauges cap at
  :data:`MAX_TENANT_GAUGES` series + ``__other__``, with retired
  tenants' series removed (PR 10's rule, applied uniformly here).
- **Planner feed** — :meth:`observation` diffs consecutive aggregate
  states into one adjustment window's planner ``Observation`` (request
  rate / ISL / OSL / TTFT / ITL from frontend snapshots, per-phase means
  from the live workers' cumulative phase totals) — the planner now
  observes the EVENT PLANE, not a point scrape.
- **SLO attribution** — per-request phase records inside the snapshots
  feed a :class:`~dynamo_tpu.obs.slo.SloAttributor` (``dynamo_slo_*``
  histograms + the ``/fleet`` payload).
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Callable

from dynamo_tpu_torch.obs.slo import SloAttributor, SloTargets, quantile
from dynamo_tpu_torch.obs.snapshot import MetricSnapshot, obs_subject
from dynamo_tpu_torch.runtime.status_server import (
    KV_CACHE_GAUGES,
    KV_POOL_GAUGES,
    MAX_TENANT_GAUGES,
    SCHEDULER_GAUGES,
    SPEC_GAUGES,
)

log = logging.getLogger("dynamo_tpu.obs.aggregator")

# family name in the snapshot -> (gauge table, service label). The tables
# are the single source of truth for names/docs — per-worker /metrics and
# the fleet view can never drift apart.
FAMILY_TABLES: dict[str, tuple[dict, str]] = {
    "scheduler": (SCHEDULER_GAUGES, "engine"),
    "spec": (SPEC_GAUGES, "engine"),
    "kv_cache": (KV_CACHE_GAUGES, "engine"),
    "kv_pool": (KV_POOL_GAUGES, "kv_pool"),
}

ROLLUP_STATS = ("sum", "max", "p50", "p99")

# The capped-overflow tenant label (shared spelling with PR 10's export).
OTHER = "__other__"


class FleetAggregator:
    """Latest-snapshot fleet state + /metrics exporter + planner feed."""

    def __init__(
        self,
        store,
        namespace: str = "dynamo",
        stale_after_s: float = 10.0,
        slo_targets: SloTargets | None = None,
        max_tenants: int = MAX_TENANT_GAUGES,
    ):
        self._store = store
        self.namespace = namespace
        self.stale_after_s = stale_after_s
        self.max_tenants = max_tenants
        self.latest: dict[int, MetricSnapshot] = {}      # role == "worker"
        self.frontends: dict[int, MetricSnapshot] = {}   # role == "frontend"
        self.slo = SloAttributor(targets=slo_targets, namespace=namespace)
        self.snapshots_received_total = 0
        self.workers_retired_total = 0
        self._sub = None
        self._task: asyncio.Task | None = None
        self._metrics = None  # MetricsRegistry the fleet series land on
        # Closed-loop controller (ISSUE 14): when attached, its decision
        # counters/replica gauges export with the fleet series and the
        # /fleet payload grows a "planner" section.
        self._controller = None
        # Removal bookkeeping: what was exported, so retirement can
        # remove exactly those series (never zero them).
        self._exported_workers: set[int] = set()
        self._exported_tenants: set[str] = set()
        self._exported_rollups: set[tuple[str, str]] = set()  # (fam, key)
        # observation() diff state.
        self._prev_totals: dict[str, float] | None = None
        self._prev_t: float = 0.0
        # Control-plane-dark bookkeeping (ISSUE 15): while the store
        # session is down, NOBODY can publish — snapshot silence is an
        # outage symptom, not worker death, so staleness retirement is
        # suspended; after reconnection every publisher gets one fresh
        # ``stale_after_s`` window to re-appear before retirement resumes.
        self._was_dark = False
        self._dark_grace_until = 0.0
        # Last-seen cumulative typed-shed counter per worker: sheds are
        # diffed per worker (retirement-aware), never on the fleet total.
        self._prev_sheds: dict[int, float] = {}
        self._last_means = (256.0, 128.0)

    # -- lifecycle ---------------------------------------------------------

    async def start(self) -> None:
        self._sub = await self._store.subscribe(obs_subject(self.namespace))
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
                self.ingest(MetricSnapshot.from_wire(ev["p"]))
            except Exception:  # noqa: BLE001 — one bad snapshot must not kill the view
                log.exception("bad snapshot payload")

    # -- ingest + retirement -----------------------------------------------

    def ingest(self, snap: MetricSnapshot) -> None:
        self.snapshots_received_total += 1
        # Staleness is judged against THIS clock (arrival time), never the
        # publisher's wall clock — cross-host skew > stale_after_s must
        # not flap a healthy worker in and out of the fleet view.
        snap.received_at = time.time()
        if snap.retired:
            # Drain retraction: series leave NOW, not at lease expiry.
            self.remove_worker(snap.worker_id)
            return
        side = "frontend" if snap.role == "frontend" else "worker"
        store = self.frontends if side == "frontend" else self.latest
        prev = store.get(snap.worker_id)
        if (
            prev is not None
            and snap.epoch == prev.epoch
            and snap.seq <= prev.seq
        ):
            # Out-of-order redelivery from the SAME publisher incarnation.
            # A different epoch is a restarted process re-using a pinned
            # worker_id: its seq starts over at 1 and must replace the
            # dead incarnation's state immediately.
            return
        store[snap.worker_id] = snap
        if snap.requests:
            self.slo.ingest(snap.requests, side=side)

    def remove_worker(self, worker_id: int) -> None:
        """Retire a worker's fleet series (drain retraction, discovery
        instance removal = lease loss, or staleness)."""
        was = self.latest.pop(worker_id, None) or self.frontends.pop(
            worker_id, None
        )
        if was is not None:
            self.workers_retired_total += 1
        self._remove_series(worker_id)

    def attach_client(self, client) -> None:
        """Retire on lease loss: discovery instance-removal events (the
        same watch the router uses to drop dead workers)."""
        client.on_instance_removed.append(self.remove_worker)

    def attach_controller(self, controller) -> None:
        """Export a PlannerController's decision counters and replica
        gauges on the fleet registry (``planner_*`` series, synced on
        every render like the rest) and surface its status in the
        ``/fleet`` payload — the operator reads what the control loop
        did and why from the same place they read the fleet's load."""
        self._controller = controller

    def live_workers(self) -> list[int]:
        return sorted(self.latest)

    # -- /metrics export ---------------------------------------------------

    def bind(self, metrics, before_render: list) -> None:
        """Export the fleet view on a MetricsRegistry, synced by a
        pre-render hook (the status server's ``before_render`` or the
        HTTP frontend's ``before_metrics``)."""
        self._metrics = metrics
        before_render.append(self.sync)

    def _remove_series(self, worker_id: int) -> None:
        if self._metrics is None or worker_id not in self._exported_workers:
            return
        self._exported_workers.discard(worker_id)
        for _fam, (table, service) in FAMILY_TABLES.items():
            scoped = self._metrics.scoped(
                namespace=self.namespace, service=service,
                worker_id=str(worker_id),
            )
            for _key, (name, _doc) in table.items():
                scoped.remove_gauge(name)

    @property
    def control_plane_dark(self) -> bool:
        """True while this process's store session is down: the event
        plane cannot deliver snapshots, so the fleet view is a frozen
        last-known-good, and "publisher went quiet" means nothing."""
        return not getattr(self._store, "connected", True)

    def sweep_stale(self, now: float | None = None) -> list[int]:
        """Retire workers that stopped publishing (the chaos-kill /
        dead-process backstop when no watch event reached us).

        Suspended while the control plane is dark — a blackout silences
        every publisher at once, and retiring the whole healthy fleet on
        that is the flap ISSUE 15 quarantines. After reconnection the
        fleet gets one fresh ``stale_after_s`` window to republish."""
        now = time.time() if now is None else now
        if self.control_plane_dark:
            self._was_dark = True
            return []
        if self._was_dark:
            self._was_dark = False
            self._dark_grace_until = now + self.stale_after_s
        if now < self._dark_grace_until:
            return []
        stale = [
            w
            for w, s in list(self.latest.items()) + list(self.frontends.items())
            if now - s.received_at > self.stale_after_s
        ]
        for w in stale:
            log.warning("retiring stale worker %d (no snapshot)", w)
            self.remove_worker(w)
        return stale

    def sync(self) -> None:
        """Pre-render: refresh every exported series from the latest
        snapshots. Dead/drained workers' series were already removed at
        retirement; staleness is swept here too so a scrape never shows
        a silently-dead worker as fresh."""
        if self._metrics is None:
            return
        self.sweep_stale()
        self.slo.sweep()
        # Per-worker series, labeled worker_id (+ namespace, so several
        # embedded aggregators sharing one frontend registry can never
        # write — or retire — each other's series).
        for wid, snap in self.latest.items():
            self._exported_workers.add(wid)
            for fam, (table, service) in FAMILY_TABLES.items():
                vals = snap.families.get(fam)
                if not vals:
                    continue
                scoped = self._metrics.scoped(
                    namespace=self.namespace, service=service,
                    worker_id=str(wid),
                )
                for key, (name, doc) in table.items():
                    if key in vals:
                        scoped.gauge(name, doc).set(vals[key])
        # Fleet rollups across live workers. A rollup whose LAST
        # contributing worker retired is removed like any other series
        # (never left frozen at the dead fleet's final values).
        for fam, (table, service) in FAMILY_TABLES.items():
            for key, (name, doc) in table.items():
                series = sorted(
                    s.families[fam][key]
                    for s in self.latest.values()
                    if fam in s.families and key in s.families[fam]
                )
                if not series:
                    if (fam, key) in self._exported_rollups:
                        self._exported_rollups.discard((fam, key))
                        for stat in ROLLUP_STATS:
                            self._metrics.scoped(
                                namespace=self.namespace,
                                service=service, stat=stat,
                            ).remove_gauge(f"fleet_{name}")
                    continue
                self._exported_rollups.add((fam, key))
                rollups = {
                    "sum": float(sum(series)),
                    "max": series[-1],
                    "p50": quantile(series, 0.50),
                    "p99": quantile(series, 0.99),
                }
                for stat in ROLLUP_STATS:
                    self._metrics.scoped(
                        namespace=self.namespace, service=service, stat=stat,
                    ).gauge(
                        f"fleet_{name}",
                        f"Fleet rollup ({'/'.join(ROLLUP_STATS)} across "
                        f"live workers) of {name}: {doc}",
                    ).set(rollups[stat])
        self._sync_tenants()
        self._sync_planner()
        # Aggregator health.
        agg = self._metrics.scoped(namespace=self.namespace, service="obs")
        agg.gauge(
            "obs_live_workers", "Workers with a fresh snapshot in the fleet view"
        ).set(float(len(self.latest)))
        agg.gauge(
            "obs_snapshots_received_total",
            "Metric snapshots ingested from the event plane since start",
        ).set(float(self.snapshots_received_total))
        agg.gauge(
            "obs_workers_retired_total",
            "Workers whose series were retired (drain / lease loss / "
            "staleness) since start",
        ).set(float(self.workers_retired_total))
        agg.gauge(
            "obs_control_plane_dark",
            "1 while the aggregator's store session is down (snapshot "
            "silence is the outage, not worker death; staleness "
            "retirement is suspended)",
        ).set(1.0 if self.control_plane_dark else 0.0)

    def _sync_tenants(self) -> None:
        """Fleet per-tenant queue gauges, cardinality-capped: at most
        ``max_tenants`` tenant series + ``__other__``, retired tenants'
        series REMOVED — the PR 10 rule applied to the aggregator, so a
        churning fleet or adversarial x-tenant-id spray cannot grow the
        aggregator's /metrics unboundedly."""
        fleet: dict[str, dict[str, float]] = {}
        for snap in self.latest.values():
            for tenant, st in snap.tenants.items():
                agg = fleet.setdefault(tenant, {"depth": 0.0, "deficit": 0.0})
                for k in agg:
                    agg[k] += float(st.get(k, 0.0))
        if len(fleet) > self.max_tenants:
            ranked = sorted(fleet.items(), key=lambda kv: -kv[1]["depth"])
            capped = dict(ranked[: self.max_tenants])
            other = {"depth": 0.0, "deficit": 0.0}
            for _t, st in ranked[self.max_tenants:]:
                for k in other:
                    other[k] += st[k]
            capped[OTHER] = other
            fleet = capped
        for tenant in self._exported_tenants - set(fleet):
            scoped = self._metrics.scoped(
                namespace=self.namespace, service="fleet", tenant=tenant
            )
            scoped.remove_gauge("fleet_tenant_queue_depth")
            scoped.remove_gauge("fleet_tenant_deficit_tokens")
        self._exported_tenants.intersection_update(fleet)
        for tenant, st in fleet.items():
            self._exported_tenants.add(tenant)
            scoped = self._metrics.scoped(
                namespace=self.namespace, service="fleet", tenant=tenant
            )
            scoped.gauge(
                "fleet_tenant_queue_depth",
                "Requests waiting in this tenant's admission queues, "
                "summed across live workers",
            ).set(st["depth"])
            scoped.gauge(
                "fleet_tenant_deficit_tokens",
                "The tenant's DRR deficit balance, summed across live workers",
            ).set(st["deficit"])

    def _sync_planner(self) -> None:
        """Planner decision observability (ISSUE 14): decision counters
        by action, per-pool current/desired replica gauges — the
        controller's stats() payload re-exported as fleet series."""
        if self._controller is None or self._metrics is None:
            return
        st = self._controller.stats()
        base = self._metrics.scoped(namespace=self.namespace, service="planner")
        base.gauge(
            "planner_cycles_total",
            "Closed-loop adjustment cycles the controller has run",
        ).set(float(st.get("cycles", 0)))
        for action, n in (st.get("decisions") or {}).items():
            self._metrics.scoped(
                namespace=self.namespace, service="planner", action=action
            ).gauge(
                "planner_decisions_total",
                "Controller decisions by outcome (scale_up / scale_down / "
                "hold / cooldown_hold / hysteresis_hold)",
            ).set(float(n))
        for comp, pool in (st.get("pools") or {}).items():
            scoped = self._metrics.scoped(
                namespace=self.namespace, service="planner", component=comp
            )
            scoped.gauge(
                "planner_current_replicas",
                "Replica count the controller last actuated for this pool",
            ).set(float(pool.get("target", 0)))
            scoped.gauge(
                "planner_target_replicas",
                "This cycle's desired replica count (pre-hysteresis/"
                "cooldown), from the plan math + reactive pressure",
            ).set(float(pool.get("desired", 0)))

    # -- planner feed ------------------------------------------------------

    def _totals(self) -> dict[str, float]:
        """Cumulative fleet totals over LIVE publishers only: frontend
        request/latency counters + per-phase (count, sum) pairs collapsed
        by phase name."""
        totals: dict[str, float] = {}
        for snap in self.frontends.values():
            for k, v in (snap.families.get("frontend") or {}).items():
                totals[k] = totals.get(k, 0.0) + v
        for snap in list(self.latest.values()) + list(self.frontends.values()):
            for key, (count, sec) in snap.phases.items():
                phase = key.rsplit("/", 1)[-1]
                totals[f"phase_count/{phase}"] = (
                    totals.get(f"phase_count/{phase}", 0.0) + count
                )
                totals[f"phase_sum/{phase}"] = (
                    totals.get(f"phase_sum/{phase}", 0.0) + sec
                )
        # Closed-loop signals (ISSUE 14): the SLO attributor's attainment
        # counters, diffed per window by observation(). (Typed sheds are
        # NOT totalled here — observation() diffs them per worker so a
        # retiring worker's cumulative counter leaving the sum cannot
        # clamp the fleet-wide delta to zero.)
        for k, v in self.slo.attainment_counters().items():
            totals[f"slo_{k}"] = v
        return totals

    def observation(self):
        """One adjustment window's planner Observation from the aggregate
        (the event-plane twin of planner/observer.py's point scrape —
        same diff math, fed by snapshots from LIVE workers only)."""
        from dynamo_tpu_torch.planner.planner_core import Observation

        self.sweep_stale()
        # Blind window (ISSUE 15): assembled while the store session was
        # down (or just after — the re-publish grace), so rates/queues in
        # it are phantom zeros. The controller holds on this flag.
        degraded = self.control_plane_dark or (
            self._was_dark or time.time() < self._dark_grace_until
        )
        now = time.monotonic()
        cur = self._totals()
        # Typed sheds: per-worker cumulative counters diffed per worker.
        # A retired worker simply drops out of the dict; a worker id
        # reused by a restarted process restarts near zero and clamps.
        cur_sheds: dict[int, float] = {}
        for wid, snap in self.latest.items():
            sched = snap.families.get("scheduler") or {}
            cur_sheds[wid] = float(sched.get("shed_total", 0) or 0) + float(
                sched.get("deadline_expired_total", 0) or 0
            )
        shed_delta = sum(
            max(0.0, v - self._prev_sheds.get(wid, 0.0))
            for wid, v in cur_sheds.items()
        )
        self._prev_sheds = cur_sheds
        prev, prev_t = self._prev_totals, self._prev_t
        self._prev_totals, self._prev_t = cur, now
        if prev is None:
            return Observation(
                request_rate=0.0,
                mean_isl=self._last_means[0],
                mean_osl=self._last_means[1],
                control_plane_degraded=degraded,
            )
        window = max(now - prev_t, 1e-6)

        def delta(name: str) -> float:
            return max(0.0, cur.get(name, 0.0) - prev.get(name, 0.0))

        def mean(prefix: str, fallback: float) -> float:
            c = delta(f"{prefix}_count")
            return delta(f"{prefix}_sum") / c if c > 0 else fallback

        isl = mean("isl", self._last_means[0])
        osl = mean("osl", self._last_means[1])
        self._last_means = (isl, osl)
        ttft_c = delta("ttft_count")
        itl_c = delta("itl_count")
        phase_means: dict[str, float] = {}
        for key in cur:
            if not key.startswith("phase_count/"):
                continue
            phase = key[len("phase_count/"):]
            c = delta(key)
            if c > 0:
                phase_means[phase] = delta(f"phase_sum/{phase}") / c
        # Closed-loop signals: point-in-time fleet queue depth, windowed
        # typed sheds, windowed SLO attainment (None when nothing
        # finished this window), live worker counts per component.
        queue_depth = 0.0
        queue_by_comp: dict[str, float] = {}
        live: dict[str, int] = {}
        for snap in self.latest.values():
            sched = snap.families.get("scheduler") or {}
            waiting = float(sched.get("waiting", 0) or 0)
            queue_depth += waiting
            queue_by_comp[snap.component] = (
                queue_by_comp.get(snap.component, 0.0) + waiting
            )
            live[snap.component] = live.get(snap.component, 0) + 1
        attainment: dict[str, float] = {}
        ttft_n = delta("slo_ttft_n")
        if ttft_n > 0:
            attainment["ttft"] = delta("slo_ttft_ok") / ttft_n
        tpot_n = delta("slo_tpot_n")
        if tpot_n > 0:
            attainment["tpot"] = delta("slo_tpot_ok") / tpot_n
        return Observation(
            request_rate=delta("requests_total") / window,
            mean_isl=isl,
            mean_osl=osl,
            observed_ttft_s=(delta("ttft_sum") / ttft_c) if ttft_c else None,
            observed_itl_s=(delta("itl_sum") / itl_c) if itl_c else None,
            phase_means=phase_means or None,
            queue_depth=queue_depth,
            queue_depths=queue_by_comp or None,
            shed_delta=shed_delta,
            slo_attainment=attainment or None,
            live_workers=live or None,
            control_plane_degraded=degraded,
        )

    # -- /fleet payload ----------------------------------------------------

    def fleet_payload(self) -> dict:
        """The ``/fleet`` status page: live workers with headline load,
        the per-tenant SLO breakdown, and aggregator health."""
        self.sweep_stale()
        self.slo.sweep()
        now = time.time()

        def worker_row(snap: MetricSnapshot) -> dict:
            sched = snap.families.get("scheduler") or {}
            kv = snap.families.get("kv_cache") or {}
            return {
                "role": snap.role,
                "component": snap.component,
                "seq": snap.seq,
                "age_s": round(max(0.0, now - snap.received_at), 3),
                "waiting": sched.get("waiting", 0),
                "running": sched.get("running", 0),
                "budget_utilization": sched.get(
                    "last_step_budget_utilization", 0.0
                ),
                "kv_resident_blocks": kv.get("resident_blocks", 0),
                "kv_capacity_blocks": kv.get("capacity_blocks", 0),
            }

        return {
            "namespace": self.namespace,
            "live_workers": self.live_workers(),
            "workers": {
                str(w): worker_row(s) for w, s in sorted(self.latest.items())
            },
            "frontends": {
                str(w): worker_row(s)
                for w, s in sorted(self.frontends.items())
            },
            "slo": self.slo.summary(),
            "planner": (
                self._controller.status_payload()
                if self._controller is not None
                else None
            ),
            "snapshots_received": self.snapshots_received_total,
            "workers_retired": self.workers_retired_total,
        }
