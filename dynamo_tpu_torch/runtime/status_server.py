"""Per-worker system status server: /health, /live, /metrics, /traces.

The port's copy of ``dynamo_tpu/runtime/status_server.py``, held to it by
``tests/test_torch_copies.py``.

Capability parity: reference `lib/runtime/src/system_status_server.rs:31-712`
(axum server per process; per-endpoint health states; uptime gauge;
Prometheus text). Enabled through `DYN_SYSTEM_ENABLED` / `DYN_SYSTEM_PORT`
(`config.rs` DYN_SYSTEM_* prefix).

``/traces`` serves the process-local tracing ring buffer
(dynamo_tpu/tracing) as JSON: recent traces with per-phase waterfalls.
Spans recorded in *other* processes of the same deployment share trace
ids (traceparent propagation over the dataplane), so an operator stitches
a full request by querying each process's ``/traces`` for one trace id —
or, in single-process/frontends, reads the whole waterfall in one place.
"""

from __future__ import annotations

import logging
import time
from typing import Callable

from aiohttp import web

from dynamo_tpu_torch import tracing
from dynamo_tpu_torch.runtime.metrics import MetricsRegistry

log = logging.getLogger("dynamo_tpu.status")

# Scheduler gauge export: stats-dict key -> (metric name, doc). Shared by
# the real engine and the mocker (both expose scheduler_stats() dicts with
# these keys), so every worker's /metrics carries the same series.
SCHEDULER_GAUGES: dict[str, tuple[str, str]] = {
    "waiting": (
        "scheduler_waiting_seqs",
        "Sequences queued for admission (inbox + waiting)",
    ),
    "running": (
        "scheduler_running_seqs",
        "Sequences admitted and running",
    ),
    "preemptions": (
        "scheduler_preemptions_total",
        "Sequences preempted (released + re-queued) since start",
    ),
    "decode_stalls": (
        "scheduler_decode_stalls_total",
        "Decode iterations skipped waiting on a free block (mocker's "
        "preemption-lite; always 0 on the real engine, which preempts)",
    ),
    "last_step_batched_tokens": (
        "scheduler_last_step_batched_tokens",
        "Tokens batched into the most recent mixed step",
    ),
    "last_step_budget_utilization": (
        "scheduler_token_budget_utilization",
        "Most recent mixed step's batched tokens / max_num_batched_tokens",
    ),
    "chunked_prefills_in_flight": (
        "scheduler_chunked_prefills_in_flight",
        "Sequences mid-prefill (first chunk run, prompt not finished)",
    ),
    "chunked_scheduling": (
        "scheduler_chunked_enabled",
        "1 when the chunked token-budget scheduler is active",
    ),
    "token_budget": (
        "scheduler_token_budget",
        "Resolved per-step batched-token budget",
    ),
    # Decode megastep (PERF.md r9): the dispatch-amortization evidence.
    "megastep_k": (
        "scheduler_megastep_k",
        "Resolved decode-megastep length (inner iterations per dispatch)",
    ),
    "megastep_dispatches": (
        "scheduler_megastep_dispatches_total",
        "Device dispatches that fused k > 1 decode iterations",
    ),
    "single_step_dispatches": (
        "scheduler_single_step_dispatches_total",
        "Single-iteration device dispatches (prefill waves, k == 1 "
        "mixed steps / verify rows / decode)",
    ),
    # Universal megastep (ISSUE 12): the lifted-carve-out evidence.
    "fused_mixed_dispatches": (
        "scheduler_fused_mixed_dispatches_total",
        "Universal-megastep dispatches that fused a ragged mixed/verify "
        "first iteration (prefill chunks / spec verify rows) with "
        "scanned decode continuation",
    ),
    "megastep_forced_single": (
        "scheduler_megastep_forced_single_total",
        "Megastep batches forced back to k=1 because a lane's stop "
        "watch overflowed the device's slots — the ONE documented "
        "un-fused path; anything non-zero without >8-stop-id requests "
        "is a bug",
    ),
    "dispatches_per_token": (
        "engine_dispatches_per_token",
        "Device dispatches / committed (client-visible) tokens since "
        "start — < 1.0 means multi-token dispatches are amortizing the "
        "fixed per-dispatch overhead",
    ),
    # Pipeline parallelism (ISSUE 20): fused pp megasteps on the fast path.
    "pp_stages": (
        "scheduler_pp_stages",
        "Pipeline-parallel stages this engine runs (1 = pp off)",
    ),
    "pp_pipe_occupancy": (
        "scheduler_pp_pipe_occupancy",
        "Steady-state pipe occupancy k*M / (k*M + pp - 1) for the "
        "resolved megastep length and microbatch count (1.0 when pp off)",
    ),
    "pp_fused_dispatches": (
        "scheduler_pp_fused_dispatches_total",
        "Fused pp megastep dispatches (k > 1 decode iterations wavefront-"
        "interleaved across the pipe in one device program)",
    ),
    "pp_forced_single": (
        "scheduler_pp_forced_single_total",
        "pp decode dispatches forced back to k=1 (stop-watch overflow — "
        "same documented un-fused path as megastep_forced_single)",
    ),
    # Overload robustness (ISSUE 10): bounded-queue + deadline shedding
    # and the fair-scheduler switch, on BOTH backends.
    "queue_limit": (
        "scheduler_queue_limit",
        "Bounded admission-queue ceiling (0 = unbounded); at the limit "
        "new requests get the typed retryable shed error",
    ),
    "shed_total": (
        "scheduler_requests_shed_total",
        "Requests refused at add_request because the bounded queue was "
        "full (each became a retry-elsewhere error, never a broken stream)",
    ),
    "deadline_expired_total": (
        "scheduler_deadline_expired_total",
        "Queued requests expired past their deadline (typed retryable "
        "error frame; admitted requests always run to completion)",
    ),
    "fair_enabled": (
        "scheduler_fair_enabled",
        "1 when per-tenant deficit-round-robin admission is active",
    ),
}


def bind_scheduler_gauges(
    status: "SystemStatusServer | None", scheduler_stats: Callable[[], dict]
) -> None:
    """Export a worker's scheduler gauges on its status-server /metrics,
    evaluated at scrape time (prometheus set_function — no polling task).
    No-op when the status server is disabled."""
    if status is None:
        return
    scoped = status.metrics.scoped(service="engine")
    for key, (name, doc) in SCHEDULER_GAUGES.items():
        scoped.gauge(name, doc).set_function(
            lambda k=key: float(scheduler_stats().get(k, 0) or 0)
        )


# Speculative-decoding gauge export: stats-dict key -> (name, doc). Keys
# match EngineCore.spec_decode_stats() / MockTpuEngine.spec_decode_stats()
# (SpecStats.as_dict + "enabled").
SPEC_GAUGES: dict[str, tuple[str, str]] = {
    "enabled": (
        "spec_decode_enabled",
        "1 when an engine-level speculative-decoding policy is configured",
    ),
    "acceptance_rate": (
        "spec_decode_acceptance_rate",
        "Drafted tokens the target model accepted / drafted tokens",
    ),
    "mean_accepted_len": (
        "spec_decode_mean_accepted_len",
        "Mean tokens emitted per verify row (>= 1.0; the dispatch "
        "amortization speculation buys)",
    ),
    "drafted_tokens": (
        "spec_decode_drafted_tokens_total",
        "Draft tokens proposed (and verified) since start",
    ),
    "accepted_tokens": (
        "spec_decode_accepted_tokens_total",
        "Draft tokens accepted since start",
    ),
    "wasted_tokens": (
        "spec_decode_wasted_tokens_total",
        "Draft tokens verified and rejected since start (speculation loss)",
    ),
    "verify_steps": (
        "spec_decode_verify_steps_total",
        "Engine steps that carried at least one verify row",
    ),
    # On-device drafting (ISSUE 18): draft->verify->accept rounds riding
    # INSIDE megastep dispatches, and the amortization gauge they move.
    "device_rounds": (
        "spec_device_rounds_total",
        "On-device draft rounds ridden inside megastep dispatches",
    ),
    "device_hits": (
        "spec_device_draft_hits_total",
        "On-device draft rounds whose history-ring match proposed at "
        "least one token",
    ),
    "dispatches_per_accepted_token": (
        "spec_decode_dispatches_per_accepted_token",
        "Device dispatches per accepted draft token (lower is better; "
        "on-device drafting compounds accepted depth per dispatch)",
    ),
}


def bind_spec_gauges(
    status: "SystemStatusServer | None", spec_stats: Callable[[], dict]
) -> None:
    """Export a worker's speculative-decoding gauges on /metrics (same
    scrape-time evaluation as the scheduler gauges)."""
    if status is None:
        return
    scoped = status.metrics.scoped(service="engine")
    for key, (name, doc) in SPEC_GAUGES.items():
        scoped.gauge(name, doc).set_function(
            lambda k=key: float(spec_stats().get(k, 0) or 0)
        )


# Prefix-cache gauge export: stats-dict key -> (name, doc). Keys match
# EngineCore.kv_cache_stats() / MockTpuEngine.kv_cache_stats() — the
# allocator has counted prefix queries/hits since the prefix cache
# landed, but never surfaced them on /metrics.
KV_CACHE_GAUGES: dict[str, tuple[str, str]] = {
    # Quantized-KV capacity observability (ISSUE 8): the int8 capacity
    # doubling must be readable off /metrics, not just asserted in tests.
    "kv_dtype_int8": (
        "kv_cache_dtype_int8",
        "1 when the paged KV cache stores int8 pages + scale metadata "
        "(kv_dtype=int8), 0 for the bf16/model-dtype layout",
    ),
    "bytes_per_block": (
        "kv_cache_bytes_per_block",
        "Bytes one KV block occupies across all layers, scale metadata "
        "included (int8 is ~0.52x the bf16 page at head_dim 128)",
    ),
    "capacity_blocks": (
        "kv_cache_capacity_blocks",
        "Total resident-block capacity of the device KV pool",
    ),
    "resident_blocks": (
        "kv_cache_resident_blocks",
        "KV blocks currently resident (pinned + cached)",
    ),
    "prefix_queries": (
        "kv_prefix_cache_queries_total",
        "match_prefix probes (router overlap scoring, disagg "
        "local-vs-remote decisions) since start",
    ),
    "prefix_hits": (
        "kv_prefix_cache_hits_total",
        "match_prefix probes that found at least one cached leading block",
    ),
    "prefix_hit_rate": (
        "kv_prefix_cache_hit_rate",
        "prefix_hits / prefix_queries (probe series; 0 when no queries)",
    ),
    "admitted_queries": (
        "kv_prefix_cache_admitted_queries_total",
        "Sequences admitted by the scheduler since start",
    ),
    "admitted_hits": (
        "kv_prefix_cache_admitted_hits_total",
        "Admitted sequences whose prompt prefix was served from cache "
        "(device blocks or host-tier onboard)",
    ),
    "admitted_hit_rate": (
        "kv_prefix_cache_admitted_hit_rate",
        "admitted_hits / admitted_queries (0 when nothing admitted yet)",
    ),
}


def bind_kv_cache_gauges(
    status: "SystemStatusServer | None", kv_cache_stats: Callable[[], dict]
) -> None:
    """Export a worker's prefix-cache + KV-layout gauges on /metrics
    (same scrape-time evaluation as the scheduler gauges). The cache
    dtype also exports as a labeled info gauge —
    ``kv_cache_dtype{kv_dtype="int8"} 1`` — the Prometheus idiom for
    string-valued facts."""
    if status is None:
        return
    scoped = status.metrics.scoped(service="engine")
    for key, (name, doc) in KV_CACHE_GAUGES.items():
        scoped.gauge(name, doc).set_function(
            lambda k=key: float(kv_cache_stats().get(k, 0) or 0)
        )
    dtype = str(kv_cache_stats().get("kv_dtype", "") or "")
    if dtype:
        status.metrics.scoped(service="engine", kv_dtype=dtype).gauge(
            "kv_cache_dtype",
            "KV cache storage dtype as an info gauge (value label)",
        ).set(1.0)


# Cluster KV pool gauges (ISSUE 11): the worker's peer-pull outcomes and
# its published global-index contribution. Keys match
# PeerKvClient.pool_stats() + KvEventPublisher.stats() on the jax backend
# and MockTpuEngine.kv_pool_stats() on the mocker — identical series on
# both, like every other gauge family here.
KV_POOL_GAUGES: dict[str, tuple[str, str]] = {
    "pulls_attempted": (
        "kv_pool_peer_pulls_attempted_total",
        "Peer prefix pulls started (router hinted a better-overlapping peer)",
    ),
    "pulls_succeeded": (
        "kv_pool_peer_pulls_succeeded_total",
        "Peer pulls that streamed to completion (imported blocks prefix-hit)",
    ),
    "pulls_fallback": (
        "kv_pool_peer_pulls_fallback_total",
        "Peer pulls that degraded to local recompute (sever/stall/dead "
        "peer/dtype mismatch — never a stalled request)",
    ),
    "blocks_pulled": (
        "kv_pool_blocks_pulled_total",
        "KV blocks imported from peers since start",
    ),
    "bytes_pulled": (
        "kv_pool_bytes_pulled_total",
        "KV page bytes received from peers (canonical packed wire buffer)",
    ),
    "last_pull_ms": (
        "kv_pool_last_pull_latency_ms",
        "Wall-clock latency of the most recent peer pull",
    ),
    "pull_ms_total": (
        "kv_pool_pull_latency_ms_total",
        "Cumulative peer-pull wall-clock milliseconds",
    ),
    "breaker_fast_fails": (
        "kv_pool_breaker_fast_fails_total",
        "Peer pulls refused in microseconds by an open dataplane circuit "
        "breaker (recompute instead of burning a connect timeout)",
    ),
    "dtype_mismatches": (
        "kv_pool_dtype_mismatch_total",
        "Peer pulls refused by the kv_dtype fail-fast contract (mixed "
        "int8/float fleet; re-quantizing would break bit-stability)",
    ),
    "published_blocks": (
        "kv_pool_published_blocks",
        "Net blocks this worker currently advertises to the global index "
        "(its stored-minus-removed contribution, all tiers)",
    ),
    "events_dropped": (
        "kv_events_dropped_total",
        "KV events dropped by the bounded publisher buffer (each schedules "
        "an anti-entropy full-inventory resync)",
    ),
    "events_published": (
        "kv_events_published_total",
        "KV events published to the control plane since start",
    ),
    "resyncs": (
        "kv_events_resyncs_total",
        "Full-inventory re-publishes (after buffer overflow or an "
        "indexer-requested resync)",
    ),
}


def bind_kv_pool_gauges(
    status: "SystemStatusServer | None", kv_pool_stats: Callable[[], dict]
) -> None:
    """Export a worker's cluster-KV-pool gauges on /metrics (same
    scrape-time evaluation as the scheduler gauges). No-op when the
    status server is disabled."""
    if status is None:
        return
    scoped = status.metrics.scoped(service="kv_pool")
    for key, (name, doc) in KV_POOL_GAUGES.items():
        scoped.gauge(name, doc).set_function(
            lambda k=key: float(kv_pool_stats().get(k, 0) or 0)
        )


# Streaming-disaggregation handoff gauges (ISSUE 17): chunk-pipelined
# pull progress on the decode side. `early_chunks` is the headline — a
# nonzero value PROVES transfer/compute overlap (chunks landed before
# the prefill's final cursor), which is what the disagg smoke asserts.
DISAGG_GAUGES: dict[str, tuple[str, str]] = {
    "handoffs_started": (
        "disagg_handoffs_total",
        "Streaming handoffs attempted for remotely-prefilled requests",
    ),
    "handoffs_streamed": (
        "disagg_handoffs_streamed_total",
        "Handoffs fully streamed chunk-by-chunk (legacy pull skipped)",
    ),
    "handoffs_fallback": (
        "disagg_handoff_fallback_total",
        "Handoffs degraded to the reply-gated pull (cursor timeout, "
        "severed window, or import refusal)",
    ),
    "chunks_pulled": (
        "disagg_chunks_pulled_total",
        "KV chunk windows pulled over the streaming handoff",
    ),
    "early_chunks": (
        "disagg_early_chunks_total",
        "Chunk windows pulled BEFORE the prefill finished (the overlap "
        "the subsystem exists to create)",
    ),
    "blocks_streamed": (
        "disagg_streamed_blocks_total",
        "KV blocks moved by streaming windows",
    ),
    "cursor_timeouts": (
        "disagg_cursor_timeouts_total",
        "Handoffs that saw no cursor advance within the timeout",
    ),
}


def bind_disagg_gauges(
    status: "SystemStatusServer | None", disagg_stats: Callable[[], dict]
) -> None:
    """Export a decode worker's streaming-handoff gauges on /metrics."""
    if status is None:
        return
    scoped = status.metrics.scoped(service="disagg")
    for key, (name, doc) in DISAGG_GAUGES.items():
        scoped.gauge(name, doc).set_function(
            lambda k=key: float(disagg_stats().get(k, 0) or 0)
        )


# Per-tenant fair-queue gauges: queue depth and DRR deficit per tenant.
# Tenant labels are dynamic (tenants appear as their first request
# arrives), so these sync via a before_render hook like the egress
# gauges rather than pre-bound set_function children.
FAIR_QUEUE_GAUGES: dict[str, tuple[str, str]] = {
    "depth": (
        "scheduler_tenant_queue_depth",
        "Requests waiting in this tenant's admission queue",
    ),
    "deficit": (
        "scheduler_tenant_deficit_tokens",
        "The tenant's current deficit-round-robin token balance",
    ),
}


# Tenant labels come from the CLIENT-controlled x-tenant-id header, so
# the export is bounded: at most this many distinct tenant series, the
# overflow aggregated under tenant="__other__", and drained tenants'
# series REMOVED (not zeroed) so /metrics output cannot grow without
# bound from a rotating-tenant spray.
MAX_TENANT_GAUGES = 64


def bind_fair_queue_gauges(
    status: "SystemStatusServer | None", fair_queue_stats: Callable[[], dict]
) -> None:
    """Export a worker's per-tenant admission-queue gauges on /metrics
    (labels: service=engine, tenant=<id>). ``fair_queue_stats`` returns
    {tenant: {"depth": n, "deficit": d}} (EngineCore/MockTpuEngine
    fair_queue_stats). No-op when the status server is disabled."""
    if status is None:
        return

    seen: set[str] = set()

    def sync() -> None:
        stats = fair_queue_stats()
        if len(stats) > MAX_TENANT_GAUGES:
            ranked = sorted(
                stats.items(), key=lambda kv: -kv[1].get("depth", 0.0)
            )
            stats = dict(ranked[:MAX_TENANT_GAUGES])
            other = {"depth": 0.0, "deficit": 0.0}
            for _t, st in ranked[MAX_TENANT_GAUGES:]:
                for k in other:
                    other[k] += st.get(k, 0.0)
            stats["__other__"] = other
        # Tenants that left the snapshot take their series with them —
        # a stale zeroed series per tenant-ever-seen is still unbounded
        # /metrics growth.
        for tenant in seen - set(stats):
            scoped = status.metrics.scoped(service="engine", tenant=tenant)
            for _key, (name, _doc) in FAIR_QUEUE_GAUGES.items():
                scoped.remove_gauge(name)
        seen.intersection_update(stats)
        for tenant, st in stats.items():
            seen.add(tenant)
            scoped = status.metrics.scoped(service="engine", tenant=tenant)
            for key, (name, doc) in FAIR_QUEUE_GAUGES.items():
                scoped.gauge(name, doc).set(float(st.get(key, 0.0)))

    status.before_render.append(sync)


# Dataplane egress containment gauges: per-address circuit-breaker state
# and stall counters (EgressClient.stats() keys). Addresses are dynamic —
# they appear as the pool dials — so these sync via a before_render hook
# instead of set_function children.
EGRESS_GAUGES: dict[str, tuple[str, str]] = {
    "breaker_open": (
        "egress_breaker_open",
        "1 when the address's circuit breaker is open (dials fail fast)",
    ),
    "breaker_half_open": (
        "egress_breaker_half_open",
        "1 while a single half-open probe decides the breaker's fate",
    ),
    "consecutive_failures": (
        "egress_consecutive_failures",
        "Consecutive connect failures / conn deaths / stalls for the address",
    ),
    "opens_total": (
        "egress_breaker_opens_total",
        "Times the address's breaker has opened since start",
    ),
    "stalls_total": (
        "egress_stream_stalls_total",
        "Response streams declared stalled (per-token deadline) for the address",
    ),
    "connected": (
        "egress_connected",
        "1 while a live pooled connection to the address exists",
    ),
}


def bind_egress_gauges(status: "SystemStatusServer | None", egress) -> None:
    """Export the egress pool's per-address breaker/stall state on
    /metrics (labels: service=dataplane, address=<host:port>). No-op when
    the status server is disabled."""
    if status is None:
        return

    def sync() -> None:
        for address, st in egress.stats().items():
            scoped = status.metrics.scoped(service="dataplane", address=address)
            values = {
                "breaker_open": 1.0 if st["state"] == "open" else 0.0,
                "breaker_half_open": 1.0 if st["state"] == "half-open" else 0.0,
                "consecutive_failures": float(st["consecutive_failures"]),
                "opens_total": float(st["opens_total"]),
                "stalls_total": float(st["stalls_total"]),
                "connected": 1.0 if st["connected"] else 0.0,
            }
            for key, (name, doc) in EGRESS_GAUGES.items():
                scoped.gauge(name, doc).set(values[key])

    status.before_render.append(sync)


# Control-plane connectivity gauges (ISSUE 15): the store client's
# connection-state surface, exported on every process's /metrics (both
# backends via their mains, the frontend via _bind_store_gauges on its
# own registry). Keys match StoreClient.stats().
STORE_GAUGES: dict[str, tuple[str, str]] = {
    "connected": (
        "store_connected",
        "1 while a live control-plane store session exists; 0 means this "
        "process is serving in degraded mode on cached discovery state",
    ),
    "outage_seconds": (
        "store_outage_seconds",
        "Cumulative seconds without a store session since start, the "
        "current outage included",
    ),
    "disconnected_for_s": (
        "store_disconnected_seconds",
        "Seconds since the current outage began (0 while connected)",
    ),
    "keepalive_failures": (
        "store_keepalive_failures_total",
        "Lease-keepalive beats that failed transiently (the loop "
        "survives them and re-attaches expired leases; a rising counter "
        "with store_connected=1 means keepalives are being lost)",
    ),
    "reconnects": (
        "store_session_rebuilds_total",
        "Store sessions rebuilt after an outage (leases re-granted, "
        "lease-bound KV replayed, watches and subscriptions resumed)",
    ),
}


def _bind_store_gauges(metrics: MetricsRegistry, hooks: list, store) -> None:
    """Registry-level binder (the HTTP frontend reuses it on its own
    metrics registry + before_metrics hooks)."""
    scoped = metrics.scoped(service="store")

    def sync() -> None:
        st = store.stats()
        for key, (name, doc) in STORE_GAUGES.items():
            scoped.gauge(name, doc).set(float(st.get(key, 0) or 0))

    hooks.append(sync)


def control_plane_section(store) -> tuple[dict, bool]:
    """The /health ``control_plane`` payload + connected flag, shared by
    the worker status server and the HTTP frontend so the two health
    surfaces can never diverge."""
    st = store.stats()
    connected = bool(st.get("connected"))
    return (
        {
            "connected": connected,
            "outage_seconds": round(float(st.get("outage_seconds", 0.0)), 3),
            "session_rebuilds": int(st.get("reconnects", 0)),
        },
        connected,
    )


def bind_store_gauges(status: "SystemStatusServer | None", store) -> None:
    """Export the process's control-plane connection state on /metrics
    and surface it in /health's ``control_plane`` section. No-op when the
    status server is disabled."""
    if status is None:
        return
    status.store = store
    _bind_store_gauges(status.metrics, status.before_render, store)


class SystemStatusServer:
    def __init__(
        self,
        metrics: MetricsRegistry | None = None,
        host: str = "0.0.0.0",
        port: int = 0,
    ):
        self.metrics = metrics or MetricsRegistry()
        self.host = host
        self.port = port
        self._started_at = time.monotonic()
        # Hooks run before each /metrics render — for exporters whose
        # label sets are dynamic (e.g. per-address breaker gauges, where
        # addresses appear as the egress pool dials new workers) and so
        # cannot pre-bind set_function children.
        self.before_render: list[Callable[[], None]] = []
        # endpoint path -> "ready" | "notready"
        self.endpoint_health: dict[str, str] = {}
        # Store client whose connectivity /health reports (wired by
        # bind_store_gauges); None = no control-plane section.
        self.store = None
        self.app = web.Application()
        self.app.router.add_get("/health", self.health)
        self.app.router.add_get("/live", self.live)
        self.app.router.add_get("/metrics", self.prometheus)
        self.app.router.add_get("/traces", self.traces)
        self._runner: web.AppRunner | None = None
        # Per-phase latency histograms ride this registry (scraped by the
        # planner observer alongside the frontend series).
        tracing.get_collector().bind_metrics(self.metrics)

    def set_endpoint_health(self, path: str, ready: bool) -> None:
        self.endpoint_health[path] = "ready" if ready else "notready"

    @property
    def uptime_s(self) -> float:
        return time.monotonic() - self._started_at

    async def start(self) -> None:
        self._runner = web.AppRunner(self.app, access_log=None)
        await self._runner.setup()
        site = web.TCPSite(self._runner, self.host, self.port)
        await site.start()
        for addr in self._runner.addresses:
            self.port = addr[1]
        log.info("status server on http://%s:%d", self.host, self.port)

    async def stop(self) -> None:
        if self._runner:
            await self._runner.cleanup()

    async def health(self, request: web.Request) -> web.Response:
        ready = all(s == "ready" for s in self.endpoint_health.values())
        status = "healthy" if ready and self.endpoint_health else "starting"
        payload = {
            "status": status,
            "uptime_s": round(self.uptime_s, 3),
            "endpoints": dict(self.endpoint_health),
        }
        if self.store is not None:
            payload["control_plane"], connected = control_plane_section(
                self.store
            )
            if status == "healthy" and not connected:
                # Degraded, NOT unhealthy: the data plane still serves
                # (that is the whole point of ISSUE 15) — stay 200 so
                # orchestrators don't kill a working worker over a store
                # blackout, but make the state visible.
                payload["status"] = status = "degraded"
        return web.json_response(
            payload,
            status=200 if status in ("healthy", "degraded") else 503,
        )

    async def live(self, request: web.Request) -> web.Response:
        return web.json_response({"status": "live"})

    async def prometheus(self, request: web.Request) -> web.Response:
        self.metrics.scoped(service="system").gauge("system_uptime_seconds").set(
            self.uptime_s
        )
        for hook in self.before_render:
            hook()
        return web.Response(body=self.metrics.render(), content_type="text/plain")

    async def traces(self, request: web.Request) -> web.Response:
        return web.json_response(render_traces(request))


def render_traces(request: web.Request) -> dict:
    """Shared ``/traces`` payload (status server + HTTP frontend):
    ``?limit=N`` recent traces, ``?trace_id=...`` to pin one."""
    collector = tracing.get_collector()
    trace_id = request.query.get("trace_id")
    if trace_id:
        traces = collector.traces(trace_id=trace_id)
    else:
        try:
            limit = max(1, min(200, int(request.query.get("limit", "20"))))
        except ValueError:
            limit = 20
        traces = collector.traces(limit=limit)
    return {
        "enabled": tracing.trace_enabled(),
        "buffered_spans": len(collector),
        "stat_spans": len(collector.stats()),
        "capacity": collector.capacity,
        "traces": traces,
    }
