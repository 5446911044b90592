"""Per-request SLO attribution: TTFT/TPOT budget breakdown per tenant.

The port's copy of ``dynamo_tpu/obs/slo.py``, held to it by
``tests/test_torch_copies.py``.

The tracer (PR 2) already records every phase of a request — ``http`` /
``tokenize`` / ``route`` on the frontend, ``sched_admit`` / ``prefill`` /
``decode`` on the worker — as spans sharing one trace and carrying the
request id. This module stitches them into per-request budget records:

    ttft  = tokenize + route + prefill      (prefill span = worker
            submit -> first token, queue time included; ``queue`` is the
            sched_admit sub-window, ``prefill_compute`` the remainder)
    tpot  = decode / (tokens - 1)

Worker-side spans reach the frontend/aggregator inside metric snapshots
(:class:`~dynamo_tpu.obs.snapshot.MetricSnapshot.requests`), scanned off
the process-local ring by :class:`PhaseScanner` — nothing new on the hot
path; the spans were already being recorded.

The :class:`SloAttributor` keys everything by the validated tenant id
(PR 10's fairness identity): per-tenant ``dynamo_slo_*`` histograms on
/metrics, and a ``/fleet`` summary with p50/p99 + attainment against
:class:`SloTargets`. Tenant cardinality is CAPPED (64 + ``__other__``),
like every tenant-labeled export since PR 10 — a rotating x-tenant-id
spray cannot grow the aggregator's /metrics without bound.
"""

from __future__ import annotations

import logging
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field

from dynamo_tpu_torch import knobs

log = logging.getLogger("dynamo_tpu.obs.slo")

# Worker-side request phases (recorded by TpuEngine / MockTpuEngine at
# stream close); the decode span is recorded last, so it completes the
# request's worker-side record.
WORKER_PHASES = frozenset({"sched_admit", "prefill", "decode"})
WORKER_COMPLETE_ON = "decode"

# Frontend-side phases (http root finishes last, in the handler finally).
FRONTEND_PHASES = frozenset({"http", "tokenize", "route"})
FRONTEND_COMPLETE_ON = "http"

# Max distinct tenant label values tracked/exported (PR 10's cap).
MAX_SLO_TENANTS = 64
OTHER_TENANT = "__other__"

# TTFT spans queue + prefill (tens of ms .. many seconds under load);
# TPOT is a per-token mean (sub-ms .. tens of ms). Edges chosen to match
# the measured ranges, like the tuned trace-phase buckets.
SLO_TTFT_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.2, 0.35, 0.5, 0.75, 1.0, 1.5,
    2.5, 5.0, 10.0, 30.0, 60.0,
)
SLO_TPOT_BUCKETS = (
    0.0002, 0.0005, 0.001, 0.002, 0.005, 0.01, 0.02, 0.035, 0.05,
    0.075, 0.1, 0.2, 0.5, 1.0,
)


@dataclass(frozen=True)
class SloTargets:
    """Attainment targets (defaults mirror the planner's SlaTargets;
    override via DYN_SLO_TTFT_MS / DYN_SLO_TPOT_MS)."""

    ttft_s: float = knobs.default("DYN_SLO_TTFT_MS") / 1e3
    tpot_s: float = knobs.default("DYN_SLO_TPOT_MS") / 1e3

    @classmethod
    def from_env(cls) -> "SloTargets":
        return cls(
            ttft_s=knobs.get_float("DYN_SLO_TTFT_MS") / 1e3,
            tpot_s=knobs.get_float("DYN_SLO_TPOT_MS") / 1e3,
        )


class PhaseScanner:
    """Incrementally scan a TraceCollector's span ring for finished
    per-request phase spans, grouped by request id.

    Each call to :meth:`scan` returns the request records COMPLETED since
    the previous call: ``{"rid", "tenant", "t", "tokens", "phases":
    {name: seconds}}``. A request completes when its ``complete_on`` span
    lands (decode worker-side, http frontend-side — both are recorded
    last by their emitters). Seen-span tracking and open groups are both
    bounded, so a scanner on a busy collector stays O(ring).
    """

    def __init__(
        self,
        collector,
        names: frozenset[str] = WORKER_PHASES,
        complete_on: str = WORKER_COMPLETE_ON,
        max_pending: int = 1024,
        max_seen: int = 16384,
    ):
        self._collector = collector
        self._names = names
        self._complete_on = complete_on
        self._max_pending = max_pending
        self._pending: "OrderedDict[str, dict]" = OrderedDict()
        self._seen: set[str] = set()
        self._seen_order: deque[str] = deque()
        self._max_seen = max_seen

    def _note_seen(self, span_id: str) -> None:
        self._seen.add(span_id)
        self._seen_order.append(span_id)
        while len(self._seen_order) > self._max_seen:
            self._seen.discard(self._seen_order.popleft())

    def scan(self) -> list[dict]:
        out: list[dict] = []
        for span in self._collector.spans():  # atomic ring copy
            if span.name not in self._names or span.span_id in self._seen:
                continue
            rid = span.attrs.get("request_id")
            if not rid:
                continue
            self._note_seen(span.span_id)
            group = self._pending.get(rid)
            if group is None:
                group = self._pending[rid] = {"phases": {}, "tenant": "", "tokens": 0}
                while len(self._pending) > self._max_pending:
                    self._pending.popitem(last=False)  # drop oldest open group
            group["phases"][span.name] = span.duration_s
            tenant = span.attrs.get("tenant")
            if tenant:
                group["tenant"] = str(tenant)
            if span.name == "decode":
                group["tokens"] = int(span.attrs.get("tokens", 0) or 0)
            if span.name == self._complete_on:
                self._pending.pop(rid, None)
                out.append(
                    {
                        "rid": rid,
                        "tenant": group["tenant"],
                        "t": span.end_s,
                        "tokens": group["tokens"],
                        "phases": group["phases"],
                    }
                )
        return out


def quantile(sorted_vals: list[float], q: float) -> float:
    """Order-statistic quantile on a pre-sorted list (shared by the SLO
    summary and the aggregator's fleet rollups — one definition, so the
    two percentile families can never diverge)."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(q * len(sorted_vals)))
    return sorted_vals[idx]


@dataclass
class _TenantSlo:
    ttft: deque = field(default_factory=lambda: deque(maxlen=512))
    tpot: deque = field(default_factory=lambda: deque(maxlen=512))
    phase_sum: dict = field(default_factory=dict)
    n: int = 0
    ttft_ok: int = 0
    tpot_ok: int = 0
    tpot_n: int = 0


class SloAttributor:
    """Merge frontend- and worker-side request records into per-tenant
    TTFT/TPOT budget breakdowns.

    Worker records are authoritative (they carry queue/prefill/decode and
    the token count); frontend records add tokenize/route. A worker-only
    record finalizes after ``grace_s`` (direct-engine traffic has no
    frontend side); a frontend-only record past grace is dropped (the
    request never reached an instrumented worker — e.g. full shed).
    """

    def __init__(
        self,
        targets: SloTargets | None = None,
        grace_s: float = 5.0,
        max_tenants: int = MAX_SLO_TENANTS,
        metrics=None,
        namespace: str = "dynamo",
    ):
        self.targets = targets or SloTargets.from_env()
        self.grace_s = grace_s
        self.max_tenants = max_tenants
        # Labels every histogram: several namespaces' attributors can
        # share one registry (embedded multi-namespace frontend) without
        # merging their observations.
        self.namespace = namespace
        self._metrics = metrics  # MetricsRegistry | None
        self._pending: "OrderedDict[str, dict]" = OrderedDict()
        self._tenants: dict[str, _TenantSlo] = {}
        # Recently finalized request ids (bounded): duplicate records —
        # snapshot redelivery, or several single-process workers scanning
        # one shared collector — must not double-count a request.
        self._done: set[str] = set()
        self._done_order: deque[str] = deque()
        self.records_total = 0

    def bind_metrics(self, metrics) -> None:
        """Export ``dynamo_slo_*`` per-tenant histograms on this registry
        as records finalize."""
        self._metrics = metrics

    # -- ingest ------------------------------------------------------------

    def ingest(self, records: list[dict], side: str = "worker") -> None:
        now = time.monotonic()
        for rec in records:
            rid = rec.get("rid")
            if not rid or rid in self._done:
                continue
            entry = self._pending.get(rid)
            if entry is None:
                entry = self._pending[rid] = {"t0": now}
                while len(self._pending) > 4096:
                    self._pending.popitem(last=False)
            entry[side] = rec
            if "worker" in entry and "frontend" in entry:
                self._pending.pop(rid, None)
                self._note_done(rid)
                self._finalize(entry)
        self.sweep(now)

    def sweep(self, now: float | None = None) -> None:
        """Finalize worker-only entries past grace; drop frontend-only
        ones (never reached a worker)."""
        now = time.monotonic() if now is None else now
        expired = [
            rid
            for rid, e in self._pending.items()
            if now - e["t0"] > self.grace_s
        ]
        for rid in expired:
            entry = self._pending.pop(rid)
            if "worker" in entry:
                self._note_done(rid)
                self._finalize(entry)

    def _note_done(self, rid: str) -> None:
        self._done.add(rid)
        self._done_order.append(rid)
        while len(self._done_order) > 16384:
            self._done.discard(self._done_order.popleft())

    def _tenant_key(self, tenant: str) -> str:
        tenant = tenant or "default"
        if tenant in self._tenants or len(self._tenants) < self.max_tenants:
            return tenant
        return OTHER_TENANT

    def _finalize(self, entry: dict) -> None:
        worker = entry.get("worker") or {}
        frontend = entry.get("frontend") or {}
        wp = worker.get("phases") or {}
        fp = frontend.get("phases") or {}
        queue = wp.get("sched_admit", 0.0)
        prefill = wp.get("prefill", 0.0)
        decode = wp.get("decode", 0.0)
        tokenize = fp.get("tokenize", 0.0)
        route = fp.get("route", 0.0)
        tokens = int(worker.get("tokens", 0) or 0)
        ttft = tokenize + route + prefill
        tpot = decode / (tokens - 1) if tokens > 1 and decode > 0 else None
        phases = {
            "tokenize": tokenize,
            "route": route,
            "queue": queue,
            "prefill_compute": max(0.0, prefill - queue),
            "decode": decode,
        }
        tenant = self._tenant_key(worker.get("tenant") or frontend.get("tenant") or "")
        st = self._tenants.get(tenant)
        if st is None:
            st = self._tenants[tenant] = _TenantSlo()
        st.n += 1
        self.records_total += 1
        st.ttft.append(ttft)
        if ttft <= self.targets.ttft_s:
            st.ttft_ok += 1
        if tpot is not None:
            st.tpot.append(tpot)
            st.tpot_n += 1
            if tpot <= self.targets.tpot_s:
                st.tpot_ok += 1
        for name, v in phases.items():
            st.phase_sum[name] = st.phase_sum.get(name, 0.0) + v
        if self._metrics is not None:
            scoped = self._metrics.scoped(
                namespace=self.namespace, service="slo", tenant=tenant
            )
            scoped.histogram(
                "slo_ttft_seconds",
                "Per-request TTFT attributed from stitched trace phases "
                "(tokenize + route + worker submit->first-token)",
                buckets=SLO_TTFT_BUCKETS,
            ).observe(ttft)
            if tpot is not None:
                scoped.histogram(
                    "slo_tpot_seconds",
                    "Per-request mean time-per-output-token "
                    "(decode phase / (tokens - 1))",
                    buckets=SLO_TPOT_BUCKETS,
                ).observe(tpot)
            for name, v in phases.items():
                self._metrics.scoped(
                    namespace=self.namespace, service="slo",
                    tenant=tenant, phase=name,
                ).histogram(
                    "slo_phase_seconds",
                    "Per-request TTFT/TPOT budget breakdown by phase",
                    buckets=SLO_TTFT_BUCKETS,
                ).observe(v)

    def attainment_counters(self) -> dict[str, float]:
        """Cumulative fleet-wide attainment counters (all tenants): the
        aggregator diffs consecutive snapshots of these into the planner
        Observation's *windowed* SLO attainment, so the controller reacts
        to the last window's misses rather than the lifetime average."""
        out = {"ttft_ok": 0.0, "ttft_n": 0.0, "tpot_ok": 0.0, "tpot_n": 0.0}
        for st in self._tenants.values():
            out["ttft_ok"] += st.ttft_ok
            out["ttft_n"] += st.n
            out["tpot_ok"] += st.tpot_ok
            out["tpot_n"] += st.tpot_n
        return out

    # -- summary (/fleet + bench) ------------------------------------------

    def summary(self) -> dict:
        tenants = {}
        for tenant, st in sorted(self._tenants.items()):
            ttfts = sorted(st.ttft)
            tpots = sorted(st.tpot)
            tenants[tenant] = {
                "requests": st.n,
                "ttft_p50_ms": round(quantile(ttfts, 0.50) * 1e3, 3),
                "ttft_p99_ms": round(quantile(ttfts, 0.99) * 1e3, 3),
                "tpot_p50_ms": round(quantile(tpots, 0.50) * 1e3, 3),
                "tpot_p99_ms": round(quantile(tpots, 0.99) * 1e3, 3),
                "ttft_attainment": round(st.ttft_ok / st.n, 4) if st.n else 0.0,
                "tpot_attainment": (
                    round(st.tpot_ok / st.tpot_n, 4) if st.tpot_n else 1.0
                ),
                "phase_mean_ms": {
                    name: round(v / st.n * 1e3, 3)
                    for name, v in sorted(st.phase_sum.items())
                },
            }
        return {
            "targets": {
                "ttft_ms": round(self.targets.ttft_s * 1e3, 1),
                "tpot_ms": round(self.targets.tpot_s * 1e3, 1),
            },
            "records": self.records_total,
            "pending": len(self._pending),
            "tenants": tenants,
        }
