"""Distributed request tracing: spans, tracers, and the ring-buffer collector.

The port's copy of ``dynamo_tpu/tracing/core.py``, held to it by
``tests/test_torch_copies.py``.

Per-phase latency attribution for a single request across frontend →
router → prefill → decode (the decomposition "Understanding Bottlenecks
for Efficiently Serving LLM Inference With KV Offloading" and NetKV
attribute their wins to — PAPERS.md). Aggregate Prometheus histograms say
*that* TTFT regressed; a stitched trace says *where* the time went.

Design constraints (ISSUE 2):

- stdlib only — no OpenTelemetry dependency; spans are plain dataclasses.
- Hot-path safe: a finished span is one ``deque.append`` (atomic under the
  GIL — the "lock-free" per-process collector; engine threads and the
  event loop share it without a mutex). A *disabled* tracer returns a
  shared no-op span: one attribute check + one return, < 1 µs per call
  (pinned by the micro-bench in tests/test_tracing.py).
- Cross-process stitching rides the W3C ``traceparent`` header the
  dataplane already carries next to ``x-request-id`` (runtime/framing.py
  ``h`` map → runtime/dataplane.py → Context.headers), so spans recorded
  in different processes (disagg prefill fleet, migrated attempts) share
  one trace id and parent links.

Configuration (read from env at import, overridable via :func:`configure`;
mirrored in runtime/config.py RuntimeConfig):

- ``DYN_TRACE_ENABLED`` — "0"/"false" disables all recording (default on).
- ``DYN_TRACE_SAMPLE``  — root-span sampling rate in [0,1] (default 1.0).
  Sampling is deterministic on the trace id, so every process in a
  deployment keeps or drops the *same* traces without coordination.
- ``DYN_TRACE_BUFFER``  — ring-buffer capacity in spans (default 4096).
"""

from __future__ import annotations

import secrets
import threading
import time
import weakref
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Iterable

from dynamo_tpu_torch import knobs
from dynamo_tpu_torch.runtime.logging_setup import TRACEPARENT_HEADER, parse_traceparent

__all__ = [
    "Span",
    "SpanContext",
    "Tracer",
    "TraceCollector",
    "configure",
    "extract_context",
    "get_collector",
    "get_tracer",
    "inject_headers",
    "trace_enabled",
]


# ---------------------------------------------------------------------------
# Span model
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SpanContext:
    """The cross-process identity of a span: what rides the wire."""

    trace_id: str  # 32 hex chars
    span_id: str   # 16 hex chars

    def traceparent(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-01"


@dataclass
class Span:
    """One timed phase of a request. Plain data + context-manager sugar.

    ``start_s``/``end_s`` are ``time.time()`` wall-clock seconds so spans
    from different processes on one host order correctly in a waterfall.
    """

    name: str
    service: str
    trace_id: str
    span_id: str
    parent_id: str | None = None
    start_s: float = 0.0
    end_s: float = 0.0
    attrs: dict[str, Any] = field(default_factory=dict)
    _collector: "TraceCollector | None" = None

    @property
    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)

    @property
    def duration_s(self) -> float:
        return max(0.0, self.end_s - self.start_s)

    @property
    def recording(self) -> bool:
        return True

    def set(self, key: str, value: Any) -> "Span":
        self.attrs[key] = value
        return self

    def finish(self, end_s: float | None = None) -> None:
        if self._collector is None:
            return  # already finished (idempotent)
        self.end_s = end_s if end_s is not None else time.time()
        collector, self._collector = self._collector, None
        collector.add(self)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        self.finish()

    def to_dict(self) -> dict[str, Any]:
        return {
            "name": self.name,
            "service": self.service,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start_s": self.start_s,
            "end_s": self.end_s,
            "duration_ms": round(self.duration_s * 1e3, 4),
            "attrs": self.attrs,
        }


class _NoopSpan:
    """Shared do-nothing span: the disabled/unsampled fast path."""

    __slots__ = ()

    recording = False
    trace_id = ""
    span_id = ""
    name = ""
    attrs: dict[str, Any] = {}

    @property
    def context(self) -> None:
        return None

    def set(self, key: str, value: Any) -> "_NoopSpan":
        return self

    def finish(self, end_s: float | None = None) -> None:
        return None

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        return None


NOOP_SPAN = _NoopSpan()


# ---------------------------------------------------------------------------
# Collector: the lock-free per-process ring buffer
# ---------------------------------------------------------------------------

# Phase-histogram bucket edges, tuned to the MEASURED phase ranges
# (ISSUE 13 satellite; the old edges were generic defaults): the fast end
# resolves sub-ms decode iterations and host_gap stats (50 µs floor), the
# middle covers queue/route/TTFT (10 ms – 1 s), and the slow end keeps
# resolution through multi-second chunked prefills and megastep drains up
# to 120 s — so a p99 estimated off /metrics interpolates inside a
# bucket instead of saturating the top one. Pinned by
# tests/test_obs.py::test_phase_buckets_cover_measured_ranges.
_PHASE_BUCKETS = (
    0.00005, 0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
    0.025, 0.05, 0.1, 0.25, 0.5, 0.75, 1.0, 1.5, 2.5, 4.0, 6.0,
    10.0, 15.0, 30.0, 60.0, 120.0,
)


class TraceCollector:
    """Fixed-size span sink; one per process.

    ``deque(maxlen=N).append`` is atomic, so engine threads (EngineCore
    step runs under ``asyncio.to_thread``) and event-loop code feed the
    same buffer without locking. Readers (``/traces``) take a snapshot via
    ``list(deque)`` — also atomic — so rendering never blocks recording.
    """

    def __init__(self, capacity: int = 4096):
        self._spans: deque[Span] = deque(maxlen=capacity)
        # High-frequency process-local stat spans (engine step timings)
        # live in their own, smaller ring so a busy decode loop can never
        # evict per-request spans out of the trace buffer.
        self._stats: deque[Span] = deque(maxlen=min(1024, capacity))
        # Cumulative per-phase (count, sum-seconds) totals — the metric
        # snapshots ship these over the event plane so the fleet
        # aggregator can diff per-window phase means without scraping.
        # Unlike the rings these survive eviction, so they are CUMULATIVE
        # counters like the prometheus histograms. The tiny lock guards
        # the two-field update against the engine-thread/event-loop race
        # (the ring appends stay lock-free).
        self._phase_lock = threading.Lock()
        self._phase_totals: dict[str, list[float]] = {}
        # Bound metrics registries: per-phase latency histograms
        # (planner/observer.py consumes these for the TTFT/ITL
        # decomposition). Held weakly — a restarted service's dead
        # registry unbinds itself instead of accumulating forever.
        self._metrics: list[weakref.ref] = []

    @property
    def capacity(self) -> int:
        return self._spans.maxlen or 0

    def __len__(self) -> int:
        return len(self._spans)

    def add(self, span: Span) -> None:
        self._spans.append(span)
        self._observe(span)

    def add_stat(self, span: Span) -> None:
        """File a stat span: histogram-observed like any other, but kept
        out of the request-trace ring and the ``/traces`` grouping."""
        self._stats.append(span)
        self._observe(span)

    def _observe(self, span: Span) -> None:
        key = f"{span.service}/{span.name}"
        with self._phase_lock:
            totals = self._phase_totals.get(key)
            if totals is None:
                totals = self._phase_totals[key] = [0.0, 0.0]
            totals[0] += 1.0
            totals[1] += span.duration_s
        dead = False
        for ref in self._metrics:
            registry = ref()
            if registry is None:
                dead = True
                continue
            registry.scoped(service=span.service, phase=span.name).histogram(
                "trace_phase_duration_seconds",
                doc="Per-phase request latency attributed by the tracer",
                buckets=_PHASE_BUCKETS,
            ).observe(span.duration_s)
        if dead:
            self._metrics[:] = [r for r in self._metrics if r() is not None]

    def bind_metrics(self, registry: Any) -> None:
        """Mirror every finished span into per-phase histograms
        (``dynamo_trace_phase_duration_seconds{service,phase}``) on the
        given :class:`~dynamo_tpu.runtime.metrics.MetricsRegistry`."""
        live = [r for r in self._metrics if r() is not None]
        if not any(r() is registry for r in live):
            live.append(weakref.ref(registry))
        self._metrics[:] = live

    def phase_totals(self) -> dict[str, tuple[float, float]]:
        """Cumulative ``{"service/phase": (count, sum_seconds)}`` since
        process start — the snapshot publisher's phase source."""
        with self._phase_lock:
            return {k: (v[0], v[1]) for k, v in self._phase_totals.items()}

    def clear(self) -> None:
        self._spans.clear()
        self._stats.clear()
        with self._phase_lock:
            self._phase_totals.clear()

    def spans(self) -> list[Span]:
        return list(self._spans)

    def stats(self) -> list[Span]:
        return list(self._stats)

    def trace(self, trace_id: str) -> list[Span]:
        # list() first: iterating the live deque races recording threads
        # (deques forbid mutation during iteration); the copy is atomic.
        return sorted(
            (s for s in list(self._spans) if s.trace_id == trace_id),
            key=lambda s: (s.start_s, s.end_s),
        )

    def traces(
        self, limit: int = 20, trace_id: str | None = None
    ) -> list[dict[str, Any]]:
        """The most recent ``limit`` traces (or the one ``trace_id``),
        each with spans in start order and a per-phase waterfall (offsets
        relative to the trace root) — the ``/traces`` endpoint payload."""
        if trace_id is not None:
            spans = self.trace(trace_id)
            return [self._payload(trace_id, spans)] if spans else []
        grouped: dict[str, list[Span]] = {}
        for span in list(self._spans):  # snapshot; oldest → newest
            grouped.setdefault(span.trace_id, []).append(span)
        out = [
            self._payload(tid, sorted(grouped[tid], key=lambda s: (s.start_s, s.end_s)))
            for tid in list(grouped)[-limit:]
        ]
        out.reverse()  # newest first
        return out

    @staticmethod
    def _payload(trace_id: str, spans: list[Span]) -> dict[str, Any]:
        t0 = spans[0].start_s
        return {
            "trace_id": trace_id,
            "start_s": t0,
            "duration_ms": round((max(s.end_s for s in spans) - t0) * 1e3, 4),
            "spans": [s.to_dict() for s in spans],
            "waterfall": [
                {
                    "phase": s.name,
                    "service": s.service,
                    "offset_ms": round((s.start_s - t0) * 1e3, 4),
                    "duration_ms": round(s.duration_s * 1e3, 4),
                }
                for s in spans
            ],
        }


# ---------------------------------------------------------------------------
# Tracer
# ---------------------------------------------------------------------------


def _sampled(trace_id: str, rate: float) -> bool:
    """Deterministic head sampling: the same trace id samples identically
    in every process, so distributed traces never arrive half-recorded."""
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    return int(trace_id[:8], 16) / 0xFFFFFFFF < rate


class Tracer:
    """Factory for spans of one service ("frontend", "router", "engine"...).

    ``span(...)`` starts a live span (use as a context manager — the
    dynalint ``unclosed-span`` rule enforces this); ``record(...)`` files
    a phase from timestamps already taken, for retroactive attribution
    (e.g. the engine marks prefill-done inside its step loop and emits
    the span when the stream closes).
    """

    def __init__(self, service: str, collector: TraceCollector):
        self.service = service
        self.collector = collector

    # NOTE: parent can be a Span, a SpanContext, or None. headers (the
    # dataplane `h` map / aiohttp request headers) are consulted when no
    # explicit parent is given.
    def _resolve_parent(
        self, parent: Any, headers: Any
    ) -> SpanContext | None:
        if isinstance(parent, Span):
            return parent.context
        if isinstance(parent, SpanContext):
            return parent
        if parent is None:
            if headers is not None:
                return extract_context(headers)
            return None
        return None

    def span(
        self,
        name: str,
        parent: Any = None,
        headers: Any = None,
        attrs: dict[str, Any] | None = None,
    ):
        """Start a span. Returns the shared no-op span when tracing is
        disabled or the trace is head-sampled out."""
        if not _STATE.enabled:
            return NOOP_SPAN
        if parent is NOOP_SPAN:
            # The parent's trace was sampled out: propagate the drop
            # instead of minting an orphan trace for the child.
            return NOOP_SPAN
        ctx = self._resolve_parent(parent, headers)
        if ctx is None:
            trace_id = secrets.token_hex(16)
            if not _sampled(trace_id, _STATE.sample):
                return NOOP_SPAN
            parent_id = None
        else:
            if not _sampled(ctx.trace_id, _STATE.sample):
                return NOOP_SPAN
            trace_id, parent_id = ctx.trace_id, ctx.span_id
        return Span(
            name=name,
            service=self.service,
            trace_id=trace_id,
            span_id=secrets.token_hex(8),
            parent_id=parent_id,
            start_s=time.time(),
            attrs=dict(attrs) if attrs else {},
            _collector=self.collector,
        )

    def record(
        self,
        name: str,
        start_s: float,
        end_s: float,
        parent: Any = None,
        headers: Any = None,
        attrs: dict[str, Any] | None = None,
        stat: bool = False,
    ) -> None:
        """File an already-elapsed phase as a finished span. ``stat=True``
        routes it to the collector's stat ring (histograms only, excluded
        from ``/traces``) — for high-frequency per-step timings that would
        otherwise evict request spans."""
        span = self.span(name, parent=parent, headers=headers, attrs=attrs)
        if span.recording:
            span.start_s = start_s
            if stat:
                span.end_s = end_s
                span._collector = None
                self.collector.add_stat(span)
            else:
                span.finish(end_s)


# ---------------------------------------------------------------------------
# W3C trace-context propagation (rides the existing header path)
# ---------------------------------------------------------------------------


def extract_context(headers: Any) -> SpanContext | None:
    """Parse ``traceparent`` out of a headers mapping (dataplane ``h``
    dict or aiohttp CIMultiDict — both expose ``.get``)."""
    if headers is None:
        return None
    value = headers.get(TRACEPARENT_HEADER)
    if not value:
        return None
    parsed = parse_traceparent(value)
    if parsed is None:
        return None
    return SpanContext(trace_id=parsed[0], span_id=parsed[1])


def inject_headers(span: Any, headers: dict[str, str]) -> dict[str, str]:
    """Stamp ``headers`` with the span's traceparent so downstream
    processes parent to it. A no-op span leaves headers untouched (the
    caller's own child_traceparent fallback stays in effect)."""
    ctx = getattr(span, "context", None)
    if ctx is not None:
        headers[TRACEPARENT_HEADER] = ctx.traceparent()
    return headers


# ---------------------------------------------------------------------------
# Process-global wiring
# ---------------------------------------------------------------------------


class _State:
    __slots__ = ("enabled", "sample", "collector")

    def __init__(self) -> None:
        self.enabled = knobs.get_bool("DYN_TRACE_ENABLED")
        self.sample = knobs.get_float("DYN_TRACE_SAMPLE")
        self.collector = TraceCollector(
            capacity=max(1, knobs.get_int("DYN_TRACE_BUFFER"))
        )


_STATE = _State()
_tracers: dict[str, Tracer] = {}


def configure(
    enabled: bool | None = None,
    sample: float | None = None,
    buffer: int | None = None,
) -> None:
    """Re-apply tracing config (tests; runtime/config.py overlay). A new
    ``buffer`` swaps in a fresh ring buffer and rebinds live tracers."""
    if enabled is not None:
        _STATE.enabled = enabled
    if sample is not None:
        _STATE.sample = max(0.0, min(1.0, sample))
    if buffer is not None and buffer != _STATE.collector.capacity:
        old = _STATE.collector
        _STATE.collector = TraceCollector(capacity=max(1, buffer))
        for ref in old._metrics:
            registry = ref()
            if registry is not None:
                _STATE.collector.bind_metrics(registry)
        for tracer in _tracers.values():
            tracer.collector = _STATE.collector


def trace_enabled() -> bool:
    return _STATE.enabled


def get_collector() -> TraceCollector:
    return _STATE.collector


def get_tracer(service: str) -> Tracer:
    tracer = _tracers.get(service)
    if tracer is None:
        tracer = _tracers[service] = Tracer(service, _STATE.collector)
    elif tracer.collector is not _STATE.collector:
        tracer.collector = _STATE.collector
    return tracer


def phase_order(spans: Iterable[Span | dict]) -> list[str]:
    """Phase names in start order — test/debug helper for asserting the
    waterfall shape ({http, tokenize, route, prefill, decode})."""
    def key(s):
        if isinstance(s, dict):
            return (s["start_s"], s["end_s"])
        return (s.start_s, s.end_s)

    def name(s):
        return s["name"] if isinstance(s, dict) else s.name

    return [name(s) for s in sorted(spans, key=key)]
