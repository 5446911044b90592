"""Hierarchical metrics registry auto-labelled by namespace/component/endpoint.

The port's copy of ``dynamo_tpu/runtime/metrics.py``, held to it by
``tests/test_torch_copies.py``.

Thin, opinionated layer over ``prometheus_client``: every metric created
through a registry handle carries the position in the component tree as
constant labels, and the whole tree exposes one ``/metrics`` text blob.

Capability parity: reference `lib/runtime/src/metrics.rs` (MetricsRegistry
with auto ns/component/endpoint labels) and `metrics/prometheus_names.rs`
(the ``dynamo_*`` name scheme).
"""

from __future__ import annotations

import prometheus_client
from prometheus_client import CollectorRegistry, Counter, Gauge, Histogram

PREFIX = "dynamo"


class MetricsRegistry:
    """One per process; `scoped()` handles add constant labels."""

    def __init__(self) -> None:
        self.registry = CollectorRegistry()
        self._metrics: dict[str, object] = {}

    def scoped(self, **labels: str) -> "ScopedMetrics":
        return ScopedMetrics(self, labels)

    def render(self) -> bytes:
        return prometheus_client.generate_latest(self.registry)

    def _get_or_create(self, kind, name: str, doc: str, labelnames: tuple[str, ...], **kwargs):
        full = f"{PREFIX}_{name}"
        key = f"{kind.__name__}:{full}:{labelnames}"
        metric = self._metrics.get(key)
        if metric is None:
            metric = kind(full, doc, labelnames=labelnames, registry=self.registry, **kwargs)
            self._metrics[key] = metric
        return metric


class ScopedMetrics:
    def __init__(self, root: MetricsRegistry, labels: dict[str, str]):
        self._root = root
        self._labels = labels

    def counter(self, name: str, doc: str = "") -> Counter:
        metric = self._root._get_or_create(Counter, name, doc, tuple(self._labels))
        return metric.labels(**self._labels)

    def gauge(self, name: str, doc: str = "") -> Gauge:
        metric = self._root._get_or_create(Gauge, name, doc, tuple(self._labels))
        return metric.labels(**self._labels)

    def remove_gauge(self, name: str) -> None:
        """Drop this label-set's child of a gauge (no-op if absent).
        For exporters with CLIENT-CONTROLLED label values (per-tenant
        queue gauges): without removal, every value ever seen leaves a
        permanent series in /metrics — unbounded output from a header."""
        key = f"Gauge:{PREFIX}_{name}:{tuple(self._labels)}"
        metric = self._root._metrics.get(key)
        if metric is not None:
            try:
                metric.remove(*self._labels.values())
            except KeyError:
                pass

    def histogram(self, name: str, doc: str = "", buckets: tuple | None = None) -> Histogram:
        kwargs = {"buckets": buckets} if buckets else {}
        metric = self._root._get_or_create(Histogram, name, doc, tuple(self._labels), **kwargs)
        return metric.labels(**self._labels)
