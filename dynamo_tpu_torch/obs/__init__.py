"""Fleet observability plane (ISSUE 13).

The port's copy of ``dynamo_tpu/obs/__init__.py``, held to it by
``tests/test_torch_copies.py``.

Three connected parts:

- :mod:`~dynamo_tpu.obs.snapshot` — workers periodically publish compact
  metric snapshots over the store/event plane (the same subject scheme
  the KV-event and load-metrics publishers use).
- :mod:`~dynamo_tpu.obs.aggregator` — the fleet aggregator composes those
  snapshots into ``/metrics`` series with ``worker_id`` labels plus fleet
  rollups, retires series on lease loss and drain, and feeds the SLA
  planner's :class:`~dynamo_tpu.planner.planner_core.Observation` from
  the aggregate instead of point scrapes.
- :mod:`~dynamo_tpu.obs.slo` — per-request TTFT/TPOT budget attribution
  stitched from the existing tracer spans, exported as ``dynamo_slo_*``
  histograms per tenant and the ``/fleet`` status payload.
- :mod:`~dynamo_tpu.obs.flight_recorder` — a bounded ring of recent
  engine-step records on both backends, dumped to a redacted JSON
  artifact on SIGTERM drain, stall-deadline fire, breaker open, and
  chaos kill.

Capability parity: the reference treats metrics aggregation as a
first-class service over its NATS event plane (``components/metrics``,
PAPER.md §L0/L1); the flight recorder is our post-mortem answer to the
chaos harness (PR 6) killing workers that previously left no artifact.
"""

from dynamo_tpu_torch.obs.flight_recorder import FlightRecorder, dump_all
from dynamo_tpu_torch.obs.snapshot import (
    MetricSnapshot,
    SnapshotPublisher,
    obs_subject,
)
from dynamo_tpu_torch.obs.aggregator import FleetAggregator
from dynamo_tpu_torch.obs.slo import PhaseScanner, SloAttributor, SloTargets

__all__ = [
    "FlightRecorder",
    "FleetAggregator",
    "MetricSnapshot",
    "PhaseScanner",
    "SloAttributor",
    "SloTargets",
    "SnapshotPublisher",
    "dump_all",
    "obs_subject",
]
