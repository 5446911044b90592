"""The SLA planner: observe → predict → plan → scale.

The port's copy of ``dynamo_tpu/planner/planner_core.py``, held to it by
``tests/test_torch_copies.py``.

Capability parity: reference `components/planner/src/dynamo/planner/utils/
planner_core.py:55-528` (adjustment loop, correction factors,
`_compute_replica_requirements` :246-331) and SURVEY.md §3.5. Scaling goes
through a Connector so tests use an in-memory recorder and production uses
an orchestrator (K8s operator equivalent) without touching the math.
"""

from __future__ import annotations

import asyncio
import logging
import math
from dataclasses import dataclass, field
from typing import Protocol

from dynamo_tpu_torch import knobs
from dynamo_tpu_torch.planner.load_predictor import PREDICTORS, BasePredictor
from dynamo_tpu_torch.planner.perf_interpolation import DecodeInterpolator, PrefillInterpolator

log = logging.getLogger("dynamo_tpu.planner")


@dataclass
class SlaTargets:
    ttft_s: float = knobs.default("DYN_SLO_TTFT_MS") / 1e3
    itl_s: float = knobs.default("DYN_SLO_TPOT_MS") / 1e3

    @classmethod
    def from_env(cls) -> "SlaTargets":
        """The same env knobs the SLO attributor reads
        (``DYN_SLO_TTFT_MS`` / ``DYN_SLO_TPOT_MS``) — one spelling of the
        targets across attribution and autoscaling, so ``/fleet``
        attainment and the controller's scaling pressure can never judge
        against different budgets."""
        return cls(
            ttft_s=knobs.get_float("DYN_SLO_TTFT_MS") / 1e3,
            itl_s=knobs.get_float("DYN_SLO_TPOT_MS") / 1e3,
        )


@dataclass
class PlannerConfig:
    adjustment_interval_s: float = 60.0
    min_replicas: int = 1
    max_replicas: int = 16
    predictor: str = "ar"
    # Headroom so predicted load doesn't plan replicas at 100% utilization.
    utilization_target: float = 0.9


@dataclass
class Observation:
    """One adjustment window's worth of aggregated frontend metrics."""

    request_rate: float      # requests/s
    mean_isl: float          # input tokens/request
    mean_osl: float          # output tokens/request
    observed_ttft_s: float | None = None
    observed_itl_s: float | None = None
    # Measured TTFT/ITL decomposition from the tracer's per-phase
    # histograms ({phase: mean seconds} over the window) — lets the
    # planner tell a routing regression from a prefill regression instead
    # of reasoning from totals alone.
    phase_means: dict[str, float] | None = None
    # Closed-loop signals, filled by the fleet aggregator's
    # event-plane feed: point-in-time queue depth summed over live
    # workers, typed sheds (queue-full + deadline) observed in the
    # window, per-target SLO attainment over the attributor's recent
    # records ({"ttft": frac, "tpot": frac}), and live worker counts per
    # component. The rate math above ignores these; the controller reads
    # them as reactive scaling pressure.
    queue_depth: float = 0.0
    # Queue depth keyed by worker component (e.g. prefill/decode/backend)
    # when the feed can attribute it — lets the controller aim backlog
    # pressure at the pool that actually holds the backlog. None = only
    # the fleet-wide total above is known.
    queue_depths: dict[str, float] | None = None
    shed_delta: float = 0.0
    slo_attainment: dict[str, float] | None = None
    live_workers: dict[str, int] | None = None
    # Control-plane outage flag: True when the observation was
    # assembled while the store session was down (or the whole event
    # plane went silent at once). The controller HOLDS actuation on such
    # windows — a dark bus reads as "zero arrivals, empty queues", and
    # scaling down a healthy serving fleet on that phantom trough is
    # exactly the flap degraded mode exists to prevent.
    control_plane_degraded: bool = False


@dataclass
class Plan:
    prefill_replicas: int
    decode_replicas: int
    predicted_rate: float
    correction_prefill: float
    correction_decode: float


class Connector(Protocol):
    async def set_replicas(self, component: str, replicas: int) -> None: ...


class RecordingConnector:
    """Test/dry-run connector: records the scaling decisions."""

    def __init__(self):
        self.calls: list[tuple[str, int]] = []

    async def set_replicas(self, component: str, replicas: int) -> None:
        self.calls.append((component, replicas))

    def current(self, component: str, default: int = 1) -> int:
        for c, n in reversed(self.calls):
            if c == component:
                return n
        return default


class Planner:
    def __init__(
        self,
        prefill_interp: PrefillInterpolator,
        decode_interp: DecodeInterpolator,
        connector: Connector,
        sla: SlaTargets | None = None,
        config: PlannerConfig | None = None,
    ):
        self.prefill_interp = prefill_interp
        self.decode_interp = decode_interp
        self.connector = connector
        self.sla = sla or SlaTargets()
        self.config = config or PlannerConfig()
        self.rate_predictor: BasePredictor = PREDICTORS[self.config.predictor]()
        # Correction factors: observed/expected latency ratio — models drift
        # between offline profile and live behavior (planner_core.py:
        # correction factors, sla_planner.md:64-84).
        self.correction_prefill = 1.0
        self.correction_decode = 1.0

    # -- planning math -----------------------------------------------------

    def _update_corrections(self, obs: Observation) -> None:
        # Prefer the tracer's measured prefill-phase mean over total TTFT:
        # totals fold tokenize/route/queue time into the prefill correction,
        # so a routing regression would wrongly scale up prefill replicas.
        ttft_signal = (obs.phase_means or {}).get("prefill") or obs.observed_ttft_s
        if ttft_signal:
            expected = self.prefill_interp.ttft_at(obs.mean_isl)
            if expected > 0:
                self.correction_prefill = max(0.1, min(10.0, ttft_signal / expected))
        if obs.observed_itl_s:
            conc = self.decode_interp.max_concurrency_within(self.sla.itl_s)
            expected = self.decode_interp.itl_at(conc)
            if expected > 0:
                self.correction_decode = max(0.1, min(10.0, obs.observed_itl_s / expected))

    def compute_plan(self, obs: Observation) -> Plan:
        self._update_corrections(obs)
        self.rate_predictor.observe(obs.request_rate)
        rate = self.rate_predictor.predict()
        util = self.config.utilization_target

        # Prefill: demand = rate * isl tokens/s, adjusted by how much worse
        # live TTFT runs than the profile; capacity = one replica's prefill
        # throughput at this ISL while still inside the TTFT budget.
        prefill_demand = rate * obs.mean_isl * self.correction_prefill
        isl_cap = min(
            obs.mean_isl,
            self.prefill_interp.max_isl_within(self.sla.ttft_s),
        )
        prefill_capacity = self.prefill_interp.throughput_at(isl_cap) * util
        prefill = math.ceil(prefill_demand / max(prefill_capacity, 1e-9))

        # Decode: demand = rate * osl tokens/s; capacity = concurrency the
        # ITL budget allows x token rate at that concurrency.
        decode_demand = rate * obs.mean_osl * self.correction_decode
        conc = self.decode_interp.max_concurrency_within(self.sla.itl_s)
        decode_capacity = self.decode_interp.throughput_at(conc) * util
        decode = math.ceil(decode_demand / max(decode_capacity, 1e-9))

        lo, hi = self.config.min_replicas, self.config.max_replicas
        return Plan(
            prefill_replicas=max(lo, min(hi, prefill)),
            decode_replicas=max(lo, min(hi, decode)),
            predicted_rate=rate,
            correction_prefill=self.correction_prefill,
            correction_decode=self.correction_decode,
        )

    # -- loop --------------------------------------------------------------

    async def apply(self, plan: Plan) -> None:
        await self.connector.set_replicas("prefill", plan.prefill_replicas)
        await self.connector.set_replicas("decode", plan.decode_replicas)

    async def run(self, observe, stop_event: asyncio.Event | None = None) -> None:
        """``observe()`` -> Observation each adjustment interval."""
        while stop_event is None or not stop_event.is_set():
            obs = await observe()
            plan = self.compute_plan(obs)
            log.info(
                "plan: rate=%.2f -> prefill=%d decode=%d (corr %.2f/%.2f)",
                plan.predicted_rate, plan.prefill_replicas, plan.decode_replicas,
                plan.correction_prefill, plan.correction_decode,
            )
            await self.apply(plan)
            await asyncio.sleep(self.config.adjustment_interval_s)
