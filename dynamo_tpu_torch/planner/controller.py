"""The closed-loop SLA autoscaling controller.

The port's copy of ``dynamo_tpu/planner/controller.py``, held to it by
``tests/test_torch_copies.py``.

``Planner`` (planner_core) owns the *math*: predict the rate, interpolate
the profile, size prefill and decode pools against the TTFT/TPOT targets.
``PlannerController`` owns the *loop*: consume event-plane Observations
(``FleetMetricsObserver`` over the fleet aggregator — per-phase means,
queue depths, shed counters, SLO attainment), turn the math's desired
replica counts into safe actuations, and drive them through a Connector.

What "safe" means here, and why a bare `set_replicas(plan)` loop is not
enough at fleet scale:

- **Reactive pressure.** The rate predictor is a trend-follower; a burst
  or a chaos blip shows up in the queues and shed counters *before* it
  shows up in the fitted rate. A standing queue beyond
  ``queue_depth_per_replica`` per live replica asks for enough extra
  replicas to amortize the backlog back to that depth; any typed shed
  in the window, or SLO attainment under ``attainment_floor``, raises
  the desired count above the math's answer — TTFT misses push the
  prefill pool, TPOT misses push the decode pool.
- **Hysteresis.** Scale-down needs the desired count to sit below the
  current target for ``down_stable_cycles`` consecutive cycles; a single
  trough sample (or a chaos blip that briefly empties the queues) never
  sheds capacity. Scale-up is deliberately asymmetric: one cycle of
  demand is enough.
- **Cooldowns.** After actuating, the pool holds for
  ``scale_up_cooldown_s`` / ``scale_down_cooldown_s`` before moving the
  same direction again — replica changes take effect with lag (process
  spawn, drain window), and re-deciding from observations that predate
  the actuation flaps the fleet.
- **Bounded steps.** At most ``max_step_up`` / ``max_step_down``
  replicas move per pool per cycle: a pathological observation window
  can never double the fleet or halve it in one decision.
- **Reconciliation.** The per-pool target is re-asserted through the
  connector every cycle, not only when a decision moves it: an actuation
  that failed mid-cycle is retried next interval, and dead children are
  reaped and respawned even while the decision is "hold".
- **Drain-only scale-down.** The controller never kills: the connector
  contract is that removing a replica triggers the worker's graceful drain
  (SIGTERM → deregister → finish in-flight → exit), so scale-down during
  active decode completes every stream bit-identically.

Every decision is counted (``planner_decisions_total{action}``), every
pool's current/target replicas are gauged, and each cycle emits a
``planner_cycle`` trace span — exported through the fleet aggregator
(:meth:`~dynamo_tpu.obs.aggregator.FleetAggregator.attach_controller`)
so ``/fleet`` shows what the controller did and why.
"""

from __future__ import annotations

import asyncio
import logging
import math
import time
from dataclasses import dataclass, field
from typing import Awaitable, Callable

from dynamo_tpu_torch import tracing
from dynamo_tpu_torch.planner.planner_core import Observation, Plan, Planner

log = logging.getLogger("dynamo_tpu.planner.controller")

# Decision outcomes, one counter each (planner_decisions_total{action}).
ACTIONS = (
    "scale_up",
    "scale_down",
    "hold",
    "cooldown_hold",
    "hysteresis_hold",
    # Control plane dark: the observation window is blind, so
    # the controller neither scales nor re-actuates — targets freeze at
    # last-known-good until the bus returns.
    "degraded_hold",
)

# How a pool maps onto the Plan's replica counts. "max" serves aggregated
# fleets (one pool doing both phases): it takes the larger of the two
# requirements, since the same workers must satisfy both budgets.
PLAN_ATTRS = {
    "prefill": lambda p: p.prefill_replicas,
    "decode": lambda p: p.decode_replicas,
    "max": lambda p: max(p.prefill_replicas, p.decode_replicas),
}


@dataclass
class ControllerConfig:
    interval_s: float = 10.0
    scale_up_cooldown_s: float = 15.0
    scale_down_cooldown_s: float = 60.0
    # Consecutive cycles the desired count must sit below the current
    # target before a scale-down actuates (the flap guard).
    down_stable_cycles: int = 3
    max_step_up: int = 4
    max_step_down: int = 1
    # Reactive pressure: queued requests per live replica beyond which
    # the pool scales up regardless of the fitted rate (0 disables).
    queue_depth_per_replica: float = 8.0
    # Any typed shed in the window forces up-pressure (overload has
    # already started; waiting for the predictor to notice is too late).
    shed_pressure: bool = True
    # SLO-attainment floor: below it, the missing target's pool gets
    # up-pressure (ttft -> prefill, tpot -> decode; both for "max"
    # pools). 0 disables.
    attainment_floor: float = 0.92
    min_replicas: int = 1
    max_replicas: int = 16
    # Per-pool (min, max) overrides — a prefill pool rarely needs the
    # decode pool's ceiling. Pools not listed use the globals above.
    pool_limits: dict[str, tuple[int, int]] = field(default_factory=dict)


@dataclass
class PoolState:
    component: str
    plan_attr: str                      # "prefill" | "decode" | "max"
    target: int = 1                     # last actuated replica count
    desired: int = 1                    # this cycle's pre-clamp desire
    last_scale_up_t: float = float("-inf")
    last_scale_down_t: float = float("-inf")
    below_streak: int = 0               # consecutive cycles desired < target
    last_action: str = "hold"
    last_reason: str = ""


class PlannerController:
    """observe → plan → decide → actuate, with the guard rails above.

    ``pools`` maps component name (the connector's scaling unit) to its
    plan attribute: ``{"prefill": "prefill", "decode": "decode"}`` for a
    disaggregated fleet, ``{"backend": "max"}`` for an aggregated one.
    ``clock`` is injectable so the fleet harness (and tests) run the loop
    on a virtual timeline.
    """

    def __init__(
        self,
        planner: Planner,
        connector,
        pools: dict[str, str] | None = None,
        config: ControllerConfig | None = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.planner = planner
        self.connector = connector
        self.config = config or ControllerConfig()
        pools = pools or {"prefill": "prefill", "decode": "decode"}
        for attr in pools.values():
            if attr not in PLAN_ATTRS:
                raise ValueError(
                    f"unknown plan attribute {attr!r} "
                    f"(expected one of {sorted(PLAN_ATTRS)})"
                )
        start = max(1, self.config.min_replicas)
        self.pools = {
            comp: PoolState(component=comp, plan_attr=attr, target=start,
                            desired=start)
            for comp, attr in pools.items()
        }
        self.clock = clock
        self.decisions: dict[str, int] = {a: 0 for a in ACTIONS}
        self.cycles = 0
        self.last_plan: Plan | None = None
        self.last_observation: Observation | None = None
        self._tracer = tracing.get_tracer("planner")

    # -- one adjustment cycle ----------------------------------------------

    async def cycle(self, obs: Observation) -> dict[str, str]:
        """Run one closed-loop adjustment from an Observation; returns
        {component: action}. Exceptions from the connector propagate —
        the loop wrapper logs and retries next interval."""
        now = self.clock()
        self.cycles += 1
        self.last_observation = obs
        if obs.control_plane_degraded:
            # Hold EVERYTHING on a blind window: no plan math (the
            # predictor must not ingest phantom-zero rates), no decision
            # movement, no actuation (the connector likely can't reach
            # its substrate mid-outage anyway; the standing targets are
            # re-asserted on the first healthy cycle). Hysteresis streaks
            # freeze too — an outage must not count toward a scale-down.
            actions = {}
            for pool in self.pools.values():
                actions[pool.component] = self._note(
                    pool, "degraded_hold", "control plane dark"
                )
                self.decisions["degraded_hold"] += 1
            log.warning(
                "planner cycle %d held: control plane dark", self.cycles
            )
            return actions
        with self._tracer.span(
            "planner_cycle",
            attrs={
                "cycle": self.cycles,
                "request_rate": round(obs.request_rate, 3),
                "queue_depth": obs.queue_depth,
                "shed_delta": obs.shed_delta,
            },
        ) as span:
            plan = self.planner.compute_plan(obs)
            self.last_plan = plan
            actions: dict[str, str] = {}
            for pool in self.pools.values():
                desired, reason = self._desired(pool, plan, obs)
                pool.desired = desired
                action = self._decide(pool, desired, now, reason)
                actions[pool.component] = action
                self.decisions[action] += 1
            # Reconcile EVERY pool EVERY cycle, not just on scale
            # decisions: set_replicas is idempotent (reap dead children,
            # top up / drain down to the count), so a failed actuation
            # is retried next cycle (``target`` is the standing intent,
            # committed above) and a worker that crashes during steady
            # "hold" load is respawned next interval instead of waiting
            # for the next unrelated scale decision.
            for pool in self.pools.values():
                await self.connector.set_replicas(pool.component, pool.target)
            span.set("predicted_rate", round(plan.predicted_rate, 3))
            for pool in self.pools.values():
                span.set(f"{pool.component}_target", pool.target)
                span.set(f"{pool.component}_action", pool.last_action)
        return actions

    def _desired(
        self, pool: PoolState, plan: Plan, obs: Observation
    ) -> tuple[int, str]:
        """The math's answer for this pool, lifted by reactive pressure."""
        cfg = self.config
        desired = PLAN_ATTRS[pool.plan_attr](plan)
        reason = "rate"
        live = (obs.live_workers or {}).get(pool.component, pool.target)
        pressure = pool.target + cfg.max_step_up  # one full step up
        if cfg.queue_depth_per_replica:
            # Backlog-proportional pressure: enough replicas that the
            # standing queue amortizes to the configured per-replica
            # depth — a deep backlog asks for real catch-up capacity,
            # not a fixed nudge (actuation is still bounded by
            # max_step_up per cycle). When the feed attributes queues to
            # components, this pool only answers for ITS OWN backlog — a
            # prefill-side queue must not scale the decode pool.
            per = cfg.queue_depth_per_replica
            if obs.queue_depths is not None:
                qd = obs.queue_depths.get(pool.component, 0.0)
            else:
                qd = obs.queue_depth
            backlog = qd - per * max(1, live)
            if backlog > 0:
                want = max(1, live) + int(math.ceil(backlog / per))
                if want > desired:
                    desired, reason = want, "queue_depth"
        if cfg.shed_pressure and obs.shed_delta > 0 and desired < pressure:
            desired, reason = pressure, "sheds"
        if cfg.attainment_floor and obs.slo_attainment:
            miss_ttft = (
                obs.slo_attainment.get("ttft", 1.0) < cfg.attainment_floor
            )
            miss_tpot = (
                obs.slo_attainment.get("tpot", 1.0) < cfg.attainment_floor
            )
            relevant = {
                "prefill": miss_ttft,
                "decode": miss_tpot,
                "max": miss_ttft or miss_tpot,
            }[pool.plan_attr]
            if relevant and desired <= pool.target:
                desired, reason = pool.target + 1, "slo_attainment"
        lo, hi = cfg.min_replicas, cfg.max_replicas
        return max(lo, min(hi, desired)), reason

    def _decide(
        self, pool: PoolState, desired: int, now: float, reason: str
    ) -> str:
        cfg = self.config
        if desired > pool.target:
            pool.below_streak = 0
            if now - pool.last_scale_up_t < cfg.scale_up_cooldown_s:
                return self._note(pool, "cooldown_hold", f"up blocked ({reason})")
            new = min(desired, pool.target + cfg.max_step_up)
            pool.last_scale_up_t = now
            log.info(
                "scale up %s: %d -> %d (%s, desired %d)",
                pool.component, pool.target, new, reason, desired,
            )
            pool.target = new
            return self._note(pool, "scale_up", reason)
        if desired < pool.target:
            pool.below_streak += 1
            if pool.below_streak < cfg.down_stable_cycles:
                return self._note(
                    pool, "hysteresis_hold",
                    f"below for {pool.below_streak}/{cfg.down_stable_cycles}",
                )
            if now - pool.last_scale_down_t < cfg.scale_down_cooldown_s:
                return self._note(pool, "cooldown_hold", "down blocked")
            new = max(desired, pool.target - cfg.max_step_down)
            pool.last_scale_down_t = now
            # Streak survives a partial step so a deep trough keeps
            # draining one replica per cooldown without re-proving itself.
            if new == desired:
                pool.below_streak = 0
            log.info(
                "scale down %s: %d -> %d (drain; desired %d)",
                pool.component, pool.target, new, desired,
            )
            pool.target = new
            return self._note(pool, "scale_down", reason)
        pool.below_streak = 0
        return self._note(pool, "hold", reason)

    def _note(self, pool: PoolState, action: str, reason: str) -> str:
        pool.last_action = action
        pool.last_reason = reason
        return action

    # -- the loop ----------------------------------------------------------

    async def run(
        self,
        observe: Callable[[], Awaitable[Observation]],
        stop_event: asyncio.Event | None = None,
    ) -> None:
        """``observe()`` → Observation each ``interval_s`` (the wall-clock
        production loop; the fleet harness calls :meth:`cycle` directly
        on its virtual timeline)."""
        while stop_event is None or not stop_event.is_set():
            try:
                obs = await observe()
                await self.cycle(obs)
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 — one bad cycle must not kill the loop
                log.exception("planner cycle failed; retrying next interval")
            if stop_event is None:
                await asyncio.sleep(self.config.interval_s)
            else:
                try:
                    await asyncio.wait_for(
                        stop_event.wait(), self.config.interval_s
                    )
                except asyncio.TimeoutError:
                    pass

    # -- observability ------------------------------------------------------

    def stats(self) -> dict:
        """Gauge payload (the aggregator/status-server export shape):
        decision counters by action + per-pool current/desired."""
        return {
            "cycles": self.cycles,
            "decisions": dict(self.decisions),
            "pools": {
                comp: {
                    "target": p.target,
                    "desired": p.desired,
                    "last_action": p.last_action,
                }
                for comp, p in self.pools.items()
            },
        }

    def status_payload(self) -> dict:
        """The ``/fleet`` planner section: what the controller did and
        why, per pool, plus the last plan's math."""
        plan = self.last_plan
        obs = self.last_observation
        return {
            "cycles": self.cycles,
            "decisions": dict(self.decisions),
            "pools": {
                comp: {
                    "target": p.target,
                    "desired": p.desired,
                    "plan_attr": p.plan_attr,
                    "last_action": p.last_action,
                    "last_reason": p.last_reason,
                    "below_streak": p.below_streak,
                }
                for comp, p in self.pools.items()
            },
            "last_plan": (
                {
                    "predicted_rate": round(plan.predicted_rate, 3),
                    "prefill_replicas": plan.prefill_replicas,
                    "decode_replicas": plan.decode_replicas,
                    "correction_prefill": round(plan.correction_prefill, 3),
                    "correction_decode": round(plan.correction_decode, 3),
                }
                if plan
                else None
            ),
            "last_observation": (
                {
                    "request_rate": round(obs.request_rate, 3),
                    "queue_depth": obs.queue_depth,
                    "shed_delta": obs.shed_delta,
                    "slo_attainment": obs.slo_attainment,
                }
                if obs
                else None
            ),
        }
