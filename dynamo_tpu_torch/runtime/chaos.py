"""Deterministic fault injection ("chaos") for every dynamo-tpu plane.

The port's copy of ``dynamo_tpu/runtime/chaos.py``, held to it by
``tests/test_torch_copies.py``.

Failure handling that is only exercised by real outages is failure
handling that does not work. This module gives the runtime NAMED
INJECTION POINTS — one line at each place where the system touches a
network, a peer, or an engine loop — and a :class:`ChaosPlan` that turns
a seeded, declarative rule list into faults at those points: dropped or
delayed frames, severed connections, a flapping store session, a stalled
or killed engine loop, a partitioned peer.

Design constraints (the reasons this is not "just a mock"):

* **Compiled to a no-op when disabled.** Every injection site guards on
  ``chaos.active()`` — a single module-global ``is not None`` check — so
  the production hot path pays one pointer read per frame and nothing
  else. ``tests/test_chaos.py`` pins the disabled-path overhead.
* **Deterministic.** A plan owns a ``random.Random(seed)``; the same
  plan against the same traffic fires the same faults. Probabilistic
  rules (``p < 1``) exist for soak-style runs, counted rules
  (``after``/``count``) for surgical repros.
* **Virtual-clock aware.** Delays and stalls go through the plan's
  injectable ``sleep`` so mocker-fleet tests on a sped-up clock can
  scale faults with the same knob.
* **Env/CLI loadable.** ``DYN_CHAOS_PLAN='{"seed":7,"rules":[...]}'``
  (or ``DYN_CHAOS_PLAN=@plan.json``) arms a worker at startup
  (``runtime/worker.py``), so a whole deployment can run under chaos
  without code changes.

Injection-point inventory (the contract between this module and the
call sites; tests assert against these names):

====================  ====================================================
``framing.send``      any outbound frame, every TCP plane (codec level)
``framing.recv``      any inbound frame, every TCP plane (codec level)
``dataplane.connect`` egress dial to a worker (target: ``host:port``)
``dataplane.send``    egress request/cancel frame (target: ``host:port``)
``dataplane.recv``    egress response frame (target: ``host:port``)
``store.connect``     control-plane dial/redial (target: store address)
``store.frame``       control-plane inbound frame (target: store address)
``engine.step``       one engine/sim-loop iteration (target: worker tag)
``kv_transfer.pull``  disagg/peer KV block pull (target: source worker)
``frontend.admit``    one HTTP LLM request at admission (target:
                      ``tenant/model``) — the overload/burst point:
                      ``delay`` slows admission, ``drop``/``sever`` shed
                      the request with a clean retryable 503, and a
                      ``delay`` rule on ``engine.step`` alongside it
                      turns nominal traffic into a saturating burst
                      (see :func:`burst_plan`)
====================  ====================================================

Rule actions:

``delay``  sleep ``delay_s`` before the operation proceeds
``drop``   swallow the frame (send: never written; recv: discarded)
``sever``  raise ``ConnectionError`` (connection/stream death)
``stall``  sleep ``stall_s`` (a wedged-but-connected peer — the failure
           mode deadlines and stall detection exist for)
``kill``   raise :class:`ChaosKill` (engine-loop death; the loop owner
           decides what dying means)

Capability parity: the reference leans on external chaos tooling
(pod-kill tests in its deploy layer); we pull the capability into the
runtime so a laptop test can partition a dataplane deterministically.
"""

from __future__ import annotations

import asyncio
import json
import logging
import random
import time
from dataclasses import dataclass, field
from typing import Any, Awaitable, Callable

from dynamo_tpu_torch import knobs

log = logging.getLogger("dynamo_tpu.chaos")

CHAOS_PLAN_ENV = "DYN_CHAOS_PLAN"

POINTS = (
    "framing.send",
    "framing.recv",
    "dataplane.connect",
    "dataplane.send",
    "dataplane.recv",
    "store.connect",
    "store.frame",
    "engine.step",
    "kv_transfer.pull",
    "frontend.admit",
)

ACTIONS = ("delay", "drop", "sever", "stall", "kill")


class ChaosKill(Exception):
    """An engine loop was ordered to die at an injection point."""


@dataclass
class ChaosRule:
    """One fault: WHERE (point + target match), WHEN (after/count/p),
    WHAT (action + timing)."""

    point: str
    action: str
    # Substring match against the site's target descriptor ("" = any).
    match: str = ""
    # Fire probability per eligible hit (evaluated on the plan's seeded
    # RNG, so runs reproduce).
    p: float = 1.0
    # Skip the first `after` matching hits (lets a stream start cleanly
    # before the fault lands mid-flight).
    after: int = 0
    # Maximum number of fires (None = unlimited).
    count: int | None = None
    delay_s: float = 0.05
    stall_s: float = 3600.0
    # Sustained-fault window: when > 0 the rule only fires within
    # ``window_s`` seconds of its FIRST eligible hit (measured on the
    # plan's injectable clock) and goes permanently quiet after — the
    # shape a control-plane blackout needs (sever everything for 60 s,
    # then let recovery proceed). 0 = no window (count/p gate instead).
    window_s: float = 0.0
    # Bookkeeping (not config).
    hits: int = 0
    fires: int = 0
    first_hit_t: float | None = None

    def __post_init__(self) -> None:
        if self.point not in POINTS:
            raise ValueError(
                f"unknown chaos point {self.point!r} (known: {', '.join(POINTS)})"
            )
        if self.action not in ACTIONS:
            raise ValueError(
                f"unknown chaos action {self.action!r} (known: {', '.join(ACTIONS)})"
            )


class ChaosPlan:
    """A seeded set of rules plus the fire log.

    ``sleep`` is injectable for virtual-clock tests; it must be an async
    callable taking seconds.
    """

    def __init__(
        self,
        rules: list[ChaosRule] | None = None,
        seed: int = 0,
        sleep: Callable[[float], Awaitable[None]] | None = None,
        clock: Callable[[], float] | None = None,
    ):
        self.rules = list(rules or [])
        self.seed = seed
        self.rng = random.Random(seed)
        self.sleep = sleep or asyncio.sleep
        # Window gating (``ChaosRule.window_s``) reads this clock;
        # injectable so virtual-clock fleets scale sustained faults with
        # the same knob as delays.
        self.clock = clock or time.monotonic
        # (point, action, target) per fire, in order — the deterministic
        # record tests and operators compare runs with.
        self.fired: list[tuple[str, str, str]] = []

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "ChaosPlan":
        rules = [ChaosRule(**r) for r in d.get("rules", [])]
        return cls(rules=rules, seed=int(d.get("seed", 0)))

    @classmethod
    def burst(
        cls,
        slow_s: float = 0.05,
        shed_p: float = 0.0,
        match: str = "",
        seed: int = 0,
        count: int | None = None,
    ) -> "ChaosPlan":
        """The canonical overload/burst rule set (ISSUE 10): slow every
        matching engine iteration by ``slow_s`` — normal arrival rate
        against a 1/slow_s-times-slower fleet IS a burst, queues build
        exactly as under a traffic spike — and optionally shed
        ``shed_p`` of frontend admissions (deterministic on the seed).
        Used by the overload tests to create saturation without
        touching client code."""
        rules = [
            ChaosRule(
                point="engine.step", action="delay", match=match,
                delay_s=slow_s, count=count,
            )
        ]
        if shed_p > 0.0:
            rules.append(
                ChaosRule(
                    point="frontend.admit", action="drop", p=shed_p,
                    match=match, count=count,
                )
            )
        return cls(rules=rules, seed=seed)

    @classmethod
    def store_outage(
        cls,
        duration_s: float = 60.0,
        after_frames: int = 0,
        seed: int = 0,
    ) -> "ChaosPlan":
        """The canonical control-plane blackout (ISSUE 15): sever EVERY
        store session sustainedly for ``duration_s``. The ``store.frame``
        rule kills each live session the moment its next inbound frame
        arrives (keepalive replies flow at ttl/3, so sessions die within
        a beat); the ``store.connect`` rule keeps every redial failing
        until the window passes — then reconnection and session replay
        proceed untouched. ``after_frames`` lets traffic start cleanly
        before the blackout lands. The window clocks from each rule's
        first eligible hit, so arm the plan right before the blackout
        should begin."""
        return cls(
            rules=[
                ChaosRule(
                    point="store.frame", action="sever",
                    after=after_frames, window_s=duration_s,
                ),
                ChaosRule(
                    point="store.connect", action="sever",
                    window_s=duration_s,
                ),
            ],
            seed=seed,
        )

    @classmethod
    def from_env(cls, env: str = CHAOS_PLAN_ENV) -> "ChaosPlan | None":
        """Build a plan from ``$DYN_CHAOS_PLAN`` (inline JSON, or
        ``@/path/to/plan.json``); None when unset/empty."""
        raw = (knobs.raw(env) or "").strip()
        if not raw:
            return None
        if raw.startswith("@"):
            with open(raw[1:], encoding="utf-8") as f:
                raw = f.read()
        return cls.from_dict(json.loads(raw))

    async def fire(self, point: str, target: str | None) -> bool:
        """Run every matching rule; returns False when the operation
        should be dropped, True to proceed. Raises for sever/kill."""
        proceed = True
        tgt = target or ""
        for rule in self.rules:
            if rule.point != point:
                continue
            if rule.match and rule.match not in tgt:
                continue
            rule.hits += 1
            if rule.hits <= rule.after:
                continue
            if rule.window_s > 0.0:
                now = self.clock()
                if rule.first_hit_t is None:
                    rule.first_hit_t = now
                if now - rule.first_hit_t > rule.window_s:
                    continue  # the sustained-fault window has passed
            if rule.count is not None and rule.fires >= rule.count:
                continue
            if rule.p < 1.0 and self.rng.random() >= rule.p:
                continue
            rule.fires += 1
            self.fired.append((point, rule.action, tgt))
            log.debug("chaos: %s at %s (%s)", rule.action, point, tgt or "any")
            if rule.action == "delay":
                await self.sleep(rule.delay_s)
            elif rule.action == "drop":
                proceed = False
            elif rule.action == "sever":
                raise ConnectionError(f"chaos: severed {point} ({tgt or 'any'})")
            elif rule.action == "stall":
                await self.sleep(rule.stall_s)
            elif rule.action == "kill":
                raise ChaosKill(f"chaos: kill at {point} ({tgt or 'any'})")
        return proceed


# ---------------------------------------------------------------------------
# Module-level switch. `_PLAN is None` IS the disabled state; injection
# sites guard on `active()` so the disabled hot path is one global read.
# ---------------------------------------------------------------------------

_PLAN: ChaosPlan | None = None


def install(plan: ChaosPlan) -> None:
    global _PLAN
    _PLAN = plan
    log.warning(
        "CHAOS ENABLED: %d rule(s), seed=%d — this process will inject faults",
        len(plan.rules), plan.seed,
    )


def uninstall() -> None:
    global _PLAN
    _PLAN = None


def active() -> bool:
    return _PLAN is not None


def plan() -> ChaosPlan | None:
    return _PLAN


def install_from_env() -> ChaosPlan | None:
    """Arm this process from ``$DYN_CHAOS_PLAN`` if set (worker startup
    path); returns the installed plan or None."""
    p = ChaosPlan.from_env()
    if p is not None:
        install(p)
    return p


async def inject(point: str, target: str | None = None) -> bool:
    """Fire the active plan at an injection point. Returns True when the
    guarded operation should proceed, False when it must be dropped.
    Call sites guard with ``chaos.active()`` first so the disabled path
    never awaits."""
    p = _PLAN
    if p is None:
        return True
    return await p.fire(point, target)
