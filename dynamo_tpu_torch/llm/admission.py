"""Frontend admission control: per-tenant rate limits + in-flight ceiling.

The port's copy of ``dynamo_tpu/llm/admission.py``, held to it by
``tests/test_torch_copies.py``.

The first line of overload defense (ISSUE 10): before a request touches
the router or a worker, the frontend decides whether it may enter at all.
Two independent gates, both answering with OpenAI-style typed errors the
caller can act on:

* **Per-tenant token bucket** — requests/second with a burst allowance,
  keyed on the validated ``x-tenant-id`` header (default tenant
  otherwise). Over-limit answers ``429`` with ``Retry-After`` set to the
  bucket's actual refill time, so well-behaved clients back off to
  exactly the sustainable rate.
* **Bounded in-flight ceiling** — a hard cap on concurrently admitted
  LLM requests across all tenants. At the ceiling the frontend answers a
  retryable ``503`` (reason ``queue_full``) instead of stacking work
  onto workers that PR 6's containment machinery would then have to
  shed anyway.

Deadlines are resolved here too: ``dyn.deadline_ms`` (request body) or
``x-request-deadline-ms`` (header, wins) becomes an absolute
``deadline_epoch`` stamped on the PreprocessedRequest, so scheduler
queue time downstream counts against the client's budget.

Everything is wall-clock-injectable for deterministic tests. Parity: the
reference runs SLA-driven admission through its frontend/planner
(PAPER.md §L4); this is the rate/ceiling half, the planner half scales
capacity.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable

# Idle buckets are dropped once the tenant table exceeds this many
# entries — a rotating-tenant-id client must not grow frontend memory
# unboundedly (a full bucket carries no state worth keeping).
MAX_TRACKED_TENANTS = 4096


@dataclass
class AdmissionConfig:
    """Frontend admission knobs (CLI: ``--tenant-rate-limit``,
    ``--tenant-burst``, ``--max-inflight-requests``)."""

    # Sustained requests/second per tenant; 0 = rate limiting off.
    tenant_rate: float = 0.0
    # Bucket capacity (burst allowance); 0 = auto (max(1, ceil(rate))).
    tenant_burst: int = 0
    # Concurrently admitted LLM requests across all tenants; 0 = unbounded.
    max_inflight: int = 0

    @property
    def burst(self) -> int:
        if self.tenant_burst > 0:
            return self.tenant_burst
        return max(1, int(self.tenant_rate + 0.999))

    @property
    def enabled(self) -> bool:
        return self.tenant_rate > 0 or self.max_inflight > 0


@dataclass
class Decision:
    """One admission verdict. ``admitted`` callers MUST pair with
    :meth:`AdmissionController.release`."""

    admitted: bool
    status: int = 200                  # 429 (rate) / 503 (ceiling) when rejected
    reason: str = ""                   # rate_limit | queue_full
    retry_after_s: float = 0.0
    message: str = ""


class _TokenBucket:
    __slots__ = ("rate", "burst", "tokens", "last")

    def __init__(self, rate: float, burst: int, now: float):
        self.rate = rate
        self.burst = float(burst)
        self.tokens = float(burst)
        self.last = now

    def try_acquire(self, now: float) -> float:
        """0.0 on success; otherwise seconds until one token refills."""
        self.tokens = min(self.burst, self.tokens + (now - self.last) * self.rate)
        self.last = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return 0.0
        return max(0.001, (1.0 - self.tokens) / self.rate)

    @property
    def full(self) -> bool:
        return self.tokens >= self.burst - 1e-9


@dataclass
class AdmissionController:
    config: AdmissionConfig
    clock: Callable[[], float] = time.monotonic
    inflight: int = 0
    shed_total: int = 0
    _buckets: dict[str, _TokenBucket] = field(default_factory=dict)

    def admit(self, tenant: str) -> Decision:
        now = self.clock()
        bucket = None
        if self.config.tenant_rate > 0:
            bucket = self._buckets.get(tenant)
            if bucket is None:
                self._gc(now)
                bucket = self._buckets[tenant] = _TokenBucket(
                    self.config.tenant_rate, self.config.burst, now
                )
            wait = bucket.try_acquire(now)
            if wait > 0.0:
                self.shed_total += 1
                return Decision(
                    admitted=False, status=429, reason="rate_limit",
                    retry_after_s=wait,
                    message=(
                        f"tenant {tenant or 'default'!r} exceeded "
                        f"{self.config.tenant_rate:g} req/s "
                        f"(burst {self.config.burst})"
                    ),
                )
        if self.config.max_inflight > 0 and self.inflight >= self.config.max_inflight:
            if bucket is not None:
                # Refund: the request never used the capacity its rate
                # token represents — keeping it would double-penalize
                # the tenant (503 now, 429 again on the advertised
                # retry for work the frontend never took).
                bucket.tokens = min(bucket.burst, bucket.tokens + 1.0)
            self.shed_total += 1
            return Decision(
                admitted=False, status=503, reason="queue_full",
                retry_after_s=1.0,
                message=(
                    f"frontend at its in-flight ceiling "
                    f"({self.config.max_inflight} requests)"
                ),
            )
        self.inflight += 1
        return Decision(admitted=True)

    def release(self) -> None:
        self.inflight = max(0, self.inflight - 1)

    def _gc(self, now: float) -> None:
        """Drop refilled (stateless) buckets when the tenant table grows
        past the bound; an adversarial tenant-id spray then costs O(1)
        memory instead of O(requests)."""
        if len(self._buckets) < MAX_TRACKED_TENANTS:
            return
        for key in [k for k, b in self._buckets.items() if b.full]:
            del self._buckets[key]

    def stats(self) -> dict:
        return {
            "inflight": self.inflight,
            "shed_total": self.shed_total,
            "tracked_tenants": len(self._buckets),
            "max_inflight": self.config.max_inflight,
            "tenant_rate": self.config.tenant_rate,
        }


def resolve_deadline(
    body_deadline_ms: float | None,
    header_deadline_ms: str | None,
    now_epoch: float | None = None,
) -> tuple[float | None, float | None, str | None]:
    """Resolve the request deadline from ``dyn.deadline_ms`` and the
    ``x-request-deadline-ms`` header (header wins — it is what proxies
    and load balancers stamp). Returns ``(deadline_ms, deadline_epoch,
    error)``; ``error`` is a client-facing message for an unusable
    value (non-numeric / non-positive)."""
    deadline_ms = body_deadline_ms
    if header_deadline_ms is not None and header_deadline_ms.strip():
        try:
            deadline_ms = float(header_deadline_ms.strip())
        except ValueError:
            return None, None, (
                f"x-request-deadline-ms must be a number, got "
                f"{header_deadline_ms!r}"
            )
    if deadline_ms is None:
        return None, None, None
    if not deadline_ms > 0:
        return None, None, f"deadline_ms must be positive, got {deadline_ms!r}"
    now = time.time() if now_epoch is None else now_epoch
    return float(deadline_ms), now + deadline_ms / 1000.0, None
