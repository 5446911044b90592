"""Per-tenant weighted fair admission queue (deficit round robin).

The port's copy of ``dynamo_tpu/engine/fair_queue.py``: the same
deficit-round-robin admission queue, so both engines admit in one order.

The scheduler's ``waiting`` line is the one place a single heavy tenant
can starve everyone else: strict FIFO admits in arrival order, so a
burst of long prompts from one client parks every other tenant behind
it. This queue replaces the FIFO deque in BOTH engines (EngineCore and
the mocker) with classic deficit-round-robin over *token cost*: each
active tenant holds a deficit counter; when the rotation pointer visits
a tenant it earns one quantum of tokens, and its head request is
admitted only once the deficit covers the request's prompt cost. Light
tenants therefore admit at most one quantum behind a flood, regardless
of how deep the heavy tenant's backlog is — the property the fairness
A/B (bench.py run_overload_ab) measures.

Design constraints:

* **Fairness off == the old deque, bit for bit.** With ``fair=False``
  every item maps to one tenant key, DRR over one queue degenerates to
  exact FIFO, and ``appendleft`` (preemption requeue) is the old
  ``deque.appendleft``. The same holds for fairness ON with a single
  tenant — which is what makes the single-tenant bit-identity invariant
  (tests/test_overload.py) structural rather than incidental.
* **Priority inside a tenant.** ``priority`` orders requests WITHIN a
  tenant's queue (higher first, FIFO among equals, enqueue-time only —
  an O(n) insert on the rare prioritized enqueue). Cross-tenant shares
  stay equal: priority is a per-tenant ordering hint, not a bigger
  bandwidth slice, so one tenant cannot buy starvation of another.
* **Externally synchronized.** Like DeviceBlockAllocator, every caller
  reaches this object under the engine's step lock (or the mocker's
  single-threaded sim loop); registered EXTERNAL in GUARDED_BY.
  ``stats()`` takes list() snapshots so a metrics scrape from another
  thread never iterates a mutating dict.

Capability parity: the reference frontend leans on SLA-planner admission
(PAPER.md §L4); per-tenant WFQ in the engine's admission loop is the
missing piece ROADMAP item 4(b) names for multi-tenant survivability.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Callable, Iterator

DEFAULT_TENANT = ""


class FairQueue:
    """Deficit-round-robin admission queue over per-tenant deques.

    ``cost_fn`` maps an item to its admission token cost (prompt length
    for engine sequences); ``quantum`` is the tokens a tenant earns per
    rotation visit. Items are expected to carry ``tenant_id`` (str) and
    ``priority`` (int) attributes; missing attributes degrade to the
    default tenant / priority 0.
    """

    def __init__(
        self,
        quantum: int = 2048,
        fair: bool = True,
        cost_fn: Callable[[Any], int] | None = None,
    ):
        self.quantum = max(1, int(quantum))
        self.fair = fair
        self._cost_fn = cost_fn or (lambda item: 1)
        self._queues: dict[str, deque] = {}
        self._deficits: dict[str, float] = {}
        # Active-tenant rotation; position 0 is the tenant the DRR
        # pointer is currently serving.
        self._order: deque[str] = deque()
        # The tenant that already received its quantum for the current
        # rotation visit (classic DRR grants ONCE per visit; the visit
        # ends when the tenant can no longer afford its head, at which
        # point the pointer rotates and the grant re-arms).
        self._visit_granted: str | None = None

    # -- enqueue -----------------------------------------------------------

    def _key(self, item: Any) -> str:
        if not self.fair:
            return DEFAULT_TENANT
        return getattr(item, "tenant_id", "") or DEFAULT_TENANT

    def _queue_for(self, key: str) -> deque:
        q = self._queues.get(key)
        if q is None:
            q = self._queues[key] = deque()
            self._deficits[key] = 0.0
            self._order.append(key)
        return q

    def append(self, item: Any) -> None:
        q = self._queue_for(self._key(item))
        prio = getattr(item, "priority", 0) or 0
        # Priority only reorders WITHIN a tenant's own queue — with
        # fairness off everyone shares one queue, and honoring a
        # client-controlled priority there would be exactly the
        # cross-tenant queue-jumping this module exists to prevent
        # (and would break the off == exact-FIFO invariant).
        if self.fair and prio > 0 and q:
            # Before the first queued item with strictly lower priority
            # (stable among equals).
            for i, other in enumerate(q):
                if (getattr(other, "priority", 0) or 0) < prio:
                    q.insert(i, item)
                    return
        q.append(item)

    def appendleft(self, item: Any) -> None:
        """Requeue at the FRONT of the item's tenant queue and move that
        tenant to the head of the rotation — the preemption contract: a
        preempted victim is the next admission candidate, exactly as the
        old ``deque.appendleft`` made it."""
        key = self._key(item)
        self._queue_for(key).appendleft(item)
        if self._order[0] != key:
            self._order.remove(key)
            self._order.appendleft(key)
            self._visit_granted = None  # the interrupted visit re-arms

    # -- DRR head selection -------------------------------------------------

    def head(self) -> Any | None:
        """The item deficit-round-robin admits next (or None when empty).
        Each rotation visit grants the tenant ONE quantum; a tenant that
        still cannot afford its head passes the pointer on. Repeated
        calls without an intervening :meth:`pop` are idempotent once a
        serveable tenant is found (no further deficit accrues), so an
        admission attempt blocked on allocator headroom can retry the
        same head every step."""
        if not self._order:
            return None
        # Each full rotation adds one quantum to every active tenant, so
        # some tenant becomes affordable within ceil(max_cost / quantum)
        # rotations; the guard is a defensive bound, never the exit path.
        max_cost = max(
            max(1, self._cost_fn(q[0])) for q in self._queues.values()
        )
        bound = (max_cost // self.quantum + 2) * (len(self._order) + 1)
        for _ in range(bound):
            key = self._order[0]
            item = self._queues[key][0]
            cost = max(1, self._cost_fn(item))
            if self._visit_granted != key:
                self._deficits[key] += self.quantum
                self._visit_granted = key
            if self._deficits[key] >= cost:
                return item
            # Visit over without an admission: pass the pointer on.
            self._order.rotate(-1)
            self._visit_granted = None
        return self._queues[self._order[0]][0]  # pragma: no cover — guard

    def pop(self) -> Any | None:
        """Remove and return :meth:`head`, charging its token cost to
        the tenant's deficit. A tenant whose queue empties leaves the
        rotation and forfeits its remaining deficit (classic DRR — idle
        tenants must not hoard bandwidth); a tenant that can no longer
        afford its next head yields the pointer until its next visit."""
        item = self.head()
        if item is None:
            return None
        key = self._order[0]
        q = self._queues[key]
        q.popleft()
        self._deficits[key] -= max(1, self._cost_fn(item))
        if not q:
            self._drop_tenant(key)
        elif self._deficits[key] < max(1, self._cost_fn(q[0])):
            # Quantum spent: end this tenant's visit.
            self._order.rotate(-1)
            self._visit_granted = None
        return item

    def _drop_tenant(self, key: str) -> None:
        self._queues.pop(key, None)
        self._deficits.pop(key, None)
        if self._visit_granted == key:
            self._visit_granted = None
        try:
            self._order.remove(key)
        except ValueError:  # already gone (defensive)
            pass

    # -- removal / sweeps ---------------------------------------------------

    def remove(self, item: Any) -> bool:
        for key in list(self._queues):
            q = self._queues[key]
            try:
                q.remove(item)
            except ValueError:
                continue
            if not q:
                self._drop_tenant(key)
            return True
        return False

    def sweep(self, pred: Callable[[Any], bool]) -> list[Any]:
        """Remove every queued item matching ``pred`` (any position, any
        tenant) and return them in queue order — the cancel/deadline
        sweep entry point: a client disconnect or an expired deadline
        must not wait for its request to reach the head of the line."""
        removed: list[Any] = []
        for key in list(self._queues):
            q = self._queues[key]
            # Fast path: the common per-step sweep finds nothing — one
            # early-exit scan, no list rebuild, no allocation.
            if not any(pred(item) for item in q):
                continue
            kept = [item for item in q if not pred(item)]
            removed.extend(item for item in q if pred(item))
            if kept:
                self._queues[key] = deque(kept)
            else:
                self._drop_tenant(key)
        return removed

    # -- introspection ------------------------------------------------------

    # len/bool/contains take list() snapshots: EngineCore.add_request
    # (bounded-queue check) and metrics scrapes read these from other
    # threads while the step thread adds/drops tenant keys — iterating
    # the live dict would raise "dictionary changed size during
    # iteration" exactly under the load this module exists to survive.

    def __len__(self) -> int:
        return sum(len(q) for q in list(self._queues.values()))

    def __bool__(self) -> bool:
        return any(list(self._queues.values()))

    def __contains__(self, item: Any) -> bool:
        return any(item in q for q in list(self._queues.values()))

    def __iter__(self) -> Iterator[Any]:
        for key in list(self._order):
            q = self._queues.get(key)
            if q is not None:
                yield from list(q)

    def stats(self) -> dict[str, dict[str, float]]:
        """Per-tenant queue depth + deficit snapshot (/metrics export via
        status_server.bind_fair_queue_gauges). Safe to call from a
        scrape thread: list() snapshots, no live iteration."""
        out: dict[str, dict[str, float]] = {}
        for key in list(self._queues):
            q = self._queues.get(key)
            if q is None:
                continue
            out[key or "default"] = {
                "depth": float(len(q)),
                "deficit": float(self._deficits.get(key, 0.0)),
            }
        return out
