"""KV-router wire types: cache events and worker load metrics.

The port's copy of ``dynamo_tpu/llm/kv_router/protocols.py``, held to it by
``tests/test_torch_copies.py``.

Workers publish :class:`RouterEvent` batches on the control-plane subject
``kv_events.{namespace}.{component}`` as their paged caches store/evict
blocks, and :class:`ForwardPassMetrics` on ``load_metrics.{...}``. Routers
consume both to maintain the global prefix index and the load term of the
scheduling cost.

Capability parity: reference `lib/llm/src/kv_router/protocols.rs:32-85`
(ForwardPassMetrics{WorkerStats,KvStats}) and the RouterEvent scheme of
`kv_router/indexer.rs`.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Any

import msgpack


def kv_events_subject(namespace: str, component: str) -> str:
    return f"kv_events.{namespace}.{component}"

def kv_resync_subject(namespace: str, component: str) -> str:
    """Anti-entropy channel: an indexer that detected an event-id GAP for
    a worker publishes ``{"w": worker_id}`` here; that worker's publisher
    answers with a full-inventory re-publish (cleared + stored events)."""
    return f"kv_events_resync.{namespace}.{component}"

def load_metrics_subject(namespace: str, component: str) -> str:
    return f"load_metrics.{namespace}.{component}"


# KV residency tiers a block-hash event can describe. "device" doubles as
# the worker-level tag: pre-tier publishers never set a tier, and untagged
# wire events decode to "device", so old workers and new indexers (and
# vice versa) stay compatible.
KV_TIERS = ("device", "host", "disk")


@dataclass(frozen=True)
class KvCacheEvent:
    """One store/remove on one worker's paged KV cache.

    ``stored``: ``block_hashes`` are chained seq hashes appended under
    ``parent_hash`` (None = sequence roots). ``removed``: hashes evicted.
    ``tier`` says WHICH residency tier the transition happened on
    (device HBM / host RAM / disk); the cluster-wide pool index composes
    per-worker tier sets, and a worker "holds" a block while ANY tier
    does. Untagged (legacy) events are device-tier.
    """

    op: str  # "stored" | "removed" | "cleared"
    block_hashes: tuple[int, ...] = ()
    parent_hash: int | None = None
    tier: str = "device"


@dataclass(frozen=True)
class RouterEvent:
    worker_id: int
    event_id: int  # per-worker monotonic
    event: KvCacheEvent

    def to_wire(self) -> bytes:
        d = {
            "w": self.worker_id,
            "i": self.event_id,
            "op": self.event.op,
            "h": list(self.event.block_hashes),
            "p": self.event.parent_hash,
        }
        if self.event.tier != "device":
            # Device-tier events travel untagged — byte-compatible with
            # every pre-tier consumer (and most events are device-tier).
            d["t"] = self.event.tier
        return msgpack.packb(d)

    @classmethod
    def from_wire(cls, raw: bytes) -> "RouterEvent":
        d = msgpack.unpackb(raw, raw=False)
        return cls(
            worker_id=d["w"],
            event_id=d["i"],
            event=KvCacheEvent(
                op=d["op"],
                block_hashes=tuple(d["h"]),
                parent_hash=d["p"],
                tier=d.get("t", "device"),
            ),
        )


@dataclass
class KvStats:
    kv_active_blocks: int = 0
    kv_total_blocks: int = 0
    gpu_cache_usage_perc: float = 0.0  # name kept for dashboard parity; TPU HBM usage
    gpu_prefix_cache_hit_rate: float = 0.0


@dataclass
class WorkerStats:
    request_active_slots: int = 0
    request_total_slots: int = 0
    num_requests_waiting: int = 0
    # Overload robustness (ISSUE 10): the engine's bounded-queue ceiling
    # (0 = unbounded) and its shed counters, so routing can skip a
    # saturated worker BEFORE the dial instead of bouncing off its
    # shed error (NetKV's point: follow measured queue depth).
    queue_limit: int = 0
    requests_shed_total: int = 0
    # Most recent step's batched-tokens / token-budget ratio — the
    # per-phase load signal the planner/monitor read.
    budget_utilization: float = 0.0


@dataclass
class ForwardPassMetrics:
    worker_id: int = 0
    worker: WorkerStats = field(default_factory=WorkerStats)
    kv: KvStats = field(default_factory=KvStats)
    # Speculative-decoding gauges (dynamo_tpu/spec SpecStats.as_dict():
    # acceptance_rate, mean_accepted_len, drafted/accepted/wasted token
    # counters). None = speculation off and never used on this worker.
    spec_decode: dict[str, Any] | None = None
    # Disagg KV transfer accounting (imported/skipped/dropped block
    # counts; see EngineCore.transfer_stats). None = engine predates it.
    transfer: dict[str, int] | None = None
    # Network-aware routing (NetKV, ISSUE 14): this worker's MEASURED
    # per-peer KV-pull cost — {source worker_id: {"pulls", "failures",
    # "blocks", "ms_per_block"}} from PeerPullStats.net_dict(). Routers
    # fold every reporter's view of a peer into one fleet-wide transfer
    # cost per source. None = no pulls observed / engine predates it.
    net: dict[int, dict] | None = None

    def to_wire(self) -> bytes:
        d = asdict(self)
        if d.get("net"):
            # Stringify map keys: msgpack's default strict unpacker
            # refuses integer map keys.
            d["net"] = {str(k): v for k, v in d["net"].items()}
        return msgpack.packb(d)

    @classmethod
    def from_wire(cls, raw: bytes) -> "ForwardPassMetrics":
        d = msgpack.unpackb(raw, raw=False)
        net = d.get("net")
        return cls(
            worker_id=d["worker_id"],
            worker=WorkerStats(**d["worker"]),
            kv=KvStats(**d["kv"]),
            spec_decode=d.get("spec_decode"),
            transfer=d.get("transfer"),
            net={int(k): v for k, v in net.items()} if net else None,
        )


@dataclass
class RouterConfig:
    """Scheduling knobs (parity: KvRouterConfig in reference args)."""

    overlap_weight: float = 1.0      # reward for cached prefix blocks
    temperature: float = 0.0         # 0 = deterministic argmin of cost
    use_kv_events: bool = True       # False → ApproxKvIndexer
    replica_sync: bool = False
    # Exclude workers whose KV-cache usage is at/above this fraction from
    # routing while alternatives exist (busy-aware routing; reference
    # worker_monitor.rs + frontend --busy-threshold). None = off.
    busy_threshold: float | None = None
    # Saturation-aware routing (ISSUE 10): also exclude workers with at
    # least this many queued requests. None = auto — workers exporting a
    # bounded-queue limit are skipped when their queue reaches it.
    queue_threshold: int | None = None
    # Network-aware routing (NetKV, ISSUE 14): extend the cost beyond
    # prefix overlap with (a) each candidate's queue depth and (b) the
    # MEASURED per-peer KV-pull cost — prefill a candidate can avoid by
    # pulling a peer's cached prefix only counts as avoided in proportion
    # to how cheap that peer's transfers actually are. Off (default) the
    # selector and peer hints are byte-identical to the overlap-only
    # router.
    network_aware: bool = False
    # Blocks-equivalent cost per queued request on a candidate (the load
    # term NetKV weighs next to transfer cost). Used only when
    # network_aware is on.
    queue_weight: float = 1.0
    # Per-block local prefill recompute cost in ms — the yardstick a
    # measured peer pull must beat (a pull at or above this never counts
    # as prefill relief). Set it from the engine profile
    # (block_size * prefill us/token / 1000); the default suits the
    # mocker's timing. Used only when network_aware is on.
    recompute_ms_per_block: float = 2.0
    # None → inherit the model card's kv_block_size at model-add time.
    # Must match the worker's KV block size or seq hashes never overlap.
    block_size: int | None = None
