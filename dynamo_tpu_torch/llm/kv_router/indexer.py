"""Global prefix index: which workers hold which KV blocks.

The port's copy of ``dynamo_tpu/llm/kv_router/indexer.py``, held to it by
``tests/test_torch_copies.py``.

Because block hashes are *chained* (tokens/blocks.py), a hash uniquely
identifies its entire prefix, so the radix tree flattens into a hash → node
map while keeping radix-tree semantics: ``find_matches`` scores each worker
by the number of *contiguous leading* blocks it holds, which is exactly the
prefix-overlap a paged cache can reuse.

Single-writer discipline: only the indexer's event task mutates the tree
(parity with the reference's task-owned RadixTree, `kv_router/indexer.rs:
222-747`); readers run on the same event loop, so no locks.

Also here: :class:`ApproxKvIndexer`, the no-KV-events fallback that infers
cache contents from this router's own routing decisions with a TTL
(parity `kv_router/approx.rs:166-299`).
"""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass, field

from dynamo_tpu_torch.llm.kv_router.protocols import KvCacheEvent, RouterEvent

log = logging.getLogger("dynamo_tpu.kv_router.indexer")


@dataclass
class _Node:
    workers: set[int] = field(default_factory=set)
    parent_hash: int | None = None
    children: set[int] = field(default_factory=set)


class RadixTree:
    def __init__(self) -> None:
        self._nodes: dict[int, _Node] = {}
        self._last_event_id: dict[int, int] = {}

    # -- mutation (single writer) -----------------------------------------

    def apply_event(self, event: RouterEvent) -> None:
        last = self._last_event_id.get(event.worker_id)
        if last is not None and event.event_id <= last:
            return  # replay/duplicate
        self._last_event_id[event.worker_id] = event.event_id
        ev = event.event
        if ev.op == "stored":
            self._apply_stored(event.worker_id, ev)
        elif ev.op == "removed":
            self._apply_removed(event.worker_id, ev)
        elif ev.op == "cleared":
            self.remove_worker(event.worker_id)

    def _apply_stored(self, worker_id: int, ev: KvCacheEvent) -> None:
        parent = ev.parent_hash
        for h in ev.block_hashes:
            node = self._nodes.get(h)
            if node is None:
                node = self._nodes[h] = _Node(parent_hash=parent)
                if parent is not None and parent in self._nodes:
                    self._nodes[parent].children.add(h)
            node.workers.add(worker_id)
            parent = h

    def _apply_removed(self, worker_id: int, ev: KvCacheEvent) -> None:
        for h in ev.block_hashes:
            node = self._nodes.get(h)
            if node is None:
                continue
            node.workers.discard(worker_id)
            if not node.workers:
                self._prune(h)

    def _prune(self, h: int) -> None:
        node = self._nodes.get(h)
        if node is None or node.workers:
            return
        for child in list(node.children):
            self._prune(child)
        node = self._nodes.pop(h, None)
        if node and node.parent_hash is not None:
            parent = self._nodes.get(node.parent_hash)
            if parent:
                parent.children.discard(h)

    def remove_worker(self, worker_id: int) -> None:
        dead = [h for h, n in self._nodes.items() if worker_id in n.workers]
        for h in dead:
            self._nodes[h].workers.discard(worker_id)
        for h in dead:
            self._prune(h)
        self._last_event_id.pop(worker_id, None)

    # -- queries -----------------------------------------------------------

    def find_matches(self, seq_hashes: list[int], early_exit: bool = False) -> dict[int, int]:
        """Per-worker count of contiguous leading blocks present.

        Parity: `RadixTree::find_matches` (indexer.rs:274).
        """
        scores: dict[int, int] = {}
        alive: set[int] | None = None
        for depth, h in enumerate(seq_hashes, start=1):
            node = self._nodes.get(h)
            if node is None or not node.workers:
                break
            present = node.workers if alive is None else (alive & node.workers)
            if not present:
                break
            for w in present:
                scores[w] = depth
            alive = set(present)
            if early_exit and len(alive) == 1:
                break
        return scores

    def num_blocks(self, worker_id: int | None = None) -> int:
        if worker_id is None:
            return len(self._nodes)
        return sum(1 for n in self._nodes.values() if worker_id in n.workers)

    def workers(self) -> set[int]:
        out: set[int] = set()
        for n in self._nodes.values():
            out |= n.workers
        return out

    def dump_as_events(self, worker_id: int) -> list[RouterEvent]:
        """Re-sync stream for replica routers (parity indexer.rs:445
        `dump_tree_as_events`)."""
        events: list[RouterEvent] = []
        i = 0
        for h, node in self._nodes.items():
            if worker_id in node.workers:
                i += 1
                events.append(
                    RouterEvent(
                        worker_id,
                        i,
                        KvCacheEvent(op="stored", block_hashes=(h,), parent_hash=node.parent_hash),
                    )
                )
        return events


class KvIndexer:
    """Event-driven indexer: subscribes to the kv_events subject and applies
    events to its global index on a single task.

    The index is a :class:`~dynamo_tpu.llm.kv_pool.global_index.
    GlobalKvIndex` — the tier-composing cluster-pool view — wrapping a
    radix tree for the per-request overlap hot loop. Uses the C++ tree
    (native/radix_tree.cpp via ctypes) when the toolchain can provide it,
    falling back to the Python tree (`DYNAMO_TPU_NO_NATIVE=1` forces the
    fallback).

    Anti-entropy: when the index detects a per-worker event-id GAP (the
    worker's bounded publisher dropped events), the indexer publishes a
    resync request on ``resync_subject``; the worker answers with a
    ``cleared`` + full-inventory re-publish."""

    def __init__(self, store, subject: str, resync_subject: str | None = None):
        from dynamo_tpu_torch import knobs
        from dynamo_tpu_torch.llm.kv_pool.global_index import GlobalKvIndex

        self._store = store
        self._subject = subject
        self._resync_subject = resync_subject
        inner: RadixTree
        if knobs.raw("DYNAMO_TPU_NO_NATIVE"):
            inner = RadixTree()
        else:
            try:
                from dynamo_tpu_torch.llm.kv_router.native_radix import NativeRadixTree

                inner = NativeRadixTree()  # type: ignore[assignment]
            except (RuntimeError, OSError):
                inner = RadixTree()
        self.tree = GlobalKvIndex(inner, on_gap=self._request_resync)
        self._task: asyncio.Task | None = None
        self._sub = None
        # Worker ids seen in events — tree-implementation-agnostic (the
        # native tree has no workers() enumeration); used by replica-sync
        # bootstrap dumps.
        self.known_workers: set[int] = set()

    def _request_resync(self, worker_id: int) -> None:
        """Ask a gapped worker for its full inventory (fire-and-forget —
        the request is an optimization; the stale entries also age out
        with the worker's lease)."""
        if self._resync_subject is None:
            return
        import msgpack

        from dynamo_tpu_torch.runtime.tasks import spawn_logged

        async def _send() -> None:
            try:
                await self._store.publish(
                    self._resync_subject, msgpack.packb({"w": worker_id})
                )
            except ConnectionError:
                log.warning("kv resync request publish failed (store down?)")

        spawn_logged(_send(), name="kv-resync-request", logger=log)

    async def start(self) -> None:
        self._sub = await self._store.subscribe(self._subject)
        self._task = asyncio.create_task(self._loop())

    async def stop(self) -> None:
        if self._task:
            self._task.cancel()
        if self._sub:
            await self._sub.unsubscribe()

    async def _loop(self) -> None:
        assert self._sub is not None
        async for ev in self._sub:
            try:
                self.apply(RouterEvent.from_wire(ev["p"]))
            except Exception:  # noqa: BLE001 — one bad event must not kill routing
                log.exception("bad kv event")

    def apply(self, event: RouterEvent) -> None:
        """The single way a RouterEvent enters this indexer — live stream
        and replica bootstrap both come through here, so the worker is
        always recorded (bootstrap-only radix state must still be served
        to the next late joiner)."""
        self.known_workers.add(event.worker_id)
        self.tree.apply_event(event)

    def find_matches(self, seq_hashes: list[int]) -> dict[int, int]:
        return self.tree.find_matches(seq_hashes)

    def remove_worker(self, worker_id: int) -> None:
        self.known_workers.discard(worker_id)
        self.tree.remove_worker(worker_id)


class ApproxKvIndexer:
    """TTL-based overlap estimate from this router's own routing decisions —
    used when workers cannot emit KV events."""

    def __init__(self, ttl_s: float = 120.0):
        self.ttl_s = ttl_s
        # hash → {worker_id → expiry}
        self._entries: dict[int, dict[int, float]] = {}

    def process_routing_decision(self, worker_id: int, seq_hashes: list[int]) -> None:
        expiry = time.monotonic() + self.ttl_s
        for h in seq_hashes:
            self._entries.setdefault(h, {})[worker_id] = expiry

    def find_matches(self, seq_hashes: list[int]) -> dict[int, int]:
        now = time.monotonic()
        scores: dict[int, int] = {}
        alive: set[int] | None = None
        for depth, h in enumerate(seq_hashes, start=1):
            entry = self._entries.get(h)
            if not entry:
                break
            live = {w for w, exp in entry.items() if exp > now}
            present = live if alive is None else (alive & live)
            if not present:
                break
            for w in present:
                scores[w] = depth
            alive = set(present)
        return scores

    def remove_worker(self, worker_id: int) -> None:
        for entry in self._entries.values():
            entry.pop(worker_id, None)

    def prune(self) -> None:
        now = time.monotonic()
        for h in list(self._entries):
            entry = {w: e for w, e in self._entries[h].items() if e > now}
            if entry:
                self._entries[h] = entry
            else:
                del self._entries[h]
