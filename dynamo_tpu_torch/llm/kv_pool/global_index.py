"""Global block-hash index: the cluster-wide view of every worker's KV
memory hierarchy.

The port's copy of ``dynamo_tpu/llm/kv_pool/global_index.py``, held to it by
``tests/test_torch_copies.py``.

Workers publish tier-tagged ``RouterEvent``s (device commits, host/disk
demotions and evictions). This index COMPOSES them: it keeps a per-worker
``hash → {tiers}`` ledger and forwards *worker-level* transitions to an
inner radix tree (``kv_router/indexer.py`` RadixTree or the native C++
tree) — a worker is added to a node when its first tier stores the hash
and removed only when its LAST tier lets go. The tree therefore answers
the only question routing asks ("which workers can serve this prefix?"),
while the ledger carries the tier detail (observability; a future
cost-aware router can prefer device-tier peers).

The composition is what makes tier events safe: a bare radix tree fed a
``removed(host)`` while the block still sits on disk would retract the
worker; this index never forwards that removal.

Consistency: per-worker event ids are monotonic; duplicates are dropped,
and an id GAP (missed events — e.g. the worker's bounded publisher
overflowed) bumps ``gaps_detected`` and fires ``on_gap(worker_id)``, the
hook ``KvIndexer`` uses to request an anti-entropy resync from the
worker. A ``cleared`` event (drain retraction, resync preamble) retires
the worker's whole inventory at once — the same path lease loss takes
through ``remove_worker``.
"""

from __future__ import annotations

import logging
from typing import Callable

from dynamo_tpu_torch.llm.kv_router.protocols import KvCacheEvent, RouterEvent

log = logging.getLogger("dynamo_tpu.kv_pool.index")


class GlobalKvIndex:
    """Single-writer (the indexer's event task) like the tree it wraps."""

    def __init__(self, tree=None, on_gap: Callable[[int], None] | None = None):
        if tree is None:
            from dynamo_tpu_torch.llm.kv_router.indexer import RadixTree

            tree = RadixTree()
        self.tree = tree
        self.on_gap = on_gap
        # worker -> hash -> (parent_hash, set of tiers holding it)
        self._tiers: dict[int, dict[int, tuple[int | None, set[str]]]] = {}
        self._last_event_id: dict[int, int] = {}
        # Per-worker id counter for events FORWARDED to the tree: one
        # source event can derive several worker-level transitions, and
        # the tree dedups on monotonic ids, so forwarded events get their
        # own sequence rather than reusing the source id.
        self._fwd_id: dict[int, int] = {}
        self.gaps_detected = 0

    # -- mutation (single writer) -----------------------------------------

    def apply_event(self, event: RouterEvent) -> None:
        w = event.worker_id
        if event.event_id <= 0:
            # Unsequenced bootstrap event (dump_as_events): apply without
            # touching the dedup/gap state — a replica must not mistake
            # the dump's synthetic numbering for the worker's live id
            # sequence (live events with lower ids would be dropped as
            # replays and the replica would route on a frozen view).
            self._dispatch(event)
            return
        last = self._last_event_id.get(w)
        if last is not None and event.event_id <= last:
            return  # replay/duplicate
        if last is not None and event.event_id > last + 1:
            # Missed events: the worker-level view may now be stale until
            # the worker resyncs (KvIndexer requests it via on_gap).
            self.gaps_detected += 1
            log.warning(
                "kv event gap for worker %d (%d -> %d); requesting resync",
                w, last, event.event_id,
            )
            if self.on_gap is not None:
                self.on_gap(w)
        self._last_event_id[w] = event.event_id
        self._dispatch(event)

    def _dispatch(self, event: RouterEvent) -> None:
        ev = event.event
        if ev.op == "stored":
            self._apply_stored(event)
        elif ev.op == "removed":
            self._apply_removed(event)
        elif ev.op == "cleared":
            self._retire(event.worker_id)

    def _forward(self, worker_id: int, ev: KvCacheEvent) -> None:
        """Hand a worker-level transition to the tree under a fresh
        per-worker monotonic id (the tree dedups on ids)."""
        fid = self._fwd_id.get(worker_id, 0) + 1
        self._fwd_id[worker_id] = fid
        self.tree.apply_event(RouterEvent(worker_id, fid, ev))

    def _apply_stored(self, event: RouterEvent) -> None:
        ev = event.event
        ledger = self._tiers.setdefault(event.worker_id, {})
        parent = ev.parent_hash
        for h in ev.block_hashes:
            entry = ledger.get(h)
            if entry is None:
                ledger[h] = (parent, {ev.tier})
                # Worker-level: this hash became servable by the worker.
                # Forwarded per hash so every node chains under its own
                # parent even when the event's chain is partially known.
                self._forward(
                    event.worker_id,
                    KvCacheEvent(
                        op="stored", block_hashes=(h,), parent_hash=parent
                    ),
                )
            else:
                entry[1].add(ev.tier)
            parent = h

    def _apply_removed(self, event: RouterEvent) -> None:
        ev = event.event
        ledger = self._tiers.get(event.worker_id)
        if ledger is None:
            return
        gone: list[int] = []
        for h in ev.block_hashes:
            entry = ledger.get(h)
            if entry is None:
                continue
            entry[1].discard(ev.tier)
            if not entry[1]:
                del ledger[h]
                gone.append(h)
        if gone:
            # Last tier let go: the worker can no longer serve these.
            self._forward(
                event.worker_id,
                KvCacheEvent(op="removed", block_hashes=tuple(gone)),
            )

    def _retire(self, worker_id: int) -> None:
        self._tiers.pop(worker_id, None)
        self.tree.remove_worker(worker_id)

    def remove_worker(self, worker_id: int) -> None:
        """Retire a worker's WHOLE inventory: lease loss, graceful drain
        (the worker also publishes `cleared`), or indexer-side eviction."""
        self._retire(worker_id)
        self._last_event_id.pop(worker_id, None)

    # -- queries -----------------------------------------------------------

    def find_matches(self, seq_hashes: list[int], **kw) -> dict[int, int]:
        return self.tree.find_matches(seq_hashes, **kw)

    def holders(self, block_hash: int) -> dict[int, set[str]]:
        """worker_id -> tiers currently holding the hash."""
        out: dict[int, set[str]] = {}
        for w, ledger in self._tiers.items():
            entry = ledger.get(block_hash)
            if entry is not None:
                out[w] = set(entry[1])
        return out

    def num_blocks(self, worker_id: int | None = None) -> int:
        if worker_id is not None:
            return len(self._tiers.get(worker_id, {}))
        distinct: set[int] = set()
        for ledger in self._tiers.values():
            distinct.update(ledger)
        return len(distinct)

    def workers(self) -> set[int]:
        return {w for w, ledger in self._tiers.items() if ledger}

    def stats(self) -> dict:
        """Index-size gauges (kv_pool_* on whichever process hosts it)."""
        tier_blocks: dict[str, int] = {}
        total = 0
        for ledger in self._tiers.values():
            total += len(ledger)
            for _parent, tiers in ledger.values():
                for t in tiers:
                    tier_blocks[t] = tier_blocks.get(t, 0) + 1
        return {
            "index_blocks": self.num_blocks(),
            "index_worker_blocks": total,  # summed over workers (dupes count)
            "index_workers": len(self.workers()),
            "gaps_detected": self.gaps_detected,
            **{f"index_{t}_blocks": n for t, n in sorted(tier_blocks.items())},
        }

    def dump_as_events(self, worker_id: int) -> list[RouterEvent]:
        """Re-sync/bootstrap stream for replica routers: one stored event
        per (hash, tier) so a fresh index composes to identical state.
        Events carry id 0 — the UNSEQUENCED bootstrap marker — so a
        replica applying the dump never advances its live-id dedup state
        for the worker (the worker's own event ids keep flowing).
        Parity with RadixTree.dump_as_events (indexer.rs:445)."""
        events: list[RouterEvent] = []
        for h, (parent, tiers) in self._tiers.get(worker_id, {}).items():
            # Device first so the worker-level add precedes tier detail.
            for tier in sorted(tiers, key=lambda t: (t != "device", t)):
                events.append(
                    RouterEvent(
                        worker_id,
                        0,
                        KvCacheEvent(
                            op="stored",
                            block_hashes=(h,),
                            parent_hash=parent,
                            tier=tier,
                        ),
                    )
                )
        return events
