"""Physical KV-block allocator: free list + prefix cache + LRU eviction.

The port's copy of ``dynamo_tpu/engine/block_allocator.py``, kept
byte-for-byte in behaviour (the prefix cache and its KV events must agree
with the JAX engine's).

The device-facing sibling of the mocker's hash-only bookkeeping
(`dynamo_tpu/llm/mocker/kv_manager.py`): every block here is a *physical*
page index into the engine's paged KV cache arrays, so sequences get block
tables they can hand straight to the jitted steps. Content-addressing uses
the shared chained hashes (`dynamo_tpu/tokens`), which keeps the worker's
KV events hash-compatible with the router's radix indexer.

Lifecycle (parity with reference `lib/llm/src/block_manager` registry +
pools, `block/registry.rs:490`, `pool/managed.rs`):

    free -> partial (allocated, no hash) -> committed (hash-registered,
    refcounted) -> inactive LRU (refcount 0, still cached) -> evicted

Commits deduplicate by hash: if the content already exists, the caller's
physical copy is freed and the canonical id returned — callers patch their
block table (identical bytes, so the swap is invisible to the device).
"""

from __future__ import annotations

from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Callable


class OutOfBlocksError(RuntimeError):
    pass


@dataclass
class _Committed:
    block_id: int
    block_hash: int
    parent_hash: int | None
    refcount: int = 0


class DeviceBlockAllocator:
    def __init__(
        self,
        num_blocks: int,
        block_size: int,
        enable_prefix_caching: bool = True,
        on_stored: Callable[[list[int], int | None], None] | None = None,
        on_removed: Callable[[list[int]], None] | None = None,
    ):
        self.capacity = num_blocks
        self.block_size = block_size
        self.enable_prefix_caching = enable_prefix_caching
        self._free: deque[int] = deque(range(num_blocks))
        self._by_hash: dict[int, _Committed] = {}
        self._inactive: OrderedDict[int, _Committed] = OrderedDict()  # hash -> block, LRU
        self._partials = 0
        self.on_stored = on_stored or (lambda hashes, parent: None)
        self.on_removed = on_removed or (lambda hashes: None)
        # Optional demotion hook (host KV tier): called with
        # (block_id, hash, parent) BEFORE an evicted block's storage is
        # reused; when set, eviction does not emit `removed` — the block
        # lives on at the next tier and the hook's owner emits removal
        # when it truly leaves the worker.
        self.on_evict: Callable[[int, int, int | None], None] | None = None
        self.prefix_queries = 0
        self.prefix_hits = 0

    # -- capacity ----------------------------------------------------------

    @property
    def free_blocks(self) -> int:
        """Immediately or evictably allocatable blocks."""
        return len(self._free) + len(self._inactive)

    @property
    def used_blocks(self) -> int:
        return self.capacity - len(self._free)

    @property
    def usage_perc(self) -> float:
        return self.used_blocks / self.capacity if self.capacity else 0.0

    # -- allocation --------------------------------------------------------

    def _evict_lru(self) -> None:
        h, blk = self._inactive.popitem(last=False)
        del self._by_hash[h]
        if self.on_evict is not None:
            self.on_evict(blk.block_id, h, blk.parent_hash)
        else:
            self.on_removed([h])
        self._free.append(blk.block_id)

    def alloc(self) -> int:
        """A fresh partial (uncommitted) block; evicts LRU under pressure."""
        if not self._free:
            if not self._inactive:
                raise OutOfBlocksError(f"all {self.capacity} blocks pinned")
            self._evict_lru()
        self._partials += 1
        return self._free.popleft()

    def alloc_many(self, n: int) -> list[int]:
        if self.free_blocks < n:
            raise OutOfBlocksError(
                f"need {n} blocks, {self.free_blocks} reclaimable"
            )
        return [self.alloc() for _ in range(n)]

    # -- prefix cache ------------------------------------------------------

    def match_prefix(self, seq_hashes: list[int]) -> int:
        """Contiguous leading blocks currently cached (no pinning)."""
        self.prefix_queries += 1
        n = 0
        for h in seq_hashes:
            if h in self._by_hash:
                n += 1
            else:
                break
        if n:
            self.prefix_hits += 1
        return n

    def acquire_cached(self, seq_hashes: list[int]) -> list[int]:
        """Pin the cached prefix; returns its physical block ids."""
        if not self.enable_prefix_caching:
            return []
        ids: list[int] = []
        for h in seq_hashes:
            blk = self._by_hash.get(h)
            if blk is None:
                break
            if blk.refcount == 0:
                self._inactive.pop(h, None)
            blk.refcount += 1
            ids.append(blk.block_id)
        return ids

    # -- commit / release --------------------------------------------------

    def commit(self, block_id: int, block_hash: int, parent_hash: int | None) -> int:
        """Register a filled partial block under its content hash.

        Returns the canonical physical id for this hash — if another block
        already holds identical content, ``block_id`` is freed and the
        existing id returned (caller patches its table).
        """
        assert self._partials > 0
        self._partials -= 1
        existing = self._by_hash.get(block_hash)
        if existing is not None:
            if existing.refcount == 0:
                self._inactive.pop(block_hash, None)
            existing.refcount += 1
            self._free.append(block_id)
            return existing.block_id
        self._by_hash[block_hash] = _Committed(block_id, block_hash, parent_hash, refcount=1)
        self.on_stored([block_hash], parent_hash)
        return block_id

    def free_partial(self, block_id: int) -> None:
        """Return an uncommitted block to the free list (cancel/finish)."""
        assert self._partials > 0
        self._partials -= 1
        self._free.append(block_id)

    def release(self, seq_hashes: list[int]) -> None:
        """Unpin committed blocks; zero-ref blocks become inactive (still
        cached, still 'stored' from the router's view) or free."""
        for h in seq_hashes:
            blk = self._by_hash.get(h)
            if blk is None:
                continue
            blk.refcount -= 1
            if blk.refcount <= 0:
                if self.enable_prefix_caching:
                    self._inactive[h] = blk
                    self._inactive.move_to_end(h)
                else:
                    del self._by_hash[h]
                    self._free.append(blk.block_id)
                    self.on_removed([h])

    def is_cached(self, block_hash: int) -> bool:
        return block_hash in self._by_hash

    def snapshot(self) -> list[tuple[int, int | None]]:
        """(hash, parent) for every committed block, in commit (≈chain)
        order — the anti-entropy resync's device-tier slice. Caller
        synchronizes (EngineCore holds _step_lock)."""
        return [(h, blk.parent_hash) for h, blk in self._by_hash.items()]

    def alloc_for_import(self) -> int:
        """A block for transferred-in KV content (not partial-tracked)."""
        if not self._free:
            if not self._inactive:
                raise OutOfBlocksError(f"all {self.capacity} blocks pinned")
            self._evict_lru()
        return self._free.popleft()

    def register_inactive(
        self, block_id: int, block_hash: int, parent_hash: int | None, emit: bool = True
    ) -> int:
        """Register imported content as cached-but-unpinned (inactive LRU).
        Dedup mirrors commit(): existing hash keeps its canonical block.
        ``emit=False`` for host-tier onboarding — the block never left the
        worker, so the router already counts it as stored."""
        existing = self._by_hash.get(block_hash)
        if existing is not None:
            self._free.append(block_id)
            return existing.block_id
        blk = _Committed(block_id, block_hash, parent_hash, refcount=0)
        self._by_hash[block_hash] = blk
        self._inactive[block_hash] = blk
        self._inactive.move_to_end(block_hash)
        if emit:
            self.on_stored([block_hash], parent_hash)
        return block_id

    def clear_cache(self) -> list[int]:
        """Drop all unpinned cached blocks; returns the evicted hashes."""
        hashes = list(self._inactive)
        for h in hashes:
            blk = self._inactive.pop(h)
            del self._by_hash[h]
            self._free.append(blk.block_id)
        if hashes:
            self.on_removed(hashes)
        return hashes
