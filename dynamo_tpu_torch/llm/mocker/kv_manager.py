"""Paged-KV bookkeeping for the mock engine: prefix caching + LRU eviction.

The port's copy of ``dynamo_tpu/llm/mocker/kv_manager.py``, held to it by
``tests/test_torch_copies.py``.

Models what a paged-attention engine's cache does: refcounted active
blocks, an inactive LRU pool that stays cached until capacity pressure
evicts it, prefix reuse by chained block hash. It surfaces stored and
removed transitions so the mocker emits real KV events, which is what
makes router tests meaningful without an accelerator.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable


@dataclass
class _Block:
    block_hash: int
    parent_hash: int | None
    refcount: int = 0


class InsufficientBlocksError(RuntimeError):
    pass


@dataclass
class KvManagerStats:
    stored_events: int = 0
    removed_events: int = 0
    prefix_hits: int = 0
    prefix_queries: int = 0


class MockKvManager:
    def __init__(
        self,
        num_blocks: int,
        block_size: int = 32,
        enable_prefix_caching: bool = True,
        on_stored: Callable[[list[int], int | None], None] | None = None,
        on_removed: Callable[[list[int]], None] | None = None,
    ):
        self.capacity = num_blocks
        self.block_size = block_size
        self.enable_prefix_caching = enable_prefix_caching
        self._active: dict[int, _Block] = {}
        self._inactive: OrderedDict[int, _Block] = OrderedDict()  # LRU, oldest first
        self._partial_in_use = 0  # partial (unhashed) blocks held by sequences
        self.on_stored = on_stored or (lambda hashes, parent: None)
        self.on_removed = on_removed or (lambda hashes: None)
        self.stats = KvManagerStats()

    # -- capacity ----------------------------------------------------------

    @property
    def used_blocks(self) -> int:
        return len(self._active) + len(self._inactive) + self._partial_in_use

    @property
    def free_blocks(self) -> int:
        """Blocks allocatable right now (inactive LRU counts as reclaimable)."""
        return self.capacity - len(self._active) - self._partial_in_use

    @property
    def usage_perc(self) -> float:
        return self.used_blocks / self.capacity if self.capacity else 0.0

    # -- prefix cache ------------------------------------------------------

    def match_prefix(self, seq_hashes: list[int]) -> int:
        """Contiguous leading blocks already cached (active or inactive)."""
        self.stats.prefix_queries += 1
        n = 0
        for h in seq_hashes:
            if h in self._active or h in self._inactive:
                n += 1
            else:
                break
        if n:
            self.stats.prefix_hits += 1
        return n

    # -- allocation --------------------------------------------------------

    def _evict_lru(self) -> bool:
        if not self._inactive:
            return False
        h, _ = self._inactive.popitem(last=False)
        self.stats.removed_events += 1
        self.on_removed([h])
        return True

    def _ensure_headroom(self, blocks_needed: int) -> None:
        while self.capacity - self.used_blocks < blocks_needed:
            if not self._evict_lru():
                raise InsufficientBlocksError(
                    f"need {blocks_needed} blocks, "
                    f"{self.capacity - self.used_blocks} available"
                )

    def acquire_cached(self, seq_hashes: list[int]) -> int:
        """Pin the cached prefix of a sequence; returns blocks pinned."""
        if not self.enable_prefix_caching:
            return 0
        n = 0
        for h in seq_hashes:
            block = self._active.get(h)
            if block is None:
                block = self._inactive.pop(h, None)
                if block is not None:
                    self._active[h] = block
            if block is None:
                break
            block.refcount += 1
            n += 1
        return n

    def allocate_partial(self, count: int = 1) -> None:
        """Reserve space for not-yet-complete blocks (no hash yet)."""
        self._ensure_headroom(count)
        self._partial_in_use += count

    def commit_block(self, block_hash: int, parent_hash: int | None) -> None:
        """A partial block filled up: register it under its hash (emits a
        stored event unless it deduplicates onto an existing block)."""
        assert self._partial_in_use > 0
        self._partial_in_use -= 1
        existing = self._active.get(block_hash)
        if existing is not None:
            existing.refcount += 1
            return
        revived = self._inactive.pop(block_hash, None)
        if revived is not None:
            revived.refcount += 1
            self._active[block_hash] = revived
            return
        self._active[block_hash] = _Block(block_hash, parent_hash, refcount=1)
        self.stats.stored_events += 1
        self.on_stored([block_hash], parent_hash)

    def release_partial(self, count: int) -> None:
        self._partial_in_use -= count
        assert self._partial_in_use >= 0

    def release(self, seq_hashes: list[int]) -> None:
        """Unpin a sequence's complete blocks; zero-ref blocks go to the
        inactive LRU (still cached → still 'stored' for the router)."""
        for h in seq_hashes:
            block = self._active.get(h)
            if block is None:
                continue
            block.refcount -= 1
            if block.refcount <= 0:
                del self._active[h]
                if self.enable_prefix_caching:
                    self._inactive[h] = block
                    self._inactive.move_to_end(h)
                else:
                    self.stats.removed_events += 1
                    self.on_removed([h])

    def held_prefix(self, seq_hashes: list[int]) -> list[int]:
        """Contiguous leading hashes this worker can serve (active or
        inactive), WITHOUT touching the prefix-probe counters — the peer
        kv_fetch server's read, mirroring EngineCore.read_cached_pages'
        'longest locally-held prefix' contract."""
        held: list[int] = []
        for h in seq_hashes:
            if h in self._active or h in self._inactive:
                held.append(h)
            else:
                break
        return held

    def import_block(self, block_hash: int, parent_hash: int | None) -> bool:
        """Register peer-pulled content as cached-but-unpinned (inactive
        LRU) — the mocker twin of DeviceBlockAllocator.register_inactive.
        Returns True when the block was actually imported (False: already
        cached, or the pool cannot make headroom)."""
        if block_hash in self._active or block_hash in self._inactive:
            return False
        try:
            self._ensure_headroom(1)
        except InsufficientBlocksError:
            return False
        self._inactive[block_hash] = _Block(block_hash, parent_hash)
        self._inactive.move_to_end(block_hash)
        self.stats.stored_events += 1
        self.on_stored([block_hash], parent_hash)
        return True

    def snapshot(self) -> list[tuple[int, int | None]]:
        """(hash, parent) for every cached block — the mocker's
        anti-entropy resync inventory (single device tier)."""
        out = [(h, b.parent_hash) for h, b in self._active.items()]
        out += [(h, b.parent_hash) for h, b in self._inactive.items()]
        return out

    def clear_unpinned(self) -> list[int]:
        """Drop only the inactive (unpinned) cache — in-flight sequences
        keep their blocks; emits `removed` for the router. The admin
        clear_kv_blocks semantics (same contract as the real engine's
        allocator.clear_cache)."""
        hashes = list(self._inactive)
        self._inactive.clear()
        if hashes:
            self.stats.removed_events += len(hashes)
            self.on_removed(hashes)
        return hashes

    def clear(self) -> list[int]:
        """Drop the whole cache (reset); returns hashes that were cached."""
        hashes = list(self._active) + list(self._inactive)
        self._active.clear()
        self._inactive.clear()
        self._partial_in_use = 0
        return hashes
