"""Host-memory KV tier (G2): blocks evicted from device memory stay cached
in host RAM and onboard back on a prefix hit.

The port's copy of ``dynamo_tpu/engine/host_cache.py``, held to it by
``tests/test_torch_copies.py``.

The counterpart of the reference's KVBM offload tier
(`lib/llm/src/block_manager/offload.rs`, `storage/cuda.rs` pinned-host
pool, CacheLevel G1/G2 in `block_manager.rs:75-86`): device eviction
demotes instead of destroys; admission checks G2 after G1 and promotes
hits before prefill. Router KV events fire on the *worker* boundary — a
block offloaded to host is still "stored" (onboardable); only host-pool
eviction emits "removed".
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable

import numpy as np


@dataclass
class HostPoolStats:
    offloads: int = 0
    onboards: int = 0
    evictions: int = 0


@dataclass
class _HostBlock:
    parent_hash: int | None
    # Combined page [L, block_size, 2*n_kv, d] — or, for quantized KV
    # caches, the canonical packed uint8 buffer (int8 payload + f32
    # scales, engine/kv_quant.py). Either way the pool stores EXACTLY
    # the bytes it was handed and hands them back verbatim: tier
    # residency never re-encodes a block.
    kv: np.ndarray


class HostKvPool:
    def __init__(
        self,
        capacity_blocks: int,
        on_removed: Callable[[list[int]], None] | None = None,
    ):
        self.capacity = capacity_blocks
        self._blocks: OrderedDict[int, _HostBlock] = OrderedDict()  # LRU
        self.on_removed = on_removed or (lambda hashes: None)
        # When set (G3 disk tier behind this pool), LRU eviction demotes
        # the block — called with (hash, parent, kv) — instead of
        # emitting `removed`.
        self.on_evict_block: Callable[[int, int | None, np.ndarray], None] | None = None
        self.stats = HostPoolStats()

    def __contains__(self, block_hash: int) -> bool:
        return block_hash in self._blocks

    def __len__(self) -> int:
        return len(self._blocks)

    def put(self, block_hash: int, parent_hash: int | None, kv: np.ndarray) -> None:
        if block_hash in self._blocks:
            self._blocks.move_to_end(block_hash)
            return
        while len(self._blocks) >= self.capacity:
            h, old = self._blocks.popitem(last=False)
            self.stats.evictions += 1
            if self.on_evict_block is not None:
                self.on_evict_block(h, old.parent_hash, old.kv)
            else:
                self.on_removed([h])
        self._blocks[block_hash] = _HostBlock(parent_hash, kv)
        self.stats.offloads += 1

    def get(self, block_hash: int) -> _HostBlock | None:
        blk = self._blocks.get(block_hash)
        if blk is not None:
            self._blocks.move_to_end(block_hash)
        return blk

    def pop(self, block_hash: int) -> _HostBlock | None:
        """Remove on onboarding — the block is device-resident again and
        G1 eviction would re-offload it here."""
        blk = self._blocks.pop(block_hash, None)
        if blk is not None:
            self.stats.onboards += 1
        return blk

    def snapshot(self) -> list[tuple[int, int | None]]:
        """(hash, parent) inventory in insertion (≈chain) order — the
        anti-entropy resync's host-tier slice. Caller synchronizes (the
        offload engine's condition guards every mutation)."""
        return [(h, blk.parent_hash) for h, blk in self._blocks.items()]
