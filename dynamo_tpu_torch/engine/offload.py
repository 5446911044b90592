"""Async tiered KV offload pipeline: G1 device -> G2 host RAM -> G3 disk.

The port's copy of ``dynamo_tpu/engine/offload.py``, held to it by
``tests/test_torch_copies.py``.

The counterpart of the reference's KVBM offload manager
(`lib/llm/src/block_manager/offload.rs:1686` — async transfer engines with
an in-queue of evicted blocks, off the engine's critical path — and
`storage/disk.rs` for the G3 tier).

Design:

- **Eviction never blocks the engine step.** When G1 evicts, the engine
  enqueues the page's slice and its copy into pinned host memory on the
  stream it runs its steps on (so the copy reads the page before any
  later dispatch can reuse the physical block) and hands this module a
  page whose ``np.asarray`` waits on the CUDA event recorded after the
  copy. That landing happens on the offload worker thread.
- **Tiers chain by demotion.** Host-pool LRU evictions demote to disk
  (same chained content hashes — G3 files are named by hash); only a
  disk-tier eviction emits a router `removed` event, because only then has
  the worker truly forgotten the block.
- **Onboarding is tier-transparent.** `contains`/`fetch` check in-flight
  transfers, host RAM, then disk; fetching an in-flight block waits for
  its landing (rare — a block evicted and re-requested within one step).

A disk directory written by the port holds bfloat16 pages as their raw
16-bit words (``uint16`` arrays); it is not shared with the JAX package.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
from collections import OrderedDict
from pathlib import Path
from typing import Any, Callable

import numpy as np

from dynamo_tpu_torch.engine.host_cache import HostKvPool, HostPoolStats

log = logging.getLogger("dynamo_tpu.engine.offload")


class DiskKvPool:
    """G3 tier: hash-addressed KV pages on disk with LRU capacity.

    One ``.npy`` file per block, named by the chained content hash, so
    dedup across sequences falls out of the same hash scheme the
    allocator and router use (parity: `block_manager/storage/disk.rs`).
    """

    def __init__(
        self,
        directory: str | Path,
        capacity_blocks: int,
        on_removed: Callable[[list[int]], None] | None = None,
    ):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.capacity = capacity_blocks
        self.on_removed = on_removed or (lambda hashes: None)
        self._index: OrderedDict[int, int | None] = OrderedDict()  # hash -> parent, LRU
        self._lock = threading.Lock()
        self.stats = HostPoolStats()

    def _path(self, block_hash: int) -> Path:
        return self.dir / f"{block_hash & ((1 << 64) - 1):016x}.npy"

    def __contains__(self, block_hash: int) -> bool:
        with self._lock:
            return block_hash in self._index

    def __len__(self) -> int:
        with self._lock:
            return len(self._index)

    def put(self, block_hash: int, parent_hash: int | None, kv: np.ndarray) -> None:
        evicted: list[int] = []
        with self._lock:
            if block_hash in self._index:
                self._index.move_to_end(block_hash)
                return
            while len(self._index) >= self.capacity:
                old, _ = self._index.popitem(last=False)
                try:
                    self._path(old).unlink(missing_ok=True)
                except OSError:
                    log.warning("disk tier: failed to unlink block %x", old)
                self.stats.evictions += 1
                evicted.append(old)
            # Tmp-file + atomic rename: a crash mid-write must never
            # leave a torn .npy at the final path — a later peek()/pop()
            # would onboard the truncated bytes as corrupt KV. The tmp
            # name is pid-tagged so a concurrent writer of the same hash
            # (two pools sharing a directory) cannot collide; os.replace
            # is atomic on POSIX, so readers see the old state or the
            # full new file, never a partial one.
            path = self._path(block_hash)
            tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
            try:
                with open(tmp, "wb") as f:
                    np.save(f, kv)
                os.replace(tmp, path)
            except BaseException:
                tmp.unlink(missing_ok=True)
                raise
            self._index[block_hash] = parent_hash
            self.stats.offloads += 1
        if evicted:
            self.on_removed(evicted)

    def pop(self, block_hash: int) -> tuple[int | None, np.ndarray] | None:
        with self._lock:
            if block_hash not in self._index:
                return None
            parent = self._index.pop(block_hash)
            path = self._path(block_hash)
            try:
                kv = np.load(path)
                path.unlink(missing_ok=True)
            except OSError:
                log.warning("disk tier: failed to load block %x", block_hash)
                return None
            self.stats.onboards += 1
            return parent, kv

    def peek(self, block_hash: int) -> np.ndarray | None:
        """Non-destructive read (peer-serving: the block stays resident)."""
        with self._lock:
            if block_hash not in self._index:
                return None
            self._index.move_to_end(block_hash)
            try:
                return np.load(self._path(block_hash))
            except OSError:
                log.warning("disk tier: failed to load block %x", block_hash)
                return None

    def snapshot(self) -> list[tuple[int, int | None]]:
        """(hash, parent) inventory — the anti-entropy resync's disk slice."""
        with self._lock:
            return list(self._index.items())


class OffloadEngine:
    """Background transfer worker between the KV tiers.

    ``submit`` is the only engine-thread entry point on the eviction path
    and does no device synchronization; the worker thread owns every
    blocking copy (device->host landing, disk IO).

    Cluster-pool tier events (ISSUE 11): when ``on_tier_stored`` /
    ``on_tier_removed`` are wired (callables taking ``(hashes, parent,
    tier)`` / ``(hashes, tier)``; must be thread-safe — they fire from
    the engine thread at submit and from the offload worker thread on
    demotion), every tier transition publishes: device→host demotion
    emits ``stored(host)`` then ``removed(device)`` AT SUBMIT (the
    in-flight block is servable — ``fetch`` waits out the landing — and
    the ordering keeps the worker's global-index entry gapless),
    host→disk demotion emits ``stored(disk)`` + ``removed(host)``, and a
    failed landing retracts the host advertisement. Without the hooks the
    legacy behavior is byte-identical: tiers move silently and only the
    final eviction emits the worker-level ``removed``.
    """

    def __init__(
        self,
        host: HostKvPool,
        disk: DiskKvPool | None = None,
        on_tier_stored: Callable[[list[int], int | None, str], None] | None = None,
        on_tier_removed: Callable[[list[int], str], None] | None = None,
    ):
        self.host = host
        self.disk = disk
        self._on_tier_stored = on_tier_stored
        self._on_tier_removed = on_tier_removed
        if disk is not None:
            # Host evictions demote to disk instead of emitting removal.
            host.on_evict_block = self._demote_to_disk
        self._cond = threading.Condition()
        self._pending: dict[int, int | None] = {}  # hash -> parent (in flight)
        self._q: queue.SimpleQueue = queue.SimpleQueue()
        self._thread = threading.Thread(target=self._run, name="kv-offload", daemon=True)
        self._thread.start()

    def _demote_to_disk(self, block_hash: int, parent: int | None, kv: np.ndarray) -> None:
        """Host LRU eviction with a disk tier behind it: the block moves
        down, and (tier-aware) the inventory follows it."""
        assert self.disk is not None
        self.disk.put(block_hash, parent, kv)
        if self._on_tier_stored is not None:
            self._on_tier_stored([block_hash], parent, "disk")
        if self._on_tier_removed is not None:
            self._on_tier_removed([block_hash], "host")

    # -- eviction side (engine thread, non-blocking) -----------------------

    def submit(self, block_hash: int, parent_hash: int | None, device_page: Any) -> None:
        with self._cond:
            self._pending[block_hash] = parent_hash
        # Advertise host-bound residency BEFORE the queue put (stored
        # before removed: the composed index never transits through
        # "worker holds nothing"): once the item is queued the worker
        # thread may fail the landing and emit its removed(host)
        # retraction, which must not be orderable ahead of this stored.
        if self._on_tier_stored is not None:
            self._on_tier_stored([block_hash], parent_hash, "host")
        if self._on_tier_removed is not None:
            self._on_tier_removed([block_hash], "device")
        self._q.put((block_hash, parent_hash, device_page))

    # -- worker ------------------------------------------------------------

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            block_hash, parent, page = item
            try:
                if isinstance(page, dict):
                    # Quantized page ({kv, scale} device slices): land
                    # both and pack into the canonical tier/wire buffer —
                    # the int8 bytes written at block-write time move
                    # verbatim, never re-quantized.
                    from dynamo_tpu_torch.engine.kv_quant import pack_kv_page

                    arr = pack_kv_page(
                        np.asarray(page["kv"]), np.asarray(page["scale"])
                    )
                else:
                    arr = np.asarray(page)  # lands the device slice
            except Exception:  # noqa: BLE001 — engine may have shut down
                log.exception("offload transfer failed for block %x", block_hash)
                arr = None
            landed = False
            with self._cond:
                try:
                    if arr is not None and block_hash in self._pending:
                        self.host.put(block_hash, parent, arr)
                        landed = True
                except Exception:  # noqa: BLE001 — e.g. disk tier ENOSPC
                    # The block is lost to the offload tiers, but the
                    # worker must survive: fetch() waiters depend on
                    # _pending draining.
                    log.exception("offload landing failed for block %x", block_hash)
                finally:
                    self._pending.pop(block_hash, None)
                    self._cond.notify_all()
            if not landed and self._on_tier_removed is not None:
                # Retract the host advertisement submit() made: the
                # landing failed, the block is gone from this worker.
                self._on_tier_removed([block_hash], "host")

    # -- onboarding side ---------------------------------------------------

    def contains(self, block_hash: int) -> bool:
        with self._cond:
            if block_hash in self._pending or block_hash in self.host:
                return True
        return self.disk is not None and block_hash in self.disk

    def reinsert(self, block_hash: int, parent_hash: int | None, kv: np.ndarray) -> None:
        """Return a fetched-but-unusable block to the host tier (e.g. the
        allocator ran out of device blocks mid-onboard). Takes the same
        lock the worker thread holds for host-pool mutation."""
        with self._cond:
            self.host.put(block_hash, parent_hash, kv)

    def fetch(self, block_hash: int) -> tuple[int | None, np.ndarray] | None:
        """Pop a block for onboarding, whichever tier holds it; waits out
        an in-flight transfer of the same hash."""
        got = self.fetch_tiered(block_hash)
        return None if got is None else got[:2]

    def fetch_tiered(
        self, block_hash: int
    ) -> tuple[int | None, np.ndarray, str] | None:
        """Like :meth:`fetch` but reports WHICH tier served the pop, so
        the onboarding path can emit the matching tier-removed event
        (device-stored is emitted by the allocator registration)."""
        with self._cond:
            while block_hash in self._pending:
                self._cond.wait(timeout=30)
            blk = self.host.pop(block_hash)
            if blk is not None:
                return blk.parent_hash, blk.kv, "host"
        if self.disk is not None:
            got = self.disk.pop(block_hash)
            if got is not None:
                return got[0], got[1], "disk"
        return None

    def peek(self, block_hash: int) -> np.ndarray | None:
        """Non-destructive read of a tiered block's page (peer-serving —
        the block stays where it is); waits out an in-flight transfer."""
        with self._cond:
            while block_hash in self._pending:
                self._cond.wait(timeout=30)
            blk = self.host.get(block_hash)
            if blk is not None:
                return blk.kv
        if self.disk is not None:
            return self.disk.peek(block_hash)
        return None

    def snapshot(self) -> list[tuple[str, int, int | None]]:
        """(tier, hash, parent) inventory across the offload tiers —
        in-flight submissions count as host (they were advertised as such
        and ``fetch`` can serve them)."""
        out: list[tuple[str, int, int | None]] = []
        with self._cond:
            out += [("host", h, p) for h, p in self._pending.items()]
            out += [("host", h, p) for h, p in self.host.snapshot()]
        if self.disk is not None:
            out += [("disk", h, p) for h, p in self.disk.snapshot()]
        return out

    def flush(self) -> None:
        """Wait until every submitted transfer has landed (tests/shutdown)."""
        with self._cond:
            while self._pending:
                self._cond.wait(timeout=30)

    def close(self) -> None:
        self._q.put(None)
