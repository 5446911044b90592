"""Router-side bookkeeping of in-flight work per worker.

The port's copy of ``dynamo_tpu/llm/kv_router/sequence.py``, held to it by
``tests/test_torch_copies.py``.

The *load* term of the scheduling cost: for every request the router has
dispatched but not seen complete, track how many prefill tokens are still
owed and how many KV blocks the sequence occupies as it decodes. Freed on
stream completion or worker death.

Capability parity: reference `lib/llm/src/kv_router/sequence.rs:48-225`
(ActiveSequences / ActiveSequencesMultiWorker) + `prefill_counter.rs:70`.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass


@dataclass
class _ActiveSeq:
    worker_id: int
    prefill_tokens: int     # tokens that still need prefill on the worker
    decode_blocks: int      # blocks currently held by this sequence
    started: float


class ActiveSequences:
    def __init__(self, block_size: int = 32):
        self.block_size = block_size
        self._seqs: dict[str, _ActiveSeq] = {}
        self._worker_prefill_tokens: dict[int, int] = {}
        self._worker_decode_blocks: dict[int, int] = {}

    def add_request(
        self,
        request_id: str,
        worker_id: int,
        prompt_tokens: int,
        overlap_blocks: int,
    ) -> None:
        if request_id in self._seqs:
            # Duplicate adds happen legitimately (migration retries reuse
            # the request id; a replica-sync delta can arrive after the
            # bootstrap snapshot already installed the request) — counting
            # twice would skew this worker's load permanently.
            return
        new_prefill = max(0, prompt_tokens - overlap_blocks * self.block_size)
        blocks = math.ceil(prompt_tokens / self.block_size)
        self._seqs[request_id] = _ActiveSeq(
            worker_id=worker_id,
            prefill_tokens=new_prefill,
            decode_blocks=blocks,
            started=time.monotonic(),
        )
        self._worker_prefill_tokens[worker_id] = (
            self._worker_prefill_tokens.get(worker_id, 0) + new_prefill
        )
        self._worker_decode_blocks[worker_id] = (
            self._worker_decode_blocks.get(worker_id, 0) + blocks
        )

    def mark_prefill_done(self, request_id: str) -> None:
        seq = self._seqs.get(request_id)
        if seq is None or seq.prefill_tokens == 0:
            return
        self._worker_prefill_tokens[seq.worker_id] -= seq.prefill_tokens
        seq.prefill_tokens = 0

    def add_decode_block(self, request_id: str) -> None:
        seq = self._seqs.get(request_id)
        if seq is None:
            return
        seq.decode_blocks += 1
        self._worker_decode_blocks[seq.worker_id] += 1

    def free(self, request_id: str) -> None:
        seq = self._seqs.pop(request_id, None)
        if seq is None:
            return
        self._worker_prefill_tokens[seq.worker_id] = (
            self._worker_prefill_tokens.get(seq.worker_id, 0) - seq.prefill_tokens
        )
        self._worker_decode_blocks[seq.worker_id] = (
            self._worker_decode_blocks.get(seq.worker_id, 0) - seq.decode_blocks
        )

    def add_raw(
        self, request_id: str, worker_id: int, prefill_tokens: int, decode_blocks: int
    ) -> None:
        """Install a replica-sync snapshot entry verbatim (already-derived
        prefill/block counts, no recomputation)."""
        if request_id in self._seqs:
            return
        self._seqs[request_id] = _ActiveSeq(
            worker_id=worker_id,
            prefill_tokens=prefill_tokens,
            decode_blocks=decode_blocks,
            started=time.monotonic(),
        )
        self._worker_prefill_tokens[worker_id] = (
            self._worker_prefill_tokens.get(worker_id, 0) + prefill_tokens
        )
        self._worker_decode_blocks[worker_id] = (
            self._worker_decode_blocks.get(worker_id, 0) + decode_blocks
        )

    def items(self):
        """(request_id, entry) view for replica-sync snapshots."""
        return self._seqs.items()

    def remove_worker(self, worker_id: int) -> list[str]:
        """Drops all state for a dead worker; returns orphaned request ids
        (candidates for migration)."""
        orphans = [rid for rid, s in self._seqs.items() if s.worker_id == worker_id]
        for rid in orphans:
            del self._seqs[rid]
        self._worker_prefill_tokens.pop(worker_id, None)
        self._worker_decode_blocks.pop(worker_id, None)
        return orphans

    # -- load queries ------------------------------------------------------

    def potential_blocks_and_tokens(
        self, worker_id: int, prompt_tokens: int, overlap_blocks: int
    ) -> tuple[int, int]:
        """(decode blocks, prefill tokens) on `worker_id` *if* this request
        were routed there."""
        new_prefill = max(0, prompt_tokens - overlap_blocks * self.block_size)
        blocks = math.ceil(prompt_tokens / self.block_size)
        return (
            self._worker_decode_blocks.get(worker_id, 0) + blocks,
            self._worker_prefill_tokens.get(worker_id, 0) + new_prefill,
        )

    def decode_blocks(self, worker_id: int) -> int:
        return self._worker_decode_blocks.get(worker_id, 0)

    def prefill_tokens(self, worker_id: int) -> int:
        return self._worker_prefill_tokens.get(worker_id, 0)

    def active_requests(self, worker_id: int | None = None) -> int:
        if worker_id is None:
            return len(self._seqs)
        return sum(1 for s in self._seqs.values() if s.worker_id == worker_id)
