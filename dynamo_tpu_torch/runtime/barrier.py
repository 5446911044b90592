"""Leader/worker distributed barrier over the control-plane store.

The port's copy of ``dynamo_tpu/runtime/barrier.py``, held to it by
``tests/test_torch_copies.py``.

Capability parity: reference `lib/runtime/src/utils/leader_worker_barrier.rs:
137,230` (LeaderBarrier posts data and waits for N workers to check in;
WorkerBarrier reads the data and checks in) — the KVBM leader/worker and
multi-host engine startups synchronize through this.
"""

from __future__ import annotations

import asyncio
import json

_BARRIER_PREFIX = "/dynamo/barrier"


def _data_key(barrier_id: str) -> str:
    return f"{_BARRIER_PREFIX}/{barrier_id}/data"


def _worker_key(barrier_id: str, worker_id: str) -> str:
    return f"{_BARRIER_PREFIX}/{barrier_id}/workers/{worker_id}"


class LeaderBarrier:
    def __init__(self, store, barrier_id: str, num_workers: int):
        self.store = store
        self.barrier_id = barrier_id
        self.num_workers = num_workers

    async def sync(self, data: dict, timeout: float = 60.0) -> list[str]:
        """Post ``data``, wait for all workers; returns their ids."""
        await self.store.kv_put(_data_key(self.barrier_id), json.dumps(data).encode())
        prefix = f"{_BARRIER_PREFIX}/{self.barrier_id}/workers/"

        async def _wait() -> list[str]:
            while True:
                entries = await self.store.kv_get_prefix(prefix)
                if len(entries) >= self.num_workers:
                    return [k[len(prefix):] for k in entries]
                await asyncio.sleep(0.05)

        return await asyncio.wait_for(_wait(), timeout)


class WorkerBarrier:
    def __init__(self, store, barrier_id: str, worker_id: str):
        self.store = store
        self.barrier_id = barrier_id
        self.worker_id = worker_id

    async def sync(self, timeout: float = 60.0, lease: int = 0) -> dict:
        """Wait for the leader's data, then check in; returns the data.

        ``lease`` binds the check-in key to the caller's lease so a dead
        worker's check-in disappears instead of satisfying a later run's
        barrier."""

        async def _wait() -> dict:
            while True:
                raw = await self.store.kv_get(_data_key(self.barrier_id))
                if raw is not None:
                    return json.loads(raw)
                await asyncio.sleep(0.05)

        data = await asyncio.wait_for(_wait(), timeout)
        await self.store.kv_put(
            _worker_key(self.barrier_id, self.worker_id), b"1", lease=lease
        )
        return data
