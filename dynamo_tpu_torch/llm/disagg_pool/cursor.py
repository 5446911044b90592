"""Per-request chunk cursor on the event plane.

The port's copy of ``dynamo_tpu/llm/disagg_pool/cursor.py``, held to it by
``tests/test_torch_copies.py``.

The prefill engine's ``on_chunk_commit`` hook fires (under the step
lock, on the engine thread) every time a hold_blocks sequence commits
prefill chunks. :class:`ChunkCursorPublisher` carries that signal to the
control-plane bus with the same discipline as the KV event publisher
(kv_router/publisher.py): the engine side enqueues without blocking and
WITHOUT awaiting the store, one drain task publishes in order. Cursors
are absolute (committed-block count, not deltas), so coalescing under
backpressure is lossless — only the LATEST cursor per request matters,
and a dropped intermediate is indistinguishable from a fast prefill.

:class:`ChunkCursorWatcher` is the decode side: one subscription per
worker, a bounded latest-cursor map, and an awaitable
``wait_advance(rid, beyond)`` the streaming handoff polls forward.
Missing or late events are never an error — the handoff degrades to the
reply-gated legacy pull on timeout, which is always correct.
"""

from __future__ import annotations

import asyncio
import logging
from collections import OrderedDict

import msgpack

from dynamo_tpu_torch.runtime import wire

log = logging.getLogger("dynamo_tpu.disagg_pool.cursor")

# Latest-cursor map bound: decode workers track in-flight handoffs only,
# but the subject carries every request in the namespace — evict the
# oldest entries so a request spray cannot grow the map without bound.
MAX_TRACKED_CURSORS = 4096


def disagg_cursor_subject(namespace: str) -> str:
    return f"disagg_cursor.{namespace}"


class ChunkCursorPublisher:
    """Bounded, coalescing, loop-affine cursor publisher for one prefill
    worker. ``note_nowait`` is the loop-affine entry; engine threads hop
    in via :meth:`engine_callback`'s ``call_soon_threadsafe`` wrapper."""

    def __init__(self, store, namespace: str, worker_id: int):
        self._store = store
        self._subject = disagg_cursor_subject(namespace)
        self.worker_id = worker_id
        # rid -> (committed, done): latest cursor wins (coalescing).
        self._pending: OrderedDict[str, tuple[int, bool]] = OrderedDict()
        self._wakeup = asyncio.Event()
        self._task: asyncio.Task | None = None
        self.published_total = 0
        self.publish_failures = 0

    def note_nowait(self, request_id: str, committed: int, done: bool) -> None:
        cur = self._pending.get(request_id)
        if cur is not None and cur[1] and not done:
            return  # never regress a final cursor with a stale commit
        self._pending[request_id] = (int(committed), bool(done))
        self._pending.move_to_end(request_id)
        while len(self._pending) > MAX_TRACKED_CURSORS:
            self._pending.popitem(last=False)
        self._wakeup.set()

    def engine_callback(self, loop: asyncio.AbstractEventLoop):
        """An ``EngineCore.on_chunk_commit``-shaped callable that hops
        from the engine thread to ``loop`` (non-blocking, never
        re-enters the core — the hook contract)."""
        def _cb(request_id: str, committed: int, done: bool) -> None:
            loop.call_soon_threadsafe(
                self.note_nowait, request_id, committed, done
            )
        return _cb

    async def start(self) -> None:
        if self._task is None:
            self._task = asyncio.create_task(self._drain())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    async def _drain(self) -> None:
        while True:
            # dynalint: unbounded-ok — in-process producer sets the event
            await self._wakeup.wait()
            self._wakeup.clear()
            while self._pending:
                rid, (committed, done) = self._pending.popitem(last=False)
                payload = msgpack.packb(
                    {
                        wire.CUR_REQUEST_ID: rid,
                        wire.CUR_WORKER: self.worker_id,
                        wire.CUR_COMMITTED: committed,
                        wire.CUR_DONE: done,
                    },
                    use_bin_type=True,
                )
                try:
                    await self._store.publish(self._subject, payload)
                    self.published_total += 1
                except asyncio.CancelledError:
                    raise
                except Exception:  # noqa: BLE001 — cursor loss degrades, never breaks
                    self.publish_failures += 1
                    log.debug(
                        "cursor publish failed for %s (handoff will use "
                        "the reply-gated pull)", rid, exc_info=True,
                    )


class ChunkCursorWatcher:
    """Decode-side cursor view: one bus subscription, latest cursor per
    request, awaitable advances. State is written only by the drain task
    and read on the same loop, so no locking beyond the condition."""

    def __init__(self, store, namespace: str):
        self._store = store
        self._subject = disagg_cursor_subject(namespace)
        # rid -> (prefill worker_id, committed, done)
        self._cursors: OrderedDict[str, tuple[int, int, bool]] = OrderedDict()
        self._advanced = asyncio.Condition()
        self._sub = None
        self._task: asyncio.Task | None = None
        self.events_total = 0

    async def start(self) -> None:
        if self._task is None:
            self._sub = await self._store.subscribe(self._subject)
            self._task = asyncio.create_task(self._drain())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        if self._sub is not None:
            try:
                await self._sub.unsubscribe()
            except Exception:  # noqa: BLE001
                log.debug("cursor unsubscribe failed (store closed?)",
                          exc_info=True)
            self._sub = None

    def cursor(self, request_id: str) -> tuple[int, int, bool] | None:
        """Latest ``(worker_id, committed, done)`` or None."""
        return self._cursors.get(request_id)

    def forget(self, request_id: str) -> None:
        self._cursors.pop(request_id, None)

    async def wait_advance(
        self, request_id: str, beyond: int, timeout: float
    ) -> tuple[int, int, bool]:
        """Block until the request's cursor shows more than ``beyond``
        committed blocks (or is final), up to ``timeout`` seconds.
        Raises TimeoutError — callers degrade to the legacy pull."""
        async with self._advanced:
            def _ready():
                cur = self._cursors.get(request_id)
                return cur is not None and (cur[1] > beyond or cur[2])
            await asyncio.wait_for(
                self._advanced.wait_for(_ready), timeout
            )
            return self._cursors[request_id]

    async def _drain(self) -> None:
        from dynamo_tpu_torch.runtime.store.client import StoreClient

        async for raw in self._sub:
            try:
                ev = msgpack.unpackb(
                    StoreClient.as_message(raw).payload, raw=False
                )
                rid = ev[wire.CUR_REQUEST_ID]
                cur = (
                    int(ev[wire.CUR_WORKER]),
                    int(ev[wire.CUR_COMMITTED]),
                    bool(ev[wire.CUR_DONE]),
                )
            except (ValueError, KeyError, TypeError):
                log.warning("malformed cursor event; dropping", exc_info=True)
                continue
            prev = self._cursors.get(rid)
            if prev is not None and prev[2] and not cur[2]:
                continue  # stale pre-final event after the final cursor
            self.events_total += 1
            self._cursors[rid] = cur
            self._cursors.move_to_end(rid)
            while len(self._cursors) > MAX_TRACKED_CURSORS:
                self._cursors.popitem(last=False)
            async with self._advanced:
                self._advanced.notify_all()
