"""TorchEngine: async facade over EngineCore for the worker runtime.

Counterpart of ``dynamo_tpu/engine/engine.py``'s ``TpuEngine``, with the
same surface: ``generate(wire_dict, context) -> async iterator of wire
dicts``. The engine loop runs each ``step()`` in a worker thread
(``asyncio.to_thread``) — device work blocks, and the event loop must stay
live to accept requests and stream tokens. Host-side scheduler state is
only touched inside ``step()``; intake goes through the core's inbox.
Each request files the JAX engine's three spans (``sched_admit``,
``prefill``, ``decode``) under the "engine" service, parented through the
data plane's headers.
"""

from __future__ import annotations

import asyncio
import logging
import time
import uuid
from typing import AsyncIterator

from dynamo_tpu_torch import tracing
from dynamo_tpu_torch.engine.core import EngineCore
from dynamo_tpu_torch.llm.protocols.common import PreprocessedRequest
from dynamo_tpu_torch.runtime.engine import Context, DeadlineExceededError

log = logging.getLogger("dynamo_tpu_torch.engine")

_FINISHED = object()


class TorchEngine:
    def __init__(self, core: EngineCore):
        self.core = core
        self._queues: dict[str, asyncio.Queue] = {}
        self._wakeup = asyncio.Event()
        self._loop_task: asyncio.Task | None = None
        self._tracer = tracing.get_tracer("engine")

    async def generate(self, request: dict, context: Context) -> AsyncIterator[dict]:
        if request.get("clear_kv_blocks"):
            cleared = await asyncio.to_thread(self.core.clear_kv_cache)
            yield {"cleared_blocks": cleared, "finish_reason": "stop"}
            return
        if request.get("embed"):
            raise ValueError("embedding requests are not ported yet (ROADMAP.md A11)")
        pre = PreprocessedRequest.from_wire(request)
        pre.request_id = pre.request_id or context.id
        if pre.request_id in self._queues:
            # Client-supplied ids are not guaranteed unique; engine state is
            # keyed by id, so uniquify locally rather than clobber a stream.
            pre.request_id = f"{pre.request_id}#{uuid.uuid4().hex[:6]}"
        t_submit = time.time()
        t_first = t_last = 0.0
        seq = self.core.add_request(pre)
        queue: asyncio.Queue = asyncio.Queue()
        self._queues[seq.request_id] = queue
        self._ensure_loop()
        self._wakeup.set()
        try:
            while True:
                item = await queue.get()
                if item is _FINISHED:
                    return
                if item.get("meta", {}).get("shed") == "deadline":
                    # Queue-expiry sweep: a clean, typed, retryable
                    # rejection, never a half-stream.
                    raise DeadlineExceededError(
                        item["meta"].get("detail", "deadline exceeded in queue")
                    )
                t_last = time.time()
                if not t_first:
                    t_first = t_last
                yield item
                if context.is_stopped:
                    self.core.cancel_request(seq)
                    return
        finally:
            self.core.cancel_request(seq)
            self._queues.pop(seq.request_id, None)
            if t_first:
                self._record_spans(seq, context, t_submit, t_first, t_last)

    def _record_spans(self, seq, context: Context, t_submit, t_first, t_last) -> None:
        """Per-request phase attribution: ``sched_admit`` is submit to
        first chunk dispatched (queue wait, nested in prefill), ``prefill``
        ends at the first emitted chunk, ``decode`` covers the rest."""
        tenant = seq.tenant_id or "default"
        if seq.t_first_sched:
            self._tracer.record(
                "sched_admit", t_submit, seq.t_first_sched, headers=context.headers,
                attrs={
                    "request_id": seq.request_id,
                    "prompt_tokens": seq.prompt_len,
                    "tenant": tenant,
                },
            )
        self._tracer.record(
            "prefill", t_submit, t_first, headers=context.headers,
            attrs={
                "request_id": seq.request_id,
                "prompt_tokens": seq.prompt_len,
                "cached_tokens": seq.num_cached_tokens,
                "tenant": tenant,
            },
        )
        self._tracer.record(
            "decode", t_first, t_last, headers=context.headers,
            attrs={"request_id": seq.request_id, "tokens": seq.generated, "tenant": tenant},
        )

    def metrics(self):
        return self.core.metrics()

    # -- engine loop -------------------------------------------------------

    def _ensure_loop(self) -> None:
        if self._loop_task is None or self._loop_task.done():
            self._loop_task = asyncio.create_task(self._run())

    async def _run(self) -> None:
        while True:
            if not self.core.has_work():
                self._wakeup.clear()
                await self._wakeup.wait()
            try:
                outputs = await asyncio.to_thread(self.core.step)
            except Exception:
                log.exception("engine step failed")
                for q in list(self._queues.values()):
                    q.put_nowait(_FINISHED)
                raise
            for seq, out in outputs:
                q = self._queues.get(seq.request_id)
                if q is None:
                    continue
                q.put_nowait(out.to_wire())
                if out.finish_reason is not None:
                    q.put_nowait(_FINISHED)
            # Yield to let request/stream tasks run between iterations.
            await asyncio.sleep(0)
