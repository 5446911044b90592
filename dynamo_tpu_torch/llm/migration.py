"""Request migration: mid-stream worker-failure recovery by token replay.

The port's copy of ``dynamo_tpu/llm/migration.py``, held to it by
``tests/test_torch_copies.py``.

If the worker serving a stream dies, the accumulated output tokens are
appended to the request's prompt and the request is re-issued to another
worker — the client sees one uninterrupted stream. Token replay is
engine-agnostic: with prefix caching the new worker re-prefills cheaply.
Bounded by the model card's ``migration_limit``.

Structured as pipeline-graph nodes (runtime/pipeline.py):
:class:`MigrationOperator` is the canonical full Operator — it must carry
state from the backward path (tokens already streamed) into the forward
path (the replayed request), exactly the property the reference built its
PipelineOperator trait for — and :class:`RouterEgress` is the terminal
backend that routes one attempt to a worker over the data plane.
:class:`Migration` assembles the two into a ServicePipeline (the same
composition `build_routed_pipeline` does on model-add, reference
`lib/llm/src/entrypoint/input/common.rs:216`).

Capability parity: reference `lib/llm/src/migration.rs:26,74-89`
(RetryManager) + `docs/architecture/request_migration.md`.
"""

from __future__ import annotations

import asyncio
import logging
import random
import time
from dataclasses import replace
from typing import AsyncIterator

from dynamo_tpu_torch import tracing
from dynamo_tpu_torch.llm.kv_router.router import KvPushRouter
from dynamo_tpu_torch.llm.protocols.common import LLMEngineOutput, PreprocessedRequest
from dynamo_tpu_torch.runtime.component import EndpointClient, NoInstancesError
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.pipeline import NextFn, PipelineBuilder, ServicePipeline
from dynamo_tpu_torch.runtime.store.client import reconnect_delay

log = logging.getLogger("dynamo_tpu.migration")


class RouterEgress:
    """Terminal pipeline backend: route ONE attempt of a preprocessed
    request to a worker instance and stream its wire chunks back. Routing
    hints ride the context: ``exclude_instances`` (workers the migration
    operator has seen die) and the caller's headers."""

    def __init__(
        self,
        client: EndpointClient,
        push_router: KvPushRouter | None,
        mode: str = "kv",
    ):
        self.client = client
        self.push_router = push_router
        self.mode = mode

    async def generate(
        self, pre: PreprocessedRequest, context: Context
    ) -> AsyncIterator[LLMEngineOutput]:
        payload = pre.to_wire()
        exclude = context.meta.get("exclude_instances", set())
        headers = context.headers or None
        if self.push_router is not None:
            stream = self.push_router.generate(
                payload,
                request_id=pre.request_id or "anon",
                token_ids=pre.token_ids,
                headers=headers,
                router_overrides=pre.router,
                exclude=exclude,
            )
            async for item in stream:
                yield LLMEngineOutput.from_wire(item)
        else:
            worker_id = self.client.pick_instance(self.mode, exclude)
            stream = None
            done = False
            try:
                try:
                    stream = await self.client.direct(worker_id, payload, headers)
                except (ConnectionError, NoInstancesError) as e:
                    # Dial-time failure: tag the instance for exclusion.
                    e.worker_id = worker_id  # type: ignore[attr-defined]
                    raise
                while True:
                    try:
                        item = await stream.__anext__()
                    except StopAsyncIteration:
                        done = True
                        break
                    except (ConnectionError, NoInstancesError) as e:
                        done = True  # the worker side is already gone
                        e.worker_id = worker_id  # type: ignore[attr-defined]
                        raise
                    except Exception:
                        done = True  # stream-delivered error: server closed it
                        raise
                    # Consumer abandonment (client disconnect) surfaces
                    # as CancelledError/GeneratorExit — at the await
                    # above or thrown in at this yield — and leaves
                    # `done` False, so the finally forwards the kill.
                    yield LLMEngineOutput.from_wire(item)
            finally:
                if stream is not None and not done:
                    # Consumer vanished mid-stream: forward the kill so
                    # the worker drops the request (queued or running)
                    # instead of serving a ghost. Fire-and-forget — this
                    # finally may be unwinding a cancellation.
                    from dynamo_tpu_torch.runtime.tasks import spawn_logged

                    spawn_logged(
                        stream.kill_quietly(),
                        name=f"egress-kill-{pre.request_id}",
                        logger=log,
                    )


class MigrationOperator:
    """Retry-with-token-replay around the downstream egress. Forward path:
    rewrites the request with already-generated tokens appended and the
    stop budget shrunk; backward path: accumulates streamed tokens (the
    state the next forward rewrite needs) and closes the stream exactly
    once a finish reason passes."""

    def __init__(self, limit: int = 3, rng: random.Random | None = None):
        self.limit = limit
        self._tracer = tracing.get_tracer("migration")
        # Retry pacing: full-jitter exponential backoff on the store
        # client's reconnect schedule (same ceilings, same rationale — a
        # worker crash fails every stream it carried at the same instant,
        # and a fixed wait would re-dial the survivors in one synchronized
        # wave). `rng`/`_sleep` are injectable for deterministic tests.
        self._rng = rng or random.Random()
        self._sleep = asyncio.sleep

    async def generate(
        self, pre: PreprocessedRequest, context: Context, next: NextFn
    ) -> AsyncIterator[LLMEngineOutput]:
        attempts = 0
        generated: list[int] = []
        failed_workers: set[int] = set()
        current = pre

        def trace_attempt(start_s: float, outcome: str) -> None:
            # Per-attempt spans only once a migration actually happened:
            # the unmigrated fast path records nothing (span names stay a
            # small fixed set; the attempt index is an attribute).
            if attempts == 0 and outcome != "failed":
                return
            self._tracer.record(
                "migration_attempt", start_s, time.time(),
                headers=context.headers,
                attrs={
                    "request_id": pre.request_id,
                    "attempt": attempts,
                    "replayed_tokens": len(current.token_ids) - len(pre.token_ids),
                    "outcome": outcome,
                },
            )

        while True:
            attempt_ctx = context.child()
            attempt_ctx.meta["exclude_instances"] = failed_workers
            t_attempt = time.time()
            try:
                async for out in next(current, attempt_ctx):
                    generated.extend(out.token_ids)
                    if attempts and out.finish_reason is not None:
                        # Usage fix-up after a replay: the final attempt's
                        # engine counts the replayed tokens as PROMPT and
                        # only its own output as completion. The client
                        # billed the original prompt and streamed
                        # len(generated) tokens total — report exactly
                        # that, charging each replayed token once.
                        out = replace(
                            out,
                            prompt_tokens=len(pre.token_ids),
                            completion_tokens=len(generated),
                        )
                    yield out
                    if out.finish_reason is not None:
                        trace_attempt(t_attempt, "completed")
                        return
                trace_attempt(t_attempt, "completed")
                return
            except (ConnectionError, NoInstancesError) as e:
                trace_attempt(t_attempt, "failed")
                attempts += 1
                failed = getattr(e, "worker_id", None)
                if failed is not None:
                    failed_workers.add(failed)
                if attempts > self.limit:
                    log.warning(
                        "request %s exhausted %d migrations", pre.request_id, self.limit
                    )
                    raise
                # Replay: generated tokens become prompt suffix; budget
                # and minimum shrink by what the client already has.
                new_stop = pre.stop.after_replay(len(generated))
                if new_stop.max_tokens is not None and new_stop.max_tokens <= 0:
                    # Budget exhausted exactly at failure: close the
                    # stream with an explicit length finish.
                    yield LLMEngineOutput(
                        token_ids=[],
                        finish_reason="length",
                        prompt_tokens=len(pre.token_ids),
                        completion_tokens=len(generated),
                    )
                    return
                current = replace(
                    current,
                    token_ids=list(pre.token_ids) + generated,
                    stop=new_stop,
                    replayed_tokens=len(generated),
                )
                log.info(
                    "migrating request %s (attempt %d/%d, %d tokens replayed): %s",
                    pre.request_id, attempts, self.limit, len(generated), e,
                )
                await self._sleep(reconnect_delay(attempts - 1, self._rng))


class Migration:
    """The assembled routed pipeline segment: MigrationOperator →
    RouterEgress. Kept as a class so callers (ModelManager, disagg
    router) hold one object with the historical ``generate(pre,
    headers)`` surface; internally it IS a ServicePipeline and further
    operators can be linked in front via ``build_pipeline``."""

    def __init__(
        self,
        client: EndpointClient,
        push_router: KvPushRouter | None,
        mode: str = "kv",
        limit: int = 3,
    ):
        self.client = client
        self.push_router = push_router
        self.mode = mode
        self.limit = limit
        self.pipeline: ServicePipeline = self.build_pipeline()

    def build_pipeline(self, *front_operators) -> ServicePipeline:
        """Assemble ``front_operators → MigrationOperator → RouterEgress``."""
        builder = PipelineBuilder()
        for op in front_operators:
            builder.link(op)
        return builder.link(MigrationOperator(self.limit)).backend(
            RouterEgress(self.client, self.push_router, self.mode)
        )

    async def generate(
        self, pre: PreprocessedRequest, headers: dict[str, str] | None = None
    ) -> AsyncIterator[LLMEngineOutput]:
        ctx = Context(request_id=pre.request_id, headers=headers)
        async for out in self.pipeline.generate(pre, ctx):
            yield out
