"""Mocker backend worker: the mock engine wired into the full runtime.

The port's copy of ``dynamo_tpu/backends/mocker/main.py``, held to it by
``tests/test_torch_copies.py``.

``python -m dynamo_tpu_torch.backends.mocker --model-name mock`` starts a
process that looks like a real worker to every other component: it
registers the model, serves the ``generate`` endpoint, and emits KV
events and load metrics. Router, disaggregation and planner tests run
against fleets of these, with no card and no model.
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import logging
import time
import uuid
from typing import Any, AsyncIterator

import msgpack

from dynamo_tpu_torch.llm.discovery import register_llm
from dynamo_tpu_torch.llm.kv_router.publisher import KvEventPublisher, WorkerMetricsPublisher
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard, ModelRuntimeConfig
from dynamo_tpu_torch.llm.mocker import MockEngineArgs, MockTpuEngine
from dynamo_tpu_torch.llm.protocols.common import (
    LLMEngineOutput,
    PreprocessedRequest,
    StopConditions,
)
from dynamo_tpu_torch import knobs
from dynamo_tpu_torch.runtime import Context, DistributedRuntime, chaos, wire
from dynamo_tpu_torch.runtime.worker import dynamo_worker
from dynamo_tpu_torch.tokens import compute_seq_hashes

log = logging.getLogger("dynamo_tpu.backends.mocker")


def _prefill_queue(namespace: str) -> str:
    """Same work-queue name as the jax worker: mock prefill/decode pools
    interoperate with real ones on the wire."""
    return f"prefill:{namespace}"


async def _pull_peer_prefix_mock(
    engine: MockTpuEngine, fetch_client, hint: dict, token_ids: list[int]
) -> int:
    """Mocker twin of PeerKvClient.pull_prefix: ask the hinted peer which
    prefix blocks it holds over the REAL dataplane (breakers, stall
    deadlines, and chaos all apply), register them as locally cached, and
    price the transfer on the clock. Every failure degrades to local
    recompute — the stream is bit-identical either way."""
    from dynamo_tpu_torch.runtime.dataplane import BreakerOpenError

    st = engine.peer_stats
    bs = engine.args.block_size
    hashes = compute_seq_hashes(token_ids, bs)
    have = engine.kv.held_prefix(hashes)
    want = hashes[len(have):]
    if not want:
        return 0
    st.pulls_attempted += 1
    t0 = time.monotonic()
    frame_timeout = knobs.get_float("DYN_KV_POOL_FRAME_TIMEOUT_S")
    imported = 0
    cost_s = 0.0
    ok = False
    try:
        if chaos.active():
            await chaos.inject("kv_transfer.pull", str(hint.get("worker_id")))
        stream = await fetch_client.direct(
            hint["worker_id"], {wire.KV_HASHES: want}
        )
        held: list[int] = []
        while True:
            try:
                frame = await asyncio.wait_for(stream.__anext__(), frame_timeout)
            except StopAsyncIteration:
                break
            dtype = frame.get(wire.KV_DTYPE)
            if dtype is not None and (
                (dtype == "int8") != (engine.args.kv_dtype == "int8")
            ):
                # The fail-fast contract, mirrored: mixed int8/float
                # fleets never re-quantize — recompute locally.
                st.dtype_mismatches += 1
                raise ValueError(
                    f"KV dtype mismatch: peer pages are {dtype!r}, local "
                    f"cache is {engine.args.kv_dtype!r}"
                )
            held.extend(frame.get(wire.KV_HELD) or [])
        offset = len(have)
        parents = [
            hashes[offset + i - 1] if offset + i > 0 else None
            for i in range(len(held))
        ]
        imported, cost_s = engine.import_peer_blocks(held, parents)
        ok = True
    except BreakerOpenError:
        st.breaker_fast_fails += 1
        log.info(
            "mock peer pull from worker %s skipped: circuit breaker open",
            hint.get("worker_id"),
        )
    except Exception:  # noqa: BLE001 — recompute is always correct
        log.warning(
            "mock peer pull from worker %s failed; recomputing locally",
            hint.get("worker_id"), exc_info=True,
        )
    if cost_s > 0:
        await asyncio.sleep(cost_s)  # the priced dataplane copy
    elapsed_ms = (time.monotonic() - t0) * 1e3
    st.pull_ms_total += elapsed_ms
    st.last_pull_ms = elapsed_ms
    peer = hint.get("worker_id")
    if peer is not None:
        st.note_pull(int(peer), imported, elapsed_ms, ok)
    if ok:
        st.pulls_succeeded += 1
    else:
        st.pulls_fallback += 1
    return imported


class _MockWindowPuller:
    """PeerKvClient.pull_held_window twin for the mocker's streaming
    handoff: windows are hash slices pulled over the EXISTING kv_fetch
    plane (the mock cache retains committed blocks, so there is no hold
    to window — the decode side computes the request's block hashes
    itself and asks for ``hashes[start:start+count]``). Each window is
    priced on the clock by DYN_DISAGG_CHUNK_US_PER_BLOCK, and any hole —
    short window, dtype mismatch, severed stream — RAISES so the handoff
    aborts to the reply-gated pull instead of continuing with gaps."""

    def __init__(self, engine: MockTpuEngine, fetch_client):
        self.engine = engine
        self.fetch_client = fetch_client
        # StreamingHandoff's bounded tail-wait reads this, like
        # PeerKvClient's.
        self.total_timeout_s = knobs.get_float("DYN_KV_POOL_PULL_TIMEOUT_S")
        self._hashes: dict[str, list[int]] = {}

    def register(self, request_id: str, token_ids: list[int]) -> None:
        self._hashes[request_id] = compute_seq_hashes(
            token_ids, self.engine.args.block_size
        )

    def forget(self, request_id: str) -> None:
        self._hashes.pop(request_id, None)

    async def pull_held_window(
        self, _transfer_client, worker_id, request_id: str,
        start: int, count: int, final: bool = False,
    ) -> int:
        hashes = self._hashes[request_id]
        window = hashes[start:start + count]
        if len(window) < count:
            raise ConnectionError(
                f"cursor for {request_id} advertises block "
                f"{start + count} past the {len(hashes)}-block prompt"
            )
        if not window:
            return 0  # empty FINAL window: nothing to release in the mock
        if chaos.active():
            await chaos.inject("kv_transfer.pull", str(worker_id))
        frame_timeout = knobs.get_float("DYN_KV_POOL_FRAME_TIMEOUT_S")
        stream = await self.fetch_client.direct(
            worker_id, {wire.KV_HASHES: window}
        )
        held: list[int] = []
        while True:
            try:
                frame = await asyncio.wait_for(stream.__anext__(), frame_timeout)
            except StopAsyncIteration:
                break
            dtype = frame.get(wire.KV_DTYPE)
            if dtype is not None and (
                (dtype == "int8") != (self.engine.args.kv_dtype == "int8")
            ):
                self.engine.peer_stats.dtype_mismatches += 1
                raise ValueError(
                    f"KV dtype mismatch: peer pages are {dtype!r}, local "
                    f"cache is {self.engine.args.kv_dtype!r}"
                )
            held.extend(frame.get(wire.KV_HELD) or [])
        if len(held) < count:
            raise ConnectionError(
                f"handoff window short for {request_id}: peer holds "
                f"{len(held)}/{count} blocks at offset {start}"
            )
        parents = [
            hashes[start + i - 1] if start + i > 0 else None
            for i in range(count)
        ]
        imported, cost_s = self.engine.import_peer_blocks(held[:count], parents)
        # Chunk-priced handoff on the clock: the streamed copy costs
        # per-block microseconds x the kv dtype byte ratio, on top of
        # whatever the kv-pull knob already priced.
        cost_s += (
            count
            * knobs.get_float("DYN_DISAGG_CHUNK_US_PER_BLOCK")
            * self.engine._kv_byte_ratio
            / 1e6
            / self.engine.args.speedup_ratio
        )
        if cost_s > 0:
            await asyncio.sleep(cost_s)
        return imported


async def _remote_prefill_then_decode_mock(
    engine: MockTpuEngine, pre: PreprocessedRequest, context: Context,
    store, qname: str, fetch_client, puller: _MockWindowPuller,
    handoff, emitted: list[int] | None = None, tracer=None,
    reply_timeout: float = 120.0,
) -> AsyncIterator[Any]:
    """The jax worker's _remote_prefill_then_decode, mocker-flavored:
    queued remote prefill, chunk-streamed (or reply-gated) block pull
    over kv_fetch, local continuation by token replay. Byte-identical to
    the aggregated run by the replay_base contract."""
    from dynamo_tpu_torch.runtime.store.client import StoreClient

    prefill_req = dataclasses.replace(
        pre,
        stop=StopConditions(max_tokens=1, ignore_eos=True),
        kv_transfer_params={"do_remote_decode": True},
    )
    reply_key = f"/dynamo/prefill-reply/{pre.request_id}-{uuid.uuid4().hex[:8]}"
    sub = await store.kv_watch(reply_key, with_initial=False)
    stream_task: asyncio.Task | None = None
    if handoff is not None:
        puller.register(pre.request_id, list(pre.token_ids))
        stream_task = asyncio.create_task(handoff.run(pre.request_id))
    first: dict | None = None
    t_handoff = time.time()
    try:
        await store.queue_push(
            qname,
            msgpack.packb(
                {
                    "request": prefill_req.to_wire(),
                    "reply_key": reply_key,
                    "traceparent": (context.headers or {}).get("traceparent"),
                },
                use_bin_type=True,
            ),
        )
        ev = await sub.get(timeout=reply_timeout)
        event = StoreClient.as_watch_event(ev)
        if event.value is not None:
            first = msgpack.unpackb(event.value, raw=False)
    finally:
        if first is None and stream_task is not None:
            stream_task.cancel()
        await sub.unsubscribe()
        await store.kv_del(reply_key)
        if tracer is not None:
            tracer.record(
                "prefill_handoff", t_handoff, time.time(),
                headers=context.headers,
                attrs={
                    "request_id": pre.request_id,
                    "prefill_tokens": len(pre.token_ids),
                    "ok": first is not None and "error" not in (first or {}),
                },
            )
    if first is None or "error" in first:
        if stream_task is not None:
            stream_task.cancel()
            puller.forget(pre.request_id)
        if first is None:
            raise ConnectionError("prefill worker returned no output")
        raise ConnectionError(f"remote prefill failed: {first['error']}")
    out1 = LLMEngineOutput.from_wire(first)
    xfer = out1.kv_transfer_params or {}
    prefill_worker = xfer.get("worker_id")
    rid = xfer.get("request_id")

    streamed = False
    if stream_task is not None:
        try:
            if stream_task.done():
                streamed = bool(stream_task.result())
            elif rid is None or handoff.watcher.cursor(rid) is None:
                stream_task.cancel()
            else:
                try:
                    streamed = bool(await asyncio.wait_for(
                        stream_task, puller.total_timeout_s
                    ))
                except asyncio.TimeoutError:
                    streamed = False
        finally:
            puller.forget(pre.request_id)

    if prefill_worker is not None and streamed and tracer is not None:
        tracer.record(
            "kv_stream", t_handoff, time.time(), headers=context.headers,
            attrs={
                "request_id": pre.request_id,
                "prefill_worker": prefill_worker,
                "chunks": handoff.stats.chunks_pulled,
                "streamed": True,
            },
        )
    if prefill_worker is not None and not streamed:
        # Reply-gated legacy pull: the peer-prefix pull re-imports
        # idempotently, so blocks a cancelled stream already landed are
        # skipped by hash.
        await _pull_peer_prefix_mock(
            engine, fetch_client, {"worker_id": prefill_worker},
            list(pre.token_ids),
        )

    token1 = out1.token_ids[0]
    first_chunk = LLMEngineOutput(
        token_ids=[token1], meta=dict(out1.meta, remote_prefill=True)
    )
    # The mock tokenizer has no EOS; only explicit stop tokens and the
    # caller's max_tokens gate token1 (mirrors _first_token_finish).
    finish = pre.stop.check_token(token1, 1, frozenset())
    if finish == "length":
        finish = None
    if finish is None and pre.stop.max_tokens is not None and pre.stop.max_tokens <= 1:
        finish = out1.finish_reason or "length"
    if finish is not None:
        first_chunk.finish_reason = finish
        first_chunk.prompt_tokens = len(pre.token_ids)
        first_chunk.completion_tokens = 1
        if emitted is not None:
            emitted.append(token1)
        yield first_chunk.to_wire()
        return
    if emitted is not None:
        emitted.append(token1)
    yield first_chunk.to_wire()

    cont = dataclasses.replace(
        pre,
        token_ids=list(pre.token_ids) + [token1],
        stop=pre.stop.after_replay(1),
        kv_transfer_params=None,
        # Unlike the jax worker (a real model conditions on the grown
        # prompt), the mock token function needs the replay count to
        # continue its cycle where the remote prefill stopped.
        replayed_tokens=pre.replayed_tokens + 1,
    )
    async for out in engine.generate(cont.to_wire(), context):
        if emitted is not None:
            emitted.extend(LLMEngineOutput.from_wire(out).token_ids)
        yield out


async def run_mocker(
    runtime: DistributedRuntime,
    model_name: str = "mock-model",
    namespace: str = "dynamo",
    component: str = "backend",
    engine_args: MockEngineArgs | None = None,
    context_length: int = 16384,
    served_event: asyncio.Event | None = None,
    engine_out: list | None = None,
    obs_publish: bool = True,
    obs_interval_s: float = 1.0,
    role: str = "aggregated",
    disagg_config=None,
) -> None:
    args = engine_args or MockEngineArgs()
    engine = MockTpuEngine(args)
    if engine_out is not None:
        engine_out.append(engine)
    worker_id = runtime.primary_lease_id
    # Chaos targeting: `engine.step` rules match this worker by id (and
    # by model name, so a plan can wedge "one worker of model X").
    engine.chaos_tag = f"worker-{worker_id}/{model_name}"
    # Flight-recorder artifacts carry the worker identity.
    engine.flight.name = f"worker-{worker_id}"

    kv_pub = KvEventPublisher(runtime.store, namespace, component, worker_id)
    # Anti-entropy + drain retraction, mirroring the jax worker: the
    # publisher can re-publish the full inventory after a gap, and a
    # graceful drain retracts it so routers drop this worker's hints now.
    kv_pub.inventory_source = lambda: [
        ("device", h, parent) for h, parent in engine.kv.snapshot()
    ]
    # The mock kv manager is loop-affine: snapshot inline, never from a
    # thread (the sim loop mutates the same dicts).
    kv_pub.inventory_blocking = False
    await kv_pub.start()

    async def _retract_kv_inventory() -> None:
        kv_pub.cleared_nowait()
        await kv_pub.flush(timeout=5.0)

    runtime.on_drain.append(_retract_kv_inventory)

    # The mock kv manager mutates only on the event loop: enqueue direct.
    engine.kv.on_stored = kv_pub.stored_nowait
    engine.kv.on_removed = kv_pub.removed_nowait

    metrics_pub = WorkerMetricsPublisher(
        runtime.store, namespace, component, worker_id, engine.metrics, interval_s=0.5
    )
    await metrics_pub.start()

    # Fleet observability: periodic metric snapshots over the
    # event plane — the same stats dicts the /metrics gauges bind, plus
    # cumulative phase totals and finished-request SLO records. Entirely
    # off the priced sim step; a graceful drain publishes the `retired`
    # retraction so the aggregator drops this worker's series NOW.
    if obs_publish:
        from dynamo_tpu_torch import tracing
        from dynamo_tpu_torch.obs.slo import PhaseScanner
        from dynamo_tpu_torch.obs.snapshot import SnapshotPublisher

        snap_pub = SnapshotPublisher(
            runtime.store, namespace, worker_id,
            role="worker", component=component, interval_s=obs_interval_s,
        )
        snap_pub.collectors = {
            "scheduler": engine.scheduler_stats,
            "spec": engine.spec_decode_stats,
            "kv_cache": engine.kv_cache_stats,
            "kv_pool": lambda: {**kv_pub.stats(), **engine.kv_pool_stats()},
        }
        snap_pub.tenant_source = engine.fair_queue_stats
        _collector = tracing.get_collector()
        snap_pub.phase_source = _collector.phase_totals
        snap_pub.request_source = PhaseScanner(_collector).scan
        await snap_pub.start()

        async def _retire_snapshot() -> None:
            await snap_pub.retire(timeout=5.0)

        runtime.on_drain.append(_retire_snapshot)

    # Same scheduler + speculation gauges as the real worker (mock fleets
    # exercise the policies CPU-only; dashboards see identical series).
    from dynamo_tpu_torch.runtime.status_server import (
        bind_fair_queue_gauges,
        bind_kv_cache_gauges,
        bind_kv_pool_gauges,
        bind_scheduler_gauges,
        bind_spec_gauges,
        bind_store_gauges,
    )

    # Control-plane connectivity: store_connected /
    # store_outage_seconds / keepalive-failure counters on /metrics, and
    # /health's control_plane section (degraded, never unhealthy, while
    # the store is dark — the data plane keeps serving).
    bind_store_gauges(runtime.status, runtime.store)
    bind_scheduler_gauges(runtime.status, engine.scheduler_stats)
    bind_spec_gauges(runtime.status, engine.spec_decode_stats)
    bind_kv_cache_gauges(runtime.status, engine.kv_cache_stats)
    bind_fair_queue_gauges(runtime.status, engine.fair_queue_stats)
    bind_kv_pool_gauges(
        runtime.status,
        lambda: {**kv_pub.stats(), **engine.kv_pool_stats()},
    )

    # Peer block server (mock twin of the jax _serve_kv_fetch): answers
    # which prefix of the requested hash chain this worker holds, behind
    # a geometry-ish frame carrying the kv dtype for the fail-fast check.
    async def kv_fetch_handler(request: Any, context: Context) -> AsyncIterator[Any]:
        hashes = list(request.get(wire.KV_HASHES) or [])
        # The dead "mock" marker key is gone (nothing ever consumed it —
        # the wire-contract rule's produced-but-never-consumed finding).
        yield {wire.KV_VERSION: 2, wire.KV_DTYPE: args.kv_dtype}
        yield {wire.KV_VERSION: 2, wire.KV_HELD: engine.kv.held_prefix(hashes)}

    fetch_ep = runtime.namespace(namespace).component(component).endpoint("kv_fetch")
    await fetch_ep.serve(kv_fetch_handler)
    fetch_client = await (
        runtime.namespace(namespace).component(component).endpoint("kv_fetch").client()
    )

    endpoint = runtime.namespace(namespace).component(component).endpoint("generate")

    async def handler(request: Any, context: Context) -> AsyncIterator[Any]:
        hint = (request.get("kv_transfer_params") or {}).get("peer_prefix")
        if (
            hint
            and hint.get("worker_id") != worker_id
            and request.get("token_ids")
        ):
            await _pull_peer_prefix_mock(
                engine, fetch_client, hint, list(request["token_ids"])
            )
        async for out in engine.generate(request, context):
            yield out

    if role == "prefill":
        # Disagg prefill pool member, mirroring the jax
        # worker's prefill role: consume the namespace work queue, run
        # max_tokens=1 prefills, advertise chunk commits on the cursor
        # plane as they land, reply over a short-TTL lease. Not
        # registered with the frontend — decode workers own client
        # traffic.
        from dynamo_tpu_torch.llm.disagg_pool import ChunkCursorPublisher

        cursor_pub = ChunkCursorPublisher(runtime.store, namespace, worker_id)
        await cursor_pub.start()
        # The sim loop runs ON the event loop: the hook may enqueue
        # directly, no call_soon_threadsafe hop (unlike EngineCore's).
        engine.on_chunk_commit = cursor_pub.note_nowait
        engine.cursor_publisher = cursor_pub  # test/benchmark access
        qname = _prefill_queue(namespace)
        sem = asyncio.Semaphore(args.max_num_seqs)
        _inflight: set[asyncio.Task] = set()

        async def _serve_queued(task: dict) -> None:
            try:
                req = task["request"]
                tp = task.get("traceparent")
                ctx = Context(
                    req.get("request_id") or f"qprefill-{uuid.uuid4().hex[:8]}",
                    headers={"traceparent": tp} if tp else None,
                )
                last: dict | None = None
                async for out in engine.generate(req, ctx):
                    last = out
                if last is None:
                    last = {"error": "prefill produced no output"}
                if last.get("kv_transfer_params"):
                    last["kv_transfer_params"]["worker_id"] = worker_id
                lease = await runtime.store.lease_grant(ttl=60.0, keepalive=False)
                await runtime.store.kv_put(
                    task["reply_key"],
                    msgpack.packb(last, use_bin_type=True),
                    lease=lease,
                )
            except Exception:
                log.exception("queued mock prefill failed")
                try:
                    lease = await runtime.store.lease_grant(
                        ttl=60.0, keepalive=False
                    )
                    await runtime.store.kv_put(
                        task["reply_key"],
                        msgpack.packb(
                            {"error": "remote prefill failed"},
                            use_bin_type=True,
                        ),
                        lease=lease,
                    )
                except Exception:  # noqa: BLE001 — store down; caller times out
                    log.warning(
                        "could not publish prefill-failure reply for %r",
                        task.get("reply_key"), exc_info=True,
                    )
            finally:
                sem.release()

        async def _consume_queue() -> None:
            while True:
                await sem.acquire()
                try:
                    payload = await runtime.store.queue_pop(qname, timeout=1.0)
                except asyncio.CancelledError:
                    raise
                except Exception:  # noqa: BLE001 — store closed on shutdown
                    log.debug("prefill queue pop failed; consumer exiting",
                              exc_info=True)
                    sem.release()
                    return
                if payload is None:
                    sem.release()
                    continue
                try:
                    task = msgpack.unpackb(payload, raw=False)
                except (ValueError, msgpack.UnpackException):
                    log.warning("dropping malformed prefill task")
                    sem.release()
                    continue
                t = asyncio.create_task(_serve_queued(task))
                _inflight.add(t)
                t.add_done_callback(_inflight.discard)

        await endpoint.serve(handler)
        consumer = asyncio.create_task(_consume_queue())
        log.info("mock prefill worker %d ready (model %r)", worker_id, model_name)
        if served_event is not None:
            served_event.set()
        try:
            await runtime.wait_for_shutdown()
        finally:
            consumer.cancel()
            await cursor_pub.stop()
        return

    if role == "decode":
        # Disagg decode pool member: routes long prefills to the prefill
        # pool and streams committed KV windows back while they run.
        from dynamo_tpu_torch.llm.disagg import DisaggRouter
        from dynamo_tpu_torch.llm.disagg_pool import ChunkCursorWatcher, StreamingHandoff
        from dynamo_tpu_torch.runtime.status_server import bind_disagg_gauges
        from dynamo_tpu_torch.runtime.tasks import spawn_logged

        disagg = DisaggRouter(disagg_config)
        spawn_logged(
            disagg.watch_store(runtime.store, namespace),
            name="disagg-watch-store", logger=log,
        )
        prefill_generate = await (
            runtime.namespace(namespace).component("prefill")
            .endpoint("generate").client()
        )
        prefill_fetch = await (
            runtime.namespace(namespace).component("prefill")
            .endpoint("kv_fetch").client()
        )
        puller = _MockWindowPuller(engine, prefill_fetch)
        handoff = None
        if knobs.get_bool("DYN_DISAGG_STREAMING"):
            cursor_watch = ChunkCursorWatcher(runtime.store, namespace)
            await cursor_watch.start()
            handoff = StreamingHandoff(puller, cursor_watch, None)
            bind_disagg_gauges(runtime.status, handoff.stats.as_dict)
        # Test/benchmark access (engine_out pattern): the handoff stats
        # are otherwise only visible through /metrics.
        engine.disagg_handoff = handoff
        engine.disagg_router = disagg
        qname = _prefill_queue(namespace)

        async def decode_handler(
            request: Any, context: Context
        ) -> AsyncIterator[Any]:
            if request.get("embed") or request.get("clear_kv_blocks"):
                async for out in engine.generate(request, context):
                    yield out
                return
            hint = (request.get("kv_transfer_params") or {}).get("peer_prefix")
            if (
                hint
                and hint.get("worker_id") != worker_id
                and request.get("token_ids")
            ):
                await _pull_peer_prefix_mock(
                    engine, fetch_client, hint, list(request["token_ids"])
                )
            pre = PreprocessedRequest.from_wire(request)
            pre.request_id = pre.request_id or context.id
            bs = engine.args.block_size
            cached = bs * len(
                engine.kv.held_prefix(compute_seq_hashes(pre.token_ids, bs))
            )
            uncached = len(pre.token_ids) - cached
            fallback_replayed = 0
            depth = 0
            if prefill_generate.instance_ids():
                try:
                    depth = await runtime.store.queue_len(qname)
                except Exception:  # noqa: BLE001 — store hiccup: stay local
                    log.debug("queue_len failed; treating prefill queue as "
                              "full (local prefill)", exc_info=True)
                    depth = disagg.config.max_prefill_queue_size + 1
            if (
                prefill_generate.instance_ids()
                and disagg.decide(
                    uncached, depth,
                    headers=context.headers, request_id=pre.request_id,
                )
            ):
                emitted: list[int] = []
                try:
                    async for out in _remote_prefill_then_decode_mock(
                        engine, pre, context, runtime.store, qname,
                        prefill_fetch, puller, handoff, emitted,
                        tracer=disagg.tracer,
                    ):
                        yield out
                    return
                except Exception:
                    log.exception(
                        "remote mock prefill failed for %s; falling back "
                        "to local", pre.request_id,
                    )
                if emitted:
                    stop = pre.stop.after_replay(len(emitted))
                    if stop.max_tokens is not None:
                        stop.max_tokens = max(1, stop.max_tokens)
                    fallback_replayed = len(emitted)
                    pre = dataclasses.replace(
                        pre,
                        token_ids=list(pre.token_ids) + emitted,
                        stop=stop,
                        kv_transfer_params=None,
                        replayed_tokens=pre.replayed_tokens + len(emitted),
                    )
            async for out in engine.generate(pre.to_wire(), context):
                if fallback_replayed and out.get("finish_reason") is not None:
                    # Charge replayed tokens once (same usage fix-up as
                    # the jax decode handler's in-worker fallback).
                    if out.get("prompt_tokens") is not None:
                        out["prompt_tokens"] -= fallback_replayed
                    if out.get("completion_tokens") is not None:
                        out["completion_tokens"] += fallback_replayed
                yield out

        await endpoint.serve(decode_handler)
    else:
        await endpoint.serve(handler)
    await register_llm(
        endpoint,
        ModelDeploymentCard(
            name=model_name,
            tokenizer="byte",
            model_type="chat",
            context_length=context_length,
            kv_block_size=args.block_size,
            runtime_config=ModelRuntimeConfig(
                total_kv_blocks=args.num_kv_blocks,
                max_num_seqs=args.max_num_seqs,
                max_num_batched_tokens=args.max_num_batched_tokens,
            ),
        ),
    )
    log.info("mocker %s worker %d serving model %r", role, worker_id, model_name)
    if served_event is not None:
        served_event.set()
    await runtime.wait_for_shutdown()


def main() -> None:
    ap = argparse.ArgumentParser(description="dynamo-tpu mocker worker")
    ap.add_argument("--model-name", default="mock-model")
    ap.add_argument("--namespace", default="dynamo")
    ap.add_argument("--component", default=None, help="defaults by role")
    ap.add_argument("--role", default="aggregated",
                    choices=["aggregated", "prefill", "decode"],
                    help="disagg pool role: 'prefill' consumes the "
                         "namespace prefill work queue and streams chunk "
                         "cursors; 'decode' routes long prefills there "
                         "and pulls committed KV windows while they run "
                         "(streams stay byte-identical to 'aggregated')")
    ap.add_argument("--num-kv-blocks", type=int, default=8192)
    ap.add_argument("--block-size", type=int, default=32)
    ap.add_argument("--max-num-seqs", type=int, default=256)
    ap.add_argument("--speedup-ratio", type=float, default=1.0)
    ap.add_argument("--context-length", type=int, default=16384)
    ap.add_argument("--scheduling", default="chunked",
                    choices=["waves", "chunked"],
                    help="mixed prefill-chunk+decode steps (chunked) or "
                         "monolithic prefill-priority waves")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="per-step prompt chunk cap (0 = budget-bound)")
    ap.add_argument("--max-num-batched-tokens", type=int, default=8192)
    ap.add_argument("--spec-decode", default="off", choices=["off", "ngram"],
                    help="simulate speculative decoding: decode rows emit "
                         "1 + accepted tokens per step at "
                         "--spec-acceptance-rate (stream stays bit-"
                         "identical to off)")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="draft tokens per verify step")
    ap.add_argument("--spec-acceptance-rate", type=float, default=0.6,
                    help="per-draft-token acceptance probability")
    ap.add_argument("--spec-device-draft", action="store_true",
                    help="draft on device between megastep inner "
                         "iterations (ISSUE 18): each later inner "
                         "iteration becomes a draft->verify->accept "
                         "round riding the same priced dispatch "
                         "(needs --megastep-k >= 2; stream stays "
                         "bit-identical)")
    ap.add_argument("--async-exec", default="off", choices=["on", "off"],
                    help="one-step-ahead overlap model: per-iteration host "
                         "overhead hides under device compute (virtual "
                         "clock; stream stays bit-identical to 'off')")
    ap.add_argument("--megastep-k", type=int, default=1,
                    help="universal megastep: iterations with decode work "
                         "fuse k device steps under ONE per-dispatch host "
                         "overhead (virtual clock; stream stays bit-"
                         "identical to k=1). Prefill chunks ride the same "
                         "priced dispatch and spec verify lanes resolve "
                         "accept/reject inside the fused iteration")
    ap.add_argument("--pp", type=int, default=1,
                    help="simulated pipeline-parallel stages (mirrors the "
                         "jax worker's --pp): decode dispatches price "
                         "k*pp + pp-1 stage hops at DYN_PP_HOP_US on the "
                         "virtual clock and report scheduler_pp_* gauges; "
                         "token values never change (stream bit-identical "
                         "to pp=1)")
    ap.add_argument("--kv-dtype", default="bf16", choices=["bf16", "int8"],
                    help="simulated KV cache dtype (mirrors the jax "
                         "worker's --kv-dtype): int8 halves the priced "
                         "per-block KV read bytes on the virtual clock "
                         "and reports int8 gauges on /metrics; token "
                         "values never change")
    ap.add_argument("--kv-read-us-per-block", type=float, default=0.0,
                    help="virtual-clock cost of reading one resident "
                         "bf16 KV block per decode lane-iteration "
                         "(scaled by the kv dtype's byte ratio; 0 = "
                         "legacy timing, KV traffic unpriced)")
    ap.add_argument("--kv-pull-us-per-block", type=float, default=0.0,
                    help="clock cost of pulling one bf16-equivalent KV "
                         "block from a peer worker (cluster KV pool; "
                         "scaled by the kv dtype's byte ratio — int8 "
                         "moves ~0.52x the bytes). 0 = pulls unpriced")
    ap.add_argument("--fair-scheduling", default="off", choices=["on", "off"],
                    help="per-tenant deficit-round-robin admission over "
                         "prompt token cost (off = strict FIFO; single-"
                         "tenant streams are bit-identical either way)")
    ap.add_argument("--fair-quantum", type=int, default=0,
                    help="tokens a tenant earns per DRR rotation visit "
                         "(0 = the per-step token budget)")
    ap.add_argument("--max-waiting", type=int, default=0,
                    help="bounded admission queue: at this many waiting "
                         "requests new submits get a typed retryable "
                         "shed error (migration retries elsewhere). "
                         "0 = unbounded")
    ap.add_argument("--obs-publish", default="on", choices=["on", "off"],
                    help="publish periodic metric snapshots on the event "
                         "plane for the fleet aggregator (off the sim "
                         "step; <2%% TPOT overhead asserted by bench "
                         "run_fleet_obs_ab)")
    ap.add_argument("--obs-interval-s", type=float, default=1.0,
                    help="metric-snapshot publish interval")
    ap.add_argument("--chaos-plan", default="",
                    help="fault-injection plan: inline JSON or @file "
                         "(same format as $DYN_CHAOS_PLAN; see "
                         "runtime/chaos.py for points/actions)")
    args = ap.parse_args()

    if args.chaos_plan:
        import json as _json

        from dynamo_tpu_torch.runtime import chaos

        raw = args.chaos_plan
        if raw.startswith("@"):
            with open(raw[1:], encoding="utf-8") as f:
                raw = f.read()
        chaos.install(chaos.ChaosPlan.from_dict(_json.loads(raw)))

    engine_args = MockEngineArgs(
        num_kv_blocks=args.num_kv_blocks,
        block_size=args.block_size,
        max_num_seqs=args.max_num_seqs,
        speedup_ratio=args.speedup_ratio,
        scheduling=args.scheduling,
        prefill_chunk=args.prefill_chunk,
        max_num_batched_tokens=args.max_num_batched_tokens,
        spec_decode=args.spec_decode,
        spec_k=args.spec_k,
        spec_acceptance_rate=args.spec_acceptance_rate,
        spec_device_draft=args.spec_device_draft,
        async_exec=args.async_exec == "on",
        megastep_k=args.megastep_k,
        pp=args.pp,
        kv_dtype=args.kv_dtype,
        kv_read_us_per_block=args.kv_read_us_per_block,
        kv_pull_us_per_block=args.kv_pull_us_per_block,
        fair_scheduling=args.fair_scheduling == "on",
        fair_quantum=args.fair_quantum,
        max_waiting=args.max_waiting,
    )

    component = args.component or (
        args.role if args.role != "aggregated" else "backend"
    )

    @dynamo_worker()
    async def entry(runtime: DistributedRuntime) -> None:
        await run_mocker(
            runtime,
            model_name=args.model_name,
            namespace=args.namespace,
            component=component,
            engine_args=engine_args,
            context_length=args.context_length,
            obs_publish=args.obs_publish == "on",
            obs_interval_s=args.obs_interval_s,
            role=args.role,
        )

    entry()


if __name__ == "__main__":
    main()
