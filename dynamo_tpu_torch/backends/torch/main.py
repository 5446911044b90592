"""The PyTorch backend worker: the port's engine wired into the runtime.

``python -m dynamo_tpu_torch.backends.torch --model-name llama3-8b
--preset llama3-8b`` starts a worker process shaped like the JAX
package's (``dynamo_tpu/backends/jax/main.py``): connect to the
control-plane store named by ``DYN_STORE_ADDRESS``, build the engine on
the card, publish KV events, load metrics and metric snapshots, serve
``/health`` and ``/metrics`` on its status server, register the model
card and serve the ``generate`` and ``kv_fetch`` endpoints over the TCP
data plane. Its wire is the JAX worker's, so the port's frontend and KV
router (``python -m dynamo_tpu_torch.frontend``) and the JAX package's
route to it as to a JAX worker, and a fleet may mix the two.

A request's image refs (``mm.images``) are resolved to embedding rows
before admission, as the JAX worker resolves them: by the encoder fleet
(``python -m dynamo_tpu_torch.backends.encoder``) when one is registered,
else in process. An embedding request (``embed``) runs locally in every
role. ``--preset tiny-moe|mixtral-8x7b`` serves a sparse MoE model
(``--moe-dispatch`` is taken as the JAX worker takes it; on one device
both values are the local dispatch).

``--role prefill`` and ``--role decode`` split a request as the JAX
worker does (decode first): the decode worker queues a long prompt's
prefill on the store's ``prefill:{namespace}`` work queue
(``--max-local-prefill-length``), a prefill worker runs it and holds the
blocks, and the decode worker pulls them over ``kv_transfer``, streamed
chunk by chunk while the prefill runs, and decodes on. ``--host-kv-blocks``
and ``--disk-kv-dir`` add the host and disk KV tiers.

:func:`build_engine` is the in-process entry point the worker wraps.
The CLI takes the JAX worker's flags, less the tuning values of features
it refuses (``--node-rank``), which argparse rejects; a value the port
does not serve yet raises a ``ValueError`` naming the ``ROADMAP.md`` item
that brings it. ``--spec-decode ngram --spec-k 4 [--spec-device-draft]``
turns on n-gram speculative decoding, drafted on the host or on the card.
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import json
import logging
import time
import uuid
from typing import Any, AsyncIterator

import msgpack
import numpy as np
import torch

from dynamo_tpu_torch import knobs, tracing
from dynamo_tpu_torch.engine.config import PRESETS, EngineConfig, ModelConfig, tiny_engine
from dynamo_tpu_torch.engine.core import EngineCore, check_slice, resolve_device
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.engine.model import init_params_quantized
from dynamo_tpu_torch.llm.disagg import DisaggConfig, DisaggRouter
from dynamo_tpu_torch.llm.disagg_pool import (
    ChunkCursorPublisher,
    ChunkCursorWatcher,
    StreamingHandoff,
)
from dynamo_tpu_torch.llm.discovery import register_llm
from dynamo_tpu_torch.llm.kv_pool import PeerKvClient
from dynamo_tpu_torch.llm.kv_router.publisher import KvEventPublisher, WorkerMetricsPublisher
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard, ModelRuntimeConfig
from dynamo_tpu_torch.llm.multimodal import image_bytes, patch_embed
from dynamo_tpu_torch.llm.protocols.common import (
    LLMEngineOutput,
    PreprocessedRequest,
    StopConditions,
)
from dynamo_tpu_torch.obs.slo import PhaseScanner
from dynamo_tpu_torch.obs.snapshot import SnapshotPublisher
from dynamo_tpu_torch.ops import ragged_attention
from dynamo_tpu_torch.runtime import Context, DistributedRuntime, chaos, wire
from dynamo_tpu_torch.runtime.status_server import (
    bind_disagg_gauges,
    bind_fair_queue_gauges,
    bind_kv_cache_gauges,
    bind_kv_pool_gauges,
    bind_scheduler_gauges,
    bind_spec_gauges,
    bind_store_gauges,
)
from dynamo_tpu_torch.runtime.store.client import StoreClient
from dynamo_tpu_torch.runtime.tasks import spawn_logged
from dynamo_tpu_torch.runtime.worker import dynamo_worker

log = logging.getLogger("dynamo_tpu_torch.backends.torch")


def engine_configs(
    preset: str, engine_overrides: dict[str, Any] | None = None,
    moe_dispatch: str | None = None,
) -> tuple[ModelConfig, EngineConfig]:
    """The preset's model config and its engine config with the overrides:
    the tiny presets use the tiny engine shape, every other preset the
    ``EngineConfig`` defaults. ``moe_dispatch`` sets a MoE preset's
    dispatch mode and is refused for a dense one, as the JAX worker
    refuses it."""
    model_cfg = PRESETS[preset]()
    if moe_dispatch is not None:
        if not model_cfg.is_moe:
            raise ValueError(f"--moe-dispatch set but preset {preset!r} is dense")
        model_cfg = dataclasses.replace(model_cfg, moe_dispatch=moe_dispatch)
    overrides = dict(engine_overrides or {})
    if preset in ("tiny", "tiny-moe"):
        return model_cfg, tiny_engine(**overrides)
    return model_cfg, EngineConfig(**overrides)


def build_engine(
    preset: str,
    engine_overrides: dict[str, Any] | None = None,
    seed: int = 0,
    eos_token_ids: tuple[int, ...] = (),
    device="cuda",
    params: dict | None = None,
    quant: str | None = None,
    on_stored=None,
    on_removed=None,
    on_tier_stored=None,
    on_tier_removed=None,
    moe_dispatch: str | None = None,
) -> tuple[EngineCore, TorchEngine]:
    """Construct (EngineCore, TorchEngine) for a model preset.

    Runs on the card unless the caller passes ``device="cpu"``; with
    ``device="cuda"`` and no card it raises. ``params`` takes converted
    weights (``engine/convert.py``) or another engine's ``core.params``;
    None draws random weights from ``seed``. ``quant="int8"`` draws them
    straight into the int8 weight-only layout (``model.init_params_quantized``,
    as the JAX ``build_engine`` does); int8 KV pages are the engine
    override ``{"kv_dtype": "int8"}``. The engine shape comes from
    :func:`engine_configs`. ``on_stored`` and ``on_removed`` receive the
    block allocator's KV events, ``on_tier_stored`` and ``on_tier_removed``
    (both or neither) the offload tiers' tier-tagged ones. A MoE preset
    (``tiny-moe``, ``mixtral-8x7b``) takes ``moe_dispatch``
    (:func:`engine_configs`); its int8 weights are refused.
    """
    dev = resolve_device(device)
    model_cfg, engine_cfg = engine_configs(preset, engine_overrides, moe_dispatch)
    if quant == "int8":
        if params is not None:
            raise ValueError("quant='int8' draws random weights; pass params or quant, not both")
        params = init_params_quantized(model_cfg, seed, dev)
    elif quant:
        raise ValueError(f"unknown quantization {quant!r}")
    core = EngineCore(
        model_cfg, engine_cfg, params=params, seed=seed,
        eos_token_ids=eos_token_ids, device=dev,
        on_stored=on_stored, on_removed=on_removed,
        on_tier_stored=on_tier_stored, on_tier_removed=on_tier_removed,
    )
    return core, TorchEngine(core)


def _eos_for(tokenizer: str) -> tuple[int, ...]:
    """EOS ids of the served tokenizer; a tokenizer that fails to load
    fails start-up (serving without EOS would stop only on max_tokens)."""
    if tokenizer == "byte":
        from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer

        return (ByteTokenizer.EOS,)
    from dynamo_tpu_torch.llm.tokenizer import load_tokenizer

    eos = load_tokenizer(tokenizer).eos_token_id
    return (eos,) if eos is not None else ()


def _model_card(model_name: str, tokenizer: str, core: EngineCore) -> ModelDeploymentCard:
    return ModelDeploymentCard(
        name=model_name,
        tokenizer=tokenizer,
        model_type="chat",
        context_length=core.engine.max_model_len,
        kv_block_size=core.engine.block_size,
        runtime_config=ModelRuntimeConfig(
            total_kv_blocks=core.engine.num_kv_blocks,
            max_num_seqs=core.engine.max_num_seqs,
            max_num_batched_tokens=core.engine.prefill_buckets[-1],
        ),
    )


def _build_and_warm(preset, engine_overrides, seed, eos, quant, device, params,
                    events, moe_dispatch=None) -> tuple[EngineCore, TorchEngine, int]:
    on_stored, on_removed, on_tier_stored, on_tier_removed = events
    core, engine = build_engine(
        preset, engine_overrides, seed=seed, eos_token_ids=eos, device=device,
        params=params, quant=quant, on_stored=on_stored, on_removed=on_removed,
        on_tier_stored=on_tier_stored, on_tier_removed=on_tier_removed,
        moe_dispatch=moe_dispatch,
    )
    if core.device.type != "cuda":
        return core, engine, core.warm_up()
    # The weights' random draw and the warm-up's eager forwards leave
    # their temporaries reserved in the caching allocator: hand them back,
    # so that several workers fit on one card.
    torch.cuda.empty_cache()
    forwards = core.warm_up()
    torch.cuda.empty_cache()
    return core, engine, forwards


async def _resolve_mm(core: EngineCore, encode_client, embed_fetch_client, request: dict) -> None:
    """Resolve a request's image refs to embedding rows in place, as the
    JAX worker does: through the encoder fleet (``encode`` returns a
    descriptor, the tensor is pulled by id over ``embed_fetch``) when one
    is registered, else, or when the fleet fails, by encoding in process,
    which gives the same rows. A request that carries its rows already
    (a remote prefill queued by a decode worker) is left as it is."""
    mm = request.get("mm")
    if not mm or mm.get("embeds") is not None or not mm.get("images"):
        return
    h = core.cfg.hidden_size
    use_fleet = encode_client is not None and encode_client.instance_ids()

    async def one(ref: str) -> np.ndarray:
        if use_fleet:
            try:
                async with asyncio.timeout(30.0):
                    desc = None
                    async for out in await encode_client.round_robin(
                        {"image": ref, "hidden_size": h}
                    ):
                        desc = out
                    data = None
                    if desc and "embed_id" in desc:
                        fetch = await embed_fetch_client.direct(
                            desc["worker_id"], {"embed_id": desc["embed_id"]}
                        )
                        async for out in fetch:
                            data = out.get("data", data)
                    if data is None:
                        raise ConnectionError("encoder returned no embedding")
                    return np.frombuffer(data, np.float32).reshape(tuple(desc["shape"]))
            except Exception:  # noqa: BLE001 — the local encode is equivalent
                log.warning("encoder fleet failed; encoding locally", exc_info=True)
        return await asyncio.to_thread(patch_embed, image_bytes(ref), h)

    # One fleet round trip bounds the latency, not one per image.
    embeds = await asyncio.gather(*(one(ref) for ref in mm["images"]))
    allemb = np.concatenate(list(embeds), axis=0).astype(np.float32)
    request["mm"] = dict(mm, embeds=allemb.tobytes(), embeds_shape=list(allemb.shape))


def _prefill_queue(namespace: str) -> str:
    """Store work-queue name for a namespace's prefill fleet."""
    return f"prefill:{namespace}"


async def _serve_kv_fetch(runtime, namespace: str, component: str, core: EngineCore) -> None:
    """Peer block server: stream the longest locally held prefix of the
    requested hash chain (device tier or offload tiers) as raw pages, the
    page geometry first, as the JAX worker serves it."""

    async def kv_fetch_handler(request: Any, context: Context) -> AsyncIterator[Any]:
        hashes = list(request.get(wire.KV_HASHES) or [])
        chunk = int(request.get(wire.KV_CHUNK_BLOCKS, 32))
        yield {
            wire.KV_VERSION: 2,
            wire.KV_SHAPE: list(core._page_shape()),
            wire.KV_DTYPE: core.kv_wire_dtype,
        }
        sent = 0
        for s in range(0, len(hashes), chunk):
            pages = await asyncio.to_thread(core.read_cached_pages, hashes[s : s + chunk])
            if pages:
                yield {wire.KV_VERSION: 2, wire.KV_START: sent, wire.KV_PAGES: pages}
                sent += len(pages)
            if len(pages) < min(chunk, len(hashes) - s):
                break  # hash chains are prefixes: the first miss ends it
        yield {wire.KV_VERSION: 2, wire.KV_DONE: sent}

    ep = runtime.namespace(namespace).component(component).endpoint("kv_fetch")
    await ep.serve(kv_fetch_handler)


async def run_torch_worker(
    runtime: DistributedRuntime,
    model_name: str = "tiny",
    preset: str = "tiny",
    namespace: str = "dynamo",
    component: str | None = None,
    engine_overrides: dict[str, Any] | None = None,
    tokenizer: str = "byte",
    seed: int = 0,
    role: str = "aggregated",
    disagg_config: DisaggConfig | None = None,
    served_event: asyncio.Event | None = None,
    core_out: list | None = None,
    quant: str | None = None,
    device="cuda",
    params: dict | None = None,
    obs_publish: bool = True,
    obs_interval_s: float = 1.0,
    moe_dispatch: str | None = None,
) -> None:
    """Serve one worker until the runtime shuts down, in the JAX worker's
    roles (``aggregated``, ``prefill`` or ``decode``; ``component``
    defaults to ``prefill`` for the prefill role, else ``backend``).

    As the JAX package's ``run_jax_worker``: KV events hop from the engine
    thread (and the offload worker's, tier-tagged) onto the loop, a
    graceful drain retracts the published inventory, load metrics are
    published every 0.5 s, the core's counters are gauges on the status
    server (when the runtime has one) and, with ``obs_publish``, metric
    snapshots every ``obs_interval_s``. Every role serves ``kv_fetch``;
    the aggregated and decode roles pull a router's ``peer_prefix`` hint
    from the peer before admission. Every role resolves image refs
    through the encoder fleet or in process (:func:`_resolve_mm`) and
    answers embedding requests locally. The prefill role takes remote
    prefills off the namespace's store work queue, holds their blocks and
    serves them on ``kv_transfer``, advertising committed chunks on the
    cursor plane; the decode role sends prompts longer than
    ``disagg_config.max_local_prefill_length`` there while the queue is
    short, pulls the blocks (streamed while the prefill runs, else after
    its reply) and decodes on. The model card is registered only once the
    engine is built and warmed up (off the loop, so the store lease's
    keepalive keeps running).
    """
    if role not in ("aggregated", "prefill", "decode"):
        raise ValueError(f"unknown role {role!r}")
    if component is None:
        component = "prefill" if role == "prefill" else "backend"
    worker_id = runtime.primary_lease_id
    kv_pub = KvEventPublisher(runtime.store, namespace, component, worker_id)
    loop = asyncio.get_running_loop()

    # KV events fire on the engine thread (core.step under to_thread) and
    # on the offload worker's thread (tier moves); the publisher's bounded
    # buffer lives on the loop.
    def on_stored(hashes: list[int], parent: int | None) -> None:
        loop.call_soon_threadsafe(kv_pub.stored_nowait, list(hashes), parent)

    def on_removed(hashes: list[int]) -> None:
        loop.call_soon_threadsafe(kv_pub.removed_nowait, list(hashes))

    def on_tier_stored(hashes: list[int], parent: int | None, tier: str) -> None:
        loop.call_soon_threadsafe(kv_pub.stored_nowait, list(hashes), parent, tier)

    def on_tier_removed(hashes: list[int], tier: str) -> None:
        loop.call_soon_threadsafe(kv_pub.removed_nowait, list(hashes), tier)

    eos = await asyncio.to_thread(_eos_for, tokenizer)
    core, engine, warm_up_forwards = await asyncio.to_thread(
        _build_and_warm, preset, engine_overrides, seed, eos, quant, device, params,
        (on_stored, on_removed, on_tier_stored, on_tier_removed), moe_dispatch,
    )
    if core_out is not None:
        core_out.append(core)
    core.flight.name = f"worker-{worker_id}"

    kv_pub.inventory_source = core.kv_inventory
    await kv_pub.start()

    async def _retract_kv_inventory() -> None:
        kv_pub.cleared_nowait()
        await kv_pub.flush(timeout=5.0)

    runtime.on_drain.append(_retract_kv_inventory)

    metrics_pub = WorkerMetricsPublisher(
        runtime.store, namespace, component, worker_id, engine.metrics, interval_s=0.5
    )
    await metrics_pub.start()

    # Every role serves its blocks to peers; the aggregated and decode
    # roles also pull them (a prefill worker serves but never pulls).
    await _serve_kv_fetch(runtime, namespace, component, core)
    peer_kv: PeerKvClient | None = None
    if role != "prefill":
        fetch_client = await (
            runtime.namespace(namespace).component(component).endpoint("kv_fetch").client()
        )
        peer_kv = PeerKvClient(core, fetch_client)

    def _kv_pool_stats() -> dict:
        st = kv_pub.stats()
        if peer_kv is not None:
            st.update(peer_kv.pool_stats())
        return st

    # Decode role: the streaming handoff's counters, and where each
    # remotely prefilled request ended up (a fallback recomputes locally).
    handoff: StreamingHandoff | None = None
    routed = {"remote_prefills": 0, "local_prefills": 0, "recompute_fallbacks": 0}

    def _disagg_stats() -> dict:
        st = handoff.stats.as_dict() if handoff is not None else {}
        return {**st, **routed, **core.transfer_stats}

    # Gauges on this worker's /metrics, read from the live core at scrape
    # time, as the JAX worker binds them.
    bind_store_gauges(runtime.status, runtime.store)
    bind_scheduler_gauges(runtime.status, core.scheduler_stats)
    bind_spec_gauges(runtime.status, core.spec_decode_stats)
    bind_kv_cache_gauges(runtime.status, core.kv_cache_stats)
    bind_fair_queue_gauges(runtime.status, core.fair_queue_stats)
    bind_kv_pool_gauges(runtime.status, _kv_pool_stats)

    if role == "decode":
        disagg = DisaggRouter(disagg_config)
        spawn_logged(
            disagg.watch_store(runtime.store, namespace),
            name="disagg-watch-store", logger=log,
        )
        prefill_client = await (
            runtime.namespace(namespace).component("prefill").endpoint("generate").client()
        )
        transfer_client = await (
            runtime.namespace(namespace).component("prefill").endpoint("kv_transfer").client()
        )
        if knobs.get_bool("DYN_DISAGG_STREAMING"):
            cursor_watch = ChunkCursorWatcher(runtime.store, namespace)
            await cursor_watch.start()
            handoff = StreamingHandoff(peer_kv, cursor_watch, transfer_client)
            bind_disagg_gauges(runtime.status, handoff.stats.as_dict)

    # Metric snapshots for the fleet aggregator: a loop task reading the
    # same host dicts, nothing on the engine thread. A graceful drain
    # publishes the retraction, so the series leave the fleet view at once.
    if obs_publish:
        snap_pub = SnapshotPublisher(
            runtime.store, namespace, worker_id,
            role="worker", component=component, interval_s=obs_interval_s,
        )
        snap_pub.collectors = {
            "scheduler": core.scheduler_stats,
            "spec": core.spec_decode_stats,
            "kv_cache": core.kv_cache_stats,
            "kv_pool": _kv_pool_stats,
        }
        if role == "decode":
            snap_pub.collectors["disagg"] = _disagg_stats
        snap_pub.tenant_source = core.fair_queue_stats
        collector = tracing.get_collector()
        snap_pub.phase_source = collector.phase_totals
        snap_pub.request_source = PhaseScanner(collector).scan
        await snap_pub.start()

        async def _retire_snapshot() -> None:
            await snap_pub.retire(timeout=5.0)

        runtime.on_drain.append(_retire_snapshot)

    # The encoder fleet's clients (idle watches where no encoder component
    # is deployed: _resolve_mm then encodes in process).
    encoder = runtime.namespace(namespace).component("encoder")
    encode_client = await encoder.endpoint("encode").client()
    embed_fetch_client = await encoder.endpoint("embed_fetch").client()

    async def resolve_mm(request: dict) -> None:
        await _resolve_mm(core, encode_client, embed_fetch_client, request)

    endpoint = runtime.namespace(namespace).component(component).endpoint("generate")

    consumer: asyncio.Task | None = None
    if role == "prefill":
        consumer = await _serve_prefill_role(runtime, namespace, component, core, engine,
                                              worker_id, endpoint, resolve_mm)
    elif role == "decode":
        qname = _prefill_queue(namespace)

        async def handler(request: Any, context: Context) -> AsyncIterator[Any]:
            if request.get("embed") or request.get("clear_kv_blocks"):
                async for out in engine.generate(request, context):
                    yield out
                return
            await resolve_mm(request)
            pre = PreprocessedRequest.from_wire(request)
            pre.request_id = pre.request_id or context.id
            hint = (pre.kv_transfer_params or {}).get("peer_prefix")
            if hint and hint.get("worker_id") != worker_id:
                await peer_kv.pull_prefix(hint, list(pre.token_ids))
            cached = await asyncio.to_thread(core.cached_prefix_tokens, pre.token_ids)
            uncached = len(pre.token_ids) - cached
            fallback_replayed = 0  # tokens replayed by an in-worker fallback
            depth = 0
            if prefill_client.instance_ids():
                try:
                    depth = await runtime.store.queue_len(qname)
                except Exception:  # noqa: BLE001 — store hiccup: stay local
                    log.debug("queue_len failed; treating the prefill queue as "
                              "full (local prefill)", exc_info=True)
                    depth = disagg.config.max_prefill_queue_size + 1
            if prefill_client.instance_ids() and disagg.decide(
                uncached, depth, headers=context.headers, request_id=pre.request_id,
            ):
                routed["remote_prefills"] += 1
                # What already reached the client: a mid-stream failure
                # resumes by token replay, never replays tokens it has seen.
                emitted: list[int] = []
                try:
                    async for out in _remote_prefill_then_decode(
                        core, engine, pre, context, runtime.store, qname,
                        transfer_client, emitted, tracer=disagg.tracer, handoff=handoff,
                    ):
                        yield out
                    return
                except Exception:
                    log.exception("remote prefill failed for %s; falling back to local",
                                  pre.request_id)
                routed["recompute_fallbacks"] += 1
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
            else:
                routed["local_prefills"] += 1
            async for out in engine.generate(pre.to_wire(), context):
                if fallback_replayed and out.get("finish_reason") is not None:
                    # The engine counted the replayed tokens as prompt and
                    # only its own output as completion: charge each once.
                    if out.get("prompt_tokens") is not None:
                        out["prompt_tokens"] -= fallback_replayed
                    if out.get("completion_tokens") is not None:
                        out["completion_tokens"] += fallback_replayed
                yield out

    else:
        async def handler(request: Any, context: Context) -> AsyncIterator[Any]:
            await resolve_mm(request)
            hint = (request.get("kv_transfer_params") or {}).get("peer_prefix")
            if hint and hint.get("worker_id") != worker_id and request.get("token_ids"):
                await peer_kv.pull_prefix(hint, list(request["token_ids"]))
            async for out in engine.generate(request, context):
                yield out

    if role != "prefill":
        await endpoint.serve(handler)
        await register_llm(endpoint, _model_card(model_name, tokenizer, core))
    log.info(
        "torch %s worker %d serving model %r (preset %s, %d kv blocks, %s)",
        role, worker_id, model_name, preset, core.engine.num_kv_blocks, core.device,
    )
    if served_event is not None:
        served_event.set()
    try:
        await runtime.wait_for_shutdown()
    finally:
        if consumer is not None:
            consumer.cancel()
        # The engine's counters over the worker's life, one JSON object:
        # the launches of each K1 kernel include the warm-up's forwards.
        stats = {**core.scheduler_stats(), "warm_up_forwards": warm_up_forwards,
                 "kernel_launches": ragged_attention.kernel_launches,
                 "role": role, "transfer": core.transfer_stats,
                 "kv_pool": _kv_pool_stats(), "disagg": _disagg_stats()}
        if core.offload is not None:
            stats["tiers"] = core.tier_stats()
        log.info("torch worker %d stopping: %s", worker_id, json.dumps(stats))


async def _serve_prefill_role(runtime, namespace, component, core, engine, worker_id,
                              endpoint, resolve_mm) -> asyncio.Task:
    """The prefill role: serve ``generate`` (descriptors tagged with this
    worker's id) and ``kv_transfer`` (descriptors first, then page
    windows), advertise committed chunks on the cursor plane, and start
    the work-queue consumer, which pops a remote prefill only while an
    admission slot is free, so the queue's length is the fleet's real
    backlog. Returns the consumer task."""

    async def handler(request: Any, context: Context) -> AsyncIterator[Any]:
        await resolve_mm(request)
        async for out in engine.generate(request, context):
            if out.get("kv_transfer_params"):
                out["kv_transfer_params"]["worker_id"] = worker_id
            yield out

    cursor_pub = ChunkCursorPublisher(runtime.store, namespace, worker_id)
    await cursor_pub.start()
    core.on_chunk_commit = cursor_pub.engine_callback(asyncio.get_running_loop())

    async def kv_transfer_handler(request: Any, context: Context) -> AsyncIterator[Any]:
        rid = request[wire.KV_REQUEST_ID]
        chunk = int(request.get(wire.KV_CHUNK_BLOCKS, 32))
        # A windowed request (streaming handoff) asks for one committed
        # window and keeps the hold unless it is the final window.
        windowed = wire.KV_WINDOW_START in request
        ws = int(request.get(wire.KV_WINDOW_START, 0))
        wc = request.get(wire.KV_WINDOW_COUNT)
        wc = int(wc) if wc is not None else None
        release = (not windowed) or bool(request.get(wire.KV_WINDOW_FINAL))
        try:
            descs = core.export_descriptors(rid, start=ws, count=wc)
        except KeyError:
            yield {wire.KV_ERROR: f"no held blocks for {rid}"}
            return
        yield {wire.KV_VERSION: core.KV_WIRE_VERSION, wire.KV_BLOCKS: descs}
        try:
            for s in range(0, len(descs), chunk):
                pages = await asyncio.to_thread(
                    core.read_held_pages, rid, ws + s, min(chunk, len(descs) - s),
                )
                yield {wire.KV_VERSION: core.KV_WIRE_VERSION, wire.KV_START: s,
                       wire.KV_PAGES: pages}
        finally:
            if release:
                core.release_held(rid)

    transfer_ep = runtime.namespace(namespace).component(component).endpoint("kv_transfer")
    await transfer_ep.serve(kv_transfer_handler)
    await endpoint.serve(handler)

    qname = _prefill_queue(namespace)
    sem = asyncio.Semaphore(core.engine.max_num_seqs)
    inflight: set[asyncio.Task] = set()
    # A pop waits up to a second on its store connection, and the store
    # serves one connection's requests in order: on the worker's own
    # connection each pop would hold back the replies, chunk cursors and
    # KV events queued behind it. So the pops get a connection of their
    # own.
    qstore = await StoreClient.open(runtime.store.address)

    async def _reply(key: str, payload: dict) -> None:
        # A short-TTL lease: a reply the decode side never reads expires.
        lease = await runtime.store.lease_grant(ttl=60.0, keepalive=False)
        await runtime.store.kv_put(key, msgpack.packb(payload, use_bin_type=True), lease=lease)

    async def _serve_queued(task: dict) -> None:
        try:
            req = task["request"]
            # The decode side's traceparent rides the queued task.
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
            await _reply(task["reply_key"], last)
        except Exception:
            log.exception("queued prefill failed")
            try:
                await _reply(task["reply_key"], {"error": "remote prefill failed"})
            except Exception:  # noqa: BLE001 — store down; the caller times out
                log.warning("could not publish prefill-failure reply for %r",
                            task.get("reply_key"), exc_info=True)
        finally:
            sem.release()

    async def _consume_queue() -> None:
        try:
            while True:
                await sem.acquire()
                try:
                    payload = await qstore.queue_pop(qname, timeout=1.0)
                except asyncio.CancelledError:
                    raise
                except Exception:  # noqa: BLE001 — store closed on shutdown
                    log.debug("prefill queue pop failed; consumer exiting", exc_info=True)
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
                # A strong reference: the loop keeps only weak ones, and a
                # collected task would leak its semaphore slot.
                t = asyncio.create_task(_serve_queued(task))
                inflight.add(t)
                t.add_done_callback(inflight.discard)
        finally:
            await qstore.close()

    return asyncio.create_task(_consume_queue())


async def _remote_prefill_then_decode(
    core: EngineCore, engine: TorchEngine, pre: PreprocessedRequest, context: Context,
    store, qname: str, transfer_client, emitted: list[int] | None = None,
    tracer=None, reply_timeout: float = 120.0, handoff: StreamingHandoff | None = None,
) -> AsyncIterator[Any]:
    """Decode-first disaggregation, as the JAX worker runs it: queue the
    prefill (``max_tokens=1``, ``do_remote_decode``), pull its blocks and
    continue decoding from the local prefix by replaying the first token.

    ``emitted`` (if given) collects every token yielded to the caller, so
    a mid-stream failure resumes instead of replaying the stream.
    ``handoff`` streams committed chunk windows in while the remote
    prefill still runs; a fully streamed handoff skips the reply-gated
    pull. A streaming failure falls through to that pull, and failing that
    to the caller's local recompute."""
    prefill_req = dataclasses.replace(
        pre,
        stop=StopConditions(max_tokens=1, ignore_eos=True),
        kv_transfer_params={"do_remote_decode": True},
    )
    reply_key = f"/dynamo/prefill-reply/{pre.request_id}-{uuid.uuid4().hex[:8]}"
    sub = await store.kv_watch(reply_key, with_initial=False)
    # Follow the chunk cursor BEFORE the queue push: the first committed
    # chunks may land within the reply round trip.
    stream_task: asyncio.Task | None = None
    if handoff is not None:
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
                "prefill_handoff", t_handoff, time.time(), headers=context.headers,
                attrs={
                    "request_id": pre.request_id,
                    "prefill_tokens": len(pre.token_ids),
                    "ok": first is not None and "error" not in (first or {}),
                },
            )
    if first is None or "error" in first:
        if stream_task is not None:
            stream_task.cancel()
        if first is None:
            raise ConnectionError("prefill worker returned no output")
        raise ConnectionError(f"remote prefill failed: {first['error']}")
    out1 = LLMEngineOutput.from_wire(first)
    xfer = out1.kv_transfer_params or {}
    prefill_worker = xfer.get("worker_id")
    rid = xfer.get("request_id")

    # By reply time most chunks should be local: wait (bounded) for the
    # in-flight tail. A fully streamed handoff sent the final window (the
    # hold was released on the prefill side) and skips the pull below.
    streamed = False
    if stream_task is not None:
        if stream_task.done():
            streamed = bool(stream_task.result())
        elif rid is None or handoff.watcher.cursor(rid) is None:
            stream_task.cancel()  # no cursor ever came: pull now
        else:
            try:
                streamed = bool(await asyncio.wait_for(stream_task, handoff.peer_kv.total_timeout_s))
            except asyncio.TimeoutError:
                streamed = False  # wait_for cancelled the tail

    if prefill_worker is not None and rid is not None and streamed and tracer is not None:
        tracer.record(
            "kv_stream", t_handoff, time.time(), headers=context.headers,
            attrs={"request_id": pre.request_id, "prefill_worker": prefill_worker,
                   "chunks": handoff.stats.chunks_pulled, "streamed": True},
        )
    if prefill_worker is not None and rid is not None and not streamed:
        descs: list[dict] | None = None
        imported = total = dropped = 0
        t_xfer = time.time()
        if chaos.active():
            # A severed pull surfaces as ConnectionError, which the decode
            # handler degrades to local recompute and replay.
            await chaos.inject("kv_transfer.pull", str(prefill_worker))
        bstream = await transfer_client.direct(prefill_worker, {wire.KV_REQUEST_ID: rid})
        async for frame in bstream:
            if wire.KV_ERROR in frame:
                log.warning("kv transfer aborted for %s: %s", rid, frame[wire.KV_ERROR])
                break
            ver = frame.get(wire.KV_VERSION)
            if ver != 2:
                raise ConnectionError(
                    f"unsupported KV transfer wire version {ver!r} "
                    "(mixed-version prefill/decode pair?)"
                )
            if wire.KV_BLOCKS in frame:
                descs = frame[wire.KV_BLOCKS]
                continue
            if descs is None:
                raise ConnectionError("KV transfer data frame before descriptors")
            s = frame[wire.KV_START]
            batch = [{**descs[s + j], wire.IMP_KV: kv} for j, kv in enumerate(frame[wire.KV_PAGES])]
            total += len(batch)
            # Chunk by chunk, beside the engine's own steps (the step lock
            # is held per splice only).
            res = await asyncio.to_thread(core.import_blocks, batch)
            imported += res.imported
            dropped += res.dropped
        if dropped > 0:
            log.warning(
                "KV transfer for %s: %d/%d blocks dropped (allocator full); "
                "the local prefill will recompute them", rid, dropped, total,
            )
        if tracer is not None:
            tracer.record(
                "kv_transfer", t_xfer, time.time(), headers=context.headers,
                attrs={"request_id": pre.request_id, "prefill_worker": prefill_worker,
                       "blocks": total, "imported": imported, "dropped": dropped},
            )

    token1 = out1.token_ids[0]
    # The prefill's log-probability of token1 rides along (the JAX worker
    # drops it, so its first disaggregated token has none).
    first_chunk = LLMEngineOutput(token_ids=[token1], logprobs=out1.logprobs,
                                  meta=dict(out1.meta, remote_prefill=True))
    # The remote prefill ran with ignore_eos: check token1 against the
    # request's own stop conditions before continuing.
    finish = _first_token_finish(core, pre.stop, token1)
    if finish is None and pre.stop.max_tokens is not None and pre.stop.max_tokens <= 1:
        finish = out1.finish_reason or "length"
    if emitted is not None:
        emitted.append(token1)
    if finish is not None:
        first_chunk.finish_reason = finish
        first_chunk.prompt_tokens = len(pre.token_ids)
        first_chunk.completion_tokens = 1
        yield first_chunk.to_wire()
        return
    yield first_chunk.to_wire()

    cont = dataclasses.replace(
        pre,
        token_ids=list(pre.token_ids) + [token1],
        stop=pre.stop.after_replay(1),
        kv_transfer_params=None,
    )
    async for out in engine.generate(cont.to_wire(), context):
        if emitted is not None:
            emitted.extend(LLMEngineOutput.from_wire(out).token_ids)
        yield out


def _first_token_finish(core: EngineCore, stop: StopConditions, token: int) -> str | None:
    """Stop check of a remotely prefilled first token (the prefill ran with
    ignore_eos and no stop set); the caller handles max_tokens."""
    reason = stop.check_token(token, 1, core.eos_token_ids)
    return None if reason == "length" else reason


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="dynamo-tpu PyTorch engine worker")
    ap.add_argument("--model-name", default="tiny")
    ap.add_argument(
        "--preset", default="tiny",
        choices=["tiny", "tiny-moe", "llama3-1b", "llama3-8b", "llama3-70b",
                 "qwen2-7b", "mixtral-8x7b"],
    )
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default; raises without a card) or cpu "
                         "(the kernels' plain PyTorch versions)")
    ap.add_argument("--namespace", default="dynamo")
    ap.add_argument("--component", default=None,
                    help="defaults to 'prefill' for --role prefill, else 'backend'")
    ap.add_argument("--tokenizer", default=None,
                    help="'byte' (default) or an HF tokenizer path "
                         "(a .gguf tokenizer waits for A7)")
    ap.add_argument("--num-kv-blocks", type=int, default=None)
    ap.add_argument("--block-size", type=int, default=None)
    ap.add_argument("--max-num-seqs", type=int, default=None)
    ap.add_argument("--max-model-len", type=int, default=None)
    ap.add_argument(
        "--scheduling", default=None, choices=["waves", "chunked"],
        help="step scheduler: 'waves' = prefill waves before decode (default); "
             "'chunked' = prefill chunks and decode rows in one step under a "
             "per-step token budget",
    )
    ap.add_argument(
        "--prefill-chunk", type=int, default=None,
        help="prompt chunk size for --scheduling chunked (block-aligned; "
             "0/unset = auto from the prefill buckets)",
    )
    ap.add_argument(
        "--max-num-batched-tokens", type=int, default=None,
        help="per-step token budget of mixed steps (0/unset = the largest "
             "prefill bucket)",
    )
    ap.add_argument(
        "--spec-decode", default=None, choices=["off", "ngram"],
        help="speculative decoding: 'ngram' drafts by prompt lookup and verifies "
             "pending + draft as one ragged row (greedy and seeded streams are "
             "those of 'off')",
    )
    ap.add_argument(
        "--spec-k", type=int, default=None,
        help="most draft tokens per verify row (also caps a request's "
             "dyn.spec_decode k)",
    )
    ap.add_argument(
        "--spec-device-draft", action="store_true", default=None,
        help="draft on the card between megastep iterations, so draft, verify "
             "and accept loop inside one dispatch (needs --megastep-k >= 2)",
    )
    ap.add_argument("--async-exec", default=None, choices=["on", "off"])
    ap.add_argument("--megastep-k", type=int, default=None,
                    help="decode iterations per megastep (1 = off; unset = 8)")
    ap.add_argument("--fair-scheduling", default=None, choices=["on", "off"])
    ap.add_argument("--fair-quantum", type=int, default=None)
    ap.add_argument("--max-waiting", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and of unseeded sampling")
    ap.add_argument("--quant", default=None, choices=["int8"],
                    help="int8 weight-only quantization")
    ap.add_argument("--kv-dtype", default=None, choices=["bf16", "int8"],
                    help="KV page dtype; align it across a fleet that transfers KV")
    ap.add_argument("--host-kv-blocks", type=int, default=None,
                    help="host-RAM KV tier (G2): blocks evicted from the card stay "
                         "here and onboard on a prefix hit (0/unset = off)")
    ap.add_argument("--disk-kv-dir", default=None,
                    help="disk KV tier (G3) under this directory (needs "
                         "--host-kv-blocks > 0; not shared with JAX workers)")
    ap.add_argument("--disk-kv-blocks", type=int, default=None,
                    help="disk tier capacity in blocks (unset = 4096)")
    ap.add_argument("--model-path", default=None)
    ap.add_argument("--moe-dispatch", default=None, choices=["replicated", "alltoall"])
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--sp", type=int, default=1)
    ap.add_argument("--ring-prefill-threshold", type=int, default=None)
    ap.add_argument("--pp", type=int, default=1)
    ap.add_argument("--obs-publish", default="on", choices=["on", "off"],
                    help="publish periodic metric snapshots on the event plane "
                         "for the fleet aggregator")
    ap.add_argument("--obs-interval-s", type=float, default=1.0,
                    help="metric-snapshot publish interval")
    ap.add_argument("--role", default="aggregated",
                    choices=["aggregated", "prefill", "decode"])
    ap.add_argument("--dist-init-addr", default=None)
    ap.add_argument("--nnodes", type=int, default=1)
    ap.add_argument("--local-cpu-devices", type=int, default=None)
    ap.add_argument(
        "--max-local-prefill-length", type=int, default=50,
        help="decode role: prefills longer than this go to the prefill fleet",
    )
    return ap


def _refuse_unported(args: argparse.Namespace) -> None:
    """Raise on the first flag value the port does not serve, naming the
    ``ROADMAP.md`` item that brings it. Engine settings outside the slice
    (ring prefill) are refused by ``build_engine`` the same way."""
    refusals = [
        (args.model_path is not None, "--model-path (checkpoints)", "A7"),
        ((args.tokenizer or "").endswith(".gguf"), "--tokenizer *.gguf", "A7"),
        (max(args.tp, args.dp, args.sp, args.pp) > 1, "--tp/--dp/--sp/--pp > 1", "A12"),
        (args.nnodes > 1 or args.dist_init_addr is not None
         or args.local_cpu_devices is not None,
         "multi-host (--nnodes, --dist-init-addr, --local-cpu-devices)", "A12"),
    ]
    for refused, what, item in refusals:
        if refused:
            raise ValueError(f"{what} is not ported yet (ROADMAP.md {item})")


def _overrides(args: argparse.Namespace) -> dict[str, Any]:
    return {
        k: v
        for k, v in {
            "num_kv_blocks": args.num_kv_blocks,
            "block_size": args.block_size,
            "max_num_seqs": args.max_num_seqs,
            "max_model_len": args.max_model_len,
            "ring_prefill_threshold": args.ring_prefill_threshold,
            "scheduling": args.scheduling,
            "prefill_chunk": args.prefill_chunk,
            "max_num_batched_tokens": args.max_num_batched_tokens,
            "spec_decode": args.spec_decode,
            "spec_k": args.spec_k,
            "spec_device_draft": args.spec_device_draft,
            "megastep_k": args.megastep_k,
            "kv_dtype": args.kv_dtype,
            "host_kv_blocks": args.host_kv_blocks,
            "disk_kv_dir": args.disk_kv_dir,
            "disk_kv_blocks": args.disk_kv_blocks,
            "async_exec": None if args.async_exec is None else args.async_exec == "on",
            "fair_scheduling": (
                None if args.fair_scheduling is None else args.fair_scheduling == "on"
            ),
            "fair_quantum": args.fair_quantum,
            "max_waiting": args.max_waiting,
        }.items()
        if v is not None
    }


def main(argv: list[str] | None = None) -> None:
    args = _parser().parse_args(argv)
    _refuse_unported(args)
    overrides = _overrides(args)
    # Before joining the fleet.
    check_slice(*engine_configs(args.preset, overrides, args.moe_dispatch))

    @dynamo_worker()
    async def entry(runtime: DistributedRuntime) -> None:
        await run_torch_worker(
            runtime,
            model_name=args.model_name,
            preset=args.preset,
            namespace=args.namespace,
            component=args.component,
            engine_overrides=overrides,
            tokenizer=args.tokenizer or "byte",
            seed=args.seed,
            role=args.role,
            disagg_config=DisaggConfig(max_local_prefill_length=args.max_local_prefill_length),
            quant=args.quant,
            device=args.device,
            obs_publish=args.obs_publish == "on",
            obs_interval_s=args.obs_interval_s,
            moe_dispatch=args.moe_dispatch,
        )

    entry()


if __name__ == "__main__":
    main()
