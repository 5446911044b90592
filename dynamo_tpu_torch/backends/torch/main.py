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
(``--moe-dispatch replicated|alltoall`` is taken as the JAX worker takes
it: on one device both values are the local dispatch, over ``--tp`` ranks
the experts split over them, in either expert-parallel mode). ``--model-path DIR`` serves a Hugging
Face llama or qwen2 checkpoint directory in place of a preset's random
weights (``engine/loader.py``; ``--quant int8`` quantizes it as it
loads), with the directory's tokenizer unless ``--tokenizer`` names
another; ``--tokenizer *.gguf`` serves a GGUF file's tokenizer.

``--role prefill`` and ``--role decode`` split a request as the JAX
worker does (decode first): the decode worker queues a long prompt's
prefill on the store's ``prefill:{namespace}`` work queue
(``--max-local-prefill-length``), a prefill worker runs it and holds the
blocks, and the decode worker pulls them over ``kv_transfer``, streamed
chunk by chunk while the prefill runs, and decodes on. ``--host-kv-blocks``
and ``--disk-kv-dir`` add the host and disk KV tiers.

:func:`build_engine` is the in-process entry point the worker wraps.
The CLI takes the JAX worker's flags; a value the port does not serve yet
raises a ``ValueError`` naming the ``ROADMAP.md`` item that brings it.
``--spec-decode ngram --spec-k 4 [--spec-device-draft]`` turns on n-gram
speculative decoding, drafted on the host or on the card.

``--tp N`` serves one model over N ranks, one process each, ``--dp N`` over
N replicas that split each decode batch's lanes (with ``--tp``: dp x tp
ranks), ``--pp N`` over N pipeline stages (exclusive with the other
two, and with ``--nnodes``), and ``--sp N`` over N replicas that prefill a
long prompt round a ring, each rank its chunk (exclusive with the other
three, and with ``--nnodes``): local rank 0 of every node starts that node's
other ranks, all join one process group (``--dist-init-addr``,
``--nnodes``, ``--node-rank`` across nodes), rank 0 serves and the others
replay its steps (``backends/torch/multihost.py``). On one node such a
worker serves every role, ``kv_fetch``, peer pulls and embeddings, its
pages gathered to and scattered from rank 0 whole; across nodes it keeps
the JAX worker's refusals (the aggregated role only, no embeddings, no
peer page serving, no held-block expiry). A rank takes
``cuda:{local rank}``; ``--tp-devices`` lists the node's ranks' devices
instead, whatever the axes (``cuda:0,cuda:0`` shares one card, the
collectives then going through host memory over gloo) and
``--local-cpu-devices`` or ``--device cpu`` runs them on the CPU.
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import json
import logging
import math
import time
import uuid
from typing import Any, AsyncIterator

import msgpack
import numpy as np
import torch

from dynamo_tpu_torch import knobs, tracing
from dynamo_tpu_torch.engine.config import PRESETS, EngineConfig, ModelConfig, tiny_engine
from dynamo_tpu_torch.engine.core import (
    EngineCore,
    check_pp,
    check_slice,
    resolve_device,
)
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.engine.loader import config_from_hf, load_hf_llama
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
from dynamo_tpu_torch.ops.ring_attention import SPMesh
from dynamo_tpu_torch.parallel.pipeline import PPMesh, stage_span
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
    preset: str | None, engine_overrides: dict[str, Any] | None = None,
    moe_dispatch: str | None = None, model_path: str | None = None,
) -> tuple[ModelConfig, EngineConfig]:
    """The model config and the engine config with the overrides. The
    model is the preset's or, with ``preset=None``, the checkpoint's at
    ``model_path`` (its ``config.json``): one of the two, never both. The
    tiny presets use the tiny engine shape; a checkpoint and every other
    preset the ``EngineConfig`` defaults. ``moe_dispatch`` sets a MoE
    model's dispatch mode and is refused for a dense one, as the JAX
    worker refuses it."""
    if (preset is None) == (model_path is None):
        raise ValueError(f"name a preset or a checkpoint, not both or neither "
                         f"(preset {preset!r}, model_path {model_path!r})")
    if model_path is None:
        model_cfg, source = PRESETS[preset](), f"preset {preset!r}"
    else:
        model_cfg, source = config_from_hf(model_path), f"checkpoint {model_path!r}"
    if moe_dispatch is not None:
        if not model_cfg.is_moe:
            raise ValueError(f"--moe-dispatch set but {source} is dense")
        model_cfg = dataclasses.replace(model_cfg, moe_dispatch=moe_dispatch)
    overrides = dict(engine_overrides or {})
    if preset in ("tiny", "tiny-moe"):
        return model_cfg, tiny_engine(**overrides)
    return model_cfg, EngineConfig(**overrides)


def _pp_prefill_buckets(
    prefill_buckets: tuple[int, ...], pp: int, block_size: int
) -> tuple[int, ...]:
    """Prefill buckets usable under ``--pp`` (the JAX worker's): every
    bucket must split into pp microbatch groups (EngineCore checks). Keeps
    the divisible subset; when none is left, one bucket divisible by both
    pp and block_size, near the largest asked for."""
    kept = tuple(b for b in prefill_buckets if b % pp == 0)
    if kept:
        return kept
    step = math.lcm(pp, block_size)
    return (step * max(1, prefill_buckets[-1] // step),)


def _split_widths(engine_cfg: EngineConfig, n: int) -> EngineConfig:
    """``engine_cfg`` with the decode widths that split into ``n`` lane
    groups (dp lanes or pp microbatches), as the JAX worker trims them:
    the divisible subset, else one width near the widest."""
    buckets = tuple(b for b in engine_cfg.decode_buckets if b % n == 0)
    if buckets == engine_cfg.decode_buckets:
        return engine_cfg
    return dataclasses.replace(
        engine_cfg, decode_buckets=buckets or (n * max(1, engine_cfg.decode_buckets[-1] // n),))


def check_pp_split(model_cfg: ModelConfig, pp: int) -> None:
    """The JAX worker's CLI-pointed errors of a ``--pp`` that does not
    divide the layers or the vocabulary (raised before any rank starts)."""
    if model_cfg.num_layers % pp:
        raise ValueError(
            f"--pp {pp} must divide the model's num_layers={model_cfg.num_layers} "
            "(layers stage evenly over the pp mesh); pick a pp that divides the "
            "layer count"
        )
    if model_cfg.vocab_size % pp:
        raise ValueError(
            f"--pp {pp} must divide the model's vocab_size={model_cfg.vocab_size} "
            "(the lm head splits over stages)"
        )


def build_engine(
    preset: str | None,
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
    model_path: str | None = None,
    mesh=None,
    tp: int = 1,
    core_cls=None,
    core_kwargs: dict[str, Any] | None = None,
    dp: int = 1,
    pp: int = 1,
    pp_mesh=None,
    sp: int = 1,
    sp_mesh=None,
) -> tuple[EngineCore, TorchEngine]:
    """Construct (EngineCore, TorchEngine) for a model preset or a
    checkpoint.

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
    (:func:`engine_configs`); its int8 weights are refused. With
    ``preset=None``, ``model_path`` names a Hugging Face checkpoint
    directory: its weights are loaded onto the device
    (``loader.load_hf_llama``, int8 with ``quant="int8"``) and the engine
    shape is ``EngineConfig`` with the overrides.

    ``mesh`` (``parallel.sharding.Mesh``) builds this process's rank of a
    tensor- and data-parallel engine on the mesh's device for it: a
    checkpoint streams only the rank's tp shard (``load_hf_llama(..., tp,
    rank)``), random weights are drawn whole and kept sharded; each dp rank
    holds a replica. ``pp_mesh`` (``parallel.pipeline.PPMesh``) builds this
    process's stage of a pipeline instead: a checkpoint streams, and
    random weights keep, only the stage's layers. ``sp_mesh``
    (``ops.ring_attention.SPMesh``) builds this process's rank of a
    sequence-parallel engine: a whole replica whose long prompts prefill
    round the ring of the sp ranks; without an explicit
    ``ring_prefill_threshold`` every prompt that fills at least half the
    largest bucket takes the ring (the JAX worker's default). ``tp``,
    ``dp``, ``pp`` or ``sp`` above 1 without a mesh builds one over the
    process group (``make_mesh``, ``make_pp_mesh``,
    ``sequence_parallel_mesh``). As the JAX worker does, pp excludes tp,
    dp and sp, sp excludes tp and dp, a pp that does not divide the
    layers or the vocabulary raises, and the prefill buckets and decode
    widths are trimmed to those that split into pp microbatches (the
    decode widths into dp lanes).
    ``core_cls`` substitutes the engine-core class (the lockstep leader,
    ``backends/torch/multihost.LeaderCore``) and ``core_kwargs`` adds to
    its arguments.
    """
    if pp_mesh is not None:
        if pp not in (1, pp_mesh.pp):
            raise ValueError(f"pp={pp} but the pp mesh has pp={pp_mesh.pp}")
        pp = pp_mesh.pp
    if mesh is not None:
        if (tp, dp) != (1, 1) and (tp, dp) != (mesh.tp, mesh.dp):
            raise ValueError(f"dp x tp = {dp}x{tp} but the mesh is {mesh.dp}x{mesh.tp}")
        tp, dp = mesh.tp, mesh.dp
    if sp_mesh is not None:
        if sp not in (1, sp_mesh.sp):
            raise ValueError(f"sp={sp} but the sp mesh has sp={sp_mesh.sp}")
        sp = sp_mesh.sp
    if pp > 1 and (tp * dp > 1 or mesh is not None or sp > 1):
        raise ValueError("--pp is mutually exclusive with --tp/--dp/--sp for now")
    if sp > 1 and (tp * dp > 1 or mesh is not None):
        raise ValueError("--sp is mutually exclusive with --tp/--dp for now")
    model_cfg, engine_cfg = engine_configs(preset, engine_overrides, moe_dispatch, model_path)
    if sp > 1 and engine_cfg.ring_prefill_threshold <= 0:
        # --sp without an explicit threshold: every prompt that fills at
        # least half the largest bucket goes round the ring.
        engine_cfg = dataclasses.replace(engine_cfg, ring_prefill_threshold=max(
            engine_cfg.block_size, engine_cfg.prefill_buckets[-1] // 2))
    if pp > 1:
        check_pp_split(model_cfg, pp)
        pbuckets = _pp_prefill_buckets(engine_cfg.prefill_buckets, pp, engine_cfg.block_size)
        engine_cfg = _split_widths(dataclasses.replace(engine_cfg, prefill_buckets=pbuckets), pp)
    engine_cfg = _split_widths(engine_cfg, dp)
    if mesh is None and tp * dp > 1:
        from dynamo_tpu_torch.parallel.sharding import make_mesh

        mesh = make_mesh(dp=dp, tp=tp)
    if pp_mesh is None and pp > 1:
        from dynamo_tpu_torch.parallel.pipeline import make_pp_mesh

        pp_mesh = make_pp_mesh(pp)
    if sp_mesh is None and sp > 1:
        from dynamo_tpu_torch.ops.ring_attention import sequence_parallel_mesh

        sp_mesh = sequence_parallel_mesh(sp)
    ranked = mesh if tp * dp > 1 else pp_mesh if pp > 1 else sp_mesh if sp > 1 else None
    if ranked is not None:
        device = ranked.device
    dev = resolve_device(device)
    check_slice(model_cfg, engine_cfg, dev)  # before any weight is drawn or loaded
    if pp > 1:
        check_pp(model_cfg, engine_cfg, pp)
    rank = mesh.tp_rank if tp > 1 else None
    span = stage_span(model_cfg, pp, pp_mesh.stage) if pp > 1 else None
    if model_path is not None:
        if params is not None:
            raise ValueError("model_path loads the weights; pass params or model_path, not both")
        _, params = load_hf_llama(model_path, quant=quant, device=dev, tp=tp, rank=rank,
                                  layer_span=span)
    elif quant == "int8":
        if params is not None:
            raise ValueError("quant='int8' draws random weights; pass params or quant, not both")
        params = init_params_quantized(model_cfg, seed, dev, tp=tp, rank=rank, layer_span=span)
    elif quant:
        raise ValueError(f"unknown quantization {quant!r}")
    core = (core_cls or EngineCore)(
        model_cfg, engine_cfg, params=params, seed=seed,
        eos_token_ids=eos_token_ids, device=dev, mesh=mesh, pp_mesh=pp_mesh, sp_mesh=sp_mesh,
        on_stored=on_stored, on_removed=on_removed,
        on_tier_stored=on_tier_stored, on_tier_removed=on_tier_removed,
        **(core_kwargs or {}),
    )
    return core, TorchEngine(core)


def use_one_malloc_arena() -> bool:
    """Make every thread of this process allocate from glibc's main arena
    (``mallopt(M_ARENA_MAX, 1)``, what ``MALLOC_ARENA_MAX=1`` does at
    start). A worker builds, warms up and steps its engine on a thread of
    the event loop's executor (``asyncio.to_thread``); on an arena of its
    own, that thread's allocations made a llama3-8b warm-up (its CUDA
    graph captures) take far longer than the same warm-up on the main
    thread. Call it before the process starts a thread. Returns whether
    the C library took the setting (False where it has no ``mallopt``)."""
    import ctypes

    mallopt = getattr(ctypes.CDLL(None), "mallopt", None)
    m_arena_max = -8  # glibc's malloc.h
    return mallopt is not None and mallopt(m_arena_max, 1) == 1


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


def _mesh_name(mesh) -> str:
    """How a rank's log lines name its mesh ("" for one rank)."""
    if mesh is None:
        return ""
    if isinstance(mesh, PPMesh):
        return f"pp={mesh.pp}" if mesh.pp > 1 else ""
    if isinstance(mesh, SPMesh):
        return f"sp={mesh.sp}" if mesh.sp > 1 else ""
    return ", ".join(f"{a}={n}" for a, n in (("dp", mesh.dp), ("tp", mesh.tp)) if n > 1)


def _world(mesh) -> int:
    """The ranks of ``mesh`` (a dp x tp mesh, a pipeline, an sp group, or
    None: one)."""
    if mesh is None:
        return 1
    if isinstance(mesh, SPMesh):
        return mesh.sp
    return mesh.pp if isinstance(mesh, PPMesh) else mesh.dp * mesh.tp


def _build_and_warm(preset, engine_overrides, seed, eos, quant, device, params,
                    events, moe_dispatch=None, model_path=None, mesh=None,
                    core_cls=None, core_kwargs=None) -> tuple[EngineCore, TorchEngine, int]:
    """Build and warm up this process's engine; ``mesh`` is a dp x tp mesh,
    a pipeline's (``parallel.pipeline.PPMesh``) or an sp group's
    (``ops.ring_attention.SPMesh``)."""
    on_stored, on_removed, on_tier_stored, on_tier_removed = events
    t0 = time.perf_counter()
    pp_mesh = mesh if isinstance(mesh, PPMesh) else None
    sp_mesh = mesh if isinstance(mesh, SPMesh) else None
    core, engine = build_engine(
        preset, engine_overrides, seed=seed, eos_token_ids=eos, device=device,
        params=params, quant=quant, on_stored=on_stored, on_removed=on_removed,
        on_tier_stored=on_tier_stored, on_tier_removed=on_tier_removed,
        moe_dispatch=moe_dispatch, model_path=model_path,
        mesh=None if pp_mesh is not None or sp_mesh is not None else mesh, pp_mesh=pp_mesh,
        sp_mesh=sp_mesh, core_cls=core_cls, core_kwargs=core_kwargs,
    )
    t1 = time.perf_counter()
    if core.device.type == "cuda":
        # The weights' random draw and the warm-up's eager forwards leave
        # their temporaries reserved in the caching allocator: hand them
        # back, so that several workers fit on one card.
        torch.cuda.empty_cache()
    forwards = core.warm_up()
    if core.device.type == "cuda":
        torch.cuda.empty_cache()
    log.info("engine built in %.2f s (weights %s), warmed up in %.2f s%s",
             t1 - t0, "loaded from the checkpoint" if model_path is not None else
             "given" if params is not None else "drawn", time.perf_counter() - t1,
             f" (rank {mesh.rank} of {_mesh_name(mesh)})" if _world(mesh) > 1 else "")
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
            wire.KV_SHAPE: list(core._page_shape(wire=True)),
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
    preset: str | None = "tiny",
    namespace: str = "dynamo",
    component: str | None = None,
    engine_overrides: dict[str, Any] | None = None,
    tokenizer: str | None = None,
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
    model_path: str | None = None,
    mesh=None,
    parent_pid: int | None = None,
    nnodes: int = 1,
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
    keepalive keeps running). ``model_path`` with ``preset=None`` serves
    a checkpoint (:func:`build_engine`); an unset ``tokenizer`` is then
    the checkpoint directory's (byte-level, with a warning, when it has no
    tokenizer files), else ``"byte"``.

    With a ``mesh`` of more than one rank (a dp x tp
    ``parallel.sharding.Mesh``, a pipeline's ``parallel.pipeline.PPMesh``
    or an sp group's ``ops.ring_attention.SPMesh``) this process is one
    rank of a tensor-, data-, pipeline- or sequence-parallel worker: rank
    0 serves as above through a
    :class:`~dynamo_tpu_torch.backends.torch.multihost.LeaderCore`,
    publishing a step record before each step, and every other rank
    replays them (:func:`_serve_follower`), the page reads and imports
    and the embeddings among them; followers serve nothing. On one node
    such a worker serves every role, ``kv_fetch`` and peer pulls, and
    expires held blocks on the leader's clock. Across nodes (``nnodes``
    > 1) it keeps the JAX worker's refusals: the aggregated role only,
    ``held_block_ttl_s`` 0, no embeddings, no ``kv_fetch`` and no peer
    pulls. A follower started by its node's local rank 0 (``parent_pid``)
    stops once that process is gone.
    """
    if tokenizer is None:
        tokenizer = model_path if model_path is not None else "byte"
    if role not in ("aggregated", "prefill", "decode"):
        raise ValueError(f"unknown role {role!r}")
    if component is None:
        component = "prefill" if role == "prefill" else "backend"
    world = _world(mesh)
    core_cls = core_kwargs = None
    if nnodes > 1:
        # The JAX worker's refusals across nodes, with its messages.
        if role != "aggregated":
            raise ValueError("multi-host serving supports role=aggregated only")
        if (engine_overrides or {}).get("held_block_ttl_s", 0) != 0:
            raise ValueError("held_block_ttl_s must be 0 under multi-host")
        engine_overrides = dict(engine_overrides or {}, held_block_ttl_s=0)
    if world > 1:
        if mesh.rank != 0:
            return await _serve_follower(
                runtime, preset, namespace, component, engine_overrides, tokenizer, seed,
                quant, params, moe_dispatch, model_path, mesh, served_event, core_out,
                parent_pid,
            )
        from dynamo_tpu_torch.backends.torch.multihost import LeaderCore

        core_cls, core_kwargs = LeaderCore, {
            "publish": _step_publisher(runtime, namespace, component), "multihost": nnodes > 1}
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
        (on_stored, on_removed, on_tier_stored, on_tier_removed), moe_dispatch, model_path,
        mesh, core_cls, core_kwargs,
    )
    if core_out is not None:
        core_out.append(core)
    if world > 1:
        from dynamo_tpu_torch.backends.torch.multihost import barrier_name

        # A staged job (a page read or import, an embedding) steps the loop.
        core.wake = lambda: loop.call_soon_threadsafe(engine.wake)
        from dynamo_tpu_torch.runtime.barrier import LeaderBarrier

        # No step record may go out before every follower subscribes.
        await LeaderBarrier(
            runtime.store, barrier_name(namespace, component), world - 1
        ).sync({"model": model_name}, timeout=600.0)
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
    # roles also pull them (a prefill worker serves but never pulls). A
    # worker across nodes does neither, as the JAX one.
    peer_kv: PeerKvClient | None = None
    if nnodes == 1:
        await _serve_kv_fetch(runtime, namespace, component, core)
    if role != "prefill" and nnodes == 1:
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
            if (hint and peer_kv is not None and hint.get("worker_id") != worker_id
                    and request.get("token_ids")):
                await peer_kv.pull_prefix(hint, list(request["token_ids"]))
            async for out in engine.generate(request, context):
                yield out

    if role != "prefill":
        await endpoint.serve(handler)
        await register_llm(endpoint, _model_card(model_name, tokenizer, core))
    log.info(
        "torch %s worker %d serving model %r (%s, %d kv blocks, %s%s)",
        role, worker_id, model_name,
        f"checkpoint {model_path}" if model_path is not None else f"preset {preset}",
        core.engine.num_kv_blocks, core.device,
        f", {_mesh_name(mesh)} over {mesh.backend}" if world > 1 else "",
    )
    if served_event is not None:
        served_event.set()
    try:
        await runtime.wait_for_shutdown()
    finally:
        if consumer is not None:
            consumer.cancel()
        if world > 1:
            core.close()  # a page read or import still staged fails, not hangs
        # The engine's counters over the worker's life, one JSON object:
        # the launches of each K1 kernel include the warm-up's forwards.
        stats = {**_rank_stats(core, warm_up_forwards),
                 "role": role, "transfer": core.transfer_stats,
                 "kv_pool": _kv_pool_stats(), "disagg": _disagg_stats()}
        if core.offload is not None:
            stats["tiers"] = core.tier_stats()
        log.info("torch worker %d stopping: %s", worker_id, json.dumps(stats))


def _rank_stats(core: EngineCore, warm_up_forwards: int) -> dict:
    """The engine's counters over the process's life: the scheduler's, the
    warm-up's forwards, each K1 kernel's launches (warm-up included), the
    collectives by kind, the page collectives' seconds and, on a card, the
    process's peak device memory."""
    from dynamo_tpu_torch.parallel import comm

    stats = {**core.scheduler_stats(), **core.parallel_stats(),
             "warm_up_forwards": warm_up_forwards,
             "kernel_launches": dict(ragged_attention.kernel_launches),
             "collectives": dict(comm.calls), "page_collective_s": dict(comm.seconds)}
    if core.device.type == "cuda":
        stats["peak_memory_bytes"] = torch.cuda.max_memory_allocated(core.device)
    return stats


def _step_publisher(runtime, namespace: str, component: str):
    """The lockstep leader's ``publish(record)``: called on the engine
    thread, it hands each record to the loop, which publishes them in
    order on the store's step subject. A failed publish shuts the worker
    down: the followers have lost lockstep."""
    from dynamo_tpu_torch.backends.torch.multihost import steps_subject

    loop = asyncio.get_running_loop()
    subject = steps_subject(namespace, component)

    def _failed(task: asyncio.Task) -> None:
        if task.cancelled() or task.exception() is None:
            return
        log.error("step-record publish failed; followers lose lockstep",
                  exc_info=task.exception())
        runtime.signal_shutdown()

    def publish(record: dict) -> None:
        payload = msgpack.packb(record, use_bin_type=True)

        def _send() -> None:
            loop.create_task(runtime.store.publish(subject, payload)).add_done_callback(_failed)

        loop.call_soon_threadsafe(_send)

    return publish


async def _serve_follower(runtime, preset, namespace, component, engine_overrides, tokenizer,
                          seed, quant, params, moe_dispatch, model_path, mesh, served_event,
                          core_out, parent_pid=None) -> None:
    """A follower rank of a worker of more than one rank: build and warm up
    its shard (or stage, or replica) of the engine (its forwards pair with the leader's warm-up
    collective for collective), then replay the leader's step records
    until the runtime shuts down; a follower that fails raises. It
    serves no endpoint and logs its counters at exit, as the leader."""
    from dynamo_tpu_torch.backends.torch.multihost import run_follower

    eos = await asyncio.to_thread(_eos_for, tokenizer)
    core, _engine, warm_up_forwards = await asyncio.to_thread(
        _build_and_warm, preset, engine_overrides, seed, eos, quant, mesh.device, params,
        (None, None, None, None), moe_dispatch, model_path, mesh,
    )
    if core_out is not None:
        core_out.append(core)
    ready = asyncio.Event()
    follower = asyncio.create_task(
        run_follower(runtime, core, namespace, component, _world(mesh), ready_event=ready)
    )
    shutdown = asyncio.create_task(runtime.wait_for_shutdown())
    if parent_pid is not None:
        spawn_logged(_watch_parent(runtime, parent_pid), name="watch-parent", logger=log)
    try:
        waiter = asyncio.create_task(ready.wait())
        await asyncio.wait({waiter, follower}, return_when=asyncio.FIRST_COMPLETED)
        waiter.cancel()
        if ready.is_set():
            log.info("torch follower rank %d/%d on %s replaying the leader's steps",
                     mesh.rank, _world(mesh), mesh.device)
            if served_event is not None:
                served_event.set()
            await asyncio.wait({follower, shutdown}, return_when=asyncio.FIRST_COMPLETED)
        if follower.done() and not follower.cancelled() and follower.exception() is not None:
            log.error("follower rank %d failed", mesh.rank, exc_info=follower.exception())
            raise follower.exception()
    finally:
        follower.cancel()
        shutdown.cancel()
        log.info("torch follower rank %d stopping: %s", mesh.rank,
                 json.dumps(_rank_stats(core, warm_up_forwards)))


async def _watch_parent(runtime, pid: int) -> None:
    """Shut this process down once its parent ``pid`` is gone (a follower
    whose node's local rank 0 was killed would otherwise wait on the store
    for records that never come)."""
    import os

    while os.getppid() == pid:
        await asyncio.sleep(1.0)
    log.error("the process that started this rank (pid %d) is gone; stopping", pid)
    runtime.signal_shutdown()


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
            # Off the loop: a lockstep leader's step blocks on the loop's
            # publishing its record, and this takes the step lock.
            descs = await asyncio.to_thread(core.export_descriptors, rid, start=ws, count=wc)
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
                await asyncio.to_thread(core.release_held, rid)

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
                    help="'byte', an HF tokenizer path or a .gguf file (default: "
                         "the --model-path directory, else byte)")
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
    ap.add_argument("--model-path", default=None,
                    help="an HF checkpoint directory (llama or qwen2 family, "
                         "safetensors or pytorch_model*.bin); overrides --preset "
                         "and defaults the tokenizer to it")
    ap.add_argument("--moe-dispatch", default=None, choices=["replicated", "alltoall"])
    ap.add_argument("--num-layers", type=int, default=None,
                    help="serve the preset's first N layers (a depth cut of its random "
                         "weights, so that a model fits one card; not with --model-path)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel degree: one process per rank, heads and MLP "
                         "columns split over the ranks (local rank 0 of each node starts "
                         "that node's other ranks)")
    ap.add_argument("--tp-devices", default=None,
                    help="this node's ranks' devices (of --tp, --dp or --pp), comma-separated "
                         "in local rank order (e.g. cuda:0,cuda:0: two ranks sharing a card, "
                         "collectives over gloo through host memory); default one card per "
                         "rank")
    ap.add_argument("--dp", type=int, default=1,
                    help="in-engine data-parallel degree: one process per rank, each a "
                         "replica; a decode batch's lanes split over the ranks")
    ap.add_argument("--sp", type=int, default=1,
                    help="sequence-parallel degree: one process per rank, each a replica; "
                         "long prompts prefill round the ring of the ranks (exclusive with "
                         "--tp/--dp/--pp)")
    ap.add_argument("--ring-prefill-threshold", type=int, default=None,
                    help="prompt tokens from which an --sp worker prefills round the ring "
                         "(default: half the largest prefill bucket)")
    ap.add_argument("--pp", type=int, default=1,
                    help="pipeline-parallel degree: one process per stage, the layers "
                         "staged over them (GPipe prefill waves, wavefront decode chains; "
                         "exclusive with --tp/--dp/--sp)")
    ap.add_argument("--obs-publish", default="on", choices=["on", "off"],
                    help="publish periodic metric snapshots on the event plane "
                         "for the fleet aggregator")
    ap.add_argument("--obs-interval-s", type=float, default=1.0,
                    help="metric-snapshot publish interval")
    ap.add_argument("--role", default="aggregated",
                    choices=["aggregated", "prefill", "decode"])
    ap.add_argument("--dist-init-addr", default=None,
                    help="host:port of rank 0's process-group coordinator (required with "
                         "--nnodes > 1; one node picks a free local port)")
    ap.add_argument("--nnodes", type=int, default=1)
    ap.add_argument("--node-rank", type=int, default=0)
    ap.add_argument("--local-cpu-devices", type=int, default=None,
                    help="run this node's N ranks on the CPU (gloo)")
    ap.add_argument("--local-rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument(
        "--max-local-prefill-length", type=int, default=50,
        help="decode role: prefills longer than this go to the prefill fleet",
    )
    return ap


def _cli_world(args: argparse.Namespace) -> int:
    """The ranks of a worker's ``--dp x --tp``, ``--pp`` or ``--sp`` (each of
    the last two excludes the others)."""
    return args.dp * args.tp * args.pp * args.sp


def _refuse_unported(args: argparse.Namespace) -> None:
    """Raise on the first flag value the port does not serve, naming the
    ``ROADMAP.md`` item that brings it, and on the combinations the JAX
    worker refuses, with its messages. A MoE preset under ``--pp`` is
    refused by ``build_engine`` (``check_pp``), with JAX's message."""
    if args.pp > 1 and (args.tp * args.dp > 1 or args.sp > 1):
        raise ValueError("--pp is mutually exclusive with --tp/--dp/--sp for now")
    if args.sp > 1 and args.tp * args.dp > 1:
        raise ValueError("--sp is mutually exclusive with --tp/--dp for now")
    many = _cli_world(args) > 1
    if args.nnodes > 1 and args.role != "aggregated":
        raise ValueError("multi-host serving supports role=aggregated only")
    if args.sp > 1 and args.nnodes > 1:
        raise ValueError("--sp (ring prefill) is not supported under --nnodes yet")
    if args.pp > 1 and args.nnodes > 1:
        raise ValueError("--pp (pipeline parallel) is not supported under --nnodes yet")
    if args.nnodes > 1 and not many:
        raise ValueError("--nnodes > 1 splits the ranks of --tp or --dp over the nodes; "
                         "set --tp or --dp")
    if args.local_cpu_devices is not None and not many:
        raise ValueError("--local-cpu-devices places the CPU ranks of --tp, --dp, --pp or "
                         "--sp; set one")


def rank_layout(args: argparse.Namespace) -> tuple[int, list[str]]:
    """(this process's global rank, every rank's device in rank order) of a
    worker of ``dp x tp``, ``pp`` or ``sp`` ranks. A node holds ``world / nnodes``
    ranks, laid out alike on every node: ``--tp-devices`` lists them
    (whatever the axes), ``--device cpu`` or ``--local-cpu-devices`` puts
    them on the CPU, else rank ``i`` of a node takes ``cuda:i`` and a node
    with fewer cards than ranks raises."""
    from dynamo_tpu_torch.parallel.sharding import default_devices

    world = _cli_world(args)
    if world % args.nnodes:
        raise ValueError(f"the {world} ranks of --dp x --tp x --pp x --sp must be a multiple "
                         f"of --nnodes {args.nnodes}")
    k = world // args.nnodes
    if not (0 <= args.node_rank < args.nnodes and 0 <= args.local_rank < k):
        raise ValueError(f"node rank {args.node_rank} / local rank {args.local_rank} outside "
                         f"{args.nnodes} nodes of {k} ranks")
    if args.local_cpu_devices is not None and args.local_cpu_devices != k:
        raise ValueError(f"--local-cpu-devices {args.local_cpu_devices} but a node holds "
                         f"{k} ranks of --dp x --tp x --pp x --sp {world}")
    if args.tp_devices:
        local = [d.strip() for d in args.tp_devices.split(",")]
        if len(local) != k:
            raise ValueError(f"--tp-devices names {len(local)} devices for {k} ranks per node")
    elif args.device == "cpu" or args.local_cpu_devices is not None:
        local = ["cpu"] * k
    else:
        local = [str(d) for d in default_devices(k)]
    return args.node_rank * k + args.local_rank, local * args.nnodes


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _start_local_ranks(argv: list[str], k: int, addr: str) -> list:
    """Local rank 0 of a node starts the node's other ranks: this command
    again, with ``--local-rank i`` and the coordinator's address; their
    status servers stay off (one per worker)."""
    import os
    import subprocess
    import sys

    env = dict(os.environ, DYN_SYSTEM_ENABLED="0")
    return [
        subprocess.Popen(
            [sys.executable, "-m", "dynamo_tpu_torch.backends.torch", *argv,
             "--local-rank", str(i), "--dist-init-addr", addr],
            env=env,
        )
        for i in range(1, k)
    ]


def _stop_local_ranks(procs: list) -> None:
    import signal
    import subprocess

    for proc in procs:
        if proc.poll() is None:
            proc.send_signal(signal.SIGINT)
    for proc in procs:
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:  # a rank that will not stop is killed
            proc.kill()
            proc.wait()


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


def cut_preset(preset: str | None, num_layers: int) -> None:
    """``--num-layers``: the preset's random weights cut to its first
    ``num_layers`` layers, for this process (a depth cut for one card;
    every rank's process parses the same arguments and cuts alike). A
    checkpoint refuses it."""
    base = PRESETS.get(preset)
    if base is None or not 1 <= num_layers <= base().num_layers:
        raise ValueError(f"--num-layers {num_layers} cuts a preset's layers, not those of "
                         f"{'a checkpoint' if preset is None else repr(preset)}")
    PRESETS[preset] = lambda: dataclasses.replace(base(), num_layers=num_layers)


def main(argv: list[str] | None = None) -> None:
    import sys

    use_one_malloc_arena()
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _parser().parse_args(argv)
    _refuse_unported(args)
    overrides = _overrides(args)
    preset = None if args.model_path is not None else args.preset  # --model-path replaces it
    # Before joining the fleet.
    if args.num_layers is not None:
        cut_preset(preset, args.num_layers)
    model_cfg, engine_cfg = engine_configs(preset, overrides, args.moe_dispatch, args.model_path)
    check_slice(model_cfg, engine_cfg, device="cpu" if args.local_cpu_devices else args.device)
    world = _cli_world(args)
    if world == 1:
        return _serve(args, overrides, preset, None)
    from dynamo_tpu_torch.ops.ring_attention import sequence_parallel_mesh
    from dynamo_tpu_torch.parallel import comm
    from dynamo_tpu_torch.parallel.multihost import init_multihost, shutdown_multihost
    from dynamo_tpu_torch.parallel.pipeline import make_pp_mesh
    from dynamo_tpu_torch.parallel.sharding import make_mesh, param_partition_specs

    param_partition_specs(model_cfg, args.tp)  # tp divides the heads and the MLP
    if args.pp > 1:
        check_pp_split(model_cfg, args.pp)
    rank, devices = rank_layout(args)
    k = world // args.nnodes
    backend = comm.choose_backend(devices, k)
    if args.nnodes > 1 and not args.dist_init_addr:
        raise ValueError("--nnodes > 1 requires --dist-init-addr")
    addr = args.dist_init_addr or f"127.0.0.1:{_free_port()}"
    local = _start_local_ranks(argv, k, addr) if args.local_rank == 0 else []
    try:
        init_multihost(addr, world, rank, backend)
        mesh = (make_pp_mesh(args.pp, devices=devices, rank=rank) if args.pp > 1 else
                sequence_parallel_mesh(args.sp, devices=devices, rank=rank) if args.sp > 1 else
                make_mesh(dp=args.dp, tp=args.tp, devices=devices, rank=rank,
                          nnodes=args.nnodes))
        _serve(args, overrides, preset, mesh)
    finally:
        _stop_local_ranks(local)
        shutdown_multihost()


def _serve(args: argparse.Namespace, overrides: dict[str, Any], preset: str | None,
           mesh) -> None:
    """Run this process's worker (or rank of one) until it shuts down."""
    import os


    @dynamo_worker()
    async def entry(runtime: DistributedRuntime) -> None:
        await run_torch_worker(
            runtime,
            model_name=args.model_name,
            preset=preset,
            namespace=args.namespace,
            component=args.component,
            engine_overrides=overrides,
            tokenizer=args.tokenizer,
            seed=args.seed,
            role=args.role,
            disagg_config=DisaggConfig(max_local_prefill_length=args.max_local_prefill_length),
            quant=args.quant,
            device=args.device,
            obs_publish=args.obs_publish == "on",
            obs_interval_s=args.obs_interval_s,
            moe_dispatch=args.moe_dispatch,
            model_path=args.model_path,
            mesh=mesh,
            parent_pid=os.getppid() if args.local_rank > 0 else None,
            nnodes=args.nnodes,
        )

    entry()


if __name__ == "__main__":
    main()
