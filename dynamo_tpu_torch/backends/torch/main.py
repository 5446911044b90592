"""The PyTorch backend worker: the port's engine wired into the runtime.

``python -m dynamo_tpu_torch.backends.torch --model-name llama3-8b
--preset llama3-8b`` starts a worker process shaped like the JAX
package's (``dynamo_tpu/backends/jax/main.py``), in its aggregated role:
connect to the control-plane store named by ``DYN_STORE_ADDRESS``, build
the engine on the card, publish KV events, load metrics and metric
snapshots, serve ``/health`` and ``/metrics`` on its status server,
register the model card and serve the ``generate`` endpoint over the TCP
data plane. Its wire is the JAX worker's, so the port's frontend and KV
router (``python -m dynamo_tpu_torch.frontend``) and the JAX package's
route to it as to a JAX worker.

:func:`build_engine` is the in-process entry point the worker wraps.
The CLI takes the JAX worker's flags, less the tuning values of features
it refuses (``--node-rank``, ``--max-local-prefill-length``), which
argparse rejects; a value the port does not serve yet raises a
``ValueError`` naming the ``ROADMAP.md`` item that brings it.
``--spec-decode ngram --spec-k 4 [--spec-device-draft]`` turns on n-gram
speculative decoding, drafted on the host or on the card.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
from typing import Any, AsyncIterator

from dynamo_tpu_torch import tracing
from dynamo_tpu_torch.engine.config import PRESETS, EngineConfig, ModelConfig, tiny_engine
from dynamo_tpu_torch.engine.core import EngineCore, check_slice, resolve_device
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.engine.model import init_params_quantized
from dynamo_tpu_torch.llm.discovery import register_llm
from dynamo_tpu_torch.llm.kv_router.publisher import KvEventPublisher, WorkerMetricsPublisher
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard, ModelRuntimeConfig
from dynamo_tpu_torch.obs.slo import PhaseScanner
from dynamo_tpu_torch.obs.snapshot import SnapshotPublisher
from dynamo_tpu_torch.ops import ragged_attention
from dynamo_tpu_torch.runtime import Context, DistributedRuntime
from dynamo_tpu_torch.runtime.status_server import (
    bind_fair_queue_gauges,
    bind_kv_cache_gauges,
    bind_kv_pool_gauges,
    bind_scheduler_gauges,
    bind_spec_gauges,
    bind_store_gauges,
)
from dynamo_tpu_torch.runtime.worker import dynamo_worker

log = logging.getLogger("dynamo_tpu_torch.backends.torch")


def engine_configs(
    preset: str, engine_overrides: dict[str, Any] | None = None
) -> tuple[ModelConfig, EngineConfig]:
    """The preset's model config and its engine config with the overrides:
    the tiny presets use the tiny engine shape, every other preset the
    ``EngineConfig`` defaults."""
    overrides = dict(engine_overrides or {})
    if preset in ("tiny", "tiny-moe"):
        return PRESETS[preset](), tiny_engine(**overrides)
    return PRESETS[preset](), EngineConfig(**overrides)


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
    block allocator's KV events.
    """
    dev = resolve_device(device)
    model_cfg, engine_cfg = engine_configs(preset, engine_overrides)
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
                    on_stored, on_removed) -> tuple[EngineCore, TorchEngine, int]:
    core, engine = build_engine(
        preset, engine_overrides, seed=seed, eos_token_ids=eos, device=device,
        params=params, quant=quant, on_stored=on_stored, on_removed=on_removed,
    )
    return core, engine, core.warm_up()


async def run_torch_worker(
    runtime: DistributedRuntime,
    model_name: str = "tiny",
    preset: str = "tiny",
    namespace: str = "dynamo",
    component: str = "backend",
    engine_overrides: dict[str, Any] | None = None,
    tokenizer: str = "byte",
    seed: int = 0,
    served_event: asyncio.Event | None = None,
    core_out: list | None = None,
    quant: str | None = None,
    device="cuda",
    params: dict | None = None,
    obs_publish: bool = True,
    obs_interval_s: float = 1.0,
) -> None:
    """Serve one aggregated worker until the runtime shuts down.

    The aggregated path of the JAX package's ``run_jax_worker``: KV events
    hop from the engine thread onto the loop, a graceful drain retracts
    the published inventory, load metrics are published every 0.5 s, the
    core's scheduler, speculation, KV-cache, fair-queue and KV-pool
    counters are gauges on the status server (when the runtime has one)
    and, with ``obs_publish``, metric snapshots every ``obs_interval_s``;
    the model card is registered only once the engine is built and has
    run its warm-up forwards, one of every shape it serves (off the loop,
    so the store lease's keepalive keeps running through the weights'
    draw, the kernels' build and the first forwards).
    """
    worker_id = runtime.primary_lease_id
    kv_pub = KvEventPublisher(runtime.store, namespace, component, worker_id)
    loop = asyncio.get_running_loop()

    # KV events fire on the engine thread (core.step under to_thread); the
    # publisher's bounded buffer lives on the loop.
    def on_stored(hashes: list[int], parent: int | None) -> None:
        loop.call_soon_threadsafe(kv_pub.stored_nowait, list(hashes), parent)

    def on_removed(hashes: list[int]) -> None:
        loop.call_soon_threadsafe(kv_pub.removed_nowait, list(hashes))

    eos = await asyncio.to_thread(_eos_for, tokenizer)
    core, engine, warm_up_forwards = await asyncio.to_thread(
        _build_and_warm, preset, engine_overrides, seed, eos, quant, device, params,
        on_stored, on_removed,
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

    # Gauges on this worker's /metrics, read from the live core at scrape
    # time, as the JAX worker binds them (the disaggregation gauges wait
    # for the roles, ROADMAP.md A10).
    bind_store_gauges(runtime.status, runtime.store)
    bind_scheduler_gauges(runtime.status, core.scheduler_stats)
    bind_spec_gauges(runtime.status, core.spec_decode_stats)
    bind_kv_cache_gauges(runtime.status, core.kv_cache_stats)
    bind_fair_queue_gauges(runtime.status, core.fair_queue_stats)
    bind_kv_pool_gauges(runtime.status, kv_pub.stats)

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
            "kv_pool": kv_pub.stats,
        }
        snap_pub.tenant_source = core.fair_queue_stats
        collector = tracing.get_collector()
        snap_pub.phase_source = collector.phase_totals
        snap_pub.request_source = PhaseScanner(collector).scan
        await snap_pub.start()

        async def _retire_snapshot() -> None:
            await snap_pub.retire(timeout=5.0)

        runtime.on_drain.append(_retire_snapshot)

    endpoint = runtime.namespace(namespace).component(component).endpoint("generate")

    async def handler(request: Any, context: Context) -> AsyncIterator[Any]:
        if (request.get("mm") or {}).get("images"):
            raise ValueError("multimodal requests are not ported yet (ROADMAP.md A11)")
        # A router's peer_prefix hint is ignored: the prompt is recomputed
        # until peer KV pulls are ported (ROADMAP.md A10).
        async for out in engine.generate(request, context):
            yield out

    await endpoint.serve(handler)
    await register_llm(endpoint, _model_card(model_name, tokenizer, core))
    log.info(
        "torch aggregated worker %d serving model %r (preset %s, %d kv blocks, %s)",
        worker_id, model_name, preset, core.engine.num_kv_blocks, core.device,
    )
    if served_event is not None:
        served_event.set()
    try:
        await runtime.wait_for_shutdown()
    finally:
        # The engine's counters over the worker's life, one JSON object:
        # the launches of each K1 kernel include the warm-up's forwards.
        stats = {**core.scheduler_stats(), "warm_up_forwards": warm_up_forwards,
                 "kernel_launches": ragged_attention.kernel_launches}
        log.info("torch worker %d stopping: %s", worker_id, json.dumps(stats))


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
    ap.add_argument("--component", default=None, help="defaults to 'backend'")
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
    ap.add_argument("--kv-dtype", default=None, choices=["bf16", "int8"])
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
    return ap


def _refuse_unported(args: argparse.Namespace) -> None:
    """Raise on the first flag value the port does not serve, naming the
    ``ROADMAP.md`` item that brings it. Engine settings outside the slice
    (host and disk KV tiers, ring prefill, MoE presets) are refused by
    ``build_engine`` the same way."""
    refusals = [
        (args.model_path is not None, "--model-path (checkpoints)", "A7"),
        ((args.tokenizer or "").endswith(".gguf"), "--tokenizer *.gguf", "A7"),
        (args.moe_dispatch is not None, "--moe-dispatch", "A11"),
        (args.role != "aggregated", f"--role {args.role}", "A10"),
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
    check_slice(*engine_configs(args.preset, overrides))  # before joining the fleet

    @dynamo_worker()
    async def entry(runtime: DistributedRuntime) -> None:
        await run_torch_worker(
            runtime,
            model_name=args.model_name,
            preset=args.preset,
            namespace=args.namespace,
            component=args.component or "backend",
            engine_overrides=overrides,
            tokenizer=args.tokenizer or "byte",
            seed=args.seed,
            quant=args.quant,
            device=args.device,
            obs_publish=args.obs_publish == "on",
            obs_interval_s=args.obs_interval_s,
        )

    entry()


if __name__ == "__main__":
    main()
