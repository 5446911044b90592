"""The port's worker process against the JAX package's, on the tiny preset
and the CPU.

A torch worker behind the JAX store, frontend and router serves the same
chat completions as a JAX worker, byte for byte apart from each
response's ``id`` and ``created``; in a fleet with a JAX worker both serve;
under KV routing its KV events and load metrics are what the JAX side
reads. Behind the port's own store and data-plane client (the path of
``chip_smoke.py``) its greedy streams equal the in-process engine's. Its
core reports the JAX core's ``ForwardPassMetrics``, its facade files the
three request spans, a graceful drain retracts its KV inventory, and what
the port does not serve yet is refused by name.
"""

import asyncio
import dataclasses
import json
import re

import aiohttp
import jax
import numpy as np
import pytest

from dynamo_tpu.backends.jax.main import run_jax_worker
from dynamo_tpu.engine import EngineCore as JaxCore
from dynamo_tpu.engine import TpuEngine
from dynamo_tpu.frontend.main import run_frontend
from dynamo_tpu.llm.kv_router.protocols import ForwardPassMetrics as JaxMetrics
from dynamo_tpu.llm.kv_router.protocols import RouterEvent as JaxRouterEvent
from dynamo_tpu.runtime import DistributedRuntime as JaxRuntime
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu.runtime.store import StoreServer as JaxStoreServer
from dynamo_tpu.tokens import compute_seq_hashes as j_seq_hashes
from dynamo_tpu_torch import tracing
from dynamo_tpu_torch.backends.torch import main as worker_main
from dynamo_tpu_torch.backends.torch.main import build_engine, run_torch_worker
from dynamo_tpu_torch.engine.config import tiny_model
from dynamo_tpu_torch.engine.convert import params_from_numpy
from dynamo_tpu_torch.llm.kv_router.protocols import (
    RouterEvent,
    kv_events_subject,
    load_metrics_subject,
)
from dynamo_tpu_torch.llm.protocols.common import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.runtime import Context, DistributedRuntime, RuntimeConfig
from dynamo_tpu_torch.runtime import worker as runtime_worker
from dynamo_tpu_torch.runtime.status_server import SCHEDULER_GAUGES, SystemStatusServer
from dynamo_tpu_torch.runtime.store import StoreServer

pytestmark = [pytest.mark.e2e]

MODEL = "tinyport"
PROMPTS = ["hello torch worker", "the quick brown fox", "parity over the wire"]
_REFERENCE: dict = {}


def _torch_params(jax_core):
    """The JAX worker's weights, carried across to the port."""
    return params_from_numpy(
        jax.tree.map(np.asarray, jax_core.params), tiny_model(), device="cpu"
    )


class Fleet:
    """The JAX store and frontend with workers of the given kinds ("jax" or
    "torch"), started in order; a torch worker serves ``params`` when
    given, else the weights of the fleet's first JAX worker, else random
    weights from seed 0. Every worker's engine takes ``overrides``; with
    ``status`` a torch worker runs a status server, as
    ``DYN_SYSTEM_ENABLED`` makes the worker process do."""

    def __init__(self, kinds, router_mode="round_robin", params=None, overrides=None,
                 status=False):
        self.kinds = kinds
        self.router_mode = router_mode
        self.params = params
        self.overrides = overrides
        self.status = status
        self.store = JaxStoreServer()
        self.runtimes: list = []
        self.tasks: list[asyncio.Task] = []
        self.cores: list = []
        self.base_url = ""

    async def __aenter__(self) -> "Fleet":
        await self.store.start()
        for kind in self.kinds:
            served = asyncio.Event()
            if kind == "jax":
                rt = await JaxRuntime.create(self.store.address)
                coro = run_jax_worker(
                    rt, model_name=MODEL, preset="tiny", seed=0,
                    served_event=served, core_out=self.cores, obs_publish=False,
                    engine_overrides=self.overrides,
                )
            else:
                rt = await DistributedRuntime.create(self.store.address)
                if self.status:
                    rt.status = SystemStatusServer(host="127.0.0.1", port=0)
                    await rt.status.start()
                params = self.params
                if params is None and self.cores:
                    params = _torch_params(self.cores[0])
                coro = run_torch_worker(
                    rt, model_name=MODEL, preset="tiny", seed=0,
                    served_event=served, core_out=self.cores, device="cpu",
                    params=params, engine_overrides=self.overrides,
                )
            self.runtimes.append(rt)
            self.tasks.append(asyncio.create_task(coro))
            await asyncio.wait_for(served.wait(), 60)
        front = await JaxRuntime.create(self.store.address)
        self.runtimes.append(front)
        ready = asyncio.Event()
        services: list = []
        self.tasks.append(asyncio.create_task(run_frontend(
            front, http_host="127.0.0.1", http_port=0, router_mode=self.router_mode,
            ready_event=ready, service_out=services, fleet_obs=False,
        )))
        await asyncio.wait_for(ready.wait(), 10)
        self.base_url = f"http://127.0.0.1:{services[0].port}"
        async with aiohttp.ClientSession() as s:
            for _ in range(200):
                async with s.get(f"{self.base_url}/v1/models") as r:
                    if (await r.json())["data"]:
                        return self
                await asyncio.sleep(0.05)
        raise TimeoutError("model never appeared on the frontend")

    async def __aexit__(self, *exc) -> None:
        for rt in self.runtimes:
            rt.signal_shutdown()
        await asyncio.sleep(0.1)
        for t in self.tasks:
            t.cancel()
        for rt in self.runtimes:
            try:
                await rt.shutdown()
            except (ConnectionError, OSError, RuntimeError):
                pass  # already closed by its worker's own teardown
        await self.store.stop()


_VOLATILE = [
    (re.compile(rb'"id": ?"[^"]*"'), b'"id":""'),
    (re.compile(rb'"created": ?\d+'), b'"created":0'),
]


def _normalise(body: bytes) -> bytes:
    """A response with its per-response ``id`` and ``created`` blanked."""
    for pattern, blank in _VOLATILE:
        body = pattern.sub(blank, body)
    return body


async def _chat_bytes(session, base_url, content, stream, max_tokens=6) -> bytes:
    body = {
        "model": MODEL,
        "messages": [{"role": "user", "content": content}],
        "max_tokens": max_tokens,
        "stream": stream,
        "temperature": 0.0,
    }
    async with session.post(f"{base_url}/v1/chat/completions", json=body) as resp:
        raw = await resp.read()
        assert resp.status == 200, raw
        return _normalise(raw)


async def _serve_all(fleet) -> list[bytes]:
    """Every prompt twice (the repeat is served from the prefix cache),
    non-streaming and SSE, one request at a time."""
    out = []
    async with aiohttp.ClientSession() as s:
        for content in PROMPTS + PROMPTS[:1]:
            for stream in (False, True):
                out.append(await _chat_bytes(s, fleet.base_url, content, stream))
    return out


async def _reference() -> dict:
    """A JAX-worker fleet's responses and its worker's weights."""
    if not _REFERENCE:
        async with Fleet(["jax"]) as f:
            _REFERENCE["responses"] = await _serve_all(f)
            _REFERENCE["params"] = jax.tree.map(np.asarray, f.cores[0].params)
    return _REFERENCE


def _cached_tokens(body: bytes) -> int:
    usage = json.loads(body)["usage"]
    return usage.get("prompt_tokens_details", {}).get("cached_tokens", 0)


def _without_cache_accounting(body: bytes) -> bytes:
    return re.sub(rb'"prompt_tokens_details": ?\{[^}]*\}', b"", body)


# -- (a) a torch worker alone behind the JAX frontend -----------------------


async def test_torch_worker_serves_jax_frontend_byte_identical():
    ref = await _reference()
    params = params_from_numpy(ref["params"], tiny_model(), device="cpu")
    async with Fleet(["torch"], params=params) as f:
        got = await _serve_all(f)
    assert got == ref["responses"]
    assert any(b"data: [DONE]" in r for r in got)
    # The repeated prompt was served from the prefix cache.
    assert _cached_tokens(got[0]) == 0 and _cached_tokens(got[-2]) > 0


async def test_chunked_torch_worker_serves_jax_frontend_byte_identical():
    """Both workers with chunked scheduling (16-token chunks): the torch
    worker's completions equal the JAX worker's byte for byte, its steps
    were mixed, and its ``/metrics`` carries the scheduler gauges with its
    core's values at the time of the scrape."""
    chunked = {"scheduling": "chunked", "prefill_chunk": 16}
    async with Fleet(["jax"], overrides=chunked) as f:
        want = await _serve_all(f)
        params = _torch_params(f.cores[0])
    async with Fleet(["torch"], params=params, overrides=chunked, status=True) as f:
        got = await _serve_all(f)
        async with aiohttp.ClientSession() as s:
            async with s.get(f"http://127.0.0.1:{f.runtimes[0].status.port}/metrics") as r:
                page = (await r.read()).decode()
        stats = f.cores[0].scheduler_stats()
    assert got == want
    assert stats["chunked_scheduling"] == 1 and stats["mixed_steps"] > 0
    samples = {line.split("{", 1)[0]: float(line.rsplit(" ", 1)[1])
               for line in page.splitlines() if line and not line.startswith("#")}
    for key in ("chunked_scheduling", "token_budget", "last_step_batched_tokens",
                "last_step_budget_utilization", "chunked_prefills_in_flight",
                "fused_mixed_dispatches"):
        assert samples[f"dynamo_{SCHEDULER_GAUGES[key][0]}"] == float(stats[key]), key
    assert samples["dynamo_scheduler_chunked_enabled"] == 1.0


def test_worker_cli_takes_chunked_scheduling():
    args = worker_main._parser().parse_args(
        ["--scheduling", "chunked", "--prefill-chunk", "16", "--max-num-batched-tokens", "64"])
    overrides = worker_main._overrides(args)
    assert overrides == {"scheduling": "chunked", "prefill_chunk": 16,
                         "max_num_batched_tokens": 64}
    core, _ = build_engine("tiny", overrides, device="cpu")
    assert (core.engine.chunk_size, core.engine.token_budget) == (16, 64)
    assert core.scheduler_stats()["chunked_scheduling"] == 1


@pytest.mark.parametrize(
    "argv, want",
    [
        (["--scheduling", "chunked", "--spec-decode", "ngram"],
         {"scheduling": "chunked", "spec_decode": "ngram"}),
        (["--spec-decode", "ngram"], {"spec_decode": "ngram"}),
        (["--spec-decode", "ngram", "--spec-k", "2"], {"spec_decode": "ngram", "spec_k": 2}),
        (["--spec-decode", "ngram", "--spec-k", "4", "--spec-device-draft"],
         {"spec_decode": "ngram", "spec_k": 4, "spec_device_draft": True}),
    ],
    ids=lambda v: " ".join(v) if isinstance(v, list) else "",
)
def test_worker_cli_takes_spec_decode(argv, want):
    """The JAX worker's speculation flags (ROADMAP.md A8c): the worker's
    engine drafts and serves the stream of speculation off through its
    ``generate`` endpoint's facade."""
    args = worker_main._parser().parse_args(argv)
    worker_main._refuse_unported(args)
    overrides = worker_main._overrides(args)
    assert overrides == want
    req = {"model": MODEL, "token_ids": [5, 6, 7, 8] * 6, "request_id": "r",
           "sampling": {"temperature": 0.0}, "stop": {"max_tokens": 40, "ignore_eos": True}}

    async def serve(engine):
        return [t async for out in engine.generate(req, Context("r")) for t in out["token_ids"]]

    streams = {}
    for name, ov in (("on", overrides), ("off", {k: v for k, v in overrides.items()
                                                  if not k.startswith("spec_")})):
        core, engine = build_engine("tiny", ov, device="cpu")
        streams[name] = asyncio.run(serve(engine))
        if name == "on":
            assert core.spec_decode_stats()["drafted_tokens"] > 0
            assert core.engine.spec_k == want.get("spec_k", 4)
    assert streams["on"] == streams["off"] and len(streams["on"]) == 40


# -- (b) a mixed fleet, round robin -----------------------------------------


async def test_mixed_fleet_round_robin_byte_identical():
    ref = await _reference()
    async with Fleet(["jax", "torch"], router_mode="round_robin") as f:
        got = await _serve_all(f)
        jax_core, torch_core = f.cores
        assert jax_core.iterations > 0 and torch_core.iterations > 0
    # Which worker's prefix cache served a repeat depends on the routing,
    # so the cache accounting is compared apart from the rest.
    assert [_without_cache_accounting(r) for r in got] == [
        _without_cache_accounting(r) for r in ref["responses"]
    ]


# -- (c) KV routing: the JAX side reads the torch worker's events -----------


async def test_kv_routing_reads_torch_kv_events_and_metrics():
    async with Fleet(["torch"], router_mode="kv") as f:
        worker_id = f.runtimes[0].primary_lease_id
        probe = await JaxRuntime.create(f.store.address)
        try:
            events = await probe.store.subscribe(kv_events_subject("dynamo", "backend"))
            metrics = await probe.store.subscribe(load_metrics_subject("dynamo", "backend"))
            async with aiohttp.ClientSession() as s:
                first = await _chat_bytes(s, f.base_url, PROMPTS[1], False)
                again = await _chat_bytes(s, f.base_url, PROMPTS[1], False)
            assert _cached_tokens(first) == 0 and _cached_tokens(again) > 0
            stored = []
            while not stored:
                ev = JaxRouterEvent.from_wire((await events.get(timeout=10))["p"])
                assert ev.worker_id == worker_id
                if ev.event.op == "stored":
                    stored.append(ev)
            m = JaxMetrics.from_wire((await metrics.get(timeout=10))["p"])
            assert m.worker_id == worker_id
            assert m.kv.kv_total_blocks == f.cores[0].engine.num_kv_blocks
            assert m.worker.request_total_slots == f.cores[0].engine.max_num_seqs
        finally:
            await probe.shutdown()


# -- (d) the port's own store and client: the chip_smoke path ----------------


def _request(prompt, max_tokens=7) -> dict:
    return PreprocessedRequest(
        model=MODEL, token_ids=prompt, sampling=SamplingOptions(temperature=0.0),
        stop=StopConditions(max_tokens=max_tokens),
    ).to_wire()


_RNG = np.random.default_rng(5)
TOKEN_PROMPTS = [[int(t) for t in _RNG.integers(1, 384, n)] for n in (9, 23, 5, 23)]
TOKEN_PROMPTS[3][:16] = TOKEN_PROMPTS[1][:16]  # shares a cached prefix


async def test_port_store_and_client_match_in_process_engine():
    _, engine = build_engine("tiny", seed=0, device="cpu")
    want = []
    for i, prompt in enumerate(TOKEN_PROMPTS):
        want.append([o async for o in engine.generate(_request(prompt), Context(f"w{i}"))])

    store = StoreServer()
    await store.start()
    rt = await DistributedRuntime.create(store.address)
    client_rt = await DistributedRuntime.create(store.address)
    served = asyncio.Event()
    task = asyncio.create_task(run_torch_worker(
        rt, model_name=MODEL, preset="tiny", seed=0, served_event=served, device="cpu",
    ))
    try:
        await asyncio.wait_for(served.wait(), 60)
        client = await client_rt.namespace("dynamo").component("backend").endpoint("generate").client()
        await client.wait_for_instances(1, timeout=10)
        got = []
        for prompt in TOKEN_PROMPTS:
            stream = await client.round_robin(_request(prompt))
            got.append([o async for o in stream])
    finally:
        rt.signal_shutdown()
        await asyncio.sleep(0.05)
        task.cancel()
        await client_rt.shutdown()
        await rt.shutdown()
        await store.stop()
    assert got == want
    assert all(sum(len(o["token_ids"]) for o in outs) == 7 for outs in got)
    assert got[3][0]["meta"]["cached_tokens"] > 0


def test_warm_up_leaves_the_engine_as_it_was():
    """The worker's warm-up forwards touch no scheduler state, no cached
    block and no counter, so the streams that follow are the unwarmed
    engine's."""
    core, engine = build_engine("tiny", seed=0, device="cpu")
    before = (core.scheduler_stats(), core.kv_inventory(), core.allocator.free_blocks)
    core.warm_up()
    assert (core.scheduler_stats(), core.kv_inventory(), core.allocator.free_blocks) == before
    _, cold = build_engine("tiny", seed=0, device="cpu")

    async def run(eng):
        return [[o async for o in eng.generate(_request(p), Context(f"r{i}"))]
                for i, p in enumerate(TOKEN_PROMPTS)]

    assert asyncio.run(run(engine)) == asyncio.run(run(cold))


# -- (e) ForwardPassMetrics, field by field ----------------------------------


async def _run_engine(engine, make_context, prompts):
    async def one(i, prompt):
        req = _request(prompt, max_tokens=5 + i)
        return [o async for o in engine.generate(req, make_context(f"m{i}"))]

    return await asyncio.gather(*(one(i, p) for i, p in enumerate(prompts)))


async def test_core_metrics_match_jax_core():
    from dynamo_tpu.engine import model as jmodel
    from dynamo_tpu.engine.config import tiny_engine as j_tiny_engine
    from dynamo_tpu.engine.config import tiny_model as j_tiny_model

    jparams = jmodel.init_params(jax.random.PRNGKey(2), j_tiny_model())
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tiny_model(), device="cpu")
    jcore = JaxCore(j_tiny_model(), j_tiny_engine(), params=jparams)
    core, engine = build_engine("tiny", device="cpu", params=tparams)
    jengine = TpuEngine(jcore)
    assert dataclasses.asdict(core.metrics()) == dataclasses.asdict(jcore.metrics())
    want = await _run_engine(jengine, JaxContext, TOKEN_PROMPTS)
    got = await _run_engine(engine, Context, TOKEN_PROMPTS)
    assert got == want
    for _ in range(2):  # the repeat hits the prefix cache on both
        await _run_engine(jengine, JaxContext, TOKEN_PROMPTS[1:2])
        await _run_engine(engine, Context, TOKEN_PROMPTS[1:2])
    t_m, j_m = core.metrics(), jcore.metrics()
    assert dataclasses.asdict(t_m) == dataclasses.asdict(j_m)
    assert t_m.kv.kv_active_blocks > 0
    assert t_m.to_wire() == j_m.to_wire()
    assert engine.metrics() == t_m
    assert core.spec_decode_stats() == jcore.spec_decode_stats()
    assert core.fair_queue_stats() == jcore.fair_queue_stats()
    assert core.kv_inventory() == jcore.kv_inventory()
    for prompt in TOKEN_PROMPTS:
        assert core.cached_prefix_tokens(prompt) == jcore.cached_prefix_tokens(prompt)
    assert core.cached_prefix_tokens(TOKEN_PROMPTS[1]) > 0


# -- (f) the three request spans ----------------------------------------------


async def test_engine_records_three_spans_under_the_callers_trace():
    trace_id, parent = "ab" * 16, "cd" * 8
    headers = {"traceparent": f"00-{trace_id}-{parent}-01"}
    tracing.get_collector().clear()
    core, engine = build_engine("tiny", device="cpu")
    async for _ in engine.generate(_request(TOKEN_PROMPTS[1]), Context("spans", headers=headers)):
        pass
    spans = {s.name: s for s in tracing.get_collector().trace(trace_id)}
    assert set(spans) == {"sched_admit", "prefill", "decode"}
    assert all(s.service == "engine" and s.parent_id == parent for s in spans.values())
    assert spans["prefill"].attrs["prompt_tokens"] == len(TOKEN_PROMPTS[1])
    assert spans["decode"].attrs["tokens"] == 7
    assert spans["sched_admit"].start_s == spans["prefill"].start_s
    assert spans["sched_admit"].end_s <= spans["prefill"].end_s <= spans["decode"].end_s
    assert spans["decode"].start_s == spans["prefill"].end_s  # the first chunk


# -- (g) a graceful drain retracts the KV inventory ---------------------------


async def test_graceful_drain_publishes_cleared():
    store = StoreServer()
    await store.start()
    rt = await DistributedRuntime.create(store.address)
    probe = await DistributedRuntime.create(store.address)
    served = asyncio.Event()
    cores: list = []
    task = asyncio.create_task(run_torch_worker(
        rt, model_name=MODEL, preset="tiny", seed=0, served_event=served,
        core_out=cores, device="cpu",
    ))
    try:
        await asyncio.wait_for(served.wait(), 60)
        events = await probe.store.subscribe(kv_events_subject("dynamo", "backend"))
        client = await probe.namespace("dynamo").component("backend").endpoint("generate").client()
        await client.wait_for_instances(1, timeout=10)
        prompt = TOKEN_PROMPTS[1]
        _ = [o async for o in await client.round_robin(_request(prompt))]
        ops = []
        while "stored" not in ops:
            ev = RouterEvent.from_wire((await events.get(timeout=10))["p"])
            ops.append(ev.event.op)
            if ev.event.op == "stored":
                # The prompt's full blocks, hashed as the JAX package hashes them.
                assert list(ev.event.block_hashes) == j_seq_hashes(
                    prompt, cores[0].engine.block_size
                )[: len(ev.event.block_hashes)]
        assert await rt.drain(timeout=5.0)
        while ops[-1] != "cleared":
            ops.append(RouterEvent.from_wire((await events.get(timeout=10))["p"]).event.op)
        await asyncio.wait_for(task, 10)  # the worker returns once drained
    finally:
        task.cancel()
        await probe.shutdown()
        await rt.shutdown()
        await store.stop()


# -- (h) what the port does not serve is refused by name ----------------------

SERVED_ITEMS = {"A7", "A10", "A11"}  # ROADMAP items landed since their flags were refused


@pytest.mark.parametrize(
    "argv, item",
    [
        (["--role", "prefill"], "A10"),
        (["--role", "decode"], "A10"),
        (["--model-path", "/nonexistent"], "A7"),
        (["--tokenizer", "/nonexistent/model.gguf"], "A7"),
        (["--moe-dispatch", "alltoall"], "A11"),
        (["--tp", "2"], "A12"),
        (["--pp", "2"], "A12"),
        (["--nnodes", "2", "--dist-init-addr", "127.0.0.1:1"], "A12"),
        (["--local-cpu-devices", "4"], "A12"),
        (["--ring-prefill-threshold", "64"], "A12"),
        (["--preset", "tiny-moe"], "A11"),
    ],
    ids=lambda v: v if isinstance(v, str) else " ".join(v),
)
def test_unported_cli_flags_refused(argv, item):
    """Each flag value the port does not serve raises, naming its ROADMAP
    item. A value whose item has landed is served instead: the parser and
    the refusals take the roles (A10), and their engine builds; they take
    the MoE presets and ``--moe-dispatch`` (A11), which a dense preset
    refuses as the JAX worker does; they take a checkpoint directory and a
    GGUF tokenizer (A7), and a path that does not exist fails as a missing
    file, the checkpoint's before the worker joins the fleet."""
    if item not in SERVED_ITEMS:
        with pytest.raises(ValueError, match=item):
            worker_main.main(argv)
        return
    args = worker_main._parser().parse_args(argv)
    worker_main._refuse_unported(args)
    if item == "A7":
        with pytest.raises(FileNotFoundError, match="nonexistent"):
            if args.model_path is not None:
                worker_main.main(argv)
            else:
                worker_main._eos_for(args.tokenizer)
        return
    if item == "A10":
        assert args.role == argv[1] and args.max_local_prefill_length == 50
        core, _ = build_engine("tiny", worker_main._overrides(args), device="cpu")
        assert core.engine.held_block_ttl_s > 0
        return
    if args.moe_dispatch is not None:
        with pytest.raises(ValueError, match="is dense"):
            worker_main.main(argv)  # the default preset, tiny, is dense
        args.preset = "tiny-moe"
    core, _ = build_engine(args.preset, worker_main._overrides(args), device="cpu",
                           moe_dispatch=args.moe_dispatch)
    assert core.cfg.is_moe
    assert core.cfg.moe_dispatch == (args.moe_dispatch or "replicated")


async def test_status_server_refused_when_asked_for(monkeypatch):
    """``DYN_SYSTEM_ENABLED`` set, and left at its default (on): the
    runtime starts its status server, which answers ``/health`` and
    ``/metrics`` while the worker function runs; set to 0, there is none."""
    store = StoreServer()
    await store.start()
    seen = []

    async def fn(runtime):
        if runtime.status is None:
            seen.append(None)
            return
        base = f"http://127.0.0.1:{runtime.status.port}"
        async with aiohttp.ClientSession() as s:
            async with s.get(f"{base}/health") as r:
                seen.append((r.status, (await r.json())["status"]))
            async with s.get(f"{base}/metrics") as r:
                assert r.status == 200
                assert b"dynamo_system_uptime_seconds" in await r.read()

    try:
        monkeypatch.setenv("DYN_STORE_ADDRESS", store.address)
        monkeypatch.setenv("DYN_SYSTEM_ENABLED", "1")
        await runtime_worker._run(fn, RuntimeConfig.from_env())
        monkeypatch.delenv("DYN_SYSTEM_ENABLED")
        cfg = RuntimeConfig.from_env()
        assert cfg.system_enabled
        await runtime_worker._run(fn, cfg)
        monkeypatch.setenv("DYN_SYSTEM_ENABLED", "0")
        await runtime_worker._run(fn, RuntimeConfig.from_env())
        # No endpoint is served yet, so the server reports "starting".
        assert seen == [(503, "starting"), (503, "starting"), None]
    finally:
        await store.stop()


async def test_worker_publishes_obs_snapshots_at_its_default():
    """At its defaults the worker publishes metric snapshots of its core's
    counters on the namespace's obs subject; a graceful drain publishes
    the retraction."""
    from dynamo_tpu_torch.obs.snapshot import MetricSnapshot, obs_subject

    store = StoreServer()
    await store.start()
    rt = await DistributedRuntime.create(store.address)
    probe = await DistributedRuntime.create(store.address)
    snaps = await probe.store.subscribe(obs_subject("dynamo"))
    served = asyncio.Event()
    cores: list = []
    task = asyncio.create_task(run_torch_worker(
        rt, model_name=MODEL, preset="tiny", seed=0, served_event=served,
        core_out=cores, device="cpu", obs_interval_s=0.05,
    ))
    try:
        await asyncio.wait_for(served.wait(), 60)
        snap = MetricSnapshot.from_wire((await snaps.get(timeout=10))["p"])
        assert snap.worker_id == rt.primary_lease_id
        assert (snap.role, snap.component, snap.retired) == ("worker", "backend", False)
        assert set(snap.families) >= {"scheduler", "kv_cache", "kv_pool"}
        assert snap.families["kv_cache"]["capacity_blocks"] == cores[0].engine.num_kv_blocks
        assert await rt.drain(timeout=5.0)
        while not snap.retired:
            snap = MetricSnapshot.from_wire((await snaps.get(timeout=10))["p"])
        assert snap.worker_id == rt.primary_lease_id
        await asyncio.wait_for(task, 10)
    finally:
        task.cancel()
        await probe.shutdown()
        await rt.shutdown()
        await store.stop()
