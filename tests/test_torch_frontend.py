"""The port's OpenAI frontend and KV router against the JAX package's, on
the tiny preset and the CPU.

The port's store, frontend and torch worker answer chat and completion
requests byte for byte as the JAX store, frontend and worker do with the
same weights, apart from each response's ``id`` and ``created`` and the
digits of its log-probabilities, which two f32 forwards agree on to
``LOGPROB_ATOL``; the
port's frontend serves a JAX worker and a mixed fleet; its KV router sends
a shared-prefix repeat to the worker that holds the prefix; a torch
worker's status server exports the JAX worker's series with equal
scheduler gauges; the frontend's ``/metrics`` composes the torch worker's
snapshots under its ``worker_id``; and a stream whose worker dies is
completed on the other worker.
"""

import asyncio
import json
import re
import time

import aiohttp
import jax
import numpy as np
import pytest

from dynamo_tpu.backends.jax.main import run_jax_worker
from dynamo_tpu.frontend.main import run_frontend as jax_run_frontend
from dynamo_tpu.runtime import DistributedRuntime as JaxRuntime
from dynamo_tpu.runtime import status_server as jax_status
from dynamo_tpu.runtime.store import StoreServer as JaxStoreServer
from dynamo_tpu_torch.backends.torch.main import run_torch_worker
from dynamo_tpu_torch.engine.config import tiny_model
from dynamo_tpu_torch.engine.convert import params_from_numpy
from dynamo_tpu_torch.frontend.main import run_frontend
from dynamo_tpu_torch.llm.protocols.openai import ChatCompletionRequest
from dynamo_tpu_torch.runtime import DistributedRuntime
from dynamo_tpu_torch.runtime import status_server as torch_status
from dynamo_tpu_torch.runtime.store import StoreServer
from dynamo_tpu_torch.tokens import compute_seq_hashes

pytestmark = [pytest.mark.e2e]

MODEL = "tinyfront"
PROMPTS = ["hello torch frontend", "the quick brown fox", "parity over http"]
_RNG = np.random.default_rng(11)
# Pre-tokenized prompts; the last shares the second's first 32 tokens
# (four full blocks of the tiny engine's 8).
TOKEN_PROMPTS = [[int(t) for t in _RNG.integers(1, 256, n)] for n in (13, 41, 7, 45)]
TOKEN_PROMPTS[3][:32] = TOKEN_PROMPTS[1][:32]
_REFERENCE: dict = {}
LOGPROB_ATOL = 1e-5
_FLOAT = re.compile(rb"-?\d+\.\d+(?:[eE][-+]?\d+)?")

# The store, runtime, frontend and status server of each side.
SIDES = {
    "jax": (JaxStoreServer, JaxRuntime, jax_run_frontend, jax_status),
    "torch": (StoreServer, DistributedRuntime, run_frontend, torch_status),
}


class Fleet:
    """A store and a frontend of one side ("jax" or "torch") with workers
    of the given kinds, started in order. A torch worker serves ``params``
    when given, else random weights from seed 0; a JAX worker draws its
    weights from seed 0. With ``status`` each worker runs a status server,
    as ``DYN_SYSTEM_ENABLED`` makes the worker process do; with
    ``fleet_obs`` the frontend embeds the fleet aggregator and the
    workers publish snapshots every ``obs_interval_s``."""

    def __init__(self, side, kinds, router_mode="round_robin", params=None,
                 status=False, fleet_obs=False, obs_interval_s=1.0):
        self.side = side
        self.kinds = kinds
        self.router_mode = router_mode
        self.params = params
        self.status = status
        self.fleet_obs = fleet_obs
        self.obs_interval_s = obs_interval_s
        self.store = SIDES[side][0]()
        self.workers: list = []  # the workers' runtimes, in order
        self.runtimes: list = []
        self.tasks: list[asyncio.Task] = []
        self.cores: list = []
        self.service = None
        self.base_url = ""

    async def _start_worker(self, kind) -> None:
        _, runtime_cls, _, status_mod = SIDES[kind]
        rt = await runtime_cls.create(self.store.address)
        if self.status:
            rt.status = status_mod.SystemStatusServer(host="127.0.0.1", port=0)
            await rt.status.start()
            status_mod.bind_egress_gauges(rt.status, rt.egress)
        served = asyncio.Event()
        common = dict(
            model_name=MODEL, preset="tiny", seed=0, served_event=served,
            core_out=self.cores, obs_publish=self.fleet_obs,
            obs_interval_s=self.obs_interval_s,
        )
        if kind == "jax":
            coro = run_jax_worker(rt, **common)
        else:
            coro = run_torch_worker(rt, device="cpu", params=self.params, **common)
        self.workers.append(rt)
        self.runtimes.append(rt)
        self.tasks.append(asyncio.create_task(coro))
        await asyncio.wait_for(served.wait(), 60)

    async def __aenter__(self) -> "Fleet":
        await self.store.start()
        for kind in self.kinds:
            await self._start_worker(kind)
        _, runtime_cls, frontend, _ = SIDES[self.side]
        front = await runtime_cls.create(self.store.address)
        self.runtimes.append(front)
        ready = asyncio.Event()
        services: list = []
        self.tasks.append(asyncio.create_task(frontend(
            front, http_host="127.0.0.1", http_port=0, router_mode=self.router_mode,
            ready_event=ready, service_out=services, fleet_obs=self.fleet_obs,
            obs_interval_s=self.obs_interval_s,
        )))
        await asyncio.wait_for(ready.wait(), 10)
        self.service = services[0]
        self.base_url = f"http://127.0.0.1:{self.service.port}"
        # The model is served, and its router sees every worker, before
        # the first request.
        served = await self.service.manager.wait_for_model(MODEL, timeout=10)
        await served.client.wait_for_instances(len(self.kinds), timeout=10)
        return self

    @property
    def served(self):
        return self.service.manager.get(MODEL)

    async def __aexit__(self, *exc) -> None:
        for rt in self.runtimes:
            rt.signal_shutdown()
        await asyncio.sleep(0.1)
        for t in self.tasks:
            t.cancel()
        for rt in self.runtimes:
            try:
                if rt.status is not None:
                    await rt.status.stop()
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


async def _post(session, base_url, path, body) -> bytes:
    async with session.post(f"{base_url}{path}", json=body) as resp:
        raw = await resp.read()
        assert resp.status == 200, raw
        return raw


def _chat(content, stream, max_tokens=6, **extra) -> tuple[str, dict]:
    return "/v1/chat/completions", {
        "model": MODEL, "messages": [{"role": "user", "content": content}],
        "max_tokens": max_tokens, "stream": stream, "temperature": 0.0, **extra,
    }


def _completion(prompt, stream, max_tokens=6, **extra) -> tuple[str, dict]:
    return "/v1/completions", {
        "model": MODEL, "prompt": prompt, "max_tokens": max_tokens, "stream": stream,
        "temperature": 0.0, **extra,
    }


def _requests() -> list[tuple[str, dict]]:
    """Every chat prompt and every pre-tokenized completion (with
    logprobs), and a repeat of the first of each that the prefix cache
    serves; non-streaming and SSE."""
    out = []
    for stream in (False, True):
        for content in PROMPTS + PROMPTS[:1]:
            out.append(_chat(content, stream))
        for prompt in TOKEN_PROMPTS + TOKEN_PROMPTS[:1]:
            out.append(_completion(prompt, stream, logprobs=1))
        out.append(_completion(PROMPTS[2], stream))
    return out


async def _serve_all(fleet) -> list[bytes]:
    """Every request of :func:`_requests`, one at a time."""
    async with aiohttp.ClientSession() as s:
        return [_normalise(await _post(s, fleet.base_url, path, body))
                for path, body in _requests()]


async def _reference() -> dict:
    """The JAX store, frontend and worker's responses, and the worker's
    weights."""
    if not _REFERENCE:
        async with Fleet("jax", ["jax"]) as f:
            _REFERENCE["responses"] = await _serve_all(f)
            _REFERENCE["params"] = jax.tree.map(np.asarray, f.cores[0].params)
    return _REFERENCE


def _split_floats(body: bytes) -> tuple[bytes, list[float]]:
    """A response with its floats (the log-probabilities: every other
    number in a response is an integer) blanked, and the floats."""
    return _FLOAT.sub(b"0.0", body), [float(x) for x in _FLOAT.findall(body)]


def _assert_same(got: list[bytes], want: list[bytes]) -> None:
    """The same bytes apart from log-probabilities, which agree to
    ``LOGPROB_ATOL``."""
    assert len(got) == len(want)
    for (path, body), g, w in zip(_requests(), got, want):
        (g_bytes, g_floats), (w_bytes, w_floats) = _split_floats(g), _split_floats(w)
        assert g_bytes == w_bytes, (path, body)
        np.testing.assert_allclose(g_floats, w_floats, rtol=0, atol=LOGPROB_ATOL)


def _torch_params(ref) -> dict:
    return params_from_numpy(ref["params"], tiny_model(), device="cpu")


def _usage(body: bytes) -> dict:
    """The usage of a response, streamed or not."""
    if body.startswith(b"data:"):
        chunks = [json.loads(line[5:]) for line in body.splitlines()
                  if line.startswith(b"data:") and line != b"data: [DONE]"]
        return next(c["usage"] for c in reversed(chunks) if c.get("usage"))
    return json.loads(body)["usage"]


def _cached_tokens(body: bytes) -> int:
    return (_usage(body).get("prompt_tokens_details") or {}).get("cached_tokens", 0)


def _without_cache_accounting(body: bytes) -> bytes:
    return re.sub(rb', ?"prompt_tokens_details": ?(?:null|\{[^}]*\})', b"", body)


# -- (a) the port's store, frontend and worker against the JAX package's -----


async def test_port_fleet_byte_identical_to_jax_fleet():
    ref = await _reference()
    async with Fleet("torch", ["torch"], params=_torch_params(ref)) as f:
        got = await _serve_all(f)
    _assert_same(got, ref["responses"])
    assert any(b"data: [DONE]" in r for r in got)
    assert any(b'"logprobs"' in r for r in got)
    # The repeats were served from the prefix cache.
    assert _cached_tokens(got[0]) == 0 and _cached_tokens(got[3]) > 0


# -- (b) the port's frontend in front of a JAX worker, and a mixed fleet ------


@pytest.mark.parametrize("kinds", [["jax"], ["jax", "torch"]], ids=["jax", "jax+torch"])
async def test_port_frontend_serves_jax_and_mixed_fleets(kinds):
    ref = await _reference()
    async with Fleet("torch", kinds, params=_torch_params(ref)) as f:
        got = await _serve_all(f)
        assert all(core.iterations > 0 for core in f.cores)
    if kinds == ["jax"]:
        assert got == ref["responses"]
    else:
        # Which worker's prefix cache served a repeat depends on the
        # routing, so the cache accounting is compared apart from the rest.
        _assert_same([_without_cache_accounting(r) for r in got],
                     [_without_cache_accounting(r) for r in ref["responses"]])


# -- (c) KV routing over two torch workers ------------------------------------


def _admitted_hits(core) -> int:
    """Admitted sequences whose prompt prefix the cache served."""
    return core.kv_cache_stats()["admitted_hits"]


async def _settled(fleet, body, worker_id, want) -> None:
    """Wait until the router's index holds ``want`` blocks of the chat
    request's prompt on the worker and the router counts no request in
    flight."""
    pre = fleet.served.preprocessor.preprocess_chat(ChatCompletionRequest(**body))
    router = fleet.served.kv_router
    hashes = compute_seq_hashes(pre.token_ids, fleet.cores[0].engine.block_size)
    for _ in range(500):
        if (router.indexer.find_matches(hashes).get(worker_id, 0) >= want
                and router.active.active_requests() == 0):
            return
        await asyncio.sleep(0.01)
    raise TimeoutError("the router never settled after the first request")


async def test_kv_router_sends_shared_prefix_to_its_holder():
    # Streamed chat: a completion's usage carries no cached tokens, and a
    # non-streamed response leaves the end of its stream, where the router
    # frees the request's load, to the garbage collector.
    shared = "a system prompt that every request of this tenant shares " * 2
    usage = {"stream_options": {"include_usage": True}}
    async with Fleet("torch", ["torch", "torch"], router_mode="kv") as f:
        async with aiohttp.ClientSession() as s:
            path, body = _chat(shared + "first question", True, **usage)
            first = await _post(s, f.base_url, path, body)
            (holder,) = [i for i, c in enumerate(f.cores) if c.iterations > 0]
            hits = _admitted_hits(f.cores[holder])
            await _settled(f, body, f.workers[holder].primary_lease_id, 4)
            again = await _post(s, f.base_url, *_chat(shared + "a second question", True, **usage))
        other = f.cores[1 - holder]
        assert other.iterations == 0
        assert _admitted_hits(f.cores[holder]) == hits + 1
        assert type(f.served.kv_router.indexer.tree.tree).__name__ in ("NativeRadixTree", "RadixTree")
    assert _cached_tokens(first) == 0
    assert _cached_tokens(again) >= 4 * f.cores[0].engine.block_size


# -- (d) the worker's status server against the JAX worker's -------------------


async def _get(url) -> tuple[int, bytes]:
    async with aiohttp.ClientSession() as s:
        async with s.get(url) as r:
            return r.status, await r.read()


def _series(text: bytes) -> dict[str, float]:
    """``name{labels}`` -> value of every sample in a Prometheus text page."""
    out = {}
    for line in text.decode().splitlines():
        if line and not line.startswith("#"):
            key, value = line.rsplit(" ", 1)
            out[key] = float(value)
    return out


def _names(series: dict[str, float]) -> set[str]:
    return {k.split("{", 1)[0] for k in series}


async def _worker_pages(side, kind, params=None) -> tuple[list, dict[str, float], dict]:
    """The worker's /health before and after the traffic, its /metrics
    after, and its core's scheduler counters."""
    async with Fleet(side, [kind], params=params, status=True) as f:
        base = f"http://127.0.0.1:{f.workers[0].status.port}"
        health = [await _get(f"{base}/health")]
        await _serve_all(f)
        health.append(await _get(f"{base}/health"))
        status, page = await _get(f"{base}/metrics")
        assert status == 200
        return health, _series(page), f.cores[0].scheduler_stats()


async def test_worker_status_server_matches_jax_worker():
    ref = await _reference()
    j_health, j_series, _ = await _worker_pages("jax", "jax")
    t_health, t_series, t_stats = await _worker_pages("torch", "torch", _torch_params(ref))
    for health in (j_health, t_health):
        assert [(code, json.loads(body)["status"]) for code, body in health] == [
            (200, "healthy"), (200, "healthy")]
    assert _names(t_series) == _names(j_series)
    table = torch_status.SCHEDULER_GAUGES
    names = {f"dynamo_{name}" for name, _ in table.values()}
    scheduler = {k: v for k, v in t_series.items() if k.split("{", 1)[0] in names}
    assert len(scheduler) == len(table)
    assert scheduler == {k: j_series[k] for k in scheduler}
    # The gauges are the core's own counters at the time of the scrape.
    for key, (name, _) in table.items():
        (sample,) = [v for k, v in scheduler.items() if k.startswith(f"dynamo_{name}{{")]
        assert sample == float(t_stats.get(key, 0) or 0), key


# -- (e) the frontend's /metrics with a torch worker publishing snapshots -----


async def test_frontend_metrics_compose_torch_worker_snapshots():
    async with Fleet("torch", ["torch"], fleet_obs=True, obs_interval_s=0.05) as f:
        worker_id = f.workers[0].primary_lease_id
        async with aiohttp.ClientSession() as s:
            for path, body in _requests()[:3]:
                await _post(s, f.base_url, path, body)
        label = f'worker_id="{worker_id}"'
        for _ in range(200):
            series = _series((await _get(f"{f.base_url}/metrics"))[1])
            mine = {k: v for k, v in series.items() if label in k}
            admitted = [v for k, v in mine.items()
                        if k.startswith("dynamo_kv_prefix_cache_admitted_queries_total{")]
            if admitted == [3]:
                break
            await asyncio.sleep(0.05)
        else:
            raise AssertionError(f"no snapshot of worker {worker_id} on the frontend")
        counters = {k: v for k, v in series.items()
                    if k.startswith("dynamo_frontend_requests_total")}
        assert sum(counters.values()) == 3
        assert mine[f'dynamo_kv_cache_capacity_blocks{{namespace="dynamo",service="engine",'
                    f'{label}}}'] == f.cores[0].engine.num_kv_blocks
        assert series[next(k for k in series if k.startswith("dynamo_obs_live_workers"))] == 1


# -- (f) migration: a worker dies mid-stream ----------------------------------


def _slow(core, seconds) -> None:
    """Each engine step of the core takes at least ``seconds``, so a
    stream is still running when its worker is cut."""
    step = core.step

    def slow_step(*args, **kwargs):
        time.sleep(seconds)
        return step(*args, **kwargs)

    core.step = slow_step


def _sse(body: bytes) -> list[dict]:
    return [json.loads(line[5:]) for line in body.splitlines()
            if line.startswith(b"data:") and line != b"data: [DONE]"]


async def test_stream_migrates_when_its_worker_dies():
    max_tokens = 40
    # With log-probabilities every engine chunk streams, text or not.
    path, body = _completion(TOKEN_PROMPTS[0], True, max_tokens=max_tokens, logprobs=1,
                             dyn={"ignore_eos": True})
    async with Fleet("torch", ["torch", "torch"]) as f:
        for core in f.cores:
            _slow(core, 0.05)
        raw = b""
        cut = None
        async with aiohttp.ClientSession() as s:
            async with s.post(f"{f.base_url}{path}", json=body) as resp:
                assert resp.status == 200
                async for line in resp.content:
                    raw += line
                    if cut is None and line.startswith(b"data: {"):
                        (cut,) = [i for i, c in enumerate(f.cores) if c.running]
                        await f.workers[cut].shutdown()
        assert cut is not None
        survivor = f.cores[1 - cut]
        assert survivor.iterations > 0
    assert raw.rstrip().endswith(b"data: [DONE]")
    chunks = _sse(raw)
    usage = _usage(raw)
    assert usage["completion_tokens"] == max_tokens
    streamed = [lp for c in chunks if c["choices"]
                for lp in (c["choices"][0].get("logprobs") or {}).get("token_logprobs", [])]
    assert len(streamed) == max_tokens  # nothing lost or repeated across the cut
    finishes = [c["choices"][0].get("finish_reason") for c in chunks if c["choices"]]
    assert [r for r in finishes if r] == ["length"] and finishes[-1] == "length"
