"""KV transfer and disaggregated prefill/decode: the port against the JAX
package, on the CPU.

Engine level, on the same weights: a remote-decode prefill's descriptors
are the JAX engine's field for field; pages a JAX engine exports import
into the port (and the port's into JAX) and read back byte for byte, f32,
bf16 and int8 (packed); after an import the port's own next step reads
the imported pages from the cache tensors it always had (a prefix hit
whose log-probabilities equal a cold prefill's, and poisoned pages that
visibly change them); chunk commits stream as the JAX engine's do.

Fleet level, behind the JAX store and frontend: a prefill worker and a
decode worker, each torch or JAX, answer as an aggregated JAX worker
does, moving blocks with no recompute; a severed handoff degrades to the
same completion; peer pulls run both ways between a torch and a JAX
worker (the torch worker honours a router's ``peer_prefix`` hint and
serves ``kv_fetch``); a mixed-dtype pull fails fast.
"""

import asyncio
import dataclasses
import re
import time

import aiohttp
import jax
import numpy as np
import pytest

from dynamo_tpu.backends.jax.main import run_jax_worker
from dynamo_tpu.engine import EngineCore as JaxCore
from dynamo_tpu.engine import model as jmodel
from dynamo_tpu.engine.config import tiny_engine as j_tiny_engine
from dynamo_tpu.engine.config import tiny_model as j_tiny_model
from dynamo_tpu.frontend.main import run_frontend
from dynamo_tpu.llm.disagg import DisaggConfig as JaxDisaggConfig
from dynamo_tpu.llm.protocols.common import PreprocessedRequest as JaxRequest
from dynamo_tpu.runtime import DistributedRuntime as JaxRuntime
from dynamo_tpu.runtime.store import StoreServer as JaxStoreServer
from dynamo_tpu_torch.backends.torch.main import run_torch_worker
from dynamo_tpu_torch.engine.config import tiny_engine, tiny_model
from dynamo_tpu_torch.engine.convert import params_from_numpy
from dynamo_tpu_torch.engine.core import EngineCore
from dynamo_tpu_torch.llm.disagg import DisaggConfig
from dynamo_tpu_torch.llm.protocols.common import PreprocessedRequest
from dynamo_tpu_torch.runtime import DistributedRuntime
from dynamo_tpu_torch.runtime import chaos
from dynamo_tpu_torch.runtime.status_server import SystemStatusServer

# Log-probabilities of a prefill over imported pages against a cold
# prefill's, the tolerance of the port's chunked-scheduling parity tests.
LP_TOL = 1e-4
PROMPT = [int(t) for t in np.random.default_rng(3).integers(1, 384, 45)]  # 5 full blocks


@pytest.fixture(scope="module")
def weights():
    jparams = jmodel.init_params(jax.random.PRNGKey(0), j_tiny_model())
    return jparams, jax.tree.map(np.asarray, jparams)


def _cores(weights, model_dtype="float32", **engine_kw):
    jcfg = dataclasses.replace(j_tiny_model(), dtype=model_dtype)
    tcfg = dataclasses.replace(tiny_model(), dtype=model_dtype)
    jparams = jax.tree.map(lambda a: a.astype(jcfg.jax_dtype), weights[0])
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    jcore = JaxCore(jcfg, j_tiny_engine(**engine_kw), params=jparams, seed=0)
    tcore = EngineCore(tcfg, tiny_engine(**engine_kw), params=tparams, seed=0, device="cpu")
    return jcore, tcore


def _wire(rid, prompt=PROMPT, max_tokens=4, remote=False, logprobs=None):
    w = {"model": "tiny", "token_ids": list(prompt), "request_id": rid,
         "sampling": {"temperature": 0.0}, "stop": {"max_tokens": max_tokens}}
    if remote:
        w["stop"] = {"max_tokens": 1, "ignore_eos": True}
        w["kv_transfer_params"] = {"do_remote_decode": True}
    if logprobs:
        w["output"] = {"logprobs": logprobs}
    return w


def _drive(core, wires, from_wire, on_step=None):
    seqs = [core.add_request(from_wire(w)) for w in wires]
    outs = {s.request_id: [] for s in seqs}
    while core.has_work():
        for seq, out in core.step():
            outs[seq.request_id].append(out)
        if on_step is not None:
            on_step()
    return outs, seqs


def _jax_drive(core, wires, on_step=None):
    return _drive(core, wires, JaxRequest.from_wire, on_step)


def _torch_drive(core, wires, on_step=None):
    return _drive(core, wires, PreprocessedRequest.from_wire, on_step)


def _tokens(outs, rid):
    return [t for o in outs[rid] for t in o.token_ids]


def _held_pages(core, rid):
    descs = core.export_descriptors(rid)
    return descs, core.read_held_pages(rid, 0, len(descs))


# -- engine level ------------------------------------------------------------


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_export_descriptors_equal_jax(weights, kv_dtype):
    jcore, tcore = _cores(weights, kv_dtype=kv_dtype)
    jout, _ = _jax_drive(jcore, [_wire("r", remote=True)])
    tout, _ = _torch_drive(tcore, [_wire("r", remote=True)])
    assert _tokens(jout, "r") == _tokens(tout, "r")
    jparams, tparams = jout["r"][-1].kv_transfer_params, tout["r"][-1].kv_transfer_params
    assert tparams == jparams and len(tparams["block_hashes"]) == 5
    assert tcore.export_descriptors("r") == jcore.export_descriptors("r")
    assert tcore.export_descriptors("r", start=2, count=2) == jcore.export_descriptors(
        "r", start=2, count=2)
    assert tcore.transfer_stats == jcore.transfer_stats
    # The hold pins the blocks until released.
    assert "r" in tcore._held and tcore.allocator.used_blocks > 0
    tcore.release_held("r")
    jcore.release_held("r")
    with pytest.raises(KeyError):
        tcore.export_descriptors("r")


@pytest.mark.parametrize("model_dtype, kv_dtype", [("float32", "bf16"), ("bfloat16", "bf16"),
                                                   ("float32", "int8")],
                         ids=["f32", "bf16", "int8-packed"])
def test_transferred_pages_byte_identical_both_ways(weights, model_dtype, kv_dtype):
    """JAX export -> port import -> port read_cached_pages gives the JAX
    bytes; port export -> JAX import -> JAX read_cached_pages gives the
    port's."""
    jcore, tcore = _cores(weights, model_dtype, kv_dtype=kv_dtype)
    _jax_drive(jcore, [_wire("r", remote=True)])
    _torch_drive(tcore, [_wire("r", remote=True)])
    for src in (jcore, tcore):
        descs, pages = _held_pages(src, "r")
        assert descs[0]["dtype"] == {"int8": "int8"}.get(kv_dtype, model_dtype)
        hashes = [d["hash"] for d in descs]
        fresh_jax, fresh_torch = _cores(weights, model_dtype, kv_dtype=kv_dtype)
        target = fresh_torch if src is jcore else fresh_jax
        res = target.import_blocks([{**d, "kv": kv} for d, kv in zip(descs, pages)])
        assert (res.imported, res.skipped, res.dropped) == (5, 0, 0)
        assert target.read_cached_pages(hashes) == pages
        # An import of hashes already held skips them.
        again = target.import_blocks([{**d, "kv": kv} for d, kv in zip(descs, pages)])
        assert (again.imported, again.skipped) == (0, 5)


def test_bf16_pages_import_into_f32_engines_alike(weights):
    """A bf16 producer's pages into an f32 consumer: both packages cast on
    the host and hold the same f32 bytes."""
    bf16, _ = _cores(weights, "bfloat16")
    _jax_drive(bf16, [_wire("r", remote=True)])
    descs, pages = _held_pages(bf16, "r")
    jcore, tcore = _cores(weights)
    blocks = [{**d, "kv": kv} for d, kv in zip(descs, pages)]
    assert jcore.import_blocks(blocks).imported == tcore.import_blocks(blocks).imported == 5
    hashes = [d["hash"] for d in descs]
    got = tcore.read_cached_pages(hashes)
    assert got == jcore.read_cached_pages(hashes) and len(got[0]) == 2 * len(pages[0])


def test_imported_pages_serve_the_next_step_in_place(weights):
    """After import_blocks the port's own step hits the imported prefix and
    reads those pages out of the cache tensors the engine held before the
    import: its log-probabilities equal a cold prefill's, while zeroed
    pages under the same hashes change them."""
    jcore, cold = _cores(weights)
    _jax_drive(jcore, [_wire("r", remote=True)])
    descs, pages = _held_pages(jcore, "r")
    want, _ = _torch_drive(cold, [_wire("c", max_tokens=6, logprobs=3)])

    def serve(page_bytes):
        _, core = _cores(weights)
        before = list(core.cache)
        res = core.import_blocks([{**d, "kv": kv} for d, kv in zip(descs, page_bytes)])
        assert res.imported == 5
        assert all(a is b for a, b in zip(before, core.cache))  # never rebound
        outs, seqs = _torch_drive(core, [_wire("c", max_tokens=6, logprobs=3)])
        assert seqs[0].num_cached_tokens == 5 * core.engine.block_size
        return outs

    def lps(outs):
        return np.array([e["logprob"] for o in outs["c"] for e in o.logprobs])

    got = serve(pages)
    assert _tokens(got, "c") == _tokens(want, "c")
    np.testing.assert_allclose(lps(got), lps(want), atol=LP_TOL)
    poisoned = serve([bytes(len(p)) for p in pages])
    assert np.abs(lps(poisoned)[:1] - lps(want)[:1]).max() > 100 * LP_TOL


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_import_blocks_direct_matches_staged_import(weights, kv_dtype):
    _, src = _cores(weights, kv_dtype=kv_dtype)
    _torch_drive(src, [_wire("r", remote=True)])
    descs, pages = _held_pages(src, "r")
    _, dst = _cores(weights, kv_dtype=kv_dtype)
    before = list(dst.cache)
    res = dst.import_blocks_direct(src, "r")
    assert (res.imported, res.dropped) == (5, 0)
    assert dst.read_cached_pages([d["hash"] for d in descs]) == pages
    assert all(a is b for a, b in zip(before, dst.cache))
    assert dst.transfer_stats["imported_blocks"] == 5
    with pytest.raises(ValueError, match="self"):
        src.import_blocks_direct(src, "r")


def test_mixed_dtype_import_fails_fast(weights):
    _, bf = _cores(weights)
    _, q8 = _cores(weights, kv_dtype="int8")
    for src, dst in ((bf, q8), (q8, bf)):
        _torch_drive(src, [_wire("r", remote=True)])
        descs, pages = _held_pages(src, "r")
        with pytest.raises(ValueError, match="KV dtype mismatch"):
            dst.import_blocks([{**d, "kv": kv} for d, kv in zip(descs, pages)])
    assert q8.transfer_stats["imported_blocks"] == bf.transfer_stats["imported_blocks"] == 0


def test_chunk_commits_stream_as_jax(weights):
    """Chunked prefill of a remote-decode request: the chunk-commit
    callbacks, the cursor and the windows readable mid-prefill are the
    JAX engine's; an unpulled hold expires after its TTL."""
    kw = {"scheduling": "chunked", "prefill_chunk": 16, "held_block_ttl_s": 0.05}
    jcore, tcore = _cores(weights, **kw)
    calls = {"jax": [], "torch": []}
    windows = {"jax": [], "torch": []}
    for kind, core, drive in (("jax", jcore, _jax_drive), ("torch", tcore, _torch_drive)):
        core.on_chunk_commit = lambda rid, n, done, k=kind: calls[k].append((rid, n, done))

        def peek(core=core, kind=kind):
            try:
                n, done = core.chunk_cursor("r")
            except KeyError:
                return
            if not done and n:
                windows[kind].append(core.export_descriptors("r", start=0, count=n))

        drive(core, [_wire("r", remote=True)], on_step=peek)
    assert calls["torch"] == calls["jax"] and calls["torch"][-1] == ("r", 5, True)
    assert len(calls["torch"]) > 2  # chunks committed before the final cursor
    assert windows["torch"] == windows["jax"] and windows["torch"]
    assert tcore.chunk_cursor("r") == (5, True)
    time.sleep(0.1)
    _torch_drive(tcore, [_wire("x", prompt=[1, 2, 3], max_tokens=1)])
    with pytest.raises(KeyError):
        tcore.export_descriptors("r")
    assert tcore.allocator.used_blocks == len(tcore.allocator._inactive)


# -- fleet level ---------------------------------------------------------------

MODEL = "tinydis"
LONG_PROMPTS = [
    "Long prompts get disaggregated: this text is deliberately padded so "
    "its tokenization spans multiple complete KV blocks end to end.",
    "A second long prompt, distinct from the first one, also padded well past "
    "the local prefill limit so that it goes to the prefill fleet too.",
]
_VOLATILE = [
    (re.compile(rb'"id": ?"[^"]*"'), b'"id":""'),
    (re.compile(rb'"created": ?\d+'), b'"created":0'),
    (re.compile(rb',? ?"prompt_tokens_details": ?\{[^}]*\}'), b""),
]
_REFERENCE: dict = {}


def _normalise(body: bytes) -> bytes:
    """A response without its id, creation time and cache accounting (which
    worker's cache served a prefix depends on the path)."""
    for pattern, blank in _VOLATILE:
        body = pattern.sub(blank, body)
    return body


class Fleet:
    """The JAX store and frontend (KV routing) with workers given as (kind,
    role[, overrides]): ``kind`` "jax" or "torch". Every worker serves the
    same weights: a torch worker gets the JAX workers' seed-0 weights
    converted, and runs a status server. A decode worker sends prompts
    past 16 tokens to the prefill fleet."""

    def __init__(self, workers, params):
        self.workers = workers
        self.params = params
        self.store = JaxStoreServer()
        self.runtimes: list = []
        self.tasks: list[asyncio.Task] = []
        self.cores: list = []
        self.worker_ids: list[int] = []
        self.service = None
        self.base_url = ""

    async def __aenter__(self) -> "Fleet":
        await self.store.start()
        for kind, role, *rest in self.workers:
            overrides = rest[0] if rest else None
            served = asyncio.Event()
            if kind == "jax":
                rt = await JaxRuntime.create(self.store.address)
                coro = run_jax_worker(
                    rt, model_name=MODEL, preset="tiny", seed=0, role=role,
                    disagg_config=JaxDisaggConfig(max_local_prefill_length=16),
                    served_event=served, core_out=self.cores, obs_publish=False,
                    engine_overrides=overrides,
                )
            else:
                rt = await DistributedRuntime.create(self.store.address)
                rt.status = SystemStatusServer(host="127.0.0.1", port=0)
                await rt.status.start()
                coro = run_torch_worker(
                    rt, model_name=MODEL, preset="tiny", seed=0, role=role,
                    disagg_config=DisaggConfig(max_local_prefill_length=16),
                    served_event=served, core_out=self.cores, device="cpu",
                    params=params_from_numpy(self.params, tiny_model(), device="cpu"),
                    obs_publish=False, engine_overrides=overrides,
                )
            self.runtimes.append(rt)
            self.tasks.append(asyncio.create_task(coro))
            await asyncio.wait_for(served.wait(), 60)
            self.worker_ids.append(rt.primary_lease_id)
        front = await JaxRuntime.create(self.store.address)
        self.runtimes.append(front)
        ready = asyncio.Event()
        services: list = []
        self.tasks.append(asyncio.create_task(run_frontend(
            front, http_host="127.0.0.1", http_port=0, router_mode="kv",
            ready_event=ready, service_out=services, fleet_obs=False,
        )))
        await asyncio.wait_for(ready.wait(), 10)
        self.service = services[0]
        self.base_url = f"http://127.0.0.1:{self.service.port}"
        async with aiohttp.ClientSession() as s:
            for _ in range(400):
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

    async def chats(self, max_tokens=6) -> list[bytes]:
        out = []
        async with aiohttp.ClientSession() as s:
            for content in LONG_PROMPTS + ["hi"]:
                body = {"model": MODEL, "messages": [{"role": "user", "content": content}],
                        "max_tokens": max_tokens, "temperature": 0.0}
                async with s.post(f"{self.base_url}/v1/chat/completions", json=body) as r:
                    raw = await r.read()
                    assert r.status == 200, raw
                    out.append(_normalise(raw))
        return out


    async def gauges(self, i: int) -> dict[str, float]:
        """Worker ``i``'s /metrics samples by series name."""
        port = self.runtimes[i].status.port
        async with aiohttp.ClientSession() as s:
            async with s.get(f"http://127.0.0.1:{port}/metrics") as r:
                page = (await r.read()).decode()
        return {line.split("{", 1)[0]: float(line.rsplit(" ", 1)[1])
                for line in page.splitlines() if line and not line.startswith("#")}


async def _reference(params) -> list[bytes]:
    """The aggregated JAX worker's completions."""
    if "chats" not in _REFERENCE:
        async with Fleet([("jax", "aggregated")], params) as f:
            _REFERENCE["chats"] = await f.chats()
    return _REFERENCE["chats"]


@pytest.mark.parametrize(
    "prefill, decode, overrides",
    [("torch", "torch", None), ("jax", "torch", None), ("torch", "jax", None),
     ("torch", "torch", {"scheduling": "chunked", "prefill_chunk": 16})],
    ids=["torch-torch", "jax-prefill-torch-decode", "torch-prefill-jax-decode",
         "torch-torch-chunked"],
)
async def test_disagg_fleet_matches_aggregated_jax(weights, prefill, decode, overrides):
    want = await _reference(weights[1])
    async with Fleet([(prefill, "prefill", overrides), (decode, "decode", overrides)],
                     weights[1]) as f:
        got = await f.chats()
        p_core, d_core = f.cores
        assert got == want
        # The long prompts prefilled remotely and their blocks moved.
        assert d_core.transfer_stats["imported_blocks"] >= 2 * 5
        assert d_core.transfer_stats["dropped_blocks"] == 0
        assert p_core.iterations > 0 and not p_core._held
        if decode == "torch":
            # No recompute: the decode worker prefilled only the tail of
            # each long prompt (and the short prompt's tokens).
            assert d_core.exec_stats["prefill_tokens"] < sum(
                len(p) for p in LONG_PROMPTS)
            g = await f.gauges(1)
            assert g["dynamo_disagg_handoffs_streamed_total"] == 2
            assert g["dynamo_disagg_handoff_fallback_total"] == 0
        if overrides:
            assert p_core.scheduler_stats()["mixed_steps"] > 0


@pytest.mark.parametrize("severed", [1, 2], ids=["window-then-pull", "window-and-pull"])
async def test_severed_handoff_degrades_to_the_same_completion(weights, severed):
    """The first request's first streamed window is severed: the
    reply-gated pull brings the blocks; with that severed too, the decode
    worker recomputes. The completions are the aggregated worker's either
    way."""
    want = await _reference(weights[1])
    try:
        async with Fleet([("torch", "prefill"), ("torch", "decode")], weights[1]) as f:
            chaos.install(chaos.ChaosPlan.from_dict({"rules": [
                {"point": "kv_transfer.pull", "action": "sever", "count": severed},
            ]}))
            got = await f.chats()
            chaos.uninstall()
            assert got == want
            d_core = f.cores[1]
            g = await f.gauges(1)
            assert g["dynamo_disagg_handoff_fallback_total"] >= 1
            assert g["dynamo_disagg_handoffs_total"] == 2
            # Only the first request meets the faults: with both severed it
            # prefills on the decode worker, the second imports.
            recomputed = d_core.exec_stats["prefill_tokens"] >= len(LONG_PROMPTS[0])
            assert recomputed == (severed == 2)
            assert d_core.transfer_stats["imported_blocks"] > 0
    finally:
        chaos.uninstall()


async def _route(push, prompt, rid, **kw):
    pre = JaxRequest.from_wire({"model": MODEL, "token_ids": list(prompt), "request_id": rid,
                                "sampling": {"temperature": 0.0}, "stop": {"max_tokens": 4}})
    toks, cached = [], 0
    async for out in push.generate(pre.to_wire(), rid, list(prompt), **kw):
        toks.extend(out.get("token_ids") or [])
        cached = max(cached, (out.get("meta") or {}).get("cached_tokens", 0))
    push.router.free(rid)
    return toks, cached


@pytest.mark.parametrize("holder, puller", [("torch", "jax"), ("jax", "torch")],
                         ids=["jax-pulls-from-torch-kv-fetch", "torch-honours-peer-prefix"])
async def test_peer_pull_between_torch_and_jax(weights, holder, puller):
    """The holder caches a prompt; the same prompt, routed away from it,
    lands on the puller with the router's peer_prefix hint: the puller
    imports the holder's blocks through kv_fetch instead of recomputing,
    and answers with the same stream."""
    prompt = list(range(1, 90))  # 11 full blocks
    async with Fleet([(holder, "aggregated"), (puller, "aggregated")], weights[1]) as f:
        push = f.service.manager.get(MODEL).push_router
        want, _ = await _route(push, prompt, "seed",
                               router_overrides={"backend_instance_id": f.worker_ids[0]})
        got, cached = await _route(push, prompt, "reroute", exclude={f.worker_ids[0]})
        assert got == want and len(got) == 4
        assert f.cores[1].transfer_stats["imported_blocks"] >= 11
        assert cached >= 11 * f.cores[1].engine.block_size
        assert f.cores[0].cached_prefix_tokens(prompt) > 0  # the pull is a read


async def test_mixed_dtype_peer_pull_fails_fast(weights):
    prompt = list(range(1, 90))
    async with Fleet([("jax", "aggregated"), ("torch", "aggregated", {"kv_dtype": "int8"})],
                     weights[1]) as f:
        push = f.service.manager.get(MODEL).push_router
        await _route(push, prompt, "seed",
                     router_overrides={"backend_instance_id": f.worker_ids[0]})
        got, _ = await _route(push, prompt, "reroute", exclude={f.worker_ids[0]})
        assert len(got) == 4
        t_core = f.cores[1]
        assert t_core.transfer_stats["imported_blocks"] == 0
        pulls = t_core.net_stats_source.__self__  # the worker's PeerPullStats
        assert pulls.dtype_mismatches == 1 and pulls.pulls_fallback == 1
        assert t_core.metrics().net  # the failed pull is priced for the router
