"""The port's speculative decoding with drafts made on the host, under
waves scheduling, against the JAX package's, on the tiny preset and the
CPU.

With ``spec_decode="ngram"`` a speculating decode lane's row is its pending
token plus up to ``spec_k`` tokens drafted by prompt lookup
(``dynamo_tpu_torch/spec``), verified in the ragged forward at sample width
``spec_k + 1``: through ``_plan_verify`` (a single-step verify dispatch) at
megastep k = 1, through ``_plan_fused`` (accept and reject resolved on the
device, the lane going on from the correction token) at k = 8. Each case
drives the same requests through the port's ``EngineCore`` and the JAX
package's (the same weights, carried across by ``engine/convert.py``),
sync and async; one run per configuration is shared by the tests that read
it (``torch_spec_harness.py``). Streams, finish reasons,
``spec_decode_stats()`` and the dispatch counts equal the JAX engine's, and
the port's speculating streams equal its streams with speculation off.
Chunked scheduling's cases are in ``test_torch_spec_chunked.py``, drafting
on the device in ``test_torch_spec_device*.py``.

Tolerances: logits and log-probabilities within 1e-4 (f32 on both sides,
summed in other orders; the tolerance of ``test_torch_model.py``), cache
pages within 1e-5; everything else exact.
"""

import asyncio

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_spec_harness import (
    DISPATCH_KEYS,
    REPEAT_PROMPT,
    SPEC,
    JaxCore,
    JaxRequest,
    PreprocessedRequest,
    assert_logprobs_close,
    drive,
    make_core,
    make_weights,
    matrix_runner,
    wire,
)

from dynamo_tpu.engine import model as jmodel
from dynamo_tpu.engine.config import tiny_engine as j_tiny_engine
from dynamo_tpu.engine.config import tiny_model as j_tiny_model
from dynamo_tpu_torch.backends.torch.main import build_engine
from dynamo_tpu_torch.engine import model as tmodel
from dynamo_tpu_torch.engine.config import tiny_engine, tiny_model
from dynamo_tpu_torch.engine.convert import cache_from_numpy
from dynamo_tpu_torch.engine.core import MEGASTEP_WATCH_W
from dynamo_tpu_torch.ops import ragged_attention as ra

LOGIT_TOL = 1e-4
CACHE_TOL = 1e-5
MATRIX = [("waves", 1), ("waves", 8)]


@pytest.fixture(scope="module")
def weights():
    return make_weights()


@pytest.fixture(scope="module")
def matrix_runs(weights):
    return matrix_runner(weights)


# -- the verify forward ---------------------------------------------------------


def _recording_attention(seen):
    def attention(q, *args, kernel=None, **kw):
        seen.append((q.shape[0], args[2].shape[0], kernel))
        return ra.ragged_paged_attention_ref(q, *args, **kw)
    return attention


def test_verify_tokens_matches_jax(weights):
    """Three lanes of width 5 (a four-token draft, a two-token draft and a
    dead lane) from the same cache: logits within 1e-4 and pages within
    1e-5 of JAX's ``verify_tokens``; dead slots wrote only the garbage
    page; every layer states the tiled form."""
    jcfg, jeng, tcfg, teng = j_tiny_model(), j_tiny_engine(), tiny_model(), tiny_engine()
    g, P = teng.garbage_block, teng.max_blocks_per_seq
    rng = np.random.default_rng(0)
    init = [rng.standard_normal(np.asarray(c).shape).astype(np.float32)
            for c in jmodel.init_cache(jcfg, jeng)]
    jcache = tuple(jnp.asarray(c) for c in init)
    tcache = cache_from_numpy(tuple(init), device="cpu")
    S, R = 3, 5
    tokens = rng.integers(1, 200, (S, R)).astype(np.int32)
    tables = np.full((S, P), g, np.int32)
    tables[0, :3], tables[1, :2], tables[2, :1] = [1, 2, 3], [4, 5], [6]
    positions = np.array([17, 6, 0], np.int32)
    draft_len = np.array([4, 2, 0], np.int32)
    active = np.array([True, True, False])
    args = (tokens, tables, positions, draft_len, active)
    want, jcache = jmodel.verify_tokens(weights[0], jcache, *map(jnp.asarray, args), jcfg, jeng)
    seen = []
    got = tmodel.verify_tokens(weights[1], tcache, *map(torch.from_numpy, args), tcfg, teng,
                               attention=_recording_attention(seen))
    assert got.shape == (S * R, tcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL, rtol=LOGIT_TOL)
    for jc, tc, c0 in zip(jcache, tcache, init):
        np.testing.assert_allclose(tc.numpy()[:g], np.asarray(jc)[:g], atol=CACHE_TOL)
        # Lane 1 (positions 6..8 live, 9 and 10 dead) leaves block 5's
        # rows past position 8 as they were; the dead lane writes nothing.
        np.testing.assert_array_equal(tc.numpy()[5][1:], c0[5][1:])
        assert not np.array_equal(tc.numpy()[5][0], c0[5][0])
        np.testing.assert_array_equal(tc.numpy()[6], c0[6])
    assert seen == [(S * R, S, "tiled")] * tcfg.num_layers


# -- stream parity over the matrix ----------------------------------------------


@pytest.mark.parametrize("scheduling, k", MATRIX)
def test_host_streams_match_jax(matrix_runs, scheduling, k):
    """Speculating streams (tokens, finish reasons, log-probabilities)
    equal the JAX engine's, sync and async."""
    runs = matrix_runs(scheduling, k)
    want = runs["jax", False][0]
    for key in (("jax", True), ("torch", False), ("torch", True)):
        got = runs[key][0]
        assert got[:2] == want[:2], key
        assert_logprobs_close(got[2], want[2])


@pytest.mark.parametrize("scheduling, k", MATRIX)
def test_host_stats_and_dispatches_match_jax(matrix_runs, scheduling, k):
    """``spec_decode_stats()`` and the dispatch counts equal the JAX
    engine's on the same run, sync and async, and drafts were accepted."""
    runs = matrix_runs(scheduling, k)
    for async_exec in (False, True):
        jcore, tcore = runs["jax", async_exec][1], runs["torch", async_exec][1]
        assert tcore.spec_decode_stats() == jcore.spec_decode_stats()
        jst, tst = jcore.scheduler_stats(), tcore.scheduler_stats()
        assert {k2: tst[k2] for k2 in DISPATCH_KEYS} == {k2: jst[k2] for k2 in DISPATCH_KEYS}
    st = runs["torch", False][1].spec_decode_stats()
    assert st["enabled"] == 1 and st["verify_steps"] > 0 and st["accepted_tokens"] > 0
    if k > 1:
        assert runs["torch", False][1].exec_stats["fused_mixed_dispatches"] > 0


@pytest.mark.parametrize("scheduling, k", MATRIX)
def test_host_spec_on_equals_spec_off(matrix_runs, scheduling, k):
    """Verification replays the target's own (seed, counter) choices: the
    port's speculating streams equal its streams with speculation off,
    greedy and seeded, log-probabilities included."""
    runs = matrix_runs(scheduling, k)
    off, on = runs["torch_off"][0], runs["torch", False][0]
    assert on[:2] == off[:2]
    assert_logprobs_close(on[2], off[2])


# -- per-request policy, budgets, stops, observability -----------------------------


def test_spec_settings_refused_as_jax_refuses_them():
    for overrides, match in (({"spec_decode": "medusa"}, "spec_decode"),
                             ({"spec_decode": "ngram", "spec_k": 0}, "spec_k")):
        with pytest.raises(ValueError, match=match):
            JaxCore(j_tiny_model(), j_tiny_engine(**overrides), seed=0)
        with pytest.raises(ValueError, match=match):
            build_engine("tiny", overrides, device="cpu")


def test_per_request_spec_override_matches_jax(weights):
    """Engine default off, a request turns speculation on (and its twin
    stays off, in one batch); engine default on, a request turns it off;
    k clamps to spec_k; an unknown method is refused at admission. The
    streams and stats equal the JAX engine's."""
    got = {}
    for pkg in ("jax", "torch"):
        core = make_core(pkg, weights)
        from_wire = JaxRequest.from_wire if pkg == "jax" else PreprocessedRequest.from_wire
        on = core.add_request(from_wire(wire(REPEAT_PROMPT, "on", 16,
                                              spec={"method": "ngram", "k": 3})))
        off = core.add_request(from_wire(wire(REPEAT_PROMPT, "off", 16)))
        assert on.spec is not None and on.spec.k == 3 and off.spec is None
        toks = {s.request_id: [] for s in (on, off)}
        while core.has_work():
            for s, o in core.step():
                toks[s.request_id] += o.token_ids
        assert toks["on"] == toks["off"]
        core2 = make_core(pkg, weights, **SPEC)
        assert core2.add_request(from_wire(wire(REPEAT_PROMPT, "x", spec={"method": "off"}))).spec is None
        assert core2.add_request(from_wire(wire(REPEAT_PROMPT, "y", spec={"k": 99}))).spec.k == 4
        with pytest.raises(ValueError, match="method"):
            core2.add_request(from_wire(wire(REPEAT_PROMPT, "z", spec={"method": "eagle"})))
        got[pkg] = (toks, core.spec_decode_stats(), core.metrics().spec_decode)
    assert got["torch"] == got["jax"]
    assert got["torch"][1]["verify_rows"] > 0 and got["torch"][1]["enabled"] == 0


def test_spec_respects_max_tokens(weights):
    """Drafts never overshoot the generation budget: exactly max_tokens
    tokens, finish "length", as the JAX engine."""
    got = {}
    for pkg in ("jax", "torch"):
        got[pkg] = drive(make_core(pkg, weights, **SPEC),
                         [wire(REPEAT_PROMPT, "m", 7, ignore_eos=True)])[:2]
    assert got["torch"] == got["jax"]
    assert len(got["torch"][0]["m"]) == 7 and got["torch"][1]["m"] == "length"


def test_fused_waves_spec_respects_token_budget(weights):
    """A token budget smaller than the speculating lane count on a waves
    engine: over-budget lanes wait for later fused steps; k = 8 streams
    equal k = 1 streams and the JAX engine's."""
    wires = [wire([3, 4, 5] * 3, f"s{i}", 10, ignore_eos=True) for i in range(6)]
    got = {}
    for pkg in ("jax", "torch"):
        got[pkg] = [drive(make_core(pkg, weights, **SPEC, megastep_k=k, max_num_batched_tokens=4),
                          wires)[:2] for k in (1, 8)]
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == got["torch"][1]


def test_eos_inside_fused_verify_continuation(weights):
    """A seeded lane that samples EOS inside the continuation of a fused
    verify megastep finishes as the single-step engine does and as the
    JAX engine does."""
    probe = drive(make_core("torch", weights, megastep_k=1),
                  [wire([5, 6] * 4, "p", 12, temperature=0.9, seed=42, ignore_eos=True)])[0]["p"]
    eos = probe[4]
    assert eos not in probe[:4]
    wires = [wire([5, 6] * 4, "e", 12, temperature=0.9, seed=42),
             wire([3, 4, 5] * 3, "n", 12, ignore_eos=True)]
    got = {(pkg, k): drive(make_core(pkg, weights, eos=(eos,), megastep_k=k, **SPEC), wires)[:2]
           for pkg in ("jax", "torch") for k in (1, 8)}
    assert len(set(map(str, got.values()))) == 1
    assert got["torch", 8][1]["e"] == "eos" and got["torch", 8][0]["e"] == probe[:5]


def test_watch_overflow_forces_single_step_with_spec(weights):
    """A speculating request watching more stop ids than the device's
    slots runs single-step verify dispatches (the host stop scan sees the
    whole list) and counts the forced single steps. The stop id is picked
    where it first occurs in the probe stream (its sixth token), so the
    stream ends there; the JAX engine's stream is the same."""
    probe = drive(make_core("torch", weights, megastep_k=1),
                  [wire([3, 4, 5] * 3, "p", 20, ignore_eos=True)])[0]["p"]
    first = next(j for j in range(5, len(probe)) if probe[j] not in probe[:j])
    stop_ids = list(range(300, 300 + MEGASTEP_WATCH_W)) + [probe[first]]
    wires = [wire([3, 4, 5] * 3, "x", 20, stop_token_ids=stop_ids, ignore_eos=True)]
    got = {}
    for pkg in ("jax", "torch"):
        core = make_core(pkg, weights, megastep_k=8, **SPEC)
        got[pkg] = drive(core, wires)[:2]
        assert core.exec_stats["megastep_dispatches"] == 0
        assert core.exec_stats["fused_mixed_dispatches"] == 0
        assert core.exec_stats["megastep_forced_single"] >= 1
    assert got["torch"] == got["jax"]
    assert got["torch"] == ({"x": probe[: first + 1]}, {"x": "stop"})


def test_metrics_and_gauges_carry_spec_stats(weights):
    """``metrics().spec_decode`` is the stats dict once speculation is on
    (None on an engine that never speculated), round-trips the wire, and
    the worker's spec gauges read it."""
    from dynamo_tpu_torch.llm.kv_router.protocols import ForwardPassMetrics
    from dynamo_tpu_torch.runtime.metrics import MetricsRegistry
    from dynamo_tpu_torch.runtime.status_server import (
        SPEC_GAUGES,
        SystemStatusServer,
        bind_spec_gauges,
    )

    got = {}
    for pkg in ("jax", "torch"):
        core = make_core(pkg, weights, **SPEC)
        drive(core, [wire(REPEAT_PROMPT, "g", 12, ignore_eos=True)])
        got[pkg] = (core.metrics().spec_decode, make_core(pkg, weights).metrics().spec_decode)
    assert got["torch"] == got["jax"]
    fpm = core.metrics()
    assert fpm.spec_decode["enabled"] == 1 and fpm.spec_decode["acceptance_rate"] > 0
    assert ForwardPassMetrics.from_wire(fpm.to_wire()).spec_decode == fpm.spec_decode
    status = SystemStatusServer(MetricsRegistry())
    bind_spec_gauges(status, core.spec_decode_stats)
    text = status.metrics.render()
    text = text.decode() if isinstance(text, bytes) else text
    for name, _doc in SPEC_GAUGES.values():
        assert name in text
    assert "spec_decode_enabled" in text


async def test_dyn_spec_decode_through_the_ports_frontend_to_a_torch_worker(weights):
    """A chat request's ``dyn.spec_decode`` travels through the port's
    OpenAI frontend and KV-free router to a torch worker whose engine
    default is off: the worker speculates for that request only, and its
    completion equals the same request's without speculation."""
    import aiohttp

    from dynamo_tpu_torch.backends.torch.main import run_torch_worker
    from dynamo_tpu_torch.frontend.main import run_frontend
    from dynamo_tpu_torch.runtime import DistributedRuntime
    from dynamo_tpu_torch.runtime.store import StoreServer

    store = StoreServer()
    await store.start()
    runtimes, tasks, cores = [], [], []
    try:
        rt = await DistributedRuntime.create(store.address)
        runtimes.append(rt)
        served = asyncio.Event()
        tasks.append(asyncio.create_task(run_torch_worker(
            rt, model_name="tinyspec", preset="tiny", seed=0, served_event=served,
            core_out=cores, device="cpu", params=weights[1], obs_publish=False,
        )))
        await asyncio.wait_for(served.wait(), 60)
        front = await DistributedRuntime.create(store.address)
        runtimes.append(front)
        ready, services = asyncio.Event(), []
        tasks.append(asyncio.create_task(run_frontend(
            front, http_host="127.0.0.1", http_port=0, router_mode="round_robin",
            ready_event=ready, service_out=services, fleet_obs=False,
        )))
        await asyncio.wait_for(ready.wait(), 10)
        url = f"http://127.0.0.1:{services[0].port}"
        bodies = {}
        async with aiohttp.ClientSession() as s:
            for _ in range(200):
                async with s.get(f"{url}/v1/models") as r:
                    if (await r.json())["data"]:
                        break
                await asyncio.sleep(0.05)
            for name, extra in (("off", {}), ("on", {"dyn": {"spec_decode": {"method": "ngram", "k": 2}}})):
                body = {"model": "tinyspec", "prompt": "abcabcabcabcabcabc", "max_tokens": 16,
                        "temperature": 0.0, "ignore_eos": True, **extra}
                async with s.post(f"{url}/v1/completions", json=body) as r:
                    assert r.status == 200
                    bodies[name] = (await r.json())["choices"][0]["text"]
                if name == "off":
                    assert cores[0].spec_stats.verify_rows == 0
        assert bodies["on"] == bodies["off"]
        st = cores[0].spec_decode_stats()
        assert st["verify_rows"] > 0 and st["enabled"] == 0
    finally:
        for rt in runtimes:
            rt.signal_shutdown()
        await asyncio.sleep(0.1)
        for t in tasks:
            t.cancel()
        for rt in runtimes:
            try:
                await rt.shutdown()
            except (ConnectionError, OSError, RuntimeError):
                pass
        await store.stop()
