"""The port's async execution against the JAX package's, on the tiny preset.

With ``async_exec`` on, the engine plans and dispatches step N+1 while
step N is in flight (device-resident token feedback, optimistic cursor
overlays, outputs landed one step later), and its token streams stay
those of the synchronous loop. Each case drives the same requests through
the port's ``EngineCore`` and the JAX package's (waves scheduling, the
same weights carried across by ``engine/convert.py``) and compares the
streams and finish reasons exactly, with async on and off on both sides:
greedy and seeded sampling at megastep k=1 and k=8, a prefix-cache
replay, stops and EOS that land one step late, block pressure that drains
the pipeline, and a cancel while a step is in flight. The observability
of the loop (the dispatch/land order, the spans, the flight recorder's
step records and ``scheduler_stats()``) is held to the JAX core's names.
Logprob values agree to 1e-4 (f32 on both sides, summed in other orders).
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu import tracing as jtracing
from dynamo_tpu.tracing import core as jtracing_core
from dynamo_tpu.engine import EngineCore as JaxCore
from dynamo_tpu.engine import model as jmodel
from dynamo_tpu.engine.config import tiny_engine as j_tiny_engine
from dynamo_tpu.engine.config import tiny_model as j_tiny_model
from dynamo_tpu.engine.sampler import gather_feedback as j_gather_feedback
from dynamo_tpu.llm.protocols.common import PreprocessedRequest as JaxRequest
from dynamo_tpu_torch import tracing
from dynamo_tpu_torch.tracing import core as tracing_core
from dynamo_tpu_torch.backends.torch import main as worker_main
from dynamo_tpu_torch.backends.torch.main import build_engine, run_torch_worker
from dynamo_tpu_torch.engine.config import tiny_model
from dynamo_tpu_torch.engine.convert import params_from_numpy
from dynamo_tpu_torch.engine.sampler import gather_feedback
from dynamo_tpu_torch.llm.protocols.common import PreprocessedRequest
from dynamo_tpu_torch.runtime import Context, DistributedRuntime
from dynamo_tpu_torch.runtime.store import StoreServer

LP_TOL = 1e-4


@pytest.fixture(scope="module")
def weights():
    jparams = jmodel.init_params(jax.random.PRNGKey(0), j_tiny_model())
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tiny_model(), device="cpu")
    return jparams, tparams


def _wire(prompt, rid, max_tokens=8, temperature=0.0, seed=None, top_k=0, top_p=1.0,
          logprobs=None, **stop):
    w = {
        "model": "tiny", "token_ids": [int(t) for t in prompt], "request_id": rid,
        "sampling": {"temperature": temperature, "seed": seed, "top_k": top_k, "top_p": top_p},
        "stop": {"max_tokens": max_tokens, **stop},
    }
    if logprobs is not None:
        w["output"] = {"logprobs": logprobs}
    return w


def _cores(weights, eos=(), **eng):
    """JAX sync, JAX async, port sync and port async engines, same weights."""
    out = {}
    for async_exec in (False, True):
        cfg = {**eng, "async_exec": async_exec}
        out["jax", async_exec] = JaxCore(
            j_tiny_model(), j_tiny_engine(**cfg), params=weights[0], eos_token_ids=eos,
        )
        out["torch", async_exec] = build_engine(
            "tiny", cfg, eos_token_ids=eos, device="cpu", params=weights[1],
        )[0]
    return out


def drive(core, wires, max_steps=4000):
    """Run to completion, draining the pipeline's tail (an in-flight step
    holds a stream's last tokens until the next step() call). Returns
    (tokens, finish reasons, logprob entries) by request id."""
    from_wire = JaxRequest.from_wire if isinstance(core, JaxCore) else PreprocessedRequest.from_wire
    seqs = [core.add_request(from_wire(w)) for w in wires]
    toks = {s.request_id: [] for s in seqs}
    fins: dict[str, str] = {}
    lps = {s.request_id: [] for s in seqs}
    for _ in range(max_steps):
        for s, out in core.step():
            toks[s.request_id].extend(out.token_ids)
            if out.logprobs:
                lps[s.request_id].extend(out.logprobs)
            if out.finish_reason:
                fins[s.request_id] = out.finish_reason
        if len(fins) == len(seqs) and not core.has_work():
            break
    assert len(fins) == len(seqs) and not core.has_work(), "engine did not finish"
    return toks, fins, lps


def _run_all(cores, wires):
    return {k: drive(c, wires) for k, c in cores.items()}


def _assert_same_streams(runs):
    want = runs["jax", False][:2]
    for key, got in runs.items():
        assert got[:2] == want, key


def _assert_logprobs_close(a, b):
    assert a.keys() == b.keys()
    for rid in a:
        assert len(a[rid]) == len(b[rid]), rid
        for x, y in zip(a[rid], b[rid]):
            assert x["token_id"] == y["token_id"]
            assert abs(x["logprob"] - y["logprob"]) <= LP_TOL
            assert [t for t, _ in x["top"]] == [t for t, _ in y["top"]]
            assert np.allclose([v for _, v in x["top"]], [v for _, v in y["top"]], atol=LP_TOL)


def _mixed_workload():
    rng = np.random.RandomState(0)
    long_prompt = list(rng.randint(1, 200, size=200))
    wires = [_wire(list(range(i + 1, i + 9)), max_tokens=12, rid=f"s{i}") for i in range(4)]
    return wires + [_wire(long_prompt, max_tokens=6, rid="long")]


# -- gather_feedback ----------------------------------------------------------


@pytest.mark.parametrize("prev_shape", [(6,), (3, 4)])
def test_gather_feedback_matches_jax(prev_shape):
    rng = np.random.default_rng(1)
    n = int(np.prod(prev_shape))
    prev = rng.integers(0, 1000, prev_shape).astype(np.int32)
    host = rng.integers(0, 1000, 9).astype(np.int32)
    src = rng.integers(-1, n, 9).astype(np.int32)
    src[:2] = [-1, n - 1]
    want = np.asarray(j_gather_feedback(jnp.asarray(prev), jnp.asarray(host), jnp.asarray(src)))
    got = gather_feedback(*(torch.from_numpy(a) for a in (prev, host, src)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


# -- stream parity ------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 8])
def test_greedy_streams_match_jax_sync_and_async(weights, k):
    runs = _run_all(_cores(weights, megastep_k=k), _mixed_workload())
    _assert_same_streams(runs)


@pytest.mark.parametrize("k", [1, 8])
def test_seeded_temperature_streams_match_jax(weights, k):
    """Seeded lanes (plain temperature, top-k and top-p in one batch)
    replay the same (seed, counter) keys through the overlay."""
    wires = [
        _wire([3, 5, 7, 9], "t", max_tokens=10, temperature=0.8, seed=11, ignore_eos=True),
        _wire([4, 6, 8], "k", max_tokens=10, temperature=0.7, seed=12, top_k=8,
              ignore_eos=True),
        _wire([2, 4, 6, 8, 10], "p", max_tokens=10, temperature=0.9, seed=13, top_p=0.8,
              logprobs=3, ignore_eos=True),
    ]
    runs = _run_all(_cores(weights, megastep_k=k), wires)
    _assert_same_streams(runs)
    assert runs["torch", True][2] == runs["torch", False][2]  # same values, bit for bit
    _assert_logprobs_close(runs["torch", True][2], runs["jax", False][2])


def test_prefix_cache_replay_matches_jax(weights):
    prompt = list(range(3, 63))
    got = {}
    for key, core in _cores(weights).items():
        warm = drive(core, [_wire(prompt, "warm", max_tokens=5)])
        hit = drive(core, [_wire(prompt, "hit", max_tokens=5)])
        got[key] = (warm[:2], hit[:2], core.kv_cache_stats()["admitted_hits"])
    assert all(v == got["jax", False] for v in got.values()), got
    assert got["torch", True][2] == 1


# -- late stops roll back -----------------------------------------------------


def test_late_stop_rolls_back_optimistic_step(weights):
    """With k=1, a stop token commits one step AFTER the next step was
    dispatched: the lane's in-flight tokens are discarded and the stream
    is the synchronous loop's."""
    ref = build_engine("tiny", {"megastep_k": 1}, device="cpu", params=weights[1])[0]
    stop_tok = drive(ref, [_wire([9, 9, 9], "r", max_tokens=12, ignore_eos=True)])[0]["r"][5]
    cores = _cores(weights, megastep_k=1)
    runs = _run_all(cores, [_wire([9, 9, 9], "x", max_tokens=12,
                                  stop_token_ids=[stop_tok], ignore_eos=True)])
    _assert_same_streams(runs)
    assert runs["torch", True][1] == {"x": "stop"}
    sync, asy = cores["torch", False].exec_stats, cores["torch", True].exec_stats
    assert asy["dispatches"] > sync["dispatches"]  # a step past the stop ran and was dropped
    assert asy["dispatches"] == cores["jax", True].exec_stats["dispatches"]


def test_late_eos_rolls_back(weights):
    ref = build_engine("tiny", {"megastep_k": 1}, device="cpu", params=weights[1])[0]
    stream = drive(ref, [_wire([1, 2, 3], "p", max_tokens=10, ignore_eos=True)])[0]["p"]
    eos = next(t for i, t in enumerate(stream) if i >= 3 and t not in stream[:i])
    runs = _run_all(_cores(weights, eos=(eos,), megastep_k=1),
                    [_wire([1, 2, 3], "e", max_tokens=10)])
    _assert_same_streams(runs)
    assert runs["torch", True][1] == {"e": "eos"}


def test_context_edge_chain_lengths_match_jax(weights):
    """At k=8, requests run to max_model_len with a step in flight: each
    megastep's length is capped by the context edge and the budget read
    through the overlay, so no plan grows past the block table, and the
    port dispatches the same chain lengths as the JAX core, sync and
    async."""
    cores = _cores(weights, max_model_len=64, megastep_k=8)
    chains = {}
    for key, core in cores.items():
        log = chains[key] = []
        inner = core._chain_length
        core._chain_length = lambda seqs, _f=inner, _log=log: _log.append(_f(seqs)) or _log[-1]
    rng = np.random.RandomState(3)
    wires = [
        _wire(list(rng.randint(1, 200, size=51)), "edge", max_tokens=None, ignore_eos=True),
        _wire(list(rng.randint(1, 200, size=45)), "near", max_tokens=None, ignore_eos=True),
        _wire([5, 6, 7], "short", max_tokens=20, ignore_eos=True),
    ]
    runs = _run_all(cores, wires)
    _assert_same_streams(runs)
    toks, fins, _ = runs["torch", True]
    assert fins == {"edge": "length", "near": "length", "short": "length"}
    assert [len(toks[r]) for r in ("edge", "near", "short")] == [13, 19, 20]
    for async_exec in (False, True):
        assert chains["torch", async_exec] == chains["jax", async_exec], async_exec
    assert max(chains["torch", True]) == 8 and min(chains["torch", True]) < 8


@pytest.mark.parametrize("async_exec, scheduling", [
    pytest.param(False, "waves", id="False"),
    pytest.param(True, "waves", id="True"),
    pytest.param(False, "chunked", id="chunked-False"),
    pytest.param(True, "chunked", id="chunked-True"),
])
def test_warm_up_enumerates_every_dispatched_key(weights, async_exec, scheduling):
    """Every graph key that serving dispatches is one that ``warm_up()``
    captures on the card: all sampling variants, and every chain length
    the context edge and the budgets cut a megastep to; under chunked
    scheduling every (token bucket, width) of a mixed step and of a fused
    megastep, and no prefill wave."""
    core = build_engine("tiny", {"max_model_len": 64, "megastep_k": 8, "async_exec": async_exec,
                                 "scheduling": scheduling},
                        device="cpu", params=weights[1])[0]
    warm = {launch.key for launch, _ in core._warm_up_launches()}
    seen = set()
    inner = core._launch
    core._launch = lambda launch, feed=None: seen.add(launch.key) or inner(launch, feed)
    rng = np.random.RandomState(4)
    wires = [
        _wire(list(rng.randint(1, 200, size=51)), "edge", max_tokens=None, ignore_eos=True),
        _wire(list(rng.randint(1, 200, size=50)), "wide", max_tokens=4),  # a 128-token wave
        _wire([3, 5, 7], "g_lp", max_tokens=11, logprobs=2),
        _wire([4, 6], "t", max_tokens=6, temperature=0.8, seed=1),
        _wire([4, 6, 9], "t_lp", max_tokens=5, temperature=0.8, seed=2, logprobs=1),
        _wire([2, 8], "m", max_tokens=9, temperature=0.7, seed=3, top_k=5),
        _wire([2, 8, 1], "m_lp", max_tokens=3, temperature=0.7, seed=4, top_p=0.5, logprobs=1),
    ]
    drive(core, wires)  # all of them in one batch, then each variant alone
    for w in wires:
        drive(core, [{**w, "request_id": w["request_id"] + "_solo"}])
    if scheduling == "chunked":
        # A fresh prompt longer than a chunk, alone: a mixed step.
        drive(core, [_wire(list(rng.randint(1, 200, size=60)), "alone", max_tokens=2)])
    assert seen <= warm, sorted(seen - warm)
    if scheduling == "chunked":
        assert {key[0] for key in seen} == {key[0] for key in warm} == {"mixed", "fused", "decode"}
        assert {key[3] for key in seen if key[0] == "fused"} == {2, 4, 8}
        assert {key[1:3] for key in seen if key[0] == "fused"} >= {(32, 4), (128, 8)}
        assert {key[-3:] for key in seen} >= {(False, True, False), (False, False, True)}
        # variants x (6 (bucket, width) shapes x (mixed + 3 fused chains) + widths x chains)
        assert core._chunked_shapes() == [(T, w) for T in (32, 64, 128) for w in (4, 8)]
        assert len(warm) == 6 * (6 * 4 + 2 * 4)
        return
    assert {key[0] for key in seen} == {"prefill", "decode"}
    assert {key[2] for key in seen if key[0] == "decode"} >= {1, 2, 4, 8}
    assert {key[-3:] for key in seen} >= {(False, True, False), (False, False, True)}
    assert any(key[:2] == ("prefill", 128) for key in seen)  # a bucket above max_model_len
    assert len(warm) == 6 * (3 + 2 * 4)  # variants x (prefill buckets + widths x chains)


# -- pressure, cancels --------------------------------------------------------


def test_block_pressure_drains_pipeline_and_recovers(weights):
    """Out of blocks mid-plan with a step in flight: the engine commits the
    in-flight step (a drain), re-plans settled, preempts, and the replayed
    streams are the synchronous loop's."""
    cores = _cores(weights, num_kv_blocks=10, max_model_len=64, megastep_k=1)
    wires = [
        _wire(list(range(1, 17)), "a", max_tokens=24),
        _wire(list(range(20, 36)), "b", max_tokens=24),
        _wire(list(range(40, 80)), "c", max_tokens=8),
    ]
    runs = _run_all(cores, wires)
    _assert_same_streams(runs)
    core = cores["torch", True]
    assert core.exec_stats["drains"] >= 1
    assert core.exec_stats["drains"] == cores["jax", True].exec_stats["drains"]
    assert core.sched_stats["preemptions"] >= 1
    for c in (core, cores["torch", False]):
        assert c.allocator._partials == 0


def test_cancel_mid_flight_discards_in_flight_tokens(weights):
    core = build_engine("tiny", {"async_exec": True, "megastep_k": 1}, device="cpu",
                        params=weights[1])[0]
    seq = core.add_request(PreprocessedRequest.from_wire(
        _wire([1, 2, 3], "c", max_tokens=50, ignore_eos=True)))
    core.step()  # dispatch the prefill wave
    core.step()  # dispatch decode 1, commit the prefill
    assert core._inflight is not None
    core.cancel_request(seq)
    for _ in range(5):
        core.step()
    assert not core.has_work()
    assert seq not in core.running
    assert core.allocator._partials == 0
    assert core.allocator.free_blocks == core.allocator.capacity


# -- the pipelining contract --------------------------------------------------


def _exec_log(weights, async_exec):
    core = build_engine("tiny", {"async_exec": async_exec, "megastep_k": 1}, device="cpu",
                        params=weights[1])[0]
    core._exec_log = []
    drive(core, [_wire([1, 2, 3, 4], "a", max_tokens=20, ignore_eos=True),
                 _wire([5, 6, 7, 8], "b", max_tokens=20, ignore_eos=True)])
    log = core._exec_log
    disp = {n: i for i, (k, n) in enumerate(log) if k == "dispatch"}
    land = {n: i for i, (k, n) in enumerate(log) if k == "land"}
    return disp, land


@pytest.mark.parametrize("async_exec", [True, False])
def test_exec_log_order(weights, async_exec):
    """Async: every landing of step n comes after dispatch n+1 (the last
    step's drain excepted). Sync: every landing precedes the next
    dispatch."""
    disp, land = _exec_log(weights, async_exec)
    assert len(disp) >= 20 and land.keys() == disp.keys()
    last = max(disp)
    if async_exec:
        assert [n for n in land if n < last and disp[n + 1] > land[n]] == []
    else:
        assert all(land[n] < disp[n + 1] for n in land if n < last)


# -- observability ------------------------------------------------------------


def test_spans_and_flight_records_match_jax(weights):
    """The same requests through both async cores file the same engine
    stat spans with the same attribute names, and the same flight-recorder
    step records, field for field."""
    wires = [_wire(list(range(1, 20)), "a", max_tokens=20, ignore_eos=True),
             _wire(list(range(5, 9)), "b", max_tokens=6, ignore_eos=True)]
    got = {}
    for pkg, trc, state in (("jax", jtracing, jtracing_core._STATE),
                            ("torch", tracing, tracing_core._STATE)):
        before = (state.enabled, state.sample)
        trc.configure(enabled=True, sample=1.0)
        collector = trc.get_collector()
        collector.clear()
        try:
            core = _cores(weights, megastep_k=8)[pkg, True]
            drive(core, wires)
            spans = collector.stats()
            got[pkg] = (
                {(s.name, tuple(sorted(s.attrs))) for s in spans},
                [{k: v for k, v in r.items() if k != "t"} for r in core.flight.snapshot()],
                core,
                [s for s in spans if s.name == "host_gap"],
            )
        finally:
            collector.clear()
            trc.configure(enabled=before[0], sample=before[1])
    names = {n for n, _ in got["torch"][0]}
    assert {"engine_commit", "host_gap", "engine_prefill_step", "engine_decode_step",
            "engine_megastep", "engine_plan", "sched_admit"} <= names
    assert got["torch"][0] == got["jax"][0]
    assert got["torch"][1] == got["jax"][1] and got["torch"][1]
    assert any(s.attrs.get("overlapped") for s in got["torch"][3])
    core = got["torch"][2]
    assert core._t_prev_dispatch == 0.0  # idle: the host_gap chain is broken
    assert core.exec_stats["last_host_gap_ms"] > 0.0


@pytest.mark.parametrize("async_exec", [False, True])
def test_scheduler_stats_carry_every_jax_key(weights, async_exec):
    cores = _cores(weights, megastep_k=8)
    runs = {}
    for pkg in ("jax", "torch"):
        drive(cores[pkg, async_exec], _mixed_workload())
        runs[pkg] = cores[pkg, async_exec].scheduler_stats()
    missing = set(runs["jax"]) - set(runs["torch"])
    assert not missing
    for key in ("async_exec", "dispatches", "commits", "drains", "megastep_dispatches",
                "single_step_dispatches", "committed_tokens", "dispatches_per_token",
                "token_budget", "chunked_scheduling", "preemptions", "pp_stages"):
        assert runs["torch"][key] == runs["jax"][key], key
    assert runs["torch"]["graph_captures"] == runs["torch"]["graph_replays"] == 0  # CPU


# -- the worker ----------------------------------------------------------------


def test_worker_cli_accepts_async_exec():
    args = worker_main._parser().parse_args(["--async-exec", "on"])
    overrides = worker_main._overrides(args)
    assert overrides == {"async_exec": True}
    worker_main.check_slice(*worker_main.engine_configs("tiny", overrides), device="cpu")


async def test_async_worker_serves_the_sync_engines_streams():
    """A worker with async execution answers the in-process synchronous
    engine's streams chunk for chunk (bar the engine step that each first
    chunk names), and names its flight recorder after its worker id."""
    rng = np.random.default_rng(5)
    prompts = [[int(t) for t in rng.integers(1, 384, n)] for n in (9, 23, 5)]

    def request(prompt):
        return PreprocessedRequest.from_wire(_wire(prompt, "", max_tokens=9)).to_wire()

    _, engine = build_engine("tiny", seed=0, device="cpu")
    want = [[o async for o in engine.generate(request(p), Context(f"w{i}"))]
            for i, p in enumerate(prompts)]
    store = StoreServer()
    await store.start()
    rt = await DistributedRuntime.create(store.address)
    client_rt = await DistributedRuntime.create(store.address)
    served, cores = asyncio.Event(), []
    task = asyncio.create_task(run_torch_worker(
        rt, model_name="tiny", preset="tiny", seed=0, served_event=served, device="cpu",
        engine_overrides={"async_exec": True}, core_out=cores,
    ))
    try:
        await asyncio.wait_for(served.wait(), 60)
        client = await client_rt.namespace("dynamo").component("backend").endpoint(
            "generate").client()
        await client.wait_for_instances(1, timeout=10)
        got = []
        for p in prompts:
            got.append([o async for o in await client.round_robin(request(p))])
    finally:
        rt.signal_shutdown()
        await asyncio.sleep(0.05)
        task.cancel()
        await client_rt.shutdown()
        await rt.shutdown()
        await store.stop()
    # The first chunk's meta names the engine step that emitted it, which
    # differs with async execution (one step later per request, and the
    # pipeline's drain steps), as in the JAX engine.
    for outs in got + want:
        del outs[0]["meta"]["iteration"]
    assert got == want
    assert cores[0].engine.async_exec
    assert cores[0].flight.name == f"worker-{rt.primary_lease_id}"
    assert cores[0].exec_stats["commits"] == cores[0].exec_stats["dispatches"] > 0
