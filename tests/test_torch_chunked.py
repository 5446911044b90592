"""The port's chunked scheduler against the JAX package's, on the tiny
preset and the CPU.

With ``scheduling="chunked"`` every engine step puts the runnable decode
rows (q_len 1) next to prefill chunks in one ragged forward under the
token budget (``_plan_mixed``), and with megastep k > 1 fuses that forward
with k - 1 decode iterations in one dispatch (``_plan_fused``,
``_megastep_fused_body``), falling back to the single step where fusion
does not apply. Each case drives the same requests through the port's
``EngineCore`` and the JAX package's (the same weights carried across by
``engine/convert.py``), sync and async, and compares token streams and
finish reasons exactly: greedy and seeded sampling at k = 1 and k = 8, a
cached prefix that ends mid-chunk, preemption between chunks under block
pressure. The port's chunked streams equal its waves streams, greedy, as
the JAX package pins them. The fused body alone, the sampler's
``resolve_verify`` and ``stop_flags_prefix``, the scheduler gauges, the
step spans and the flight recorder are held to the JAX package's, and
each forward states the attention kernel form it needs.

Tolerances: log-probabilities within 1e-4 (f32 on both sides, summed in
other orders); the fused body's cache pages within 1e-5; everything else
exact.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu import tracing as jtracing
from dynamo_tpu.engine import EngineCore as JaxCore
from dynamo_tpu.engine import core as jcore
from dynamo_tpu.engine import model as jmodel
from dynamo_tpu.engine import sampler as jsampler
from dynamo_tpu.engine.config import tiny_engine as j_tiny_engine
from dynamo_tpu.engine.config import tiny_model as j_tiny_model
from dynamo_tpu.llm.protocols.common import PreprocessedRequest as JaxRequest
from dynamo_tpu.tracing import core as jtracing_core
from dynamo_tpu_torch import tracing
from dynamo_tpu_torch.backends.torch.main import build_engine
from dynamo_tpu_torch.engine import core as tcore
from dynamo_tpu_torch.engine import model as tmodel
from dynamo_tpu_torch.engine import sampler as tsampler
from dynamo_tpu_torch.engine.config import tiny_engine, tiny_model
from dynamo_tpu_torch.engine.convert import cache_from_numpy, params_from_numpy
from dynamo_tpu_torch.llm.protocols.common import PreprocessedRequest
from dynamo_tpu_torch.ops import ragged_attention as ra
from dynamo_tpu_torch.tracing import core as tracing_core

LP_TOL = 1e-4
CACHE_TOL = 1e-5
CHUNKED = {"scheduling": "chunked", "prefill_chunk": 32}


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
    """Run to completion, the pipeline's tail drained. Returns (tokens,
    finish reasons, logprob entries) by request id."""
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
    """Four short prompts and one of 200 tokens (chunks of 32 next to the
    short ones' decode rows)."""
    rng = np.random.RandomState(0)
    long_prompt = list(rng.randint(1, 200, size=200))
    wires = [_wire(list(range(i + 1, i + 9)), max_tokens=12, rid=f"s{i}") for i in range(4)]
    return wires + [_wire(long_prompt, max_tokens=6, rid="long")]


def _path_counts(core):
    st = core.scheduler_stats()
    return {k: st[k] for k in ("mixed_steps", "megastep_dispatches", "fused_mixed_dispatches",
                               "single_step_dispatches", "preemptions", "drains")}


# -- the sampler's fused-iteration functions ----------------------------------


@pytest.mark.parametrize("R", [1, 2, 5])
def test_resolve_verify_matches_jax(R):
    rng = np.random.default_rng(R)
    S = 7
    sampled = rng.integers(0, 4, (S, R)).astype(np.int32)
    draft = np.full((S, R - 1), -1, np.int32)
    draft_len = rng.integers(0, R, S).astype(np.int32)
    for i in range(S):
        n = draft_len[i]
        agree = rng.random(n) < 0.7
        draft[i, :n] = np.where(agree, sampled[i, :n], rng.integers(0, 4, n))
    want = jsampler.resolve_verify(*map(jnp.asarray, (sampled, draft, draft_len)))
    got = tsampler.resolve_verify(*map(torch.from_numpy, (sampled, draft, draft_len)))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("R, with_base", [(1, False), (3, False), (3, True)])
def test_stop_flags_prefix_matches_jax(R, with_base):
    rng = np.random.default_rng(10 + R)
    S, W = 9, 4
    sampled = rng.integers(0, 6, (S, R)).astype(np.int32)
    accepted = rng.integers(0, R, S).astype(np.int32)
    watch = np.where(rng.random((S, W)) < 0.5, rng.integers(0, 6, (S, W)), -1).astype(np.int32)
    budgets = rng.integers(1, R + 3, S).astype(np.int32)
    min_left = rng.integers(0, R + 2, S).astype(np.int32)
    base = rng.integers(0, 3, S).astype(np.int32) if with_base else None
    args = (sampled, accepted, watch, budgets, min_left)
    want = jsampler.stop_flags_prefix(
        *map(jnp.asarray, args), None if base is None else jnp.asarray(base))
    got = tsampler.stop_flags_prefix(
        *map(torch.from_numpy, args), None if base is None else torch.from_numpy(base))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- the fused body alone -----------------------------------------------------


def test_fused_body_matches_jax(weights):
    """Two decode rows, a chunk that completes its prompt and a mid-prompt
    chunk in one fused megastep of 4 iterations, from the same cache:
    equal tokens and log-probabilities, cache pages within 1e-5, and the
    mid-prompt lane's continuation writes nothing but the garbage block."""
    jcfg, jeng, tcfg, teng = j_tiny_model(), j_tiny_engine(), tiny_model(), tiny_engine()
    bs, g, P = teng.block_size, teng.garbage_block, teng.max_blocks_per_seq
    rng = np.random.default_rng(3)
    init = [rng.standard_normal(np.asarray(c).shape).astype(np.float32)
            for c in jmodel.init_cache(jcfg, jeng)]
    jcache = tuple(jnp.asarray(c) for c in init)
    tcache = cache_from_numpy(tuple(init), device="cpu")
    # lane: (tokens, first position, kv length, blocks)
    lanes = [
        ([17], 12, 13, [1, 2]),                     # decode row, 12 cached
        ([40], 5, 6, [3]),                          # decode row, 5 cached
        (list(range(50, 60)), 0, 10, [4, 5, 6]),    # chunk completing a 10-token prompt
        (list(range(70, 78)), 0, 8, [7, 8, 9]),     # first chunk of a 20-token prompt
    ]
    S, T, n_steps = 4, 32, 4
    tokens, positions = np.zeros(T, np.int32), np.zeros(T, np.int32)
    write_pages, write_offs = np.full(T, g, np.int32), np.zeros(T, np.int32)
    kv_lens, tables = np.zeros(S, np.int32), np.full((S, P), g, np.int32)
    cu, gather = np.zeros(S + 1, np.int32), np.zeros(S, np.int32)
    t = 0
    for i, (toks, p0, kv, blocks) in enumerate(lanes):
        n = len(toks)
        pos = np.arange(p0, p0 + n)
        tokens[t : t + n], positions[t : t + n] = toks, pos
        write_pages[t : t + n] = np.asarray(blocks)[pos // bs]
        write_offs[t : t + n] = pos % bs
        kv_lens[i], tables[i, : len(blocks)] = kv, blocks
        t += n
        cu[i + 1], gather[i] = t, t - 1
    seeds = np.array([3, 4, 5, 6], np.int32)
    counters = np.array([7, 2, 0, 0], np.int32)
    temp = np.array([0.0, 0.8, 0.9, 0.7], np.float32)
    top_k, top_p = np.zeros(S, np.int32), np.ones(S, np.float32)
    cont = np.array([True, True, True, False])
    base_pos = np.array([13, 6, 10, 0], np.int32)
    watch = np.full((S, 8), -1, np.int32)
    budgets = np.array([9, 9, 3, n_steps + 2], np.int32)
    min_left = np.zeros(S, np.int32)
    ragged = [tokens, positions, write_pages, write_offs, kv_lens, tables, cu,
              np.array([S], np.int32), gather, seeds, counters, temp, top_k, top_p]
    lanes_in = [cont, base_pos, seeds, temp, top_k, top_p, watch, budgets, min_left]
    kw = dict(n_steps=n_steps, need_mask=False, all_greedy=False, want_logprobs=True)

    want, want_lps, jcache = jcore._megastep_fused_body(
        weights[0], jcache, *map(jnp.asarray, ragged),
        jnp.zeros((1, 1), jnp.float32), jnp.zeros(1, bool),
        jnp.full((S, 0), -1, jnp.int32), jnp.zeros(S, jnp.int32),
        *map(jnp.asarray, lanes_in), want_mm=False, cfg=jcfg, engine=jeng, **kw,
    )
    got, got_lps = tcore._megastep_fused_body(
        weights[1], tcache, *map(torch.from_numpy, ragged),
        torch.full((S, 0), -1, dtype=torch.int32), torch.zeros(S, dtype=torch.int32),
        *map(torch.from_numpy, lanes_in), cfg=tcfg, engine=teng, **kw,
    )
    assert got.shape == (n_steps, S, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(got_lps[0].numpy(), np.asarray(want_lps[0]), atol=LP_TOL)
    np.testing.assert_array_equal(got_lps[1].numpy(), np.asarray(want_lps[1]))
    for jc, tc, c0 in zip(jcache, tcache, init):
        np.testing.assert_allclose(tc.numpy()[:g], np.asarray(jc)[:g], atol=CACHE_TOL)
        # The mid-prompt lane: its chunk filled block 7; the masked
        # continuation left the rest of its pages untouched.
        for blk in (8, 9):
            np.testing.assert_array_equal(tc.numpy()[blk], c0[blk])
    # The completing chunk (budget 3) stops after 3 tokens: its lane's last
    # iteration repeats its last live token.
    assert got[2, 2, 0] == got[3, 2, 0]


# -- stream parity ------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 8])
def test_greedy_streams_match_jax_sync_and_async(weights, k):
    """k = 1 runs every step through _plan_mixed; k = 8 through
    _plan_fused and its fallbacks (a lone mid-prompt chunk, the decode
    megastep once the prompt is in)."""
    cores = _cores(weights, megastep_k=k, **CHUNKED)
    runs = _run_all(cores, _mixed_workload())
    _assert_same_streams(runs)
    for async_exec in (False, True):
        counts = _path_counts(cores["torch", async_exec])
        assert counts == _path_counts(cores["jax", async_exec]), async_exec
        assert counts["mixed_steps"] > 0
        if k == 1:
            assert counts["fused_mixed_dispatches"] == counts["megastep_dispatches"] == 0
        else:
            assert 0 < counts["fused_mixed_dispatches"] < counts["mixed_steps"]


@pytest.mark.parametrize("k", [1, 8])
def test_seeded_streams_and_logprobs_match_jax(weights, k):
    """Seeded lanes (plain temperature, top-k, top-p) decode next to a
    seeded prompt's chunks; their (seed, counter) keys replay through the
    overlay under async execution."""
    rng = np.random.RandomState(1)
    wires = [
        _wire([3, 5, 7, 9], "t", max_tokens=10, temperature=0.8, seed=11, ignore_eos=True),
        _wire([4, 6, 8], "k", max_tokens=10, temperature=0.7, seed=12, top_k=8,
              ignore_eos=True),
        _wire([2, 4, 6, 8, 10], "p", max_tokens=10, temperature=0.9, seed=13, top_p=0.8,
              logprobs=3, ignore_eos=True),
        _wire(list(rng.randint(1, 200, size=90)), "long", max_tokens=6, temperature=0.6,
              seed=14, logprobs=2, ignore_eos=True),
    ]
    runs = _run_all(_cores(weights, megastep_k=k, **CHUNKED), wires)
    _assert_same_streams(runs)
    assert runs["torch", True][2] == runs["torch", False][2]  # same values, bit for bit
    _assert_logprobs_close(runs["torch", True][2], runs["jax", False][2])


def test_cached_prefix_ending_mid_chunk_matches_jax(weights):
    """56 of 60 prompt tokens come from the prefix cache, so the chunk
    cursor resumes at 56, not a multiple of the chunk: both engines, sync
    and async, replay the same tokens, and so does the port's waves
    engine."""
    prompt = list(range(3, 63))
    got = {}
    cores = _cores(weights, **CHUNKED)
    cores["torch waves"] = build_engine("tiny", {}, device="cpu", params=weights[1])[0]
    for key, core in cores.items():
        warm = drive(core, [_wire(prompt, "warm", max_tokens=5)])
        hit = drive(core, [_wire(prompt, "hit", max_tokens=5)])
        got[key] = (warm[0]["warm"], hit[0]["hit"], core.kv_cache_stats()["admitted_hits"])
    assert all(v == got["jax", False] for v in got.values()), got
    assert got["torch", True][0] == got["torch", True][1] and got["torch", True][2] == 1


# -- preemption ---------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 8])
def test_preemption_under_block_pressure_matches_jax(weights, k):
    """Decode growth preempts the last running sequence, a prompt half
    prefilled in chunks, which replays its whole prompt; the pipeline
    drains under async execution. Streams, preemptions and drains equal
    the JAX engine's, and no block leaks."""
    cores = _cores(weights, num_kv_blocks=12, max_model_len=64, megastep_k=k,
                   scheduling="chunked", prefill_chunk=16)
    wires = [_wire(list(range(1, 17)), "a", max_tokens=24),
             _wire(list(range(20, 36)), "b", max_tokens=24),
             _wire(list(range(40, 80)), "c", max_tokens=8)]
    runs = _run_all(cores, wires)
    _assert_same_streams(runs)
    assert runs["torch", False][1] == {"a": "length", "b": "length", "c": "length"}
    for async_exec in (False, True):
        core = cores["torch", async_exec]
        assert _path_counts(core) == _path_counts(cores["jax", async_exec])
        assert core.allocator._partials == 0
        assert core.allocator.used_blocks == len(core.allocator._inactive)
    assert cores["torch", False].sched_stats["preemptions"] >= 1


def test_preempt_between_chunks_releases_exactly_once(weights):
    prompt = list(range(1, 81))
    ref = drive(build_engine("tiny", {}, device="cpu", params=weights[1])[0],
                [_wire(prompt, "ref", max_tokens=5)])[0]["ref"]
    core = build_engine("tiny", CHUNKED, device="cpu", params=weights[1])[0]
    seq = core.add_request(PreprocessedRequest.from_wire(_wire(prompt, "L", max_tokens=5)))
    core.step()  # the first chunk only
    assert 0 < seq.prefilled < seq.prompt_len
    core._preempt(seq)
    assert seq.prompt == prompt  # a mid-chunk preemption keeps the full prompt
    assert seq.prefilled == 0 and seq.block_ids == [] and seq.pinned_hashes == []
    assert core.allocator._partials == 0
    free, used = core.allocator.free_blocks, core.allocator.used_blocks
    core._release_blocks(seq)  # a second release changes nothing
    assert (core.allocator.free_blocks, core.allocator.used_blocks) == (free, used)
    toks = []
    while core.has_work():
        toks += [t for s, o in core.step() for t in o.token_ids]
    assert toks == ref
    assert core.allocator.used_blocks == len(core.allocator._inactive)
    assert core.allocator._partials == 0 and core.sched_stats["preemptions"] == 1


# -- chunked against waves, and the interleaving ------------------------------


@pytest.mark.parametrize("k", [1, 8])
def test_chunked_equals_waves_greedy(weights, k):
    """Mixed steps change the step's shape, never the math: the port's
    chunked and waves engines emit the same greedy tokens."""
    runs = {
        sched: drive(build_engine("tiny", {**CHUNKED, "scheduling": sched, "megastep_k": k},
                                  device="cpu", params=weights[1])[0], _mixed_workload())
        for sched in ("waves", "chunked")
    }
    assert runs["chunked"][:2] == runs["waves"][:2]


def test_long_prompt_never_stalls_decodes(weights):
    """A 200-token prompt streams in over ceil(200 / 32) steps and every
    unfinished decode emits in each of them; under waves they stall for
    every wave."""
    long_prompt = list(np.random.RandomState(1).randint(1, 200, size=200))

    def run(scheduling):
        core = build_engine("tiny", {**CHUNKED, "scheduling": scheduling}, device="cpu",
                            params=weights[1])[0]
        ds = [core.add_request(PreprocessedRequest.from_wire(
            _wire(p, f"d{i}", max_tokens=40, ignore_eos=True)))
            for i, p in enumerate(([1, 2, 3, 4], [5, 6, 7, 8]))]
        while not all(d.prefill_done for d in ds):
            core.step()
        lg = core.add_request(PreprocessedRequest.from_wire(
            _wire(long_prompt, "long", max_tokens=2, ignore_eos=True)))
        steps = stalled = 0
        while not lg.prefill_done and steps < 100:
            live = {d.request_id for d in ds if d.finish is None}
            outs = core.step()
            steps += 1
            stalled += bool(live) and not any(s.request_id in live for s, _ in outs)
        return steps, stalled

    steps, stalled = run("chunked")
    assert steps <= math.ceil(200 / 32) and stalled == 0
    steps, stalled = run("waves")
    assert stalled == steps > 0


# -- observability --------------------------------------------------------------


def test_scheduler_gauges_after_one_mixed_step_match_jax(weights):
    prompt = list(np.random.RandomState(3).randint(1, 200, size=100))
    got = {}
    for pkg in ("jax", "torch"):
        core = _cores(weights, **CHUNKED)[pkg, False]
        idle = core.scheduler_stats()
        core.add_request((JaxRequest if pkg == "jax" else PreprocessedRequest).from_wire(
            _wire(prompt, "g", max_tokens=2)))
        core.step()
        got[pkg] = (idle, core.scheduler_stats())
    keys = ("mixed_steps", "last_step_batched_tokens", "last_step_budget_utilization",
            "chunked_prefills_in_flight", "chunked_scheduling", "token_budget", "running")
    for i in (0, 1):
        assert {k: got["torch"][i][k] for k in keys} == {k: got["jax"][i][k] for k in keys}
    st = got["torch"][1]
    assert st["chunked_scheduling"] == 1 and st["token_budget"] == 128
    assert (st["mixed_steps"], st["last_step_batched_tokens"]) == (1, 32)
    assert st["chunked_prefills_in_flight"] == 1
    assert 0 < st["last_step_budget_utilization"] <= 1
    assert (st["mixed_tokens"], st["mixed_bucket_tokens"]) == (32, 32)


def test_spans_stats_and_flight_records_match_jax(weights):
    """The same requests through both async chunked cores (k = 8) file the
    same stat spans with the same attribute names (one
    ``engine_prefill_chunk`` per chunk, fused megasteps whose
    ``fused_shapes`` carry chunks) and the same flight-recorder step
    records, field for field; ``scheduler_stats()`` carries every JAX key
    with the JAX values."""
    wires = _mixed_workload()
    got = {}
    for pkg, trc, state in (("jax", jtracing, jtracing_core._STATE),
                            ("torch", tracing, tracing_core._STATE)):
        before = (state.enabled, state.sample)
        trc.configure(enabled=True, sample=1.0)
        collector = trc.get_collector()
        collector.clear()
        try:
            core = _cores(weights, megastep_k=8, **CHUNKED)[pkg, True]
            drive(core, wires)
            got[pkg] = (collector.stats(), core)
        finally:
            collector.clear()
            trc.configure(enabled=before[0], sample=before[1])
    shapes = {pkg: {(s.name, tuple(sorted(s.attrs))) for s in spans}
              for pkg, (spans, _) in got.items()}
    assert shapes["torch"] == shapes["jax"]
    spans, core = got["torch"]
    chunks = [s for s in spans if s.name == "engine_prefill_chunk"]
    long_chunks = [s.attrs["tokens"] for s in chunks if s.attrs["request_id"] == "long"]
    assert len(long_chunks) == math.ceil(200 / 32) and sum(long_chunks) == 200
    fused = [s.attrs["fused_shapes"] for s in spans if s.name == "engine_megastep"]
    assert any(f["chunk"] > 0 and f["decode"] > 0 for f in fused)
    jspans = got["jax"][0]
    assert sorted(str(s.attrs) for s in spans if s.name in ("engine_megastep", "engine_mixed_step",
                                                         "engine_prefill_chunk")) == \
        sorted(str(s.attrs) for s in jspans if s.name in ("engine_megastep", "engine_mixed_step",
                                                          "engine_prefill_chunk"))
    records = {pkg: [{k: v for k, v in r.items() if k != "t"} for r in c.flight.snapshot()]
               for pkg, (_, c) in got.items()}
    assert records["torch"] == records["jax"]
    assert records["torch"][-1]["fused_mixed_dispatches"] > 0
    jst, tst = got["jax"][1].scheduler_stats(), core.scheduler_stats()
    assert not set(jst) - set(tst)
    for key in ("mixed_steps", "last_step_batched_tokens", "chunked_prefills_in_flight",
                "chunked_scheduling", "token_budget", "dispatches", "commits", "drains",
                "megastep_dispatches", "single_step_dispatches", "fused_mixed_dispatches",
                "committed_tokens", "dispatches_per_token", "preemptions"):
        assert tst[key] == jst[key], key


# -- the attention form each forward states -----------------------------------


def _recording_attention(seen):
    def attention(q, *args, kernel=None, **kw):
        seen.append((q.shape[0], args[2].shape[0], kernel))
        return ra.ragged_paged_attention_ref(q, *args, **kw)
    return attention


def test_forwards_state_their_kernel_form(weights):
    """``forward_tokens`` asks every layer for the tiled form, even on a
    mixed batch whose token bucket equals its row count; ``decode_tokens``
    for the decode form."""
    cfg, eng = tiny_model(), tiny_engine()
    cache = tmodel.init_cache(cfg, eng, "cpu")
    i32 = lambda a: torch.tensor(a, dtype=torch.int32)  # noqa: E731
    g = eng.garbage_block
    # T = S = 8: a 5-token chunk and three decode rows, padded to 8 rows.
    tables = np.full((8, eng.max_blocks_per_seq), g, np.int32)
    tables[:4, 0] = [1, 2, 3, 4]
    ops = (i32([9, 8, 7, 6, 5, 4, 3, 2]), i32([0, 1, 2, 3, 4, 0, 0, 0]),
           i32([1] * 5 + [2, 3, 4]), i32([0, 1, 2, 3, 4, 0, 0, 0]),
           i32([5, 1, 1, 1, 0, 0, 0, 0]), torch.from_numpy(tables),
           i32([0, 5, 6, 7, 8, 8, 8, 8, 8]), i32([4]), i32([4, 5, 6, 7, 7, 7, 7, 7]))
    seen = []
    logits = tmodel.forward_tokens(weights[1], cache, *ops, cfg,
                                   attention=_recording_attention(seen))
    assert seen == [(8, 8, "tiled")] * cfg.num_layers
    torch.testing.assert_close(
        logits, tmodel.forward_tokens(weights[1], tmodel.init_cache(cfg, eng, "cpu"), *ops, cfg))
    seen.clear()
    B = 4
    tmodel.decode_tokens(weights[1], cache, i32([1, 2, 3, 4]), torch.from_numpy(tables[:B]),
                         i32([5, 1, 1, 1]), torch.ones(B, dtype=torch.bool), cfg, eng,
                         attention=_recording_attention(seen))
    assert seen == [(B, B, "decode")] * cfg.num_layers


def test_engine_mixed_step_with_bucket_equal_to_width_asks_for_tiled(weights, monkeypatch):
    """With a prefill bucket equal to a decode width, a mixed step of five
    decode rows and a two-token prompt runs at T == S == 8: it asks for the
    tiled form (the shapes alone would pick the decode kernel, which walks
    each chunk row on its own), decode megasteps for the decode form, and
    the streams are the JAX engine's."""
    seen = []
    ref = ra.ragged_paged_attention_ref

    def recording_ref(q, *args, kernel=None, **kw):
        seen.append((q.shape[0], args[2].shape[0], int(args[4][0]), kernel))
        return ref(q, *args, **kw)

    monkeypatch.setattr(ra, "ragged_paged_attention_ref", recording_ref)
    eng = {"scheduling": "chunked", "prefill_buckets": (8, 32, 64, 128), "megastep_k": 1}
    wires = [_wire([i + 1, i + 2, i + 3], f"d{i}", max_tokens=12, ignore_eos=True)
             for i in range(5)]
    got = {}
    for pkg in ("jax", "torch"):
        core = _cores(weights, **eng)[pkg, False]
        from_wire = JaxRequest.from_wire if pkg == "jax" else PreprocessedRequest.from_wire
        for w in wires:
            core.add_request(from_wire(w))
        toks: dict[str, list[int]] = {}
        for step in range(40):
            if step == 3:
                core.add_request(from_wire(_wire([7, 9], "late", max_tokens=4, ignore_eos=True)))
            for s, o in core.step():
                toks.setdefault(s.request_id, []).extend(o.token_ids)
        got[pkg] = toks
    assert got["torch"] == got["jax"]
    assert len(got["torch"]["late"]) == 4
    mixed = {(T, S, n, kernel) for T, S, n, kernel in seen if T == S and n < S}
    assert mixed and {kernel for *_, kernel in mixed} == {"tiled"}
    assert {kernel for T, S, n, kernel in seen if n == S == T} == {"decode"}


# -- configuration --------------------------------------------------------------


@pytest.mark.parametrize("overrides, match", [
    ({"scheduling": "fancy"}, "scheduling"),
    ({"scheduling": "chunked", "prefill_chunk": 12}, "block_size"),
    ({"scheduling": "chunked", "max_num_batched_tokens": 4096}, "largest prefill bucket"),
    ({"scheduling": "chunked", "prefill_chunk": 128, "max_num_batched_tokens": 64},
     "token budget"),
    ({"scheduling": "chunked", "max_num_batched_tokens": 12}, "decode width"),
])
def test_chunked_settings_refused_as_jax_refuses_them(overrides, match):
    with pytest.raises(ValueError, match=match):
        JaxCore(j_tiny_model(), j_tiny_engine(**overrides), seed=0)
    with pytest.raises(ValueError, match=match):
        build_engine("tiny", overrides, device="cpu")
