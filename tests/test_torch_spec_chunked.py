"""The port's speculative decoding under chunked scheduling, drafts made on
the host, against the JAX package's, on the tiny preset and the CPU.

Verify rows ride mixed steps next to prefill chunks (``_plan_mixed`` at
megastep k = 1), and fused megasteps next to chunks and decode rows
(``_plan_fused`` at k = 8); drafted tokens count against the token budget
with one block kept for a prompt's chunk. The same requests go through the
port's ``EngineCore`` and the JAX package's (the same weights), sync and
async, with one run per configuration shared through the module's fixture
(``torch_spec_harness.py``): streams, log-probabilities,
``spec_decode_stats()``, dispatch counts, each step's batched tokens,
block pressure, spans and flight-recorder records equal the JAX engine's.

Tolerances: log-probabilities within 1e-4; everything else exact.
"""

import pytest
from torch_spec_harness import (
    CHUNKED,
    DISPATCH_KEYS,
    SPEC,
    JaxRequest,
    PreprocessedRequest,
    assert_logprobs_close,
    drive,
    make_core,
    make_weights,
    matrix_runner,
    spec_workload,
    wire,
)

from dynamo_tpu import tracing as jtracing
from dynamo_tpu.tracing import core as jtracing_core
from dynamo_tpu_torch import tracing
from dynamo_tpu_torch.tracing import core as tracing_core

MATRIX = [("chunked", 1), ("chunked", 8)]


@pytest.fixture(scope="module")
def weights():
    return make_weights()


@pytest.fixture(scope="module")
def matrix_runs(weights):
    return matrix_runner(weights)


# -- stream parity over the matrix ----------------------------------------------


@pytest.mark.parametrize("scheduling, k", MATRIX)
def test_chunked_streams_match_jax(matrix_runs, scheduling, k):
    """Speculating streams (tokens, finish reasons, log-probabilities)
    equal the JAX engine's, sync and async."""
    runs = matrix_runs(scheduling, k)
    want = runs["jax", False][0]
    for key in (("jax", True), ("torch", False), ("torch", True)):
        got = runs[key][0]
        assert got[:2] == want[:2], key
        assert_logprobs_close(got[2], want[2])


@pytest.mark.parametrize("scheduling, k", MATRIX)
def test_chunked_stats_and_dispatches_match_jax(matrix_runs, scheduling, k):
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
def test_chunked_spec_on_equals_spec_off(matrix_runs, scheduling, k):
    """Verification replays the target's own (seed, counter) choices: the
    port's speculating streams equal its streams with speculation off,
    greedy and seeded, log-probabilities included."""
    runs = matrix_runs(scheduling, k)
    off, on = runs["torch_off"][0], runs["torch", False][0]
    assert on[:2] == off[:2]
    assert_logprobs_close(on[2], off[2])


# -- budgets and block pressure --------------------------------------------------


def _budget_engine(budget=16, **extra):
    return dict(scheduling="chunked", prefill_chunk=8, max_num_batched_tokens=budget,
                prefill_buckets=(16, 32, 64), **SPEC, **extra)


@pytest.mark.parametrize("lanes, extra", [(3, {}), (7, {"decode_buckets": (4, 8)})],
                         ids=["three_lanes", "seven_lanes"])
def test_drafts_count_against_the_token_budget(weights, lanes, extra):
    """Chunked mixed steps with a 16-token budget: drafted tokens count
    against it, every lane's base token is pre-charged (seven speculating
    lanes cannot push the prompt out), one block stays for the prompt's
    chunk; each step's batched tokens and the streams equal the JAX
    engine's."""
    got = {}
    for pkg in ("jax", "torch"):
        core = make_core(pkg, weights, **_budget_engine(**extra))
        from_wire = JaxRequest.from_wire if pkg == "jax" else PreprocessedRequest.from_wire
        seqs = [core.add_request(from_wire(wire([5, 6] * 6, f"d{i}", 30, ignore_eos=True)))
                for i in range(lanes)]
        toks = {s.request_id: [] for s in seqs}
        trace = []
        while not all(s.prefill_done for s in seqs):
            core.step()
        long = core.add_request(from_wire(wire(list(range(1, 49)), "long", 2, ignore_eos=True)))
        toks["long"] = []
        steps = 0
        while core.has_work():
            for s, o in core.step():
                toks[s.request_id] += o.token_ids
            steps += 1
            batched = core.sched_stats["last_step_batched_tokens"]
            assert batched <= 16
            trace.append(batched)
            assert long.prefill_done or steps < 50, "prefill starved by speculation"
        got[pkg] = (toks, trace, core.spec_decode_stats())
    assert got["torch"] == got["jax"]
    assert got["torch"][2]["drafted_tokens"] > 0


@pytest.mark.parametrize("blocks, k, eng", [
    (12, 1, {}), (12, 8, {}),
    (7, 8, {"scheduling": "chunked"}), (7, 8, {"scheduling": "chunked", "async_exec": True}),
], ids=["waves-k1", "waves-k8", "chunked-k8", "chunked-k8-async"])
def test_spec_under_block_pressure_matches_jax(weights, blocks, k, eng):
    """Verify rows grow blocks like decode rows; under pressure the engine
    preempts (or drains, then preempts) and drops drafts whose blocks are
    not reservable. The streams equal the JAX engine's and the port's
    without speculation, and every block comes back; at 7 blocks the
    fused headroom forces preemptions."""
    eng = dict(num_kv_blocks=blocks, max_model_len=64, megastep_k=k, **eng)
    wires = [wire([5, 6] * 8, "a", 24, ignore_eos=True), wire([7, 8] * 8, "b", 24, ignore_eos=True)]
    got = {}
    for pkg in ("jax", "torch"):
        core = make_core(pkg, weights, **eng, **SPEC)
        got[pkg] = drive(core, wires)[:2]
        assert core.allocator._partials == 0
        assert core.allocator.used_blocks == len(core.allocator._inactive)
        got[pkg] += (core.sched_stats["preemptions"], core.exec_stats["drains"])
    off = drive(make_core("torch", weights, **eng), wires)[:2]
    assert got["torch"] == got["jax"] and got["torch"][:2] == off
    assert blocks > 7 or got["torch"][2] >= 1


# -- observability -----------------------------------------------------------------


def test_cancel_mid_fused_megastep_releases_exactly_once(weights):
    core = make_core("torch", weights, megastep_k=8, scheduling="chunked", async_exec=True, **SPEC)
    seq = core.add_request(PreprocessedRequest.from_wire(
        wire([3, 4, 5] * 3, "c", 50, ignore_eos=True)))
    core.step()  # dispatch the prefill
    core.step()  # dispatch a fused step, commit the prefill
    core.cancel_request(seq)
    for _ in range(5):
        core.step()
    assert not core.has_work() and seq not in core.running
    assert core.allocator._partials == 0


def test_spans_stats_and_flight_records_match_jax(weights):
    """The same requests through both async chunked cores (k = 8, host
    drafts) file the same stat spans with the same attributes
    (``spec_draft``, ``spec_verify``, ``engine_megastep`` with verify rows
    in its ``fused_shapes``) and the same flight-recorder step records."""
    eng = {**SPEC, **CHUNKED, "megastep_k": 8, "async_exec": True}
    got = {}
    for pkg, trc, state in (("jax", jtracing, jtracing_core._STATE),
                            ("torch", tracing, tracing_core._STATE)):
        before = (state.enabled, state.sample)
        trc.configure(enabled=True, sample=1.0)
        collector = trc.get_collector()
        collector.clear()
        try:
            core = make_core(pkg, weights, **eng)
            drive(core, spec_workload())
            got[pkg] = (collector.stats(), core)
        finally:
            collector.clear()
            trc.configure(enabled=before[0], sample=before[1])
    names = ("spec_draft", "spec_verify", "engine_megastep", "engine_mixed_step",
             "engine_decode_step")
    for name in names:
        want = sorted(str(s.attrs) for s in got["jax"][0] if s.name == name)
        assert sorted(str(s.attrs) for s in got["torch"][0] if s.name == name) == want, name
    spans, core = got["torch"]
    verifies = [s for s in spans if s.name == "spec_verify"]
    assert verifies and sum(s.attrs["accepted"] for s in verifies) == core.spec_stats.accepted_tokens
    assert any(s.attrs["fused_shapes"]["verify"] > 0 for s in spans if s.name == "engine_megastep")
    records = {pkg: [{k: v for k, v in r.items() if k != "t"} for r in c.flight.snapshot()]
               for pkg, (_, c) in got.items()}
    assert records["torch"] == records["jax"]
