"""The port's speculative decoding with drafts made on the device under
chunked scheduling, against the JAX package's, on the tiny preset and the
CPU.

Drafting megasteps carry prefill chunks beside device-drafting lanes
(``_plan_fused``), and under block pressure a lane whose worst case
(``1 + (n_steps - 1) * R`` tokens) is not reservable degrades to a
host-drafted verify row, which is the JAX engine's semantics: the stream
is the same either way. Streams, log-probabilities, stats and dispatch
counts, sync and async, at k = 1 and 8 (one run per configuration shared
through the module's fixture, ``torch_spec_harness.py``) equal the JAX
engine's and the port's without speculation.

Tolerances: log-probabilities within 1e-4; everything else exact.
"""

import pytest
from torch_spec_harness import (
    DISPATCH_KEYS,
    REPEAT_PROMPT,
    SPEC,
    assert_logprobs_close,
    drive,
    make_core,
    make_weights,
    matrix_runner,
    wire,
)

DEVICE = {**SPEC, "spec_device_draft": True}
MATRIX = [("chunked", 1), ("chunked", 8)]


@pytest.fixture(scope="module")
def weights():
    return make_weights()


@pytest.fixture(scope="module")
def matrix_runs(weights):
    return matrix_runner(weights, spec_device_draft=True)


@pytest.mark.parametrize("scheduling, k", MATRIX)
def test_device_chunked_streams_match_jax(matrix_runs, scheduling, k):
    runs = matrix_runs(scheduling, k)
    want = runs["jax", False][0]
    for key in (("jax", True), ("torch", False), ("torch", True)):
        got = runs[key][0]
        assert got[:2] == want[:2], key
        assert_logprobs_close(got[2], want[2])


@pytest.mark.parametrize("scheduling, k", MATRIX)
def test_device_chunked_stats_and_dispatches_match_jax(matrix_runs, scheduling, k):
    runs = matrix_runs(scheduling, k)
    for async_exec in (False, True):
        jc, tc = runs["jax", async_exec][1], runs["torch", async_exec][1]
        assert tc.spec_decode_stats() == jc.spec_decode_stats()
        jst, tst = jc.scheduler_stats(), tc.scheduler_stats()
        assert {k2: tst[k2] for k2 in DISPATCH_KEYS} == {k2: jst[k2] for k2 in DISPATCH_KEYS}
    tc = runs["torch", False][1]
    assert (tc.spec_decode_stats()["device_rounds"] > 0) == (k > 1)
    assert tc.sched_stats["mixed_steps"] > 0


@pytest.mark.parametrize("scheduling, k", MATRIX)
def test_device_chunked_spec_on_equals_spec_off(matrix_runs, scheduling, k):
    runs = matrix_runs(scheduling, k)
    off, on = runs["torch_off"][0], runs["torch", False][0]
    assert on[:2] == off[:2]
    assert_logprobs_close(on[2], off[2])


@pytest.mark.parametrize("async_exec", [False, True])
def test_block_pressure_degrades_device_lanes_as_jax(weights, async_exec):
    """Too few blocks for the drafting lanes' worst case: they verify host
    drafts instead (and preempt or drain where even that does not fit).
    Streams equal speculation off and the JAX engine's; stats and dispatch
    counts equal the JAX engine's; every block comes back."""
    eng = dict(megastep_k=4, num_kv_blocks=28, max_model_len=64, async_exec=async_exec)
    wires = [
        wire(REPEAT_PROMPT, "rep", 20, ignore_eos=True),
        wire([int(t) for t in range(3, 43)], "rnd", 12),
        wire(REPEAT_PROMPT, "tmp", 16, temperature=0.9, seed=42, ignore_eos=True),
    ]
    got = {}
    for pkg in ("jax", "torch"):
        core = make_core(pkg, weights, **eng, **DEVICE)
        got[pkg] = drive(core, wires)[:2]
        assert core.allocator._partials == 0
        st = core.scheduler_stats()
        got[pkg] += (core.spec_decode_stats(), {k: st[k] for k in DISPATCH_KEYS})
    assert got["torch"] == got["jax"]
    assert got["torch"][:2] == drive(make_core("torch", weights, **eng), wires)[:2]
    assert got["torch"][2]["verify_rows"] > got["torch"][2]["device_hits"]
