"""The port's EngineCore against the JAX package's on the same weights.

One request set — several prompts, two sharing a prefix, varied
max_tokens, an EOS id and a per-request stop id — goes through both
engines with greedy sampling. The token streams and finish reasons must be
IDENTICAL, at megastep k=1 and k=8, under preemption, and a later request
sharing the prefix must hit the prefix cache on both alike. The tiny
preset is f32 and runs the plain attention on the CPU, so the kernel's
launch counter stays 0 throughout.
"""

import jax
import numpy as np
import pytest

from dynamo_tpu.engine import EngineCore as JaxCore
from dynamo_tpu.engine import model as jmodel
from dynamo_tpu.engine.config import tiny_engine as j_tiny_engine
from dynamo_tpu.engine.config import tiny_model as j_tiny_model
from dynamo_tpu.llm.protocols.common import PreprocessedRequest as JaxRequest
from dynamo_tpu_torch.backends.torch.main import build_engine
from dynamo_tpu_torch.engine.config import tiny_model
from dynamo_tpu_torch.engine.convert import params_from_numpy
from dynamo_tpu_torch.llm.protocols.common import PreprocessedRequest
from dynamo_tpu_torch.ops import ragged_attention as ra

_RNG = np.random.default_rng(0)
SHARED = [int(t) for t in _RNG.integers(1, 384, 40)]
SPECS = [  # (request id, prompt, max_tokens)
    ("a", [int(t) for t in _RNG.integers(1, 384, 19)], 9),
    ("b", [int(t) for t in _RNG.integers(1, 384, 60)], 14),
    ("c", [int(t) for t in _RNG.integers(1, 384, 5)], 21),
    ("d", [int(t) for t in _RNG.integers(1, 384, 100)], 6),
    ("p1", SHARED + [5, 6, 7], 11),
    ("p2", SHARED + [9, 9], 10),
]
LATE = ("p3", SHARED + [4], 7)  # arrives after the prefix is cached


@pytest.fixture(scope="module")
def weights():
    jparams = jmodel.init_params(jax.random.PRNGKey(0), j_tiny_model())
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tiny_model(), device="cpu")
    return jparams, tparams


def _wire(rid, prompt, max_tokens, stop_ids=()):
    return {
        "model": "tiny", "token_ids": list(prompt), "request_id": rid,
        "sampling": {"temperature": 0.0},
        "stop": {"max_tokens": max_tokens, "stop_token_ids": list(stop_ids)},
    }


def drive(core, wires, from_wire, max_steps=3000):
    seqs = [core.add_request(from_wire(w)) for w in wires]
    tokens = {s.request_id: [] for s in seqs}
    finishes = {}
    for _ in range(max_steps):
        for seq, out in core.step():
            tokens[seq.request_id].extend(out.token_ids)
            if out.finish_reason:
                finishes[seq.request_id] = out.finish_reason
        if len(finishes) == len(seqs):
            break
    assert len(finishes) == len(seqs), "engine did not finish every request"
    return tokens, finishes, {s.request_id: s.num_cached_tokens for s in seqs}


@pytest.fixture(scope="module")
def stops(weights):
    """An EOS id and a stop id that the greedy streams really produce:
    read off a stop-free run of the port (the parity runs below then hold
    both engines to them)."""
    core, _ = build_engine("tiny", device="cpu", params=weights[1])
    toks, _, _ = drive(core, [_wire(r, p, m) for r, p, m in SPECS], PreprocessedRequest.from_wire)

    def fresh(stream, start):
        return next(t for i, t in enumerate(stream) if i >= start and t not in stream[:i])

    return fresh(toks["c"], 4), fresh(toks["b"], 5)


def _pair(weights, eos, **eng):
    jcore = JaxCore(j_tiny_model(), j_tiny_engine(**eng), params=weights[0], eos_token_ids=(eos,))
    tcore, _ = build_engine("tiny", eng, eos_token_ids=(eos,), device="cpu", params=weights[1])
    return jcore, tcore


def _wires(stop_id):
    return [_wire(r, p, m, [stop_id] if r == "b" else []) for r, p, m in SPECS]


@pytest.mark.parametrize("k", [1, 8])
def test_greedy_streams_and_prefix_hits_match_jax(weights, stops, k):
    eos, stop_id = stops
    jcore, tcore = _pair(weights, eos, megastep_k=k)
    launches = ra.launches
    want = drive(jcore, _wires(stop_id), JaxRequest.from_wire)
    got = drive(tcore, _wires(stop_id), PreprocessedRequest.from_wire)
    assert got[:2] == want[:2]
    assert "eos" in want[1].values() and want[1]["b"] == "stop"
    # A later request sharing the prefix reuses the cached blocks alike.
    want_late = drive(jcore, [_wire(*LATE)], JaxRequest.from_wire)
    got_late = drive(tcore, [_wire(*LATE)], PreprocessedRequest.from_wire)
    assert got_late == want_late
    assert got_late[2]["p3"] == 40
    for key in ("admitted_queries", "admitted_hits", "prefix_queries", "prefix_hits"):
        assert tcore.kv_cache_stats()[key] == jcore.kv_cache_stats()[key], key
    assert tcore.kv_cache_stats()["admitted_hits"] >= 1
    st = tcore.scheduler_stats()
    jst = jcore.scheduler_stats()
    for key in ("dispatches", "megastep_dispatches", "committed_tokens"):
        assert st[key] == jst[key], key
    assert ra.launches == launches


def test_preemption_streams_match_jax(weights, stops):
    eos, stop_id = stops
    jcore, tcore = _pair(weights, eos, megastep_k=8, num_kv_blocks=20)
    want = drive(jcore, _wires(stop_id), JaxRequest.from_wire)
    got = drive(tcore, _wires(stop_id), PreprocessedRequest.from_wire)
    assert got[:2] == want[:2]
    assert tcore.sched_stats["preemptions"] == jcore.sched_stats["preemptions"] > 0
