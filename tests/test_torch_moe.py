"""The port's sparse MoE (Mixtral-style) against the JAX package's, on the CPU.

The same seeded numpy weights and activations go through the JAX
``_moe_mlp`` (its ``mesh=None`` branch, ``_moe_dispatch_local``) and the
port's: on ``tiny_moe`` and on a wider case (h 256, i 512, 8 experts,
top-2), with identical experts (the dense MLP), at capacity factor 0.5
(entries dropped: the same ones on both sides, checked against a numpy
count of each expert's entries in token-major order), and against an
all-experts dense reference with room for every entry. Then a ``tiny-moe``
engine serves the same requests as the JAX engine, on weights carried
across by ``engine/convert.py``, under waves, chunked scheduling, n-gram
speculation and int8 KV pages: greedy streams equal, log-probabilities
within ``LP_TOL``.

Tolerances: f32 on both sides, sums taken in other orders: the MLP within
1e-5 (``MLP_TOL``), logits within 1e-4 over two layers (``LOGIT_TOL``),
log-probabilities within 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import EngineCore as JaxCore
from dynamo_tpu.engine import model as jmodel
from dynamo_tpu.engine.config import tiny_engine as j_tiny_engine
from dynamo_tpu.engine.config import tiny_moe as j_tiny_moe
from dynamo_tpu.llm.protocols.common import PreprocessedRequest as JaxRequest
from dynamo_tpu_torch.backends.torch.main import build_engine
from dynamo_tpu_torch.engine import model as tmodel
from dynamo_tpu_torch.engine.config import tiny_engine, tiny_moe
from dynamo_tpu_torch.engine.convert import cache_from_numpy, params_from_numpy
from dynamo_tpu_torch.llm.protocols.common import PreprocessedRequest
from tests.model_harness import prefill_chunk
from tests.test_torch_model import _port_prefill_chunk

MLP_TOL = 1e-5
LOGIT_TOL = 1e-4
LP_TOL = 1e-4

WIDE = {"hidden_size": 256, "intermediate_size": 512, "num_experts": 8, "num_experts_per_tok": 2}
SHAPES = {"tiny_moe": {}, "wide": WIDE}


def _cfgs(shape: str, **extra):
    return (dataclasses.replace(j_tiny_moe(), **SHAPES[shape], **extra),
            dataclasses.replace(tiny_moe(), **SHAPES[shape], **extra))


def _layer(cfg, seed: int, identical: bool = False) -> dict[str, np.ndarray]:
    """One layer's MoE weights from a seeded numpy generator; ``identical``
    gives every expert the same weights and the router zeros."""
    rng = np.random.default_rng(seed)
    h, i, E = cfg.hidden_size, cfg.intermediate_size, cfg.num_experts
    f = lambda *s: (rng.standard_normal(s) / np.sqrt(s[-2])).astype(np.float32)  # noqa: E731
    if identical:
        g, u, d = f(h, i), f(h, i), f(i, h)
        return {"w_router": np.zeros((h, E), np.float32), "w_gate": np.tile(g, (E, 1, 1)),
                "w_up": np.tile(u, (E, 1, 1)), "w_down": np.tile(d, (E, 1, 1))}
    return {"w_router": f(h, E), "w_gate": f(E, h, i), "w_up": f(E, h, i), "w_down": f(E, i, h)}


def _both(x: np.ndarray, lp: dict, jcfg, tcfg) -> tuple[np.ndarray, np.ndarray]:
    want = jmodel._moe_mlp(jnp.asarray(x), {k: jnp.asarray(v) for k, v in lp.items()}, jcfg)
    got = tmodel._moe_mlp(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in lp.items()},
                          tcfg)
    return got.numpy(), np.asarray(want)


def _kept(x: np.ndarray, lp: dict, cfg) -> np.ndarray:
    """[N, k] bool: the entries the capacity keeps, counted in numpy (each
    expert's entries in token-major, rank-minor order, the first C kept)."""
    N, k = x.shape[0], cfg.num_experts_per_tok
    C = max(1, min(N, int(-(-N * k * cfg.moe_capacity_factor // cfg.num_experts))))
    idx = np.argsort(-(x @ lp["w_router"]), axis=-1, kind="stable")[:, :k]
    seen = np.zeros(cfg.num_experts, int)
    kept = np.zeros((N, k), bool)
    for t in range(N):
        for j in range(k):
            kept[t, j] = seen[idx[t, j]] < C
            seen[idx[t, j]] += 1
    return kept


def _dense_reference(x: np.ndarray, lp: dict, cfg, kept: np.ndarray | None = None) -> np.ndarray:
    """Every expert on every token (float64), weighted by the softmax of
    the top-k router logits; ``kept`` zeroes dropped entries."""
    x64 = x.astype(np.float64)
    router = x64 @ lp["w_router"]
    k = cfg.num_experts_per_tok
    idx = np.argsort(-router, axis=-1, kind="stable")[:, :k]
    vals = np.take_along_axis(router, idx, -1)
    probs = np.exp(vals - vals.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    if kept is not None:
        probs = probs * kept
    out = np.zeros_like(x64)
    for j in range(k):
        g = np.einsum("nh,nhi->ni", x64, lp["w_gate"][idx[:, j]])
        u = np.einsum("nh,nhi->ni", x64, lp["w_up"][idx[:, j]])
        act = g / (1 + np.exp(-g)) * u
        out += probs[:, j : j + 1] * np.einsum("ni,nih->nh", act, lp["w_down"][idx[:, j]])
    return out


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("case", ["identical_experts_dense", "overflow_drops", "dense_reference"])
def test_moe_mlp_matches_jax(shape, case):
    """The port's ``_moe_mlp`` against the JAX package's, three ways."""
    if case == "identical_experts_dense":
        # top_k == num_experts with identical experts and a zero router:
        # every token's experts tie and the MoE is the dense MLP.
        jcfg, tcfg = _cfgs(shape)
        jcfg = dataclasses.replace(jcfg, num_experts_per_tok=jcfg.num_experts)
        tcfg = dataclasses.replace(tcfg, num_experts_per_tok=tcfg.num_experts)
        lp = _layer(tcfg, 1, identical=True)
        x = np.random.default_rng(2).standard_normal((6, tcfg.hidden_size)).astype(np.float32)
        got, want = _both(x, lp, jcfg, tcfg)
        np.testing.assert_allclose(got, want, rtol=MLP_TOL, atol=MLP_TOL)
        dense = tmodel._mlp(
            torch.from_numpy(x),
            {"wgu": torch.from_numpy(np.concatenate([lp["w_gate"][0], lp["w_up"][0]], -1)),
             "w_down": torch.from_numpy(lp["w_down"][0])},
            dataclasses.replace(tcfg, num_experts=0),
        )
        np.testing.assert_allclose(got, dense.numpy(), rtol=MLP_TOL, atol=MLP_TOL)
        return
    factor = 0.5 if case == "overflow_drops" else None
    jcfg, tcfg = _cfgs(shape)
    factor = factor or float(tcfg.num_experts)  # room for every entry
    jcfg = dataclasses.replace(jcfg, moe_capacity_factor=factor)
    tcfg = dataclasses.replace(tcfg, moe_capacity_factor=factor)
    lp = _layer(tcfg, 3)
    x = np.random.default_rng(4).standard_normal((13, tcfg.hidden_size)).astype(np.float32)
    got, want = _both(x, lp, jcfg, tcfg)
    np.testing.assert_allclose(got, want, rtol=MLP_TOL, atol=MLP_TOL)
    kept = _kept(x, lp, tcfg)
    if case == "overflow_drops":
        assert 0 < (~kept).sum() < kept.size  # some entries dropped, not all
    else:
        assert kept.all()
    np.testing.assert_allclose(got, _dense_reference(x, lp, tcfg, kept), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("factor", [0.01, 0.5, 1.0, 2.0, 8.0])
def test_capacity_matches_jax(factor):
    """C from the forward's padded width N, as the JAX function sizes it."""
    jcfg, tcfg = _cfgs("wide", moe_capacity_factor=factor)
    for N in (1, 7, 8, 13, 128, 8192):
        assert tmodel._moe_capacity(N, tcfg) == jmodel._moe_capacity(N, jcfg)


def _moe_weights(seed: int = 0):
    jparams = jmodel.init_params(jax.random.PRNGKey(seed), j_tiny_moe())
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tiny_moe(), device="cpu")
    return jparams, tparams


def test_moe_forward_logits_match_jax():
    """A prefill chunk, its continuation and decode steps through both
    forwards: logits within ``LOGIT_TOL``; bucket padding rows route and
    take capacity slots on both sides."""
    jcfg, tcfg = j_tiny_moe(), tiny_moe()
    jeng, teng = j_tiny_engine(), tiny_engine()
    jparams, tparams = _moe_weights(5)
    assert set(tparams["layers"]) >= {"w_router", "w_gate", "w_up", "w_down"}
    assert tparams["layers"]["w_gate"].shape == (2, 4, 64, 96)
    jcache = jmodel.init_cache(jcfg, jeng)
    tcache = cache_from_numpy(tuple(np.asarray(c) for c in jcache), device="cpu")
    prompt = [int(t) for t in np.random.default_rng(6).integers(1, jcfg.vocab_size, 37)]
    blocks = [5, 2, 9, 0, 7, 3]
    for start, stop, bucket in ((0, 20, 32), (20, 37, 64)):
        want, jcache = prefill_chunk(jparams, jcache, prompt[start:stop], start, blocks,
                                     jcfg, jeng, bucket)
        got = _port_prefill_chunk(tparams, tcache, prompt[start:stop], start, blocks,
                                  tcfg, teng, bucket)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL, rtol=LOGIT_TOL)
    table = np.full((4, jeng.max_blocks_per_seq), jeng.garbage_block, np.int32)
    table[0, : len(blocks)] = blocks
    active = np.array([True, False, False, False])
    jdecode = jax.jit(jmodel.decode_tokens, static_argnames=("cfg", "engine"))
    for step, tok in enumerate([17, 250, 3]):
        toks = np.array([tok, 0, 0, 0], np.int32)
        pos = np.array([37 + step, 0, 0, 0], np.int32)
        want, jcache = jdecode(
            jparams, jcache, jnp.asarray(toks), jnp.asarray(table), jnp.asarray(pos),
            jnp.asarray(active), cfg=jcfg, engine=jeng,
        )
        got = tmodel.decode_tokens(tparams, tcache, *map(torch.from_numpy,
                                                         (toks, table, pos, active)), tcfg, teng)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want)[0],
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)


def _wire(prompt, rid, max_tokens=10, logprobs=1):
    return {"model": "tiny-moe", "token_ids": [int(t) for t in prompt], "request_id": rid,
            "sampling": {"temperature": 0.0}, "stop": {"max_tokens": max_tokens},
            "output": {"logprobs": logprobs}}


def _drive(core, wires, max_steps=2000):
    from_wire = JaxRequest.from_wire if isinstance(core, JaxCore) else PreprocessedRequest.from_wire
    seqs = [core.add_request(from_wire(w)) for w in wires]
    toks = {s.request_id: [] for s in seqs}
    lps = {s.request_id: [] for s in seqs}
    for _ in range(max_steps):
        if not core.has_work():
            break
        for s, out in core.step():
            toks[s.request_id] += list(out.token_ids)
            lps[s.request_id] += [e["logprob"] for e in (out.logprobs or [])]
    assert not core.has_work()
    return toks, lps


# Each mode as the JAX engine runs it with a MoE preset (it refuses MoE only
# under pipeline parallelism).
MODES = {
    "waves": {},
    "chunked": {"scheduling": "chunked", "prefill_chunk": 32},
    "ngram": {"spec_decode": "ngram", "spec_k": 3},
    "int8_kv": {"kv_dtype": "int8"},
}


@pytest.mark.parametrize("mode", list(MODES))
def test_tiny_moe_engine_matches_jax(mode):
    """A ``tiny-moe`` engine against the JAX engine on the same weights:
    greedy streams identical, log-probabilities within ``LP_TOL``. The
    prompts repeat their phrases (drafts to accept), one is longer than
    a chunk, and two share a prefix (the prefix cache)."""
    rng = np.random.default_rng(8)
    phrase = [int(t) for t in rng.integers(1, 384, 6)]
    shared = [int(t) for t in rng.integers(1, 384, 24)]
    prompts = {
        "rep": phrase * 5,
        "long": [int(t) for t in rng.integers(1, 384, 90)],
        "pa": shared + [7, 8, 9],
        "short": [int(t) for t in rng.integers(1, 384, 5)],
    }
    jparams, tparams = _moe_weights(0)
    jcore = JaxCore(j_tiny_moe(), j_tiny_engine(**MODES[mode]), params=jparams)
    tcore, _ = build_engine("tiny-moe", MODES[mode], device="cpu", params=tparams)
    wires = [_wire(p, rid) for rid, p in prompts.items()]
    want_t, want_lp = _drive(jcore, wires)
    got_t, got_lp = _drive(tcore, wires)
    assert got_t == want_t
    for rid in prompts:
        assert len(got_t[rid]) == 10
        np.testing.assert_allclose(got_lp[rid], want_lp[rid], atol=LP_TOL, rtol=0)
    # The second wave of the shared prefix finds it cached on both sides.
    pb = [_wire(shared + [1, 2], "pb")]
    assert _drive(tcore, pb)[0] == _drive(jcore, pb)[0]
    if mode == "ngram":
        assert tcore.spec_decode_stats()["drafted_tokens"] > 0


def test_int8_weights_refused_for_moe():
    """int8 weight-only quantization stays refused for MoE presets: the
    JAX package has no int8 MoE init either."""
    with pytest.raises(ValueError, match="JAX package has no int8 MoE"):
        build_engine("tiny-moe", device="cpu", quant="int8")
    with pytest.raises(NotImplementedError):
        jmodel.init_params_quantized(jax.random.PRNGKey(0), j_tiny_moe())
    # int8 KV pages are served (test_tiny_moe_engine_matches_jax[int8_kv]).
    core, _ = build_engine("tiny-moe", {"kv_dtype": "int8"}, device="cpu")
    assert core.engine.kv_quantized


def test_moe_init_params_layout():
    """Random MoE weights have the JAX layout, drawn one layer at a time."""
    cfg = tiny_moe()
    p = tmodel.init_params(cfg, seed=3, device="cpu")
    L, E, h, i = cfg.num_layers, cfg.num_experts, cfg.hidden_size, cfg.intermediate_size
    shapes = {k: tuple(v.shape) for k, v in p["layers"].items()}
    assert shapes["w_router"] == (L, h, E) and shapes["w_down"] == (L, E, i, h)
    assert shapes["w_gate"] == shapes["w_up"] == (L, E, h, i)
    assert "wgu" not in shapes
    assert not torch.equal(p["layers"]["w_gate"][0], p["layers"]["w_gate"][1])
    std = float(p["layers"]["w_gate"].std())
    assert abs(std - h ** -0.5) < 0.1 * h ** -0.5
