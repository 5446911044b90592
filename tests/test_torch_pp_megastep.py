"""Fused pp megasteps and their compositions, the port against the JAX
package, on the CPU.

The port's ``EngineCore`` runs in rank processes over gloo, one per
pipeline stage (module-scoped pools of 2 and 4, ``tests/torch_tp_ranks.py``),
on the weights of the JAX engine beside it in the test process. The
streams must be those of JAX's ``EngineCore(pp_mesh=make_pp_mesh(pp))``
and of the port's unpipelined engine, token for token and finish reason
for finish reason (logprob values to 1e-4: the vocab-split logits are
gathered and the log-softmax sums them in another order, as in JAX):
greedy and seeded lanes with top-p and logprobs, fused and single-step
chains, waves and chunked scheduling, synchronous and asynchronous
execution, EOS inside a fused megastep, a host-only stop rolled back,
block-pressure preemption, int8 weights and int8 KV pages. A stage's
tier pages are JAX's packed block sliced to its layers, byte for byte,
and what a pipeline does not serve is refused with JAX's messages.
"""

import asyncio
import dataclasses

import jax
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import EngineCore as JaxCore
from dynamo_tpu.engine import model as jmodel
from dynamo_tpu.engine.config import tiny_engine as j_tiny_engine
from dynamo_tpu.engine.config import tiny_model as j_tiny_model
from dynamo_tpu.engine.kv_quant import unpack_kv_page as j_unpack_kv_page
from dynamo_tpu.llm.protocols.common import PreprocessedRequest as JaxRequest
from dynamo_tpu.parallel.pipeline import make_pp_mesh as j_make_pp_mesh
from dynamo_tpu_torch.backends.torch import main as worker_main
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig, tiny_engine, tiny_model
from dynamo_tpu_torch.engine.convert import params_from_numpy
from dynamo_tpu_torch.engine.core import MEGASTEP_WATCH_W, EngineCore
from dynamo_tpu_torch.engine.kv_quant import pack_kv_page
from dynamo_tpu_torch.llm.protocols.common import (
    OutputOptions,
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.parallel.pipeline import PPMesh
from tests.test_pp_megastep import CFG as JCFG
from tests.test_pp_megastep import _eng as j_eng
from tests.torch_tp_ranks import RankPair, drive, tier_round_trip

CFG = ModelConfig(**dataclasses.asdict(JCFG))


def _eng(**kw) -> EngineConfig:
    return EngineConfig(**dataclasses.asdict(j_eng(**kw)))


@pytest.fixture(scope="module")
def pools():
    """Rank pools by stage count, started on first use."""
    started: dict[int, RankPair] = {}

    def get(pp: int) -> RankPair:
        if pp not in started:
            started[pp] = RankPair(pp, axes={"pp": pp})
        return started[pp]

    try:
        yield get
    finally:
        for pool in started.values():
            pool.close()


@pytest.fixture(scope="module")
def weights():
    """The JAX engine's weights (f32 and int8) and their numpy trees."""
    jp = jmodel.init_params(jax.random.PRNGKey(0), JCFG)
    jq = jmodel.init_params_quantized(jax.random.PRNGKey(0), JCFG)
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return {"f32": (jp, np_tree(jp)), "int8": (jq, np_tree(jq))}


def _req(prompt, rid, max_tokens=8, temperature=0.0, seed=None, top_p=1.0, logprobs=None,
         **stop_kw) -> dict:
    return PreprocessedRequest(
        model="t", token_ids=list(prompt), request_id=rid,
        sampling=SamplingOptions(temperature=temperature, seed=seed, top_p=top_p),
        stop=StopConditions(max_tokens=max_tokens, **stop_kw),
        output=OutputOptions(logprobs=logprobs),
    ).to_wire()


def _workload() -> list[dict]:
    """JAX's ``_workload``: greedy, seeded-temperature and top-p/logprobs
    lanes with staggered budgets, and one long prompt (a prefill wave or
    chunks between fused megasteps)."""
    rng = np.random.RandomState(0)
    reqs = [_req(list(range(i + 3, i + 30)), f"g{i}", max_tokens=8 + i, ignore_eos=True)
            for i in range(2)]
    reqs.append(_req([3, 5, 7, 9], "t", max_tokens=11, temperature=0.8, seed=11,
                     ignore_eos=True))
    reqs.append(_req([2, 4, 6, 8, 10], "p", max_tokens=9, temperature=0.9, seed=13, top_p=0.8,
                     logprobs=3, ignore_eos=True))
    reqs.append(_req(list(rng.randint(1, 400, size=50)), "long", max_tokens=6,
                     ignore_eos=True))
    return reqs


def _jax_drive(params, pp, eng, requests, eos=()):
    core = JaxCore(JCFG, eng, params=params, seed=0, eos_token_ids=tuple(eos),
                   pp_mesh=j_make_pp_mesh(pp) if pp > 1 else None)
    done = {r["request_id"]: [] for r in requests}
    fins, lps = {}, {r["request_id"]: [] for r in requests}
    for r in requests:
        core.add_request(JaxRequest.from_wire(r))
    while len(fins) < len(requests) or core.has_work():
        for s, out in core.step():
            done[s.request_id].extend(out.token_ids)
            if out.logprobs:
                lps[s.request_id].extend(out.logprobs)
            if out.finish_reason:
                fins[s.request_id] = str(out.finish_reason)
    return done, fins, lps


def _one(tree, eng, requests, eos=()):
    """The port's unpipelined engine."""
    core = EngineCore(CFG, eng, params=params_from_numpy(tree, CFG, "cpu"), seed=0,
                      eos_token_ids=tuple(eos), device="cpu")
    return drive(core, requests)


def _assert_streams_match(got, ref):
    """Tokens and finish reasons equal; logprob entries' ids equal and
    values to 1e-4 (JAX's ``_assert_streams_match``)."""
    gd, gf, gl = got
    rd, rf, rl = ref
    assert gd == rd
    assert gf == rf
    assert set(gl) == set(rl)
    for rid in rl:
        assert len(gl[rid]) == len(rl[rid])
        for a, b in zip(gl[rid], rl[rid]):
            assert a["token_id"] == b["token_id"]
            assert a["logprob"] == pytest.approx(b["logprob"], abs=1e-4)
            assert [t for t, _ in a["top"]] == [t for t, _ in b["top"]]
            for (_, la), (_, lb) in zip(a["top"], b["top"]):
                assert la == pytest.approx(lb, abs=1e-4)


def _ranks(pool, eng, requests, tree, **kw) -> list[dict]:
    res = pool.call("drive", cfg=CFG, eng=eng, requests=requests, tree=tree, **kw)
    for r in res[1:]:  # every stage streams alike
        assert r["out"] == res[0]["out"]
    return res


# -- parity: pp on/off x fused on/off ------------------------------------------

@pytest.mark.parametrize("pp", [2, 4])
def test_parity_fused_pp_vs_single_device(pools, weights, pp):
    """pp = N with fused k = 4 megasteps and forced single steps streams
    what the unpipelined single-step engine streams, and at pp = 2 what
    JAX's pp = 2 fused engine streams (JAX's pp = 4 engine is held in
    ``test_torch_pipeline.py`` and, with int8, below): greedy, seeded
    temperature, top-p and logprob lanes in one batch."""
    jp, tree = weights["f32"]
    reqs = _workload()
    ref = _one(tree, _eng(megastep_k=1), reqs)
    if pp == 2:
        _assert_streams_match(_jax_drive(jp, pp, j_eng(megastep_k=4), reqs), ref)
    single = _ranks(pools(pp), _eng(megastep_k=1), reqs, tree)
    fused = _ranks(pools(pp), _eng(megastep_k=4), reqs, tree)
    _assert_streams_match(single[0]["out"], ref)
    _assert_streams_match(fused[0]["out"], ref)
    assert fused[0]["stats"]["pp_fused_dispatches"] >= 1
    assert single[0]["stats"]["pp_fused_dispatches"] == 0


@pytest.mark.parametrize("mode", ["chunked", "async"])
def test_parity_pp_chunked_and_async(pools, weights, mode):
    """Chunked scheduling (mixed steps run single through the GPipe
    program, decode-only steps fuse) and async execution (one fused pp
    dispatch in flight while the next plans, its tokens fed on the
    device) stream what the unpipelined single-step synchronous engine
    streams; the chunked pipeline also what JAX's does."""
    jp, tree = weights["f32"]
    reqs = _workload()
    kw = ({"scheduling": "chunked", "prefill_chunk": 32, "max_num_batched_tokens": 64}
          if mode == "chunked" else {})
    ref = _one(tree, _eng(megastep_k=1, **kw), reqs)
    got = _ranks(pools(2), _eng(megastep_k=4, async_exec=mode == "async", **kw), reqs, tree)
    _assert_streams_match(got[0]["out"], ref)
    if mode == "chunked":
        _assert_streams_match(_jax_drive(jp, 2, j_eng(megastep_k=4, **kw), reqs), ref)
        assert got[0]["stats"]["mixed_steps"] > 0
    assert got[0]["stats"]["pp_fused_dispatches"] >= 1


# -- stops inside / at the boundary of a fused pp megastep ----------------------

def test_eos_inside_fused_pp_megastep(pools, weights):
    """A seeded lane that samples EOS at an inner wavefront iteration of a
    k = 8 chain finishes with "eos" mid-megastep, its neighbour untouched,
    as on the unpipelined single-step engine."""
    _, tree = weights["f32"]
    probe = _one(tree, _eng(megastep_k=1),
                 [_req([1, 2, 3], "p", max_tokens=12, temperature=0.9, seed=42,
                       ignore_eos=True)])[0]["p"]
    eos = probe[4]
    assert eos not in probe[:4], "seeded stream repeats before position 4"
    reqs = [_req([1, 2, 3], "e", max_tokens=12, temperature=0.9, seed=42),
            _req([9, 9, 9], "n", max_tokens=12, ignore_eos=True)]
    ref = _one(tree, _eng(megastep_k=1), reqs, eos=(eos,))
    got = _ranks(pools(2), _eng(megastep_k=8), reqs, tree, eos=[eos])[0]["out"]
    assert got[:2] == ref[:2]
    assert got[1]["e"] == "eos"
    assert got[0]["e"] == probe[:5]  # stopped inside the megastep


def test_host_only_stop_forces_single_and_rolls_back_on_pp(pools, weights):
    """A watch list wider than the device's MEGASTEP_WATCH_W slots forces
    the chain to k = 1 (the host stop-scan between dispatches), counted as
    ``pp_forced_single``, with the unpipelined stream and finish reason."""
    _, tree = weights["f32"]
    probe = _one(tree, _eng(megastep_k=1),
                 [_req([9, 9, 9], "p", max_tokens=20, temperature=0.9, seed=7,
                       ignore_eos=True)])[0]["p"]
    stop_tok = probe[5]
    assert stop_tok not in probe[:5], "seeded stream repeats before position 5"
    stop_ids = list(range(300, 300 + MEGASTEP_WATCH_W)) + [stop_tok]
    reqs = [_req([9, 9, 9], "x", max_tokens=20, temperature=0.9, seed=7,
                 stop_token_ids=stop_ids, ignore_eos=True)]
    ref = _one(tree, _eng(megastep_k=1), reqs)
    res = _ranks(pools(2), _eng(megastep_k=8), reqs, tree)[0]
    assert res["out"][:2] == ref[:2] == ({"x": probe[:6]}, {"x": "stop"})
    assert res["partials"] == 0
    assert res["stats"]["pp_fused_dispatches"] == 0
    assert res["stats"]["pp_forced_single"] >= 1


def test_block_pressure_drain_preempt_on_pp_engine(pools, weights):
    """k tokens of block headroom per lane are reserved at plan time on the
    pp path too: pressure preempts before the fused dispatch, and the
    replayed streams equal an unpressured unpipelined run."""
    _, tree = weights["f32"]
    reqs = [_req(list(range(1, 17)), "a", max_tokens=24, ignore_eos=True),
            _req(list(range(20, 36)), "b", max_tokens=24, ignore_eos=True)]
    ref = _one(tree, _eng(num_kv_blocks=64, max_model_len=64, megastep_k=1), reqs)
    res = _ranks(pools(2), _eng(num_kv_blocks=7, max_model_len=64, megastep_k=8), reqs, tree)[0]
    assert res["out"][:2] == ref[:2]
    assert res["partials"] == 0
    assert res["stats"]["preemptions"] >= 1


# -- quantization composition ----------------------------------------------------

@pytest.mark.parametrize("pp", [2, 4])
def test_int8_weights_and_kv_compose_with_pp(pools, weights, pp):
    """int8 weights (each ``{w, scale}`` pair whole on its stage) and int8
    KV pages together, fused pp megasteps: the unpipelined int8 engine's
    streams, and at pp = 4 JAX's pp int8 engine's."""
    jq, tree = weights["int8"]
    reqs = _workload()
    ref = _one(tree, _eng(kv_dtype="int8", megastep_k=1), reqs)
    if pp == 4:
        _assert_streams_match(_jax_drive(jq, pp, j_eng(kv_dtype="int8", megastep_k=4), reqs),
                              ref)
    res = _ranks(pools(pp), _eng(kv_dtype="int8", megastep_k=4), reqs, tree)[0]
    _assert_streams_match(res["out"], ref)
    assert res["stats"]["pp_fused_dispatches"] >= 1
    assert res["cache"] == ["dict"] * (CFG.num_layers // pp)  # this stage's {kv, scale} pages


def test_kvint8_pp_tier_round_trip_is_byte_stable(pools, tmp_path):
    """Each stage offloads and onboards its own layers' pages: its host and
    disk tiers hold the unpipelined engine's packed int8 block sliced to
    the stage's layers, byte for byte, and JAX's pp engine's block sliced
    alike (int8 values byte for byte; the f32 scales to 1e-5, the repo's
    f32 tolerance: the two frameworks sum the K/V products in another
    order, and a scale is its row's largest value over 127); the onboarded
    prefix serves the stream the prompt had on a plain engine."""
    jcfg, tcfg = j_tiny_model(), tiny_model()
    prompt = list(range(7, 7 + 40))
    rng = np.random.RandomState(1000)
    noise = [[list(rng.randint(1, 300, size=40)) for _ in range(8)] for _ in range(2)]
    tier_kw = dict(kv_dtype="int8", num_kv_blocks=24, host_kv_blocks=4, disk_kv_blocks=256,
                   max_model_len=128)
    jp = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, jp)

    jcore = JaxCore(jcfg, j_tiny_engine(disk_kv_dir=str(tmp_path / "jax"), **tier_kw),
                    params=jp, seed=0, pp_mesh=j_make_pp_mesh(2))

    def jrun(prompts, rid):
        seqs = [jcore.add_request(JaxRequest.from_wire(
            PreprocessedRequest(model="t", token_ids=list(p), request_id=f"{rid}-{j}",
                                sampling=SamplingOptions(temperature=0.0),
                                stop=StopConditions(max_tokens=6)).to_wire()))
            for j, p in enumerate(prompts)]
        while jcore.has_work():
            jcore.step()
        return seqs[0]

    prefix = jrun([prompt], "a").prompt_hashes[: (len(prompt) - 1) // 8]
    for i, batch in enumerate(noise):
        jrun(batch, f"n{i}")
    jcore.offload.flush()
    jax_blocks = {h: jcore.host_pool._blocks[h].kv.tobytes() if h in jcore.host_pool
                  else jcore.disk_pool.peek(h).tobytes()
                  for h in prefix if h in jcore.host_pool or h in jcore.disk_pool}
    assert jax_blocks, "noise did not push the prefix off the JAX engine's pages"

    one = tier_round_trip(
        lambda e: EngineCore(tcfg, e, params=params_from_numpy(tree, tcfg, "cpu"), seed=0,
                             device="cpu"),
        tiny_engine(kv_dtype="int8"),
        tiny_engine(disk_kv_dir=str(tmp_path / "one"), **tier_kw), prompt, noise)
    one_blocks = {**one["host"], **one["disk"]}
    assert one["prefix"] == prefix and set(one_blocks) == set(jax_blocks)
    got = pools(2).call(
        "tiers", cfg=tcfg, eng=tiny_engine(kv_dtype="int8"),
        tier_eng=tiny_engine(disk_kv_dir=str(tmp_path / "torch"), **tier_kw),
        prompt=prompt, noise=noise, tree=tree)
    geom = (jcfg.num_layers, 8, jcfg.num_kv_heads, jcfg.head_dim)
    for s, res in enumerate(got):
        assert res["prefix"] == prefix
        assert res["again"] == res["ref"] == one["ref"] and res["onboards"] > 0
        blocks = {**res["host"], **res["disk"]}
        assert set(blocks) == set(one_blocks)
        sl = slice(s * jcfg.num_layers // 2, (s + 1) * jcfg.num_layers // 2)
        for h, blob in blocks.items():
            kv, sc = j_unpack_kv_page(one_blocks[h], *geom)
            assert blob == pack_kv_page(kv[sl], sc[sl]).tobytes(), f"stage {s} block {h}"
            got_kv, got_sc = j_unpack_kv_page(blob, 1, *geom[1:])
            jkv, jsc = j_unpack_kv_page(jax_blocks[h], *geom)
            assert got_kv.tobytes() == jkv[sl].tobytes(), f"stage {s} block {h} against JAX"
            np.testing.assert_allclose(got_sc, jsc[sl], rtol=1e-5, atol=0)


# -- construction matrix: served combinations and refusals -------------------------

def _stage0(pp: int = 2) -> PPMesh:
    """Stage 0 of a pipeline, for construction alone (no collective runs)."""
    return PPMesh(pp, 0, (torch.device("cpu"),) * pp, "gloo")


def test_lifted_combos_construct(weights):
    """Every combination JAX serves on a pipeline builds a stage: int8
    weights, int8 KV, chunked, async, and all of them at once."""
    _, tree = weights["int8"]
    q = params_from_numpy(tree, CFG, "cpu")
    for kw, params in (({}, q), ({"kv_dtype": "int8"}, None),
                       ({"scheduling": "chunked", "prefill_chunk": 32,
                         "max_num_batched_tokens": 64}, None),
                       ({"async_exec": True}, None),
                       ({"kv_dtype": "int8", "async_exec": True, "megastep_k": 8}, q)):
        core = EngineCore(CFG, _eng(**kw), params=params, seed=0, device="cpu",
                          pp_mesh=_stage0())
        assert len(core.cache) == CFG.num_layers // 2
        assert core.scheduler_stats()["pp_stages"] == 2


def test_unsupported_combos_keep_pointed_errors():
    """What JAX refuses on a pipeline the port refuses with JAX's message:
    speculation (at construction and per request), MoE, pp with a tp/dp
    mesh, a decode width that does not split into microbatches, image
    rows."""
    from dynamo_tpu.engine.config import tiny_moe as j_tiny_moe
    from dynamo_tpu.parallel.sharding import make_mesh as j_make_mesh
    from dynamo_tpu_torch.engine.config import tiny_moe
    from dynamo_tpu_torch.parallel.sharding import make_mesh

    def same(jax_call, port_call):
        with pytest.raises(ValueError) as jerr:
            jax_call()
        with pytest.raises(ValueError) as terr:
            port_call()
        assert str(terr.value) == str(jerr.value)

    same(lambda: JaxCore(JCFG, j_eng(spec_decode="ngram", spec_k=4), seed=0,
                         pp_mesh=j_make_pp_mesh(2)),
         lambda: EngineCore(CFG, _eng(spec_decode="ngram", spec_k=4), seed=0, device="cpu",
                            pp_mesh=_stage0()))
    same(lambda: JaxCore(JCFG, j_eng(), seed=0, mesh=j_make_mesh(dp=1, tp=2),
                         pp_mesh=j_make_pp_mesh(2)),
         lambda: EngineCore(CFG, _eng(), seed=0, device="cpu",
                            mesh=make_mesh(tp=1, devices=["cpu"]), pp_mesh=_stage0()))
    same(lambda: JaxCore(JCFG, j_eng(decode_buckets=(6,)), seed=0,
                         pp_mesh=j_make_pp_mesh(4)),
         lambda: EngineCore(CFG, _eng(decode_buckets=(6,)), seed=0, device="cpu",
                            pp_mesh=_stage0(4)))
    same(lambda: JaxCore(j_tiny_moe(), j_tiny_engine(), seed=0, pp_mesh=j_make_pp_mesh(2)),
         lambda: EngineCore(tiny_moe(), tiny_engine(), seed=0, device="cpu",
                            pp_mesh=_stage0()))
    jcore = JaxCore(JCFG, j_eng(), seed=0, pp_mesh=j_make_pp_mesh(2))
    core = EngineCore(CFG, _eng(), seed=0, device="cpu", pp_mesh=_stage0())
    spec = _req([1, 2, 3], "s")
    spec["spec_decode"] = {"method": "ngram", "k": 2}
    mm = _req([1, 2, 3], "m")
    mm["mm"] = {"embeds": np.zeros((1, CFG.hidden_size), np.float32).tobytes(),
                "embeds_shape": [1, CFG.hidden_size], "positions": [[0, 1]]}
    for wire in (spec, mm):
        same(lambda: jcore.add_request(JaxRequest.from_wire(wire)),
             lambda: core.add_request(PreprocessedRequest.from_wire(wire)))


def test_multihost_pp_cli_guard():
    """``--pp`` under ``--nnodes`` stays refused, with the JAX worker's
    message; so does ``--pp`` beside ``--tp``, ``--dp`` or ``--sp``."""
    from dynamo_tpu.backends.jax.main import run_jax_worker

    with pytest.raises(ValueError) as jerr:
        asyncio.run(run_jax_worker(None, nnodes=2, pp=2))
    args = worker_main._parser().parse_args(
        ["--pp", "2", "--nnodes", "2", "--dist-init-addr", "127.0.0.1:1"])
    with pytest.raises(ValueError) as terr:
        worker_main._refuse_unported(args)
    assert str(terr.value) == str(jerr.value)
    for flags in (["--tp", "2"], ["--dp", "2"], ["--sp", "2"]):
        args = worker_main._parser().parse_args(["--pp", "2", *flags])
        with pytest.raises(ValueError, match="--pp is mutually exclusive with --tp/--dp/--sp"):
            worker_main._refuse_unported(args)


# -- observability -------------------------------------------------------------------

def test_pp_gauges_and_megastep_span(pools, weights):
    """``pp_stages``, the fused dispatches and the pipe occupancy (k*M items
    over k*M + pp - 1 rounds) on ``scheduler_stats``, ``pp_stages`` on every
    ``engine_megastep`` span, and the hops and exits each stage made; an
    unpipelined engine reports the trivial pipe."""
    _, tree = weights["f32"]
    reqs = [_req([1, 2, 3], "m", max_tokens=16, ignore_eos=True)]
    res = _ranks(pools(2), _eng(megastep_k=8), reqs, tree, spans=True)
    for s, r in enumerate(res):
        st = r["stats"]
        assert r["spans"] and all(p == 2 for p in r["spans"])
        assert st["pp_stages"] == 2 and st["pp_fused_dispatches"] >= 1
        assert st["pp_pipe_occupancy"] == pytest.approx(16 / 17)  # k*M = 8*2
        assert st["comm_backend"] == "gloo" and st["rank"] == s
        # One hop per microbatch a stage passes on or takes in.
        assert st["p2p_calls"] == st["forwards"] > 0
    st1 = EngineCore(CFG, _eng(), seed=0, device="cpu").scheduler_stats()
    assert (st1["pp_stages"], st1["pp_pipe_occupancy"], st1["p2p_calls"]) == (1, 1.0, 0)
