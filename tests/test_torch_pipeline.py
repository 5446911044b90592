"""The port's pipeline parallelism against the JAX package's, on the CPU.

Layouts and plans are held array for array: the pp specs and their
error, ``plan_microbatches``, and each stage's params against the
addressable shards of JAX's ``shard_params_pp``. The programs run in rank
processes over gloo, one per stage (module-scoped pools of 2 and 4,
``tests/torch_tp_ranks.py``), against JAX's ``pp_forward_tokens`` under
``make_pp_mesh(2|4)`` on the 8 virtual CPU devices and the port's own
unpipelined forward: GPipe prefill logits at 1, 2 and 4 microbatches
(sequences cut mid-way by the microbatch boundaries), each stage's pages,
and one wavefront decode round's logits, to 1e-5. The whole
``EngineCore`` at pp 2 and 4 streams what JAX's pp engine and the port's
pp = 1 engine stream, greedy and seeded, with logprobs.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import model as jmodel
from dynamo_tpu.engine.core import EngineCore as JaxCore
from dynamo_tpu.llm.protocols.common import PreprocessedRequest as JaxRequest
from dynamo_tpu.parallel import pipeline as jpipe
from dynamo_tpu_torch.engine import model as tmodel
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.convert import params_from_numpy
from dynamo_tpu_torch.engine.core import EngineCore
from dynamo_tpu_torch.llm.protocols.common import (
    OutputOptions,
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.parallel import pipeline
from tests.test_pipeline_parallel import CFG as JCFG
from tests.test_pipeline_parallel import ENG as JENG
from tests.test_pipeline_parallel import build_wave, pp_prefill, single_device_prefill
from tests.torch_tp_ranks import RankPair, run_requests

# f32 logits and pages of a pipeline against JAX's and the port's
# unpipelined forward: relative 1e-5 with an absolute floor of 1e-5
# (microbatches attend the same pages in another order of rows).
RTOL = ATOL = 1e-5

CFG = ModelConfig(**dataclasses.asdict(JCFG))
ENG = EngineConfig(**dataclasses.asdict(JENG))
VARIANTS = {
    "tied": {},
    "untied_qkv_bias": {"tie_embeddings": False, "attn_qkv_bias": True},
}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jparams(variant="tied", quant=False):
    cfg = dataclasses.replace(JCFG, **VARIANTS[variant])
    init = jmodel.init_params_quantized if quant else jmodel.init_params
    return cfg, init(jax.random.PRNGKey(0), cfg)


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


def test_ranks_import_no_jax(pools):
    info = pools(2).call("info")
    assert [i["rank"] for i in info] == [0, 1]
    assert all(i["backend"] == "gloo" and not i["leaked"] for i in info)


# -- layouts and plans -------------------------------------------------------

@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("pp", [1, 2, 4])
def test_pp_param_specs_match_jax(variant, pp):
    jcfg = dataclasses.replace(JCFG, **VARIANTS[variant])
    tcfg = dataclasses.replace(CFG, **VARIANTS[variant])
    want = jax.tree.map(tuple, jpipe.pp_param_specs(jcfg, pp),
                        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert pipeline.pp_param_specs(tcfg, pp) == want
    with pytest.raises(ValueError) as jerr:
        jpipe.pp_param_specs(jcfg, 3)
    with pytest.raises(ValueError) as terr:
        pipeline.pp_param_specs(tcfg, 3)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("n_micro", [1, 2, 3, 4])
def test_plan_microbatches_match_jax(n_micro):
    """Array for array, with sequences straddling the chunks and a padded
    tail (T = 42 over 4 chunks of 11)."""
    wave = build_wave([20, 13, 9], pad_to=42, rng=np.random.RandomState(0))
    args = (wave["tokens"], wave["positions"], wave["write_pages"], wave["write_offs"],
            wave["kv_lens"], wave["cu_q_lens"], 3, wave["last_rows"], n_micro,
            ENG.garbage_block)
    want, got = jpipe.plan_microbatches(*args), pipeline.plan_microbatches(*args)
    assert got.n_micro == want.n_micro
    for f in dataclasses.fields(want):
        if f.name != "n_micro":
            np.testing.assert_array_equal(getattr(got, f.name), getattr(want, f.name), f.name)


@pytest.mark.parametrize("quant", [False, True], ids=["bf", "int8"])
@pytest.mark.parametrize("pp", [2, 4])
def test_stage_params_equal_jax_shards(pp, quant):
    """Each stage's params are the addressable shard of JAX's
    ``shard_params_pp`` on its device: its layers of every stacked leaf
    (both members of an int8 pair), the rest whole."""
    cfg, jp = _jparams("untied_qkv_bias", quant)
    tcfg = dataclasses.replace(CFG, **VARIANTS["untied_qkv_bias"])
    mesh = jpipe.make_pp_mesh(pp)
    placed = jpipe.shard_params_pp(jp, cfg, mesh)
    full = params_from_numpy(_np_tree(jp), tcfg, "cpu")
    for s in range(pp):
        tm = pipeline.PPMesh(pp, s, (torch.device("cpu"),) * pp, "gloo")
        got = pipeline.stage_params(full, tcfg, tm)
        dev = mesh.devices[s]
        flat_j = jax.tree_util.tree_flatten_with_path(placed)[0]
        for path, leaf in flat_j:
            keys = [p.key for p in path]
            if keys == ["fuse_tp"]:  # the port carries it only fused for tp > 1
                continue
            t = got
            for k in keys:
                t = t[k]
            shard = next(x.data for x in leaf.addressable_shards if x.device == dev)
            np.testing.assert_array_equal(t.numpy(), np.asarray(shard), err_msg=f"{s} {keys}")


# -- the programs --------------------------------------------------------------

@pytest.mark.parametrize("pp, n_micro", [(2, 1), (2, 2), (4, 1), (4, 2), (4, 4)])
def test_pp_prefill_matches_jax_and_single(pools, pp, n_micro):
    """The GPipe prefill of a wave whose sequences the microbatch
    boundaries cut (lens 20/13/9): the last-token logits equal JAX's
    under ``make_pp_mesh(pp)`` and the port's unpipelined forward, and the
    stages' pages together equal the unpipelined cache (the garbage page
    left out)."""
    wave = build_wave([20, 13, 9], pad_to=48, rng=np.random.RandomState(0))
    jp = jmodel.init_params(jax.random.PRNGKey(0), JCFG)
    mesh = jpipe.make_pp_mesh(pp)
    cache_pp = jax.device_put(jmodel.init_cache_stacked(JCFG, JENG),
                              jpipe.cache_sharding_pp(mesh))
    want, _ = pp_prefill(jpipe.shard_params_pp(jp, JCFG, mesh), cache_pp, wave, mesh, n_micro)
    one_logits, one_cache = single_device_prefill(jp, wave)
    params = params_from_numpy(_np_tree(jp), CFG, "cpu")
    cache = tmodel.init_cache(CFG, ENG, "cpu")
    t = {k: torch.from_numpy(v) for k, v in wave.items()}
    mine = tmodel.forward_tokens(
        params, cache, t["tokens"], t["positions"], t["write_pages"], t["write_offs"],
        t["kv_lens"], t["block_tables"], t["cu_q_lens"], t["num_seqs"], t["last_rows"], CFG)
    got = pools(pp).call("pp_prefill", tree=_np_tree(jp), cfg=CFG, eng=ENG, wave=wave,
                         n_micro=n_micro)
    for r, res in enumerate(got):
        np.testing.assert_allclose(res["logits"], np.asarray(want), rtol=RTOL, atol=ATOL,
                                   err_msg=f"stage {r} against JAX's pipeline")
        np.testing.assert_allclose(res["logits"], mine.numpy(), rtol=RTOL, atol=ATOL,
                                   err_msg=f"stage {r} against the port's pp = 1")
    np.testing.assert_allclose(mine.numpy(), np.asarray(one_logits), rtol=RTOL, atol=ATOL)
    real = slice(0, ENG.num_kv_blocks)
    pages = np.concatenate([res["cache"] for res in got])[:, real]
    np.testing.assert_allclose(pages, torch.stack(cache).numpy()[:, real], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pages, np.stack([np.asarray(c) for c in one_cache])[:, real],
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("pp", [2, 4])
def test_pp_decode_round_matches_jax_and_single(pools, pp):
    """After a GPipe prefill, one wavefront decode step (B = 4 lanes in pp
    groups, one pad lane): the logits each group drains with equal JAX's
    unpipelined ``decode_tokens`` and the port's, and every stage holds
    them. Each round posts one hop per stage boundary it crosses, one exit
    broadcast and one vocab gather once items drain."""
    lens = [20, 13, 9]
    wave = build_wave(lens, pad_to=48, rng=np.random.RandomState(1))
    jp = jmodel.init_params(jax.random.PRNGKey(0), JCFG)
    want_logits, want_cache = single_device_prefill(jp, wave)
    B = 4
    nxt = np.zeros(B, np.int32)
    nxt[:3] = np.argmax(np.asarray(want_logits), axis=-1)
    tables = np.full((B, ENG.max_blocks_per_seq), ENG.garbage_block, np.int32)
    tables[:3] = wave["block_tables"]
    pos = np.zeros(B, np.int32)
    pos[:3] = lens
    active = np.zeros(B, bool)
    active[:3] = True
    want, _ = jmodel.decode_tokens(jp, want_cache, nxt, tables, pos, active, JCFG, JENG, None)
    params = params_from_numpy(_np_tree(jp), CFG, "cpu")
    cache = tmodel.init_cache(CFG, ENG, "cpu")
    t = {k: torch.from_numpy(v) for k, v in wave.items()}
    tmodel.forward_tokens(
        params, cache, t["tokens"], t["positions"], t["write_pages"], t["write_offs"],
        t["kv_lens"], t["block_tables"], t["cu_q_lens"], t["num_seqs"], t["last_rows"], CFG)
    mine = tmodel.decode_tokens(params, cache, *map(torch.from_numpy, (nxt, tables, pos, active)),
                                CFG, ENG)
    dec = {"tokens": nxt, "tables": tables, "positions": pos, "active": active}
    got = pools(pp).call("pp_decode", tree=_np_tree(jp), cfg=CFG, eng=ENG, wave=wave, dec=dec)
    for r, res in enumerate(got):
        np.testing.assert_allclose(res["logits"][:3], np.asarray(want)[:3], rtol=RTOL,
                                   atol=ATOL, err_msg=f"stage {r} against JAX")
        np.testing.assert_allclose(res["logits"][:3], mine.numpy()[:3], rtol=RTOL, atol=ATOL,
                                   err_msg=f"stage {r} against the port's pp = 1")
        calls = res["calls"]
        assert calls["send"] == (pp if r < pp - 1 else 0)  # M = pp items pass each stage
        assert calls["recv"] == (pp if r > 0 else 0)
        assert calls["broadcast"] == calls["stage_gather"] == pp


# -- the engine ----------------------------------------------------------------

def _requests(logprobs=None):
    return [
        PreprocessedRequest(
            model="t", token_ids=list(range(3 + i, 40 + 3 * i)), request_id=f"r{i}",
            sampling=SamplingOptions(temperature=0.0 if i < 2 else 0.8, seed=7),
            stop=StopConditions(max_tokens=6, ignore_eos=True),
            output=OutputOptions(logprobs=logprobs),
        ).to_wire()
        for i in range(3)
    ]


def _jax_streams(jp, pp, requests):
    core = JaxCore(JCFG, JENG, params=jp, seed=0,
                   pp_mesh=jpipe.make_pp_mesh(pp) if pp > 1 else None)
    streams = {r["request_id"]: [] for r in requests}
    for r in requests:
        core.add_request(JaxRequest.from_wire(r))
    while core.has_work():
        for seq, out in core.step():
            streams[seq.request_id].extend(out.token_ids)
    return streams


@pytest.mark.parametrize("pp", [2, 4])
def test_engine_core_pp_matches_jax_and_single(pools, pp):
    """EngineCore on a pipeline of pp stages (GPipe prefill waves and the
    wavefront decode chain) streams what JAX's pp engine and the port's
    pp = 1 engine stream, greedy and seeded; every stage streams alike."""
    jp = jmodel.init_params(jax.random.PRNGKey(0), JCFG)
    tree = _np_tree(jp)
    requests = _requests()
    want = _jax_streams(jp, pp, requests)
    one = run_requests(EngineCore(CFG, ENG, params=params_from_numpy(tree, CFG, "cpu"), seed=0,
                                  device="cpu"), requests)
    got = pools(pp).call("engine", cfg=CFG, eng=ENG, requests=requests, tree=tree)
    assert want == one
    for res in got:
        assert res["streams"] == want
        assert res["layers"] == CFG.num_layers // pp
        assert res["stats"]["pp_stages"] == pp


def test_engine_core_pp_logprobs_match_single(pools):
    """Logprobs ride the wavefront chain (the vocab-split logits gathered):
    the chosen tokens and top ids equal the unpipelined engine's, the
    values to 1e-4 (the log-softmax sums the gathered logits in another
    order, as in JAX)."""
    tree = _np_tree(jmodel.init_params(jax.random.PRNGKey(0), JCFG))
    requests = _requests(logprobs=2)[:1]

    def lps(core):
        out = []
        core.add_request(PreprocessedRequest.from_wire(requests[0]))
        while core.has_work():
            for _, o in core.step():
                out.extend(o.logprobs or [])
        return out

    want = lps(EngineCore(CFG, ENG, params=params_from_numpy(tree, CFG, "cpu"), seed=0,
                          device="cpu"))
    assert len(want) == 6
    got = pools(2).call("engine_logprobs", cfg=CFG, eng=ENG, request=requests[0], tree=tree)
    for res in got:
        assert [e["token_id"] for e in res] == [e["token_id"] for e in want]
        for g, w in zip(res, want):
            assert g["logprob"] == pytest.approx(w["logprob"], abs=1e-4)
            assert [t for t, _ in g["top"]] == [t for t, _ in w["top"]]


def test_engine_core_pp_rejects_bad_buckets():
    """The JAX engine's construction errors, word for word: a decode width
    or a prefill bucket that does not split into pp microbatches."""
    tmesh = pipeline.PPMesh(4, 0, (torch.device("cpu"),) * 4, "gloo")
    for bad in ({"decode_buckets": (6,)}, {"prefill_buckets": (66,), "block_size": 2}):
        with pytest.raises(ValueError) as jerr:
            JaxCore(JCFG, dataclasses.replace(JENG, **bad), seed=0,
                    pp_mesh=jpipe.make_pp_mesh(4))
        with pytest.raises(ValueError) as terr:
            EngineCore(CFG, dataclasses.replace(ENG, **bad), seed=0, device="cpu",
                       pp_mesh=tmesh)
        assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("quant", [None, "int8"])
def test_stage_weights_drawn_and_loaded_alone(tmp_path, quant):
    """A stage draws (``init_params*(layer_span=...)``) and loads
    (``load_hf_llama(layer_span=...)``) exactly its layers of the whole
    model's weights, without holding the others."""
    from dynamo_tpu_torch.engine import loader
    from tests.test_torch_multihost import _hf_checkpoint
    from tests.torch_tp_ranks import _leaves

    _hf_checkpoint("qwen2", tmp_path, seed=4)
    cfg, full = loader.load_hf_llama(tmp_path, dtype=torch.float32, quant=quant, device="cpu")
    init = tmodel.init_params_quantized if quant else tmodel.init_params
    drawn = init(cfg, 0, "cpu")
    for s in range(2):
        mesh = pipeline.PPMesh(2, s, (torch.device("cpu"),) * 2, "gloo")
        span = pipeline.stage_span(cfg, 2, s)
        _, part = loader.load_hf_llama(tmp_path, dtype=torch.float32, quant=quant,
                                       device="cpu", layer_span=span)
        for got, whole in ((part, full), (init(cfg, 0, "cpu", layer_span=span), drawn)):
            want = _leaves(pipeline.stage_params(whole, cfg, mesh))
            got = _leaves(got)
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=f"stage {s} {k}")
