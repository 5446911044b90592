"""The port's in-engine data parallelism against dp = 1 and the JAX
package, on the CPU.

Rank processes over gloo (module-scoped pools of dp 2 x tp 1 and dp 2 x
tp 2, ``tests/torch_tp_ranks.py``) run the port's ``EngineCore`` with a
replica of the model (of its tp shard) and of the cache each; a decode
megastep's lanes split over dp, the lane blocks' K/V rows and outputs
gathered so the replicas stay equal. Their streams must be the port's
dp = 1 streams and JAX's ``EngineCore(mesh=make_mesh(dp=2, tp=...))``
streams, token for token. The decode-width refusal and the worker's
trimming of widths and buckets are JAX's; the lockstep keeps pp stages
and dp ranks in step; ``--dp 2`` and ``--pp 2`` workers on CPU ranks
serve a single worker's tokens over the store and data plane.
"""

import asyncio
import dataclasses

import jax
import numpy as np
import pytest
import torch

from dynamo_tpu.backends.jax import main as jax_worker_main
from dynamo_tpu.engine import model as jmodel
from dynamo_tpu.engine.config import tiny_engine as j_tiny_engine
from dynamo_tpu.engine.config import tiny_model as j_tiny_model
from dynamo_tpu.engine.core import EngineCore as JaxCore
from dynamo_tpu.parallel.sharding import make_mesh as j_make_mesh
from dynamo_tpu_torch.backends.torch import main as worker_main
from dynamo_tpu_torch.engine.config import tiny_engine, tiny_model
from dynamo_tpu_torch.engine.convert import params_from_numpy
from dynamo_tpu_torch.engine.core import EngineCore
from dynamo_tpu_torch.parallel.sharding import Mesh, dp_lane_block
from tests.test_torch_multihost import UNTIED, _jax_streams, _requests, _serve_one
from tests.torch_tp_ranks import RankPair, drive, unblocked

MODES = {
    "waves": {},
    "chunked": {"scheduling": "chunked", "prefill_chunk": 16, "max_num_batched_tokens": 64},
    "int8kv": {"kv_dtype": "int8"},
}
MESHES = {"dp2": {"dp": 2}, "dp2tp2": {"dp": 2, "tp": 2}, "pp2": {"pp": 2}}


@pytest.fixture(scope="module")
def pools():
    """Rank pools by mesh name (``MESHES``), started on first use."""
    started: dict[str, RankPair] = {}

    def get(name: str) -> RankPair:
        if name not in started:
            axes = MESHES[name]
            started[name] = RankPair(int(np.prod(list(axes.values()))), axes=axes)
        return started[name]

    try:
        yield get
    finally:
        for pool in started.values():
            pool.close()


def _mixed_requests() -> list[dict]:
    """Greedy lanes and a seeded one with logprobs, over five lanes (a
    width-8 dispatch: each dp rank computes four lanes, one of them idle
    padding on the second)."""
    reqs = _requests(n=4, max_tokens=12)
    reqs.append({"model": "tiny", "token_ids": [3, 5, 7, 9, 11], "request_id": "s",
                 "sampling": {"temperature": 0.9, "seed": 13, "top_p": 0.8},
                 "output": {"logprobs": 2}, "stop": {"max_tokens": 10, "ignore_eos": True}})
    return reqs


def test_ranks_and_lane_blocks(pools):
    """Rank r of a dp x tp mesh is (r // tp, r % tp) as in JAX's
    ``devices.reshape(dp, tp)``, and a dp rank's lanes are its contiguous
    block (JAX's ``P("dp")`` split)."""
    info = pools("dp2tp2").call("info")
    assert [i["rank"] for i in info] == [0, 1, 2, 3]
    assert all(i["backend"] == "gloo" and not i["leaked"] for i in info)
    cpu = (torch.device("cpu"),) * 4
    blocks = [dp_lane_block(Mesh(2, 2, r, cpu, "gloo"), 8) for r in range(4)]
    assert blocks == [(0, 4), (0, 4), (4, 8), (4, 8)]
    assert [Mesh(2, 2, r, cpu, "gloo").tp_rank for r in range(4)] == [0, 1, 0, 1]
    with pytest.raises(ValueError, match="decode width 5 not a multiple of dp=2"):
        dp_lane_block(Mesh(2, 1, 0, cpu[:2], "gloo"), 5)


@pytest.mark.parametrize("mesh", ["dp2", "dp2tp2"])
@pytest.mark.parametrize("mode", list(MODES))
def test_dp_engine_streams_match_dp1_and_jax(pools, mesh, mode):
    """The dp engine streams what the port's dp = 1 engine streams (and the
    JAX engine under ``make_mesh(dp=2, tp)``), tokens, finish reasons and
    logprob ids exactly, logprob values to 1e-4; every rank streams alike,
    each holding the whole cache (all layers, its tp heads). A decode
    iteration gathers the lanes' write targets once and each layer's K/V
    rows over dp."""
    tp = MESHES[mesh].get("tp", 1)
    jcfg = dataclasses.replace(j_tiny_model(), **UNTIED)
    tcfg = dataclasses.replace(tiny_model(), **UNTIED)
    jp = jmodel.init_params(jax.random.PRNGKey(3), jcfg, tp=tp)
    tree = jax.tree.map(np.asarray, jp)
    requests = _mixed_requests()
    eng = tiny_engine(**MODES[mode])
    one = drive(EngineCore(tcfg, eng, params=params_from_numpy(unblocked(tree, tcfg), tcfg,
                                                               "cpu"), seed=0, device="cpu"),
                requests)
    greedy = [r for r in requests if r["request_id"] != "s"]
    want = _jax_streams(jcfg, j_tiny_engine(**MODES[mode]), jp, j_make_mesh(dp=2, tp=tp), greedy)
    assert want == {r["request_id"]: one[0][r["request_id"]] for r in greedy}
    got = pools(mesh).call("drive", cfg=tcfg, eng=eng, requests=requests, tree=tree)
    for res in got:
        toks, fins, lps = res["out"]
        assert (toks, fins) == one[:2]
        for a, b in zip(lps["s"], one[2]["s"], strict=True):
            assert a["token_id"] == b["token_id"]
            assert a["logprob"] == pytest.approx(b["logprob"], abs=1e-4)
            assert [t for t, _ in a["top"]] == [t for t, _ in b["top"]]
        st = res["stats"]
        assert (st["dp"], st["tp"]) == (2, tp)
        assert len(res["cache"]) == tcfg.num_layers
    res = pools(mesh).call("engine", cfg=tcfg, eng=eng, requests=greedy, tree=tree)[0]
    # Per decode iteration the write targets and each layer's rows; per
    # decode megastep also its tokens.
    per_iter = 1 + tcfg.num_layers
    assert res["calls"]["dp_gather"] > res["stats"]["decode_iterations"] * per_iter > 0


def test_dp_decode_bucket_refused():
    """A decode width that does not split over dp is refused at
    construction with the JAX engine's message."""
    with pytest.raises(ValueError) as jerr:
        JaxCore(j_tiny_model(), j_tiny_engine(decode_buckets=(3,)), seed=0,
                mesh=j_make_mesh(dp=2, tp=1))
    mesh = Mesh(2, 1, 0, (torch.device("cpu"),) * 2, "gloo")
    with pytest.raises(ValueError) as terr:
        EngineCore(tiny_model(), tiny_engine(decode_buckets=(3,)), seed=0, device="cpu",
                   mesh=mesh)
    assert str(terr.value) == str(jerr.value) == "decode bucket 3 not a multiple of dp=2"


@pytest.mark.parametrize("buckets, pp, bs", [((6, 16), 4, 2), ((6,), 4, 2), ((32, 64), 2, 8),
                                             ((12,), 8, 4)])
def test_pp_prefill_buckets_match_jax_worker(buckets, pp, bs):
    assert (worker_main._pp_prefill_buckets(buckets, pp, bs)
            == jax_worker_main._pp_prefill_buckets(buckets, pp, bs))


@pytest.mark.parametrize("mesh, overrides", [
    ("dp2", {"decode_buckets": (3, 4, 6)}),
    ("dp2", {"decode_buckets": (3,)}),
    ("pp2", {"decode_buckets": (3, 4), "prefill_buckets": (32, 64)}),
], ids=["dp-subset", "dp-none-left", "pp"])
def test_worker_trims_widths_and_buckets(pools, mesh, overrides):
    """``build_engine`` on a dp or pp mesh settles on the decode widths
    (and under pp the prefill buckets) the JAX worker's ``build_engine``
    settles on for the same flags; a pp stage holds its layers."""
    axes = MESHES[mesh]
    jcore = jax_worker_main.build_engine("tiny", overrides, dp=axes.get("dp", 1),
                                         pp=axes.get("pp", 1))[0]
    for res in pools(mesh).call("build", preset="tiny", overrides=overrides):
        assert res["decode_buckets"] == jcore.engine.decode_buckets
        assert res["prefill_buckets"] == jcore.engine.prefill_buckets
        assert res["layers"] == tiny_model().num_layers // axes.get("pp", 1)


@pytest.mark.parametrize("mesh", ["dp2", "pp2"])
def test_lockstep_on_dp_ranks_and_pp_stages(pools, mesh):
    """A LeaderCore journals a cancel mid-stream and a rejected add; the
    other ranks (a dp replica, a pipeline stage), replaying the records,
    emit exactly what the leader emitted, with the same request counter."""
    tcfg = tiny_model()
    eng = tiny_engine(decode_chain=2)
    requests = _requests(max_tokens=12)
    requests[2] = dict(requests[2], sampling={"temperature": 1.0})  # seeded from the counter
    bad = dict(requests[0], request_id="bad", token_ids=[5] * (eng.max_model_len + 4))
    lead, follow = pools(mesh).call("lockstep", cfg=tcfg, eng=eng, requests=requests,
                                    cancel_after=2, bad=bad)
    assert "exceeds max_model_len" in lead["rejected"]
    assert follow["emitted"] == lead["emitted"]
    assert follow["records"] == lead["records"] and follow["counter"] == lead["counter"] == 4


@pytest.mark.parametrize("mesh", ["dp2", "pp2"])
def test_mesh_refusals_name_their_items(pools, mesh):
    """What a dp or pp engine once refused by ROADMAP.md A12d it serves:
    an embedding (the same on both ranks), a held prefill's export (the
    whole pages on rank 0: a dp replica's own, a pipeline's stages'
    layers joined), their import into a second core of the mesh and its
    pages read back for a peer byte for byte, and the same through a
    direct import (each rank copying its own part), each core holding the
    five blocks cached, on both ranks."""
    eng = tiny_engine()
    lead, follow = pools(mesh).call("mesh_paths", cfg=tiny_model(), eng=eng)
    np.testing.assert_array_equal(lead["embed"], follow["embed"])
    assert lead["blocks"] == len(lead["pages"]) == lead["imported"] == follow["imported"] == 5
    assert lead["back"] == lead["direct_back"] == lead["pages"]
    assert follow["pages"] == follow["back"] == follow["direct_back"] == []
    assert lead["direct"] == follow["direct"] == 5
    assert lead["used"] == follow["used"] == [5, 5, 5]


def test_worker_dp_and_pp_on_cpu_ranks_serve_single_tokens(tmp_path):
    """``--dp 2`` and ``--pp 2`` workers with ``--local-cpu-devices 2`` start
    their second rank themselves and serve a request over the store and
    data plane with the tokens of a single worker started beside them
    (namespaces apart); both ranks of each log their counters at exit."""
    req = _requests(1, max_tokens=10)[0]
    runs = {"one": ["--device", "cpu"], "dp2": ["--dp", "2", "--local-cpu-devices", "2"],
            "pp2": ["--pp", "2", "--local-cpu-devices", "2"]}

    async def all_of(logs):
        from dynamo_tpu_torch.runtime.store import StoreServer

        store = StoreServer()
        await store.start()
        try:
            return await asyncio.gather(*(
                _serve_one(store.address, [*flags, "--namespace", k], logs[k], req, k)
                for k, flags in runs.items()))
        finally:
            await store.stop()

    logs = {k: open(tmp_path / f"{k}.log", "w") for k in runs}
    try:
        streams = asyncio.run(asyncio.wait_for(all_of(logs), 150))
    finally:
        for f in logs.values():
            f.close()
    assert len(streams[0]) == 10
    for name, stream in zip(runs, streams):
        log = (tmp_path / f"{name}.log").read_text()
        assert stream == streams[0], log[-3000:]
        if name != "one":
            assert f"{name[:2]}=2 over gloo" in log
            assert "torch follower rank 1 stopping" in log, log[-3000:]
