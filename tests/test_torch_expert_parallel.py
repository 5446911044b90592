"""The port's expert parallelism against the JAX package's, on the CPU.

Rank processes over gloo (module-scoped pools of tp = 2 and dp 2 x tp 2,
``tests/torch_tp_ranks.py``) hold ``E / tp`` experts each. ``_moe_mlp``
over tp = 2 in both modes (``replicated``: every rank dispatches every
token to its experts and the partials are summed; ``alltoall``: the token
slices travel to their experts and back) matches JAX's ``_moe_mlp`` under
``make_mesh(dp=1, tp=2)`` in the same mode on 14 tokens (the all-to-all's
padding path), within 1e-5 (f32, ``tests/test_moe.py``'s tolerance), at
a capacity with room for every entry, at the default and at a saturating
one (where the two modes drop differently, each as JAX's mode does). A
``tiny-moe`` engine over dp 2 x tp 2 streams the tokens of JAX's
single-device engine and of its dp 2 x tp 2 engine in both modes, and a
``--tp 2 --moe-dispatch alltoall`` worker on CPU ranks serves the tokens
of a single worker.
"""

import asyncio
import dataclasses

import jax
import numpy as np
import pytest
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from dynamo_tpu.engine import model as jmodel
from dynamo_tpu.engine.config import tiny_engine as j_tiny_engine
from dynamo_tpu.engine.config import tiny_moe as j_tiny_moe
from dynamo_tpu.parallel.sharding import make_mesh as j_make_mesh
from dynamo_tpu_torch.engine.config import tiny_engine, tiny_moe
from dynamo_tpu_torch.engine.model import moe_overflow
from tests.test_torch_multihost import _jax_streams, _serve_one
from tests.torch_tp_ranks import RankPair

MLP_TOL = 1e-5
CAPACITY = {"generous": float(tiny_moe().num_experts), "default": tiny_moe().moe_capacity_factor,
            "saturated": 0.5}
MESHES = {"tp2": {"tp": 2}, "dp2tp2": {"dp": 2, "tp": 2}}


@pytest.fixture(scope="module")
def pools():
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


@pytest.mark.parametrize("capacity", list(CAPACITY))
@pytest.mark.parametrize("dispatch", ["replicated", "alltoall"])
def test_moe_mlp_matches_jax_mode(pools, dispatch, capacity):
    """Layer 0's MoE MLP on 14 tokens over tp = 2 ranks, each rank holding
    two of the four experts: every rank returns JAX's output of the same
    mode; replicated calls one all-reduce, alltoall two all-to-alls and
    one gather. With room for every entry the modes agree with each
    other; saturated, both drop (``moe_overflow`` says so)."""
    import torch

    jcfg = dataclasses.replace(j_tiny_moe(), moe_capacity_factor=CAPACITY[capacity],
                               moe_dispatch=dispatch)
    tcfg = dataclasses.replace(tiny_moe(), moe_capacity_factor=CAPACITY[capacity])
    rng = jax.random.PRNGKey(7)
    lp = jax.tree.map(lambda a: np.asarray(a[0]), jmodel.init_params(rng, jcfg)["layers"])
    lp = {k: lp[k] for k in ("w_router", "w_gate", "w_up", "w_down")}
    x = np.asarray(jax.random.normal(jax.random.fold_in(rng, 1), (14, jcfg.hidden_size)))
    mesh = j_make_mesh(dp=1, tp=2)
    sharded = {k: jax.device_put(v, NamedSharding(mesh, P() if k == "w_router" else P("tp")))
               for k, v in lp.items()}
    want = np.asarray(jax.jit(lambda a, w: jmodel._moe_mlp(a, w, jcfg, mesh=mesh))(x, sharded))
    got = pools("tp2").call("moe_mlp", x=x, lp=lp, cfg=tcfg, dispatch=dispatch)
    for res in got:
        np.testing.assert_allclose(res["out"], want, rtol=MLP_TOL, atol=MLP_TOL)
        calls = res["calls"]
        if dispatch == "alltoall":
            assert (calls["all_to_all"], calls["all_gather"], calls["all_reduce"]) == (2, 1, 0)
        else:
            assert (calls["all_to_all"], calls["all_reduce"]) == (0, 1)
    over = moe_overflow(torch.tensor(x), torch.tensor(lp["w_router"]), tcfg, tp=2)
    assert over["replicated"] == over["alltoall"] == (capacity == "saturated"), over
    if capacity == "generous":
        other = "alltoall" if dispatch == "replicated" else "replicated"
        again = pools("tp2").call("moe_mlp", x=x, lp=lp, cfg=tcfg, dispatch=other)[0]
        np.testing.assert_allclose(again["out"], want, rtol=MLP_TOL, atol=MLP_TOL)


def _requests() -> list[dict]:
    return [{"model": "tiny-moe", "token_ids": list(range(5 + i, 30 + i)), "request_id": f"r{i}",
             "sampling": {"temperature": 0.0}, "stop": {"max_tokens": 6, "ignore_eos": True}}
            for i in range(3)]


@pytest.mark.parametrize("dispatch", ["replicated", "alltoall"])
def test_ep_engine_dp2tp2_matches_jax(pools, dispatch):
    """JAX's ``test_alltoall_engine_parity_with_single_device`` and
    ``test_moe_expert_parallel_matches_single_device`` on both packages: a
    ``tiny-moe`` engine over dp 2 x tp 2 (two experts per rank, each decode
    megastep's lanes split over dp and gathered for the dispatch) streams
    the JAX single-device engine's tokens and the JAX dp 2 x tp 2 engine's
    in the same mode, on the same weights, on every rank."""
    generous = float(tiny_moe().num_experts)
    jcfg = dataclasses.replace(j_tiny_moe(), moe_capacity_factor=generous,
                               moe_dispatch=dispatch)
    tcfg = dataclasses.replace(tiny_moe(), moe_capacity_factor=generous, moe_dispatch=dispatch)
    jp2 = jmodel.init_params(jax.random.PRNGKey(2), jcfg, tp=2)
    jp1 = jmodel.init_params(jax.random.PRNGKey(2), jcfg, tp=1)
    reqs = _requests()
    want = _jax_streams(jcfg, j_tiny_engine(), jp1, None, reqs)
    assert _jax_streams(jcfg, j_tiny_engine(), jp2, j_make_mesh(dp=2, tp=2), reqs) == want
    got = pools("dp2tp2").call("drive", cfg=tcfg, eng=tiny_engine(), requests=reqs,
                               tree=jax.tree.map(np.asarray, jp2))
    for res in got:
        toks, fins, _ = res["out"]
        assert toks == want and set(fins.values()) == {"length"}
        st = res["stats"]
        assert (st["dp"], st["tp"]) == (2, 2)
        per_layer = 4 if dispatch == "alltoall" else 2
        assert st["collectives_per_forward"] == per_layer * tcfg.num_layers


def test_worker_tp2_alltoall_on_cpu_ranks_serves_tp1_tokens(tmp_path):
    """``--tp 2 --moe-dispatch alltoall --preset tiny-moe`` with
    ``--local-cpu-devices 2`` serves the tokens of a single ``tiny-moe``
    worker (at the default capacity neither mode drops an entry on this
    preset: C = N, Cs = n * k)."""
    req = dict(_requests()[0], stop={"max_tokens": 10, "ignore_eos": True})
    runs = {"one": ["--device", "cpu", "--preset", "tiny-moe"],
            "ep": ["--tp", "2", "--local-cpu-devices", "2", "--preset", "tiny-moe",
                   "--moe-dispatch", "alltoall"]}

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
    log = (tmp_path / "ep.log").read_text()
    assert streams[0] == streams[1] and len(streams[0]) == 10, log[-3000:]
    assert "tp=2 over gloo" in log
    assert '"all_to_all": ' in log and "torch follower rank 1 stopping" in log, log[-3000:]
