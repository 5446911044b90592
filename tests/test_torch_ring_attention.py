"""The port's sequence-parallel ring prefill against the JAX package's, on
the CPU.

Rank processes over gloo (module-scoped pools of sp = 2 and sp = 4,
``tests/torch_tp_ranks.py``) run the port's ``ring_attention``: K/V chunks
go round the ring between the processes while each folds them into its
online softmax. At the shapes of ``tests/test_ring_attention.py`` it must
match JAX's ``ring_attention`` over its 8-device CPU mesh and JAX's
``causal_attention_reference`` within 2e-5 (f32, sums in other orders).
A tiny-preset sp = 2 engine streams exactly what JAX's
``EngineCore(sp_mesh=sequence_parallel_mesh(2))`` and the port's plain
engine stream, with one ring prefill; a short prompt stays paged, a
repeat of the long one hits the blocks the ring committed, and every
rank's cache holds the same bytes. The ``tiny-moe`` preset is served
too, its MoE input gathered over the ranks. The refusals are JAX's, and
a ``--sp 2`` worker on CPU ranks serves a long prompt.
"""

import asyncio
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.backends.jax import main as jax_worker_main
from dynamo_tpu.engine import model as jmodel
from dynamo_tpu.engine.config import tiny_engine as j_tiny_engine
from dynamo_tpu.engine.config import tiny_model as j_tiny_model
from dynamo_tpu.engine.config import tiny_moe as j_tiny_moe
from dynamo_tpu.engine.core import EngineCore as JaxCore
from dynamo_tpu.ops import ring_attention as jring
from dynamo_tpu.parallel.pipeline import make_pp_mesh as j_make_pp_mesh
from dynamo_tpu.parallel.sharding import make_mesh as j_make_mesh
from dynamo_tpu_torch.backends.torch import main as worker_main
from dynamo_tpu_torch.engine.config import tiny_engine, tiny_model, tiny_moe
from dynamo_tpu_torch.engine.convert import params_from_numpy
from dynamo_tpu_torch.engine.core import EngineCore
from dynamo_tpu_torch.ops import ring_attention as tring
from dynamo_tpu_torch.parallel.pipeline import PPMesh
from dynamo_tpu_torch.parallel.sharding import Mesh
from tests.test_torch_multihost import ROOT
from tests.torch_tp_ranks import RankPair, run_requests

RING_TOL = 2e-5
CPU2 = (torch.device("cpu"),) * 2
SHAPES = [(256, 8, 4, 16), (64, 4, 4, 32)]


@pytest.fixture(scope="module")
def pools():
    """sp rank pools by size, started on first use."""
    started: dict[int, RankPair] = {}

    def get(sp: int) -> RankPair:
        if sp not in started:
            started[sp] = RankPair(sp, axes={"sp": sp})
        return started[sp]

    try:
        yield get
    finally:
        for pool in started.values():
            pool.close()


@functools.cache
def _jax_side(T, n_q, n_kv, d) -> tuple:
    """Seeded q, k, v (numpy), JAX's reference and JAX's ring over its
    8-device mesh (jitted, as ``test_ring_under_jit``)."""
    ks = jax.random.split(jax.random.PRNGKey(0), 3)
    q, k, v = (jax.random.normal(kk, (T, n, d), jnp.float32)
               for kk, n in zip(ks, (n_q, n_kv, n_kv)))
    mesh = jring.sequence_parallel_mesh(8)
    ring = jax.jit(lambda a, b, c: jring.ring_attention(a, b, c, mesh))(q, k, v)
    return ((np.array(q), np.array(k), np.array(v)),
            np.asarray(jring.causal_attention_reference(q, k, v)), np.asarray(ring))


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("T,n_q,n_kv,d", SHAPES)
def test_ring_matches_jax(pools, sp, T, n_q, n_kv, d):
    """Every rank returns the whole output, equal to JAX's ring over 8
    devices and to its single-device reference; each rank sent and
    received K and V ``sp - 1`` times."""
    (q, k, v), want, jax_ring = _jax_side(T, n_q, n_kv, d)
    ref = tring.causal_attention_reference(*map(torch.from_numpy, (q, k, v))).numpy()
    np.testing.assert_allclose(ref, want, rtol=RING_TOL, atol=RING_TOL)
    for res in pools(sp).call("ring", q=q, k=k, v=v):
        np.testing.assert_allclose(res["out"], want, rtol=RING_TOL, atol=RING_TOL)
        np.testing.assert_allclose(res["out"], jax_ring, rtol=RING_TOL, atol=RING_TOL)
        assert res["calls"]["ring_send"] == res["calls"]["ring_recv"] == 2 * (sp - 1)
        assert res["calls"]["sp_gather"] == 1


def test_ring_rejects_indivisible():
    """A sequence that does not split over the ranks is refused with JAX's
    message, before any exchange."""
    q = np.zeros((30, 4, 16), np.float32)
    with pytest.raises(ValueError) as jerr:
        jring.ring_attention(*(jnp.asarray(q),) * 3, jring.sequence_parallel_mesh(4))
    mesh = tring.SPMesh(4, 0, (torch.device("cpu"),) * 4, "gloo")
    with pytest.raises(ValueError) as terr:
        tring.ring_attention(*(torch.from_numpy(q),) * 3, mesh)
    assert str(terr.value) == str(jerr.value) == "sequence 30 not divisible by 4-way sp"


def _wire(prompt, rid, max_tokens):
    return {"model": "tiny", "token_ids": [int(t) for t in prompt], "request_id": rid,
            "sampling": {"temperature": 0.0},
            "stop": {"max_tokens": max_tokens, "ignore_eos": True}}


@pytest.mark.parametrize("preset", ["tiny", "tiny-moe", "tiny-int8kv"])
def test_sp_engine_matches_jax_sp_engine_and_plain(pools, preset):
    """JAX's ``test_engine_ring_prefill_matches_paged_waves`` on both
    packages: a 100-token prompt over the threshold of 64 runs as one ring
    prefill on every sp rank and streams the tokens of JAX's sp engine and
    of the port's plain engine, on the same weights; a short prompt stays
    on the paged waves; the long prompt again hits the blocks the ring
    committed and streams the same tokens. Every rank's cache ends with
    the same bytes. An int8 cache quantizes the ring's rows as it writes
    them, as JAX's does."""
    jcfg, tcfg = (j_tiny_moe(), tiny_moe()) if preset == "tiny-moe" else (j_tiny_model(),
                                                                          tiny_model())
    kv = {"kv_dtype": "int8"} if preset == "tiny-int8kv" else {}
    jp = jmodel.init_params(jax.random.PRNGKey(4), jcfg)
    tree = jax.tree.map(np.asarray, jp)
    prompt = list(np.random.RandomState(3).randint(1, 300, size=100))
    batches = [[_wire(prompt, "ring", 8)], [_wire(range(1, 20), "short", 4)],
               [_wire(prompt, "again", 8)]]
    jeng = j_tiny_engine(ring_prefill_threshold=64, **kv)
    jcore = JaxCore(jcfg, jeng, params=jp, seed=0, sp_mesh=jring.sequence_parallel_mesh(2))
    want = [_jax_streams_on(jcore, b) for b in batches]
    assert jcore._ring_prefills == 1
    plain = EngineCore(tcfg, tiny_engine(**kv), params=params_from_numpy(tree, tcfg, "cpu"),
                       seed=0, device="cpu")
    assert [run_requests(plain, b) for b in batches] == want
    got = pools(2).call("sp_engine", cfg=tcfg, eng=tiny_engine(ring_prefill_threshold=64, **kv),
                        batches=batches, tree=tree)
    for res in got:
        assert res["streams"] == want
        st = res["stats"]
        assert (st["sp"], st["ring_prefills"], st["comm_backend"]) == (2, 1, "gloo")
        assert res["kv"][2]["admitted_hits"] > res["kv"][1]["admitted_hits"]
        # One ring prefill: K and V sent once per layer (sp - 1 = 1 hop),
        # the logits broadcast once, and under MoE the MLP input gathered
        # once per layer.
        calls = res["calls"]
        assert calls["ring_send"] == calls["ring_recv"] == 2 * tcfg.num_layers
        assert calls["sp_broadcast"] == 1
        assert calls["sp_gather"] == (tcfg.num_layers if tcfg.is_moe else 0)
    assert got[0]["cache_sha"] == got[1]["cache_sha"]


def _jax_streams_on(core, requests):
    from dynamo_tpu.llm.protocols.common import PreprocessedRequest as JaxRequest

    streams = {r["request_id"]: [] for r in requests}
    for r in requests:
        core.add_request(JaxRequest.from_wire(r))
    while core.has_work():
        for seq, out in core.step():
            streams[seq.request_id].extend(out.token_ids)
    return streams


def _jax_error(fn) -> str:
    with pytest.raises(ValueError) as err:
        fn()
    return str(err.value)


@pytest.mark.parametrize("case", ["chunked", "async", "mesh", "pp"])
def test_sp_engine_refusals_are_jax(case):
    """An sp engine refuses chunked scheduling, async execution and a tp/dp
    or pp mesh beside it, with the JAX engine's messages."""
    jsp = jring.sequence_parallel_mesh(2)
    sp = tring.SPMesh(2, 0, CPU2, "gloo")
    eng = {"chunked": {"scheduling": "chunked"}, "async": {"async_exec": True}}.get(case, {})
    jkw = {"mesh": {"sp_mesh": jsp, "mesh": j_make_mesh(dp=1, tp=2)},
           "pp": {"pp_mesh": j_make_pp_mesh(2), "sp_mesh": jsp}}.get(case, {"sp_mesh": jsp})
    tkw = {"mesh": {"sp_mesh": sp, "mesh": Mesh(1, 2, 0, CPU2, "gloo")},
           "pp": {"pp_mesh": PPMesh(2, 0, CPU2, "gloo"), "sp_mesh": sp}}.get(case,
                                                                               {"sp_mesh": sp})
    want = _jax_error(lambda: JaxCore(j_tiny_model(), j_tiny_engine(**eng), seed=0, **jkw))
    with pytest.raises(ValueError) as err:
        EngineCore(tiny_model(), tiny_engine(**eng), seed=0, device="cpu", **tkw)
    assert str(err.value) == want


@pytest.mark.parametrize("flags, want", [
    (["--sp", "2", "--tp", "2"], "--sp is mutually exclusive with --tp/--dp for now"),
    (["--sp", "2", "--dp", "2"], "--sp is mutually exclusive with --tp/--dp for now"),
    (["--sp", "2", "--pp", "2"], "--pp is mutually exclusive with --tp/--dp/--sp for now"),
    (["--sp", "2", "--nnodes", "2"], "--sp (ring prefill) is not supported under --nnodes yet"),
    (["--sp", "2", "--role", "prefill", "--nnodes", "2"],
     "multi-host serving supports role=aggregated only"),
    (["--sp", "2", "--role", "decode", "--nnodes", "2"],
     "multi-host serving supports role=aggregated only"),
], ids=["tp", "dp", "pp", "nnodes", "prefill", "decode"])
def test_worker_sp_refusals(flags, want):
    """The worker's refusals of ``--sp`` beside other axes are the JAX
    worker's messages (``build_engine``'s for the meshes, ``run_jax_worker``'s
    under ``--nnodes``, where a role but the aggregated one is refused
    first, as there; on one node an sp worker serves every role)."""
    args = worker_main._parser().parse_args(flags)
    with pytest.raises(ValueError) as err:
        worker_main._refuse_unported(args)
    assert want in str(err.value)
    if flags[2] in ("--tp", "--dp", "--pp"):
        jax_msg = _jax_error(lambda: jax_worker_main.build_engine(
            "tiny", sp=2, **{flags[2][2:]: 2}))
        assert str(err.value) == jax_msg


@pytest.mark.parametrize("overrides", [{}, {"ring_prefill_threshold": 96}],
                         ids=["default", "explicit"])
def test_worker_threshold_is_jax(overrides):
    """``build_engine`` of an sp = 2 engine without a threshold routes every
    prompt that fills half the largest bucket round the ring, and keeps
    an explicit one, as the JAX worker's ``build_engine`` does."""
    jcore, _ = jax_worker_main.build_engine("tiny", overrides, sp=2)
    core, _ = worker_main.build_engine("tiny", overrides, device="cpu",
                                       sp_mesh=tring.SPMesh(2, 0, CPU2, "gloo"))
    assert core.engine.ring_prefill_threshold == jcore.engine.ring_prefill_threshold
    assert core.engine.ring_prefill_threshold == overrides.get("ring_prefill_threshold", 64)


def test_worker_sp2_on_cpu_ranks_serves_long_prompt(tmp_path):
    """``--sp 2 --local-cpu-devices 2`` starts its second rank itself and
    serves a long prompt (over the default threshold of 64 tokens) and a
    short one with a single worker's tokens; both ranks log one ring
    prefill at exit."""
    long_req = _wire(list(np.random.RandomState(5).randint(3, 300, size=90)), "long", 8)
    short_req = _wire(list(range(3, 20)), "short", 6)
    runs = {"one": ["--device", "cpu"], "sp2": ["--sp", "2", "--local-cpu-devices", "2"]}

    async def all_of(logs):
        from dynamo_tpu_torch.runtime.store import StoreServer

        store = StoreServer()
        await store.start()
        try:
            return await asyncio.gather(*(
                _serve_two(store.address, [*flags, "--namespace", k], logs[k],
                           [long_req, short_req], k)
                for k, flags in runs.items()))
        finally:
            await store.stop()

    logs = {k: open(tmp_path / f"{k}.log", "w") for k in runs}
    try:
        streams = asyncio.run(asyncio.wait_for(all_of(logs), 150))
    finally:
        for f in logs.values():
            f.close()
    log = (tmp_path / "sp2.log").read_text()
    assert streams[0] == streams[1] and [len(s) for s in streams[0]] == [8, 6], log[-3000:]
    assert "sp=2 over gloo" in log
    assert log.count('"ring_prefills": 1') == 2, log[-3000:]


async def _serve_two(address: str, extra: list[str], log, reqs: list[dict], namespace: str
                     ) -> list[list[int]]:
    """Start a tiny worker with ``extra`` flags, send ``reqs`` one after
    another once it serves, return their tokens; the worker is stopped
    (and joined) whatever happens."""
    import os
    import subprocess
    import sys
    import time

    from dynamo_tpu_torch.runtime import DistributedRuntime

    proc = subprocess.Popen(
        [sys.executable, "-m", "dynamo_tpu_torch.backends.torch", "--model-name", "tiny",
         "--preset", "tiny", "--obs-publish", "off", "--num-kv-blocks", "64", *extra],
        cwd=ROOT, stdout=log, stderr=subprocess.STDOUT,
        env={**os.environ, "DYN_STORE_ADDRESS": address, "DYN_SYSTEM_ENABLED": "0",
             "OMP_NUM_THREADS": "1"},
    )
    try:
        rt = await DistributedRuntime.create(address)
        try:
            client = await (rt.namespace(namespace).component("backend")
                            .endpoint("generate").client())
            deadline = time.time() + 90
            while not client.instance_ids():
                assert proc.poll() is None, "the worker exited before serving"
                assert time.time() < deadline, "the worker never served"
                await asyncio.sleep(0.2)
            return [[t async for out in await client.round_robin(req) for t in out["token_ids"]]
                    for req in reqs]
        finally:
            await rt.shutdown()
    finally:
        proc.terminate()  # it drains through the store, served by this loop
        try:
            await asyncio.to_thread(proc.wait, 60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
