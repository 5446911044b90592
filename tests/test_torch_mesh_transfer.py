"""Disaggregated transfer, peer page serving and embeddings on an engine
of more than one rank: the port against the JAX package, on the CPU.

Rank processes over gloo (module-scoped pools of tp 2, pp 2, dp 2 and sp
2, ``tests/torch_tp_ranks.py``) run the port's ``EngineCore`` on the
tiny preset in f32 with JAX's weights. The wire page is JAX's whole
combined page whatever the mesh: a tp = 2 prefill's held pages equal the
JAX tp = 2 engine's to f32 tolerance and decode, imported into a tp = 1
core, to JAX's aggregated tokens; tp = 1 pages imported into tp = 2 and
pp = 2 decode to them too, and read back for a peer byte for byte; a dp
or sp rank holds the whole page after an import, every rank alike; an
int8 tp = 2 export, import and export is byte-identical; a pp = 2
engine's ``read_cached_pages`` is byte-stable across the device, host
and disk tiers; a mesh ``embed`` equals JAX's on the same mesh; a
lockstep leader's page read from a second thread completes while it
steps, and its hold expiry is journaled as a release; more leader jobs
than the event loop's default executor has threads all complete; a
follower whose replay of a job ended otherwise than the leader's stops.
"""

import threading

import jax
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import model as jmodel
from dynamo_tpu.engine.config import tiny_engine as j_tiny_engine
from dynamo_tpu.engine.config import tiny_model as j_tiny_model
from dynamo_tpu.engine.core import EngineCore as JaxCore
from dynamo_tpu.engine.kv_quant import pack_kv_page, unpack_kv_page
from dynamo_tpu.llm.protocols.common import PreprocessedRequest as JaxRequest
from dynamo_tpu.parallel.pipeline import make_pp_mesh as j_make_pp_mesh
from dynamo_tpu.parallel.sharding import make_mesh as j_make_mesh
from dynamo_tpu_torch.engine.config import tiny_engine, tiny_model
from dynamo_tpu_torch.engine.convert import params_from_numpy
from dynamo_tpu_torch.engine.core import EngineCore
from dynamo_tpu_torch.llm.protocols.common import PreprocessedRequest
from dynamo_tpu_torch.parallel.sharding import Mesh
from tests.torch_tp_ranks import RankPair, _remote_wire, run_requests

MESHES = {"tp2": {"tp": 2}, "pp2": {"pp": 2}, "dp2": {"dp": 2}, "sp2": {"sp": 2}}
PROMPT = [int(t) for t in np.random.default_rng(11).integers(1, 384, 45)]  # 5 full blocks
DECODE = 6  # tokens after the prompt, the first from the prefill side
# Pages and embeddings of two f32 engines whose sums run in another order
# (a tp all-reduce against XLA's sharded matmul): the f32 tolerance.
F32_RTOL, F32_ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def pools():
    """Rank pools by mesh name (``MESHES``), started on first use."""
    started: dict[str, RankPair] = {}

    def get(name: str) -> RankPair:
        if name not in started:
            started[name] = RankPair(2, axes=MESHES[name])
        return started[name]

    try:
        yield get
    finally:
        for pool in started.values():
            pool.close()


@pytest.fixture(scope="module")
def weights():
    """JAX's tiny weights fused for tp = 1 and for tp = 2 (one draw), and
    JAX's aggregated greedy stream of ``PROMPT``."""
    key = jax.random.PRNGKey(0)
    jp1 = jmodel.init_params(key, j_tiny_model())
    jp2 = jmodel.init_params(key, j_tiny_model(), tp=2)
    core = JaxCore(j_tiny_model(), j_tiny_engine(), params=jp1, seed=0)
    core.add_request(JaxRequest.from_wire(_wire("agg", PROMPT, DECODE)))
    want = []
    while core.has_work():
        for _, out in core.step():
            want.extend(out.token_ids)
    return {"jp1": jp1, "jp2": jp2, "tree1": jax.tree.map(np.asarray, jp1),
            "tree2": jax.tree.map(np.asarray, jp2), "want": want}


def _wire(rid, prompt, max_tokens):
    return {"model": "t", "token_ids": list(prompt), "request_id": rid,
            "sampling": {"temperature": 0.0},
            "stop": {"max_tokens": max_tokens, "ignore_eos": True}}


def _blocks(descs, pages):
    return [dict(d, kv=p) for d, p in zip(descs, pages)]


def _f32(pages):
    return np.stack([np.frombuffer(p, np.float32) for p in pages])


def _tp1_export(weights, eng):
    """A tp = 1 port core's remote-decode prefill of ``PROMPT``: its first
    token, descriptors and held pages."""
    core = EngineCore(tiny_model(), eng, device="cpu",
                      params=params_from_numpy(weights["tree1"], tiny_model(), "cpu"))
    tok1 = run_requests(core, [_remote_wire("pf", PROMPT)])["pf"]
    descs = core.export_descriptors("pf")
    return tok1, descs, core.read_held_pages("pf", 0, len(descs))


def test_tp2_export_matches_jax_and_decodes_on_tp1(pools, weights):
    """The port's counterpart of the JAX test
    ``test_cross_tp_kv_transfer_matches_aggregated``: a tp = 2 prefill's
    held pages, gathered whole to rank 0 (``layout["tp"]`` 2, the whole
    page's shape), equal the JAX tp = 2 engine's ``read_held_pages`` to
    f32 tolerance; imported into a tp = 1 core they decode to JAX's
    aggregated tokens over the imported prefix. Rank 1 returns no pages;
    each rank joined one page gather."""
    cfg, eng = tiny_model(), tiny_engine()
    got = pools("tp2").call("prefill_export", cfg=cfg, eng=eng, tree=weights["tree2"],
                            req=_remote_wire("pf", PROMPT))
    jcore = JaxCore(j_tiny_model(), j_tiny_engine(), params=weights["jp2"], seed=0,
                    mesh=j_make_mesh(dp=1, tp=2))
    seq = jcore.add_request(JaxRequest.from_wire(_remote_wire("pf", PROMPT)))
    while seq.finish is None:
        jcore.step()
    jdescs = jcore.export_descriptors("pf")
    jpages = jcore.read_held_pages("pf", 0, len(jdescs))
    descs, pages = got[0]["descs"], got[0]["pages"]
    assert descs == jdescs and descs[0]["layout"]["tp"] == 2
    assert got[1]["pages"] == [] and got[0]["tokens"] == got[1]["tokens"] == weights["want"][:1]
    assert [r["calls"]["page_gather"] for r in got] == [1, 1]
    np.testing.assert_allclose(_f32(pages), _f32(jpages), rtol=F32_RTOL, atol=F32_ATOL)

    core = EngineCore(cfg, eng, device="cpu",
                      params=params_from_numpy(weights["tree1"], cfg, "cpu"))
    assert core.import_blocks(_blocks(descs, pages)).imported == len(descs) == 5
    cont = _wire("dec", PROMPT + got[0]["tokens"], DECODE - 1)
    seq = core.add_request(PreprocessedRequest.from_wire(cont))
    tokens = []
    while core.has_work():
        for s, out in core.step():
            tokens.extend(out.token_ids)
    assert got[0]["tokens"] + tokens == weights["want"]
    assert seq.num_cached_tokens == 5 * eng.block_size


@pytest.mark.parametrize("mesh", ["tp2", "pp2"])
def test_tp1_pages_decode_on_tp2_and_pp2(pools, weights, mesh):
    """tp = 1 pages imported into a tp = 2 and into a pp = 2 decode core
    (every rank calls ``import_blocks``; rank 0's pages are scattered,
    each rank writing its heads or its layers) decode to JAX's aggregated
    tokens over the imported prefix, and read back for a peer
    (``read_cached_pages``, gathered whole again) byte for byte."""
    cfg, eng = tiny_model(), tiny_engine()
    tok1, descs, pages = _tp1_export(weights, eng)
    tree = weights["tree2" if mesh == "tp2" else "tree1"]
    got = pools(mesh).call("import_decode", cfg=cfg, eng=eng, tree=tree,
                           blocks=_blocks(descs, pages),
                           req=_wire("dec", PROMPT + tok1, DECODE - 1))
    for r, res in enumerate(got):
        assert res["imported"] == len(descs) == 5
        assert tok1 + res["tokens"] == weights["want"], r
        assert res["cached_tokens"] == 5 * eng.block_size
        assert res["calls"]["page_scatter"] == 1 and res["calls"]["page_gather"] == 1
    assert got[0]["back"] == pages and got[1]["back"] == []
    assert got[0]["digest"] != got[1]["digest"]  # each rank holds its own part


@pytest.mark.parametrize("mesh", ["dp2", "sp2"])
def test_dp2_and_sp2_import_whole_pages_on_every_rank(pools, weights, mesh):
    """A dp = 2 x tp = 1 or sp = 2 decode core holds whole pages on every
    rank: after an import each rank's pages are the wire pages (one
    digest on both ranks), and both decode JAX's aggregated tokens; rank
    0 alone serves them back, with no gather."""
    import hashlib

    cfg, eng = tiny_model(), tiny_engine()
    tok1, descs, pages = _tp1_export(weights, eng)
    got = pools(mesh).call("import_decode", cfg=cfg, eng=eng, tree=weights["tree1"],
                           blocks=_blocks(descs, pages),
                           req=_wire("dec", PROMPT + tok1, DECODE - 1))
    want = hashlib.sha256(b"".join(pages)).hexdigest()
    assert [r["digest"] for r in got] == [want, want]
    assert [tok1 + r["tokens"] for r in got] == [weights["want"]] * 2
    assert got[0]["back"] == pages and got[1]["back"] == []
    assert [r["calls"]["page_gather"] for r in got] == [0, 0]


def test_int8_tp2_round_trip_is_byte_identical(pools):
    """int8 KV pages on tp = 2: a prefill's export (the canonical packed
    page, each rank's int8 heads and f32 scales gathered), its import into
    a second tp = 2 core (each rank's heads and scales scattered) and that
    core's export for a peer are byte-identical; the packed page parses
    at the whole model's geometry."""
    cfg, eng = tiny_model(), tiny_engine(kv_dtype="int8")
    pool = pools("tp2")
    got = pool.call("prefill_export", cfg=cfg, eng=eng, req=_remote_wire("q", PROMPT))
    descs, pages = got[0]["descs"], got[0]["pages"]
    geom = (cfg.num_layers, eng.block_size, cfg.num_kv_heads, cfg.head_dim)
    for p in pages:
        kv, sc = unpack_kv_page(np.frombuffer(p, np.uint8), *geom)
        assert pack_kv_page(kv, sc).tobytes() == p
    back = pool.call("import_decode", cfg=cfg, eng=eng, blocks=_blocks(descs, pages),
                     req=_wire("dec", PROMPT + got[0]["tokens"], 2))
    assert [r["imported"] for r in back] == [5, 5]
    assert back[0]["back"] == pages


def test_pp2_read_cached_pages_byte_stable_across_tiers(pools, tmp_path):
    """The port's counterpart of the JAX test
    ``test_kvint8_pp_tier_round_trip_is_byte_stable`` on pp = 2 rank
    processes: the prefix's int8 pages read for a peer on the device, from
    the host and disk tiers once noise has evicted them (each stage reading
    its own tier under ``<dir>/rank<r>``), and after onboarding are one
    byte string; each stage's tier holds its layers of that page; the
    onboarded prefix serves the plain engine's stream."""
    cfg = tiny_model()
    eng = tiny_engine(kv_dtype="int8")
    tier_eng = tiny_engine(kv_dtype="int8", num_kv_blocks=24, host_kv_blocks=4,
                           disk_kv_dir=str(tmp_path / "g3"), disk_kv_blocks=256,
                           max_model_len=128)
    prompt = list(range(7, 47))
    rng = np.random.default_rng(4)
    noise = [[[int(t) for t in rng.integers(1, 384, 60)] for _ in range(4)] for _ in range(4)]
    got = pools("pp2").call("tier_pages", cfg=cfg, eng=eng, tier_eng=tier_eng, prompt=prompt,
                            noise=noise, timeout=120)
    lead = got[0]
    assert lead["onboards"] > 0 and lead["again"] == lead["ref"]
    assert len(lead["w0"]) == len(lead["prefix"]) == 4
    assert lead["w_tier"] == lead["w0"] and lead["w1"] == lead["w0"]
    assert got[1]["w0"] == got[1]["w_tier"] == got[1]["w1"] == []
    off = [h for h in lead["prefix"] if lead["tier"][h] is not None]
    assert off, "the noise did not push the prefix off the device"
    L, bs, n_kv, d = lead["geometry"]
    for i, h in enumerate(lead["prefix"]):
        if h not in off:
            continue
        kv, sc = unpack_kv_page(np.frombuffer(lead["w0"][i], np.uint8), 2 * L, bs, n_kv, d)
        for stage, res in enumerate(got):
            part = pack_kv_page(kv[stage * L:(stage + 1) * L], sc[stage * L:(stage + 1) * L])
            assert res["tier"][h] == part.tobytes(), (stage, i)


@pytest.mark.parametrize("mesh", ["tp2", "pp2"])
def test_embed_on_mesh_matches_jax(pools, weights, mesh):
    """``embed`` on a tp = 2 engine (each rank its heads, all-reduced) and
    on a pp = 2 engine (the stages in turn, then the exit broadcast)
    equals JAX's ``embed`` on the same mesh to f32 tolerance, on every
    rank alike."""
    tokens = PROMPT[:29]
    if mesh == "tp2":
        jcore = JaxCore(j_tiny_model(), j_tiny_engine(), params=weights["jp2"], seed=0,
                        mesh=j_make_mesh(dp=1, tp=2))
    else:
        jcore = JaxCore(j_tiny_model(), j_tiny_engine(), params=weights["jp1"], seed=0,
                        pp_mesh=j_make_pp_mesh(2))
    want = np.asarray(jcore.embed(tokens))
    got = pools(mesh).call("embed", cfg=tiny_model(), eng=tiny_engine(), tokens=tokens,
                           tree=weights["tree2" if mesh == "tp2" else "tree1"])
    np.testing.assert_array_equal(got[0]["embed"], got[1]["embed"])
    np.testing.assert_allclose(got[0]["embed"], want, rtol=F32_RTOL, atol=F32_ATOL)
    kind = "all_reduce" if mesh == "tp2" else "broadcast"
    assert got[0]["calls"][kind] > 0


def test_lockstep_page_read_and_hold_expiry(pools):
    """A LeaderCore's ``read_held_pages`` from a second thread completes
    while the main thread steps (its job runs at a step's snapshot, before
    the step's forwards; the follower replays it from the record), and a
    hold left past ``held_block_ttl_s`` is released by the leader's clock,
    journaled as a ``release`` op; the ranks' allocators end equal."""
    cfg, eng = tiny_model(), tiny_engine(held_block_ttl_s=0.2)
    requests = [_wire(f"r{i}", PROMPT[i:i + 20], 12) for i in range(2)]
    lead, follow = pools("tp2").call(
        "lockstep_transfer", cfg=cfg, eng=eng, requests=requests,
        held=_remote_wire("h", PROMPT), ttl_held=_remote_wire("t", PROMPT[::-1]))
    assert lead["blocks"] == len(lead["pages"]) == 5
    assert all(len(p) == cfg.num_layers * eng.block_size * 2 * cfg.num_kv_heads
               * cfg.head_dim * 4 for p in lead["pages"])
    assert "read_held" in lead["ops"] and lead["ops"].count("release") == 2
    assert follow["ops"] == lead["ops"]
    assert lead["held"] == follow["held"] == []
    for k in ("free", "inactive", "snapshot"):
        assert follow[k] == lead[k], k


def test_direct_import_refuses_other_meshes():
    """``import_blocks_direct`` between cores of different meshes refuses
    and points to the staged path (as JAX refuses mismatched cache
    layouts); between cores of one mesh it copies each rank's own part
    (here one rank: the whole page)."""
    cfg, eng = tiny_model(), tiny_engine()
    src = EngineCore(cfg, eng, device="cpu", seed=0)
    run_requests(src, [_remote_wire("pf", PROMPT)])
    assert EngineCore(cfg, eng, device="cpu", seed=0).import_blocks_direct(
        src, "pf").imported == 5
    rank0 = EngineCore(cfg, eng, device="cpu", seed=0,
                       mesh=Mesh(1, 2, 0, (torch.device("cpu"),) * 2, "gloo"))
    with pytest.raises(ValueError, match="matching meshes .*staged wire path"):
        rank0.import_blocks_direct(src, "pf")


def test_multihost_leader_refuses_embeddings():
    """Across nodes (``multihost``) a lockstep leader refuses embeddings
    with the JAX multi-host leader's error; on one node (the default) it
    runs them, returning the single engine's embedding."""
    from dynamo_tpu.backends.jax.multihost import LeaderCore as JaxLeader
    from dynamo_tpu_torch.backends.torch.multihost import LeaderCore

    with pytest.raises(RuntimeError) as want:
        JaxLeader(j_tiny_model(), j_tiny_engine(), seed=0).embed([1, 2, 3])
    cfg, eng = tiny_model(), tiny_engine()
    with pytest.raises(RuntimeError) as got:
        LeaderCore(cfg, eng, seed=0, device="cpu", multihost=True).embed([1, 2, 3])
    assert str(got.value) == str(want.value)
    single = EngineCore(cfg, eng, seed=0, device="cpu").embed([1, 2, 3])
    lead = LeaderCore(cfg, eng, seed=0, device="cpu")
    box: list = []
    reader = threading.Thread(target=lambda: box.append(lead.embed([1, 2, 3])))
    reader.start()
    for _ in range(1000):
        if not reader.is_alive():
            break
        lead.step()  # the snapshot runs the staged embedding
    reader.join(timeout=10)
    assert not reader.is_alive()
    np.testing.assert_array_equal(box[0], single)


def test_leader_jobs_outnumbering_the_default_executor_finish():
    """More concurrent leader page reads and embeddings than the event
    loop's default executor has threads: each call blocks a thread of that
    pool until a step runs its job, and ``TorchEngine`` steps on a thread
    of its own, so every call completes, with the single engine's pages
    and embedding."""
    import asyncio
    from concurrent.futures import ThreadPoolExecutor

    from dynamo_tpu_torch.backends.torch.multihost import LeaderCore
    from dynamo_tpu_torch.engine.engine import TorchEngine

    cfg, eng = tiny_model(), tiny_engine()
    single = EngineCore(cfg, eng, seed=0, device="cpu")
    lead = LeaderCore(cfg, eng, seed=0, device="cpu")
    for core in (single, lead):
        run_requests(core, [_remote_wire("h", PROMPT)])
    pages = single.read_held_pages("h", 0, 5)
    vec = single.embed(PROMPT[:9])

    async def main():
        loop = asyncio.get_running_loop()
        pool = ThreadPoolExecutor(max_workers=2)
        loop.set_default_executor(pool)
        engine = TorchEngine(lead)
        lead.wake = lambda: loop.call_soon_threadsafe(engine.wake)
        calls = [asyncio.to_thread(lead.read_held_pages, "h", 0, 5) for _ in range(6)]
        calls += [asyncio.to_thread(lead.embed, PROMPT[:9]) for _ in range(3)]
        try:
            return await asyncio.wait_for(asyncio.gather(*calls), 60)
        finally:
            lead.close()  # on a failure, frees the pool's blocked threads

    got = asyncio.run(main())
    assert got[:6] == [pages] * 6
    for e in got[6:]:
        np.testing.assert_array_equal(e, vec)


def test_follower_checks_the_leaders_job_outcomes(caplog):
    """A follower logs each collective op whose replay raised, and stops
    with "lost lockstep" when the next record says the leader's job ended
    otherwise; when both raised alike, it goes on."""
    import logging

    from dynamo_tpu_torch.backends.torch.multihost import apply_record, follower_mode

    core = EngineCore(tiny_model(), tiny_engine(), seed=0, device="cpu")
    follower_mode(core)
    op = {"op": "read_held", "rid": "gone", "start": 0, "count": 1}
    with caplog.at_level(logging.WARNING):
        apply_record(core, {"iter": 0, "ops": [op], "outcomes": []})
    assert "replaying read_held raised KeyError" in caplog.text
    apply_record(core, {"iter": 1, "ops": [op], "outcomes": ["KeyError"]})
    with pytest.raises(RuntimeError, match="step record 1: .*lost lockstep"):
        apply_record(core, {"iter": 2, "ops": [], "outcomes": ["ok"]})
