"""The port's tensor parallelism against the JAX package's, on the CPU.

Layouts are held leaf for leaf: specs and their divisibility errors, the
fused projections' shard-blocked layouts and their splits, each rank's
shard against the addressable shard of JAX's ``shard_params`` on a
``make_mesh(dp=1, tp=2)`` mesh (int8 scales included), and the memory
plan's byte counts. The forwards run in two rank processes over gloo (a
module-scoped pair, ``tests/torch_tp_ranks.py``) against JAX's forward
under the tp = 2 mesh of the 8 virtual CPU devices and the port's tp = 1
forward. What a mesh does not serve yet is refused by its ROADMAP item.
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import model as jmodel
from dynamo_tpu.engine.config import EngineConfig as JEngineConfig
from dynamo_tpu.engine.config import PRESETS as J_PRESETS
from dynamo_tpu.engine.config import tiny_engine as j_tiny_engine
from dynamo_tpu.engine.config import tiny_model as j_tiny_model
from dynamo_tpu.parallel import placement as jplacement
from dynamo_tpu.parallel import sharding as jsharding
from dynamo_tpu_torch.engine import model as tmodel
from dynamo_tpu_torch.engine.config import PRESETS, EngineConfig, tiny_engine, tiny_model
from dynamo_tpu_torch.engine.convert import params_from_numpy
from dynamo_tpu_torch.ops import ragged_attention as ra
from dynamo_tpu_torch.parallel import comm, placement, sharding
from tests.torch_tp_ranks import RankPair, prefill_operands, run_forwards, unblocked

# f32 logits of the tp = 2 forward against JAX's under its tp = 2 mesh
# and the port's tp = 1: relative 1e-5, with an absolute floor of 1e-5
# for logits near zero (the partial sums add in another order).
RTOL = ATOL = 1e-5

VARIANTS = {
    "tiny": {},
    "untied_qkv_bias": {"tie_embeddings": False, "attn_qkv_bias": True},
}


def _cfgs(variant):
    return (dataclasses.replace(j_tiny_model(), **VARIANTS[variant]),
            dataclasses.replace(tiny_model(), **VARIANTS[variant]))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def ranks():
    pair = RankPair(2)
    try:
        yield pair
    finally:
        pair.close()


# -- layouts ----------------------------------------------------------------

SPEC_CASES = [(v, tp) for v in ("tiny", "untied_qkv_bias", "tiny-moe", "llama3-8b")
              for tp in (1, 2, 4)]


def _cfg_pair(name):
    if name in VARIANTS:
        return _cfgs(name)
    return J_PRESETS[name](), PRESETS[name]()


@pytest.mark.parametrize("name, tp", SPEC_CASES, ids=[f"{n}-tp{t}" for n, t in SPEC_CASES])
def test_partition_specs_match_jax(name, tp):
    """Every leaf's spec is JAX's, as a tuple; a tp that does not divide
    the heads raises JAX's message word for word."""
    jcfg, tcfg = _cfg_pair(name)
    try:
        want = jsharding.param_partition_specs(jcfg, tp)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            sharding.param_partition_specs(tcfg, tp)
        assert str(got.value) == str(e)
        return
    got = sharding.param_partition_specs(tcfg, tp)
    flat = {k: v for k, v in want.items() if k != "layers"}
    assert set(got) == set(flat) | {"layers"}
    for k, spec in flat.items():
        assert got[k] == tuple(spec), k
    assert {k: tuple(v) for k, v in want["layers"].items()} == got["layers"]


def test_divisibility_errors_match_jax():
    bad = dataclasses.replace(tiny_model(), num_heads=6, num_kv_heads=3)
    jbad = dataclasses.replace(j_tiny_model(), num_heads=6, num_kv_heads=3)
    for tp in (2, 4):
        with pytest.raises(ValueError) as want:
            jsharding.param_partition_specs(jbad, tp)
        with pytest.raises(ValueError, match="must divide") as got:
            sharding.param_partition_specs(bad, tp)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_fuse_and_split_match_jax(tp):
    """fuse_qkv/fuse_gu on weights and split_qkv/split_gu on activations
    equal JAX's for each tp, and a split recovers the natural order."""
    cfg = dataclasses.replace(tiny_model(), num_heads=8, num_kv_heads=4)
    jcfg = dataclasses.replace(j_tiny_model(), num_heads=8, num_kv_heads=4)
    rng = np.random.default_rng(tp)
    h, i = cfg.hidden_size, cfg.intermediate_size
    wq, wk, wv = (rng.standard_normal((2, h, n)).astype(np.float32)
                  for n in (cfg.q_size, cfg.kv_size, cfg.kv_size))
    wg, wu = (rng.standard_normal((2, h, i)).astype(np.float32) for _ in range(2))
    t = torch.from_numpy
    fq = tmodel.fuse_qkv(t(wq), t(wk), t(wv), tp)
    np.testing.assert_array_equal(fq.numpy(), np.asarray(jmodel.fuse_qkv(wq, wk, wv, tp)))
    fg = tmodel.fuse_gu(t(wg), t(wu), tp)
    np.testing.assert_array_equal(fg.numpy(), np.asarray(jmodel.fuse_gu(wg, wu, tp)))
    x = rng.standard_normal((5, fq.shape[-1])).astype(np.float32)
    for a, b in zip(tmodel.split_qkv(t(x), cfg, tp), jmodel.split_qkv(x, jcfg, tp)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    gu = rng.standard_normal((5, 2 * i)).astype(np.float32)
    for a, b in zip(tmodel.split_gu(t(gu), tp), jmodel.split_gu(gu, tp)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # A fused product split at tp recovers the tp = 1 projections.
    y = rng.standard_normal((3, h)).astype(np.float32)
    f1 = tmodel.fuse_qkv(t(wq[0]), t(wk[0]), t(wv[0]))
    for a, b in zip(tmodel.split_qkv(t(y) @ f1, cfg), tmodel.split_qkv(t(y) @ fq[0], cfg, tp)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("quant", [None, "int8"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_shard_params_equal_jax_addressable_shards(variant, quant):
    """Each rank's shard of a tp = 2 params dict equals the addressable
    shard that JAX's ``shard_params`` puts on that rank's device, int8
    scales included (row-parallel scales replicate); the port's init at
    tp = 2 draws the weights of its tp = 1 init, and with a rank keeps
    that rank's shard."""
    jcfg, tcfg = _cfgs(variant)
    jp = jmodel.init_params(jax.random.PRNGKey(3), jcfg, tp=2)
    if quant:
        jp = jmodel.quantize_params(jp)
    mesh = jsharding.make_mesh(dp=1, tp=2)
    placed = jsharding.shard_params(jp, jcfg, mesh)
    full = params_from_numpy(_np_tree(jp), tcfg, device="cpu")
    assert full["fuse_tp"] == 2
    for r in range(2):
        got = sharding.shard_params(full, tcfg, SimpleNamespace(tp=2, rank=r))
        conv = params_from_numpy(_np_tree(jp), tcfg, device="cpu", rank=r)
        dev = mesh.devices[0, r]
        leaves = jax.tree_util.tree_flatten_with_path(placed)[0]
        for path, arr in leaves:
            keys = [p.key for p in path]
            if keys == ["fuse_tp"]:
                continue
            want = next(s.data for s in arr.addressable_shards if s.device == dev)
            for mine in (got, conv):
                leaf = mine
                for k in keys:
                    leaf = leaf[k]
                np.testing.assert_array_equal(leaf.numpy(), np.asarray(want), err_msg=str(keys))
    # The port's own init: tp = 2 (and a rank's shard of it) holds the tp = 1 weights.
    p1 = tmodel.init_params(tcfg, 5, "cpu")
    p2 = tmodel.init_params(tcfg, 5, "cpu", tp=2)
    for r in range(2):
        pr = tmodel.init_params(tcfg, 5, "cpu", tp=2, rank=r)
        want = sharding.shard_params(p2, tcfg, SimpleNamespace(tp=2, rank=r))
        for k in ("wqkv", "wo", "wgu", "w_down"):
            assert torch.equal(pr["layers"][k], want["layers"][k]), k
    sizes = sharding.fused_sizes("wqkv", tcfg)
    assert torch.equal(sharding.reblock(p1["layers"]["wqkv"], sizes, 2), p2["layers"]["wqkv"])
    q2 = tmodel.init_params_quantized(tcfg, 5, "cpu", tp=2)
    q2r = tmodel.init_params_quantized(tcfg, 5, "cpu", tp=2, rank=1)
    want = sharding.shard_params(q2, tcfg, SimpleNamespace(tp=2, rank=1))
    for k in ("wqkv", "wo"):
        for m in ("w", "scale"):
            assert torch.equal(q2r["layers"][k][m], want["layers"][k][m]), (k, m)


PLAN_CASES = [(name, tp, quant) for name in ("tiny", "llama3-8b", "llama3-70b")
              for tp in (1, 2, 4, 8) for quant in (None, "int8")]


@pytest.mark.parametrize("name, tp, quant", PLAN_CASES,
                         ids=[f"{n}-tp{t}-{q or 'bf'}" for n, t, q in PLAN_CASES])
def test_memory_plan_matches_jax(name, tp, quant):
    """Per-card parameter and KV bytes equal JAX's ``memory_plan`` (its
    shapes from ``jax.eval_shape``; the port's from its own specs), or
    both refuse the tp with the same message."""
    jcfg, tcfg = J_PRESETS[name](), PRESETS[name]()
    jeng = j_tiny_engine() if name == "tiny" else JEngineConfig()
    teng = tiny_engine() if name == "tiny" else EngineConfig()
    try:
        want = jplacement.memory_plan(jcfg, jeng, tp, quant=quant)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            placement.memory_plan(tcfg, teng, tp, quant=quant)
        assert str(got.value) == str(e)
        return
    got = placement.memory_plan(tcfg, teng, tp, quant=quant)
    assert got.param_bytes_per_chip == want.param_bytes_per_chip
    assert got.cache_bytes_per_chip == want.cache_bytes_per_chip
    assert got.total_per_chip == want.total_per_chip


def test_memory_plan_on_80gb():
    """The H100's 80 GB decides the fit: llama3-70b in bf16 needs two or
    more cards, llama3-8b fits one."""
    assert placement.memory_plan(PRESETS["llama3-8b"](), EngineConfig(), 1).fits()
    assert not placement.memory_plan(PRESETS["llama3-70b"](), EngineConfig(), 1).fits()
    assert placement.memory_plan(PRESETS["llama3-70b"](), EngineConfig(), 4).fits()
    assert "/ 80 GiB" in placement.memory_plan(PRESETS["tiny"](), tiny_engine(), 1).describe()


# -- the backend, the mesh and the kernel's plans ---------------------------

@pytest.mark.parametrize("devices, per_node, want", [
    (["cpu", "cpu"], None, "gloo"),
    (["cuda:0", "cuda:1"], None, "nccl"),
    (["cuda:0", "cuda:0"], None, "gloo-host"),
    (["cuda:0", "cuda:1", "cuda:0", "cuda:1"], 2, "nccl"),
    (["cuda:0", "cuda:0", "cuda:1", "cuda:1"], 2, "gloo-host"),
    (["cuda:0", "cuda:0", "cuda:0", "cuda:0"], 4, "gloo-host"),
], ids=["cpu", "two-cards", "shared-card", "two-nodes", "two-nodes-shared", "four-shared"])
def test_backend_choice(devices, per_node, want):
    """NCCL when every rank of a node has its own card, gloo on the CPU,
    gloo through host memory where ranks share a card; the choice is made
    from the devices alone."""
    assert comm.choose_backend(devices, per_node) == want
    assert comm.process_group_backend(want) == ("nccl" if want == "nccl" else "gloo")


def test_backend_choice_refuses_mixed_and_unknown():
    with pytest.raises(ValueError, match="all on the CPU or all on cards"):
        comm.choose_backend(["cpu", "cuda:0"])
    with pytest.raises(ValueError, match="unknown collective backend"):
        comm.process_group_backend("mpi")


def test_make_mesh_refusals(monkeypatch):
    """dp > 1 and tp > 1 need the process group; without a device list, a
    node with fewer cards than ranks raises; tp = 1 needs neither and
    calls no collective."""
    with pytest.raises(RuntimeError, match="process group"):
        sharding.make_mesh(dp=2, tp=1, devices=["cpu", "cpu"])
    with pytest.raises(RuntimeError, match="process group"):
        sharding.make_mesh(tp=2, devices=["cpu", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="list the ranks' devices explicitly"):
        sharding.make_mesh(tp=2)
    mesh = sharding.make_mesh(tp=1, devices=["cpu"])
    assert (mesh.tp, mesh.rank, mesh.backend, mesh.group) == (1, 0, "gloo", None)
    x = torch.ones(3)
    assert comm.all_reduce(x, mesh) is x and comm.all_gather(x, mesh) is x


def test_kernel_plans_at_llama3_8b_shard_shapes():
    """At tp = 2 K1 sees q [T, 16, 128] and pages [P, 16, 8, 128]: the
    group stays 4, so the tiled plan is tp = 1's; the decode plan splits
    each row's pages over twice the splits per KV head pair count allows,
    covering the table; the scratch holds a rank's heads."""
    cfg = sharding.rank_config(PRESETS["llama3-8b"](), 2)
    n_q, n_kv = cfg.num_heads, cfg.num_kv_heads
    assert (n_q, n_kv) == (16, 4)
    assert sharding.cache_sharding(PRESETS["llama3-8b"](), 2) == ((None, None, "tp", None), 8)
    for T in (8, 64):
        n_splits, per = ra.decode_split_plan(T, n_kv, 256, 16, 132)
        assert n_splits * per >= 256 and (n_splits - 1) * per < 256
        full_splits, _ = ra.decode_split_plan(T, 8, 256, 16, 132)
        assert n_splits >= full_splits
        o, ml = ra.decode_scratch_shapes(T, n_q, n_kv, n_splits)
        assert o == (T, 4, n_splits, 4, 128) and ml == (T, 4, n_splits, 4, 2)
    assert ra.tiled_plan(8192, 8, n_q // n_kv) == ra.tiled_plan(8192, 8, 32 // 8)


# -- forwards in two rank processes -----------------------------------------

def test_ranks_import_no_jax(ranks):
    info = ranks.call("info")
    assert [i["rank"] for i in info] == [0, 1]
    assert all(i["backend"] == "gloo" and not i["leaked"] for i in info)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_rank_forwards_match_jax_mesh(ranks, variant):
    """Prefill (a chunk and its continuation) and decode logits of the
    port's tp = 2 ranks equal JAX's ``forward_tokens`` under the tp = 2
    mesh and the port's tp = 1 forward (RTOL/ATOL above); both ranks hold
    the same full-vocab logits."""
    jcfg, tcfg = _cfgs(variant)
    jeng, teng = j_tiny_engine(), tiny_engine()
    rng = np.random.default_rng(17)
    prompt = [int(t) for t in rng.integers(1, jcfg.vocab_size, 37)]
    blocks = [5, 2, 9, 0, 7, 3]
    chunks = [(0, 20, 32), (20, 37, 64)]
    decode = [17, 250, 3]

    mesh = jsharding.make_mesh(dp=1, tp=2)
    jp2 = jmodel.init_params(jax.random.PRNGKey(7), jcfg, tp=2)
    params = jsharding.shard_params(jp2, jcfg, mesh)
    cache = jax.device_put(jmodel.init_cache(jcfg, jeng), jsharding.cache_sharding(mesh))
    fwd = jax.jit(jmodel.forward_tokens, static_argnames=("cfg", "engine", "mesh"))
    dec = jax.jit(jmodel.decode_tokens, static_argnames=("cfg", "engine", "mesh"))
    want = []
    for start, stop, bucket in chunks:
        ops = prefill_operands(prompt[start:stop], start, blocks, teng, bucket)
        logits, cache = fwd(params, cache, *map(jnp.asarray, ops), cfg=jcfg, engine=jeng,
                            mesh=mesh)
        want.append(np.asarray(logits)[0])
    table = np.full((2, jeng.max_blocks_per_seq), jeng.garbage_block, np.int32)
    table[0, : len(blocks)] = blocks
    for step, tok in enumerate(decode):
        logits, cache = dec(
            params, cache, jnp.asarray([tok, 0], jnp.int32), jnp.asarray(table),
            jnp.asarray([len(prompt) + step, 0], jnp.int32), jnp.asarray([True, False]),
            cfg=jcfg, engine=jeng, mesh=mesh,
        )
        want.append(np.asarray(logits)[0])

    tree = _np_tree(jp2)
    got = ranks.call("forwards", tree=tree, cfg=tcfg, eng=teng, prompt=prompt,
                     chunks=chunks, blocks=blocks, decode_toks=decode)
    one = run_forwards(params_from_numpy(unblocked(tree, tcfg), tcfg, "cpu"),
                       tmodel.init_cache(tcfg, teng, "cpu"), tcfg, teng, prompt, chunks,
                       blocks, decode)
    for step, w in enumerate(want):
        np.testing.assert_array_equal(got[0][step], got[1][step])
        np.testing.assert_allclose(got[0][step], w, rtol=RTOL, atol=ATOL, err_msg=f"step {step}")
        np.testing.assert_allclose(got[0][step], one[step], rtol=RTOL, atol=ATOL)
