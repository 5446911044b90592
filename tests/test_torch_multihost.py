"""The port's tensor-parallel engine, its lockstep and its loader against
the JAX package's, on the CPU.

Two rank processes over gloo (a module-scoped pair,
``tests/torch_tp_ranks.py``) run the port's ``EngineCore`` at tp = 2;
the JAX ``EngineCore(mesh=make_mesh(1, 2))`` runs in the test process on
the virtual CPU devices, and the port's tp = 1 engine beside it, all on
the same weights. Greedy streams must be equal under waves, chunked
scheduling, n-gram speculation, and int8 weights with int8 KV pages. A
LeaderCore and a follower stay in step through a cancel and a rejected
add; each rank's checkpoint shard equals the JAX loader's tp = 2 params
sliced; a ``--tp 2`` worker on CPU ranks serves the tp = 1 worker's
tokens over the store and data plane; and what a tp > 1 worker does not
serve yet is refused by its ROADMAP item.
"""

import asyncio
import dataclasses
import json
import os
import struct
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import loader as jloader
from dynamo_tpu.engine import model as jmodel
from dynamo_tpu.engine.config import tiny_engine as j_tiny_engine
from dynamo_tpu.engine.config import tiny_model as j_tiny_model
from dynamo_tpu.engine.core import EngineCore as JaxCore
from dynamo_tpu.llm.protocols.common import PreprocessedRequest as JaxRequest
from dynamo_tpu.parallel.sharding import make_mesh as j_make_mesh
from dynamo_tpu_torch.backends.torch import main as worker_main
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig, tiny_engine, tiny_model
from dynamo_tpu_torch.engine.convert import params_from_numpy
from dynamo_tpu_torch.engine.core import EngineCore
from tests.torch_tp_ranks import RankPair, _leaves, run_requests, unblocked

ROOT = Path(__file__).resolve().parents[1]
UNTIED = {"tie_embeddings": False, "attn_qkv_bias": True}
MODES = {
    "waves": ({}, None),
    "chunked": ({"scheduling": "chunked", "prefill_chunk": 16, "max_num_batched_tokens": 64},
                None),
    "ngram": ({"spec_decode": "ngram", "spec_k": 3}, None),
    "int8": ({"kv_dtype": "int8"}, "int8"),
}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def ranks():
    pair = RankPair(2)
    try:
        yield pair
    finally:
        pair.close()


def _requests(n=3, max_tokens=16) -> list[dict]:
    """Greedy prompts that repeat a segment, so n-gram drafts find matches."""
    rng = np.random.default_rng(5)
    out = []
    for i in range(n):
        seg = [int(t) for t in rng.integers(3, 300, 6 + i)]
        out.append({"model": "tiny", "token_ids": seg * 3 + seg[:2], "request_id": f"r{i}",
                    "sampling": {"temperature": 0.0},
                    "stop": {"max_tokens": max_tokens, "ignore_eos": True}})
    return out


def _jax_streams(jcfg, jeng, params, mesh, requests) -> dict[str, list[int]]:
    core = JaxCore(jcfg, jeng, params=params, seed=0, mesh=mesh)
    streams = {r["request_id"]: [] for r in requests}
    for r in requests:
        core.add_request(JaxRequest.from_wire(r))
    for _ in range(500):
        if not core.has_work():
            break
        for seq, out in core.step():
            streams[seq.request_id].extend(out.token_ids)
    return streams


@pytest.mark.parametrize("mode", list(MODES))
def test_engine_streams_match_jax_mesh_and_tp1(ranks, mode):
    """Greedy streams of the port's tp = 2 engine (two ranks) equal JAX's
    tp = 2 engine and the port's tp = 1 engine on the same weights; both
    ranks emit the same streams, each over its own KV heads, with 2 L + 1
    collectives per forward (two all-reduces a layer and the logits'
    gather)."""
    overrides, quant = MODES[mode]
    jcfg = dataclasses.replace(j_tiny_model(), **UNTIED)
    tcfg = dataclasses.replace(tiny_model(), **UNTIED)
    jeng, teng = j_tiny_engine(**overrides), tiny_engine(**overrides)
    jp2 = jmodel.init_params(jax.random.PRNGKey(2), jcfg, tp=2)
    if quant:
        jp2 = jmodel.quantize_params(jp2)
    requests = _requests()
    want = _jax_streams(jcfg, jeng, jp2, j_make_mesh(dp=1, tp=2), requests)
    tree = _np_tree(jp2)
    got = ranks.call("engine", cfg=tcfg, eng=teng, requests=requests, tree=tree)
    one = run_requests(EngineCore(tcfg, teng, params=params_from_numpy(
        unblocked(tree, tcfg), tcfg, "cpu"), seed=0, device="cpu"), requests)
    assert got[0]["streams"] == want == one
    assert got[1]["streams"] == got[0]["streams"]
    assert all(len(s) == 16 for s in want.values())
    for r, res in enumerate(got):
        st = res["stats"]
        assert (st["tp"], st["rank"], st["comm_backend"]) == (2, r, "gloo")
        assert st["collectives_per_forward"] == 2 * tcfg.num_layers + 1
        assert st["collective_calls"] >= st["forwards"] * st["collectives_per_forward"] > 0
        assert res["kv_heads"] == tcfg.num_kv_heads  # 2 * n_kv / tp combined heads
    if mode == "ngram":
        assert got[0]["spec"]["drafted_tokens"] > 0
    if mode == "chunked":
        assert got[0]["stats"]["mixed_steps"] > 0


def test_host_tier_on_rank_heads(ranks):
    """With a host KV tier and a pool too small for two rounds of
    prompts, each rank offloads and onboards the pages of its own heads:
    a first round's prompts sent again after a second round come back
    from the host tier on both ranks, and every round's streams equal the
    port's tp = 1 engine's with the same tier."""
    cfg = dataclasses.replace(tiny_model(), **UNTIED)
    eng = tiny_engine(num_kv_blocks=24, host_kv_blocks=64)
    first = _requests(max_tokens=8)
    second = [dict(r, request_id=f"b{i}", token_ids=[(t * 7 + 3) % 384 for t in r["token_ids"]]
                   * 2) for i, r in enumerate(first)]
    rounds = [first, second, [dict(r, request_id=f"again-{r['request_id']}") for r in first]]
    got = ranks.call("engine", cfg=cfg, eng=eng, requests=rounds[0], more=rounds[1:])
    core = EngineCore(cfg, eng, seed=0, device="cpu")
    want = [run_requests(core, r) for r in rounds]
    assert got[0]["streams"] == got[1]["streams"] == want
    assert core.tier_stats()["host"]["onboards"] > 0
    assert got[0]["tiers"] == got[1]["tiers"] == core.tier_stats()


def test_engine_core_on_mesh_matches_single_device(ranks):
    """The port's counterpart of the JAX test of the same name, without
    its dp axis: the real EngineCore at tp = 2 with random weights from
    seed 0 produces the tp = 1 engine's greedy output (the draw is the
    same at any tp)."""
    cfg = ModelConfig(name="dryrun", vocab_size=512, hidden_size=64, intermediate_size=128,
                      num_layers=2, num_heads=8, num_kv_heads=8, head_dim=16,
                      dtype="float32", tie_embeddings=True)
    eng = EngineConfig(num_kv_blocks=32, block_size=8, max_num_seqs=8, max_model_len=128,
                       prefill_buckets=(32, 64, 128), decode_buckets=(4, 8))
    requests = [{"model": "t", "token_ids": list(range(3 + i, 40 + i)), "request_id": f"r{i}",
                 "sampling": {"temperature": 0.0}, "stop": {"max_tokens": 5}}
                for i in range(3)]
    got = ranks.call("engine", cfg=cfg, eng=eng, requests=requests)
    want = run_requests(EngineCore(cfg, eng, seed=0, device="cpu"), requests)
    assert got[0]["streams"] == got[1]["streams"] == want
    assert got[0]["stats"]["collectives_per_forward"] == 4  # tied: no gather


def test_lockstep_cancel_and_rejected_add(ranks):
    """A LeaderCore journals a cancel mid-stream and an add it rejects
    (a prompt over max_model_len, which still took a request-counter
    tick); the follower, replaying the records, emits exactly what the
    leader emitted, with the same counter, and both run the same steps."""
    tcfg = dataclasses.replace(tiny_model(), **UNTIED)
    eng = tiny_engine(decode_chain=2)
    requests = _requests(max_tokens=12)
    requests[2] = dict(requests[2], sampling={"temperature": 1.0})  # seeded from the counter
    bad = dict(requests[0], request_id="bad", token_ids=[5] * (eng.max_model_len + 4))
    lead, follow = ranks.call("lockstep", cfg=tcfg, eng=eng, requests=requests,
                              cancel_after=2, bad=bad)
    assert "exceeds max_model_len" in lead["rejected"]
    assert follow["emitted"] == lead["emitted"]
    assert follow["records"] == lead["records"] and follow["counter"] == lead["counter"] == 4
    tokens = {}
    for rid, toks, _ in lead["emitted"]:
        tokens.setdefault(rid, []).extend(toks)
    assert len(tokens["r0"]) < 12 and len(tokens["r1"]) == len(tokens["r2"]) == 12


def test_mesh_refusals_name_their_items(ranks):
    """What a tp = 2 engine once refused by ROADMAP.md A12d it serves:
    an embedding (the same on both ranks), a held prefill's export (the
    whole pages on rank 0, none on rank 1), their import into a second
    tp = 2 core and that core's pages read back for a peer byte for
    byte, and the same through a direct import (each rank copying its own
    heads), each core holding the five blocks cached, on both ranks."""
    tcfg = dataclasses.replace(tiny_model(), **UNTIED)
    eng = tiny_engine()
    lead, follow = ranks.call("mesh_paths", cfg=tcfg, eng=eng)
    np.testing.assert_array_equal(lead["embed"], follow["embed"])
    assert lead["embed"].shape == (tcfg.hidden_size,)
    assert lead["blocks"] == len(lead["pages"]) == lead["imported"] == follow["imported"] == 5
    assert lead["back"] == lead["direct_back"] == lead["pages"]
    assert follow["pages"] == follow["back"] == follow["direct_back"] == []
    assert lead["direct"] == follow["direct"] == 5
    assert lead["used"] == follow["used"] == [5, 5, 5]


# -- the loader ---------------------------------------------------------------

def _hf_checkpoint(arch: str, path: Path, seed: int) -> None:
    """A small untied llama or qwen2 checkpoint of seeded f32 weights:
    ``config.json`` and one safetensors file (an 8-byte header length,
    the JSON header, the raw tensors)."""
    h, i, v, L, nq, nkv, d = 32, 64, 128, 2, 4, 2, 8
    rng = np.random.default_rng(seed)
    w = lambda *shape: rng.standard_normal(shape).astype(np.float32) * 0.5  # noqa: E731
    tensors = {"model.embed_tokens.weight": w(v, h), "model.norm.weight": 1 + w(h),
               "lm_head.weight": w(v, h)}
    for l in range(L):
        pre = f"model.layers.{l}."
        tensors |= {
            pre + "input_layernorm.weight": 1 + w(h),
            pre + "post_attention_layernorm.weight": 1 + w(h),
            pre + "self_attn.q_proj.weight": w(nq * d, h),
            pre + "self_attn.k_proj.weight": w(nkv * d, h),
            pre + "self_attn.v_proj.weight": w(nkv * d, h),
            pre + "self_attn.o_proj.weight": w(h, nq * d),
            pre + "mlp.gate_proj.weight": w(i, h),
            pre + "mlp.up_proj.weight": w(i, h),
            pre + "mlp.down_proj.weight": w(h, i),
        }
        if arch == "qwen2":
            tensors |= {pre + f"self_attn.{n}_proj.bias": w(k * d)
                        for n, k in (("q", nq), ("k", nkv), ("v", nkv))}
    header, off = {}, 0
    for name, t in tensors.items():
        header[name] = {"dtype": "F32", "shape": list(t.shape),
                        "data_offsets": [off, off + t.nbytes]}
        off += t.nbytes
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path / "model.safetensors", "wb") as f:
        f.write(struct.pack("<Q", len(raw)) + raw)
        for t in tensors.values():
            f.write(t.tobytes())
    (path / "config.json").write_text(json.dumps({
        "model_type": arch, "vocab_size": v, "hidden_size": h, "intermediate_size": i,
        "num_hidden_layers": L, "num_attention_heads": nq, "num_key_value_heads": nkv,
        "rope_theta": 10000.0, "rms_norm_eps": 1e-5, "tie_word_embeddings": False,
    }))


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    out = {}
    for i, arch in enumerate(("llama", "qwen2")):
        path = tmp_path_factory.mktemp(f"tp-{arch}")
        _hf_checkpoint(arch, path, seed=20 + i)
        out[arch] = path
    return out


@pytest.mark.parametrize("quant", [None, "int8"])
@pytest.mark.parametrize("arch", ["llama", "qwen2"])
def test_loader_rank_shards_equal_jax(ranks, checkpoints, arch, quant):
    """``load_hf_llama(path, tp=2, rank=r)`` on each rank equals the JAX
    loader's ``load_hf_llama(path, tp=2)`` sliced to rank r, leaf for
    leaf, f32 and int8 (row-parallel scales from the full weight); the
    port's own full tp = 2 load equals the JAX one."""
    from dynamo_tpu_torch.engine import loader as tloader

    path = checkpoints[arch]
    cfg = tloader.config_from_hf(path)
    _, jp = jloader.load_hf_llama(path, dtype=jax.numpy.float32, tp=2, quant=quant)
    tree = _np_tree(jp)
    got = ranks.call("load", path=str(path), quant=quant)
    for r in range(2):
        want = _leaves(params_from_numpy(tree, cfg, "cpu", rank=r))
        assert got[r].keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[r][k], want[k], err_msg=f"rank {r} {k}")
    _, full = tloader.load_hf_llama(path, dtype=torch.float32, tp=2, quant=quant, device="cpu")
    full_leaves, want = _leaves(full), _leaves(params_from_numpy(tree, cfg, "cpu"))
    for k in want:
        np.testing.assert_array_equal(full_leaves[k], want[k], err_msg=k)


# -- the worker ---------------------------------------------------------------

async def _serve_one(address: str, extra: list[str], log, req: dict, namespace: str
                     ) -> list[int]:
    """Start a tiny worker with ``extra`` flags, send ``req`` once it serves,
    return its tokens; the worker is stopped (and joined) whatever happens."""
    from dynamo_tpu_torch.runtime import DistributedRuntime

    proc = subprocess.Popen(
        [sys.executable, "-m", "dynamo_tpu_torch.backends.torch", "--model-name", "tiny",
         "--preset", "tiny", "--obs-publish", "off", "--num-kv-blocks", "32", *extra],
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
            return [t async for out in await client.round_robin(req) for t in out["token_ids"]]
        finally:
            await rt.shutdown()
    finally:
        proc.terminate()  # it drains through the store, served by this loop
        try:
            await asyncio.to_thread(proc.wait, 60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def test_worker_tp2_on_cpu_ranks_serves_tp1_tokens(tmp_path):
    """``python -m dynamo_tpu_torch.backends.torch --tp 2
    --local-cpu-devices 2`` starts its second rank itself and serves a
    request over the store and data plane with the tokens of a tp = 1
    worker started beside it (another namespace); both ranks log their
    counters at exit."""
    req = _requests(1, max_tokens=10)[0]
    runs = {"tp1": ["--device", "cpu"], "tp2": ["--tp", "2", "--local-cpu-devices", "2"]}

    async def both(logs):
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
        streams = asyncio.run(asyncio.wait_for(both(logs), 150))
    finally:
        for f in logs.values():
            f.close()
    log = (tmp_path / "tp2.log").read_text()
    assert streams[0] == streams[1] and len(streams[0]) == 10, log[-3000:]
    assert "tp=2 over gloo" in log
    assert "torch follower rank 1 stopping" in log, log[-3000:]


@pytest.mark.parametrize("flags, item", [
    (["--dp", "2", "--role", "prefill"], None),
    (["--pp", "2", "--preset", "tiny-moe", "--moe-dispatch", "alltoall"], None),
    (["--sp", "2"], None),
    (["--tp", "2", "--role", "prefill", "--nnodes", "2"],
     "multi-host serving supports role=aggregated only"),
    (["--tp", "2", "--preset", "tiny-moe", "--moe-dispatch", "alltoall"], None),
], ids=["dp", "pp", "sp", "tp-prefill", "tp-moe-dispatch"])
def test_worker_refusals_name_their_items(flags, item):
    """A role on a mesh of one node passes (A12d part 2); across nodes it
    is refused with the JAX worker's message. The other flags whose items
    have landed pass: ``--sp`` (A12c) and ``--moe-dispatch`` over ranks
    (A12d part 1); a MoE preset under ``--pp`` is then refused as the JAX
    engine refuses it (``check_pp``)."""
    args = worker_main._parser().parse_args(flags)
    if item is not None:
        with pytest.raises(ValueError, match=item):
            worker_main._refuse_unported(args)
        return
    worker_main._refuse_unported(args)
    if args.pp > 1:
        from dynamo_tpu_torch.engine.core import check_pp

        cfg, eng = worker_main.engine_configs(args.preset, {}, args.moe_dispatch)
        with pytest.raises(ValueError, match="pipeline parallelism for MoE presets"):
            check_pp(cfg, eng, args.pp)


def test_rank_layout():
    """A node's ranks: one card each by default, the listed devices, or
    the CPU; the global rank counts nodes first."""
    parse = worker_main._parser().parse_args
    rank, devs = worker_main.rank_layout(parse(
        ["--tp", "4", "--nnodes", "2", "--node-rank", "1", "--tp-devices", "cuda:0,cuda:0",
         "--local-rank", "1"]))
    assert rank == 3 and devs == ["cuda:0"] * 4
    rank, devs = worker_main.rank_layout(parse(["--tp", "2", "--local-cpu-devices", "2"]))
    assert rank == 0 and devs == ["cpu", "cpu"]
    with pytest.raises(ValueError, match="--tp-devices names 1 devices for 2 ranks"):
        worker_main.rank_layout(parse(["--tp", "2", "--tp-devices", "cuda:0"]))
    with pytest.raises(ValueError, match="list the ranks' devices explicitly"):
        worker_main.rank_layout(parse(["--tp", "2"]))
