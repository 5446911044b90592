"""The port's Hugging Face checkpoint loader against the JAX package's.

Tiny llama and qwen2 checkpoints are built locally with ``transformers``
(as ``tests/test_hf_loader.py`` builds them), among them a qwen2 of 7
query heads over 1 KV head, saved as f32 and as bf16, as safetensors and
as ``pytorch_model.bin``, and sharded. On each, the port's config equals
the JAX loader's, its params equal ``convert.params_from_numpy`` of the
JAX loader's exactly (int8 too), its logits agree with ``transformers``
within the JAX test's 2e-3, and greedy streams of an engine built from
the checkpoint equal the JAX engine's. A worker process started with
``--model-path`` serves one.
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
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from dynamo_tpu.backends.jax.main import build_engine as jax_build_engine
from dynamo_tpu.engine import loader as jloader
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.backends.torch.main import build_engine
from dynamo_tpu_torch.engine import loader as tloader
from dynamo_tpu_torch.engine import model as tmodel
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.convert import params_from_numpy
from dynamo_tpu_torch.runtime.engine import Context

ROOT = Path(__file__).resolve().parents[1]
LAYERS = 2
# The checkpoints: (architecture, query heads, KV heads, hidden, saved dtype,
# safetensors?, tied embeddings?, largest shard or None).
CHECKPOINTS = {
    "llama-f32": ("llama", 4, 2, 32, torch.float32, True, False, None),
    "llama-bf16-bin": ("llama", 4, 2, 32, torch.bfloat16, False, False, None),
    "llama-tied": ("llama", 4, 2, 32, torch.float32, True, True, None),
    "llama-sharded": ("llama", 4, 2, 32, torch.bfloat16, True, False, "20KB"),
    "qwen2-f32": ("qwen2", 4, 2, 32, torch.float32, True, False, None),
    "qwen2-g7-f32": ("qwen2", 7, 1, 56, torch.float32, True, False, None),
    "qwen2-g7-bf16": ("qwen2", 7, 1, 56, torch.bfloat16, True, False, None),
    "qwen2-g7-f32-bin": ("qwen2", 7, 1, 56, torch.float32, False, False, None),
    "qwen2-g7-bf16-bin": ("qwen2", 7, 1, 56, torch.bfloat16, False, False, None),
}
SERVED = ["llama-f32", "qwen2-g7-bf16"]
# Small engine shapes for the greedy comparisons (both packages).
ENGINE = dict(num_kv_blocks=64, block_size=8, max_num_seqs=4, max_model_len=128,
              prefill_buckets=(32, 64), decode_buckets=(4,), decode_chain=4)


def _hf_model(arch, heads, kv_heads, hidden, tied, seed):
    common = dict(
        vocab_size=128, hidden_size=hidden, intermediate_size=64,
        num_hidden_layers=LAYERS, num_attention_heads=heads, num_key_value_heads=kv_heads,
        max_position_embeddings=128, rope_theta=10000.0, tie_word_embeddings=tied,
        # Wider than the default 0.02, so that greedy picks are not near-ties.
        initializer_range=0.5,
    )
    torch.manual_seed(seed)
    if arch == "llama":
        return transformers.LlamaForCausalLM(transformers.LlamaConfig(**common))
    return transformers.Qwen2ForCausalLM(
        transformers.Qwen2Config(use_sliding_window=False, **common))


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """name -> (directory, the f32 transformers model it was saved from)."""
    out = {}
    for i, (name, (arch, heads, kv, hidden, dt, safe, tied, shard)) in enumerate(
            CHECKPOINTS.items()):
        model = _hf_model(arch, heads, kv, hidden, tied, seed=i)
        path = tmp_path_factory.mktemp(name)
        kw = {"max_shard_size": shard} if shard else {}
        model.to(dt).save_pretrained(path, safe_serialization=safe, **kw)
        out[name] = (path, model.float().eval())
    return out


def _assert_equal_trees(got, want, where="params"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), where
        for k in want:
            _assert_equal_trees(got[k], want[k], f"{where}.{k}")
        return
    assert got.dtype == want.dtype and got.shape == want.shape, where
    assert torch.equal(got, want), where


def _jax_params(path, jdtype, quant, cfg):
    _, jp = jloader.load_hf_llama(path, dtype=jdtype, quant=quant)
    return params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")


@pytest.mark.parametrize("name", list(CHECKPOINTS))
def test_config_matches_jax(checkpoints, name):
    path, _ = checkpoints[name]
    got = dataclasses.asdict(tloader.config_from_hf(path))
    want = dataclasses.asdict(jloader.config_from_hf(path))
    assert got == want
    assert got["attn_qkv_bias"] == name.startswith("qwen2")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", list(CHECKPOINTS))
def test_params_equal_jax_loader(checkpoints, name, dtype):
    """Exactly the JAX loader's values, through ``convert``: a bf16 source
    copied, f32 sources rounded to bf16 as ml_dtypes rounds them."""
    path, _ = checkpoints[name]
    tdt, jdt = {"f32": (torch.float32, jnp.float32), "bf16": (None, None)}[dtype]
    cfg, got = tloader.load_hf_llama(path, dtype=tdt, device="cpu")
    _assert_equal_trees(got, _jax_params(path, jdt, None, cfg))
    assert ("lm_head" in got) == (not cfg.tie_embeddings)
    assert ("bqkv" in got["layers"]) == cfg.attn_qkv_bias


@pytest.mark.parametrize("name", ["llama-f32", "llama-bf16-bin", "qwen2-g7-f32", "qwen2-g7-bf16"])
def test_int8_equal_jax_loader(checkpoints, name):
    """int8 weights byte-equal and scales bit-equal to the JAX loader's
    (``_quantize_np``: a true division by 127 on the f32 values)."""
    path, _ = checkpoints[name]
    cfg, got = tloader.load_hf_llama(path, quant="int8", device="cpu")
    want = _jax_params(path, None, "int8", cfg)
    _assert_equal_trees(got, want)
    assert got["layers"]["wqkv"]["w"].dtype == torch.int8
    assert got["lm_head"]["scale"].shape == (1, cfg.vocab_size)


def _port_logits(params, cfg, prompt):
    """Last-token logits of one prefill through the port's forward, in f32."""
    cfg = dataclasses.replace(cfg, dtype="float32")
    eng = EngineConfig(num_kv_blocks=16, block_size=8, max_num_seqs=2, max_model_len=64,
                       prefill_buckets=(16, 32), decode_buckets=(2,))
    cache = tmodel.init_cache(cfg, eng, device="cpu")
    n, bucket, blocks = len(prompt), 16, np.array([0, 1], np.int32)
    pos = np.arange(n, dtype=np.int32)
    pad = lambda a, fill=0: np.concatenate([a, np.full(bucket - n, fill, np.int32)])  # noqa: E731
    table = np.full((1, eng.max_blocks_per_seq), eng.garbage_block, np.int32)
    table[0, :2] = blocks
    ops = [pad(np.array(prompt, np.int32)), pad(pos), pad(blocks[pos // 8], eng.garbage_block),
           pad(pos % 8), np.array([n], np.int32), table, np.array([0, n], np.int32),
           np.array([1], np.int32), np.array([n - 1], np.int32)]
    return tmodel.forward_tokens(params, cache, *map(torch.from_numpy, ops), cfg)[0]


@pytest.mark.parametrize("name", ["llama-f32", "qwen2-f32", "qwen2-g7-f32"])
def test_logits_match_transformers(checkpoints, name):
    path, hf_model = checkpoints[name]
    cfg, params = tloader.load_hf_llama(path, dtype=torch.float32, device="cpu")
    prompt = [3, 17, 42, 99, 7, 64, 23, 5]
    with torch.no_grad():
        want = hf_model(torch.tensor([prompt])).logits[0, -1].numpy()
        got = _port_logits(params, cfg, prompt).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


# Greedy streams at bf16 may part where the JAX engine's two best tokens are
# this close in log-probability (the ceiling chip_smoke.py holds its
# near-ties to): the JAX engine's compiled step keeps some bf16 roundings
# of its plain forward in f32, which moves a log-probability by up to
# ~4e-2 here, while the port computes that plain forward.
NEAR_TIE = 0.1


def _greedy_requests():
    rng = np.random.default_rng(5)
    return [
        {"model": "ck", "token_ids": [int(t) for t in rng.integers(1, 128, n)],
         "request_id": f"g{i}", "sampling": {"temperature": 0.0},
         "stop": {"max_tokens": 12, "ignore_eos": True}, "output": {"logprobs": 2}}
        for i, n in enumerate((5, 19, 33))
    ]


async def _streams(engine, make_context):
    """Each greedy request's tokens, with each token's top-2 log-probs."""
    async def one(req):
        return [(lp["token_id"], lp["top"])
                async for out in engine.generate(dict(req), make_context(req["request_id"]))
                for lp in out["logprobs"]]

    return await asyncio.gather(*(one(r) for r in _greedy_requests()))


def _held_to_near_ties(got, want):
    """Token for token equal, but where the JAX engine's top two are a
    near-tie: there the port must pick JAX's runner-up, and the streams
    are compared no further."""
    for g, w in zip(got, want):
        for (gt, _), (wt, top) in zip(g, w):
            if gt != wt:
                (first, lp1), (second, lp2) = top[:2]
                assert gt == second and lp1 - lp2 < NEAR_TIE, (g, w)
                break
        assert len(g) == len(w) == 12


@pytest.mark.parametrize("name", SERVED)
def test_engine_from_checkpoint_matches_jax_engine(checkpoints, name):
    """``build_engine(None, model_path=...)`` on the CPU (bf16 weights, the
    model's dtype) streams the JAX engine's greedy tokens from the same
    checkpoint up to near-ties, and its first token's log-probabilities
    are the plain JAX forward's; at f32, engines on both loaders' params
    stream the same tokens exactly."""
    from dynamo_tpu.engine import EngineCore as JaxCore
    from dynamo_tpu.engine import TpuEngine
    from dynamo_tpu.engine import model as jmodel
    from dynamo_tpu.engine.config import EngineConfig as JaxEngineConfig
    from dynamo_tpu_torch.engine.core import EngineCore
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from tests.model_harness import prefill_chunk

    path, _ = checkpoints[name]
    core, engine = build_engine(None, model_path=str(path), engine_overrides=ENGINE, device="cpu")
    assert core.cfg == tloader.config_from_hf(path) and core.cfg.dtype == "bfloat16"
    _, jengine = jax_build_engine("tiny", ENGINE, model_path=str(path))
    got = asyncio.run(_streams(engine, Context))
    _held_to_near_ties(got, asyncio.run(_streams(jengine, JaxContext)))
    jcfg, jparams = jloader.load_hf_llama(path)
    prompt = _greedy_requests()[0]["token_ids"]
    jeng = JaxEngineConfig(**ENGINE)
    logits, _ = prefill_chunk(jparams, jmodel.init_cache(jcfg, jeng), prompt, 0, [0], jcfg,
                              jeng, 32)
    plain = np.asarray(jax.nn.log_softmax(np.asarray(logits, np.float32)))
    top = dict(got[0][0][1])
    np.testing.assert_allclose([top[t] for t in top], [plain[t] for t in top], atol=1e-4)

    cfg32 = dataclasses.replace(core.cfg, dtype="float32")
    _, tparams = tloader.load_hf_llama(path, dtype=torch.float32, device="cpu")
    _, jparams = jloader.load_hf_llama(path, dtype=jnp.float32)
    jcfg32 = dataclasses.replace(jcfg, dtype="float32")
    got = asyncio.run(_streams(TorchEngine(EngineCore(
        cfg32, EngineConfig(**ENGINE), params=tparams, device="cpu")), Context))
    want = asyncio.run(_streams(TpuEngine(JaxCore(jcfg32, jeng, params=jparams)), JaxContext))
    assert [[t for t, _ in s] for s in got] == [[t for t, _ in s] for s in want]


def test_int8_engine_from_checkpoint(checkpoints):
    path, _ = checkpoints["llama-f32"]
    core, engine = build_engine(None, model_path=str(path), engine_overrides=ENGINE,
                                device="cpu", quant="int8")
    _assert_equal_trees(core.params, _jax_params(path, None, "int8", core.cfg))
    assert all(len(s) == 12 for s in asyncio.run(_streams(engine, Context)))


def test_safetensors_reader_matches_package(checkpoints):
    """Across the shards of a sharded checkpoint, the port's reader gives
    the ``safetensors`` package's tensors."""
    from safetensors import safe_open

    path, _ = checkpoints["llama-sharded"]
    shards = sorted(path.glob("*.safetensors"))
    assert len(shards) > 2
    seen = 0
    for f in shards:
        got = tloader.read_safetensors(f)
        with safe_open(f, framework="pt") as sf:
            assert sorted(got) == sorted(sf.keys())
            for key in sf.keys():
                want = sf.get_tensor(key)
                assert got[key].dtype == want.dtype == torch.bfloat16
                assert torch.equal(got[key], want), key
                seen += 1
    assert seen == 3 + 9 * LAYERS


def test_refusals(checkpoints, tmp_path, monkeypatch):
    """tp > 1, a missing shard, an unknown dtype and an unknown
    quantization raise; the default device is the card, which raises
    without one."""
    path, _ = checkpoints["llama-sharded"]
    with pytest.raises(ValueError, match="A12"):
        tloader.load_hf_llama(path, tp=2, device="cpu")
    with pytest.raises(ValueError, match="unknown quantization"):
        tloader.load_hf_llama(path, quant="int4", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tloader.load_hf_llama(path)
    broken = tmp_path / "broken"
    broken.mkdir()
    for f in path.iterdir():
        (broken / f.name).write_bytes(f.read_bytes())
    (broken / sorted(broken.glob("*.safetensors"))[1].name).unlink()
    with pytest.raises(FileNotFoundError, match="missing shards"):
        tloader.load_hf_llama(broken, device="cpu")
    header = json.dumps({"x": {"dtype": "I64", "shape": [2], "data_offsets": [0, 16]}}).encode()
    odd = tmp_path / "odd.safetensors"
    odd.write_bytes(struct.pack("<Q", len(header)) + header + bytes(16))
    with pytest.raises(ValueError, match="I64"):
        tloader.read_safetensors(odd)
    empty = tmp_path / "empty"
    empty.mkdir()
    (empty / "config.json").write_bytes((path / "config.json").read_bytes())
    with pytest.raises(FileNotFoundError, match="no safetensors or torch checkpoints"):
        tloader.load_hf_llama(empty, device="cpu")


def test_engine_names_one_model(checkpoints):
    """``build_engine`` takes a preset or a checkpoint, not both and not
    neither; a refusal on a checkpoint's model names the checkpoint."""
    path, _ = checkpoints["llama-f32"]
    with pytest.raises(ValueError, match="not both or neither"):
        build_engine("tiny", model_path=str(path), device="cpu")
    with pytest.raises(ValueError, match="not both or neither"):
        build_engine(None, device="cpu")
    with pytest.raises(ValueError, match=f"checkpoint '{path}' is dense"):
        build_engine(None, model_path=str(path), device="cpu", moe_dispatch="alltoall")


def test_tied_checkpoint_has_no_lm_head(checkpoints):
    path, hf_model = checkpoints["llama-tied"]
    cfg, params = tloader.load_hf_llama(path, dtype=torch.float32, device="cpu")
    assert cfg.tie_embeddings and "lm_head" not in params
    with torch.no_grad():
        want = hf_model(torch.tensor([[9, 8, 7]])).logits[0, -1].numpy()
    np.testing.assert_allclose(_port_logits(params, cfg, [9, 8, 7]).numpy(), want,
                               rtol=2e-3, atol=2e-3)


async def _ask_worker(address: str, proc, req: dict) -> list[int]:
    from dynamo_tpu_torch.runtime import DistributedRuntime

    rt = await DistributedRuntime.create(address)
    try:
        client = await rt.namespace("dynamo").component("backend").endpoint("generate").client()
        deadline = time.time() + 120
        while not client.instance_ids():
            assert proc.poll() is None, "the worker exited before serving"
            assert time.time() < deadline, "the worker never served"
            await asyncio.sleep(0.2)
        return [t async for out in await client.round_robin(req) for t in out["token_ids"]]
    finally:
        await rt.shutdown()


def test_worker_serves_checkpoint(checkpoints, tmp_path):
    """``python -m dynamo_tpu_torch.backends.torch --model-path DIR --device
    cpu`` answers a request with the greedy stream of ``build_engine`` on
    the same checkpoint; the directory has no tokenizer files, so the
    worker serves byte-level and says so."""
    from dynamo_tpu_torch.runtime.store import StoreServer

    path, _ = checkpoints["qwen2-g7-bf16"]
    req = _greedy_requests()[1]
    flags = {"num_kv_blocks": 64, "max_num_seqs": 4, "max_model_len": 128}
    _, engine = build_engine(None, model_path=str(path), engine_overrides=flags, device="cpu")
    want = [t for t, _ in asyncio.run(_streams(engine, Context))[1]]

    async def run(log):
        store = StoreServer()
        await store.start()
        proc = subprocess.Popen(
            [sys.executable, "-m", "dynamo_tpu_torch.backends.torch", "--model-name", "ck",
             "--model-path", str(path), "--device", "cpu", "--obs-publish", "off",
             *(f"--{k.replace('_', '-')}={v}" for k, v in flags.items())],
            cwd=ROOT, stdout=log, stderr=subprocess.STDOUT,
            env={**os.environ, "DYN_STORE_ADDRESS": store.address, "DYN_SYSTEM_ENABLED": "0"},
        )
        try:
            return await _ask_worker(store.address, proc, req)
        finally:
            proc.terminate()  # it drains through the store, served by this loop
            await asyncio.to_thread(proc.wait, 60)
            await store.stop()

    with open(tmp_path / "worker.log", "w") as log:
        got = asyncio.run(run(log))
    text = (tmp_path / "worker.log").read_text()
    assert got == want, text[-3000:]
    assert "has no tokenizer files; serving byte-level" in text
    assert f"checkpoint {path}" in text
    assert "(weights loaded from the checkpoint), warmed up in" in text
