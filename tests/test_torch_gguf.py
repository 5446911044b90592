"""The port's GGUF reader against the JAX package's.

The files are built with the writer of ``tests/test_gguf.py`` (a
spec-conformant GGUF v3 file, byte by byte): metadata, the tensor index,
F32, F16, BF16 and I32 payloads and a block-quantized tensor that is
indexed only. Metadata, index, payloads (bit for bit), the config and the
tokenizer equal the JAX reader's; a non-GGUF file and a block-quantized
tensor are refused with the same messages. ``load_tokenizer("*.gguf")``
resolves in the port, and a worker started with ``--tokenizer *.gguf``
serves behind the port's frontend, which tokenizes with the file's
tokenizer.
"""

import asyncio
import dataclasses
import os
import struct
import subprocess
import sys
import time
from pathlib import Path

import aiohttp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import gguf as jgguf
from dynamo_tpu.llm.tokenizer import _load_cached as j_load_cached
from dynamo_tpu.llm.tokenizer import load_tokenizer as j_load_tokenizer
from dynamo_tpu_torch.engine import gguf as tgguf
from dynamo_tpu_torch.llm.tokenizer import _load_cached as t_load_cached
from dynamo_tpu_torch.llm.tokenizer import load_tokenizer as t_load_tokenizer
from tests.test_gguf import _kv_f32, _kv_str, _kv_str_array, _kv_u32, _s

ROOT = Path(__file__).resolve().parents[1]
TOKENS = ["<s>", "</s>", "<unk>", "▁hi", "▁there", "a", "b", "ab", "▁", "<0x21>",
          "<0xC3>", "<0xA9>", "<0xE2>", "<0x82>", "<0xAC>"]
TEXTS = [" hi there", "ab ba!", "é", " hi€", "aab b", "", "hi  there!"]


def _payloads():
    """name -> (ggml type, logical shape, raw bytes)."""
    rng = np.random.default_rng(0)
    f32 = rng.standard_normal((3, 4)).astype(np.float32)
    f16 = rng.standard_normal((2, 5)).astype(np.float16)
    bf16 = torch.from_numpy(rng.standard_normal((4, 2)).astype(np.float32)).bfloat16()
    i32 = np.array([7, -3, 2**31 - 1], np.int32)
    return {
        "tok_embd.weight": (0, (3, 4), f32.tobytes()),
        "blk.0.ffn_up.weight": (1, (2, 5), f16.tobytes()),
        "blk.0.attn_norm.weight": (30, (4, 2), bf16.view(torch.int16).numpy().tobytes()),
        "blk.0.ids": (26, (3,), i32.tobytes()),
        "blk.0.attn_q.weight": (12, (8,), bytes(144)),  # Q4_K: indexed, not loadable
    }


def write_gguf(path: Path, tokens=TOKENS, model="llama") -> Path:
    meta = [
        _kv_str("general.architecture", "llama"),
        _kv_str("general.name", "tinygguf"),
        _kv_u32("llama.embedding_length", 64),
        _kv_u32("llama.block_count", 2),
        _kv_u32("llama.attention.head_count", 4),
        _kv_u32("llama.attention.head_count_kv", 2),
        _kv_u32("llama.feed_forward_length", 128),
        _kv_f32("llama.rope.freq_base", 10000.0),
        _kv_f32("llama.attention.layer_norm_rms_epsilon", 1e-5),
        _kv_str("tokenizer.ggml.model", model),
        _kv_str_array("tokenizer.ggml.tokens", tokens),
        _kv_u32("tokenizer.ggml.bos_token_id", 0),
        _kv_u32("tokenizer.ggml.eos_token_id", 1),
        _kv_u32("tokenizer.ggml.unknown_token_id", 2),
    ]
    index, data = b"", b""
    for name, (gtype, shape, raw) in _payloads().items():
        data += b"\0" * ((-len(data)) % 32)
        index += (_s(name) + struct.pack("<I", len(shape))
                  + struct.pack(f"<{len(shape)}Q", *reversed(shape))
                  + struct.pack("<IQ", gtype, len(data)))
        data += raw
    header = struct.pack("<IIQQ", 0x46554747, 3, len(_payloads()), len(meta))
    header += b"".join(meta) + index
    path.write_bytes(header + b"\0" * ((-len(header)) % 32) + data)
    return path


@pytest.fixture
def gguf_file(tmp_path):
    return write_gguf(tmp_path / "tiny.gguf")


def test_metadata_and_index_match_jax(gguf_file):
    got, want = tgguf.read_gguf(gguf_file), jgguf.read_gguf(gguf_file)
    assert (got.version, got.metadata, got.data_start, got.alignment) == (
        want.version, want.metadata, want.data_start, want.alignment)
    assert {k: dataclasses.astuple(v) for k, v in got.tensors.items()} == {
        k: dataclasses.astuple(v) for k, v in want.tensors.items()}
    assert got.tensors["blk.0.attn_q.weight"].type_name == "Q4_K"


@pytest.mark.parametrize("name", ["tok_embd.weight", "blk.0.ffn_up.weight",
                                  "blk.0.attn_norm.weight", "blk.0.ids"])
def test_payloads_match_jax_bit_for_bit(gguf_file, name):
    """A CPU tensor of the JAX array's shape and bits; BF16 without
    ml_dtypes (read as uint16, viewed as torch.bfloat16)."""
    g = tgguf.read_gguf(gguf_file)
    got = g.load_tensor(name)
    want = jgguf.read_gguf(gguf_file).load_tensor(name)
    g.close()
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert tuple(got.shape) == want.shape
    if name == "blk.0.attn_norm.weight":
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.view(torch.int16).numpy(), want.view(np.int16))
    else:
        assert got.numpy().dtype == want.dtype
        np.testing.assert_array_equal(got.numpy(), want)


def test_refusals_match_jax(gguf_file, tmp_path):
    msgs = []
    for mod in (tgguf, jgguf):
        with pytest.raises(NotImplementedError) as e:
            mod.read_gguf(gguf_file).load_tensor("blk.0.attn_q.weight")
        msgs.append(str(e.value))
    bad = tmp_path / "bad.gguf"
    bad.write_bytes(b"NOPE" + b"\0" * 64)
    for mod in (tgguf, jgguf):
        with pytest.raises(ValueError) as e:
            mod.read_gguf(bad)
        msgs.append(str(e.value))
    bpe = write_gguf(tmp_path / "bpe.gguf", model="gpt2")
    for mod in (tgguf, jgguf):
        with pytest.raises(NotImplementedError) as e:
            mod.GGUFTokenizer.from_gguf(mod.read_gguf(bpe))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "Q4_K" in msgs[0]
    assert msgs[2] == msgs[3] and "not a GGUF file" in msgs[2]
    assert msgs[4] == msgs[5] and "'gpt2'" in msgs[4]


def test_config_matches_jax(gguf_file):
    got = tgguf.config_from_gguf(tgguf.read_gguf(gguf_file))
    want = jgguf.config_from_gguf(jgguf.read_gguf(gguf_file))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.vocab_size == len(TOKENS) and got.head_dim == 16


def _same_tokenizer(got, want):
    assert (got.eos_token_id, got.bos_token_id, got.vocab_size) == (
        want.eos_token_id, want.bos_token_id, want.vocab_size) == (1, 0, len(TOKENS))
    for text in TEXTS:
        ids = got.encode(text)
        assert ids == want.encode(text), text
        for skip in (True, False):
            assert got.decode(ids, skip) == want.decode(ids, skip)
            assert got.decode([0, *ids, 1, 99], skip) == want.decode([0, *ids, 1, 99], skip)
    messages = [{"role": "user", "content": "hi"}]
    assert got.apply_chat_template(messages) == want.apply_chat_template(messages)


def test_tokenizer_matches_jax(gguf_file):
    """Greedy longest-match encode, byte fallback (one unk for a character
    whose bytes are missing), exact decode."""
    _same_tokenizer(tgguf.GGUFTokenizer.from_gguf(tgguf.read_gguf(gguf_file)),
                    jgguf.GGUFTokenizer.from_gguf(jgguf.read_gguf(gguf_file)))
    assert tgguf.GGUFTokenizer.from_gguf(tgguf.read_gguf(gguf_file)).encode(" hi€") == [
        3, 12, 13, 14]


def test_load_tokenizer_resolves_gguf(gguf_file):
    """``load_tokenizer("*.gguf")`` returns the file's tokenizer in the port
    (it named a module the port lacked), equal to the JAX package's."""
    t_load_cached.cache_clear()
    j_load_cached.cache_clear()
    got, want = t_load_tokenizer(str(gguf_file)), j_load_tokenizer(str(gguf_file))
    assert isinstance(got, tgguf.GGUFTokenizer)
    _same_tokenizer(got, want)


def test_worker_serves_gguf_tokenizer(gguf_file, tmp_path):
    """``python -m dynamo_tpu_torch.backends.torch --tokenizer x.gguf``
    serves: its model card names the file, and the port's frontend
    tokenizes a completion's prompt with it."""
    from dynamo_tpu_torch.frontend.main import run_frontend
    from dynamo_tpu_torch.runtime import DistributedRuntime
    from dynamo_tpu_torch.runtime.store import StoreServer

    prompt = " hi there ab"
    n_prompt = len(tgguf.GGUFTokenizer.from_gguf(tgguf.read_gguf(gguf_file)).encode(prompt))

    async def run(log):
        store = StoreServer()
        await store.start()
        proc = subprocess.Popen(
            [sys.executable, "-m", "dynamo_tpu_torch.backends.torch", "--model-name", "gg",
             "--preset", "tiny", "--tokenizer", str(gguf_file), "--device", "cpu",
             "--obs-publish", "off"],
            cwd=ROOT, stdout=log, stderr=subprocess.STDOUT,
            env={**os.environ, "DYN_STORE_ADDRESS": store.address, "DYN_SYSTEM_ENABLED": "0"},
        )
        front = await DistributedRuntime.create(store.address)
        ready, services = asyncio.Event(), []
        task = asyncio.create_task(run_frontend(
            front, http_host="127.0.0.1", http_port=0, router_mode="round_robin",
            ready_event=ready, service_out=services, fleet_obs=False))
        try:
            await asyncio.wait_for(ready.wait(), 30)
            base = f"http://127.0.0.1:{services[0].port}"
            async with aiohttp.ClientSession() as s:
                deadline = time.time() + 120
                while True:
                    async with s.get(f"{base}/v1/models") as r:
                        if (await r.json())["data"]:
                            break
                    assert proc.poll() is None and time.time() < deadline, "worker never served"
                    await asyncio.sleep(0.2)
                body = {"model": "gg", "prompt": prompt, "max_tokens": 6, "temperature": 0.0,
                        "ignore_eos": True}
                async with s.post(f"{base}/v1/completions", json=body) as r:
                    assert r.status == 200, await r.text()
                    return await r.json()
        finally:
            front.signal_shutdown()
            task.cancel()
            proc.terminate()  # it drains through the store, served by this loop
            await asyncio.to_thread(proc.wait, 60)
            await front.shutdown()
            await store.stop()

    with open(tmp_path / "worker.log", "w") as log:
        out = asyncio.run(run(log))
    assert out["usage"]["prompt_tokens"] == n_prompt
    assert out["usage"]["completion_tokens"] == 6
    assert out["choices"][0]["finish_reason"] == "length"
