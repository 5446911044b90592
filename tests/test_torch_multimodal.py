"""The port's multimodal path against the JAX package's, on the CPU.

An image request carries its encoder rows (``pre.mm``: the embeddings and
the ``[start, count]`` spans of its placeholder tokens). The port's
``EngineCore`` splices exactly the JAX engine's rows into each ragged
forward (a whole prompt, chunks that start or end inside an image, rows
of several requests), refuses bad rows with the JAX messages, and, on
weights carried across by ``engine/convert.py``, serves image requests
with the JAX engine's greedy streams under waves and chunked scheduling,
synchronous and asynchronous: another image gives another stream, and
the same image again hits the prefix cache. The worker resolves image
refs as the JAX worker does (``_resolve_mm``); and the port's store,
worker and frontend, each a process, answer an image chat request with
the in-process encode and then with the port's encoder component, with
the same completion, and ``/v1/embeddings`` with the engine's vectors;
behind the JAX frontend a torch prefill and a torch decode worker
complete an image chat as the aggregated JAX worker does.

Tolerances: spliced rows exact; log-probabilities within 1e-4 (f32 on
both sides, sums in other orders); the worker's embeddings within 1e-5
of an engine with the same seed in this process.
"""

import asyncio
import base64
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import aiohttp
import jax
import numpy as np
import pytest

from dynamo_tpu.engine import EngineCore as JaxCore
from dynamo_tpu.engine import model as jmodel
from dynamo_tpu.engine.config import tiny_engine as j_tiny_engine
from dynamo_tpu.engine.config import tiny_model as j_tiny_model
from dynamo_tpu.llm.protocols.common import PreprocessedRequest as JaxRequest
from dynamo_tpu_torch.backends.torch.main import _resolve_mm, build_engine
from dynamo_tpu_torch.engine.config import tiny_model
from dynamo_tpu_torch.engine.convert import params_from_numpy
from dynamo_tpu_torch.llm.multimodal import MM_PATCHES, image_bytes, patch_embed, pseudo_tokens
from dynamo_tpu_torch.llm.protocols.common import PreprocessedRequest

ROOT = Path(__file__).resolve().parents[1]
LP_TOL = 1e-4
EMBED_TOL = 1e-5


def data_url(payload: bytes) -> str:
    return "data:application/octet-stream;base64," + base64.b64encode(payload).decode()


IMG_A = data_url(b"a cat sitting on a red mat" * 9)
IMG_B = data_url(b"a dog running on green grass" * 9)
TEXT = [5, 6, 7, 8, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20]  # 14 tokens before the image


def _mm_wire(rid, img, text=TEXT, tail=(9, 10), max_tokens=8, embeds=True):
    cfg = tiny_model()
    w = {"model": "tiny", "token_ids": list(text) + pseudo_tokens(img, cfg.vocab_size) + list(tail),
         "request_id": rid, "sampling": {"temperature": 0.0}, "stop": {"max_tokens": max_tokens},
         "output": {"logprobs": 1},
         "mm": {"images": [img], "positions": [[len(text), MM_PATCHES]]}}
    if embeds:
        emb = patch_embed(image_bytes(img), cfg.hidden_size)
        w["mm"].update(embeds=emb.astype(np.float32).tobytes(), embeds_shape=list(emb.shape))
    return w


@pytest.fixture(scope="module")
def weights():
    jparams = jmodel.init_params(jax.random.PRNGKey(3), j_tiny_model())
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams), tiny_model(), device="cpu")


def _seq(core, wire, n_blocks=8):
    from_wire = JaxRequest.from_wire if isinstance(core, JaxCore) else PreprocessedRequest.from_wire
    seq = core.add_request(from_wire(wire))
    seq.block_ids = list(range(n_blocks))
    return seq


# (first prompt position, last + 1) of each row: the image spans 14..30.
WINDOWS = {
    "whole_prompt": [(0, 32)],
    "chunk_starts_inside_image": [(20, 32)],
    "chunk_ends_inside_image": [(8, 24)],
    "text_row_beside_image_rows": [(0, 16), (16, 32)],
}


@pytest.mark.parametrize("window", list(WINDOWS))
def test_splice_rows_match_jax(weights, window):
    """``_assemble_ragged`` puts the same encoder rows at the same token
    slots as the JAX engine's, masked the same; a text-only request
    beside an image request gets no rows."""
    jcore = JaxCore(j_tiny_model(), j_tiny_engine(), params=weights[0])
    tcore, _ = build_engine("tiny", device="cpu", params=weights[1])
    batches = []
    for core in (jcore, tcore):
        img = _seq(core, _mm_wire("img", IMG_A))
        txt = _seq(core, {**_mm_wire("txt", IMG_B), "mm": None})
        rows = [(img, img.prompt[a:b], a, b) for a, b in WINDOWS[window]]
        rows.append((txt, txt.prompt[:5], 0, 5))
        batches.append(core._assemble_ragged(rows, 8))
    want, got = batches
    assert want.want_mm and got.mm_embeds is not None
    np.testing.assert_array_equal(got.mm_mask, np.asarray(want.mm_mask))
    np.testing.assert_array_equal(got.mm_embeds, np.asarray(want.mm_embeds))
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    assert 0 < got.mm_mask.sum() <= MM_PATCHES
    # Rows without an image span carry no multimodal rows at all.
    for core in (jcore, tcore):
        txt = _seq(core, {**_mm_wire("plain", IMG_B), "mm": None})
        b = core._assemble_ragged([(txt, txt.prompt[:5], 0, 5)], 8)
        assert (b.want_mm is False) if core is jcore else (b.mm_embeds is None)


def _drive(core, wires, max_steps=500):
    from_wire = JaxRequest.from_wire if isinstance(core, JaxCore) else PreprocessedRequest.from_wire
    seqs = [core.add_request(from_wire(w)) for w in wires]
    toks = {s.request_id: [] for s in seqs}
    lps = {s.request_id: [] for s in seqs}
    for _ in range(max_steps):
        if not core.has_work():
            break
        for s, out in core.step():
            toks[s.request_id] += list(out.token_ids)
            lps[s.request_id] += [e["logprob"] for e in (out.logprobs or [])]
    assert not core.has_work()
    return toks, lps, {s.request_id: s.num_cached_tokens for s in seqs}


MODES = {
    "waves": {},
    "waves_async": {"async_exec": True},
    "chunked": {"scheduling": "chunked", "prefill_chunk": 16},
    "chunked_async": {"scheduling": "chunked", "prefill_chunk": 16, "async_exec": True},
}


@pytest.mark.parametrize("mode", list(MODES))
def test_image_request_streams_match_jax(weights, mode):
    """Image requests next to a text request, then the first image again:
    the JAX engine's greedy streams and log-probabilities; the image
    changes the stream, and its repeat is served from the prefix cache."""
    jcore = JaxCore(j_tiny_model(), j_tiny_engine(**MODES[mode]), params=weights[0])
    tcore, _ = build_engine("tiny", MODES[mode], device="cpu", params=weights[1])
    first = [_mm_wire("a", IMG_A), _mm_wire("b", IMG_B),
             {**_mm_wire("t", IMG_A, text=[3, 4]), "mm": None}]
    for wires in (first, [_mm_wire("a2", IMG_A)]):
        want_t, want_lp, _ = _drive(jcore, wires)
        got_t, got_lp, cached = _drive(tcore, wires)
        assert got_t == want_t
        for rid in got_t:
            assert len(got_t[rid]) == 8
            np.testing.assert_allclose(got_lp[rid], want_lp[rid], atol=LP_TOL, rtol=0)
    assert got_t["a2"] == _drive(tcore, [_mm_wire("a3", IMG_A)])[0]["a3"]
    assert want_t["a2"] != _drive(jcore, [{**_mm_wire("plain", IMG_A), "mm": None}])[0]["plain"]
    assert cached["a2"] > 0, "the same image missed the prefix cache"


@pytest.mark.parametrize("fault", ["width", "rows"])
def test_bad_rows_refused_as_jax(fault):
    """Rows of the wrong width, or fewer rows than the spans need, are
    refused at admission with the JAX engine's message."""
    wire = _mm_wire("bad", IMG_A)
    if fault == "width":
        emb = np.zeros((MM_PATCHES, 32), np.float32)
    else:
        emb = np.zeros((MM_PATCHES - 1, tiny_model().hidden_size), np.float32)
    wire["mm"].update(embeds=emb.tobytes(), embeds_shape=list(emb.shape))
    jcore = JaxCore(j_tiny_model(), j_tiny_engine(), seed=0)
    tcore, _ = build_engine("tiny", device="cpu")
    with pytest.raises(ValueError) as want:
        jcore.add_request(JaxRequest.from_wire(wire))
    with pytest.raises(ValueError) as got:
        tcore.add_request(PreprocessedRequest.from_wire(wire))
    assert str(got.value) == str(want.value)


def test_resolve_mm_encodes_in_process_without_a_fleet():
    """With no encoder fleet the worker encodes in process: the rows of
    every image, in order; a request with rows already is left as it is."""
    core, _ = build_engine("tiny", device="cpu")
    wire = _mm_wire("r", IMG_A, embeds=False)
    wire["mm"]["images"] = [IMG_A, IMG_B]
    asyncio.run(_resolve_mm(core, None, None, wire))
    want = np.concatenate([patch_embed(image_bytes(i), 64) for i in (IMG_A, IMG_B)])
    assert wire["mm"]["embeds_shape"] == [2 * MM_PATCHES, 64]
    np.testing.assert_array_equal(np.frombuffer(wire["mm"]["embeds"], np.float32),
                                  want.reshape(-1))
    held = dict(wire["mm"])
    asyncio.run(_resolve_mm(core, None, None, wire))
    assert wire["mm"] == held


# -- the port's store, worker and frontend, each a process ---------------------

MODEL = "tinymm"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait_for_port(port: int, proc, timeout=60.0) -> None:
    t0 = time.time()
    while time.time() - t0 < timeout:
        assert proc.poll() is None, f"{proc.args} exited before listening on {port}"
        with socket.socket() as s:
            if s.connect_ex(("127.0.0.1", port)) == 0:
                return
        time.sleep(0.1)
    raise TimeoutError(f"nothing listened on port {port}")


def _spawn(args, log: Path, env: dict) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-m", *args], cwd=ROOT, env=env,
                            stdout=log.open("w"), stderr=subprocess.STDOUT)


async def _until(pred, what: str, procs, timeout=90.0):
    t0 = time.time()
    while time.time() - t0 < timeout:
        for p in procs:
            assert p.poll() is None, f"a process exited ({p.args}) before {what}"
        if await pred():
            return
        await asyncio.sleep(0.2)
    raise TimeoutError(what)


async def _chat(s, base, img):
    body = {"model": MODEL, "max_tokens": 6, "temperature": 0.0, "logprobs": True, "messages": [{
        "role": "user", "content": [{"type": "text", "text": "describe "},
                                    {"type": "image_url", "image_url": {"url": img}}]}]}
    async with s.post(f"{base}/v1/chat/completions", json=body) as r:
        assert r.status == 200, await r.text()
        return await r.json()


def test_worker_processes_serve_images_and_embeddings(tmp_path):
    """The port's store, worker (``--device cpu``) and frontend as
    processes: ``/v1/embeddings`` answers with the vectors of an engine
    with the same seed; an image chat request is encoded in process, its
    repeat hits the prefix cache, another image changes the completion;
    with the port's encoder component on the fleet the same request goes
    through it (encoded and pulled by descriptor) and completes the same."""
    from dynamo_tpu_torch.backends.encoder.main import run_encode_worker
    from dynamo_tpu_torch.runtime import DistributedRuntime

    store_port, http_port = _free_port(), _free_port()
    address = f"127.0.0.1:{store_port}"
    env = {**os.environ, "DYN_STORE_ADDRESS": address, "DYN_SYSTEM_ENABLED": "0"}
    procs = [_spawn(["dynamo_tpu_torch.runtime.store", "--port", str(store_port)],
                    tmp_path / "store.log", env)]
    base = f"http://127.0.0.1:{http_port}"
    prompts = [[3, 4, 5, 6, 7], list(range(10, 50))]

    async def go():
        async with aiohttp.ClientSession() as s:
            async def model_listed():
                try:
                    async with s.get(f"{base}/v1/models") as r:
                        return r.status == 200 and MODEL in await r.text()
                except aiohttp.ClientError:
                    return False

            await _until(model_listed, "the model was listed", procs)
            async with s.post(f"{base}/v1/embeddings",
                              json={"model": MODEL, "input": prompts}) as r:
                assert r.status == 200, await r.text()
                emb = [d["embedding"] for d in (await r.json())["data"]]
            local = [await _chat(s, base, img) for img in (IMG_A, IMG_A, IMG_B)]

            rt = await DistributedRuntime.create(address)
            stats: list = []
            served = asyncio.Event()
            task = asyncio.create_task(run_encode_worker(rt, served_event=served,
                                                         stats_out=stats))
            try:
                await asyncio.wait_for(served.wait(), 30)
                fleet = None
                for _ in range(50):  # the worker's encoder client sees it soon
                    fleet = await _chat(s, base, IMG_A)
                    if stats[0]["fetched"]:
                        break
                    await asyncio.sleep(0.2)
                assert stats[0]["encoded"] >= 1 and stats[0]["fetched"] >= 1
            finally:
                rt.signal_shutdown()
                await asyncio.sleep(0.1)
                task.cancel()
                await rt.shutdown()
            return emb, local, fleet

    try:
        _wait_for_port(store_port, procs[0])
        # The frontend listens before the worker binds its ephemeral ports.
        procs.append(_spawn(["dynamo_tpu_torch.frontend", "--http-host", "127.0.0.1",
                             "--http-port", str(http_port), "--router-mode", "round_robin"],
                            tmp_path / "frontend.log", env))
        _wait_for_port(http_port, procs[1])
        procs.append(_spawn(["dynamo_tpu_torch.backends.torch", "--model-name", MODEL,
                             "--preset", "tiny", "--device", "cpu", "--seed", "0"],
                            tmp_path / "worker.log", env))
        emb, (a, a2, b), fleet = asyncio.run(go())
    finally:
        for p in reversed(procs):
            if p.poll() is None:
                p.send_signal(signal.SIGINT)
        for p in procs:
            try:
                p.wait(20)
            except subprocess.TimeoutExpired:
                p.kill()
    core, _ = build_engine("tiny", device="cpu", seed=0)
    for got, prompt in zip(emb, prompts):
        np.testing.assert_allclose(got, core.embed(prompt), atol=EMBED_TOL, rtol=EMBED_TOL)
    # The completion and each token's log-probability: a random tiny model
    # may emit the same text for two images, never the same numbers.
    text = lambda out: (out["choices"][0]["message"]["content"],  # noqa: E731
                        [t["logprob"] for t in out["choices"][0]["logprobs"]["content"]])
    assert a["usage"]["completion_tokens"] == 6
    assert text(a2)[0] == text(a)[0] and text(b)[1] != text(a)[1]
    np.testing.assert_allclose(text(a2)[1], text(a)[1], atol=LP_TOL, rtol=0)
    assert a2["usage"].get("prompt_tokens_details", {}).get("cached_tokens", 0) > 0
    assert text(fleet)[0] == text(a)[0]
    np.testing.assert_allclose(text(fleet)[1], text(a)[1], atol=LP_TOL, rtol=0)
    assert "encoder fleet failed" not in (tmp_path / "worker.log").read_text()


async def test_image_request_disaggregated_matches_aggregated_jax():
    """An image chat past the decode worker's local prefill limit, through
    a torch prefill and a torch decode worker behind the JAX frontend, on
    the JAX workers' weights: the decode worker resolves the image and
    queues the prefill with its rows, the prefill worker splices them, the
    decode worker imports the blocks; the completion is the aggregated JAX
    worker's."""
    from tests.test_torch_disagg import MODEL as DISAGG_MODEL
    from tests.test_torch_disagg import Fleet, _normalise

    params = jax.tree.map(np.asarray, jmodel.init_params(jax.random.PRNGKey(0), j_tiny_model()))
    body = {"model": DISAGG_MODEL, "max_tokens": 6, "temperature": 0.0, "messages": [{
        "role": "user", "content": [
            {"type": "text", "text": "look closely at this picture and describe every detail "},
            {"type": "image_url", "image_url": {"url": IMG_A}}]}]}

    async def ask(fleet) -> bytes:
        async with aiohttp.ClientSession() as s:
            async with s.post(f"{fleet.base_url}/v1/chat/completions", json=body) as r:
                raw = await r.read()
                assert r.status == 200, raw
                return _normalise(raw)

    async with Fleet([("jax", "aggregated")], params) as f:
        want = await ask(f)
    async with Fleet([("torch", "prefill"), ("torch", "decode")], params) as f:
        got = await ask(f)
        p_core, d_core = f.cores
        assert p_core.iterations > 0
        assert d_core.transfer_stats["imported_blocks"] > 0
    assert got == want
