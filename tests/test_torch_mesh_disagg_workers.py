"""Disaggregated roles on workers of more than one rank, as processes on
the CPU.

A ``--role prefill --tp 2`` worker and a ``--role decode --pp 2`` worker
(each starting its second rank itself, gloo on the CPU) serve a prompt
over the port's store and data plane: the decode worker sends its
prefill to the tp worker, pulls the pages it holds (gathered whole to
its rank 0, scattered over the decode worker's stages) and decodes on
with a single-rank engine's tokens; both workers serve the same page
bytes, of the whole page's geometry, on ``kv_fetch``, the tp worker an
embedding equal to the single engine's, and every rank of both logs its
counters at exit.
"""

import asyncio
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from dynamo_tpu_torch.backends.torch.main import build_engine
from dynamo_tpu_torch.tokens import compute_seq_hashes
from tests.torch_tp_ranks import run_requests

ROOT = Path(__file__).resolve().parents[1]
PROMPT = [int(t) for t in np.random.default_rng(21).integers(3, 384, 70)]  # over 50: remote
TOKENS = 8


def _request(rid: str) -> dict:
    return {"model": "tiny", "token_ids": PROMPT, "request_id": rid,
            "sampling": {"temperature": 0.0},
            "stop": {"max_tokens": TOKENS, "ignore_eos": True}}


async def _drive(address: str, procs: dict) -> dict:
    """Wait for both workers, then the request through the decode worker,
    a page from each worker's ``kv_fetch`` and an embedding from the
    prefill worker."""
    from dynamo_tpu_torch.runtime import DistributedRuntime

    rt = await DistributedRuntime.create(address)
    try:
        ns = rt.namespace("dynamo")
        gen = {c: await ns.component(c).endpoint("generate").client()
               for c in ("prefill", "backend")}
        fetch = {c: await ns.component(c).endpoint("kv_fetch").client()
                 for c in ("prefill", "backend")}
        deadline = time.time() + 120
        while not all(c.instance_ids() for c in (*gen.values(), *fetch.values())):
            for name, proc in procs.items():
                assert proc.poll() is None, f"the {name} worker exited before serving"
            assert time.time() < deadline, "the workers never served"
            await asyncio.sleep(0.2)
        tokens = [t async for out in await gen["backend"].round_robin(_request("m1"))
                  for t in out["token_ids"]]
        block = compute_seq_hashes(PROMPT, 8)[:4]
        pages, shapes = {}, {}
        for c, client in fetch.items():
            frames = [f async for f in await client.round_robin(
                {"hashes": block, "chunk_blocks": 4})]
            pages[c] = [bytes(p) for f in frames for p in f.get("kv") or []]
            shapes[c] = next(f["shape"] for f in frames if "shape" in f)
        embed = [out async for out in await gen["prefill"].round_robin(
            {"embed": True, "token_ids": PROMPT[:20], "request_id": "e1"})][-1]["embedding"]
        return {"tokens": tokens, "pages": pages, "shapes": shapes, "embed": embed}
    finally:
        await rt.shutdown()


def _counters(text: str, who: str) -> dict:
    for line in reversed(text.splitlines()):
        if who in line and " stopping: " in line:
            return json.loads(line.split(" stopping: ", 1)[1])
    raise AssertionError(f"no counters of {who!r}:\n{text[-3000:]}")


def test_tp2_prefill_and_pp2_decode_workers_serve_single_tokens(tmp_path):
    """The decode worker's tokens equal a single engine's; it imported the
    prompt's full blocks from the tp worker and recomputed none; both
    workers serve those pages byte for byte; the tp worker's embedding
    equals the single engine's; both serve the whole page's geometry; the
    tp worker's ranks each joined page gathers, the pp worker's page
    scatters."""
    core, _ = build_engine("tiny", device="cpu")
    want = run_requests(core, [_request("ref")])["ref"]
    want_embed = core.embed(PROMPT[:20])
    common = [sys.executable, "-m", "dynamo_tpu_torch.backends.torch", "--model-name", "tiny",
              "--preset", "tiny", "--obs-publish", "off", "--num-kv-blocks", "64",
              "--local-cpu-devices", "2"]
    roles = {"prefill": ["--role", "prefill", "--tp", "2"],
             "decode": ["--role", "decode", "--pp", "2"]}

    async def run(logs):
        from dynamo_tpu_torch.runtime.store import StoreServer

        store = StoreServer()
        await store.start()
        env = {**os.environ, "DYN_STORE_ADDRESS": store.address, "DYN_SYSTEM_ENABLED": "0",
               "OMP_NUM_THREADS": "1"}
        procs = {name: subprocess.Popen(common + flags, cwd=ROOT, stdout=logs[name],
                                        stderr=subprocess.STDOUT, env=env)
                 for name, flags in roles.items()}
        try:
            return await _drive(store.address, procs)
        finally:
            for proc in procs.values():
                proc.terminate()  # they drain through the store, served by this loop
            for proc in procs.values():
                try:
                    await asyncio.to_thread(proc.wait, 60)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
            await store.stop()

    logs = {name: open(tmp_path / f"{name}.log", "w") for name in roles}
    try:
        got = asyncio.run(asyncio.wait_for(run(logs), 180))
    finally:
        for f in logs.values():
            f.close()
    text = {name: (tmp_path / f"{name}.log").read_text() for name in roles}
    assert got["tokens"] == want, text["decode"][-3000:]
    assert len(got["pages"]["prefill"]) == 4 and got["pages"]["backend"] == got["pages"]["prefill"]
    # The whole page's geometry on both meshes: [L, block_size, 2 n_kv, d].
    assert got["shapes"]["prefill"] == got["shapes"]["backend"] == [2, 8, 4, 16]
    np.testing.assert_allclose(got["embed"], want_embed, rtol=1e-4, atol=1e-5)
    lead = _counters(text["decode"], "torch worker")
    assert lead["transfer"]["imported_blocks"] >= 8 and lead["disagg"]["remote_prefills"] == 1
    assert lead["disagg"]["recompute_fallbacks"] == 0 and lead["transfer"]["dropped_blocks"] == 0
    for name, kind in (("prefill", "page_gather"), ("decode", "page_scatter")):
        for who in ("torch worker", "torch follower rank 1"):
            assert _counters(text[name], who)["collectives"][kind] > 0, (name, who)
