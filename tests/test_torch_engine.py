"""The TorchEngine facade against TpuEngine: concurrent greedy requests
through ``generate(wire_dict, context)``, one of them cancelled after its
first chunk, yield the same token ids and finish reasons on both."""

import asyncio

import jax
import numpy as np
import pytest

from dynamo_tpu.engine import EngineCore as JaxCore
from dynamo_tpu.engine import TpuEngine
from dynamo_tpu.engine import model as jmodel
from dynamo_tpu.engine.config import tiny_engine as j_tiny_engine
from dynamo_tpu.engine.config import tiny_model as j_tiny_model
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.backends.torch.main import build_engine
from dynamo_tpu_torch.engine.config import tiny_model
from dynamo_tpu_torch.engine.convert import params_from_numpy
from dynamo_tpu_torch.runtime.engine import Context

_RNG = np.random.default_rng(1)
REQUESTS = [
    (f"r{i}", [int(t) for t in _RNG.integers(1, 384, n)], m)
    for i, (n, m) in enumerate([(12, 9), (45, 16), (7, 5), (70, 12)])
]
CANCELLED = "r1"


async def _serve(engine, make_context):
    async def one(rid, prompt, max_tokens):
        ctx = make_context(rid)
        req = {
            "model": "tiny", "token_ids": prompt, "request_id": rid,
            "sampling": {"temperature": 0.0}, "stop": {"max_tokens": max_tokens},
        }
        chunks = []
        async for out in engine.generate(req, ctx):
            chunks.append((out["token_ids"], out.get("finish_reason")))
            if rid == CANCELLED:
                ctx.stop_generating()
        return rid, chunks

    done = await asyncio.wait_for(
        asyncio.gather(*(one(*r) for r in REQUESTS)), timeout=120
    )
    return dict(done)


async def _clear(engine, make_context):
    return [out async for out in engine.generate({"clear_kv_blocks": True}, make_context("c"))]


def test_facade_matches_tpu_engine():
    jparams = jmodel.init_params(jax.random.PRNGKey(3), j_tiny_model())
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tiny_model())
    jax_engine = TpuEngine(JaxCore(j_tiny_model(), j_tiny_engine(), params=jparams))
    core, torch_engine = build_engine("tiny", device="cpu", params=tparams)

    want = asyncio.run(_serve(jax_engine, JaxContext))
    got = asyncio.run(_serve(torch_engine, Context))
    assert got == want
    # Clearing the prefix cache drops the same unpinned blocks on both.
    want_clear = asyncio.run(_clear(jax_engine, JaxContext))
    got_clear = asyncio.run(_clear(torch_engine, Context))
    assert got_clear == want_clear and got_clear[0]["cleared_blocks"] > 0
    assert len(got[CANCELLED]) == 1  # stopped after its first chunk
    for rid, _, max_tokens in REQUESTS:
        if rid != CANCELLED:
            assert sum(len(t) for t, _ in got[rid]) == max_tokens
            assert got[rid][-1][1] == "length"
    assert not core.has_work() or all(s.cancelled for s in core.running)


def test_facade_refuses_embeddings():
    _, engine = build_engine("tiny", device="cpu")

    async def go():
        async for _ in engine.generate({"embed": True, "token_ids": [1, 2]}, Context()):
            pass

    with pytest.raises(ValueError, match="A11"):
        asyncio.run(go())
