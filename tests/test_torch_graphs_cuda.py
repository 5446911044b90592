"""The engine's CUDA graphs against its eager bodies, on the card.

Every test here needs a CUDA card and skips without one. The file imports
neither jax nor the JAX package; ``tests/conftest.py`` imports jax, so on
a machine with only PyTorch run it without it::

    python -m pytest --noconftest -q -m cuda tests/test_torch_graphs_cuda.py

A small bf16 model with the kernels' head size (2 layers, 4 query and 2
KV heads of 128) serves a few greedy and seeded requests. A decode
megastep replayed from its graph gives the eager body's tokens on the same
cache and inputs, with bf16 and int8 pages; the attention kernel's launch
counters grow by layers x iterations on every replay; after ``warm_up()``
every dispatch is a replay of a graph it captured; and async execution
streams what the synchronous loop streams.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.core import EngineCore
from dynamo_tpu_torch.llm.protocols.common import PreprocessedRequest
from dynamo_tpu_torch.ops import ragged_attention as ra

pytestmark = [pytest.mark.cuda]

CFG = ModelConfig(
    name="card-small", vocab_size=512, hidden_size=256, intermediate_size=512,
    num_layers=2, num_heads=4, num_kv_heads=2, head_dim=128, rope_theta=10000.0,
)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graphs capture the CUDA kernels")


def _core(**eng) -> EngineCore:
    _card()
    engine = EngineConfig(
        num_kv_blocks=64, block_size=32, max_num_seqs=8, max_model_len=512,
        prefill_buckets=(64, 128, 512), decode_buckets=(4, 8), **eng,
    )
    return EngineCore(CFG, engine, seed=0, device="cuda")


def _requests(n=6):
    rng = np.random.default_rng(3)
    out = []
    for i in range(n):
        sampling = {"temperature": 0.0} if i % 2 == 0 else {"temperature": 0.9, "seed": i}
        out.append(PreprocessedRequest.from_wire({
            "model": "card-small", "request_id": f"r{i}",
            "token_ids": [int(t) for t in rng.integers(0, CFG.vocab_size, 20 + 13 * i)],
            "sampling": sampling, "stop": {"max_tokens": 24},
        }))
    return out


def _drive(core, requests):
    for r in requests:
        core.add_request(r)
    toks = {r.request_id: [] for r in requests}
    for _ in range(1000):
        for seq, out in core.step():
            toks[seq.request_id] += out.token_ids
        if not core.has_work():
            break
    return toks


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_replayed_megastep_equals_eager_body(kv_dtype):
    core = _core(kv_dtype=kv_dtype)
    core.warm_up()
    for r in _requests():
        core.add_request(r)
    core.step()  # the prefill wave: every sequence now has a pending token
    ready = core._decode_candidates()
    assert len(ready) == 6
    core._grow_or_preempt(ready, 8)
    launch = core._megastep_launch(ready, 8)
    saved = [{k: t.clone() for k, t in c.items()} if isinstance(c, dict) else c.clone()
             for c in core.cache]

    def restore():
        for c, s in zip(core.cache, saved):
            pairs = [(c[k], s[k]) for k in c] if isinstance(c, dict) else [(c, s)]
            for dst, src in pairs:
                dst.copy_(src)

    eager = launch.body(torch.from_numpy(launch.packed).cuda())
    eager_cache = [c["kv"].clone() if isinstance(c, dict) else c.clone() for c in core.cache]
    restore()
    assert launch.key in core._graphs  # warm_up() captured every key
    replayed = core._graphs.replay(launch)
    torch.cuda.synchronize()
    assert torch.equal(replayed[0], eager[0])
    for got, want in zip(core.cache, eager_cache):
        assert torch.equal(got["kv"] if isinstance(got, dict) else got, want)


def test_launch_counters_grow_on_replay():
    core = _core()
    core.warm_up()
    ra.reset_launches()
    replays = core._graphs.replays
    toks = _drive(core, _requests())
    st = core.scheduler_stats()
    assert all(len(t) == 24 for t in toks.values())
    assert st["graph_replays"] - replays == st["dispatches"] > 0
    assert ra.launches == CFG.num_layers * st["forwards"]
    assert min(ra.kernel_launches[ra.INSTANCE_NAMES[k, False, 128]] for k in ("decode", "tiled")) > 0


def test_async_streams_equal_sync_and_every_dispatch_replays():
    got = {}
    for async_exec in (False, True):
        core = _core(async_exec=async_exec)
        core.warm_up()
        captured = core._graphs.captures
        got[async_exec] = _drive(core, _requests())
        st = core.scheduler_stats()
        assert st["graph_replays"] == st["dispatches"]
        assert st["commits"] == st["dispatches"]
        assert st["graph_captures"] == captured  # warm_up() captured every key
    assert got[True] == got[False]


def test_first_use_capture_on_a_fresh_thread():
    """The worker steps the engine on an executor thread: a key first seen
    there (here every key: the engine is not warmed up) is captured there,
    its cuBLAS handles made first, outside the capture, and streams what
    the main thread's graphs stream."""
    want = _drive(_core(), _requests())
    core = _core()
    with ThreadPoolExecutor(1) as pool:
        got = pool.submit(_drive, core, _requests()).result()
    assert core._graphs.captures > 0
    assert got == want
