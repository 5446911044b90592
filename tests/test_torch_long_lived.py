"""A long-lived engine serves as a fresh one does, and a model the card's
attention kernel cannot run is refused before its engine is built.

The first: a ``tiny`` f32 engine runs, in ``chip_smoke.py``'s order, the
kinds of work the smoke's bf16 sub-phases do to or beside the main
engine: its sync and async passes, a megastep body run eagerly from a
saved cache, engines built on its ``params`` (k = 1, chunked, speculating
and tiered), the page programs, ``embed()`` and an image request; then,
its prefix cache cleared, its greedy solo stream (tokens and
log-probabilities) must equal a fresh engine's on the same weights,
exactly, and its weights must be unchanged. At f32 a near-tie is
unlikely, so a difference would be state that some phase left behind.
Through the async facade the two engines' chunks are equal but for the
engine step the first chunk names (``meta.iteration``), a count of each
engine's life: what a whole-chunk comparison of a long-lived engine
against a fresh worker trips on.

The second: on ``cuda`` the configs alone (no card needed) say which
models K1 serves: the f32 tiny presets, head_dim 96 and groups above 8
through its generic instance; a model no instance runs (head_dim 264,
query heads that are not whole groups) raises a ``ValueError`` that says
why before its engine is built. The JAX package serves such models
through its plain reference.
"""

import asyncio
import dataclasses

import numpy as np
import pytest
import torch

from dynamo_tpu_torch.backends.torch import main as worker_main
from dynamo_tpu_torch.backends.torch.main import build_engine, engine_configs
from dynamo_tpu_torch.engine.config import PRESETS, tiny_engine, tiny_model
from dynamo_tpu_torch.engine.core import check_slice
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.llm.multimodal import MM_PATCHES, image_bytes, patch_embed, pseudo_tokens
from dynamo_tpu_torch.llm.protocols.common import PreprocessedRequest
from dynamo_tpu_torch.runtime.engine import Context

SOLO_LEN, SOLO_TOKENS = 120, 32
IMG = "data:application/octet-stream;base64," + __import__("base64").b64encode(
    b"a cat sitting on a red mat" * 9).decode()


def _wire(rid, prompt, max_tokens, logprobs=None, temperature=0.0, seed=None):
    req = {"model": "tiny", "token_ids": list(prompt), "request_id": rid,
           "sampling": {"temperature": temperature, **({"seed": seed} if seed else {})},
           "stop": {"max_tokens": max_tokens, "ignore_eos": True}}
    if logprobs:
        req["output"] = {"logprobs": logprobs}
    return req


def _run(core, reqs) -> dict:
    """Requests added together to a synchronous engine and stepped to the end."""
    out = {r["request_id"]: {"tokens": [], "logprobs": []} for r in reqs}
    for r in reqs:
        core.add_request(PreprocessedRequest.from_wire(r))
    while core.has_work():
        for s, o in core.step():
            out[s.request_id]["tokens"] += o.token_ids
            out[s.request_id]["logprobs"] += o.logprobs or []
    return out


def _prompts(n, lo, hi, seed, vocab=384):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, vocab, int(rng.integers(lo, hi)))] for _ in range(n)]


SOLO = _prompts(1, SOLO_LEN, SOLO_LEN + 1, 2000)[0]


def _solo(core) -> dict:
    core.clear_kv_cache()
    return _run(core, [_wire("solo", SOLO, SOLO_TOKENS, logprobs=2)])["solo"]


async def _passes(engine, reqs):
    async def one(r):
        return [o async for o in engine.generate(r, Context(r["request_id"]))]

    return await asyncio.gather(*(one(r) for r in reqs))


def _sync_and_async(core):
    reqs = [_wire(f"p{i}", p, 24, temperature=0.8 if i == 2 else 0.0, seed=7 if i == 2 else None)
            for i, p in enumerate(_prompts(6, 20, 200, 1))]
    for flag in (False, True):
        core.engine = dataclasses.replace(core.engine, async_exec=flag)
        core.clear_kv_cache()
        asyncio.run(_passes(TorchEngine(core), reqs))
    core.engine = dataclasses.replace(core.engine, async_exec=False)


def _eager_megastep(core):
    """One decode megastep's body run from a saved cache, as the smoke's
    graph-against-eager check runs it, then the lanes cancelled."""
    for i, p in enumerate(_prompts(8, 10, 30, 3)):
        core.add_request(PreprocessedRequest.from_wire(_wire(f"g{i}", p, 24)))
    for _ in range(16):
        core.step()
        ready = core._decode_candidates()
        if len(ready) == 8 and core._inflight is None:
            break
    assert len(ready) == 8
    core._grow_or_preempt(ready, 8)
    launch = core._megastep_launch(ready, 8)
    saved = [c.clone() for c in core.cache]
    for _ in range(2):
        launch.body(torch.from_numpy(launch.packed))
        for c, s in zip(core.cache, saved):
            c.copy_(s)
    for seq in ready:
        core.cancel_request(seq)
    while core.has_work():
        core.step()


def _engines_on_params(core, tmp_path):
    params = core.params
    traffic = [_wire(f"e{i}", p, 20) for i, p in enumerate(_prompts(5, 30, 220, 4))]
    quoting = [_wire(f"q{i}", (p * 4)[:160], 30) for i, p in enumerate(_prompts(4, 8, 20, 5))]
    k1, _ = build_engine("tiny", {"megastep_k": 1}, device="cpu", params=params)
    _run(k1, traffic[:2])
    chunked, _ = build_engine("tiny", {"scheduling": "chunked", "prefill_chunk": 32},
                              device="cpu", params=params)
    _run(chunked, traffic)
    _run(core, traffic)
    spec, _ = build_engine("tiny", {"spec_decode": "ngram", "spec_k": 4,
                                    "spec_device_draft": True}, device="cpu", params=params)
    _run(spec, quoting)
    _run(core, [dict(q, output={"logprobs": 2}) for q in quoting])
    tiers, _ = build_engine("tiny", {"num_kv_blocks": 24, "host_kv_blocks": 16,
                                     "disk_kv_dir": str(tmp_path / "disk")},
                            device="cpu", params=params)
    long = _prompts(4, 100, 101, 6)
    for rnd in range(2):
        for i, p in enumerate(long):
            _run(tiers, [_wire(f"t{rnd}{i}", p, 8)])
            _run(core, [_wire(f"c{rnd}{i}", p, 8)])
    tiers.offload.flush()
    assert sum(st["onboards"] for st in tiers.tier_stats().values()) > 0
    tiers.offload.close()


def _page_programs(core):
    core.clear_kv_cache()
    for n in (1, 8):
        src, dst = list(range(n)), list(range(n, 2 * n))
        dev = core._gather_pages(src)
        core._scatter_pages(dst, dev)
        core._copy_pages_from(core, src, dst)
        core._scatter_pages(dst, dev.cpu())
    core._slice_page(0)


def _embed_and_image(core):
    core.embed(_prompts(1, 90, 91, 7)[0])
    cfg = core.cfg
    text = _prompts(1, 48, 49, 8)[0]
    toks = text[:40] + pseudo_tokens(IMG, cfg.vocab_size) + text[40:]
    emb = patch_embed(image_bytes(IMG), cfg.hidden_size)
    req = _wire("img", toks, 16, logprobs=2)
    req["mm"] = {"images": [IMG], "positions": [[40, MM_PATCHES]], "embeds": emb.tobytes(),
                 "embeds_shape": list(emb.shape)}
    _run(core, [req])


def test_long_lived_engine_streams_as_a_fresh_one(tmp_path):
    core, _ = build_engine("tiny", device="cpu", seed=0)
    fresh, _ = build_engine("tiny", device="cpu", seed=0)
    want = _solo(fresh)
    assert _solo(core) == want  # the same engine just after it is built
    weights = {k: v.clone() for k, v in core.params["layers"].items()}
    phases = [("sync and async passes", _sync_and_async),
              ("a megastep body from a saved cache", _eager_megastep),
              ("engines on its params", lambda c: _engines_on_params(c, tmp_path)),
              ("page programs", _page_programs),
              ("embed() and an image request", _embed_and_image)]
    for name, phase in phases:
        phase(core)
        got = _solo(core)
        assert got["tokens"] == want["tokens"], f"the solo stream parted after {name}"
        assert got["logprobs"] == want["logprobs"], f"log-probabilities moved after {name}"
    for k, v in core.params["layers"].items():
        assert torch.equal(v, weights[k]), k
        assert torch.equal(v, fresh.params["layers"][k]), k
    # Through the facade a worker serves with, chunk for chunk: the
    # chunks are equal but for the engine step the first one names, which
    # counts the engine's whole life (the long-lived one has stepped
    # through every phase above).
    got, want = (_facade_chunks(c) for c in (core, _fresh_engine()))
    assert _without_iteration(got) == _without_iteration(want)
    assert got[0]["meta"]["iteration"] > want[0]["meta"]["iteration"]


def _fresh_engine():
    return build_engine("tiny", device="cpu", seed=0)[0]


def _facade_chunks(core) -> list[dict]:
    core.clear_kv_cache()
    req = _wire("facade", SOLO, SOLO_TOKENS, logprobs=1)
    return asyncio.run(_passes(TorchEngine(core), [req]))[0]


def _without_iteration(chunks):
    return [{**c, "meta": {k: v for k, v in c.get("meta", {}).items() if k != "iteration"}}
            for c in chunks]


# -- the card's attention kernel: fast instances, the generic one, refusals --

REFUSED = {
    "bf16-head264": ("head_dim 264",),
    "bf16-head100": ("head_dim 100",),
    "partial-group": ("32 query heads over 3 KV heads",),
}


def _model(name):
    if name in PRESETS:
        return PRESETS[name]()
    base = PRESETS["llama3-1b"]()
    return {"bf16-head96": dataclasses.replace(base, head_dim=96),
            "bf16-head64": dataclasses.replace(base, head_dim=64),
            "f32-head128": dataclasses.replace(base, dtype="float32"),
            "group16": dataclasses.replace(base, num_heads=32, num_kv_heads=2),
            "bf16-head264": dataclasses.replace(base, head_dim=264),
            "bf16-head100": dataclasses.replace(base, head_dim=100),
            "partial-group": dataclasses.replace(base, num_heads=32, num_kv_heads=3)}[name]


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_model_k1_cannot_run_refused_on_cuda(name):
    cfg = _model(name)
    with pytest.raises(ValueError, match="cannot run on the card's attention kernel") as err:
        check_slice(cfg, tiny_engine(), device="cuda")
    for why in REFUSED[name]:
        assert why in str(err.value)
    check_slice(cfg, tiny_engine(), device="cpu")  # the plain versions serve it


@pytest.mark.parametrize("preset", ["llama3-8b", "llama3-1b", "qwen2-7b", "mixtral-8x7b", "tiny",
                                    "tiny-moe"])
def test_models_k1_runs_pass_on_cuda(preset):
    check_slice(*engine_configs(preset), device="cuda")


def test_head_dim64_passes_on_cuda():
    """K1 has a head_dim-64 instance: a bf16 model at head_dim 64 is served."""
    check_slice(_model("bf16-head64"), tiny_engine(), device="cuda")


@pytest.mark.parametrize("name", ["bf16-head96", "f32-head128", "group16"])
def test_generic_instance_models_pass_on_cuda(name):
    """Models the fast instances do not take (head_dim 96, f32, a group of
    16) pass: K1's generic instance runs them."""
    cfg = _model(name)
    check_slice(cfg, tiny_engine(), device="cuda")
    from dynamo_tpu_torch.ops import ragged_attention as ra

    assert "generic" in ra.k1_instance(cfg.torch_dtype, False, cfg.head_dim,
                                       cfg.num_heads // cfg.num_kv_heads)


def test_refused_before_the_engine_is_built(monkeypatch):
    """With a card present, ``build_engine`` refuses a model no K1 instance
    runs (the tiny preset at head_dim 264) before drawing a weight, and the
    worker's CLI before joining the fleet."""
    drawn = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(worker_main, "init_params_quantized", lambda *a: drawn.append(a))
    monkeypatch.setattr(worker_main, "EngineCore", lambda *a, **k: drawn.append(a))
    monkeypatch.setitem(PRESETS, "tiny", lambda: dataclasses.replace(tiny_model(), head_dim=264))
    with pytest.raises(ValueError, match="head_dim 264"):
        build_engine("tiny")
    with pytest.raises(ValueError, match="head_dim 264"):
        build_engine("tiny", quant="int8")
    with pytest.raises(ValueError, match="head_dim 264"):
        worker_main.main(["--model-name", "t", "--preset", "tiny"])
    assert not drawn
