"""The port's embeddings path against the JAX package's, on the CPU.

``EngineCore.embed`` runs one forward over a prompt padded to a prefill
bucket (``model.embed_forward``) on a scratch paged cache of its own and
mean-pools the final-norm hidden states of the prompt's rows. On weights
carried across by ``engine/convert.py`` its vectors agree with the JAX
engine's on the dense and MoE tiny presets, at bucket edges and with int8
KV pages (the scratch pages stay in the model dtype on both); the vector
is the mean of the prompt's prefill hidden states; and the serving
cache, the allocator and a request's stream are untouched by it.

Tolerance: f32 on both sides, sums in other orders, within 1e-5.
"""

import jax
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import EngineCore as JaxCore
from dynamo_tpu.engine import model as jmodel
from dynamo_tpu.engine.config import tiny_engine as j_tiny_engine
from dynamo_tpu.engine.config import tiny_model as j_tiny_model
from dynamo_tpu.engine.config import tiny_moe as j_tiny_moe
from dynamo_tpu_torch.backends.torch.main import build_engine
from dynamo_tpu_torch.engine import model as tmodel
from dynamo_tpu_torch.engine.config import tiny_model, tiny_moe
from dynamo_tpu_torch.engine.convert import params_from_numpy
from dynamo_tpu_torch.llm.protocols.common import PreprocessedRequest

EMBED_TOL = 1e-5
PRESETS = {"tiny": (j_tiny_model, tiny_model), "tiny-moe": (j_tiny_moe, tiny_moe)}


def _pair(preset: str, seed: int = 0, **eng):
    jcfg, tcfg = (f() for f in PRESETS[preset])
    jparams = jmodel.init_params(jax.random.PRNGKey(seed), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    jcore = JaxCore(jcfg, j_tiny_engine(**eng), params=jparams)
    tcore, _ = build_engine(preset, eng, device="cpu", params=tparams)
    return jcore, tcore


@pytest.mark.parametrize("preset", list(PRESETS))
@pytest.mark.parametrize("n", [1, 5, 32, 100, 128])
def test_embed_matches_jax(preset, n):
    """Prompts of 1 token to the largest prefill bucket, one of them
    exactly a bucket (32), through both engines' ``embed``."""
    jcore, tcore = _pair(preset, seed=n)
    prompt = [int(t) for t in np.random.default_rng(n).integers(1, 384, n)]
    got = tcore.embed(prompt)
    assert got.shape == (tcore.cfg.hidden_size,) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(jcore.embed(prompt)), atol=EMBED_TOL,
                               rtol=EMBED_TOL)


def test_embed_with_int8_kv_pages_matches_jax():
    """With int8 KV pages the embedding's scratch pages stay in the model
    dtype, on both sides."""
    jcore, tcore = _pair("tiny", seed=4, kv_dtype="int8")
    prompt = list(range(3, 50))
    np.testing.assert_allclose(tcore.embed(prompt), np.asarray(jcore.embed(prompt)),
                               atol=EMBED_TOL, rtol=EMBED_TOL)
    assert tcore._embed_scratch[0].dtype == torch.float32


def test_embed_is_the_mean_pooled_prefill_hidden_state():
    """The vector is the mean over the prompt's rows of the final hidden
    states of the same prompt's prefill (``forward_hidden``)."""
    core, _ = build_engine("tiny", device="cpu", seed=2)
    prompt = [int(t) for t in np.random.default_rng(2).integers(1, 384, 45)]
    n, bs, eng = len(prompt), core.engine.block_size, core.engine
    cache = tmodel.init_cache(core.cfg, eng, "cpu")
    i32 = lambda a: torch.tensor(a, dtype=torch.int32)  # noqa: E731
    table = list(range(-(-n // bs))) + [eng.garbage_block] * (eng.max_blocks_per_seq - (-(-n // bs)))
    x = tmodel.forward_hidden(
        core.params, cache, i32(prompt), i32(list(range(n))), i32([p // bs for p in range(n)]),
        i32([p % bs for p in range(n)]), i32([n]), i32([table]), i32([0, n]), i32([1]), core.cfg,
    )
    np.testing.assert_allclose(core.embed(prompt), x.mean(dim=0).numpy(), atol=EMBED_TOL,
                               rtol=EMBED_TOL)


def test_embed_leaves_the_serving_cache_untouched():
    """An embedding between a request's steps changes neither the
    serving cache's pages, nor the allocator, nor the request's stream."""
    wire = {"model": "tiny", "token_ids": list(range(2, 40)), "request_id": "r",
            "sampling": {"temperature": 0.0}, "stop": {"max_tokens": 8}}

    def run(embed_between: bool):
        core, _ = build_engine("tiny", device="cpu", seed=1)
        core.add_request(PreprocessedRequest.from_wire(wire))
        toks = [t for _, o in core.step() for t in o.token_ids]
        if embed_between:
            pages = [c.clone() for c in core.cache]
            free = core.allocator.free_blocks
            core.embed(list(range(5, 120)))
            assert all(torch.equal(a, b) for a, b in zip(pages, core.cache))
            assert core.allocator.free_blocks == free
        while core.has_work():
            toks += [t for _, o in core.step() for t in o.token_ids]
        return toks

    assert run(True) == run(False)


def test_embed_refuses_an_empty_prompt():
    core, _ = build_engine("tiny", device="cpu")
    with pytest.raises(ValueError, match="empty input"):
        core.embed([])
