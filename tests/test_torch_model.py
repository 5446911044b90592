"""The port's dense forward against the JAX package's, on converted weights.

The JAX tiny model (f32) is initialised once, its params pytree carried
across with ``engine/convert.py``, and the same ragged operands go through
both ``forward_tokens`` / ``decode_tokens``: a prefill chunk, a chunked
continuation, then decode steps. Logits agree at atol = rtol = 1e-4 (f32
sums are taken in a different order, and the error compounds over layers);
the written cache pages at 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import model as jmodel
from dynamo_tpu.engine.config import tiny_engine as j_tiny_engine
from dynamo_tpu.engine.config import tiny_model as j_tiny_model
from dynamo_tpu_torch.engine import model as tmodel
from dynamo_tpu_torch.engine.config import tiny_engine, tiny_model
from dynamo_tpu_torch.engine.convert import cache_from_numpy, params_from_numpy
from dynamo_tpu_torch.ops import ragged_attention as ra
from tests.model_harness import prefill_chunk

VARIANTS = {
    "tiny": {},
    "untied_qkv_bias": {"tie_embeddings": False, "attn_qkv_bias": True},
}


def _port_prefill_chunk(params, cache, chunk, start_pos, block_ids, cfg, eng, bucket):
    """The operands of tests/model_harness.prefill_chunk, through the port."""
    n = len(chunk)
    bs = eng.block_size
    ids = np.asarray(block_ids, np.int32)
    tokens = np.zeros(bucket, np.int32)
    tokens[:n] = chunk
    positions = np.zeros(bucket, np.int32)
    pos = np.arange(start_pos, start_pos + n, dtype=np.int32)
    positions[:n] = pos
    write_pages = np.full(bucket, eng.garbage_block, np.int32)
    write_pages[:n] = ids[pos // bs]
    write_offs = np.zeros(bucket, np.int32)
    write_offs[:n] = pos % bs
    table = np.full((1, eng.max_blocks_per_seq), eng.garbage_block, np.int32)
    table[0, : len(ids)] = ids
    ops = [
        tokens, positions, write_pages, write_offs,
        np.array([start_pos + n], np.int32), table, np.array([0, n], np.int32),
        np.array([1], np.int32), np.array([n - 1], np.int32),
    ]
    logits = tmodel.forward_tokens(params, cache, *map(torch.from_numpy, ops), cfg)
    return logits[0]


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_matches_jax(variant):
    jcfg = dataclasses.replace(j_tiny_model(), **VARIANTS[variant])
    tcfg = dataclasses.replace(tiny_model(), **VARIANTS[variant])
    jeng, teng = j_tiny_engine(), tiny_engine()
    jparams = jmodel.init_params(jax.random.PRNGKey(7), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg)
    assert ("lm_head" in tparams) == (not tcfg.tie_embeddings)
    assert ("bqkv" in tparams["layers"]) == tcfg.attn_qkv_bias
    jcache = jmodel.init_cache(jcfg, jeng)
    tcache = cache_from_numpy(tuple(np.asarray(c) for c in jcache))
    launches = ra.launches

    rng = np.random.default_rng(11)
    prompt = [int(t) for t in rng.integers(1, jcfg.vocab_size, 37)]
    blocks = [5, 2, 9, 0, 7, 3]  # scattered physical pages, 8 tokens each

    # Prefill chunk, then a chunked continuation of the same sequence.
    for start, stop, bucket in ((0, 20, 32), (20, 37, 32)):
        want, jcache = prefill_chunk(
            jparams, jcache, prompt[start:stop], start, blocks, jcfg, jeng, bucket
        )
        got = _port_prefill_chunk(
            tparams, tcache, prompt[start:stop], start, blocks, tcfg, teng, bucket
        )
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)

    # Decode: one live lane plus one padded lane, three steps.
    table = np.full((2, jeng.max_blocks_per_seq), jeng.garbage_block, np.int32)
    table[0, : len(blocks)] = blocks
    active = np.array([True, False])
    for step, tok in enumerate([17, 250, 3]):
        toks = np.array([tok, 0], np.int32)
        pos = np.array([37 + step, 0], np.int32)
        want, jcache = jmodel.decode_tokens(
            jparams, jcache, jnp.asarray(toks), jnp.asarray(table), jnp.asarray(pos),
            jnp.asarray(active), jcfg, jeng,
        )
        got = tmodel.decode_tokens(
            tparams, tcache, *map(torch.from_numpy, (toks, table, pos, active)),
            tcfg, teng,
        )
        np.testing.assert_allclose(
            got[0].numpy(), np.asarray(want)[0], atol=1e-4, rtol=1e-4
        )

    for l in range(jcfg.num_layers):
        written = np.asarray(jcache[l])[blocks]  # the sequence's real pages
        np.testing.assert_allclose(tcache[l][blocks].numpy(), written, atol=1e-5, rtol=1e-5)
    assert ra.launches == launches


def test_building_blocks_match():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5, 3, 16)).astype(np.float32)
    pos = np.array([0, 3, 9, 100, 4097], np.int32)
    jc, js = jmodel.rope_tables(jnp.asarray(pos), 16, 500000.0)
    tc, ts = tmodel.rope_tables(torch.from_numpy(pos), 16, 500000.0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        tmodel.rope_apply(torch.from_numpy(x), tc, ts).numpy(),
        np.asarray(jmodel.rope_apply(jnp.asarray(x), jc, js)),
        atol=1e-5, rtol=1e-5,
    )
    h = rng.standard_normal((4, 32)).astype(np.float32)
    w = rng.standard_normal(32).astype(np.float32)
    np.testing.assert_allclose(
        tmodel.rms_norm(torch.from_numpy(h), torch.from_numpy(w), 1e-5).numpy(),
        np.asarray(jmodel.rms_norm(jnp.asarray(h), jnp.asarray(w), 1e-5)),
        atol=1e-5, rtol=1e-5,
    )
    wq, wk, wv = (rng.standard_normal((8, n)).astype(np.float32) for n in (8, 4, 4))
    fused = tmodel.fuse_qkv(*map(torch.from_numpy, (wq, wk, wv)))
    np.testing.assert_array_equal(
        fused.numpy(), np.asarray(jmodel.fuse_qkv(*map(jnp.asarray, (wq, wk, wv))))
    )
    cfg = dataclasses.replace(tiny_model(), num_heads=2, num_kv_heads=1, head_dim=4)
    q, k, v = tmodel.split_qkv(fused, cfg)
    np.testing.assert_array_equal(torch.cat([q, k, v], -1).numpy(), np.concatenate([wq, wk, wv], -1))
    wg, wu = (rng.standard_normal((8, 6)).astype(np.float32) for _ in range(2))
    gu = tmodel.fuse_gu(torch.from_numpy(wg), torch.from_numpy(wu))
    np.testing.assert_array_equal(gu.numpy(), np.asarray(jmodel.fuse_gu(jnp.asarray(wg), jnp.asarray(wu))))
    g, u = tmodel.split_gu(gu)
    np.testing.assert_array_equal(g.numpy(), wg)
    np.testing.assert_array_equal(u.numpy(), wu)


def test_bf16_params_convert_bit_exact():
    cfg = dataclasses.replace(j_tiny_model(), dtype="bfloat16")
    jparams = jax.tree.map(np.asarray, jmodel.init_params(jax.random.PRNGKey(1), cfg))
    tparams = params_from_numpy(jparams, dataclasses.replace(tiny_model(), dtype="bfloat16"))
    assert tparams["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tparams["layers"]["wqkv"].view(torch.int16).numpy(),
        jparams["layers"]["wqkv"].view(np.int16),
    )
