"""int8 KV pages and int8 weights: the port against the JAX package.

- ``quantize_kv`` / ``quantize_weight``: int8 bytes and f32 scales are
  IDENTICAL to the JAX functions as XLA compiles them (the engine runs
  them compiled), and the packed page format round-trips between the two
  packages byte for byte.
- ``write_kv`` on an int8 layer: the same rows give byte-identical int8
  pages and scales.
- Whole forwards on the tiny preset (f32) with int8 KV, int8 weights and
  both: logits at atol = rtol = 1e-4, as test_torch_model.py holds the
  bf16 forward (f32 sums in another order; measured 3e-6). A K/V element
  may flip by one int8 step where the f32 projections of XLA and torch
  round differently near a half step, so the written pages are held to
  one step, on fewer than 0.1% of elements.
- Greedy token streams and prefix hits IDENTICAL to the JAX ``EngineCore``
  at ``kv_dtype="int8"``, at megastep k=1 and k=8 and under preemption.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import EngineCore as JaxCore
from dynamo_tpu.engine import kv_quant as jkvq
from dynamo_tpu.engine import model as jmodel
from dynamo_tpu.engine.config import tiny_engine as j_tiny_engine
from dynamo_tpu.engine.config import tiny_model as j_tiny_model
from dynamo_tpu.llm.protocols.common import PreprocessedRequest as JaxRequest
from dynamo_tpu_torch.backends.torch.main import build_engine
from dynamo_tpu_torch.engine import kv_quant as tkvq
from dynamo_tpu_torch.engine import model as tmodel
from dynamo_tpu_torch.engine.config import tiny_engine, tiny_model
from dynamo_tpu_torch.engine.convert import cache_from_numpy, params_from_numpy
from dynamo_tpu_torch.llm.protocols.common import PreprocessedRequest
from dynamo_tpu_torch.ops import ragged_attention as ra
from tests.model_harness import prefill_chunk
from tests.test_torch_engine_core import LATE, SPECS, drive
from tests.test_torch_model import _port_prefill_chunk

LOGIT_TOL = 1e-4


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _rows(seed, shape, dtype):
    """K/V-like rows with per-row magnitudes from 1e-2 to 10 and one zero row."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * rng.uniform(0.01, 10, shape[:-1] + (1,))
    x[(0,) * (len(shape) - 1)] = 0.0
    j = jnp.asarray(x.astype(np.float32)).astype(dtype)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    )
    return j, t


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
def test_quantize_kv_bytes_match_jax(dtype):
    L, bs, n_kv, d = 10, 16, 2, 128
    j, t = _rows(0, (L, bs, 2 * n_kv, d), dtype)
    jq, js = jax.jit(jkvq.quantize_kv)(j)
    tq, ts = tkvq.quantize_kv(t)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_bits(ts.numpy()), _bits(js))
    np.testing.assert_array_equal(
        _bits(tkvq.dequantize_kv(tq, ts).numpy()), _bits(jkvq.dequantize_kv(jq, js))
    )
    # Packed pages: the port's tensors pack to JAX's bytes and unpack back.
    kv, sc = tq.numpy(), ts.numpy()
    buf = tkvq.pack_kv_page(kv, sc)
    assert buf.tobytes() == jkvq.pack_kv_page(np.asarray(jq), np.asarray(js)).tobytes()
    kv2, sc2 = jkvq.unpack_kv_page(buf.tobytes(), L, bs, n_kv, d)
    assert kv2.tobytes() == kv.tobytes() and sc2.tobytes() == sc.tobytes()
    assert tkvq.kv_page_bytes(L, bs, n_kv, d, "int8") == buf.size


@pytest.mark.parametrize("shape", [(16, 24), (3, 64, 40)], ids=["2d", "stacked"])
def test_quantize_weight_matches_jax(shape):
    j, t = _rows(1, shape, jnp.bfloat16)
    want = jax.jit(jmodel.quantize_weight)(j)
    got = tmodel.quantize_weight(t)
    np.testing.assert_array_equal(got["w"].numpy(), np.asarray(want["w"]))
    np.testing.assert_array_equal(_bits(got["scale"].numpy()), _bits(want["scale"]))
    # quantize_params quantizes stacked weights one layer at a time: the
    # same scales as the whole-tensor call.
    cfg = j_tiny_model()
    jparams = jmodel.init_params(jax.random.PRNGKey(5), dataclasses.replace(cfg, tie_embeddings=False))
    jq = jax.jit(jmodel.quantize_params)(jparams)
    tq = tmodel.quantize_params(
        params_from_numpy(jax.tree.map(np.asarray, jparams), dataclasses.replace(tiny_model(), tie_embeddings=False), device="cpu")
    )
    for name in ("wqkv", "wo", "wgu", "w_down"):
        for k in ("w", "scale"):
            np.testing.assert_array_equal(
                _bits(tq["layers"][name][k].numpy()), _bits(jq["layers"][name][k]), err_msg=name
            )
    np.testing.assert_array_equal(tq["lm_head"]["w"].numpy(), np.asarray(jq["lm_head"]["w"]))


def test_init_params_quantized_layout_matches_jax():
    cfg = dataclasses.replace(tiny_model(), tie_embeddings=False, attn_qkv_bias=True)
    jcfg = dataclasses.replace(j_tiny_model(), tie_embeddings=False, attn_qkv_bias=True)
    want = jax.tree.map(np.asarray, jmodel.init_params_quantized(jax.random.PRNGKey(0), jcfg))
    want.pop("fuse_tp")
    got = tmodel.init_params_quantized(cfg, seed=0, device="cpu")
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, g), (_, w) in zip(flat_g, flat_w):
        assert tuple(g.shape) == w.shape, path
        assert str(g.dtype).split(".")[-1] == str(w.dtype), path
    # A tensor cannot tell: each quantized column really spans +-127.
    assert (got["layers"]["wgu"]["w"].abs().amax(dim=-2) == 127).all()


def test_write_kv_pages_match_jax():
    n_pages, bs, n_comb, d, T = 6, 8, 4, 16, 13
    j, t = _rows(2, (T, n_comb, d), jnp.float32)
    pages = np.array([3, 3, 1, 0, 4, 4, 4, 2, 1, 0, 3, 5, 5], np.int32)
    offs = np.array([0, 1, 7, 2, 5, 6, 7, 0, 3, 4, 2, 1, 0], np.int32)
    eng = j_tiny_engine(kv_dtype="int8", num_kv_blocks=n_pages - 1, block_size=bs)
    jcache = jmodel.init_cache(dataclasses.replace(j_tiny_model(), num_kv_heads=n_comb // 2, head_dim=d, num_layers=1), eng)
    want = jax.jit(jmodel.write_kv)(jcache[0], jnp.asarray(pages), jnp.asarray(offs), j)
    tcache = cache_from_numpy(jax.tree.map(np.asarray, jcache), device="cpu")
    got = tmodel.write_kv(tcache[0], torch.from_numpy(pages).long(), torch.from_numpy(offs).long(), t)
    assert got is tcache[0]  # in place
    np.testing.assert_array_equal(got["kv"].numpy(), np.asarray(want["kv"]))
    np.testing.assert_array_equal(_bits(got["scale"].numpy()), _bits(want["scale"]))


VARIANTS = {
    "int8_kv": ("int8", False),
    "int8_weights": ("bf16", True),
    "int8_kv_and_weights": ("int8", True),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_int8_matches_jax(variant):
    kv_dtype, quant = VARIANTS[variant]
    jcfg = dataclasses.replace(j_tiny_model(), tie_embeddings=False)
    tcfg = dataclasses.replace(tiny_model(), tie_embeddings=False)
    jeng, teng = j_tiny_engine(kv_dtype=kv_dtype), tiny_engine(kv_dtype=kv_dtype)
    jparams = jmodel.init_params(jax.random.PRNGKey(7), jcfg)
    if quant:
        jparams = jax.jit(jmodel.quantize_params)(jparams)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    assert isinstance(tparams["layers"]["wqkv"], dict) == quant
    jcache = jmodel.init_cache(jcfg, jeng)
    tcache = tmodel.init_cache(tcfg, teng, device="cpu")
    launches = (ra.launches, ra.launches_int8)

    rng = np.random.default_rng(11)
    prompt = [int(t) for t in rng.integers(1, jcfg.vocab_size, 37)]
    blocks = [5, 2, 9, 0, 7, 3]
    for start, stop, bucket in ((0, 20, 32), (20, 37, 32)):
        want, jcache = prefill_chunk(jparams, jcache, prompt[start:stop], start, blocks, jcfg, jeng, bucket)
        got = _port_prefill_chunk(tparams, tcache, prompt[start:stop], start, blocks, tcfg, teng, bucket)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL, rtol=LOGIT_TOL)
    table = np.full((2, jeng.max_blocks_per_seq), jeng.garbage_block, np.int32)
    table[0, : len(blocks)] = blocks
    active = np.array([True, False])
    for step, tok in enumerate([17, 250, 3]):
        toks, pos = np.array([tok, 0], np.int32), np.array([37 + step, 0], np.int32)
        want, jcache = jmodel.decode_tokens(
            jparams, jcache, jnp.asarray(toks), jnp.asarray(table), jnp.asarray(pos),
            jnp.asarray(active), jcfg, jeng,
        )
        got = tmodel.decode_tokens(tparams, tcache, *map(torch.from_numpy, (toks, table, pos, active)), tcfg, teng)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want)[0], atol=LOGIT_TOL, rtol=LOGIT_TOL)
    if kv_dtype == "int8":
        # The sequence's pages: every int8 element within one step of JAX's.
        for l in range(jcfg.num_layers):
            diff = tcache[l]["kv"][blocks].int() - torch.from_numpy(np.asarray(jcache[l]["kv"])[blocks]).int()
            assert diff.abs().max() <= 1
            assert (diff != 0).float().mean() < 1e-3
            np.testing.assert_allclose(tcache[l]["scale"][blocks].numpy(), np.asarray(jcache[l]["scale"])[blocks], rtol=1e-5)
    assert (ra.launches, ra.launches_int8) == launches


# -- the engine: greedy streams against the JAX EngineCore ------------------

def _wire(rid, prompt, max_tokens):
    return {
        "model": "tiny", "token_ids": list(prompt), "request_id": rid,
        "sampling": {"temperature": 0.0}, "stop": {"max_tokens": max_tokens},
    }


@pytest.fixture(scope="module")
def weights():
    jparams = jmodel.init_params(jax.random.PRNGKey(0), j_tiny_model())
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams), tiny_model(), device="cpu")


@pytest.fixture(scope="module")
def quant_weights(weights):
    jq = jax.jit(jmodel.quantize_params)(weights[0])
    return jq, params_from_numpy(jax.tree.map(np.asarray, jq), tiny_model(), device="cpu")


@pytest.mark.parametrize(
    "k, blocks, quant",
    [(1, 256, False), (8, 256, False), (8, 20, False), (8, 256, True)],
    ids=["k1", "k8", "k8_preempt", "k8_int8_weights"],
)
def test_int8_greedy_streams_match_jax(weights, quant_weights, k, blocks, quant):
    jparams, tparams = quant_weights if quant else weights
    eng = {"kv_dtype": "int8", "megastep_k": k, "num_kv_blocks": blocks}
    jcore = JaxCore(j_tiny_model(), j_tiny_engine(**eng), params=jparams)
    tcore, _ = build_engine("tiny", eng, device="cpu", params=tparams)
    assert isinstance(tcore.cache[0], dict) and tcore.cache[0]["kv"].dtype == torch.int8
    wires = [_wire(r, p, m) for r, p, m in SPECS]
    want = drive(jcore, wires, JaxRequest.from_wire)
    got = drive(tcore, wires, PreprocessedRequest.from_wire)
    assert got == want
    # A later request sharing the prefix reuses the cached int8 blocks alike.
    got_late = drive(tcore, [_wire(*LATE)], PreprocessedRequest.from_wire)
    assert got_late == drive(jcore, [_wire(*LATE)], JaxRequest.from_wire)
    assert got_late[2]["p3"] == 40
    assert tcore.sched_stats["preemptions"] == jcore.sched_stats["preemptions"]
    if blocks == 20:
        assert tcore.sched_stats["preemptions"] > 0
    jst, tst = jcore.kv_cache_stats(), tcore.kv_cache_stats()
    for key in ("kv_dtype", "kv_dtype_int8", "bytes_per_block", "admitted_hits", "prefix_hits"):
        assert tst[key] == jst[key], key
    assert tst["admitted_hits"] >= 1
