"""Models at head_dim 64 (Llama-3.2-1B's published 32 x 64 heads,
TinyLlama, Qwen2.5-0.5B, SmolLM2) in the port against the JAX package.

The JAX package serves them through its XLA reference attention; the port
has K1 instances at head_dim 64 on the card and its plain version on the
CPU. Here, on the CPU: the plain ragged attention at head_dim 64 against
JAX's reference (f32, bf16-layout and int8 pages, atol = rtol = 1e-5: the
same masked softmax, sums in another order) and the plain version of the
tiled kernel's arithmetic at head_dim 64; a llama checkpoint at a cut
width (2 layers, 4 query heads over 2 KV heads of 64, tied embeddings,
Llama-3.2-1B's rope theta) written from a seed, whose config both
packages read alike, whose f32 logits equal the JAX forward's within 1e-4,
and whose bf16 engine streams the JAX engine's greedy tokens up to the
near-ties of ``tests/test_torch_loader.py``; and the card's slice check,
which reads configs alone: head_dim 64 and 128 pass, and so do the
shapes K1's generic instance takes (head_dim 96, 16 and 256, a GQA group
above 8, f32); head dims no instance runs (100, 264) are refused by name.
"""

import asyncio
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.torch import save_file

from dynamo_tpu.backends.jax.main import build_engine as jax_build_engine
from dynamo_tpu.engine import loader as jloader
from dynamo_tpu.engine import model as jmodel
from dynamo_tpu.engine.config import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.kv_quant import quantize_kv
from dynamo_tpu.ops.ragged_attention import ragged_paged_attention_ref as jax_ref
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.backends.torch.main import build_engine
from dynamo_tpu_torch.engine import loader as tloader
from dynamo_tpu_torch.engine.config import ModelConfig, tiny_engine
from dynamo_tpu_torch.engine.core import check_slice
from dynamo_tpu_torch.ops import ragged_attention as ra
from dynamo_tpu_torch.runtime.engine import Context
from tests.model_harness import prefill_chunk
from tests.test_torch_loader import ENGINE, _held_to_near_ties, _port_logits, _streams
from tests.test_torch_ragged_attention import CASES as ATTENTION_CASES
from tests.test_torch_ragged_attention import check_tiled_arithmetic

HD = 64
# JAX's reference compiled once per case's shapes (op by op it takes seconds a case).
_jax_ref = jax.jit(jax_ref, static_argnames=("sm_scale",))


def _attention_batch(q_lens, kv_lens, S, pps, n_q, n_kv, seed, page=4):
    rng = np.random.default_rng(seed)
    n_pages = S * pps + 1
    T = sum(q_lens) + 3
    q = rng.standard_normal((T, n_q, HD)).astype(np.float32)
    kv = rng.standard_normal((n_pages, page, 2 * n_kv, HD)).astype(np.float32)
    perm = rng.permutation(n_pages - 1).astype(np.int32)
    tables = np.full((S, pps), n_pages - 1, np.int32)
    off = 0
    for s, L in enumerate(kv_lens):
        npg = -(-L // page)
        tables[s, :npg] = perm[off : off + npg]
        off += npg
    lens = np.zeros(S, np.int32)
    lens[: len(kv_lens)] = kv_lens
    cu = np.zeros(S + 1, np.int32)
    cu[1 : len(q_lens) + 1] = np.cumsum(q_lens)
    cu[len(q_lens) + 1 :] = cu[len(q_lens)]
    return q, kv, lens, tables, cu, np.array([len(q_lens)], np.int32)


@pytest.mark.parametrize("pages", ["bf16", "int8"])
@pytest.mark.parametrize("case", list(ATTENTION_CASES))
def test_plain_attention_matches_jax_at_head_dim64(case, pages):
    q, kv, lens, tables, cu, ns = _attention_batch(*ATTENTION_CASES[case], seed=7)
    kw_j, kw_t = {}, {}
    if pages == "int8":
        kv, scales = (np.array(a) for a in jax.jit(quantize_kv)(jnp.asarray(kv)))
        kw_j["kv_scales"], kw_t["kv_scales"] = jnp.asarray(scales), torch.from_numpy(scales)
    before = dict(ra.kernel_launches)
    want = np.asarray(_jax_ref(*(jnp.asarray(a) for a in (q, kv, lens, tables, cu, ns)),
                               sm_scale=HD ** -0.5, **kw_j))
    got = ra.ragged_paged_attention(*(torch.from_numpy(a) for a in (q, kv, lens, tables, cu, ns)),
                                    sm_scale=HD ** -0.5, **kw_t)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    assert ra.kernel_launches == before  # the CPU takes the plain version


@pytest.mark.parametrize("pages", ["bf16", "int8"])
@pytest.mark.parametrize("case", list(ATTENTION_CASES))
def test_tiled_arithmetic_at_head_dim64(case, pages):
    """The plain version of the tiled kernel's arithmetic at head_dim 64:
    the plain version but for P's rounding to bf16."""
    check_tiled_arithmetic(*_attention_batch(*ATTENTION_CASES[case], seed=11),
                           int8=pages == "int8")


def test_head_dim64_instances_are_named_and_planned():
    """Each head dim has its own four C entry points and launch counters
    (128's keep their names; the generic instance's count apart); the
    decode plan's scratch follows the head dim; the operand check names
    the fast head_dim-64 instance for head_dim-64 operands, the generic one
    at 48, and refuses 100."""
    assert set(ra.KERNEL_HEAD_DIMS) == {64, 128}
    assert ra.INSTANCE_NAMES["decode", False, 128] == "ragged_paged_attention_decode_launch"
    assert ra.INSTANCE_NAMES["tiled", True, 64] == "ragged_paged_attention_int8_tiled_hd64_launch"
    assert set(ra.kernel_launches) - set(ra.GENERIC_INSTANCE_NAMES.values()) == set(
        ra.INSTANCE_NAMES.values())
    assert len(ra.INSTANCE_NAMES) == 8
    ints, n_o, n_ml = ra.launch_plan("decode", 8, 32, 8, 32, 256, 8, 132, head_dim=64)
    assert n_o == 8 * 8 * ints[6] * 4 * 64 and n_ml == 8 * 8 * ints[6] * 4 * 2
    bf16 = lambda a: torch.from_numpy(a).bfloat16()  # noqa: E731
    q, kv, lens, tables, cu, ns = _attention_batch([3, 1], [5, 7], 2, 2, 8, 2, seed=3)
    ints = [torch.from_numpy(a) for a in (lens, tables, cu, ns)]
    assert ra._check_cuda_operands(bf16(q), bf16(kv), *ints) == ra.INSTANCE_NAMES[
        "decode", False, 64]
    assert ra._check_cuda_operands(bf16(q[..., :48]), bf16(kv[..., :48]), *ints) == (
        ra.GENERIC_INSTANCE_NAMES["decode", "bf16", False])
    q100, kv100 = np.zeros((*q.shape[:2], 100)), np.zeros((*kv.shape[:3], 100))
    with pytest.raises(ValueError, match="head_dim 100"):
        ra._check_cuda_operands(bf16(q100), bf16(kv100), *ints)


# -- a head_dim-64 llama checkpoint, as the JAX worker serves one ------------------

HF_CONFIG = dict(
    architectures=["LlamaForCausalLM"], model_type="llama", vocab_size=128, hidden_size=128,
    intermediate_size=256, num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
    head_dim=HD, max_position_embeddings=128, rope_theta=500000.0, rms_norm_eps=1e-5,
    hidden_act="silu", tie_word_embeddings=True, torch_dtype="bfloat16")
# The weights' scale: the loader tests' 0.5 at width 32, scaled by
# 1/sqrt(width) to 128, so that greedy picks are seldom near-ties (at 0.5
# here bf16 roundings moved a log-probability by up to 0.23).
INIT_STD = 0.25


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A llama checkpoint as ``save_pretrained`` writes one (config.json and
    bf16 safetensors under the Hugging Face names, tied embeddings), its
    matrices drawn from N(0, INIT_STD) with seed 64 and its norms ones."""
    c = HF_CONFIG
    h, inter, nq, nkv = (c["hidden_size"], c["intermediate_size"], c["num_attention_heads"],
                         c["num_key_value_heads"])
    shapes = {"model.embed_tokens.weight": (c["vocab_size"], h), "model.norm.weight": (h,)}
    for i in range(c["num_hidden_layers"]):
        pre = f"model.layers.{i}."
        shapes.update({
            pre + "input_layernorm.weight": (h,), pre + "post_attention_layernorm.weight": (h,),
            pre + "self_attn.q_proj.weight": (nq * HD, h),
            pre + "self_attn.k_proj.weight": (nkv * HD, h),
            pre + "self_attn.v_proj.weight": (nkv * HD, h),
            pre + "self_attn.o_proj.weight": (h, nq * HD),
            pre + "mlp.gate_proj.weight": (inter, h), pre + "mlp.up_proj.weight": (inter, h),
            pre + "mlp.down_proj.weight": (h, inter),
        })
    rng = np.random.default_rng(64)
    tensors = {
        name: (torch.ones(shape) if len(shape) == 1
               else torch.from_numpy(rng.normal(0.0, INIT_STD, shape).astype(np.float32)))
        .to(torch.bfloat16)
        for name, shape in shapes.items()
    }
    path = tmp_path_factory.mktemp("llama_hd64")
    save_file(tensors, str(path / "model.safetensors"), metadata={"format": "pt"})
    (path / "config.json").write_text(json.dumps(c))
    return path


def test_config_matches_jax(checkpoint):
    got = dataclasses.asdict(tloader.config_from_hf(checkpoint))
    assert got == dataclasses.asdict(jloader.config_from_hf(checkpoint))
    assert (got["head_dim"], got["num_heads"], got["num_kv_heads"]) == (HD, 4, 2)
    assert got["tie_embeddings"] and got["rope_theta"] == 500000.0


def test_logits_match_jax_forward(checkpoint):
    """f32 last-token logits of one prefill: the port's forward against the
    JAX forward (its XLA reference attention at head_dim 64)."""
    cfg, params = tloader.load_hf_llama(checkpoint, dtype=torch.float32, device="cpu")
    jcfg, jparams = jloader.load_hf_llama(checkpoint, dtype=jnp.float32)
    jcfg = dataclasses.replace(jcfg, dtype="float32")
    prompt = [3, 17, 42, 99, 7, 64, 23, 5, 77, 12]
    jeng = JaxEngineConfig(**ENGINE)
    want, _ = prefill_chunk(jparams, jmodel.init_cache(jcfg, jeng), prompt, 0, [0, 1], jcfg, jeng,
                            32)
    got = _port_logits(params, cfg, prompt).numpy()
    np.testing.assert_allclose(got, np.asarray(want, np.float32).reshape(got.shape),
                               rtol=1e-4, atol=1e-4)


def test_engine_streams_match_jax_engine(checkpoint):
    """``build_engine(None, model_path=...)`` at bf16 streams the JAX
    engine's greedy tokens from the same checkpoint up to near-ties; at
    f32, engines on both loaders' params stream the same tokens exactly."""
    from dynamo_tpu.engine import EngineCore as JaxCore
    from dynamo_tpu.engine import TpuEngine
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.core import EngineCore
    from dynamo_tpu_torch.engine.engine import TorchEngine

    core, engine = build_engine(None, model_path=str(checkpoint), engine_overrides=ENGINE,
                                device="cpu")
    assert core.cfg.head_dim == HD and core.cfg.dtype == "bfloat16"
    _, jengine = jax_build_engine("tiny", ENGINE, model_path=str(checkpoint))
    _held_to_near_ties(asyncio.run(_streams(engine, Context)),
                       asyncio.run(_streams(jengine, JaxContext)))

    _, tparams = tloader.load_hf_llama(checkpoint, dtype=torch.float32, device="cpu")
    jcfg, jparams = jloader.load_hf_llama(checkpoint, dtype=jnp.float32)
    got = asyncio.run(_streams(TorchEngine(EngineCore(
        dataclasses.replace(core.cfg, dtype="float32"), EngineConfig(**ENGINE), params=tparams,
        device="cpu")), Context))
    want = asyncio.run(_streams(TpuEngine(JaxCore(
        dataclasses.replace(jcfg, dtype="float32"), JaxEngineConfig(**ENGINE), params=jparams)),
        JaxContext))
    assert [[t for t, _ in s] for s in got] == [[t for t, _ in s] for s in want]


# -- the card's slice check (configs alone: no card needed) ------------------------

LLAMA32_1B = ModelConfig(  # Llama-3.2-1B's published config.json
    name="llama", vocab_size=128256, hidden_size=2048, intermediate_size=8192, num_layers=16,
    num_heads=32, num_kv_heads=8, head_dim=64, rope_theta=500000.0, rms_norm_eps=1e-5,
    tie_embeddings=True)


@pytest.mark.parametrize("cfg", [
    LLAMA32_1B,
    dataclasses.replace(LLAMA32_1B, num_heads=14, num_kv_heads=2, hidden_size=896),  # Qwen2.5-0.5B
    dataclasses.replace(LLAMA32_1B, head_dim=128, num_heads=16),
    # K1's generic instance:
    dataclasses.replace(LLAMA32_1B, head_dim=96),
    dataclasses.replace(LLAMA32_1B, head_dim=16),
    dataclasses.replace(LLAMA32_1B, head_dim=256),
    dataclasses.replace(LLAMA32_1B, num_heads=9, num_kv_heads=1),
    dataclasses.replace(LLAMA32_1B, dtype="float32"),
], ids=["llama3.2-1b", "qwen2.5-0.5b-heads", "head_dim128", "head_dim96", "head_dim16",
        "head_dim256", "group9", "f32"])
def test_slice_check_accepts_head_dim64_on_cuda(cfg):
    check_slice(cfg, tiny_engine(), device="cuda")


@pytest.mark.parametrize("over, why", [
    ({"head_dim": 100}, "head_dim 100 (K1 takes a multiple of 8 up to 256)"),
    ({"head_dim": 264}, "head_dim 264 (K1 takes a multiple of 8 up to 256)"),
], ids=["head_dim100", "head_dim264"])
def test_slice_check_refuses_by_name_on_cuda(over, why):
    cfg = dataclasses.replace(LLAMA32_1B, **over)
    with pytest.raises(ValueError, match="cannot run on the card's attention kernel") as err:
        check_slice(cfg, tiny_engine(), device="cuda")
    assert why in str(err.value)
    check_slice(cfg, tiny_engine(), device="cpu")  # the plain versions serve it
