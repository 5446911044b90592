"""K1's generic instance (``csrc/ragged_paged_attention_generic.cu``): which
instance runs what on the card, the card's slice check, and one model it
opens to the card against the JAX package.

On the CPU no kernel runs, so this holds what surrounds it: the routing
function :func:`ragged_attention.k1_instance` (the fast instances exactly
where they ran before the generic one existed, the generic one elsewhere,
refusals by name), the generic plans, the slice check on ``cuda`` (which
reads configs alone), that no module of the port turns TF32 on (an f32
engine on the card multiplies in full f32), and a llama checkpoint at
Falcon3-7B's head_dim 256 and a GQA group of 3, at a cut width (2 layers,
3 query heads over 1 KV head, untied embeddings) written from a seed:
both packages read its config alike, the port's f32 logits equal the JAX
forward's (its XLA reference attention: JAX's Pallas kernel takes no
head_dim 256 off a TPU) within 1e-4, and the port's bf16 engine streams
the JAX engine's greedy tokens up to the near-ties of
``tests/test_torch_loader.py``. The kernels themselves are held against
the plain version on the card (``tests/test_torch_kernels_cuda.py``,
``chip_smoke.py``).
"""

import asyncio
import dataclasses
import json
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.torch import save_file

from dynamo_tpu.backends.jax.main import build_engine as jax_build_engine
from dynamo_tpu.engine import loader as jloader
from dynamo_tpu.engine import model as jmodel
from dynamo_tpu.engine.config import EngineConfig as JaxEngineConfig
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.backends.torch.main import build_engine
from dynamo_tpu_torch.engine import loader as tloader
from dynamo_tpu_torch.engine.config import PRESETS, tiny_engine
from dynamo_tpu_torch.engine.core import check_slice
from dynamo_tpu_torch.ops import ragged_attention as ra
from dynamo_tpu_torch.runtime.engine import Context
from tests.model_harness import prefill_chunk
from tests.test_torch_loader import ENGINE, _held_to_near_ties, _port_logits, _streams

BF16, F16, F32 = torch.bfloat16, torch.float16, torch.float32


# -- which instance runs what ------------------------------------------------------

@pytest.mark.parametrize("kernel", ["decode", "tiled"])
@pytest.mark.parametrize("int8", [False, True], ids=["bf16_pages", "int8_pages"])
@pytest.mark.parametrize("head_dim, group", [(64, 1), (64, 8), (128, 4), (128, 7), (128, 8)])
def test_fast_instances_where_they_ran(head_dim, group, int8, kernel):
    """bf16 q at head_dim 64 or 128 and a group up to 8: the fast instance,
    under the name (and counter) it had before the generic one existed."""
    name = ra.k1_instance(BF16, int8, head_dim, group, kernel)
    assert name == ra.INSTANCE_NAMES[kernel, int8, head_dim]
    assert "generic" not in name


@pytest.mark.parametrize("kernel", ["decode", "tiled"])
@pytest.mark.parametrize("int8", [False, True], ids=["q_pages", "int8_pages"])
@pytest.mark.parametrize("dtype, head_dim, group, tag", [
    (F32, 16, 2, "f32"),      # tiny, tiny-moe
    (F32, 128, 4, "f32"),
    (F16, 128, 4, "f16"),
    (BF16, 96, 4, "bf16"),
    (BF16, 256, 3, "bf16"),   # Falcon3-7B
    (BF16, 128, 9, "bf16"),
    (BF16, 128, 12, "bf16"),  # Mistral-Large-Instruct-2407
    (BF16, 128, 16, "bf16"),  # Llama-3.1-405B, a tp = 8 rank
    (BF16, 8, 200, "bf16"),
], ids=["tiny", "f32_hd128", "f16", "hd96", "falcon3", "group9", "group12", "group16",
        "hd8_group200"])
def test_generic_instance_elsewhere(dtype, head_dim, group, tag, int8, kernel):
    name = ra.k1_instance(dtype, int8, head_dim, group, kernel)
    assert name == ra.GENERIC_INSTANCE_NAMES[kernel, tag, int8]
    assert name == f"ragged_paged_attention_generic_{tag}{'_int8' if int8 else ''}_{kernel}_launch"


@pytest.mark.parametrize("dtype, head_dim, group, why", [
    (BF16, 100, 4, "head_dim 100 (K1 takes a multiple of 8 up to 256)"),
    (BF16, 264, 4, "head_dim 264 (K1 takes a multiple of 8 up to 256)"),
    (F32, 4, 1, "head_dim 4"),
    (torch.float64, 128, 4, "dtype float64 (K1 takes float32, float16 or bfloat16)"),
    (BF16, 128, 0, "a GQA group of 0"),
], ids=["hd100", "hd264", "hd4", "f64", "group0"])
def test_refused_by_name(dtype, head_dim, group, why):
    with pytest.raises(ValueError, match="no K1 instance runs on the card") as err:
        ra.k1_instance(dtype, False, head_dim, group)
    assert why in str(err.value)


def test_counters_and_sums_cover_every_instance():
    """One launch counter per C entry point, fast and generic; the page-type
    sums count both."""
    assert set(ra.kernel_launches) == {*ra.INSTANCE_NAMES.values(),
                                       *ra.GENERIC_INSTANCE_NAMES.values()}
    assert len(ra.GENERIC_INSTANCE_NAMES) == 12
    saved = dict(ra.kernel_launches)
    try:
        ra.reset_launches()
        ra.kernel_launches[ra.INSTANCE_NAMES["decode", False, 128]] += 1
        ra.kernel_launches[ra.GENERIC_INSTANCE_NAMES["tiled", "f32", False]] += 2
        ra.kernel_launches[ra.GENERIC_INSTANCE_NAMES["decode", "bf16", True]] += 4
        assert (ra.launches, ra.launches_int8) == (3, 4)
    finally:
        ra.kernel_launches.update(saved)


@pytest.mark.parametrize("head_dim, group, tile_m, rows", [
    (16, 2, 128, 64), (128, 4, 128, 32), (136, 4, 64, 16), (256, 3, 64, 21), (256, 12, 64, 5),
    (128, 16, 128, 8), (256, 96, 64, 1), (128, 200, 128, 1),
])
def test_generic_plans(head_dim, group, tile_m, rows):
    """The generic tiled grid: ``generic_tile_m`` M rows a block (a group
    above it takes one query row and the kernel's passes); its ints carry
    the head dim after n_kv, as its C entry points take them. The decode
    plan and scratch are the fast instance's."""
    assert ra.generic_tile_m(head_dim) == tile_m
    T, S, n_kv, sms = 2048, 8, 2, 132
    n_q = group * n_kv
    ints, n_o, n_ml = ra.generic_launch_plan("tiled", T, n_q, n_kv, head_dim, 16, 128, S, sms)
    assert ints == (T, n_q, n_kv, head_dim, 16, 128, S, -(-T // rows) + S, rows)
    assert (n_o, n_ml) == (0, 0)
    ints, n_o, n_ml = ra.generic_launch_plan("decode", 8, n_q, n_kv, head_dim, 16, 128, S, sms)
    n_splits, per = ra.decode_split_plan(8, n_kv, 128, 16, sms)
    assert ints == (8, n_q, n_kv, head_dim, 16, 128, S, n_splits, per)
    assert n_o == 8 * n_kv * n_splits * group * head_dim and n_ml == n_o // head_dim * 2


def test_fast_plan_unchanged():
    """The fast instances' tiled plan keeps TILE_M // group rows."""
    assert ra.tiled_plan(8192, 8, 4) == (8192 // 32 + 8, 32)
    assert ra.tiled_plan(2048, 8, 7) == (-(-2048 // 18) + 8, 18)


def _cuda_shaped(dtype, d, n_q=12, n_kv=4, page_dtype=None, scales=False):
    q = torch.zeros(4, n_q, d, dtype=dtype)
    kv = torch.zeros(3, 8, 2 * n_kv, d, dtype=page_dtype or dtype)
    sc = torch.ones(3, 8, 2 * n_kv) if scales else None
    ints = (torch.ones(2, dtype=torch.int32), torch.zeros(2, 2, dtype=torch.int32),
            torch.tensor([0, 2, 4], dtype=torch.int32), torch.tensor([2], dtype=torch.int32))
    return (q, kv, *ints), sc


@pytest.mark.parametrize("dtype, d, page_dtype, scales, match", [
    (F32, 16, None, False, None),
    (F16, 256, torch.int8, True, None),
    (BF16, 96, None, False, None),
    (F32, 16, BF16, False, "pages of q's type"),
    (BF16, 264, None, False, "head_dim 264 .K1 takes a multiple of 8 up to 256"),
    (F32, 16, torch.int8, False, "without kv_scales"),
], ids=["f32", "f16_int8", "bf16_hd96", "mixed_types", "hd264", "int8_without_scales"])
def test_generic_operand_checks(dtype, d, page_dtype, scales, match):
    """Operands of the generic instance pass the operand check, which names
    the instance (group 3 here); a mixed q and page type, a head_dim
    above 256 and int8 pages without scales are refused by name."""
    args, sc = _cuda_shaped(dtype, d, page_dtype=page_dtype, scales=scales)
    if match is None:
        assert ra._check_cuda_operands(*args, sc, kernel="tiled") == ra.GENERIC_INSTANCE_NAMES[
            "tiled", ra.GENERIC_Q_DTYPES[dtype], scales]
    else:
        with pytest.raises((TypeError, ValueError), match=match):
            ra._check_cuda_operands(*args, sc)


# -- the card's slice check (configs alone: no card needed) ------------------------

LLAMA = PRESETS["llama3-1b"]()


@pytest.mark.parametrize("cfg", [
    PRESETS["tiny"](), PRESETS["tiny-moe"](),
    dataclasses.replace(LLAMA, dtype="float32"),
    dataclasses.replace(LLAMA, dtype="float16"),
    dataclasses.replace(LLAMA, head_dim=96),
    dataclasses.replace(LLAMA, head_dim=256, num_heads=12, num_kv_heads=4),
    dataclasses.replace(LLAMA, num_heads=96, num_kv_heads=8),
    dataclasses.replace(LLAMA, num_heads=16, num_kv_heads=1),
], ids=["tiny", "tiny-moe", "f32_hd128", "fp16", "hd96", "hd256", "group12", "group16"])
def test_slice_check_accepts_on_cuda(cfg):
    check_slice(cfg, tiny_engine(), device="cuda")


@pytest.mark.parametrize("over, why", [
    ({"head_dim": 100}, "head_dim 100 (K1 takes a multiple of 8 up to 256)"),
    ({"head_dim": 264}, "head_dim 264 (K1 takes a multiple of 8 up to 256)"),
    ({"num_heads": 12, "num_kv_heads": 8}, "12 query heads over 8 KV heads"),
], ids=["hd100", "hd264", "partial_group"])
def test_slice_check_refuses_on_cuda(over, why):
    cfg = dataclasses.replace(LLAMA, **over)
    with pytest.raises(ValueError, match="cannot run on the card's attention kernel") as err:
        check_slice(cfg, tiny_engine(), device="cuda")
    assert why in str(err.value)


# -- f32 on the card is full f32 ---------------------------------------------------

def test_no_module_of_the_port_turns_tf32_on():
    """PyTorch multiplies f32 matrices in full f32 unless told otherwise;
    no module of the port tells it otherwise (``allow_tf32 = True``, a
    float32 matmul precision other than "highest")."""
    pkg = Path(ra.__file__).resolve().parents[1]
    found = []
    for path in sorted(pkg.rglob("*.py")):
        text = path.read_text()
        found += [f"{path.relative_to(pkg)}: {m.group(0)}" for m in re.finditer(
            r"allow_tf32\s*=\s*(?!False\b)\S+|set_float32_matmul_precision\(\s*(?![\"']highest[\"'])"
            r"[^)]*\)", text)]
    assert not found, found


# -- Falcon3-7B's head_dim 256 and a group of 3, cut to size, against JAX ----------

HD, N_Q, N_KV = 256, 3, 1
HF_CONFIG = dict(
    architectures=["LlamaForCausalLM"], model_type="llama", vocab_size=128, hidden_size=64,
    intermediate_size=128, num_hidden_layers=2, num_attention_heads=N_Q,
    num_key_value_heads=N_KV, head_dim=HD, max_position_embeddings=128, rope_theta=1000042.0,
    rms_norm_eps=1e-6, hidden_act="silu", tie_word_embeddings=False, torch_dtype="bfloat16")
INIT_STD = 0.25  # wide enough that greedy picks are seldom near-ties


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A llama checkpoint as ``save_pretrained`` writes one (config.json and
    bf16 safetensors under the Hugging Face names, untied), its matrices
    drawn from N(0, INIT_STD) with seed 256 and its norms ones."""
    c = HF_CONFIG
    h, inter = c["hidden_size"], c["intermediate_size"]
    shapes = {"model.embed_tokens.weight": (c["vocab_size"], h), "model.norm.weight": (h,),
              "lm_head.weight": (c["vocab_size"], h)}
    for i in range(c["num_hidden_layers"]):
        pre = f"model.layers.{i}."
        shapes.update({
            pre + "input_layernorm.weight": (h,), pre + "post_attention_layernorm.weight": (h,),
            pre + "self_attn.q_proj.weight": (N_Q * HD, h),
            pre + "self_attn.k_proj.weight": (N_KV * HD, h),
            pre + "self_attn.v_proj.weight": (N_KV * HD, h),
            pre + "self_attn.o_proj.weight": (h, N_Q * HD),
            pre + "mlp.gate_proj.weight": (inter, h), pre + "mlp.up_proj.weight": (inter, h),
            pre + "mlp.down_proj.weight": (h, inter),
        })
    rng = np.random.default_rng(256)
    tensors = {
        name: (torch.ones(shape) if len(shape) == 1
               else torch.from_numpy(rng.normal(0.0, INIT_STD, shape).astype(np.float32)))
        .to(torch.bfloat16)
        for name, shape in shapes.items()
    }
    path = tmp_path_factory.mktemp("llama_hd256")
    save_file(tensors, str(path / "model.safetensors"), metadata={"format": "pt"})
    (path / "config.json").write_text(json.dumps(c))
    return path


def test_head_dim256_checkpoint_matches_jax(checkpoint):
    """Both packages read the config alike and the card would serve it
    (generic instance); the port's f32 logits of one prefill equal the JAX
    forward's within 1e-4; the port's bf16 engine (the CPU's plain
    attention) streams the JAX engine's greedy tokens up to near-ties."""
    cfg = tloader.config_from_hf(checkpoint)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jloader.config_from_hf(checkpoint))
    assert (cfg.head_dim, cfg.num_heads, cfg.num_kv_heads, cfg.tie_embeddings) == (HD, 3, 1, False)
    check_slice(cfg, tiny_engine(), device="cuda")
    assert ra.k1_instance(cfg.torch_dtype, False, HD, N_Q // N_KV, "tiled") == \
        ra.GENERIC_INSTANCE_NAMES["tiled", "bf16", False]

    _, params = tloader.load_hf_llama(checkpoint, dtype=torch.float32, device="cpu")
    jcfg, jparams = jloader.load_hf_llama(checkpoint, dtype=jnp.float32)
    jcfg = dataclasses.replace(jcfg, dtype="float32")
    prompt = [3, 17, 42, 99, 7, 64, 23, 5, 77, 12]
    jeng = JaxEngineConfig(**ENGINE)
    want, _ = prefill_chunk(jparams, jmodel.init_cache(jcfg, jeng), prompt, 0, [0, 1], jcfg, jeng,
                            32)
    got = _port_logits(params, cfg, prompt).numpy()
    np.testing.assert_allclose(got, np.asarray(want, np.float32).reshape(got.shape),
                               rtol=1e-4, atol=1e-4)

    before = dict(ra.kernel_launches)
    core, engine = build_engine(None, model_path=str(checkpoint), engine_overrides=ENGINE,
                                device="cpu")
    assert core.cfg.head_dim == HD and core.cfg.dtype == "bfloat16"
    _, jengine = jax_build_engine("tiny", ENGINE, model_path=str(checkpoint))
    _held_to_near_ties(asyncio.run(_streams(engine, Context)),
                       asyncio.run(_streams(jengine, JaxContext)))
    assert ra.kernel_launches == before  # the CPU takes the plain version
