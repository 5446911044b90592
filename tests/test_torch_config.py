"""The port's engine/config.py against the JAX package's: every field
default, every preset and every derived property agree."""

import dataclasses

import jax.numpy as jnp
import pytest

from dynamo_tpu.engine import config as jcfg
from dynamo_tpu_torch.engine import config as tcfg


def _fields(cls):
    return [(f.name, f.default) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("cls", ["ModelConfig", "EngineConfig"])
def test_field_names_and_defaults_match(cls):
    assert _fields(getattr(tcfg, cls)) == _fields(getattr(jcfg, cls))
    assert dataclasses.asdict(getattr(tcfg, cls)()) == dataclasses.asdict(
        getattr(jcfg, cls)()
    )


def test_preset_names_match():
    assert list(tcfg.PRESETS) == list(jcfg.PRESETS)


@pytest.mark.parametrize("name", sorted(jcfg.PRESETS))
def test_preset_matches(name):
    t, j = tcfg.PRESETS[name](), jcfg.PRESETS[name]()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.torch_dtype.itemsize == jnp.dtype(j.jax_dtype).itemsize
    assert t.param_bytes() == j.param_bytes()
    assert t.quantized_param_bytes() == j.quantized_param_bytes()
    assert (t.q_size, t.kv_size, t.is_moe) == (j.q_size, j.kv_size, j.is_moe)


_DERIVED = (
    "kv_quantized", "megastep", "max_blocks_per_seq", "token_budget",
    "fair_quantum_resolved", "chunk_size", "total_slots", "garbage_block",
)


@pytest.mark.parametrize(
    "overrides",
    [
        {},
        {"megastep_k": 4, "decode_chain": 2},
        {"max_num_batched_tokens": 64, "prefill_chunk": 16, "fair_quantum": 7},
    ],
    ids=["defaults", "megastep", "budget"],
)
def test_tiny_engine_and_derived_properties_match(overrides):
    t, j = tcfg.tiny_engine(**overrides), jcfg.tiny_engine(**overrides)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    for prop in _DERIVED:
        assert getattr(t, prop) == getattr(j, prop), prop
    full_t, full_j = tcfg.EngineConfig(**overrides), jcfg.EngineConfig(**overrides)
    for prop in _DERIVED:
        assert getattr(full_t, prop) == getattr(full_j, prop), prop
