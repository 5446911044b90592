"""Paged decode attention (K2): the port's plain version against the JAX
package's reference and its Pallas kernel in interpret mode, with f32 and
int8 caches, with and without the self position; and the dispatch rules
around the CUDA kernel.

Tolerance: atol = rtol = 1e-5 in f32, as the JAX package holds its own
kernel to its reference: the same masked softmax in f32, sums in another
order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.kv_quant import quantize_kv
from dynamo_tpu.ops.paged_attention import paged_attention_pallas, paged_attention_reference
from dynamo_tpu_torch.ops import _build
from dynamo_tpu_torch.ops import paged_attention as pa

B, N_Q, N_KV, D, BS, MAX_BLOCKS = 4, 8, 2, 16, 8, 6
SEQ_LENS = np.array([5, 17, 48, 1], np.int32)


def make_operands(seed, quant, with_self, seq_lens=SEQ_LENS):
    """numpy operands: each sequence owns MAX_BLOCKS scattered blocks; one
    block past them is the garbage block."""
    rng = np.random.default_rng(seed)
    total = (MAX_BLOCKS * B + 1) * BS
    q = rng.standard_normal((B, N_Q, D)).astype(np.float32)
    k = rng.standard_normal((N_KV, total, D)).astype(np.float32)
    v = rng.standard_normal((N_KV, total, D)).astype(np.float32)
    tables = rng.permutation(MAX_BLOCKS * B).astype(np.int32).reshape(B, MAX_BLOCKS)
    ops = dict(q=q, k_cache=k, v_cache=v, block_tables=tables, seq_lens=seq_lens)
    if quant:
        (k8, ks), (v8, vs) = quantize_kv(jnp.asarray(k)), quantize_kv(jnp.asarray(v))
        ops.update(k_cache=np.asarray(k8), v_cache=np.asarray(v8),
                   k_scale=np.asarray(ks), v_scale=np.asarray(vs))
    if with_self:
        ops.update(k_self=rng.standard_normal((B, N_KV, D)).astype(np.float32),
                   v_self=rng.standard_normal((B, N_KV, D)).astype(np.float32))
    return ops


def _split(ops, convert):
    pos = [convert(np.array(ops[n])) for n in ("q", "k_cache", "v_cache", "block_tables", "seq_lens")]
    kw = {n: convert(np.array(a)) for n, a in ops.items() if n in ("k_self", "v_self", "k_scale", "v_scale")}
    return pos, kw


@pytest.mark.parametrize("with_self", [False, True], ids=["cache_only", "with_self"])
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_matches_jax_reference_and_pallas(seed, quant, with_self):
    ops = make_operands(seed, quant, with_self)
    jpos, jkw = _split(ops, jnp.asarray)
    want = np.asarray(paged_attention_reference(*jpos, block_size=BS, **jkw))
    pallas = np.asarray(paged_attention_pallas(*jpos, block_size=BS, interpret=True, **jkw))
    tpos, tkw = _split(ops, torch.from_numpy)
    before = (pa.launches, pa.launches_int8)
    got = pa.paged_attention(*tpos, block_size=BS, **tkw)
    assert (pa.launches, pa.launches_int8) == before
    assert got.dtype == torch.float32 and got.shape == (B, N_Q, D)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), pallas, atol=1e-5, rtol=1e-5)


def test_self_position_and_table_edge():
    """seq_len 0 with a self position attends only itself; a seq_len past
    the table is cut at the table's span, as in the JAX reference."""
    lens = np.array([0, MAX_BLOCKS * BS + 9, 8, 3], np.int32)
    ops = make_operands(2, False, True, seq_lens=lens)
    jpos, jkw = _split(ops, jnp.asarray)
    want = np.asarray(paged_attention_reference(*jpos, block_size=BS, **jkw))
    tpos, tkw = _split(ops, torch.from_numpy)
    got = pa.paged_attention(*tpos, block_size=BS, **tkw).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    group = N_Q // N_KV
    np.testing.assert_allclose(
        got[0].reshape(N_KV, group, D), np.repeat(ops["v_self"][0][:, None, :], group, 1),
        atol=1e-6,
    )


def test_cpu_call_never_touches_the_build(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("a CPU call reached the kernel build")

    for name in ("load", "build", "nvcc_path"):
        monkeypatch.setattr(_build, name, boom)
    tpos, tkw = _split(make_operands(3, True, True), torch.from_numpy)
    assert pa.paged_attention(*tpos, block_size=BS, **tkw).shape == (B, N_Q, D)


def _cuda_shaped(**bad):
    """Operands at the kernel's shapes (on the CPU: only the checks run)."""
    d, n_q = bad.get("d", 128), bad.get("n_q", 32)
    q = torch.zeros(2, n_q, d, dtype=bad.get("q_dtype", torch.float32))
    cache = torch.zeros(8, 64, d, dtype=bad.get("page_dtype", torch.bfloat16))
    tables = torch.zeros(2, 2, dtype=bad.get("table_dtype", torch.int32))
    lens = torch.ones(2, dtype=torch.int32)
    scales = bad.get("scales")
    return q, cache, cache.clone(), tables, lens, None, None, scales, scales


@pytest.mark.parametrize(
    "bad, err, match",
    [
        ({"q_dtype": torch.float16}, ValueError, "f32 or bf16 q"),
        ({"d": 64}, ValueError, "head_dim"),
        ({"n_q": 72}, ValueError, "GQA group"),
        ({"page_dtype": torch.float32}, TypeError, "bfloat16 pages without scales"),
        ({"page_dtype": torch.int8}, TypeError, "got torch.int8"),
        ({"table_dtype": torch.int64}, TypeError, "int32"),
        ({"page_dtype": torch.int8, "scales": torch.ones(8, 64, dtype=torch.float64)}, ValueError, "f32"),
    ],
    ids=["q_dtype", "head_dim", "group", "f32_pages", "int8_without_scales", "index_dtype", "scale_dtype"],
)
def test_kernel_operand_checks(bad, err, match):
    with pytest.raises(err, match=match):
        pa._check_cuda_operands(*_cuda_shaped(**bad))
    assert pa.kernel_supported(torch.float32, torch.int8, 128, 4)
    assert not pa.kernel_supported(torch.float16, torch.bfloat16, 128, 4)
