"""Ragged paged attention: the port's plain version against the JAX
package's reference, with bf16-layout pages and with int8 pages and their
scales (``kv_scales``), and the dispatch rules around the CUDA kernel.

Tolerance: atol = rtol = 1e-5 in f32 — both compute the same masked
softmax in f32; only the order of the sums differs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.kv_quant import quantize_kv
from dynamo_tpu.ops.ragged_attention import ragged_paged_attention_ref as jax_ref
from dynamo_tpu_torch.ops import _build
from dynamo_tpu_torch.ops import ragged_attention as ra

D = 16
PAGE = 4


def make_batch(q_lens, kv_lens, S, pages_per_seq, n_q, n_kv, seed):
    """Random operands: sequence s owns q rows cu[s]..cu[s+1]-1 and the
    pages of its own table; entries past its pages and rows past the last
    sequence point at the garbage page (the last one)."""
    rng = np.random.default_rng(seed)
    n_pages = S * pages_per_seq + 1
    T = sum(q_lens) + 3  # padded rows past cu[num_seqs]
    q = rng.standard_normal((T, n_q, D)).astype(np.float32)
    kv = rng.standard_normal((n_pages, PAGE, 2 * n_kv, D)).astype(np.float32)
    perm = rng.permutation(n_pages - 1).astype(np.int32)
    tables = np.full((S, pages_per_seq), n_pages - 1, np.int32)
    off = 0
    for s, L in enumerate(kv_lens):
        npg = -(-L // PAGE)
        tables[s, :npg] = perm[off : off + npg]
        off += npg
    lens = np.zeros(S, np.int32)
    lens[: len(kv_lens)] = kv_lens
    cu = np.zeros(S + 1, np.int32)
    cu[1 : len(q_lens) + 1] = np.cumsum(q_lens)
    cu[len(q_lens) + 1 :] = cu[len(q_lens)]
    num_seqs = np.array([len(q_lens)], np.int32)
    return q, kv, lens, tables, cu, num_seqs


CASES = {
    # q_lens, kv_lens, S, pages_per_seq, n_q, n_kv
    "mixed_prefill_decode": ([5, 1, 3, 1], [9, 14, 3, 1], 4, 4, 4, 2),
    "q_len_zero": ([2, 0, 1, 0, 4], [6, 5, 8, 2, 4], 5, 3, 4, 2),
    "num_seqs_below_S": ([3, 1], [7, 2], 6, 2, 4, 2),
    "page_boundaries": ([4, 1, 8], [8, 12, 16], 3, 4, 4, 2),
    "group1": ([2, 1, 1], [5, 9, 1], 3, 3, 2, 2),
    "group2": ([6, 1], [6, 11], 2, 3, 4, 2),
    "group4": ([1, 1, 3], [13, 4, 3], 3, 4, 8, 2),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_matches_jax_reference(case, seed):
    q_lens, kv_lens, S, pps, n_q, n_kv = CASES[case]
    q, kv, lens, tables, cu, ns = make_batch(q_lens, kv_lens, S, pps, n_q, n_kv, seed)
    before = ra.launches
    want = np.asarray(
        jax_ref(
            jnp.asarray(q), jnp.asarray(kv), jnp.asarray(lens), jnp.asarray(tables),
            jnp.asarray(cu), jnp.asarray(ns), sm_scale=D ** -0.5,
        )
    )
    got = ra.ragged_paged_attention(
        *(torch.from_numpy(a) for a in (q, kv, lens, tables, cu, ns)),
        sm_scale=D ** -0.5,
    )
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    assert not got[int(cu[len(q_lens)]) :].any(), "rows past the last sequence are zero"
    assert ra.launches == before


@pytest.mark.parametrize("case", list(CASES))
def test_plain_int8_matches_jax_reference(case):
    """int8 pages: the same quantized bytes and scales through both plain
    versions (dequantize on gather)."""
    q_lens, kv_lens, S, pps, n_q, n_kv = CASES[case]
    q, kv, lens, tables, cu, ns = make_batch(q_lens, kv_lens, S, pps, n_q, n_kv, seed=5)
    kv8, scales = (np.asarray(a) for a in jax.jit(quantize_kv)(jnp.asarray(kv)))
    before = (ra.launches, ra.launches_int8)
    want = np.asarray(
        jax_ref(
            *(jnp.asarray(a) for a in (q, kv8, lens, tables, cu, ns)),
            sm_scale=D ** -0.5, kv_scales=jnp.asarray(scales),
        )
    )
    got = ra.ragged_paged_attention(
        *(torch.from_numpy(a) for a in (q, kv8, lens, tables, cu, ns)),
        sm_scale=D ** -0.5, kv_scales=torch.from_numpy(scales),
    )
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    assert not got[int(cu[len(q_lens)]) :].any(), "rows past the last sequence are zero"
    assert (ra.launches, ra.launches_int8) == before


def test_cpu_call_never_touches_the_build(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("a CPU call reached the kernel build")

    for name in ("load", "build", "nvcc_path"):
        monkeypatch.setattr(_build, name, boom)
    q, kv, lens, tables, cu, ns = make_batch([3, 1], [5, 7], 2, 2, 4, 2, seed=3)
    before = ra.launches
    out = ra.ragged_paged_attention(
        *(torch.from_numpy(a) for a in (q, kv, lens, tables, cu, ns)), sm_scale=0.25
    )
    assert out.shape == q.shape
    assert ra.launches == before


def test_kv_scales_refused():
    """Scales that are not one per (slot, combined head) are refused."""
    q, kv, lens, tables, cu, ns = make_batch([2], [4], 1, 1, 4, 2, seed=4)
    with pytest.raises(ValueError, match="kv_scales must be"):
        ra.ragged_paged_attention(
            *(torch.from_numpy(a) for a in (q, kv.astype(np.int8), lens, tables, cu, ns)),
            sm_scale=0.25, kv_scales=torch.ones(kv.shape[:-2]),
        )


@pytest.mark.parametrize(
    "bad, match",
    [
        ({"dtype": torch.float32}, "bf16"),
        ({"d": 64}, "head_dim"),
        ({"n_q": 36}, "head layout"),
        ({"table_dtype": torch.int64}, "int32"),
        ({"scales": torch.ones(3, 32, 16)}, "int8 pages"),
        ({"page_dtype": torch.int8}, "without kv_scales"),
        ({"page_dtype": torch.int8, "scales": torch.ones(3, 32, 16, dtype=torch.float64)}, "float32"),
        ({"page_dtype": torch.int8, "scales": torch.ones(3, 32, 8)}, "kv_scales must be"),
    ],
    ids=["dtype", "head_dim", "group", "index_dtype", "bf16_pages_with_scales",
         "int8_pages_without_scales", "scale_dtype", "scale_shape"],
)
def test_kernel_operand_checks(bad, match):
    d = bad.get("d", 128)
    n_q = bad.get("n_q", 32)
    dt = bad.get("dtype", torch.bfloat16)
    q = torch.zeros(4, n_q, d, dtype=dt)
    kv = torch.zeros(3, 32, 16, d, dtype=bad.get("page_dtype", dt))
    tables = torch.zeros(2, 2, dtype=bad.get("table_dtype", torch.int32))
    lens = torch.ones(2, dtype=torch.int32)
    cu = torch.tensor([0, 2, 4], dtype=torch.int32)
    ns = torch.tensor([2], dtype=torch.int32)
    with pytest.raises((TypeError, ValueError), match=match):
        ra._check_cuda_operands(q, kv, lens, tables, cu, ns, bad.get("scales"))
