"""The plan the K2 wrapper hands its CUDA kernel, and the plain version of
the kernel's split-and-combine arithmetic, on the CPU.

- ``paged_split_plan``: splits of whole pages that cover the block table,
  each starting inside it, and enough blocks to fill the card at the
  int8-against-bf16 comparison's shape and at llama3-8b decode widths
  (fixed cases and hypothesis);
- ``launch_plan``: the C entry point's int arguments and scratch sizes,
  worked out once per shape, with the split count forced or planned;
- ``paged_attention_split_ref`` (partials per split, log-sum-exp merge,
  the self position folded in once) against the JAX
  ``paged_attention_reference`` and ``paged_attention_pallas(...,
  interpret=True)`` at atol = rtol = 1e-5 in f32 (the same masked softmax
  summed in another order), f32 (bf16-layout) and int8 pages, with and
  without self, with splits and sequences that see no position.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from dynamo_tpu.ops.paged_attention import paged_attention_pallas, paged_attention_reference
from dynamo_tpu_torch.ops import paged_attention as pa
from tests.test_torch_paged_attention import BS, MAX_BLOCKS, N_KV, N_Q, _split, make_operands

H100_SMS = 132
D = 16

# (B, n_kv, max_blocks, block_size): the shapes the chip checks time.
CARD_SHAPES = {
    "bench_kvquant": (16, 8, 8, 32),
    "decode8": (8, 8, 128, 32),
    "decode64": (64, 8, 128, 32),
}


def _assert_plan_ok(B, n_kv, max_blocks, bs, n, per):
    assert n >= 1 and 1 <= per <= pa.KERNEL_MAX_SPLIT_PAGES
    assert n * per >= max_blocks, "the splits cover the block table"
    assert (n - 1) * per < max_blocks, "every split starts inside the table"


@pytest.mark.parametrize("B, n_kv, max_blocks, bs, sms", [
    *((*s, H100_SMS) for s in CARD_SHAPES.values()),
    (1, 8, 3, 32, H100_SMS),      # a table shorter than one split
    (2, 2, 40, 4, 16),            # small pages: many pages a split
    (1, 1, 5000, 1, H100_SMS),    # one-slot pages: the pages-per-split cap binds
    (4096, 8, 256, 32, H100_SMS),  # many rows: one split
])
def test_paged_split_plan(B, n_kv, max_blocks, bs, sms):
    n, per = pa.paged_split_plan(B, n_kv, max_blocks, bs, sms)
    _assert_plan_ok(B, n_kv, max_blocks, bs, n, per)
    most = -(-pa.MAX_SPLIT_BLOCKS_PER_SM * sms // (B * n_kv))
    if per < pa.KERNEL_MAX_SPLIT_PAGES:
        assert n <= max(1, most), "no more than the block cap"
        assert n <= -(-max_blocks * bs // pa.SPLIT_POSITIONS), "no split far below its length"
    if n > 1:
        assert (per - 1) * bs < pa.SPLIT_POSITIONS or n >= most, "splits near their length"


# The plans the card runs at the checked shapes (timed in PERF.md):
# one split at the comparison's 8-page tables (no partials, no combine; 128
# blocks for 132 SMs ran faster than 2 or 4 splits with the combine), nine
# splits of 15 pages at decode8 and decode64.
CARD_PLANS = {"bench_kvquant": (1, 8), "decode8": (9, 15), "decode64": (9, 15)}


@pytest.mark.parametrize("shape", list(CARD_SHAPES))
def test_plan_fills_the_card(shape):
    """A block for (nearly) every SM when every row is full: 128 of the 132
    SMs at the comparison's shape, at least four blocks per SM at decode8
    and decode64 (the old grid, B x n_kv, gave decode8 64 blocks)."""
    B, n_kv, max_blocks, bs = CARD_SHAPES[shape]
    n, per = pa.paged_split_plan(B, n_kv, max_blocks, bs, H100_SMS)
    assert (n, per) == CARD_PLANS[shape]
    assert B * n_kv * n >= H100_SMS - 4
    if shape != "bench_kvquant":
        assert B * n_kv * n >= 4 * H100_SMS


@settings(max_examples=300, deadline=None)
@given(
    B=st.integers(1, 300), n_kv=st.integers(1, 16), max_blocks=st.integers(1, 3000),
    bs=st.sampled_from([1, 2, 3, 8, 16, 32, 64, 128]), sms=st.integers(1, 200),
)
def test_plan_invariants_random(B, n_kv, max_blocks, bs, sms):
    n, per = pa.paged_split_plan(B, n_kv, max_blocks, bs, sms)
    _assert_plan_ok(B, n_kv, max_blocks, bs, n, per)


def test_scratch_shapes():
    o, ml = pa.paged_scratch_shapes(8, 32, 8, 16)
    assert o == (8, 8, 16, 4, 128)
    assert ml == (8, 8, 16, 4, 2)


@pytest.mark.parametrize("shape", list(CARD_SHAPES))
def test_launch_plan_planned(shape):
    B, n_kv, max_blocks, bs = CARD_SHAPES[shape]
    ints, n_o, n_ml = pa.launch_plan(B, 4 * n_kv, n_kv, bs, max_blocks, H100_SMS)
    n, per = pa.paged_split_plan(B, n_kv, max_blocks, bs, H100_SMS)
    assert ints == (B, 4 * n_kv, n_kv, bs, max_blocks, n, per)
    o, ml = pa.paged_scratch_shapes(B, 4 * n_kv, n_kv, n)
    assert (n_o, n_ml) == ((np.prod(o), np.prod(ml)) if n > 1 else (0, 0))
    assert n_o % 4 == 0, "(m, l) starts 16-byte aligned after o"


@pytest.mark.parametrize("forced, want", [(1, (1, 128)), (128, (128, 1)), (5, (5, 26)),
                                          (3, (3, 43)), (1000, (128, 1))])
def test_launch_plan_forced(forced, want):
    ints, n_o, _ = pa.launch_plan(8, 32, 8, 32, 128, H100_SMS, forced)
    assert ints[-2:] == want
    assert (n_o == 0) == (want[0] == 1), "one split writes the output directly"


def test_launch_plan_is_cached():
    pa.launch_plan.cache_clear()
    first = pa.launch_plan(8, 32, 8, 32, 128, H100_SMS)
    again = pa.launch_plan(8, 32, 8, 32, 128, H100_SMS)
    assert again is first
    info = pa.launch_plan.cache_info()
    assert (info.hits, info.misses) == (1, 1)
    with pytest.raises(ValueError, match="n_splits"):
        pa.launch_plan(8, 32, 8, 32, 128, H100_SMS, 0)


def _plans(max_blocks):
    """One split, two, one page per split, and an uneven cut."""
    return [(1, max_blocks), (2, -(-max_blocks // 2)), (max_blocks, 1), (-(-max_blocks // 4), 4)]


def _compare(ops, *, pallas: bool):
    jpos, jkw = _split(ops, jnp.asarray)
    want = np.asarray(paged_attention_reference(*jpos, block_size=BS, **jkw))
    kernel = np.asarray(paged_attention_pallas(*jpos, block_size=BS, interpret=True, **jkw)) if pallas else None
    tpos, tkw = _split(ops, torch.from_numpy)
    lens = np.asarray(ops["seq_lens"])
    sees = (lens > 0) | ("k_self" in ops)  # the others are zeros (the reference averages garbage)
    before = (pa.launches, pa.launches_int8)
    for n, per in _plans(MAX_BLOCKS):
        got = pa.paged_attention_split_ref(*tpos, block_size=BS, n_splits=n, pages_per_split=per,
                                           **tkw).numpy()
        np.testing.assert_allclose(got[sees], want[sees], atol=1e-5, rtol=1e-5)
        assert not got[~sees].any(), "a sequence that sees nothing is zeros"
        if kernel is not None:
            np.testing.assert_allclose(got, kernel, atol=1e-5, rtol=1e-5)
    assert (pa.launches, pa.launches_int8) == before
    return got


@pytest.mark.parametrize("with_self", [False, True], ids=["cache_only", "with_self"])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16_layout", "int8"])
@pytest.mark.parametrize("seed", [0, 1])
def test_split_ref_matches_jax_reference_and_pallas(seed, quant, with_self):
    _compare(make_operands(seed, quant, with_self), pallas=True)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16_layout", "int8"])
@pytest.mark.parametrize("lens", [
    [8, 9, 16, 17],      # a split edge (8 positions a page) and one past it
    [1, 48, 0, 47],      # a sequence that sees nothing; the whole table
    [0, 0, 0, 0],        # no sequence sees anything
], ids=["split_edges", "empty_and_full", "all_empty"])
@pytest.mark.parametrize("with_self", [False, True], ids=["cache_only", "with_self"])
def test_split_ref_edges(lens, quant, with_self):
    ops = make_operands(5, quant, with_self, seq_lens=np.array(lens, np.int32))
    got = _compare(ops, pallas=True)
    if with_self:  # seq_len 0 with self: the self value, for every head of the group
        group = N_Q // N_KV
        for b in np.flatnonzero(np.array(lens) == 0):
            np.testing.assert_allclose(
                got[b].reshape(N_KV, group, D), np.repeat(ops["v_self"][b][:, None, :], group, 1),
                atol=1e-6)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16_layout", "int8"])
def test_split_ref_cuts_seq_len_at_the_table(quant):
    """A seq_len past the table is cut at its span, as the JAX reference
    does (the Pallas kernel would walk past the table, so it is left out)."""
    lens = np.array([0, MAX_BLOCKS * BS + 9, 8, 3], np.int32)
    _compare(make_operands(2, quant, True, seq_lens=lens), pallas=False)


@settings(max_examples=40, deadline=None)
@given(
    lens=st.lists(st.integers(-3, MAX_BLOCKS * BS + 5), min_size=4, max_size=4),
    n_splits=st.integers(1, MAX_BLOCKS), with_self=st.booleans(), seed=st.integers(0, 5),
)
def test_split_ref_random_plans(lens, n_splits, with_self, seed):
    """Any plan of whole pages gives the plain version's output on the
    sequences that see a position (torch on both sides)."""
    ops = make_operands(seed, False, with_self, seq_lens=np.array(lens, np.int32))
    tpos, tkw = _split(ops, torch.from_numpy)
    n, per = pa.launch_plan(4, N_Q, N_KV, BS, MAX_BLOCKS, H100_SMS, n_splits)[0][-2:]
    got = pa.paged_attention_split_ref(*tpos, block_size=BS, n_splits=n, pages_per_split=per, **tkw)
    want = pa.paged_attention_reference(*tpos, block_size=BS, **tkw)
    sees = (np.array(lens) > 0) | with_self
    np.testing.assert_allclose(got.numpy()[sees], want.numpy()[sees], atol=1e-5, rtol=1e-5)
    assert not got.numpy()[~sees].any()
