"""The plans the K1 wrapper hands its two CUDA kernels, and the plain
version of the split-KV arithmetic, on the CPU.

- ``decode_split_plan``: splits of whole pages that cover the block table,
  enough blocks to fill the card at the serving decode width;
- ``tiled_plan``: the grid's bound leaves no query row, real or padded,
  without exactly one writer (every case of the attention tests and random
  ragged batches) under the kernel's block-to-rows rule, restated here as
  ``tile_owners``;
- ``decode_scratch_shapes``, ``launch_plan`` (the entry points' int
  arguments and scratch, once per shape) and the ``T == S`` dispatch;
- ``ragged_paged_attention_split_ref`` (partials per split, log-sum-exp
  merge) against the JAX ``ragged_paged_attention_ref``, bf16-layout and
  int8 pages, at atol = rtol = 1e-5 in f32 (the same masked softmax summed
  in another order), with splits and rows that see no position.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from dynamo_tpu.engine.kv_quant import quantize_kv
from dynamo_tpu.ops.ragged_attention import ragged_paged_attention_ref as jax_ref
from dynamo_tpu_torch.engine import model
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.ops import ragged_attention as ra
from tests.test_torch_ragged_attention import CASES, D, make_batch

H100_SMS = 132


@pytest.mark.parametrize("T, n_kv, pps, page_size, sms", [
    (8, 8, 128, 32, H100_SMS),     # decode8 of the kernel checks
    (8, 8, 256, 32, H100_SMS),     # the engine's serving decode
    (64, 8, 128, 32, H100_SMS),    # decode64
    (64, 8, 256, 32, H100_SMS),
    (1, 8, 3, 32, H100_SMS),       # a table shorter than one split's floor
    (2, 2, 40, 4, 16),             # small pages: the position floor binds
    (4096, 8, 256, 32, H100_SMS),  # many rows: one split
])
def test_decode_split_plan(T, n_kv, pps, page_size, sms):
    n, per = ra.decode_split_plan(T, n_kv, pps, page_size, sms)
    assert n >= 1 and per >= 1
    assert n * per >= pps, "the splits cover the block table"
    assert (n - 1) * per < pps, "every split starts inside the table"
    if n > 1:
        assert per * page_size >= ra.MIN_SPLIT_POSITIONS
    most = pps // max(1, -(-ra.MIN_SPLIT_POSITIONS // page_size))
    if T * n_kv * most >= 2 * sms:
        assert T * n_kv * n >= 2 * sms, "at least 2 blocks per SM when rows are full"


def test_decode8_plan_fills_the_card():
    n, per = ra.decode_split_plan(8, 8, 128, 32, H100_SMS)
    assert 8 * 8 * n >= 2 * H100_SMS
    assert (n, per) == (16, 8)


def test_decode_scratch_shapes():
    o, ml = ra.decode_scratch_shapes(8, 32, 8, 16)
    assert o == (8, 8, 16, 4, 128)
    assert ml == (8, 8, 16, 4, 2)


@pytest.mark.parametrize("T, n_q, n_kv, pps, S", [
    (8, 32, 8, 256, 8),    # the engine's serving decode: 32 splits of 8 pages
    (64, 32, 8, 128, 64),  # decode64
    (1, 32, 8, 3, 1),      # one split: the block writes the output itself
])
def test_decode_launch_plan(T, n_q, n_kv, pps, S):
    ints, n_o, n_ml = ra.launch_plan("decode", T, n_q, n_kv, 32, pps, S, H100_SMS)
    n, per = ra.decode_split_plan(T, n_kv, pps, 32, H100_SMS)
    assert ints == (T, n_q, n_kv, 32, pps, S, n, per)
    o, ml = ra.decode_scratch_shapes(T, n_q, n_kv, n)
    assert (n_o, n_ml) == ((np.prod(o), np.prod(ml)) if n > 1 else (0, 0))
    assert n_o % 128 == 0, "(m, l) starts 16-byte aligned after o"


def test_tiled_launch_plan():
    ints, n_o, n_ml = ra.launch_plan("tiled", 8192, 32, 8, 32, 256, 8, H100_SMS)
    assert ints == (8192, 32, 8, 32, 256, 8, *ra.tiled_plan(8192, 8, 4))
    assert (n_o, n_ml) == (0, 0)
    with pytest.raises(ValueError, match="kernel must be"):
        ra.launch_plan("dense", 8, 32, 8, 32, 256, 8, H100_SMS)


def test_launch_counts_by_page_type():
    """``launches`` / ``launches_int8`` are the per-entry counts summed."""
    saved = dict(ra.kernel_launches)
    try:
        ra.reset_launches()
        assert (ra.launches, ra.launches_int8) == (0, 0)
        ra.kernel_launches[ra.INSTANCE_NAMES["decode", False, 128]] += 3
        ra.kernel_launches[ra.INSTANCE_NAMES["tiled", False, 128]] += 1
        ra.kernel_launches[ra.INSTANCE_NAMES["tiled", True, 128]] += 2
        assert (ra.launches, ra.launches_int8) == (4, 2)
    finally:
        ra.kernel_launches.update(saved)


@pytest.mark.parametrize("T, S, kernel", [
    (8, 8, "decode"), (64, 64, "decode"), (1, 1, "decode"),
    (8192, 8, "tiled"), (128, 8, "tiled"), (9, 4, "tiled"), (4, 6, "tiled"),
])
def test_kernel_for(T, S, kernel):
    assert ra.kernel_for(T, S) == kernel


def test_engine_decode_batch_takes_the_decode_kernel(monkeypatch):
    """``model.decode_tokens`` builds the T == S form and states the decode
    kernel for it."""
    seen = {}

    def capture(params, cache, tokens, positions, write_pages, write_offs, kv_lens,
                block_tables, cu, num_seqs, rows, cfg, attention, kernel, mesh=None):
        seen["T"], seen["S"], seen["kernel"] = tokens.shape[0], block_tables.shape[0], kernel
        assert mesh is None  # one device: no tensor parallelism
        return torch.zeros(1)

    monkeypatch.setattr(model, "forward_tokens", capture)
    eng = EngineConfig(num_kv_blocks=16, max_model_len=128)
    B = 5
    model.decode_tokens(
        None, None, torch.zeros(B, dtype=torch.int32),
        torch.zeros(B, eng.max_blocks_per_seq, dtype=torch.int32),
        torch.arange(B, dtype=torch.int32), torch.ones(B, dtype=torch.bool), None, eng,
    )
    assert seen["T"] == seen["S"] == B and seen["kernel"] == "decode"


def tile_owners(cu_q_lens, num_seqs, num_tokens, n_blocks, rows_per_tile):
    """The query rows each block of the tiled grid writes, by the rule of
    ``ragged_paged_attention_tiled_kernel``: tiles sequence after sequence,
    then the padded rows past ``cu[num_seqs]`` in runs of ``rows_per_tile``
    to the spare blocks."""
    spans = []
    for s in range(num_seqs):
        q_len = cu_q_lens[s + 1] - cu_q_lens[s]
        for tile in range(-(-q_len // rows_per_tile)):
            r0 = cu_q_lens[s] + tile * rows_per_tile
            spans.append(range(r0, min(r0 + rows_per_tile, cu_q_lens[s + 1])))
    n_real = len(spans)
    end = cu_q_lens[num_seqs]
    for j in range(n_real, n_blocks):
        r0 = end + (j - n_real) * rows_per_tile
        spans.append(range(r0, max(r0, min(r0 + rows_per_tile, num_tokens))))
    return spans[:n_blocks]


def _assert_rows_covered_once(q_lens, S, T, group):
    cu = [0]
    for n in q_lens:
        cu.append(cu[-1] + n)
    cu += [cu[-1]] * (S + 1 - len(cu))
    n_blocks, rows = ra.tiled_plan(T, S, group)
    assert rows * group <= ra.TILE_M
    owners = tile_owners(cu, len(q_lens), T, n_blocks, rows)
    count = np.zeros(T, np.int64)
    for span in owners:
        assert len(span) <= rows
        count[list(span)] += 1
    assert (count == 1).all(), f"rows written {count.tolist()}"
    # A real tile never straddles two sequences.
    for span in owners:
        if len(span) and span[0] < cu[len(q_lens)]:
            s = int(np.searchsorted(cu[1:], span[0], side="right"))
            assert span[-1] < cu[s + 1]


@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("case", list(CASES))
def test_tiled_grid_covers_every_row_once(case, group):
    q_lens, _, S, *_ = CASES[case]
    _assert_rows_covered_once(q_lens, S, sum(q_lens) + 3, group)


@settings(max_examples=200, deadline=None)
@given(
    q_lens=st.lists(st.integers(0, 300), min_size=1, max_size=40),
    extra_seqs=st.integers(0, 5),
    pad=st.integers(0, 200),
    group=st.sampled_from([1, 2, 3, 4, 5, 8]),
)
def test_tiled_grid_covers_random_batches(q_lens, extra_seqs, pad, group):
    _assert_rows_covered_once(q_lens, len(q_lens) + extra_seqs, sum(q_lens) + pad, group)


def _plans(pps):
    """One split, two, and one page per split."""
    return [(1, pps), (2, -(-pps // 2)), (pps, 1)]


def _compare_split_ref(q_lens, kv_lens, S, pps, n_q, n_kv, seed, int8):
    q, kv, lens, tables, cu, ns = make_batch(q_lens, kv_lens, S, pps, n_q, n_kv, seed)
    kw_jax, kw = {}, {}
    if int8:
        kv, scales = (np.array(a) for a in jax.jit(quantize_kv)(jnp.asarray(kv)))
        kw_jax["kv_scales"] = jnp.asarray(scales)
        kw["kv_scales"] = torch.from_numpy(scales)
    want = np.asarray(jax_ref(*(jnp.asarray(a) for a in (q, kv, lens, tables, cu, ns)),
                              sm_scale=D ** -0.5, **kw_jax))
    # Rows that see a position; the others are the kernels' zeros.
    seq = np.minimum(np.searchsorted(cu[1:], np.arange(q.shape[0]), side="right"), S - 1)
    t = np.arange(q.shape[0])
    abs_pos = lens[seq] - (cu[seq + 1] - cu[seq]) + (t - cu[seq])
    sees = (t < cu[len(q_lens)]) & (np.minimum(abs_pos + 1, lens[seq]) > 0)
    before = (ra.launches, ra.launches_int8)
    for n_splits, per in _plans(pps):
        got = ra.ragged_paged_attention_split_ref(
            *(torch.from_numpy(a) for a in (q, kv, lens, tables, cu, ns)),
            sm_scale=D ** -0.5, n_splits=n_splits, pages_per_split=per, **kw,
        ).numpy()
        np.testing.assert_allclose(got[sees], want[sees], atol=1e-5, rtol=1e-5)
        assert not got[~sees].any(), "rows that see no position are zeros"
    assert (ra.launches, ra.launches_int8) == before


@pytest.mark.parametrize("int8", [False, True], ids=["bf16_layout", "int8"])
@pytest.mark.parametrize("case", list(CASES))
def test_split_ref_matches_jax_reference(case, int8):
    _compare_split_ref(*CASES[case], seed=7, int8=int8)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16_layout", "int8"])
@pytest.mark.parametrize("q_lens, kv_lens, S, pps", [
    ([1, 1, 1, 1], [8, 9, 16, 17], 4, 6),  # kv_len at a split edge and one past it
    ([1, 1], [1, 24], 2, 6),                # most splits see nothing
    ([3, 1], [1, 5], 2, 2),                 # rows ahead of their cache see nothing
])
def test_split_ref_edges(q_lens, kv_lens, S, pps, int8):
    _compare_split_ref(q_lens, kv_lens, S, pps, 4, 2, seed=11, int8=int8)
