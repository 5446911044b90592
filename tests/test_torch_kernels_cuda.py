"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA card and skips without one. The file imports
neither jax nor the JAX package, so it runs on a machine that has only
PyTorch; ``tests/conftest.py`` imports jax, so there run it without it::

    python -m pytest --noconftest -q -m cuda tests/test_torch_kernels_cuda.py

K1 has two kernels (split-KV decode and query-tiled); each runs forced on
every case, plus the edges of their plans. K2 (split-KV paged decode and
its combine) runs its planned split count and, forced, one split and one
page per split on every case.

Tolerance: the largest relative L2 error of one output vector (one query
row, one head) is at most 1e-2. Both sides round to bf16 (~1e-3 per vector)
and sum in other orders; the limit scales with the output, which shrinks as
1/sqrt(visible positions), so a dropped tile of a 4096-position row fails.
The kernels' int8 modes are held to the plain versions on the same int8
pages and scales, at the same limit.
"""

import numpy as np
import pytest
import torch

from dynamo_tpu_torch.engine.kv_quant import quantize_kv
from dynamo_tpu_torch.ops import paged_attention as pa
from dynamo_tpu_torch.ops import ragged_attention as ra

D = 128
PAGE = 32
ROW_REL_TOL = 1e-2

CASES = {
    # q_lens, kv_lens, S, pages_per_seq, n_kv, group
    "mixed_prefill_decode": ([70, 1, 33, 1], [90, 140, 33, 1], 4, 8, 8, 4),
    "q_len_zero": ([20, 0, 1, 0, 40], [60, 50, 80, 20, 40], 5, 4, 8, 4),
    "num_seqs_below_S": ([30, 1], [70, 20], 6, 4, 8, 4),
    "page_boundaries": ([32, 1, 64], [64, 96, 128], 3, 4, 8, 4),
    "long_decode": ([1, 1], [4096, 2049], 2, 128, 8, 4),
    "group1": ([20, 1, 1], [50, 90, 1], 3, 3, 4, 1),
    "group2": ([60, 1], [60, 110], 2, 4, 4, 2),
    "group8": ([1, 1, 30], [130, 40, 30], 3, 5, 2, 8),
}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU build")
    return torch.device("cuda")


def make_batch(q_lens, kv_lens, S, pages_per_seq, n_kv, group, seed, pad=5):
    """bf16 operands on the card: sequence s owns q rows cu[s]..cu[s+1]-1
    and its own pages; table entries past its pages and the ``pad`` rows
    past the last sequence point at the garbage page (the last one)."""
    dev = _card()
    rng = np.random.default_rng(seed)
    n_pages = S * pages_per_seq + 1
    T = sum(q_lens) + pad
    q = rng.standard_normal((T, n_kv * group, D)).astype(np.float32)
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
    on_card = [torch.from_numpy(a).to(dev) for a in (q, kv, lens, tables, cu, num_seqs)]
    on_card[0], on_card[1] = on_card[0].bfloat16(), on_card[1].bfloat16()
    return on_card


def _row_rel(got, want):
    g, w = got.float(), want.float()
    return ((g - w).norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-12)).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_matches_plain(case):
    q_lens = CASES[case][0]
    args = make_batch(*CASES[case], seed=0)
    before = ra.launches
    got = ra.ragged_paged_attention(*args, sm_scale=D ** -0.5)
    assert ra.launches == before + 1
    want = ra.ragged_paged_attention_ref(*args, sm_scale=D ** -0.5)
    n = sum(q_lens)
    g, w = got[:n].float(), want[:n].float()
    rel = (g - w).norm(dim=-1) / w.norm(dim=-1)
    assert rel.max().item() <= ROW_REL_TOL, f"max row relative error {rel.max().item():.3e}"
    assert not got[n:].any(), "rows past the last sequence are zero"


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_int8_kernel_matches_plain(case):
    q_lens = CASES[case][0]
    q, kv, *rest = make_batch(*CASES[case], seed=2)
    kv8, scales = quantize_kv(kv)
    before = ra.launches_int8
    got = ra.ragged_paged_attention(q, kv8, *rest, sm_scale=D ** -0.5, kv_scales=scales)
    assert ra.launches_int8 == before + 1
    want = ra.ragged_paged_attention_ref(q, kv8, *rest, sm_scale=D ** -0.5, kv_scales=scales)
    n = sum(q_lens)
    rel = _row_rel(got[:n], want[:n])
    assert rel <= ROW_REL_TOL, f"max row relative error {rel:.3e}"
    assert not got[n:].any(), "rows past the last sequence are zero"


def _split_edge_lens():
    """kv lengths at the decode plan's split edge and one past it, for the
    plan the wrapper picks at this case's shape (T = 4 + 5 padded rows)."""
    n, per = ra.decode_split_plan(9, 8, 128, PAGE, ra.sm_count(_card().index or 0))
    edge = per * PAGE
    return [edge, edge + 1, 2 * edge, 2 * edge + 1]


# Edges of the two kernels' plans (llama3-8b heads unless stated).
EDGE_CASES = {
    # q_lens, kv_lens (None: from the decode plan), S, pages_per_seq, n_kv, group
    "split_edges": ([1, 1, 1, 1], None, 4, 128, 8, 4),
    "page_edges": ([1, 1, 1, 1], [32, 33, 64, 31], 4, 4, 8, 4),
    "tile_straddles_sequences": ([10, 30, 7], [10, 45, 200], 3, 8, 8, 4),
    "shorter_than_a_tile": ([5, 1, 3], [5, 70, 3], 3, 4, 8, 4),
    "prefill": ([100, 37, 64], [100, 37, 64], 3, 4, 8, 4),
    "q_len_zero_prefill": ([0, 40, 0, 16], [30, 40, 9, 80], 4, 4, 8, 4),
    "num_seqs_below_S_prefill": ([17, 64], [17, 100], 5, 4, 8, 4),
}


@pytest.mark.cuda
@pytest.mark.parametrize("pages", ["bf16", "int8"])
@pytest.mark.parametrize("kernel", ["decode", "tiled"])
@pytest.mark.parametrize("case", list(CASES) + list(EDGE_CASES))
def test_each_kernel_matches_plain(case, kernel, pages):
    """Both kernels, forced, in both page types, on every case: each is
    right on every ragged batch, not only the ones the wrapper picks it
    for."""
    q_lens, kv_lens, *rest = {**CASES, **EDGE_CASES}[case]
    if kv_lens is None:
        kv_lens = _split_edge_lens()
    q, kv, *ops = make_batch(q_lens, kv_lens, *rest, seed=4)
    kw = {}
    if pages == "int8":
        kv, kw["kv_scales"] = quantize_kv(kv)
    name = ra.ENTRY_NAMES[kernel, pages == "int8"]
    before = ra.kernel_launches[name]
    got = ra.ragged_paged_attention_cuda(q, kv, *ops, sm_scale=D ** -0.5, kernel=kernel, **kw)
    assert ra.kernel_launches[name] == before + 1
    want = ra.ragged_paged_attention_ref(q, kv, *ops, sm_scale=D ** -0.5, **kw)
    n = sum(q_lens)
    rel = _row_rel(got[:n], want[:n])
    assert rel <= ROW_REL_TOL, f"max row relative error {rel:.3e}"
    assert not got[n:].any(), "rows past the last sequence are zero"


# The smoke's serving prompts (100-2000 tokens) 48 tokens into decode;
# 2000 + 48 ends on a split edge of the serving plan (8 pages a split).
SERVING_DECODE_LENS = [n + 48 for n in (2000, 1124, 100, 700, 1500, 300, 1800, 1074)]


@pytest.mark.cuda
@pytest.mark.parametrize("pages", ["bf16", "int8"])
def test_serving_decode_shape(pages):
    """The engine's decode form at its serving shape: T == S == 8, no padded
    rows, pages_per_seq 256 (the default EngineConfig), so the dispatch
    takes the decode kernel with the serving plan's many splits and its
    combine."""
    dev = _card()
    n, per = ra.decode_split_plan(8, 8, 256, PAGE, ra.sm_count(dev.index or 0))
    assert n > 16 and n * per >= 256, (n, per)
    q, kv, *ops = make_batch([1] * 8, SERVING_DECODE_LENS, 8, 256, 8, 4, seed=6, pad=0)
    kw = {}
    if pages == "int8":
        kv, kw["kv_scales"] = quantize_kv(kv)
    name = ra.ENTRY_NAMES["decode", pages == "int8"]
    before = ra.kernel_launches[name]
    got = ra.ragged_paged_attention(q, kv, *ops, sm_scale=D ** -0.5, **kw)
    assert ra.kernel_launches[name] == before + 1
    want = ra.ragged_paged_attention_ref(q, kv, *ops, sm_scale=D ** -0.5, **kw)
    rel = _row_rel(got, want)
    assert rel <= ROW_REL_TOL, f"max row relative error {rel:.3e}"


K2_CASES = {
    # B, n_kv, group, bs, max_blocks, seq_lens (None: random up to the span)
    "bench_kvquant": (16, 8, 4, 32, 8, [251] * 16),
    "decode8_llama": (8, 8, 4, 32, 128, [4096, 3000, 2048, 1500, 1024, 700, 300, 0]),
    "group1_edges": (3, 4, 1, 16, 5, [1, 80, 95]),
    "group8": (4, 2, 8, 32, 3, [31, 32, 33, 96]),
    "decode64": (64, 8, 4, 32, 128, [int(x) for x in np.random.default_rng(2).integers(1, 4097, 64)]),
}


def k2_operands(B, n_kv, group, bs, max_blocks, seq_lens, *, q_dtype, quant, with_self, seed):
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(seed)
    total = (B * max_blocks + 1) * bs
    q = torch.randn(B, n_kv * group, D, device=dev, generator=gen).to(q_dtype)
    k = torch.randn(n_kv, total, D, device=dev, generator=gen).bfloat16()
    v = torch.randn(n_kv, total, D, device=dev, generator=gen).bfloat16()
    perm = torch.randperm(B * max_blocks, device=dev, generator=gen).to(torch.int32)
    tables = perm.reshape(B, max_blocks).contiguous()
    lens = torch.tensor(seq_lens, dtype=torch.int32, device=dev)
    kw = {}
    if quant:
        (k, kw["k_scale"]), (v, kw["v_scale"]) = quantize_kv(k), quantize_kv(v)
    if with_self:
        kw["k_self"] = torch.randn(B, n_kv, D, device=dev, generator=gen).to(q_dtype)
        kw["v_self"] = torch.randn(B, n_kv, D, device=dev, generator=gen).to(q_dtype)
    return (q, k, v, tables, lens), kw


@pytest.mark.cuda
@pytest.mark.parametrize("with_self", [False, True], ids=["cache_only", "with_self"])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16_pages", "int8_pages"])
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16], ids=["q_f32", "q_bf16"])
@pytest.mark.parametrize("case", list(K2_CASES))
def test_paged_attention_kernel_matches_plain(case, q_dtype, quant, with_self):
    B, n_kv, group, bs, max_blocks, lens = K2_CASES[case]
    if not with_self and 0 in lens:
        lens = [max(1, n) for n in lens]  # nothing to attend: the plain version averages garbage
    args, kw = k2_operands(B, n_kv, group, bs, max_blocks, lens, q_dtype=q_dtype,
                           quant=quant, with_self=with_self, seed=3)
    counter = "launches_int8" if quant else "launches"
    before = getattr(pa, counter)
    got = pa.paged_attention(*args, block_size=bs, **kw)
    assert getattr(pa, counter) == before + 1
    assert got.dtype == q_dtype
    want = pa.paged_attention_reference(*args, block_size=bs, **kw)
    rel = _row_rel(got, want)
    assert rel <= ROW_REL_TOL, f"max row relative error {rel:.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("n_splits", ["one", "many"])
@pytest.mark.parametrize("with_self", [False, True], ids=["cache_only", "with_self"])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16_pages", "int8_pages"])
@pytest.mark.parametrize("case", list(K2_CASES))
def test_paged_attention_forced_splits(case, quant, with_self, n_splits):
    """Each K2 case with the plan forced to one split (the block writes the
    output, folding in self) and to one page per split (partials and the
    combine), with bf16 q (f32 q at the comparison's shape)."""
    B, n_kv, group, bs, max_blocks, lens = K2_CASES[case]
    if not with_self:
        lens = [max(1, n) for n in lens]
    q_dtype = torch.float32 if case == "bench_kvquant" else torch.bfloat16
    args, kw = k2_operands(B, n_kv, group, bs, max_blocks, lens, q_dtype=q_dtype,
                           quant=quant, with_self=with_self, seed=5)
    counter = "launches_int8" if quant else "launches"
    before = getattr(pa, counter)
    forced = 1 if n_splits == "one" else max_blocks
    got = pa.paged_attention_cuda(*args, block_size=bs, n_splits=forced, **kw)
    assert getattr(pa, counter) == before + 1
    want = pa.paged_attention_reference(*args, block_size=bs, **kw)
    rel = _row_rel(got, want)
    assert rel <= ROW_REL_TOL, f"max row relative error {rel:.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("n_splits", [1, 3, None], ids=["one", "three", "planned"])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16_pages", "int8_pages"])
def test_paged_attention_sequence_that_sees_nothing(quant, n_splits):
    """seq_len 0: zeros without self, the self value with it (every head of
    the group); the other rows still match the plain version."""
    B, n_kv, group, bs, max_blocks = 4, 8, 4, 32, 6
    lens = [0, 100, 0, 192]
    for with_self in (False, True):
        args, kw = k2_operands(B, n_kv, group, bs, max_blocks, lens, q_dtype=torch.bfloat16,
                               quant=quant, with_self=with_self, seed=9)
        counter = "launches_int8" if quant else "launches"
        before = getattr(pa, counter)
        got = pa.paged_attention_cuda(*args, block_size=bs, n_splits=n_splits, **kw)
        assert getattr(pa, counter) == before + 1
        want = pa.paged_attention_reference(*args, block_size=bs, **kw)
        assert _row_rel(got[[1, 3]], want[[1, 3]]) <= ROW_REL_TOL
        for b in (0, 2):
            if with_self:
                v_self = kw["v_self"][b].float().repeat_interleave(group, dim=0)
                assert _row_rel(got[b], v_self) <= ROW_REL_TOL
            else:
                assert not got[b].any(), "no position and no self: zeros"


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take():
    args = make_batch([3, 1], [5, 7], 2, 1, 8, 4, seed=1)
    with pytest.raises(TypeError, match="without kv_scales"):
        ra.ragged_paged_attention(*args[:1], args[1].to(torch.int8), *args[2:], sm_scale=0.1)
    with pytest.raises(TypeError, match="int8"):
        ra.ragged_paged_attention(*args, sm_scale=0.1, kv_scales=torch.ones(args[1].shape[:-1], device=args[0].device))
    with pytest.raises(TypeError, match="bf16"):
        ra.ragged_paged_attention(args[0].float(), *args[1:], sm_scale=0.1)
    with pytest.raises(ValueError, match="on cpu"):
        ra.ragged_paged_attention(args[0], args[1], args[2].cpu(), *args[3:], sm_scale=0.1)
