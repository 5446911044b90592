"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA card and skips without one. The file imports
neither jax nor the JAX package, so it runs on a machine that has only
PyTorch; ``tests/conftest.py`` imports jax, so there run it without it::

    python -m pytest --noconftest -q -m cuda tests/test_torch_kernels_cuda.py

Tolerance: the largest relative L2 error of one output vector (one query
row, one head) is at most 1e-2. Both sides round to bf16 (~1e-3 per vector)
and sum in other orders; the limit scales with the output, which shrinks as
1/sqrt(visible positions), so a dropped tile of a 4096-position row fails.
"""

import numpy as np
import pytest
import torch

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


def make_batch(q_lens, kv_lens, S, pages_per_seq, n_kv, group, seed):
    """bf16 operands on the card: sequence s owns q rows cu[s]..cu[s+1]-1
    and its own pages; table entries past its pages and rows past the last
    sequence point at the garbage page (the last one)."""
    dev = _card()
    rng = np.random.default_rng(seed)
    n_pages = S * pages_per_seq + 1
    T = sum(q_lens) + 5  # padded rows past cu[num_seqs]
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
def test_kernel_refuses_what_it_does_not_take():
    args = make_batch([3, 1], [5, 7], 2, 1, 8, 4, seed=1)
    with pytest.raises(NotImplementedError, match="A9"):
        ra.ragged_paged_attention(*args, sm_scale=0.1, kv_scales=torch.ones(1, device=args[0].device))
    with pytest.raises(TypeError, match="bf16"):
        ra.ragged_paged_attention(args[0].float(), *args[1:], sm_scale=0.1)
    with pytest.raises(ValueError, match="on cpu"):
        ra.ragged_paged_attention(args[0], args[1], args[2].cpu(), *args[3:], sm_scale=0.1)
