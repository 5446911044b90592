#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``dynamo_tpu_torch``).

Run from the repository root on a machine with one CUDA card::

    python3 chip_smoke.py

It (1) prints the card's name and power limit, (2) builds every kernel of
the port from ``dynamo_tpu_torch/csrc`` with nvcc, together with copies
holding planted faults (one nvcc per source, all started at once), (3)
holds each kernel against its plain PyTorch version on the card and times
both, each launch with the L2 flushed before it (as a layer's pages are
on the serving path): K1's two kernels (split-KV decode and query-tiled),
each forced, with bf16 and with int8 pages, at llama3-8b head shapes,
among them the serving decode form's and the prefill wave's, beside a
yardstick of a different function (dense causal
``scaled_dot_product_attention`` on the same rows laid out
contiguously); K2 (split-KV paged decode attention and its combine)
with bf16 and int8 pages, with and without the self position, at the
int8-against-bf16 comparison's shape and llama3-8b decode shapes, each
with its planned split count; and shows that the comparison fails every
planted fault (K2: the self position dropped, a tile dropped, the combine
dropping the last split, two splits overlapping by a page, int8 V with
K's scale), (4) runs K2's own path, that
int8-page against bf16-page decode-attention comparison, through
``paged_attention``, (5) serves 8 requests through
``build_engine("llama3-8b")`` and ``TorchEngine.generate`` at full width
and depth with random weights, bf16 first, then, with the bf16 engine
freed, int8 weights and int8 KV pages (``{"kv_dtype": "int8"}``,
``quant="int8"``), checking token counts, finish reasons, the prefix
cache, the launch counts of K1 and of each of its kernels (counted
across graph replays), finite logits and megastep k=1 == k=8 greedy
streams; each engine first runs ``warm_up()``, which captures the CUDA
graphs, so every prefill wave and decode megastep of the main path is a
graph replay (checked: replays == dispatches); then one decode megastep
(width 8, k = 8) is replayed from its graph and run as the eager body
from the same cache copy and inputs (tokens equal, both timed per
iteration), and the traffic runs again through the warm engine and an
async engine on the same weights (streams equal, decode ms per
iteration and TTFT printed for each), (6) runs the worker process:
the port's store (``python -m dynamo_tpu_torch.runtime.store``) and
``python -m dynamo_tpu_torch.backends.torch --model-name llama3-8b
--preset llama3-8b --seed 0`` as subprocesses, waits for the model card
through the port's discovery and sends requests through the port's
data-plane client: 4 greedy prompts one at a time, whose streams must
equal those of ``build_engine("llama3-8b", seed=0)`` in this process
(run first with the same traffic, and freed), then all 8 at once, then,
with the prefix cache cleared, all 8 again staggered (one, and the other
7 0.1 s later, an arrival pattern neither path shapes), with time to
first token and decode ms per iteration printed beside the in-process
engine's, then one prompt again, which must report cached tokens and
whose full blocks' hashes must be among the worker's KV events; the
worker's own counters must show K1's two kernels launched once per layer
of every forward; a second worker with ``--async-exec on`` answers the 4
solo prompts with the sync worker's chunks (but for the engine step the
first chunk names); it also times the data plane alone, a server process
replaying the batch's recorded chunks to a client in this process, and
(7) prints a JSON line of
kernel measurements (one record per C entry point) and, last, a JSON
status line. Any failed check raises and the script exits non-zero.
Without a card it exits non-zero at once and prints no result.
"""

from __future__ import annotations

import asyncio
import ctypes
import gc
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
BF16_OPS_PER_S = 989e12     # H100 SXM dense bf16 tensor-core peak
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
SCALE_BYTES = 4             # one f32 scale per (slot, combined head) of int8 pages
N_Q, N_KV, HEAD_DIM, PAGE = 32, 8, 128, 32  # llama3-8b attention geometry
# Kernel against plain version: the largest relative L2 error of one
# output vector (one query row, one head) over the real rows. Both sides
# round to bf16 (relative step 2**-8, so ~1e-3 per vector in L2) and sum in
# other orders. The limit is scaled to the output, whose size falls as
# 1/sqrt(visible positions): an absolute limit that passes bf16 rounding
# at short rows would pass a dropped tile at 4096 positions.
ROW_REL_TOL = 1e-2


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back launches
    (CUDA events), after one warm-up call, the L2 warm: only K2's own
    int8-against-bf16 comparison, which runs that way."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


_FLUSH: list = []  # a 256 MB buffer, five times the 50 MB L2


def cold_ms(fn, reps: int) -> float:
    """Mean device time of one call of ``fn`` with the L2 flushed before
    it, as a layer's pages are on the serving path: each of ``reps`` calls
    runs after a read and write of a 256 MB buffer, timed by its own event
    pair (the flush is outside the pair); one warm-up call first."""
    if not _FLUSH:
        _FLUSH.append(torch.empty(256 << 20, dtype=torch.uint8, device="cuda"))
    fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(reps)]
    for start, end in pairs:
        _FLUSH[0].add_(1)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in pairs) / reps


# -- kernel against its plain version --------------------------------------

def compare(got, want, n_real: int) -> tuple[float, float, bool]:
    """(largest relative L2 error of an output vector, largest absolute
    error, ok): ok when the first is within ROW_REL_TOL and every padded
    row past the ``n_real`` real ones is zero."""
    g, w = got[:n_real].float(), want[:n_real].float()
    rel = ((g - w).norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-12)).max().item()
    err = (got.float() - want.float()).abs().max().item()
    return rel, err, rel <= ROW_REL_TOL and not got[n_real:].any().item()


def attention_batch(q_lens, kv_lens, S, pages_per_seq, T, gen):
    """Ragged operands on the card: sequence s owns q rows cu[s]..cu[s+1]-1
    and its own pages; rows past cu[num_seqs] and table entries past a
    sequence's pages point at the garbage page. Returns the positional
    operands and the keyword ones (none for bf16 pages)."""
    dev = "cuda"
    n_pages = sum(-(-L // PAGE) for L in kv_lens) + 1
    q = torch.randn(T, N_Q, HEAD_DIM, device=dev, generator=gen).bfloat16()
    kv = torch.randn(n_pages, PAGE, 2 * N_KV, HEAD_DIM, device=dev, generator=gen).bfloat16()
    perm = torch.randperm(n_pages - 1, device=dev, generator=gen).to(torch.int32)
    tables = torch.full((S, pages_per_seq), n_pages - 1, dtype=torch.int32, device=dev)
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
    as_dev = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return (q, kv, as_dev(lens), tables, as_dev(cu),
            as_dev(np.array([len(q_lens)], np.int32))), {}


def quantized(args, kw):
    """The same batch with its pages quantized to int8 plus scales."""
    from dynamo_tpu_torch.engine.kv_quant import quantize_kv

    kv8, scales = quantize_kv(args[1])
    return (args[0], kv8, *args[2:]), {**kw, "kv_scales": scales}


def attention_bound(q_lens, kv_lens, T, int8=False):
    """Least time for this call's work: each input byte the data needs
    read once (q rows, the visible K/V rows and, for int8 pages, their
    scales, the table entries in use), the output written once; operations
    4 * visible positions * n_q * d (QK^T and PV, a multiply-add counted
    as 2)."""
    kv_rows = sum(kv_lens)
    pages = sum(-(-L // PAGE) for L in kv_lens)
    row_bytes = HEAD_DIM + SCALE_BYTES if int8 else HEAD_DIM * 2
    nbytes = (
        sum(q_lens) * N_Q * HEAD_DIM * 2        # q (bf16)
        + kv_rows * 2 * N_KV * row_bytes        # K and V rows (+ scales)
        + T * N_Q * HEAD_DIM * 2                # out (bf16)
        + 4 * (pages + 2 * len(kv_lens) + 2)    # tables, kv_lens, cu, num_seqs
    )
    visible = sum(
        min(L - q + i + 1, L) for q, L in zip(q_lens, kv_lens) for i in range(q)
    )
    ops = 4 * visible * N_Q * HEAD_DIM
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


K1_KERNELS = ("decode", "tiled")


def sdpa_yardstick(args, kw, q_lens, kv_lens):
    """A yardstick of a different function: dense causal
    ``scaled_dot_product_attention`` on the same rows with each sequence's
    K/V laid out contiguously (bf16; int8 pages dequantized; kv heads
    repeated for the group). A decode batch is one call, padded to the
    longest row with a key mask; other batches one call per sequence
    (``is_causal`` where q_len == kv_len, a lower-right mask otherwise).
    Returns the call to time. The port never calls it."""
    from dynamo_tpu_torch.engine.kv_quant import dequantize_kv

    F = torch.nn.functional
    q, kv, _, tables, cu, _ = args
    group = N_Q // N_KV
    cu_h = cu.tolist()

    def contiguous(s, L):
        pos = torch.arange(L, device=q.device)
        slots = tables[s].long()[pos // PAGE] * PAGE + pos % PAGE
        rows = kv.reshape(-1, 2 * N_KV, HEAD_DIM)[slots]
        if "kv_scales" in kw:
            rows = dequantize_kv(rows, kw["kv_scales"].reshape(-1, 2 * N_KV)[slots]).bfloat16()
        k, v = (rows[:, i::2].repeat_interleave(group, dim=1).transpose(0, 1) for i in (0, 1))
        return k, v                                                    # [n_q, L, d]

    if all(n == 1 for n in q_lens):
        B, L = len(q_lens), max(kv_lens)
        k = torch.zeros(B, N_Q, L, HEAD_DIM, dtype=torch.bfloat16, device=q.device)
        v = torch.zeros_like(k)
        for s, n in enumerate(kv_lens):
            k[s, :, :n], v[s, :, :n] = contiguous(s, n)
        mask = (torch.arange(L, device=q.device)[None, :]
                < torch.tensor(kv_lens, device=q.device)[:, None])[:, None, None, :]
        qs = q[:B].unsqueeze(2)                                        # [B, n_q, 1, d]
        return lambda: F.scaled_dot_product_attention(qs, k, v, attn_mask=mask)
    calls = []
    for s, (n, L) in enumerate(zip(q_lens, kv_lens)):
        if n == 0:
            continue
        k, v = contiguous(s, L)
        qs = q[cu_h[s]:cu_h[s] + n].transpose(0, 1).unsqueeze(0)     # [1, n_q, n, d]
        if n == L:
            calls.append((qs, k[None], v[None], None, True))
        else:
            i = torch.arange(n, device=q.device)[:, None]
            p = torch.arange(L, device=q.device)[None, :]
            calls.append((qs, k[None], v[None], p <= L - n + i, False))
    return lambda: [F.scaled_dot_product_attention(qq, kk, vv, attn_mask=m, is_causal=c)
                    for qq, kk, vv, m, c in calls]


def hold_k1(ra, name, args, kw, want, q_lens, kv_lens, T, int8, reps, plain_ms, tag):
    """Both K1 kernels, forced, on one batch against the plain output
    ``want``, each timed with the L2 flushed; the yardstick beside them.
    Raises if either disagrees."""
    scale = HEAD_DIM ** -0.5
    bound_ms, bound_by = attention_bound(q_lens, kv_lens, T, int8)
    sdpa_ms = cold_ms(sdpa_yardstick(args, kw, q_lens, kv_lens), reps)
    torch.cuda.empty_cache()
    out = []
    for kernel in K1_KERNELS:
        run = lambda: ra.ragged_paged_attention_cuda(*args, sm_scale=scale, kernel=kernel, **kw)  # noqa: E731
        got = run()
        torch.cuda.synchronize()
        rel, err, ok = compare(got, want, sum(q_lens))
        del got
        ms = cold_ms(run, reps)
        out.append(dict(
            shape=name, kernel=kernel, T=T, S=args[3].shape[0], num_seqs=len(q_lens),
            max_kv_len=max(kv_lens), ok=ok, max_row_rel_err=rel, max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            yardstick_sdpa_ms=sdpa_ms,
        ))
        print(f"{tag} {kernel} {name}: ok={ok} max_row_rel_err={rel:.3e} max_abs_err={err:.3e} "
              f"kernel {ms:.4f} ms plain {plain_ms:.3f} ms bound {bound_ms:.4f} ms ({bound_by}); "
              f"kernel/bound {ms / bound_ms:.1f}x; kernel/plain {ms / plain_ms:.4f}", flush=True)
        if not ok:
            raise AssertionError(f"{tag} {kernel} kernel disagrees with its plain version on {name}")
    print(f"{tag} {name}: yardstick (a different function: dense causal "
          f"scaled_dot_product_attention on the rows laid out contiguously) {sdpa_ms:.4f} ms",
          flush=True)
    return out


def check_attention_kernel(ra, decode_lens, int8=False) -> tuple[list[dict], list[tuple]]:
    """Both K1 kernels against ragged_paged_attention_ref on several ragged
    batches at llama3-8b head shapes, with bf16 pages or (``int8``) the
    same pages quantized; returns the measurements and, for the
    planted-fault check, each batch with its plain output. One batch is the
    main path's decode form: T == S == 8, pages_per_seq 256 as the engine
    has it (the serving plan's 32 splits and its combine), kv lengths
    ``decode_lens``. The plain version materialises [T, pages_per_seq * 32,
    16, 128] f32 (decode_serving8: 8 * 8192 * 16 * 128 * 4 B = 0.5 GB;
    decode64: 64 * 4096 * 16 * 128 * 4 B = 2.1 GB; mixed_padded: 512 *
    2048 * 16 * 128 * 4 B = 8.6 GB)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    tag = "attention int8" if int8 else "attention"
    rng = np.random.default_rng(0)
    cases = [
        # name, q_lens, kv_lens, S, pages_per_seq, T (bucket)
        ("decode_serving8", [1] * 8, decode_lens, 8, 256, 8),
        ("decode8", [1] * 8, [4096, 3000, 2048, 1500, 1024, 700, 300, 33], 8, 128, 8),
        ("decode64", [1] * 64, [int(x) for x in rng.integers(1, 4097, 64)], 64, 128, 64),
        ("mixed_padded", [256, 64, 1, 1, 1, 1], [256, 1024, 2000, 1500, 64, 500], 8, 64, 512),
        ("pages_edge_padded", [32, 1, 1], [64, 2048, 32], 6, 64, 64),
    ]
    scale = HEAD_DIM ** -0.5
    results, batches = [], []
    for name, q_lens, kv_lens, S, pps, T in cases:
        args, kw = attention_batch(q_lens, kv_lens, S, pps, T, gen)
        if int8:
            args, kw = quantized(args, kw)
        plain = lambda: ra.ragged_paged_attention_ref(*args, sm_scale=scale, **kw)  # noqa: E731
        want = plain()
        plain_ms = cold_ms(plain, 3)
        torch.cuda.empty_cache()
        results += hold_k1(ra, name, args, kw, want, q_lens, kv_lens, T, int8, 20, plain_ms, tag)
        batches.append((name, args, kw, want, sum(q_lens)))
        torch.cuda.empty_cache()
    return results, batches


# Faults planted in copies of the kernels' sources: (text, replacement).
# K1, by kernel: each copy runs its kernel, forced, on every batch.
PLANTED_FAULTS = {
    "decode": {
        "decode_drops_second_tile": (
            "    const unsigned char* st = ring + (it % kDecStages) * kStageBytes;",
            "    if (it == 1) continue;\n    const unsigned char* st = ring + (it % kDecStages) * kStageBytes;",
        ),
        "decode_misses_own_position": (
            "dec_vis = min(abs_pos + 1, kv_len);", "dec_vis = min(abs_pos, kv_len);",
        ),
        "decode_sees_next_position": (
            "dec_vis = min(abs_pos + 1, kv_len);", "dec_vis = min(abs_pos + 2, kv_len);",
        ),
        "combine_drops_last_split": (
            "min(n_splits, (row_vis + split_len - 1) / split_len)",
            "max(1, min(n_splits, (row_vis + split_len - 1) / split_len) - 1)",
        ),
    },
    "tiled": {
        "tiled_drops_second_tile": (
            "    // S = Q K^T: 16 M rows x 64 positions per warp.",
            "    if (kt == 1) continue;\n    // S = Q K^T: 16 M rows x 64 positions per warp.",
        ),
        "tiled_misses_own_position": (
            "vis_row[i] = min(abs0 + r + 1, kv_len);", "vis_row[i] = min(abs0 + r, kv_len);",
        ),
        "tiled_sees_next_position": (
            "vis_row[i] = min(abs0 + r + 1, kv_len);", "vis_row[i] = min(abs0 + r + 2, kv_len);",
        ),
        "diagonal_tile_skips_mask": (
            "const bool need_mask = (kt + 1) * kTileN > vis_first;",
            "const bool need_mask = (kt + 1) * kTileN > kv_len;",
        ),
    },
}
# K1's int8 instances: V rows dequantized with K's scale.
PLANTED_FAULTS_INT8 = {
    "decode": {
        "decode_v_takes_k_scale": (
            "const float vsc = kQuant ? sc[p * 2 + 1] : 1.f;",
            "const float vsc = kQuant ? sc[p * 2] : 1.f;",
        ),
    },
    "tiled": {
        "tiled_v_takes_k_scale": (
            "x *= tsc[((2 * kk + half) * 8 + 2 * (lane & 3) + (e & 1)) * 2 + 1];",
            "x *= tsc[((2 * kk + half) * 8 + 2 * (lane & 3) + (e & 1)) * 2];",
        ),
    },
}
# K2: each fault runs on every with-self batch of its page types.
PLANTED_FAULTS_K2 = {
    "drops_self_position": ("if (s_self != nullptr) {", "if (false) {"),
    "k2_drops_a_tile": (
        "    const unsigned char* st = ring + (it % kStages) * kStageBytes;",
        "    if (it == 1) continue;\n    const unsigned char* st = ring + (it % kStages) * kStageBytes;",
    ),
    "k2_combine_drops_last_split": (
        "min(n_splits, (n_vis + split_len - 1) / split_len)",
        "max(1, min(n_splits, (n_vis + split_len - 1) / split_len) - 1)",
    ),
    "k2_splits_overlap_by_a_page": (
        "const int c0 = split * split_len;",
        "const int c0 = max(0, split * split_len - block_size);",
    ),
}
# K2's int8 instances only: V rows dequantized with K's scale.
PLANTED_FAULTS_K2_INT8 = {
    "k2_int8_v_takes_k_scale": (
        "const float vsc = kQuant ? sc[kTile + p] : 1.f;",
        "const float vsc = kQuant ? sc[p] : 1.f;",
    ),
}


def build_planted(tmp: str) -> dict:
    """Start one nvcc per planted fault (each a copy of its kernel's source
    with one edit) and return ``{fault: future of the loaded library}``."""
    from dynamo_tpu_torch.ops import _build

    def build(source, name, old, new):
        text = (_build.CSRC_DIR / source).read_text()
        if text.count(old) != 1:
            raise AssertionError(f"planted fault {name}: its anchor is not in {source} once")
        src = Path(tmp, f"{name}.cu")
        src.write_text(text.replace(old, new))
        _build.build(src, src.with_suffix(".so"))
        return ctypes.CDLL(str(src.with_suffix(".so")))

    jobs = [("ragged_paged_attention.cu", f) for table in (PLANTED_FAULTS, PLANTED_FAULTS_INT8)
            for f in table.values()]
    jobs += [("paged_attention.cu", PLANTED_FAULTS_K2), ("paged_attention.cu", PLANTED_FAULTS_K2_INT8)]
    names = [name for _, faults in jobs for name in faults]
    if len(set(names)) != len(names):
        raise AssertionError(f"planted-fault names repeat: {sorted(names)}")
    pool = ThreadPoolExecutor(len(names))
    futures = {
        name: pool.submit(build, source, name, old, new)
        for source, faults in jobs for name, (old, new) in faults.items()
    }
    pool.shutdown(wait=False)
    return futures


def check_planted_faults(ra, batches, libs, faults, int8=False) -> dict:
    """Run each planted fault's copy of its K1 kernel, forced, on the
    batches above: the comparison must fail every one on at least one
    batch, or its limit is too loose to mean anything."""
    found = {}
    for kernel, table in faults.items():
        for name in table:
            entries = ra.bind(libs[name].result(), int8)
            rels = {
                shape: compare(
                    ra.launch(entries, *args, sm_scale=HEAD_DIM ** -0.5, kernel=kernel, **kw),
                    want, n_real,
                )[0]
                for shape, args, kw, want, n_real in batches
            }
            found[name] = max(rels.values())
            caught = not found[name] <= ROW_REL_TOL  # a NaN fails the limit too
            print(f"planted fault {name} ({kernel} kernel): max_row_rel_err by batch "
                  + ", ".join(f"{k} {v:.3e}" for k, v in rels.items())
                  + f"; caught={caught}", flush=True)
            if not caught:
                raise AssertionError(f"the comparison passes planted fault {name}")
    return found


def plain_by_row_chunks(ra, args, kw, q_lens, rows=64):
    """The plain version over a batch too large for it in one call: each
    run of ``rows`` query rows of a sequence goes through it alone, as the
    last rows of that sequence cut at the chunk's end (same absolute
    positions, same visible keys), so each call materialises at most
    ``rows`` x 2048 positions."""
    q, kv, lens, tables, cu, _ = args
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=q.device)  # noqa: E731
    lens_h, cu_h = lens.tolist(), cu.tolist()
    out = torch.zeros_like(q)
    for s, ql in enumerate(q_lens):
        for a in range(0, ql, rows):
            b = min(a + rows, ql)
            kv_len = lens_h[s] - ql + b
            r0, r1 = cu_h[s] + a, cu_h[s] + b
            out[r0:r1] = ra.ragged_paged_attention_ref(
                q[r0:r1], kv, i32([kv_len]), tables[s : s + 1, : -(-kv_len // PAGE)],
                i32([0, b - a]), i32([1]), sm_scale=HEAD_DIM ** -0.5, **kw,
            )
    return out


def check_serving_prefill_shape(ra, prompt_lens, int8=False) -> list[dict]:
    """Both K1 kernels at the serving prefill wave's shape (bucket 8192, S
    = 8, pages_per_seq 256), held against the plain version run in row
    chunks (in one call it would materialise 8192 x 8192 x 16 x 128 f32)."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    args, kw = attention_batch(prompt_lens, prompt_lens, 8, 256, 8192, gen)
    if int8:
        args, kw = quantized(args, kw)
    tag = "attention int8" if int8 else "attention"
    plain = lambda: plain_by_row_chunks(ra, args, kw, prompt_lens)  # noqa: E731
    want = plain()
    plain_ms = cold_ms(plain, 1)
    out = hold_k1(ra, "prefill_wave8192", args, kw, want, prompt_lens, prompt_lens, 8192,
                  int8, 5, plain_ms, tag)
    del args, kw, want
    torch.cuda.empty_cache()
    return out


# -- K2: paged decode attention ----------------------------------------------

# The int8-page against bf16-page comparison (JAX bench.py:2104-2158):
# B 16, 8 kv heads of group 4, block 32, 8 blocks each, 251 cached tokens.
K2_BENCH = dict(B=16, n_kv=8, group=4, bs=32, max_blocks=8, lens=[251] * 16, q_dtype=torch.float32)


def k2_operands(B, n_kv, group, bs, max_blocks, lens, q_dtype, gen, *, int8, with_self):
    """Head-major flat caches on the card, each sequence on its own
    scattered blocks (one spare block past them), as the positional and
    keyword operands of ``paged_attention``."""
    from dynamo_tpu_torch.engine.kv_quant import quantize_kv

    dev = "cuda"
    total = (B * max_blocks + 1) * bs
    q = torch.randn(B, n_kv * group, HEAD_DIM, device=dev, generator=gen).to(q_dtype)
    k = torch.randn(n_kv, total, HEAD_DIM, device=dev, generator=gen).bfloat16()
    v = torch.randn(n_kv, total, HEAD_DIM, device=dev, generator=gen).bfloat16()
    tables = torch.randperm(B * max_blocks, device=dev, generator=gen).to(torch.int32)
    tables = tables.reshape(B, max_blocks).contiguous()
    seq_lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    kw = {"block_size": bs}
    if int8:
        (k, kw["k_scale"]), (v, kw["v_scale"]) = quantize_kv(k), quantize_kv(v)
    if with_self:
        kw["k_self"] = torch.randn(B, n_kv, HEAD_DIM, device=dev, generator=gen).to(q_dtype)
        kw["v_self"] = torch.randn(B, n_kv, HEAD_DIM, device=dev, generator=gen).to(q_dtype)
    return (q, k, v, tables, seq_lens), kw


def k2_bound(B, n_kv, group, bs, lens, q_dtype, *, int8, with_self):
    """Least time for this call's work: q, the visible K/V rows (and their
    scales for int8 pages), the self rows, the table entries in use and
    seq_lens read once, the output written once; operations 4 * (visible
    positions + self) * n_q * d at the rate of q's type (the f32 units for
    f32 q, the bf16 tensor cores for bf16 q)."""
    q_item = 4 if q_dtype == torch.float32 else 2
    n_q = n_kv * group
    visible = sum(lens)
    row_bytes = HEAD_DIM + SCALE_BYTES if int8 else HEAD_DIM * 2
    nbytes = (
        2 * B * n_q * HEAD_DIM * q_item                      # q and out
        + visible * 2 * n_kv * row_bytes                     # K and V rows (+ scales)
        + (2 * B * n_kv * HEAD_DIM * q_item if with_self else 0)
        + 4 * (sum(-(-n // bs) for n in lens) + B)           # tables in use, seq_lens
    )
    ops = 4 * (visible + (B if with_self else 0)) * n_q * HEAD_DIM
    rate = F32_OPS_PER_S if q_dtype == torch.float32 else BF16_OPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / rate
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def k2_cases():
    rng = np.random.default_rng(2)
    llama = dict(n_kv=N_KV, group=N_Q // N_KV, bs=PAGE, max_blocks=128, q_dtype=torch.bfloat16)
    return [
        ("bench_kvquant", K2_BENCH),
        ("decode8", dict(B=8, lens=[4096, 3000, 2048, 1500, 1024, 700, 300, 33], **llama)),
        ("decode64", dict(B=64, lens=[int(x) for x in rng.integers(1, 4097, 64)], **llama)),
    ]


def check_paged_attention_kernel(pa) -> tuple[list[dict], list[tuple]]:
    """K2 against paged_attention_reference with bf16 and int8 pages, with
    and without the self position; returns the measurements and the
    with-self batches with their plain outputs (for the planted fault)."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    results, batches = [], []
    for shape, c in k2_cases():
        for int8 in (False, True):
            for with_self in (False, True):
                args, kw = k2_operands(c["B"], c["n_kv"], c["group"], c["bs"], c["max_blocks"],
                                       c["lens"], c["q_dtype"], gen, int8=int8, with_self=with_self)
                kernel = lambda: pa.paged_attention(*args, **kw)  # noqa: E731
                plain = lambda: pa.paged_attention_reference(*args, **kw)  # noqa: E731
                got = kernel()
                torch.cuda.synchronize()
                want = plain()
                rel, err, ok = compare(got, want, c["B"])
                ms = cold_ms(kernel, 20)
                plain_ms = cold_ms(plain, 3)
                bound_ms, bound_by = k2_bound(c["B"], c["n_kv"], c["group"], c["bs"], c["lens"],
                                              c["q_dtype"], int8=int8, with_self=with_self)
                pages = "int8" if int8 else "bf16"
                n_splits = pa.launch_plan(c["B"], c["n_kv"] * c["group"], c["n_kv"], c["bs"],
                                          c["max_blocks"], pa.sm_count(0))[0][-2]
                results.append(dict(
                    shape=shape, pages=pages, self=with_self, B=c["B"], q_dtype=str(c["q_dtype"]),
                    n_splits=n_splits,
                    max_seq_len=max(c["lens"]), ok=ok, max_row_rel_err=rel, max_abs_err=err,
                    ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                ))
                print(f"paged_attention {shape} {pages} pages self={with_self}: ok={ok} "
                      f"max_row_rel_err={rel:.3e} max_abs_err={err:.3e} kernel {ms:.4f} ms "
                      f"plain {plain_ms:.3f} ms bound {bound_ms:.4f} ms ({bound_by}); {n_splits} "
                      f"splits; kernel/bound {ms / bound_ms:.1f}x; kernel/plain {ms / plain_ms:.4f}",
                      flush=True)
                if with_self:
                    batches.append((shape, pages, args, kw, want))
                if not ok:
                    raise AssertionError(f"paged_attention kernel disagrees with its plain "
                                         f"version on {shape} ({pages} pages, self={with_self})")
                del got
            torch.cuda.empty_cache()
    return results, batches


def check_k2_planted_faults(pa, batches, libs) -> dict:
    """Each of K2's planted faults, run with the planned split count on the
    with-self batches (the int8-only fault on the int8 ones), must fail the
    limit on at least one of them."""
    found = {}
    for table, pages in ((PLANTED_FAULTS_K2, ("bf16", "int8")), (PLANTED_FAULTS_K2_INT8, ("int8",))):
        for name in table:
            fn = pa.bind(libs[name].result())
            rels = {f"{shape}_{p}": compare(pa.launch(fn, *args, **kw), want, args[0].shape[0])[0]
                    for shape, p, args, kw, want in batches if p in pages}
            torch.cuda.synchronize()
            found[name] = max(rels.values())
            caught = not found[name] <= ROW_REL_TOL  # a NaN fails the limit too
            print(f"planted fault {name} (paged_attention): max_row_rel_err by batch "
                  + ", ".join(f"{k} {v:.3e}" for k, v in rels.items())
                  + f"; caught={caught}", flush=True)
            if not caught:
                raise AssertionError(f"the comparison passes planted fault {name}")
    return found


INT8_VS_BF16_MAX_ROW_REL = 5e-2  # int8 pages against bf16 pages: quantization error


def k2_path(pa, reps=20) -> dict:
    """K2's own path: the int8-page against bf16-page decode-attention
    comparison of the JAX package's bench (bench.py:2104-2158) through the
    dispatcher ``paged_attention``, with both launch counts at 0 just
    before it. Times each page dtype over ``reps`` calls after a warm-up
    and holds the int8 output to the bf16 one within the quantization
    error."""
    from dynamo_tpu_torch.engine.kv_quant import quantize_kv

    c = K2_BENCH
    gen = torch.Generator(device="cuda").manual_seed(4)
    (q, k, v, tables, lens), kw = k2_operands(c["B"], c["n_kv"], c["group"], c["bs"], c["max_blocks"],
                                              c["lens"], c["q_dtype"], gen, int8=False, with_self=False)
    (k8, ks), (v8, vs) = quantize_kv(k), quantize_kv(v)
    pa.launches = pa.launches_int8 = 0
    bf16_ms = cuda_ms(lambda: pa.paged_attention(q, k, v, tables, lens, **kw), reps)
    int8_ms = cuda_ms(lambda: pa.paged_attention(q, k8, v8, tables, lens, k_scale=ks, v_scale=vs, **kw), reps)
    out_bf16 = pa.paged_attention(q, k, v, tables, lens, **kw)
    out_int8 = pa.paged_attention(q, k8, v8, tables, lens, k_scale=ks, v_scale=vs, **kw)
    launches = {"bf16": pa.launches, "int8": pa.launches_int8}
    rel = ((out_int8 - out_bf16).norm(dim=-1) / out_bf16.norm(dim=-1)).max().item()
    finite = bool(torch.isfinite(out_int8).all().item())
    print(f"paged_attention path (int8-page vs bf16-page comparison, B 16, seq_len 251): "
          f"bf16 pages {bf16_ms:.4f} ms, int8 pages {int8_ms:.4f} ms, int8_vs_bf16 "
          f"{int8_ms / bf16_ms:.3f}; int8 against bf16 output max_row_rel {rel:.3e}; "
          f"launches {launches}", flush=True)
    if min(launches.values()) == 0 or not finite or rel > INT8_VS_BF16_MAX_ROW_REL:
        raise AssertionError(f"K2 path: launches {launches}, finite={finite}, int8 error {rel:.3e}")
    return {"bf16_page_ms": bf16_ms, "int8_page_ms": int8_ms, "int8_vs_bf16": int8_ms / bf16_ms,
            "int8_vs_bf16_output_max_row_rel": rel, "launches": launches}


# -- the serving path -------------------------------------------------------

MAX_TOKENS = 64
SHARED_PREFIX = 1024  # tokens two requests share (32 blocks)


def serving_requests(vocab: int):
    rng = np.random.default_rng(1234)
    ids = lambda n: [int(t) for t in rng.integers(0, vocab, n)]  # noqa: E731
    shared = ids(SHARED_PREFIX)
    greedy = {"temperature": 0.0}
    reqs = [  # (id, prompt, sampling)
        ("long", ids(2000), greedy),
        ("prefix_a", shared + ids(100), greedy),
        ("temp", ids(100), {"temperature": 0.8, "seed": 7}),
        ("top_p", ids(700), {"temperature": 1.0, "top_p": 0.9, "seed": 11}),
        ("mid", ids(1500), greedy),
        ("short", ids(300), greedy),
        ("long2", ids(1800), greedy),
    ]
    late = ("prefix_b", shared + ids(50), greedy)  # sent once prefix_a has streamed
    solo = ("solo", ids(400), greedy)              # k=1 vs k=8 comparison
    return reqs, late, solo


def wire(rid, prompt, sampling):
    return {"model": "llama3-8b", "token_ids": prompt, "request_id": rid,
            "sampling": sampling, "stop": {"max_tokens": MAX_TOKENS}}


async def collect(engine, Context, rid, prompt, sampling, first=None):
    tokens, finish, meta = [], None, {}
    try:
        async for out in engine.generate(wire(rid, prompt, sampling), Context(rid)):
            tokens += out["token_ids"]
            meta.update(out.get("meta", {}))
            finish = out.get("finish_reason")
            if first is not None:
                first.set()
    finally:  # a stream that ends early releases the late request too
        if first is not None:
            first.set()
    return rid, tokens, finish, meta


async def serve_concurrent(engine, Context, reqs, late):
    prefix_streamed = asyncio.Event()

    async def late_request():
        await prefix_streamed.wait()
        return await collect(engine, Context, *late)

    tasks = [
        collect(engine, Context, *r, first=prefix_streamed if r[0] == "prefix_a" else None)
        for r in reqs
    ]
    done = await asyncio.wait_for(asyncio.gather(*tasks, late_request()), timeout=600)
    return {rid: (toks, fin, meta) for rid, toks, fin, meta in done}


LOGITS_MIN_COSINE = 0.9995  # 1 - cos measured at 1.4e-4 over 32 bf16 layers


def check_logits(core, prompt) -> dict:
    """Logits of one short prompt through the engine's weights on a scratch
    cache, once with the kernel and once with the plain attention: finite,
    of the expected shape, and pointing the same way."""
    from dynamo_tpu_torch.engine import model
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.ops import ragged_attention as ra

    cfg = core.cfg
    eng = EngineConfig(num_kv_blocks=8, max_model_len=256, kv_dtype=core.engine.kv_dtype)
    n, bs = len(prompt), eng.block_size
    dev = core.device
    i32 = lambda a: torch.tensor(a, dtype=torch.int32, device=dev)  # noqa: E731
    pos = list(range(n))
    table = list(range(8)) + [eng.garbage_block] * (eng.max_blocks_per_seq - 8)
    ops = (i32(prompt), i32(pos), i32([p // bs for p in pos]), i32([p % bs for p in pos]),
           i32([n]), i32([table]), i32([0, n]), i32([1]), i32([n - 1]))

    def run(attention):
        cache = model.init_cache(cfg, eng, dev)
        return model.forward_tokens(core.params, cache, *ops, cfg, attention=attention)

    with_kernel = run(ra.ragged_paged_attention)
    with_plain = run(ra.ragged_paged_attention_ref)
    cos = torch.nn.functional.cosine_similarity(with_kernel, with_plain).item()
    finite = bool(torch.isfinite(with_kernel).all().item())
    print(f"logits: shape {tuple(with_kernel.shape)} finite={finite} "
          f"cosine(kernel, plain attention)={cos:.6f} "
          f"max_abs_diff={(with_kernel - with_plain).abs().max().item():.4e}", flush=True)
    if not finite or with_kernel.shape != (1, cfg.vocab_size) or cos < LOGITS_MIN_COSINE:
        raise AssertionError("logits are not finite, misshapen, or disagree with the plain path")
    return {"cosine": cos}


GRAPH_WIDTH, GRAPH_K = 8, 8  # the megastep held against its eager body: width 8, k = 8


def memory_line() -> str:
    return (f"allocated {torch.cuda.memory_allocated() / 1e9:.2f} GB, reserved "
            f"{torch.cuda.memory_reserved() / 1e9:.2f} GB")


def warm_up(core, mode: str) -> dict:
    """``EngineCore.warm_up()``: one eager forward of every shape in each
    sampling variant, then the capture of every graph key the engine can
    dispatch (each prefill bucket, and each decode width at k = 1, 2, 4
    and 8, in six sampling variants). Returns its wall time, the graphs it
    captured and the card memory it took (the graph pool, mostly)."""
    torch.cuda.synchronize()
    reserved, t0 = torch.cuda.memory_reserved(), time.time()
    forwards = core.warm_up()
    torch.cuda.synchronize()
    st = core.scheduler_stats()
    out = {"warm_up_s": time.time() - t0, "warm_up_forwards": forwards,
           "graph_captures": st["graph_captures"], "graph_capture_s": st["graph_capture_s"],
           "warm_up_reserved_gb": (torch.cuda.memory_reserved() - reserved) / 1e9}
    print(f"warm-up ({mode}): {forwards} eager forwards, {out['graph_captures']} graphs "
          f"captured in {out['graph_capture_s']:.2f} s of {out['warm_up_s']:.2f} s; reserved "
          f"memory grew by {out['warm_up_reserved_gb']:.2f} GB; {memory_line()}", flush=True)
    return out


def decode_to_width(core, reqs) -> list:
    """Admit the serving prompts (greedy and seeded) and step until every
    one has its first token and none is prefilling: GRAPH_WIDTH decode
    lanes with real contexts (100 to 2000 positions)."""
    from dynamo_tpu_torch.llm.protocols.common import PreprocessedRequest

    if len(reqs) < GRAPH_WIDTH:
        raise ValueError(f"{len(reqs)} prompts for a width of {GRAPH_WIDTH}")
    for rid, prompt, sampling in reqs[:GRAPH_WIDTH]:
        core.add_request(PreprocessedRequest.from_wire(wire(f"graph_{rid}", prompt, sampling)))
    for _ in range(16):
        core.step()
        ready = core._decode_candidates()
        if len(ready) == GRAPH_WIDTH and core._inflight is None:
            return ready
    raise AssertionError(f"{len(ready)} decode lanes after 16 steps, not {GRAPH_WIDTH}")


def graph_against_eager(core, reqs, mode: str) -> dict:
    """One decode megastep (width 8, k = 8) from the same cache copy and
    inputs: the replay of its CUDA graph against an eager ``_megastep_body``
    call, the parent's way of running it. Tokens must be equal; each is
    timed per iteration on the host's wall clock, sync to sync."""
    ready = decode_to_width(core, reqs)
    core._grow_or_preempt(ready, GRAPH_K)
    launch = core._megastep_launch(ready, GRAPH_K)
    if launch.key not in core._graphs:
        raise AssertionError(f"{mode}: warm_up() did not capture {launch.key}")
    saved = [{k: t.clone() for k, t in c.items()} if isinstance(c, dict) else c.clone()
             for c in core.cache]

    def restore():
        for c, s in zip(core.cache, saved):
            pairs = [(c[k], s[k]) for k in c] if isinstance(c, dict) else [(c, s)]
            for dst, src in pairs:
                dst.copy_(src)

    def timed(run, reps):
        walls, out = [], None
        for _ in range(reps):
            restore()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = run()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3 / GRAPH_K)
        return out, walls

    eager, eager_ms = timed(lambda: launch.body(torch.from_numpy(launch.packed).cuda()), 3)
    graph, graph_ms = timed(lambda: core._graphs.replay(launch), 10)
    restore()
    del saved
    same = torch.equal(eager[0], graph[0])
    res = {"eager_ms_per_iteration": float(np.median(eager_ms)),
           "graph_ms_per_iteration": float(np.median(graph_ms)),
           "eager_ms": eager_ms, "graph_ms": graph_ms, "tokens_equal": same}
    print(f"megastep graph against eager body ({mode}, width {GRAPH_WIDTH}, k = {GRAPH_K}): "
          f"tokens equal={same}; ms per iteration, median: eager {res['eager_ms_per_iteration']:.3f} "
          f"graph {res['graph_ms_per_iteration']:.3f} (eager {[round(x, 3) for x in eager_ms]}, "
          f"graph {[round(x, 3) for x in graph_ms]})", flush=True)
    if not same:
        raise AssertionError(f"{mode}: the replayed megastep's tokens differ from the eager body's")
    for seq in ready:  # the lanes go on to finish as ordinary requests
        core.cancel_request(seq)
    while core.has_work():
        core.step()
    return res


async def timed_engine_batch(engine, Context, reqs) -> dict:
    """All requests sent at once (before the engine's first step), each
    with its time to first token on this clock."""
    async def one(rid, prompt, sampling):
        t0, ttft, toks = time.perf_counter(), None, []
        async for out in engine.generate(wire(rid, prompt, sampling), Context(rid)):
            ttft = ttft or 1e3 * (time.perf_counter() - t0)
            toks += out["token_ids"]
        return rid, toks, ttft

    done = await asyncio.wait_for(asyncio.gather(*(one(*r) for r in reqs)), timeout=600)
    return {rid: {"tokens": toks, "ttft_ms": ttft} for rid, toks, ttft in done}


def sync_against_async(core, overrides, reqs, mode: str) -> dict:
    """The serving traffic (all 8 prompts at once, prefix caches cleared)
    through the warm sync engine and through an async engine on the same
    weights, twice each, the second pass measured: identical streams;
    decode ms per iteration (the engine loop's wall over its decode
    iterations) and TTFT for each."""
    from dynamo_tpu_torch.backends.torch.main import build_engine
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.runtime.engine import Context

    acore, _ = build_engine("llama3-8b", {**overrides, "async_exec": True}, device="cuda",
                            params=core.params)
    warm = warm_up(acore, f"{mode}, async")
    rows = {}
    for name, c in (("sync", core), ("async", acore)):
        # A first pass warms the loop, the second is measured; neither
        # captures a graph. Each event loop gets its own facade.
        captures = c.scheduler_stats()["graph_captures"]
        c.clear_kv_cache()
        first = asyncio.run(timed_engine_batch(TorchEngine(c), Context, reqs))
        c.clear_kv_cache()
        before = dict(c.scheduler_stats())
        got = asyncio.run(timed_engine_batch(TorchEngine(c), Context, reqs))
        if {r: g["tokens"] for r, g in first.items()} != {r: g["tokens"] for r, g in got.items()}:
            raise AssertionError(f"{mode} {name}: the two passes' streams differ")
        st = c.scheduler_stats()
        d = {k: st[k] - before[k] for k in ("decode_loop_s", "decode_iterations", "dispatches",
                                            "graph_replays", "decode_s")}
        if d["graph_replays"] != d["dispatches"] or st["graph_captures"] != captures:
            raise AssertionError(f"{mode} {name}: {d['graph_replays']} replays for "
                                 f"{d['dispatches']} dispatches, "
                                 f"{st['graph_captures'] - captures} graphs captured serving")
        rows[name] = {"streams": {r: g["tokens"] for r, g in got.items()},
                      "ttft_ms": {r: g["ttft_ms"] for r, g in got.items()},
                      "decode_ms_per_iteration": 1e3 * d["decode_loop_s"] / d["decode_iterations"],
                      "decode_dispatch_to_landing_ms_per_iteration":
                          1e3 * d["decode_s"] / d["decode_iterations"],
                      "dispatches": d["dispatches"]}
    same = rows["sync"]["streams"] == rows["async"]["streams"]
    for name in ("sync", "async"):
        r = rows[name]
        print(f"serving {mode} graphs {name}: decode {r['decode_ms_per_iteration']:.3f} ms per "
              f"iteration (engine loop; dispatch to landing "
              f"{r['decode_dispatch_to_landing_ms_per_iteration']:.3f}), {r['dispatches']} "
              f"dispatches, all replays; TTFT ms "
              + ", ".join(f"{k} {v:.1f}" for k, v in sorted(r["ttft_ms"].items())), flush=True)
    print(f"serving {mode}: async streams equal to sync streams: {same}", flush=True)
    if not same or any(len(t) != MAX_TOKENS for t in rows["async"]["streams"].values()):
        raise AssertionError(f"{mode}: async execution changed the streams")
    del acore
    gc.collect()
    torch.cuda.empty_cache()
    return {"async_warm_up": warm, **{name: {k: v for k, v in r.items() if k != "streams"}
                                      for name, r in rows.items()}}


def serve(ra, card: str, int8=False) -> tuple[int, dict]:
    """The main path: 8 requests through the llama3-8b engine, bf16, or
    (``int8``) with int8 weights and int8 KV pages, after ``warm_up()``
    (so every prefill wave and decode megastep is a graph replay); then
    the graph-against-eager megastep, k = 1 against k = 8, and the
    traffic with async execution off and on."""
    from dynamo_tpu_torch.backends.torch.main import build_engine
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.runtime.engine import Context

    overrides = {"kv_dtype": "int8"} if int8 else {}
    mode = "int8 weights + int8 KV" if int8 else "bf16"
    t0 = time.time()
    core, engine = build_engine(
        "llama3-8b", overrides, seed=0, device="cuda", quant="int8" if int8 else None
    )
    torch.cuda.synchronize()
    print(f"built {core.cfg.name} engine ({core.cfg.num_layers} layers, {mode}, random weights, "
          f"{core.engine.num_kv_blocks} x {core.engine.block_size}-token KV blocks of "
          f"{core.kv_cache_stats()['bytes_per_block']} bytes) "
          f"in {time.time() - t0:.1f} s; {memory_line()}", flush=True)
    warm = warm_up(core, mode)
    reqs, late, solo = serving_requests(core.cfg.vocab_size)

    # The main path, with every kernel launch count at 0 just before it.
    ra.reset_launches()
    t_serve = time.time()
    results = asyncio.run(serve_concurrent(engine, Context, reqs, late))
    serve_s = time.time() - t_serve
    launches, other = (ra.launches_int8, ra.launches) if int8 else (ra.launches, ra.launches_int8)
    by_entry = {ra.ENTRY_NAMES[k, int8]: ra.kernel_launches[ra.ENTRY_NAMES[k, int8]]
                for k in K1_KERNELS}
    st = core.scheduler_stats()
    forwards = st["forwards"]

    for rid, (toks, fin, meta) in results.items():
        print(f"request {rid}: {len(toks)} tokens, finish={fin}, "
              f"cached_tokens={meta.get('cached_tokens')}", flush=True)
        if len(toks) != MAX_TOKENS or fin != "length":
            raise AssertionError(f"{rid}: {len(toks)} tokens, finish {fin!r}")
    if (launches != core.cfg.num_layers * forwards or other != 0 or min(by_entry.values()) == 0
            or sum(by_entry.values()) != launches):
        raise AssertionError(
            f"{mode} attention launches {launches} != {core.cfg.num_layers} x {forwards} "
            f"forwards, or the other page dtype's kernels ran ({other} launches), or a K1 "
            f"kernel never ran: {by_entry}"
        )
    if st["graph_replays"] != st["dispatches"]:
        raise AssertionError(f"{mode}: {st['graph_replays']} graph replays for "
                             f"{st['dispatches']} dispatches after warm_up()")
    if st["graph_captures"] != warm["graph_captures"]:
        raise AssertionError(f"{mode}: {st['graph_captures'] - warm['graph_captures']} graphs "
                             f"captured while serving, after warm_up()")
    kv = core.kv_cache_stats()
    if results["prefix_b"][2].get("cached_tokens") != SHARED_PREFIX or kv["admitted_hits"] < 1:
        raise AssertionError(f"shared prefix missed the prefix cache: {kv}")
    print(f"main path ({mode}): {len(results)} requests in {serve_s:.2f} s; forwards {forwards} "
          f"(prefill waves + decode iterations), attention launches {launches} = "
          f"{core.cfg.num_layers} x {forwards} counted across graph replays, by kernel "
          f"{by_entry}; dispatches {st['dispatches']} (megastep {st['megastep_dispatches']}), "
          f"graph_replays {st['graph_replays']}, graph_captures {st['graph_captures']} "
          f"({warm['graph_captures']} at warm-up)", flush=True)
    prefill_tps = st["prefill_tokens"] / st["prefill_s"]
    decode_ms = 1e3 * st["decode_loop_s"] / st["decode_iterations"]
    print(f"serving {mode} on {card}: prefill {prefill_tps:.0f} tokens/s "
          f"({st['prefill_tokens']} tokens in {st['prefill_s']:.3f} s), decode "
          f"{decode_ms:.2f} ms per iteration (engine loop: {st['decode_iterations']} iterations "
          f"in {st['decode_loop_s']:.3f} s; dispatch to landing "
          f"{1e3 * st['decode_s'] / st['decode_iterations']:.2f})", flush=True)

    logit_check = check_logits(core, reqs[5][1][:64])
    graph_check = graph_against_eager(core, reqs + [late], mode)

    # Megastep k=1 against k=8: a second engine on the same weight tensors,
    # not warmed up (its graphs are captured at first use). Each event
    # loop gets its own facade (asyncio objects bind to a loop).
    core1, engine1 = build_engine(
        "llama3-8b", {**overrides, "megastep_k": 1}, device="cuda", params=core.params
    )

    async def solo_on(eng):
        return await collect(eng, Context, *solo)

    k8 = asyncio.run(solo_on(TorchEngine(core)))[1]
    k1 = asyncio.run(solo_on(engine1))[1]
    print(f"greedy solo request ({mode}): k=8 and k=1 streams equal={k8 == k1} "
          f"({len(k8)} tokens; k=1 engine captured {core1.scheduler_stats()['graph_captures']} "
          f"graphs at first use)", flush=True)
    if k8 != k1 or len(k8) != MAX_TOKENS:
        raise AssertionError("megastep k=8 and k=1 greedy streams differ")
    del core1, engine1
    gc.collect()
    torch.cuda.empty_cache()
    modes = sync_against_async(core, overrides, reqs + [late], mode)
    return by_entry, {
        "mode": mode, "attention_launches": launches, "requests": len(results), "serve_s": serve_s, "forwards": forwards,
        "bytes_per_block": core.kv_cache_stats()["bytes_per_block"],
        "prefill_tokens_per_s": prefill_tps, "decode_ms_per_iteration": decode_ms,
        "logits_cosine": logit_check["cosine"], "warm_up": warm,
        "graph_replays": st["graph_replays"], "dispatches": st["dispatches"],
        "graph_against_eager": graph_check, "graphs_sync_async": modes,
    }


# -- the worker process --------------------------------------------------------

ROOT = Path(__file__).resolve().parent
WORKER_SOLO = ("long", "prefix_a", "mid", "short")  # greedy prompts sent one at a time
WORKER_RESEND = "mid"
# The staggered batch: STAGGER_FIRST alone, the other 7 STAGGER_DELAY_S
# later. Its prefill step ends at ~25 ms and its first decode megastep
# lasts 8 iterations of 20 ms or more, so the 7 arrive inside that
# megastep through either path and share the next wave.
STAGGER_FIRST, STAGGER_DELAY_S = "short", 0.1
DATAPLANE_REPEATS = 40  # replays of the worker's batch chunks per stream


async def timed_stream(open_stream, rid, prompt, sampling) -> dict:
    """One request's output chunks with the client's clock: time to the
    first chunk, and ms per token after the first."""
    t0 = time.perf_counter()
    outs, stamps = [], []
    async for out in await open_stream(wire(rid, prompt, sampling)):
        outs.append(out)
        stamps.append(time.perf_counter())
    tokens = [t for o in outs for t in o["token_ids"]]
    meta = {k: v for o in outs for k, v in o.get("meta", {}).items()}
    return {
        "rid": rid, "outs": outs, "tokens": tokens, "finish": outs[-1].get("finish_reason"),
        "cached_tokens": meta.get("cached_tokens"),
        "first_iteration": meta.get("iteration"),  # the engine step that emitted it
        "ttft_ms": 1e3 * (stamps[0] - t0),
        "tpot_ms": 1e3 * (stamps[-1] - stamps[0]) / max(1, len(tokens) - 1),
    }


async def staggered_batch(open_stream, by_id: dict) -> list[dict]:
    """The 8 serving prompts in an arrival pattern that neither path
    shapes: ``STAGGER_FIRST`` alone, the other 7 ``STAGGER_DELAY_S``
    later."""
    first = asyncio.create_task(timed_stream(open_stream, *by_id[STAGGER_FIRST]))
    await asyncio.sleep(STAGGER_DELAY_S)
    rest = asyncio.gather(
        *(timed_stream(open_stream, *r) for rid, r in by_id.items() if rid != STAGGER_FIRST))
    return [await first, *await rest]


async def worker_traffic(open_stream, vocab: int) -> dict:
    """What the worker phase sends, the same through either path: the
    ``WORKER_SOLO`` prompts one at a time; all 8 serving prompts at once;
    a ``clear_kv_blocks`` request, so that the next batch prefills what
    the first did; the 8 staggered (:func:`staggered_batch`); then
    ``WORKER_RESEND`` again."""
    reqs, late, _ = serving_requests(vocab)
    by_id = {r[0]: r for r in reqs + [late]}
    solo = [await timed_stream(open_stream, *by_id[rid]) for rid in WORKER_SOLO]
    batch = await asyncio.wait_for(
        asyncio.gather(*(timed_stream(open_stream, *r) for r in by_id.values())), timeout=600
    )
    cleared = [out async for out in await open_stream(
        {"request_id": "clear", "clear_kv_blocks": True})]
    if not cleared or not cleared[-1].get("cleared_blocks"):
        raise AssertionError(f"clear_kv_blocks answered {cleared}")
    staggered = await asyncio.wait_for(staggered_batch(open_stream, by_id), timeout=600)
    resend = await timed_stream(open_stream, *by_id[WORKER_RESEND])
    for r in solo + list(batch) + staggered + [resend]:
        if len(r["tokens"]) != MAX_TOKENS or r["finish"] != "length":
            raise AssertionError(f"{r['rid']}: {len(r['tokens'])} tokens, finish {r['finish']!r}")
    return {"solo": solo, "batch": list(batch), "staggered": staggered, "resend": resend,
            "prompts": {rid: r[1] for rid, r in by_id.items()}}


def replay_server(address: str, chunks_path: str) -> None:
    """The data-plane probe's server, run by :func:`dataplane_cost` in a
    process of its own (``python -c``): serves ``dataplane_probe/replay``,
    which streams a request's recorded chunks ``DATAPLANE_REPEATS`` times,
    or, asked for ``cpu``, this process's CPU seconds; until it is killed."""
    from dynamo_tpu_torch.runtime import DistributedRuntime

    chunks = json.loads(Path(chunks_path).read_text())

    async def handler(request, context):
        if request.get("cpu"):
            yield {"cpu_s": time.process_time()}
            return
        for _ in range(DATAPLANE_REPEATS):
            for out in chunks[request["rid"]]:
                yield out

    async def serve():
        rt = await DistributedRuntime.create(address)
        await rt.namespace("dynamo").component("dataplane_probe").endpoint("replay").serve(handler)
        await asyncio.Event().wait()

    asyncio.run(serve())


async def dataplane_cost(rt, address: str, chunks: dict[str, list[dict]]) -> dict:
    """The data plane's host cost per streamed chunk and token, with no
    engine: a server process (:func:`replay_server`) replays each
    request's recorded chunks ``DATAPLANE_REPEATS`` times to this
    process's client, one stream per request, all at once, as a worker
    streams to a frontend. Each end's CPU time is its whole host cost of
    the chunks: the handler and encoding and framing on the server,
    reading and decoding on the client."""
    with tempfile.TemporaryDirectory() as tmp:
        (Path(tmp) / "chunks.json").write_text(json.dumps(chunks))
        with open(Path(tmp) / "server.log", "w") as log_file:
            server = subprocess.Popen(
                [sys.executable, "-c", "import sys, chip_smoke; chip_smoke.replay_server(*sys.argv[1:])",
                 address, str(Path(tmp) / "chunks.json")],
                cwd=ROOT, stdout=log_file, stderr=subprocess.STDOUT,
            )
        try:
            client = await rt.namespace("dynamo").component("dataplane_probe").endpoint(
                "replay").client()
            await client.wait_for_instances(1, timeout=120)

            async def stream(request) -> list[dict]:
                return [out async for out in await client.round_robin(request)]

            await stream({"rid": next(iter(chunks))})  # opens the connection
            server_c0 = (await stream({"cpu": True}))[0]["cpu_s"]
            t0, c0 = time.perf_counter(), time.process_time()
            outs = await asyncio.wait_for(
                asyncio.gather(*(stream({"rid": rid}) for rid in chunks)), timeout=300)
            wall_s, client_s = time.perf_counter() - t0, time.process_time() - c0
            server_s = (await stream({"cpu": True}))[0]["cpu_s"] - server_c0
        except BaseException:
            print(f"replay server log:\n{(Path(tmp) / 'server.log').read_text()[-4000:]}",
                  file=sys.stderr)
            raise
        finally:
            stop_process(server, signal.SIGKILL, 10)
    n = sum(len(o) for o in outs)
    tokens = sum(len(c["token_ids"]) for o in outs for c in o)
    if n != DATAPLANE_REPEATS * sum(len(c) for c in chunks.values()):
        raise AssertionError(f"the replay streamed {n} chunks")
    return {"streams": len(chunks), "chunks": n, "tokens": tokens,
            "wall_ms_per_chunk": 1e3 * wall_s / n,
            "server_cpu_ms_per_chunk": 1e3 * server_s / n,
            "server_cpu_ms_per_token": 1e3 * server_s / tokens,
            "client_cpu_ms_per_chunk": 1e3 * client_s / n,
            "client_cpu_ms_per_token": 1e3 * client_s / tokens}


def in_process_traffic(preset: str, device: str) -> tuple[dict, dict]:
    """The worker phase's traffic through ``build_engine`` in this process,
    warmed up as the worker warms up; the engine is freed on return."""
    from dynamo_tpu_torch.backends.torch.main import build_engine
    from dynamo_tpu_torch.runtime.engine import Context

    core, engine = build_engine(preset, seed=0, device=device)
    core.warm_up()
    captures = core.scheduler_stats()["graph_captures"]

    async def open_stream(req):
        return engine.generate(req, Context(req["request_id"]))

    got = asyncio.run(worker_traffic(open_stream, core.cfg.vocab_size))
    stats = core.scheduler_stats()
    if stats["graph_captures"] != captures:
        raise AssertionError(f"{stats['graph_captures'] - captures} graphs captured serving "
                             f"the worker traffic in process, after warm_up()")
    del core, engine
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return got, stats


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def wait_for_port(port: int, proc, timeout: float) -> None:
    deadline = time.time() + timeout
    while time.time() < deadline:
        if proc.poll() is not None:
            raise RuntimeError(f"store exited with {proc.returncode}")
        with socket.socket() as s:
            if s.connect_ex(("127.0.0.1", port)) == 0:
                return
        time.sleep(0.1)
    raise TimeoutError(f"store never listened on port {port}")


async def solo_traffic(open_stream, vocab: int) -> dict:
    """The ``WORKER_SOLO`` prompts one at a time."""
    reqs, late, _ = serving_requests(vocab)
    by_id = {r[0]: r for r in reqs + [late]}
    return {"solo": [await timed_stream(open_stream, *by_id[rid]) for rid in WORKER_SOLO]}


async def drive_worker(address: str, worker, vocab: int,
                       solo_only=False) -> tuple[dict, list, object]:
    """Wait for the worker's model card through the port's discovery, send
    the worker phase's traffic (or, ``solo_only``, the solo prompts alone)
    through the port's data-plane client, and collect the KV events the
    worker put on the store."""
    from dynamo_tpu_torch.llm.discovery import ModelWatcher
    from dynamo_tpu_torch.llm.kv_router.protocols import RouterEvent, kv_events_subject
    from dynamo_tpu_torch.runtime import DistributedRuntime

    rt = await DistributedRuntime.create(address)
    try:
        events = await rt.store.subscribe(kv_events_subject("dynamo", "backend"))
        received: list = []

        async def collect_events():
            async for ev in events:
                received.append(RouterEvent.from_wire(ev["p"]))

        collector = asyncio.create_task(collect_events())
        cards: list = []
        watcher = ModelWatcher(rt.store)

        async def on_added(entry, card):
            cards.append(card)

        watcher.on_model_added.append(on_added)
        await watcher.start()
        t0 = time.time()
        while not cards:
            if worker.poll() is not None:
                raise RuntimeError(f"worker exited with {worker.returncode} before registering")
            if time.time() - t0 > 600:
                raise TimeoutError("the worker's model card never appeared")
            await asyncio.sleep(0.5)
        print(f"worker registered model {cards[0].name!r} after {time.time() - t0:.1f} s "
              f"(kv_block_size {cards[0].kv_block_size}, "
              f"{cards[0].runtime_config.total_kv_blocks} blocks)", flush=True)
        client = await rt.namespace("dynamo").component("backend").endpoint("generate").client()
        await client.wait_for_instances(1, timeout=30)

        async def open_stream(req):
            return await client.round_robin(req)

        got = await (solo_traffic if solo_only else worker_traffic)(open_stream, vocab)
        await asyncio.sleep(1.0)  # the last KV events are in flight
        collector.cancel()
        await watcher.stop()
        if not solo_only:
            got["dataplane"] = await dataplane_cost(
                rt, address, {r["rid"]: r["outs"] for r in got["batch"]})
        return got, received, cards[0]
    finally:
        await rt.shutdown()


def stop_process(proc, sig=signal.SIGINT, timeout=60.0) -> None:
    if proc.poll() is None:
        proc.send_signal(sig)
        try:
            proc.wait(timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def worker_stats(log_path: Path) -> dict:
    """The counters the worker logs as it stops."""
    for line in reversed(log_path.read_text().splitlines()):
        if " stopping: " in line:
            return json.loads(line.split(" stopping: ", 1)[1])
    raise AssertionError(f"the worker logged no counters; log tail:\n{log_path.read_text()[-4000:]}")


def summarize(name: str, got: dict) -> dict:
    row = {"path": name, "solo_ttft_ms": {r["rid"]: r["ttft_ms"] for r in got["solo"]}}
    for key in ("batch", "staggered"):
        runs = sorted(got[key], key=lambda r: r["rid"])
        first = min(r["first_iteration"] for r in runs)
        row |= {
            f"{key}_ttft_ms": {r["rid"]: r["ttft_ms"] for r in runs},
            f"{key}_tpot_ms": {r["rid"]: r["tpot_ms"] for r in runs},
            # The engine step (1 = the batch's first) that emitted each first token.
            f"{key}_first_step": {r["rid"]: r["first_iteration"] - first + 1 for r in runs},
            f"{key}_tpot_ms_median": float(np.median([r["tpot_ms"] for r in runs])),
        }
    row["resend_cached_tokens"] = got["resend"]["cached_tokens"]
    return row


def without_iteration(outs: list[dict]) -> list[dict]:
    """Chunks without the engine step the first one names (one step later
    per request under async execution, as in the JAX engine)."""
    return [{**o, "meta": {k: v for k, v in o.get("meta", {}).items() if k != "iteration"}}
            for o in outs]


def worker_process(cfg, preset: str, device: str, extra_args: list[str],
                   solo_only=False) -> tuple[dict, list, object, dict]:
    """The port's store and ``python -m dynamo_tpu_torch.backends.torch``
    (with ``extra_args``) as subprocesses, driven by :func:`drive_worker`;
    returns its traffic, KV events, model card and exit counters."""
    logs = Path(tempfile.mkdtemp(prefix="chip_smoke_worker_"))
    port = free_port()
    with open(logs / "store.log", "w") as store_log, open(logs / "worker.log", "w") as worker_log:
        store = subprocess.Popen(
            [sys.executable, "-m", "dynamo_tpu_torch.runtime.store", "--port", str(port)],
            cwd=ROOT, stdout=store_log, stderr=subprocess.STDOUT,
        )
        worker = None
        try:
            wait_for_port(port, store, 30)
            t0 = time.time()
            worker = subprocess.Popen(
                [sys.executable, "-m", "dynamo_tpu_torch.backends.torch",
                 "--model-name", preset, "--preset", preset, "--seed", "0", "--device", device,
                 *extra_args],
                cwd=ROOT, stdout=worker_log, stderr=subprocess.STDOUT,
                env={**os.environ, "DYN_STORE_ADDRESS": f"127.0.0.1:{port}"},
            )
            got, events, mdc = asyncio.run(
                drive_worker(f"127.0.0.1:{port}", worker, cfg.vocab_size, solo_only))
            stop_process(worker)
            if worker.returncode != 0:
                raise AssertionError(f"worker exited with {worker.returncode}")
            print(f"worker phase: worker {' '.join(extra_args)} up and served in "
                  f"{time.time() - t0:.1f} s", flush=True)
        except BaseException:
            print(f"worker log tail:\n{(logs / 'worker.log').read_text()[-6000:]}", file=sys.stderr)
            raise
        finally:
            if worker is not None:
                stop_process(worker, signal.SIGKILL, 10)
            stop_process(store, signal.SIGTERM, 10)
    return got, events, mdc, worker_stats(logs / "worker.log")


def serve_worker(card: str, preset: str = "llama3-8b", device: str = "cuda") -> dict:
    """The worker process: the port's store and
    ``python -m dynamo_tpu_torch.backends.torch`` as subprocesses, driven
    through the port's discovery and data-plane client. Its solo greedy
    streams must equal the in-process engine's (run first, and freed, so
    one engine is on the card at a time); the 8-request batch's times are
    printed beside the in-process engine's; a resent prompt must report
    cached tokens, and the worker's KV events must carry the block hashes
    of the prompt's full blocks."""
    from dynamo_tpu_torch.engine.config import PRESETS
    from dynamo_tpu_torch.tokens import compute_seq_hashes

    cfg = PRESETS[preset]()
    ref, ref_stats = in_process_traffic(preset, device)
    print(f"worker phase: in-process reference done ({len(ref['solo'])} solo, "
          f"{len(ref['batch'])} concurrent, 1 resent)", flush=True)
    got, events, mdc, stats = worker_process(cfg, preset, device, [])
    got_async, _, _, stats_async = worker_process(cfg, preset, device, ["--async-exec", "on"],
                                                  solo_only=True)

    for w, r, a in zip(got["solo"], ref["solo"], got_async["solo"]):
        same = w["outs"] == r["outs"]
        same_async = without_iteration(a["outs"]) == without_iteration(w["outs"])
        print(f"worker solo {w['rid']}: {len(w['tokens'])} tokens, greedy stream equal to "
              f"the in-process engine's: {same}; the async worker's chunks equal the sync "
              f"worker's (but for the engine step named in the first): {same_async}", flush=True)
        if not same:
            raise AssertionError(f"{w['rid']}: the worker's greedy stream differs from build_engine's")
        if not same_async:
            raise AssertionError(f"{w['rid']}: the async worker's stream differs from the sync one's")
    if not stats_async["async_exec"] or stats_async["graph_replays"] != stats_async["dispatches"]:
        raise AssertionError(f"the async worker's counters: {stats_async}")
    if not stats["graph_captures"] == stats_async["graph_captures"] == ref_stats["graph_captures"]:
        raise AssertionError(  # the in-process engine captured at warm-up only
            f"graphs captured: worker {stats['graph_captures']}, async worker "
            f"{stats_async['graph_captures']}, in process {ref_stats['graph_captures']}")
    resend = got["resend"]
    prompt = got["prompts"][WORKER_RESEND]
    full = compute_seq_hashes(prompt, mdc.kv_block_size)
    stored = {h for ev in events if ev.event.op == "stored" for h in ev.event.block_hashes}
    if not resend["cached_tokens"] or not set(full) <= stored:
        raise AssertionError(
            f"resent {WORKER_RESEND}: cached_tokens {resend['cached_tokens']}, "
            f"{len(set(full) & stored)} of its {len(full)} full blocks in the worker's KV events"
        )
    print(f"worker resend {WORKER_RESEND}: cached_tokens {resend['cached_tokens']}; all "
          f"{len(full)} full-block hashes of the prompt among the {len(stored)} stored hashes "
          f"of {len(events)} KV events", flush=True)
    kernels = stats["kernel_launches"]
    if (device == "cuda" and (
            stats["attention_launches"]
            != cfg.num_layers * (stats["forwards"] + stats["warm_up_forwards"])
            or stats["attention_launches_int8"] != 0
            or min(kernels[k] for k in ("ragged_paged_attention_decode_launch",
                                        "ragged_paged_attention_tiled_launch")) == 0)):
        raise AssertionError(f"the worker's K1 launches do not match its forwards: {stats}")
    decode_ms = {"worker": 1e3 * stats["decode_loop_s"] / stats["decode_iterations"],
                 "in_process": 1e3 * ref_stats["decode_loop_s"] / ref_stats["decode_iterations"],
                 "async_worker_solo": 1e3 * stats_async["decode_loop_s"]
                 / stats_async["decode_iterations"]}
    rows = [summarize("worker", got), summarize("in_process", ref)]
    for key in ("batch", "staggered"):
        for rid in sorted(rows[0][f"{key}_ttft_ms"]):
            print(f"{key} {rid}: TTFT worker {rows[0][f'{key}_ttft_ms'][rid]:.1f} ms, in-process "
                  f"{rows[1][f'{key}_ttft_ms'][rid]:.1f} ms; first token from the batch's step "
                  f"{rows[0][f'{key}_first_step'][rid]} vs {rows[1][f'{key}_first_step'][rid]}"
                  f"; ms per token after the first {rows[0][f'{key}_tpot_ms'][rid]:.2f} vs "
                  f"{rows[1][f'{key}_tpot_ms'][rid]:.2f}", flush=True)
    dp = got["dataplane"]
    print(f"worker against in-process on {card}: decode {decode_ms['worker']:.2f} vs "
          f"{decode_ms['in_process']:.2f} ms per iteration (engine counters over the same "
          f"traffic); median ms per token after the first, batch "
          f"{rows[0]['batch_tpot_ms_median']:.2f} vs {rows[1]['batch_tpot_ms_median']:.2f}, "
          f"staggered {rows[0]['staggered_tpot_ms_median']:.2f} vs "
          f"{rows[1]['staggered_tpot_ms_median']:.2f}; worker K1 launches {kernels}", flush=True)
    print(f"data plane on this host, no engine: {dp['chunks']} chunks ({dp['tokens']} tokens) "
          f"in {dp['streams']} streams, {dp['wall_ms_per_chunk']:.4f} ms of wall per chunk; "
          f"CPU ms per chunk (per token): server {dp['server_cpu_ms_per_chunk']:.4f} "
          f"({dp['server_cpu_ms_per_token']:.4f}), client {dp['client_cpu_ms_per_chunk']:.4f} "
          f"({dp['client_cpu_ms_per_token']:.4f})", flush=True)
    print(f"async worker (solo prompts): decode {decode_ms['async_worker_solo']:.2f} ms per "
          f"iteration; graph_replays {stats_async['graph_replays']} = dispatches "
          f"{stats_async['dispatches']}, graph_captures {stats_async['graph_captures']}", flush=True)
    return {"decode_ms_per_iteration": decode_ms, "dataplane": dp,
            "worker": rows[0], "in_process": rows[1],
            "worker_attention_launches": stats["attention_launches"],
            "worker_forwards": stats["forwards"],
            "worker_warm_up_forwards": stats["warm_up_forwards"], "kv_events": len(events)}


def kernel_entry(name, source, replaces, launches, shapes, main_shape, **extra) -> dict:
    """One kernel's record for the kernels line: the contract's keys from
    the main path's launch count and the main shape's measurements, then
    every shape measured."""
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches,
        "max_abs_err": max(s["max_abs_err"] for s in shapes),
        "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"], "bound_by": main_shape["bound_by"],
        # No single PyTorch call computes paged attention over a block table.
        "library_ms": None,
        "ok": all(s["ok"] for s in shapes),
        "max_row_rel_err": max(s["max_row_rel_err"] for s in shapes),
        "row_rel_tol": ROW_REL_TOL,
        "shape": main_shape["shape"],
        **extra,
        "shapes": shapes,
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    from dynamo_tpu_torch.engine.config import llama3_8b
    from dynamo_tpu_torch.ops import _build
    from dynamo_tpu_torch.ops import paged_attention as pa
    from dynamo_tpu_torch.ops import ragged_attention as ra

    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        # Every kernel and every planted fault's copy: one nvcc each, all
        # started together.
        t0 = time.time()
        planted = build_planted(tmp)
        with ThreadPoolExecutor(2) as pool:
            list(pool.map(_build.load, ("ragged_paged_attention", "paged_attention")))
        for fut in planted.values():
            fut.result()
        print(f"kernel build: ragged_paged_attention.cu, paged_attention.cu and "
              f"{len(planted)} planted-fault copies in {time.time() - t0:.1f} s", flush=True)

        reqs, late, _ = serving_requests(llama3_8b().vocab_size)
        prompt_lens = [len(p) for _, p, _ in reqs]
        # The serving batch 48 tokens into decode (2000 + 48 ends on a split edge).
        decode_lens = [n + 48 for n in prompt_lens + [len(late[1])]]
        shapes, batches = check_attention_kernel(ra, decode_lens)
        faults = check_planted_faults(ra, batches, planted, PLANTED_FAULTS)
        del batches
        shapes8, batches8 = check_attention_kernel(ra, decode_lens, int8=True)
        faults8 = check_planted_faults(ra, batches8, planted, PLANTED_FAULTS_INT8, int8=True)
        del batches8
        shapes += check_serving_prefill_shape(ra, prompt_lens)
        shapes8 += check_serving_prefill_shape(ra, prompt_lens, int8=True)
        k2_shapes, k2_batches = check_paged_attention_kernel(pa)
        k2_faults = check_k2_planted_faults(pa, k2_batches, planted)
        del k2_batches
        torch.cuda.empty_cache()

    k2 = k2_path(pa)
    counts, summary = serve(ra, card)
    print(f"serving summary: {json.dumps(summary)}", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"bf16 engine freed: allocated {torch.cuda.memory_allocated() / 1e9:.2f} GB", flush=True)
    counts8, summary8 = serve(ra, card, int8=True)
    print(f"serving summary: {json.dumps(summary8)}", flush=True)
    print(f"int8 against bf16 on {card}: prefill {summary8['prefill_tokens_per_s']:.0f} vs "
          f"{summary['prefill_tokens_per_s']:.0f} tokens/s, decode "
          f"{summary8['decode_ms_per_iteration']:.2f} vs {summary['decode_ms_per_iteration']:.2f} "
          f"ms per iteration", flush=True)
    for summ in (summary, summary8):
        ge, sa = summ["graph_against_eager"], summ["graphs_sync_async"]
        print(f"decode on {card} ({summ['mode']}, ms per iteration): eager body "
              f"{ge['eager_ms_per_iteration']:.3f}, graph replay {ge['graph_ms_per_iteration']:.3f} "
              f"(width {GRAPH_WIDTH}, k = {GRAPH_K}); serving graphs sync "
              f"{sa['sync']['decode_ms_per_iteration']:.3f}, graphs async "
              f"{sa['async']['decode_ms_per_iteration']:.3f}", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"worker summary: {json.dumps(serve_worker(card))}", flush=True)

    def k2_shapes_of(pages):
        return [s for s in k2_shapes if s["pages"] == pages]

    def k2_main(pages):  # K2's path: the bench comparison, no self position
        return next(s for s in k2_shapes_of(pages) if s["shape"] == "bench_kvquant" and not s["self"])

    k1_src, k2_src = ("dynamo_tpu_torch/csrc/ragged_paged_attention.cu",
                      "dynamo_tpu_torch/csrc/paged_attention.cu")
    # One record per C entry point. Main shapes: K1's decode kernel at the
    # serving decode form, its tiled kernel at the serving prefill wave
    # (the shapes each runs on the main path); K2 at the int8-against-bf16
    # comparison (its path).
    k1 = []
    for int8, got, counts_of, planted_of, table in (
        (False, shapes, counts, faults, PLANTED_FAULTS),
        (True, shapes8, counts8, faults8, PLANTED_FAULTS_INT8),
    ):
        for kernel, main_shape in (("decode", "decode_serving8"), ("tiled", "prefill_wave8192")):
            own = [x for x in got if x["kernel"] == kernel]
            main_rec = next(x for x in own if x["shape"] == main_shape)
            extra = {}
            if int8:
                bf16 = next(x for x in shapes if x["kernel"] == kernel and x["shape"] == main_shape)
                extra["int8_vs_bf16"] = main_rec["ms"] / bf16["ms"]
            name = ra.ENTRY_NAMES[kernel, int8]
            k1.append(kernel_entry(
                name, k1_src, "dynamo_tpu/ops/ragged_attention.py:163", counts_of[name], own,
                main_rec, pages="int8" if int8 else "bf16", **extra,
                planted_faults_row_rel_err={f: planted_of[f] for f in table[kernel]},
            ))
    print(json.dumps({"kernels": k1 + [
        kernel_entry("paged_attention_launch", k2_src, "dynamo_tpu/ops/paged_attention.py:216",
                     k2["launches"]["bf16"], k2_shapes_of("bf16"), k2_main("bf16"), pages="bf16",
                     planted_faults_row_rel_err={f: k2_faults[f] for f in PLANTED_FAULTS_K2}),
        kernel_entry("paged_attention_launch (int8 pages)", k2_src,
                     "dynamo_tpu/ops/paged_attention.py:216",
                     k2["launches"]["int8"], k2_shapes_of("int8"), k2_main("int8"), pages="int8",
                     int8_vs_bf16=k2["int8_vs_bf16"], planted_faults_row_rel_err=k2_faults),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
