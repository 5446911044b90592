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
K's scale); K1 also at Qwen2-7B's head layout (28 query heads over 4 KV
heads, a group of 7: the decode form and a 2048-token tiled wave, with
the planted faults), (4) runs K2's own path, that
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
iteration), and the traffic runs again through the warm engine, sync
and then async (streams equal, decode ms per iteration and TTFT printed
for each); then the chunked phase
(:func:`serve_chunked`, bf16, at full width and depth on the same
weights): a chunked engine's ``warm_up()`` at the one decode width its
8 lanes need (its graph keys by kind, capture seconds, memory), K1's
kernels held against the plain version at the mixed steps the chunked
planners dispatch (T 8192 with a 2048-token chunk and T 2048 with a 512
chunk, each next to 7 decode rows), a mixed batch at T == S through the
model's forward (every layer's attention against the plain version), one
mixed step and one fused megastep replayed against their eager bodies
(tokens equal), a prompt prefilled in three chunks beside decode rows
against one wave (logits' cosine), and the traffic of 7 decoding streams
joined by a 2124-token prompt under waves, chunked at the defaults (sync
and async) and chunked with ``max_num_batched_tokens`` 2048: the streams'
largest and p99 gap between tokens, the long prompt's TTFT, the
real-token share of the mixed steps' token buckets, K1 launches = layers
x forwards and no capture after warm-up; then the speculation phase
(:func:`serve_spec`, bf16, on the same weights): K1's kernels held at
the verify rows' shapes (S rows of spec_k + 1 = 5 queries, T = S * 5),
verify-forward against one-token-forward logits, the history rings'
copy, a speculating engine's ``warm_up()`` and 8 segment-quoting prompts
with speculation off, drafted on the host and on the device (sync and
async), then the same engine under chunked scheduling with a 2124-token
prompt in the last lane (drafts made, fewer dispatches than tokens, no
capture while serving, greedy streams equal to spec off's up to
near-ties), then the KV tiers (:func:`serve_tiers`: a 256-block pool with
host and disk tiers behind it, 8 prompts of 2000 tokens and their
repeats, onboarded bytes and streams held to the main path engine's) and
the page programs (:func:`page_programs`: gather, scatter, direct copy,
the eviction slice, D2H and H2D of 1, 8 and 64 blocks against their byte
bounds, bf16 and int8), then an embedding (:func:`check_embed`: the
vector against the mean-pooled prefill hidden states, the serving
cache's pages unchanged) and image requests (:func:`check_images`: the
image's prefill eager, no capture, tokens and log-probabilities equal
with every dispatch eager, other streams without the image or with
another, the repeat cached and equal up to a near-tie) on the bf16
engine; with the llama3-8b engines freed, the MoE
phase (:func:`serve_moe`: 16 of Mixtral-8x7B's 32 layers at full width,
bf16, one layer's MoE MLP against its f32 CPU version, warm-up, 8
prompts in one wave with TTFT and decode ms beside their bounds, K1 at 16
launches per forward, graph against eager with tokens and
log-probabilities equal, the idle share, a chunked mixed step), then Qwen2-7B at full width, 4 of
its 28 layers (:func:`serve_qwen2`: greedy streams, the weights written
as a ``qwen2`` checkpoint and loaded back, every leaf equal, the same
streams from the loaded engine) and a GGUF file written and read back
(:func:`gguf_round_trip`: F32, F16 and BF16 tensors, the config, the
tokenizer), (6) runs the worker process:
the port's store (``python -m dynamo_tpu_torch.runtime.store``) and
``python -m dynamo_tpu_torch.backends.torch --model-name llama3-8b
--preset llama3-8b --seed 0`` as subprocesses, waits for the model card
through the port's discovery and sends requests through the port's
data-plane client: 4 greedy prompts one at a time, whose streams must
equal those of ``build_engine("llama3-8b", seed=0)`` in this process,
chunk for chunk but for the engine step the first chunk names
(the main path's bf16 engine, which ran the same traffic after all its
sub-phases; its weights were then written as a Hugging Face checkpoint by
this script's own safetensors writer and loaded back with every leaf
equal; here the checkpoint is loaded again as int8, layer 0 and
``lm_head`` bit-equal to the loader's arithmetic in numpy; the sync
worker serves that checkpoint with ``--model-path`` in place of
``--preset``), then all 8 at once, then,
with the prefix cache cleared, all 8 again staggered (one, and the other
7 0.1 s later, an arrival pattern neither path shapes), with time to
first token and decode ms per iteration printed beside the in-process
engine's, then one prompt again, which must report cached tokens and
whose full blocks' hashes must be among the worker's KV events; the
worker's own counters must show K1's two kernels launched once per layer
of every forward; a second worker with ``--async-exec on`` answers the 4
solo prompts with the sync worker's chunks (but for the engine step the
first chunk names); it also times the data plane alone, a server process
replaying the batch's recorded chunks to a client in this process (the
worker phase's requests ask for each token's log-probability; its main
worker runs without its status server and snapshots), (7) runs the
frontend phase (:func:`serve_frontend`): the port's store, two workers
started together (each with its status server and obs snapshots, as by
default) and ``python -m dynamo_tpu_torch.frontend --router-mode kv``,
each a process, spoken to over HTTP: ``/health`` on all three, a
shared-prefix chat routed to the worker holding the prefix (cached
tokens, the worker's prefix-hit gauge), a fresh prompt routed away from
a busy worker, the worker phase's solo prompts as pre-tokenized
completions, streamed and not, with the tokens and log-probabilities of
the data-plane client's streams, its 8 requests at once timed beside the
same 8 sent by the data-plane client straight to the same worker and
beside the worker phase's, the frontend's request counters and each worker's
series under its ``worker_id`` on the frontend's ``/metrics``, each
worker's scheduler gauges against the counters it logs on exit, K1's
launches in each worker, and a peer pull (:func:`check_peer_pull`: one
worker imports the other's 64 prompt blocks on a router's
``peer_prefix`` hint, its pages and stream held to the holder's), (8)
runs the disaggregation phase (:func:`serve_disagg`: a prefill worker, a
decode worker, an aggregated worker and the frontend as processes, the
three workers warming up together and serving llama3-8b's first 8
layers at full width from a checkpoint the main path's engine wrote; the
serving requests at once and staggered through both paths, greedy
streams equal up to measured near-ties, pages checksummed on both sides,
blocks imported with no recompute and no failed pull), (9) runs the
doctor (:func:`doctor_phase`: ``python -m dynamo_tpu_torch.check``
against a store it starts, exit 0, K1 launched by its engine check) and
the single-command runner (:func:`doctor_and_runner`: ``python -m
dynamo_tpu_torch.run`` with ``--out torch --preset llama3-8b`` at full
width and depth on the worker phase's 8 prompts as text, ``--out echo``,
``--out mocker`` and the doctor beside its worker's start-up, one
completion per prompt, the torch run's worker start-up split and its K1
launches from its exit counters), and (10)
prints a JSON line of
kernel measurements (one record per C entry point) and, last, a JSON
status line. Along the bf16 serving phase, the main path's engine streams
the worker phase's ``long`` prompt alone after each sub-phase
(:func:`solo_drift`: the first position where it parts from the stream
just after warm-up, the top-2 gap there), and after the last sub-phase
that stream is held to the one just after warm-up under the near-tie
rule, so a long-lived engine serves as a fresh worker does; the same
prompt repeated over its own cached prefix is held to its cold run under
that rule too, and where it parts is printed. Any failed check raises and the script exits non-zero.
Without a card it exits non-zero at once and prints no result.
"""

from __future__ import annotations

import asyncio
import ctypes
import dataclasses
import gc
import json
import os
import re
import shutil
import signal
import socket
import struct
import subprocess
import threading
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


def attention_batch(q_lens, kv_lens, S, pages_per_seq, T, gen, n_q=N_Q, n_kv=N_KV):
    """Ragged operands on the card: sequence s owns q rows cu[s]..cu[s+1]-1
    and its own pages; rows past cu[num_seqs] and table entries past a
    sequence's pages point at the garbage page. Returns the positional
    operands and the keyword ones (none for bf16 pages)."""
    dev = "cuda"
    n_pages = sum(-(-L // PAGE) for L in kv_lens) + 1
    q = torch.randn(T, n_q, HEAD_DIM, device=dev, generator=gen).bfloat16()
    kv = torch.randn(n_pages, PAGE, 2 * n_kv, HEAD_DIM, device=dev, generator=gen).bfloat16()
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


def attention_bound(q_lens, kv_lens, T, int8=False, n_q=N_Q, n_kv=N_KV):
    """Least time for this call's work: each input byte the data needs
    read once (q rows, the visible K/V rows and, for int8 pages, their
    scales, the table entries in use), the output written once; operations
    4 * visible positions * n_q * d (QK^T and PV, a multiply-add counted
    as 2)."""
    kv_rows = sum(kv_lens)
    pages = sum(-(-L // PAGE) for L in kv_lens)
    row_bytes = HEAD_DIM + SCALE_BYTES if int8 else HEAD_DIM * 2
    nbytes = (
        sum(q_lens) * n_q * HEAD_DIM * 2        # q (bf16)
        + kv_rows * 2 * n_kv * row_bytes        # K and V rows (+ scales)
        + T * n_q * HEAD_DIM * 2                # out (bf16)
        + 4 * (pages + 2 * len(kv_lens) + 2)    # tables, kv_lens, cu, num_seqs
    )
    visible = sum(
        min(L - q + i + 1, L) for q, L in zip(q_lens, kv_lens) for i in range(q)
    )
    ops = 4 * visible * n_q * HEAD_DIM
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
    n_q, n_kv = q.shape[1], kv.shape[2] // 2
    group = n_q // n_kv
    cu_h = cu.tolist()

    def contiguous(s, L):
        pos = torch.arange(L, device=q.device)
        slots = tables[s].long()[pos // PAGE] * PAGE + pos % PAGE
        rows = kv.reshape(-1, 2 * n_kv, HEAD_DIM)[slots]
        if "kv_scales" in kw:
            rows = dequantize_kv(rows, kw["kv_scales"].reshape(-1, 2 * n_kv)[slots]).bfloat16()
        k, v = (rows[:, i::2].repeat_interleave(group, dim=1).transpose(0, 1) for i in (0, 1))
        return k, v                                                    # [n_q, L, d]

    if all(n == 1 for n in q_lens):
        B, L = len(q_lens), max(kv_lens)
        k = torch.zeros(B, n_q, L, HEAD_DIM, dtype=torch.bfloat16, device=q.device)
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
    n_q, n_kv = args[0].shape[1], args[1].shape[2] // 2
    bound_ms, bound_by = attention_bound(q_lens, kv_lens, T, int8, n_q, n_kv)
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
            shape=name, kernel=kernel, n_q=n_q, n_kv=n_kv, T=T, S=args[3].shape[0],
            num_seqs=len(q_lens),
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


# K1 at Qwen2-7B's attention geometry: 28 query heads over 4 KV heads, a
# group of 7. The decode kernel's template rounds the group up to 8; the
# tiled kernel takes 128 // 7 = 18 query rows per block (126 of its 128 M
# rows). The serving engine's shapes: S = 8 slots of 256 pages.
QWEN_N_Q, QWEN_N_KV = 28, 4
QWEN_DECODE_LENS = [2048, 1700, 1200, 900, 513, 300, 64, 33]
QWEN_PREFILL_LENS = [1024, 600, 300, 124]  # one 2048-token wave


def check_qwen2_attention(ra, planted) -> tuple[list[dict], dict]:
    """Both K1 kernels, bf16 pages, at Qwen2-7B's head layout: the decode
    form (T = S = 8) and a tiled prefill wave (T 2048, held against the
    plain version in row chunks), then every planted fault of the bf16
    kernels on both batches, which the comparison must catch."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    geo = dict(n_q=QWEN_N_Q, n_kv=QWEN_N_KV)
    scale = HEAD_DIM ** -0.5
    results, batches = [], []
    for name, q_lens, kv_lens, T, reps in (
        ("qwen2_decode8", [1] * 8, QWEN_DECODE_LENS, 8, 20),
        ("qwen2_prefill2048", QWEN_PREFILL_LENS, QWEN_PREFILL_LENS, 2048, 10),
    ):
        args, kw = attention_batch(q_lens, kv_lens, 8, 256, T, gen, **geo)
        if T == 8:
            plain = lambda: ra.ragged_paged_attention_ref(*args, sm_scale=scale, **kw)  # noqa: E731
        else:
            plain = lambda: plain_by_row_chunks(ra, args, kw, q_lens)  # noqa: E731
        want = plain()
        plain_ms = cold_ms(plain, 3 if T == 8 else 1)
        results += hold_k1(ra, name, args, kw, want, q_lens, kv_lens, T, False, reps, plain_ms,
                           "attention qwen2")
        batches.append((name, args, kw, want, sum(q_lens)))
        torch.cuda.empty_cache()
    faults = check_planted_faults(ra, batches, planted, PLANTED_FAULTS)
    del batches
    torch.cuda.empty_cache()
    return results, faults


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


def wire(rid, prompt, sampling, logprobs=None):
    req = {"model": "llama3-8b", "token_ids": prompt, "request_id": rid,
           "sampling": sampling, "stop": {"max_tokens": MAX_TOKENS}}
    if logprobs is not None:
        req["output"] = {"logprobs": logprobs}
    return req


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


def sync_against_async(core, reqs, mode: str) -> dict:
    """The serving traffic (all 8 prompts at once, prefix caches cleared)
    through the warm engine, sync and then async (its configuration
    switched: the step reads ``async_exec`` each time, and the graphs are
    the same), twice each, the second pass measured: identical streams;
    decode ms per iteration (the engine loop's wall over its decode
    iterations) and TTFT for each. (The worker phase's async worker and
    the chunked phase warm up with async execution on.)"""
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.runtime.engine import Context

    rows = {}
    for name in ("sync", "async"):
        c = core
        c.engine = dataclasses.replace(c.engine, async_exec=name == "async")
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
    core.engine = dataclasses.replace(core.engine, async_exec=False)
    if not same or any(len(t) != MAX_TOKENS for t in rows["async"]["streams"].values()):
        raise AssertionError(f"{mode}: async execution changed the streams")
    return {name: {k: v for k, v in r.items() if k != "streams"} for name, r in rows.items()}


def solo_stream(core, repeat: bool = False):
    """The worker phase's first solo prompt (``long``, 2000 tokens) alone
    through a synchronous engine from a cleared prefix cache: 64 greedy
    tokens, each with its top-2 log-probabilities. With ``repeat``, the
    same request again over the prefix the first run left cached, and
    both runs. The prefix cache is cleared after, so the run leaves no
    cached block behind (a later request of the same prompt would prefill
    only its last block over those pages, which rounds bf16 otherwise
    than a cold prefill, and part from a fresh worker's stream)."""
    reqs, _, _ = serving_requests(core.cfg.vocab_size)
    rid, prompt, sampling = next(r for r in reqs if r[0] == WORKER_SOLO[0])
    req = wire(rid, prompt, sampling, logprobs=2)
    core.clear_kv_cache()
    cold = run_wires(core, [req])
    again = run_wires(core, [req]) if repeat else None
    core.clear_kv_cache()
    return (cold, again) if repeat else cold


def solo_drift(core, want: dict, phase: str) -> dict:
    """The long-lived engine's solo stream after ``phase`` against ``want``
    (the same engine's just after warm-up): the first position where the
    tokens part and ``want``'s top-2 gap there, and the largest
    log-probability difference before it. Printed, not asserted: the
    check after the last sub-phase holds the stream."""
    rid = WORKER_SOLO[0]
    w, g = want[rid], solo_stream(core)[rid]
    j = first_divergence(w["tokens"], g["tokens"])
    diff = max([abs(x["logprob"] - y["logprob"])
                for x, y in list(zip(w["logprobs"], g["logprobs"]))[:j]] or [0.0])
    gap = None if j is None else w["logprobs"][j]["top"][0][1] - w["logprobs"][j]["top"][1][1]
    print(f"long-lived engine, solo {rid} after {phase}: "
          + ("tokens equal" if j is None else f"tokens part at {j} (top-2 gap {gap:.4e})")
          + f"; log-probabilities differ by up to {diff:.4e}"
          + (" before it" if j is not None else ""), flush=True)
    return {"after": phase, "first_divergence": j, "top2_gap": gap, "max_logprob_diff": diff}


def serve(ra, card: str, int8=False) -> tuple[dict, dict, tuple | None]:
    """The main path: 8 requests through the llama3-8b engine, bf16, or
    (``int8``) with int8 weights and int8 KV pages, after ``warm_up()``
    (so every prefill wave and decode megastep is a graph replay); then
    the graph-against-eager megastep, k = 1 against k = 8, and the
    traffic with async execution off and on. The bf16 engine then runs
    its other sub-phases (chunked, speculation, tiers, page programs, an
    embedding and image requests), its solo stream checked after each
    (:func:`solo_drift`), and last the worker phase's in-process reference
    (:func:`in_process_traffic`), which is returned with the checkpoints
    it writes (None under ``int8``). The main path reads its counters as
    differences over its own traffic."""
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
    # The long-lived engine's solo stream, as a fresh worker serves it,
    # then again after each sub-phase (bf16: the sub-phases run there).
    solo_want, cached_repeat = None, None
    if not int8:
        solo_want, again = solo_stream(core, repeat=True)
        # The mechanism that parts a long-lived engine's stream from a
        # fresh worker's: the prompt's own prefix in its cache.
        cached_repeat = near_tie_streams("the long prompt over its own cached prefix against "
                                         "its cold run", solo_want, again)
        cached_repeat["cached_tokens"] = again[WORKER_SOLO[0]]["cached_tokens"]
        print(f"long-lived engine, solo {WORKER_SOLO[0]} repeated over its cached prefix "
              f"({cached_repeat['cached_tokens']} tokens): parts from its cold run at "
              f"{[(x['position'], round(x['gap'], 6)) for x in cached_repeat['parted']]} "
              f"(position, top-2 gap); log-probabilities differ by up to "
              f"{cached_repeat['limit']:.4e} before", flush=True)
    drift: list[dict] = []

    def after(phase: str) -> None:
        if solo_want is not None:
            drift.append(solo_drift(core, solo_want, phase))

    reqs, late, solo = serving_requests(core.cfg.vocab_size)

    # The main path, with every kernel launch count at 0 just before it,
    # from a cleared prefix cache, its counters read over its traffic.
    core.clear_kv_cache()
    before, hits0 = dict(core.scheduler_stats()), core.kv_cache_stats()["admitted_hits"]
    ra.reset_launches()
    t_serve = time.time()
    results = asyncio.run(serve_concurrent(engine, Context, reqs, late))
    serve_s = time.time() - t_serve
    launches, other = (ra.launches_int8, ra.launches) if int8 else (ra.launches, ra.launches_int8)
    by_entry = {ra.ENTRY_NAMES[k, int8]: ra.kernel_launches[ra.ENTRY_NAMES[k, int8]]
                for k in K1_KERNELS}
    captures = core.scheduler_stats()["graph_captures"]
    st = {k: v - before[k] for k, v in core.scheduler_stats().items()}
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
    if captures != warm["graph_captures"]:
        raise AssertionError(f"{mode}: {captures - warm['graph_captures']} graphs "
                             f"captured while serving, after warm_up()")
    kv = core.kv_cache_stats()
    if (results["prefix_b"][2].get("cached_tokens") != SHARED_PREFIX
            or kv["admitted_hits"] - hits0 < 1):
        raise AssertionError(f"shared prefix missed the prefix cache: {kv}")
    print(f"main path ({mode}): {len(results)} requests in {serve_s:.2f} s; forwards {forwards} "
          f"(prefill waves + decode iterations), attention launches {launches} = "
          f"{core.cfg.num_layers} x {forwards} counted across graph replays, by kernel "
          f"{by_entry}; dispatches {st['dispatches']} (megastep {st['megastep_dispatches']}), "
          f"graph_replays {st['graph_replays']}, graph_captures {captures} "
          f"({warm['graph_captures']} at warm-up)", flush=True)
    prefill_tps = st["prefill_tokens"] / st["prefill_s"]
    decode_ms = 1e3 * st["decode_loop_s"] / st["decode_iterations"]
    print(f"serving {mode} on {card}: prefill {prefill_tps:.0f} tokens/s "
          f"({st['prefill_tokens']} tokens in {st['prefill_s']:.3f} s), decode "
          f"{decode_ms:.2f} ms per iteration (engine loop: {st['decode_iterations']} iterations "
          f"in {st['decode_loop_s']:.3f} s; dispatch to landing "
          f"{1e3 * st['decode_s'] / st['decode_iterations']:.2f})", flush=True)

    after("the main path's traffic")
    logit_check = check_logits(core, reqs[5][1][:64])
    graph_check = graph_against_eager(core, reqs + [late], mode)
    after("the logits check and the megastep's graph against its eager body")

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
    after("the k=1 engine on its weights")
    modes = sync_against_async(core, reqs + [late], mode)
    after("the sync and async passes")
    chunked = None if int8 else serve_chunked(ra, card, core)
    after("the chunked phase")
    spec = None if int8 else serve_spec(ra, card, core)
    after("the speculation phase")
    tiers = None if int8 else serve_tiers(ra, card, core)
    after("the tier phase")
    pages = page_programs(core, mode)
    after("the page programs")
    mm = None
    if not int8:
        mm = {"embed": check_embed(ra, core)}
        after("the embedding")
        mm["images"] = check_images(ra, core)
        after("the image requests")
        # Kept: after all its sub-phases, the engine streams the solo
        # prompt bit for bit as it did just after warm-up (as the worker
        # phase's fresh worker streams it): no sub-phase leaves state
        # behind that a later request reads.
        near_tie_streams("the long-lived engine after its sub-phases", solo_want,
                         solo_stream(core), exact=True)
        print("long-lived engine: after all its sub-phases its solo stream equals the one just "
              "after warm-up (tokens and log-probabilities, bit for bit)", flush=True)
    # The worker phase's in-process reference, served by this long-lived
    # engine after all its sub-phases from a cleared prefix cache; the
    # worker phase holds a fresh worker's streams to it.
    reference = None if int8 else in_process_traffic(core, warm["graph_captures"])
    return by_entry, {
        "mode": mode, "attention_launches": launches, "requests": len(results), "serve_s": serve_s, "forwards": forwards,
        "bytes_per_block": core.kv_cache_stats()["bytes_per_block"],
        "prefill_tokens_per_s": prefill_tps, "decode_ms_per_iteration": decode_ms,
        "logits_cosine": logit_check["cosine"], "warm_up": warm,
        "graph_replays": st["graph_replays"], "dispatches": st["dispatches"],
        "graph_against_eager": graph_check, "graphs_sync_async": modes,
        "chunked": chunked, "spec": spec, "tiers": tiers, "page_programs": pages, "mm": mm,
        "long_lived_drift": drift, "cached_prefix_repeat": cached_repeat,
    }, reference


# -- multimodal rows and embeddings (in process, on the main path's engine) -----

MM_TEXT = 200       # prompt tokens before the image's placeholders
MM_TOKENS = 32      # tokens each image request decodes
MM_LOGPROBS = 2     # each token's top 2: the near-tie rule reads the gap between them
EMBED_PROMPT = 300
EMBED_PAGES = 16    # serving-cache pages whose bytes are hashed around the embedding
# The embedding against the mean of the same prompt's prefill hidden states:
# both run the same kernels on the same rows, the embedding at the 512-token
# bucket (its products at another M, so another cuBLAS order). bf16 rounds
# at 2**-8 at each of 32 layers; the vectors must point the same way and
# differ by at most 3e-2 of their norm.
EMBED_MIN_COSINE = 0.999
EMBED_REL_TOL = 3e-2


def data_url(payload: bytes) -> str:
    import base64

    return "data:application/octet-stream;base64," + base64.b64encode(payload).decode()


IMG_A = data_url(b"a cat sitting on a red mat" * 9)
IMG_B = data_url(b"a dog running on green grass" * 9)


def mm_wire(rid: str, prompt: list[int], img: str, cfg, with_image=True) -> dict:
    """A greedy request whose prompt has ``img``'s placeholder tokens after
    ``MM_TEXT`` text tokens, with the encoder's rows in ``mm`` (or, without
    the image, the same tokens alone)."""
    from dynamo_tpu_torch.llm.multimodal import MM_PATCHES, image_bytes, patch_embed, pseudo_tokens

    toks = prompt[:MM_TEXT] + pseudo_tokens(img, cfg.vocab_size) + prompt[MM_TEXT:]
    req = wire(rid, toks, {"temperature": 0.0}, logprobs=MM_LOGPROBS)
    req["stop"] = {"max_tokens": MM_TOKENS}
    if with_image:
        emb = patch_embed(image_bytes(img), cfg.hidden_size)
        req["mm"] = {"images": [img], "positions": [[MM_TEXT, MM_PATCHES]],
                     "embeds": emb.tobytes(), "embeds_shape": list(emb.shape)}
    return req


def run_wires(core, reqs: list[dict]) -> dict:
    """Requests added together to a synchronous engine and stepped to the
    end: each one's tokens, logprob entries, cached tokens and time to the
    step that emitted its first token."""
    from dynamo_tpu_torch.llm.protocols.common import PreprocessedRequest

    t0 = time.perf_counter()
    seqs = {core.add_request(PreprocessedRequest.from_wire(r)).request_id: r for r in reqs}
    out = {rid: {"tokens": [], "logprobs": [], "ttft_ms": None} for rid in seqs}
    by_rid = {}
    while core.has_work():
        for s, o in core.step():
            by_rid[s.request_id] = s
            got = out[s.request_id]
            got["tokens"] += o.token_ids
            got["logprobs"] += o.logprobs or []
            if got["ttft_ms"] is None and o.token_ids:
                got["ttft_ms"] = 1e3 * (time.perf_counter() - t0)
    for rid, got in out.items():
        got["cached_tokens"] = by_rid[rid].num_cached_tokens
        want = seqs[rid]["stop"]["max_tokens"]
        if len(got["tokens"]) != want:
            raise AssertionError(f"{rid}: {len(got['tokens'])} tokens of {want}")
    return out


def eager_dispatches(core):
    """``core`` with every dispatch run as its eager body, never a graph."""
    from dynamo_tpu_torch.engine.core import EngineCore

    core._launch = lambda launch, feed=None: EngineCore._launch(
        core, dataclasses.replace(launch, eager=True), feed)
    return core


# The near-tie rule's ceiling: two runs whose kernels differ (a prompt's
# blocks recomputed or read from the prefix cache, prefilled on another
# worker) moved a token's log-probability by at most 0.041 before any
# stream parted in the smoke's runs on the H100; a measured limit above
# this is a fault of its own, not a near-tie.
NEAR_TIE_CEILING = 0.1


def near_tie_streams(name: str, want: dict, got: dict, exact: bool = False) -> dict:
    """Greedy streams of ``got`` against ``want`` (rid -> tokens and logprob
    entries, each with its top 2). ``exact``: the two runs compute one
    function through the same kernels (graph replays against their eager
    bodies on one engine), so every token and log-probability must be
    equal. Otherwise the streams are equal, or part only at a near-tie:
    the limit is the largest difference between the two runs'
    log-probabilities of the same token at the same position before any
    stream parts, and must stay under ``NEAR_TIE_CEILING``; a stream that
    parts where ``want``'s top-2 gap exceeds the limit fails."""
    if exact:
        for rid, w in want.items():
            g = got[rid]
            if (w["tokens"] != g["tokens"]
                    or [x["logprob"] for x in w["logprobs"]] != [y["logprob"] for y in g["logprobs"]]):
                j = first_divergence(w["tokens"], g["tokens"])
                raise AssertionError(f"{name}: {rid} is not equal (tokens part at {j}, or a "
                                     f"log-probability differs)")
        return {"streams": len(want), "equal": len(want), "parted": [], "limit": 0.0}
    limit = 0.0
    for rid, w in want.items():
        j = first_divergence(w["tokens"], got[rid]["tokens"])
        for x, y in list(zip(w["logprobs"], got[rid]["logprobs"]))[:j]:
            limit = max(limit, abs(x["logprob"] - y["logprob"]))
    if limit > NEAR_TIE_CEILING:
        raise AssertionError(f"{name}: log-probabilities differ by {limit:.4e} before any stream "
                             f"parts, above the ceiling {NEAR_TIE_CEILING}")
    parted = []
    for rid, w in want.items():
        j = first_divergence(w["tokens"], got[rid]["tokens"])
        if j is None:
            continue
        top = w["logprobs"][j]["top"]
        gap = top[0][1] - top[1][1]
        parted.append({"rid": rid, "position": j, "gap": gap})
        print(f"divergence, {name} {rid} at token {j}: {w['tokens'][j]} against "
              f"{got[rid]['tokens'][j]}; top-2 gap {gap:.4e} (limit {limit:.4e})", flush=True)
        if gap > limit:
            raise AssertionError(f"{name}: {rid} parts at token {j} where the top-2 gap "
                                 f"{gap:.4e} exceeds {limit:.4e}")
    return {"streams": len(want), "equal": len(want) - len(parted), "parted": parted,
            "limit": limit}


def launches_of(ra) -> dict:
    """K1's launches by C entry point since the last reset."""
    return {name: n for name, n in ra.kernel_launches.items() if n}


def check_embed(ra, core) -> dict:
    """``EngineCore.embed`` on the main path's engine, the launch counts at
    0 just before it: the vector against the mean over the prompt's rows
    of the same prompt's prefill hidden states (``forward_hidden`` on a
    scratch cache), and the serving cache's pages unchanged (the sha256 of
    up to ``EMBED_PAGES`` cached pages before and after)."""
    from dynamo_tpu_torch.engine import model
    from dynamo_tpu_torch.engine.config import EngineConfig

    cfg, dev = core.cfg, core.device
    rng = np.random.default_rng(77)
    prompt = [int(t) for t in rng.integers(0, cfg.vocab_size, EMBED_PROMPT)]
    # A request whose blocks stay cached: the pages the embedding must not touch.
    one_request(core, "embed_neighbour", [int(t) for t in rng.integers(0, cfg.vocab_size, 600)], 4)
    hashes = [h for tier, h, _ in core.kv_inventory() if tier == "device"][:EMBED_PAGES]
    before = {h: page_sha(core, h) for h in hashes}
    reserved = torch.cuda.memory_reserved()
    vec = core.embed(prompt)  # the first call builds the scratch cache
    scratch_gb = sum(c.numel() * c.element_size() for c in core._embed_scratch) / 1e9
    scratch_reserved_gb = (torch.cuda.memory_reserved() - reserved) / 1e9
    ra.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vec = core.embed(prompt)
    embed_ms = 1e3 * (time.perf_counter() - t0)
    launches = launches_of(ra)
    after = {h: page_sha(core, h) for h in hashes}
    eng = EngineConfig(num_kv_blocks=16, max_model_len=512)
    n, bs = len(prompt), eng.block_size
    i32 = lambda a: torch.tensor(a, dtype=torch.int32, device=dev)  # noqa: E731
    pages = -(-n // bs)
    table = list(range(pages)) + [eng.garbage_block] * (eng.max_blocks_per_seq - pages)
    x = model.forward_hidden(
        core.params, model.init_cache(cfg, eng, dev), i32(prompt), i32(list(range(n))),
        i32([p // bs for p in range(n)]), i32([p % bs for p in range(n)]), i32([n]),
        i32([table]), i32([0, n]), i32([1]), cfg,
    )
    ref = x.float().mean(dim=0)
    got = torch.from_numpy(vec).to(dev)
    cos = torch.nn.functional.cosine_similarity(got, ref, dim=0).item()
    rel = ((got - ref).norm() / ref.norm()).item()
    res = {"prompt_tokens": n, "embed_ms": embed_ms, "cosine": cos, "norm_rel_err": rel,
           "max_abs_err": (got - ref).abs().max().item(), "pages_hashed": len(hashes),
           "pages_unchanged": before == after, "launches": launches,
           "scratch_gb": scratch_gb, "scratch_reserved_gb": scratch_reserved_gb,
           "finite": bool(np.isfinite(vec).all())}
    print(f"embedding of a {n}-token prompt on the main path's engine: {embed_ms:.2f} ms "
          f"(eager, one forward at the {core._bucket_for(n)} bucket), K1 launches {launches}; "
          f"against the "
          f"mean-pooled prefill hidden state: cosine {cos:.6f}, norm-relative error {rel:.3e} "
          f"(limits {EMBED_MIN_COSINE}, {EMBED_REL_TOL}), max abs {res['max_abs_err']:.3e}; "
          f"{len(hashes)} serving-cache pages unchanged: {res['pages_unchanged']}; the scratch "
          f"cache the first call built holds {scratch_gb:.3f} GB for the engine's life (reserved "
          f"memory grew by {scratch_reserved_gb:.3f} GB)", flush=True)
    if (not res["finite"] or cos < EMBED_MIN_COSINE or rel > EMBED_REL_TOL or not hashes
            or not res["pages_unchanged"] or sum(launches.values()) != cfg.num_layers):
        raise AssertionError(f"the embedding check failed: {res}")
    return res


def check_images(ra, core) -> dict:
    """Image requests on the main path's engine after ``warm_up()``: the
    launch counts at 0 just before the first; its prefill runs eagerly (a
    multimodal dispatch) and its decode megasteps replay graphs, with no
    capture. Its greedy stream (tokens and log-probabilities) equals the
    same request on an engine whose every dispatch is eager; the same
    prompt without the image gives another stream (or other
    log-probabilities), another image too, and the image's repeat hits
    the prefix cache and equals the first run up to a near-tie."""
    from dynamo_tpu_torch.backends.torch.main import build_engine

    cfg = core.cfg
    prompt = [int(t) for t in np.random.default_rng(78).integers(0, cfg.vocab_size, MM_TEXT + 8)]
    core.clear_kv_cache()
    st0 = core.scheduler_stats()
    ra.reset_launches()
    a = run_wires(core, [mm_wire("img_a", prompt, IMG_A, cfg)])
    launches = launches_of(ra)
    st = core.scheduler_stats()
    d = {k: st[k] - st0[k] for k in ("dispatches", "graph_replays", "eager_dispatches",
                                      "graph_captures", "forwards")}
    a2 = run_wires(core, [mm_wire("img_a2", prompt, IMG_A, cfg)])
    # The same tokens without the image must not find the image's blocks.
    core.clear_kv_cache()
    plain = run_wires(core, [mm_wire("plain", prompt, IMG_A, cfg, with_image=False)])
    b = run_wires(core, [mm_wire("img_b", prompt, IMG_B, cfg)])
    ecore, _ = build_engine("llama3-8b", {"num_kv_blocks": 256}, device="cuda",
                            params=core.params)
    eager = run_wires(eager_dispatches(ecore), [mm_wire("img_a", prompt, IMG_A, cfg)])
    del ecore
    gc.collect()
    torch.cuda.empty_cache()
    held = near_tie_streams("image request, graphs against eager", a, eager, exact=True)
    repeat = near_tie_streams("image request, its repeat", a, {"img_a": a2["img_a2"]})

    def differs(x):
        return (x["tokens"] != a["img_a"]["tokens"]
                or x["logprobs"][0]["logprob"] != a["img_a"]["logprobs"][0]["logprob"])

    res = {"prompt_tokens": len(prompt) + 16, "ttft_ms": a["img_a"]["ttft_ms"], "launches": launches,
           **d, "graphs_against_eager": held, "repeat": repeat,
           "repeat_cached_tokens": a2["img_a2"]["cached_tokens"],
           "differs_without_image": differs(plain["plain"]), "differs_other_image": differs(b["img_b"])}
    print(f"image request on the main path's engine: TTFT {res['ttft_ms']:.1f} ms, "
          f"{d['dispatches']} dispatches ({d['eager_dispatches']} eager, {d['graph_replays']} graph "
          f"replays, {d['graph_captures']} captures), K1 launches {launches} for {d['forwards']} "
          f"forwards; graphs against eager: {held['equal']} of {held['streams']} streams equal; "
          f"differs without the image: {res['differs_without_image']}, with another image: "
          f"{res['differs_other_image']}; repeat cached {res['repeat_cached_tokens']} tokens",
          flush=True)
    if (d["graph_captures"] or d["eager_dispatches"] < 1
            or d["graph_replays"] != d["dispatches"] - d["eager_dispatches"]
            or sum(launches.values()) != cfg.num_layers * d["forwards"]
            or not res["differs_without_image"] or not res["differs_other_image"]
            or res["repeat_cached_tokens"] < PAGE):
        raise AssertionError(f"the image check failed: {res}")
    return res


# -- sparse MoE at Mixtral-8x7B width (in process) -------------------------------

MOE_LAYERS = 16   # one of two pipeline stages: 32 layers of bf16 experts need 92.9 GB
MOE_PROMPT_LENS = (128, 512, 1000, 1500, 2048, 2000, 300, 700)  # one 8192 wave
MOE_LAYER_TOKENS = 64


def moe_bounds(core, prompt_lens) -> dict:
    """The least time the card could take: a decode iteration reads every
    weight (capacity dispatch runs every expert on C >= 1 rows) over the
    memory rate. The prefill wave of ``prompt_lens`` over the tensor
    cores' bf16 rate, counted two ways: at its bucket with the experts'
    E * C slots each (capacity padding included: the dispatch's own
    semantics), and with only what its tokens need (the real tokens'
    projections and their k * n expert entries). Causal attention is
    counted in both."""
    from dynamo_tpu_torch.engine.model import _moe_capacity

    cfg = core.cfg
    h, i, E, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_experts, cfg.num_layers
    leaves = [core.params["final_norm"], *core.params["layers"].values()]
    if "lm_head" in core.params:
        leaves.append(core.params["lm_head"])
    weight_bytes = sum(t.numel() * t.element_size() for t in leaves)
    T, n = core._bucket_for(sum(prompt_lens)), sum(prompt_lens)
    C = _moe_capacity(T, cfg)
    attention = sum(2 * m * m * cfg.q_size for m in prompt_lens)  # QK^T and PV, causal

    def dense(rows):  # q, k, v, o and the router on ``rows`` tokens
        return 2 * rows * h * (cfg.q_size + 2 * cfg.kv_size) + 2 * rows * cfg.q_size * h \
            + 2 * rows * h * E

    slots = L * (dense(T) + 2 * E * C * 3 * h * i + attention)
    needed = L * (dense(n) + 2 * cfg.num_experts_per_tok * n * 3 * h * i + attention)
    return {"decode_weight_bytes": weight_bytes,
            "decode_bound_ms": 1e3 * weight_bytes / HBM_BYTES_PER_S,
            "prefill_bucket": T, "prefill_tokens": n, "prefill_capacity": C,
            "prefill_ops": slots, "prefill_bound_ms": 1e3 * slots / BF16_OPS_PER_S,
            "prefill_needed_ops": needed,
            "prefill_needed_bound_ms": 1e3 * needed / BF16_OPS_PER_S,
            "prefill_capacity_padding": 1 - cfg.num_experts_per_tok * T / (E * C)}


def moe_layer_check(core) -> dict:
    """Layer 0's ``_moe_mlp`` on the card (bf16) against the same function
    on CPU tensors in f32, for ``MOE_LAYER_TOKENS`` tokens at full width:
    the largest relative L2 error of an output row, within ROW_REL_TOL
    (as for K1); the card call's time against reading every expert's
    weights."""
    from dynamo_tpu_torch.engine import model

    cfg = core.cfg
    lp = {k: core.params["layers"][k][0] for k in ("w_router", "w_gate", "w_up", "w_down")}
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((MOE_LAYER_TOKENS, cfg.hidden_size), generator=gen, device="cuda")
    x = x.to(cfg.torch_dtype)
    got = model._moe_mlp(x, lp, cfg)
    ms = cold_ms(lambda: model._moe_mlp(x, lp, cfg), 5)
    want = model._moe_mlp(x.float().cpu(), {k: v.float().cpu() for k, v in lp.items()}, cfg)
    err = got.float().cpu() - want
    row_rel = (err.norm(dim=1) / want.norm(dim=1)).max().item()
    expert_bytes = sum(lp[k].numel() * lp[k].element_size() for k in lp)
    res = {"tokens": MOE_LAYER_TOKENS, "capacity": model._moe_capacity(MOE_LAYER_TOKENS, cfg),
           "max_row_rel_err": row_rel, "max_abs_err": err.abs().max().item(), "ms": ms,
           "bound_ms": 1e3 * expert_bytes / HBM_BYTES_PER_S,
           "finite": bool(torch.isfinite(got).all().item())}
    print(f"MoE MLP, layer 0 at full width, {MOE_LAYER_TOKENS} tokens (C {res['capacity']}): card "
          f"bf16 against CPU f32: largest row relative error {row_rel:.3e} (limit {ROW_REL_TOL}), "
          f"max abs {res['max_abs_err']:.3e}; {ms:.3f} ms on the card, L2 flushed (reading the "
          f"experts' {expert_bytes / 1e9:.2f} GB: {res['bound_ms']:.3f} ms)", flush=True)
    if not res["finite"] or not row_rel <= ROW_REL_TOL:
        raise AssertionError(f"the MoE MLP on the card disagrees with its f32 CPU version: {res}")
    return res


def moe_idle_share(core, reqs) -> dict:
    """Two decode megasteps of 8 lanes under ``torch.profiler``
    (``tools/profile_serving.py``'s phase): wall, kernel time by group and
    the device's idle share."""
    from dynamo_tpu_torch.tools.profile_serving import _phase

    ready = decode_to_width(core, reqs)
    phase = _phase(core, 2, "moe_decode", None)
    for seq in ready:
        core.cancel_request(seq)
    while core.has_work():
        core.step()
    print(f"MoE decode under the profiler: 2 megasteps in {phase['wall_ms']:.1f} ms, kernels "
          f"{phase['kernel_ms']:.1f} ms by group "
          f"{ {k: round(v, 2) for k, v in phase['groups_ms'].items()} }; device idle share "
          f"{phase['idle_share']:.4f}", flush=True)
    return {k: phase[k] for k in ("wall_ms", "kernel_ms", "idle_share", "groups_ms", "top")}


def moe_mixed_step(core, streams, long_prompt) -> dict:
    """One chunked mixed step on the MoE weights: a chunked engine (k = 1,
    a 512-block pool, not warmed up: its keys are captured at first use)
    decodes ``streams`` and takes the long prompt's first chunk; the
    mixed step its planner dispatches is captured, replayed and run as its
    eager body from the same cache copy (tokens equal, each timed)."""
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.core import EngineCore
    from dynamo_tpu_torch.engine.model import _moe_capacity

    ccore = EngineCore(core.cfg, EngineConfig(scheduling="chunked", megastep_k=1,
                                              num_kv_blocks=512), params=core.params,
                       device="cuda")
    res = chunked_graph_against_eager(ccore, streams, long_prompt, kinds=("mixed",),
                                      capture=True)["mixed"]
    T = res["key"][1]
    res["capacity"] = _moe_capacity(T, core.cfg)
    print(f"MoE chunked mixed step at T {T}: C {res['capacity']}", flush=True)
    del ccore
    gc.collect()
    torch.cuda.empty_cache()
    return res


def serve_moe(ra, card: str) -> dict:
    """Sparse MoE at Mixtral-8x7B width: ``MOE_LAYERS`` of its 32 layers
    (bf16 experts for 32 layers need 92.9 GB), random bf16
    weights from seed 0, the default ``EngineConfig``, through
    ``EngineCore`` and ``TorchEngine``. Memory; one layer's MoE MLP on the
    card against its f32 CPU version; ``warm_up()``; the MoE path (eight
    prompts of 128-2048 tokens, one 8192 wave, 64 greedy tokens each, the
    launch counts at 0 just before it): TTFT, prefill and decode ms beside
    their bounds, K1 at ``MOE_LAYERS`` launches per forward, every dispatch a graph
    replay; the megastep (width 8, k = 8) replayed against its eager body;
    the same traffic with every dispatch eager (tokens and
    log-probabilities equal); C per bucket; the device's idle share in decode; and one
    chunked mixed step."""
    from dynamo_tpu_torch.engine.config import EngineConfig, mixtral_8x7b
    from dynamo_tpu_torch.engine.core import EngineCore
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.engine.model import _moe_capacity
    from dynamo_tpu_torch.runtime.engine import Context

    t_phase = time.time()
    cfg = dataclasses.replace(mixtral_8x7b(), num_layers=MOE_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.time()
    core = EngineCore(cfg, EngineConfig(), seed=0, device="cuda")
    torch.cuda.synchronize()
    built_s = time.time() - t0
    kv_bytes = sum(c.numel() * c.element_size() for c in core.cache)
    mem = {"weights_and_kv_gb": (torch.cuda.memory_allocated() - base) / 1e9,
           "kv_gb": kv_bytes / 1e9, "build_peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    mem["weights_gb"] = mem["weights_and_kv_gb"] - mem["kv_gb"]
    torch.cuda.empty_cache()
    print(f"built {cfg.name} engine, {MOE_LAYERS} of 32 layers at full width (h {cfg.hidden_size}, "
          f"FFN {cfg.intermediate_size}, {cfg.num_experts} experts, top-{cfg.num_experts_per_tok}, "
          f"bf16, random weights from seed 0) in {built_s:.1f} s: weights "
          f"{mem['weights_gb']:.2f} GB, KV {mem['kv_gb']:.2f} GB "
          f"({core.engine.num_kv_blocks} x {core.engine.block_size}-token blocks), peak "
          f"{mem['build_peak_gb']:.2f} GB; {memory_line()}", flush=True)
    layer = moe_layer_check(core)
    warm = warm_up(core, "MoE")
    rng = np.random.default_rng(4321)
    reqs = [(f"moe{i}", [int(t) for t in rng.integers(0, cfg.vocab_size, n)], {"temperature": 0.0})
            for i, n in enumerate(MOE_PROMPT_LENS)]
    bounds = moe_bounds(core, MOE_PROMPT_LENS)

    # The MoE path, with every kernel launch count at 0 just before it.
    before = dict(core.scheduler_stats())
    ra.reset_launches()
    got = asyncio.run(timed_engine_batch(TorchEngine(core), Context, reqs))
    launches = launches_of(ra)
    st = core.scheduler_stats()
    d = {k: st[k] - before[k] for k in ("forwards", "dispatches", "graph_replays", "graph_captures",
                                         "prefill_s", "prefill_tokens", "decode_loop_s",
                                         "decode_iterations", "prefill_loop_s")}
    waves = st["single_step_dispatches"] - before["single_step_dispatches"]
    decode_ms = 1e3 * d["decode_loop_s"] / d["decode_iterations"]
    wave_ms = 1e3 * d["prefill_loop_s"] / max(waves, 1)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"MoE path on {card}: {len(reqs)} requests, prompts {MOE_PROMPT_LENS}; TTFT ms "
          + ", ".join(f"{r} {g['ttft_ms']:.1f}" for r, g in got.items())
          + f"; {waves} prefill wave(s) of {d['prefill_tokens']} tokens at {wave_ms:.1f} ms each "
          f"(bucket {bounds['prefill_bucket']}, C {bounds['prefill_capacity']}; operation bound "
          f"{bounds['prefill_needed_bound_ms']:.1f} ms for the tokens' k * n expert entries, "
          f"{bounds['prefill_bound_ms']:.1f} ms for every E * C capacity slot); decode {decode_ms:.3f} ms per iteration (engine "
          f"loop, {d['decode_iterations']} iterations; byte bound {bounds['decode_bound_ms']:.2f} "
          f"ms: {bounds['decode_weight_bytes'] / 1e9:.2f} GB of weights); K1 launches {launches} "
          f"for {d['forwards']} forwards; {d['graph_replays']} replays for {d['dispatches']} "
          f"dispatches, {d['graph_captures']} captures; peak allocated {peak_gb:.2f} GB",
          flush=True)
    if (any(len(g["tokens"]) != MAX_TOKENS for g in got.values()) or len(launches) != 2
            or sum(launches.values()) != MOE_LAYERS * d["forwards"]
            or d["graph_replays"] != d["dispatches"] or d["graph_captures"]):
        raise AssertionError(f"the MoE path failed its checks: {d}, launches {launches}")

    # Graph replays against eager bodies: the megastep alone, then the
    # traffic's streams (every dispatch eager, its log-probabilities read).
    sreqs, late, _ = serving_requests(cfg.vocab_size)
    megastep = graph_against_eager(core, sreqs + [late], "MoE")
    lp_wires = [wire(rid, prompt, sampling, logprobs=MM_LOGPROBS) for rid, prompt, sampling in reqs]
    core.clear_kv_cache()
    graphs = run_wires(core, lp_wires)
    core.clear_kv_cache()
    eager = run_wires(eager_dispatches(core), lp_wires)
    del core._launch
    streams = near_tie_streams("MoE, graphs against eager", graphs, eager, exact=True)
    idle = moe_idle_share(core, sreqs + [late])
    capacity = {f"{kind} {n}": _moe_capacity(n, cfg) for kind, ns in
                (("prefill", core.engine.prefill_buckets), ("decode", core.engine.decode_buckets))
                for n in ns}
    print(f"MoE capacity C per bucket (N -> C): {capacity}", flush=True)
    core._graphs = type(core._graphs)()  # the graph pool goes before the mixed step's
    gc.collect()
    torch.cuda.empty_cache()
    mixed = moe_mixed_step(core, [p for _, p, _ in reqs[:7]],
                           [int(t) for t in rng.integers(0, cfg.vocab_size, CHUNKED_LONG)])
    res = {"layers": MOE_LAYERS, "built_s": built_s, "memory": {**mem, "peak_gb": peak_gb},
           "layer_check": layer, "warm_up": warm, "bounds": bounds, "launches": launches,
           "forwards": d["forwards"], "ttft_ms": {r: g["ttft_ms"] for r, g in got.items()},
           "prefill_wave_ms": wave_ms, "decode_ms_per_iteration": decode_ms,
           "megastep": megastep, "streams": streams, "idle": idle, "capacity": capacity,
           "mixed_step": mixed, "phase_s": None}
    del core
    gc.collect()
    torch.cuda.empty_cache()
    res["phase_s"] = time.time() - t_phase
    print(f"MoE phase: {res['phase_s']:.1f} s", flush=True)
    return res


# -- KV tiers and the page programs (in process) --------------------------------

# The tier run: a 256-block device pool (8192 positions) with a 128-block
# host tier and a disk tier behind it, and 8 prompts of 2000 tokens (63
# blocks each, 504 in all) sent one at a time, then again: the repeats
# find their blocks on the host, on the disk or still on the card.
TIER_ENGINE = {"num_kv_blocks": 256, "host_kv_blocks": 128}
TIER_PROMPTS, TIER_PROMPT_LEN, TIER_TOKENS = 8, 2000, 8
PAGE_BLOCKS = (1, 8, 64)     # blocks per page-program call
PCIE_BYTES_PER_S = 64e9      # PCIe Gen5 x16, one direction


def one_request(core, rid: str, prompt: list[int], max_tokens: int) -> dict:
    """One greedy request through a synchronous engine, alone: its tokens,
    cached tokens and time to the step that emitted its first token."""
    from dynamo_tpu_torch.llm.protocols.common import PreprocessedRequest

    t0 = time.perf_counter()
    seq = core.add_request(PreprocessedRequest.from_wire(
        {**wire(rid, prompt, {"temperature": 0.0}), "stop": {"max_tokens": max_tokens}}))
    tokens, ttft = [], None
    while core.has_work():
        for s, out in core.step():
            tokens += out.token_ids
            if ttft is None and out.token_ids:
                ttft = 1e3 * (time.perf_counter() - t0)
    if len(tokens) != max_tokens:
        raise AssertionError(f"{rid}: {len(tokens)} tokens of {max_tokens}")
    return {"tokens": tokens, "ttft_ms": ttft, "cached_tokens": seq.num_cached_tokens}


def page_sha(core, block_hash: int) -> str:
    """sha256 of a cached block's page in the host layout (int8: packed)."""
    import hashlib

    from dynamo_tpu_torch.engine.kv_quant import pack_kv_page

    page = core._slice_page(core.allocator._by_hash[block_hash].block_id)
    if isinstance(page, dict):
        raw = pack_kv_page(np.asarray(page["kv"]), np.asarray(page["scale"])).tobytes()
    else:
        raw = np.asarray(page).tobytes()
    return hashlib.sha256(raw).hexdigest()


def serve_tiers(ra, card: str, core, preset="llama3-8b", device="cuda") -> dict:
    """The host and disk KV tiers at full width and depth, on the main path
    engine's weights: an engine with a small device pool, a host tier and a
    disk tier under a temp directory (:data:`TIER_ENGINE`), prompts that
    overflow the pool one at a time, then each again. The first block's
    page, read before it was evicted, must come back byte for byte, and
    every run must stream exactly what the main path engine streams for
    the same prompt: cold, and again with its prefix cached on the card (a
    repeat computes the prompt's last block over the cached prefix, which
    rounds bf16 otherwise than the cold prefill, so the reference of a
    repeat is a device-cache hit, and an onboarded page with a wrong byte
    would show). Two warm prompts first capture the graphs the timed runs
    use (a full prefill, a cached-prefix tail, the decode megasteps)."""
    from dynamo_tpu_torch.backends.torch.main import build_engine
    from dynamo_tpu_torch.tokens import compute_seq_hashes

    rng = np.random.default_rng(4321)
    vocab = core.cfg.vocab_size
    ids = lambda: [int(t) for t in rng.integers(0, vocab, TIER_PROMPT_LEN)]  # noqa: E731
    prompts = [ids() for _ in range(TIER_PROMPTS)]
    want = [[one_request(core, f"{kind}{i}", p, TIER_TOKENS)["tokens"] for kind in ("ref", "hit")]
            for i, p in enumerate(prompts)]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tiers_") as disk:
        tcore, _ = build_engine(preset, {**TIER_ENGINE, "disk_kv_dir": disk},
                                device=device, params=core.params)
        warm = ids()
        for rid in ("warm", "warm_again"):  # the second has its prefix cached
            one_request(tcore, rid, warm, TIER_TOKENS)
        st0 = tcore.scheduler_stats()
        ra.reset_launches()
        bs = tcore.engine.block_size
        h0 = compute_seq_hashes(prompts[0], bs)[0]
        cold, sha_before = [], None
        for i, p in enumerate(prompts):
            cold.append(one_request(tcore, f"cold{i}", p, TIER_TOKENS))
            if i == 0:
                sha_before = page_sha(tcore, h0)
        tcore.offload.flush()
        where = ("device" if tcore.allocator.is_cached(h0) else "host"
                 if h0 in tcore.host_pool else "disk" if h0 in tcore.disk_pool else "lost")
        after_cold = tcore.tier_stats()
        # The repeats newest first: the last prompts hit the card, the
        # ones before them the host tier, the first ones the disk (in
        # order, each repeat would evict the next one's blocks first).
        again, sha_after = [None] * len(prompts), None
        for i in reversed(range(len(prompts))):
            h = compute_seq_hashes(prompts[i], bs)[0]
            source = ("device" if tcore.allocator.is_cached(h) else "host"
                      if tcore.offload.contains(h) and h not in tcore.disk_pool else "disk")
            again[i] = {**one_request(tcore, f"again{i}", prompts[i], TIER_TOKENS),
                        "source": source}
            if i == 0:
                sha_after = page_sha(tcore, h0)
        tcore.offload.flush()
        stats = tcore.tier_stats()
        st = tcore.scheduler_stats()
        launches = {k: v for k, v in ra.kernel_launches.items() if v}
        forwards = st["forwards"] - st0["forwards"]
        tcore.offload.close()
        del tcore
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    for i, (c, a) in enumerate(zip(cold, again)):
        if [c["tokens"], a["tokens"]] != want[i]:
            raise AssertionError(f"tier prompt {i}: cold {c['tokens']}, repeat {a['tokens']}; "
                                 f"the main path engine's cold and cached runs {want[i]}")
    onboarded = sum(stats[t]["onboards"] for t in stats)
    if (min(stats[t]["offloads"] for t in ("host", "disk")) == 0 or not onboarded
            or sha_after != sha_before or where not in ("host", "disk")
            or min(a["cached_tokens"] for a in again) == 0):
        raise AssertionError(f"tiers: {stats}, block 0 was on {where}, page equal "
                             f"{sha_after == sha_before}, cached tokens "
                             f"{[a['cached_tokens'] for a in again]}")
    if device == "cuda" and (sum(launches.values()) != core.cfg.num_layers * forwards
                             or len(launches) != 2):
        raise AssertionError(f"tier run K1 launches {launches} for {forwards} forwards")
    out = {
        "engine": TIER_ENGINE, "prompts": TIER_PROMPTS, "prompt_tokens": TIER_PROMPT_LEN,
        "tiers_after_cold": after_cold, "tiers": stats, "block0_was_on": where,
        "block0_page_equal": sha_after == sha_before,
        "cold_ttft_ms": [c["ttft_ms"] for c in cold],
        "repeat_ttft_ms": [a["ttft_ms"] for a in again],
        "repeat_cached_tokens": [a["cached_tokens"] for a in again],
        "repeat_first_block_from": [a["source"] for a in again],
        "kernel_launches": launches, "forwards": forwards,
    }
    print(f"tiers on {card}: after the cold runs {after_cold}, block 0 on {where}; after the "
          f"repeats {stats}; block 0's onboarded page equal to the evicted one: "
          f"{out['block0_page_equal']}; TTFT ms cold {[round(t, 1) for t in out['cold_ttft_ms']]}"
          f", repeat {[round(t, 1) for t in out['repeat_ttft_ms']]} (cached tokens "
          f"{out['repeat_cached_tokens']}, first block from {out['repeat_first_block_from']}); "
          f"K1 launches {launches} = {core.cfg.num_layers} x "
          f"{forwards} forwards", flush=True)
    return out


def page_programs(core, mode: str) -> dict:
    """The page programs the tiers and transfers run, at n = 1, 8 and 64
    blocks, L2 flushed before each call: a gather of n pages into the
    layer-major wire layout, a scatter of them into other blocks, a direct
    block-to-block copy, the eviction's one-page slice with its copy to
    pinned memory, the copy of n gathered pages to pinned memory (D2H), and
    pinned pages to the card (H2D) and pageable ones (staged through pinned
    memory, as an import stages them). Each against its byte bound: the
    device programs read and write every byte once (2 n pages over
    3.35 TB/s), the host hops move n pages over 64 GB/s. The cache's
    prefix blocks are dropped first, so the pages written hold no cached
    block."""
    from dynamo_tpu_torch.engine.core import _Landing

    core.clear_kv_cache()
    pb = core.kv_cache_stats()["bytes_per_block"]
    rows = []
    for n in PAGE_BLOCKS:
        src, dst = list(range(n)), list(range(n, 2 * n))
        dev = core._gather_pages(src)
        leaves = dev if isinstance(dev, dict) else {"kv": dev}  # int8: kv and scale
        pinned = [torch.empty(v.shape, dtype=v.dtype, pin_memory=core.device.type == "cuda")
                  .copy_(v) for v in leaves.values()]
        pageable = {k: v.cpu() for k, v in leaves.items()}
        if not isinstance(dev, dict):
            pageable = pageable["kv"]
        timed = {
            "gather": lambda: core._gather_pages(src),
            "scatter": lambda: core._scatter_pages(dst, dev),
            "copy": lambda: core._copy_pages_from(core, src, dst),
            "slice_d2h": (lambda: core._slice_page(0)) if n == 1 else None,
            "d2h": lambda: [_Landing(v) for v in leaves.values()],
            "h2d": lambda: [v.to(core.device, non_blocking=True) for v in pinned],
            "staged_h2d": lambda: core._scatter_pages(dst, pageable),
        }
        row = {"mode": mode, "blocks": n, "bytes": n * pb}
        for name, fn in timed.items():
            if fn is None:
                continue
            ms = cold_ms(fn, 10)
            host_hop = name in ("slice_d2h", "d2h", "h2d", "staged_h2d")
            bound = 1e3 * (n * pb / PCIE_BYTES_PER_S if host_hop else 2 * n * pb / HBM_BYTES_PER_S)
            row[f"{name}_ms"], row[f"{name}_bound_ms"] = ms, bound
        # The scatters wrote the gathered pages: a gather of dst reads them back.
        back = core._gather_pages(dst)
        back = back if isinstance(back, dict) else {"kv": back}
        if (not all(torch.equal(back[k], v) for k, v in leaves.items())
                or leaves["kv"].shape[:2] != (n, core.cfg.num_layers)):
            raise AssertionError(f"page programs ({mode}, n = {n}): scatter-then-gather "
                                 f"differs, or the gather's layout is "
                                 f"{tuple(leaves['kv'].shape)}")
        rows.append(row)
        print(f"page programs ({mode}, {n} blocks of {pb} bytes): " + ", ".join(
            f"{k[:-3]} {v:.4f} ms (bound {row[k[:-3] + '_bound_ms']:.4f})"
            for k, v in row.items() if k.endswith("_ms") and not k.endswith("bound_ms")),
            flush=True)
    return {"bytes_per_block": pb, "rows": rows}


# -- chunked scheduling ---------------------------------------------------------

# The chunked phase's traffic: 7 streams decoding (greedy, these prompt
# lengths), then a long prompt arriving; the long prompt's chunks ride next
# to the streams' decode rows.
CHUNKED_STREAM_LENS = (100, 250, 400, 550, 700, 850, 1000)
CHUNKED_STREAM_TOKENS = 160  # enough to decode past the long prompt's last chunk
CHUNKED_LONG = 2124
# The chunked engine serves this phase's 8 lanes (7 streams and the long
# prompt) at one decode width, as the speculating engine does: its warm-up
# captures the keys of width 8 only (120 graphs, not the 480 of the
# default widths); profile_serving.py --scheduling chunked warms up an
# engine of the default widths.
CHUNKED_ENGINE = {"scheduling": "chunked", "decode_buckets": (8,), "max_num_seqs": 8}


def chunked_prompts(vocab: int) -> tuple[list[list[int]], list[int]]:
    rng = np.random.default_rng(4321)
    ids = lambda n: [int(t) for t in rng.integers(0, vocab, n)]  # noqa: E731
    return [ids(n) for n in CHUNKED_STREAM_LENS], ids(CHUNKED_LONG)


def check_mixed_shapes(ra) -> list[dict]:
    """K1 at the mixed steps the chunked planners dispatch for this phase's
    traffic, the 7 streams' decode rows first and the long prompt's first
    chunk last, as ``_plan_mixed`` orders them (S 8, pages_per_seq 256):
    T 8192 with a 2048-token chunk (the default token budget) and T 2048
    with a 512-token chunk (``max_num_batched_tokens`` 2048). Both kernels,
    forced, against the plain version run in row chunks, L2 flushed: the
    tiled kernel is the one the engine's forward asks for, the decode
    kernel the one the shapes alone would pick at T == S."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    ctx = [n + 48 for n in CHUNKED_STREAM_LENS]
    out = []
    for name, chunk, T in (("mixed8192_chunk2048", 2048, 8192), ("mixed2048_chunk512", 512, 2048)):
        q_lens, kv_lens = [1] * 7 + [chunk], ctx + [chunk]
        args, kw = attention_batch(q_lens, kv_lens, 8, 256, T, gen)
        plain = lambda: plain_by_row_chunks(ra, args, kw, q_lens)  # noqa: E731
        want = plain()
        plain_ms = cold_ms(plain, 1)
        out += hold_k1(ra, name, args, kw, want, q_lens, kv_lens, T, False, 10, plain_ms,
                       "attention")
        del args, kw, want
        torch.cuda.empty_cache()
    return out


def ragged_ops(rows, T, S, eng, dev) -> tuple:
    """``model.forward_tokens``' operands for ``rows`` of (tokens, first
    position, page ids), packed as ``EngineCore._assemble_ragged`` packs a
    mixed step: tokens padded to T, table rows to S, padded slots on the
    garbage block."""
    bs, g = eng.block_size, eng.garbage_block
    tokens, positions = np.zeros(T, np.int32), np.zeros(T, np.int32)
    write_pages, write_offs = np.full(T, g, np.int32), np.zeros(T, np.int32)
    kv_lens, tables = np.zeros(S, np.int32), np.full((S, eng.max_blocks_per_seq), g, np.int32)
    cu, last = np.zeros(S + 1, np.int32), np.zeros(S, np.int32)
    t = 0
    for i, (toks, p0, pages) in enumerate(rows):
        n = len(toks)
        pos = np.arange(p0, p0 + n)
        tokens[t : t + n], positions[t : t + n] = toks, pos
        write_pages[t : t + n] = np.asarray(pages)[pos // bs]
        write_offs[t : t + n] = pos % bs
        kv_lens[i], tables[i, : len(pages)] = p0 + n, pages
        t += n
        cu[i + 1], last[i] = t, t - 1
    cu[len(rows) + 1 :] = t
    arrays = (tokens, positions, write_pages, write_offs, kv_lens, tables, cu,
              np.array([len(rows)], np.int32), last)
    return tuple(torch.from_numpy(a).to(dev) for a in arrays)


def scratch_cache(core, eng, seed: int):
    """A cache of ``eng``'s shape for ``core``'s model, every page random
    (bf16 normal), the same for the same seed."""
    from dynamo_tpu_torch.engine import model

    cache = model.init_cache(core.cfg, eng, core.device)
    gen = torch.Generator(device=core.device).manual_seed(seed)
    for c in cache:
        c.normal_(generator=gen)
    return cache


def page_runs(lens, bs: int, first: int = 0) -> list[list[int]]:
    """Consecutive page ids for sequences of these lengths."""
    out, nxt = [], first
    for n in lens:
        k = -(-n // bs)
        out.append(list(range(nxt, nxt + k)))
        nxt += k
    return out


def check_t_equal_s_forward(ra, core) -> dict:
    """A mixed batch at T == S == 64 through the engine's own forward
    (``model.forward_tokens`` on ``core``'s weights, a scratch cache of
    random pages): a 37-token chunk next to 27 decode rows, as a mixed
    step runs where a prefill bucket equals a decode width. Every layer's
    attention, in the form the forward states (tiled), is held against the
    plain version on the same inputs; on layer 0's inputs the decode
    kernel, which the shapes alone would pick, is held too, and both are
    timed with the L2 flushed."""
    from dynamo_tpu_torch.engine import model
    from dynamo_tpu_torch.engine.config import EngineConfig

    eng = EngineConfig(num_kv_blocks=1024, max_model_len=1024)
    rng = np.random.default_rng(5)
    ctx = [int(x) for x in rng.integers(2, 1000, 27)]
    pages = page_runs([37] + ctx, eng.block_size)
    rows = [([int(t) for t in rng.integers(0, core.cfg.vocab_size, 37)], 0, pages[0])]
    rows += [([int(rng.integers(0, core.cfg.vocab_size))], n - 1, pg)
             for n, pg in zip(ctx, pages[1:])]
    ops = ragged_ops(rows, 64, 64, eng, core.device)
    cache = scratch_cache(core, eng, 5)
    held, layer0 = [], {}

    def attention(q, kv, lens, tables, cu, ns, *, sm_scale, kv_scales=None, kernel):
        got = ra.ragged_paged_attention(q, kv, lens, tables, cu, ns, sm_scale=sm_scale,
                                        kernel=kernel)
        want = ra.ragged_paged_attention_ref(q, kv, lens, tables, cu, ns, sm_scale=sm_scale)
        held.append((kernel, *compare(got, want, 64)))
        if not layer0:
            layer0.update(args=(q.clone(), kv.clone(), lens, tables, cu, ns), want=want)
        return got

    tiled = ra.ENTRY_NAMES["tiled", False]
    before = ra.kernel_launches[tiled]
    logits = model.forward_tokens(core.params, cache, *ops, core.cfg, attention=attention)
    launched = ra.kernel_launches[tiled] - before
    args = layer0["args"]
    scale = core.cfg.head_dim ** -0.5
    dec = ra.ragged_paged_attention_cuda(*args, sm_scale=scale, kernel="decode")
    dec_rel, _, dec_ok = compare(dec, layer0["want"], 64)
    ms = {k: cold_ms(lambda k=k: ra.ragged_paged_attention_cuda(*args, sm_scale=scale, kernel=k), 20)
          for k in K1_KERNELS}
    worst = max(h[1] for h in held)
    res = {"layers": len(held), "forms": sorted({h[0] for h in held}), "max_row_rel_err": worst,
           "tiled_launches": launched, "decode_kernel_row_rel_err": dec_rel,
           "tiled_ms": ms["tiled"], "decode_kernel_ms": ms["decode"]}
    print(f"T == S mixed forward (64 rows: a 37-token chunk + 27 decode rows, S 64): "
          f"{len(held)} layers asked for {res['forms']}, {launched} tiled launches, largest row "
          f"relative error against the plain version {worst:.3e}; on layer 0's inputs the decode "
          f"kernel {dec_rel:.3e} in {ms['decode']:.4f} ms, the tiled kernel {ms['tiled']:.4f} ms "
          f"(L2 flushed)", flush=True)
    if (not all(h[3] for h in held) or res["forms"] != ["tiled"] or launched != core.cfg.num_layers
            or not dec_ok or not bool(torch.isfinite(logits).all())):
        raise AssertionError(f"T == S mixed forward: {res}")
    return res


def chunked_prefill_logits(core) -> dict:
    """A 1100-token prompt prefilled in chunks of 512, 512 and 76 tokens,
    each forward with 7 decode rows beside it (a mixed step's packing,
    through ``model.forward_tokens`` on ``core``'s weights and a scratch
    cache), against the same prompt prefilled in one forward: the last
    position's logits point the same way (``check_logits``' cosine)."""
    from dynamo_tpu_torch.engine import model
    from dynamo_tpu_torch.engine.config import EngineConfig

    eng = EngineConfig(num_kv_blocks=512, max_model_len=2048)
    rng = np.random.default_rng(6)
    vocab = core.cfg.vocab_size
    prompt = [int(t) for t in rng.integers(0, vocab, 1100)]
    ctx = [n + 48 for n in CHUNKED_STREAM_LENS]
    pages = page_runs([len(prompt)] + [n + 8 for n in ctx], eng.block_size)

    def last_logits(chunks):
        cache = scratch_cache(core, eng, 6)
        out, p0 = None, 0
        for step, n in enumerate(chunks):
            rows = [([int(rng.integers(0, vocab))], c - 1 + step, pg)
                    for c, pg in zip(ctx, pages[1:])] if len(chunks) > 1 else []
            rows.append((prompt[p0 : p0 + n], p0, pages[0]))
            total = sum(len(r[0]) for r in rows)
            T = next(b for b in core.engine.prefill_buckets if b >= total)
            out = model.forward_tokens(core.params, cache, *ragged_ops(rows, T, 8, eng, core.device),
                                       core.cfg)[len(rows) - 1]
            p0 += n
        return out

    one = last_logits([len(prompt)])
    chunked = last_logits([512, 512, 76])
    cos = torch.nn.functional.cosine_similarity(one, chunked, dim=0).item()
    res = {"cosine": cos, "max_abs_diff": (one - chunked).abs().max().item(),
           "finite": bool(torch.isfinite(chunked).all().item())}
    print(f"chunked prefill (512 + 512 + 76 tokens, 7 decode rows beside each chunk) against one "
          f"wave: last-position logits cosine {cos:.6f}, max abs diff {res['max_abs_diff']:.4e}",
          flush=True)
    if not res["finite"] or cos < LOGITS_MIN_COSINE:
        raise AssertionError(f"chunked prefill logits disagree with the one-wave logits: {res}")
    return res


def chunked_graph_against_eager(core, streams, long_prompt, kinds=("mixed", "fused"),
                                capture=False) -> dict:
    """One mixed step and one fused megastep (``kinds``) from the same
    cache copy: the chunked planners' own launches (``_plan_mixed`` and
    ``_plan_fused`` stopped at their dispatch) with the 7 streams decoding
    and the long prompt's first chunk, T 8192 at width 8, each replayed
    from the graph ``warm_up()`` captured (or, with ``capture``, captured
    here) and run as its eager body. Tokens must be equal; each is timed
    on the host's wall clock, sync to sync."""
    from dynamo_tpu_torch.llm.protocols.common import PreprocessedRequest

    greedy = {"temperature": 0.0}
    for i, p in enumerate(streams):
        core.add_request(PreprocessedRequest.from_wire(wire(f"ge_s{i}", p, greedy)))
    for _ in range(32):
        core.step()
        if len(core._decode_candidates()) == len(streams) and core._inflight is None:
            break
    else:
        raise AssertionError("the streams did not reach decode")
    long_seq = core.add_request(PreprocessedRequest.from_wire(wire("ge_long", long_prompt, greedy)))
    core._admit()
    launches = {}

    class Stop(Exception):
        pass

    def grab(launch, feed=None):
        launches[launch.key[0]] = launch
        raise Stop

    core._launch = grab
    try:
        for kind in kinds:
            try:
                {"mixed": core._plan_mixed, "fused": core._plan_fused}[kind]([long_seq])
            except Stop:
                pass
    finally:
        del core._launch
    saved = [c.clone() for c in core.cache]

    def restore():
        for c, s in zip(core.cache, saved):
            c.copy_(s)

    res = {}
    for kind in kinds:
        launch = launches[kind]
        if capture and launch.key not in core._graphs:
            core._graphs.capture(launch, core.device)
        if launch.key not in core._graphs:
            raise AssertionError(f"warm_up() did not capture {launch.key}")

        def timed(run, reps):
            walls, out = [], None
            for _ in range(reps):
                restore()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = run()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            return out, walls

        eager, eager_ms = timed(lambda: launch.body(torch.from_numpy(launch.packed).cuda()), 3)
        graph, graph_ms = timed(lambda: core._graphs.replay(launch), 5)
        same = torch.equal(eager[0], graph[0])
        res[kind] = {"key": list(launch.key), "tokens_equal": same,
                     "eager_ms": float(np.median(eager_ms)), "graph_ms": float(np.median(graph_ms))}
        print(f"chunked {kind} step {launch.key} graph against eager body: tokens equal={same}; "
              f"ms, median: eager {res[kind]['eager_ms']:.2f} graph {res[kind]['graph_ms']:.2f}",
              flush=True)
        if not same:
            raise AssertionError(f"the replayed {kind} step's tokens differ from the eager body's")
    restore()
    del saved
    for seq in list(core.running) + list(core.waiting):
        core.cancel_request(seq)
    while core.has_work():
        core.step()
    return res


async def streams_then_long(engine, Context, streams, long_prompt, on_long) -> dict:
    """The 7 streams sent at once; when each has its first token, the long
    prompt (``on_long()`` is called just before it is sent). Returns each
    request's send time and token arrival times (``perf_counter``; the
    tokens of one chunk arrive together), the long prompt's send time and
    what ``on_long`` returned."""
    arrivals: dict[str, tuple[float, list[float]]] = {}
    greedy = {"temperature": 0.0}

    async def one(rid, prompt, max_tokens):
        req = wire(rid, prompt, greedy)
        req["stop"] = {"max_tokens": max_tokens}
        t0, ts = time.perf_counter(), []
        arrivals[rid] = (t0, ts)
        async for out in engine.generate(req, Context(rid)):
            ts += [time.perf_counter()] * len(out["token_ids"])

    tasks = [asyncio.create_task(one(f"s{i}", p, CHUNKED_STREAM_TOKENS))
             for i, p in enumerate(streams)]
    while not all(len(arrivals.get(f"s{i}", (0, []))[1]) for i in range(len(streams))):
        await asyncio.sleep(0.002)
    at_long = on_long()
    t_long = time.perf_counter()
    await asyncio.wait_for(asyncio.gather(*tasks, one("long", long_prompt, 8)), timeout=600)
    return {"arrivals": arrivals, "t_long": t_long, "at_long": at_long}


def chunked_traffic(ra, core, name: str, streams, long_prompt) -> dict:
    """This phase's traffic through ``core`` (a fresh facade, its prefix
    cache cleared), with every launch count at 0 just before it: the
    streams' largest and p99 gap between tokens from the long prompt's
    arrival on, the long prompt's time to first token, the real-token
    share of the mixed steps' token buckets, K1's launches against layers x
    forwards, and no graph captured."""
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.runtime.engine import Context

    core.clear_kv_cache()
    before = dict(core.scheduler_stats())
    ra.reset_launches()
    mixed_keys = ("mixed_tokens", "mixed_bucket_tokens")
    got = asyncio.run(streams_then_long(
        TorchEngine(core), Context, streams, long_prompt,
        lambda: {k: core.exec_stats[k] for k in mixed_keys}))
    by_entry = {ra.ENTRY_NAMES[k, False]: ra.kernel_launches[ra.ENTRY_NAMES[k, False]]
                for k in K1_KERNELS}
    launches = ra.launches
    st = core.scheduler_stats()
    d = {k: st[k] - before[k] for k in ("forwards", "dispatches", "graph_replays", "graph_captures",
                                        "mixed_steps", "mixed_tokens", "mixed_bucket_tokens",
                                        "megastep_dispatches", "fused_mixed_dispatches")}
    t_long, arrivals = got["t_long"], got["arrivals"]
    gaps = []
    for rid, (_, ts) in arrivals.items():
        if rid != "long":
            gaps += [1e3 * (b - a) for a, b in zip(ts, ts[1:]) if b >= t_long]
    t0_long, ts_long = arrivals["long"]
    # The mixed steps from the long prompt's arrival on: its chunks (the
    # streams only decode by then).
    real, bucket = (st[k] - got["at_long"][k] for k in mixed_keys)
    res = {
        "setting": name, "async_exec": bool(core.engine.async_exec),
        "max_gap_ms": max(gaps), "p99_gap_ms": float(np.percentile(gaps, 99)),
        "long_ttft_ms": 1e3 * (ts_long[0] - t0_long),
        "real_token_share": (d["mixed_tokens"] / d["mixed_bucket_tokens"]
                             if d["mixed_bucket_tokens"] else None),
        "long_prompt_real_token_share": real / bucket if bucket else None,
        "long_prompt_mixed_tokens": [real, bucket],
        "attention_launches": launches, "launches_by_kernel": by_entry, **d,
    }
    share = "n/a (no mixed step)" if res["real_token_share"] is None else (
        f"{res['real_token_share']:.4f} ({d['mixed_tokens']} of {d['mixed_bucket_tokens']}; "
        f"the long prompt's steps {res['long_prompt_real_token_share']:.4f}, {real} of {bucket})")
    print(f"traffic {name} ({'async' if res['async_exec'] else 'sync'}): 7 streams' gap between "
          f"tokens after the {CHUNKED_LONG}-token prompt arrived: largest {res['max_gap_ms']:.1f} ms, "
          f"p99 {res['p99_gap_ms']:.1f} ms; long prompt TTFT {res['long_ttft_ms']:.1f} ms; mixed "
          f"steps {d['mixed_steps']} (fused {d['fused_mixed_dispatches']}), real-token share of "
          f"their T {share}; forwards {d['forwards']}, attention launches {launches} by kernel "
          f"{by_entry}; dispatches {d['dispatches']}, replays {d['graph_replays']}, captures "
          f"{d['graph_captures']}", flush=True)
    if (launches != core.cfg.num_layers * d["forwards"] or min(by_entry.values()) == 0
            or d["graph_captures"] or d["graph_replays"] != d["dispatches"]
            or len(arrivals["long"][1]) != 8
            or any(len(ts) != CHUNKED_STREAM_TOKENS for r, (_, ts) in arrivals.items()
                   if r != "long")):
        raise AssertionError(f"traffic {name}: {res}")
    if name != "waves" and not d["mixed_steps"]:
        raise AssertionError(f"traffic {name}: no mixed step ran")
    return res


def serve_chunked(ra, card: str, core) -> dict:
    """The chunked phase, bf16, llama3-8b at full width and depth, on the
    main path engine's weights: a chunked engine's (``CHUNKED_ENGINE``,
    width 8) ``warm_up()`` (keys,
    capture seconds, memory); K1 at the dispatched mixed shapes; a T == S
    mixed batch through the forward; the mixed and fused replays against
    their eager bodies; chunked-prefill logits against one wave; then the
    traffic (7 streams decoding, then the long prompt) under waves (the
    main path's engine), chunked at the defaults (sync, then async), and
    chunked with ``max_num_batched_tokens`` 2048. The last two run on the
    same warm chunked engine with its configuration switched: the planners
    read ``async_exec`` and the token budget at every step, and every graph
    key a 2048-token budget can dispatch is one the default engine's
    warm-up captured (checked), so no setting captures while serving."""
    from dynamo_tpu_torch.backends.torch.main import build_engine

    streams, long_prompt = chunked_prompts(core.cfg.vocab_size)
    res = {"shapes": check_mixed_shapes(ra)}
    ccore, _ = build_engine("llama3-8b", CHUNKED_ENGINE, device="cuda", params=core.params)
    keys = [launch.key[0] for launch, _ in ccore._warm_up_launches()]
    res["warm_up"] = {**warm_up(ccore, "chunked"),
                      "keys": {k: keys.count(k) for k in sorted(set(keys))}}
    print(f"chunked warm-up keys: {res['warm_up']['keys']}", flush=True)
    res["t_equal_s"] = check_t_equal_s_forward(ra, ccore)
    res["graph_against_eager"] = chunked_graph_against_eager(ccore, streams, long_prompt)
    res["prefill_logits"] = chunked_prefill_logits(ccore)
    traffic = [chunked_traffic(ra, core, "waves", streams, long_prompt),
               chunked_traffic(ra, ccore, "chunked", streams, long_prompt)]
    ccore.engine = dataclasses.replace(ccore.engine, async_exec=True)
    traffic.append(chunked_traffic(ra, ccore, "chunked", streams, long_prompt))
    ccore.engine = dataclasses.replace(ccore.engine, async_exec=False,
                                       max_num_batched_tokens=2048)
    keys = {launch.key for launch, _ in ccore._warm_up_launches()}
    if any(key not in ccore._graphs for key in keys):
        raise AssertionError("a 2048-token budget reaches keys the warm-up did not capture")
    res["budget2048_keys"] = len(keys)
    print(f"chunked, budget 2048: all {len(keys)} keys it can dispatch were captured by the "
          f"default engine's warm-up (chunk {ccore.engine.chunk_size})", flush=True)
    traffic.append(chunked_traffic(ra, ccore, "chunked_budget2048", streams, long_prompt))
    del ccore
    gc.collect()
    torch.cuda.empty_cache()
    res["traffic"] = traffic
    print(f"chunked phase on {card}: " + "; ".join(
        f"{t['setting']}{' async' if t['async_exec'] else ''} largest gap {t['max_gap_ms']:.1f} ms "
        f"p99 {t['p99_gap_ms']:.1f} TTFT {t['long_ttft_ms']:.1f}" for t in traffic), flush=True)
    return res


# -- speculative decoding ------------------------------------------------------

# The speculation phase's traffic: 8 prompts, each a random segment quoted
# several times (as extraction and code-edit traffic quote their input),
# so the prompt-lookup drafter finds matches; 6 greedy lanes and 2 seeded.
SPEC_K = 4
SPEC_TOKENS = 96
SPEC_SEGMENTS = ((48, 6), (56, 5), (64, 4), (72, 4), (80, 3), (96, 3), (120, 2), (160, 2))
SPEC_SEEDED = {6: {"temperature": 0.7, "seed": 31}, 7: {"temperature": 0.9, "seed": 32}}
SPEC_LONG = 2124  # the chunked runs' last lane: a prompt of two chunks at the default budget
# The smoke's speculating engine serves these 8 lanes at one decode width
# (its warm-up captures the keys of width 8 only); profile_serving.py
# --spec-decode ngram warms up an engine of the default widths.
SPEC_ENGINE = {"spec_decode": "ngram", "spec_k": SPEC_K, "spec_device_draft": True,
               "decode_buckets": (8,), "max_num_seqs": 8}


def spec_prompts(vocab: int) -> list[list[int]]:
    rng = np.random.default_rng(777)
    out = []
    for n, reps in SPEC_SEGMENTS:
        seg = [int(t) for t in rng.integers(0, vocab, n)]
        out.append(seg * reps)
    return out


def check_verify_shapes(ra, spec_ctx) -> list[dict]:
    """K1 at the verify rows' shapes, both kernels forced, against the plain
    version run in row chunks, L2 flushed: S rows of q_len spec_k + 1 = 5
    at T = S * 5 (a drafting megastep's verify iteration, ``verify_tokens``,
    which is unpadded), S 8 and 64 with kv lengths up to 2048, and the
    speculation phase's own lanes halfway through their streams."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    rng = np.random.default_rng(9)
    R = SPEC_K + 1
    cases = [("verify8", [int(x) for x in rng.integers(R, 2049, 8)]),
             ("verify64", [int(x) for x in rng.integers(R, 2049, 64)]),
             ("verify_spec_phase8", [n + SPEC_TOKENS // 2 for n in spec_ctx])]
    out = []
    for name, kv_lens in cases:
        S = len(kv_lens)
        q_lens = [R] * S
        args, kw = attention_batch(q_lens, kv_lens, S, 256, S * R, gen)
        plain = lambda: plain_by_row_chunks(ra, args, kw, q_lens)  # noqa: E731
        want = plain()
        plain_ms = cold_ms(plain, 1)
        out += hold_k1(ra, name, args, kw, want, q_lens, kv_lens, S * R, False, 20, plain_ms,
                       "attention")
        del args, kw, want
        torch.cuda.empty_cache()
    by_shape = {}
    for rec in out:
        by_shape.setdefault(rec["shape"], {})[rec["kernel"]] = rec["ms"]
    for shape, ms in by_shape.items():
        print(f"verify shape {shape}: tiled {ms['tiled']:.4f} ms, decode {ms['decode']:.4f} ms; "
              f"faster: {min(ms, key=ms.get)}", flush=True)
    return out


def verify_logits(core, prompts) -> dict:
    """Verify-forward logits against one-token-forward logits at the same
    positions: each prompt but its last spec_k + 1 tokens prefilled in one
    wave (a scratch cache, ``core``'s weights), then those tokens once as
    five one-token forwards (``decode_tokens``) and once as one verify
    row each (``verify_tokens``, every slot live), in each of K1's forms.
    Each position's logits must point the same way (``check_logits``'
    cosine); the largest logit difference is the near-tie limit of the
    stream comparison."""
    from dynamo_tpu_torch.engine import model
    from dynamo_tpu_torch.engine.config import EngineConfig

    eng = EngineConfig(num_kv_blocks=512, max_model_len=2048)
    R, S, dev = SPEC_K + 1, len(prompts), core.device
    lens = [len(p) for p in prompts]
    pages = page_runs(lens, eng.block_size)
    rows = [(p[: n - R], 0, pg) for p, n, pg in zip(prompts, lens, pages)]
    T = next(b for b in core.engine.prefill_buckets if b >= sum(n - R for n in lens))
    cache = model.init_cache(core.cfg, eng, dev)
    model.forward_tokens(core.params, cache, *ragged_ops(rows, T, S, eng, dev), core.cfg)
    saved = [c.clone() for c in cache]
    tables = torch.full((S, eng.max_blocks_per_seq), eng.garbage_block, dtype=torch.int32,
                        device=dev)
    for i, pg in enumerate(pages):
        tables[i, : len(pg)] = torch.tensor(pg, dtype=torch.int32)
    last = torch.tensor([p[n - R :] for p, n in zip(prompts, lens)], dtype=torch.int32, device=dev)
    pos0 = torch.tensor([n - R for n in lens], dtype=torch.int32, device=dev)
    active = torch.ones(S, dtype=torch.bool, device=dev)
    one = torch.stack([
        model.decode_tokens(core.params, cache, last[:, j].contiguous(), tables, pos0 + j,
                            active, core.cfg, eng)
        for j in range(R)
    ], dim=1).reshape(S * R, -1)
    res = {}
    for kernel in K1_KERNELS:
        for c, s in zip(cache, saved):
            c.copy_(s)
        ver = model.verify_tokens(core.params, cache, last, tables, pos0,
                                  torch.full((S,), R - 1, dtype=torch.int32, device=dev),
                                  active, core.cfg, eng, kernel=kernel)
        cos = torch.nn.functional.cosine_similarity(ver, one, dim=1)
        res[kernel] = {
            "min_cosine": cos.min().item(), "max_abs_diff": (ver - one).abs().max().item(),
            "argmax_equal": int((ver.argmax(1) == one.argmax(1)).sum().item()),
            "finite": bool(torch.isfinite(ver).all().item()),
        }
        r = res[kernel]
        print(f"verify logits ({kernel} form, {S} rows of {R}) against one-token forwards at the "
              f"same positions: min cosine {r['min_cosine']:.6f}, max abs diff "
              f"{r['max_abs_diff']:.4e}, argmax equal at {r['argmax_equal']} of {S * R}",
              flush=True)
        if not r["finite"] or r["min_cosine"] < LOGITS_MIN_COSINE:
            raise AssertionError(f"verify-forward logits disagree with one-token forwards: {res}")
    del cache, saved
    torch.cuda.empty_cache()
    res["near_tie_limit"] = max(r["max_abs_diff"] for r in res.values())
    return res


def ring_copy(core) -> dict:
    """The drafting megastep's history rings in its packed input: their
    bytes at widths 8 and 64 (``window + ngram_max`` int32 per lane), and
    the host-to-device copy of that many pinned bytes, CUDA events over 50
    back-to-back copies, beside the copy of the rest of a width-8 drafting
    graph's input."""
    from dynamo_tpu_torch.engine.core import _drafted_layout

    H, R = core._ring_H, SPEC_K + 1
    res = {"ring_slots": H}
    for S in (8, 64):
        packed = _drafted_layout(128, S, core.engine.max_blocks_per_seq, R, H).size * 4
        ring = S * (H + 8) * 4  # hist, ring_feed and the five per-lane knobs
        for what, n in (("ring", ring), ("rest", packed - ring)):
            host = torch.zeros(n // 4, dtype=torch.int32).pin_memory()
            dev = torch.empty(n // 4, dtype=torch.int32, device="cuda")
            res[f"{what}{S}_bytes"] = n
            res[f"{what}{S}_copy_ms"] = cuda_ms(lambda: dev.copy_(host, non_blocking=True), 50)
    print(f"history rings in the drafting graph's input: {H} slots per lane; width 8: "
          f"{res['ring8_bytes']} B copied in {res['ring8_copy_ms']:.4f} ms (the rest of the input "
          f"{res['rest8_bytes']} B, {res['rest8_copy_ms']:.4f} ms); width 64: {res['ring64_bytes']} "
          f"B in {res['ring64_copy_ms']:.4f} ms", flush=True)
    return res


def spec_wire(i, rid, prompt, spec, logprobs=None):
    req = wire(rid, prompt, SPEC_SEEDED.get(i, {"temperature": 0.0}), logprobs)
    req["stop"] = {"max_tokens": SPEC_TOKENS}
    if spec is not None:
        req["spec_decode"] = spec
    return req


async def spec_batch(engine, Context, prompts, name, spec, logprobs=None) -> dict:
    async def one(i, prompt):
        rid = f"{name}_{i}"
        toks, lps, fin = [], [], None
        async for out in engine.generate(spec_wire(i, rid, prompt, spec, logprobs), Context(rid)):
            toks += out["token_ids"]
            lps += out.get("logprobs") or []
            fin = out.get("finish_reason") or fin
        return i, toks, lps, fin

    done = await asyncio.wait_for(asyncio.gather(*(one(i, p) for i, p in enumerate(prompts))),
                                  timeout=600)
    return {i: (toks, lps, fin) for i, toks, lps, fin in done}


def spec_traffic(ra, core, name: str, prompts, spec, logprobs=None) -> dict:
    """The phase's 8 prompts at once through ``core`` (prefix cache
    cleared), every launch count at 0 just before: decode ms per emitted
    token (the engine loop's time in decode, verify and drafting steps,
    and under chunked scheduling in mixed steps, chunks included, over
    the tokens after each first), dispatches per emitted token, the
    speculation counters of this run, the ``spec_draft`` span's host ms
    per drafting step, K1's launches against 32 x forwards, and no graph
    captured."""
    from dynamo_tpu_torch import tracing
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.runtime.engine import Context

    core.clear_kv_cache()
    keys = ("dispatches", "committed_tokens", "forwards", "graph_replays", "graph_captures",
            "decode_loop_s", "spec_loop_s", "mixed_loop_s", "megastep_dispatches",
            "single_step_dispatches", "fused_mixed_dispatches")
    before, sbefore = dict(core.scheduler_stats()), core.spec_decode_stats()
    totals0 = tracing.get_collector().phase_totals().get("engine/spec_draft", (0.0, 0.0))
    ra.reset_launches()
    t0 = time.perf_counter()
    got = asyncio.run(spec_batch(TorchEngine(core), Context, prompts, name, spec, logprobs))
    wall = time.perf_counter() - t0
    by_entry = {ra.ENTRY_NAMES[k, False]: ra.kernel_launches[ra.ENTRY_NAMES[k, False]]
                for k in K1_KERNELS}
    st, sst = core.scheduler_stats(), core.spec_decode_stats()
    totals1 = tracing.get_collector().phase_totals().get("engine/spec_draft", (0.0, 0.0))
    d = {k: st[k] - before[k] for k in keys}
    sd = {k: sst[k] - sbefore[k] for k in ("verify_steps", "verify_rows", "drafted_tokens",
                                           "accepted_tokens", "emitted_tokens", "device_rounds",
                                           "device_hits")}
    after_first = d["committed_tokens"] - len(prompts)
    draft_steps = totals1[0] - totals0[0]
    res = {
        "run": name, "async_exec": bool(core.engine.async_exec), "wall_s": wall,
        "decode_ms_per_token": (1e3 * (d["decode_loop_s"] + d["spec_loop_s"] + d["mixed_loop_s"])
                                / after_first),
        "dispatches_per_token": d["dispatches"] / d["committed_tokens"],
        "acceptance_rate": sd["accepted_tokens"] / sd["drafted_tokens"] if sd["drafted_tokens"] else 0.0,
        "mean_accepted_len": sd["emitted_tokens"] / sd["verify_rows"] if sd["verify_rows"] else 0.0,
        "spec_draft_host_ms_per_step": 1e3 * (totals1[1] - totals0[1]) / draft_steps if draft_steps else 0.0,
        "spec_draft_steps": draft_steps,
        "attention_launches": ra.launches, "launches_by_kernel": by_entry, **d, **sd,
        "streams": {i: toks for i, (toks, _, _) in got.items()},
        "logprobs": {i: lps for i, (_, lps, _) in got.items()},
    }
    print(f"speculation {name} ({'async' if res['async_exec'] else 'sync'}): decode "
          f"{res['decode_ms_per_token']:.3f} ms per emitted token, "
          f"{res['dispatches_per_token']:.4f} dispatches per emitted token ({d['dispatches']} for "
          f"{d['committed_tokens']}); drafted {sd['drafted_tokens']}, accepted "
          f"{sd['accepted_tokens']} (rate {res['acceptance_rate']:.4f}), mean accepted length "
          f"{res['mean_accepted_len']:.3f}, verify rows {sd['verify_rows']}, device rounds "
          f"{sd['device_rounds']} (hits {sd['device_hits']}); spec_draft {draft_steps:.0f} steps, "
          f"{res['spec_draft_host_ms_per_step']:.3f} host ms each; forwards {d['forwards']}, "
          f"attention launches {ra.launches} by kernel {by_entry}; replays "
          f"{d['graph_replays']} for {d['dispatches']} dispatches, captures "
          f"{d['graph_captures']}; wall {wall:.2f} s", flush=True)
    if (ra.launches != core.cfg.num_layers * d["forwards"] or d["graph_captures"]
            or d["graph_replays"] != d["dispatches"]
            or any(len(t) != SPEC_TOKENS or f != "length" for t, _, f in got.values())):
        raise AssertionError(f"speculation {name}: { {k: v for k, v in res.items() if k not in ('streams', 'logprobs')} }")
    return res


def compare_streams(base: dict, run: dict, limit: float) -> list[dict]:
    """Each greedy lane of ``run`` against spec off: equal, or equal up to
    a position where spec off's top-2 logit gap is within ``limit`` (a
    near-tie that the verify forward's rounding may break the other way;
    the streams part there). Prints each divergence with its gap; raises
    on one past a clear margin."""
    out = []
    for i, want in base["streams"].items():
        if i in SPEC_SEEDED:
            continue
        got = run["streams"][i]
        j = next((j for j, (a, b) in enumerate(zip(want, got)) if a != b), None)
        if j is None:
            continue
        top = base["logprobs"][i][j]["top"]
        gap = top[0][1] - top[1][1]
        out.append({"lane": i, "position": j, "off": want[j], "on": got[j], "gap": gap})
        print(f"divergence, {run['run']} lane {i} at token {j}: spec off {want[j]}, spec on "
              f"{got[j]}; spec off's top-2 logit gap {gap:.4e} (limit {limit:.4e})", flush=True)
        if gap > limit:
            raise AssertionError(f"{run['run']}: lane {i} parts from spec off at token {j} where "
                                 f"the top-2 gap {gap:.4e} exceeds {limit:.4e}")
    return out


def serve_spec(ra, card: str, core) -> dict:
    """The speculation phase, bf16, llama3-8b at full width and depth, on
    the main path engine's weights: K1 at the verify shapes, verify-forward
    against one-token-forward logits, the rings' copy, a speculating
    engine's ``warm_up()`` (waves, spec_k 4, device drafting allowed, at
    width 8), then the phase's traffic with speculation off (the main path
    engine, with top-2 log-probabilities on the greedy lanes), drafted on
    the host (the requests' ``spec_decode`` turns device drafting off),
    sync and async, and drafted on the device, sync and async (the
    engine's configuration switched; the planners read ``async_exec`` at
    every step); then the same engine switched to chunked scheduling,
    warmed up again for its chunked keys, with a 2124-token prompt in the
    last lane: spec off, host drafts and device drafts. Under both
    drafters: drafts made, fewer dispatches than emitted tokens, no
    capture while serving, and greedy streams equal to spec off's (the
    same scheduler's) but at near-ties."""
    import dataclasses

    from dynamo_tpu_torch import tracing
    from dynamo_tpu_torch.backends.torch.main import build_engine
    from dynamo_tpu_torch.tracing import core as tracing_core

    prompts = spec_prompts(core.cfg.vocab_size)
    res = {"shapes": check_verify_shapes(ra, [len(p) for p in prompts])}
    res["logits"] = verify_logits(core, prompts)
    limit = res["logits"]["near_tie_limit"]
    scfg = dict(SPEC_ENGINE)
    score, _ = build_engine("llama3-8b", scfg, device="cuda", params=core.params)
    res["ring"] = ring_copy(score)
    keys = [launch.key[0] for launch, _ in score._warm_up_launches()]
    res["warm_up"] = {**warm_up(score, "speculation"),
                      "keys": {k: keys.count(k) for k in sorted(set(keys))}}
    print(f"speculation warm-up keys: {res['warm_up']['keys']}", flush=True)
    before = (tracing.trace_enabled(), tracing_core._STATE.sample)
    tracing.configure(enabled=True, sample=1.0)
    try:
        runs = [spec_traffic(ra, core, "off", prompts, None, logprobs=2)]
        for name, spec in (("host", {"method": "ngram", "device": False}),
                           ("device", {"method": "ngram"})):
            for async_exec in (False, True):
                score.engine = dataclasses.replace(score.engine, async_exec=async_exec)
                runs.append(spec_traffic(ra, score, name, prompts, spec))
        # Chunked scheduling on the same engine: its configuration switched
        # (the planners read it at every step) and its warm-up run again,
        # capturing the chunked keys it lacks; a 2124-token prompt takes
        # the last lane, so verify rows and drafting lanes ride beside its
        # chunks. Its own spec-off run is the streams' reference.
        score.engine = dataclasses.replace(score.engine, scheduling="chunked", async_exec=False)
        captured = score.scheduler_stats()["graph_captures"]
        keys = [launch.key[0] for launch, _ in score._warm_up_launches()]
        res["chunked_warm_up"] = {**warm_up(score, "speculation, chunked"),
                                  "keys": {k: keys.count(k) for k in sorted(set(keys))}}
        res["chunked_warm_up"]["new_captures"] = score.scheduler_stats()["graph_captures"] - captured
        print(f"speculation, chunked: {res['chunked_warm_up']['new_captures']} keys captured "
              f"anew of {len(keys)} ({res['chunked_warm_up']['keys']})", flush=True)
        rng = np.random.default_rng(778)
        mixed = prompts[:-1] + [[int(t) for t in rng.integers(0, core.cfg.vocab_size, SPEC_LONG)]]
        runs += [spec_traffic(ra, score, f"chunked_{name}", mixed, spec, logprobs)
                 for name, spec, logprobs in (("off", {"method": "off"}, 2),
                                              ("host", {"method": "ngram", "device": False}, None),
                                              ("device", {"method": "ngram"}, None))]
    finally:
        tracing.configure(enabled=before[0], sample=before[1])
    res["divergences"] = {}
    for run in runs[1:]:
        if run["run"] == "chunked_off":
            continue
        tag = f"{run['run']}{'_async' if run['async_exec'] else ''}"
        base = next(r for r in runs if r["run"] == ("chunked_off" if tag.startswith("chunked")
                                                   else "off"))
        res["divergences"][tag] = compare_streams(base, run, limit)
        if run["drafted_tokens"] <= 0 or run["dispatches_per_token"] >= 1:
            raise AssertionError(f"speculation {tag}: drafted {run['drafted_tokens']}, "
                                 f"{run['dispatches_per_token']:.4f} dispatches per token")
        if run["run"].endswith("device") and run["device_rounds"] <= 0:
            raise AssertionError(f"speculation {tag}: no round drafted on the device")
    del score
    gc.collect()
    torch.cuda.empty_cache()
    res["traffic"] = [{k: v for k, v in r.items() if k not in ("streams", "logprobs")}
                      for r in runs]
    print(f"speculation phase on {card}: " + "; ".join(
        f"{r['run']}{' async' if r['async_exec'] else ''} {r['decode_ms_per_token']:.3f} ms/token, "
        f"{r['dispatches_per_token']:.4f} dispatches/token, acceptance {r['acceptance_rate']:.3f}"
        for r in res["traffic"]), flush=True)
    return res


# -- the worker process --------------------------------------------------------

# -- checkpoints ---------------------------------------------------------------

SHARD_BYTES = 5 * 10**9  # the largest shard, as Hugging Face's writer cuts them
ST_DTYPES = {torch.bfloat16: "BF16", torch.float16: "F16", torch.float32: "F32"}
HF_ARCH = {"llama": "LlamaForCausalLM", "qwen2": "Qwen2ForCausalLM"}


def sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def hf_tensors(params, cfg) -> list:
    """The port's params as a Hugging Face checkpoint's tensors, in file
    order: (name, a function giving the ``[out, in]`` view), so that one
    tensor at a time is made contiguous and copied off the card."""
    L = params["layers"]
    q, kv, i, h = cfg.q_size, cfg.kv_size, cfg.intermediate_size, cfg.hidden_size
    out = [("model.embed_tokens.weight", lambda: params["embed"])]
    for layer in range(cfg.num_layers):
        pre = f"model.layers.{layer}."
        out += [(pre + "input_layernorm.weight", lambda l=layer: L["attn_norm"][l]),
                (pre + "post_attention_layernorm.weight", lambda l=layer: L["mlp_norm"][l])]
        for hf, leaf, c0, c1 in (
            ("self_attn.q_proj", "wqkv", 0, q), ("self_attn.k_proj", "wqkv", q, q + kv),
            ("self_attn.v_proj", "wqkv", q + kv, q + 2 * kv), ("self_attn.o_proj", "wo", 0, h),
            ("mlp.gate_proj", "wgu", 0, i), ("mlp.up_proj", "wgu", i, 2 * i),
            ("mlp.down_proj", "w_down", 0, h),
        ):
            out.append((f"{pre}{hf}.weight",
                        lambda l=layer, w=leaf, a=c0, b=c1: L[w][l][:, a:b].T))
            if leaf == "wqkv" and "bqkv" in L:
                out.append((f"{pre}{hf}.bias", lambda l=layer, a=c0, b=c1: L["bqkv"][l][a:b]))
    out.append(("model.norm.weight", lambda: params["final_norm"]))
    if "lm_head" in params:
        out.append(("lm_head.weight", lambda: params["lm_head"].T))
    return out


def write_hf_checkpoint(params, cfg, model_type: str, path: Path) -> dict:
    """Write ``params`` as a Hugging Face checkpoint directory with this
    script's own safetensors writer (an 8-byte little-endian header length,
    the JSON header padded to 8 bytes, then each tensor's raw bytes):
    ``config.json``, shards of at most ``SHARD_BYTES``, and the shard
    index. No tokenizer files. Refuses to start unless the disk has twice
    the checkpoint's bytes free."""
    entries = [(name, fn, fn()) for name, fn in hf_tensors(params, cfg)]
    total = sum(t.numel() * t.element_size() for _, _, t in entries)
    free = shutil.disk_usage(path).free
    print(f"checkpoint {model_type}: {total / 1e9:.2f} GB to write under {path}; "
          f"{free / 1e9:.1f} GB free on its disk", flush=True)
    if free < 2 * total:
        raise RuntimeError(f"{free / 1e9:.1f} GB free under {path}: the checkpoint needs "
                           f"twice its {total / 1e9:.2f} GB")
    t0 = time.perf_counter()
    shards, size = [[]], 0
    for e in entries:
        n = e[2].numel() * e[2].element_size()
        if shards[-1] and size + n > SHARD_BYTES:
            shards.append([])
            size = 0
        shards[-1].append(e)
        size += n
    weight_map = {}
    for k, shard in enumerate(shards):
        fname = f"model-{k + 1:05d}-of-{len(shards):05d}.safetensors"
        header, off = {}, 0
        for name, _, t in shard:
            n = t.numel() * t.element_size()
            header[name] = {"dtype": ST_DTYPES[t.dtype], "shape": list(t.shape),
                            "data_offsets": [off, off + n]}
            weight_map[name] = fname
            off += n
        raw = json.dumps(header).encode()
        raw += b" " * (-len(raw) % 8)
        with open(path / fname, "wb") as f:
            f.write(struct.pack("<Q", len(raw)) + raw)
            for _, fn, _ in shard:
                f.write(fn().contiguous().cpu().reshape(-1).view(torch.uint8).numpy())
    (path / "model.safetensors.index.json").write_text(
        json.dumps({"metadata": {"total_size": total}, "weight_map": weight_map}))
    (path / "config.json").write_text(json.dumps({
        "architectures": [HF_ARCH[model_type]], "model_type": model_type,
        "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size, "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads, "num_key_value_heads": cfg.num_kv_heads,
        "head_dim": cfg.head_dim, "rope_theta": cfg.rope_theta,
        "rms_norm_eps": cfg.rms_norm_eps, "tie_word_embeddings": cfg.tie_embeddings,
        "torch_dtype": "bfloat16",
    }))
    secs = time.perf_counter() - t0
    print(f"checkpoint {model_type}: {len(shards)} shards written in {secs:.1f} s "
          f"({total / 1e9 / secs:.2f} GB/s)", flush=True)
    return {"bytes": total, "shards": len(shards), "write_s": secs}


def rss_bytes() -> int:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def leaves_equal(got, want, where="params") -> list[str]:
    """The paths of the leaves that are not ``torch.equal`` (or absent)."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or got.keys() != want.keys():
            return [where]
        return [p for k in want for p in leaves_equal(got[k], want[k], f"{where}.{k}")]
    same = got.dtype == want.dtype and got.shape == want.shape and torch.equal(got, want)
    return [] if same else [where]


def timed_load(path: Path, device: str, quant=None) -> tuple:
    """``load_hf_llama(path)`` with its seconds, the peak device memory it
    added and the process's peak host RSS growth (sampled every 10 ms)."""
    from dynamo_tpu_torch.engine.loader import load_hf_llama

    sync(device)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    base_dev = torch.cuda.memory_allocated() if device == "cuda" else 0
    base_rss, peak_rss, done = rss_bytes(), [0], threading.Event()

    def sample():
        while not done.is_set():
            peak_rss[0] = max(peak_rss[0], rss_bytes())
            done.wait(0.01)

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    t0 = time.perf_counter()
    try:
        cfg, params = load_hf_llama(path, quant=quant, device=device)
        sync(device)
        secs = time.perf_counter() - t0
    finally:
        done.set()
        sampler.join()
    stats = {"load_s": secs, "peak_rss_growth_gb": (peak_rss[0] - base_rss) / 1e9,
             "peak_device_gb": ((torch.cuda.max_memory_allocated() - base_dev) / 1e9
                                if device == "cuda" else None),
             "params_gb": tree_bytes(params) / 1e9}
    return cfg, params, stats


def checkpoint_round_trip(core, model_type: str, device: str) -> dict:
    """Write the engine's weights as a checkpoint into a new temporary
    directory, load it back and hold every leaf to the drawn one; the
    directory stays for the caller, who deletes it."""
    path = Path(tempfile.mkdtemp(prefix=f"chip_smoke_{model_type}_"))
    try:
        out = write_hf_checkpoint(core.params, core.cfg, model_type, path)
        cfg, params, stats = timed_load(path, device)
        out |= stats
        out["load_gb_per_s"] = out["bytes"] / 1e9 / stats["load_s"]
        if cfg != dataclasses.replace(core.cfg, name=model_type):
            raise AssertionError(f"config.json read back as {cfg}, drawn {core.cfg}")
        bad = leaves_equal(params, core.params)
        if bad:
            raise AssertionError(f"{len(bad)} loaded leaves differ from the drawn ones: {bad[:4]}")
        print(f"checkpoint {model_type}: loaded in {stats['load_s']:.1f} s "
              f"({out['load_gb_per_s']:.2f} GB/s); every leaf equal to the drawn one; peak "
              f"device memory added {stats['peak_device_gb']} GB for {stats['params_gb']:.2f} GB "
              f"of params; peak host RSS growth {stats['peak_rss_growth_gb']:.2f} GB", flush=True)
        del params
    except BaseException:
        shutil.rmtree(path, ignore_errors=True)
        raise
    out["dir"] = str(path)
    return out


DISAGG_LAYERS = 8  # the disaggregation phase's depth: its 3 workers' warm-ups, in turn on the card


def write_cut_checkpoint(core, layers: int) -> dict:
    """The engine's first ``layers`` layers (with its embeddings, final
    norm and head) as a llama checkpoint in a new temporary directory,
    which the caller deletes."""
    path = Path(tempfile.mkdtemp(prefix="chip_smoke_cut_"))
    params = {**core.params,
              "layers": {k: v[:layers] for k, v in core.params["layers"].items()}}
    try:
        out = write_hf_checkpoint(params, dataclasses.replace(core.cfg, num_layers=layers),
                                  "llama", path)
    except BaseException:
        shutil.rmtree(path, ignore_errors=True)
        raise
    return {**out, "layers": layers, "dir": str(path)}


def int8_reference(w: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The JAX loader's int8 arithmetic (``_quantize_np``) in numpy, on an
    f32 ``[in, out]`` weight."""
    scale = np.maximum(np.abs(w).max(axis=-2, keepdims=True) / np.float32(127.0),
                       np.float32(1e-8))
    return np.clip(np.round(w / scale), -127, 127).astype(np.int8), scale.astype(np.float32)


def int8_load(path: Path, device: str) -> dict:
    """The checkpoint loaded with ``quant="int8"``: its footprint, and layer
    0's projections and ``lm_head`` held bit for bit to the same
    arithmetic in numpy on the CPU, from the file's values."""
    from dynamo_tpu_torch.engine.loader import read_safetensors

    cfg, q8, stats = timed_load(path, device, quant="int8")
    files = {}
    for f in sorted(path.glob("*.safetensors")):
        files.update(read_safetensors(f))

    def f32(name):  # HF [out, in] -> f32 [in, out]
        return np.ascontiguousarray(files[name].float().numpy().T)

    pre = "model.layers.0."
    groups = {"wqkv": ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj"),
              "wo": ("self_attn.o_proj",), "wgu": ("mlp.gate_proj", "mlp.up_proj"),
              "w_down": ("mlp.down_proj",)}
    held = []
    for leaf, names in groups.items():
        parts = [int8_reference(f32(f"{pre}{n}.weight")) for n in names]
        want = (np.concatenate([w for w, _ in parts], -1), np.concatenate([s for _, s in parts], -1))
        got = q8["layers"][leaf]
        held.append((f"layers.{leaf}[0]", got["w"][0].cpu().numpy(), got["scale"][0].cpu().numpy(),
                     *want))
    if "lm_head" in q8:
        w, sc = int8_reference(f32("lm_head.weight"))
        held.append(("lm_head", q8["lm_head"]["w"].cpu().numpy(),
                     q8["lm_head"]["scale"].cpu().numpy(), w, sc))
    for name, gw, gs, ww, ws in held:
        if not (np.array_equal(gw, ww) and gs.view(np.int32).tobytes() == ws.view(np.int32).tobytes()):
            raise AssertionError(f"int8 load: {name} differs from the CPU quantization")
    print(f"checkpoint int8 load: {stats['load_s']:.1f} s, footprint {stats['params_gb']:.2f} GB "
          f"(model.quantized_param_bytes {cfg.quantized_param_bytes() / 1e9:.2f} GB), peak "
          f"device memory added {stats['peak_device_gb']} GB, peak host RSS growth "
          f"{stats['peak_rss_growth_gb']:.2f} GB; {', '.join(n for n, *_ in held)} bit-equal to "
          f"the numpy quantization on the CPU", flush=True)
    del q8, files
    return {**stats, "held_bit_equal": [n for n, *_ in held]}


QWEN_LAYERS = 4
QWEN_PROMPT_LENS = (100, 300, 500, 700, 900, 1100, 1500, 2000)
QWEN_TOKENS = 64


def greedy_streams(core, prompt_lens, max_tokens, seed=7) -> dict[str, list[int]]:
    """Greedy streams of prompts of random tokens, all admitted at once,
    stepped to the end on ``core``."""
    from dynamo_tpu_torch.llm.protocols.common import PreprocessedRequest

    rng = np.random.default_rng(seed)
    for i, n in enumerate(prompt_lens):
        core.add_request(PreprocessedRequest.from_wire({
            "model": "m", "token_ids": [int(t) for t in rng.integers(1, core.cfg.vocab_size, n)],
            "request_id": f"q{i}", "sampling": {"temperature": 0.0},
            "stop": {"max_tokens": max_tokens, "ignore_eos": True}}))
    out: dict[str, list[int]] = {f"q{i}": [] for i in range(len(prompt_lens))}
    while core.has_work():
        for seq, o in core.step():
            out[seq.request_id] += o.token_ids
    if any(len(t) != max_tokens for t in out.values()):
        raise AssertionError(f"stream lengths {[len(t) for t in out.values()]}")
    return out


def serve_qwen2(ra, card: str, device: str = "cuda", layers: int = QWEN_LAYERS) -> dict:
    """Qwen2-7B at full width (h 3584, FFN 18944, 28/4 heads, vocab 152064,
    qkv biases), ``layers`` of its 28 layers, bf16 weights drawn from seed
    0: greedy streams through ``EngineCore`` (K1 at the group of 7, every
    layer's forward), then the weights written as a ``qwen2`` checkpoint,
    loaded (every leaf equal), and the same streams from an engine on the
    loaded weights, one engine on the card at a time."""
    from dynamo_tpu_torch.engine.config import EngineConfig, qwen2_7b
    from dynamo_tpu_torch.engine.core import EngineCore
    from dynamo_tpu_torch.engine.model import init_params

    t0 = time.time()
    cfg = dataclasses.replace(qwen2_7b(), num_layers=layers)
    core = EngineCore(cfg, EngineConfig(), params=init_params(cfg, 0, device), device=device)
    ra.reset_launches()
    t1 = time.time()
    want = greedy_streams(core, QWEN_PROMPT_LENS, QWEN_TOKENS)
    stats = core.scheduler_stats()
    launches = launches_of(ra)
    drawn_s = time.time() - t1
    if device == "cuda" and (
            stats["attention_launches"] != cfg.num_layers * stats["forwards"]
            or min(launches.get(k, 0) for k in ("ragged_paged_attention_decode_launch",
                                                 "ragged_paged_attention_tiled_launch")) == 0):
        raise AssertionError(f"K1 launches {launches} for {stats['forwards']} forwards")
    ck = checkpoint_round_trip(core, "qwen2", device)
    del core
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    try:
        t2 = time.time()
        lcfg, params, _ = timed_load(Path(ck["dir"]), device)
        core = EngineCore(lcfg, EngineConfig(), params=params, device=device)
        got = greedy_streams(core, QWEN_PROMPT_LENS, QWEN_TOKENS)
        loaded_s = time.time() - t2
    finally:
        shutil.rmtree(ck["dir"], ignore_errors=True)
    same = got == want
    print(f"qwen2-7b ({layers} of 28 layers) on {card}: {len(want)} greedy streams of "
          f"{QWEN_TOKENS} tokens from the loaded checkpoint equal to the drawn engine's: {same}; "
          f"K1 launches {launches} over {stats['forwards']} forwards; drawn engine's traffic "
          f"{drawn_s:.1f} s, loaded engine's (load included) {loaded_s:.1f} s; phase "
          f"{time.time() - t0:.1f} s", flush=True)
    if not same:
        diff = [r for r in want if got[r] != want[r]]
        raise AssertionError(f"qwen2 streams differ after the checkpoint round trip: {diff}")
    del core, params
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return {"layers": layers, "launches": launches, "forwards": stats["forwards"],
            "checkpoint": {k: v for k, v in ck.items() if k != "dir"},
            "phase_s": time.time() - t0}


GGUF_TOKENS = ["<s>", "</s>", "<unk>", "▁hello", "▁world", "▁", "he", "llo"] + [
    f"<0x{b:02X}>" for b in range(256)]


def gguf_round_trip(tmp: str) -> dict:
    """A GGUF v3 file written here (a token table, llama metadata, one F32,
    one F16 and one BF16 tensor) read back by the port's reader, which
    needs no ml_dtypes: the tensors bit-equal, the config, and a
    ``load_tokenizer`` encode and decode round trip."""
    from dynamo_tpu_torch.engine.gguf import config_from_gguf, read_gguf
    from dynamo_tpu_torch.llm.tokenizer import load_tokenizer

    def s(text):
        b = text.encode()
        return struct.pack("<Q", len(b)) + b

    def kv(key, vtype, payload):
        return s(key) + struct.pack("<I", vtype) + payload

    gen = torch.Generator().manual_seed(5)
    tensors = {"tok_embd.weight": (0, torch.randn(16, 8, generator=gen)),
               "blk.0.ffn_up.weight": (1, torch.randn(8, 4, generator=gen).half()),
               "blk.0.attn_norm.weight": (30, torch.randn(4, 16, generator=gen).bfloat16())}
    meta = [kv("general.architecture", 8, s("llama")), kv("general.name", 8, s("smoke")),
            kv("llama.embedding_length", 4, struct.pack("<I", 4096)),
            kv("llama.block_count", 4, struct.pack("<I", 32)),
            kv("llama.attention.head_count", 4, struct.pack("<I", 32)),
            kv("llama.attention.head_count_kv", 4, struct.pack("<I", 8)),
            kv("llama.feed_forward_length", 4, struct.pack("<I", 14336)),
            kv("llama.rope.freq_base", 6, struct.pack("<f", 500000.0)),
            kv("tokenizer.ggml.model", 8, s("llama")),
            kv("tokenizer.ggml.tokens", 9, struct.pack("<IQ", 8, len(GGUF_TOKENS))
               + b"".join(s(t) for t in GGUF_TOKENS)),
            kv("tokenizer.ggml.bos_token_id", 4, struct.pack("<I", 0)),
            kv("tokenizer.ggml.eos_token_id", 4, struct.pack("<I", 1))]
    index, data = b"", b""
    for name, (gtype, t) in tensors.items():
        data += b"\0" * (-len(data) % 32)
        index += (s(name) + struct.pack("<I", t.dim()) + struct.pack(f"<{t.dim()}Q", *reversed(t.shape))
                  + struct.pack("<IQ", gtype, len(data)))
        data += t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    header = struct.pack("<IIQQ", 0x46554747, 3, len(tensors), len(meta)) + b"".join(meta) + index
    path = Path(tmp, "smoke.gguf")
    path.write_bytes(header + b"\0" * (-len(header) % 32) + data)

    g = read_gguf(path)
    for name, (_, t) in tensors.items():
        got = g.load_tensor(name)
        if got.dtype != t.dtype or not torch.equal(got, t):
            raise AssertionError(f"GGUF tensor {name} read back as {got.dtype} {tuple(got.shape)}")
    g.close()
    cfg = config_from_gguf(g)
    if (cfg.hidden_size, cfg.num_layers, cfg.num_kv_heads, cfg.vocab_size) != (
            4096, 32, 8, len(GGUF_TOKENS)):
        raise AssertionError(f"GGUF config {cfg}")
    tok = load_tokenizer(str(path))
    text = "hello world, ünïcode €!"
    ids = tok.encode(text)
    back = tok.decode(ids)
    if back != text or tok.eos_token_id != 1:
        raise AssertionError(f"GGUF tokenizer round trip: {text!r} -> {ids} -> {back!r}")
    print(f"GGUF on this machine: F32, F16 and BF16 tensors read back bit-equal, config "
          f"{cfg.num_layers} layers x {cfg.hidden_size}, tokenizer round trip of {len(ids)} "
          f"tokens", flush=True)
    return {"tensors": list(tensors), "tokens": len(ids)}


ROOT = Path(__file__).resolve().parent
WORKER_SOLO = ("long", "prefix_a", "mid", "short")  # greedy prompts sent one at a time
WORKER_RESEND = "mid"
# The staggered batch: STAGGER_FIRST alone, the other 7 STAGGER_DELAY_S
# later. Its prefill step ends at ~25 ms and its first decode megastep
# lasts 8 iterations of 20 ms or more, so the 7 arrive inside that
# megastep through either path and share the next wave.
STAGGER_FIRST, STAGGER_DELAY_S = "short", 0.1
DATAPLANE_REPEATS = 40  # replays of the worker's batch chunks per stream


async def timed_stream(open_stream, rid, prompt, sampling, logprobs=1) -> dict:
    """One request's output chunks, each token with its log-probability
    (and ``logprobs`` - 1 alternatives), with the client's clock: time to
    the first chunk, and ms per token after the first. (The frontend phase
    sends the same requests over HTTP, where a completion streams a chunk
    only for a token that has text or a log-probability.)"""
    t0 = time.perf_counter()
    outs, stamps = [], []
    async for out in await open_stream(wire(rid, prompt, sampling, logprobs=logprobs)):
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


async def staggered_batch(open_stream, by_id: dict, logprobs=1) -> list[dict]:
    """The 8 serving prompts in an arrival pattern that neither path
    shapes: ``STAGGER_FIRST`` alone, the other 7 ``STAGGER_DELAY_S``
    later."""
    first = asyncio.create_task(
        timed_stream(open_stream, *by_id[STAGGER_FIRST], logprobs=logprobs))
    await asyncio.sleep(STAGGER_DELAY_S)
    rest = asyncio.gather(*(timed_stream(open_stream, *r, logprobs=logprobs)
                            for rid, r in by_id.items() if rid != STAGGER_FIRST))
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


def in_process_traffic(core, captures: int) -> tuple[dict, dict, dict]:
    """The worker phase's traffic in this process, through the main path's
    bf16 engine (``core``: llama3-8b from seed 0, the worker's default
    ``EngineConfig``, whose ``warm_up()`` captured ``captures`` graphs)
    after all its sub-phases, from a cleared prefix cache, as a fresh
    worker serves it from its own; then the engine's weights written as a
    llama checkpoint and loaded back (:func:`checkpoint_round_trip`), and
    its first ``DISAGG_LAYERS`` layers written as another (both
    directories the caller's to delete)."""
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.runtime.engine import Context

    core.clear_kv_cache()
    engine = TorchEngine(core)
    before = dict(core.scheduler_stats())

    async def open_stream(req):
        return engine.generate(req, Context(req["request_id"]))

    got = asyncio.run(worker_traffic(open_stream, core.cfg.vocab_size))
    st = core.scheduler_stats()
    if st["graph_captures"] != before["graph_captures"]:
        raise AssertionError(f"{st['graph_captures'] - before['graph_captures']} graphs captured "
                             f"serving the worker traffic in process, after warm_up()")
    stats = {k: st[k] - before[k] for k in ("decode_loop_s", "decode_iterations")}
    stats["graph_captures"] = captures
    ck = checkpoint_round_trip(core, "llama", "cuda")
    try:
        ck["cut"] = write_cut_checkpoint(core, DISAGG_LAYERS)
    except BaseException:
        shutil.rmtree(ck["dir"], ignore_errors=True)
        raise
    return got, stats, ck


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def wait_for_port(port: int, proc, timeout: float) -> None:
    deadline = time.time() + timeout
    while time.time() < deadline:
        if proc.poll() is not None:
            raise RuntimeError(f"the process for port {port} exited with {proc.returncode}")
        with socket.socket() as s:
            if s.connect_ex(("127.0.0.1", port)) == 0:
                return
        time.sleep(0.1)
    raise TimeoutError(f"nothing listened on port {port}")


async def solo_traffic(open_stream, vocab: int) -> dict:
    """The ``WORKER_SOLO`` prompts one at a time."""
    reqs, late, _ = serving_requests(vocab)
    by_id = {r[0]: r for r in reqs + [late]}
    return {"solo": [await timed_stream(open_stream, *by_id[rid]) for rid in WORKER_SOLO]}


async def drive_worker(address: str, worker, vocab: int, solo_only=False,
                       before_traffic=None) -> tuple[dict, list, object]:
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
        if before_traffic is not None:
            await before_traffic()

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


def start_worker(preset: str, device: str, extra_args: list[str], env=None,
                 model_path=None) -> dict:
    """The port's store and ``python -m dynamo_tpu_torch.backends.torch``
    (with ``extra_args`` and the environment variables ``env``; serving
    the checkpoint at ``model_path`` in place of the preset when given)
    started as subprocesses; the worker builds and warms up its engine
    meanwhile."""
    logs = Path(tempfile.mkdtemp(prefix="chip_smoke_worker_"))
    port = free_port()
    h = {"logs": logs, "port": port, "args": extra_args, "worker": None,
         "files": [open(logs / "store.log", "w"), open(logs / "worker.log", "w")]}
    h["store"] = subprocess.Popen(
        [sys.executable, "-m", "dynamo_tpu_torch.runtime.store", "--port", str(port)],
        cwd=ROOT, stdout=h["files"][0], stderr=subprocess.STDOUT,
    )
    try:
        wait_for_port(port, h["store"], 30)
        h["t0"] = time.time()
        h["worker"] = subprocess.Popen(
            [sys.executable, "-m", "dynamo_tpu_torch.backends.torch", "--model-name", preset,
             *(["--model-path", model_path] if model_path else ["--preset", preset]),
             "--seed", "0", "--device", device, *extra_args],
            cwd=ROOT, stdout=h["files"][1], stderr=subprocess.STDOUT,
            env={**os.environ, **(env or {}), "DYN_STORE_ADDRESS": f"127.0.0.1:{port}"},
        )
    except BaseException:
        close_worker(h)
        raise
    return h


def close_worker(h: dict) -> None:
    if h["worker"] is not None:
        stop_process(h["worker"], signal.SIGKILL, 10)
    stop_process(h["store"], signal.SIGTERM, 10)
    for f in h["files"]:
        f.close()


def served_after_s(h: dict) -> float:
    """Seconds from a worker's start to its log's "serving model" line."""
    for line in (h["logs"] / "worker.log").read_text().splitlines():
        if " serving model " in line:
            stamp, ms = line[:23].split(",")
            return time.mktime(time.strptime(stamp, "%Y-%m-%d %H:%M:%S")) + int(ms) / 1e3 - h["t0"]
    raise AssertionError(f"worker {h['args']} never logged that it serves")


def worker_build_s(h: dict) -> dict:
    """The seconds a worker logged for building its engine (its weights
    loaded or drawn) and for warming it up, timed inside the worker."""
    text = (h["logs"] / "worker.log").read_text()
    m = re.search(r"engine built in ([\d.]+) s \(weights ([^)]*)\), warmed up in ([\d.]+) s", text)
    if m is None:
        raise AssertionError(f"worker {h['args']} logged no build and warm-up times")
    return {"build_s": float(m.group(1)), "weights": m.group(2), "warm_up_s": float(m.group(3))}


def finish_worker(h: dict, cfg, solo_only=False,
                  before_traffic=None) -> tuple[dict, list, object, dict]:
    """Drive a worker of :func:`start_worker` (:func:`drive_worker`; once
    its model card is up, ``before_traffic()`` first), stop it and return
    its traffic, KV events, model card and exit counters."""
    worker, logs = h["worker"], h["logs"]
    try:
        got, events, mdc = asyncio.run(drive_worker(
            f"127.0.0.1:{h['port']}", worker, cfg.vocab_size, solo_only, before_traffic))
        stop_process(worker)
        if worker.returncode != 0:
            raise AssertionError(f"worker exited with {worker.returncode}")
        print(f"worker phase: worker {' '.join(h['args'])} up and served in "
              f"{time.time() - h['t0']:.1f} s", flush=True)
    except BaseException:
        print(f"worker log tail:\n{(logs / 'worker.log').read_text()[-6000:]}", file=sys.stderr)
        raise
    finally:
        close_worker(h)
    return got, events, mdc, worker_stats(logs / "worker.log")


def serve_worker(card: str, reference: tuple, preset: str = "llama3-8b",
                 device: str = "cuda") -> tuple[dict, dict, dict]:
    """The worker process: the port's store and
    ``python -m dynamo_tpu_torch.backends.torch`` as subprocesses, driven
    through the port's discovery and data-plane client. Its solo greedy
    streams must equal the in-process engine's (``reference``, from
    :func:`in_process_traffic`: run on the main path's long-lived engine
    after all its sub-phases, since freed, so one engine is on the card at
    a time), chunk for chunk but for the engine step the first chunk
    names; the 8-request batch's times are
    printed beside the in-process engine's; a resent prompt must report
    cached tokens, and the worker's KV events must carry the block hashes
    of the prompt's full blocks. The worker runs without its status server
    and obs snapshots (``DYN_SYSTEM_ENABLED=0``, ``--obs-publish off``),
    the frontend phase's workers with them, so the two phases' decode
    times compare the two. The sync worker serves the in-process engine's
    weights written as a checkpoint (``--model-path``), the async one the
    preset's seeded draw; both start-ups are printed. Returns the
    summary, and the worker's traffic and exit counters, which the
    frontend phase is held to."""
    from dynamo_tpu_torch.engine.config import PRESETS
    from dynamo_tpu_torch.tokens import compute_seq_hashes

    cfg = PRESETS[preset]()
    ref, ref_stats, ck = reference
    ck["int8"] = int8_load(Path(ck["dir"]), device)
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    # The async worker (the preset) warms up while the sync worker (the
    # checkpoint) does; the sync worker's traffic waits until it is
    # serving (and idle), so it runs alone on the card.
    h_async = start_worker(preset, device, ["--async-exec", "on"])
    try:
        # The checkpoint has no tokenizer files: the worker names the byte
        # tokenizer it would fall back to, not trying a Hugging Face one
        # first (~20 s of a worker's start-up).
        h_sync = start_worker(preset, device, ["--obs-publish", "off", "--tokenizer", "byte"],
                              env={"DYN_SYSTEM_ENABLED": "0"}, model_path=ck["dir"])
        got, events, mdc, stats = finish_worker(
            h_sync, cfg, before_traffic=lambda: wait_for_log(
                h_async["logs"] / "worker.log", r"torch aggregated worker \d+ serving model",
                h_async["worker"], 900))
        got_async, _, _, stats_async = finish_worker(h_async, cfg, solo_only=True)
    finally:
        close_worker(h_async)
    shutil.rmtree(ck["dir"], ignore_errors=True)  # the phase's checkpoint (main's finally too)
    # Start-up to serving, and inside it the engine's build (the load from
    # the checkpoint, or the preset's draw) and warm-up as each worker
    # timed them; the rest is the process's start, imports and joining the
    # fleet. The two warm up together on the card, the async one started
    # first, so only the build compares the load with the draw.
    startup_s = {name: {"served_after_s": served_after_s(h), **worker_build_s(h)}
                 for name, h in (("sync_worker_checkpoint", h_sync),
                                 ("async_worker_preset", h_async))}
    for name, st in startup_s.items():
        rest = st["served_after_s"] - st["build_s"] - st["warm_up_s"]
        print(f"worker start-up ({name}): serving after {st['served_after_s']:.1f} s; engine "
              f"built in {st['build_s']:.2f} s (weights {st['weights']}), warmed up in "
              f"{st['warm_up_s']:.2f} s; the rest {rest:.1f} s", flush=True)

    w0, r0 = got["solo"][0]["first_iteration"], ref["solo"][0]["first_iteration"]
    for w, r, a in zip(got["solo"], ref["solo"], got_async["solo"]):
        # The first chunk names the engine step that emitted it, a count
        # of the engine's whole life: the long-lived in-process engine has
        # stepped through every earlier phase, the fresh worker through
        # its warm-up only. So that step is compared as an offset from the
        # first solo request's; everything else must be equal: tokens,
        # log-probabilities, cached tokens, finish reasons.
        same = without_iteration(w["outs"]) == without_iteration(r["outs"])
        same_step = w["first_iteration"] - w0 == r["first_iteration"] - r0
        same_async = without_iteration(a["outs"]) == without_iteration(w["outs"])
        print(f"worker solo {w['rid']}: {len(w['tokens'])} tokens, greedy stream equal to "
              f"the long-lived in-process engine's: {same} (tokens equal "
              f"{w['tokens'] == r['tokens']}; the engine step the first chunk names: worker "
              f"{w['first_iteration']}, in process {r['first_iteration']}, equal offsets from "
              f"the first solo request's: {same_step}); the async worker's chunks equal the "
              f"sync worker's (but for that step): {same_async}", flush=True)
        if not same:
            raise AssertionError(f"{w['rid']}: the worker's greedy stream differs from build_engine's")
        if not same_step:
            raise AssertionError(f"{w['rid']}: its first token came {w['first_iteration'] - w0} "
                                 f"engine steps after the first solo request's on the worker, "
                                 f"{r['first_iteration'] - r0} in process")
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
            "checkpoint": ck, "startup_s": startup_s,
            "worker": rows[0], "in_process": rows[1],
            "worker_attention_launches": stats["attention_launches"],
            "worker_forwards": stats["forwards"],
            "worker_warm_up_forwards": stats["warm_up_forwards"], "kv_events": len(events)}, got, stats


# -- the frontend ----------------------------------------------------------------

# The shared-prefix check's chat prompts: one long system text (well over
# 4 full blocks of 16 byte tokens), then a question of their own.
ROUTE_SHARED_TEXT = ("Every request of this tenant opens with the same long system prompt, "
                     "so the blocks that hold it are worth routing to. ") * 3
ROUTE_SETTLE_S = 1.0  # for the KV events of a finished request to reach the router
BUSY_PROMPT_LENS = (2000, 300)  # the busy worker's request, and the fresh one


def metric_samples(text: str) -> dict[str, float]:
    """``name{labels}`` -> value of every sample of a Prometheus page."""
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            key, value = line.rsplit(" ", 1)
            out[key] = float(value)
    return out


def metric(samples: dict[str, float], name: str, *labels: str) -> float:
    """The sum of the samples of ``name`` whose labels hold every one of
    ``labels`` (``'key="value"'``)."""
    return sum(v for k, v in samples.items()
               if k.split("{", 1)[0] == name and all(lab in k for lab in labels))


def proc_cpu_s(pid: int) -> float:
    """A process's user and system CPU seconds, from ``/proc``."""
    fields = Path(f"/proc/{pid}/stat").read_text().rsplit(")", 1)[1].split()
    return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")


async def wait_for_log(path: Path, pattern: str, proc, timeout: float):
    """The first match of ``pattern`` in the log, once it appears."""
    deadline = time.time() + timeout
    while True:
        m = re.search(pattern, path.read_text(errors="replace"))
        if m:
            return m
        if proc.poll() is not None:
            raise RuntimeError(f"{path.name}: the process exited with {proc.returncode}")
        if time.time() > deadline:
            raise TimeoutError(f"{path.name}: no {pattern!r} after {timeout:.0f} s")
        await asyncio.sleep(0.5)


async def http_stream(session, url: str, body: dict) -> dict:
    """POST a streamed completion or chat request and read its server-sent
    events with the client's clock: every chunk, the log-probabilities of
    its tokens, its usage and finish reason, the time to the first chunk
    and ms per token after the first."""
    t0 = time.perf_counter()
    chunks, stamps, lps, tops = [], [], [], []
    async with session.post(url, json={**body, "stream": True}) as resp:
        if resp.status != 200:
            raise AssertionError(f"{url}: {resp.status} {await resp.text()}")
        async for line in resp.content:
            line = line.strip()
            if not line.startswith(b"data: "):
                continue
            if line == b"data: [DONE]":
                chunks.append("[DONE]")
                break
            chunk = json.loads(line[6:])
            if "error" in chunk:
                raise AssertionError(f"{url}: {chunk['error']}")
            chunks.append(chunk)
            lp = (chunk["choices"] or [{}])[0].get("logprobs") or {}
            if lp.get("token_logprobs"):
                stamps.append(time.perf_counter())
                lps += lp["token_logprobs"]
                tops += lp["top_logprobs"]
    if chunks[-1] != "[DONE]":
        raise AssertionError(f"{url}: the stream ended without [DONE]")
    final = chunks[-2]
    return {"chunks": chunks, "logprobs": lps, "top_logprobs": tops,
            "usage": final.get("usage") or {},
            "finish": next((c["choices"][0].get("finish_reason") for c in chunks[:-1]
                            if c["choices"] and c["choices"][0].get("finish_reason")), None),
            "ttft_ms": 1e3 * (stamps[0] - t0) if stamps else None,
            "tpot_ms": 1e3 * (stamps[-1] - stamps[0]) / max(1, len(lps) - 1) if stamps else None}


async def http_json(session, url: str, body: dict) -> dict:
    async with session.post(url, json=body) as resp:
        if resp.status != 200:
            raise AssertionError(f"{url}: {resp.status} {await resp.text()}")
        return await resp.json()


def completion_body(model: str, prompt, sampling: dict, pin=None) -> dict:
    """A pre-tokenized ``/v1/completions`` request of the worker phase's
    prompt and sampling, with one log-probability per token; ``pin`` names
    the worker it must run on."""
    body = {"model": model, "prompt": prompt, "max_tokens": MAX_TOKENS, "logprobs": 1,
            **sampling}
    if pin is not None:
        body["dyn"] = {"router": {"backend_instance_id": pin}}
    return body


def held_to_direct(rid: str, got: dict, direct: dict) -> None:
    """An HTTP completion against the same request through the data-plane
    client: the same count of tokens, finish reason, and log-probability
    of each token and of its top alternative."""
    want = [e for o in direct["outs"] for e in o.get("logprobs") or []]
    want_lps = [e["logprob"] for e in want]
    want_tops = [[lp for _, lp in e["top"]] for e in want]
    tops = [list(t.values()) for t in got["top_logprobs"]]
    if (len(got["logprobs"]) != len(direct["tokens"]) or got["finish"] != direct["finish"]
            or got["logprobs"] != want_lps or tops != want_tops):
        raise AssertionError(
            f"{rid}: over HTTP {len(got['logprobs'])} tokens, finish {got['finish']!r}; "
            f"direct {len(direct['tokens'])} tokens, finish {direct['finish']!r}; first "
            f"log-probabilities {got['logprobs'][:4]} against {want_lps[:4]}")


async def worker_metrics(session, workers: dict) -> dict[str, dict[str, float]]:
    out = {}
    for name, w in workers.items():
        async with session.get(f"http://127.0.0.1:{w['status_port']}/metrics") as resp:
            if resp.status != 200:
                raise AssertionError(f"{name} /metrics answered {resp.status}")
            out[name] = metric_samples(await resp.text())
    return out


def admitted(samples: dict[str, dict[str, float]]) -> dict[str, tuple[float, float]]:
    """Each worker's admitted sequences and prefix-cache hits among them."""
    return {name: (metric(s, "dynamo_kv_prefix_cache_admitted_queries_total"),
                   metric(s, "dynamo_kv_prefix_cache_admitted_hits_total"))
            for name, s in samples.items()}


async def registered_workers(procs: dict, logs: Path) -> dict:
    """Each worker's id and status-server port, from its log once it
    serves."""
    workers = {}
    for name in ("worker_a", "worker_b"):
        m = await wait_for_log(logs / f"{name}.log",
                               r"torch aggregated worker (\d+) serving model", procs[name], 900)
        port = await wait_for_log(logs / f"{name}.log", r"status server on http://[^:]+:(\d+)",
                                  procs[name], 10)
        workers[name] = {"id": int(m.group(1)), "status_port": int(port.group(1))}
    return workers


async def check_health(s, base: str, model: str, workers: dict) -> None:
    """Wait until the frontend lists the model and its fleet aggregator
    has both workers' snapshots, then ``/health`` must answer 200 on the
    frontend and on each worker's status server."""
    deadline = time.time() + 120
    while True:
        async with s.get(f"{base}/v1/models") as r:
            models = [m["id"] for m in (await r.json())["data"]] if r.status == 200 else []
        async with s.get(f"{base}/metrics") as r:
            live = metric(metric_samples(await r.text()), "dynamo_obs_live_workers")
        if model in models and live == 2:
            break
        if time.time() > deadline:
            raise TimeoutError(f"frontend: models {models}, {live} live workers")
        await asyncio.sleep(0.5)
    health = {}
    for name, url in [(n, f"http://127.0.0.1:{w['status_port']}/health")
                      for n, w in workers.items()] + [("frontend", f"{base}/health")]:
        async with s.get(url) as r:
            health[name] = (r.status, (await r.json())["status"])
    if any(code != 200 for code, _ in health.values()):
        raise AssertionError(f"/health: {health}")
    print(f"frontend phase: /health {health}; worker ids and status ports "
          f"{ {n: (w['id'], w['status_port']) for n, w in workers.items()} }", flush=True)


async def check_routing(s, base: str, model: str, vocab: int, workers: dict) -> dict:
    """KV routing, unpinned and streamed (a streamed response frees its
    router load as it ends): a chat, then one sharing its first blocks,
    which must land on the worker holding them with cached tokens; then a
    fresh prompt sent while one worker decodes a long request, which must
    land on the other. Which worker admitted a request is read off the
    workers' ``/metrics``."""
    chat = f"{base}/v1/chat/completions"
    usage = {"stream_options": {"include_usage": True}, "max_tokens": 8, "temperature": 0.0}
    before = admitted(await worker_metrics(s, workers))
    first = await http_stream(s, chat, {"model": model, "messages": [
        {"role": "user", "content": ROUTE_SHARED_TEXT + "What is the first question?"}],
        **usage})
    mid = admitted(await worker_metrics(s, workers))
    (holder,) = [n for n in workers if mid[n][0] == before[n][0] + 1]
    await asyncio.sleep(ROUTE_SETTLE_S)
    second = await http_stream(s, chat, {"model": model, "messages": [
        {"role": "user", "content": ROUTE_SHARED_TEXT + "And which is the second one?"}],
        **usage})
    after = admitted(await worker_metrics(s, workers))
    cached = (second["usage"].get("prompt_tokens_details") or {}).get("cached_tokens", 0)
    other = next(n for n in workers if n != holder)
    if (after[holder] != (mid[holder][0] + 1, mid[holder][1] + 1) or after[other] != mid[other]
            or not cached or (first["usage"].get("prompt_tokens_details") or {}).get("cached_tokens")):
        raise AssertionError(f"shared prefix: holder {holder}, admitted (queries, hits) "
                             f"{before} -> {mid} -> {after}, cached_tokens {cached}")
    print(f"frontend routing: the shared-prefix chat landed on its holder {holder} "
          f"(worker {workers[holder]['id']}), cached_tokens {cached} of "
          f"{second['usage']['prompt_tokens']}, its admitted prefix hits "
          f"{mid[holder][1]:.0f} -> {after[holder][1]:.0f}", flush=True)

    rng = np.random.default_rng(77)
    long_prompt, fresh_prompt = ([int(t) for t in rng.integers(0, vocab, n)]
                                 for n in BUSY_PROMPT_LENS)
    url = f"{base}/v1/completions"
    greedy = {"temperature": 0.0}
    started = asyncio.Event()
    base_counts = admitted(await worker_metrics(s, workers))

    async def busy():
        async with s.post(url, json={**completion_body(model, long_prompt, greedy),
                                     "stream": True}) as resp:
            async for line in resp.content:
                if line.startswith(b"data: {"):
                    started.set()
        started.set()

    busy_task = asyncio.create_task(busy())
    await started.wait()
    busy_counts = admitted(await worker_metrics(s, workers))
    (busy_name,) = [n for n in workers if busy_counts[n][0] == base_counts[n][0] + 1]
    await http_stream(s, url, completion_body(model, fresh_prompt, greedy))
    fresh_counts = admitted(await worker_metrics(s, workers))
    await busy_task
    free_name = next(n for n in workers if n != busy_name)
    if (fresh_counts[free_name][0] != busy_counts[free_name][0] + 1
            or fresh_counts[busy_name][0] != busy_counts[busy_name][0]):
        raise AssertionError(f"busy routing: {busy_name} busy, admitted {busy_counts} -> "
                             f"{fresh_counts}")
    print(f"frontend routing: a fresh prompt sent while {busy_name} decoded a long one "
          f"landed on {free_name}; both workers served "
          f"{sum(1 for n in workers if fresh_counts[n][0] > 0)} of 2", flush=True)
    return {"requests": 4, "holder": holder, "cached_tokens": cached, "busy": busy_name,
            "fresh_to": free_name}


async def check_parity(s, base: str, model: str, pin: int, direct: dict, sampling: dict) -> int:
    """The worker phase's solo prompts, one at a time on worker ``pin``
    with its KV cache cleared, streamed, then again after a clear, not
    streamed: each held to the data-plane client's stream of the same
    request (:func:`held_to_direct`). Returns the requests sent."""
    url = f"{base}/v1/completions"
    by_rid = {r["rid"]: r for r in direct["solo"]}
    for stream in (True, False):
        cleared = await http_json(s, f"{base}/clear_kv_blocks", {})
        if len(cleared["cleared"][model]) != 2 or min(cleared["cleared"][model].values()) < 0:
            raise AssertionError(f"clear_kv_blocks: {cleared}")
        for rid in WORKER_SOLO:
            body = completion_body(model, direct["prompts"][rid], sampling[rid], pin)
            if stream:
                got = await http_stream(s, url, body)
            else:
                out = await http_json(s, url, body)
                lp = out["choices"][0]["logprobs"]
                got = {"logprobs": lp["token_logprobs"], "top_logprobs": lp["top_logprobs"],
                       "finish": out["choices"][0]["finish_reason"]}
                if out["usage"]["completion_tokens"] != len(got["logprobs"]):
                    raise AssertionError(f"{rid}: usage {out['usage']}")
            held_to_direct(rid, got, by_rid[rid])
    print(f"frontend parity: {len(WORKER_SOLO)} prompts, streamed and not, each "
          f"{MAX_TOKENS} tokens with the log-probabilities of the data-plane client's "
          f"stream, on worker {pin}", flush=True)
    return 2 * len(WORKER_SOLO)


async def direct_batch(store: str, pin: int, by_id: dict) -> list[dict]:
    """The solo prompts and then the 8 at once through the port's
    data-plane client, straight to worker ``pin`` (its cache cleared
    first): the same worker's figures without the frontend."""
    from dynamo_tpu_torch.runtime import DistributedRuntime

    rt = await DistributedRuntime.create(store)
    try:
        client = await rt.namespace("dynamo").component("backend").endpoint("generate").client()
        await client.wait_for_instances(2, timeout=30)

        async def open_stream(req):
            return await client.direct(pin, req)

        for rid in WORKER_SOLO:
            await timed_stream(open_stream, *by_id[rid])
        return await asyncio.wait_for(
            asyncio.gather(*(timed_stream(open_stream, *r) for r in by_id.values())), 600)
    finally:
        await rt.shutdown()


PEER_PROMPT_LEN = 64 * PAGE + 17  # 64 full blocks and a partial one


async def check_peer_pull(store: str, workers: dict, vocab: int) -> dict:
    """A peer pull between the two worker processes: a prompt nobody holds
    runs on worker_a, twice (the second a hit of its prefix cache), then
    goes straight to worker_b carrying the KV router's ``peer_prefix``
    hint at worker_a (what the router attaches when it routes a prompt
    away from the worker holding it). worker_b must pull the 64 full
    blocks over ``kv_fetch`` instead of recomputing them (cached tokens
    64 x 32), a sample of the pages must read the same on both workers,
    and worker_b must stream worker_a's cached run: both compute the
    prompt's last block over the same pages, so the streams are equal
    until that block fills (there worker_a's prefix cache hands the
    cached run the cold run's copy of the block, which rounded bf16
    otherwise); past it they may part at a near-tie only
    (:func:`hold_streams`)."""
    from dynamo_tpu_torch.runtime import DistributedRuntime
    from dynamo_tpu_torch.tokens import compute_seq_hashes

    prompt = [int(t) for t in np.random.default_rng(55).integers(0, vocab, PEER_PROMPT_LEN)]
    greedy = {"temperature": 0.0}
    a, b = workers["worker_a"]["id"], workers["worker_b"]["id"]
    rt = await DistributedRuntime.create(store)
    try:
        client = await rt.namespace("dynamo").component("backend").endpoint("generate").client()
        await client.wait_for_instances(2, timeout=30)

        def on(worker, hint=None):
            async def open_stream(req):
                if hint is not None:
                    req = {**req, "kv_transfer_params": {"peer_prefix": hint}}
                return await client.direct(worker, req)
            return open_stream

        runs = [await timed_stream(stream, "peer", prompt, greedy, logprobs=DISAGG_LOGPROBS)
                for stream in (on(a), on(a), on(b, {"worker_id": a,
                                                    "blocks": PEER_PROMPT_LEN // PAGE}))]
        cold, hit, pulled = runs
        fetch = await rt.namespace("dynamo").component("backend").endpoint("kv_fetch").client()
        await fetch.wait_for_instances(2, timeout=30)
        hashes = compute_seq_hashes(prompt, PAGE)
        pages_equal = {}
        for j in (0, len(hashes) // 2, len(hashes) - 1):
            got = [(await fetch_pages(fetch, w, [hashes[j]]))[0] for w in (a, b)]
            pages_equal[j] = len(got[0]) == len(got[1]) == 1 and got[0] == got[1]
    finally:
        await rt.shutdown()
    full = (PEER_PROMPT_LEN // PAGE) * PAGE
    exact = PAGE - PEER_PROMPT_LEN % PAGE  # tokens until the prompt's last block fills
    j = first_divergence(hit["tokens"], pulled["tokens"])
    if ((j is not None and j < exact) or not all(pages_equal.values())
            or (pulled["cached_tokens"], hit["cached_tokens"]) != (full, full)):
        raise AssertionError(f"peer pull: cached_tokens {pulled['cached_tokens']} and "
                             f"{hit['cached_tokens']} of {full}; pages equal {pages_equal}; "
                             f"parts from worker_a's cached run at token {j}")
    held = hold_streams("peer pull", [hit], [pulled], {"peer"})
    print(f"peer pull: worker_b took {full} prompt tokens from worker_a's cache, sampled pages "
          f"equal; TTFT {pulled['ttft_ms']:.1f} ms against worker_a's cold {cold['ttft_ms']:.1f} "
          f"ms and cached {hit['ttft_ms']:.1f} ms; stream equal to worker_a's cached run up to "
          f"token {len(pulled['tokens']) if j is None else j}", flush=True)
    return {"prompt_tokens": PEER_PROMPT_LEN, "cached_tokens": pulled["cached_tokens"],
            "cold_ttft_ms": cold["ttft_ms"], "cached_ttft_ms": hit["ttft_ms"],
            "pulled_ttft_ms": pulled["ttft_ms"], "pages_equal": len(pages_equal),
            "stream": held}


async def drive_frontend(base: str, store: str, model: str, vocab: int, procs: dict,
                         logs: Path, direct: dict) -> dict:
    """The frontend phase's traffic (see :func:`serve_frontend`)."""
    import aiohttp

    workers = await registered_workers(procs, logs)
    t_registered = time.time()
    reqs, late, _ = serving_requests(vocab)
    sampling = {rid: samp for rid, _, samp in reqs + [late]}
    pin = workers["worker_a"]["id"]
    async with aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=600)) as s:
        await check_health(s, base, model, workers)
        routing = await check_routing(s, base, model, vocab, workers)
        n_requests = routing.pop("requests") + await check_parity(
            s, base, model, pin, direct, sampling)

        # The worker phase's 8 requests at once, on the worker that holds
        # the solo prompts' blocks as the worker phase's worker did.
        cpu0 = proc_cpu_s(procs["frontend"].pid)
        batch = await asyncio.gather(*(
            http_stream(s, f"{base}/v1/completions",
                        completion_body(model, prompt, sampling[rid], pin))
            for rid, prompt in direct["prompts"].items()))
        frontend_cpu_s = proc_cpu_s(procs["frontend"].pid) - cpu0
        n_requests += len(batch)
        batch = dict(zip(direct["prompts"], batch))
        for rid, r in batch.items():
            if len(r["logprobs"]) != MAX_TOKENS or r["finish"] != "length":
                raise AssertionError(f"{rid}: {len(r['logprobs'])} tokens, finish {r['finish']}")
        streamed = sum(len(r["logprobs"]) for r in batch.values())

        # The same 8 from the same cache state through the data-plane
        # client, on the same worker.
        await http_json(s, f"{base}/clear_kv_blocks", {})
        same_worker = await direct_batch(store, pin, {r[0]: r for r in reqs + [late]})
        peer = await check_peer_pull(store, workers, vocab)

        # The frontend's own series, and each worker's under its worker_id.
        async with s.get(f"{base}/metrics") as r:
            front = metric_samples(await r.text())
        requests_total = metric(front, "dynamo_frontend_requests_total")
        per_worker = {n: metric(front, "dynamo_scheduler_megastep_k", f'worker_id="{w["id"]}"')
                      for n, w in workers.items()}
        if requests_total != n_requests or not all(per_worker.values()):
            raise AssertionError(f"frontend /metrics: {requests_total} requests counted of "
                                 f"{n_requests}; scheduler_megastep_k by worker {per_worker}")
        final = await worker_metrics(s, workers)
    return {"workers": workers, "registered_s": t_registered, "batch": batch,
            "same_worker_batch": {r["rid"]: r for r in same_worker},
            "frontend_cpu_ms_per_token": 1e3 * frontend_cpu_s / streamed,
            "streamed_tokens": streamed, "requests": n_requests, "worker_metrics": final,
            "routing": routing, "peer_pull": peer}


def serve_frontend(card: str, direct: dict, direct_stats: dict,
                   preset: str = "llama3-8b", device: str = "cuda") -> dict:
    """The port's whole serving stack, each part a process of its own and
    spoken to over HTTP: the store, two workers
    (``python -m dynamo_tpu_torch.backends.torch``, started together, each
    with its status server and obs snapshots on) and
    ``python -m dynamo_tpu_torch.frontend --router-mode kv``. It checks
    ``/health`` on all three; KV routing (a shared-prefix chat lands on
    the worker that holds the prefix, with cached tokens, and a fresh
    prompt sent while one worker is busy lands on the other); the worker
    phase's solo prompts as pre-tokenized completions, streamed and not,
    against the data-plane client's streams (``direct``: tokens, finish
    reasons, log-probabilities); its 8 requests at once, timed beside the
    same 8 from the same cache state through the data-plane client
    straight to the same worker, and beside the worker phase's; the
    frontend's request counters and each worker's
    series under its ``worker_id`` on the frontend's ``/metrics``; each
    worker's scheduler gauges against the counters it logs on exit; and
    K1's launches in each worker."""
    from dynamo_tpu_torch.engine.config import PRESETS
    from dynamo_tpu_torch.runtime.status_server import SCHEDULER_GAUGES

    cfg = PRESETS[preset]()
    logs = Path(tempfile.mkdtemp(prefix="chip_smoke_frontend_"))
    store_port, http_port = free_port(), free_port()
    env = {**os.environ, "DYN_STORE_ADDRESS": f"127.0.0.1:{store_port}"}
    t0 = time.time()
    procs: dict = {}
    files = {name: open(logs / f"{name}.log", "w")
             for name in ("store", "worker_a", "worker_b", "frontend")}
    try:
        procs["store"] = subprocess.Popen(
            [sys.executable, "-m", "dynamo_tpu_torch.runtime.store", "--port", str(store_port)],
            cwd=ROOT, stdout=files["store"], stderr=subprocess.STDOUT)
        wait_for_port(store_port, procs["store"], 30)
        # The frontend listens before the workers bind their ephemeral
        # ports, one of which could otherwise take the port chosen for it.
        procs["frontend"] = subprocess.Popen(
            [sys.executable, "-m", "dynamo_tpu_torch.frontend", "--http-host", "127.0.0.1",
             "--http-port", str(http_port), "--router-mode", "kv"],
            cwd=ROOT, stdout=files["frontend"], stderr=subprocess.STDOUT, env=env)
        wait_for_port(http_port, procs["frontend"], 60)
        for name in ("worker_a", "worker_b"):
            procs[name] = subprocess.Popen(
                [sys.executable, "-m", "dynamo_tpu_torch.backends.torch", "--model-name", preset,
                 "--preset", preset, "--seed", "0", "--device", device],
                cwd=ROOT, stdout=files[name], stderr=subprocess.STDOUT,
                env={**env, "DYN_SYSTEM_ENABLED": "1"})
        got = asyncio.run(drive_frontend(f"http://127.0.0.1:{http_port}",
                                         f"127.0.0.1:{store_port}", preset, cfg.vocab_size,
                                         procs, logs, direct))
        stats = {}
        for name in ("worker_a", "worker_b"):
            stop_process(procs[name])
            if procs[name].returncode != 0:
                raise AssertionError(f"{name} exited with {procs[name].returncode}")
            stats[name] = worker_stats(logs / f"{name}.log")
        stop_process(procs["frontend"])
        frontend_log = (logs / "frontend.log").read_text(errors="replace")
    except BaseException:
        for name in files:
            print(f"{name} log tail:\n{(logs / f'{name}.log').read_text(errors='replace')[-4000:]}",
                  file=sys.stderr)
        raise
    finally:
        for name, proc in procs.items():
            stop_process(proc, signal.SIGKILL if name != "store" else signal.SIGTERM, 10)
        for f in files.values():
            f.close()
    wall_s = time.time() - t0

    for name, st in stats.items():
        gauges = {key: metric(got["worker_metrics"][name], f"dynamo_{metric_name}")
                  for key, (metric_name, _) in SCHEDULER_GAUGES.items()}
        want = {key: float(st.get(key, 0) or 0) for key in SCHEDULER_GAUGES}
        if gauges != want:
            raise AssertionError(f"{name}: /metrics scheduler gauges {gauges}, counters {want}")
        if st["graph_captures"] != direct_stats["graph_captures"]:
            raise AssertionError(f"{name}: {st['graph_captures']} graphs captured, the worker "
                                 f"phase's worker {direct_stats['graph_captures']} (warm-up)")
        if (device == "cuda" and (
                st["attention_launches"] != cfg.num_layers * (st["forwards"] + st["warm_up_forwards"])
                or st["attention_launches_int8"] != 0)):
            raise AssertionError(f"{name}: K1 launches do not match its forwards: {st}")
    pool = stats["worker_b"]["kv_pool"]
    if (stats["worker_b"]["transfer"]["imported_blocks"] < PEER_PROMPT_LEN // PAGE
            or pool["pulls_succeeded"] < 1 or pool["pulls_fallback"]):
        raise AssertionError(f"worker_b's peer pull: {pool}, {stats['worker_b']['transfer']}")
    got["peer_pull"] |= {"pull_ms": pool["last_pull_ms"], "blocks_pulled": pool["blocks_pulled"],
                         "bytes_pulled": pool["bytes_pulled"]}
    print(f"peer pull: {pool['blocks_pulled']} blocks ({pool['bytes_pulled'] / 1e6:.1f} MB) in "
          f"{pool['last_pull_ms']:.1f} ms", flush=True)
    kernels = stats["worker_a"]["kernel_launches"]  # the worker that served the parity and batch
    if device == "cuda" and min(kernels[k] for k in ("ragged_paged_attention_decode_launch",
                                                     "ragged_paged_attention_tiled_launch")) == 0:
        raise AssertionError(f"worker_a launched a K1 kernel no time: {kernels}")
    tree = "python" if "native radix unavailable" in frontend_log else "native"
    decode_ms = {name: 1e3 * st["decode_loop_s"] / st["decode_iterations"]
                 for name, st in stats.items() if st["decode_iterations"]}
    decode_ms["worker_phase"] = 1e3 * direct_stats["decode_loop_s"] / direct_stats["decode_iterations"]
    phase_batch = {r["rid"]: r for r in direct["batch"]}
    same = got["same_worker_batch"]
    for rid, r in sorted(got["batch"].items()):
        d, w = same[rid], phase_batch[rid]
        print(f"frontend batch {rid}: TTFT HTTP {r['ttft_ms']:.1f} ms, direct to the same worker "
              f"{d['ttft_ms']:.1f} ms, the worker phase's {w['ttft_ms']:.1f} ms; ms per token "
              f"after the first {r['tpot_ms']:.2f}, {d['tpot_ms']:.2f}, {w['tpot_ms']:.2f}",
              flush=True)

    def median_tpot(runs) -> float:
        return float(np.median([r["tpot_ms"] for r in runs]))

    summary = {
        "radix_tree": tree,
        "wall_s": wall_s,
        "workers_registered_s": got["registered_s"] - t0,
        "routing": got["routing"],
        "peer_pull": got["peer_pull"],
        "requests": got["requests"],
        "batch_ttft_ms": {rid: r["ttft_ms"] for rid, r in got["batch"].items()},
        "batch_tpot_ms": {rid: r["tpot_ms"] for rid, r in got["batch"].items()},
        "batch_tpot_ms_median": median_tpot(got["batch"].values()),
        "same_worker_batch_ttft_ms": {rid: r["ttft_ms"] for rid, r in same.items()},
        "same_worker_batch_tpot_ms_median": median_tpot(same.values()),
        "worker_phase_batch_ttft_ms": {rid: r["ttft_ms"] for rid, r in phase_batch.items()},
        "worker_phase_batch_tpot_ms_median": median_tpot(phase_batch.values()),
        "frontend_cpu_ms_per_streamed_token": got["frontend_cpu_ms_per_token"],
        "streamed_tokens": got["streamed_tokens"],
        "decode_ms_per_iteration": decode_ms,
        "attention_launches": {n: st["attention_launches"] for n, st in stats.items()},
        "forwards": {n: st["forwards"] + st["warm_up_forwards"] for n, st in stats.items()},
        "graph_captures": {n: st["graph_captures"] for n, st in stats.items()},
        "kernel_launches": {n: st["kernel_launches"] for n, st in stats.items()},
    }
    print(f"frontend phase on {card}: radix tree {tree}; {got['requests']} HTTP requests; "
          f"8 at once, median ms per token after the first: HTTP "
          f"{summary['batch_tpot_ms_median']:.2f}, direct to the same worker "
          f"{summary['same_worker_batch_tpot_ms_median']:.2f}, the worker phase's "
          f"{summary['worker_phase_batch_tpot_ms_median']:.2f}; frontend CPU {summary['frontend_cpu_ms_per_streamed_token']:.4f} ms per "
          f"streamed token; decode ms per iteration {json.dumps(decode_ms)}; workers registered "
          f"after {summary['workers_registered_s']:.1f} s; phase wall {wall_s:.1f} s", flush=True)
    return summary


# -- disaggregated prefill and decode ------------------------------------------------

DISAGG_MODEL = "llama3-8b-disagg"
DISAGG_LOGPROBS = 2  # each token's top 2: the near-tie rule reads the gap between them
DISAGG_CHECKSUMMED = ("long", "mid", "short")  # prompts whose pages are checksummed on both sides
FETCH_WINDOW = 32    # blocks in the data-plane throughput window
DISAGG_FRESH_LEN = 1200  # the prompt sent through the frontend


def first_divergence(want: list[int], got: list[int]) -> int | None:
    return next((j for j, (a, b) in enumerate(zip(want, got)) if a != b),
                None if len(want) == len(got) else min(len(want), len(got)))


def hold_streams(name: str, agg: list[dict], dis: list[dict], greedy: set[str]) -> dict:
    """The disaggregated run's greedy streams against the aggregated
    worker's, under the near-tie rule (:func:`near_tie_streams`): the
    decode worker computes a prompt's last block with the tiled kernel
    where the aggregated worker decodes it."""
    def streams(records):
        return {r["rid"]: {"tokens": r["tokens"],
                           "logprobs": [e for o in r["outs"] for e in o.get("logprobs") or []]}
                for r in records if r["rid"] in greedy}

    want = streams(agg)
    return near_tie_streams(name, want, {rid: s for rid, s in streams(dis).items() if rid in want})


async def fetch_pages(client, worker_id: int, hashes: list[int]) -> tuple[list[bytes], dict]:
    """The pages a worker's ``kv_fetch`` endpoint serves for a hash chain,
    and the reply's geometry frame."""
    geometry, pages = {}, []
    async for frame in await client.direct(worker_id, {"hashes": hashes,
                                                       "chunk_blocks": len(hashes)}):
        if "shape" in frame:
            geometry = {"shape": frame["shape"], "dtype": frame["dtype"]}
        pages += [bytes(p) for p in frame.get("kv") or []]
    return pages, geometry


async def run_batches(store: str, namespace: str, component: str, worker_id: int,
                      by_id: dict, tag: str, clear_also=()) -> dict:
    """The serving requests through the port's data-plane client to one
    worker, all at once and then staggered, each run from cleared caches
    (the worker's, and those of ``clear_also``: (component, worker id)
    pairs). Request ids are unique over the phase, as a frontend makes
    them: a prefill worker keys its holds and chunk cursors by them."""
    from dynamo_tpu_torch.runtime import DistributedRuntime

    rt = await DistributedRuntime.create(store)
    try:
        ns = rt.namespace(namespace)
        clients = {c: await ns.component(c).endpoint("generate").client()
                   for c in {component, *(c for c, _ in clear_also)}}
        for c in clients.values():
            await c.wait_for_instances(1, timeout=60)

        async def clear():
            for c, w in [(component, worker_id), *clear_also]:
                async for _ in await clients[c].direct(
                        w, {"request_id": "clear", "clear_kv_blocks": True}):
                    pass

        runs = {}
        for kind in ("batch", "staggered"):
            async def open_stream(req, kind=kind):
                req = {**req, "request_id": f"{tag}-{kind}-{req['request_id']}"}
                return await clients[component].direct(worker_id, req)

            await clear()
            runs[kind] = await asyncio.wait_for(
                staggered_batch(open_stream, by_id, logprobs=DISAGG_LOGPROBS)
                if kind == "staggered" else asyncio.gather(
                    *(timed_stream(open_stream, *r, logprobs=DISAGG_LOGPROBS)
                      for r in by_id.values())), 600)
            for r in runs[kind]:
                if len(r["tokens"]) != MAX_TOKENS or r["finish"] != "length":
                    raise AssertionError(f"{tag} {kind} {r['rid']}: {len(r['tokens'])} tokens, "
                                         f"finish {r['finish']!r}")
        return runs
    finally:
        await rt.shutdown()


async def drive_disagg(store: str, base: str, procs: dict, logs: Path, vocab: int,
                       ids: dict, by_id: dict) -> dict:
    """The disaggregated half of the phase (see :func:`serve_disagg`)."""
    import hashlib

    import aiohttp

    from dynamo_tpu_torch.runtime import DistributedRuntime
    from dynamo_tpu_torch.tokens import compute_seq_hashes

    runs = await run_batches(store, "dynamo", "backend", ids["decode"], by_id, "disagg",
                             clear_also=[("prefill", ids["prefill"])])
    rt = await DistributedRuntime.create(store)
    try:
        # Every transferred page as the producer holds it: a sample of full
        # blocks of the last run's prompts (first, middle, last) read
        # through each side's kv_fetch endpoint.
        fetch = {
            "prefill": await rt.namespace("dynamo").component("prefill").endpoint(
                "kv_fetch").client(),
            "decode": await rt.namespace("dynamo").component("backend").endpoint(
                "kv_fetch").client(),
        }
        for c in fetch.values():
            await c.wait_for_instances(1, timeout=60)
        checksums = {}
        for rid in DISAGG_CHECKSUMMED:
            full = compute_seq_hashes(by_id[rid][1], PAGE)
            for j in sorted({0, len(full) // 2, len(full) - 1}):
                got = {}
                for side in ("prefill", "decode"):
                    pages, _ = await fetch_pages(fetch[side], ids[side], [full[j]])
                    if len(pages) != 1:
                        raise AssertionError(f"{side} holds no page for {rid} block {j}")
                    got[side] = hashlib.sha256(pages[0]).hexdigest()
                checksums[f"{rid}[{j}]"] = got
                if got["prefill"] != got["decode"]:
                    raise AssertionError(f"{rid} block {j}: prefill page {got['prefill']}, "
                                         f"decode page {got['decode']}")
        # The data plane's throughput for one page window, from the
        # prefill worker: its gather and landing included.
        window = compute_seq_hashes(by_id["long"][1], PAGE)[:FETCH_WINDOW]
        t0 = time.perf_counter()
        pages, geometry = await fetch_pages(fetch["prefill"], ids["prefill"], window)
        fetch_s = time.perf_counter() - t0
        if len(pages) != len(window):
            raise AssertionError(f"the prefill worker served {len(pages)} of {len(window)} pages")
        window_bytes = sum(len(p) for p in pages)
    finally:
        await rt.shutdown()

    # One request through the port's frontend: a prompt nobody holds, so
    # it prefills remotely.
    fresh = [int(t) for t in np.random.default_rng(99).integers(0, vocab, DISAGG_FRESH_LEN)]
    async with aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=600)) as s:
        deadline = time.time() + 120
        while True:
            async with s.get(f"{base}/v1/models") as r:
                models = {m["id"] for m in (await r.json())["data"]} if r.status == 200 else set()
            if DISAGG_MODEL in models:
                break
            if time.time() > deadline:
                raise TimeoutError(f"frontend models {models}")
            await asyncio.sleep(0.5)
        http = await http_stream(s, f"{base}/v1/completions", completion_body(
            DISAGG_MODEL, fresh, {"temperature": 0.0}))
        if len(http["logprobs"]) != MAX_TOKENS:
            raise AssertionError(f"over HTTP: {len(http['logprobs'])} tokens")
        async with s.get(f"http://127.0.0.1:{procs['decode_status']}/metrics") as r:
            gauges = metric_samples(await r.text())
    return {"runs": runs, "checksums": checksums,
            "fetch": {"blocks": len(pages), "bytes": window_bytes, "ms": 1e3 * fetch_s,
                      "geometry": geometry},
            "http": {"ttft_ms": http["ttft_ms"], "tpot_ms": http["tpot_ms"]},
            "gauges": {k: v for k, v in gauges.items() if k.startswith("dynamo_disagg_")
                       or k.startswith("dynamo_kv_pool_")}}


def serve_disagg(card: str, model_path: str, device: str = "cuda") -> dict:
    """Disaggregated prefill and decode through the port's processes, each
    worker serving the checkpoint at ``model_path`` (the smoke: llama3-8b's
    first ``DISAGG_LAYERS`` layers, at full width: the three workers'
    warm-ups run in turn on the card, and their graph pools fit it
    together). The port's
    frontend starts first; then an aggregated worker, a ``--role prefill``
    and a ``--role decode`` worker (model ``llama3-8b-disagg``) start and
    warm up together. Once all three serve, the aggregated worker runs the
    serving phase's 8 requests (100-2124 prompt tokens) through the
    data-plane client, all at once and staggered, each run from a cleared
    cache, while the other two idle, and stops. Then the prefill and the
    decode worker and the frontend run the same: every prompt is over the
    decode worker's default 50-token local limit. The decode worker's greedy streams must
    equal the aggregated worker's up to a measured near-tie
    (:func:`hold_streams`); a sample of pages must read the same bytes
    through the prefill and the decode worker's ``kv_fetch``; one fresh
    prompt goes through the frontend over HTTP. The decode worker must
    have imported blocks, with no local recompute, no failed pull and no
    dropped block. Prints TTFT and ms per token both ways, blocks, bytes
    and ms transferred per request and per block, the handoff's windows,
    the data plane's throughput for a 32-block window, and K1's launches
    in each worker."""
    from dynamo_tpu_torch.engine.loader import config_from_hf

    cfg = config_from_hf(model_path)
    reqs, late, _ = serving_requests(cfg.vocab_size)
    by_id = {r[0]: r for r in reqs + [late]}
    greedy = {rid for rid, _, samp in by_id.values() if samp.get("temperature") == 0.0}
    logs = Path(tempfile.mkdtemp(prefix="chip_smoke_disagg_"))
    store_port = free_port()
    store = f"127.0.0.1:{store_port}"
    env = {**os.environ, "DYN_STORE_ADDRESS": store}
    # The checkpoint has no tokenizer files: its workers name the byte
    # tokenizer they would fall back to, so neither they nor the frontend
    # first try a Hugging Face tokenizer there (~20 s each).
    worker = [sys.executable, "-m", "dynamo_tpu_torch.backends.torch", "--model-path", model_path,
              "--tokenizer", "byte", "--seed", "0", "--device", device, "--obs-publish", "off"]
    args = {
        "agg": ["--model-name", "llama3-8b-agg", "--namespace", "agg"],
        "prefill": ["--model-name", DISAGG_MODEL, "--role", "prefill"],
        "decode": ["--model-name", DISAGG_MODEL, "--role", "decode"],
    }
    t0 = time.time()
    procs: dict = {}
    files = {name: open(logs / f"{name}.log", "w")
             for name in ("store", "agg", "prefill", "decode", "frontend")}

    def start(name):
        wenv = {**env, "DYN_SYSTEM_ENABLED": "0"}
        if name == "decode":  # its status server, for the disaggregation gauges
            wenv = {**env, "DYN_SYSTEM_ENABLED": "1", "DYN_SYSTEM_PORT": str(status_port)}
        procs[name] = subprocess.Popen(worker + args[name], cwd=ROOT, stdout=files[name],
                                       stderr=subprocess.STDOUT, env=wenv)

    async def serving(names) -> dict[str, int]:
        role = {"agg": "aggregated", "prefill": "prefill", "decode": "decode"}
        return {n: int((await wait_for_log(logs / f"{n}.log",
                                           rf"torch {role[n]} worker (\d+) serving model",
                                           procs[n], 900)).group(1)) for n in names}

    def stop(name) -> dict:
        stop_process(procs[name])
        if procs[name].returncode != 0:
            raise AssertionError(f"{name} exited with {procs[name].returncode}")
        return worker_stats(logs / f"{name}.log")

    stats = {}
    try:
        procs["store"] = subprocess.Popen(
            [sys.executable, "-m", "dynamo_tpu_torch.runtime.store", "--port", str(store_port)],
            cwd=ROOT, stdout=files["store"], stderr=subprocess.STDOUT)
        wait_for_port(store_port, procs["store"], 30)
        # Ports chosen just before their servers bind them, and the
        # frontend listening before the workers bind their ephemeral ports.
        http_port, status_port = free_port(), free_port()
        procs["frontend"] = subprocess.Popen(
            [sys.executable, "-m", "dynamo_tpu_torch.frontend", "--http-host", "127.0.0.1",
             "--http-port", str(http_port), "--router-mode", "kv"],
            cwd=ROOT, stdout=files["frontend"], stderr=subprocess.STDOUT, env=env)
        wait_for_port(http_port, procs["frontend"], 60)
        t_start = time.time()
        for name in ("agg", "prefill", "decode"):
            start(name)
        procs["decode_status"] = status_port
        ids = asyncio.run(serving(["agg", "prefill", "decode"]))
        t_up = time.time()
        agg_runs = asyncio.run(run_batches(store, "agg", "backend", ids["agg"], by_id, "agg"))
        stats["agg"] = stop("agg")
        got = asyncio.run(drive_disagg(store, f"http://127.0.0.1:{http_port}", procs, logs,
                                       cfg.vocab_size, ids, by_id))
        for name in ("decode", "prefill"):
            stats[name] = stop(name)
        stop_process(procs["frontend"])
    except BaseException:
        for name in files:
            print(f"{name} log tail:\n{(logs / f'{name}.log').read_text(errors='replace')[-4000:]}",
                  file=sys.stderr)
        raise
    finally:
        for name, proc in procs.items():
            if not isinstance(proc, int):
                stop_process(proc, signal.SIGKILL if name != "store" else signal.SIGTERM, 10)
        for f in files.values():
            f.close()
    wall_s = time.time() - t0

    runs = {**{f"agg_{k}": v for k, v in agg_runs.items()},
            **{f"disagg_{k}": v for k, v in got["runs"].items()}}
    held = {kind: hold_streams(kind, runs[f"agg_{kind}"], runs[f"disagg_{kind}"], greedy)
            for kind in ("batch", "staggered")}
    d = stats["decode"]
    dis, pool, xfer = d["disagg"], d["kv_pool"], d["transfer"]
    remote = dis["remote_prefills"]
    # The happy path: blocks imported, no request recomputed locally, no
    # pull failed (a window pull, or the reply-gated pull a handoff whose
    # cursor came after the prefill's reply takes), none dropped.
    if (xfer["imported_blocks"] == 0 or dis["recompute_fallbacks"] or pool["pulls_fallback"]
            or dis["handoffs_fallback"] or xfer["dropped_blocks"]
            or remote + dis["local_prefills"] != 2 * len(by_id) + 1):
        raise AssertionError(f"the decode worker's transfers: {dis}, {pool}, {xfer}")
    for name, st in stats.items():
        kernels = st["kernel_launches"]
        if device == "cuda" and (
                st["attention_launches"] != cfg.num_layers * (st["forwards"] + st["warm_up_forwards"])
                or min(kernels[k] for k in ("ragged_paged_attention_decode_launch",
                                            "ragged_paged_attention_tiled_launch")) == 0):
            raise AssertionError(f"{name}: K1 launches {kernels} for {st['forwards']} forwards "
                                 f"and {st['warm_up_forwards']} at warm-up")

    def col(key, field):
        return {r["rid"]: r[field] for r in runs[key]}

    def median(key, field):
        return float(np.median([r[field] for r in runs[key]]))

    blocks = pool["blocks_pulled"]
    summary = {
        "wall_s": wall_s, "workers_up_s": t_up - t_start,
        "streams": held, "checksums": got["checksums"],
        "ttft_ms": {k: col(k, "ttft_ms") for k in runs},
        "tpot_ms": {k: col(k, "tpot_ms") for k in runs},
        "ttft_ms_median": {k: median(k, "ttft_ms") for k in runs},
        "tpot_ms_median": {k: median(k, "tpot_ms") for k in runs},
        "remote_prefills": remote, "local_prefills": dis["local_prefills"],
        # A handoff that did not stream took the reply-gated pull.
        "reply_gated_pulls": remote - dis["handoffs_streamed"],
        "imported_blocks": xfer["imported_blocks"],
        "blocks_per_request": xfer["imported_blocks"] / remote,
        "bytes_per_request": pool["bytes_pulled"] / remote,
        # Summed over the windows, which overlap across concurrent requests.
        "transfer_ms_per_request": pool["pull_ms_total"] / remote,
        "transfer_ms_per_block": pool["pull_ms_total"] / blocks if blocks else None,
        "handoff": {k: dis[k] for k in ("handoffs_started", "handoffs_streamed",
                                        "handoffs_fallback", "chunks_pulled", "early_chunks",
                                        "blocks_streamed", "cursor_timeouts")},
        "decode_worker": {"disagg": dis, "kv_pool": pool, "transfer": xfer},
        "fetch_window": got["fetch"],
        "fetch_window_gb_per_s": got["fetch"]["bytes"] / got["fetch"]["ms"] / 1e6,
        "http": got["http"], "decode_gauges": got["gauges"],
        "kernel_launches": {n: st["kernel_launches"] for n, st in stats.items()},
        "forwards": {n: st["forwards"] + st["warm_up_forwards"] for n, st in stats.items()},
        "decode_ms_per_iteration": {n: 1e3 * st["decode_loop_s"] / st["decode_iterations"]
                                    for n, st in stats.items() if st["decode_iterations"]},
    }
    for kind in ("batch", "staggered"):
        for rid in sorted(summary["ttft_ms"][f"agg_{kind}"]):
            print(f"disagg {kind} {rid}: TTFT aggregated "
                  f"{summary['ttft_ms'][f'agg_{kind}'][rid]:.1f} ms, disaggregated "
                  f"{summary['ttft_ms'][f'disagg_{kind}'][rid]:.1f} ms; ms per token after the "
                  f"first {summary['tpot_ms'][f'agg_{kind}'][rid]:.2f} vs "
                  f"{summary['tpot_ms'][f'disagg_{kind}'][rid]:.2f}", flush=True)
    print(f"disagg phase on {card}: {remote} remote prefills ({summary['reply_gated_pulls']} by "
          f"the reply-gated pull), {xfer['imported_blocks']} blocks imported "
          f"({summary['blocks_per_request']:.1f} per request, "
          f"{summary['bytes_per_request'] / 1e6:.1f} MB), transfer "
          f"{summary['transfer_ms_per_request']:.1f} ms per request, "
          f"{summary['transfer_ms_per_block'] or 0:.3f} ms per block; handoff "
          f"{summary['handoff']}; greedy streams equal {held['batch']['equal']}/"
          f"{held['batch']['streams']} at once, {held['staggered']['equal']}/"
          f"{held['staggered']['streams']} staggered; {len(got['checksums'])} pages equal on "
          f"both sides; data plane {got['fetch']['blocks']} pages in {got['fetch']['ms']:.1f} ms "
          f"({summary['fetch_window_gb_per_s']:.2f} GB/s); over HTTP TTFT "
          f"{got['http']['ttft_ms']:.1f} ms; K1 launches by worker "
          f"{json.dumps(summary['kernel_launches'])}; the three workers up after "
          f"{summary['workers_up_s']:.1f} s, phase wall {wall_s:.1f} s", flush=True)
    return summary


# -- the doctor and the single-command runner (subprocesses) --------------------


def doctor_phase(device: str = "cuda") -> dict:
    """``python -m dynamo_tpu_torch.check`` against a port store this phase
    runs: every line printed, exit 0, the store line reached, and (on the
    card) the engine line's K1 launches above 0."""
    logs = Path(tempfile.mkdtemp(prefix="chip_smoke_doctor_"))
    port = free_port()
    with open(logs / "store.log", "w") as store_log:
        store = subprocess.Popen(
            [sys.executable, "-m", "dynamo_tpu_torch.runtime.store", "--port", str(port)],
            cwd=ROOT, stdout=store_log, stderr=subprocess.STDOUT)
        try:
            wait_for_port(port, store, 30)
            t0 = time.time()
            proc = subprocess.run(
                [sys.executable, "-m", "dynamo_tpu_torch.check", "--device", device,
                 "--store-address", f"127.0.0.1:{port}"],
                cwd=ROOT, capture_output=True, text=True, timeout=300)
            wall_s = time.time() - t0
        finally:
            stop_process(store, signal.SIGTERM, 10)
    shutil.rmtree(logs, ignore_errors=True)
    lines = proc.stdout.splitlines()
    for line in lines:
        print(f"doctor: {line}", flush=True)
    engine = next((ln for ln in lines if "engine smoke" in ln), "")
    m = re.search(r"K1 launches (\d+)", engine)
    launches = int(m.group(1)) if m else 0
    print(f"doctor: exit {proc.returncode} in {wall_s:.1f} s; engine line's K1 launches "
          f"{launches}", flush=True)
    if (proc.returncode != 0 or not engine.startswith("[ok ]")
            or not any(ln.startswith("[ok ] store — 127.0.0.1") for ln in lines)
            or (device == "cuda" and launches < 1)):
        raise AssertionError(f"the doctor failed (exit {proc.returncode}):\n{proc.stdout}"
                             f"{proc.stderr[-4000:]}")
    return {"exit": proc.returncode, "lines": len(lines), "engine_k1_launches": launches,
            "wall_s": wall_s}


def runner_prompts() -> list[str]:
    """The worker phase's 8 prompts as chat text of the same lengths (the
    runner takes text; a prompt of n lowercase letters and spaces is n
    tokens of the byte tokenizer, before the chat template)."""
    reqs, late, _ = serving_requests(1 << 17)
    rng = np.random.default_rng(1234)
    alphabet = np.array(list("abcdefghijklmnopqrstuvwxyz     "))
    return ["".join(rng.choice(alphabet, len(p))) for _, p, _ in reqs + [late]]


def start_runner(args: list[str], logs: Path, name: str,
                 served_pattern: str | None = None) -> dict:
    """Start one ``python -m dynamo_tpu_torch.run`` process, its errors
    (the log) in ``logs``; with ``served_pattern``, a thread notes the
    seconds from its start to the first log line that matches it."""
    h = {"name": name, "log": logs / f"{name}.log", "t0": time.time(), "out": [],
         "served_after_s": None}
    h["log_f"] = open(h["log"], "w")
    h["proc"] = subprocess.Popen([sys.executable, "-m", "dynamo_tpu_torch.run", *args], cwd=ROOT,
                                 stdout=subprocess.PIPE, stderr=h["log_f"], text=True)
    h["reader"] = threading.Thread(target=lambda: h["out"].extend(h["proc"].stdout), daemon=True)
    h["reader"].start()

    def watch():
        while h["proc"].poll() is None and h["served_after_s"] is None:
            if re.search(served_pattern, h["log"].read_text()):
                h["served_after_s"] = time.time() - h["t0"]
            time.sleep(0.2)

    if served_pattern:
        threading.Thread(target=watch, daemon=True).start()
    return h


def finish_runner(h: dict, timeout: float) -> dict:
    """Wait for a :func:`start_runner` process to exit 0 within ``timeout``
    seconds of its start; its standard output, wall seconds and start-up."""
    proc, name = h["proc"], h["name"]
    try:
        proc.wait(max(1.0, timeout - (time.time() - h["t0"])))
    except BaseException:
        stop_process(proc, signal.SIGKILL, 10)
        print(f"runner {name} log tail:\n{h['log'].read_text()[-6000:]}", file=sys.stderr)
        raise
    finally:
        h["reader"].join(10)
        h["log_f"].close()
    wall_s = time.time() - h["t0"]
    if proc.returncode != 0:
        raise AssertionError(f"runner {name} exited with {proc.returncode}:\n"
                             f"{h['log'].read_text()[-6000:]}")
    return {"stdout": "".join(h["out"]), "wall_s": wall_s,
            "served_after_s": h["served_after_s"], "log": h["log"]}


def doctor_and_runner(card: str, device: str = "cuda", preset: str = "llama3-8b") -> dict:
    """``python -m dynamo_tpu_torch.run --in batch --out torch --preset
    llama3-8b`` (at full width and depth, its worker warmed up as a
    default worker) on the worker phase's 8 prompts as text, 64 tokens
    each; while its worker builds and warms up, ``--in batch --out echo``,
    ``--in text --out mocker --speedup-ratio 100`` and the doctor
    (:func:`doctor_phase`) run beside it. Each runner exits 0 with one
    completion per prompt; the torch run's worker start-up is split into
    its engine's build and warm-up (its own log line) and the rest, and
    its exit counters show K1's two kernels launched once per layer of
    every forward."""
    from dynamo_tpu_torch.engine.config import PRESETS

    logs = Path(tempfile.mkdtemp(prefix="chip_smoke_runner_"))
    h = None
    try:
        prompts = runner_prompts()
        inp = logs / "prompts.jsonl"
        inp.write_text("".join(json.dumps({"prompt": p}) + "\n" for p in prompts))
        res = {}

        def batch_args(name, out_args):
            return ["--in", "batch", *out_args, "--input", str(inp), "--output",
                    str(logs / f"{name}.jsonl"), "--max-tokens", str(MAX_TOKENS)]

        def completions(name):
            # A request the frontend failed still writes a row, its
            # completion "[error] <message>".
            rows = [json.loads(ln) for ln in (logs / f"{name}.jsonl").read_text().splitlines()]
            if [row["prompt"] for row in rows] != prompts or not all(
                    isinstance(row.get("completion"), str) for row in rows):
                raise AssertionError(f"runner {name}: {len(rows)} completions for "
                                     f"{len(prompts)} prompts")
            failed = [row["completion"] for row in rows if row["completion"].startswith("[error]")]
            if failed:
                raise AssertionError(f"runner {name}: {len(failed)} requests failed: {failed[:2]}")
            return rows

        # The torch worker builds and warms up while the echo and mocker
        # runs and the doctor run (one after another would add their ~13 s).
        h = start_runner(batch_args("worker", ["--out", "torch", "--preset", preset,
                                               "--device", device]),
                         logs, "worker", r"serving model")
        with ThreadPoolExecutor(3) as pool:
            echo_f = pool.submit(lambda: finish_runner(start_runner(
                batch_args("echo", ["--out", "echo"]), logs, "echo"), 120))
            mock_f = pool.submit(lambda: finish_runner(start_runner(
                ["--in", "text", "--out", "mocker", "--speedup-ratio", "100",
                 "--prompt", prompts[2], "--max-tokens", "16"], logs, "mocker"), 120))
            doctor_f = pool.submit(doctor_phase, device)
            echo, mock, res["doctor"] = echo_f.result(), mock_f.result(), doctor_f.result()
        if not all(row["completion"].startswith("<|user|>") for row in completions("echo")):
            raise AssertionError("runner echo: a completion is not its prompt echoed")
        res["echo"] = {"wall_s": echo["wall_s"], "completions": len(prompts)}
        if mock["stdout"].strip() != "abcdefghijklmnop":
            raise AssertionError(f"runner mocker answered {mock['stdout']!r}")
        res["mocker"] = {"wall_s": mock["wall_s"], "completions": 1}
        torch_run = finish_runner(h, 900)
        h = None
        rows = completions("worker")
        if torch_run["served_after_s"] is None:
            raise AssertionError(f"runner torch logged no serving line:\n"
                                 f"{torch_run['log'].read_text()[-4000:]}")
        built = worker_build_s({"logs": logs, "args": ["--out", "torch"]})
        stats = worker_stats(torch_run["log"])
        cfg = PRESETS[preset]()
        kernels = stats["kernel_launches"]
        # Warm-up alone launches both K1 kernels: the traffic must have
        # run forwards of its own and committed a token for every prompt.
        if stats["forwards"] == 0 or stats["committed_tokens"] < len(prompts):
            raise AssertionError(f"the runner's worker served no traffic: {stats['forwards']} "
                                 f"forwards, {stats['committed_tokens']} tokens committed for "
                                 f"{len(prompts)} prompts")
        if device == "cuda" and (
                stats["attention_launches"]
                != cfg.num_layers * (stats["forwards"] + stats["warm_up_forwards"])
                or min(kernels[k] for k in ("ragged_paged_attention_decode_launch",
                                            "ragged_paged_attention_tiled_launch")) == 0):
            raise AssertionError(f"the runner's worker: K1 launches do not match its "
                                 f"forwards: {stats}")
        build_s, warm_s = built["build_s"], built["warm_up_s"]
        served = torch_run["served_after_s"]
        res["torch"] = {
            "wall_s": torch_run["wall_s"], "completions": len(rows), "served_after_s": served,
            "build_s": build_s, "warm_up_s": warm_s, "rest_s": served - build_s - warm_s,
            "forwards": stats["forwards"], "warm_up_forwards": stats["warm_up_forwards"],
            "committed_tokens": stats["committed_tokens"],
            "attention_launches": stats["attention_launches"], "kernel_launches": kernels,
            "graph_captures": stats["graph_captures"],
        }
        t = res["torch"]
        print(f"runner on {card}: echo {len(prompts)} completions in {echo['wall_s']:.1f} s; "
              f"mocker {mock['stdout'].strip()!r} in {mock['wall_s']:.1f} s; torch --preset "
              f"{preset}: {t['completions']} completions of {MAX_TOKENS} tokens at most "
              f"({t['committed_tokens']} tokens committed) in {t['wall_s']:.1f} s; its worker served after {served:.1f} s (engine built in "
              f"{build_s:.2f} s, warmed up in {warm_s:.2f} s, the rest {t['rest_s']:.1f} s; the "
              f"echo and mocker runs and the doctor ran meanwhile); K1 launches {kernels} = "
              f"{cfg.num_layers} x ({t['forwards']} forwards + {t['warm_up_forwards']} at "
              f"warm-up); graph captures {t['graph_captures']}", flush=True)
        return res
    finally:
        if h is not None:
            stop_process(h["proc"], signal.SIGKILL, 10)
            h["log_f"].close()
        shutil.rmtree(logs, ignore_errors=True)


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
    t_start = time.time()
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

    def lap(phase: str) -> None:  # the smoke's wall clock at each phase's end
        print(f"timeline: {phase} done at {time.time() - t_start:.1f} s", flush=True)

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
        t0 = time.time()
        qwen_shapes, qwen_faults = check_qwen2_attention(ra, planted)
        shapes += qwen_shapes
        print(f"K1 at Qwen2-7B's geometry (28/4 heads), with the planted faults: "
              f"{time.time() - t0:.1f} s", flush=True)
        k2_shapes, k2_batches = check_paged_attention_kernel(pa)
        k2_faults = check_k2_planted_faults(pa, k2_batches, planted)
        del k2_batches
        torch.cuda.empty_cache()
    lap("kernel build and checks")

    k2 = k2_path(pa)
    lap("K2 path")
    counts, summary, reference = serve(ra, card)
    ck = reference[2]  # the worker phase's checkpoints, deleted whatever happens
    try:
        lap("bf16 serving, chunked, speculation, tiers, multimodal and the worker reference")
        print(f"serving summary: {json.dumps(summary)}", flush=True)
        # K1 at the mixed steps' shapes joins its bf16 records; the chunked
        # path's launches (chunked scheduling at the defaults, sync) join its
        # bf16 entries.
        shapes += summary["chunked"]["shapes"]
        chunked_counts = next(t for t in summary["chunked"]["traffic"]
                              if t["setting"] == "chunked" and not t["async_exec"])["launches_by_kernel"]
        # K1 at the verify shapes joins them too; the speculation runs'
        # launches (sync, host and device drafting) join its bf16 entries.
        shapes += summary["spec"]["shapes"]
        spec_counts = {t["run"]: t["launches_by_kernel"] for t in summary["spec"]["traffic"]
                       if not t["run"].endswith("off") and not t["async_exec"]}
        gc.collect()
        torch.cuda.empty_cache()
        print(f"bf16 engine freed: allocated {torch.cuda.memory_allocated() / 1e9:.2f} GB", flush=True)
        counts8, summary8, _ = serve(ra, card, int8=True)
        lap("int8 serving")
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
        print(f"llama3-8b engines freed: {memory_line()}", flush=True)
        moe = serve_moe(ra, card)
        lap("MoE")
        print(f"MoE summary: {json.dumps(moe)}", flush=True)
        gc.collect()
        torch.cuda.empty_cache()
        qwen = serve_qwen2(ra, card)
        lap("Qwen2")
        print(f"Qwen2 summary: {json.dumps(qwen)}", flush=True)
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.time()
            gguf = gguf_round_trip(tmp)
            print(f"GGUF summary: {json.dumps(gguf)} in {time.time() - t0:.2f} s", flush=True)
        worker_summary, direct, direct_stats = serve_worker(card, reference)
        lap("GGUF and worker")
        print(f"worker summary: {json.dumps(worker_summary)}", flush=True)
        gc.collect()
        torch.cuda.empty_cache()
        frontend = serve_frontend(card, direct, direct_stats)
        lap("frontend")
        print(f"frontend summary: {json.dumps(frontend)}", flush=True)
        gc.collect()
        torch.cuda.empty_cache()
        print(f"before the disaggregation phase: {memory_line()}", flush=True)
        disagg = serve_disagg(card, ck["cut"]["dir"])
        lap("disaggregation")
        print(f"disagg summary: {json.dumps(disagg)}", flush=True)
        runner = doctor_and_runner(card)
        lap("doctor and runner")
        print(f"doctor and runner summary: {json.dumps(runner)}", flush=True)

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
                # The frontend phase's two workers, warm-up included (their
                # processes start with the counts at 0).
                extra["frontend_phase_launches"] = sum(
                    w[name] for w in frontend["kernel_launches"].values())
                # The disaggregation phase's three workers, warm-up included.
                extra["disagg_phase_launches"] = {
                    role: w[name] for role, w in disagg["kernel_launches"].items()}
                if not int8:
                    extra["chunked_path_launches"] = chunked_counts[name]
                    extra["tier_path_launches"] = summary["tiers"]["kernel_launches"].get(name, 0)
                    extra["spec_path_launches"] = {run: c[name] for run, c in spec_counts.items()}
                    extra["moe_path_launches"] = moe["launches"].get(name, 0)
                    extra["qwen2_path_launches"] = qwen["launches"].get(name, 0)
                    extra["qwen2_planted_faults_row_rel_err"] = {
                        f: qwen_faults[f] for f in table[kernel]}
                    extra["embed_path_launches"] = summary["mm"]["embed"]["launches"].get(name, 0)
                    extra["image_path_launches"] = summary["mm"]["images"]["launches"].get(name, 0)
                # The runner's worker (--out torch --preset llama3-8b), warm-up included.
                extra["runner_phase_launches"] = runner["torch"]["kernel_launches"][name]
                k1.append(kernel_entry(
                    name, k1_src, "dynamo_tpu/ops/ragged_attention.py:163", counts_of[name], own,
                    main_rec, pages="int8" if int8 else "bf16", **extra,
                    planted_faults_row_rel_err={f: planted_of[f] for f in table[kernel]},
                ))
        print(f"smoke wall {time.time() - t_start:.1f} s", flush=True)
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
    finally:
        shutil.rmtree(ck["dir"], ignore_errors=True)
        shutil.rmtree(ck["cut"]["dir"], ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
