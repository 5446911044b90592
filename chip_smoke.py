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
the planted faults) and K1's head_dim-64 instances (Llama-3.2-1B's 32/8
heads of 64: the serving decode form, the 8192 wave and a 2048 mixed
step with bf16 pages, the decode form with int8 pages; Qwen2.5-0.5B's
14/2: the decode form and a 2048 wave; each with the planted faults) and
K1's generic instance (``csrc/ragged_paged_attention_generic.cu``, the
models the fast instances do not take; :func:`check_generic_attention`:
f32 at the tiny presets' 4/2 heads of 16 within 1e-5, fp16 at llama3-8b's,
bf16 at Falcon3-7B's 12/4 of 256, at groups of 12 and 16 and at head_dim
96, int8 pages beside them; five planted faults), (4) runs K2's own path, that
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
phase (:func:`serve_moe`: ``MOE_LAYERS`` of Mixtral-8x7B's 32 layers at full width,
bf16, one layer's MoE MLP against its f32 CPU version, warm-up, 8
prompts in one wave with TTFT and decode ms beside their bounds, K1 at
``MOE_LAYERS`` launches per forward, graph against eager with tokens and
log-probabilities equal, the idle share, a chunked mixed step), the EP
phase (:func:`serve_ep`: those layers by a ``--tp 2`` worker, its
experts split over two ranks on the one card, a solo stream bit for bit
an in-process tp = 2 engine's, both dispatch modes' logits compared by
two side ranks), then Qwen2-7B at full width, 4 of
its 28 layers (:func:`serve_qwen2`: greedy streams, the weights written
as a ``qwen2`` checkpoint and loaded back, every leaf equal, the same
streams from the loaded engine) and a GGUF file written and read back
(:func:`gguf_round_trip`: F32, F16 and BF16 tensors, the config, the
tokenizer), then Llama-3.2-1B's published shape at full width and depth
from a checkpoint of seeded weights (:func:`serve_llama32_1b`: 16 K1
launches per forward, all head_dim-64 instances, inside graph replays,
logits and greedy streams against the same engine with the plain
attention), the f32 tiny presets through K1's generic instance
(:func:`serve_f32_presets`: ``tiny`` at the defaults, chunked, n-gram
speculation and int8 KV, and ``tiny-moe``, each after ``warm_up()``
against the same engine on the CPU: logits within 1e-4, streams up to
near-ties, every dispatch a graph replay), Falcon3-7B's and
Mistral-Large-2's published shapes and llama3-8b's at fp16
(:func:`serve_generic_shapes`: one generic launch per layer per forward in
graph replays, logits and streams against the plain attention) and the
port's SLA profiler (:func:`sla_profile`: ``python -m
dynamo_tpu_torch.tools.profile_sla --preset llama3-1b``, its profile
loaded by the port's planner), then the tp, pipeline and sp phases (:func:`serve_tp`,
:func:`serve_pipeline`, :func:`serve_sp`: the main path's first 4 layers
from a checkpoint by ``--tp 2``, ``--pp 2`` and ``--dp 2`` workers, all
32 by ``--sp 2`` ones, both ranks on the one card, streams and one prompt's logits
held to the tp = 1 engine's), (6) runs the worker process:
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
dynamo_tpu_torch.run --out torch`` with no ``--preset`` and no
``--device``, the f32 ``tiny`` preset on the card, on 8 prompts as text, ``--out echo``,
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
import contextlib
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
BF16_OPS_PER_S = 989e12     # H100 SXM dense bf16 (and fp16) tensor-core peak
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


def timed_once(fn):
    """``fn()`` and its device time in ms (CUDA events around the one
    call, after a flush of the L2 as in :func:`cold_ms`)."""
    if not _FLUSH:
        _FLUSH.append(torch.empty(256 << 20, dtype=torch.uint8, device="cuda"))
    _FLUSH[0].add_(1)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


# -- kernel against its plain version --------------------------------------

def compare(got, want, n_real: int, tol: float = ROW_REL_TOL) -> tuple[float, float, bool]:
    """(largest relative L2 error of an output vector, largest absolute
    error, ok): ok when the first is within ``tol`` and every padded row
    past the ``n_real`` real ones is zero."""
    g, w = got[:n_real].float(), want[:n_real].float()
    rel = ((g - w).norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-12)).max().item()
    err = (got.float() - want.float()).abs().max().item()
    return rel, err, rel <= tol and not got[n_real:].any().item()


def attention_batch(q_lens, kv_lens, S, pages_per_seq, T, gen, n_q=N_Q, n_kv=N_KV, d=HEAD_DIM,
                    dtype=torch.bfloat16, page=PAGE):
    """Ragged operands on the card at head_dim ``d``, q and pages in
    ``dtype``, ``page`` positions a page: sequence s owns q rows cu[s]..cu[s+1]-1
    and its own pages; rows past cu[num_seqs] and table entries past a
    sequence's pages point at the garbage page. Returns the positional
    operands and the keyword ones (none for pages of q's type)."""
    dev = "cuda"
    n_pages = sum(-(-L // page) for L in kv_lens) + 1
    q = torch.randn(T, n_q, d, device=dev, generator=gen).bfloat16().to(dtype)
    kv = torch.randn(n_pages, page, 2 * n_kv, d, device=dev, generator=gen).bfloat16().to(dtype)
    perm = torch.randperm(n_pages - 1, device=dev, generator=gen).to(torch.int32)
    tables = torch.full((S, pages_per_seq), n_pages - 1, dtype=torch.int32, device=dev)
    off = 0
    for s, L in enumerate(kv_lens):
        npg = -(-L // page)
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


def attention_bound(q_lens, kv_lens, T, int8=False, n_q=N_Q, n_kv=N_KV, d=HEAD_DIM,
                    itemsize=2, ops_per_s=BF16_OPS_PER_S, page=PAGE):
    """Least time for this call's work: each input byte the data needs
    read once (q rows, the visible K/V rows and, for int8 pages, their
    scales, the table entries in use), the output written once; operations
    4 * visible positions * n_q * d (QK^T and PV, a multiply-add counted
    as 2) over ``ops_per_s``, the card's peak for q's type (the bf16
    tensor cores' by default). q, out and pages of q's type have
    ``itemsize`` bytes an element."""
    kv_rows = sum(kv_lens)
    pages = sum(-(-L // page) for L in kv_lens)
    row_bytes = d + SCALE_BYTES if int8 else d * itemsize
    nbytes = (
        sum(q_lens) * n_q * d * itemsize        # q
        + kv_rows * 2 * n_kv * row_bytes        # K and V rows (+ scales)
        + T * n_q * d * itemsize                # out
        + 4 * (pages + 2 * len(kv_lens) + 2)    # tables, kv_lens, cu, num_seqs
    )
    visible = sum(
        min(L - q + i + 1, L) for q, L in zip(q_lens, kv_lens) for i in range(q)
    )
    ops = 4 * visible * n_q * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


K1_KERNELS = ("decode", "tiled")


def sdpa_yardstick(args, kw, q_lens, kv_lens):
    """A yardstick of a different function: dense causal
    ``scaled_dot_product_attention`` on the same rows with each sequence's
    K/V laid out contiguously (in q's type; int8 pages dequantized; kv heads
    repeated for the group). A decode batch is one call, padded to the
    longest row with a key mask; other batches one call per sequence
    (``is_causal`` where q_len == kv_len, a lower-right mask otherwise).
    Returns the call to time. The port never calls it."""
    from dynamo_tpu_torch.engine.kv_quant import dequantize_kv

    F = torch.nn.functional
    q, kv, _, tables, cu, _ = args
    n_q, n_kv, d, page = q.shape[1], kv.shape[2] // 2, q.shape[2], kv.shape[1]
    group = n_q // n_kv
    cu_h = cu.tolist()

    def contiguous(s, L):
        pos = torch.arange(L, device=q.device)
        slots = tables[s].long()[pos // page] * page + pos % page
        rows = kv.reshape(-1, 2 * n_kv, d)[slots]
        if "kv_scales" in kw:
            rows = dequantize_kv(rows, kw["kv_scales"].reshape(-1, 2 * n_kv)[slots]).to(q.dtype)
        k, v = (rows[:, i::2].repeat_interleave(group, dim=1).transpose(0, 1) for i in (0, 1))
        return k, v                                                    # [n_q, L, d]

    if all(n == 1 for n in q_lens):
        B, L = len(q_lens), max(kv_lens)
        k = torch.zeros(B, n_q, L, d, dtype=q.dtype, device=q.device)
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


def hold_k1(ra, name, args, kw, want, q_lens, kv_lens, T, int8, reps, plain_ms, tag,
            kernels=K1_KERNELS, tol=ROW_REL_TOL, ops_per_s=BF16_OPS_PER_S):
    """``kernels`` (both K1 kernels by default), forced, on one batch
    against the plain output ``want`` within ``tol``, each timed with the
    L2 flushed; the yardstick beside them; the bound at ``ops_per_s``.
    Raises if one disagrees."""
    n_q, n_kv, d = args[0].shape[1], args[1].shape[2] // 2, args[0].shape[2]
    scale = d ** -0.5
    bound_ms, bound_by = attention_bound(q_lens, kv_lens, T, int8, n_q, n_kv, d,
                                         itemsize=args[0].element_size(), ops_per_s=ops_per_s,
                                         page=args[1].shape[1])
    sdpa_ms = cold_ms(sdpa_yardstick(args, kw, q_lens, kv_lens), reps)
    torch.cuda.empty_cache()
    out = []
    for kernel in kernels:
        run = lambda: ra.ragged_paged_attention_cuda(*args, sm_scale=scale, kernel=kernel, **kw)  # noqa: E731
        got = run()
        torch.cuda.synchronize()
        rel, err, ok = compare(got, want, sum(q_lens), tol)
        del got
        ms = cold_ms(run, reps)
        out.append(dict(
            shape=name, kernel=kernel, n_q=n_q, n_kv=n_kv, head_dim=d, T=T, S=args[3].shape[0],
            num_seqs=len(q_lens),
            max_kv_len=max(kv_lens), ok=ok, max_row_rel_err=rel, max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            yardstick_sdpa_ms=sdpa_ms,
        ))
        print(f"{tag} {kernel} {name}: ok={ok} max_row_rel_err={rel:.3e} (limit {tol:g}) "
              f"max_abs_err={err:.3e} "
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


# K1's entry points of each page type: a planted copy of the K1 source
# instantiates only the page type its fault runs on (half the compile).
K1_ENTRY_LINES = {False: ("K1_BF16_ENTRY_POINTS(, 128)", "K1_BF16_ENTRY_POINTS(_hd64, 64)"),
                  True: ("K1_INT8_ENTRY_POINTS(, 128)", "K1_INT8_ENTRY_POINTS(_hd64, 64)")}


# The planted copies' nvcc runs at a lower CPU priority, so that the port's
# own sources, built beside them, are done first.
LOW_PRIORITY = ("nice", "-n", "10")


def build_planted(tmp: str) -> dict:
    """Start one nvcc per planted fault (each a copy of its kernel's source
    with one edit; a K1 copy without the other page type's entry points),
    at a lower CPU priority, and return ``{fault: future of the loaded
    library}``: each check waits for the copies it runs."""
    from dynamo_tpu_torch.ops import _build

    def build(source, name, old, new, drop):
        text = (_build.CSRC_DIR / source).read_text()
        for anchor in (old, *drop):
            if text.count(anchor) != 1:
                raise AssertionError(f"planted fault {name}: {anchor!r} is not in {source} once")
        for line in drop:
            text = text.replace(line, "")
        src = Path(tmp, f"{name}.cu")
        src.write_text(text.replace(old, new))
        _build.build(src, src.with_suffix(".so"), prefix=LOW_PRIORITY)
        return ctypes.CDLL(str(src.with_suffix(".so")))

    jobs = [("ragged_paged_attention.cu", f, K1_ENTRY_LINES[not int8])
            for int8, table in ((False, PLANTED_FAULTS), (True, PLANTED_FAULTS_INT8))
            for f in table.values()]
    jobs += [("paged_attention.cu", PLANTED_FAULTS_K2, ()),
             ("paged_attention.cu", PLANTED_FAULTS_K2_INT8, ())]
    names = [name for _, faults, _ in jobs for name in faults]
    names += [*PLANTED_FAULTS_GENERIC, *PLANTED_FAULTS_GENERIC_INT8]
    if len(set(names)) != len(names):
        raise AssertionError(f"planted-fault names repeat: {sorted(names)}")
    pool = ThreadPoolExecutor(len(names))
    futures = {
        name: pool.submit(build, source, name, old, new, drop)
        for source, faults, drop in jobs for name, (old, new) in faults.items()
    }
    futures.update(build_planted_generic(tmp, pool))
    pool.shutdown(wait=False)
    return futures


def check_planted_faults(ra, batches, libs, faults, int8=False) -> dict:
    """Run each planted fault's copy of its K1 kernel, forced, on the
    batches above: the comparison must fail every one on at least one
    batch, or its limit is too loose to mean anything."""
    found = {}
    for kernel, table in faults.items():
        for name in table:
            def run(args, kw):
                d = args[0].shape[2]
                entries = ra.bind(libs[name].result(), int8, d)
                return ra.launch(entries, *args, sm_scale=d ** -0.5, kernel=kernel, **kw)

            rels = {shape: compare(run(args, kw), want, n_real)[0]
                    for shape, args, kw, want, n_real in batches}
            found[name] = max(rels.values())
            caught = not found[name] <= ROW_REL_TOL  # a NaN fails the limit too
            print(f"planted fault {name} ({kernel} kernel): max_row_rel_err by batch "
                  + ", ".join(f"{k} {v:.3e}" for k, v in rels.items())
                  + f"; caught={caught}", flush=True)
            if not caught:
                raise AssertionError(f"the comparison passes planted fault {name}")
    return found


def plain_by_row_chunks(ra, args, kw, q_lens, rows=64, ref=None):
    """The plain version (``ref``, by default ``ragged_paged_attention_ref``)
    over a batch too large for it in one call: each run of ``rows`` query
    rows of a sequence goes through it alone, as the last rows of that
    sequence cut at the chunk's end (same absolute positions, same visible
    keys), so each call materialises at most ``rows`` x 2048 positions."""
    ref = ref or ra.ragged_paged_attention_ref
    q, kv, lens, tables, cu, _ = args
    page = kv.shape[1]
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=q.device)  # noqa: E731
    lens_h, cu_h = lens.tolist(), cu.tolist()
    out = torch.zeros_like(q)
    for s, ql in enumerate(q_lens):
        for a in range(0, ql, rows):
            b = min(a + rows, ql)
            kv_len = lens_h[s] - ql + b
            r0, r1 = cu_h[s] + a, cu_h[s] + b
            out[r0:r1] = ref(
                q[r0:r1], kv, i32([kv_len]), tables[s : s + 1, : -(-kv_len // page)],
                i32([0, b - a]), i32([1]), sm_scale=q.shape[2] ** -0.5, **kw,
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


def check_attention_geometry(ra, planted, cases, n_q, n_kv, tag, seed, d=HEAD_DIM,
                             int8=False) -> tuple[list[dict], dict]:
    """Both K1 kernels, bf16 pages (or with ``int8`` the same pages
    quantized), at a head layout (``n_q`` query heads over ``n_kv`` KV
    heads of ``d``) on each case ``(name, q_lens, kv_lens, T, reps[, S])``
    of S slots (8 by default) of 256 pages (a decode form of T <= 8 against
    the plain version in one call, larger T in row chunks), then every
    planted fault of those kernels' instances on all the batches, which
    the comparison must catch."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    scale = d ** -0.5
    results, batches = [], []
    for name, q_lens, kv_lens, T, reps, *slots in cases:
        args, kw = attention_batch(q_lens, kv_lens, *(slots or [8]), 256, T, gen, n_q=n_q,
                                   n_kv=n_kv, d=d)
        if int8:
            args, kw = quantized(args, kw)
        if T <= 8:
            plain = lambda: ra.ragged_paged_attention_ref(*args, sm_scale=scale, **kw)  # noqa: E731
        else:
            plain = lambda: plain_by_row_chunks(ra, args, kw, q_lens)  # noqa: E731
        want = plain()
        plain_ms = cold_ms(plain, 3 if T <= 8 else 1)
        results += hold_k1(ra, name, args, kw, want, q_lens, kv_lens, T, int8, reps, plain_ms,
                           tag)
        batches.append((name, args, kw, want, sum(q_lens)))
        torch.cuda.empty_cache()
    faults = check_planted_faults(ra, batches, planted,
                                  PLANTED_FAULTS_INT8 if int8 else PLANTED_FAULTS, int8)
    del batches
    torch.cuda.empty_cache()
    return results, faults


def check_qwen2_attention(ra, planted) -> tuple[list[dict], dict]:
    """K1 at Qwen2-7B's head layout: the decode form (T = S = 8) and a
    tiled prefill wave (T 2048), with the planted faults."""
    return check_attention_geometry(ra, planted, (
        ("qwen2_decode8", [1] * 8, QWEN_DECODE_LENS, 8, 20),
        ("qwen2_prefill2048", QWEN_PREFILL_LENS, QWEN_PREFILL_LENS, 2048, 10),
    ), QWEN_N_Q, QWEN_N_KV, "attention qwen2", seed=2)


# K1 at a tp = 2 rank's llama3-8b shard: 16 query heads over 4 KV heads,
# the group of 4 as at tp = 1 (the serving engine's shapes per rank).
TP = 2
TP_N_Q, TP_N_KV = N_Q // TP, N_KV // TP


def check_shard_attention(ra, planted, decode_lens, prompt_lens) -> tuple[list[dict], dict]:
    """K1 at a tp = 2 rank's shard of llama3-8b: the serving decode form
    (T = S = 8) and the serving prefill wave (T 8192), with the planted
    faults."""
    return check_attention_geometry(ra, planted, (
        ("tp2_decode_serving8", [1] * 8, decode_lens, 8, 20),
        ("tp2_prefill_wave8192", prompt_lens, prompt_lens, 8192, 5),
    ), TP_N_Q, TP_N_KV, "attention tp2 shard", seed=3)


# K1 under pipeline and data parallelism at 2 (the pipeline phase): full
# llama3-8b heads, on a stage's 16 layers or a replica's 32. The serving
# decode width 8 splits into 2 groups (pp microbatches) or 2 lane blocks
# (dp ranks) of 4, so both give K1 T = S = 4; a pp stage runs the 8192
# prefill wave as 2 microbatches of 4096 rows (parallel.pipeline's plan),
# whose sequences straddle the cut.
PIPE = 2


def pipeline_microbatch(prompt_lens) -> tuple[list[int], list[int]]:
    """(q_lens, kv_lens) of the serving prefill wave's second microbatch
    under ``PIPE`` microbatches: each sequence's rows in it and its K/V
    through it (``plan_microbatches``; a sequence with no rows keeps the
    plan's 1)."""
    from dynamo_tpu_torch.parallel.pipeline import plan_microbatches

    T, n = 8192, len(prompt_lens)
    cu = np.concatenate([[0], np.cumsum(prompt_lens)]).astype(np.int32)
    zeros = np.zeros(T, np.int32)
    plan = plan_microbatches(zeros, zeros, zeros, zeros, np.asarray(prompt_lens, np.int32), cu,
                             n, cu[1:] - 1, PIPE, 0)
    q_lens = np.diff(plan.cu_q_lens[1]).tolist()
    return q_lens, plan.kv_lens[1].tolist()


def check_pipeline_attention(ra, planted, decode_lens, prompt_lens) -> tuple[list[dict], dict]:
    """K1 at the shapes pp = 2 and dp = 2 give it at llama3-8b's heads: the
    decode form of a microbatch group or a lane block (T = S = 4) and a
    stage's microbatch of the 8192 wave (T 4096, S = 8), with the planted
    faults."""
    q_lens, kv_lens = pipeline_microbatch(prompt_lens)
    return check_attention_geometry(ra, planted, (
        ("pp2_dp2_decode4", [1] * 4, decode_lens[:4], 4, 20, 4),
        ("pp2_microbatch4096", q_lens, kv_lens, 4096, 5),
    ), N_Q, N_KV, "attention pp2/dp2", seed=4)


# K1's head_dim-64 instances. Llama-3.2-1B's published attention: 32 query
# heads over 8 KV heads of 64 (llama3-8b's group of 4 at half the head dim);
# Qwen2.5-0.5B's: 14 over 2 (a group of 7, padded to 8 by the decode
# template). The serving engine's shapes, as for llama3-8b: S = 8 slots of
# 256 pages, the serving decode form, the 8192 wave, a 2048 mixed step.
HD64 = 64
QWEN25_N_Q, QWEN25_N_KV = 14, 2


def check_head_dim64_attention(ra, planted, decode_lens, prompt_lens) -> tuple[dict, dict]:
    """Both K1 kernels' head_dim-64 instances against the plain version:
    at Llama-3.2-1B's 32/8 heads the serving decode form (T = S = 8), the
    serving prefill wave (T 8192) and a T 2048 mixed step (a 512-token
    chunk next to 7 decode rows), with bf16 pages and with int8 pages; at
    Qwen2.5-0.5B's 14/2 heads the decode form and a T 2048 wave. Each
    page type's planted faults run on its batches; returns the records by
    page type and every fault's largest row error by geometry."""
    ctx = [n + 48 for n in CHUNKED_STREAM_LENS]
    cases = (
        ("hd64_decode_serving8", [1] * 8, decode_lens, 8, 20),
        ("hd64_prefill_wave8192", prompt_lens, prompt_lens, 8192, 5),
        ("hd64_mixed2048_chunk512", [1] * 7 + [512], ctx + [512], 2048, 10),
    )
    shapes, faults = check_attention_geometry(ra, planted, cases, N_Q, N_KV, "attention hd64",
                                              seed=5, d=HD64)
    shapes8, faults8 = check_attention_geometry(ra, planted, cases, N_Q, N_KV,
                                                "attention hd64 int8", seed=6, d=HD64, int8=True)
    qwen, qwen_faults = check_attention_geometry(ra, planted, (
        ("qwen25_decode8", [1] * 8, QWEN_DECODE_LENS, 8, 20),
        ("qwen25_prefill2048", QWEN_PREFILL_LENS, QWEN_PREFILL_LENS, 2048, 10),
    ), QWEN25_N_Q, QWEN25_N_KV, "attention qwen2.5 hd64", seed=7, d=HD64)
    return {"bf16": shapes + qwen, "int8": shapes8}, {
        "bf16": faults, "int8": faults8, "qwen25": qwen_faults}


# -- K1's generic instance (csrc/ragged_paged_attention_generic.cu) -------------

# What the fast instances do not take: f32 and fp16, head dims other than 64
# and 128, groups above 8. Each case runs the form the engine states for it
# (the decode kernel on decode forms, the tiled one on waves and mixed
# steps), against the plain version on the same operands: f32 within 1e-5
# (no rounding on either side but the order of f32 sums), the others within
# ROW_REL_TOL (the output's rounding). Bounds take the card's peak for q's
# type (989 TFLOP/s for fp16 and bf16, 67 for f32); beside them, a design
# ceiling at the f32 CUDA cores' 67 TFLOP/s, the units the generic kernels
# use (no tensor core).
GENERIC_SRC = "ragged_paged_attention_generic.cu"
GENERIC_TOL = {torch.float32: 1e-5, torch.float16: ROW_REL_TOL, torch.bfloat16: ROW_REL_TOL}
TINY_N_Q, TINY_N_KV, TINY_HD, TINY_PAGE = 4, 2, 16, 8   # the tiny presets' attention
TINY_DECODE_LENS = [40, 75, 100, 130, 160, 190, 220, 256]
TINY_PROMPT_LENS = [30, 25, 20, 15, 12, 10, 8, 6]       # one 128-token wave
FALCON3_N_Q, FALCON3_N_KV, FALCON3_HD = 12, 4, 256      # Falcon3-7B
MISTRAL_N_Q, MISTRAL_N_KV = 96, 8                       # Mistral-Large-Instruct-2407
L405_TP8_N_Q, L405_TP8_N_KV = 16, 1                     # Llama-3.1-405B's 128/8 at tp = 8


def hold_generic(ra, case, dtype, n_q, n_kv, d, gen, tag, page=PAGE, int8=False):
    """One case ``(name, q_lens, kv_lens, T, kernel, reps[, S, pages_per_seq])``
    of the generic instance: its batch in ``dtype`` (int8 pages with
    ``int8``), the plain version (a decode form in one call, larger T in
    row chunks; above T = 128 run once, its time that call's, the L2
    flushed before it), and the stated kernel held to it by
    :func:`hold_k1` within ``GENERIC_TOL``, its bound at the card's peak
    for ``dtype``, the CUDA cores' f32 ceiling beside it. Returns its
    record and the batch for the planted faults."""
    name, q_lens, kv_lens, T, kernel, reps, *rest = case
    S, pps = rest or (8, 256)
    args, kw = attention_batch(q_lens, kv_lens, S, pps, T, gen, n_q=n_q, n_kv=n_kv, d=d,
                               dtype=dtype, page=page)
    if int8:
        args, kw = quantized(args, kw)
    entry = ra.k1_instance(dtype, int8, d, n_q // n_kv, kernel)
    if entry not in ra.GENERIC_INSTANCE_NAMES.values():
        raise AssertionError(f"{tag} {name}: {entry} is not the generic instance")
    if T <= 8:
        plain = lambda: ra.ragged_paged_attention_ref(*args, sm_scale=d ** -0.5, **kw)  # noqa: E731
    else:
        plain = lambda: plain_by_row_chunks(ra, args, kw, q_lens)  # noqa: E731
    if T <= 128:  # cheap: a warm-up call, then one timed
        want = plain()
        plain_ms = cold_ms(plain, 1)
    else:
        want, plain_ms = timed_once(plain)
    rate = F32_OPS_PER_S if dtype == torch.float32 else BF16_OPS_PER_S
    (rec,) = hold_k1(ra, name, args, kw, want, q_lens, kv_lens, T, int8, reps, plain_ms, tag,
                     kernels=(kernel,), tol=GENERIC_TOL[dtype], ops_per_s=rate)
    core_ms, core_by = attention_bound(q_lens, kv_lens, T, int8, n_q, n_kv, d,
                                       itemsize=args[0].element_size(),
                                       ops_per_s=F32_OPS_PER_S, page=page)
    if core_ms != rec["bound_ms"]:
        print(f"{tag} {kernel} {name}: the CUDA cores' f32 ceiling (a design figure, not the "
              f"bound) {core_ms:.4f} ms ({core_by}); kernel/ceiling {rec['ms'] / core_ms:.1f}x",
              flush=True)
    rec |= dict(entry=entry, q_dtype=str(dtype).removeprefix("torch."),
                pages="int8" if int8 else "q", row_rel_tol=GENERIC_TOL[dtype],
                f32_core_ceiling_ms=core_ms)
    return rec, (name, args, kw, want, sum(q_lens), kernel, GENERIC_TOL[dtype])


# Faults planted in copies of the generic source: each copy keeps only the
# entry points its batches run (f32 and bf16; their int8 ones for the int8
# fault) and holds one fault, caught when the comparison fails it on at
# least one of the batches it runs on. A fault may edit more than one
# place (both kernels' walks).
GENERIC_ENTRY_LINES = {
    tag: f"K1_GENERIC_ENTRY_POINTS({tag}, {qt}, {kv})" for tag, qt, kv in (
        ("f32", "float", "float"), ("f16", "__half", "__half"),
        ("bf16", "__nv_bfloat16", "__nv_bfloat16"), ("f32_int8", "float", "int8_t"),
        ("f16_int8", "__half", "int8_t"), ("bf16_int8", "__nv_bfloat16", "int8_t"))
}
PLANTED_FAULTS_GENERIC = {
    "generic_drops_second_tile": (
        ("  for (int base = c0; base < c1; base += kTileN) {\n",
         "  for (int base = c0; base < c1; base += kTileN) {\n    if (base == c0 + kTileN) continue;\n"),
        ("      const int base = kt * kTileN;\n",
         "      const int base = kt * kTileN;\n      if (kt == 1) continue;\n"),
    ),
    "generic_misses_own_position": (
        ("return min(kv_len - q_len + i + 1, kv_len);", "return min(kv_len - q_len + i, kv_len);"),
    ),
    "generic_sees_next_position": (
        ("return min(kv_len - q_len + i + 1, kv_len);",
         "return min(kv_len - q_len + i + 2, kv_len);"),
    ),
    "generic_combine_drops_last_split": (
        ("min(n_splits, (row_vis + split_len - 1) / split_len)",
         "max(1, min(n_splits, (row_vis + split_len - 1) / split_len) - 1)"),
    ),
}
PLANTED_FAULTS_GENERIC_INT8 = {
    "generic_v_takes_k_scale": (
        ("kv_scales[slot * 2 * n_kv + 2 * h + is_v]", "kv_scales[slot * 2 * n_kv + 2 * h]"),
    ),
}


def build_planted_generic(tmp: str, pool) -> dict:
    """Start one nvcc per planted fault of the generic source on ``pool``;
    ``{fault: future of the loaded library}``."""
    from dynamo_tpu_torch.ops import _build

    def build(name, edits, keep):
        text = (_build.CSRC_DIR / GENERIC_SRC).read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise AssertionError(f"planted fault {name}: {old!r} is not in {GENERIC_SRC} once")
            text = text.replace(old, new)
        for tag, line in GENERIC_ENTRY_LINES.items():
            if text.count(line) != 1:
                raise AssertionError(f"{line!r} is not in {GENERIC_SRC} once")
            if tag not in keep:
                text = text.replace(line, "")
        src = Path(tmp, f"{name}.cu")
        src.write_text(text)
        _build.build(src, src.with_suffix(".so"), prefix=LOW_PRIORITY)
        return ctypes.CDLL(str(src.with_suffix(".so")))

    futures = {name: pool.submit(build, name, edits, ("f32", "bf16"))
               for name, edits in PLANTED_FAULTS_GENERIC.items()}
    futures.update({name: pool.submit(build, name, edits, ("f32_int8", "bf16_int8"))
                    for name, edits in PLANTED_FAULTS_GENERIC_INT8.items()})
    return futures


def check_generic_planted_faults(ra, batches, libs, faults) -> dict:
    """Each planted fault's copy of the generic source, on every batch of
    its page type, with the batch's stated kernel: the comparison must
    fail each on at least one batch. Returns each fault's largest row
    error over the limit of its batch (above 1: caught)."""
    found = {}
    for name in faults:
        def run(args, kw, kernel):
            entries = ra.bind_generic(libs[name].result(), args[0].dtype, "kv_scales" in kw)
            return ra.launch(entries, *args, sm_scale=args[0].shape[2] ** -0.5, kernel=kernel,
                             **kw)

        ratios = {shape: compare(run(args, kw, kernel), want, n_real, tol)[0] / tol
                  for shape, args, kw, want, n_real, kernel, tol in batches}
        found[name] = max(ratios.values())
        caught = not found[name] <= 1.0  # a NaN fails the limit too
        print(f"planted fault {name} (generic instance): max_row_rel_err over its limit by batch "
              + ", ".join(f"{k} {v:.3e}" for k, v in ratios.items()) + f"; caught={caught}",
              flush=True)
        if not caught:
            raise AssertionError(f"the comparison passes planted fault {name}")
    return found


def check_generic_attention(ra, planted, decode_lens, prompt_lens) -> tuple[list[dict], dict]:
    """K1's generic instance against the plain version at the shapes the
    models it opens to the card give it (the serving engine's: S = 8 slots
    of 256 pages of 32 positions; tiny's 8 slots of 32 pages of 8):
    f32 at the tiny presets' 4/2 heads of 16 (the decode form, a 128-token
    wave, a mixed step of a 32-token chunk and 7 decode rows; int8 pages
    with f32 q on the decode form and the wave); fp16 at llama3-8b's 32/8
    of 128 (the serving decode form, a 2048 wave); bf16 at Falcon3-7B's
    12/4 of 256 (the serving decode form, the 8192 wave, a 2048 mixed step;
    int8 pages on the decode form and the wave), at Mistral-Large-2's
    group of 12 (96/8 of 128) and a Llama-3.1-405B tp = 8 rank's group of
    16 (16/1 of 128) on the decode form and a 2048 wave, and at head_dim
    96 (32/8) on the decode form. Then the planted faults on the tiny and
    Falcon3 batches. Returns the records and the faults' ratios."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    ctx = [n + 48 for n in CHUNKED_STREAM_LENS]
    tiny_ctx = [n + 16 for n in TINY_PROMPT_LENS[:7]]
    tiny = ("tiny_decode8", [1] * 8, TINY_DECODE_LENS, 8, "decode", 20, 8, 32)
    tiny_wave = ("tiny_wave128", TINY_PROMPT_LENS, TINY_PROMPT_LENS, 128, "tiled", 20, 8, 32)
    tiny_mixed = ("tiny_mixed64_chunk32", [1] * 7 + [32], tiny_ctx + [32], 64, "tiled", 20, 8, 32)
    serving = ("decode_serving8", [1] * 8, decode_lens, 8, "decode", 20)
    wave2048 = ("prefill2048", QWEN_PREFILL_LENS, QWEN_PREFILL_LENS, 2048, "tiled", 10)
    falcon = (
        ("falcon3_decode_serving8", [1] * 8, decode_lens, 8, "decode", 20),
        ("falcon3_prefill_wave8192", prompt_lens, prompt_lens, 8192, "tiled", 5),
    )
    plan = (  # (cases, dtype, n_q, n_kv, d, page, int8, tag)
        ((tiny, tiny_wave, tiny_mixed), torch.float32, TINY_N_Q, TINY_N_KV, TINY_HD, TINY_PAGE,
         False, "attention generic f32 tiny"),
        ((tiny, tiny_wave), torch.float32, TINY_N_Q, TINY_N_KV, TINY_HD, TINY_PAGE, True,
         "attention generic f32 tiny int8"),
        ((serving, wave2048), torch.float16, N_Q, N_KV, HEAD_DIM, PAGE, False,
         "attention generic fp16 llama3-8b"),
        (falcon + (("falcon3_mixed2048_chunk512", [1] * 7 + [512], ctx + [512], 2048, "tiled",
                    10),), torch.bfloat16, FALCON3_N_Q, FALCON3_N_KV, FALCON3_HD, PAGE, False,
         "attention generic bf16 falcon3"),
        (falcon, torch.bfloat16, FALCON3_N_Q, FALCON3_N_KV, FALCON3_HD, PAGE, True,
         "attention generic bf16 falcon3 int8"),
        ((serving, wave2048), torch.bfloat16, MISTRAL_N_Q, MISTRAL_N_KV, HEAD_DIM, PAGE, False,
         "attention generic bf16 group12"),
        ((serving, wave2048), torch.bfloat16, L405_TP8_N_Q, L405_TP8_N_KV, HEAD_DIM, PAGE, False,
         "attention generic bf16 group16"),
        ((serving,), torch.bfloat16, N_Q, N_KV, 96, PAGE, False, "attention generic bf16 hd96"),
    )
    records, batches = [], {False: [], True: []}
    for cases, dtype, n_q, n_kv, d, page, int8, tag in plan:
        for case in cases:
            rec, batch = hold_generic(ra, case, dtype, n_q, n_kv, d, gen, tag, page, int8)
            records.append({**rec, "geometry": tag.removeprefix("attention generic ")})
            if "tiny" in tag or "falcon3" in tag:
                batches[int8].append(batch)
            torch.cuda.empty_cache()
    faults = check_generic_planted_faults(ra, batches[False], planted, PLANTED_FAULTS_GENERIC)
    faults |= check_generic_planted_faults(ra, batches[True], planted, PLANTED_FAULTS_GENERIC_INT8)
    del batches
    torch.cuda.empty_cache()
    return records, faults


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
    by_entry = {name: ra.kernel_launches[name]
                for name in (ra.INSTANCE_NAMES[k, int8, 128] for k in K1_KERNELS)}
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
    chunked = spec = None
    if not int8:
        # The chunked and speculation phases serve the first
        # PARALLEL_LAYERS layers, on views of this engine's weights: their
        # engines' warm-ups at full depth took a fifth of the time limit.
        cut = cut_engine(core)
        chunked = {"cut_warm_up": warm_up(cut, f"bf16, {PARALLEL_LAYERS} layers")}
        chunked.update(serve_chunked(ra, card, cut))
        after("the chunked phase")
        spec = serve_spec(ra, card, cut)
        after("the speculation phase")
        del cut
        gc.collect()
        torch.cuda.empty_cache()
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
    reference = None if int8 else (*in_process_traffic(core, warm["graph_captures"]),
                                   tp_reference(core))
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
    limit = logprob_limit(want, got)
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


def logprob_limit(want: dict, got: dict) -> float:
    """The largest difference between two runs' log-probabilities of the
    same token at the same position before their streams part."""
    limit = 0.0
    for rid, w in want.items():
        j = first_divergence(w["tokens"], got[rid]["tokens"])
        for x, y in list(zip(w["logprobs"], got[rid]["logprobs"]))[:j]:
            limit = max(limit, abs(x["logprob"] - y["logprob"]))
    return limit


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

# 32 layers of bf16 experts need 92.9 GB; 8 of them since the tp phase
# joined the smoke (16 until then), for the run's time limit.
MOE_LAYERS = 8
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


def moe_requests(vocab: int) -> tuple[list, np.random.Generator]:
    """The MoE path's requests (rid, prompt, sampling), one per length of
    ``MOE_PROMPT_LENS``, and the generator that drew them (the MoE phase
    draws its chunked prompt from it next)."""
    rng = np.random.default_rng(4321)
    return [(f"moe{i}", [int(t) for t in rng.integers(0, vocab, n)], {"temperature": 0.0})
            for i, n in enumerate(MOE_PROMPT_LENS)], rng


def moe_wires(reqs: list) -> list[dict]:
    return [wire(rid, prompt, sampling, logprobs=MM_LOGPROBS) for rid, prompt, sampling in reqs]


class RouteLog:
    """While entered, every ``model._moe_route`` call of this process is
    logged in call order: the chosen expert ids ``[N*k]`` and, with
    ``logits``, the router logits ``[N, E]`` f32. With ``impose`` (a list
    of id arrays of another run, call for call) each call returns those
    ids instead of its own, with the softmax of its own router logits at
    them: the run then takes the other run's expert choices (and so its
    slots and drops) on its own numbers."""

    def __init__(self, impose: list | None = None, logits: bool = False):
        self.impose, self.keep_logits = impose, logits
        self.ids, self.logits = [], []

    def __enter__(self):
        from dynamo_tpu_torch.engine import model

        self.inner = inner = model._moe_route

        def route(xf, w_router, k):
            probs, ids = inner(xf, w_router, k)
            if self.impose is not None or self.keep_logits:
                router = model._dot(xf, w_router)
            if self.impose is not None:
                c = len(self.ids)
                if c >= len(self.impose) or self.impose[c].shape != tuple(ids.shape):
                    raise AssertionError(f"route call {c} of shape {tuple(ids.shape)} has no "
                                         f"counterpart in the imposed run's {len(self.impose)}")
                ids = torch.from_numpy(self.impose[c]).to(ids.device)
                probs = torch.softmax(router.gather(1, ids.view(-1, k)), dim=-1).reshape(-1)
            self.ids.append(ids.cpu().numpy())
            if self.keep_logits:
                self.logits.append(router.float().cpu().numpy())
            return probs, ids

        model._moe_route = route
        return self

    def __exit__(self, *exc):
        from dynamo_tpu_torch.engine import model

        model._moe_route = self.inner
        return False


def moe_ep_reference(core, streams, wires) -> dict:
    """The EP phase's tp = 1 side, on the MoE phase's engine: its streams of
    ``wires`` and one prompt's first-token logits at ``EP_CAPACITY``, room
    for every entry (the side pair holds its replicated dispatch to them);
    then, every dispatch eager and each from a cleared prefix cache, the
    wave of ``wires`` and the EP phase's solo request with their route
    logs (:class:`RouteLog`; the solo's with its router logits): the EP
    side pair takes the wave's expert choices, and the solo's route log
    is compared with the tp = 2 engine's."""
    cfg = dataclasses.replace(core.cfg, moe_capacity_factor=EP_CAPACITY)
    logits = prompt_logits(core.params, cfg, tp_logits_prompt(cfg.vocab_size)[:EP_LOGITS_PROMPT],
                           "cuda")
    t0 = time.time()
    eager = eager_dispatches(core)
    eager.clear_kv_cache()
    with RouteLog() as wave_routes:
        wave = run_wires(eager, wires)
    eager.clear_kv_cache()
    with RouteLog(logits=True) as solo_routes:
        solo = run_wires(eager, [ep_solo_wire(cfg.vocab_size)])
    del core._launch
    print(f"EP reference: the tp = 1 wave and solo request, eager, with their route logs "
          f"({len(wave_routes.ids)} and {len(solo_routes.ids)} route calls) in "
          f"{time.time() - t0:.1f} s", flush=True)
    return {"streams": streams, "wires": wires, "ref_logits": logits,
            "wave": {"streams": wave, "ids": wave_routes.ids},
            "solo": {"streams": solo, "ids": solo_routes.ids, "logits": solo_routes.logits}}


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
    reqs, rng = moe_requests(cfg.vocab_size)
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
    lp_wires = moe_wires(reqs)
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
    ep_reference = moe_ep_reference(core, graphs, lp_wires)
    res = {"layers": MOE_LAYERS, "built_s": built_s, "memory": {**mem, "peak_gb": peak_gb},
           "layer_check": layer, "warm_up": warm, "bounds": bounds, "launches": launches,
           "forwards": d["forwards"], "ttft_ms": {r: g["ttft_ms"] for r, g in got.items()},
           "prefill_wave_ms": wave_ms, "decode_ms_per_iteration": decode_ms,
           "megastep": megastep, "streams": streams, "idle": idle, "capacity": capacity,
           "mixed_step": mixed, "phase_s": None,
           "ep_reference": ep_reference}  # for the EP phase, not printed
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

    tiled = ra.INSTANCE_NAMES["tiled", False, 128]
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
    by_entry = {name: ra.kernel_launches[name]
                for name in (ra.INSTANCE_NAMES[k, False, 128] for k in K1_KERNELS)}
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
    """The chunked phase, bf16, llama3-8b at full width, on ``core``'s
    weights (the smoke: the main path's first ``PARALLEL_LAYERS`` layers,
    :func:`cut_engine`): a chunked engine's (``CHUNKED_ENGINE``, width 8)
    ``warm_up()`` (keys,
    capture seconds, memory); K1 at the dispatched mixed shapes; a T == S
    mixed batch through the forward; the mixed and fused replays against
    their eager bodies; chunked-prefill logits against one wave; then the
    traffic (7 streams decoding, then the long prompt) under waves
    (``core``, warm), chunked at the defaults (sync, then async), and
    chunked with ``max_num_batched_tokens`` 2048. The last two run on the
    same warm chunked engine with its configuration switched: the planners
    read ``async_exec`` and the token budget at every step, and every graph
    key a 2048-token budget can dispatch is one the default engine's
    warm-up captured (checked), so no setting captures while serving."""
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.core import EngineCore

    streams, long_prompt = chunked_prompts(core.cfg.vocab_size)
    res = {"shapes": check_mixed_shapes(ra)}
    ccore = EngineCore(core.cfg, EngineConfig(**CHUNKED_ENGINE), params=core.params,
                       device="cuda")
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
    by_entry = {name: ra.kernel_launches[name]
                for name in (ra.INSTANCE_NAMES[k, False, 128] for k in K1_KERNELS)}
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
    """The speculation phase, bf16, llama3-8b at full width, on ``core``'s
    weights (the smoke: the main path's first ``PARALLEL_LAYERS`` layers,
    :func:`cut_engine`): K1 at the verify shapes, verify-forward against
    one-token-forward logits, the rings' copy, a speculating engine's
    ``warm_up()`` (waves, spec_k 4, device drafting allowed, at width 8),
    then the phase's traffic with speculation off (``core``, warm, with
    top-2 log-probabilities on the greedy lanes), drafted on
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
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.core import EngineCore
    from dynamo_tpu_torch.tracing import core as tracing_core

    prompts = spec_prompts(core.cfg.vocab_size)
    res = {"shapes": check_verify_shapes(ra, [len(p) for p in prompts])}
    res["logits"] = verify_logits(core, prompts)
    limit = res["logits"]["near_tie_limit"]
    scfg = dict(SPEC_ENGINE)
    score = EngineCore(core.cfg, EngineConfig(**scfg), params=core.params, device="cuda")
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


DISAGG_LAYERS = 4  # the disaggregation phase's depth: its 3 workers' warm-ups, in turn on the card
# The tp and pipeline phases' depth (and the chunked and speculation
# phases' engine over the main path's first layers): they serve the same
# cut checkpoint, to keep the smoke within its time limit on a slow host
# (the sp phase serves all 32 layers).
PARALLEL_LAYERS = DISAGG_LAYERS


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


# Llama-3.2-1B's published shape (its config.json: 16 layers, hidden 2048,
# FFN 8192, 32 query heads over 8 KV heads of head_dim 64, vocab 128256,
# rope theta 500000, tied embeddings; its llama3 rope_scaling is read by
# neither package, so both compute plain RoPE), seeded bf16 weights: the
# checkpoint a user serves with --model-path, through K1's head_dim-64
# instances. Its references: the same engine with the plain attention on
# the card (in row chunks, :func:`plain_attention`), every dispatch eager,
# once with the tiled kernel's arithmetic on its calls (P rounded to bf16)
# and once in f32 throughout.
LLAMA32_1B_PROMPT_LENS = (100, 148, 200, 300, 420, 560, 700, 900)
LLAMA32_1B_TOKENS = 64


def llama32_1b_config():
    from dynamo_tpu_torch.engine.config import ModelConfig

    return ModelConfig(name="llama", vocab_size=128256, hidden_size=2048,
                       intermediate_size=8192, num_layers=16, num_heads=32, num_kv_heads=8,
                       head_dim=64, rope_theta=500000.0, rms_norm_eps=1e-5, tie_embeddings=True)


def llama32_1b_wires(vocab: int) -> list[dict]:
    rng = np.random.default_rng(32)
    return [{"model": "llama3.2-1b", "token_ids": [int(t) for t in rng.integers(1, vocab, n)],
             "request_id": f"l{i}", "sampling": {"temperature": 0.0},
             "stop": {"max_tokens": LLAMA32_1B_TOKENS, "ignore_eos": True},
             "output": {"logprobs": 2}}
            for i, n in enumerate(LLAMA32_1B_PROMPT_LENS)]


def generate_wires(core, wires: list[dict]) -> dict:
    """The requests sent at once through ``TorchEngine.generate`` (a facade
    of ``core`` for this event loop: asyncio objects bind to one): each
    one's tokens and logprob entries (each with its top 2)."""
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.runtime.engine import Context

    async def one(engine, w):
        toks, lps = [], []
        async for out in engine.generate(dict(w), Context(w["request_id"])):
            toks += out["token_ids"]
            lps += out.get("logprobs") or []
        return w["request_id"], {"tokens": toks, "logprobs": lps}

    async def every():
        engine = TorchEngine(core)
        return dict(await asyncio.gather(*(one(engine, w) for w in wires)))

    out = asyncio.run(every())
    if any(len(g["tokens"]) != LLAMA32_1B_TOKENS for g in out.values()):
        raise AssertionError(f"stream lengths {[len(g['tokens']) for g in out.values()]}")
    return out


@contextlib.contextmanager
def plain_attention(ra, tiled_arithmetic=False):
    """Within it, a CUDA call of K1's wrapper runs the plain version on the
    card instead, in one call where it gathers at most 64 x 8192 positions
    (a decode iteration), else each sequence's rows 64 at a time
    (:func:`plain_by_row_chunks`: the engine's 8192-row waves in one call
    would gather 8192 x 8192), and launches no kernel. With
    ``tiled_arithmetic`` the calls of the tiled kernel's form take the
    plain version of its arithmetic (``ragged_paged_attention_tiled_ref``:
    P rounded to bf16 for PV), the decode form's the f32 one."""
    def plain(q, kv_pages, kv_lens, page_indices, cu_q_lens, num_seqs, *, sm_scale,
              kv_scales=None, kernel=None):
        form = kernel or ra.kernel_for(q.shape[0], page_indices.shape[0])
        ref = (ra.ragged_paged_attention_tiled_ref if tiled_arithmetic and form == "tiled"
               else ra.ragged_paged_attention_ref)
        if q.shape[0] * page_indices.shape[1] * kv_pages.shape[1] <= 64 * 8192:  # decode rows
            return ref(q, kv_pages, kv_lens, page_indices, cu_q_lens, num_seqs,
                       sm_scale=sm_scale, kv_scales=kv_scales)
        if sm_scale != q.shape[2] ** -0.5:
            raise AssertionError(f"sm_scale {sm_scale} is not head_dim ** -0.5")
        cu = cu_q_lens.tolist()
        q_lens = [cu[s + 1] - cu[s] for s in range(int(num_seqs.item()))]
        kw = {} if kv_scales is None else {"kv_scales": kv_scales}
        return plain_by_row_chunks(ra, (q, kv_pages, kv_lens, page_indices, cu_q_lens, num_seqs),
                                   kw, q_lens, ref=ref)

    cuda, ra.ragged_paged_attention_cuda = ra.ragged_paged_attention_cuda, plain
    try:
        yield
    finally:
        ra.ragged_paged_attention_cuda = cuda


def hd64_launches(ra, int8: bool) -> dict:
    """K1's head_dim-64 launches of one page type since the last reset,
    and every other instance's."""
    mine = {ra.INSTANCE_NAMES[k, int8, HD64] for k in K1_KERNELS}
    got = launches_of(ra)
    return ({k: got.get(k, 0) for k in sorted(mine)},
            {k: n for k, n in got.items() if k not in mine})


def serve_llama32_1b(ra, card: str, device: str = "cuda") -> dict:
    """Llama-3.2-1B's published shape at full width and depth, seeded bf16
    weights written as a checkpoint (deleted whatever happens), loaded
    through ``build_engine(None, model_path=...)`` at the engine defaults
    (waves, megastep k = 8, CUDA graphs captured at first use): 8 requests
    through ``TorchEngine.generate`` once to capture, then again from a
    cleared prefix cache with the launch counts at 0 (16 K1 launches per
    forward, all head_dim-64 instances, every dispatch a graph replay),
    the last-token logits against the plain attention (``check_logits``),
    the same requests with int8 KV pages on the same weights (the int8
    head_dim-64 instances, their logits held the same way), and the
    greedy streams under the near-tie rule against the same engine with
    the plain attention, every dispatch eager, the tiled kernel's calls
    in its arithmetic (P rounded to bf16 for PV). The same engine in f32
    throughout is the witness: where the kernel's streams part from it,
    whether the plain version with bf16 P parts there the same way."""
    from dynamo_tpu_torch.backends.torch.main import build_engine
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.core import EngineCore
    from dynamo_tpu_torch.engine.model import init_params

    t0 = time.time()
    cfg = llama32_1b_config()
    path = Path(tempfile.mkdtemp(prefix="chip_smoke_llama32_1b_"))
    try:
        params = init_params(cfg, 0, device)
        ck = write_hf_checkpoint(params, cfg, "llama", path)
        del params
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        t1 = time.time()
        core, _ = build_engine(None, model_path=str(path), seed=0, device=device)
        sync(device)
        build_s = time.time() - t1
        if core.cfg != cfg:
            raise AssertionError(f"config.json read back as {core.cfg}, written {cfg}")
        wires = llama32_1b_wires(cfg.vocab_size)
        t1 = time.time()
        generate_wires(core, wires)  # its graphs captured at first use
        capture_pass_s = time.time() - t1
        core.clear_kv_cache()
        before = dict(core.scheduler_stats())
        ra.reset_launches()
        t1 = time.time()
        got = generate_wires(core, wires)
        serve_s = time.time() - t1
        mine, others = hd64_launches(ra, int8=False)
        st = {k: v - before[k] for k, v in core.scheduler_stats().items()}
        per_forward = sum(mine.values()) / st["forwards"]
        peak_gb = torch.cuda.max_memory_allocated() / 1e9 if device == "cuda" else None
        if device == "cuda" and (
                sum(mine.values()) != cfg.num_layers * st["forwards"] or others
                or min(mine.values()) == 0):
            raise AssertionError(f"K1 launches {mine} (other instances {others}) over "
                                 f"{st['forwards']} forwards of {cfg.num_layers} layers")
        if device == "cuda" and (st["graph_replays"] != st["dispatches"] or st["graph_captures"]):
            raise AssertionError(f"{st['graph_replays']} graph replays for {st['dispatches']} "
                                 f"dispatches, {st['graph_captures']} captures on the second pass")
        decode_ms = 1e3 * st["decode_loop_s"] / st["decode_iterations"]
        print(f"llama3.2-1b shape ({cfg.num_layers} layers, {cfg.num_heads}/{cfg.num_kv_heads} "
              f"heads x {cfg.head_dim}) from a checkpoint on {card}: built in {build_s:.1f} s, "
              f"capture pass {capture_pass_s:.1f} s ({before['graph_captures']} graphs), "
              f"{len(got)} requests in {serve_s:.2f} s; K1 launches {mine} = "
              f"{per_forward:.2f} per forward over {st['forwards']} forwards; graph replays "
              f"{st['graph_replays']} of {st['dispatches']} dispatches; decode "
              f"{decode_ms:.3f} ms per iteration ({st['decode_iterations']} iterations); peak "
              f"memory {peak_gb} GB", flush=True)
        logits = check_logits(core, wires[3]["token_ids"][:64])

        core8 = EngineCore(cfg, EngineConfig(kv_dtype="int8"), params=core.params, device=device)
        ra.reset_launches()
        st8_before = dict(core8.scheduler_stats())
        run_wires(core8, wires)
        mine8, others8 = hd64_launches(ra, int8=True)
        forwards8 = core8.scheduler_stats()["forwards"] - st8_before["forwards"]
        if device == "cuda" and (sum(mine8.values()) != cfg.num_layers * forwards8 or others8
                                 or min(mine8.values()) == 0):
            raise AssertionError(f"int8 KV: K1 launches {mine8} (others {others8}) over "
                                 f"{forwards8} forwards")
        print(f"llama3.2-1b shape, int8 KV pages on the same weights: K1 launches {mine8} over "
              f"{forwards8} forwards", flush=True)
        logits8 = check_logits(core8, wires[3]["token_ids"][:64])
        del core8
        gc.collect()

        ref = eager_dispatches(EngineCore(cfg, EngineConfig(), params=core.params, device=device))
        t1 = time.time()
        with plain_attention(ra, tiled_arithmetic=True):
            want = generate_wires(ref, wires)
        ref_s = time.time() - t1
        streams = near_tie_streams("llama3.2-1b: K1 head_dim 64 against the plain attention "
                                   "in the tiled kernel's arithmetic", want, got)
        print(f"llama3.2-1b shape: greedy streams against the plain attention in the tiled "
              f"kernel's arithmetic (eager, {ref_s:.1f} s): {streams['equal']} of "
              f"{streams['streams']} equal, parted "
              f"{[(x['rid'], x['position'], round(x['gap'], 6)) for x in streams['parted']]}, "
              f"log-probabilities differ by up to {streams['limit']:.4e} before", flush=True)
        ref.clear_kv_cache()
        with plain_attention(ra):
            want32 = generate_wires(ref, wires)
        witness = p_rounding_witness(want32, got, want)
        print(f"llama3.2-1b shape: against the plain attention in f32 throughout, the kernel's "
              f"streams part {[(w['rid'], w['kernel']) for w in witness['parted']]} and the "
              f"plain version with bf16 P "
              f"{[(w['rid'], w['plain_bf16_p']) for w in witness['parted']]} (position, f32's "
              f"token, the other's, f32's top-2 gap); {witness['same']} of {len(witness['parted'])} part at the "
              f"same position on the same token; log-probabilities before parting differ by "
              f"up to {witness['limits']['kernel']:.4e} (the kernel) and "
              f"{witness['limits']['plain_bf16_p']:.4e} (bf16 P alone), partings at a top-2 gap "
              f"above that limit {witness['above_limit']}; phase {time.time() - t0:.1f} s",
              flush=True)
        del ref, core
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(path, ignore_errors=True)
    return {"launches": mine, "forwards": st["forwards"], "launches_per_forward": per_forward,
            "int8_launches": mine8, "int8_forwards": forwards8,
            "graph_replays": st["graph_replays"], "dispatches": st["dispatches"],
            "decode_ms_per_iteration": decode_ms, "peak_memory_gb": peak_gb,
            "logits_cosine": logits["cosine"], "int8_logits_cosine": logits8["cosine"],
            "streams": streams, "f32_witness": witness, "build_s": build_s,
            "checkpoint": ck, "phase_s": time.time() - t0}


def p_rounding_witness(want32: dict, got: dict, bf16_p: dict) -> dict:
    """Where the kernel's greedy streams (``got``) part from the plain
    attention in f32 (``want32``), and where the plain attention with the
    tiled kernel's bf16 P (``bf16_p``) parts from it: each stream that
    either parts, as (position, f32's token, the other's token, f32's
    top-2 gap there) or None, how many part at the same position on the
    same token, how many of each part at a gap above its limit (the gap
    rule's failures), and each one's
    log-probability limit against f32 (:func:`logprob_limit`): the plain
    version's, with P's rounding the only change, is what that rounding
    alone moves. The kernel's must stay under ``NEAR_TIE_CEILING``."""
    limits = {"kernel": logprob_limit(want32, got), "plain_bf16_p": logprob_limit(want32, bf16_p)}
    if limits["kernel"] > NEAR_TIE_CEILING:
        raise AssertionError(f"K1 against the plain attention in f32: log-probabilities differ "
                             f"by {limits['kernel']:.4e} before any stream parts, above the "
                             f"ceiling {NEAR_TIE_CEILING}")
    parted = []
    for rid, w in want32.items():
        pair = {}
        for key, other in (("kernel", got[rid]["tokens"]), ("plain_bf16_p", bf16_p[rid]["tokens"])):
            j = first_divergence(w["tokens"], other)
            top = w["logprobs"][j]["top"] if j is not None else None
            pair[key] = None if j is None else (j, w["tokens"][j], other[j],
                                                top[0][1] - top[1][1])
        if pair["kernel"] or pair["plain_bf16_p"]:
            parted.append({"rid": rid, **pair})
    return {"parted": parted, "limits": limits,
            "same": sum(x["kernel"] is not None and x["kernel"] == x["plain_bf16_p"]
                        for x in parted),
            "above_limit": {k: sum(x[k] is not None and x[k][3] > limits[k] for x in parted)
                            for k in limits}}


# -- models K1's generic instance opens to the card ------------------------------

# The f32 tiny presets in process, on the card against the same engine on the
# CPU (the plain versions) on the same weights: each engine of F32_ENGINES
# at the tiny engine shape, 8 requests of F32_PROMPT_LENS tokens (the odd
# ones quote a segment three times, so that n-gram drafts exist), 6 greedy
# and 2 seeded, F32_TOKENS new each. Logits within F32_LOGITS_ATOL: f32
# throughout on both sides (TF32 off, the attention's P unrounded), so only
# the order of f32 sums differs.
F32_ENGINES = (  # (label, preset, engine overrides)
    ("tiny", "tiny", {}),
    ("tiny chunked", "tiny", {"scheduling": "chunked"}),
    ("tiny ngram", "tiny", {"spec_decode": "ngram", "spec_k": 4}),
    ("tiny int8 KV", "tiny", {"kv_dtype": "int8"}),
    ("tiny-moe", "tiny-moe", {}),
)
F32_PROMPT_LENS = (12, 20, 28, 36, 9, 17, 33, 40)
F32_TOKENS = 24
F32_SEEDED = {6: {"temperature": 0.7, "seed": 31}, 7: {"temperature": 0.9, "seed": 32}}
F32_LOGITS_ATOL = 1e-4


def f32_wires(vocab: int) -> list[dict]:
    rng = np.random.default_rng(16)
    wires = []
    for i, n in enumerate(F32_PROMPT_LENS):
        if i % 2:
            seg = [int(t) for t in rng.integers(1, vocab, -(-n // 3))]
            prompt = (seg * 3)[:n]
        else:
            prompt = [int(t) for t in rng.integers(1, vocab, n)]
        wires.append({"model": "tiny", "token_ids": prompt, "request_id": f"f{i}",
                      "sampling": F32_SEEDED.get(i, {"temperature": 0.0}),
                      "stop": {"max_tokens": F32_TOKENS, "ignore_eos": True},
                      "output": {"logprobs": 2}})
    return wires


def tree_to(tree, device):
    """A params tree (dicts of tensors, int8 ``{w, scale}`` pairs, plain
    values) with every tensor copied to ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def generic_launches(ra, tag: str, int8: bool) -> tuple[dict, dict]:
    """K1's launches since the last reset of the generic instance for q of
    ``tag`` over its pages (int8 with ``int8``), and every other one's."""
    mine = {ra.GENERIC_INSTANCE_NAMES[k, tag, int8] for k in K1_KERNELS}
    got = launches_of(ra)
    return ({k: got.get(k, 0) for k in sorted(mine)},
            {k: n for k, n in got.items() if k not in mine})


def serve_f32_presets(ra, card: str, device: str = "cuda") -> dict:
    """``build_engine("tiny")`` at the engine defaults (waves, megastep k =
    8, CUDA graphs), chunked, n-gram speculation and int8 KV, and
    ``build_engine("tiny-moe")``, each on the card after ``warm_up()``
    against the same engine on the CPU on the same weights (drawn on the
    card, copied): last-token logits within F32_LOGITS_ATOL; greedy and
    seeded streams equal up to near-ties under the measured limit
    (``near_tie_streams``); every forward's K1 launches the generic f32
    instance's (int8 pages for the int8 engine), one per layer, every
    dispatch a graph replay, no capture after warm-up."""
    from dynamo_tpu_torch.backends.torch.main import build_engine

    t0 = time.time()
    out = {}
    for label, preset, overrides in F32_ENGINES:
        t1 = time.time()
        core, _ = build_engine(preset, dict(overrides), seed=0, device=device)
        cpu, _ = build_engine(preset, dict(overrides), params=tree_to(core.params, "cpu"),
                              device="cpu")
        cfg = core.cfg
        wires = f32_wires(cfg.vocab_size)
        got_logits, want_logits = (
            prompt_logits(c.params, cfg, wires[0]["token_ids"], c.device,
                          kv_dtype=c.engine.kv_dtype) for c in (core, cpu))
        logits_diff = (got_logits - want_logits).abs().max().item()
        warm = warm_up(core, label) if device == "cuda" else {}
        before = dict(core.scheduler_stats())
        ra.reset_launches()
        got = run_wires(core, wires)
        st = {k: v - before[k] for k, v in core.scheduler_stats().items()
              if isinstance(v, (int, float))}
        int8 = overrides.get("kv_dtype") == "int8"
        mine, others = generic_launches(ra, "f32", int8)
        want = run_wires(cpu, wires)
        streams = near_tie_streams(f"{label}: card against the CPU", want, got)
        rec = {"launches": mine, "forwards": st["forwards"],
               "launches_per_forward": sum(mine.values()) / max(1, st["forwards"]),
               "graph_replays": st["graph_replays"], "dispatches": st["dispatches"],
               "graph_captures": st["graph_captures"], "logits_max_abs_diff": logits_diff,
               "streams": streams, "warm_up_s": warm.get("warm_up_s"),
               "spec_drafted": st.get("spec_drafted_tokens"), "phase_s": time.time() - t1}
        out[label] = rec
        print(f"f32 {label} on {card} against the CPU: logits max |diff| {logits_diff:.3e} "
              f"(limit {F32_LOGITS_ATOL:g}); K1 launches {mine} = "
              f"{rec['launches_per_forward']:.2f} per forward over {st['forwards']} forwards "
              f"(other instances {others}); graph replays {st['graph_replays']} of "
              f"{st['dispatches']} dispatches, {st['graph_captures']} captures after warm-up; "
              f"streams {streams['equal']} of {streams['streams']} equal, parted "
              f"{[(x['rid'], x['position'], x['gap']) for x in streams['parted']]}, "
              f"log-probabilities differ by up to {streams['limit']:.4e} before; "
              f"{rec['phase_s']:.1f} s", flush=True)
        if logits_diff > F32_LOGITS_ATOL or not torch.isfinite(got_logits).all():
            raise AssertionError(f"f32 {label}: logits differ from the CPU's by {logits_diff:.3e}")
        if device == "cuda" and (
                sum(mine.values()) != cfg.num_layers * st["forwards"] or others
                or min(mine.values()) == 0 or st["graph_replays"] != st["dispatches"]
                or st["graph_captures"]):
            raise AssertionError(f"f32 {label}: K1 launches {mine} (others {others}) over "
                                 f"{st['forwards']} forwards of {cfg.num_layers} layers; "
                                 f"{st['graph_replays']} replays of {st['dispatches']} "
                                 f"dispatches, {st['graph_captures']} captures")
        del core, cpu
        gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    out["phase_s"] = time.time() - t0
    return out


# Published shapes served at full width from a config.json holding the
# published values (the depth cut), with seeded weights drawn on the card,
# at the engine defaults (waves, megastep k = 8, CUDA graphs captured at
# first use by a first pass): Falcon3-7B-Base (tiiuae/Falcon3-7B-Base,
# model_type llama: head_dim 256, 12 query heads over 4) at 4 of its 28
# layers, Mistral-Large-Instruct-2407 (a group of 12: 96 over 8 of 128) at
# 2 of 88. The llama3-8b shape at fp16 (2 of 32 layers) gives the fp16
# instance its path. Requests: Llama-3.2-1B's phase's 8 prompts.
FALCON3_7B = dict(
    architectures=["LlamaForCausalLM"], model_type="llama", hidden_size=3072,
    intermediate_size=23040, num_attention_heads=12, num_key_value_heads=4, head_dim=256,
    vocab_size=131072, rope_theta=1000042.0, rms_norm_eps=1e-6, tie_word_embeddings=False,
    max_position_embeddings=32768, hidden_act="silu", torch_dtype="bfloat16",
    num_hidden_layers=4)  # cut: 28 in the published config
MISTRAL_LARGE_2 = dict(
    architectures=["MistralForCausalLM"], model_type="mistral", hidden_size=12288,
    intermediate_size=28672, num_attention_heads=96, num_key_value_heads=8, head_dim=128,
    vocab_size=32768, rope_theta=1000000.0, rms_norm_eps=1e-5, tie_word_embeddings=False,
    max_position_embeddings=131072, hidden_act="silu", torch_dtype="bfloat16",
    num_hidden_layers=2)  # cut: 88 in the published config
PUBLISHED_LAYERS = {"falcon3-7b": 28, "mistral-large-2407": 88}


def published_config(hf: dict):
    """The port's ModelConfig of a config.json holding ``hf``, read through
    ``config_from_hf`` from a temp dir (deleted)."""
    from dynamo_tpu_torch.engine.loader import config_from_hf

    path = Path(tempfile.mkdtemp(prefix="chip_smoke_config_"))
    try:
        (path / "config.json").write_text(json.dumps(hf))
        return config_from_hf(path)
    finally:
        shutil.rmtree(path, ignore_errors=True)


def serve_generic_shape(ra, card: str, label: str, cfg, int8_pass=False, streams=True,
                        device: str = "cuda") -> dict:
    """One model the generic instance opens to the card, seeded weights on
    the card at the engine defaults: 8 requests through
    ``TorchEngine.generate`` once to capture the graphs, then again from a
    cleared prefix cache with the launch counts at 0 (one generic launch per
    layer per forward of q's type, every dispatch a graph replay), decode
    ms per iteration and peak memory; the last-token logits against the
    plain attention (``check_logits``); with ``int8_pass`` the same
    requests with int8 KV on the same weights (the generic int8
    instances); with ``streams`` the greedy streams under the near-tie rule
    against the same engine with the plain attention, every dispatch
    eager."""
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.core import EngineCore
    from dynamo_tpu_torch.engine.model import init_params

    t0 = time.time()
    tag = ra.GENERIC_Q_DTYPES[cfg.torch_dtype]
    if device == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    core = EngineCore(cfg, EngineConfig(), params=init_params(cfg, 0, device), device=device)
    sync(device)
    build_s = time.time() - t0
    wires = llama32_1b_wires(cfg.vocab_size)
    t1 = time.time()
    generate_wires(core, wires)  # its graphs captured at first use
    capture_pass_s = time.time() - t1
    core.clear_kv_cache()
    before = dict(core.scheduler_stats())
    ra.reset_launches()
    t1 = time.time()
    got = generate_wires(core, wires)
    serve_s = time.time() - t1
    mine, others = generic_launches(ra, tag, False)
    st = {k: v - before[k] for k, v in core.scheduler_stats().items() if isinstance(v, (int, float))}
    per_forward = sum(mine.values()) / st["forwards"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if device == "cuda" else None
    decode_ms = 1e3 * st["decode_loop_s"] / st["decode_iterations"]
    print(f"{label} ({cfg.num_layers} layers, {cfg.num_heads}/{cfg.num_kv_heads} heads x "
          f"{cfg.head_dim}, {cfg.dtype}) on {card}: built in {build_s:.1f} s, capture pass "
          f"{capture_pass_s:.1f} s ({before['graph_captures']} graphs), {len(got)} requests in "
          f"{serve_s:.2f} s; K1 launches {mine} = {per_forward:.2f} per forward over "
          f"{st['forwards']} forwards (other instances {others}); graph replays "
          f"{st['graph_replays']} of {st['dispatches']} dispatches; decode {decode_ms:.3f} ms per "
          f"iteration ({st['decode_iterations']} iterations); peak memory {peak_gb} GB",
          flush=True)
    if device == "cuda" and (sum(mine.values()) != cfg.num_layers * st["forwards"] or others
                             or min(mine.values()) == 0):
        raise AssertionError(f"{label}: K1 launches {mine} (others {others}) over "
                             f"{st['forwards']} forwards of {cfg.num_layers} layers")
    if device == "cuda" and (st["graph_replays"] != st["dispatches"] or st["graph_captures"]):
        raise AssertionError(f"{label}: {st['graph_replays']} graph replays for "
                             f"{st['dispatches']} dispatches, {st['graph_captures']} captures on "
                             f"the second pass")
    logits = check_logits(core, wires[3]["token_ids"][:64])
    out = {"launches": mine, "forwards": st["forwards"], "launches_per_forward": per_forward,
           "graph_replays": st["graph_replays"], "dispatches": st["dispatches"],
           "decode_ms_per_iteration": decode_ms, "peak_memory_gb": peak_gb,
           "logits_cosine": logits["cosine"], "build_s": build_s}
    if int8_pass:
        core8 = EngineCore(cfg, EngineConfig(kv_dtype="int8"), params=core.params, device=device)
        ra.reset_launches()
        st8 = dict(core8.scheduler_stats())
        run_wires(core8, wires)
        mine8, others8 = generic_launches(ra, tag, True)
        forwards8 = core8.scheduler_stats()["forwards"] - st8["forwards"]
        print(f"{label}, int8 KV pages on the same weights: K1 launches {mine8} over {forwards8} "
              f"forwards (other instances {others8})", flush=True)
        if device == "cuda" and (sum(mine8.values()) != cfg.num_layers * forwards8 or others8
                                 or min(mine8.values()) == 0):
            raise AssertionError(f"{label} int8 KV: K1 launches {mine8} (others {others8}) over "
                                 f"{forwards8} forwards")
        out |= {"int8_launches": mine8, "int8_forwards": forwards8,
                "int8_logits_cosine": check_logits(core8, wires[3]["token_ids"][:64])["cosine"]}
        del core8
        gc.collect()
    if streams:
        ref = eager_dispatches(EngineCore(cfg, EngineConfig(), params=core.params, device=device))
        t1 = time.time()
        with plain_attention(ra):
            want = generate_wires(ref, wires)
        held = near_tie_streams(f"{label}: K1's generic instance against the plain attention",
                                want, got)
        print(f"{label}: greedy streams against the plain attention (eager, "
              f"{time.time() - t1:.1f} s): {held['equal']} of {held['streams']} equal, parted "
              f"{[(x['rid'], x['position'], round(x['gap'], 6)) for x in held['parted']]}, "
              f"log-probabilities differ by up to {held['limit']:.4e} before", flush=True)
        out["streams"] = held
        del ref
    del core
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    out["phase_s"] = time.time() - t0
    print(f"{label}: phase {out['phase_s']:.1f} s", flush=True)
    return out


def serve_generic_shapes(ra, card: str) -> dict:
    """Falcon3-7B's and Mistral-Large-2's published shapes (their
    config.json values, the depth cut) and llama3-8b's at fp16, each
    through :func:`serve_generic_shape`."""
    from dynamo_tpu_torch.engine.config import llama3_8b

    falcon = published_config(FALCON3_7B)
    mistral = published_config(MISTRAL_LARGE_2)
    if (falcon.head_dim, falcon.num_heads, falcon.num_kv_heads, falcon.tie_embeddings) != (
            256, 12, 4, False) or mistral.num_heads // mistral.num_kv_heads != 12:
        raise AssertionError(f"config.json read back as {falcon} / {mistral}")
    return {
        "falcon3-7b": serve_generic_shape(ra, card, "falcon3-7b shape", falcon, int8_pass=True),
        "mistral-large-2407": serve_generic_shape(ra, card, "mistral-large-2407 shape", mistral),
        "llama3-8b-fp16": serve_generic_shape(
            ra, card, "llama3-8b shape at fp16",
            dataclasses.replace(llama3_8b(), num_layers=2, dtype="float16"), streams=False),
    }


def sla_profile(card: str, device: str = "cuda") -> dict:
    """The port's SLA profiler as a user runs it (``python -m
    dynamo_tpu_torch.tools.profile_sla --preset llama3-1b``, short grids),
    its profile loaded by the port's planner, and the plan for one
    observation printed."""
    from dynamo_tpu_torch.planner.perf_interpolation import from_profile
    from dynamo_tpu_torch.planner.planner_core import (
        Observation,
        Planner,
        RecordingConnector,
        SlaTargets,
    )

    t0 = time.time()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sla_") as tmp:
        out = Path(tmp, "profile.json")
        proc = subprocess.run(
            [sys.executable, "-m", "dynamo_tpu_torch.tools.profile_sla", "--preset", "llama3-1b",
             "--isl-grid", "128", "512", "--concurrency-grid", "1", "8", "--device", device,
             "--out", str(out)], cwd=ROOT, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise AssertionError(f"profile_sla exited {proc.returncode}: {proc.stderr[-3000:]}")
        profile = json.loads(out.read_text())
    pf, dc = from_profile(profile)
    obs = Observation(request_rate=4.0, mean_isl=512, mean_osl=128)
    sla = SlaTargets(ttft_s=0.5, itl_s=0.05)
    plan = Planner(pf, dc, RecordingConnector(), sla=sla).compute_plan(obs)
    print(f"SLA profile on {card} (llama3-1b preset, 16 x 128 heads): {json.dumps(profile)}; "
          f"planner at {obs} under {sla}: {plan}; {time.time() - t0:.1f} s with the process's "
          f"start", flush=True)
    if not (all(t > 0 for t in profile["prefill"]["ttft_s"])
            and all(t > 0 for t in profile["decode"]["itl_s"])
            and plan.prefill_replicas >= 1 and plan.decode_replicas >= 1):
        raise AssertionError(f"profile {profile} or plan {plan} is not usable")
    return {"profile": profile, "plan": dataclasses.asdict(plan), "phase_s": time.time() - t0}


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
    ref, ref_stats, ck = reference[:3]
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


# -- tensor parallelism: tp = 2 over two processes sharing the card -------------

# The one card holds both ranks (NCCL refuses two ranks on one GPU), so
# their collectives go over gloo through host memory and every dispatch
# runs eagerly: a proof of numerics, not a speed figure.
TP_DEVICES = "cuda:0,cuda:0"
TP_LOGPROBS = 2          # each token's top 2: the near-tie rule reads the gap between them
TP_LOGITS_PROMPT = 64    # prompt tokens before the compared logits (check_logits' length)
TP_LOGITS_MIN_COSINE = LOGITS_MIN_COSINE  # tp = 2 against tp = 1, both bf16 on the card


def tp_wires(vocab: int) -> list[dict]:
    """The 8 serving prompts, greedy, ``MAX_TOKENS`` each, with top-2
    log-probabilities."""
    reqs, late, _ = serving_requests(vocab)
    return [wire(rid, prompt, {"temperature": 0.0}, logprobs=TP_LOGPROBS)
            for rid, prompt, _ in reqs + [late]]


def tp_logits_prompt(vocab: int) -> list[int]:
    return [int(t) for t in np.random.default_rng(99).integers(0, vocab, TP_LOGITS_PROMPT)]


def prompt_logits(params, cfg, prompt, device, mesh=None, kv_dtype="bf16") -> torch.Tensor:
    """f32 logits ``[V]`` of the token after ``prompt``: one forward over a
    scratch cache of its own (``check_logits``' operands; pages of
    ``kv_dtype``), on this rank's shard under a ``mesh``."""
    from dynamo_tpu_torch.engine import model
    from dynamo_tpu_torch.engine.config import EngineConfig

    nb = max(8, -(-len(prompt) // 16))  # the scratch pages: the prompt's, 8 at least
    eng = EngineConfig(num_kv_blocks=nb, max_model_len=max(256, 16 * nb), kv_dtype=kv_dtype)
    n, bs = len(prompt), eng.block_size
    i32 = lambda a: torch.tensor(a, dtype=torch.int32, device=device)  # noqa: E731
    pos = list(range(n))
    table = list(range(nb)) + [eng.garbage_block] * (eng.max_blocks_per_seq - nb)
    ops = (i32(prompt), i32(pos), i32([p // bs for p in pos]), i32([p % bs for p in pos]),
           i32([n]), i32([table]), i32([0, n]), i32([1]), i32([n - 1]))
    cache = model.init_cache(cfg, eng, device, tp=mesh.tp if mesh is not None else 1)
    return model.forward_tokens(params, cache, *ops, cfg, mesh=mesh)[0].float().cpu()


def decode_logits(params, cfg, prompt, device, mesh=None) -> torch.Tensor:
    """f32 logits ``[V]`` of one decode step after ``prompt`` (its first
    token again, at the prompt's end) in a batch of two lanes, the
    second idle: the prompt's forward (:func:`prompt_logits`' operands),
    then the step. Under a dp ``mesh`` the prompt runs whole on each rank
    and the step on the rank's lane block, the K/V rows gathered
    (``model.decode_tokens`` under ``mesh.lane_view()``); a rank whose
    block does not hold the prompt's lane returns None."""
    from dynamo_tpu_torch.engine import model
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.parallel.sharding import dp_lane_block

    eng = EngineConfig(num_kv_blocks=8, max_model_len=256)
    n, bs = len(prompt), eng.block_size
    i32 = lambda a: torch.tensor(a, dtype=torch.int32, device=device)  # noqa: E731
    pos = list(range(n))
    table = list(range(8)) + [eng.garbage_block] * (eng.max_blocks_per_seq - 8)
    ops = (i32(prompt), i32(pos), i32([p // bs for p in pos]), i32([p % bs for p in pos]),
           i32([n]), i32([table]), i32([0, n]), i32([1]), i32([n - 1]))
    cache = model.init_cache(cfg, eng, device)
    model.forward_tokens(params, cache, *ops, cfg)
    lanes = (i32([prompt[0], 0]), i32([table, [eng.garbage_block] * len(table)]),
             i32([n, 0]), torch.tensor([True, False], device=device))
    lo, hi = dp_lane_block(mesh, 2) if mesh is not None else (0, 2)
    if lo > 0:
        model.decode_tokens(params, cache, *(a[lo:hi] for a in lanes), cfg, eng,
                            mesh=mesh.lane_view())
        return None
    out = model.decode_tokens(params, cache, *(a[lo:hi] for a in lanes), cfg, eng,
                              mesh=mesh.lane_view() if mesh is not None else None)
    return out[0].float().cpu()


def cut_engine(core, engine_cfg=None):
    """An engine on views of ``core``'s first ``PARALLEL_LAYERS`` layers (its
    embeddings, final norm and head shared), at full width: the model of
    the cut checkpoint (:func:`write_cut_checkpoint`)."""
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.core import EngineCore

    cfg = dataclasses.replace(core.cfg, num_layers=PARALLEL_LAYERS)
    params = {**core.params,
              "layers": {k: v[:PARALLEL_LAYERS] for k, v in core.params["layers"].items()}}
    return EngineCore(cfg, engine_cfg or EngineConfig(), params=params, device="cuda")


def tp_reference(core) -> dict:
    """The tp = 1 side of the tp, pipeline, sp and mesh disaggregation
    phases, each on an engine of its own over the main path's bf16
    weights, every dispatch eager: cut to their first ``PARALLEL_LAYERS``
    layers (the cut checkpoint the tp, pipeline and mesh disaggregation
    phases serve; :func:`cut_engine`), the serving prompts' greedy streams
    with top-2 log-probabilities, one prompt's first-token logits and the
    logits of one decode step after it, and the mesh disaggregation
    phase's embedding; at all 32 layers (the checkpoint the sp phase
    serves), the sp prompts' streams and the long sp prompt's logits."""
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.core import EngineCore

    cut = eager_dispatches(cut_engine(core))
    cfg, params = cut.cfg, cut.params
    streams = run_wires(cut, tp_wires(cfg.vocab_size))
    embed = cut.embed(mesh_embed_prompt(cfg.vocab_size))
    del cut
    full = eager_dispatches(EngineCore(core.cfg, EngineConfig(num_kv_blocks=SP_KV_BLOCKS),
                                       params=core.params, device="cuda"))
    sp_streams = run_wires(full, sp_wires(cfg.vocab_size))
    del full
    gc.collect()
    torch.cuda.empty_cache()
    prompt = tp_logits_prompt(cfg.vocab_size)
    long_prompt = sp_wires(cfg.vocab_size)[0]["token_ids"]
    return {"streams": streams, "embed": embed,
            "logits": prompt_logits(params, cfg, prompt, "cuda"),
            "decode_logits": decode_logits(params, cfg, prompt, "cuda"),
            "sp_streams": sp_streams,
            "sp_logits": prompt_logits(core.params, core.cfg, long_prompt, "cuda")}


def tp_logits_rank(rank: int, addr: str, ckpt: str, out: str) -> int:
    """One rank of the tp phase's logits check (``python chip_smoke.py
    --tp-logits-rank RANK ADDR CHECKPOINT OUT``): join the tp = 2 process
    group on the shared card, load this rank's shard of the checkpoint
    (``load_hf_llama(..., tp=2, rank=...)``) and compute the prompt's
    logits through the collectives; rank 0 saves them to ``OUT``."""
    from dynamo_tpu_torch.engine.loader import load_hf_llama
    from dynamo_tpu_torch.parallel import comm
    from dynamo_tpu_torch.parallel.multihost import init_multihost, shutdown_multihost
    from dynamo_tpu_torch.parallel.sharding import make_mesh

    devices = TP_DEVICES.split(",")
    t0 = time.time()
    init_multihost(addr, TP, rank, comm.choose_backend(devices))
    try:
        mesh = make_mesh(tp=TP, devices=devices, rank=rank)
        t1 = time.time()
        cfg, params = load_hf_llama(ckpt, tp=TP, rank=rank, device=mesh.device)
        torch.cuda.synchronize()
        t2 = time.time()
        comm.reset_calls()
        logits = prompt_logits(params, cfg, tp_logits_prompt(cfg.vocab_size), "cuda", mesh)
        print(f"tp logits rank {rank}: process group and mesh in {t1 - t0:.1f} s, shard "
              f"loaded in {t2 - t1:.2f} s, forward {time.time() - t2:.2f} s, collectives "
              f"{dict(comm.calls)}, peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB",
              flush=True)
        if rank == 0:
            np.save(out, logits.numpy())
    finally:
        shutdown_multihost()
    return 0


async def tp_traffic(address: str, worker, wires: list[dict]) -> dict:
    """Wait until the worker (of tp, pp or dp ranks) serves, send ``wires`` together through
    the port's data-plane client and collect each stream (tokens, logprob
    entries, finish, times)."""
    from dynamo_tpu_torch.runtime import DistributedRuntime

    rt = await DistributedRuntime.create(address)
    try:
        client = await rt.namespace("dynamo").component("backend").endpoint("generate").client()
        t0 = time.time()
        while not client.instance_ids():
            if worker.poll() is not None:
                raise RuntimeError(f"the worker exited with {worker.returncode}")
            if time.time() - t0 > 600:
                raise TimeoutError("the worker never served")
            await asyncio.sleep(0.5)

        async def one(req):
            t = time.perf_counter()
            toks, lps, finish, first = [], [], None, None
            async for out in await client.round_robin(req):
                toks += out["token_ids"]
                lps += out.get("logprobs") or []
                finish = out.get("finish_reason") or finish
                first = first or time.perf_counter()
            return req["request_id"], {"tokens": toks, "logprobs": lps, "finish": finish,
                                       "ttft_ms": 1e3 * (first - t)}

        t = time.perf_counter()
        got = dict(await asyncio.wait_for(asyncio.gather(*(one(r) for r in wires)), 600))
        return {"streams": got, "wall_s": time.perf_counter() - t}
    finally:
        await rt.shutdown()


def rank_build_s(text: str) -> list[dict]:
    """Each rank's engine build and warm-up, as it logged them (the leader
    first)."""
    found = [{"rank": int(m.group(4)), "build_s": float(m.group(1)), "weights": m.group(2),
              "warm_up_s": float(m.group(3))}
             for m in re.finditer(r"engine built in ([\d.]+) s \(weights ([^)]*)\), warmed up "
                                  r"in ([\d.]+) s \(rank (\d+) of [a-z]+=\d+\)", text)]
    return sorted(found, key=lambda b: b["rank"])


def rank_stats(text: str, who: str) -> dict:
    """The counters a rank of the tp worker logs as it stops (``who``: the
    leader's "torch worker N", the follower's "torch follower rank 1")."""
    for line in reversed(text.splitlines()):
        if re.search(who + " stopping: ", line):
            return json.loads(line.split(" stopping: ", 1)[1])
    raise AssertionError(f"{who} logged no counters; log tail:\n{text[-4000:]}")


def serve_tp(card: str, ckpt: str, ref: dict, preset: str = "llama3-8b") -> dict:
    """The tp phase: ``python -m dynamo_tpu_torch.backends.torch --tp 2
    --tp-devices cuda:0,cuda:0 --model-path CKPT`` (llama3-8b at full width,
    the cut checkpoint's ``PARALLEL_LAYERS`` layers; each rank streams its
    shard of the checkpoint) on
    the port's store, its second rank started by the first, serves the 8
    serving prompts (greedy, top-2) through the data plane; their streams
    are held to the tp = 1 engine's (``ref``, :func:`tp_reference`) by the
    near-tie rule. Meanwhile two rank processes of this script compute one
    prompt's first-token logits from the same checkpoint at tp = 2, held
    to the tp = 1 engine's. Each rank's K1 launches must be 32 per forward
    (warm-up included), its collectives 2 x 32 + 1 per forward, over gloo
    through host memory, with no graph captured."""
    from dynamo_tpu_torch.engine.loader import config_from_hf

    cfg = config_from_hf(ckpt)
    per_forward = 2 * cfg.num_layers + (0 if cfg.tie_embeddings else 1)
    logs = Path(tempfile.mkdtemp(prefix="chip_smoke_tp_"))
    out_npy = logs / "tp_logits.npy"
    addr = f"127.0.0.1:{free_port()}"
    t_start = time.time()
    ranks = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--tp-logits-rank", str(r), addr, ckpt,
         str(out_npy)], cwd=ROOT, stdout=open(logs / f"logits_rank{r}.log", "w"),
        stderr=subprocess.STDOUT) for r in range(TP)]
    h = None
    try:
        h = start_worker(preset, "cuda", ["--tp", str(TP), "--tp-devices", TP_DEVICES,
                                          "--obs-publish", "off", "--tokenizer", "byte"],
                         env={"DYN_SYSTEM_ENABLED": "0"}, model_path=ckpt)
        for r, proc in enumerate(ranks):
            if proc.wait(600) != 0:
                raise AssertionError(f"tp logits rank {r} exited with {proc.returncode}:\n"
                                     + (logs / f"logits_rank{r}.log").read_text()[-4000:])
        logits_s = time.time() - t_start
        for r in range(TP):
            print((logs / f"logits_rank{r}.log").read_text().strip().splitlines()[-1], flush=True)
        got_l = torch.from_numpy(np.load(out_npy))
        want_l = ref["logits"]
        cos = torch.nn.functional.cosine_similarity(got_l, want_l, dim=0).item()
        err = (got_l - want_l).abs().max().item()
        rel = ((got_l - want_l).norm() / want_l.norm()).item()
        finite = bool(torch.isfinite(got_l).all())
        print(f"tp logits: tp = 2 ranks against the tp = 1 engine, first token after "
              f"{TP_LOGITS_PROMPT} prompt tokens: shape {tuple(got_l.shape)} finite={finite} "
              f"cosine {cos:.6f} (limit {TP_LOGITS_MIN_COSINE}), max_abs_err {err:.4e}, "
              f"relative L2 {rel:.4e}, |logit| up to {want_l.abs().max().item():.3f}; argmax "
              f"{int(got_l.argmax())} against {int(want_l.argmax())} ({logits_s:.1f} s, both "
              f"ranks beside the worker's start-up)", flush=True)
        if not finite or got_l.shape != want_l.shape or cos < TP_LOGITS_MIN_COSINE:
            raise AssertionError("tp = 2 logits disagree with the tp = 1 engine's")
        got = asyncio.run(tp_traffic(f"127.0.0.1:{h['port']}", h["worker"],
                                     tp_wires(cfg.vocab_size)))
        stop_process(h["worker"])
        if h["worker"].returncode != 0:
            raise AssertionError(f"the tp worker exited with {h['worker'].returncode}")
    except BaseException:
        if h is not None:
            print(f"tp worker log tail:\n{(h['logs'] / 'worker.log').read_text()[-8000:]}",
                  file=sys.stderr)
        raise
    finally:
        for proc in ranks:
            stop_process(proc, signal.SIGKILL, 10)
        if h is not None:
            close_worker(h)
    text = (h["logs"] / "worker.log").read_text()
    lead = rank_stats(text, r"torch worker \d+")
    follow = rank_stats(text, "torch follower rank 1")
    for rid, st in got["streams"].items():
        if len(st["tokens"]) != MAX_TOKENS or st["finish"] != "length":
            raise AssertionError(f"tp {rid}: {len(st['tokens'])} tokens, finish {st['finish']!r}")
    held = near_tie_streams("the tp = 2 worker against the tp = 1 engine", ref["streams"],
                            got["streams"])
    per_rank = []
    for rank, st in enumerate((lead, follow)):
        forwards = st["forwards"] + st["warm_up_forwards"]
        k = st["kernel_launches"]
        decode, tiled = (k["ragged_paged_attention_decode_launch"],
                         k["ragged_paged_attention_tiled_launch"])
        ok = (decode + tiled == cfg.num_layers * forwards and min(decode, tiled) > 0
              and st["attention_launches_int8"] == 0 and st["tp"] == TP and st["rank"] == rank
              and st["comm_backend"] == "gloo-host" and st["graph_captures"] == 0
              and st["collective_calls"] == per_forward * forwards
              and st["eager_dispatches"] == st["dispatches"])
        per_rank.append({"rank": rank, "forwards": st["forwards"],
                         "warm_up_forwards": st["warm_up_forwards"], "decode_launches": decode,
                         "tiled_launches": tiled, "collectives": st["collectives"],
                         "collective_calls": st["collective_calls"],
                         "peak_memory_gb": st.get("peak_memory_bytes", 0) / 1e9,
                         "decode_ms_per_iteration": 1e3 * st["decode_loop_s"]
                         / max(1, st["decode_iterations"])})
        print(f"tp rank {rank}: K1 launches decode {decode} + tiled {tiled} = {cfg.num_layers} x "
              f"({st['forwards']} forwards + {st['warm_up_forwards']} at warm-up): "
              f"{decode + tiled == cfg.num_layers * forwards}; collectives {st['collectives']} "
              f"= {per_forward} per forward: {st['collective_calls'] == per_forward * forwards}; "
              f"backend {st['comm_backend']}, graphs captured {st['graph_captures']}, eager "
              f"dispatches {st['eager_dispatches']} of {st['dispatches']}; peak memory "
              f"{per_rank[-1]['peak_memory_gb']:.2f} GB", flush=True)
        if not ok:
            raise AssertionError(f"tp rank {rank}'s counters: {st}")
    if lead["forwards"] != follow["forwards"] or lead["dispatches"] != follow["dispatches"]:
        raise AssertionError("the tp ranks ran different steps")
    builds = rank_build_s(text)
    if [b["rank"] for b in builds] != list(range(TP)):
        raise AssertionError(f"the tp ranks' build lines: {builds}")
    served = served_after_s(h)
    print(f"tp worker on {card}: serving after {served:.1f} s; ranks' engines "
          + "; ".join(f"rank {b['rank']} built in {b['build_s']:.2f} s (weights {b['weights']}), "
                      f"warmed up in {b['warm_up_s']:.2f} s" for b in builds)
          + f"; 8 requests in {got['wall_s']:.1f} s; decode "
          f"{per_rank[0]['decode_ms_per_iteration']:.2f} ms per iteration (eager, two ranks "
          f"time-sharing one card, collectives through host memory: a proof of numerics, not "
          f"a speed figure)", flush=True)
    print(f"tp: the NCCL path (one card per rank, collectives captured in CUDA graphs) was not "
          f"run: this machine has {torch.cuda.device_count()} card", flush=True)
    return {"served_after_s": served, "rank_builds": builds, "ranks": per_rank,
            "near_tie": held, "logits": {"cosine": cos, "max_abs_err": err, "rel_l2": rel},
            "wall_s": got["wall_s"], "phase_s": time.time() - t_start,
            "launches": [{"ragged_paged_attention_decode_launch": r["decode_launches"],
                          "ragged_paged_attention_tiled_launch": r["tiled_launches"]}
                         for r in per_rank]}


# -- pipeline and data parallelism ---------------------------------------------

PIPE_KV_BLOCKS = 512  # each rank's KV pool: 16384 tokens (the 8 prompts hold ~8100)
PIPE_CARD_SHARE = "cuda:0,cuda:0"  # both ranks of each worker on the one card


def pipeline_logits_rank(rank: int, addr: str, ckpt: str, out: str) -> int:
    """One rank of the pipeline phase's logits checks (``python
    chip_smoke.py --pipeline-logits-rank RANK ADDR CHECKPOINT OUT``): join a
    world of two ranks on the shared card; as stage ``RANK`` of pp = 2, load
    the stage's half of the checkpoint's layers (``load_hf_llama(...,
    layer_span=...)``) and compute one prompt's first-token logits through
    the GPipe program (2 microbatches); then, that stage freed, as dp rank
    ``RANK`` of dp = 2, load the whole model and compute the logits of one
    decode step after the prompt with the lanes split over the ranks
    (:func:`decode_logits`). Rank 0 saves both (``OUT``.pp.npy,
    ``OUT``.dp.npy)."""
    from dynamo_tpu_torch.engine import model
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.loader import config_from_hf, load_hf_llama
    from dynamo_tpu_torch.parallel import comm, pipeline
    from dynamo_tpu_torch.parallel.multihost import init_multihost, shutdown_multihost
    from dynamo_tpu_torch.parallel.sharding import make_mesh

    devices = PIPE_CARD_SHARE.split(",")
    t0 = time.time()
    init_multihost(addr, PIPE, rank, comm.choose_backend(devices))
    try:
        pp_mesh = pipeline.make_pp_mesh(PIPE, devices=devices, rank=rank)
        t1 = time.time()
        span = pipeline.stage_span(config_from_hf(ckpt), PIPE, rank)
        cfg, params = load_hf_llama(ckpt, layer_span=span, device=pp_mesh.device)
        torch.cuda.synchronize()
        t2 = time.time()
        prompt = tp_logits_prompt(cfg.vocab_size)
        eng = EngineConfig(num_kv_blocks=8, max_model_len=256)
        n, bs = len(prompt), eng.block_size
        table = np.full((1, eng.max_blocks_per_seq), eng.garbage_block, np.int32)
        table[0, :8] = np.arange(8)
        pos = np.arange(n, dtype=np.int32)
        plan = pipeline.plan_microbatches(
            np.asarray(prompt, np.int32), pos, pos // bs, pos % bs, np.array([n], np.int32),
            np.array([0, n], np.int32), 1, np.array([n - 1], np.int32), PIPE, eng.garbage_block)
        dev = lambda a: torch.from_numpy(np.asarray(a)).to("cuda")  # noqa: E731
        cache = model.init_cache(pipeline.stage_config(cfg, PIPE), eng, "cuda")
        comm.reset_calls()
        pp_logits = pipeline.pp_forward_tokens(
            params, cache, dev(plan.tokens), dev(plan.positions), dev(plan.write_pages),
            dev(plan.write_offs), dev(plan.kv_lens), dev(table), dev(plan.cu_q_lens),
            dev(np.array([1], np.int32)), dev(plan.last_local), dev(plan.last_mask), cfg,
            pp_mesh)[0].float().cpu()
        pp_calls = dict(comm.calls)
        t3 = time.time()
        print(f"pp logits stage {rank}: process group and mesh in {t1 - t0:.1f} s, layers "
              f"{span[0]}:{span[1]} loaded in {t2 - t1:.2f} s, forward {t3 - t2:.2f} s, "
              f"collectives {pp_calls}, peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} "
              f"GB", flush=True)
        del params, cache
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        mesh = make_mesh(dp=PIPE, tp=1, devices=devices, rank=rank)
        cfg, params = load_hf_llama(ckpt, device=mesh.device)
        torch.cuda.synchronize()
        t4 = time.time()
        comm.reset_calls()
        dp_logits = decode_logits(params, cfg, prompt, "cuda", mesh)
        print(f"dp logits rank {rank}: replica loaded in {t4 - t3:.2f} s, prompt and decode step "
              f"{time.time() - t4:.2f} s, collectives {dict(comm.calls)}, peak memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
        if rank == 0:
            np.save(out + ".pp.npy", pp_logits.numpy())
            np.save(out + ".dp.npy", dp_logits.numpy())
    finally:
        shutdown_multihost()
    return 0


def logits_agreement(name: str, got: torch.Tensor, want: torch.Tensor) -> dict:
    """``got`` against ``want`` logits: finite, same shape, cosine at least
    ``TP_LOGITS_MIN_COSINE``; printed and returned."""
    cos = torch.nn.functional.cosine_similarity(got, want, dim=0).item()
    err = (got - want).abs().max().item()
    rel = ((got - want).norm() / want.norm()).item()
    finite = bool(torch.isfinite(got).all())
    print(f"{name}: shape {tuple(got.shape)} finite={finite} cosine {cos:.6f} (limit "
          f"{TP_LOGITS_MIN_COSINE}), max_abs_err {err:.4e}, relative L2 {rel:.4e}, |logit| up "
          f"to {want.abs().max().item():.3f}; argmax {int(got.argmax())} against "
          f"{int(want.argmax())}", flush=True)
    if not finite or got.shape != want.shape or cos < TP_LOGITS_MIN_COSINE:
        raise AssertionError(f"{name} disagree")
    return {"cosine": cos, "max_abs_err": err, "rel_l2": rel}


def start_pipeline_worker(ckpt: str, axis: str, preset: str = "llama3-8b") -> dict:
    """``python -m dynamo_tpu_torch.backends.torch --{axis} 2 --tp-devices
    cuda:0,cuda:0 --model-path CKPT`` (``axis`` "pp": two stages of half
    the layers; "dp": two replicas of all) and its store, started
    (:func:`start_worker`)."""
    return start_worker(preset, "cuda", [f"--{axis}", str(PIPE), "--tp-devices", PIPE_CARD_SHARE,
                                         "--num-kv-blocks", str(PIPE_KV_BLOCKS), "--obs-publish",
                                         "off", "--tokenizer", "byte"],
                        env={"DYN_SYSTEM_ENABLED": "0"}, model_path=ckpt)


def pipeline_worker(card: str, ckpt: str, ref: dict, axis: str, h: dict) -> dict:
    """One worker of the pipeline phase (:func:`start_pipeline_worker`,
    its handle ``h``, closed here) serves the 8 serving prompts (greedy,
    top-2) through the data plane, held to the tp = 1 engine's streams by
    the near-tie rule. Each rank's K1 launches must be its layers x its
    forwards, warm-up included (a pp stage counts one forward per
    microbatch it passes), with no graph captured and every dispatch eager
    (gloo through host memory); a stage must hop once per forward (pp =
    2: stage 0 sends, stage 1 receives), a dp rank gather K/V rows."""
    from dynamo_tpu_torch.engine.loader import config_from_hf

    cfg = config_from_hf(ckpt)
    layers = cfg.num_layers // (PIPE if axis == "pp" else 1)
    try:
        got = asyncio.run(tp_traffic(f"127.0.0.1:{h['port']}", h["worker"],
                                     tp_wires(cfg.vocab_size)))
        stop_process(h["worker"])
        if h["worker"].returncode != 0:
            raise AssertionError(f"the {axis} worker exited with {h['worker'].returncode}")
    except BaseException:
        print(f"{axis} worker log tail:\n{(h['logs'] / 'worker.log').read_text()[-8000:]}",
              file=sys.stderr)
        raise
    finally:
        close_worker(h)
    text = (h["logs"] / "worker.log").read_text()
    for rid, st in got["streams"].items():
        if len(st["tokens"]) != MAX_TOKENS or st["finish"] != "length":
            raise AssertionError(f"{axis} {rid}: {len(st['tokens'])} tokens, finish "
                                 f"{st['finish']!r}")
    held = near_tie_streams(f"the {axis} = 2 worker against the tp = 1 engine", ref["streams"],
                            got["streams"])
    per_rank = []
    for rank, st in enumerate((rank_stats(text, r"torch worker \d+"),
                               rank_stats(text, "torch follower rank 1"))):
        forwards = st["forwards"] + st["warm_up_forwards"]
        k = st["kernel_launches"]
        decode, tiled = (k["ragged_paged_attention_decode_launch"],
                         k["ragged_paged_attention_tiled_launch"])
        calls = st["collectives"]
        comm_ok = (st["p2p_calls"] == forwards and st["pp_stages"] == PIPE if axis == "pp"
                   else calls["dp_gather"] > 0 and st["dp"] == PIPE)
        ok = (decode + tiled == layers * forwards and min(decode, tiled) > 0
              and st["attention_launches_int8"] == 0 and st["rank"] == rank
              and st["comm_backend"] == "gloo-host" and st["graph_captures"] == 0
              and st["eager_dispatches"] == st["dispatches"] and comm_ok)
        per_rank.append({
            "rank": rank, "forwards": st["forwards"], "warm_up_forwards": st["warm_up_forwards"],
            "decode_launches": decode, "tiled_launches": tiled, "collectives": calls,
            "collectives_per_forward": st["collective_calls"] / forwards,
            "peak_memory_gb": st.get("peak_memory_bytes", 0) / 1e9,
            "decode_ms_per_iteration": 1e3 * st["decode_loop_s"] / max(1, st["decode_iterations"]),
            "pp_pipe_occupancy": st["pp_pipe_occupancy"],
            "pp_fused_dispatches": st["pp_fused_dispatches"],
        })
        print(f"{axis} rank {rank}: K1 launches decode {decode} + tiled {tiled} = {layers} x "
              f"({st['forwards']} forwards + {st['warm_up_forwards']} at warm-up): "
              f"{decode + tiled == layers * forwards}; collectives {calls} "
              f"({per_rank[-1]['collectives_per_forward']:.2f} per forward; p2p "
              f"{st['p2p_calls']}); backend {st['comm_backend']}, graphs captured "
              f"{st['graph_captures']}, eager dispatches {st['eager_dispatches']} of "
              f"{st['dispatches']}; pp_pipe_occupancy {st['pp_pipe_occupancy']:.4f}; peak memory "
              f"{per_rank[-1]['peak_memory_gb']:.2f} GB", flush=True)
        if not ok:
            raise AssertionError(f"{axis} rank {rank}'s counters: {st}")
    builds = rank_build_s(text)
    if [b["rank"] for b in builds] != list(range(PIPE)):
        raise AssertionError(f"the {axis} ranks' build lines: {builds}")
    served = served_after_s(h)
    print(f"{axis} worker on {card}: serving after {served:.1f} s; ranks' engines "
          + "; ".join(f"rank {b['rank']} built in {b['build_s']:.2f} s (weights {b['weights']}), "
                      f"warmed up in {b['warm_up_s']:.2f} s" for b in builds)
          + f"; 8 requests in {got['wall_s']:.1f} s; decode "
          f"{per_rank[0]['decode_ms_per_iteration']:.2f} ms per iteration (eager, two ranks "
          f"time-sharing one card, hops and gathers through host memory: a proof of numerics, "
          f"not a speed figure)", flush=True)
    return {"served_after_s": served, "rank_builds": builds, "ranks": per_rank,
            "near_tie": held, "wall_s": got["wall_s"],
            "launches": [{"ragged_paged_attention_decode_launch": r["decode_launches"],
                          "ragged_paged_attention_tiled_launch": r["tiled_launches"]}
                         for r in per_rank]}


def serve_pipeline(card: str, ckpt: str, ref: dict) -> dict:
    """The pipeline phase: a ``--pp 2`` worker and a ``--dp 2`` worker,
    started together (their start-ups are mostly the host's), then served
    one after the other (:func:`pipeline_worker`), each on the tp phase's
    llama3-8b checkpoint (``PARALLEL_LAYERS`` layers) with both ranks on
    the one card. Beside the pp worker two
    rank processes of this script compute one prompt's first-token logits
    through the GPipe program and then one decode step's logits through
    the dp lanes (:func:`pipeline_logits_rank`), each held to the tp = 1
    engine's (``ref``, :func:`tp_reference`)."""
    t_start = time.time()
    logs = Path(tempfile.mkdtemp(prefix="chip_smoke_pipe_"))
    out = str(logs / "logits")
    addr = f"127.0.0.1:{free_port()}"
    ranks = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--pipeline-logits-rank", str(r), addr,
         ckpt, out], cwd=ROOT, stdout=open(logs / f"logits_rank{r}.log", "w"),
        stderr=subprocess.STDOUT) for r in range(PIPE)]
    hs: dict = {}
    try:
        for axis in ("pp", "dp"):
            hs[axis] = start_pipeline_worker(ckpt, axis)
        pp = pipeline_worker(card, ckpt, ref, "pp", hs["pp"])
        for r, proc in enumerate(ranks):
            if proc.wait(600) != 0:
                raise AssertionError(f"pipeline logits rank {r} exited with {proc.returncode}:\n"
                                     + (logs / f"logits_rank{r}.log").read_text()[-4000:])
        for r in range(PIPE):
            print("\n".join(line for line in (logs / f"logits_rank{r}.log").read_text().splitlines()
                            if " logits " in line), flush=True)
        pp["logits"] = logits_agreement(
            f"pp logits: pp = 2 stages against the tp = 1 engine, first token after "
            f"{TP_LOGITS_PROMPT} prompt tokens", torch.from_numpy(np.load(out + ".pp.npy")),
            ref["logits"])
        dp_logits = torch.from_numpy(np.load(out + ".dp.npy"))
        t_dp = time.time()
        dp = pipeline_worker(card, ckpt, ref, "dp", hs["dp"])
        dp["logits"] = logits_agreement(
            "dp logits: dp = 2 lanes against the tp = 1 engine, the decode step after "
            f"{TP_LOGITS_PROMPT} prompt tokens", dp_logits, ref["decode_logits"])
    finally:
        for proc in ranks:
            stop_process(proc, signal.SIGKILL, 10)
        for h in hs.values():
            close_worker(h)  # a worker whose phase did not run (closing twice is harmless)
    print(f"pipeline: the NCCL path (one card per stage or replica, hops and gathers captured "
          f"in CUDA graphs) was not run: this machine has {torch.cuda.device_count()} card",
          flush=True)
    return {"pp": pp, "dp": dp, "pp_phase_s": t_dp - t_start, "dp_phase_s": time.time() - t_dp,
            "phase_s": time.time() - t_start}


# -- sequence-parallel ring prefill ---------------------------------------------

SP = 2
SP_LONG = 7000           # the long prompt: bucket 8192, 4096 rows a rank, over the threshold
SP_SHORT = (300, 900)    # prompts that stay on the paged waves
SP_KV_BLOCKS = 1024      # each rank's pool: 16384 tokens (the three prompts hold ~8400)
SP_HOP_ROWS = 4096       # the rows of one K or V chunk round the ring: the 8192 bucket over sp


def sp_wires(vocab: int) -> list[dict]:
    """The sp phase's prompts, greedy, ``MAX_TOKENS`` each, with top-2
    log-probabilities: one long prompt for the ring and two short ones."""
    rng = np.random.default_rng(77)
    return [wire(rid, [int(t) for t in rng.integers(0, vocab, n)], {"temperature": 0.0},
                 logprobs=TP_LOGPROBS)
            for rid, n in (("sp_long", SP_LONG), *((f"sp_short{i}", n)
                                                   for i, n in enumerate(SP_SHORT)))]


def cache_digest(cache) -> str:
    """sha256 of every byte of a paged cache (each layer's pages, an int8
    layer's pages and scales), in layer order, but the garbage page: the
    bucket's pad rows all land there, and which of a scatter's duplicate
    writes wins is not defined on the card."""
    import hashlib

    h = hashlib.sha256()
    for layer in cache:
        for t in (layer.values() if isinstance(layer, dict) else (layer,)):
            h.update(t[:-1].contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def sp_logits_rank(rank: int, addr: str, ckpt: str, out: str) -> int:
    """One rank of the sp phase's logits check (``python chip_smoke.py
    --sp-logits-rank RANK ADDR CHECKPOINT OUT``): join an sp = 2 group on
    the shared card, load the whole checkpoint (a replica on each rank)
    and prefill the long prompt through ``model.forward_ring_prefill``
    (each rank its half of the prompt's bucket: 4096 rows of 8192); rank 0
    saves the last-token logits to ``OUT``. Each rank prints its ring
    calls and bytes, its time and memory, and its cache's digest (every
    chunk written on every rank: the digests must agree)."""
    from dynamo_tpu_torch.engine import model
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.loader import load_hf_llama
    from dynamo_tpu_torch.ops.ring_attention import sequence_parallel_mesh
    from dynamo_tpu_torch.parallel import comm
    from dynamo_tpu_torch.parallel.multihost import init_multihost, shutdown_multihost

    devices = TP_DEVICES.split(",")
    t0 = time.time()
    init_multihost(addr, SP, rank, comm.choose_backend(devices))
    try:
        mesh = sequence_parallel_mesh(SP, devices=devices, rank=rank)
        cfg, params = load_hf_llama(ckpt, device=mesh.device)
        torch.cuda.synchronize()
        t1 = time.time()
        prompt = sp_wires(cfg.vocab_size)[0]["token_ids"]
        n = len(prompt)
        T = next(b for b in EngineConfig().prefill_buckets if b >= n)
        eng = EngineConfig(num_kv_blocks=T // 16, max_model_len=T)
        cache = model.init_cache(cfg, eng, mesh.device)
        pos = torch.arange(T, dtype=torch.int32, device=mesh.device)
        tokens = torch.zeros(T, dtype=torch.int32, device=mesh.device)
        tokens[:n] = torch.tensor(prompt, dtype=torch.int32)
        pages = torch.where(pos < n, pos // eng.block_size, eng.garbage_block)
        comm.reset_calls()
        torch.cuda.reset_peak_memory_stats()
        t2 = time.time()
        logits = model.forward_ring_prefill(params, cache, tokens, pages, pos % eng.block_size,
                                            n - 1, cfg, mesh)[0].float().cpu()
        t3 = time.time()
        hop_bytes = (T // SP) * cfg.kv_size * 2  # one K or V chunk, bf16
        print(f"sp logits rank {rank}: group and replica loaded in {t1 - t0:.1f} s; ring prefill of "
              f"{n} tokens (bucket {T}, {T // SP} rows a rank) {1e3 * (t3 - t2):.1f} ms; ring "
              f"sends {comm.calls['ring_send']} and receives {comm.calls['ring_recv']} of "
              f"{hop_bytes / 1e6:.2f} MB each ({2 * (SP - 1) * cfg.num_layers} = 2 (sp - 1) L "
              f"expected); collectives {dict(comm.calls)}; peak memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; cache digest "
              f"{cache_digest(cache)}", flush=True)
        if rank == 0:
            np.save(out, logits.numpy())
    finally:
        shutdown_multihost()
    return 0


def serve_sp(card: str, ckpt: str, ref: dict, preset: str = "llama3-8b") -> dict:
    """The sp phase. First two rank processes of this script prefill the
    long prompt round the ring (:func:`sp_logits_rank`) and its
    last-token logits are held to the tp = 1 paged wave's (``ref``,
    :func:`tp_reference`); then ``python -m dynamo_tpu_torch.backends.torch
    --sp 2 --tp-devices cuda:0,cuda:0 --model-path CKPT`` (llama3-8b at
    full width, all 32 layers of the worker phase's checkpoint, a whole
    replica on each rank, gloo through host memory) serves the long
    prompt and two short ones (greedy, top-2)
    through the data plane, held to the tp = 1 engine's streams by the
    near-tie rule. Each rank must have run one ring prefill, its ring
    hops 2 (sp - 1) L, its K1 launches L per paged forward (the ring
    forward runs none), every paged dispatch a graph replay (an sp rank's
    dispatches call no collective) and the ring forward eager."""
    from dynamo_tpu_torch.engine.loader import config_from_hf

    cfg = config_from_hf(ckpt)
    t_start = time.time()
    logs = Path(tempfile.mkdtemp(prefix="chip_smoke_sp_"))
    out_npy = logs / "sp_logits.npy"
    addr = f"127.0.0.1:{free_port()}"
    ranks = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--sp-logits-rank", str(r), addr, ckpt,
         str(out_npy)], cwd=ROOT, stdout=open(logs / f"logits_rank{r}.log", "w"),
        stderr=subprocess.STDOUT) for r in range(SP)]
    try:
        for r, proc in enumerate(ranks):
            if proc.wait(600) != 0:
                raise AssertionError(f"sp logits rank {r} exited with {proc.returncode}:\n"
                                     + (logs / f"logits_rank{r}.log").read_text()[-4000:])
    finally:
        for proc in ranks:
            stop_process(proc, signal.SIGKILL, 10)
    lines = [(logs / f"logits_rank{r}.log").read_text().strip().splitlines()[-1] for r in range(SP)]
    print("\n".join(lines), flush=True)
    digests = {line.rsplit("cache digest ", 1)[1] for line in lines}
    if len(digests) != 1:
        raise AssertionError(f"the sp ranks' caches differ after the ring prefill: {digests}")
    logits = logits_agreement(
        f"sp logits: ring prefill over sp = 2 ranks against the tp = 1 paged wave, first token "
        f"after {SP_LONG} prompt tokens", torch.from_numpy(np.load(out_npy)), ref["sp_logits"])
    logits_s = time.time() - t_start
    print(f"before the sp worker: {memory_line()}", flush=True)
    wires = sp_wires(cfg.vocab_size)
    h = start_worker(preset, "cuda", ["--sp", str(SP), "--tp-devices", TP_DEVICES,
                                      "--num-kv-blocks", str(SP_KV_BLOCKS), "--obs-publish",
                                      "off", "--tokenizer", "byte"],
                     env={"DYN_SYSTEM_ENABLED": "0"}, model_path=ckpt)
    try:
        got = asyncio.run(tp_traffic(f"127.0.0.1:{h['port']}", h["worker"], wires))
        stop_process(h["worker"])
        if h["worker"].returncode != 0:
            raise AssertionError(f"the sp worker exited with {h['worker'].returncode}")
    except BaseException:
        print(f"sp worker log tail:\n{(h['logs'] / 'worker.log').read_text()[-8000:]}",
              file=sys.stderr)
        raise
    finally:
        close_worker(h)
    text = (h["logs"] / "worker.log").read_text()
    for rid, st in got["streams"].items():
        if len(st["tokens"]) != MAX_TOKENS or st["finish"] != "length":
            raise AssertionError(f"sp {rid}: {len(st['tokens'])} tokens, finish {st['finish']!r}")
    held = near_tie_streams("the sp = 2 worker against the tp = 1 engine", ref["sp_streams"],
                            got["streams"])
    L = cfg.num_layers
    per_rank = []
    for rank, st in enumerate((rank_stats(text, r"torch worker \d+"),
                               rank_stats(text, "torch follower rank 1"))):
        calls = st["collectives"]
        paged = st["forwards"] + st["warm_up_forwards"] - st["ring_prefills"]
        k = st["kernel_launches"]
        decode, tiled = (k["ragged_paged_attention_decode_launch"],
                         k["ragged_paged_attention_tiled_launch"])
        ok = (st["ring_prefills"] == 1 and st["sp"] == SP and st["rank"] == rank
              and calls["ring_send"] == calls["ring_recv"] == 2 * (SP - 1) * L
              and calls["sp_broadcast"] == 1 and decode + tiled == L * paged
              and min(decode, tiled) > 0 and st["comm_backend"] == "gloo-host"
              and st["graph_replays"] == st["dispatches"] - st["ring_prefills"]
              and st["eager_dispatches"] == st["ring_prefills"])
        per_rank.append({
            "rank": rank, "ring_prefills": st["ring_prefills"], "forwards": st["forwards"],
            "warm_up_forwards": st["warm_up_forwards"], "decode_launches": decode,
            "tiled_launches": tiled, "collectives": calls,
            "ring_bytes_per_prefill": calls["ring_send"] * SP_HOP_ROWS * cfg.kv_size * 2,
            "graph_captures": st["graph_captures"], "graph_replays": st["graph_replays"],
            "peak_memory_gb": st.get("peak_memory_bytes", 0) / 1e9,
            "decode_ms_per_iteration": 1e3 * st["decode_loop_s"] / max(1, st["decode_iterations"]),
        })
        print(f"sp rank {rank}: ring prefills {st['ring_prefills']}; ring hops sent "
              f"{calls['ring_send']}, received {calls['ring_recv']} (2 (sp - 1) L = "
              f"{2 * (SP - 1) * L}), {per_rank[-1]['ring_bytes_per_prefill'] / 1e6:.1f} MB sent "
              f"per prefill; K1 launches decode {decode} + tiled {tiled} = {L} x ({paged} paged "
              f"forwards, warm-up included): {decode + tiled == L * paged}; graphs captured "
              f"{st['graph_captures']}, replays {st['graph_replays']} of {st['dispatches']} "
              f"dispatches, eager {st['eager_dispatches']} (the ring); peak memory "
              f"{per_rank[-1]['peak_memory_gb']:.2f} GB", flush=True)
        if not ok:
            raise AssertionError(f"sp rank {rank}'s counters: {st}")
    builds = rank_build_s(text)
    if [b["rank"] for b in builds] != list(range(SP)):
        raise AssertionError(f"the sp ranks' build lines: {builds}")
    served = served_after_s(h)
    ttft = got["streams"]["sp_long"]["ttft_ms"]
    print(f"sp worker on {card}: serving after {served:.1f} s; ranks' engines "
          + "; ".join(f"rank {b['rank']} built in {b['build_s']:.2f} s (weights {b['weights']}), "
                      f"warmed up in {b['warm_up_s']:.2f} s" for b in builds)
          + f"; 3 requests in {got['wall_s']:.1f} s; the long prompt's TTFT {ttft:.1f} ms "
          f"through the data plane (the tp = 1 engine in process: "
          f"{ref['sp_streams']['sp_long']['ttft_ms']:.1f} ms, its wave with a short prompt); "
          f"decode {per_rank[0]['decode_ms_per_iteration']:.2f} ms per iteration (graph "
          f"replays, two ranks time-sharing one card, the ring through host memory: a proof "
          f"of numerics, not a speed figure)", flush=True)
    return {"served_after_s": served, "rank_builds": builds, "ranks": per_rank,
            "near_tie": held, "logits": logits, "logits_s": logits_s, "ttft_ms": ttft,
            "tp1_ttft_ms": ref["sp_streams"]["sp_long"]["ttft_ms"], "wall_s": got["wall_s"],
            "phase_s": time.time() - t_start,
            "launches": [{"ragged_paged_attention_decode_launch": r["decode_launches"],
                          "ragged_paged_attention_tiled_launch": r["tiled_launches"]}
                         for r in per_rank]}


# -- expert parallelism -----------------------------------------------------------

EP_LOGITS_PROMPT = 64  # prompt tokens before the compared logits
# The capacity factor of the side pair's held logits comparisons: E, room
# for every entry. At the default factor 2 random weights saturate the
# dispatch (on the H100, a 64-token prefill overflowed), and the two
# modes then drop different entries, as the JAX docstring says.
EP_CAPACITY = 8.0
# The EP worker's solo request after the wave: a prompt the wave did not
# cache, sent alone, so that the worker's batches are the in-process tp = 2
# engine's and the two streams must be equal bit for bit.
EP_SOLO_LEN = 1000


def route_flips(ref: dict, got: dict, prompt_len: int, layers: int) -> dict:
    """Two runs' route logs of one request (:class:`RouteLog` ``ids`` and
    ``logits``, call for call, ``layers`` calls a forward: the prefill,
    then one decode step a token) compared on the request's own rows: its
    ``prompt_len`` prompt rows in the prefill (the bucket's pad rows come
    after them), lane 0 in a decode step (a lone sequence decodes in lane
    0, the pad lanes after it). Pad rows and lanes come last in the
    dispatch's entry order, so they take no slot from the request's
    entries. A flip is a row whose top-k expert set differs; its margin
    is ``ref``'s router logit of the expert it dropped minus that of the
    expert taken instead (the least such difference), the amount the
    other run's numbers moved across. Until the first flip both runs'
    rows differ by rounding alone: the router noise of a layer is the
    largest difference of a router logit between the runs over the rows
    of that layer's calls before it (the flipped row left out). Returns
    every flip (forward, layer, row, margin) and the first one with its
    layer's noise."""
    flips, noise, first = [], [0.0] * layers, None
    for c, (i1, i2, z1, z2) in enumerate(zip(ref["ids"], got["ids"], ref["logits"], got["logits"])):
        if z1.shape != z2.shape:
            raise AssertionError(f"route call {c}: shapes {z1.shape} and {z2.shape}")
        f, layer = divmod(c, layers)
        k = i1.size // z1.shape[0]
        rows = np.arange(prompt_len if z1.shape[0] >= prompt_len else 1)
        a, b = i1.reshape(-1, k)[rows], i2.reshape(-1, k)[rows]
        bad = (np.sort(a, axis=1) != np.sort(b, axis=1)).any(axis=1)
        for r in rows[bad]:
            dropped, taken = set(a[r]) - set(b[r]), set(b[r]) - set(a[r])
            flips.append({"forward": f, "layer": layer, "row": int(r), "margin": float(min(
                z1[r, x] - z1[r, y] for x in dropped for y in taken))})
        if first is None:
            d = np.abs(z1[rows] - z2[rows]).max(axis=1)[~bad]
            noise[layer] = max(noise[layer], float(d.max()) if d.size else 0.0)
            if bad.any():
                first = dict(flips[-int(bad.sum())], noise=noise[layer])
    return {"flips": flips, "first": first}


def moe_near_tie_streams(name: str, want: dict, got: dict, routes: dict) -> dict:
    """The near-tie rule (:func:`near_tie_streams`) for one MoE request
    whose two runs' route logs were compared (:func:`route_flips`). A
    router flip moves its row's hidden state at once by the weighted
    difference of two experts' outputs, where a dense layer's rounding
    moves it by an ulp; so the limit (at most ``NEAR_TIE_CEILING``) is
    taken over the tokens before both the parting and the forward of the
    first flip, and the first flip's margin must be within twice its
    layer's router noise (a row's two logits move apart by at most twice
    their largest move): a flip past rounding is a fault. The stream then
    equals ``want``'s, or parts at a token whose top-2 gap is within the
    limit (a near-tie of the logits), or parts at or after the forward of
    the first flip (a near-tie of the router)."""
    (rid, w), = want.items()
    g = got[rid]
    j = first_divergence(w["tokens"], g["tokens"])
    first = routes["first"]
    end = min(x for x in (j, first and first["forward"], len(w["tokens"])) if x is not None)
    limit = max([abs(x["logprob"] - y["logprob"])
                 for x, y in list(zip(w["logprobs"], g["logprobs"]))[:end]] or [0.0])
    before = [x for x in routes["flips"] if j is None or x["forward"] <= j]
    margins = [x["margin"] for x in before]
    print(f"{name}: {len(routes['flips'])} router flips on the request's rows over its "
          f"{len(w['tokens'])} tokens, {len(before)} of them up to the parting (margins up to "
          f"{max(margins, default=0.0):.4e}, median {float(np.median(margins)) if margins else 0.0:.4e})"
          + (f"; the first at forward {first['forward']}, layer {first['layer']}, row "
             f"{first['row']}: margin {first['margin']:.4e} against the layer's router noise "
             f"{first['noise']:.4e}" if first else "")
          + f"; log-probabilities differ by up to {limit:.4e} over the {end} tokens before the "
          f"parting and the first flip", flush=True)
    if limit > NEAR_TIE_CEILING:
        raise AssertionError(f"{name}: log-probabilities differ by {limit:.4e} before any "
                             f"parting or router flip, above the ceiling {NEAR_TIE_CEILING}")
    if first is not None and first["margin"] > 2 * first["noise"]:
        raise AssertionError(f"{name}: the first router flip's margin {first['margin']:.4e} "
                             f"exceeds twice its layer's router noise {first['noise']:.4e}")
    out = {"equal": j is None, "limit": limit, "flips": len(routes["flips"]),
           "flips_to_parting": len(before), "first_flip": first, "parted": None}
    if j is None:
        return out
    top = w["logprobs"][j]["top"]
    gap = top[0][1] - top[1][1]
    out["parted"] = {"rid": rid, "position": j, "gap": gap}
    cause = ("a near-tie of the logits" if gap <= limit else
             "a near-tie of the router" if first is not None and first["forward"] <= j else None)
    print(f"divergence, {name} {rid} at token {j}: {w['tokens'][j]} against {g['tokens'][j]}; "
          f"top-2 gap {gap:.4e} (limit {limit:.4e}): {cause or 'unexplained'}", flush=True)
    if cause is None:
        raise AssertionError(f"{name}: {rid} parts at token {j} where the top-2 gap {gap:.4e} "
                             f"exceeds {limit:.4e}, with no router flip before it")
    return out


def ep_logits(params, cfg, prompt, mesh) -> tuple[torch.Tensor, torch.Tensor]:
    """(first-token logits after ``prompt``, logits of one decode step
    after it in a batch of two lanes, the second idle), f32 on the CPU,
    on this tp rank's shard over a scratch cache of its own."""
    from dynamo_tpu_torch.engine import model
    from dynamo_tpu_torch.engine.config import EngineConfig

    eng = EngineConfig(num_kv_blocks=8, max_model_len=256)
    n, bs = len(prompt), eng.block_size
    i32 = lambda a: torch.tensor(a, dtype=torch.int32, device=mesh.device)  # noqa: E731
    pos = list(range(n))
    table = list(range(8)) + [eng.garbage_block] * (eng.max_blocks_per_seq - 8)
    cache = model.init_cache(cfg, eng, mesh.device, tp=mesh.tp)
    first = model.forward_tokens(
        params, cache, i32(prompt), i32(pos), i32([p // bs for p in pos]),
        i32([p % bs for p in pos]), i32([n]), i32([table]), i32([0, n]), i32([1]), i32([n - 1]),
        cfg, mesh=mesh)[0].float().cpu()
    step = model.decode_tokens(
        params, cache, i32([prompt[0], 0]), i32([table, [eng.garbage_block] * len(table)]),
        i32([n, 0]), torch.tensor([True, False], device=mesh.device), cfg, eng,
        mesh=mesh)[0].float().cpu()
    return first, step


def ep_solo_wire(vocab: int) -> dict:
    rng = np.random.default_rng(2024)
    return wire("ep_solo", [int(t) for t in rng.integers(0, vocab, EP_SOLO_LEN)],
                {"temperature": 0.0}, logprobs=MM_LOGPROBS)


def ep_logits_rank(rank: int, addr: str, out: str, routes: str) -> int:
    """One rank of the EP phase's side pair (``python chip_smoke.py
    --ep-logits-rank RANK ADDR OUT ROUTES``): join a tp = 2 group on the shared
    card, draw this rank's shard of Mixtral-8x7B at ``MOE_LAYERS`` layers
    from seed 0 (four of the eight experts), and compute one prompt's
    first-token logits and one decode step's in the replicated dispatch,
    then in the all-to-all dispatch on the same weights, at capacity
    factor ``EP_CAPACITY`` and then at the preset's default. Every MoE call
    notes whether an entry overflowed its capacity in either mode
    (``model.moe_overflow`` of the whole dispatch): the two modes drop
    differently under saturation. Rank 0 saves the eight logits and, per
    capacity and forward, whether either mode overflowed to ``OUT``
    (npz). Then an in-process tp = 2 engine runs the solo request with
    its own expert choices, and the MoE wave with the tp = 1 engine's
    (``ROUTES``, npz of the tp = 1 wave's route log, from
    :func:`moe_ep_reference`): rank 0 saves the two runs' streams
    (``OUT.solo.json``) and the solo run's route log
    (``OUT.routes.npz``)."""
    from dynamo_tpu_torch.engine import model
    from dynamo_tpu_torch.engine.config import mixtral_8x7b
    from dynamo_tpu_torch.ops import ragged_attention as ra
    from dynamo_tpu_torch.parallel import comm
    from dynamo_tpu_torch.parallel.multihost import init_multihost, shutdown_multihost
    from dynamo_tpu_torch.parallel.sharding import make_mesh

    devices = TP_DEVICES.split(",")
    t0 = time.time()
    init_multihost(addr, TP, rank, comm.choose_backend(devices))
    try:
        mesh = make_mesh(tp=TP, devices=devices, rank=rank)
        cfg = dataclasses.replace(mixtral_8x7b(), num_layers=MOE_LAYERS)
        params = model.init_params(cfg, 0, mesh.device, tp=TP, rank=rank)
        torch.cuda.synchronize()
        t1 = time.time()
        prompt = tp_logits_prompt(cfg.vocab_size)[:EP_LOGITS_PROMPT]
        notes = []  # per MoE call: (replicated overflowed, all-to-all overflowed)
        inner = model._moe_mlp

        def noted(x, lp, c, m=None):
            o = model.moe_overflow(x.reshape(-1, x.shape[-1]), lp["w_router"], c, tp=TP)
            notes.append((o["replicated"], o["alltoall"]))
            return inner(x, lp, c, m)

        model._moe_mlp = noted
        got, per_mode, flags = {}, {}, {}
        for cap, factor in (("roomy", EP_CAPACITY), ("default", cfg.moe_capacity_factor)):
            for mode in ("replicated", "alltoall"):
                mcfg = dataclasses.replace(cfg, moe_dispatch=mode, moe_capacity_factor=factor)
                comm.reset_calls()
                ra.reset_launches()
                notes.clear()
                t = time.time()
                got[f"{cap}_{mode}"] = ep_logits(params, mcfg, prompt, mesh)
                per_mode[f"{cap}_{mode}"] = {"s": time.time() - t, "calls": dict(comm.calls),
                                             "k1": sum(ra.kernel_launches.values())}
                if mode == "replicated":
                    # Each forward's layers, prefill then decode (the
                    # all-to-all run routes the same inputs).
                    flags[cap] = np.asarray(notes).reshape(2, MOE_LAYERS, 2).any(axis=1)
        model._moe_mlp = inner
        # An in-process engine of the worker's shape (replicated, every
        # dispatch eager): the solo request with its own expert choices
        # (its route log kept), then the MoE wave with the tp = 1
        # engine's, from a cleared prefix cache.
        from dynamo_tpu_torch.engine.config import EngineConfig
        from dynamo_tpu_torch.engine.core import EngineCore

        ref = np.load(routes)
        imposed = [ref[f"wave_{c}"] for c in range(int(ref["wave_calls"]))]
        core = EngineCore(cfg, EngineConfig(), params=params, device=mesh.device, mesh=mesh)
        t = time.time()
        with RouteLog(logits=True) as free:
            solo = run_wires(core, [ep_solo_wire(cfg.vocab_size)])
        solo_s = time.time() - t
        t = time.time()
        core.clear_kv_cache()
        with RouteLog(impose=imposed) as taken:
            wave = run_wires(core, moe_wires(moe_requests(cfg.vocab_size)[0]))
        if len(taken.ids) != len(imposed):
            raise AssertionError(f"the imposed wave made {len(taken.ids)} route calls, the tp = 1 "
                                 f"wave {len(imposed)}")
        del core
        print(f"ep logits rank {rank}: group and shard ({cfg.num_experts // TP} experts a rank) "
              f"in {t1 - t0:.1f} s; "
              + "; ".join(f"{m}: prefill and decode step {v['s']:.2f} s, collectives over 2 "
                          f"forwards {v['calls']}, K1 launches {v['k1']}"
                          for m, v in per_mode.items())
              + "; overflowed (replicated, all-to-all): "
              + ", ".join(f"{cap} {w} {tuple(bool(b) for b in f[i])}" for cap, f in flags.items()
                          for i, w in enumerate(("prefill", "decode")))
              + f"; the solo request in process {solo_s:.1f} s, then the wave with the tp = 1 "
                f"engine's expert choices in {time.time() - t:.1f} s"
              + f"; peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
        if rank == 0:
            Path(out + ".solo.json").write_text(json.dumps({"solo": solo, "wave": wave}))
            np.savez(out + ".routes.npz", calls=len(free.ids),
                     **{f"ids_{c}": a for c, a in enumerate(free.ids)},
                     **{f"logits_{c}": a for c, a in enumerate(free.logits)})
            np.savez(out, **{f"overflow_{cap}": f for cap, f in flags.items()},
                     **{f"{m}_{w}": got[m][i].numpy() for m in got
                        for i, w in enumerate(("prefill", "decode"))})
    finally:
        shutdown_multihost()
    return 0


def serve_ep(card: str, moe: dict) -> dict:
    """The EP phase: Mixtral-8x7B at its published widths, ``MOE_LAYERS``
    layers from seed 0 (the MoE phase's weights: a tp = 2 draw from one
    seed is the tp = 1 model). ``python -m dynamo_tpu_torch.backends.torch
    --preset mixtral-8x7b --num-layers 8 --tp 2 --tp-devices
    cuda:0,cuda:0`` (replicated dispatch, each rank four experts, gloo
    through host memory) serves the MoE phase's eight prompts (one 8192
    wave, 64 greedy tokens, top-2), printed against the MoE phase's tp = 1
    streams (``moe``), then one fresh prompt alone: held bit for bit to an
    in-process tp = 2 engine's stream, and to the tp = 1 engine's under
    the MoE near-tie rule (:func:`moe_near_tie_streams`, on the two
    engines' route logs). Beside it two rank processes of this script
    (:func:`ep_logits_rank`) compute one prefill forward's and one decode
    step's logits in both dispatch modes, at ``EP_CAPACITY`` and at the
    default factor: the all-to-all logits are held to the replicated ones
    wherever no entry overflowed, and the replicated prefill logits at
    ``EP_CAPACITY`` to the tp = 1 engine's (``moe["ref_logits"]``); and
    their in-process tp = 2 engine, given the tp = 1 engine's expert
    choices, streams the wave held to tp = 1's by the near-tie rule."""
    t_start = time.time()
    logs = Path(tempfile.mkdtemp(prefix="chip_smoke_ep_"))
    out_npz = str(logs / "ep_logits.npz")
    routes = str(logs / "tp1_routes.npz")
    np.savez(routes, wave_calls=len(moe["wave"]["ids"]),
             **{f"wave_{c}": a for c, a in enumerate(moe["wave"]["ids"])})
    addr = f"127.0.0.1:{free_port()}"
    ranks = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--ep-logits-rank", str(r), addr,
         str(out_npz), routes], cwd=ROOT, stdout=open(logs / f"logits_rank{r}.log", "w"),
        stderr=subprocess.STDOUT) for r in range(TP)]
    h = None
    try:
        h = start_worker("mixtral-8x7b", "cuda",
                         ["--tp", str(TP), "--tp-devices", TP_DEVICES, "--num-layers",
                          str(MOE_LAYERS), "--obs-publish", "off", "--tokenizer", "byte"],
                         env={"DYN_SYSTEM_ENABLED": "0"})
        for r, proc in enumerate(ranks):
            if proc.wait(600) != 0:
                raise AssertionError(f"ep logits rank {r} exited with {proc.returncode}:\n"
                                     + (logs / f"logits_rank{r}.log").read_text()[-4000:])
        for r in range(TP):
            print((logs / f"logits_rank{r}.log").read_text().strip().splitlines()[-1], flush=True)
        side = np.load(out_npz)
        logits = {}
        for cap in ("roomy", "default"):
            for i, w in enumerate(("prefill", "decode")):
                a2a, rep_ = (torch.from_numpy(side[f"{cap}_{m}_{w}"])
                             for m in ("alltoall", "replicated"))
                over = side[f"overflow_{cap}"][i]
                name = f"ep logits ({w}, capacity factor {cap})"
                if over.any():
                    # Each mode dropped its own entries: the two compute
                    # other functions, and are not held to each other.
                    cos = torch.nn.functional.cosine_similarity(a2a, rep_, dim=0).item()
                    logits[f"{cap}_alltoall_{w}"] = {"overflowed": over.tolist(), "cosine": cos}
                    print(f"{name}: an entry overflowed its capacity (replicated, all-to-all: "
                          f"{over.tolist()}), so the modes drop differently and are not held "
                          f"to each other; cosine {cos:.6f}", flush=True)
                    continue
                logits[f"{cap}_alltoall_{w}"] = logits_agreement(
                    f"{name}: the all-to-all dispatch against the replicated one over tp = 2 "
                    f"ranks, no entry overflowed", a2a, rep_)
        logits["replicated_prefill_vs_tp1"] = logits_agreement(
            f"ep logits (prefill, capacity factor {EP_CAPACITY}): the replicated dispatch over "
            f"tp = 2 ranks against the tp = 1 engine", torch.from_numpy(side["roomy_replicated_prefill"]),
            moe["ref_logits"])
        if "roomy_alltoall_prefill" not in logits or "overflowed" in logits["roomy_alltoall_prefill"]:
            raise AssertionError(f"an entry overflowed at capacity factor {EP_CAPACITY}")
        side = json.loads(Path(out_npz + ".solo.json").read_text())
        side_routes = np.load(out_npz + ".routes.npz")
        free_routes = {key: [side_routes[f"{key}_{c}"] for c in range(int(side_routes["calls"]))]
                       for key in ("ids", "logits")}
        got = asyncio.run(tp_traffic(f"127.0.0.1:{h['port']}", h["worker"], moe["wires"]))
        got_solo = asyncio.run(tp_traffic(f"127.0.0.1:{h['port']}", h["worker"],
                                          [ep_solo_wire(moe["ref_logits"].shape[0])]))
        stop_process(h["worker"])
        if h["worker"].returncode != 0:
            raise AssertionError(f"the ep worker exited with {h['worker'].returncode}")
    except BaseException:
        if h is not None:
            print(f"ep worker log tail:\n{(h['logs'] / 'worker.log').read_text()[-8000:]}",
                  file=sys.stderr)
        raise
    finally:
        for proc in ranks:
            stop_process(proc, signal.SIGKILL, 10)
        if h is not None:
            close_worker(h)
    text = (h["logs"] / "worker.log").read_text()
    for rid, st in got["streams"].items():
        if len(st["tokens"]) != MAX_TOKENS or st["finish"] != "length":
            raise AssertionError(f"ep {rid}: {len(st['tokens'])} tokens, finish {st['finish']!r}")
    # The served solo request: bit for bit the in-process tp = 2
    # engine's (the same batches), whose route log is compared with the
    # tp = 1 engine's; held to the tp = 1 stream under the MoE near-tie
    # rule. Then the EP dispatch itself: the in-process tp = 2 engine
    # with the tp = 1 engine's expert choices (so its slots and drops)
    # streams the MoE wave under the plain near-tie rule.
    solo = {"worker_against_in_process": near_tie_streams(
        "the tp = 2 EP worker's solo request against the in-process tp = 2 engine",
        side["solo"], got_solo["streams"], exact=True)}
    print(f"ep solo: the worker's {EP_SOLO_LEN}-token request alone streams the in-process "
          f"tp = 2 engine's {MAX_TOKENS} tokens and log-probabilities bit for bit", flush=True)
    solo["against_tp1"] = moe_near_tie_streams(
        "the tp = 2 EP worker's solo request against the tp = 1 MoE engine",
        moe["solo"]["streams"], got_solo["streams"],
        route_flips(moe["solo"], free_routes, EP_SOLO_LEN, MOE_LAYERS))
    held = near_tie_streams("the in-process tp = 2 engine's wave with the tp = 1 engine's expert "
                            "choices against the tp = 1 MoE engine", moe["wave"]["streams"],
                            side["wave"])
    # The served wave against tp = 1 is printed, not held: the worker
    # takes the wave's requests in their order of arrival (lanes, hence
    # slots), and the route logs compared are the solo request's.
    partings = {rid: first_divergence(w["tokens"], got["streams"][rid]["tokens"])
                for rid, w in moe["streams"].items()}
    print("ep wave: the worker's streams against the tp = 1 MoE engine's part at "
          + ", ".join(f"{rid} token {j}" if j is not None else f"{rid} nowhere"
                      for rid, j in partings.items())
          + " (router flips: see the solo request's)", flush=True)
    per_rank = []
    for rank, st in enumerate((rank_stats(text, r"torch worker \d+"),
                               rank_stats(text, "torch follower rank 1"))):
        forwards = st["forwards"] + st["warm_up_forwards"]
        k = st["kernel_launches"]
        decode, tiled = (k["ragged_paged_attention_decode_launch"],
                         k["ragged_paged_attention_tiled_launch"])
        calls = st["collectives"]
        waves = st["single_step_dispatches"]
        ok = (decode + tiled == MOE_LAYERS * forwards and min(decode, tiled) > 0
              and st["tp"] == TP and st["rank"] == rank and st["comm_backend"] == "gloo-host"
              and st["graph_captures"] == 0 and st["eager_dispatches"] == st["dispatches"]
              and st["collective_calls"] == st["collectives_per_forward"] * forwards
              and calls["all_to_all"] == 0)
        per_rank.append({
            "rank": rank, "forwards": st["forwards"], "warm_up_forwards": st["warm_up_forwards"],
            "decode_launches": decode, "tiled_launches": tiled, "collectives": calls,
            "all_to_all_per_forward": calls["all_to_all"] / forwards,
            "peak_memory_gb": st.get("peak_memory_bytes", 0) / 1e9,
            "prefill_wave_ms": 1e3 * st["prefill_loop_s"] / max(1, waves),
            "decode_ms_per_iteration": 1e3 * st["decode_loop_s"] / max(1, st["decode_iterations"]),
        })
        print(f"ep rank {rank}: K1 launches decode {decode} + tiled {tiled} = {MOE_LAYERS} x "
              f"({st['forwards']} forwards + {st['warm_up_forwards']} at warm-up): "
              f"{decode + tiled == MOE_LAYERS * forwards}; collectives {calls} "
              f"({st['collectives_per_forward']} per forward, all-to-alls 0 in the replicated "
              f"dispatch); graphs captured {st['graph_captures']}, eager dispatches "
              f"{st['eager_dispatches']} of {st['dispatches']}; prefill wave "
              f"{per_rank[-1]['prefill_wave_ms']:.1f} ms, decode "
              f"{per_rank[-1]['decode_ms_per_iteration']:.2f} ms per iteration; peak memory "
              f"{per_rank[-1]['peak_memory_gb']:.2f} GB", flush=True)
        if not ok:
            raise AssertionError(f"ep rank {rank}'s counters: {st}")
    builds = rank_build_s(text)
    if [b["rank"] for b in builds] != list(range(TP)):
        raise AssertionError(f"the ep ranks' build lines: {builds}")
    served = served_after_s(h)
    print(f"ep worker on {card}: serving after {served:.1f} s; ranks' engines "
          + "; ".join(f"rank {b['rank']} built in {b['build_s']:.2f} s (weights {b['weights']}), "
                      f"warmed up in {b['warm_up_s']:.2f} s" for b in builds)
          + f"; {len(moe['wires'])} requests in {got['wall_s']:.1f} s (eager, two ranks "
          f"time-sharing one card, collectives through host memory: a proof of numerics, not a "
          f"speed figure)", flush=True)
    print(f"ep: Mixtral-8x7B at its 32 layers needs two cards (46.5 GB of experts a rank at "
          f"tp = 2); this machine has {torch.cuda.device_count()} card", flush=True)
    return {"served_after_s": served, "rank_builds": builds, "ranks": per_rank,
            "near_tie": held, "solo": solo, "wave_partings": partings, "logits": logits,
            "wall_s": got["wall_s"],
            "phase_s": time.time() - t_start,
            "launches": [{"ragged_paged_attention_decode_launch": r["decode_launches"],
                          "ragged_paged_attention_tiled_launch": r["tiled_launches"]}
                         for r in per_rank]}


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
                      by_id: dict, tag: str, clear_also=(),
                      kinds=("batch", "staggered")) -> dict:
    """The serving requests through the port's data-plane client to one
    worker, all at once and then staggered (``kinds``), each run from
    cleared caches (the worker's, and those of ``clear_also``: (component,
    worker id) pairs). Request ids are unique over the phase, as a
    frontend makes them: a prefill worker keys its holds and chunk cursors
    by them."""
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
        for kind in kinds:
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


async def page_checksums(rt, ids: dict, by_id: dict) -> tuple[dict, dict]:
    """Every transferred page as the producer holds it: a sample of full
    blocks of the last run's prompts (first, middle, last) read through
    the prefill and the decode worker's ``kv_fetch`` endpoints (``ids``:
    their instance ids), equal byte for byte. Returns the clients and the
    pages' digests."""
    import hashlib

    from dynamo_tpu_torch.tokens import compute_seq_hashes

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
    return fetch, checksums


async def drive_disagg(store: str, base: str, procs: dict, logs: Path, vocab: int,
                       ids: dict, by_id: dict) -> dict:
    """The disaggregated half of the phase (see :func:`serve_disagg`)."""
    import aiohttp

    from dynamo_tpu_torch.runtime import DistributedRuntime
    from dynamo_tpu_torch.tokens import compute_seq_hashes

    runs = await run_batches(store, "dynamo", "backend", ids["decode"], by_id, "disagg",
                             clear_also=[("prefill", ids["prefill"])])
    rt = await DistributedRuntime.create(store)
    try:
        fetch, checksums = await page_checksums(rt, ids, by_id)
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
        # The aggregated worker's runs, the mesh phase's reference (taken
        # out before the summary is printed).
        "agg_runs": agg_runs,
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


# -- disaggregation on meshes: a tp = 2 prefill worker, a pp = 2 decode worker ---

MESH_DISAGG_MODEL = "llama3-8b-mesh-disagg"
MESH_KV_BLOCKS = 512      # each rank's pool: 8192 tokens (the 8 prompts hold ~8100)
MESH_EMBED_LEN = 300      # the embedding's prompt
MESH_EMBED_MIN_COSINE = TP_LOGITS_MIN_COSINE  # tp = 2 against tp = 1, both bf16 on the card


def mesh_embed_prompt(vocab: int) -> list[int]:
    return [int(t) for t in np.random.default_rng(77).integers(0, vocab, MESH_EMBED_LEN)]


async def mesh_embedding(store: str, worker_id: int, prompt: list[int]) -> tuple[list, float]:
    """One embedding request through the data plane to the prefill worker
    (component ``prefill``), and its wall ms."""
    from dynamo_tpu_torch.runtime import DistributedRuntime

    rt = await DistributedRuntime.create(store)
    try:
        client = await rt.namespace("dynamo").component("prefill").endpoint("generate").client()
        await client.wait_for_instances(1, timeout=60)
        t0 = time.perf_counter()
        outs = [o async for o in await client.direct(
            worker_id, {"embed": True, "token_ids": prompt, "request_id": "mesh-embed"})]
        return outs[-1]["embedding"], 1e3 * (time.perf_counter() - t0)
    finally:
        await rt.shutdown()


def serve_mesh_disagg(card: str, model_path: str, agg_runs: dict, embed_ref,
                      device: str = "cuda", devices: str = PIPE_CARD_SHARE) -> dict:
    """Disaggregated prefill and decode between workers of two ranks each,
    every rank on the one card (gloo through host memory): a ``--role
    prefill --tp 2`` worker (each rank its heads) and a ``--role decode
    --pp 2`` worker (each stage its layers) on the disaggregation phase's
    cut checkpoint (``model_path``), started together on a store of their
    own. The serving phase's 8 requests go to the decode worker through
    the data-plane client, all at once, from cleared caches; every prompt
    prefills on the tp worker, whose pages are gathered whole to its rank
    0 and scattered over the decode worker's stages. Held: the decode
    worker's greedy streams against the disaggregation phase's aggregated
    tp = 1 worker (``agg_runs``) under the near-tie rule; blocks imported
    with no local recompute, no failed pull and none dropped; a sample of
    pages equal byte for byte through both workers' ``kv_fetch``; one
    embedding from the tp = 2 worker against the tp = 1 engine's
    (``embed_ref``, cosine at least ``MESH_EMBED_MIN_COSINE``). Each rank's
    K1 launches must be its layers x its forwards (warm-up and the
    embedding's forward included). Prints each rank's K1 launches per
    forward, the page collectives per request and their ms, the TTFT
    against the aggregated worker's, each rank's peak memory and the
    phase's seconds."""
    from dynamo_tpu_torch.engine.loader import config_from_hf

    t0 = time.time()
    cfg = config_from_hf(model_path)
    reqs, late, _ = serving_requests(cfg.vocab_size)
    by_id = {r[0]: r for r in reqs + [late]}
    greedy = {rid for rid, _, samp in by_id.values() if samp.get("temperature") == 0.0}
    logs = Path(tempfile.mkdtemp(prefix="chip_smoke_mesh_disagg_"))
    store_port = free_port()
    store = f"127.0.0.1:{store_port}"
    env = {**os.environ, "DYN_STORE_ADDRESS": store, "DYN_SYSTEM_ENABLED": "0"}
    worker = [sys.executable, "-m", "dynamo_tpu_torch.backends.torch", "--model-path", model_path,
              "--tokenizer", "byte", "--seed", "0", "--device", device, "--obs-publish", "off",
              "--model-name", MESH_DISAGG_MODEL, "--tp-devices", devices,
              "--num-kv-blocks", str(MESH_KV_BLOCKS)]
    args = {"prefill": ["--role", "prefill", "--tp", "2"],
            "decode": ["--role", "decode", "--pp", "2"]}
    layers = {"prefill": cfg.num_layers, "decode": cfg.num_layers // 2}
    procs: dict = {}
    files = {name: open(logs / f"{name}.log", "w") for name in ("store", "prefill", "decode")}

    async def serving() -> dict[str, int]:
        return {n: int((await wait_for_log(logs / f"{n}.log",
                                           rf"torch {n} worker (\d+) serving model",
                                           procs[n], 600)).group(1)) for n in args}

    async def checksums(ids) -> dict:
        from dynamo_tpu_torch.runtime import DistributedRuntime

        rt = await DistributedRuntime.create(store)
        try:
            return (await page_checksums(rt, ids, by_id))[1]
        finally:
            await rt.shutdown()

    text = {}
    try:
        procs["store"] = subprocess.Popen(
            [sys.executable, "-m", "dynamo_tpu_torch.runtime.store", "--port", str(store_port)],
            cwd=ROOT, stdout=files["store"], stderr=subprocess.STDOUT)
        wait_for_port(store_port, procs["store"], 30)
        for name in args:
            procs[name] = subprocess.Popen(worker + args[name], cwd=ROOT, stdout=files[name],
                                           stderr=subprocess.STDOUT, env=env)
        ids = asyncio.run(serving())
        t_up = time.time()
        runs = asyncio.run(run_batches(store, "dynamo", "backend", ids["decode"], by_id, "mesh",
                                       clear_also=[("prefill", ids["prefill"])],
                                       kinds=("batch",)))["batch"]
        sums = asyncio.run(checksums(ids))
        vec, embed_ms = asyncio.run(mesh_embedding(store, ids["prefill"],
                                                   mesh_embed_prompt(cfg.vocab_size)))
        t_traffic = time.time()
        for name in ("decode", "prefill"):
            stop_process(procs[name])
            if procs[name].returncode != 0:
                raise AssertionError(f"the mesh {name} worker exited with {procs[name].returncode}")
            text[name] = (logs / f"{name}.log").read_text()
    except BaseException:
        for name in files:
            print(f"mesh {name} log tail:\n"
                  f"{(logs / f'{name}.log').read_text(errors='replace')[-6000:]}", file=sys.stderr)
        raise
    finally:
        for name, proc in procs.items():
            stop_process(proc, signal.SIGKILL if name != "store" else signal.SIGTERM, 10)
        for f in files.values():
            f.close()

    held = hold_streams("the pp = 2 decode worker (tp = 2 prefill) against the tp = 1 "
                        "aggregated worker", agg_runs["batch"], runs, greedy)
    got = torch.tensor(vec, dtype=torch.float32)
    want = torch.as_tensor(np.asarray(embed_ref), dtype=torch.float32)
    cos = torch.nn.functional.cosine_similarity(got, want, dim=0).item()
    finite = bool(torch.isfinite(got).all())
    print(f"mesh embedding: the tp = 2 prefill worker against the tp = 1 engine, "
          f"{MESH_EMBED_LEN} tokens: shape {tuple(got.shape)} finite={finite} cosine {cos:.6f} "
          f"(limit {MESH_EMBED_MIN_COSINE}), max_abs_err {(got - want).abs().max().item():.4e}, "
          f"{embed_ms:.1f} ms over the data plane", flush=True)
    if not finite or got.shape != want.shape or cos < MESH_EMBED_MIN_COSINE:
        raise AssertionError("the tp = 2 embedding disagrees with the tp = 1 engine's")

    stats = {name: [rank_stats(text[name], rf"torch worker \d+"),
                    rank_stats(text[name], "torch follower rank 1")] for name in args}
    d = stats["decode"][0]
    dis, pool, xfer = d["disagg"], d["kv_pool"], d["transfer"]
    remote = dis["remote_prefills"]
    if (xfer["imported_blocks"] == 0 or dis["recompute_fallbacks"] or pool["pulls_fallback"]
            or dis["handoffs_fallback"] or xfer["dropped_blocks"]
            or remote + dis["local_prefills"] != len(by_id) or remote == 0):
        raise AssertionError(f"the mesh decode worker's transfers: {dis}, {pool}, {xfer}")
    ranks = {}
    for name, pair in stats.items():
        embeds = 1 if name == "prefill" else 0  # the embedding's forward, on the tp worker
        ranks[name] = []
        for rank, st in enumerate(pair):
            forwards = st["forwards"] + st["warm_up_forwards"] + embeds
            k = st["kernel_launches"]
            decode, tiled = (k["ragged_paged_attention_decode_launch"],
                             k["ragged_paged_attention_tiled_launch"])
            calls, secs = st["collectives"], st["page_collective_s"]
            ok = (st["rank"] == rank
                  and st["comm_backend"] == ("gloo-host" if device == "cuda" else "gloo")
                  and st["attention_launches_int8"] == 0 and st["graph_captures"] == 0
                  and (device != "cuda" or (decode + tiled == layers[name] * forwards
                                            and tiled > 0)))
            page = {c: calls[c] for c in ("page_gather", "page_scatter", "page_count")}
            r = {"rank": rank, "forwards": st["forwards"],
                 "warm_up_forwards": st["warm_up_forwards"], "decode_launches": decode,
                 "tiled_launches": tiled, "k1_per_forward": (decode + tiled) / forwards,
                 "page_collectives": page,
                 "page_collectives_per_request": sum(page.values()) / remote,
                 "page_collective_ms": {c: 1e3 * v for c, v in secs.items()},
                 "page_collective_ms_per_request": 1e3 * sum(secs.values()) / remote,
                 "peak_memory_gb": st.get("peak_memory_bytes", 0) / 1e9}
            ranks[name].append(r)
            print(f"mesh {name} rank {rank}: K1 launches decode {decode} + tiled {tiled} = "
                  f"{r['k1_per_forward']:.2f} per forward over {forwards} forwards "
                  f"({layers[name]} layers held); page collectives {page} "
                  f"({r['page_collectives_per_request']:.2f} per request, "
                  f"{r['page_collective_ms_per_request']:.1f} ms per request: "
                  f"{json.dumps(r['page_collective_ms'])}); peak memory "
                  f"{r['peak_memory_gb']:.2f} GB", flush=True)
            if not ok:
                raise AssertionError(f"mesh {name} rank {rank}'s counters: {st}")
    ttft = {a["rid"]: (a["ttft_ms"], m["ttft_ms"]) for a in agg_runs["batch"] for m in runs
            if a["rid"] == m["rid"]}
    summary = {
        "phase_s": time.time() - t0, "workers_up_s": t_up - t0, "traffic_s": t_traffic - t_up,
        "streams": held, "checksums": sums,
        "embed": {"cosine": cos, "ms": embed_ms},
        "ttft_ms": ttft,
        "ttft_ms_median": {"agg_tp1": float(np.median([a for a, _ in ttft.values()])),
                           "mesh": float(np.median([m for _, m in ttft.values()]))},
        "remote_prefills": remote, "imported_blocks": xfer["imported_blocks"],
        "handoff": {k: dis[k] for k in ("handoffs_started", "handoffs_streamed",
                                        "handoffs_fallback", "chunks_pulled")},
        # Where a TTFT goes: the prefill worker's waves (its engine loop's
        # wall), the decode worker's pulls (summed over the windows, which
        # overlap across requests).
        "prefill_loop_s": stats["prefill"][0]["prefill_loop_s"],
        "prefill_forwards": stats["prefill"][0]["forwards"],
        "pull_ms_total": pool["pull_ms_total"], "bytes_pulled": pool["bytes_pulled"],
        "ranks": ranks,
        "launches": {name: [{"ragged_paged_attention_decode_launch": r["decode_launches"],
                             "ragged_paged_attention_tiled_launch": r["tiled_launches"]}
                            for r in rs] for name, rs in ranks.items()},
    }
    print(f"mesh disagg phase on {card}: {remote} remote prefills on the tp = 2 worker, "
          f"{xfer['imported_blocks']} blocks imported into the pp = 2 worker; greedy streams "
          f"equal {held['equal']}/{held['streams']}; {len(sums)} pages equal through both "
          f"workers' kv_fetch; TTFT median {summary['ttft_ms_median']['mesh']:.1f} ms against "
          f"{summary['ttft_ms_median']['agg_tp1']:.1f} ms aggregated at tp = 1 (the prefill "
          f"worker's {summary['prefill_forwards']} waves {summary['prefill_loop_s']:.2f} s, the "
          f"pulls {pool['pull_ms_total']:.0f} ms for {pool['bytes_pulled'] / 1e6:.0f} MB; two ranks "
          f"time-sharing one card, eager, pages through host memory: a proof of the paths, not "
          f"a speed figure); workers up after {summary['workers_up_s']:.1f} s, traffic "
          f"{summary['traffic_s']:.1f} s, phase {summary['phase_s']:.1f} s", flush=True)
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


# The runner's prompts: 8 chat texts that, with the chat template and
# MAX_TOKENS new tokens, fit the default ``tiny`` preset's 256-token context.
RUNNER_PROMPT_LENS = (20, 40, 60, 80, 100, 120, 30, 50)


def runner_prompts() -> list[str]:
    """8 prompts of RUNNER_PROMPT_LENS characters as chat text (the runner
    takes text; a prompt of n lowercase letters and spaces is n tokens of
    the byte tokenizer, before the chat template)."""
    rng = np.random.default_rng(1234)
    alphabet = np.array(list("abcdefghijklmnopqrstuvwxyz     "))
    return ["".join(rng.choice(alphabet, n)) for n in RUNNER_PROMPT_LENS]


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


def doctor_and_runner(card: str, device: str | None = None) -> dict:
    """``python -m dynamo_tpu_torch.run --in batch --out torch`` with no
    ``--preset`` and no ``--device``: the defaults, the f32 ``tiny`` preset
    on the card (K1's generic instance; ``device`` names another device
    for a rehearsal), its worker warmed up as a default worker, on 8
    prompts, 64 tokens each; while its worker builds and warms up, ``--in
    batch --out echo``, ``--in text --out mocker --speedup-ratio 100`` and
    the doctor (:func:`doctor_phase`, its engine line the tiny preset on
    the card) run beside it. Each runner exits 0 with one completion per
    prompt; the torch run's worker start-up is split into its engine's
    build and warm-up (its own log line) and the rest, and its exit
    counters show K1's generic f32 instance, both kernels, launched once
    per layer of every forward."""
    from dynamo_tpu_torch.engine.config import PRESETS
    from dynamo_tpu_torch.ops import ragged_attention as ra

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
        cfg = PRESETS["tiny"]()  # the runner's default preset
        h = start_runner(batch_args("worker", ["--out", "torch", *(
            ["--device", device] if device else [])]), logs, "worker", r"serving model")
        with ThreadPoolExecutor(3) as pool:
            echo_f = pool.submit(lambda: finish_runner(start_runner(
                batch_args("echo", ["--out", "echo"]), logs, "echo"), 120))
            mock_f = pool.submit(lambda: finish_runner(start_runner(
                ["--in", "text", "--out", "mocker", "--speedup-ratio", "100",
                 "--prompt", prompts[2], "--max-tokens", "16"], logs, "mocker"), 120))
            doctor_f = pool.submit(doctor_phase, device or "cuda")
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
        kernels = stats["kernel_launches"]
        # Warm-up alone launches both K1 kernels: the traffic must have
        # run forwards of its own and committed a token for every prompt.
        if stats["forwards"] == 0 or stats["committed_tokens"] < len(prompts):
            raise AssertionError(f"the runner's worker served no traffic: {stats['forwards']} "
                                 f"forwards, {stats['committed_tokens']} tokens committed for "
                                 f"{len(prompts)} prompts")
        generic = [ra.GENERIC_INSTANCE_NAMES[k, "f32", False] for k in K1_KERNELS]
        if device is None and (
                stats["attention_launches"]
                != cfg.num_layers * (stats["forwards"] + stats["warm_up_forwards"])
                or min(kernels[k] for k in generic) == 0
                or sum(kernels[k] for k in generic) != stats["attention_launches"]):
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
              f"mocker {mock['stdout'].strip()!r} in {mock['wall_s']:.1f} s; torch with no "
              f"--preset and no --device (tiny, f32): {t['completions']} completions of "
              f"{MAX_TOKENS} tokens at most "
              f"({t['committed_tokens']} tokens committed) in {t['wall_s']:.1f} s; its worker served after {served:.1f} s (engine built in "
              f"{build_s:.2f} s, warmed up in {warm_s:.2f} s, the rest {t['rest_s']:.1f} s; the "
              f"echo and mocker runs and the doctor ran meanwhile; {cfg.num_layers} layers); "
              f"K1 launches {({k: n for k, n in kernels.items() if n})} = "
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
        # started together; the planted copies at a lower priority, each
        # awaited where its check first runs it.
        t0 = time.time()
        sources = ("ragged_paged_attention", "ragged_paged_attention_generic", "paged_attention")
        with ThreadPoolExecutor(len(sources)) as pool:
            built = pool.map(_build.load, sources)
            planted = build_planted(tmp)
            list(built)
        print(f"kernel build: {', '.join(f'{n}.cu' for n in sources)} in "
              f"{time.time() - t0:.1f} s; {len(planted)} planted-fault copies building",
              flush=True)

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
        t0 = time.time()
        tp_shapes, tp_faults = check_shard_attention(ra, planted, decode_lens, prompt_lens)
        shapes += tp_shapes
        print(f"K1 at a tp = 2 rank's llama3-8b shard (16/4 heads), with the planted faults: "
              f"{time.time() - t0:.1f} s", flush=True)
        t0 = time.time()
        pipe_shapes, pipe_faults = check_pipeline_attention(ra, planted, decode_lens, prompt_lens)
        shapes += pipe_shapes
        print(f"K1 at the pp = 2 and dp = 2 shapes (T = S = 4, a 4096-row microbatch), with the "
              f"planted faults: {time.time() - t0:.1f} s", flush=True)
        t0 = time.time()
        hd64_shapes, hd64_faults = check_head_dim64_attention(ra, planted, decode_lens, prompt_lens)
        print(f"K1's head_dim-64 instances at Llama-3.2-1B's 32/8 and Qwen2.5-0.5B's 14/2 heads, "
              f"bf16 and int8, with the planted faults: {time.time() - t0:.1f} s", flush=True)
        t0 = time.time()
        generic_shapes, generic_faults = check_generic_attention(ra, planted, decode_lens,
                                                                 prompt_lens)
        print(f"K1's generic instance (f32, fp16, bf16; head_dim 16, 96, 128, 256; groups 2-16), "
              f"with its planted faults: {time.time() - t0:.1f} s", flush=True)
        k2_shapes, k2_batches = check_paged_attention_kernel(pa)
        k2_faults = check_k2_planted_faults(pa, k2_batches, planted)
        del k2_batches
        torch.cuda.empty_cache()
        for fut in planted.values():
            fut.result()
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
        ep_ref = moe.pop("ep_reference")
        print(f"MoE summary: {json.dumps(moe)}", flush=True)
        gc.collect()
        torch.cuda.empty_cache()
        ep = serve_ep(card, ep_ref)
        lap("expert parallelism")
        print(f"ep summary: {json.dumps(ep)}", flush=True)
        qwen = serve_qwen2(ra, card)
        lap("Qwen2")
        print(f"Qwen2 summary: {json.dumps(qwen)}", flush=True)
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.time()
            gguf = gguf_round_trip(tmp)
            print(f"GGUF summary: {json.dumps(gguf)} in {time.time() - t0:.2f} s", flush=True)
        gc.collect()
        torch.cuda.empty_cache()
        llama32 = serve_llama32_1b(ra, card)
        lap("Llama-3.2-1B shape (head_dim 64)")
        print(f"llama3.2-1b summary: {json.dumps(llama32)}", flush=True)
        f32_presets = serve_f32_presets(ra, card)
        lap("tiny and tiny-moe in f32 (K1's generic instance)")
        print(f"f32 presets summary: {json.dumps(f32_presets)}", flush=True)
        generic_paths = serve_generic_shapes(ra, card)
        lap("Falcon3-7B, Mistral-Large-2 and fp16 shapes (K1's generic instance)")
        print(f"generic shapes summary: {json.dumps(generic_paths)}", flush=True)
        sla = sla_profile(card)
        lap("SLA profile")
        print(f"sla summary: {json.dumps(sla)}", flush=True)
        tp = serve_tp(card, ck["cut"]["dir"], reference[3])
        lap("tensor parallelism")
        print(f"tp summary: {json.dumps(tp)}", flush=True)
        pipe = serve_pipeline(card, ck["cut"]["dir"], reference[3])
        lap("pipeline and data parallelism")
        print(f"pipeline summary: {json.dumps(pipe)}", flush=True)
        print(f"before the sp phase: {memory_line()}", flush=True)
        sp = serve_sp(card, ck["dir"], reference[3])
        lap("sequence parallelism")
        print(f"sp summary: {json.dumps(sp)}", flush=True)
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
        agg_runs = disagg.pop("agg_runs")
        print(f"disagg summary: {json.dumps(disagg)}", flush=True)
        mesh_disagg = serve_mesh_disagg(card, ck["cut"]["dir"], agg_runs, reference[3]["embed"])
        lap("disaggregation on meshes")
        print(f"mesh disagg summary: {json.dumps(mesh_disagg)}", flush=True)
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
                name = ra.INSTANCE_NAMES[kernel, int8, 128]
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
                    # The tp worker's two ranks, warm-up included (each
                    # process starts with the counts at 0).
                    extra["tp_path_launches_by_rank"] = [r[name] for r in tp["launches"]]
                    extra["tp_shard_planted_faults_row_rel_err"] = {
                        f: tp_faults[f] for f in table[kernel]}
                    # The pp and dp workers' two ranks each, warm-up included.
                    extra["pp_path_launches_by_rank"] = [r[name] for r in pipe["pp"]["launches"]]
                    extra["dp_path_launches_by_rank"] = [r[name] for r in pipe["dp"]["launches"]]
                    extra["pipeline_planted_faults_row_rel_err"] = {
                        f: pipe_faults[f] for f in table[kernel]}
                    # The sp worker's two ranks and the EP worker's two,
                    # warm-up included.
                    extra["sp_path_launches_by_rank"] = [r[name] for r in sp["launches"]]
                    extra["ep_path_launches_by_rank"] = [r[name] for r in ep["launches"]]
                    # The mesh disaggregation phase's tp = 2 prefill and pp
                    # = 2 decode workers' ranks, warm-up included.
                    extra["mesh_disagg_launches_by_rank"] = {
                        role: [r[name] for r in rs]
                        for role, rs in mesh_disagg["launches"].items()}
                k1.append(kernel_entry(
                    name, k1_src, "dynamo_tpu/ops/ragged_attention.py:163", counts_of[name], own,
                    main_rec, pages="int8" if int8 else "bf16", head_dim=HEAD_DIM, **extra,
                    planted_faults_row_rel_err={f: planted_of[f] for f in table[kernel]},
                ))
        # The head_dim-64 instances: launches from the Llama-3.2-1B-shaped
        # phase (bf16 KV: its measured pass; int8 KV: its pass on the same
        # weights); main shapes the serving decode form for the decode
        # kernel and the 8192 wave for the tiled one.
        for int8, counts_of, table in ((False, llama32["launches"], PLANTED_FAULTS),
                                       (True, llama32["int8_launches"], PLANTED_FAULTS_INT8)):
            got = hd64_shapes["int8" if int8 else "bf16"]
            for kernel in K1_KERNELS:
                main_shape = ("hd64_prefill_wave8192" if kernel == "tiled"
                              else "hd64_decode_serving8")
                own = [x for x in got if x["kernel"] == kernel]
                main_rec = next(x for x in own if x["shape"] == main_shape)
                name = ra.INSTANCE_NAMES[kernel, int8, HD64]
                faults_of = hd64_faults["int8" if int8 else "bf16"]
                if int8:
                    bf16 = next(x for x in hd64_shapes["bf16"]
                                if x["kernel"] == kernel and x["shape"] == main_shape)
                    extra = {"int8_vs_bf16": main_rec["ms"] / bf16["ms"]}
                else:
                    extra = {"qwen25_planted_faults_row_rel_err": {
                        f: hd64_faults["qwen25"][f] for f in table[kernel]}}
                k1.append(kernel_entry(
                    name, k1_src, "dynamo_tpu/ops/ragged_attention.py:163", counts_of[name], own,
                    main_rec, pages="int8" if int8 else "bf16", head_dim=HD64, **extra,
                    planted_faults_row_rel_err={f: faults_of[f] for f in table[kernel]},
                ))
        # The generic instance's records: launches from the engine phases
        # that run each (the f32 tiny engine at the defaults and its int8 KV
        # one; Falcon3-7B's shape, bf16 and int8 KV, Mistral-Large-2's beside
        # it; llama3-8b's at fp16); main shapes the serving decode form for
        # the decode kernel and the largest wave for the tiled one.
        generic_src = f"dynamo_tpu_torch/csrc/{GENERIC_SRC}"
        falcon_run = generic_paths["falcon3-7b"]
        for tag, int8, counts_of, geometry in (
            ("f32", False, f32_presets["tiny"]["launches"], "f32 tiny"),
            ("f32", True, f32_presets["tiny int8 KV"]["launches"], "f32 tiny int8"),
            ("f16", False, generic_paths["llama3-8b-fp16"]["launches"], "fp16 llama3-8b"),
            ("bf16", False, falcon_run["launches"], "bf16 falcon3"),
            ("bf16", True, falcon_run["int8_launches"], "bf16 falcon3 int8"),
        ):
            for kernel in K1_KERNELS:
                name = ra.GENERIC_INSTANCE_NAMES[kernel, tag, int8]
                own = [x for x in generic_shapes if x["entry"] == name]
                main_rec = max((x for x in own if x["geometry"] == geometry),
                               key=lambda x: x["T"] if kernel == "tiled" else -x["T"])
                extra = {}
                if name in generic_paths["mistral-large-2407"]["launches"]:
                    extra["mistral_large_2_path_launches"] = (
                        generic_paths["mistral-large-2407"]["launches"][name])
                if not int8 and tag == "f32":
                    extra["f32_preset_path_launches"] = {
                        label: r["launches"].get(name, 0) for label, r in f32_presets.items()
                        if isinstance(r, dict)}
                    # The runner's worker (its defaults: tiny, f32), warm-up included.
                    extra["runner_phase_launches"] = runner["torch"]["kernel_launches"][name]
                k1.append(kernel_entry(
                    name, generic_src, "dynamo_tpu/ops/ragged_attention.py:163", counts_of[name],
                    own, main_rec, pages="int8" if int8 else tag, head_dim=main_rec["head_dim"],
                    row_rel_tol=main_rec["row_rel_tol"], **extra,
                    planted_faults_row_rel_err_over_limit={
                        f: generic_faults[f] for f in (PLANTED_FAULTS_GENERIC_INT8 if int8
                                                       else PLANTED_FAULTS_GENERIC)}))
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
    if sys.argv[1:2] == ["--tp-logits-rank"]:
        sys.exit(tp_logits_rank(int(sys.argv[2]), *sys.argv[3:6]))
    if sys.argv[1:2] == ["--pipeline-logits-rank"]:
        sys.exit(pipeline_logits_rank(int(sys.argv[2]), *sys.argv[3:6]))
    if sys.argv[1:2] == ["--sp-logits-rank"]:
        sys.exit(sp_logits_rank(int(sys.argv[2]), *sys.argv[3:6]))
    if sys.argv[1:2] == ["--ep-logits-rank"]:
        sys.exit(ep_logits_rank(int(sys.argv[2]), *sys.argv[3:6]))
    sys.exit(main())
