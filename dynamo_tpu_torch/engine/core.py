"""EngineCore: continuous-batching scheduler on one device.

Counterpart of ``dynamo_tpu/engine/core.py`` for its waves and chunked
schedulers, synchronous or asynchronous execution, bf16 (model-dtype) or
int8 KV pages, plain or int8 weights, no speculation, decode megasteps of
k iterations. One ``step()`` is one engine iteration: drain new requests,
admit under a free-block watermark (reusing cached prefix blocks), then
dispatch. Under ``waves`` that is one ragged prefill wave or one decode
megastep for every running sequence; under ``chunked`` every runnable
decode row rides next to prefill chunks in one ragged forward under the
token budget (:meth:`EngineCore._plan_mixed`), fused with k - 1 decode
iterations where k > 1 (:func:`_megastep_fused_body`), and a step with
no prompt to prefill is a decode megastep. All of it rides the SAME ragged
forward (``model.forward_tokens``); total tokens snap to
``prefill_buckets`` and row counts to ``decode_buckets`` (a wave's to
``prefill_batch``), exactly as the JAX engine pads them, so both engines
run the same shapes and the same block layout.

The decode megastep (:func:`_megastep_body`) is a loop of k decode+sample
iterations over device tensors: sampled tokens feed the next iteration on
the device, stop flags stay on the device, and the host reads the
``[k, B]`` token block once per megastep. On the card each megastep, each
prefill wave and each mixed step is the replay of a CUDA graph captured
once per static key (``engine/graphs.py``), the counterpart of the JAX
engine's jitted programs; on the CPU the bodies run eagerly.

A step is planned and dispatched, then committed (:class:`_PlannedStep`).
With ``async_exec`` the engine keeps one step in flight: it plans and
dispatches step N+1 against the optimistic overlays of step N (cursor
advances, and the sampled tokens gathered on the device), then commits
step N while N+1 runs. The token streams are the synchronous loop's.

Settings outside this slice are refused by name with the ``ROADMAP.md``
item that brings them; nothing is silently substituted.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from dynamo_tpu_torch import tracing
from dynamo_tpu_torch.engine.block_allocator import DeviceBlockAllocator, OutOfBlocksError
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.fair_queue import FairQueue
from dynamo_tpu_torch.engine.graphs import GraphCache, Launch, Layout
from dynamo_tpu_torch.engine.kv_quant import KV_DTYPES, kv_page_bytes
from dynamo_tpu_torch.engine.model import (
    decode_tokens,
    forward_tokens,
    init_cache,
    init_params,
)
from dynamo_tpu_torch.engine.sampler import (
    gather_feedback,
    resolve_verify,
    sample_seeded,
    stop_flags,
    stop_flags_prefix,
    token_logprobs,
)
from dynamo_tpu_torch.llm.protocols.common import (
    FinishReason,
    LLMEngineOutput,
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.llm.kv_router.protocols import ForwardPassMetrics, KvStats, WorkerStats
from dynamo_tpu_torch.obs.flight_recorder import FlightRecorder
from dynamo_tpu_torch.ops import ragged_attention
from dynamo_tpu_torch.runtime.engine import EngineOverloadedError
from dynamo_tpu_torch.tokens import TokenBlockSequence, compute_seq_hashes

log = logging.getLogger("dynamo_tpu_torch.engine")


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. ``cuda`` without a card raises:
    the port never moves to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' but torch.cuda.is_available() is False; pass "
            "device='cpu' to run the plain PyTorch versions on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (expected cuda or cpu)")
    return dev


def check_slice(model_cfg: ModelConfig, engine_cfg: EngineConfig) -> None:
    """Refuse every setting the port does not serve yet, naming the
    ``ROADMAP.md`` item that brings it, a KV dtype or scheduler that does
    not exist, and chunked-scheduling sizes the JAX engine refuses."""
    if engine_cfg.kv_dtype not in KV_DTYPES:
        raise ValueError(
            f"unknown kv_dtype {engine_cfg.kv_dtype!r} (expected one of {KV_DTYPES})"
        )
    refusals = [
        (engine_cfg.spec_decode != "off",
         f"spec_decode={engine_cfg.spec_decode!r}", "A8c"),
        (engine_cfg.host_kv_blocks > 0 or bool(engine_cfg.disk_kv_dir),
         "host/disk KV tiers (host_kv_blocks, disk_kv_dir)", "A10"),
        (engine_cfg.ring_prefill_threshold > 0,
         "ring_prefill_threshold > 0 (sequence-parallel prefill)", "A12"),
        (model_cfg.is_moe, f"MoE model {model_cfg.name!r}", "A11"),
    ]
    for refused, what, item in refusals:
        if refused:
            raise ValueError(f"{what} is not ported yet (ROADMAP.md {item})")
    bs = engine_cfg.block_size
    if engine_cfg.scheduling not in ("waves", "chunked"):
        raise ValueError(
            f"unknown scheduling policy {engine_cfg.scheduling!r} (expected 'waves' or 'chunked')"
        )
    if engine_cfg.prefill_chunk and engine_cfg.prefill_chunk % bs:
        raise ValueError(
            f"prefill_chunk {engine_cfg.prefill_chunk} not a multiple of block_size {bs} "
            "(chunk boundaries must respect block granularity so both schedulers "
            "commit identical layouts)"
        )
    if engine_cfg.max_num_batched_tokens > engine_cfg.prefill_buckets[-1]:
        raise ValueError(
            f"max_num_batched_tokens {engine_cfg.max_num_batched_tokens} exceeds the largest "
            f"prefill bucket {engine_cfg.prefill_buckets[-1]} (mixed steps bucket their "
            "total tokens)"
        )
    if engine_cfg.prefill_chunk > engine_cfg.token_budget:
        raise ValueError(
            f"prefill_chunk {engine_cfg.prefill_chunk} exceeds the per-step token budget "
            f"{engine_cfg.token_budget}"
        )
    if engine_cfg.scheduling == "chunked" and (
        engine_cfg.token_budget < engine_cfg.decode_buckets[-1] + bs
    ):
        raise ValueError(
            f"max_num_batched_tokens {engine_cfg.token_budget} cannot fit the decode width "
            f"{engine_cfg.decode_buckets[-1]} plus one {bs}-token prefill chunk; raise the "
            "budget or shrink decode_buckets"
        )


def _check_params(params: dict, device: torch.device) -> None:
    """Every leaf is a tensor, or an int8 ``{w: int8, scale: f32}`` pair,
    on the engine's device."""
    leaves = [params["embed"], params["final_norm"], *params["layers"].values()]
    if "lm_head" in params:
        leaves.append(params["lm_head"])
    tensors = []
    for w in leaves:
        if isinstance(w, dict):
            if set(w) != {"w", "scale"} or w["w"].dtype != torch.int8:
                raise ValueError(
                    f"a quantized weight is {{w: int8, scale: f32}}, got "
                    f"{ {k: getattr(v, 'dtype', type(v)) for k, v in w.items()} }"
                )
            tensors += [w["w"], w["scale"]]
        else:
            tensors.append(w)
    for w in tensors:
        if w.device.type != device.type:
            raise ValueError(f"params live on {w.device}, the engine on {device}")


@dataclass
class Sequence:
    request_id: str
    prompt: list[int]
    sampling: SamplingOptions
    stop: StopConditions
    seed: int
    # Requested top-k logprob alternatives; None = logprobs off.
    logprobs: int | None = None
    # -- device-cache bookkeeping --
    prompt_hashes: list[int] = field(default_factory=list)
    block_ids: list[int] = field(default_factory=list)
    hashed: TokenBlockSequence | None = None   # tokens whose K/V is written
    pinned_hashes: list[int] = field(default_factory=list)
    committed_blocks: int = 0                  # prefix of block_ids committed
    num_cached_tokens: int = 0
    # -- progress --
    prefilled: int = 0      # prompt tokens with K/V written
    processed: int = 0      # all tokens with K/V written
    pending: int | None = None  # sampled, not yet processed
    generated: int = 0
    finish: str | None = None
    cancelled: bool = False
    emitted_first: bool = False
    t_queued: float = 0.0       # wall-clock at enqueue into the scheduler
    t_first_sched: float = 0.0  # first chunk dispatched to the device
    # -- overload robustness --
    tenant_id: str = ""
    priority: int = 0
    deadline_epoch: float | None = None

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    @property
    def prefill_done(self) -> bool:
        return self.prefilled >= self.prompt_len


def _lp_entry(token: int, chosen, top_ids, top_lps, k: int) -> dict:
    """Host-side logprob record for one emitted token, sliced to the k the
    request asked for. ``top`` is [[token_id, logprob], ...] (descending)."""
    k = min(k, len(top_ids))
    return {
        "token_id": token,
        "logprob": float(chosen),
        "top": [[int(top_ids[j]), float(top_lps[j])] for j in range(k)],
    }


@dataclass
class _RaggedBatch:
    """Host-assembled inputs of one ragged forward over arbitrary rows
    (:meth:`EngineCore._assemble_ragged`): a prefill wave, a mixed step,
    and the fused megastep's first iteration."""

    T: int
    tokens: np.ndarray
    positions: np.ndarray
    write_pages: np.ndarray
    write_offs: np.ndarray
    kv_lens: np.ndarray
    tables: np.ndarray
    cu: np.ndarray
    last_rows: np.ndarray
    counters: np.ndarray
    seeds: np.ndarray
    temp: np.ndarray
    top_k: np.ndarray
    top_p: np.ndarray
    # [T]: flat index into the in-flight step's sampled tokens of the
    # token at that slot, or -1 (the host value stands).
    feed_idx: np.ndarray
    need_mask: bool
    want_lp: bool
    all_greedy: bool
    num_rows: int


# Static width of the per-lane on-device stop-watch array ([B, W], -1
# padded): EOS ids + stop_token_ids. A lane with more watch ids forces its
# batch to k=1, where the host stop-scan checks the full list every token.
MEGASTEP_WATCH_W = 8

# One request of each sampling variant a dispatch's graph key names
# (need_mask, all_greedy, want_logprobs): greedy, plain temperature, or
# top-k/top-p masked, each with and without logprobs.
WARM_UP_VARIANTS = tuple(
    (sampling, logprobs)
    for sampling in (
        SamplingOptions(temperature=0.0),
        SamplingOptions(temperature=1.0),
        SamplingOptions(temperature=1.0, top_k=50, top_p=0.9),
    )
    for logprobs in (None, 1)
)


def _megastep_body(
    params, cache, tokens, block_tables, positions, active,
    seeds, counters, temperature, top_k, top_p,
    watch, budgets, min_left,
    *, n_steps, need_mask, all_greedy=False, want_logprobs=False,
    cfg, engine,
):
    """The decode MEGASTEP: ``n_steps`` decode+sample iterations enqueued
    back to back with no host synchronisation. Each iteration writes the
    current token's K/V, attends, samples the next token with key
    ``(seed, counter + i)`` — which feeds the next iteration on the device
    — and updates per-lane stop flags: a lane that samples a watched stop
    id or exhausts its budget runs its remaining iterations as masked
    no-ops (K/V writes to the garbage block, position frozen, output
    padded with its last live token). Returns ([n_steps, B] tokens,
    stacked logprob arrays or None); the host stop-scan stays the
    authority over what is emitted."""
    toks, pos = tokens, positions
    alive = torch.ones_like(active)
    out, lps = [], []
    for i in range(n_steps):
        act = active & alive
        logits = decode_tokens(params, cache, toks, block_tables, pos, act, cfg, engine)
        nxt = sample_seeded(
            logits, seeds, counters + i, temperature, top_k, top_p,
            need_mask=need_mask, all_greedy=all_greedy,
        )
        toks = torch.where(act, nxt, toks)
        if want_logprobs:
            lps.append(token_logprobs(logits, toks))
        alive = alive & ~stop_flags(nxt, watch, budgets, min_left, i)
        pos = pos + act.to(torch.int32)
        out.append(toks)
    lp = tuple(torch.stack(a) for a in zip(*lps)) if want_logprobs else None
    return torch.stack(out), lp


def _prefill_and_sample(
    params, cache, tokens, positions, write_pages, write_offs,
    kv_lens, block_tables, cu_q_lens, num_seqs, last_rows,
    seeds, counters, temperature, top_k, top_p,
    *, need_mask, all_greedy=False, want_logprobs=False, cfg,
):
    """One ragged prefill wave + first-token sampling of every row of the
    [S, vocab] last-token logits; the host keeps only rows whose prompt
    completed this wave."""
    logits = forward_tokens(
        params, cache, tokens, positions, write_pages, write_offs,
        kv_lens, block_tables, cu_q_lens, num_seqs, last_rows, cfg,
    )
    toks = sample_seeded(
        logits, seeds, counters, temperature, top_k, top_p,
        need_mask=need_mask, all_greedy=all_greedy,
    )
    lps = token_logprobs(logits, toks) if want_logprobs else None
    return toks, lps


def _megastep_fused_body(
    params, cache,
    # -- iteration 0: the ragged forward (exactly a mixed step's)
    tokens, positions, write_pages, write_offs, kv_lens, block_tables,
    cu_q_lens, num_seqs, gather,
    seeds_r, counters_r, temp_r, top_k_r, top_p_r,
    # -- per-lane continuation state ([S] unless noted)
    draft, draft_len,        # [S, R-1] drafted tokens, live length
    cont_active,             # bool: the lane continues as a decode row
    base_pos,                # write position of the first continuation write at acc=0
    seeds, temp, top_k, top_p,
    watch, budgets, min_left,
    *, n_steps, need_mask, all_greedy=False, want_logprobs=False,
    cfg, engine,
):
    """The UNIVERSAL megastep: one dispatch runs a ragged first iteration
    over prefill chunks and decode rows (a mixed step's forward and
    sampling) and then ``n_steps - 1`` decode+sample iterations over the
    same lanes. Iteration 0 samples the ``[S, R]`` sample slots with
    ``(seed, counter + j)`` keys and each lane resolves on the device
    (:func:`resolve_verify`; at R = 1, the engine's only width until
    speculative decoding lands, every lane continues from its one sample).
    A decode row continues from its sampled token; a prefill chunk that
    completes its prompt continues as a decode row from its first token;
    a mid-prompt chunk (``cont_active`` False) runs the remaining
    iterations as masked no-ops, writing only the garbage block and never
    advancing a cursor. The stop state (watch ids, budget, min-tokens
    floor) carries iteration 0's emission count.

    Returns (sampled ``[n_steps, S, R]``: iteration 0 fills the sample
    width, later iterations broadcast their token across it; matching
    logprob arrays or None). The host stop-scan stays the authority, as
    in :func:`_megastep_body`."""
    logits = forward_tokens(
        params, cache, tokens, positions, write_pages, write_offs,
        kv_lens, block_tables, cu_q_lens, num_seqs, gather, cfg,
    )
    t0 = sample_seeded(
        logits, seeds_r, counters_r, temp_r, top_k_r, top_p_r,
        need_mask=need_mask, all_greedy=all_greedy,
    )
    lp0 = token_logprobs(logits, t0) if want_logprobs else None
    S = draft.shape[0]
    R = t0.shape[0] // S
    t0s = t0.reshape(S, R)
    acc, tok = resolve_verify(t0s, draft, draft_len)
    alive = cont_active & ~stop_flags_prefix(t0s, acc, watch, budgets, min_left)
    gen = torch.where(cont_active, acc + 1, 0).to(torch.int32)  # tokens iteration 0 produced
    pos = base_pos + acc                                        # next write position
    counters0 = counters_r.reshape(S, R)[:, 0]                  # per-lane generated base
    rest, rest_lp = [], []
    for _ in range(n_steps - 1):
        act = alive
        logits = decode_tokens(params, cache, tok, block_tables, pos, act, cfg, engine)
        nxt = sample_seeded(
            logits, seeds, counters0 + gen, temp, top_k, top_p,
            need_mask=need_mask, all_greedy=all_greedy,
        )
        tok = torch.where(act, nxt, tok)
        if want_logprobs:
            rest_lp.append(token_logprobs(logits, tok))
        gen = gen + act.to(torch.int32)
        stop = ((nxt[:, None] == watch).any(dim=1) & (gen >= min_left)) | (gen >= budgets)
        alive = alive & ~stop
        pos = pos + act.to(torch.int32)
        rest.append(tok)

    def widen(a0, ar):
        # a0: [S*R(, K)] iteration-0 slots; ar: n_steps - 1 of [S(, K)]
        a0 = a0.reshape((1, S, R) + a0.shape[1:])
        if not ar:
            return a0
        ar = torch.stack(ar)[:, :, None]
        return torch.cat([a0, ar.expand((n_steps - 1, S, R) + ar.shape[3:])])

    lps = None
    if want_logprobs:
        lps = tuple(widen(a0, [r[j] for r in rest_lp]) for j, a0 in enumerate(lp0))
    return widen(t0, rest), lps


class _NeedDrain(Exception):
    """Plan-time block growth failed while a step is in flight: the
    planner must not preempt over uncommitted state (the victim's emitted
    tokens may still be on the device), so the async loop commits the
    in-flight step and re-plans from settled state, where normal
    preemption applies."""


class _NeedCapture(Exception):
    """A dispatch needs a CUDA graph that is not captured yet while a step
    is in flight: capture synchronises the card, so the async loop
    commits the in-flight step first and re-plans; the re-plan captures
    with nothing in flight."""


class _PendingFetch:
    """In-flight device outputs of ONE dispatch and their copies to the
    host. Construction enqueues a non-blocking copy of every output into
    pinned host tensors owned by this fetch and records an event after
    them, so by the time :meth:`land` waits (one step later under async
    execution) the bytes have been streaming while the next step
    computes. ``land`` waits on that event only. On the CPU the outputs
    are host tensors already and landing is a copy."""

    def __init__(self, core: "EngineCore", outs: tuple):
        self.core = core
        self.toks = outs[0]  # device-resident: the next dispatch's feed source
        self.no = core._note_dispatch()
        self._event = None
        if self.toks.is_cuda:
            self._host = tuple(
                torch.empty(o.shape, dtype=o.dtype, pin_memory=True).copy_(o, non_blocking=True)
                for o in outs
            )
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = outs

    def land(self):
        """([tokens], logprob arrays or None) as numpy."""
        core = self.core
        if core._exec_log is not None:
            core._exec_log.append(("land", self.no))
        if self._event is not None:
            self._event.synchronize()
        toks, *lps = (h.numpy().copy() for h in self._host)
        return toks, tuple(lps) if lps else None


@dataclass
class _PlannedStep:
    """One planned-and-dispatched engine step awaiting commit.

    The plan side assembles host arrays and enqueues the device work; the
    commit side lands the outputs and applies every piece of host
    bookkeeping (block commits, cursor advances, stop scans, stream
    emission). With ``async_exec`` off, commit runs right after plan. With
    it on, the engine keeps ONE of these in flight and plans step N+1
    against the optimistic ``adv`` overlays before committing step N.
    """

    core: "EngineCore"
    commit_fn: Callable[[], list]
    # Optimistic per-lane deltas this step applies once committed:
    # request_id -> (d_prefilled, d_processed, d_generated). The next
    # plan reads real state + adv while this step is in flight.
    adv: dict[str, tuple[int, int, int]] = field(default_factory=dict)
    # Device-resident sampled tokens of this step (flat [S] or
    # [n_steps, B]) and request_id -> flat index of each lane's newest
    # token: the next dispatch's token buffer gathers from here on device.
    feed_tokens: Any = None
    feed_index: dict[str, int] = field(default_factory=dict)
    # request_id -> (start, stride, count): this step's whole per-lane
    # emission as flat indices into feed_tokens, in stream order. Its
    # reader, the on-device drafter's history ring, comes with
    # speculative decoding (ROADMAP.md A8c).
    feed_series: dict[str, tuple[int, int, int]] = field(default_factory=dict)
    kind: str = ""  # "prefill", "decode" or "mixed": what the engine loop's time is filed under
    committed: bool = False

    def commit(self) -> list:
        if self.committed:
            return []
        self.committed = True
        t0 = time.time()
        out = self.commit_fn()
        core = self.core
        core.exec_stats["commits"] += 1
        core._committed_kinds.append(self.kind)
        core._tracer.record(
            "engine_commit", t0, time.time(),
            attrs={"outputs": len(out)}, stat=True,
        )
        return out


# The packed inputs of a decode megastep, a prefill wave, a mixed step and
# a fused megastep (engine/graphs.py): one layout per width, one per
# (bucket, rows).
def _decode_layout(B: int, P: int) -> Layout:
    return Layout([
        ("tokens", (B,), "i"), ("feed_idx", (B,), "i"), ("block_tables", (B, P), "i"),
        ("positions", (B,), "i"), ("active", (B,), "b"), ("seeds", (B,), "i"),
        ("counters", (B,), "i"), ("temperature", (B,), "f"), ("top_k", (B,), "i"),
        ("top_p", (B,), "f"), ("watch", (B, MEGASTEP_WATCH_W), "i"),
        ("budgets", (B,), "i"), ("min_left", (B,), "i"),
    ])


def _prefill_layout(T: int, S: int, P: int) -> Layout:
    return Layout([
        ("tokens", (T,), "i"), ("positions", (T,), "i"), ("write_pages", (T,), "i"),
        ("write_offs", (T,), "i"), ("kv_lens", (S,), "i"), ("block_tables", (S, P), "i"),
        ("cu_q_lens", (S + 1,), "i"), ("num_seqs", (1,), "i"), ("last_rows", (S,), "i"),
        ("seeds", (S,), "i"), ("counters", (S,), "i"), ("temperature", (S,), "f"),
        ("top_k", (S,), "i"), ("top_p", (S,), "f"),
    ])


def _mixed_layout(T: int, S: int, P: int) -> Layout:
    """A prefill wave's fields plus ``feed_idx``: decode rows read their
    token from the in-flight step's output on the device."""
    return Layout([*_prefill_layout(T, S, P).spec, ("feed_idx", (T,), "i")])


def _fused_layout(T: int, S: int, P: int) -> Layout:
    """A mixed step's fields plus each lane's continuation state."""
    return Layout([
        *_mixed_layout(T, S, P).spec, ("cont_active", (S,), "b"), ("base_pos", (S,), "i"),
        ("watch", (S, MEGASTEP_WATCH_W), "i"), ("budgets", (S,), "i"), ("min_left", (S,), "i"),
    ])


class EngineCore:
    def __init__(
        self,
        model_cfg: ModelConfig,
        engine_cfg: EngineConfig,
        params: Any = None,
        seed: int = 0,
        eos_token_ids: tuple[int, ...] = (),
        device="cuda",
        mesh: Any = None,
        on_stored: Callable[[list[int], int | None], None] | None = None,
        on_removed: Callable[[list[int]], None] | None = None,
    ):
        """``params`` is a parameter dict on ``device`` (``engine/convert``
        or a previous engine's ``core.params``); None initialises random
        weights from ``seed``. ``mesh`` exists to be refused: the port
        serves one device until parallelism lands. ``on_stored`` and
        ``on_removed`` receive the allocator's KV events (block hashes
        committed under a parent, hashes evicted), called on the thread
        that runs ``step()``."""
        if mesh is not None:
            raise ValueError("device meshes are not ported yet (ROADMAP.md A12)")
        check_slice(model_cfg, engine_cfg)
        bs = engine_cfg.block_size
        for b in engine_cfg.prefill_buckets:
            if b % bs:
                raise ValueError(f"prefill bucket {b} not a multiple of block_size {bs}")
        if engine_cfg.megastep_k < 0:
            raise ValueError(
                f"megastep_k must be >= 0 (0 inherits decode_chain, 1 "
                f"disables fusion), got {engine_cfg.megastep_k}"
            )
        if engine_cfg.max_waiting < 0:
            raise ValueError(
                f"max_waiting must be >= 0 (0 = unbounded), got {engine_cfg.max_waiting}"
            )
        if engine_cfg.fair_quantum < 0:
            raise ValueError(
                f"fair_quantum must be >= 0 (0 = token budget), got {engine_cfg.fair_quantum}"
            )
        self.device = resolve_device(device)
        self.cfg = model_cfg
        self.engine = engine_cfg
        self.eos_token_ids = set(eos_token_ids)
        if params is None:
            params = init_params(model_cfg, seed, self.device)
        _check_params(params, self.device)
        self.params = params
        self.cache = init_cache(model_cfg, engine_cfg, self.device)
        self.allocator = DeviceBlockAllocator(
            engine_cfg.num_kv_blocks,
            bs,
            enable_prefix_caching=engine_cfg.enable_prefix_caching,
            on_stored=on_stored,
            on_removed=on_removed,
        )
        self._inbox: deque[Sequence] = deque()   # thread-safe enqueue
        self.waiting: FairQueue = FairQueue(
            quantum=engine_cfg.fair_quantum_resolved,
            fair=engine_cfg.fair_scheduling,
            cost_fn=lambda s: s.prompt_len,
        )
        self.running: list[Sequence] = []
        # Typed rejections from the queue sweep (deadline expiry),
        # delivered with the step's outputs.
        self._shed_outputs: list[tuple[Sequence, LLMEngineOutput]] = []
        self._max_waiting = engine_cfg.max_waiting
        self.iterations = 0
        # Step-level spans (engine_prefill_step / engine_decode_step /
        # engine_megastep / engine_commit / host_gap ...), stat spans of
        # the "engine" service; queue-wait spans under "sched", so the
        # facade's per-request sched_admit twin is not counted twice.
        self._tracer = tracing.get_tracer("engine")
        self._sched_tracer = tracing.get_tracer("sched")
        self._req_counter = 0
        self._lock = threading.Lock()
        self._step_lock = threading.Lock()
        self.sched_stats = {
            "preemptions": 0,
            # Set by mixed (chunked) steps only; waves leave them at 0 as
            # the JAX engine does.
            "mixed_steps": 0,
            "last_step_batched_tokens": 0,
            "last_step_budget_utilization": 0.0,
            "chunked_prefills_in_flight": 0,
            "shed_total": 0,
            "deadline_expired_total": 0,
        }
        # Disaggregated KV transfer accounting, reported in
        # ForwardPassMetrics.transfer; the transfer path waits for A10.
        self.transfer_stats = {
            "transfers": 0,
            "imported_blocks": 0,
            "skipped_cached_blocks": 0,
            "dropped_blocks": 0,
            "partial_transfers": 0,
        }
        # At most ONE step is in flight under async execution.
        self._inflight: _PlannedStep | None = None
        self.exec_stats = {
            "dispatches": 0,
            "commits": 0,
            # Forced pipeline flushes: block pressure mid-plan with a step
            # in flight.
            "drains": 0,
            # Host wall time between consecutive dispatch enqueues.
            "last_host_gap_ms": 0.0,
            "megastep_dispatches": 0,
            "single_step_dispatches": 0,
            "committed_tokens": 0,
            # Fused megasteps whose first iteration carried prefill chunks
            # (verify rows wait for A8c), and pipeline-parallel dispatches
            # (A12, 0 until ported).
            "fused_mixed_dispatches": 0,
            "megastep_forced_single": 0,
            "pp_fused_dispatches": 0,
            "pp_forced_single": 0,
            # Model forwards: one per prefill wave, one per decode
            # iteration. Every forward runs the attention kernel once per
            # layer on the card (its int8 instance for int8 pages).
            "forwards": 0,
            "prefill_tokens": 0,
            "decode_iterations": 0,
            # Host wall time from dispatch to landed outputs, per kind;
            # under async execution consecutive spans overlap.
            "prefill_s": 0.0,
            "decode_s": 0.0,
            # Wall time of the step() calls that committed a prefill wave
            # or a decode megastep: the engine loop's own time per kind,
            # which does not overlap (decode ms per iteration =
            # decode_loop_s / decode_iterations).
            "prefill_loop_s": 0.0,
            "decode_loop_s": 0.0,
            # Mixed steps and fused megasteps (chunked scheduling): the
            # real tokens of their ragged iteration and its token bucket
            # (their ratio is the padding the buckets cost), and the
            # engine loop's time.
            "mixed_tokens": 0,
            "mixed_bucket_tokens": 0,
            "mixed_loop_s": 0.0,
        }
        # Crash/stall flight recorder: one record per step with outputs,
        # appended on the commit side; the worker renames it to its id.
        self.flight = FlightRecorder(f"engine-{id(self) & 0xFFFF:04x}")
        # Test hook: set to [] to record ("dispatch", n) / ("land", n)
        # events; under async execution dispatch n+1 precedes the landing
        # of step n's outputs in steady-state decode.
        self._exec_log: list[tuple[str, int]] | None = None
        self._dispatch_no = 0
        self._t_prev_dispatch = 0.0
        # CUDA graphs of the megastep and the prefill wave (the card only).
        self._graphs = GraphCache()
        self._committed_kinds: list[str] = []  # kinds of the steps the current step() committed
        self._admit_prefix_queries = 0
        self._admit_prefix_hits = 0
        self._forced_single_iter = -1
        self._watch_overflow_warned = False

    # -- request intake (any thread) --------------------------------------

    def add_request(self, pre: PreprocessedRequest) -> Sequence:
        limit = self._max_waiting
        if limit and (len(self._inbox) + len(self.waiting)) >= limit:
            with self._lock:
                self.sched_stats["shed_total"] += 1
            raise EngineOverloadedError(
                f"scheduler queue full ({limit} requests waiting); "
                f"retry on another instance"
            )
        if (pre.kv_transfer_params or {}).get("do_remote_decode"):
            raise ValueError("disaggregated prefill is not ported yet (ROADMAP.md A10)")
        if pre.spec_decode and pre.spec_decode.get("method", "off") != "off":
            raise ValueError("speculative decoding is not ported yet (ROADMAP.md A8c)")
        if pre.mm and pre.mm.get("embeds") is not None:
            raise ValueError("multimodal embeddings are not ported yet (ROADMAP.md A11)")
        with self._lock:
            self._req_counter += 1
            n = self._req_counter
        seed = pre.sampling.seed if pre.sampling.seed is not None else n
        # Seeds ride int32 device arrays; fold 64-bit client seeds in.
        seed = (seed ^ (seed >> 31)) & 0x7FFFFFFF
        seq = Sequence(
            request_id=pre.request_id or f"req-{n}",
            prompt=list(pre.token_ids),
            sampling=pre.sampling,
            stop=pre.stop,
            seed=seed,
            logprobs=pre.output.logprobs,
        )
        if not seq.prompt:
            raise ValueError("empty prompt")
        limit = self.engine.max_model_len
        if seq.prompt_len >= limit:
            raise ValueError(
                f"prompt of {seq.prompt_len} tokens exceeds max_model_len {limit}"
            )
        # Clamp the generation budget to the context window (vLLM semantics).
        budget = limit - seq.prompt_len
        if seq.stop.max_tokens is None or seq.stop.max_tokens > budget:
            seq.stop = type(seq.stop)(
                max_tokens=budget,
                min_tokens=seq.stop.min_tokens,
                stop=seq.stop.stop,
                stop_token_ids=seq.stop.stop_token_ids,
                ignore_eos=seq.stop.ignore_eos,
            )
        seq.tenant_id = pre.tenant_id or ""
        seq.priority = pre.priority or 0
        if pre.deadline_epoch is not None:
            seq.deadline_epoch = pre.deadline_epoch
        elif pre.deadline_ms is not None and pre.deadline_ms > 0:
            seq.deadline_epoch = time.time() + pre.deadline_ms / 1000.0
        seq.t_queued = time.time()
        self._inbox.append(seq)
        return seq

    def cancel_request(self, seq: Sequence) -> None:
        seq.cancelled = True

    # -- scheduling --------------------------------------------------------

    def has_work(self) -> bool:
        # An in-flight step is work: its outputs (possibly a stream's
        # final tokens) are not committed until the next step() call.
        return bool(
            self._inbox or self.waiting or self.running
            or self._inflight is not None
        )

    # -- optimistic overlays (async planning) -------------------------------

    def _adv3(self, seq: Sequence) -> tuple[int, int, int]:
        """Optimistic (prefilled, processed, generated) deltas the
        in-flight step will apply to this sequence once committed:
        (0, 0, 0) with an empty pipeline, so every plan-time computation
        reads ``real + _adv3`` and is identical to the synchronous loop."""
        if self._inflight is None:
            return (0, 0, 0)
        return self._inflight.adv.get(seq.request_id, (0, 0, 0))

    def _eff_prefill_done(self, seq: Sequence) -> bool:
        return seq.prefilled + self._adv3(seq)[0] >= seq.prompt_len

    def _eff_processed(self, seq: Sequence) -> int:
        return seq.processed + self._adv3(seq)[1]

    def _eff_generated(self, seq: Sequence) -> int:
        return seq.generated + self._adv3(seq)[2]

    def _feed_src(self, seq: Sequence) -> int | None:
        """Flat index of this lane's newest sampled token in the in-flight
        step's device output, or None when the pending token is committed
        on the host."""
        if self._inflight is None:
            return None
        return self._inflight.feed_index.get(seq.request_id)

    def _note_dispatch(self) -> int:
        """Dispatch-side bookkeeping: the sequence number feeds the test
        hook, and the host wall-clock gap between consecutive dispatch
        enqueues is recorded as the ``host_gap`` stat: an upper bound on
        device idle when the pipeline is empty, covered by the in-flight
        step when it is not (``overlapped``)."""
        self._dispatch_no += 1
        self.exec_stats["dispatches"] += 1
        now = time.time()
        if self._t_prev_dispatch:
            self.exec_stats["last_host_gap_ms"] = (now - self._t_prev_dispatch) * 1e3
            self._tracer.record(
                "host_gap", self._t_prev_dispatch, now,
                attrs={
                    "dispatch": self._dispatch_no,
                    "overlapped": self._inflight is not None,
                },
                stat=True,
            )
        self._t_prev_dispatch = now
        if self._exec_log is not None:
            self._exec_log.append(("dispatch", self._dispatch_no))
        return self._dispatch_no

    def _mark_first_sched(self, seq: Sequence, now: float) -> None:
        """The sequence's first chunk is being dispatched: close its queue
        wait as a ``sched_admit`` stat span under the "sched" service
        (the facade files the per-request twin under "engine")."""
        if seq.t_first_sched:
            return
        seq.t_first_sched = now
        if seq.t_queued:
            self._sched_tracer.record(
                "sched_admit", seq.t_queued, now,
                attrs={
                    "request_id": seq.request_id,
                    "prompt_tokens": seq.prompt_len,
                    "cached_tokens": seq.num_cached_tokens,
                },
                stat=True,
            )

    def _bucket_for(self, n: int) -> int:
        """Token-budget bucket: total ragged tokens in a prefill wave."""
        for b in self.engine.prefill_buckets:
            if b >= n:
                return b
        raise ValueError(f"{n} exceeds largest prefill bucket")

    def _decode_width(self, n: int) -> int:
        for b in self.engine.decode_buckets:
            if b >= n:
                return b
        return self.engine.decode_buckets[-1]

    def _sweep_queue(self) -> None:
        """Drop cancelled requests from any queue position, and expire
        never-scheduled requests past their deadline with a typed error
        frame (admitted sequences always run to completion)."""
        now = time.time()

        def dead(s: Sequence) -> bool:
            return s.cancelled or (
                s.deadline_epoch is not None
                and now > s.deadline_epoch
                and not s.emitted_first
            )

        for seq in [s for s in self.waiting.sweep(dead) if not s.cancelled]:
            self.sched_stats["deadline_expired_total"] += 1
            waited_ms = (now - seq.t_queued) * 1e3 if seq.t_queued else 0.0
            out = LLMEngineOutput(
                token_ids=[], finish_reason=FinishReason.ERROR.value,
                prompt_tokens=seq.prompt_len, completion_tokens=0,
            )
            out.meta = {
                "shed": "deadline",
                "detail": (
                    f"request {seq.request_id} expired after "
                    f"{waited_ms:.0f} ms in the scheduler queue"
                ),
            }
            self._shed_outputs.append((seq, out))

    def _admit(self) -> None:
        while self._inbox:
            self.waiting.append(self._inbox.popleft())
        self._sweep_queue()
        bs = self.engine.block_size
        watermark = 0.01 * self.allocator.capacity
        while self.waiting and len(self.running) < self.engine.max_num_seqs:
            seq = self.waiting.head()
            P = seq.prompt_len
            seq.prompt_hashes = compute_seq_hashes(seq.prompt, bs)
            # Cap the reusable prefix so at least one token is prefilled
            # (decoding starts from last-token logits).
            cap = (P - 1) // bs
            cached_ids = self.allocator.acquire_cached(seq.prompt_hashes[:cap])
            ncached = len(cached_ids)
            need = -(-P // bs) - ncached
            if self.allocator.free_blocks - need < watermark and self.running:
                self.allocator.release(seq.prompt_hashes[:ncached])
                return
            try:
                new_ids = self.allocator.alloc_many(need)
            except OutOfBlocksError:
                self.allocator.release(seq.prompt_hashes[:ncached])
                return
            self.waiting.pop()
            self._admit_prefix_queries += 1
            if ncached:
                self._admit_prefix_hits += 1
            seq.block_ids = cached_ids + new_ids
            seq.committed_blocks = ncached
            seq.pinned_hashes = list(seq.prompt_hashes[:ncached])
            seq.num_cached_tokens = ncached * bs
            seq.prefilled = seq.processed = ncached * bs
            seq.hashed = TokenBlockSequence(seq.prompt[: seq.prefilled], bs)
            self.running.append(seq)

    # -- device-step assembly ---------------------------------------------

    def _commit_completed(self, seq: Sequence, completed) -> None:
        for blk in completed:
            idx = blk.position
            canonical = self.allocator.commit(
                seq.block_ids[idx], blk.block_hash, blk.parent_hash
            )
            seq.block_ids[idx] = canonical
            seq.pinned_hashes.append(blk.block_hash)
            seq.committed_blocks += 1

    def _assemble_ragged(
        self, rows: list[tuple[Sequence, list[int], int, int]], S: int,
        feed_rows: list[int | None] | None = None,
    ) -> _RaggedBatch:
        """Host-side assembly of one ragged forward's inputs: each row is
        ``(seq, tokens, pos_start, kv_len)``, packed into one token buffer
        padded to the prefill bucket; padded slots write the garbage block.
        Shared by the prefill wave, the mixed step and the fused
        megastep's first iteration, so they cannot disagree on row
        packing, sample rows or counter keys. Every row samples its last
        position (verify rows, which sample more, wait for ROADMAP.md
        A8c). A non-None entry of ``feed_rows`` is the flat index of that
        row's first token in the in-flight step's sampled output, gathered
        on the device over the host placeholder."""
        P = self.engine.max_blocks_per_seq
        bs = self.engine.block_size
        total = sum(len(tl) for _, tl, _, _ in rows)
        T = self._bucket_for(total)

        tokens = np.zeros(T, np.int32)
        positions = np.zeros(T, np.int32)
        write_pages = np.full(T, self.engine.garbage_block, np.int32)
        write_offs = np.zeros(T, np.int32)
        kv_lens = np.zeros(S, np.int32)
        tables = np.full((S, P), self.engine.garbage_block, np.int32)
        cu = np.zeros(S + 1, np.int32)
        last_rows = np.zeros(S, np.int32)
        counters = np.zeros(S, np.int32)
        seeds = np.zeros(S, np.int32)
        temp = np.ones(S, np.float32)
        top_k = np.zeros(S, np.int32)
        top_p = np.ones(S, np.float32)
        feed_idx = np.full(T, -1, np.int32)

        t = 0
        for i, (seq, toks_list, pos0, kv_len) in enumerate(rows):
            chunk = len(toks_list)
            pos = np.arange(pos0, pos0 + chunk, dtype=np.int32)
            tokens[t : t + chunk] = toks_list
            positions[t : t + chunk] = pos
            ids = np.asarray(seq.block_ids, np.int32)
            write_pages[t : t + chunk] = ids[pos // bs]
            write_offs[t : t + chunk] = pos % bs
            kv_lens[i] = kv_len
            tables[i, : len(ids)] = ids
            last_rows[i] = t + chunk - 1
            # Read through the overlay: with a step in flight the lane's
            # generated count lags by the tokens that step will commit.
            counters[i] = self._eff_generated(seq)
            if feed_rows is not None and feed_rows[i] is not None:
                feed_idx[t] = feed_rows[i]
            seeds[i] = seq.seed
            temp[i] = seq.sampling.temperature
            top_k[i] = seq.sampling.top_k
            top_p[i] = seq.sampling.top_p
            t += chunk
        cu[1 : len(rows) + 1] = np.cumsum([len(tl) for _, tl, _, _ in rows])
        cu[len(rows) + 1 :] = cu[len(rows)]
        return _RaggedBatch(
            T=T, tokens=tokens, positions=positions, write_pages=write_pages,
            write_offs=write_offs, kv_lens=kv_lens, tables=tables, cu=cu,
            last_rows=last_rows, counters=counters, seeds=seeds, temp=temp,
            top_k=top_k, top_p=top_p, feed_idx=feed_idx,
            need_mask=any(
                s.sampling.top_k > 0 or s.sampling.top_p < 1.0 for s, _, _, _ in rows
            ),
            want_lp=any(s.logprobs is not None for s, _, _, _ in rows),
            all_greedy=all(s.sampling.temperature == 0.0 for s, _, _, _ in rows),
            num_rows=len(rows),
        )

    @staticmethod
    def _ragged_fields(b: _RaggedBatch) -> dict[str, Any]:
        return {
            "tokens": b.tokens, "positions": b.positions, "write_pages": b.write_pages,
            "write_offs": b.write_offs, "kv_lens": b.kv_lens, "block_tables": b.tables,
            "cu_q_lens": b.cu, "num_seqs": [b.num_rows], "last_rows": b.last_rows,
            "seeds": b.seeds, "counters": b.counters, "temperature": b.temp,
            "top_k": b.top_k, "top_p": b.top_p, "feed_idx": b.feed_idx,
        }

    def _ragged_launch(self, b: _RaggedBatch, S: int, mixed: bool = False) -> Launch:
        """One ragged forward + sampling of ``b`` as a dispatch. A prefill
        wave's graph key is (token bucket, sampling variant), its ``S`` the
        engine's fixed ``prefill_batch``; a mixed step's (``mixed``) is
        (token bucket, width, sampling variant), and its decode rows may
        read their token from the in-flight step on the device."""
        P = self.engine.max_blocks_per_seq
        layout = _mixed_layout(b.T, S, P) if mixed else _prefill_layout(b.T, S, P)
        fields = self._ragged_fields(b)
        packed = layout.pack({k: fields[k] for k in layout.fields})
        need_mask = b.need_mask and not b.all_greedy

        def body(buf: torch.Tensor) -> tuple:
            x = layout.unpack(buf)
            toks, lps = _prefill_and_sample(
                self.params, self.cache,
                x["tokens"], x["positions"], x["write_pages"], x["write_offs"],
                x["kv_lens"], x["block_tables"], x["cu_q_lens"], x["num_seqs"],
                x["last_rows"], x["seeds"], x["counters"], x["temperature"],
                x["top_k"], x["top_p"],
                need_mask=need_mask, all_greedy=b.all_greedy,
                want_logprobs=b.want_lp, cfg=self.cfg,
            )
            return (toks, *(lps or ()))

        variant = (need_mask, b.all_greedy, b.want_lp)
        key = ("mixed", b.T, S, *variant) if mixed else ("prefill", b.T, *variant)
        return Launch(key, layout, packed, body)

    def _fused_launch(
        self, b: _RaggedBatch, S: int, n_steps: int, lanes: dict[str, np.ndarray],
    ) -> Launch:
        """One fused megastep as a dispatch: ``b``'s ragged iteration and
        ``n_steps - 1`` decode iterations, the lanes' continuation state in
        ``lanes`` (``cont_active``, ``base_pos``, ``watch``, ``budgets``,
        ``min_left``, [S] rows). Its graph key is (token bucket, width,
        n_steps, sampling variant)."""
        layout = _fused_layout(b.T, S, self.engine.max_blocks_per_seq)
        packed = layout.pack({**self._ragged_fields(b), **lanes})
        need_mask = b.need_mask and not b.all_greedy

        def body(buf: torch.Tensor) -> tuple:
            x = layout.unpack(buf)
            # R = 1: no lane drafts (ROADMAP.md A8c).
            draft = x["tokens"].new_full((S, 0), -1)
            toks, lps = _megastep_fused_body(
                self.params, self.cache,
                x["tokens"], x["positions"], x["write_pages"], x["write_offs"],
                x["kv_lens"], x["block_tables"], x["cu_q_lens"], x["num_seqs"],
                x["last_rows"], x["seeds"], x["counters"], x["temperature"],
                x["top_k"], x["top_p"],
                draft, torch.zeros_like(x["kv_lens"]), x["cont_active"], x["base_pos"],
                x["seeds"], x["temperature"], x["top_k"], x["top_p"],
                x["watch"], x["budgets"], x["min_left"],
                n_steps=n_steps, need_mask=need_mask, all_greedy=b.all_greedy,
                want_logprobs=b.want_lp, cfg=self.cfg, engine=self.engine,
            )
            return (toks, *(lps or ()))

        key = ("fused", b.T, S, n_steps, need_mask, b.all_greedy, b.want_lp)
        return Launch(key, layout, packed, body)

    def _launch(self, launch: Launch, feed: Callable | None = None) -> tuple:
        """Run one dispatch and return its output tensors: eagerly on the
        CPU, else as the replay of its graph, captured at first use where
        warm_up() did not. ``feed(buf)`` writes the device-resident slots
        of the packed inputs."""
        if self.device.type == "cpu":
            buf = torch.from_numpy(launch.packed).to(self.device)
            if feed is not None:
                feed(buf)
            return launch.body(buf)
        if launch.key not in self._graphs:
            if self._inflight is not None:
                raise _NeedCapture(launch.key)
            self._graphs.capture(launch, self.device)
        return self._graphs.replay(launch, feed)

    def _feed(self, launch: Launch, fed: bool) -> Callable | None:
        """The device-side token feed of ``launch`` when a slot is ``fed``
        (its ``tokens`` slots whose ``feed_idx`` is set gather the
        in-flight step's sampled tokens, :func:`gather_feedback`), else
        None."""
        if not fed:
            return None
        src, layout = self._inflight.feed_tokens, launch.layout

        def feed(buf: torch.Tensor) -> None:
            tok = layout.field(buf, "tokens")
            tok.copy_(gather_feedback(src, tok, layout.field(buf, "feed_idx")))

        return feed

    def _dispatch_ragged(
        self, rows: list[tuple[Sequence, list[int], int, int]], S: int,
        feed_rows: list[int | None] | None = None,
    ) -> _PendingFetch:
        """Assemble and enqueue ONE ragged forward + fused sampling over
        arbitrary rows: prefill chunks (tokens sliced from the prompt) and
        decode rows (the pending token at position ``processed``, q_len
        1). A prefill wave passes ``S = prefill_batch`` and no
        ``feed_rows``; a mixed step (``feed_rows`` given, aligned with
        rows) its decode width. Returns a pending fetch whose ``land()``
        yields (tokens [S], logprob arrays or None)."""
        b = self._assemble_ragged(rows, S, feed_rows)
        mixed = feed_rows is not None
        launch = self._ragged_launch(b, S, mixed)
        outs = self._launch(launch, self._feed(launch, bool((b.feed_idx >= 0).any())))
        self.exec_stats["single_step_dispatches"] += 1
        self.exec_stats["forwards"] += 1
        if mixed:
            self._count_mixed(b)
        return _PendingFetch(self, outs)

    def _count_mixed(self, b: _RaggedBatch) -> None:
        self.exec_stats["mixed_tokens"] += int(b.cu[b.num_rows])
        self.exec_stats["mixed_bucket_tokens"] += b.T

    def _dispatch_fused(
        self,
        rows: list[tuple[Sequence, list[int], int, int]],
        S: int,
        feed_rows: list[int | None],
        kinds: list[str],
        cont: list[bool],
        n_steps: int,
    ) -> _PendingFetch:
        """Assemble and enqueue one UNIVERSAL megastep
        (:func:`_megastep_fused_body`): the ragged first iteration a mixed
        step would run over these rows, fused with ``n_steps - 1`` decode
        iterations. ``cont`` (aligned with rows) marks the lanes that go on
        as decode rows after iteration 0: every decode row ("d" in
        ``kinds``), and a prefill chunk ("p") when it completes its prompt
        and the planner reserved its headroom. Returns a pending fetch
        whose ``land()`` yields ([n_steps, S, 1] tokens, matching logprob
        arrays or None)."""
        b = self._assemble_ragged(rows, S, feed_rows=feed_rows)
        lanes = {
            "cont_active": np.zeros(S, bool),
            "base_pos": np.zeros(S, np.int32),
            "watch": np.full((S, MEGASTEP_WATCH_W), -1, np.int32),
            # Masked and padded lanes never reach their budget: the deepest
            # lane emits 1 + (n_steps - 1) tokens.
            "budgets": np.full(S, n_steps + 2, np.int32),
            "min_left": np.zeros(S, np.int32),
        }
        for i, ((seq, toks_list, pos0, _), kind) in enumerate(zip(rows, kinds)):
            if not cont[i]:
                continue
            lanes["cont_active"][i] = True
            lanes["base_pos"][i] = pos0 + (len(toks_list) if kind == "p" else 1)
            self._arm_stop_inputs(
                seq, i, lanes["watch"], lanes["budgets"], lanes["min_left"]
            )
        launch = self._fused_launch(b, S, n_steps, lanes)
        outs = self._launch(launch, self._feed(launch, bool((b.feed_idx >= 0).any())))
        self.exec_stats["megastep_dispatches"] += 1
        if "p" in kinds:
            self.exec_stats["fused_mixed_dispatches"] += 1
        self.exec_stats["forwards"] += n_steps
        self._count_mixed(b)
        return _PendingFetch(self, outs)

    def _plan_prefill_wave(self, seqs: list[Sequence]) -> _PlannedStep | None:
        """Plan one ragged prefill wave: up to ``prefill_batch`` sequences
        under a shared token budget (largest prefill bucket), first-token
        sampling fused in. The commit lands the sampled tokens and emits
        for every sequence whose prompt completed this wave. Chunk cursors
        read through the optimistic overlay, so consecutive waves of one
        long prompt pipeline under async execution."""
        S = self.engine.prefill_batch
        budget = self.engine.prefill_buckets[-1]
        chosen: list[tuple[Sequence, int, int]] = []  # (seq, p0, chunk)
        total = 0
        for seq in seqs:
            if len(chosen) == S or total >= budget:
                break
            p0 = seq.prefilled + self._adv3(seq)[0]
            chunk = min(seq.prompt_len - p0, budget - total)
            if chunk <= 0:
                continue
            chosen.append((seq, p0, chunk))
            total += chunk
        if not chosen:
            return None
        t_disp = time.time()
        rows = [(seq, seq.prompt[p0 : p0 + chunk], p0, p0 + chunk) for seq, p0, chunk in chosen]
        pend = self._dispatch_ragged(rows, S)
        for seq, _, _ in chosen:
            self._mark_first_sched(seq, t_disp)
        adv: dict[str, tuple[int, int, int]] = {}
        feed_index: dict[str, int] = {}
        feed_series: dict[str, tuple[int, int, int]] = {}
        for i, (seq, p0, chunk) in enumerate(chosen):
            done = p0 + chunk >= seq.prompt_len
            adv[seq.request_id] = (chunk, chunk, 1 if done else 0)
            if done:
                feed_index[seq.request_id] = i
                feed_series[seq.request_id] = (i, 0, 1)

        def commit() -> list[tuple[Sequence, LLMEngineOutput]]:
            toks, lps = pend.land()
            self.exec_stats["prefill_s"] += time.time() - t_disp
            self.exec_stats["prefill_tokens"] += total
            outputs: list[tuple[Sequence, LLMEngineOutput]] = []
            now = time.time()
            live = {id(s) for s in self.running}
            for i, (seq, p0, chunk) in enumerate(chosen):
                if seq.finish is not None or seq.cancelled or id(seq) not in live:
                    continue  # lane left the scheduler while in flight
                tok, lp = self._advance_prefill_chunk(seq, chunk, toks, lps, i, t_disp, now)
                if tok is None:
                    continue  # prompt not finished this wave
                outputs.append((seq, self._emit_first(seq, tok, lp)))
            self._tracer.record(
                "engine_prefill_step", t_disp, time.time(),
                attrs={"seqs": len(chosen), "tokens": total},
                stat=True,
            )
            return outputs

        return _PlannedStep(
            core=self, commit_fn=commit, adv=adv,
            feed_tokens=pend.toks, feed_index=feed_index,
            feed_series=feed_series, kind="prefill",
        )

    def _advance_prefill_chunk(
        self, seq: Sequence, chunk: int, toks, lps, i: int, t0: float, now: float,
    ) -> tuple[int | None, dict | None]:
        """Commit one prefill chunk's bookkeeping: block commits, the
        cursor advance and the chunk's span. Returns (sampled_token,
        lp_entry); the token is real only when this chunk completes the
        prompt."""
        completed = seq.hashed.extend(seq.prompt[seq.prefilled : seq.prefilled + chunk])
        self._commit_completed(seq, completed)
        seq.prefilled += chunk
        seq.processed = seq.prefilled
        self._tracer.record(
            "engine_prefill_chunk", t0, now,
            attrs={
                "request_id": seq.request_id, "tokens": chunk,
                "prefilled": seq.prefilled, "prompt_tokens": seq.prompt_len,
            },
            stat=True,
        )
        if not seq.prefill_done:
            return None, None
        lp = None
        if lps is not None and seq.logprobs is not None:
            lp = _lp_entry(int(toks[i]), lps[0][i], lps[1][i], lps[2][i], seq.logprobs)
        return int(toks[i]), lp

    def _grow_or_preempt(self, decoding: list[Sequence], n_tokens: int) -> list[Sequence]:
        """Ensure every decode lane has blocks for its next ``n_tokens``
        writes, preempting the youngest neighbour under pressure; with a
        step in flight, pressure drains the pipeline instead."""
        ready: list[Sequence] = []
        for seq in decoding:
            if seq not in self.running:
                continue  # preempted by an earlier lane in this loop
            if self._grow_blocks(seq, n_tokens):
                ready.append(seq)
                continue
            if self._inflight is not None:
                # Block pressure mid-plan with a step in flight: the async
                # loop commits it and re-plans from settled state, where
                # preemption is safe.
                raise _NeedDrain(seq.request_id)
            victim = next((s for s in reversed(self.running) if s is not seq), None)
            if victim is not None:
                self._preempt(victim)
                if victim in ready:
                    ready.remove(victim)
                if self._grow_blocks(seq, n_tokens):
                    ready.append(seq)
        return ready

    def _grow_blocks(self, seq: Sequence, n_tokens: int) -> bool:
        """Ensure physical blocks exist for the next ``n_tokens`` decode
        writes (positions processed .. processed + n_tokens - 1, read
        through the overlay so an in-flight step's writes are covered)."""
        bs = self.engine.block_size
        need = (self._eff_processed(seq) + n_tokens - 1) // bs + 1 - len(seq.block_ids)
        grabbed: list[int] = []
        for _ in range(max(0, need)):
            try:
                grabbed.append(self.allocator.alloc())
            except OutOfBlocksError:
                for b in grabbed:
                    self.allocator.free_partial(b)
                return False
        seq.block_ids.extend(grabbed)
        return True

    def _preempt(self, seq: Sequence) -> None:
        """Token-replay preemption: free everything, re-prefill later with
        the generated tokens folded into the prompt."""
        log.info("preempting %s (generated=%d)", seq.request_id, seq.generated)
        self.sched_stats["preemptions"] += 1
        self._release_blocks(seq)
        if seq.prefill_done:
            new_prompt = seq.hashed.all_tokens()
            if seq.pending is not None:
                new_prompt.append(seq.pending)
            seq.prompt = new_prompt
        seq.pending = None
        seq.block_ids = []
        seq.committed_blocks = 0
        seq.prefilled = seq.processed = 0
        seq.hashed = None
        self.running.remove(seq)
        self.waiting.appendleft(seq)

    def _release_blocks(self, seq: Sequence) -> None:
        """Release a sequence's block refs exactly once: uncommitted
        partials back to the free list, pinned hashes unpinned."""
        for bid in seq.block_ids[seq.committed_blocks :]:
            self.allocator.free_partial(bid)
        self.allocator.release(seq.pinned_hashes)
        seq.block_ids = seq.block_ids[: seq.committed_blocks]
        seq.pinned_hashes = []

    def _arm_stop_inputs(
        self, seq: Sequence, i: int, watch: np.ndarray,
        budgets: np.ndarray, min_left: np.ndarray,
    ) -> None:
        """Fill lane ``i``'s on-device stop inputs: watch ids (EOS +
        stop_token_ids), remaining generation budget, min-tokens floor,
        the last two read through the overlay."""
        W = watch.shape[1]
        wl: list[int] = []
        if not seq.stop.ignore_eos:
            wl.extend(sorted(self.eos_token_ids))
        wl.extend(seq.stop.stop_token_ids)
        watch[i, : min(W, len(wl))] = wl[:W]
        if seq.stop.max_tokens is not None:
            budgets[i] = max(1, seq.stop.max_tokens - self._eff_generated(seq))
        if seq.stop.min_tokens:
            min_left[i] = max(0, seq.stop.min_tokens - self._eff_generated(seq))

    def _megastep_launch(
        self, seqs: list[Sequence], n_steps: int,
        feed_lanes: list[int | None] | None = None,
    ) -> Launch:
        """One decode megastep over these lanes as a dispatch: its graph
        key is (width, n_steps, sampling variant). A non-None entry of
        ``feed_lanes`` (aligned with seqs) is the flat index of that
        lane's pending token in the in-flight step's sampled output, to be
        gathered on the device; cursors and counters read through the
        overlay."""
        B = self._decode_width(len(seqs))
        seqs = seqs[:B]
        tokens = np.zeros(B, np.int32)
        feed_idx = np.full(B, -1, np.int32)
        positions = np.zeros(B, np.int32)
        tables = np.full(
            (B, self.engine.max_blocks_per_seq), self.engine.garbage_block, np.int32
        )
        active = np.zeros(B, bool)
        temp = np.ones(B, np.float32)
        top_k = np.zeros(B, np.int32)
        top_p = np.ones(B, np.float32)
        seeds = np.zeros(B, np.int32)
        counters = np.zeros(B, np.int32)
        watch = np.full((B, MEGASTEP_WATCH_W), -1, np.int32)
        # Padded lanes never hit their budget (gen <= n_steps < n_steps+1).
        budgets = np.full(B, n_steps + 1, np.int32)
        min_left = np.zeros(B, np.int32)
        for i, seq in enumerate(seqs):
            if feed_lanes is not None and feed_lanes[i] is not None:
                feed_idx[i] = feed_lanes[i]
            else:
                tokens[i] = seq.pending
            positions[i] = self._eff_processed(seq)
            tables[i, : len(seq.block_ids)] = seq.block_ids
            active[i] = True
            temp[i] = seq.sampling.temperature
            top_k[i] = seq.sampling.top_k
            top_p[i] = seq.sampling.top_p
            seeds[i] = seq.seed
            counters[i] = self._eff_generated(seq)
            self._arm_stop_inputs(seq, i, watch, budgets, min_left)
        all_greedy = all(s.sampling.temperature == 0.0 for s in seqs)
        need_mask = not all_greedy and any(
            s.sampling.top_k > 0 or s.sampling.top_p < 1.0 for s in seqs
        )
        want_lp = any(s.logprobs is not None for s in seqs)
        layout = _decode_layout(B, self.engine.max_blocks_per_seq)
        packed = layout.pack({
            "tokens": tokens, "feed_idx": feed_idx, "block_tables": tables,
            "positions": positions, "active": active, "seeds": seeds,
            "counters": counters, "temperature": temp, "top_k": top_k, "top_p": top_p,
            "watch": watch, "budgets": budgets, "min_left": min_left,
        })

        def body(buf: torch.Tensor) -> tuple:
            x = layout.unpack(buf)
            toks, lps = _megastep_body(
                self.params, self.cache,
                x["tokens"], x["block_tables"], x["positions"], x["active"],
                x["seeds"], x["counters"], x["temperature"], x["top_k"], x["top_p"],
                x["watch"], x["budgets"], x["min_left"],
                n_steps=n_steps, need_mask=need_mask, all_greedy=all_greedy,
                want_logprobs=want_lp, cfg=self.cfg, engine=self.engine,
            )
            return (toks, *(lps or ()))

        return Launch(("decode", B, n_steps, need_mask, all_greedy, want_lp), layout, packed, body)

    def _dispatch_megastep(
        self, seqs: list[Sequence], n_steps: int,
        feed_lanes: list[int | None] | None = None,
    ) -> _PendingFetch:
        """Assemble and enqueue one decode megastep (:meth:`_megastep_launch`).
        With fed lanes, the token input gathers their pending tokens from
        the in-flight step's device output (:func:`gather_feedback`) before
        the body runs. Returns a pending fetch whose ``land()`` yields
        ([n_steps, B] tokens, logprob arrays or None)."""
        launch = self._megastep_launch(seqs, n_steps, feed_lanes)
        fed = feed_lanes is not None and any(f is not None for f in feed_lanes)
        outs = self._launch(launch, self._feed(launch, fed))
        self.exec_stats[
            "megastep_dispatches" if n_steps > 1 else "single_step_dispatches"
        ] += 1
        self.exec_stats["forwards"] += n_steps
        self.exec_stats["decode_iterations"] += n_steps
        return _PendingFetch(self, outs)

    # -- the iteration -----------------------------------------------------

    def step(self) -> list[tuple[Sequence, LLMEngineOutput]]:
        """One engine iteration; returns (sequence, output-chunk) pairs. A
        chunk with ``finish_reason`` set is the sequence's last.

        With ``async_exec`` off, the step plans, dispatches and commits in
        place. With it on, the step plans and dispatches iteration N+1
        BEFORE committing iteration N, so the returned outputs lag the
        dispatch by one call; the token stream is the same either way."""
        with self._step_lock:
            return self._step_locked()

    def _step_locked(self) -> list[tuple[Sequence, LLMEngineOutput]]:
        t0 = time.time()
        self._committed_kinds = []
        if self.engine.async_exec:
            outputs = self._step_async()
        else:
            self.iterations += 1
            plan = self._plan_step()
            outputs = plan.commit() if plan is not None else []
        if self._committed_kinds:
            # The loop's wall time goes to the kind of step it committed.
            self.exec_stats[f"{self._committed_kinds[-1]}_loop_s"] += time.time() - t0
        if self._shed_outputs:
            outputs = self._shed_outputs + outputs
            self._shed_outputs = []
        if self._inflight is None and not (self.running or self.waiting or self._inbox):
            # Going idle: break the host_gap chain so the next burst's
            # first dispatch does not record inter-arrival time.
            self._t_prev_dispatch = 0.0
        if self.flight.capacity and outputs:
            # Counts and cursors only (the dump is redacted by contract):
            # one dict append per committed step, never on the plan side.
            self.flight.record_step(
                i=self.iterations,
                outputs=[
                    {
                        "rid": s.request_id,
                        "emitted": len(o.token_ids),
                        "generated": s.generated,
                        "finish": o.finish_reason or "",
                    }
                    for s, o in outputs[:64]
                ],
                outputs_truncated=len(outputs) > 64,
                dispatches=self.exec_stats["dispatches"],
                megastep_dispatches=self.exec_stats["megastep_dispatches"],
                fused_mixed_dispatches=self.exec_stats["fused_mixed_dispatches"],
                committed_tokens=self.exec_stats["committed_tokens"],
                shed_total=self.sched_stats["shed_total"],
                deadline_expired_total=self.sched_stats["deadline_expired_total"],
                running=len(self.running),
            )
        return outputs

    def _step_async(self) -> list[tuple[Sequence, LLMEngineOutput]]:
        """One-step-ahead iteration: plan and enqueue the next step while
        the previous one runs on the device, then commit the previous
        step, so its stop scans and stream emission overlap device work.
        Block pressure mid-plan drains the pipeline and re-plans settled;
        so does a dispatch whose graph is not captured yet."""
        outputs: list[tuple[Sequence, LLMEngineOutput]] = []
        self.iterations += 1  # one per step() call, even when a drain re-plans
        try:
            plan = self._plan_step()
        except (_NeedDrain, _NeedCapture) as e:
            if isinstance(e, _NeedDrain):
                self.exec_stats["drains"] += 1
            outputs.extend(self._commit_inflight())
            plan = self._plan_step()
        prev, self._inflight = self._inflight, plan
        if prev is not None:
            outputs.extend(prev.commit())
        return outputs

    def _commit_inflight(self) -> list[tuple[Sequence, LLMEngineOutput]]:
        prev, self._inflight = self._inflight, None
        return prev.commit() if prev is not None else []

    def _plan_step(self) -> _PlannedStep | None:
        """Plan + dispatch one engine iteration (no commit): drain
        intake, admit under the watermark, then assemble and enqueue the
        iteration's device work. Cursor reads go through the optimistic
        overlay, so planning over an in-flight step sees the state that
        step will commit."""
        for seq in [s for s in self.running if s.cancelled]:
            self.running.remove(seq)
            self._release_blocks(seq)
        self._admit()
        t_plan = time.time()
        if self.engine.scheduling == "chunked":
            prefills = [s for s in self.running if not self._eff_prefill_done(s)]
            plan = None
            if prefills and self.engine.megastep > 1:
                # The universal megastep: prefill chunks and decode rows
                # fuse with decode continuations in one dispatch; None
                # falls back to the single-step path, which is exact.
                plan = self._plan_fused(prefills)
            if plan is None:
                plan = self._plan_mixed(prefills) if prefills else self._plan_decode()
        else:
            plan = self._plan_waves()
        if plan is not None:
            self._tracer.record(
                "engine_plan", t_plan, time.time(),
                attrs={"iteration": self.iterations, "pipelined": self._inflight is not None},
                stat=True,
            )
        return plan

    def _plan_waves(self) -> _PlannedStep | None:
        """Prefill-priority scheduling: one prefill wave strictly before
        any decode."""
        prefills = [s for s in self.running if not self._eff_prefill_done(s)]
        if prefills:
            return self._plan_prefill_wave(prefills)
        return self._plan_decode()

    def _decode_candidates(self) -> list[Sequence]:
        """Runnable decode lanes under the optimistic overlay. Lanes whose
        in-flight step is sure to finish them (generation budget or
        context edge reached) are left out: the synchronous loop would
        have removed them before this iteration."""
        out: list[Sequence] = []
        for s in self.running:
            _, dproc, dgen = self._adv3(s)
            if s.pending is None and dgen == 0:
                continue  # no sampled token yet (still prefilling)
            if not self._eff_prefill_done(s):
                continue
            if s.stop.max_tokens is not None and s.generated + dgen >= s.stop.max_tokens:
                continue  # finishes (length) in flight
            if self.engine.max_model_len - (s.processed + dproc) < 1:
                continue  # context edge reached in flight
            out.append(s)
        return out

    def _plan_decode(self) -> _PlannedStep | None:
        """Plan one decode megastep. ALL block growth happens before the
        dispatch: every lane's k tokens of headroom are reserved here, so
        pressure surfaces (preemption, or _NeedDrain under async) while
        nothing is enqueued, and a megastep never exhausts blocks
        mid-dispatch."""
        decoding = self._decode_candidates()
        if not decoding:
            return None
        n_steps = self._chain_length(decoding)
        ready = self._grow_or_preempt(decoding, n_steps)
        ready = [s for s in ready if s in self.running]
        if not ready:
            return None
        return self._plan_megastep(ready, n_steps)

    def _plan_megastep(self, ready: list[Sequence], n_steps: int) -> _PlannedStep:
        """Dispatch one decode megastep; the commit scans stops, commits
        K/V bookkeeping and emits whole-megastep chunks."""
        t_decode = time.time()
        feed_lanes = [self._feed_src(s) for s in ready]
        pend = self._dispatch_megastep(ready, n_steps, feed_lanes=feed_lanes)
        adv = {s.request_id: (0, n_steps, n_steps) for s in ready}
        # Each lane's newest token is the chain's LAST sampled row: flat
        # index (n_steps-1)*B + lane of the [n_steps, B] output; its whole
        # emission sits at lane, B + lane, ..., (n_steps-1)*B + lane.
        B = self._decode_width(len(ready))
        feed_index = {s.request_id: (n_steps - 1) * B + i for i, s in enumerate(ready)}
        feed_series = {s.request_id: (i, B, n_steps) for i, s in enumerate(ready)}

        def commit() -> list[tuple[Sequence, LLMEngineOutput]]:
            chained, lps = pend.land()  # [n_steps, B]
            self.exec_stats["decode_s"] += time.time() - t_decode
            outputs: list[tuple[Sequence, LLMEngineOutput]] = []
            emitted_total = 0
            live = {id(s) for s in self.running}
            for i, seq in enumerate(ready):
                if seq.finish is not None or seq.cancelled or id(seq) not in live:
                    continue  # late finish/preempt: discard the optimistic chain
                out = self._commit_chain(seq, chained, lps, i)
                outputs.append((seq, out))
                emitted_total += len(out.token_ids)
            t_done = time.time()
            self._tracer.record(
                "engine_decode_step", t_decode, t_done,
                attrs={"seqs": len(ready), "chain": n_steps, "tokens": emitted_total},
                stat=True,
            )
            if n_steps > 1:
                self._tracer.record(
                    "engine_megastep", t_decode, t_done,
                    attrs={
                        "seqs": len(ready), "inner_steps": n_steps,
                        "tokens": emitted_total, "pp_stages": 1,
                        "fused_shapes": {"decode": len(ready), "chunk": 0, "verify": 0},
                    },
                    stat=True,
                )
            return outputs

        return _PlannedStep(
            core=self, commit_fn=commit, adv=adv,
            feed_tokens=pend.toks, feed_index=feed_index,
            feed_series=feed_series, kind="decode",
        )

    def _rotate_decode_lanes(self, decoding: list[Sequence], cap: int) -> list[Sequence]:
        """At most ``cap`` decode lanes for a mixed step; which ones sit
        out rotates with the iteration, so no stream stalls repeatedly."""
        if len(decoding) <= cap:
            return decoding
        off = self.iterations % len(decoding)
        return (decoding + decoding)[off : off + cap]

    def _decode_rows(self, ready: list[Sequence]):
        """A mixed step's decode rows: each lane's pending token (or its
        device feed under async execution) at its cursor, q_len 1."""
        rows, feed_rows = [], []
        for seq in ready:
            cursor = self._eff_processed(seq)
            src = self._feed_src(seq)
            rows.append((seq, [0 if src is not None else seq.pending], cursor, cursor + 1))
            feed_rows.append(src)
        return rows, feed_rows

    def _take_chunks(
        self, prefills: list[Sequence], n_rows: int, total: int, t_step: float,
    ) -> list[tuple[Sequence, int, int]]:
        """Prefill chunks ``(seq, p0, chunk)`` to ride next to ``n_rows``
        rows of ``total`` tokens: in queue order, each at most
        ``chunk_size`` and what is left of the token budget, at most
        ``decode_buckets[-1]`` rows in all. A chunk that does not finish
        its prompt ends on a block boundary, so both schedulers commit the
        same block layout."""
        budget, chunk_cap = self.engine.token_budget, self.engine.chunk_size
        bs, S_max = self.engine.block_size, self.engine.decode_buckets[-1]
        out: list[tuple[Sequence, int, int]] = []
        for seq in prefills:
            if seq not in self.running:
                continue  # preempted by the decode lanes' growth
            if n_rows + len(out) >= S_max:
                break
            room = min(budget - total, chunk_cap)
            if room <= 0:
                break
            p0 = seq.prefilled + self._adv3(seq)[0]
            remaining = seq.prompt_len - p0
            chunk = min(remaining, room)
            if chunk < remaining:
                chunk -= chunk % bs
                if chunk <= 0:
                    continue
            self._mark_first_sched(seq, t_step)
            out.append((seq, p0, chunk))
            total += chunk
        return out

    def _note_mixed_step(self, total: int) -> None:
        """The scheduler gauges of a step that carried prefill chunks."""
        budget = self.engine.token_budget
        st = self.sched_stats
        st["mixed_steps"] += 1
        st["last_step_batched_tokens"] = total
        st["last_step_budget_utilization"] = total / budget if budget else 0.0
        st["chunked_prefills_in_flight"] = sum(
            1 for s in self.running if not s.prefill_done and s.t_first_sched
        )

    def _plan_mixed(self, prefills: list[Sequence]) -> _PlannedStep | None:
        """Plan one single-step chunked iteration (megastep k = 1, or the
        fused path's fallback): every runnable decode sequence rides as a
        q_len=1 row NEXT TO prefill chunks in one ragged forward under the
        ``max_num_batched_tokens`` budget, at the decode width of its row
        count. A long prompt streams through ceil(P / chunk) steps while
        in-flight decodes keep emitting one token per step. Under async
        execution decode rows gather their pending token from the
        in-flight step's device output and chunk cursors read through the
        optimistic overlay, so mixed steps pipeline like decode steps."""
        t_step = time.time()
        budget = self.engine.token_budget
        S_max = self.engine.decode_buckets[-1]
        # Keep one row and budget headroom for a prefill chunk, so a full
        # decode batch can never starve admission.
        decoding = self._rotate_decode_lanes(
            self._decode_candidates(), min(S_max - 1, budget - 1)
        )
        # Block growth first (a preemption re-queues its victim, possibly
        # a mid-prefill one, which keeps its full prompt; see _preempt).
        ready = self._grow_or_preempt(decoding, 1)
        rows, feed_rows = self._decode_rows(ready)
        n_decode = total = len(rows)
        chunks = self._take_chunks(prefills, n_decode, total, t_step)
        for seq, p0, chunk in chunks:
            rows.append((seq, seq.prompt[p0 : p0 + chunk], p0, p0 + chunk))
            feed_rows.append(None)
            total += chunk
        if not rows:
            return None
        pend = self._dispatch_ragged(rows, self._decode_width(len(rows)), feed_rows=feed_rows)
        adv: dict[str, tuple[int, int, int]] = {}
        feed_index: dict[str, int] = {}
        feed_series: dict[str, tuple[int, int, int]] = {}
        for i, (seq, toks_list, p0, _) in enumerate(rows):
            chunk = len(toks_list)
            done = i < n_decode or p0 + chunk >= seq.prompt_len
            adv[seq.request_id] = (0, 1, 1) if i < n_decode else (chunk, chunk, int(done))
            if done:
                feed_index[seq.request_id] = i
                feed_series[seq.request_id] = (i, 0, 1)

        def commit() -> list[tuple[Sequence, LLMEngineOutput]]:
            outputs: list[tuple[Sequence, LLMEngineOutput]] = []
            toks, lps = pend.land()  # [S]
            now = time.time()
            live = {id(s) for s in self.running}
            for i, (seq, toks_list, _, _) in enumerate(rows):
                if seq.finish is not None or seq.cancelled or id(seq) not in live:
                    continue  # late finish/preempt: discard the row
                if i < n_decode:
                    # The row wrote the pending token's K/V and sampled the
                    # next: a one-iteration chain.
                    lps1 = None if lps is None else tuple(a[None] for a in lps)
                    outputs.append((seq, self._commit_chain(seq, toks[None], lps1, i)))
                    continue
                tok, lp = self._advance_prefill_chunk(
                    seq, len(toks_list), toks, lps, i, t_step, now
                )
                if tok is not None:  # this chunk completed the prompt
                    outputs.append((seq, self._emit_first(seq, tok, lp)))
            self._note_mixed_step(total)
            self._tracer.record(
                "engine_mixed_step", t_step, now,
                attrs={
                    "seqs": len(rows), "decode_rows": n_decode,
                    "prefill_tokens": total - n_decode, "budget": budget,
                },
                stat=True,
            )
            return outputs

        return _PlannedStep(
            core=self, commit_fn=commit, adv=adv,
            feed_tokens=pend.toks, feed_index=feed_index,
            feed_series=feed_series, kind="mixed",
        )

    def _plan_fused(self, prefills: list[Sequence]) -> _PlannedStep | None:
        """Plan one UNIVERSAL megastep: a mixed step's rows, decode rows and
        prefill chunks, ride the first iteration of
        :func:`_megastep_fused_body`, and every lane that can go on runs
        ``n_steps - 1`` decode iterations in the same dispatch; a chunk
        that completes its prompt continues as a decode row. Returns None
        where fusion cannot apply (a stop watch too wide for the device, a
        budget or context edge at k = 1, nothing that would continue, or
        a pure prefill step whose chunks all stay mid-prompt): the caller
        falls back to :meth:`_plan_mixed`, which is exact.

        ALL block growth happens before the dispatch (the
        :meth:`_plan_decode` contract): n_steps tokens per decode lane and
        chunk + n_steps - 1 per completing chunk are reserved here, so
        pressure surfaces as preemption (or _NeedDrain under async) while
        nothing is enqueued; a completing chunk whose headroom is not
        reservable degrades to the single-step bookkeeping."""
        t_step = time.time()
        budget, chunk_cap = self.engine.token_budget, self.engine.chunk_size
        S_max = self.engine.decode_buckets[-1]
        decoding = self._decode_candidates()
        if not decoding:
            # A pure prefill step: fusing pays only when a chunk can
            # COMPLETE its prompt this step and go on decoding on the device.
            room = min(budget, chunk_cap)
            if not any(s.prompt_len - (s.prefilled + self._adv3(s)[0]) <= room for s in prefills):
                return None
        n_steps = self._chain_length(decoding or prefills)
        if n_steps <= 1:
            return None
        decoding = self._rotate_decode_lanes(decoding, min(S_max - 1, budget - 1))
        ready = self._grow_or_preempt(decoding, n_steps)
        rows, feed_rows = self._decode_rows(ready)
        kinds, cont = ["d"] * len(rows), [True] * len(rows)
        n_decode = total = len(rows)
        for seq, p0, chunk in self._take_chunks(prefills, n_decode, total, t_step):
            # A chunk that completes its prompt continues as a decode row
            # when its watch fits the device's flags, the context leaves
            # room for the continuation's writes and the blocks for them
            # are reservable; otherwise it keeps the single-step books.
            cont.append(bool(
                p0 + chunk == seq.prompt_len
                and self._watch_len(seq) <= MEGASTEP_WATCH_W
                and self.engine.max_model_len - (p0 + chunk) >= n_steps - 1
                and self._grow_blocks(seq, chunk + n_steps - 1)
            ))
            rows.append((seq, seq.prompt[p0 : p0 + chunk], p0, p0 + chunk))
            kinds.append("p")
            feed_rows.append(None)
            total += chunk
        if not any(cont):
            return None  # nothing continues on the device: the single step is exact
        S = self._decode_width(len(rows))
        pend = self._dispatch_fused(rows, S, feed_rows, kinds, cont, n_steps)
        adv: dict[str, tuple[int, int, int]] = {}
        feed_index: dict[str, int] = {}
        feed_series: dict[str, tuple[int, int, int]] = {}
        last_flat = (n_steps - 1) * S
        for i, (seq, toks_list, p0, _) in enumerate(rows):
            chunk = len(toks_list)
            if kinds[i] == "d":
                adv[seq.request_id] = (0, n_steps, n_steps)
            elif cont[i]:
                adv[seq.request_id] = (chunk, chunk + n_steps - 1, n_steps)
            else:
                done = p0 + chunk >= seq.prompt_len
                adv[seq.request_id] = (chunk, chunk, int(done))
                if done:  # its one token is iteration 0's
                    feed_index[seq.request_id] = i
                    feed_series[seq.request_id] = (i, 0, 1)
                continue
            # A continuing lane's newest token is the last iteration's.
            feed_index[seq.request_id] = last_flat + i
            feed_series[seq.request_id] = (i, S, n_steps)

        def commit() -> list[tuple[Sequence, LLMEngineOutput]]:
            outputs: list[tuple[Sequence, LLMEngineOutput]] = []
            toks3, lps3 = pend.land()  # [n_steps, S, 1]
            toks = toks3[:, :, 0]
            lps = None if lps3 is None else tuple(a[:, :, 0] for a in lps3)
            lps0 = None if lps is None else tuple(a[0] for a in lps)
            now = time.time()
            emitted_total = 0
            live = {id(s) for s in self.running}
            for i, (seq, toks_list, _, _) in enumerate(rows):
                if seq.finish is not None or seq.cancelled or id(seq) not in live:
                    continue  # late finish/preempt: discard the lane
                if kinds[i] == "d":
                    out = self._commit_chain(seq, toks, lps, i)
                else:
                    tok, lp = self._advance_prefill_chunk(
                        seq, len(toks_list), toks[0], lps0, i, t_step, now
                    )
                    if tok is None:
                        continue  # mid-prompt: masked no-ops ran on the device
                    if cont[i]:
                        # Continued on the device: the chain wrote its first
                        # n_steps - 1 tokens past the completed prompt.
                        out = self._commit_chain(seq, toks, lps, i, from_prompt=True)
                    else:
                        out = self._emit_first(seq, tok, lp)
                outputs.append((seq, out))
                emitted_total += len(out.token_ids)
            t_done = time.time()
            n_chunk = len(rows) - n_decode
            if n_chunk:
                self._note_mixed_step(total)
                self._tracer.record(
                    "engine_mixed_step", t_step, t_done,
                    attrs={
                        "seqs": len(rows), "decode_rows": n_decode,
                        "prefill_tokens": total - n_decode, "budget": budget,
                    },
                    stat=True,
                )
            else:
                self._tracer.record(
                    "engine_decode_step", t_step, t_done,
                    attrs={"seqs": len(rows), "chain": n_steps, "tokens": emitted_total},
                    stat=True,
                )
            self._tracer.record(
                "engine_megastep", t_step, t_done,
                attrs={
                    "seqs": len(rows), "inner_steps": n_steps,
                    "tokens": emitted_total, "draft_rounds": 0,
                    "fused_shapes": {
                        "decode": n_decode, "chunk": n_chunk, "verify": 0, "device": 0,
                    },
                },
                stat=True,
            )
            return outputs

        return _PlannedStep(
            core=self, commit_fn=commit, adv=adv,
            feed_tokens=pend.toks, feed_index=feed_index,
            feed_series=feed_series, kind="mixed",
        )

    def _commit_chain(
        self, seq: Sequence, chained: np.ndarray, lps, i: int, from_prompt: bool = False,
    ) -> LLMEngineOutput:
        """Commit lane ``i`` of a chain's ``[n, B]`` sampled tokens (and
        logprob arrays of the same leading shape): the stop scan, the K/V
        bookkeeping, one streamed chunk. The chain's cache writes are the
        old pending token and its first k-1 tokens; a lane whose prompt
        completed in the same dispatch (``from_prompt``) had its prompt
        committed already, and writes only the k-1."""
        toks = chained[:, i]
        k, finish = self._scan_stop(seq, toks)
        emitted = [int(t) for t in toks[:k]]
        written = emitted[: k - 1] if from_prompt else [seq.pending] + emitted[: k - 1]
        self._commit_completed(seq, seq.hashed.extend(written))
        seq.processed += len(written)
        seq.generated += k
        lp_entries = None
        if lps is not None and seq.logprobs is not None:
            lp_entries = [
                _lp_entry(emitted[j], lps[0][j][i], lps[1][j][i], lps[2][j][i], seq.logprobs)
                for j in range(k)
            ]
        out = self._emit_chunk(seq, emitted, lp_entries, finish)
        if finish is not None:
            seq.finish = finish
            self._finish(seq)
        else:
            seq.pending = emitted[-1]
        return out

    def _emit_first(self, seq: Sequence, tok: int, lp: dict | None) -> LLMEngineOutput:
        """Emit the first token sampled from a completed prompt."""
        seq.pending = tok
        seq.generated += 1
        out = self._emit(seq, tok, lp)
        if seq.finish is not None:
            self._finish(seq)
        return out

    def _scan_stop(self, seq: Sequence, toks: np.ndarray) -> tuple[int, str | None]:
        """Vectorized stop scan over a megastep's sampled tokens: returns
        (tokens emitted, finish reason or None), with the eos > stop >
        length precedence of ``check_token`` on the stopping token."""
        stop = seq.stop
        n = len(toks)
        k = n
        watch: list[int] = []
        if not stop.ignore_eos:
            watch.extend(self.eos_token_ids)
        watch.extend(stop.stop_token_ids)
        if watch:
            cand = np.isin(toks, np.asarray(watch, toks.dtype))
            if stop.min_tokens:
                gen_after = seq.generated + np.arange(1, n + 1)
                cand &= gen_after >= stop.min_tokens
            if cand.any():
                k = int(np.argmax(cand)) + 1
        if stop.max_tokens is not None:
            k = min(k, stop.max_tokens - seq.generated)
        k = max(1, k)
        finish = stop.check_token(int(toks[k - 1]), seq.generated + k, self.eos_token_ids)
        return k, finish

    def _watch_len(self, seq: Sequence) -> int:
        n = len(seq.stop.stop_token_ids)
        if not seq.stop.ignore_eos:
            n += len(self.eos_token_ids)
        return n

    def _chain_length(self, seqs: list[Sequence]) -> int:
        """Inner iterations of this megastep: the resolved megastep k,
        capped by the context edge and by the batch's largest remaining
        budget, snapped to a power of two. A lane whose stop watch
        overflows the device's slots forces k=1."""
        k_cfg = self.engine.megastep
        if k_cfg > 1 and any(self._watch_len(s) > MEGASTEP_WATCH_W for s in seqs):
            if self._forced_single_iter != self.iterations:
                self._forced_single_iter = self.iterations
                self.exec_stats["megastep_forced_single"] += 1
            if not self._watch_overflow_warned:
                self._watch_overflow_warned = True
                over = next(s for s in seqs if self._watch_len(s) > MEGASTEP_WATCH_W)
                log.warning(
                    "request %s watches %d stop ids but the device stop "
                    "watch holds %d: forcing megastep k=1 for its batches",
                    over.request_id, self._watch_len(over), MEGASTEP_WATCH_W,
                )
            return 1
        # Both caps read through the optimistic overlay: with a step in
        # flight the committed counts are that step's length behind, and
        # the context cap is hard (no write past the block table).
        ctx_cap = min(self.engine.max_model_len - self._eff_processed(s) for s in seqs)
        budget_cap = max(
            (
                s.stop.max_tokens - self._eff_generated(s)
                if s.stop.max_tokens is not None
                else k_cfg
            )
            for s in seqs
        )
        n = max(1, min(k_cfg, ctx_cap, budget_cap))
        if n == k_cfg:
            return n
        # Round UP when the overshoot is small (<= 1/3), else down.
        up = 1 << (n - 1).bit_length()
        if up <= min(k_cfg, ctx_cap) and up * 3 <= n * 4:
            return up
        return 1 << (n.bit_length() - 1)

    def _emit_chunk(
        self,
        seq: Sequence,
        tokens: list[int],
        lp_entries: list[dict] | None,
        finish: str | None,
    ) -> LLMEngineOutput:
        """One streamed chunk for a whole megastep (stop already decided
        by _scan_stop — ``tokens`` is exactly what the client gets)."""
        self.exec_stats["committed_tokens"] += len(tokens)
        out = LLMEngineOutput(token_ids=tokens)
        if lp_entries:
            out.logprobs = lp_entries
        if not seq.emitted_first:
            seq.emitted_first = True
            out.meta = {"cached_tokens": seq.num_cached_tokens, "iteration": self.iterations}
        if finish is not None:
            out.finish_reason = finish
            out.prompt_tokens = seq.prompt_len
            out.completion_tokens = seq.generated
        return out

    def _emit(self, seq: Sequence, token: int, lp: dict | None = None) -> LLMEngineOutput:
        """Emit the newest sampled token (``seq.generated`` counts it)."""
        self.exec_stats["committed_tokens"] += 1
        finish = seq.stop.check_token(token, seq.generated, self.eos_token_ids)
        out = LLMEngineOutput(token_ids=[token])
        if lp is not None:
            out.logprobs = [lp]
        if not seq.emitted_first:
            seq.emitted_first = True
            out.meta = {"cached_tokens": seq.num_cached_tokens, "iteration": self.iterations}
        if finish is not None:
            seq.finish = finish
            out.finish_reason = finish
            out.prompt_tokens = seq.prompt_len
            out.completion_tokens = seq.generated
        return out

    def _finish(self, seq: Sequence) -> None:
        if seq in self.running:
            self.running.remove(seq)
        self._release_blocks(seq)

    def clear_kv_cache(self) -> int:
        """Drop every unpinned cached block; returns blocks cleared."""
        with self._step_lock:
            return len(self.allocator.clear_cache())

    def warm_up(self) -> int:
        """Run every shape the engine serves once before it serves, every
        row writing only the garbage block: under ``waves`` one prefill
        wave per prefill bucket, under ``chunked`` one mixed step per
        (token bucket, width) its planners can dispatch, and one decode
        iteration per decode width, in each sampling variant. A shape's
        first run on the card loads its kernels (CUDA loads modules
        lazily) and settles cuBLAS's choices; done here, no request pays
        for it. On the card it then captures the CUDA graph of every key
        the engine can dispatch (:meth:`_warm_up_launches`), so serving
        captures nothing. Scheduler state, the prefix cache and the
        execution counters are left as they were; the kernels' launch
        counters count the eager launches (captures launch nothing).
        Returns the forwards it ran."""
        with self._step_lock:
            launches = self._warm_up_launches()
            forwards = 0
            for launch, eager in launches:
                if eager:
                    launch.body(torch.from_numpy(launch.packed).to(self.device))
                    forwards += 1
            if self.device.type == "cuda":
                for launch, _ in launches:
                    if launch.key not in self._graphs:
                        self._graphs.capture(launch, self.device)
        return forwards

    def _chunked_shapes(self) -> list[tuple[int, int]]:
        """(token bucket, width) of every ragged step the chunked planners
        can dispatch. A step holds n rows, 1 <= n <= min(widest decode
        width, max_num_seqs), of at least one token each and at most one
        chunk (``chunk_size``, and less than ``max_model_len``), in all at
        most the token budget; a width w takes the row counts above the
        next narrower width, so its totals are [n_lo, min(budget, n_hi *
        chunk)]."""
        eng = self.engine
        chunk = min(eng.chunk_size, eng.max_model_len - 1)
        n_max = min(eng.decode_buckets[-1], eng.max_num_seqs)
        shapes = []
        for w_prev, w in zip((0, *eng.decode_buckets), eng.decode_buckets):
            n_lo, n_hi = w_prev + 1, min(w, n_max)
            if n_lo > n_hi:
                continue
            t_hi = min(eng.token_budget, n_hi * chunk)
            for b_prev, T in zip((0, *eng.prefill_buckets), eng.prefill_buckets):
                if max(n_lo, b_prev + 1) <= min(t_hi, T):
                    shapes.append((T, w))
        return sorted(shapes)

    def _warm_up_launches(self) -> list[tuple[Launch, bool]]:
        """(launch, run eagerly) for every graph key the engine can
        dispatch, every row on the garbage block: each sampling variant of
        each decode width at every chain length ``_chain_length`` can
        return, and, under ``waves``, each prefill bucket; under
        ``chunked``, each (token bucket, width) of :meth:`_chunked_shapes`
        as a mixed step and, with k > 1, as a fused megastep at each chain
        length above 1. A prefill bucket above ``max_model_len`` is filled
        by several rows, as a wave of several prompts fills it. The decode
        launches run eagerly at k = 1 only, the fused ones not at all
        (longer chains run the same kernels)."""
        g, bs = self.engine.garbage_block, self.engine.block_size
        S, k_cfg = self.engine.prefill_batch, self.engine.megastep
        L = self.engine.max_model_len
        chains = sorted({k_cfg} | {1 << i for i in range(k_cfg.bit_length())})
        chunked = self.engine.scheduling == "chunked"
        launches: list[tuple[Launch, bool]] = []
        for sampling, logprobs in WARM_UP_VARIANTS:
            seq = Sequence("warm-up", [0] * L, sampling, StopConditions(), seed=0,
                           logprobs=logprobs)
            seq.block_ids = [g] * -(-L // bs)
            if chunked:
                chunk = min(self.engine.chunk_size, L - 1)
                for T, width in self._chunked_shapes():
                    # t tokens in n rows of at most one chunk each.
                    t = min(T, self.engine.token_budget, min(width, self.engine.max_num_seqs) * chunk)
                    n = min(width, self.engine.max_num_seqs, t)
                    sizes = [t // n + (i < t % n) for i in range(n)]
                    rows = [(seq, [0] * m, 0, m) for m in sizes]
                    batch = self._assemble_ragged(rows, width, feed_rows=[None] * n)
                    launches.append((self._ragged_launch(batch, width, mixed=True), True))
                    lanes = {
                        "cont_active": np.zeros(width, bool), "base_pos": np.zeros(width, np.int32),
                        "watch": np.full((width, MEGASTEP_WATCH_W), -1, np.int32),
                        "budgets": np.ones(width, np.int32), "min_left": np.zeros(width, np.int32),
                    }
                    for k in chains[1:]:
                        launches.append((self._fused_launch(batch, width, k, lanes), False))
            else:
                for bucket in self.engine.prefill_buckets:
                    n = min(bucket, S * L)
                    rows = [(seq, [0] * min(L, n - t), 0, min(L, n - t)) for t in range(0, n, L)]
                    batch = self._assemble_ragged(rows, S)
                    launches.append((self._ragged_launch(batch, S), True))
            seq.block_ids, seq.pending, seq.processed = [g], 0, 1
            for width in self.engine.decode_buckets:
                for k in chains:
                    launches.append((self._megastep_launch([seq] * width, k), k == 1))
        return launches

    def cached_prefix_tokens(self, token_ids: list[int]) -> int:
        """Locally cached leading tokens."""
        hashes = compute_seq_hashes(token_ids, self.engine.block_size)
        with self._step_lock:
            return self.allocator.match_prefix(hashes) * self.engine.block_size

    def kv_inventory(self) -> list[tuple[str, int, int | None]]:
        """(tier, hash, parent) of every cached block: the payload the KV
        event publisher re-publishes after an indexer reports a gap. Only
        the device tier exists until the host and disk tiers land (A10)."""
        with self._step_lock:
            return [("device", h, parent) for h, parent in self.allocator.snapshot()]

    # -- observability -----------------------------------------------------

    def scheduler_stats(self) -> dict:
        """Scheduler gauges plus the execution counters, with the JAX
        engine's keys, and the port's own: the attention kernel's launch
        counts, bf16 and int8 pages apart (0 on the CPU), and the CUDA
        graphs captured and replayed (the JAX engine's jit cache)."""
        st = dict(self.sched_stats)
        st["waiting"] = len(self.waiting) + len(self._inbox)
        st["running"] = len(self.running)
        st["chunked_scheduling"] = 1 if self.engine.scheduling == "chunked" else 0
        st["token_budget"] = self.engine.token_budget
        st["async_exec"] = 1 if self.engine.async_exec else 0
        st["queue_limit"] = self._max_waiting
        st["fair_enabled"] = 1 if self.engine.fair_scheduling else 0
        st.update(self.exec_stats)
        st["megastep_k"] = self.engine.megastep
        toks = self.exec_stats["committed_tokens"]
        st["dispatches_per_token"] = self.exec_stats["dispatches"] / toks if toks else 0.0
        st["pp_stages"] = 1  # one device until A12
        st["pp_pipe_occupancy"] = 1.0
        st["attention_launches"] = ragged_attention.launches
        st["attention_launches_int8"] = ragged_attention.launches_int8
        st["graph_captures"] = self._graphs.captures
        st["graph_replays"] = self._graphs.replays
        st["graph_capture_s"] = self._graphs.capture_s
        return st

    def kv_cache_stats(self) -> dict:
        """Prefix-cache gauges: the allocator's probe counters and the
        admitted sequences whose prefix came from cache."""
        a = self.allocator
        return {
            "kv_dtype": self.engine.kv_dtype,
            "kv_dtype_int8": 1 if self.engine.kv_quantized else 0,
            "bytes_per_block": kv_page_bytes(
                self.cfg.num_layers, self.engine.block_size,
                self.cfg.num_kv_heads, self.cfg.head_dim,
                self.engine.kv_dtype, self.cfg.torch_dtype.itemsize,
            ),
            "capacity_blocks": a.capacity,
            "resident_blocks": a.used_blocks,
            "prefix_queries": a.prefix_queries,
            "prefix_hits": a.prefix_hits,
            "admitted_queries": self._admit_prefix_queries,
            "admitted_hits": self._admit_prefix_hits,
            "admitted_hit_rate": (
                self._admit_prefix_hits / self._admit_prefix_queries
                if self._admit_prefix_queries
                else 0.0
            ),
        }

    def spec_decode_stats(self) -> dict:
        """Speculation gauges with the JAX engine's keys; speculative
        decoding waits for A8c, so every counter is 0."""
        return dict(_SPEC_OFF_STATS)

    def fair_queue_stats(self) -> dict[str, dict[str, float]]:
        """Per-tenant admission-queue depth and DRR deficit."""
        return self.waiting.stats()

    def metrics(self) -> ForwardPassMetrics:
        """Load metrics as the JAX engine reports them. ``spec_decode``
        and ``net`` stay None: speculation (A8c) and peer pulls (A10) are
        not ported."""
        alloc = self.allocator
        return ForwardPassMetrics(
            worker=WorkerStats(
                request_active_slots=len(self.running),
                request_total_slots=self.engine.max_num_seqs,
                num_requests_waiting=len(self.waiting) + len(self._inbox),
                queue_limit=self._max_waiting,
                requests_shed_total=(
                    self.sched_stats["shed_total"]
                    + self.sched_stats["deadline_expired_total"]
                ),
                budget_utilization=self.sched_stats["last_step_budget_utilization"],
            ),
            kv=KvStats(
                kv_active_blocks=alloc.used_blocks,
                kv_total_blocks=alloc.capacity,
                gpu_cache_usage_perc=alloc.usage_perc,
                gpu_prefix_cache_hit_rate=(
                    alloc.prefix_hits / alloc.prefix_queries
                    if alloc.prefix_queries
                    else 0.0
                ),
            ),
            transfer=dict(self.transfer_stats),
        )


# ``SpecStats().as_dict()`` of the JAX engine with speculation off.
_SPEC_OFF_STATS = {
    "verify_steps": 0,
    "verify_rows": 0,
    "drafted_tokens": 0,
    "accepted_tokens": 0,
    "wasted_tokens": 0,
    "emitted_tokens": 0,
    "acceptance_rate": 0.0,
    "mean_accepted_len": 0.0,
    "device_rounds": 0,
    "device_hits": 0,
    "dispatches_per_accepted_token": 0.0,
    "enabled": 0,
}
