"""EngineCore: synchronous continuous-batching scheduler on one device.

Counterpart of ``dynamo_tpu/engine/core.py`` for the engine's default
path: waves scheduling, synchronous execution, bf16 (model-dtype) or int8
KV pages, plain or int8 weights, no speculation, decode megasteps of k
iterations. One ``step()`` is one engine iteration: drain new requests,
admit under a free-block watermark (reusing cached prefix blocks), then
either run one ragged prefill wave or one decode megastep for every
running sequence. Both ride the SAME ragged
forward (``model.forward_tokens``); total prefill tokens snap to
``prefill_buckets`` and decode width to ``decode_buckets``, exactly as the
JAX engine pads them, so both engines run the same shapes and the same
block layout.

The decode megastep (:func:`_megastep_body`) is a Python loop of k
decode+sample iterations over device tensors: sampled tokens feed the next
iteration on the device, stop flags stay on the device, and the host reads
the ``[k, B]`` token block once per megastep.

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

from dynamo_tpu_torch.engine.block_allocator import DeviceBlockAllocator, OutOfBlocksError
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.fair_queue import FairQueue
from dynamo_tpu_torch.engine.kv_quant import KV_DTYPES, kv_page_bytes
from dynamo_tpu_torch.engine.model import (
    decode_tokens,
    forward_tokens,
    init_cache,
    init_params,
)
from dynamo_tpu_torch.engine.sampler import (
    sample_seeded,
    stop_flags,
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
    ``ROADMAP.md`` item that brings it, and a KV dtype that does not exist."""
    if engine_cfg.kv_dtype not in KV_DTYPES:
        raise ValueError(
            f"unknown kv_dtype {engine_cfg.kv_dtype!r} (expected one of {KV_DTYPES})"
        )
    refusals = [
        (engine_cfg.scheduling != "waves",
         f"scheduling={engine_cfg.scheduling!r}", "A8"),
        (engine_cfg.async_exec, "async_exec=True", "A8"),
        (engine_cfg.spec_decode != "off",
         f"spec_decode={engine_cfg.spec_decode!r}", "A8"),
        (engine_cfg.host_kv_blocks > 0 or bool(engine_cfg.disk_kv_dir),
         "host/disk KV tiers (host_kv_blocks, disk_kv_dir)", "A10"),
        (engine_cfg.ring_prefill_threshold > 0,
         "ring_prefill_threshold > 0 (sequence-parallel prefill)", "A12"),
        (model_cfg.is_moe, f"MoE model {model_cfg.name!r}", "A11"),
    ]
    for refused, what, item in refusals:
        if refused:
            raise ValueError(f"{what} is not ported yet (ROADMAP.md {item})")


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
    """Host-assembled inputs of one ragged prefill forward."""

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
    need_mask: bool
    want_lp: bool
    all_greedy: bool


# Static width of the per-lane on-device stop-watch array ([B, W], -1
# padded): EOS ids + stop_token_ids. A lane with more watch ids forces its
# batch to k=1, where the host stop-scan checks the full list every token.
MEGASTEP_WATCH_W = 8


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


def _to_host(x):
    """Land device outputs (a tensor or a tuple of them) as numpy."""
    if x is None:
        return None
    if isinstance(x, tuple):
        return tuple(a.cpu().numpy() for a in x)
    return x.cpu().numpy()


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
        self._req_counter = 0
        self._lock = threading.Lock()
        self._step_lock = threading.Lock()
        self.sched_stats = {
            "preemptions": 0,
            # Set by mixed (chunked) steps only, which wait for A8; waves
            # leave it at 0.0 as the JAX engine does.
            "last_step_budget_utilization": 0.0,
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
        self.exec_stats = {
            "dispatches": 0,
            "megastep_dispatches": 0,
            "single_step_dispatches": 0,
            "megastep_forced_single": 0,
            "committed_tokens": 0,
            # Model forwards: one per prefill wave, one per decode
            # iteration. Every forward runs the attention kernel once per
            # layer on the card (its int8 instance for int8 pages).
            "forwards": 0,
            "prefill_tokens": 0,
            "decode_iterations": 0,
            # Host wall time from dispatch to landed outputs, per kind.
            "prefill_s": 0.0,
            "decode_s": 0.0,
        }
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
            raise ValueError("speculative decoding is not ported yet (ROADMAP.md A8)")
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
        return bool(self._inbox or self.waiting or self.running)

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

    def _put(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(arr).to(self.device)

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
        self, rows: list[tuple[Sequence, list[int], int, int]], S: int
    ) -> _RaggedBatch:
        """Host-side assembly of one ragged forward's inputs: each row is
        ``(seq, tokens, pos_start, kv_len)``, packed into one token buffer
        padded to the prefill bucket; padded slots write the garbage block."""
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
            counters[i] = seq.generated
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
            top_k=top_k, top_p=top_p,
            need_mask=any(
                s.sampling.top_k > 0 or s.sampling.top_p < 1.0 for s, _, _, _ in rows
            ),
            want_lp=any(s.logprobs is not None for s, _, _, _ in rows),
            all_greedy=all(s.sampling.temperature == 0.0 for s, _, _, _ in rows),
        )

    def _dispatch_ragged(
        self, rows: list[tuple[Sequence, list[int], int, int]], S: int
    ):
        """Assemble and enqueue ONE ragged forward + fused sampling over
        prefill-chunk rows. Returns the device outputs (tokens [S], logprob
        arrays or None)."""
        b = self._assemble_ragged(rows, S)
        put = self._put
        out = _prefill_and_sample(
            self.params, self.cache,
            put(b.tokens), put(b.positions), put(b.write_pages), put(b.write_offs),
            put(b.kv_lens), put(b.tables), put(b.cu),
            put(np.array([len(rows)], np.int32)), put(b.last_rows),
            put(b.seeds), put(b.counters), put(b.temp), put(b.top_k), put(b.top_p),
            need_mask=b.need_mask and not b.all_greedy,
            all_greedy=b.all_greedy,
            want_logprobs=b.want_lp,
            cfg=self.cfg,
        )
        self.exec_stats["dispatches"] += 1
        self.exec_stats["single_step_dispatches"] += 1
        self.exec_stats["forwards"] += 1
        return out

    def _plan_prefill_wave(self, seqs: list[Sequence]):
        """Plan and dispatch one ragged prefill wave: up to
        ``prefill_batch`` sequences under a shared token budget (largest
        prefill bucket). Returns the commit, which lands the sampled tokens
        and emits for every sequence whose prompt completed this wave."""
        S = self.engine.prefill_batch
        budget = self.engine.prefill_buckets[-1]
        chosen: list[tuple[Sequence, int, int]] = []  # (seq, p0, chunk)
        total = 0
        for seq in seqs:
            if len(chosen) == S or total >= budget:
                break
            p0 = seq.prefilled
            chunk = min(seq.prompt_len - p0, budget - total)
            if chunk <= 0:
                continue
            chosen.append((seq, p0, chunk))
            total += chunk
        if not chosen:
            return None
        t_disp = time.time()
        rows: list[tuple[Sequence, list[int], int, int]] = []
        for seq, p0, chunk in chosen:
            # The end of the sequence's queue wait (TorchEngine's sched_admit span).
            seq.t_first_sched = seq.t_first_sched or t_disp
            rows.append((seq, seq.prompt[p0 : p0 + chunk], p0, p0 + chunk))
        toks_dev, lps_dev = self._dispatch_ragged(rows, S)

        def commit() -> list[tuple[Sequence, LLMEngineOutput]]:
            toks, lps = _to_host(toks_dev), _to_host(lps_dev)
            self.exec_stats["prefill_s"] += time.time() - t_disp
            self.exec_stats["prefill_tokens"] += total
            outputs: list[tuple[Sequence, LLMEngineOutput]] = []
            live = {id(s) for s in self.running}
            for i, (seq, p0, chunk) in enumerate(chosen):
                if seq.finish is not None or seq.cancelled or id(seq) not in live:
                    continue  # cancelled between dispatch and commit
                tok, lp = self._advance_prefill_chunk(seq, chunk, toks, lps, i)
                if tok is None:
                    continue  # prompt not finished this wave
                seq.pending = tok
                seq.generated += 1
                outputs.append((seq, self._emit(seq, tok, lp)))
                if seq.finish is not None:
                    self._finish(seq)
            return outputs

        return commit

    def _advance_prefill_chunk(
        self, seq: Sequence, chunk: int, toks, lps, i: int
    ) -> tuple[int | None, dict | None]:
        """Commit one prefill chunk's bookkeeping — block commits and the
        cursor advance. Returns (sampled_token, lp_entry); the token is
        real only when this chunk completes the prompt."""
        completed = seq.hashed.extend(seq.prompt[seq.prefilled : seq.prefilled + chunk])
        self._commit_completed(seq, completed)
        seq.prefilled += chunk
        seq.processed = seq.prefilled
        if not seq.prefill_done:
            return None, None
        lp = None
        if lps is not None and seq.logprobs is not None:
            lp = _lp_entry(int(toks[i]), lps[0][i], lps[1][i], lps[2][i], seq.logprobs)
        return int(toks[i]), lp

    def _grow_or_preempt(self, decoding: list[Sequence], n_tokens: int) -> list[Sequence]:
        """Ensure every decode lane has blocks for its next ``n_tokens``
        writes, preempting the youngest neighbour under pressure."""
        ready: list[Sequence] = []
        for seq in decoding:
            if seq not in self.running:
                continue  # preempted by an earlier lane in this loop
            if self._grow_blocks(seq, n_tokens):
                ready.append(seq)
                continue
            victim = next((s for s in reversed(self.running) if s is not seq), None)
            if victim is not None:
                self._preempt(victim)
                if victim in ready:
                    ready.remove(victim)
                if self._grow_blocks(seq, n_tokens):
                    ready.append(seq)
        return ready

    def _grow_blocks(self, seq: Sequence, n_tokens: int) -> bool:
        """Ensure physical blocks exist for positions processed ..
        processed + n_tokens - 1."""
        bs = self.engine.block_size
        need = (seq.processed + n_tokens - 1) // bs + 1 - len(seq.block_ids)
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
        stop_token_ids), remaining generation budget, min-tokens floor."""
        W = watch.shape[1]
        wl: list[int] = []
        if not seq.stop.ignore_eos:
            wl.extend(sorted(self.eos_token_ids))
        wl.extend(seq.stop.stop_token_ids)
        watch[i, : min(W, len(wl))] = wl[:W]
        if seq.stop.max_tokens is not None:
            budgets[i] = max(1, seq.stop.max_tokens - seq.generated)
        if seq.stop.min_tokens:
            min_left[i] = max(0, seq.stop.min_tokens - seq.generated)

    def _dispatch_megastep(self, seqs: list[Sequence], n_steps: int):
        """Assemble and enqueue one decode megastep over these lanes.
        Returns the device outputs ([n_steps, B] tokens, logprobs or None)."""
        B = self._decode_width(len(seqs))
        seqs = seqs[:B]
        W = MEGASTEP_WATCH_W
        tokens = np.zeros(B, np.int32)
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
        watch = np.full((B, W), -1, np.int32)
        # Padded lanes never hit their budget (gen <= n_steps < n_steps+1).
        budgets = np.full(B, n_steps + 1, np.int32)
        min_left = np.zeros(B, np.int32)
        for i, seq in enumerate(seqs):
            tokens[i] = seq.pending
            positions[i] = seq.processed
            tables[i, : len(seq.block_ids)] = seq.block_ids
            active[i] = True
            temp[i] = seq.sampling.temperature
            top_k[i] = seq.sampling.top_k
            top_p[i] = seq.sampling.top_p
            seeds[i] = seq.seed
            counters[i] = seq.generated
            self._arm_stop_inputs(seq, i, watch, budgets, min_left)
        need_mask = any(s.sampling.top_k > 0 or s.sampling.top_p < 1.0 for s in seqs)
        all_greedy = all(s.sampling.temperature == 0.0 for s in seqs)
        put = self._put
        out = _megastep_body(
            self.params, self.cache,
            put(tokens), put(tables), put(positions), put(active),
            put(seeds), put(counters), put(temp), put(top_k), put(top_p),
            put(watch), put(budgets), put(min_left),
            n_steps=n_steps,
            need_mask=need_mask and not all_greedy,
            all_greedy=all_greedy,
            want_logprobs=any(s.logprobs is not None for s in seqs),
            cfg=self.cfg, engine=self.engine,
        )
        self.exec_stats["dispatches"] += 1
        self.exec_stats[
            "megastep_dispatches" if n_steps > 1 else "single_step_dispatches"
        ] += 1
        self.exec_stats["forwards"] += n_steps
        self.exec_stats["decode_iterations"] += n_steps
        return out

    # -- the iteration -----------------------------------------------------

    def step(self) -> list[tuple[Sequence, LLMEngineOutput]]:
        """One engine iteration; returns (sequence, output-chunk) pairs. A
        chunk with ``finish_reason`` set is the sequence's last."""
        with self._step_lock:
            self.iterations += 1
            commit = self._plan_step()
            outputs = commit() if commit is not None else []
            if self._shed_outputs:
                outputs = self._shed_outputs + outputs
                self._shed_outputs = []
            return outputs

    def _plan_step(self):
        """Drain intake, admit, then plan and dispatch the iteration's
        device work. Returns its commit, or None when there is nothing."""
        for seq in [s for s in self.running if s.cancelled]:
            self.running.remove(seq)
            self._release_blocks(seq)
        self._admit()
        return self._plan_waves()

    def _plan_waves(self):
        """Prefill-priority scheduling: one prefill wave strictly before
        any decode."""
        prefills = [s for s in self.running if not s.prefill_done]
        if prefills:
            return self._plan_prefill_wave(prefills)
        return self._plan_decode()

    def _decode_candidates(self) -> list[Sequence]:
        out: list[Sequence] = []
        for s in self.running:
            if s.pending is None or not s.prefill_done:
                continue
            if s.stop.max_tokens is not None and s.generated >= s.stop.max_tokens:
                continue
            if self.engine.max_model_len - s.processed < 1:
                continue
            out.append(s)
        return out

    def _plan_decode(self):
        """Plan one decode megastep. ALL block growth happens before the
        dispatch: every lane's k tokens of headroom are reserved here, so
        a megastep can never exhaust blocks mid-dispatch."""
        decoding = self._decode_candidates()
        if not decoding:
            return None
        n_steps = self._chain_length(decoding)
        ready = self._grow_or_preempt(decoding, n_steps)
        ready = [s for s in ready if s in self.running]
        if not ready:
            return None
        return self._plan_megastep(ready, n_steps)

    def _plan_megastep(self, ready: list[Sequence], n_steps: int):
        """Dispatch one decode megastep; the commit scans stops, commits
        K/V bookkeeping and emits whole-megastep chunks."""
        t_decode = time.time()
        chained_dev, lps_dev = self._dispatch_megastep(ready, n_steps)

        def commit() -> list[tuple[Sequence, LLMEngineOutput]]:
            chained, lps = _to_host(chained_dev), _to_host(lps_dev)  # [n_steps, B]
            self.exec_stats["decode_s"] += time.time() - t_decode
            outputs: list[tuple[Sequence, LLMEngineOutput]] = []
            live = {id(s) for s in self.running}
            for i, seq in enumerate(ready):
                if seq.finish is not None or seq.cancelled or id(seq) not in live:
                    continue  # cancelled between dispatch and commit
                toks = chained[:, i]
                k, finish = self._scan_stop(seq, toks)
                # Cache writes this chain: the old pending token plus the
                # first k-1 sampled tokens.
                written = [seq.pending] + [int(t) for t in toks[: k - 1]]
                self._commit_completed(seq, seq.hashed.extend(written))
                seq.processed += k
                seq.generated += k
                emitted = [int(t) for t in toks[:k]]
                lp_entries = None
                if lps is not None and seq.logprobs is not None:
                    lp_entries = [
                        _lp_entry(
                            emitted[j], lps[0][j][i], lps[1][j][i], lps[2][j][i],
                            seq.logprobs,
                        )
                        for j in range(k)
                    ]
                outputs.append((seq, self._emit_chunk(seq, emitted, lp_entries, finish)))
                if finish is not None:
                    seq.finish = finish
                    self._finish(seq)
                else:
                    seq.pending = emitted[-1]
            return outputs

        return commit

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
        ctx_cap = min(self.engine.max_model_len - s.processed for s in seqs)
        budget_cap = max(
            (
                s.stop.max_tokens - s.generated
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
        """Run every shape the engine serves once before it serves: one
        prefill wave per prefill bucket and one decode iteration per decode
        width, greedy and again through the masked sampler with logprobs,
        every row writing only the garbage block. A shape's first run on
        the card loads its kernels (CUDA loads modules lazily) and settles
        cuBLAS's choices; done here, no request pays for it. On the card
        the waves run K1's tiled kernel and the decode iterations its
        split-KV decode kernel. Scheduler state, the prefix cache and the
        execution counters are left as they were; the kernels' launch
        counters count these launches. Returns the forwards it ran."""
        g, bs = self.engine.garbage_block, self.engine.block_size
        forwards = 0
        with self._step_lock:
            saved = dict(self.exec_stats)
            for sampling, logprobs in (
                (SamplingOptions(temperature=0.0), None),
                (SamplingOptions(temperature=1.0, top_k=50, top_p=0.9), 1),
            ):
                for bucket in self.engine.prefill_buckets:
                    n = min(bucket, self.engine.max_model_len)
                    seq = Sequence("warm-up", [0] * n, sampling, StopConditions(), seed=0,
                                   logprobs=logprobs)
                    seq.block_ids = [g] * -(-n // bs)
                    toks, _ = self._dispatch_ragged(
                        [(seq, seq.prompt, 0, n)], self.engine.prefill_batch
                    )
                    _to_host(toks)
                seq.block_ids, seq.pending, seq.processed = [g], 0, 1
                for width in self.engine.decode_buckets:
                    chained, _ = self._dispatch_megastep([seq] * width, 1)
                    _to_host(chained)
                forwards += len(self.engine.prefill_buckets) + len(self.engine.decode_buckets)
            self.exec_stats.update(saved)
        return forwards

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
        """Scheduler gauges plus the execution counters, including the
        attention kernel's launch counts, bf16 and int8 pages apart (0 on
        the CPU)."""
        st = dict(self.sched_stats)
        st["waiting"] = len(self.waiting) + len(self._inbox)
        st["running"] = len(self.running)
        st["queue_limit"] = self._max_waiting
        st["fair_enabled"] = 1 if self.engine.fair_scheduling else 0
        st.update(self.exec_stats)
        st["megastep_k"] = self.engine.megastep
        st["attention_launches"] = ragged_attention.launches
        st["attention_launches_int8"] = ragged_attention.launches_int8
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
        decoding waits for A8, so every counter is 0."""
        return dict(_SPEC_OFF_STATS)

    def fair_queue_stats(self) -> dict[str, dict[str, float]]:
        """Per-tenant admission-queue depth and DRR deficit."""
        return self.waiting.stats()

    def metrics(self) -> ForwardPassMetrics:
        """Load metrics as the JAX engine reports them. ``spec_decode``
        and ``net`` stay None: speculation (A8) and peer pulls (A10) are
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
