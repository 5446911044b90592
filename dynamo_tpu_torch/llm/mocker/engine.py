"""The mock engine: a timing-faithful fake worker.

The port's copy of ``dynamo_tpu/llm/mocker/engine.py``, held to it by
``tests/test_torch_copies.py``.

Simulates a paged-attention continuous-batching engine (watermark
admission, chunked prefill, prefix-cache reuse, a per-iteration cost
model, LRU eviction) while emitting real KV events and load metrics.
Router, disaggregation, migration, planner and fleet tests run against
fleets of these. The cost model's defaults (``MockEngineArgs``) are prices
on a virtual clock, not measurements of any device. The class keeps its
original name, ``MockTpuEngine``.
"""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass, field
from typing import Any, AsyncIterator

from dynamo_tpu_torch import knobs, tracing
from dynamo_tpu_torch.engine.fair_queue import FairQueue
from dynamo_tpu_torch.llm.kv_router.protocols import ForwardPassMetrics, KvStats, WorkerStats
from dynamo_tpu_torch.llm.mocker.kv_manager import InsufficientBlocksError, MockKvManager
from dynamo_tpu_torch.llm.protocols.common import (
    LLMEngineOutput,
    PreprocessedRequest,
    StopConditions,
)
from dynamo_tpu_torch.runtime import chaos
from dynamo_tpu_torch.runtime.engine import Context, EngineOverloadedError
from dynamo_tpu_torch.spec import SpecConfig, SpecStats, resolve_spec_config
from dynamo_tpu_torch.tokens import TokenBlockSequence, compute_seq_hashes

log = logging.getLogger("dynamo_tpu.mocker")


@dataclass
class MockEngineArgs:
    num_kv_blocks: int = 8192
    block_size: int = 32
    max_num_seqs: int = 256
    max_num_batched_tokens: int = 8192
    watermark: float = 0.01
    enable_prefix_caching: bool = True
    enable_chunked_prefill: bool = True
    # Step scheduler, mirroring EngineConfig.scheduling: "chunked" mixes
    # prefill chunks with decode rows under max_num_batched_tokens (the
    # mocker's historical shape); "waves" runs monolithic prefill
    # iterations strictly before decode — in-flight decodes stall while
    # any prompt prefills, like the real engine's wave scheduler.
    scheduling: str = "chunked"
    # Chunk cap for streaming one prompt per mixed step; 0 = budget-bound
    # only (mirrors EngineConfig.prefill_chunk).
    prefill_chunk: int = 0
    speedup_ratio: float = 1.0
    # Cost model (pre-speedup): base_iter_us is the fixed per-dispatch
    # HOST overhead (plan assembly, sampled-token fetch, bookkeeping,
    # detokenization); the token/seq terms are DEVICE compute.
    #   async_exec off: iteration = host + device  (they serialize)
    #   async_exec on:  iteration = max(host, device)  (one-step-ahead
    #     pipelining hides the smaller term under the larger — the
    #     virtual-clock twin of EngineCore's plan/dispatch/commit split;
    #     token VALUES are unchanged, the stream stays bit-identical)
    base_iter_us: float = 500.0
    prefill_us_per_token: float = 10.0
    decode_us_per_seq: float = 100.0
    async_exec: bool = False
    # Speculative decoding (mirrors EngineConfig.spec_decode/spec_k): with
    # "ngram", every decode row becomes a verify row that emits
    # 1 + accepted tokens per iteration, where accepted is simulated by
    # spec_acceptance_rate (per-draft-token Bernoulli, stop at first
    # miss — the geometric acceptance profile real drafters show). Draft
    # tokens are priced like prefill tokens and count against
    # max_num_batched_tokens, so frontend/router/bench A/Bs exercise the
    # scheduling + timing consequences CPU-only. Token VALUES are
    # unchanged — the stream stays bit-identical to spec off.
    spec_decode: str = "off"
    spec_k: int = 4
    spec_acceptance_rate: float = 0.6
    # On-device n-gram drafting (mirrors EngineConfig.spec_device_draft):
    # with megastep_k >= 2, a device-drafting lane's inner
    # iterations become draft->verify->accept ROUNDS riding the same
    # dispatch — round 0 emits one token, every later round drafts up to
    # spec_k fresh tokens from the (simulated) history ring and emits
    # accepted + 1. Drafted tokens price like prefill tokens (each is an
    # extra target forward in the verify-shaped row) and every round
    # adds DYN_SPEC_DRAFT_ROUND_US of match/gather cost to the clock.
    # Token VALUES are unchanged — the stream stays bit-identical to
    # spec off; only the chunking and the virtual clock move.
    spec_device_draft: bool = False
    # UNIVERSAL megastep (mirrors EngineConfig.megastep_k):
    # every iteration with decode work fuses k device steps under ONE
    # per-dispatch host overhead (base_iter_us) — decode lanes run up to
    # k inner iterations, spec verify lanes resolve accept/reject inside
    # the fused iteration and emit (1 + accepted) + (k - 1) tokens, and
    # prefill chunks ride the same priced dispatch (mixed traffic no
    # longer forces k=1). The device term prices k lane-iterations per
    # lane — lanes that stop early still pay the masked no-op
    # iterations, like the real scan. Token VALUES are unchanged — the
    # stream is bit-identical to k=1.
    megastep_k: int = 1
    # Quantized KV cache (mirrors EngineConfig.kv_dtype): decode
    # attention is DMA-latency-bound (PERF.md), so the cost model prices
    # per-lane-iteration KV traffic as resident_blocks x
    # kv_read_us_per_block x the dtype's byte ratio (engine/kv_quant.py:
    # 1.0 for bf16, ~0.516 for int8 at head_dim 128, scales included).
    # kv_read_us_per_block=0 (default) keeps every existing timing
    # bit-identical; bench.py run_kvquant_ab sets it for the A/B. Token
    # VALUES never change — only the virtual clock and capacity move.
    kv_dtype: str = "bf16"
    kv_read_us_per_block: float = 0.0
    # Cluster KV pool: virtual-clock price of pulling ONE
    # bf16-equivalent KV block from a peer over the dataplane, scaled by
    # the kv_dtype's byte ratio (int8 pulls move ~0.52x the bytes — the
    # packed wire buffer IS the transfer format). 0 = pulls are free on
    # the clock (legacy timing untouched); bench run_peer_pool_ab sets it
    # for the shared-prefix fleet A/B.
    kv_pull_us_per_block: float = 0.0
    # Overload robustness (mirrors EngineConfig): per-tenant
    # DRR fair admission (off = exact FIFO; single tenant is FIFO either
    # way, so streams stay bit-identical), the DRR quantum (0 = token
    # budget), and the bounded admission queue (0 = unbounded; at the
    # ceiling submits raise the typed retryable EngineOverloadedError).
    fair_scheduling: bool = False
    fair_quantum: int = 0
    max_waiting: int = 0
    # Pipeline parallelism (mirrors EngineCore's pp_mesh): the
    # virtual clock prices every decode dispatch's stage traffic as
    # (k * pp + pp - 1) hops at DYN_PP_HOP_US each — k wavefront
    # iterations over pp stages plus the pipe fill/drain bubble. With
    # megastep_k=1 that is the host-rollback pp baseline (one priced
    # dispatch + bubble PER TOKEN); with megastep_k=k the same bubble
    # amortizes over k tokens under ONE base_iter_us — exactly the fused
    # pp megastep A/B bench.py run_pp_megastep_ab asserts. Token VALUES
    # are unchanged — pp streams stay bit-identical to pp=1.
    pp: int = 1


@dataclass
class _Seq:
    request_id: str
    prompt: list[int]
    max_tokens: int
    out: asyncio.Queue
    seq: TokenBlockSequence
    prompt_hashes: list[int]
    cached_blocks: int = 0
    pinned: list[int] = field(default_factory=list)
    partials_held: int = 0
    prefilled: int = 0
    generated: int = 0
    cancelled: bool = False
    stop: StopConditions = field(default_factory=StopConditions)
    # Speculation draft length for this request (0 = off); resolved at
    # submit from the engine default + the request's spec_decode dict.
    spec_k: int = 0
    # Drafts on device between megastep inner iterations;
    # resolved like spec_k (engine flag AND the request's choice).
    spec_device: bool = False
    # Tokens a previous attempt already streamed to the client
    # (migration replay): offsets the synthetic token function so a
    # replayed stream continues bit-identically where the dead worker
    # stopped, the way a real model conditioning on the grown prompt
    # would.
    replay_base: int = 0
    # Overload metadata, mirroring engine/core.Sequence:
    # fairness identity, within-tenant ordering, absolute deadline (in
    # the engine's clock domain — injectable for virtual-clock tests).
    tenant_id: str = ""
    priority: int = 0
    deadline_epoch: float | None = None
    # do_remote_decode request (disagg prefill side): advertise chunk
    # commits through the engine's on_chunk_commit hook and tag the
    # final output with kv_transfer_params for the reply contract.
    notify_chunks: bool = False
    # Phase timestamps for the tracer (0.0 = not reached yet). The spans
    # are emitted retroactively when the stream closes so the sim loop's
    # hot path only ever stamps a float.
    t_submit: float = 0.0
    t_first_sched: float = 0.0   # first prefill chunk entered a step
    t_prefill_done: float = 0.0
    t_last_token: float = 0.0

    @property
    def prefill_done(self) -> bool:
        return self.prefilled >= len(self.prompt)


class MockTpuEngine:
    """AsyncEngine over PreprocessedRequest wire dicts."""

    _FINISHED = object()

    def __init__(
        self,
        args: MockEngineArgs | None = None,
        kv_manager: MockKvManager | None = None,
        eos_token_ids: tuple[int, ...] = (),
    ):
        self.args = args or MockEngineArgs()
        if self.args.scheduling not in ("waves", "chunked"):
            raise ValueError(
                f"unknown scheduling policy {self.args.scheduling!r} "
                "(expected 'waves' or 'chunked')"
            )
        if self.args.spec_decode not in ("off", "ngram"):
            raise ValueError(
                f"unknown spec_decode {self.args.spec_decode!r} "
                "(expected 'off' or 'ngram')"
            )
        if self.args.megastep_k < 1:
            raise ValueError(
                f"megastep_k must be >= 1, got {self.args.megastep_k}"
            )
        if self.args.pp < 1:
            raise ValueError(f"pp must be >= 1, got {self.args.pp}")
        from dynamo_tpu_torch.engine.kv_quant import KV_DTYPES, kv_byte_ratio

        if self.args.kv_dtype not in KV_DTYPES:
            raise ValueError(
                f"unknown kv_dtype {self.args.kv_dtype!r} "
                f"(expected one of {KV_DTYPES})"
            )
        # Bytes moved per resident KV block relative to bf16 (int8 pages
        # + f32 scales ~0.516x at the nominal head_dim 128).
        self._kv_byte_ratio = kv_byte_ratio(self.args.kv_dtype)
        self._last_kv_blocks_read = 0
        self._last_device_rounds = 0
        self._last_pp_rounds = 0
        # Cluster-pool peer-pull accounting (kv_pool_* gauges; same
        # counter shape as the jax worker's PeerKvClient).
        from dynamo_tpu_torch.llm.kv_pool import PeerPullStats

        self.peer_stats = PeerPullStats()
        # Streaming disagg mirror, same contract as
        # EngineCore.on_chunk_commit: fired as a do_remote_decode
        # sequence commits prefill chunks (done=True at finish). The sim
        # loop runs ON the event loop, so the callback may touch
        # loop-affine state directly — no thread hop needed.
        self.on_chunk_commit = None
        self._spec_default = (
            SpecConfig(
                k=self.args.spec_k, device=self.args.spec_device_draft
            )
            if self.args.spec_decode != "off"
            else None
        )
        # Acceptance simulation: deterministic per engine instance so
        # virtual-clock A/Bs reproduce exactly.
        import random as _random

        self._spec_rng = _random.Random(0x5bec)
        self.spec_stats = SpecStats()
        self.eos_token_ids = set(eos_token_ids)
        self.kv = kv_manager or MockKvManager(
            num_blocks=self.args.num_kv_blocks,
            block_size=self.args.block_size,
            enable_prefix_caching=self.args.enable_prefix_caching,
        )
        # Admission queue: per-tenant DRR over prompt-token cost,
        # mirroring EngineCore.waiting (fair off = exact FIFO, keeping
        # every historical stream bit-identical).
        self._waiting: FairQueue = FairQueue(
            quantum=self.args.fair_quantum or self.args.max_num_batched_tokens,
            fair=self.args.fair_scheduling,
            cost_fn=lambda s: len(s.prompt),
        )
        self._running: list[_Seq] = []
        # Deadline clock — injectable so virtual-clock drivers (bench
        # run_overload_ab, fairness tests) expire queued requests on the
        # simulated timeline instead of the wall.
        self.clock = time.time
        self._wakeup = asyncio.Event()
        self._loop_task: asyncio.Task | None = None
        self._iterations = 0
        # Chaos: the engine.step injection point fires once per sim
        # iteration, targeted by this tag (run_mocker sets it to the
        # worker id). A `kill` action leaves the loop dead — in-flight
        # streams stop producing, which is exactly the wedged-worker
        # shape the client-side stall deadline exists to catch.
        self.chaos_tag = ""
        self._dead = False
        # Crash/stall flight recorder: one record per sim
        # iteration with decode/prefill work — step shape, lane cursors,
        # timestamps — dumped to a redacted artifact on chaos kill /
        # stall / drain. run_mocker renames it to the worker id.
        from dynamo_tpu_torch.obs.flight_recorder import FlightRecorder

        self.flight = FlightRecorder(f"mock-{id(self) & 0xFFFF:04x}")
        self._tracer = tracing.get_tracer("engine")
        # Queue-wait stat spans under their own service (the waterfall
        # sched_admit twin in _trace_phases is service "engine"; sharing
        # the key would double-observe the histogram — same split as
        # EngineCore._mark_first_sched).
        self._sched_tracer = tracing.get_tracer("sched")
        # Scheduler gauges, mirroring EngineCore.sched_stats (the status
        # server exports the same series for real and mock workers).
        # The mocker never truly preempts (release + re-queue) — a decode
        # blocked on allocation just stalls one iteration — so stalls are
        # counted separately, not as preemptions.
        # Admission-time prefix-cache accounting, mirroring
        # EngineCore._admit (kv_prefix_cache_admitted_* gauges).
        self._admit_prefix_queries = 0
        self._admit_prefix_hits = 0
        self.sched_stats = {
            "preemptions": 0,
            "decode_stalls": 0,
            "mixed_steps": 0,
            "last_step_batched_tokens": 0,
            "last_step_budget_utilization": 0.0,
            "chunked_prefills_in_flight": 0,
            # Megastep observability, mirroring EngineCore.exec_stats:
            # iterations that fused k > 1 decode steps under one dispatch
            # overhead vs everything else, plus emitted tokens (the
            # dispatches_per_token gauge divides these).
            "dispatches": 0,
            "megastep_dispatches": 0,
            "single_step_dispatches": 0,
            "committed_tokens": 0,
            # Universal megastep, mirroring EngineCore:
            # dispatches that fused mixed/verify work, and (real-engine
            # only — the mocker never truncates a watch) batches forced
            # to k=1 by the device stop-watch overflow.
            "fused_mixed_dispatches": 0,
            "megastep_forced_single": 0,
            # Pipeline parallelism, mirroring EngineCore:
            # decode dispatches that fused k > 1 wavefront iterations
            # across the pipe vs the single-iteration (bubble-per-token)
            # fallback. Both 0 when pp == 1.
            "pp_fused_dispatches": 0,
            "pp_forced_single": 0,
            # Overload counters, mirroring EngineCore.
            "shed_total": 0,
            "deadline_expired_total": 0,
        }

    # -- public engine surface --------------------------------------------

    async def generate(self, request: dict, context: Context) -> AsyncIterator[dict]:
        """Handler-compatible: wire dict in, wire dicts out."""
        if request.get("clear_kv_blocks"):
            # Admin clear: unpinned cache only; the kv manager's
            # on_removed callback carries the router events.
            cleared = self.kv.clear_unpinned()
            yield {"cleared_blocks": len(cleared), "finish_reason": "stop"}
            return
        if request.get("embed"):
            # Deterministic synthetic embedding (seeded by content) so
            # /v1/embeddings works against mocker fleets in tests, like
            # every other surface (reference mocker philosophy).
            import numpy as _np

            token_ids = list(request["token_ids"])
            rng = _np.random.RandomState(abs(hash(tuple(token_ids))) % (2**31))
            vec = rng.randn(64).astype(float)
            yield {
                "embedding": [float(x) for x in vec],
                "prompt_tokens": len(token_ids),
                "finish_reason": "stop",
            }
            return
        pre = PreprocessedRequest.from_wire(request)
        limit = self.args.max_waiting
        if limit and len(self._waiting) >= limit:
            # Bounded admission queue (backpressure): the typed shed
            # error serializes as a retry-elsewhere err frame, exactly
            # like EngineCore's — migration moves the request to a
            # less-loaded worker.
            self.sched_stats["shed_total"] += 1
            self.flight.record_event(
                "shed_queue_full", rid=pre.request_id or context.id,
                waiting=len(self._waiting), limit=limit,
            )
            raise EngineOverloadedError(
                f"scheduler queue full ({limit} requests waiting); "
                f"retry on another instance"
            )
        max_tokens = pre.stop.max_tokens or 16
        seq = _Seq(
            request_id=pre.request_id or context.id,
            prompt=list(pre.token_ids),
            max_tokens=max_tokens,
            out=asyncio.Queue(),
            seq=TokenBlockSequence(pre.token_ids, self.args.block_size),
            prompt_hashes=compute_seq_hashes(pre.token_ids, self.args.block_size),
            stop=pre.stop,
            replay_base=pre.replayed_tokens,
            tenant_id=pre.tenant_id or "",
            priority=pre.priority or 0,
            notify_chunks=bool(
                (pre.kv_transfer_params or {}).get("do_remote_decode")
            ),
        )
        if pre.deadline_epoch is not None:
            seq.deadline_epoch = pre.deadline_epoch
        elif pre.deadline_ms is not None and pre.deadline_ms > 0:
            seq.deadline_epoch = self.clock() + pre.deadline_ms / 1000.0
        spec = resolve_spec_config(
            self._spec_default, pre.spec_decode, self.args.spec_k
        )
        seq.spec_k = spec.k if spec is not None else 0
        seq.spec_device = spec.device if spec is not None else False
        seq.t_submit = time.time()
        self._waiting.append(seq)
        self._ensure_loop()
        self._wakeup.set()
        try:
            while True:
                # Engine-local queue; a chaos-killed loop parks this
                # deliberately (the client stall deadline catches it).
                # dynalint: unbounded-ok — engine-local queue
                item = await seq.out.get()
                if item is self._FINISHED:
                    return
                shed = item.get("meta", {}).get("shed") if isinstance(item, dict) else None
                if shed == "deadline":
                    # Expired while queued: typed, clean, never a
                    # half-stream (mirrors TpuEngine.generate).
                    from dynamo_tpu_torch.runtime.engine import DeadlineExceededError

                    raise DeadlineExceededError(
                        item["meta"].get("detail", "deadline exceeded in queue")
                    )
                yield item
                if context.is_stopped:
                    seq.cancelled = True
                    return
        finally:
            seq.cancelled = True
            self._trace_phases(seq, context)

    def _trace_phases(self, seq: _Seq, context: Context) -> None:
        """Emit the request's prefill/decode spans from the timestamps the
        sim loop stamped; parented through the dataplane headers so they
        stitch under the frontend's root span."""
        headers = context.headers
        if seq.t_first_sched:
            # Queue-wait attribution (admit -> first chunk), mirroring the
            # real engine's sched_admit span.
            self._tracer.record(
                "sched_admit", seq.t_submit, seq.t_first_sched, headers=headers,
                attrs={
                    "request_id": seq.request_id,
                    "prompt_tokens": len(seq.prompt),
                    "tenant": seq.tenant_id or "default",
                },
            )
        if seq.t_prefill_done:
            self._tracer.record(
                "prefill", seq.t_submit, seq.t_prefill_done, headers=headers,
                attrs={
                    "request_id": seq.request_id,
                    "prompt_tokens": len(seq.prompt),
                    "cached_tokens": seq.cached_blocks * self.args.block_size,
                    "tenant": seq.tenant_id or "default",
                },
            )
        if seq.generated and seq.t_last_token and seq.t_prefill_done:
            self._tracer.record(
                "decode", seq.t_prefill_done, seq.t_last_token, headers=headers,
                attrs={
                    "request_id": seq.request_id,
                    "tokens": seq.generated,
                    "tenant": seq.tenant_id or "default",
                },
            )

    def scheduler_stats(self) -> dict:
        """Point-in-time scheduler gauges (status-server /metrics export);
        same keys as EngineCore.scheduler_stats."""
        st = dict(self.sched_stats)
        st["waiting"] = len(self._waiting)
        st["running"] = len(self._running)
        st["chunked_scheduling"] = 1 if self.args.scheduling == "chunked" else 0
        st["token_budget"] = self.args.max_num_batched_tokens
        st["async_exec"] = 1 if self.args.async_exec else 0
        st["queue_limit"] = self.args.max_waiting
        st["fair_enabled"] = 1 if self.args.fair_scheduling else 0
        st["megastep_k"] = self.args.megastep_k
        # Pipe occupancy, mirroring EngineCore.scheduler_stats: k*M
        # wavefront work items over k*M + pp - 1 rounds (M = pp
        # microbatch groups); 1.0 when pp is off.
        st["pp_stages"] = self.args.pp
        km = max(1, self.args.megastep_k) * self.args.pp
        st["pp_pipe_occupancy"] = km / (km + self.args.pp - 1)
        toks = self.sched_stats["committed_tokens"]
        st["dispatches_per_token"] = (
            self.sched_stats["dispatches"] / toks if toks else 0.0
        )
        return st

    def spec_decode_stats(self) -> dict:
        """Speculation gauges, same keys as EngineCore.spec_decode_stats
        (the status server exports identical series for real and mock
        workers)."""
        st = self.spec_stats.as_dict()
        st["enabled"] = 1 if self._spec_default is not None else 0
        return st

    def kv_cache_stats(self) -> dict:
        """Prefix-cache gauges, same keys as EngineCore.kv_cache_stats:
        ``prefix_*`` are match_prefix probe counters, ``admitted_*`` count
        admitted sequences whose prefix was served from cache.
        bytes_per_block uses the mocker's nominal llama3-8b geometry
        (L=32, n_kv=8, d=128) so the dtype capacity delta is observable
        on /metrics just like a real worker's."""
        from dynamo_tpu_torch.engine.kv_quant import kv_page_bytes

        st = self.kv.stats
        return {
            "kv_dtype": self.args.kv_dtype,
            "kv_dtype_int8": 1 if self.args.kv_dtype == "int8" else 0,
            "bytes_per_block": kv_page_bytes(
                32, self.args.block_size, 8, 128, self.args.kv_dtype
            ),
            "capacity_blocks": self.kv.capacity,
            "resident_blocks": self.kv.used_blocks,
            "prefix_queries": st.prefix_queries,
            "prefix_hits": st.prefix_hits,
            "prefix_hit_rate": (
                st.prefix_hits / st.prefix_queries if st.prefix_queries else 0.0
            ),
            "admitted_queries": self._admit_prefix_queries,
            "admitted_hits": self._admit_prefix_hits,
            "admitted_hit_rate": (
                self._admit_prefix_hits / self._admit_prefix_queries
                if self._admit_prefix_queries
                else 0.0
            ),
        }

    def fair_queue_stats(self) -> dict[str, dict[str, float]]:
        """Per-tenant queue depth + DRR deficit snapshot, same shape as
        EngineCore.fair_queue_stats (status-server tenant gauges)."""
        return self._waiting.stats()

    # -- cluster KV pool mirror ---------------------------------

    def import_peer_blocks(
        self, hashes: list[int], parents: list[int | None]
    ) -> tuple[int, float]:
        """Register peer-pulled block hashes as locally cached and price
        the transfer: returns (blocks imported, virtual-clock seconds the
        pull costs). The cost models the dataplane copy of the canonical
        packed buffer — per-block microseconds x the kv_dtype byte ratio
        (int8 ≈ 0.52x) — so shared-prefix TTFT A/Bs carry the transfer
        price, not just the win. Token values never change: an imported
        prefix only turns recompute into a prefix-cache hit."""
        from dynamo_tpu_torch.engine.kv_quant import kv_page_bytes

        imported = 0
        for h, parent in zip(hashes, parents):
            if self.kv.import_block(h, parent):
                imported += 1
        cost_s = (
            imported
            * self.args.kv_pull_us_per_block
            * self._kv_byte_ratio
            / 1e6
            / self.args.speedup_ratio
        )
        self.peer_stats.blocks_pulled += imported
        self.peer_stats.bytes_pulled += imported * kv_page_bytes(
            32, self.args.block_size, 8, 128, self.args.kv_dtype
        )
        return imported, cost_s

    def kv_pool_stats(self) -> dict:
        """kv_pool_* gauge payload, same keys as the jax worker's
        PeerKvClient.pool_stats() + KvEventPublisher.stats() merge (the
        publisher half is merged in by run_mocker, which owns it)."""
        return self.peer_stats.as_dict()

    def metrics(self) -> ForwardPassMetrics:
        return ForwardPassMetrics(
            worker=WorkerStats(
                request_active_slots=len(self._running),
                request_total_slots=self.args.max_num_seqs,
                num_requests_waiting=len(self._waiting),
                queue_limit=self.args.max_waiting,
                requests_shed_total=(
                    self.sched_stats["shed_total"]
                    + self.sched_stats["deadline_expired_total"]
                ),
                budget_utilization=self.sched_stats[
                    "last_step_budget_utilization"
                ],
            ),
            kv=KvStats(
                kv_active_blocks=self.kv.used_blocks,
                kv_total_blocks=self.kv.capacity,
                gpu_cache_usage_perc=self.kv.usage_perc,
                gpu_prefix_cache_hit_rate=(
                    self.kv.stats.prefix_hits / self.kv.stats.prefix_queries
                    if self.kv.stats.prefix_queries
                    else 0.0
                ),
            ),
            spec_decode=(
                self.spec_decode_stats()
                if self._spec_default is not None or self.spec_stats.verify_rows
                else None
            ),
            # Measured per-peer pull cost (NetKV): routers read this to
            # weigh decode placement / peer hints by real transfer cost.
            net=self.peer_stats.net_dict() or None,
        )

    # -- simulation loop ---------------------------------------------------

    def _ensure_loop(self) -> None:
        if self._dead:
            return  # chaos-killed: stays dead until the process restarts
        if self._loop_task is None or self._loop_task.done():
            self._loop_task = asyncio.create_task(self._sim_loop())

    def iter_time_s(
        self, prefill_tokens: int, decode_seqs: int, kv_blocks_read: int = 0,
        device_rounds: int = 0, pp_rounds: int = 0,
    ) -> float:
        """Virtual-clock cost of one iteration under the overlap model:
        with async execution, the fixed host overhead runs one step ahead
        and hides under device compute (bounded by the larger term). The
        uncovered remainder is recorded as the ``host_gap`` stat. NOTE on
        semantics: the mocker's span is the model's DEVICE-IDLE time per
        iteration (it knows the split exactly), while the real engine's
        ``host_gap`` is the wall-clock gap between consecutive dispatch
        enqueues (it cannot see device occupancy) — same name, related
        but not identical quantities; compare trends, not absolutes.

        ``kv_blocks_read`` prices the DMA-bound decode KV traffic
        (resident blocks read per lane-iteration), scaled by the
        configured kv_dtype's byte ratio — int8 halves this term, which
        is exactly the int8-page win bench.py run_kvquant_ab measures."""
        host_s = self.args.base_iter_us / 1e6
        device_s = (
            prefill_tokens * self.args.prefill_us_per_token
            + decode_seqs * self.args.decode_us_per_seq
            + kv_blocks_read
            * self.args.kv_read_us_per_block
            * self._kv_byte_ratio
            # On-device draft rounds: ring match + gather between inner
            # iterations — device-side work, so it hides
            # nothing and overlaps with nothing extra.
            + device_rounds * knobs.get_float("DYN_SPEC_DRAFT_ROUND_US")
            # Pipeline stage hops: each ppermute boundary
            # crossing a decode dispatch paid this iteration, bubble
            # included — device-side collective time, same overlap
            # behaviour as the draft rounds above.
            + pp_rounds * knobs.get_float("DYN_PP_HOP_US")
        ) / 1e6
        if self.args.async_exec:
            total = max(host_s, device_s)
            gap = max(0.0, host_s - device_s)
        else:
            total = host_s + device_s
            gap = host_s
        now = time.time()
        self._tracer.record(
            "host_gap", now - gap, now,
            attrs={"overlapped": self.args.async_exec}, stat=True,
        )
        return total / self.args.speedup_ratio

    async def _sim_loop(self) -> None:
        while True:
            if not self._waiting and not self._running:
                self._wakeup.clear()
                await self._wakeup.wait()
            if chaos.active():
                try:
                    # stall: wedged loop, streams freeze, socket stays up;
                    # kill: the loop dies for good (worker-crash twin).
                    await chaos.inject("engine.step", self.chaos_tag)
                except chaos.ChaosKill:
                    log.warning(
                        "chaos: engine loop killed (tag=%r, %d in flight)",
                        self.chaos_tag, len(self._running),
                    )
                    self._dead = True
                    # Post-mortem: the victim's final steps
                    # dump to a redacted artifact before the loop dies —
                    # chaos tests reconstruct the killed worker's last
                    # megasteps from it.
                    from dynamo_tpu_torch.obs import flight_recorder

                    flight_recorder.dump_all("chaos_kill", self.chaos_tag)
                    return
            self._admit()
            prefill_tokens, decode_seqs = self._step()
            self._iterations += 1
            await asyncio.sleep(
                self.iter_time_s(
                    prefill_tokens, decode_seqs, self._last_kv_blocks_read,
                    self._last_device_rounds, self._last_pp_rounds,
                )
            )

    def _sweep_queue(self) -> None:
        """Queue hygiene ahead of admission, mirroring EngineCore:
        cancelled requests leave from ANY queue position; queued
        requests past their deadline get the typed shed frame (the
        generate loop raises it as DeadlineExceededError). Queued
        sequences hold no pins or partials, so removal is the whole
        cleanup."""
        now = self.clock()

        def dead(s: _Seq) -> bool:
            # ONE combined pass per iteration (cancel + expiry),
            # mirroring EngineCore._sweep_queue.
            return s.cancelled or (
                s.deadline_epoch is not None
                and now > s.deadline_epoch
                and s.generated == 0
            )

        swept = self._waiting.sweep(dead)
        for seq in swept:
            if seq.cancelled:
                self._finish(seq, emit=False)
        expired = [s for s in swept if not s.cancelled]
        for seq in expired:
            self.sched_stats["deadline_expired_total"] += 1
            self.flight.record_event(
                "deadline_expired", rid=seq.request_id,
                tenant=seq.tenant_id or "default",
            )
            waited_ms = (now - seq.t_submit) * 1e3 if seq.t_submit else 0.0
            out = LLMEngineOutput(
                token_ids=[], finish_reason="error",
                prompt_tokens=len(seq.prompt), completion_tokens=0,
            )
            out.meta = {
                "shed": "deadline",
                "detail": (
                    f"request {seq.request_id} expired after "
                    f"{waited_ms:.0f} ms in the scheduler queue"
                ),
            }
            seq.out.put_nowait(out.to_wire())
            self._finish(seq, emit=False)

    def _admit(self) -> None:
        self._sweep_queue()
        watermark_blocks = self.args.watermark * self.kv.capacity
        while self._waiting and len(self._running) < self.args.max_num_seqs:
            # DRR head (FIFO with fairness off / one tenant); pop() on
            # successful admission charges the tenant's deficit.
            seq = self._waiting.head()
            cached = self.kv.acquire_cached(seq.prompt_hashes)
            to_commit = len(seq.prompt_hashes) - cached
            trailing = 1 if len(seq.prompt) % self.args.block_size else 0
            need = to_commit + trailing
            if self.kv.free_blocks - need < watermark_blocks and self._running:
                # Not enough headroom; un-pin and retry next iteration.
                self.kv.release(seq.prompt_hashes[:cached])
                return
            try:
                self.kv.allocate_partial(need) if need else None
            except InsufficientBlocksError:
                self.kv.release(seq.prompt_hashes[:cached])
                return
            self._waiting.pop()
            # Admission-time prefix accounting (one query per ADMITTED
            # sequence), mirroring EngineCore._admit — DEDICATED counters,
            # never the kv manager's match_prefix probe counters.
            self._admit_prefix_queries += 1
            if cached:
                self._admit_prefix_hits += 1
            seq.cached_blocks = cached
            seq.pinned = list(seq.prompt_hashes[:cached])
            seq.partials_held = need
            seq.prefilled = cached * self.args.block_size
            if seq.prefill_done:  # fully prefix-cached: no prefill phase
                self._mark_first_sched(seq)
                seq.t_prefill_done = seq.t_first_sched
            self._running.append(seq)

    def _mark_first_sched(self, seq: _Seq) -> None:
        """Close the admit→first-schedule window as a sched_admit stat
        span (cache hits included — the queue-wait histogram must cover
        the fast cohort too, mirroring EngineCore._mark_first_sched)."""
        if seq.t_first_sched:
            return
        seq.t_first_sched = time.time()
        self._sched_tracer.record(
            "sched_admit", seq.t_submit, seq.t_first_sched,
            attrs={
                "request_id": seq.request_id,
                "prompt_tokens": len(seq.prompt),
            },
            stat=True,
        )

    def _step(self) -> tuple[int, int]:
        """One engine iteration; returns (prefill tokens, decoding seqs).

        scheduling='chunked': prefill chunks (capped at prefill_chunk) and
        decode rows share the max_num_batched_tokens budget in the same
        iteration. scheduling='waves': while ANY prompt is prefilling,
        the iteration is prefill-only (monolithic, budget-bound) and every
        in-flight decode stalls — the real engine's wave scheduler."""
        budget = self.args.max_num_batched_tokens
        chunk_cap = self.args.prefill_chunk or budget
        any_prefill = any(
            not s.prefill_done and not s.cancelled for s in self._running
        )
        prefill_only = self.args.scheduling == "waves" and any_prefill
        # UNIVERSAL megastep (mirroring the real engine):
        # every iteration with decode work fuses — prefill chunks ride
        # the same priced dispatch and spec verify lanes resolve
        # accept/reject inside it, so mixed traffic no longer forces
        # k=1. k caps at the batch's largest remaining budget, like
        # EngineCore._chain_length. (waves scheduling still stalls
        # decodes during a wave via prefill_only — nothing to fuse.)
        k_mega = 1
        if self.args.megastep_k > 1 and not prefill_only:
            remaining = [
                max(1, s.max_tokens - s.generated)
                for s in self._running
                if s.prefill_done and not s.cancelled
            ]
            if remaining:
                k_mega = min(self.args.megastep_k, max(remaining))
        mega_lanes = 0
        mega_verify_lanes = 0
        mega_device_lanes = 0
        device_draft_tokens = 0  # priced like prefill tokens, not budgeted
        device_rounds_step = 0   # DYN_SPEC_DRAFT_ROUND_US each on the clock
        chunk_rows = 0
        tokens_emitted = 0
        prefill_tokens = 0
        decode_seqs = 0
        kv_blocks_read = 0  # resident blocks read by decode lane-iterations
        # Simulated verify accounting: drafted tokens are priced like
        # prefill tokens (each is one extra target forward in the verify
        # row) and count against the shared step budget.
        spec_tokens = 0
        spec_rows = spec_drafted = spec_accepted = spec_emitted = 0
        finished: list[_Seq] = []
        # Flight-recorder lane cursors for this iteration (counts only —
        # the dump artifact is redacted by contract, never token values).
        lane_records: list[dict] = []

        for seq in self._running:
            if seq.cancelled:
                finished.append(seq)
                continue
            if not seq.prefill_done:
                if not self.args.enable_chunked_prefill and prefill_tokens:
                    continue  # one prefill at a time without chunking
                chunk = min(
                    len(seq.prompt) - seq.prefilled,
                    budget - prefill_tokens - spec_tokens,
                )
                if not prefill_only:
                    chunk = min(chunk, chunk_cap)  # chunked: stream the prompt
                if chunk <= 0:
                    continue
                self._mark_first_sched(seq)
                chunk_rows += 1
                start_block = seq.prefilled // self.args.block_size
                seq.prefilled += chunk
                prefill_tokens += chunk
                lane_records.append(
                    {
                        "rid": seq.request_id, "kind": "chunk",
                        "chunk": chunk, "prefilled": seq.prefilled,
                        "prompt": len(seq.prompt),
                    }
                )
                end_block = seq.prefilled // self.args.block_size
                for i in range(max(start_block, seq.cached_blocks), end_block):
                    h = seq.prompt_hashes[i]
                    parent = seq.prompt_hashes[i - 1] if i else None
                    self.kv.commit_block(h, parent)
                    seq.partials_held -= 1
                    seq.pinned.append(h)
                if (
                    seq.notify_chunks
                    and self.on_chunk_commit is not None
                    and end_block > max(start_block, seq.cached_blocks)
                ):
                    # Absolute cursor: blocks [0, end_block) are all in
                    # cache now (cached prefix included). done rides
                    # _finish, mirroring EngineCore.
                    self.on_chunk_commit(seq.request_id, end_block, False)
                if seq.prefill_done:
                    seq.t_prefill_done = time.time()
                continue
            if prefill_only:
                continue  # waves: decodes stall for the whole wave

            # Decode: one token per iteration — or a UNIVERSAL MEGASTEP
            # of up to k_mega fused inner iterations under one dispatch
            # overhead. A speculating lane's verify row resolves inside
            # the fused iteration: it emits (1 + accepted) tokens for
            # iteration 0 plus one per remaining inner iteration,
            # mirroring the real engine's on-device accept/reject +
            # scanned continuation. Token VALUES are unchanged in every
            # mode: the stream is bit-identical, only the chunking and
            # the virtual clock move.
            inner = k_mega
            decode_seqs += inner  # lane-iterations: device term prices
            #                       masked no-ops too, like the real scan
            # KV traffic term: each lane-iteration's attention reads the
            # lane's whole resident context (DMA-bound decode).
            lane_blocks = inner * (
                -(-(seq.prefilled + seq.generated) // self.args.block_size)
            )
            kv_blocks_read += lane_blocks
            dev_lane = bool(seq.spec_k and seq.spec_device and inner > 1)
            if inner > 1:
                mega_lanes += 1
                if dev_lane:
                    mega_device_lanes += 1
                elif seq.spec_k:
                    mega_verify_lanes += 1
            if dev_lane:
                # ON-DEVICE DRAFTING: round 0 emits one token;
                # each later inner iteration drafts up to spec_k fresh
                # tokens from the history ring (clamped by the remaining
                # generation budget, like the device kc clamp) and emits
                # accepted + 1 — accepted depth compounds INSIDE the one
                # priced dispatch. Drafted tokens price like prefill
                # tokens but do NOT consume max_num_batched_tokens (the
                # ring lives on device; the plan charges one base token,
                # like the real engine).
                emitted = []
                finish = None
                stalled = False
                lane_rounds = lane_hits = 0
                lane_drafted = lane_accepted = 0
                for r in range(inner):
                    if r == 0:
                        n_emit = 1
                    else:
                        d_j = min(
                            seq.spec_k,
                            max(0, seq.max_tokens - seq.generated - 1),
                        )
                        a_j = 0
                        for _ in range(d_j):
                            if (
                                self._spec_rng.random()
                                >= self.args.spec_acceptance_rate
                            ):
                                break
                            a_j += 1
                        n_emit = a_j + 1
                        lane_rounds += 1
                        if d_j:
                            lane_hits += 1
                            lane_drafted += d_j
                            lane_accepted += a_j
                            self.spec_stats.observe_row(d_j, a_j)
                    for _ in range(n_emit):
                        token = 97 + ((seq.replay_base + seq.generated) % 26)
                        if len(self.seq_tail(seq)) == 0:
                            try:
                                self.kv.allocate_partial(1)
                                seq.partials_held += 1
                            except InsufficientBlocksError:
                                stalled = not emitted
                                break
                        completed = seq.seq.append(token)
                        if completed is not None:
                            self.kv.commit_block(
                                completed.block_hash, completed.parent_hash
                            )
                            seq.partials_held -= 1
                            seq.pinned.append(completed.block_hash)
                        seq.generated += 1
                        emitted.append(token)
                        finish = self._check_stop(seq, token)
                        if finish is not None:
                            break
                    if stalled or finish is not None:
                        break
                if stalled:
                    decode_seqs -= inner
                    kv_blocks_read -= lane_blocks
                    mega_lanes -= 1
                    mega_device_lanes -= 1
                    self.sched_stats["decode_stalls"] += 1
                    continue
                tokens_emitted += len(emitted)
                lane_records.append(
                    {
                        "rid": seq.request_id, "kind": "device",
                        "emitted": len(emitted), "generated": seq.generated,
                        "inner": inner, "rounds": lane_rounds,
                        "finish": finish or "",
                    }
                )
                device_draft_tokens += lane_drafted
                device_rounds_step += lane_rounds
                self.spec_stats.device_rounds += lane_rounds
                self.spec_stats.device_hits += lane_hits
                spec_rows += 1
                spec_drafted += lane_drafted
                spec_accepted += lane_accepted
                spec_emitted += len(emitted)
                out = LLMEngineOutput(token_ids=emitted)
                if seq.generated == len(emitted):
                    out.meta = {
                        "cached_tokens": (
                            seq.cached_blocks * self.args.block_size
                        ),
                        "iteration": self._iterations,
                    }
                seq.t_last_token = time.time()
                if finish is not None:
                    out.finish_reason = finish
                    out.prompt_tokens = len(seq.prompt)
                    out.completion_tokens = seq.generated
                    if seq.notify_chunks:
                        out.kv_transfer_params = {
                            "request_id": seq.request_id
                        }
                    seq.out.put_nowait(out.to_wire())
                    finished.append(seq)
                else:
                    seq.out.put_nowait(out.to_wire())
                continue
            drafted = min(
                seq.spec_k, max(0, budget - prefill_tokens - spec_tokens)
            )
            accepted = 0
            for _ in range(drafted):
                if self._spec_rng.random() >= self.args.spec_acceptance_rate:
                    break
                accepted += 1
            emitted: list[int] = []
            finish = None
            stalled = False
            for _ in range((1 + accepted) + (inner - 1) if seq.spec_k else inner):
                # 'a'..'z' cycle (ByteTokenizer); replay_base keeps a
                # migrated continuation on the original cycle position.
                token = 97 + ((seq.replay_base + seq.generated) % 26)
                if len(self.seq_tail(seq)) == 0:
                    # Starting a fresh block mid-decode needs a new partial.
                    try:
                        self.kv.allocate_partial(1)
                        seq.partials_held += 1
                    except InsufficientBlocksError:
                        stalled = not emitted
                        break  # stalled: emit what we have (maybe nothing)
                completed = seq.seq.append(token)
                if completed is not None:
                    self.kv.commit_block(completed.block_hash, completed.parent_hash)
                    seq.partials_held -= 1
                    seq.pinned.append(completed.block_hash)
                seq.generated += 1
                emitted.append(token)
                finish = self._check_stop(seq, token)
                if finish is not None:
                    break
            if stalled:
                decode_seqs -= inner
                kv_blocks_read -= lane_blocks
                if inner > 1:
                    mega_lanes -= 1
                    if seq.spec_k:
                        mega_verify_lanes -= 1
                self.sched_stats["decode_stalls"] += 1
                continue  # stalled this iteration (preemption-lite)
            tokens_emitted += len(emitted)
            lane_records.append(
                {
                    "rid": seq.request_id,
                    "kind": "verify" if drafted else "decode",
                    "emitted": len(emitted), "generated": seq.generated,
                    "inner": inner,
                    "finish": finish or "",
                }
            )
            if drafted:
                # Charge + account the verify row only once it actually
                # ran (the real engine drops the draft under block
                # pressure the same way — a stalled lane must not skew
                # the clock or the acceptance gauges).
                spec_tokens += drafted
                self.spec_stats.observe_row(drafted, accepted)
                spec_rows += 1
                spec_drafted += drafted
                spec_accepted += accepted
                spec_emitted += len(emitted)
            out = LLMEngineOutput(token_ids=emitted)
            if seq.generated == len(emitted):
                out.meta = {
                    "cached_tokens": seq.cached_blocks * self.args.block_size,
                    "iteration": self._iterations,
                }
            seq.t_last_token = time.time()
            if finish is not None:
                out.finish_reason = finish
                out.prompt_tokens = len(seq.prompt)
                out.completion_tokens = seq.generated
                if seq.notify_chunks:
                    # Disagg reply contract: the decode side pulls held
                    # blocks keyed by this id (the worker stamps its
                    # worker_id into the same dict before replying).
                    out.kv_transfer_params = {"request_id": seq.request_id}
                seq.out.put_nowait(out.to_wire())
                finished.append(seq)
            else:
                seq.out.put_nowait(out.to_wire())

        for seq in finished:
            self._running.remove(seq)
            self._finish(seq, emit=True)
        if spec_rows:
            # Draft + verify spans mirror the real engine's (the mocker's
            # draft is free, so the spans share one timestamp pair; what
            # matters for /traces consumers is the accepted-token attrs).
            now = time.time()
            self.spec_stats.verify_steps += 1
            self._tracer.record(
                "spec_draft", now, now,
                attrs={"seqs": spec_rows, "drafted": spec_drafted}, stat=True,
            )
            self._tracer.record(
                "spec_verify", now, now,
                attrs={
                    "seqs": spec_rows, "drafted": spec_drafted,
                    "accepted": spec_accepted, "tokens": spec_emitted,
                },
                stat=True,
            )
        st = self.sched_stats
        if prefill_tokens or decode_seqs or spec_rows:
            st["dispatches"] += 1
            if mega_lanes:
                st["megastep_dispatches"] += 1
                if chunk_rows or mega_verify_lanes:
                    # (Pure device-draft dispatches stay plain fused
                    # decode dispatches, like the real engine — the dd
                    # lanes keep their decode row shape.)
                    # A fused MIXED dispatch: prefill chunks
                    # and/or verify rows rode the same priced megastep.
                    st["fused_mixed_dispatches"] += 1
                now = time.time()
                # Same span name + attrs as EngineCore's megastep commit
                # (zero-width on the mocker's free host clock) so /traces
                # consumers and the smoke tool see identical series.
                self._tracer.record(
                    "engine_megastep", now, now,
                    attrs={
                        "seqs": mega_lanes, "inner_steps": k_mega,
                        "tokens": tokens_emitted,
                        "draft_rounds": device_rounds_step,
                        "pp_stages": self.args.pp,
                        "fused_shapes": {
                            "decode": (
                                mega_lanes - mega_verify_lanes
                                - mega_device_lanes
                            ),
                            "chunk": chunk_rows,
                            "verify": mega_verify_lanes,
                            "device": mega_device_lanes,
                        },
                    },
                    stat=True,
                )
            else:
                st["single_step_dispatches"] += 1
        st["committed_tokens"] += tokens_emitted
        if prefill_tokens and decode_seqs:
            st["mixed_steps"] += 1
        batched = prefill_tokens + spec_tokens + decode_seqs
        st["last_step_batched_tokens"] = batched
        st["last_step_budget_utilization"] = batched / budget if budget else 0.0
        st["chunked_prefills_in_flight"] = sum(
            1 for s in self._running if not s.prefill_done and s.t_first_sched
        )
        self._last_kv_blocks_read = kv_blocks_read
        self._last_device_rounds = device_rounds_step
        # Pipeline stage traffic this iteration: a decode
        # dispatch wavefronts k_mega iterations over pp stages and pays
        # the fill/drain bubble once — k*pp + pp-1 ppermute hops; a
        # prefill-only dispatch crosses the pipe once (pp + pp-1 hops).
        # With megastep_k=1 the SAME formula is the host-rollback
        # baseline: every token pays its own bubble + base_iter_us.
        pp_rounds_step = 0
        if self.args.pp > 1 and (prefill_tokens or decode_seqs):
            k_pp = k_mega if decode_seqs else 1
            pp_rounds_step = k_pp * self.args.pp + self.args.pp - 1
            if decode_seqs:
                key = "pp_fused_dispatches" if k_mega > 1 else "pp_forced_single"
                st[key] += 1
        self._last_pp_rounds = pp_rounds_step
        if self.flight.capacity and lane_records:
            # One flight-recorder record per iteration with work: step
            # shape + lane cursors (the chaos-kill artifact reconstructs
            # the victim's final megasteps from these). One dict append —
            # no work added to the priced step itself.
            self.flight.record_step(
                i=self._iterations,
                k=k_mega,
                shape={
                    "decode": sum(
                        1 for r in lane_records if r["kind"] == "decode"
                    ),
                    "chunk": chunk_rows,
                    "verify": sum(
                        1 for r in lane_records if r["kind"] == "verify"
                    ),
                    "device": sum(
                        1 for r in lane_records if r["kind"] == "device"
                    ),
                },
                batched=batched,
                emitted=tokens_emitted,
                lanes=lane_records[:64],
                lanes_truncated=len(lane_records) > 64,
                shed_total=st["shed_total"],
                deadline_expired_total=st["deadline_expired_total"],
            )
        # Device-drafted tokens ride the returned prefill-equivalent term
        # (each is one extra target forward in the verify-shaped row) but
        # never entered `batched` — they don't consume the host budget.
        return prefill_tokens + spec_tokens + device_draft_tokens, decode_seqs

    def _check_stop(self, seq: _Seq, token: int) -> str | None:
        reason = seq.stop.check_token(token, seq.generated, self.eos_token_ids)
        if reason is None and seq.generated >= seq.max_tokens:
            reason = "length"  # mocker defaults max_tokens when unset
        return reason

    def seq_tail(self, seq: _Seq) -> list[int]:
        return seq.seq.partial_tokens

    def _finish(self, seq: _Seq, emit: bool) -> None:
        if seq.notify_chunks and self.on_chunk_commit is not None:
            # Final cursor: every full prompt block is committed (the
            # mock cache RETAINS committed blocks after release, which
            # is what makes the decode side's window pulls work — no
            # hold/release plumbing needed in the mirror).
            self.on_chunk_commit(
                seq.request_id, len(seq.prompt) // self.args.block_size, True
            )
        self.kv.release(seq.pinned)
        if seq.partials_held:
            self.kv.release_partial(seq.partials_held)
            seq.partials_held = 0
        if emit:
            seq.out.put_nowait(self._FINISHED)
