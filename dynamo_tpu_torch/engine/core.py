"""EngineCore: continuous-batching scheduler on one device.

Counterpart of ``dynamo_tpu/engine/core.py`` for its waves and chunked
schedulers, synchronous or asynchronous execution, bf16 (model-dtype) or
int8 KV pages, plain or int8 weights, n-gram speculative decoding drafted
on the host or on the device, decode megasteps of k iterations. One
``step()`` is one engine iteration: drain new requests, admit under a
free-block watermark (reusing cached prefix blocks), then dispatch. Under
``waves`` that is one ragged prefill wave or one decode megastep for
every running sequence; under ``chunked`` every runnable decode row rides
next to prefill chunks in one ragged forward under the token budget
(:meth:`EngineCore._plan_mixed`), fused with k - 1 decode iterations where
k > 1 (:func:`_megastep_fused_body`), and a step with no prompt to prefill
is a decode megastep. All of it rides the SAME ragged forward
(``model.forward_tokens``); total tokens snap to ``prefill_buckets`` and
row counts to ``decode_buckets`` (a wave's to ``prefill_batch``), exactly
as the JAX engine pads them, so both engines run the same shapes and the
same block layout.

The decode megastep (:func:`_megastep_body`) is a loop of k decode+sample
iterations over device tensors: sampled tokens feed the next iteration on
the device, stop flags stay on the device, and the host reads the
``[k, B]`` token block once per megastep. On the card each megastep, each
prefill wave and each mixed step is the replay of a CUDA graph captured
once per static key (``engine/graphs.py``), the counterpart of the JAX
engine's jitted programs; on the CPU the bodies run eagerly.

Speculative decoding (``spec_decode="ngram"``, ``dynamo_tpu_torch/spec``):
a speculating lane's row is its pending token plus up to ``spec_k``
drafted tokens, verified in the same ragged forward at a sample width of
``R = spec_k + 1``; each drafted position samples the target's own
``(seed, counter)`` choice, so the stream is the one speculation off
would emit. With k > 1 verify rows ride the fused megastep, which
resolves accept/reject on the device; with ``spec_device_draft`` the
drafter itself runs between the megastep's iterations
(:func:`_megastep_draft_body`).

A step is planned and dispatched, then committed (:class:`_PlannedStep`).
With ``async_exec`` the engine keeps one step in flight: it plans and
dispatches step N+1 against the optimistic overlays of step N (cursor
advances, and the sampled tokens gathered on the device), then commits
step N while N+1 runs. A step whose advance depends on the data (live
drafts) commits before the next plan. The token streams are the
synchronous loop's.

Model paths beside the dense MLP: a MoE preset (Mixtral-style) runs the
sparse capacity-bounded expert dispatch in every forward
(``model._moe_mlp``), on every path above; a request's multimodal rows
(``pre.mm``: encoder embeddings and the placeholder spans they replace)
override the token embedding wherever its prompt rows ride a ragged
forward, whose dispatch then runs its body eagerly instead of a graph
replay (:meth:`EngineCore._ragged_launch`); and :meth:`EngineCore.embed`
mean-pools one prompt's final hidden states on a scratch cache of its
own.

KV tiers and transfer: with ``host_kv_blocks`` a block the allocator
evicts is sliced and copied into pinned host memory on the engine's
stream, and lands in the host (then disk) tier on the offload worker's
thread (``engine/offload.py``); admission promotes tier hits back. A
``do_remote_decode`` request holds its committed blocks after it finishes
for a decode peer to pull (:meth:`EngineCore.export_descriptors`,
:meth:`EngineCore.read_held_pages`), and :meth:`EngineCore.import_blocks`
writes a peer's pages into this cache as cached prefix blocks. Host and
wire pages keep the JAX package's layer-major layout and bytes. Every
write into the cache is in place (``index_copy_``): the CUDA graphs hold
the cache tensors' addresses.

Over a mesh (``parallel/``) the engine is one rank of several, each a
process with the same scheduler: under tp it computes its heads, under
dp its block of each decode megastep's lanes (every other dispatch runs
whole on every dp rank), and on a pipeline stage its layers, prefill
waves and mixed steps through the GPipe program and decode megasteps
through the wavefront chain (:func:`_pp_prefill_and_sample`,
:func:`_pp_decode_chain`). A MoE preset's experts split over tp, in
either expert-parallel dispatch (``model._moe_mlp``). An sp rank
(``ops.ring_attention.SPMesh``) holds a whole replica: a long prompt's
prefill goes round the ring of the ranks, each its chunk, and writes the
whole prompt into every rank's pages (:meth:`EngineCore._maybe_ring_prefill`,
eager, the step synchronous); every other dispatch runs whole on every
rank and keeps its CUDA graph.

Settings outside this slice are refused by name with the ``ROADMAP.md``
item that brings them; nothing is silently substituted.
"""

from __future__ import annotations

import contextlib
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
from dynamo_tpu_torch.engine.kv_quant import KV_DTYPES, kv_page_bytes, pack_kv_page, unpack_kv_page
from dynamo_tpu_torch.engine.model import (
    decode_tokens,
    embed_forward,
    forward_ring_prefill,
    forward_tokens,
    init_cache,
    init_params,
    params_fuse_tp,
    verify_tokens,
)
from dynamo_tpu_torch.engine.sampler import (
    device_ngram_draft,
    gather_feedback,
    resolve_verify,
    ring_append,
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
from dynamo_tpu_torch.parallel import comm
from dynamo_tpu_torch.parallel.pipeline import (
    plan_microbatches,
    pp_decode_round,
    pp_forward_tokens,
    stage_config,
    stage_params,
    stage_span,
)
from dynamo_tpu_torch.parallel.sharding import dp_lane_block, rank_config, shard_params
from dynamo_tpu_torch.runtime import wire
from dynamo_tpu_torch.runtime.engine import EngineOverloadedError
from dynamo_tpu_torch.spec import SpecConfig, SpecStats, propose_ngram, resolve_spec_config
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


def check_slice(model_cfg: ModelConfig, engine_cfg: EngineConfig, device) -> None:
    """Refuse every setting the port does not serve yet, naming the
    ``ROADMAP.md`` item that brings it, a KV dtype or scheduler that does
    not exist, and chunked-scheduling and speculation settings the JAX
    engine refuses. On a ``cuda`` device, also a model whose attention no
    instance of the card's kernel (K1) runs (``ragged_attention.
    card_refusals``): the generic instance takes f32, fp16 and bf16, any
    head_dim that is a multiple of 8 up to 256 and any whole GQA group. The
    JAX package serves such a model through its plain reference; the port
    refuses it, so the kernel never gives way to the plain version on the
    card. The check reads the configs alone, so it needs no card."""
    if engine_cfg.kv_dtype not in KV_DTYPES:
        raise ValueError(
            f"unknown kv_dtype {engine_cfg.kv_dtype!r} (expected one of {KV_DTYPES})"
        )
    if engine_cfg.spec_decode not in ("off", "ngram"):
        raise ValueError(
            f"unknown spec_decode {engine_cfg.spec_decode!r} (expected 'off' or 'ngram')"
        )
    if engine_cfg.spec_k < 1:
        raise ValueError(f"spec_k must be >= 1, got {engine_cfg.spec_k}")
    if engine_cfg.disk_kv_dir and engine_cfg.host_kv_blocks <= 0:
        raise ValueError("disk_kv_dir (G3) requires host_kv_blocks > 0 (G2)")
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
    if torch.device(device).type == "cuda":
        why = ragged_attention.card_refusals(model_cfg.torch_dtype, model_cfg.head_dim,
                                             model_cfg.num_heads, model_cfg.num_kv_heads)
        if why:
            raise ValueError(
                f"model {model_cfg.name!r} cannot run on the card's attention kernel: "
                f"{'; '.join(why)}; serve it with device='cpu' (the plain versions)"
            )


def _check_fuse_tp(params: dict, tp: int) -> None:
    """The fused wqkv/wgu column layout depends on tp; serving params fused
    for another tp would give silently wrong logits (permuted q/k/v and
    gate/up columns). Fail loudly instead (the JAX engine's check)."""
    fused = params_fuse_tp(params)
    if fused != tp:
        raise ValueError(
            f"params were fused for tp={fused} but the serving mesh has "
            f"tp={tp}; reload with load_hf_llama(path, tp={tp}) or "
            f"init_params(cfg, seed, tp={tp})"
        )


def check_pp(model_cfg: ModelConfig, engine_cfg: EngineConfig, pp: int) -> None:
    """The JAX engine's checks of a pp engine, with its messages: MoE and
    speculation are refused, pp divides the layers and the vocabulary, and
    the prefill buckets and decode widths split into pp microbatch groups
    (the microbatch count is pp)."""
    if model_cfg.is_moe:
        raise ValueError(
            "pipeline parallelism for MoE presets is not built yet "
            "(compose pp with the EP dispatch inside each stage)"
        )
    if engine_cfg.spec_decode != "off":
        raise ValueError(
            "speculative decoding under pipeline parallelism is not "
            "wired yet (the pp microbatch planner samples one row per "
            "sequence); run spec on a tp/dp or single-chip engine"
        )
    if model_cfg.num_layers % pp:
        raise ValueError(f"pp={pp} must divide num_layers={model_cfg.num_layers}")
    if model_cfg.vocab_size % pp:
        raise ValueError(f"pp={pp} must divide vocab_size={model_cfg.vocab_size}")
    for b in engine_cfg.prefill_buckets:
        if b % pp:
            raise ValueError(f"prefill bucket {b} not a multiple of pp microbatch count {pp}")
    for b in engine_cfg.decode_buckets:
        if b % pp:
            raise ValueError(f"decode bucket {b} not a multiple of pp microbatch count {pp}")


def _leaf_tensor(w) -> torch.Tensor:
    """A leaf's weight tensor (an int8 leaf's ``w``)."""
    return w["w"] if isinstance(w, dict) else w


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
    # -- speculative decoding --
    # Resolved policy, or None: the engine default merged with the
    # request's spec_decode override at admission.
    spec: SpecConfig | None = None
    # Every emitted token in order: the drafter's history past the prompt
    # (cleared on preemption, where the rebuilt prompt absorbs it).
    out_tokens: list[int] = field(default_factory=list)
    # Disaggregation: a remote-decode prefill holds its blocks after it
    # finishes until the decode worker pulls them.
    hold_blocks: bool = False
    # -- multimodal: encoder rows [n, h] f32 and their [start, count] spans
    mm_embeds: Any = None
    mm_positions: list | None = None
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
    (:meth:`EngineCore._assemble_ragged`): a prefill wave, a mixed or
    verify step, and the fused megastep's first iteration. ``R`` is the
    sample width: 1, or ``spec_k + 1`` where a verify row samples its
    drafted positions."""

    T: int
    R: int
    tokens: np.ndarray
    positions: np.ndarray
    write_pages: np.ndarray
    write_offs: np.ndarray
    kv_lens: np.ndarray
    tables: np.ndarray
    cu: np.ndarray
    # [S, R]: the row whose logits each sample slot reads, and its
    # counter key (a verify row's slot j reads its j-th token's logits
    # with counter generated + j).
    gather: np.ndarray
    counters: np.ndarray
    seeds: np.ndarray
    temp: np.ndarray
    top_k: np.ndarray
    top_p: np.ndarray
    # [T]: flat index into the in-flight step's sampled tokens of the
    # token at that slot, or -1 (the host value stands).
    feed_idx: np.ndarray
    # [T, h] f32 encoder rows and the [T] mask of the rows they replace,
    # or None when no row carries a multimodal span.
    mm_embeds: np.ndarray | None
    mm_mask: np.ndarray | None
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
    cfg, engine, mesh=None,
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
    authority over what is emitted.

    Over dp > 1 each rank runs the iterations on its block of the lanes
    (``parallel.sharding.dp_lane_block``), writing every lane's K/V rows
    (gathered per layer), and the lane blocks' tokens and logprobs are
    gathered at the end, so every rank returns the whole batch."""
    if mesh is not None and mesh.dp > 1 and not mesh.lanes:
        lo, hi = dp_lane_block(mesh, tokens.shape[0])
        toks, lp = _megastep_body(
            params, cache, *(a[lo:hi] for a in (
                tokens, block_tables, positions, active, seeds, counters, temperature,
                top_k, top_p, watch, budgets, min_left)),
            n_steps=n_steps, need_mask=need_mask, all_greedy=all_greedy,
            want_logprobs=want_logprobs, cfg=cfg, engine=engine, mesh=mesh.lane_view(),
        )
        return comm.dp_gather(toks, mesh, dim=1), (
            tuple(comm.dp_gather(a, mesh, dim=1) for a in lp) if lp is not None else None)
    toks, pos = tokens, positions
    alive = torch.ones_like(active)
    out, lps = [], []
    for i in range(n_steps):
        act = active & alive
        logits = decode_tokens(params, cache, toks, block_tables, pos, act, cfg, engine,
                               mesh=mesh)
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
    *, need_mask, all_greedy=False, want_logprobs=False, cfg, mm=None, mesh=None,
):
    """One ragged prefill wave + first-token sampling of every row of the
    [S, vocab] last-token logits; the host keeps only rows whose prompt
    completed this wave. ``mm``: (embeds, mask) of multimodal rows."""
    mm_embeds, mm_mask = mm or (None, None)
    logits = forward_tokens(
        params, cache, tokens, positions, write_pages, write_offs,
        kv_lens, block_tables, cu_q_lens, num_seqs, last_rows, cfg,
        mm_embeds=mm_embeds, mm_mask=mm_mask, mesh=mesh,
    )
    toks = sample_seeded(
        logits, seeds, counters, temperature, top_k, top_p,
        need_mask=need_mask, all_greedy=all_greedy,
    )
    lps = token_logprobs(logits, toks) if want_logprobs else None
    return toks, lps


def _ring_prefill_and_sample(
    params, cache, tokens, write_pages, write_offs, last_row: int,
    seeds, counters, temperature, top_k, top_p,
    *, need_mask, all_greedy=False, want_logprobs=False, cfg, sp_mesh,
):
    """One sequence-parallel prefill of a single long prompt (ring
    attention over the sp ranks, ``model.forward_ring_prefill``) and its
    first-token sampling, the same on every rank."""
    logits = forward_ring_prefill(params, cache, tokens, write_pages, write_offs, last_row,
                                  cfg, sp_mesh)
    toks = sample_seeded(
        logits, seeds, counters, temperature, top_k, top_p,
        need_mask=need_mask, all_greedy=all_greedy,
    )
    lps = token_logprobs(logits, toks) if want_logprobs else None
    return toks, lps


def _pp_prefill_and_sample(
    params, cache, mb_tokens, mb_positions, mb_pages, mb_offs,
    mb_kv_lens, block_tables, mb_cu, num_seqs, mb_last_local, mb_last_mask,
    seeds, counters, temperature, top_k, top_p,
    *, need_mask, all_greedy=False, want_logprobs=False, cfg, pp_mesh,
):
    """A prefill wave or mixed step under pipeline parallelism: the GPipe
    program (``parallel/pipeline.py``) and the same first-token sampling
    as :func:`_prefill_and_sample`, on every stage alike."""
    logits = pp_forward_tokens(
        params, cache, mb_tokens, mb_positions, mb_pages, mb_offs, mb_kv_lens,
        block_tables, mb_cu, num_seqs, mb_last_local, mb_last_mask, cfg, pp_mesh,
    )
    toks = sample_seeded(
        logits, seeds, counters, temperature, top_k, top_p,
        need_mask=need_mask, all_greedy=all_greedy,
    )
    lps = token_logprobs(logits, toks) if want_logprobs else None
    return toks, lps


def _pp_decode_chain(
    params, cache, tokens, block_tables, positions, active,
    seeds, counters, temperature, top_k, top_p,
    watch, budgets, min_left,
    *, n_steps, need_mask, all_greedy=False, want_logprobs=False,
    cfg, engine, pp_mesh,
):
    """Wavefront pipeline-parallel decode (JAX's ``_pp_decode_chain``):
    ``B`` lanes split into ``M = pp`` groups that march through the stages
    one round apart, so in steady state every stage works every round
    (occupancy ``n_steps*M / (n_steps*M + pp - 1)``). Group ``g``'s next
    token is sampled when it drains the last stage at round ``g + t*M +
    pp - 1`` and re-enters stage 0 at round ``g + (t+1)*M``, which comes
    later exactly when ``M >= pp``. Every stage samples the drained item
    from the same gathered logits, so the token store, the stop flags and
    the output are the same on every stage. The output contract is
    :func:`_megastep_body`'s, with the same stop flags: a lane that
    samples a watched stop id (or exhausts its budget) at its drain round
    goes dead, and its later items write the garbage block and repeat its
    last live token. Dead lanes' positions keep advancing (``pos0 + t``
    stays in the table: the planner grows k tokens of headroom per lane);
    their writes go to the garbage block, so the stream is the same. The
    host stop-scan stays the authority."""
    pp = pp_mesh.pp
    M = pp
    B = tokens.shape[0]
    Bm = B // M
    g_ = lambda a: a.reshape(M, Bm, *a.shape[1:])  # noqa: E731
    tab_g, pos_g, act_g = g_(block_tables), g_(positions), g_(active)
    seeds_g, cnt_g, temp_g, k_g, p_g = map(g_, (seeds, counters, temperature, top_k, top_p))
    watch_g, bud_g, ml_g = g_(watch), g_(budgets), g_(min_left)
    store = g_(tokens).clone()
    alive = torch.ones((M, Bm), dtype=torch.bool, device=tokens.device)
    out = torch.zeros((n_steps, M, Bm), dtype=torch.int32, device=tokens.device)
    lps: list = [[None] * M for _ in range(n_steps)]
    pending: list = []
    for r in range(n_steps * M + pp - 1):
        logits = pp_decode_round(
            params, cache, r, store, tab_g, pos_g, act_g & alive, pending,
            cfg=cfg, engine=engine, mesh=pp_mesh, n_steps=n_steps,
        )
        if logits is None:
            continue
        e = r - (pp - 1)  # the work item that drained the last stage
        ge, te = e % M, e // M
        nxt = sample_seeded(
            logits, seeds_g[ge], cnt_g[ge] + te, temp_g[ge], k_g[ge], p_g[ge],
            need_mask=need_mask, all_greedy=all_greedy,
        )
        live = act_g[ge] & alive[ge]
        new_tok = torch.where(live, nxt, store[ge])
        store[ge] = new_tok
        out[te, ge] = new_tok
        alive[ge] = alive[ge] & ~stop_flags(nxt, watch_g[ge], bud_g[ge], ml_g[ge], te)
        if want_logprobs:
            lps[te][ge] = token_logprobs(logits, new_tok)
    comm.wait_sends(pending)
    lp = None
    if want_logprobs:
        lp = tuple(
            torch.stack([torch.cat([lps[t][g][j] for g in range(M)]) for t in range(n_steps)])
            for j in range(len(lps[0][0]))
        )
    return out.reshape(n_steps, B), lp


def _first_iteration(
    params, cache, tokens, positions, write_pages, write_offs, kv_lens, block_tables,
    cu_q_lens, num_seqs, gather, seeds_r, counters_r, temp_r, top_k_r, top_p_r,
    draft, draft_len, cont_active, base_pos, watch, budgets, min_left,
    *, need_mask, all_greedy, want_logprobs, cfg, mm=None, mesh=None,
):
    """Iteration 0 of a fused or drafting megastep: the ragged forward
    (with multimodal rows ``mm``, if any), its ``[S, R]`` samples, each
    lane's accept/reject (:func:`resolve_verify`) and stop flag over the
    slots it emits. Returns (samples ``[S, R]``, their logprob arrays or
    None, accepted drafts, the token each lane goes on from, alive, tokens
    emitted, the next write position, each lane's counter base)."""
    mm_embeds, mm_mask = mm or (None, None)
    logits = forward_tokens(
        params, cache, tokens, positions, write_pages, write_offs,
        kv_lens, block_tables, cu_q_lens, num_seqs, gather, cfg,
        mm_embeds=mm_embeds, mm_mask=mm_mask, mesh=mesh,
    )
    t0 = sample_seeded(
        logits, seeds_r, counters_r, temp_r, top_k_r, top_p_r,
        need_mask=need_mask, all_greedy=all_greedy,
    )
    lp0 = token_logprobs(logits, t0) if want_logprobs else None
    S = draft.shape[0]
    t0s = t0.reshape(S, -1)
    acc, tok = resolve_verify(t0s, draft, draft_len)
    alive = cont_active & ~stop_flags_prefix(t0s, acc, watch, budgets, min_left)
    gen = torch.where(cont_active, acc + 1, 0).to(torch.int32)
    return t0s, lp0, acc, tok, alive, gen, base_pos + acc, counters_r.reshape(S, -1)[:, 0]


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
    cfg, engine, mm=None, mesh=None,
):
    """The UNIVERSAL megastep: one dispatch runs a ragged first iteration
    over prefill chunks, decode rows and verify rows (a mixed step's
    forward and sampling) and then ``n_steps - 1`` decode+sample
    iterations over the same lanes. Iteration 0 samples the ``[S, R]``
    sample slots with ``(seed, counter + j)`` keys and each lane resolves
    on the device (:func:`resolve_verify`): a verify row accepts the
    longest drafted prefix the target agrees with and continues from the
    correction (or bonus) token at ``base_pos + accepted``, so a rejected
    draft rolls back inside the dispatch (its K/V sits past the lane's
    position, never attended, overwritten by the continuation). A decode
    row continues from its sampled token; a prefill chunk that
    completes its prompt continues as a decode row from its first token;
    a mid-prompt chunk (``cont_active`` False) runs the remaining
    iterations as masked no-ops, writing only the garbage block and never
    advancing a cursor. The stop state (watch ids, budget, min-tokens
    floor) carries iteration 0's emission count.

    Returns (sampled ``[n_steps, S, R]``: iteration 0 fills the sample
    width, later iterations broadcast their token across it; matching
    logprob arrays or None). The host stop-scan stays the authority, as
    in :func:`_megastep_body`."""
    t0s, lp0, _, tok, alive, gen, pos, counters0 = _first_iteration(
        params, cache, tokens, positions, write_pages, write_offs, kv_lens, block_tables,
        cu_q_lens, num_seqs, gather, seeds_r, counters_r, temp_r, top_k_r, top_p_r,
        draft, draft_len, cont_active, base_pos, watch, budgets, min_left,
        need_mask=need_mask, all_greedy=all_greedy, want_logprobs=want_logprobs, cfg=cfg,
        mm=mm, mesh=mesh,
    )
    S, R = t0s.shape
    rest, rest_lp = [], []
    for _ in range(n_steps - 1):
        act = alive
        logits = decode_tokens(params, cache, tok, block_tables, pos, act, cfg, engine,
                               mesh=mesh)
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
    return widen(t0s.reshape(-1), rest), lps


def _rep(a: torch.Tensor, R: int) -> torch.Tensor:
    """[S] -> [S * R], each lane's value repeated over its sample slots."""
    return a if R == 1 else a[:, None].expand(a.shape[0], R).reshape(-1)


def _megastep_draft_body(
    params, cache,
    # -- iteration 0: the ragged forward (exactly a fused megastep's)
    tokens, positions, write_pages, write_offs, kv_lens, block_tables,
    cu_q_lens, num_seqs, gather,
    seeds_r, counters_r, temp_r, top_k_r, top_p_r,
    # -- per-lane continuation state ([S] unless noted)
    draft, draft_len,        # [S, R-1] host-drafted tokens, live length
    cont_active,             # bool: the lane continues past iteration 0
    base_pos,                # write position of the first later write at acc=0
    seeds, temp, top_k, top_p,
    watch, budgets, min_left,
    # -- drafting on the device
    hist, hist_len,          # [S, H] right-aligned history ring, [S] lengths
    dd,                      # [S] bool: lanes that draft on the device
    win, nmin, nmax, kmax,   # [S] each lane's drafter knobs
    *, n_steps, need_mask, all_greedy=False, want_logprobs=False,
    ngram_max_static, cfg, engine, mm=None, mesh=None,
):
    """The DRAFTING megastep: the fused megastep's ragged first iteration,
    then ``n_steps - 1`` verify-shaped iterations. Before each, every
    drafting lane suffix-matches its history ring
    (:func:`device_ngram_draft`); the iteration verifies pending + fresh
    draft as one width-R row (:func:`verify_tokens`), resolves
    accept/reject on the device and appends the emitted tokens to the ring
    (:func:`ring_append`), so draft, verify and accept loop inside one
    dispatch and a lane can emit up to ``1 + (n_steps - 1) * R`` tokens.

    Lanes that do not draft on the device (prefill chunks, decode rows,
    host-drafted verify rows) draft nothing each round (``draft_len`` 0),
    which is the fused body's one-token iteration: the same counters, the
    same budget arithmetic (:func:`stop_flags_prefix` from the running
    per-lane count), and flags that may under-stop, never over-stop. The
    host stop-scan stays the authority, and the ring is packed anew from
    committed history at every plan, which is the whole of its rollback.

    Returns (sampled ``[n_steps, S, R]``; a ``[3, n_steps, S]`` int32 of
    each round's emitted count, draft length and accepted count, round 0
    being iteration 0's resolution; matching logprob arrays or None)."""
    t0s, lp0, acc, tok, alive, gen, pos, counters0 = _first_iteration(
        params, cache, tokens, positions, write_pages, write_offs, kv_lens, block_tables,
        cu_q_lens, num_seqs, gather, seeds_r, counters_r, temp_r, top_k_r, top_p_r,
        draft, draft_len, cont_active, base_pos, watch, budgets, min_left,
        need_mask=need_mask, all_greedy=all_greedy, want_logprobs=want_logprobs, cfg=cfg,
        mm=mm, mesh=mesh,
    )
    S, R = t0s.shape
    # Iteration 0's emission enters the ring of a drafting lane; the ring
    # of any other lane is carried unread.
    hist, hlen = ring_append(hist, hist_len, t0s, torch.where(dd, gen, 0))
    jR = torch.arange(R, dtype=torch.int32, device=t0s.device)
    outs, es, dls, accs, rest_lp = [t0s], [gen], [draft_len], [acc], []
    for _ in range(n_steps - 1):
        act = alive
        # At most the remaining budget - 1, as the host drafter is capped,
        # so the correction or bonus token always fits.
        kc = torch.where(dd & act, torch.minimum(kmax, budgets - gen - 1), 0)
        dtoks, dlen = device_ngram_draft(
            hist, hlen, win, nmin, nmax, kc, ngram_max_static=ngram_max_static, slots=R - 1,
        )
        slot = torch.cat([tok[:, None], torch.where(dtoks >= 0, dtoks, 0)], dim=1)
        logits = verify_tokens(params, cache, slot, block_tables, pos, dlen, act, cfg, engine,
                               mesh=mesh)
        cnt = ((counters0 + gen)[:, None] + jR[None, :]).reshape(-1)
        nxt = sample_seeded(
            logits, _rep(seeds, R), cnt, _rep(temp, R), _rep(top_k, R), _rep(top_p, R),
            need_mask=need_mask, all_greedy=all_greedy,
        )
        ns = nxt.reshape(S, R)
        accj, nxt_tok = resolve_verify(ns, dtoks, dlen)
        e = torch.where(act, accj + 1, 0).to(torch.int32)
        out = torch.where(act[:, None], ns, tok[:, None])
        if want_logprobs:
            rest_lp.append(token_logprobs(logits, out.reshape(-1)))
        alive = alive & ~stop_flags_prefix(ns, accj, watch, budgets, min_left, gen_base=gen)
        pos = pos + e
        gen = gen + e
        hist, hlen = ring_append(hist, hlen, ns, torch.where(dd, e, 0))
        tok = torch.where(act, nxt_tok, tok)
        outs.append(out)
        es.append(e)
        dls.append(dlen)
        accs.append(accj)
    aux = torch.stack([torch.stack(es), torch.stack(dls), torch.stack(accs)]).to(torch.int32)
    lps = None
    if want_logprobs:
        # Iteration 0's [S*R(, K)] slots and each round's, as [n_steps, S, R(, K)].
        lps = tuple(
            torch.stack([a.reshape((S, R) + a.shape[1:]) for a in (a0, *(r[j] for r in rest_lp))])
            for j, a0 in enumerate(lp0)
        )
    return torch.stack(outs), aux, lps


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

    def __init__(self, core: "EngineCore", outs: tuple, aux: bool = False, sr=None):
        """``outs`` is (tokens, [aux,] logprob arrays...): ``aux`` says the
        drafting megastep's per-round counts follow the tokens. ``sr`` is
        (S, R): ``land()`` then shapes a verify step's flat samples as
        ``[S, R]``."""
        self.core = core
        self.toks = outs[0]  # device-resident: the next dispatch's feed source
        self._aux = aux
        self._sr = sr
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
        toks, *lps = (h.numpy().copy() for i, h in enumerate(self._host)
                      if not (self._aux and i == 1))
        if self._sr is not None:
            toks = toks.reshape(self._sr)
            lps = [a.reshape(self._sr + a.shape[1:]) for a in lps]
        return toks, tuple(lps) if lps else None

    def land_aux(self) -> np.ndarray:
        """The drafting megastep's ``[3, n_steps, S]`` per-round counts;
        call after :meth:`land`."""
        return self._host[1].numpy().copy()


@dataclass
class ImportResult:
    """Per-call KV import outcome (also accumulated in transfer_stats):
    ``dropped`` blocks arrived but found no free device block — the
    decode side will recompute them."""
    imported: int = 0
    skipped: int = 0
    dropped: int = 0

    def __int__(self) -> int:
        return self.imported


# Float page dtypes by their wire name (the JAX package's numpy names).
_WIRE_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}


def _host_numpy(t: torch.Tensor) -> np.ndarray:
    """A host tensor as numpy. numpy has no bfloat16: bf16 pages stay on
    the host as their raw 16-bit words (``uint16``), whose bytes are the
    JAX package's bfloat16 bytes."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _raw_bytes(buf) -> np.ndarray:
    """A page's bytes (``bytes`` or a host array) as a flat uint8 view."""
    if isinstance(buf, (bytes, bytearray, memoryview)):
        return np.frombuffer(buf, np.uint8)
    return np.ascontiguousarray(buf).reshape(-1).view(np.uint8)


class _Landing:
    """Device pages on their way to the host: a non-blocking copy into a
    pinned host tensor, enqueued on the engine's stream, and an event
    recorded after it. :meth:`land` (and ``np.asarray``, which is how the
    offload worker lands a page) waits on that event only, on whichever
    thread calls it, never on the step. On the CPU the tensor is the
    host copy already."""

    def __init__(self, t: torch.Tensor):
        self.event = None
        if t.is_cuda:
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = t

    def land(self) -> np.ndarray:
        """The pages as numpy, a view of the pinned buffer."""
        if self.event is not None:
            self.event.synchronize()
        return _host_numpy(self.host)

    def __array__(self, dtype=None, copy=None):
        # Copied out of the pinned buffer, which goes back to PyTorch's
        # pinned-memory cache for the next eviction (a host tier holding
        # pinned pages would make every eviction allocate pinned memory).
        a = np.array(self.land(), dtype=dtype, copy=True)
        self.host = None
        return a


def _chain_order(where: list[tuple[bool, int]], dev_pages: list, tier_page) -> list:
    """A hash chain's pages in its order: ``where`` gives each block's
    (on the device, hash); device pages come from ``dev_pages`` in turn,
    tier pages from ``tier_page(hash)``, whose None (evicted meanwhile)
    ends the chain."""
    out, dev = [], iter(dev_pages)
    for on_dev, h in where:
        page = next(dev) if on_dev else tier_page(h)
        if page is None:
            break
        out.append(page)
    return out


def _tier_bytes(kv) -> bytes | None:
    return None if kv is None else np.ascontiguousarray(kv).tobytes()


def _landing(pages):
    """Start landing a page program's output (a tensor, or int8's
    ``{kv, scale}``)."""
    if isinstance(pages, dict):
        return {k: _Landing(v) for k, v in pages.items()}
    return _Landing(pages)


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
    # emission as flat indices into feed_tokens, in stream order, set by
    # deterministic plans only: a device-drafting lane's next plan gathers
    # it into its history ring, so the drafter sees in-flight tokens.
    feed_series: dict[str, tuple[int, int, int]] = field(default_factory=dict)
    # False when a lane's advance depends on the data (verify rows with
    # live drafts): the next plan must commit this step first.
    deterministic: bool = True
    # "prefill", "decode", "mixed" or "spec": what the engine loop's time is filed under
    kind: str = ""
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
# a fused or drafting megastep (engine/graphs.py): one layout per width,
# one per (bucket, rows, sample width).
def _decode_layout(B: int, P: int) -> Layout:
    return Layout([
        ("tokens", (B,), "i"), ("feed_idx", (B,), "i"), ("block_tables", (B, P), "i"),
        ("positions", (B,), "i"), ("active", (B,), "b"), ("seeds", (B,), "i"),
        ("counters", (B,), "i"), ("temperature", (B,), "f"), ("top_k", (B,), "i"),
        ("top_p", (B,), "f"), ("watch", (B, MEGASTEP_WATCH_W), "i"),
        ("budgets", (B,), "i"), ("min_left", (B,), "i"),
    ])


def _prefill_layout(T: int, S: int, P: int, R: int = 1) -> Layout:
    """A ragged forward's fields: ``gather`` and ``counters`` hold one
    entry per sample slot, the sampling knobs one per row."""
    return Layout([
        ("tokens", (T,), "i"), ("positions", (T,), "i"), ("write_pages", (T,), "i"),
        ("write_offs", (T,), "i"), ("kv_lens", (S,), "i"), ("block_tables", (S, P), "i"),
        ("cu_q_lens", (S + 1,), "i"), ("num_seqs", (1,), "i"), ("gather", (S * R,), "i"),
        ("seeds", (S,), "i"), ("counters", (S * R,), "i"), ("temperature", (S,), "f"),
        ("top_k", (S,), "i"), ("top_p", (S,), "f"),
    ])


def _pp_layout(M: int, Tm: int, S: int, P: int) -> Layout:
    """A ragged forward's fields under pipeline parallelism: the microbatch
    plan of its rows (``parallel.pipeline.PPPlan``, each ``[M, ...]``
    array flat), one sample slot per row, and ``feed_idx`` (the plan only
    pads the token buffer, so flat feed indices apply to its flat
    tokens)."""
    return Layout([
        ("tokens", (M * Tm,), "i"), ("positions", (M * Tm,), "i"),
        ("write_pages", (M * Tm,), "i"), ("write_offs", (M * Tm,), "i"),
        ("kv_lens", (M * S,), "i"), ("block_tables", (S, P), "i"),
        ("cu_q_lens", (M * (S + 1),), "i"), ("num_seqs", (1,), "i"),
        ("last_local", (M * S,), "i"), ("last_mask", (M * S,), "b"),
        ("seeds", (S,), "i"), ("counters", (S,), "i"), ("temperature", (S,), "f"),
        ("top_k", (S,), "i"), ("top_p", (S,), "f"), ("feed_idx", (M * Tm,), "i"),
    ])


def _mixed_layout(T: int, S: int, P: int, R: int = 1) -> Layout:
    """A prefill wave's fields plus ``feed_idx``: decode and verify rows
    read their first token from the in-flight step's output on the
    device."""
    return Layout([*_prefill_layout(T, S, P, R).spec, ("feed_idx", (T,), "i")])


def _fused_layout(T: int, S: int, P: int, R: int = 1) -> Layout:
    """A mixed step's fields plus each lane's host draft and continuation
    state."""
    return Layout([
        *_mixed_layout(T, S, P, R).spec, ("draft", (S, R - 1), "i"), ("draft_len", (S,), "i"),
        ("cont_active", (S,), "b"), ("base_pos", (S,), "i"),
        ("watch", (S, MEGASTEP_WATCH_W), "i"), ("budgets", (S,), "i"), ("min_left", (S,), "i"),
    ])


def _drafted_layout(T: int, S: int, P: int, R: int, H: int) -> Layout:
    """A fused megastep's fields plus each lane's history ring and drafter
    knobs. ``ring_feed`` is (first, stride, take): the ring's newest
    ``take`` slots gather the in-flight step's tokens at flat indices
    ``first, first + stride, ...`` on the device (``take`` 0: none)."""
    return Layout([
        *_fused_layout(T, S, P, R).spec, ("hist", (S, H), "i"), ("hist_len", (S,), "i"),
        ("dd", (S,), "b"), ("win", (S,), "i"), ("nmin", (S,), "i"), ("nmax", (S,), "i"),
        ("kmax", (S,), "i"), ("ring_feed", (S, 3), "i"),
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
        pp_mesh: Any = None,
        sp_mesh: Any = None,
        on_stored: Callable[[list[int], int | None], None] | None = None,
        on_removed: Callable[[list[int]], None] | None = None,
        on_tier_stored: Callable[[list[int], int | None, str], None] | None = None,
        on_tier_removed: Callable[[list[int], str], None] | None = None,
    ):
        """``params`` is a parameter dict on ``device`` (``engine/convert``
        or a previous engine's ``core.params``); None initialises random
        weights from ``seed``. ``mesh`` (``parallel.sharding.Mesh``) serves
        tensor and data parallelism: this process is one rank, on the
        mesh's device for it, with the rank's tp shard of ``params`` (a
        full dict fused for the mesh's tp is sharded here) and the rank's
        KV heads; a dp rank holds its replica of both and computes its
        block of each decode megastep's lanes. ``pp_mesh``
        (``parallel.pipeline.PPMesh``) serves pipeline parallelism instead
        (the two exclude each other, as in JAX): this process is one
        stage, with its layers of ``params`` (a full dict is sliced here)
        and a cache of its layers; prefill waves and mixed steps run the
        GPipe program and decode megasteps the wavefront chain. ``sp_mesh``
        (``ops.ring_attention.SPMesh``) serves sequence-parallel ring
        prefill instead (it excludes the other two, as in JAX): every rank
        holds a whole replica of ``params`` and of the cache, a prompt of
        at least ``ring_prefill_threshold`` tokens is prefilled round the
        ring, each rank computing its chunk (:meth:`_maybe_ring_prefill`),
        and every other dispatch runs whole on every rank with no
        collective. Every rank must run the same steps in the same order
        (``backends/torch/multihost.py``). Over gloo every dispatch runs
        eagerly (a collective through the host cannot sit in a CUDA
        graph); over NCCL the collectives are captured. ``on_stored`` and
        ``on_removed`` receive the allocator's KV events (block hashes
        committed under a parent, hashes evicted), called on the thread
        that runs ``step()``. With both ``on_tier_stored`` and
        ``on_tier_removed``, offload-tier transitions publish tier-tagged
        events (the offload worker's thread calls them too), as in the
        JAX engine."""
        self.device = resolve_device(device)
        check_slice(model_cfg, engine_cfg, self.device)
        if sp_mesh is not None:
            # The JAX engine's refusals of an sp engine, with its messages.
            if engine_cfg.scheduling == "chunked":
                raise ValueError(
                    "scheduling='chunked' is not wired for sp meshes yet; "
                    "those engines keep 'waves'"
                )
            if engine_cfg.async_exec:
                raise ValueError(
                    "async_exec is not wired for sp meshes yet (the ring "
                    "prefill path runs synchronously); sp engines keep the "
                    "synchronous loop"
                )
        self.mesh = mesh
        tp = dp = pp = 1
        if pp_mesh is not None:
            if mesh is not None or sp_mesh is not None:
                raise ValueError(
                    "pp_mesh is mutually exclusive with mesh (tp/dp) and "
                    "sp_mesh for now (pp x tp composition: future work)"
                )
            pp = pp_mesh.pp
            check_pp(model_cfg, engine_cfg, pp)
        # A pipeline of one stage is the unpipelined engine.
        self.pp_mesh = pp_mesh if pp > 1 else None
        if mesh is not None:
            if sp_mesh is not None:
                raise ValueError("sp_mesh (sequence parallel) and mesh (tp/dp) "
                                 "are mutually exclusive for now")
            tp, dp = mesh.tp, mesh.dp
            for b in engine_cfg.decode_buckets:
                if b % dp:
                    raise ValueError(f"decode bucket {b} not a multiple of dp={dp}")
        # The sequence-parallel group of the ring prefill, or None; ring
        # prefills run so far (the JAX engine's observability counter).
        self.sp_mesh = sp_mesh
        self._ring_prefills = 0
        sp = sp_mesh.sp if sp_mesh is not None else 1
        ranked = (mesh if mesh is not None and tp * dp > 1 else pp_mesh if pp > 1
                  else sp_mesh if sp > 1 else None)
        if ranked is not None and self.device != resolve_device(ranked.device):
            raise ValueError(f"rank {ranked.rank} runs on {ranked.device}, not {self.device}")
        # Pipeline stages, also the microbatch count M (the wavefront needs
        # M >= pp, and M = pp keeps each stage's lm-head slice V/pp).
        self._pp = pp
        # The shapes this rank computes and caches: its heads (all at tp 1)
        # and its layers (all at pp 1).
        self.local_cfg = stage_config(rank_config(model_cfg, tp), pp)
        # A collective through the host cannot be captured in a CUDA graph.
        # An sp rank's dispatches call none (the ring prefill, which does,
        # runs eagerly outside the graphs), so they keep their graphs.
        self._eager_only = (ranked is not None and ranked is not sp_mesh
                            and ranked.backend != comm.NCCL)
        # The mesh whose ranks share the KV pages (None for one rank): page
        # export, import, peer serving and embeddings are collective
        # methods on it, which every rank calls in the same order; rank 0
        # holds the whole wire pages (``comm.page_gather``/``page_scatter``).
        self._page_mesh = ranked
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
        # The verify sample width: static per engine, so the graph keys
        # grow by one width, not one per draft length; shorter drafts pad
        # the sample gather with repeated reads.
        self._spec_R = engine_cfg.spec_k + 1
        self._spec_default = (
            SpecConfig(
                method=engine_cfg.spec_decode,
                k=engine_cfg.spec_k,
                ngram_min=engine_cfg.spec_ngram_min,
                ngram_max=engine_cfg.spec_ngram_max,
                window=engine_cfg.spec_window,
                device=engine_cfg.spec_device_draft,
            )
            if engine_cfg.spec_decode != "off"
            else None
        )
        # Drafting on the device: each lane's history ring holds the tail
        # the host drafter is handed (window + ngram_max tokens), so the
        # two drafters see the same candidates.
        self._spec_device = engine_cfg.spec_decode != "off" and engine_cfg.spec_device_draft
        self._ring_H = engine_cfg.spec_window + engine_cfg.spec_ngram_max
        self.spec_stats = SpecStats()
        self.cfg = model_cfg
        self.engine = engine_cfg
        self.eos_token_ids = set(eos_token_ids)
        span = stage_span(model_cfg, pp, pp_mesh.stage) if pp > 1 else None
        if params is None:
            params = init_params(model_cfg, seed, self.device, tp=tp,
                                 rank=mesh.tp_rank if tp > 1 else None, layer_span=span)
        _check_fuse_tp(params, tp)
        if tp > 1 and _leaf_tensor(params["layers"]["wo"]).shape[-2] == model_cfg.q_size:
            params = shard_params(params, model_cfg, mesh)  # a full dict: take this rank's
        if pp > 1:
            params = stage_params(params, model_cfg, pp_mesh)  # a full dict: take this stage's
        _check_params(params, self.device)
        self.params = params
        self.cache = init_cache(stage_config(model_cfg, pp), engine_cfg, self.device, tp=tp)
        self.allocator = DeviceBlockAllocator(
            engine_cfg.num_kv_blocks,
            bs,
            enable_prefix_caching=engine_cfg.enable_prefix_caching,
            on_stored=on_stored,
            on_removed=on_removed,
        )
        # The stream every step and every page program runs on: device
        # work is ordered on it, as XLA orders the JAX engine's programs.
        self._stream = (
            torch.cuda.current_stream(self.device) if self.device.type == "cuda" else None
        )
        self.host_pool = None
        self.disk_pool = None
        self.offload = None
        self._tier_aware = on_tier_stored is not None and on_tier_removed is not None
        self._on_tier_stored = on_tier_stored
        self._on_tier_removed = on_tier_removed
        if engine_cfg.host_kv_blocks > 0:
            from dynamo_tpu_torch.engine.host_cache import HostKvPool
            from dynamo_tpu_torch.engine.offload import DiskKvPool, OffloadEngine

            def _pool_removed(tier: str) -> Callable[[list[int]], None]:
                # Tier-aware: the pool's eviction retracts THAT tier;
                # otherwise the worker-level removed, as the JAX engine.
                if self._tier_aware:
                    return lambda hashes: self._on_tier_removed(hashes, tier)
                return lambda hashes: self.allocator.on_removed(hashes)

            self.host_pool = HostKvPool(
                engine_cfg.host_kv_blocks, on_removed=_pool_removed("host")
            )
            if engine_cfg.disk_kv_dir:
                self.disk_pool = DiskKvPool(
                    # Ranks hold different pages under one hash: each its
                    # own directory.
                    engine_cfg.disk_kv_dir if ranked is None
                    else f"{engine_cfg.disk_kv_dir}/rank{ranked.rank}",
                    engine_cfg.disk_kv_blocks,
                    on_removed=_pool_removed("disk"),
                )
            self.offload = OffloadEngine(
                self.host_pool,
                self.disk_pool,
                on_tier_stored=on_tier_stored if self._tier_aware else None,
                on_tier_removed=on_tier_removed if self._tier_aware else None,
            )
            self.allocator.on_evict = self._offload_block
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
        # Deadline expiry reads the wall clock; ranks in lockstep turn it
        # off (backends/torch/multihost.py). So does held-block expiry,
        # which their leader decides on its own clock and journals.
        self.enforce_deadlines = True
        self.expire_holds = True
        self.iterations = 0
        # Step-level spans (engine_prefill_step / engine_decode_step /
        # engine_megastep / engine_commit / host_gap ...), stat spans of
        # the "engine" service; queue-wait spans under "sched", so the
        # facade's per-request sched_admit twin is not counted twice.
        self._tracer = tracing.get_tracer("engine")
        self._sched_tracer = tracing.get_tracer("sched")
        self._req_counter = 0
        self._lock = threading.Lock()
        # Serializes step() against the cache surgery of other threads
        # (import and export of transferred KV blocks).
        self._step_lock = threading.Lock()
        # Finished remote-decode prefills whose blocks wait for their
        # decode worker, and each hold's deadline (monotonic), refreshed
        # by every transfer call and swept at the top of each step.
        self._held: dict[str, Sequence] = {}
        self._held_deadline: dict[str, float] = {}
        # ``on_chunk_commit(request_id, committed_blocks, done)``: called
        # under the step lock on the engine thread each time a
        # hold_blocks sequence commits prefill blocks, and once with
        # done=True when it finishes; it must not block or re-enter.
        self.on_chunk_commit = None
        # Measured per-peer pull costs, installed by PeerKvClient.
        self.net_stats_source = None
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
        # Disaggregated KV transfer accounting (imported and dropped
        # blocks apart: a dropped block is recomputed by the decode side),
        # reported in ForwardPassMetrics.transfer.
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
            # or verify rows.
            "fused_mixed_dispatches": 0,
            "megastep_forced_single": 0,
            # Dispatches that ran their body eagerly on the card instead of
            # a graph replay (those carrying multimodal rows).
            "eager_dispatches": 0,
            # Pipeline-parallel decode chains of k > 1 iterations and of
            # one (a watch list too wide for the device's stop flags).
            "pp_fused_dispatches": 0,
            "pp_forced_single": 0,
            # Model forwards: one per prefill wave, one per decode
            # iteration; on a pipeline stage one per microbatch through its
            # layers (M per wave, M per decode iteration). Every forward
            # runs the attention kernel once per layer this rank holds on
            # the card (its int8 instance for int8 pages).
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
            # The engine loop's time in steps that verified speculating
            # lanes and carried no prefill chunk (verify steps, fused and
            # drafting megasteps of decode lanes).
            "spec_loop_s": 0.0,
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
        # The embeddings' scratch pages (one tuple per engine, built at the
        # first embed() call).
        self._embed_scratch: tuple | None = None

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
        if (pre.kv_transfer_params or {}).get("do_remote_decode"):
            seq.hold_blocks = True
        # The request's spec_decode dict overrides the engine default
        # ("off" disables; k clamps to spec_k); a bad one is refused here.
        seq.spec = resolve_spec_config(self._spec_default, pre.spec_decode, self.engine.spec_k)
        if seq.spec is not None and self.pp_mesh is not None:
            raise ValueError(
                "speculative decoding under pipeline parallelism is not "
                "wired yet (route spec requests to a tp/dp worker)"
            )
        if pre.mm and pre.mm.get("embeds") is not None:
            if self.pp_mesh is not None:
                # Refused at admission, not inside a wave other requests share.
                raise ValueError(
                    "multimodal embedding splice under pipeline parallelism "
                    "is not wired yet (route mm requests to a tp/dp worker)"
                )
            embeds = np.frombuffer(pre.mm["embeds"], np.float32).reshape(
                tuple(pre.mm["embeds_shape"])
            )
            if embeds.shape[1] != self.cfg.hidden_size:
                raise ValueError(
                    f"multimodal embeds of width {embeds.shape[1]} != "
                    f"hidden_size {self.cfg.hidden_size}"
                )
            positions = [list(p) for p in pre.mm["positions"]]
            need_rows = sum(cnt for _, cnt in positions)
            if embeds.shape[0] < need_rows:
                # Refused here, not inside a wave that other requests share.
                raise ValueError(
                    f"multimodal embeds have {embeds.shape[0]} rows but the "
                    f"placeholder spans need {need_rows}"
                )
            seq.mm_embeds = embeds
            seq.mm_positions = positions
        seq.tenant_id = pre.tenant_id or ""
        seq.priority = pre.priority or 0
        if pre.deadline_epoch is not None:
            seq.deadline_epoch = pre.deadline_epoch
        elif pre.deadline_ms is not None and pre.deadline_ms > 0:
            seq.deadline_epoch = time.time() + pre.deadline_ms / 1000.0
        seq.t_queued = time.time()
        self._enqueue(seq)
        return seq

    def _enqueue(self, seq: Sequence) -> None:
        """Hand a validated sequence to the scheduler (the lockstep leader
        stages it for its next step record instead)."""
        self._inbox.append(seq)

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

    def _feed_series(self, seq: Sequence) -> tuple[int, int, int] | None:
        """The in-flight step's whole emission for this lane as flat
        indices ``(start, stride, count)`` into its device output, or None:
        a device-drafting lane's ring gathers it, so the drafter matches
        against tokens the host has not committed yet."""
        if self._inflight is None:
            return None
        return self._inflight.feed_series.get(seq.request_id)

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
                self.enforce_deadlines
                and s.deadline_epoch is not None
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
            if self.host_pool is not None:
                cached_ids, ncached = self._onboard_from_host(
                    seq.prompt_hashes, cached_ids, ncached, cap
                )
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
        if completed and seq.hold_blocks and self.on_chunk_commit is not None:
            # Streaming handoff: the committed prefix is immutable and
            # readable from now on; a decode peer may pull it while this
            # prefill keeps chunking.
            self.on_chunk_commit(seq.request_id, seq.committed_blocks, False)

    def _assemble_ragged(
        self, rows: list[tuple[Sequence, list[int], int, int]], S: int,
        n_sample: list[int] | None = None,
        feed_rows: list[int | None] | None = None,
        force_R: bool = False,
    ) -> _RaggedBatch:
        """Host-side assembly of one ragged forward's inputs: each row is
        ``(seq, tokens, pos_start, kv_len)``, packed into one token buffer
        padded to the prefill bucket; padded slots write the garbage block.
        Shared by the prefill wave, the mixed and verify steps and the
        fused megastep's first iteration, so they cannot disagree on row
        packing, sample rows or counter keys. ``n_sample`` (aligned with
        rows) marks verify rows: an entry above 1 samples that row's first
        n positions, with counters ``generated + j``, the keys the
        one-token path would use for the same tokens; every other row
        samples its last position. The sample width is ``spec_k + 1``
        when any row verifies, or with ``force_R`` (a drafting megastep
        needs the width for its later iterations), else 1; short rows pad
        it with repeated reads. A non-None entry of ``feed_rows`` is the
        flat index of that row's first token in the in-flight step's
        sampled output, gathered on the device over the host
        placeholder."""
        P = self.engine.max_blocks_per_seq
        bs = self.engine.block_size
        total = sum(len(tl) for _, tl, _, _ in rows)
        T = self._bucket_for(total)
        R = (
            self._spec_R
            if force_R or (n_sample is not None and any(n > 1 for n in n_sample))
            else 1
        )

        tokens = np.zeros(T, np.int32)
        positions = np.zeros(T, np.int32)
        write_pages = np.full(T, self.engine.garbage_block, np.int32)
        write_offs = np.zeros(T, np.int32)
        kv_lens = np.zeros(S, np.int32)
        tables = np.full((S, P), self.engine.garbage_block, np.int32)
        cu = np.zeros(S + 1, np.int32)
        gather = np.zeros((S, R), np.int32)
        counters = np.zeros((S, R), np.int32)
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
            # Read through the overlay: with a step in flight the lane's
            # generated count lags by the tokens that step will commit.
            gen0 = self._eff_generated(seq)
            if n_sample is not None and n_sample[i] > 1:
                off = np.minimum(np.arange(R, dtype=np.int32), chunk - 1)
                gather[i] = t + off
                counters[i] = gen0 + off
            else:
                gather[i] = t + chunk - 1
                counters[i] = gen0
            if feed_rows is not None and feed_rows[i] is not None:
                feed_idx[t] = feed_rows[i]
            seeds[i] = seq.seed
            temp[i] = seq.sampling.temperature
            top_k[i] = seq.sampling.top_k
            top_p[i] = seq.sampling.top_p
            t += chunk
        cu[1 : len(rows) + 1] = np.cumsum([len(tl) for _, tl, _, _ in rows])
        cu[len(rows) + 1 :] = cu[len(rows)]
        # Multimodal splice: a row whose prompt position falls inside an
        # image span takes the encoder's row for that patch. Decode and
        # verify rows sit past the prompt, so the span check never selects
        # them.
        mm_embeds = mm_mask = None
        if any(s.mm_embeds is not None for s, _, _, _ in rows):
            mm_embeds = np.zeros((T, self.cfg.hidden_size), np.float32)
            mm_mask = np.zeros(T, bool)
            t0 = 0
            for seq, toks_list, pos0, _ in rows:
                lo, hi = pos0, pos0 + len(toks_list)
                if seq.mm_embeds is not None:
                    row = 0
                    for start, cnt in seq.mm_positions:
                        for p in range(start, start + cnt):
                            if lo <= p < hi:
                                mm_embeds[t0 + p - lo] = seq.mm_embeds[row]
                                mm_mask[t0 + p - lo] = True
                            row += 1
                t0 += hi - lo
        return _RaggedBatch(
            T=T, R=R, tokens=tokens, positions=positions, write_pages=write_pages,
            write_offs=write_offs, kv_lens=kv_lens, tables=tables, cu=cu,
            gather=gather, counters=counters, seeds=seeds, temp=temp,
            top_k=top_k, top_p=top_p, feed_idx=feed_idx,
            mm_embeds=mm_embeds, mm_mask=mm_mask,
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
            "cu_q_lens": b.cu, "num_seqs": [b.num_rows], "gather": b.gather,
            "seeds": b.seeds, "counters": b.counters, "temperature": b.temp,
            "top_k": b.top_k, "top_p": b.top_p, "feed_idx": b.feed_idx,
        }

    def _mm_operands(self, b: _RaggedBatch) -> tuple | None:
        """``b``'s multimodal rows and mask on the engine's device, or
        None."""
        if b.mm_embeds is None:
            return None
        return (self._to_device(torch.from_numpy(b.mm_embeds)),
                self._to_device(torch.from_numpy(b.mm_mask)))

    def _ragged_launch(self, b: _RaggedBatch, S: int, mixed: bool = False) -> Launch:
        """One ragged forward + sampling of ``b`` as a dispatch. A prefill
        wave's graph key is (token bucket, sampling variant), its ``S`` the
        engine's fixed ``prefill_batch``; a mixed or verify step's
        (``mixed``) is (token bucket, width, sample width, sampling
        variant), and its decode and verify rows may read their first
        token from the in-flight step on the device.

        A batch with multimodal rows runs its body eagerly, on the card
        too (``Launch.eager``), with the rows beside the packed buffer:
        the JAX engine compiles a ``want_mm`` variant of every program,
        which as graphs would double the keys warm_up() captures, and a
        key captured at its first use would cost the first image request
        a capture (1.2-3.7 s) inside its TTFT. Only the dispatches that
        carry an image's prompt rows pay the eager launches."""
        if self.pp_mesh is not None:
            return self._pp_ragged_launch(b, S, mixed)
        P, R = self.engine.max_blocks_per_seq, b.R
        layout = _mixed_layout(b.T, S, P, R) if mixed else _prefill_layout(b.T, S, P)
        fields = self._ragged_fields(b)
        packed = layout.pack({k: fields[k] for k in layout.fields})
        need_mask = b.need_mask and not b.all_greedy
        mm = self._mm_operands(b)

        def body(buf: torch.Tensor) -> tuple:
            x = layout.unpack(buf)
            toks, lps = _prefill_and_sample(
                self.params, self.cache,
                x["tokens"], x["positions"], x["write_pages"], x["write_offs"],
                x["kv_lens"], x["block_tables"], x["cu_q_lens"], x["num_seqs"],
                x["gather"], _rep(x["seeds"], R), x["counters"], _rep(x["temperature"], R),
                _rep(x["top_k"], R), _rep(x["top_p"], R),
                need_mask=need_mask, all_greedy=b.all_greedy,
                want_logprobs=b.want_lp, cfg=self.cfg, mm=mm, mesh=self.mesh,
            )
            return (toks, *(lps or ()))

        variant = (need_mask, b.all_greedy, b.want_lp)
        key = ("mixed", b.T, S, R, *variant) if mixed else ("prefill", b.T, *variant)
        return Launch(key, layout, packed, body, eager=mm is not None)

    def _pp_ragged_launch(self, b: _RaggedBatch, S: int, mixed: bool) -> Launch:
        """:meth:`_ragged_launch` on a pipeline stage: ``b``'s rows planned
        into ``M`` microbatches on the host (``plan_microbatches``) and run
        through the GPipe program (:func:`_pp_prefill_and_sample`). The
        keys are the unpipelined engine's. A pp engine serves no
        speculation and no image rows, so the sample width is 1 and the
        body never runs eagerly for them."""
        M, P = self._pp, self.engine.max_blocks_per_seq
        plan = plan_microbatches(
            b.tokens, b.positions, b.write_pages, b.write_offs, b.kv_lens, b.cu,
            b.num_rows, b.gather[:, 0], M, self.engine.garbage_block,
        )
        Tm = plan.tokens.shape[1]
        feed_idx = np.full(M * Tm, -1, np.int32)
        feed_idx[: b.T] = b.feed_idx
        layout = _pp_layout(M, Tm, S, P)
        packed = layout.pack({
            "tokens": plan.tokens, "positions": plan.positions,
            "write_pages": plan.write_pages, "write_offs": plan.write_offs,
            "kv_lens": plan.kv_lens, "block_tables": b.tables, "cu_q_lens": plan.cu_q_lens,
            "num_seqs": [b.num_rows], "last_local": plan.last_local,
            "last_mask": plan.last_mask, "seeds": b.seeds, "counters": b.counters[:, 0],
            "temperature": b.temp, "top_k": b.top_k, "top_p": b.top_p, "feed_idx": feed_idx,
        })
        need_mask = b.need_mask and not b.all_greedy

        def body(buf: torch.Tensor) -> tuple:
            x = layout.unpack(buf)
            mb = {k: x[k].view(M, -1) for k in (
                "tokens", "positions", "write_pages", "write_offs", "kv_lens", "cu_q_lens",
                "last_local", "last_mask")}
            toks, lps = _pp_prefill_and_sample(
                self.params, self.cache,
                mb["tokens"], mb["positions"], mb["write_pages"], mb["write_offs"],
                mb["kv_lens"], x["block_tables"], mb["cu_q_lens"], x["num_seqs"],
                mb["last_local"], mb["last_mask"],
                x["seeds"], x["counters"], x["temperature"], x["top_k"], x["top_p"],
                need_mask=need_mask, all_greedy=b.all_greedy, want_logprobs=b.want_lp,
                cfg=self.cfg, pp_mesh=self.pp_mesh,
            )
            return (toks, *(lps or ()))

        variant = (need_mask, b.all_greedy, b.want_lp)
        key = ("mixed", b.T, S, 1, *variant) if mixed else ("prefill", b.T, *variant)
        return Launch(key, layout, packed, body)

    @staticmethod
    def _fused_lanes(S: int, R: int, budget: int) -> dict[str, np.ndarray]:
        """A fused megastep's per-lane inputs with every lane idle (no
        draft, no continuation, no watch), padded lanes' budget
        ``budget``."""
        return {
            "draft": np.full((S, R - 1), -1, np.int32), "draft_len": np.zeros(S, np.int32),
            "cont_active": np.zeros(S, bool), "base_pos": np.zeros(S, np.int32),
            "watch": np.full((S, MEGASTEP_WATCH_W), -1, np.int32),
            "budgets": np.full(S, budget, np.int32), "min_left": np.zeros(S, np.int32),
        }

    def _ring_lanes(self, S: int) -> dict[str, np.ndarray]:
        """A drafting megastep's ring inputs with no lane drafting."""
        return {
            "hist": np.zeros((S, self._ring_H), np.int32), "hist_len": np.zeros(S, np.int32),
            "dd": np.zeros(S, bool), "win": np.ones(S, np.int32), "nmin": np.ones(S, np.int32),
            "nmax": np.ones(S, np.int32), "kmax": np.zeros(S, np.int32),
            "ring_feed": np.zeros((S, 3), np.int32),
        }

    def _fused_launch(
        self, b: _RaggedBatch, S: int, n_steps: int, lanes: dict[str, np.ndarray],
        drafted: bool = False,
    ) -> Launch:
        """One fused megastep as a dispatch: ``b``'s ragged iteration and
        ``n_steps - 1`` decode iterations, the lanes' drafts and
        continuation state in ``lanes`` (:meth:`_fused_lanes`). Its graph
        key is (token bucket, width, n_steps, sample width, sampling
        variant). ``drafted``: the drafting megastep
        (:func:`_megastep_draft_body`) instead, with the rings of
        :meth:`_ring_lanes` in ``lanes``; its key is (token bucket, width,
        n_steps, sampling variant), its sample width always ``spec_k + 1``."""
        P, R = self.engine.max_blocks_per_seq, b.R
        layout = (_drafted_layout(b.T, S, P, R, self._ring_H) if drafted
                  else _fused_layout(b.T, S, P, R))
        packed = layout.pack({**self._ragged_fields(b), **lanes})
        need_mask = b.need_mask and not b.all_greedy
        mm = self._mm_operands(b)

        def body(buf: torch.Tensor) -> tuple:
            x = layout.unpack(buf)
            args = (
                self.params, self.cache,
                x["tokens"], x["positions"], x["write_pages"], x["write_offs"],
                x["kv_lens"], x["block_tables"], x["cu_q_lens"], x["num_seqs"],
                x["gather"], _rep(x["seeds"], R), x["counters"], _rep(x["temperature"], R),
                _rep(x["top_k"], R), _rep(x["top_p"], R),
                x["draft"], x["draft_len"], x["cont_active"], x["base_pos"],
                x["seeds"], x["temperature"], x["top_k"], x["top_p"],
                x["watch"], x["budgets"], x["min_left"],
            )
            kw = dict(n_steps=n_steps, need_mask=need_mask, all_greedy=b.all_greedy,
                      want_logprobs=b.want_lp, cfg=self.cfg, engine=self.engine, mm=mm,
                      mesh=self.mesh)
            if drafted:
                toks, aux, lps = _megastep_draft_body(
                    *args, x["hist"], x["hist_len"], x["dd"], x["win"], x["nmin"],
                    x["nmax"], x["kmax"], ngram_max_static=self.engine.spec_ngram_max, **kw,
                )
                return (toks, aux, *(lps or ()))
            toks, lps = _megastep_fused_body(*args, **kw)
            return (toks, *(lps or ()))

        variant = (need_mask, b.all_greedy, b.want_lp)
        key = (("drafted", b.T, S, n_steps, *variant) if drafted
               else ("fused", b.T, S, n_steps, R, *variant))
        return Launch(key, layout, packed, body, eager=mm is not None)

    def _launch(self, launch: Launch, feed: Callable | None = None) -> tuple:
        """Run one dispatch and return its output tensors: eagerly on the
        CPU, else as the replay of its graph, captured at first use where
        warm_up() did not; an ``eager`` launch runs its body on the card
        as on the CPU. ``feed(buf)`` writes the device-resident slots of
        the packed inputs."""
        if self.device.type == "cpu" or launch.eager or self._eager_only:
            buf = self._to_device(torch.from_numpy(launch.packed))
            if feed is not None:
                feed(buf)
            if self.device.type == "cuda":
                self.exec_stats["eager_dispatches"] += 1
            return launch.body(buf)
        if launch.key not in self._graphs:
            if self._inflight is not None:
                raise _NeedCapture(launch.key)
            self._graphs.capture(launch, self.device)
        return self._graphs.replay(launch, feed)

    def _feed(self, launch: Launch, fed: bool, ring: bool = False) -> Callable | None:
        """The device-side feed of ``launch`` from the in-flight step's
        sampled tokens (:func:`gather_feedback`), or None: where ``fed``,
        the ``tokens`` slots whose ``feed_idx`` is set; where ``ring``, the
        history rings' in-flight tails named by ``ring_feed``."""
        if not (fed or ring):
            return None
        src, layout = self._inflight.feed_tokens, launch.layout

        def feed(buf: torch.Tensor) -> None:
            if fed:
                tok = layout.field(buf, "tokens")
                tok.copy_(gather_feedback(src, tok, layout.field(buf, "feed_idx")))
            if ring:
                hist, rf = layout.field(buf, "hist"), layout.field(buf, "ring_feed")
                H = hist.shape[1]
                j = torch.arange(H, device=buf.device)[None, :] - (H - rf[:, 2:3])
                idx = torch.where(j >= 0, rf[:, 0:1] + j * rf[:, 1:2], -1)
                hist.copy_(gather_feedback(src, hist.reshape(-1), idx.reshape(-1))
                           .reshape(hist.shape))

        return feed

    def _dispatch_ragged(
        self, rows: list[tuple[Sequence, list[int], int, int]], S: int,
        n_sample: list[int] | None = None,
        feed_rows: list[int | None] | None = None,
    ) -> _PendingFetch:
        """Assemble and enqueue ONE ragged forward + fused sampling over
        arbitrary rows: prefill chunks (tokens sliced from the prompt),
        decode rows (the pending token at position ``processed``, q_len
        1) and verify rows (pending + drafted tokens, marked by
        ``n_sample``). A prefill wave passes ``S = prefill_batch`` and no
        ``feed_rows``; a mixed or verify step (``feed_rows`` given,
        aligned with rows) its decode width. Returns a pending fetch whose
        ``land()`` yields (tokens, logprob arrays or None), ``[S, R]``
        with ``n_sample``, else ``[S]``."""
        b = self._assemble_ragged(rows, S, n_sample, feed_rows)
        mixed = feed_rows is not None
        launch = self._ragged_launch(b, S, mixed)
        outs = self._launch(launch, self._feed(launch, bool((b.feed_idx >= 0).any())))
        self.exec_stats["single_step_dispatches"] += 1
        self.exec_stats["forwards"] += self._pp
        if mixed:
            self._count_mixed(b)
        return _PendingFetch(self, outs, sr=(S, b.R) if n_sample is not None else None)

    def _count_mixed(self, b: _RaggedBatch) -> None:
        self.exec_stats["mixed_tokens"] += int(b.cu[b.num_rows])
        self.exec_stats["mixed_bucket_tokens"] += b.T

    def _dispatch_fused(
        self,
        rows: list[tuple[Sequence, list[int], int, int]],
        S: int,
        n_sample: list[int],
        feed_rows: list[int | None],
        kinds: list[str],
        drafts: list[list[int]],
        cont: list[bool],
        n_steps: int,
        device: list[bool] | None = None,
    ) -> _PendingFetch:
        """Assemble and enqueue one UNIVERSAL megastep
        (:func:`_megastep_fused_body`): the ragged first iteration a mixed
        step would run over these rows (prefill chunks "p", decode rows
        "d", verify rows "v" with their ``drafts``), fused with
        ``n_steps - 1`` decode iterations. ``cont`` (aligned with rows)
        marks the lanes that go on after iteration 0: every decode and
        verify row, and a prefill chunk when it completes its prompt and
        the planner reserved its headroom. Verify rows resolve
        accept/reject on the device and go on from the correction token.
        Returns a pending fetch whose ``land()`` yields ([n_steps, S, R]
        tokens, matching logprob arrays or None).

        When a lane of ``device`` drafts on the device, the dispatch is
        the drafting megastep (:func:`_megastep_draft_body`): each such
        lane's ring is packed from committed history, its in-flight tail
        gathered on the device (:meth:`_pack_rings`), and the fetch also
        lands the per-round counts (``land_aux``)."""
        use_dd = device is not None and any(device)
        b = self._assemble_ragged(rows, S, n_sample, feed_rows, force_R=use_dd)
        R = b.R
        # Masked and padded lanes never reach their budget: the deepest lane
        # emits accepted + 1 + (n_steps - 1) <= R + n_steps - 1 tokens, a
        # drafting lane up to R a round, n_steps * R in all.
        lanes = self._fused_lanes(S, R, (n_steps * R if use_dd else n_steps + R) + 1)
        for i, ((seq, toks_list, pos0, _), kind) in enumerate(zip(rows, kinds)):
            if not cont[i]:
                continue
            lanes["cont_active"][i] = True
            lanes["base_pos"][i] = pos0 + (len(toks_list) if kind == "p" else 1)
            d = drafts[i]
            if d:
                lanes["draft"][i, : len(d)] = d
                lanes["draft_len"][i] = len(d)
            self._arm_stop_inputs(
                seq, i, lanes["watch"], lanes["budgets"], lanes["min_left"]
            )
        ring = use_dd and self._pack_rings(rows, device, lanes, S, R)
        launch = self._fused_launch(b, S, n_steps, lanes, drafted=use_dd)
        outs = self._launch(launch, self._feed(launch, bool((b.feed_idx >= 0).any()), ring))
        self.exec_stats["megastep_dispatches"] += 1
        if any(k != "d" for k in kinds):
            self.exec_stats["fused_mixed_dispatches"] += 1
        self.exec_stats["forwards"] += n_steps
        self._count_mixed(b)
        return _PendingFetch(self, outs, aux=use_dd)

    def _pack_rings(
        self, rows: list[tuple[Sequence, list[int], int, int]], device: list[bool],
        lanes: dict[str, np.ndarray], S: int, R: int,
    ) -> bool:
        """Pack the history ring of every lane of ``device`` into
        ``lanes``: exactly the tail :meth:`_draft_for` hands the host
        drafter (the last ``window + ngram_max`` tokens of prompt +
        out_tokens, newest at the right), except that the in-flight step's
        emission (:meth:`_feed_series`) is left to the device to gather
        into the newest slots. The ring is packed from committed host
        history every plan, so a host-side truncation (a stop string, a
        budget clamp) rolls it back for free. Returns whether any ring
        gathers on the device."""
        H = self._ring_H
        ring = self._ring_lanes(S)
        for i, (seq, _, _, _) in enumerate(rows):
            if not device[i]:
                continue
            sc = seq.spec
            ring["dd"][i] = True
            ring["win"][i], ring["nmin"][i], ring["nmax"][i] = sc.window, sc.ngram_min, sc.ngram_max
            ring["kmax"][i] = min(sc.k, R - 1)
            take = 0
            series = self._feed_series(seq)
            if series is not None:
                start, stride, cnt = series
                take = min(cnt, H)
                ring["ring_feed"][i] = (start + (cnt - take) * stride, stride, take)
            need = H - take
            if need <= 0:
                ctx: list[int] = []
            elif len(seq.out_tokens) >= need:
                ctx = seq.out_tokens[-need:]
            else:
                keep = need - len(seq.out_tokens)
                ctx = seq.prompt[max(0, len(seq.prompt) - keep):] + seq.out_tokens
            if ctx:
                ring["hist"][i, H - take - len(ctx) : H - take] = ctx
            ring["hist_len"][i] = min(len(ctx) + take, H)
        lanes.update(ring)
        return bool(ring["ring_feed"][:, 2].any())

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
        # The rebuilt prompt absorbs every emitted token; keeping them
        # would count them twice in the drafter's history.
        seq.out_tokens = []
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
            args = (
                self.params, self.cache,
                x["tokens"], x["block_tables"], x["positions"], x["active"],
                x["seeds"], x["counters"], x["temperature"], x["top_k"], x["top_p"],
                x["watch"], x["budgets"], x["min_left"],
            )
            kw = dict(n_steps=n_steps, need_mask=need_mask, all_greedy=all_greedy,
                      want_logprobs=want_lp, cfg=self.cfg, engine=self.engine)
            if self.pp_mesh is not None:
                toks, lps = _pp_decode_chain(*args, **kw, pp_mesh=self.pp_mesh)
            else:
                toks, lps = _megastep_body(*args, **kw, mesh=self.mesh)
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
        if self.pp_mesh is not None:
            self.exec_stats["pp_fused_dispatches" if n_steps > 1 else "pp_forced_single"] += 1
        self.exec_stats["forwards"] += n_steps * self._pp
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
        with self._step_lock, self._on_stream():
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
        A step whose advance depends on the data (live drafts) commits
        before the next plan. Block pressure mid-plan drains the pipeline
        and re-plans settled; so does a dispatch whose graph is not
        captured yet."""
        outputs: list[tuple[Sequence, LLMEngineOutput]] = []
        self.iterations += 1  # one per step() call, even when a drain re-plans
        if self._inflight is not None and not self._inflight.deterministic:
            # Its advance depends on what it sampled: commit it first.
            outputs.extend(self._commit_inflight())
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
        self._sweep_expired_holds()
        for seq in [s for s in self.running if s.cancelled]:
            self.running.remove(seq)
            self._release_blocks(seq)
        self._admit()
        t_plan = time.time()
        if self.engine.scheduling == "chunked":
            prefills = [s for s in self.running if not self._eff_prefill_done(s)]
            plan = None
            if prefills and self.engine.megastep > 1 and self.pp_mesh is None:
                # The universal megastep: prefill chunks and decode rows
                # fuse with decode continuations in one dispatch; None
                # falls back to the single-step path, which is exact. A
                # pipeline runs mixed steps single, as in JAX.
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
        any decode. On an sp engine a long prompt may take the ring path
        instead, synchronously (sp engines keep the synchronous loop)."""
        prefills = [s for s in self.running if not self._eff_prefill_done(s)]
        if prefills:
            t_wave = time.time()
            ring_out = self._maybe_ring_prefill(prefills)
            if ring_out is not None:
                self._tracer.record(
                    "engine_prefill_step", t_wave, time.time(),
                    attrs={"seqs": len(prefills), "ring": True}, stat=True,
                )
                return _PlannedStep(core=self, commit_fn=lambda: ring_out, kind="prefill")
            return self._plan_prefill_wave(prefills)
        return self._plan_decode()

    def _maybe_ring_prefill(self, prefills: list[Sequence]):
        """Run one eligible long prompt through the sequence-parallel ring
        path (each sp rank computes its chunk; the paged cache is written
        in the same pass, so decode goes on on the paged path). Returns
        the emitted (seq, output) pairs, or None to fall through to the
        ragged wave. A prompt stays on the paged waves when a prefix of it
        is cached or already prefilled, when it carries multimodal rows,
        when it is shorter than the threshold, longer than the largest
        bucket, or when its bucket does not split over the sp ranks."""
        if self.sp_mesh is None or self.engine.ring_prefill_threshold <= 0:
            return None
        for seq in prefills:
            if seq.prefilled or seq.committed_blocks:
                continue  # cached prefix / mid-flight: the paged waves own it
            if seq.mm_embeds is not None:
                continue  # the multimodal splice is a paged-wave variant only
            if seq.prompt_len < self.engine.ring_prefill_threshold:
                continue
            try:
                T = self._bucket_for(seq.prompt_len)
            except ValueError:
                continue  # longer than the largest bucket: chunked waves
            if T % self.sp_mesh.sp:
                continue
            return self._run_ring_prefill(seq, T)
        return None

    def _run_ring_prefill(self, seq: Sequence, T: int) -> list[tuple[Sequence, LLMEngineOutput]]:
        """The ring prefill of ``seq`` in bucket ``T`` and its first token,
        committed at once. It runs eagerly on the card too: it calls the
        ring's collectives, which no graph holds over gloo."""
        t0 = time.time()
        self._mark_first_sched(seq, t0)
        bs = self.engine.block_size
        P_len = seq.prompt_len
        tokens = np.zeros(T, np.int32)
        tokens[:P_len] = seq.prompt
        pos = np.arange(T, dtype=np.int32)
        write_pages = np.full(T, self.engine.garbage_block, np.int32)
        write_pages[:P_len] = np.asarray(seq.block_ids, np.int32)[pos[:P_len] // bs]
        want_lp = seq.logprobs is not None
        all_greedy = seq.sampling.temperature == 0.0
        need_mask = seq.sampling.top_k > 0 or seq.sampling.top_p < 1.0
        dev = lambda a: self._to_device(torch.from_numpy(np.asarray(a)))  # noqa: E731
        toks, lps = _ring_prefill_and_sample(
            self.params, self.cache, dev(tokens), dev(write_pages), dev(pos % bs), P_len - 1,
            dev(np.asarray([seq.seed], np.int32)), dev(np.asarray([seq.generated], np.int32)),
            dev(np.asarray([seq.sampling.temperature], np.float32)),
            dev(np.asarray([seq.sampling.top_k], np.int32)),
            dev(np.asarray([seq.sampling.top_p], np.float32)),
            need_mask=need_mask and not all_greedy, all_greedy=all_greedy,
            want_logprobs=want_lp, cfg=self.cfg, sp_mesh=self.sp_mesh,
        )
        pend = _PendingFetch(self, (toks, *(lps or ())))
        self.exec_stats["single_step_dispatches"] += 1
        self.exec_stats["forwards"] += 1
        if self.device.type == "cuda":
            self.exec_stats["eager_dispatches"] += 1
        self._ring_prefills += 1
        if self._ring_prefills == 1:
            log.info("ring prefill active: %d-token prompt over sp=%d", P_len, self.sp_mesh.sp)
        got, lps = pend.land()
        self.exec_stats["prefill_s"] += time.time() - t0
        self.exec_stats["prefill_tokens"] += P_len
        tok = int(got[0])
        completed = seq.hashed.extend(seq.prompt)
        self._commit_completed(seq, completed)
        seq.prefilled = seq.processed = P_len
        lp = None
        if want_lp and lps is not None:
            lp = _lp_entry(tok, lps[0][0], lps[1][0], lps[2][0], seq.logprobs)
        return [(seq, self._emit_first(seq, tok, lp))]

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
        """Plan one decode iteration. With megastep k > 1 a batch with
        speculating lanes fuses whole (:meth:`_plan_fused`): verify rows
        resolve accept/reject on the device next to plain decode lanes in
        one dispatch. Otherwise (k = 1, or where fusion does not apply)
        speculating lanes go to one single-step verify dispatch
        (:meth:`_plan_verify`) and the rest to one decode megastep, both in
        one planned step whose commits run in order.

        ALL block growth happens before ANY dispatch: every lane's k
        tokens of headroom are reserved here, so pressure surfaces
        (preemption, or _NeedDrain under async) while nothing is enqueued,
        and a megastep never exhausts blocks mid-dispatch."""
        decoding = self._decode_candidates()
        if not decoding:
            return None
        spec_lanes = [s for s in decoding if s.spec is not None]
        if spec_lanes and self.engine.megastep > 1:
            plan = self._plan_fused([], decoding=decoding)
            if plan is not None:
                return plan
        chain_lanes = [s for s in decoding if s.spec is None]
        chain_ready: list[Sequence] = []
        n_steps = 0
        if chain_lanes:
            n_steps = self._chain_length(chain_lanes)
            chain_ready = self._grow_or_preempt(chain_lanes, n_steps)
        parts: list[_PlannedStep] = []
        if spec_lanes:
            # The verify rows' growth (and any preemption it causes) also
            # precedes their dispatch, inside _plan_verify.
            vplan = self._plan_verify([s for s in spec_lanes if s in self.running])
            if vplan is not None:
                parts.append(vplan)
        # A verify preemption may have evicted a chain lane.
        chain_ready = [s for s in chain_ready if s in self.running]
        if chain_ready:
            parts.append(self._plan_megastep(chain_ready, n_steps))
        return self._merge_plans(parts)

    def _merge_plans(self, parts: list[_PlannedStep]) -> _PlannedStep | None:
        """One planned step of several dispatches, committed in order. It
        never feeds the next plan (a feed gathers from ONE device output),
        so it is deterministic only where no part carries drafts or
        feeds: a batch of speculating and plain lanes runs unpipelined."""
        if not parts:
            return None
        if len(parts) == 1:
            return parts[0]

        def commit() -> list[tuple[Sequence, LLMEngineOutput]]:
            out: list[tuple[Sequence, LLMEngineOutput]] = []
            for p in parts:
                p.committed = True  # bypass the per-part wrapper
                out.extend(p.commit_fn())
            return out

        adv: dict[str, tuple[int, int, int]] = {}
        for p in parts:
            adv.update(p.adv)
        return _PlannedStep(
            core=self, commit_fn=commit, adv=adv,
            deterministic=all(p.deterministic and not p.feed_index for p in parts),
            kind="spec",
        )

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
                        "tokens": emitted_total, "pp_stages": self._pp,
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

    # -- speculative decoding (drafts and verify rows) ----------------------

    def _draft_context(self, seq: Sequence, need: int) -> list[int]:
        """The last ``need`` tokens of prompt + out_tokens: all the
        drafter can match (out_tokens ends with the pending token)."""
        if need <= 0:
            return []
        if len(seq.out_tokens) >= need:
            return seq.out_tokens[-need:]
        keep = need - len(seq.out_tokens)
        return seq.prompt[max(0, len(seq.prompt) - keep):] + seq.out_tokens

    def _draft_for(self, seq: Sequence, max_extra: int, reserve: int = 0) -> list[int]:
        """Draft continuation tokens for one speculating lane, capped by
        the caller's token headroom, the context edge and the remaining
        generation budget (a draft past ``max_tokens`` would be cut by the
        stop scan). ``reserve`` keeps context room for a fused megastep's
        ``n_steps - 1`` later writes. Under async execution the host
        history lags by the in-flight tokens, which changes which tokens
        are drafted, never which are emitted."""
        sc = seq.spec
        d_cap = min(
            sc.k, max_extra,
            self.engine.max_model_len - self._eff_processed(seq) - 1 - reserve,
        )
        if seq.stop.max_tokens is not None:
            d_cap = min(d_cap, seq.stop.max_tokens - self._eff_generated(seq) - 1)
        if d_cap <= 0:
            return []
        context = self._draft_context(seq, sc.window + sc.ngram_max)
        return propose_ngram(context, d_cap, sc.ngram_min, sc.ngram_max, sc.window)

    def _spec_rows(
        self, ready: list[Sequence], budget: int, spec_budget: int, t0: float,
        n_steps: int = 1, dd_room: int = 0,
    ):
        """The decode and verify rows of a step over ``ready``: each lane's
        pending token (or its device feed under async execution) at its
        cursor, plus, for a speculating lane, its host draft. Every draft
        cap pre-charges the base token of each lane still to come, so the
        rows stay within ``spec_budget`` however many lanes speculate; a
        lane whose base token does not fit ``budget`` waits a step. A
        draft whose blocks (``n_steps`` + its length) are not reservable
        is dropped: the row verifies nothing. With ``dd_room`` (a
        drafting megastep), a lane that may draft on the device and whose
        blocks and context hold ``dd_room`` tokens drafts there instead.
        Files a ``spec_draft`` span when anything was drafted. Returns
        (rows, kinds "v"/"d", drafts, feed_rows, device, total tokens,
        the time drafting ended)."""
        rows: list[tuple[Sequence, list[int], int, int]] = []
        kinds: list[str] = []
        drafts: list[list[int]] = []
        feed_rows: list[int | None] = []
        device: list[bool] = []
        total = 0
        for idx, seq in enumerate(ready):
            if total + 1 > budget:
                break  # over-budget lanes wait one step
            draft: list[int] = []
            dev = False
            if seq.spec is not None:
                if (
                    dd_room
                    and self._spec_device
                    and seq.spec.device
                    and self.engine.max_model_len - self._eff_processed(seq) >= dd_room
                    and self._grow_blocks(seq, dd_room)
                ):
                    dev = True  # drafts on the device; no host proposal
                else:
                    lanes_after = len(ready) - idx - 1
                    draft = self._draft_for(
                        seq, spec_budget - total - 1 - lanes_after, reserve=n_steps - 1
                    )
                    if draft and not self._grow_blocks(seq, n_steps + len(draft)):
                        draft = []  # block pressure: the row degrades to q_len 1
            cursor = self._eff_processed(seq)
            src = self._feed_src(seq)
            toks = [0 if src is not None else seq.pending] + draft
            rows.append((seq, toks, cursor, cursor + len(toks)))
            kinds.append("v" if seq.spec is not None and not dev else "d")
            drafts.append(draft)
            feed_rows.append(src)
            device.append(dev)
            total += len(toks)
        t_drafted = time.time()
        n_drafted = sum(1 for d in drafts if d)
        if n_drafted:
            self._tracer.record(
                "spec_draft", t0, t_drafted,
                attrs={"seqs": n_drafted, "drafted": sum(len(d) for d in drafts)},
                stat=True,
            )
        return rows, kinds, drafts, feed_rows, device, total, t_drafted

    def _apply_verify_row(
        self, seq: Sequence, draft: list[int], row_toks, lps, i: int,
    ) -> tuple[LLMEngineOutput, int, int]:
        """The host side of one single-step verify row: accept the longest
        drafted prefix the target agrees with and emit accepted + 1 tokens
        (the last the target's own correction or bonus choice). Rejected
        drafts' K/V sits past the cursor, never attended and rewritten by
        the next step: the rollback is the cursor. Returns (output chunk,
        drafted, accepted)."""
        d = len(draft)
        a = 0
        while a < d and int(row_toks[a]) == draft[a]:
            a += 1
        if d:
            # A row that drafted nothing is a plain decode row for the stats.
            self.spec_stats.observe_row(d, a)
        out = self._commit_emission(seq, row_toks[: a + 1], lps, lambda j: (i, j))
        return out, d, a

    def _record_spec_verify(self, t0: float, t1: float, seqs: int, drafted: int,
                            accepted: int, tokens: int) -> None:
        self.spec_stats.verify_steps += 1
        self._tracer.record(
            "spec_verify", t0, t1,
            attrs={"seqs": seqs, "drafted": drafted, "accepted": accepted, "tokens": tokens},
            stat=True,
        )

    def _plan_verify(self, seqs: list[Sequence]) -> _PlannedStep | None:
        """Plan one single-step verify dispatch over speculating decode
        lanes: every row is pending + up to k drafted tokens in the ragged
        forward, so k + 1 target positions ride one forward; drafted
        tokens count against the token budget. Under async execution a
        row's first slot gathers the pending token on the device; a step
        carrying live drafts advances by data the host has not seen, so it
        is not deterministic and commits before the next plan."""
        t0 = time.time()
        ready = self._grow_or_preempt(seqs, 1)[: self.engine.decode_buckets[-1]]
        if not ready:
            return None
        budget = self.engine.token_budget
        rows, _, drafts, feed_rows, _, _, t_draft = self._spec_rows(ready, budget, budget, t0)
        if not rows:
            return None
        n_draft_rows = sum(1 for d in drafts if d)
        pend = self._dispatch_ragged(
            rows, self._decode_width(len(rows)),
            n_sample=[len(tl) for _, tl, _, _ in rows], feed_rows=feed_rows,
        )
        # No live drafts: every row advances one token at sample width 1,
        # so the step pipelines like a decode step.
        deterministic = n_draft_rows == 0
        adv = {seq.request_id: (0, 1, 1) for seq, _, _, _ in rows}
        feed_index = (
            {seq.request_id: i for i, (seq, _, _, _) in enumerate(rows)} if deterministic else {}
        )
        feed_series = {rid: (i, 0, 1) for rid, i in feed_index.items()}

        def commit() -> list[tuple[Sequence, LLMEngineOutput]]:
            outputs: list[tuple[Sequence, LLMEngineOutput]] = []
            toks, lps = pend.land()  # [S, R]
            drafted = accepted = emitted = 0
            live = {id(s) for s in self.running}
            for i, ((seq, _, _, _), draft) in enumerate(zip(rows, drafts)):
                if seq.finish is not None or seq.cancelled or id(seq) not in live:
                    continue  # late finish/preempt: discard the row
                out, d, a = self._apply_verify_row(seq, draft, toks[i], lps, i)
                outputs.append((seq, out))
                drafted += d
                accepted += a
                emitted += len(out.token_ids)
            if n_draft_rows:
                # A step carried a verify row only when something was drafted.
                self._record_spec_verify(t_draft, time.time(), n_draft_rows, drafted,
                                         accepted, emitted)
            return outputs

        return _PlannedStep(
            core=self, commit_fn=commit, adv=adv,
            feed_tokens=pend.toks, feed_index=feed_index, feed_series=feed_series,
            deterministic=deterministic, kind="spec",
        )

    # -- chunked scheduling --------------------------------------------------

    def _rotate_decode_lanes(self, decoding: list[Sequence], cap: int) -> list[Sequence]:
        """At most ``cap`` decode lanes for a mixed step; which ones sit
        out rotates with the iteration, so no stream stalls repeatedly."""
        if len(decoding) <= cap:
            return decoding
        off = self.iterations % len(decoding)
        return (decoding + decoding)[off : off + cap]

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
        q_len=1 row, or a verify row with its draft, NEXT TO prefill chunks
        in one ragged forward under the ``max_num_batched_tokens`` budget,
        at the decode width of its row count. Drafts keep one block of the
        budget in reserve, so speculation never starves admission. A long
        prompt streams through ceil(P / chunk) steps while in-flight
        decodes keep emitting. Under async execution decode rows gather
        their pending token from the in-flight step's device output and
        chunk cursors read through the optimistic overlay, so mixed steps
        pipeline like decode steps (live drafts make a step commit before
        the next plan)."""
        t_step = time.time()
        budget, bs = self.engine.token_budget, self.engine.block_size
        S_max = self.engine.decode_buckets[-1]
        # Keep one row and budget headroom for a prefill chunk, so a full
        # decode batch can never starve admission.
        decoding = self._rotate_decode_lanes(
            self._decode_candidates(), min(S_max - 1, budget - 1)
        )
        # Block growth first (a preemption re-queues its victim, possibly
        # a mid-prefill one, which keeps its full prompt; see _preempt).
        ready = self._grow_or_preempt(decoding, 1)
        rows, kinds, drafts, feed_rows, _, total, t_drafted = self._spec_rows(
            ready, budget, budget - bs, t_step
        )
        n_decode, decode_row_tokens = len(rows), total
        n_spec_rows = sum(1 for d in drafts if d)
        for seq, p0, chunk in self._take_chunks(prefills, n_decode, total, t_step):
            rows.append((seq, seq.prompt[p0 : p0 + chunk], p0, p0 + chunk))
            kinds.append("p")
            drafts.append([])
            feed_rows.append(None)
            total += chunk
        if not rows:
            return None
        # Only verify rows sample more than their last position.
        pend = self._dispatch_ragged(
            rows, self._decode_width(len(rows)),
            n_sample=[len(tl) if kind == "v" else 1 for (_, tl, _, _), kind in zip(rows, kinds)],
            feed_rows=feed_rows,
        )
        deterministic = n_spec_rows == 0
        adv: dict[str, tuple[int, int, int]] = {}
        feed_index: dict[str, int] = {}
        feed_series: dict[str, tuple[int, int, int]] = {}
        for i, ((seq, toks_list, p0, _), kind) in enumerate(zip(rows, kinds)):
            chunk = len(toks_list)
            done = kind != "p" or p0 + chunk >= seq.prompt_len
            adv[seq.request_id] = (0, 1, 1) if kind != "p" else (chunk, chunk, int(done))
            if done and deterministic:  # sample width 1: column 0
                feed_index[seq.request_id] = i
                feed_series[seq.request_id] = (i, 0, 1)

        def commit() -> list[tuple[Sequence, LLMEngineOutput]]:
            outputs: list[tuple[Sequence, LLMEngineOutput]] = []
            toks2, lps2 = pend.land()  # [S, R]
            # Column 0 is each decode row's and chunk's one sample.
            toks = toks2[:, 0]
            lps = None if lps2 is None else tuple(a[:, 0] for a in lps2)
            now = time.time()
            drafted = accepted = spec_emitted = 0
            live = {id(s) for s in self.running}
            for i, ((seq, toks_list, _, _), kind) in enumerate(zip(rows, kinds)):
                if seq.finish is not None or seq.cancelled or id(seq) not in live:
                    continue  # late finish/preempt: discard the row
                if kind == "v":
                    out, d, a = self._apply_verify_row(seq, drafts[i], toks2[i], lps2, i)
                    outputs.append((seq, out))
                    if d:
                        drafted += d
                        accepted += a
                        spec_emitted += len(out.token_ids)
                    continue
                if kind == "d":
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
            if n_spec_rows:
                self._record_spec_verify(t_drafted, now, n_spec_rows, drafted, accepted,
                                         spec_emitted)
            self._note_mixed_step(total)
            self._tracer.record(
                "engine_mixed_step", t_step, now,
                attrs={
                    "seqs": len(rows), "decode_rows": n_decode,
                    "prefill_tokens": total - decode_row_tokens, "budget": budget,
                },
                stat=True,
            )
            return outputs

        return _PlannedStep(
            core=self, commit_fn=commit, adv=adv,
            feed_tokens=pend.toks, feed_index=feed_index,
            feed_series=feed_series, deterministic=deterministic, kind="mixed",
        )

    def _plan_fused(
        self, prefills: list[Sequence], decoding: list[Sequence] | None = None,
    ) -> _PlannedStep | None:
        """Plan one UNIVERSAL megastep: a mixed step's rows (decode rows,
        verify rows and prefill chunks) ride the first iteration of
        :func:`_megastep_fused_body`, and every lane that can go on runs
        ``n_steps - 1`` decode iterations in the same dispatch: verify
        rows resolve accept/reject on the device and go on from the
        correction token (a rejected draft rolls back inside the
        dispatch), and a chunk that completes its prompt continues as a
        decode row. A lane that drafts on the device makes it the drafting
        megastep (:func:`_megastep_draft_body`). ``decoding`` given (with
        no prefills) is a decode step whose batch speculates. Returns None
        where fusion cannot apply (a stop watch too wide for the device, a
        budget or context edge at k = 1, a plain decode batch, nothing
        that would continue, or a pure prefill step whose chunks all stay
        mid-prompt): the caller falls back to the single-step paths, which
        are exact.

        ALL block growth happens before the dispatch (the
        :meth:`_plan_decode` contract): n_steps tokens per decode lane,
        n_steps + draft per verify lane, ``1 + (n_steps - 1) * R`` per
        device-drafting lane and chunk + n_steps - 1 per completing chunk
        are reserved here, so pressure surfaces as preemption (or
        _NeedDrain under async) while nothing is enqueued. A draft whose
        blocks are not reservable degrades its row to q_len 1, a device
        lane to a host-drafted verify row, a completing chunk to the
        single-step bookkeeping."""
        t_step = time.time()
        budget, chunk_cap = self.engine.token_budget, self.engine.chunk_size
        bs, S_max = self.engine.block_size, self.engine.decode_buckets[-1]
        if decoding is None:
            decoding = self._decode_candidates()
        prefills = [s for s in prefills if s in self.running]
        if not decoding and not prefills:
            return None
        if not prefills and not any(s.spec is not None for s in decoding):
            return None  # plain decode: the decode megastep is the cheaper graph
        if not decoding:
            # A pure prefill step: fusing pays only when a chunk can
            # COMPLETE its prompt this step and go on decoding on the device.
            room = min(budget, chunk_cap)
            if not any(s.prompt_len - (s.prefilled + self._adv3(s)[0]) <= room for s in prefills):
                return None
        n_steps = self._chain_length(decoding or prefills)
        if n_steps <= 1:
            return None
        # One row and budget headroom stay free for a prefill chunk when
        # there are prefills; without, the budget still bounds base tokens.
        cap = min(S_max - 1, budget - 1) if prefills else min(S_max, budget)
        decoding = self._rotate_decode_lanes(decoding, cap)
        ready = self._grow_or_preempt(decoding, n_steps)
        # Drafts keep one block of the budget for prefill admission, where
        # there is a prefill to admit.
        rows, kinds, drafts, feed_rows, device, total, t_drafted = self._spec_rows(
            ready, budget, budget - bs if prefills else budget, t_step,
            n_steps=n_steps, dd_room=1 + (n_steps - 1) * self._spec_R,
        )
        cont = [True] * len(rows)
        n_decode, decode_row_tokens = len(rows), total
        n_spec_rows = sum(1 for d in drafts if d)
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
            drafts.append([])
            feed_rows.append(None)
            device.append(False)
            total += chunk
        if not rows or not any(cont):
            return None  # nothing continues on the device: the single step is exact
        n_chunk = len(rows) - n_decode
        n_sample = [len(tl) if kind == "v" else 1 for (_, tl, _, _), kind in zip(rows, kinds)]
        S = self._decode_width(len(rows))
        use_dd = any(device)
        pend = self._dispatch_fused(
            rows, S, n_sample, feed_rows, kinds, drafts, cont, n_steps, device=device,
        )
        R = self._spec_R if use_dd or any(n > 1 for n in n_sample) else 1
        deterministic = n_spec_rows == 0 and not use_dd
        adv: dict[str, tuple[int, int, int]] = {}
        feed_index: dict[str, int] = {}
        feed_series: dict[str, tuple[int, int, int]] = {}
        last_flat = (n_steps - 1) * S * R
        for i, ((seq, toks_list, p0, _), kind) in enumerate(zip(rows, kinds)):
            chunk = len(toks_list)
            if kind != "p" and (drafts[i] or device[i]):
                # An advance that depends on the data: the step commits
                # before the next plan, so the overlay needs only what
                # iteration 0 surely emits.
                adv[seq.request_id] = (0, 1, 1)
                continue
            if kind != "p":
                adv[seq.request_id] = (0, n_steps, n_steps)
            elif cont[i]:
                adv[seq.request_id] = (chunk, chunk + n_steps - 1, n_steps)
            else:
                done = p0 + chunk >= seq.prompt_len
                adv[seq.request_id] = (chunk, chunk, int(done))
                if done and deterministic:  # its one token is iteration 0's
                    feed_index[seq.request_id] = i * R
                    feed_series[seq.request_id] = (i * R, 0, 1)
                continue
            if deterministic:
                # A continuing lane's newest token is the last iteration's.
                feed_index[seq.request_id] = last_flat + i * R
                feed_series[seq.request_id] = (i * R, S * R, n_steps)

        def commit() -> list[tuple[Sequence, LLMEngineOutput]]:
            outputs: list[tuple[Sequence, LLMEngineOutput]] = []
            toks3, lps3 = pend.land()  # [n_steps, S, R]
            # Each round's emitted count, draft length and accepted count.
            aux3 = pend.land_aux() if use_dd else None
            toks0 = toks3[0, :, 0]
            lps0 = None if lps3 is None else tuple(a[0, :, 0] for a in lps3)
            now = time.time()
            emitted_total = drafted = accepted = spec_emitted = 0
            dd_rounds = dd_hits = 0
            live = {id(s) for s in self.running}
            for i, ((seq, toks_list, _, _), kind) in enumerate(zip(rows, kinds)):
                if seq.finish is not None or seq.cancelled or id(seq) not in live:
                    continue  # late finish/preempt: discard the lane
                if kind == "p":
                    tok, lp = self._advance_prefill_chunk(
                        seq, len(toks_list), toks0, lps0, i, t_step, now
                    )
                    if tok is None:
                        continue  # mid-prompt: masked no-ops ran on the device
                    if cont[i]:
                        # Continued on the device: the chain wrote its first
                        # n_steps - 1 tokens past the completed prompt.
                        out = self._commit_emission(
                            seq, toks3[:, i, 0], lps3, lambda j, i=i: (j, i, 0), from_prompt=True
                        )
                    else:
                        out = self._emit_first(seq, tok, lp)
                elif device[i]:
                    # Drafted on the device: the per-round emitted counts
                    # say which [round, slot] cells carry tokens; the stop
                    # scan truncates as everywhere (the device only
                    # under-stops, so E covers the stop).
                    E: list[int] = []
                    at: list[tuple[int, int, int]] = []
                    for r, (e_r, d_r, a_r) in enumerate(aux3[:, :, i].T.tolist()):
                        E += [int(t) for t in toks3[r, i, :e_r]]
                        at += [(r, i, j) for j in range(e_r)]
                        if r:
                            dd_rounds += e_r > 0
                            if d_r:
                                dd_hits += 1
                                self.spec_stats.observe_row(d_r, a_r)
                                drafted += d_r
                                accepted += a_r
                    out = self._commit_emission(seq, E, lps3, at.__getitem__)
                    spec_emitted += len(out.token_ids)
                else:
                    # Decode and verify rows: replay the device's accept
                    # (the longest drafted prefix matching the target's own
                    # choices), then the continuation.
                    draft = drafts[i]
                    d, a = len(draft), 0
                    while a < d and int(toks3[0, i, a]) == draft[a]:
                        a += 1
                    if d:
                        self.spec_stats.observe_row(d, a)
                    E = [int(t) for t in toks3[0, i, : a + 1]] + [int(t) for t in toks3[1:, i, 0]]
                    out = self._commit_emission(
                        seq, E, lps3, lambda j, i=i, a=a: (0, i, j) if j <= a else (j - a, i, 0)
                    )
                    if d:
                        drafted += d
                        accepted += a
                        spec_emitted += len(out.token_ids)
                outputs.append((seq, out))
                emitted_total += len(out.token_ids)
            t_done = time.time()
            if n_spec_rows or use_dd:
                self.spec_stats.device_rounds += dd_rounds
                self.spec_stats.device_hits += dd_hits
                self._record_spec_verify(t_drafted, t_done, n_spec_rows + sum(device),
                                         drafted, accepted, spec_emitted)
            if n_chunk:
                self._note_mixed_step(total)
                self._tracer.record(
                    "engine_mixed_step", t_step, t_done,
                    attrs={
                        "seqs": len(rows), "decode_rows": n_decode,
                        "prefill_tokens": total - decode_row_tokens, "budget": budget,
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
                    "tokens": emitted_total, "draft_rounds": dd_rounds,
                    "fused_shapes": {
                        "decode": kinds.count("d") - sum(device), "chunk": n_chunk,
                        "verify": kinds.count("v"), "device": sum(device),
                    },
                },
                stat=True,
            )
            return outputs

        return _PlannedStep(
            core=self, commit_fn=commit, adv=adv,
            feed_tokens=pend.toks, feed_index=feed_index, feed_series=feed_series,
            deterministic=deterministic, kind="mixed" if prefills else "spec",
        )

    def _commit_emission(
        self, seq: Sequence, E, lps=None, at: Callable | None = None,
        from_prompt: bool = False,
    ) -> LLMEngineOutput:
        """Commit one lane's candidate emission ``E`` (its tokens from one
        dispatch, in stream order): the stop scan cuts it, the K/V
        bookkeeping covers what the dispatch wrote (the old pending token
        and every emitted token but the last; a lane whose prompt
        completed in the same dispatch, ``from_prompt``, had its prompt
        committed already and wrote no pending token), and one chunk
        streams. ``at(j)`` indexes token j's record in the logprob arrays
        ``lps``."""
        E = np.asarray(E)
        k, finish = self._scan_stop(seq, E)
        emitted = [int(t) for t in E[:k]]
        written = emitted[: k - 1] if from_prompt else [seq.pending] + emitted[: k - 1]
        self._commit_completed(seq, seq.hashed.extend(written))
        seq.processed += len(written)
        seq.generated += k
        lp_entries = None
        if lps is not None and seq.logprobs is not None:
            lp_entries = [
                _lp_entry(emitted[j], *(a[at(j)] for a in lps), seq.logprobs)
                for j in range(k)
            ]
        out = self._emit_chunk(seq, emitted, lp_entries, finish)
        if finish is not None:
            seq.finish = finish
            self._finish(seq)
        else:
            seq.pending = emitted[-1]
        return out

    def _commit_chain(
        self, seq: Sequence, chained: np.ndarray, lps, i: int, from_prompt: bool = False,
    ) -> LLMEngineOutput:
        """Commit lane ``i`` of a chain's ``[n, B]`` sampled tokens (and
        logprob arrays of the same leading shape)."""
        return self._commit_emission(seq, chained[:, i], lps, lambda j: (j, i), from_prompt)

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
        seq.out_tokens.extend(tokens)
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
            if seq.hold_blocks:
                out.kv_transfer_params = self._held_params(seq)
        return out

    def _emit(self, seq: Sequence, token: int, lp: dict | None = None) -> LLMEngineOutput:
        """Emit the newest sampled token (``seq.generated`` counts it)."""
        seq.out_tokens.append(token)
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
            if seq.hold_blocks:
                out.kv_transfer_params = self._held_params(seq)
        return out

    def _held_params(self, seq: Sequence) -> dict:
        """The kv_transfer_params a remote-decode prefill finishes with."""
        return {
            "request_id": seq.request_id,
            "block_hashes": list(seq.pinned_hashes[: seq.committed_blocks]),
            "block_size": self.engine.block_size,
        }

    def _finish(self, seq: Sequence) -> None:
        if seq in self.running:
            self.running.remove(seq)
        if not seq.hold_blocks:
            self._release_blocks(seq)
            return
        self._held[seq.request_id] = seq
        if self.engine.held_block_ttl_s > 0:
            self._held_deadline[seq.request_id] = (
                time.monotonic() + self.engine.held_block_ttl_s
            )
        if self.on_chunk_commit is not None:
            # Final cursor: only the tail (if anything) remains for a
            # streaming puller.
            self.on_chunk_commit(seq.request_id, seq.committed_blocks, True)

    def _sweep_expired_holds(self) -> None:
        """Release held prefills whose decode side never came (timeout,
        crash): abandoned holds would otherwise pin blocks until the
        allocator starves."""
        if self.expire_holds:
            for rid in self._expired_holds():
                self._expire_hold(rid)

    def _expired_holds(self) -> list[str]:
        """The held requests whose deadline has passed."""
        now = time.monotonic()
        return [r for r, d in self._held_deadline.items() if d < now]

    def _expire_hold(self, rid: str) -> None:
        self._held_deadline.pop(rid, None)
        seq = self._held.pop(rid, None)
        if seq is not None:
            log.warning(
                "releasing expired held blocks for %s (ttl %.0fs)",
                rid, self.engine.held_block_ttl_s,
            )
            self._release_blocks(seq)

    def clear_kv_cache(self) -> int:
        """Drop every unpinned cached block; returns blocks cleared."""
        with self._step_lock:
            return len(self.allocator.clear_cache())

    # -- embeddings --------------------------------------------------------

    def embed(self, token_ids: list[int]) -> np.ndarray:
        """Mean-pooled final-hidden embedding of one prompt (``[h]`` f32),
        as the JAX engine's ``embed``: one forward
        (``model.embed_forward``) padded to a prefill bucket, on a scratch
        paged cache of its own (built at the first call, reused), so the
        serving cache and the allocator are untouched. The scratch pages
        are in the model dtype whatever ``kv_dtype`` is, as in JAX. The
        forward runs eagerly and takes the step lock: a step's capture
        must not see another thread's work on the card. On a mesh every
        rank calls it: a tp rank runs its heads (all-reduced), a pipeline
        stage its layers (the stages in turn, then the exit broadcast), a
        dp or sp rank the whole model; every rank returns the embedding."""
        self._check_embed(token_ids)
        with self._step_lock, self._on_stream():
            return self._embed_locked(token_ids)

    def _check_embed(self, token_ids: list[int]) -> None:
        if not token_ids:
            raise ValueError("empty input")
        self._bucket_for(len(token_ids))

    def _embed_locked(self, token_ids: list[int]) -> np.ndarray:
        """:meth:`embed`'s forward (the caller holds the step lock, on the
        engine's stream)."""
        T = len(token_ids)
        bucket = self._bucket_for(T)
        bs = self.engine.block_size
        if self._embed_scratch is None:
            n = -(-self.engine.prefill_buckets[-1] // bs) + 1
            shape = (n, bs, 2 * self.local_cfg.num_kv_heads, self.cfg.head_dim)
            self._embed_scratch = tuple(
                torch.zeros(shape, dtype=self.cfg.torch_dtype, device=self.device)
                for _ in range(self.local_cfg.num_layers)
            )
        garbage = self._embed_scratch[0].shape[0] - 1
        tokens = np.zeros(bucket, np.int32)
        tokens[:T] = token_ids
        write_pages = np.full(bucket, garbage, np.int32)
        write_pages[:T] = np.arange(T) // bs
        tables = np.full((1, garbage), garbage, np.int32)
        tables[0, : -(-bucket // bs)] = np.arange(-(-bucket // bs))
        dev = lambda a: self._to_device(torch.from_numpy(a))  # noqa: E731
        pooled = embed_forward(
            self.params, self._embed_scratch, dev(tokens),
            dev(np.arange(bucket) < T), dev(write_pages), dev(tables),
            self.cfg, self.engine, mesh=self.pp_mesh or self.mesh,
        )
        return pooled.cpu().numpy()

    def warm_up(self) -> int:
        """Run every shape the engine serves once before it serves, every
        row writing only the garbage block: under ``waves`` one prefill
        wave per prefill bucket, under ``chunked`` or with speculation one
        mixed step per (token bucket, width, sample width) its planners
        can dispatch, and one decode iteration per decode width, in each
        sampling variant. A shape's first run on the card loads its
        kernels (CUDA loads modules lazily) and settles cuBLAS's choices;
        done here, no request pays for it. On the card it then captures
        the CUDA graph of every key the engine can dispatch
        (:meth:`_warm_up_launches`), so serving captures nothing (a
        request that turns speculation on where the engine's default is
        off captures its keys at first use). Scheduler state, the prefix
        cache and the execution counters are left as they were; the
        kernels' launch counters count the eager launches (captures
        launch nothing). An engine whose collectives go through the host
        (a tp, dp or pp mesh over gloo) captures nothing and runs one eager
        forward per kind of dispatch. Returns the forwards it ran (on a
        pipeline stage, as ``exec_stats["forwards"]`` counts them: one per
        microbatch)."""
        with self._step_lock:
            launches = self._warm_up_launches()
            if self._eager_only:
                # Nothing is captured, and every kernel a kind of dispatch
                # runs loads at its first forward: one eager forward per
                # kind (its smallest shape, the first sampling variant) is
                # the warm-up; each further one would be a round of
                # collectives through the host.
                first: dict[str, Launch] = {}
                for launch, eager in launches:
                    if eager:
                        first.setdefault(launch.key[0], launch)
                launches = [(launch, True) for launch in first.values()]
            forwards = 0
            for launch, eager in launches:
                if eager:
                    launch.body(torch.from_numpy(launch.packed).to(self.device))
                    forwards += self._pp  # a stage's forwards: one per microbatch
            if self.device.type == "cuda" and not self._eager_only:
                for launch, _ in launches:
                    if launch.key not in self._graphs:
                        self._graphs.capture(launch, self.device)
        return forwards

    def _chunked_shapes(self, row_max: int | None = None) -> list[tuple[int, int]]:
        """(token bucket, width) of every ragged step next to decode rows
        that the planners can dispatch. A step holds n rows, 1 <= n <=
        min(widest decode width, max_num_seqs), of at least one token each
        and at most ``row_max`` (by default one chunk: ``chunk_size``, and
        less than ``max_model_len``), in all at most the token budget; a
        width w takes the row counts above the next narrower width, so its
        totals are [n_lo, min(budget, n_hi * row_max)]."""
        eng = self.engine
        row_max = row_max or min(eng.chunk_size, eng.max_model_len - 1)
        n_max = min(eng.decode_buckets[-1], eng.max_num_seqs)
        shapes = []
        for w_prev, w in zip((0, *eng.decode_buckets), eng.decode_buckets):
            n_lo, n_hi = w_prev + 1, min(w, n_max)
            if n_lo > n_hi:
                continue
            t_hi = min(eng.token_budget, n_hi * row_max)
            for b_prev, T in zip((0, *eng.prefill_buckets), eng.prefill_buckets):
                if max(n_lo, b_prev + 1) <= min(t_hi, T):
                    shapes.append((T, w))
        return sorted(shapes)

    def _warm_up_launches(self) -> list[tuple[Launch, bool]]:
        """(launch, run eagerly) for every graph key the engine can
        dispatch, every row on the garbage block: each sampling variant of
        each decode width at every chain length ``_chain_length`` can
        return; under ``waves``, each prefill bucket; under ``chunked``,
        or with speculation on, each (token bucket, width) of
        :meth:`_chunked_shapes` as a mixed step and, with k > 1, as a
        fused megastep at each chain length above 1. Speculation adds the
        verify sample width ``spec_k + 1`` to the mixed steps and fused
        megasteps (whose rows are verify rows of at most that many tokens
        under ``waves``), and device drafting the drafting megastep. A
        prefill bucket above ``max_model_len`` is filled by several rows,
        as a wave of several prompts fills it. The decode launches run
        eagerly at k = 1 only, the fused ones not at all (longer chains
        run the same kernels)."""
        g, bs = self.engine.garbage_block, self.engine.block_size
        S, k_cfg = self.engine.prefill_batch, self.engine.megastep
        L = self.engine.max_model_len
        chains = sorted({k_cfg} | {1 << i for i in range(k_cfg.bit_length())})
        chunked = self.engine.scheduling == "chunked"
        spec, R = self._spec_default is not None, self._spec_R
        # The longest row of a step next to decode rows: a chunk, or a
        # verify row (only those under waves).
        row_max = max(min(self.engine.chunk_size, L - 1) if chunked else 1, R if spec else 1)
        launches: list[tuple[Launch, bool]] = []
        for sampling, logprobs in WARM_UP_VARIANTS:
            seq = Sequence("warm-up", [0] * L, sampling, StopConditions(), seed=0,
                           logprobs=logprobs)
            seq.block_ids = [g] * -(-L // bs)
            for T, width in self._chunked_shapes(row_max) if chunked or spec else ():
                # t tokens in n rows of at most row_max each.
                t = min(T, self.engine.token_budget, min(width, self.engine.max_num_seqs) * row_max)
                n = min(width, self.engine.max_num_seqs, t)
                sizes = [t // n + (i < t % n) for i in range(n)]
                rows = [(seq, [0] * m, 0, m) for m in sizes]
                for r in (1, R) if spec else (1,):
                    batch = self._assemble_ragged(rows, width, feed_rows=[None] * n, force_R=r > 1)
                    launches.append((self._ragged_launch(batch, width, mixed=True), True))
                    lanes = self._fused_lanes(width, r, 1)
                    for k in chains[1:] if self.pp_mesh is None else ():
                        launches.append((self._fused_launch(batch, width, k, lanes), False))
                        if r > 1 and self._spec_device:
                            launches.append((self._fused_launch(
                                batch, width, k, {**lanes, **self._ring_lanes(width)}, drafted=True,
                            ), False))
            if not chunked:
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

    # -- tiered KV offload (G2 host / G3 disk) ------------------------------

    def _on_stream(self):
        """Run the enclosed device work on the engine's stream (from any
        thread: PyTorch's current stream is per thread)."""
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def _to_device(self, t: torch.Tensor) -> torch.Tensor:
        """A host tensor on the engine's device without waiting for the
        stream: a non-blocking copy out of pinned memory."""
        if t.device.type == self.device.type:
            return t
        return (t if t.is_pinned() else t.pin_memory()).to(self.device, non_blocking=True)

    def _index(self, ids: list[int]) -> torch.Tensor:
        return self._to_device(torch.tensor(ids, dtype=torch.long))

    def _offload_block(self, block_id: int, block_hash: int, parent: int | None) -> None:
        """Device eviction hook: enqueue an async demotion of the block's
        page. The slice and its copy to pinned memory are enqueued here,
        on the engine's stream, so they read the page before any later
        dispatch reuses the physical block; the offload worker's thread
        waits for the copy."""
        self.offload.submit(block_hash, parent, self._slice_page(block_id))

    def _slice_page(self, block_id: int):
        """One block's page in the host layout, ``[L, ps, 2kv, d]`` (int8:
        ``{kv, scale}``), on its way to the host (:class:`_Landing`)."""
        with self._on_stream():
            if self.engine.kv_quantized:
                return {
                    k: _Landing(torch.stack([c[k][block_id] for c in self.cache]))
                    for k in ("kv", "scale")
                }
            return _Landing(torch.stack([c[block_id] for c in self.cache]))

    def _gather_pages(self, ids: list[int]):
        """The pages of blocks ``ids`` on the device, layer-major ``[n, L,
        ps, 2kv, d]`` (int8: ``{kv, scale}`` leaves ``[n, L, ...]``), this
        rank's part of them on a mesh."""
        with self._on_stream():
            idx = self._index(ids)
            if self.engine.kv_quantized:
                return {
                    k: torch.stack([c[k].index_select(0, idx) for c in self.cache], dim=1)
                    for k in ("kv", "scale")
                }
            return torch.stack([c.index_select(0, idx) for c in self.cache], dim=1)

    def _collect_pages(self, pages):
        """Start landing a batch of this rank's pages (:meth:`_gather_pages`)
        as whole wire pages: on a mesh gathered to rank 0
        (``comm.page_gather``), None on the other ranks."""
        if self._page_mesh is not None:
            pages = comm.page_gather(pages, self._page_mesh)
            if pages is None:
                return None
        return _landing(pages)

    def _scatter_pages(self, ids: list[int], pages) -> None:
        """Write host pages (``[n, L, ...]`` tensors, int8: ``{kv, scale}``)
        into blocks ``ids``, in place: the CUDA graphs captured the cache
        tensors' addresses, so the cache is never rebound."""
        with self._on_stream():
            idx = self._index(ids)
            if self.engine.kv_quantized:
                dev = {k: self._to_device(v) for k, v in pages.items()}
                for l, c in enumerate(self.cache):
                    for k in ("kv", "scale"):
                        c[k].index_copy_(0, idx, dev[k][:, l])
            else:
                dev = self._to_device(pages)
                for l, c in enumerate(self.cache):
                    c.index_copy_(0, idx, dev[:, l])

    def _copy_pages_from(self, src: "EngineCore", sids: list[int], dids: list[int]) -> None:
        """Device-direct copy of ``src``'s blocks ``sids`` into this
        cache's ``dids``, in place, with no host staging."""
        with self._on_stream():
            if src._stream is not None and src._stream != self._stream:
                self._stream.wait_stream(src._stream)
            s_idx, d_idx = src._index(sids), self._index(dids)
            for s, d in zip(src.cache, self.cache):
                if isinstance(d, dict):
                    for k in d:
                        d[k].index_copy_(0, d_idx, s[k].index_select(0, s_idx))
                else:
                    d.index_copy_(0, d_idx, s.index_select(0, s_idx))

    @property
    def kv_wire_dtype(self) -> str:
        """The dtype name KV pages carry on every tier and wire: "int8"
        for quantized caches (packed pages — engine/kv_quant.py), else
        the model dtype's numpy name ("bfloat16", as the JAX engine says)."""
        if self.engine.kv_quantized:
            return "int8"
        return str(self.cfg.torch_dtype).removeprefix("torch.")

    def _page_geometry(self, wire: bool = False) -> tuple[int, int, int, int]:
        """(layers, page size, KV heads, head dim) of this rank's pages, or
        with ``wire`` of the whole page the transfer and the peer server
        carry (every layer and KV head, whatever the mesh)."""
        cfg = self.cfg if wire else self.local_cfg
        return cfg.num_layers, self.engine.block_size, cfg.num_kv_heads, self.cfg.head_dim

    def _page_shape(self, wire: bool = False) -> tuple[int, int, int, int]:
        L, bs, kv, d = self._page_geometry(wire)
        return L, bs, 2 * kv, d

    def _stage_page(self, kv, wire: bool = False):
        """One host-side page (the canonical tier/wire representation —
        packed uint8 for int8, a plain ``[L, ps, 2kv, d]`` array otherwise)
        as the views :meth:`_stack_staged` copies from, its size checked
        against this rank's geometry (``wire``: the whole page's): the
        page's bytes, or int8's unpacked ``{kv, scale}`` (bit for bit, never
        re-quantized)."""
        if self.engine.kv_quantized:
            q8, sc = unpack_kv_page(kv, *self._page_geometry(wire))
            return {"kv": q8, "scale": sc}
        raw = _raw_bytes(kv)
        want = int(np.prod(self._page_shape(wire))) * self.cfg.torch_dtype.itemsize
        if raw.size != want:
            raise ValueError(f"KV page of {raw.size} bytes, the local geometry takes {want}")
        return raw

    def _page_batch(self, n: int, wire: bool = False):
        """An empty host batch of ``n`` pages (this rank's, or with ``wire``
        whole ones), pinned on the card, from which a scatter's copy to the
        device runs."""
        pin = self.device.type == "cuda"
        shape = (n, *self._page_shape(wire))
        if self.engine.kv_quantized:
            return {"kv": torch.empty(shape, dtype=torch.int8, pin_memory=pin),
                    "scale": torch.empty(shape[:-1], dtype=torch.float32, pin_memory=pin)}
        return torch.empty(shape, dtype=self.cfg.torch_dtype, pin_memory=pin)

    def _stack_staged(self, pages: list, wire: bool = False):
        """Staged pages (:meth:`_stage_page`) as one ``[n, L, ...]`` host
        batch (:meth:`_page_batch`; int8: ``{kv, scale}``), each page copied
        once."""
        out = self._page_batch(len(pages), wire)
        if self.engine.kv_quantized:
            for k in ("kv", "scale"):
                view = out[k].numpy()
                for i, p in enumerate(pages):
                    view[i] = p[k]
            return out
        view = out.view(torch.uint8).numpy().reshape(len(pages), -1)
        for i, p in enumerate(pages):
            view[i] = p
        return out

    def _rank_pages(self, staged: list | None, n: int):
        """This rank's part of ``n`` staged wire pages as a host batch: the
        pages themselves on one rank; on a mesh rank 0's (``staged``; None
        on the other ranks) split by ``comm.page_scatter``."""
        if self._page_mesh is None:
            return self._stack_staged(staged)
        whole = self._stack_staged(staged, wire=True) if staged is not None else None
        return comm.page_scatter(whole, self._page_batch(n), self._page_mesh)

    def _fetch_page_bytes(self, pages, n: int) -> list[bytes]:
        """Land a gather of ``n`` pages (:func:`_landing`) and serialize
        each block to its canonical wire bytes (packed int8 + scales for
        quantized caches, bit-stable across every hop)."""
        if isinstance(pages, dict):
            kv_h, sc_h = pages["kv"].land(), pages["scale"].land()
            return [pack_kv_page(kv_h[i], sc_h[i]).tobytes() for i in range(n)]
        host = pages.land()
        return [np.ascontiguousarray(host[i]).tobytes() for i in range(n)]

    def _onboard_from_host(
        self, hashes: list[int], cached_ids: list[int], ncached: int, cap: int
    ) -> tuple[list[int], int]:
        """Extend a device-cached prefix with offload-tier hits: promote
        each consecutive host/disk block back to the device and pin it.
        The staged bytes scatter back exactly as stored, in one batch
        (the JAX engine scatters block by block; the allocator sees the
        same calls in the same order)."""
        got: list[tuple[int, int, int | None, Any, str]] = []
        while ncached + len(got) < cap and self.offload.contains(hashes[ncached + len(got)]):
            h = hashes[ncached + len(got)]
            hit = self.offload.fetch_tiered(h)
            if hit is None:
                break  # evicted between contains() and fetch()
            parent_hash, kv, src_tier = hit
            try:
                bid = self.allocator.alloc_for_import()
            except OutOfBlocksError:
                self.offload.reinsert(h, parent_hash, kv)  # undo the pop
                break
            got.append((bid, h, parent_hash, kv, src_tier))
        if not got:
            return cached_ids, ncached
        self._scatter_pages(
            [bid for bid, *_ in got], self._stack_staged([self._stage_page(g[3]) for g in got])
        )
        for bid, h, parent_hash, _, src_tier in got:
            # Tier-aware: the promotion publishes stored(device) through
            # the allocator, then retracts the source tier (stored first,
            # so the composed index never sees the worker empty). Legacy:
            # the block never left the worker; no event.
            self.allocator.register_inactive(bid, h, parent_hash, emit=self._tier_aware)
            if self._tier_aware:
                self._on_tier_removed([h], src_tier)
            cached_ids.extend(self.allocator.acquire_cached([h]))
        return cached_ids, ncached + len(got)

    # -- disaggregated KV transfer (export on prefill, import on decode) ---
    #
    # v2 protocol, as the JAX engine's: descriptors first (hash chain and
    # layout, no data, under the step lock), then page data in chunks. A
    # chunk's gather and its copy to pinned memory are enqueued under the
    # step lock, on the engine's stream; the wait for the copy runs
    # unlocked (held blocks are pinned and cannot be rewritten).
    #
    # On a mesh the wire page is still the whole combined page: reading
    # pages, importing them, serving them to peers and embedding are
    # collective methods, which every rank calls in the same order (a
    # lockstep leader journals them, backends/torch/multihost.py); the
    # allocator's calls are the same on every rank, so every rank picks the
    # same blocks, and the pages' bytes travel through comm.page_gather and
    # comm.page_scatter. Descriptors, cursors and prefix probes read host
    # state only and run on any one rank.

    KV_WIRE_VERSION = 2

    def _streaming_seq(self, request_id: str) -> "Sequence | None":
        """The RUNNING hold_blocks sequence for ``request_id``, if any —
        the streaming-handoff source while its prefill is still chunking.
        Cancel, preemption and finish all take the sequence out of
        ``running``, so a mid-stream puller then sees KeyError and falls
        back. Callers hold ``_step_lock``."""
        for seq in self.running:
            if seq.request_id == request_id and seq.hold_blocks:
                return seq
        return None

    def export_descriptors(
        self, request_id: str, start: int = 0, count: int | None = None
    ) -> list[dict]:
        """Phase 1: descriptor snapshot of a held prefill's committed
        blocks (``start``/``count``: a committed-block window, for the
        streaming handoff). The hold stays until :meth:`release_held`.
        The page is the whole model's on any mesh; ``layout["tp"]`` is
        this producer's tp, as in JAX."""
        with self._step_lock:
            seq = self._held.get(request_id) or self._streaming_seq(request_id)
            if seq is None:
                raise KeyError(f"no held blocks for request {request_id}")
            self._touch_hold(request_id)
            shape = list(self._page_shape(wire=True))
            dtype = self.kv_wire_dtype
            layout = {
                "kind": "combined_kv_page",
                "block_size": self.engine.block_size,
                "tp": self.mesh.tp if self.mesh is not None else 1,
                "kv_dtype": self.engine.kv_dtype,
            }
            if self.engine.kv_quantized:
                layout["scale_dtype"] = "float32"
                layout["scale_shape"] = shape[:-1]
            lo = max(0, start)
            hi = seq.committed_blocks
            if count is not None:
                hi = min(hi, lo + max(0, count))
            descs: list[dict] = []
            parent: int | None = seq.pinned_hashes[lo - 1] if lo > 0 else None
            for i in range(lo, hi):
                h = seq.pinned_hashes[i]
                descs.append(
                    {
                        wire.IMP_HASH: h, wire.IMP_PARENT: parent,
                        wire.IMP_SHAPE: shape, wire.IMP_DTYPE: dtype,
                        wire.IMP_LAYOUT: layout,
                    }
                )
                parent = h
            return descs

    def read_held_pages(self, request_id: str, start: int, count: int) -> list[bytes]:
        """Phase 2: a chunk of a held prefill's committed pages as raw
        bytes (``[L, block_size, 2*n_kv, d]`` each, int8: packed). On a
        mesh every rank calls it; rank 0 returns the pages, the others
        ``[]``."""
        with self._step_lock, self._on_stream():
            pages, n = self._held_pages(request_id, start, count)
        return self._fetch_page_bytes(pages, n) if pages is not None else []

    def _held_pages(self, request_id: str, start: int, count: int):
        """:meth:`read_held_pages`' gather, landing started (the caller
        holds the step lock): (the landing or None, pages)."""
        seq = self._held.get(request_id) or self._streaming_seq(request_id)
        if seq is None:
            raise KeyError(f"no held blocks for request {request_id}")
        self._touch_hold(request_id)
        # Committed blocks only: export_descriptors describes exactly
        # those, and the consumer zips data frames against them.
        ids = seq.block_ids[: seq.committed_blocks][start : start + count]
        if not ids:
            return None, 0
        return self._collect_pages(self._gather_pages(ids)), len(ids)

    def read_cached_pages(self, hashes: list[int]) -> list[bytes]:
        """Non-destructive read of the longest locally held prefix of a
        hash chain, for peer serving. Device blocks are pinned under one
        step-lock acquisition and gathered at once; offload-tier blocks
        are read from host RAM or disk. Stops at the first hash held
        nowhere. On a mesh every rank calls it: each reads its part of the
        pages where it holds them (on the device, or in its own tier), the
        chain ends where any rank's does, and rank 0 returns the whole
        pages, the others ``[]``."""
        with self._step_lock, self._on_stream():
            out = self._cached_pages(hashes)
        return out() if out is not None else []

    def _cached_pages(self, hashes: list[int]) -> Callable[[], list[bytes]] | None:
        """:meth:`read_cached_pages` under the step lock: the device blocks
        are read (gathers enqueued, their landing started) and their pins
        released; returns what serializes the pages, to call unlocked (None:
        nothing to return on this rank). On one rank the offload tiers are
        read there, unlocked, so that a disk read never stalls a step; on a
        mesh they are read here, since every rank must agree on one page
        count (``comm.page_count``) before the pages' gather."""
        where: list[tuple[bool, int]] = []  # (on the device, hash)
        for h in hashes:
            if self.allocator.enable_prefix_caching and self.allocator.is_cached(h):
                where.append((True, h))
            elif self.offload is not None and self.offload.contains(h):
                where.append((False, h))
            else:
                break
        mesh = self._page_mesh
        tier: dict[int, Any] = {}
        if mesh is not None:
            for i, (on_dev, h) in enumerate(where):
                if not on_dev:
                    kv = self.offload.peek(h)
                    if kv is None:  # evicted between contains() and peek()
                        where = where[:i]
                        break
                    tier[h] = kv
            where = where[: comm.page_count(len(where), mesh)]
        if not where:
            return None
        dev_hashes = [h for on_dev, h in where if on_dev]
        # Pinned and released as the JAX engine does (the release refreshes
        # the blocks' LRU position); the gathers are enqueued on the
        # engine's stream before any later step can rewrite them.
        dev_ids = self.allocator.acquire_cached(dev_hashes)
        try:
            dev = _landing(self._gather_pages(dev_ids)) if dev_ids else None
        finally:
            if dev_hashes:
                self.allocator.release(dev_hashes)
        if mesh is None:

            def serialize() -> list[bytes]:
                got = self._fetch_page_bytes(dev, len(dev_ids)) if dev is not None else []
                # Offload tiers store the canonical wire buffer.
                return _chain_order(where, got, lambda h: _tier_bytes(self.offload.peek(h)))

            return serialize
        # On a mesh: this rank's parts, device and tier pages in chain
        # order, as one host batch, gathered to rank 0.
        if isinstance(dev, dict):
            host = {k: v.land() for k, v in dev.items()}
            dev_pages = [{k: v[j] for k, v in host.items()} for j in range(len(dev_ids))]
        else:
            host = dev.land() if dev is not None else None
            dev_pages = [_raw_bytes(host[j]) for j in range(len(dev_ids))]
        staged = _chain_order(where, dev_pages, lambda h: self._stage_page(tier[h]))
        pages = self._collect_pages(self._stack_staged(staged))
        return None if pages is None else lambda: self._fetch_page_bytes(pages, len(staged))

    def cached_prefix_tokens(self, token_ids: list[int]) -> int:
        """Locally cached leading tokens."""
        hashes = compute_seq_hashes(token_ids, self.engine.block_size)
        with self._step_lock:
            return self.allocator.match_prefix(hashes) * self.engine.block_size

    def kv_inventory(self) -> list[tuple[str, int, int | None]]:
        """(tier, hash, parent) of every cached block across the device
        and offload tiers: the payload the KV event publisher re-publishes
        after an indexer reports a gap."""
        with self._step_lock:
            out: list[tuple[str, int, int | None]] = [
                ("device", h, parent) for h, parent in self.allocator.snapshot()
            ]
        if self.offload is not None:
            out.extend(self.offload.snapshot())
        return out

    def tier_stats(self) -> dict:
        """The offload tiers' counters: blocks offloaded into, onboarded
        from and evicted out of each tier, and its residency."""
        out = {}
        for tier, pool in (("host", self.host_pool), ("disk", self.disk_pool)):
            if pool is not None:
                st = pool.stats
                out[tier] = {"offloads": st.offloads, "onboards": st.onboards,
                             "evictions": st.evictions, "resident": len(pool)}
        return out

    def _touch_hold(self, request_id: str) -> None:
        """Refresh a hold's expiry: an in-flight transfer must not lose its
        blocks between chunks. Callers hold ``_step_lock``."""
        if self.engine.held_block_ttl_s > 0 and request_id in self._held_deadline:
            self._held_deadline[request_id] = (
                time.monotonic() + self.engine.held_block_ttl_s
            )

    def chunk_cursor(self, request_id: str) -> tuple[int, bool]:
        """The streaming-handoff cursor: (committed blocks readable now,
        prefill finished). KeyError when the request holds nothing."""
        with self._step_lock:
            seq = self._held.get(request_id)
            if seq is not None:
                return seq.committed_blocks, True
            seq = self._streaming_seq(request_id)
            if seq is None:
                raise KeyError(f"no held blocks for request {request_id}")
            return seq.committed_blocks, False

    def release_held(self, request_id: str) -> None:
        with self._step_lock:
            self._release_held_locked(request_id)

    def _release_held_locked(self, request_id: str) -> None:
        self._held_deadline.pop(request_id, None)
        seq = self._held.pop(request_id, None)
        if seq is not None:
            self._release_blocks(seq)
            return
        # Still running (a streaming handoff abandoned early): drop the
        # hold, so _finish releases the blocks at once and
        # _streaming_seq serves no more windows.
        seq = self._streaming_seq(request_id)
        if seq is not None:
            seq.hold_blocks = False

    def import_blocks(self, blocks: list[dict]) -> ImportResult:
        """Write transferred KV pages into the local cache as inactive
        cached content; a following admission prefix-matches them. Returns
        the per-call outcome (already-cached hashes are skipped). The
        pages are staged on the host first; under the step lock one
        batched in-place scatter on the engine's stream writes them (the
        caller runs this on a worker thread, whose current stream is not
        the engine's).

        int8 pages arrive as the canonical packed buffer and scatter bit
        for bit, never re-quantized; a mismatch where either side is int8
        fails fast. A float mismatch (bf16 producer, f32 consumer) is
        cast on the host.

        On a mesh every rank calls it with the same descriptors; only rank
        0's carry the pages (the others' ``kv`` is ignored, and may be
        absent), and each rank writes its part (``comm.page_scatter``)."""
        staged = self._stage_imports(blocks)
        with self._step_lock, self._on_stream():
            return self._import_locked(blocks, staged)

    def _stage_imports(self, blocks: list[dict]) -> list | None:
        """Check each descriptor's geometry and dtype against this engine's
        (every rank) and stage its page on the host (rank 0; None on the
        other ranks of a mesh)."""
        expected = self._page_shape(wire=True)
        local = self.cfg.torch_dtype
        for blk in blocks:
            shape = tuple(blk[wire.IMP_SHAPE])
            if shape != expected:
                kind = (blk.get(wire.IMP_LAYOUT) or {}).get("kind", "combined_kv_page")
                if kind != "combined_kv_page":
                    raise ValueError(f"unknown producer KV layout {kind!r}; cannot relayout")
                if shape[1] != expected[1]:
                    raise ValueError(
                        f"producer block_size {shape[1]} != local "
                        f"{expected[1]}: hash domains are disjoint, refusing "
                        "import (align kv_block_size across the P/D fleet)"
                    )
                raise ValueError(
                    f"incompatible KV page geometry {shape} vs local "
                    f"{expected} (different model config?)"
                )
            wire_dtype = str(blk[wire.IMP_DTYPE])
            if (wire_dtype == "int8") != self.engine.kv_quantized:
                raise ValueError(
                    f"KV dtype mismatch: producer pages are {wire_dtype!r} "
                    f"but this worker's kv_dtype is "
                    f"{self.engine.kv_dtype!r} — refusing to import "
                    "(re-quantizing would break the quantize-once "
                    "invariant; align --kv-dtype across the fleet)"
                )
            if not self.engine.kv_quantized and wire_dtype not in _WIRE_DTYPES:
                raise ValueError(f"unknown KV page dtype {wire_dtype!r}")
        if self._page_mesh is not None and self._page_mesh.rank != 0:
            return None
        staged = []
        for blk in blocks:
            wire_dtype = str(blk[wire.IMP_DTYPE])
            if not self.engine.kv_quantized and _WIRE_DTYPES[wire_dtype] != local:
                # A float fleet of mixed precision (a bf16 producer, an f32
                # consumer): cast on the host, before staging.
                page = torch.from_numpy(_raw_bytes(blk[wire.IMP_KV]).copy())
                page = _raw_bytes(_host_numpy(page.view(_WIRE_DTYPES[wire_dtype]).to(local)))
            else:
                page = blk[wire.IMP_KV]
            # Validates the page's size (int8: the packed size).
            staged.append(self._stage_page(page, wire=True))
        return staged

    def _import_locked(self, blocks: list[dict], staged: list | None) -> ImportResult:
        """:meth:`import_blocks` under the step lock: the allocator picks the
        blocks (the same on every rank), then one scatter writes them."""
        ids: list[int] = []
        rows: list[int] = []
        pending: list[tuple[int, int, int | None]] = []
        skipped = 0
        for i, blk in enumerate(blocks):
            h = blk[wire.IMP_HASH]
            if self.allocator.is_cached(h):
                skipped += 1
                continue
            try:
                bid = self.allocator.alloc_for_import()
            except OutOfBlocksError:
                break
            ids.append(bid)
            rows.append(i)
            pending.append((bid, h, blk[wire.IMP_PARENT]))
        if ids:
            mine = [staged[i] for i in rows] if staged is not None else None
            self._scatter_pages(ids, self._rank_pages(mine, len(ids)))
            for bid, h, parent in pending:
                self.allocator.register_inactive(bid, h, parent)
        return self._account_transfer(len(blocks), len(ids), skipped)

    def _account_transfer(self, total: int, imported: int, skipped: int) -> ImportResult:
        """Update transfer_stats for one import call (the caller holds the
        step lock) and return the per-call outcome."""
        dropped = total - imported - skipped
        st = self.transfer_stats
        st["transfers"] += 1
        st["imported_blocks"] += imported
        st["skipped_cached_blocks"] += skipped
        st["dropped_blocks"] += dropped
        if dropped > 0:
            st["partial_transfers"] += 1
            log.warning(
                "partial KV import: %d/%d transferred blocks dropped "
                "(allocator full) — decode will recompute them",
                dropped, total,
            )
        return ImportResult(imported=imported, skipped=skipped, dropped=dropped)

    def _mesh_shape(self) -> tuple[int, int, int, int]:
        """(dp, tp, pp, sp) of this engine's ranks."""
        m = self.mesh
        return (m.dp if m is not None else 1, m.tp if m is not None else 1, self._pp,
                self.sp_mesh.sp if self.sp_mesh is not None else 1)

    def import_blocks_direct(self, src: "EngineCore", request_id: str) -> ImportResult:
        """Device-direct KV pull from a source core on the same device:
        one gather out of the source cache and one in-place scatter into
        this one per layer, no host staging. Both step locks are held for
        the copy, taken in id() order so mutual pulls cannot deadlock. On a
        mesh both cores' meshes must be the same, and every rank calls it
        with its own pair, copying its own part of the pages."""
        if src is self:
            raise ValueError("cannot direct-import from self")
        if src._mesh_shape() != self._mesh_shape():
            dp, tp, pp, sp = src._mesh_shape()
            raise ValueError(
                f"direct import needs matching meshes (source dp={dp} tp={tp} pp={pp} "
                f"sp={sp}, this core {self._mesh_shape()}); use the staged wire path instead"
            )
        if src.device != self.device:
            raise ValueError(
                f"direct import needs both caches on one device ({src.device} vs "
                f"{self.device}); use the staged wire path instead"
            )
        if src.engine.kv_dtype != self.engine.kv_dtype:
            raise ValueError(
                f"KV dtype mismatch: source core stores "
                f"{src.engine.kv_dtype!r} pages but this core is "
                f"{self.engine.kv_dtype!r} — refusing direct import "
                "(align --kv-dtype across the fleet)"
            )
        descs = src.export_descriptors(request_id)
        first, second = (src, self) if id(src) < id(self) else (self, src)
        # dynacheck: allow-lock-order(global id()-ordered acquisition — mutual pulls always take the lower-id core's lock first, so the pair can never deadlock)
        with first._step_lock, second._step_lock:
            seq = src._held.get(request_id)
            if seq is None:
                raise KeyError(f"no held blocks for request {request_id}")
            src._touch_hold(request_id)
            all_src_ids = seq.block_ids[: seq.committed_blocks]
            ids: list[int] = []
            src_ids: list[int] = []
            pending: list[tuple[int, int, int | None]] = []
            skipped = 0
            for row, d in enumerate(descs):
                if self.allocator.is_cached(d[wire.IMP_HASH]):
                    skipped += 1
                    continue
                try:
                    bid = self.allocator.alloc_for_import()
                except OutOfBlocksError:
                    break
                ids.append(bid)
                src_ids.append(all_src_ids[row])
                pending.append((bid, d[wire.IMP_HASH], d[wire.IMP_PARENT]))
            if ids:
                self._copy_pages_from(src, src_ids, ids)
                for bid, h, parent in pending:
                    self.allocator.register_inactive(bid, h, parent)
            return self._account_transfer(len(descs), len(ids), skipped)

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
        # The stage count and a fused chain's steady-state pipe occupancy:
        # k*M work items over k*M + pp - 1 wavefront rounds (1.0 unpipelined).
        st["pp_stages"] = self._pp
        km = max(1, self.engine.megastep) * self._pp
        st["pp_pipe_occupancy"] = km / (km + self._pp - 1)
        par = self.parallel_stats()
        st.update({k: v for k, v in par.items() if k != "comm_backend"})
        st["attention_launches"] = ragged_attention.launches
        st["attention_launches_int8"] = ragged_attention.launches_int8
        st["graph_captures"] = self._graphs.captures
        st["graph_replays"] = self._graphs.replays
        st["graph_capture_s"] = self._graphs.capture_s
        return st

    def parallel_stats(self) -> dict:
        """The mesh: tp, dp, pp and this rank (a pipeline's: its stage),
        the collective backend ("none" on one rank), the collectives this
        process has called (all kinds; ``p2p_calls`` of them the stage hops
        sent and received) and those each forward of a tp rank calls (2 per
        layer: the all-reduces after ``wo`` and the MLP, or under the
        all-to-all expert dispatch 4: the ``wo`` all-reduce, two
        all-to-alls and the tokens' gather; and the logits' gather of an
        untied lm_head); an sp rank's ring prefills. ``scheduler_stats``
        carries the numbers."""
        tp = self.mesh.tp if self.mesh is not None else 1
        dp = self.mesh.dp if self.mesh is not None else 1
        sp = self.sp_mesh.sp if self.sp_mesh is not None else 1
        ranked = (self.pp_mesh if self._pp > 1 else self.mesh if tp * dp > 1
                  else self.sp_mesh if sp > 1 else None)
        return {
            "tp": tp,
            "dp": dp,
            "sp": sp,
            "ring_prefills": self._ring_prefills,
            "rank": ranked.rank if ranked is not None else 0,
            "comm_backend": ranked.backend if ranked is not None else "none",
            "collective_calls": sum(comm.calls.values()) if ranked is not None else 0,
            "p2p_calls": comm.calls["send"] + comm.calls["recv"] if self._pp > 1 else 0,
            "collectives_per_forward": (
                0 if tp == 1 else
                (4 if self.cfg.is_moe and self.cfg.moe_dispatch == "alltoall" else 2)
                * self.cfg.num_layers + (0 if self.cfg.tie_embeddings else 1)),
        }

    def kv_cache_stats(self) -> dict:
        """Prefix-cache gauges: the allocator's probe counters and the
        admitted sequences whose prefix came from cache."""
        a = self.allocator
        return {
            "kv_dtype": self.engine.kv_dtype,
            "kv_dtype_int8": 1 if self.engine.kv_quantized else 0,
            "bytes_per_block": kv_page_bytes(
                self.local_cfg.num_layers, self.engine.block_size,
                self.local_cfg.num_kv_heads, self.cfg.head_dim,
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
        """Speculation gauges with the JAX engine's keys: acceptance rate,
        mean accepted length, drafted, accepted and wasted tokens, device
        draft rounds."""
        st = self.spec_stats.as_dict()
        st["enabled"] = 1 if self._spec_default is not None else 0
        return st

    def fair_queue_stats(self) -> dict[str, dict[str, float]]:
        """Per-tenant admission-queue depth and DRR deficit."""
        return self.waiting.stats()

    def metrics(self) -> ForwardPassMetrics:
        """Load metrics as the JAX engine reports them: ``spec_decode``
        once speculation is configured or a request used it, ``net`` the
        measured per-peer pull costs once a PeerKvClient installed its
        source."""
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
            spec_decode=(
                self.spec_decode_stats()
                if self._spec_default is not None or self.spec_stats.verify_rows
                else None
            ),
            net=(
                self.net_stats_source() or None
                if self.net_stats_source is not None
                else None
            ),
        )
