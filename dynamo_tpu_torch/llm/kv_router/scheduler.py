"""Worker selection: the KV-aware cost function + softmax sampling.

The port's copy of ``dynamo_tpu/llm/kv_router/scheduler.py``, held to it by
``tests/test_torch_copies.py``.

For each candidate worker the cost is

    cost(w) = overlap_weight * potential_prefill_blocks(w)
              + potential_decode_blocks(w)

where ``potential_prefill_blocks`` is the prefill still required *after*
prefix-cache reuse on that worker, and ``potential_decode_blocks`` the
worker's block occupancy if the request lands there. Lower is better; a
softmax over negative normalized costs (temperature ``t``) picks the
worker — ``t == 0`` degenerates to argmin with deterministic tie-break.

Capability parity: reference `lib/llm/src/kv_router/scheduler.rs:361,
417-418` (DefaultWorkerSelector, formula) and `:288` (softmax_sample).
"""

from __future__ import annotations

import math
import random
import time
from dataclasses import dataclass
from typing import Protocol

from dynamo_tpu_torch.llm.kv_router.protocols import RouterConfig
from dynamo_tpu_torch.llm.kv_router.sequence import ActiveSequences


@dataclass
class SelectionResult:
    worker_id: int
    overlap_blocks: int
    required_prefill_tokens: int
    costs: dict[int, float]
    # Per-worker cached-prefix overlap (blocks) as the indexer saw it at
    # selection time — lets the caller detect a better-overlapping PEER
    # than the chosen worker (cross-worker prefix pull).
    overlaps: dict[int, int] = None  # type: ignore[assignment]
    # Wall-clock bounds of the scoring pass (cost function + softmax),
    # stamped by the selector. The router files these as an
    # ``overlap_score`` child span of its route span — the selector
    # itself has no trace context, so the span is recorded upstream.
    score_start_s: float = 0.0
    score_end_s: float = 0.0
    # Network-aware routing (netcost.NetworkAwareSelector): the chosen
    # worker's cost-decided pull source — (source_worker_id, blocks held
    # there) — already discounted by measured transfer cost. None = no
    # pull beats recomputing (or the selector is overlap-only).
    pull_hint: tuple[int, int] | None = None


class WorkerSelector(Protocol):
    def select_worker(
        self,
        workers: list[int],
        overlaps: dict[int, int],
        prompt_tokens: int,
        active: ActiveSequences,
        config: RouterConfig,
    ) -> SelectionResult: ...


def softmax_sample(
    costs: dict[int, float], temperature: float, rng: random.Random | None = None
) -> int:
    """Sample a key with probability decreasing in cost; t=0 → argmin."""
    if not costs:
        raise ValueError("no candidates")
    if temperature <= 0.0:
        return min(sorted(costs), key=lambda k: costs[k])
    vals = list(costs.values())
    lo, hi = min(vals), max(vals)
    span = hi - lo
    if span == 0.0:
        keys = sorted(costs)
        return (rng or random).choice(keys)
    logits = {k: -(v - lo) / span / temperature for k, v in costs.items()}
    mx = max(logits.values())
    weights = {k: math.exp(v - mx) for k, v in logits.items()}
    total = sum(weights.values())
    r = (rng.random() if rng else random.random()) * total
    acc = 0.0
    for k in sorted(weights):
        acc += weights[k]
        if r <= acc:
            return k
    return max(sorted(weights), key=lambda k: weights[k])


class DefaultWorkerSelector:
    def __init__(self, rng: random.Random | None = None):
        self._rng = rng or random.Random()

    def _score(
        self,
        worker_id: int,
        overlap: int,
        prefill_blocks: float,
        decode_blocks: float,
        overlaps: dict[int, int],
        prompt_blocks: int,
        config: RouterConfig,
    ) -> tuple[float, object]:
        """One candidate's cost, plus an opaque note handed to
        :meth:`_annotate` if this candidate wins. Subclasses extend the
        scoring HERE (NetworkAwareSelector) so the candidate loop itself
        exists once and the two routing modes cannot silently diverge."""
        return config.overlap_weight * prefill_blocks + decode_blocks, None

    def _annotate(self, result: SelectionResult, note: object) -> SelectionResult:
        """Post-selection hook: the winning candidate's note from
        :meth:`_score`."""
        return result

    def select_worker(
        self,
        workers: list[int],
        overlaps: dict[int, int],
        prompt_tokens: int,
        active: ActiveSequences,
        config: RouterConfig,
    ) -> SelectionResult:
        if not workers:
            raise ValueError("no live workers")
        t_score = time.time()
        block_size = active.block_size
        prompt_blocks = math.ceil(prompt_tokens / block_size) if prompt_tokens else 0
        costs: dict[int, float] = {}
        notes: dict[int, object] = {}
        for w in workers:
            overlap = min(overlaps.get(w, 0), prompt_blocks)
            decode_blocks, prefill_tokens = active.potential_blocks_and_tokens(
                w, prompt_tokens, overlap
            )
            prefill_blocks = prefill_tokens / block_size
            costs[w], notes[w] = self._score(
                w, overlap, prefill_blocks, decode_blocks, overlaps,
                prompt_blocks, config,
            )
        chosen = softmax_sample(costs, config.temperature, self._rng)
        overlap = min(overlaps.get(chosen, 0), prompt_blocks)
        result = SelectionResult(
            worker_id=chosen,
            overlap_blocks=overlap,
            required_prefill_tokens=max(0, prompt_tokens - overlap * block_size),
            costs=costs,
            score_start_s=t_score,
            score_end_s=time.time(),
        )
        return self._annotate(result, notes[chosen])
