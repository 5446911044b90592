"""Network-aware routing (NetKV, ISSUE 14): measured-transfer-cost +
queue-depth scoring for decode placement and peer-prefix pulls.

The port's copy of ``dynamo_tpu/llm/kv_router/netcost.py``, held to it by
``tests/test_torch_copies.py``.

The overlap-only selector (scheduler.py) assumes two things that break at
fleet scale: that every candidate's network is uniform (a cached prefix
on ANY peer is equally worth pulling) and that load shows up fast enough
in block occupancy. NetKV's observation is that decode-instance
selection must weigh the *measured* KV-transfer cost — a peer behind a
congested/partitioned link, or one that keeps stalling its frames, makes
"pull the prefix" slower than recomputing it — and the queue depth the
candidate already carries.

Two pieces:

- :class:`NetCostModel` — the fleet's measured per-source transfer cost.
  Workers publish their per-peer pull EWMAs (``PeerPullStats.per_peer``
  → ``ForwardPassMetrics.net``); the model folds every reporter's view
  of a source into one ``ms_per_block`` per source worker (pull-count
  weighted), plus direct local observations (``observe_pull``) for
  processes that pull themselves (the fleet harness, tests). The
  ``cost_ratio`` of a source is its measured per-block pull cost over
  the configured per-block *recompute* cost — ratio ≥ 1 means pulling
  from that source buys nothing.
- :class:`NetworkAwareSelector` — DefaultWorkerSelector's cost function
  extended with (a) a queue-depth term and (b) transfer-aware prefill
  relief: the prefill a candidate would skip by pulling a peer's cached
  prefix counts as avoided only in proportion to ``1 - cost_ratio`` of
  the cheapest useful source. The same pass picks the candidate's best
  pull source, which becomes the ``peer_prefix`` hint — so placement
  and pulls shift away from slow/loaded peers TOGETHER, and a fleet
  with no useful cheap peer degrades to exactly the overlap-only
  scoring.

Streams are bit-identical with routing-aware on or off: the cost model
only moves *where* a request lands and *which* peer it pulls from, never
what tokens it produces.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import Callable

from dynamo_tpu_torch.llm.kv_router.protocols import RouterConfig
from dynamo_tpu_torch.llm.kv_router.scheduler import (
    DefaultWorkerSelector,
    SelectionResult,
)

# Prior per-block pull cost before anything is measured: optimistic
# enough that the first pull from a fresh peer happens (you cannot
# measure a link you never use), pessimistic enough that real
# measurements move the score immediately.
DEFAULT_PULL_MS_PER_BLOCK = 0.5
# Measured-cost ceiling, as a multiple of the recompute cost: a severed
# peer's EWMA can reach seconds/block — the ratio clamp keeps one
# horrible peer from distorting the normalized softmax for everyone else.
MAX_COST_RATIO = 4.0


@dataclass
class _SourceCost:
    ms_per_block: float = DEFAULT_PULL_MS_PER_BLOCK
    pulls: int = 0


class NetCostModel:
    """Fleet-wide measured KV-transfer cost per source worker."""

    def __init__(
        self,
        recompute_ms_per_block: float = 2.0,
        fleet_view: Callable[[], dict] | None = None,
        ewma_alpha: float = 0.3,
        cache_s: float = 0.5,
        clock: Callable[[], float] = time.monotonic,
    ):
        # What one block of local prefill recompute costs — the yardstick
        # a pull must beat. Callers with a profiled engine should set it
        # from block_size * prefill_us_per_token.
        self.recompute_ms_per_block = recompute_ms_per_block
        # () -> {worker_id: ForwardPassMetrics}: the router's
        # WorkerMonitor/MetricsAggregator view (queue depths + per-peer
        # net dicts). None = local observations only.
        self.fleet_view = fleet_view
        self.ewma_alpha = ewma_alpha
        # The fold over every reporter's net dict is O(workers) per
        # source; the selector asks per candidate×peer. Cache the folded
        # table for cache_s (worker metrics only refresh every ~0.5 s
        # anyway). clock is injectable for virtual-time harnesses.
        self.cache_s = cache_s
        self.clock = clock
        self._local: dict[int, _SourceCost] = {}
        self._table: dict[int, float] | None = None
        self._queues: dict[int, int] = {}
        self._table_t: float = float("-inf")

    # -- feeding -----------------------------------------------------------

    def observe_pull(
        self, source: int, blocks: int, elapsed_ms: float, ok: bool = True
    ) -> None:
        """Direct local measurement (same sample semantics as
        ``PeerPullStats.note_pull``: a failed pull charges its whole
        elapsed budget as one block's worth)."""
        st = self._local.setdefault(int(source), _SourceCost())
        sample = elapsed_ms / max(1, blocks) if ok else elapsed_ms
        st.ms_per_block = (
            sample
            if st.pulls == 0
            else (1 - self.ewma_alpha) * st.ms_per_block
            + self.ewma_alpha * sample
        )
        st.pulls += 1
        self.invalidate()

    def invalidate(self) -> None:
        self._table = None

    # -- reading -----------------------------------------------------------

    def _fleet_metrics(self) -> dict:
        if self.fleet_view is None:
            return {}
        try:
            return self.fleet_view() or {}
        # dynalint: allow-broad-except(a broken monitor view must degrade to local observations, never break routing)
        except Exception:
            return {}

    def _fold(self) -> dict[int, float]:
        """The folded per-source cost table + queue depths, rebuilt at
        most every cache_s: pull-count-weighted mean over every
        reporter's EWMA (ForwardPassMetrics.net) + local observations."""
        now = self.clock()
        if self._table is not None and now - self._table_t <= self.cache_s:
            return self._table
        weight: dict[int, float] = {}
        total: dict[int, float] = {}
        for source, st in self._local.items():
            if st.pulls:
                weight[source] = weight.get(source, 0.0) + st.pulls
                total[source] = (
                    total.get(source, 0.0) + st.ms_per_block * st.pulls
                )
        queues: dict[int, int] = {}
        for wid, fpm in self._fleet_metrics().items():
            try:
                queues[wid] = int(fpm.worker.num_requests_waiting)
            except AttributeError:
                pass
            for src, st in (getattr(fpm, "net", None) or {}).items():
                src = int(src)
                pulls = st.get("pulls", 0)
                if pulls:
                    weight[src] = weight.get(src, 0.0) + pulls
                    total[src] = (
                        total.get(src, 0.0) + st["ms_per_block"] * pulls
                    )
        self._table = {s: total[s] / weight[s] for s in weight}
        self._queues = queues
        self._table_t = now
        return self._table

    def pull_ms_per_block(self, source: int) -> float:
        """Measured per-block cost of pulling FROM this source."""
        return self._fold().get(int(source), DEFAULT_PULL_MS_PER_BLOCK)

    def cost_ratio(self, source: int) -> float:
        """pull cost / recompute cost for this source, clamped to
        [0, MAX_COST_RATIO]. < 1 → pulling beats recomputing."""
        ratio = self.pull_ms_per_block(source) / max(
            self.recompute_ms_per_block, 1e-9
        )
        return min(MAX_COST_RATIO, max(0.0, ratio))

    def queue_depth(self, worker_id: int) -> int:
        self._fold()
        return self._queues.get(worker_id, 0)

    def snapshot(self) -> dict:
        """Debug/trace payload: per-source measured cost ratios."""
        return {
            s: {
                "ms_per_block": round(ms, 3),
                "cost_ratio": round(self.cost_ratio(s), 3),
            }
            for s, ms in sorted(self._fold().items())
        }


def best_pull_source(
    candidate: int,
    local_overlap: int,
    overlaps: dict[int, int],
    prompt_blocks: int,
    netcost: NetCostModel,
) -> tuple[int, int, float] | None:
    """The cheapest USEFUL source for a candidate worker: the peer whose
    extra cached blocks, discounted by its measured transfer-cost ratio,
    save the most recompute. Returns (source, extra_blocks, ratio) or
    None when no pull beats recomputing (every peer at ratio >= 1, or no
    peer holds more than the candidate). Ties break by lowest source id
    (deterministic, like best_peer_hint)."""
    best: tuple[float, int, int, float] | None = None  # (-benefit, id, extra, ratio)
    for peer, blocks in overlaps.items():
        if peer == candidate:
            continue
        extra = min(blocks, prompt_blocks) - local_overlap
        if extra <= 0:
            continue
        ratio = netcost.cost_ratio(peer)
        benefit = extra * (1.0 - ratio)
        if benefit <= 0:
            continue
        key = (-benefit, peer)
        if best is None or key < (best[0], best[1]):
            best = (-benefit, peer, extra, ratio)
    if best is None:
        return None
    return best[1], best[2], best[3]


class NetworkAwareSelector(DefaultWorkerSelector):
    """Overlap + measured-transfer-cost + queue-depth cost function.

    Implemented as DefaultWorkerSelector scoring hooks — the candidate
    loop lives once, in scheduler.py, so the overlap-only and
    network-aware modes cannot silently diverge."""

    def __init__(self, netcost: NetCostModel, rng: random.Random | None = None):
        super().__init__(rng)
        self.netcost = netcost

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
        src = best_pull_source(
            worker_id, overlap, overlaps, prompt_blocks, self.netcost
        )
        if src is not None:
            # Prefill the candidate avoids by pulling, discounted by
            # what the transfer measurably costs: a cheap source
            # (ratio→0) relieves nearly the whole pullable span, an
            # expensive one (ratio→1) relieves nothing.
            _, extra, ratio = src
            prefill_blocks -= min(extra, prefill_blocks) * (1.0 - ratio)
        cost = (
            config.overlap_weight * prefill_blocks
            + decode_blocks
            + config.queue_weight * self.netcost.queue_depth(worker_id)
        )
        return cost, src

    def _annotate(self, result: SelectionResult, note: object) -> SelectionResult:
        if note is not None:
            source, extra, _ratio = note
            result.pull_hint = (source, result.overlap_blocks + extra)
        return result
