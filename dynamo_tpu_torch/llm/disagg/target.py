"""Cost-chosen decode target for a disaggregated handoff.

The port's copy of ``dynamo_tpu/llm/disagg/target.py``, held to it by
``tests/test_torch_copies.py``.

Once the remote-prefill decision is made, SOMEBODY must pick where the
KV lands. The aggregated router already prices cross-worker pulls
(:class:`~dynamo_tpu.llm.kv_router.netcost.NetCostModel`, NetKV shape);
this module reuses those prices for the disagg direction: given the
prefill source and the candidate decode workers, pick the decode target
whose transfer-plus-queue cost is lowest. The same scoring runs in the
fleet harness's disagg topology, so the A/B exercises the production
chooser, not a sim-only stand-in.
"""

from __future__ import annotations

from typing import Callable, Iterable

# Queue-depth penalty, ms of equivalent transfer per queued request.
# Matches the spirit of RouterConfig.queue_weight: a deep decode queue
# costs real TTFT just like a slow link does.
DEFAULT_QUEUE_MS = 5.0


def choose_decode_target(
    candidates: Iterable[int],
    blocks: int,
    pull_ms_per_block: Callable[[int], float],
    queue_depth: Callable[[int], float] | None = None,
    queue_ms: float = DEFAULT_QUEUE_MS,
) -> int | None:
    """The decode worker that minimizes handoff cost.

    ``pull_ms_per_block(wid)`` prices moving one KV block from the
    prefill source into ``wid`` (callers derive it from each candidate's
    ``NetCostModel.pull_ms_per_block`` view of the source — or, fleet
    side, from the harness's per-source link prices). ``queue_depth``
    adds the candidate's backlog. Deterministic tie-break on worker id
    so both A/B arms and reruns pick identically."""
    best_wid: int | None = None
    best_cost = float("inf")
    for wid in candidates:
        cost = float(blocks) * float(pull_ms_per_block(wid))
        if queue_depth is not None:
            cost += queue_ms * float(queue_depth(wid))
        if cost < best_cost or (cost == best_cost and (
            best_wid is None or wid < best_wid
        )):
            best_cost = cost
            best_wid = wid
    return best_wid
