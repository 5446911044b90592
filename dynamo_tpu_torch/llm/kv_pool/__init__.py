"""Cluster-wide prefix KV pool (ISSUE 11).

The port's copy of ``dynamo_tpu/llm/kv_pool/__init__.py``, held to it by
``tests/test_torch_copies.py``.

Three pieces turn the per-worker KV tiers (device allocator, host RAM,
crash-safe disk pool) into one CLUSTER resource:

- :mod:`global_index` — the tier-composing global block-hash index. Every
  worker publishes tier-tagged stored/removed events (device commits from
  the allocator, host/disk transitions from the offload engine); the
  index folds them into per-worker tier sets over a radix tree, so the
  router scores prefix overlap against the whole fleet's memory
  hierarchy, not one worker's HBM.
- :mod:`peer_client` — the worker→worker block pull. When routing lands a
  request on a worker with less of its prefix cached than some peer, the
  router's ``peer_prefix`` hint (rides ``PreprocessedRequest.
  kv_transfer_params``) lets the chosen worker stream the reusable blocks
  over the TCP dataplane — the same canonical packed int8+scales wire
  buffer every tier moves — instead of re-prefilling.
- Degradation: the pull path rides the dataplane's per-address circuit
  breakers and adds per-frame deadlines of its own, so a slow, severed,
  or dead peer degrades to LOCAL RECOMPUTE (always correct), never a
  stall. Failure counters export as ``kv_pool_*`` gauges.

Reference parity: the KVBM/NIXL distributed block manager (PAPER.md §L2,
`block_manager/distributed/leader.rs`) plus the KV-management survey's
"prefix cache as a cluster resource" direction (PAPERS.md).
"""

from dynamo_tpu_torch.llm.kv_pool.global_index import GlobalKvIndex
from dynamo_tpu_torch.llm.kv_pool.peer_client import PeerKvClient, PeerPullStats

__all__ = ["GlobalKvIndex", "PeerKvClient", "PeerPullStats"]
