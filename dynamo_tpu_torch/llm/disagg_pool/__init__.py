"""Streaming disaggregation: chunk-pipelined KV handoff.

The port's copy of ``dynamo_tpu/llm/disagg_pool/__init__.py``, held to it by
``tests/test_torch_copies.py``.

Replaces pull-after-prefill with transfer/compute overlap: the prefill
worker advertises committed chunks as they land (``cursor`` — a
per-request chunk cursor on the control-plane event bus), and the decode
worker's :class:`StreamingHandoff` pulls the packed KV buffer
chunk-by-chunk through the ``kv_transfer`` endpoint *while prefill is
still chunking*, so by the final commit only the tail remains in flight.

Degradation contract: a sever/stall/kill at ANY chunk boundary degrades
to the legacy reply-gated pull, and failing that to local recompute —
bit-identically (quantize-once packed buffers).
"""

from dynamo_tpu_torch.llm.disagg_pool.cursor import (  # noqa: F401
    ChunkCursorPublisher,
    ChunkCursorWatcher,
    disagg_cursor_subject,
)
from dynamo_tpu_torch.llm.disagg_pool.handoff import (  # noqa: F401
    HandoffStats,
    StreamingHandoff,
)
