"""Decode-side streaming handoff: pull committed chunks while prefill runs.

The port's copy of ``dynamo_tpu/llm/disagg_pool/handoff.py``, held to it by
``tests/test_torch_copies.py``.

One :class:`StreamingHandoff` per decode worker, one :meth:`run` per
remotely-prefilled request, raced against the reply wait: it follows the
request's chunk cursor (:mod:`.cursor`) and pulls each newly committed
window through :meth:`PeerKvClient.pull_held_window` — the existing
frame/total deadlines, circuit breakers, and chaos sever points all
apply per window. The FINAL window (sent once the cursor is final)
releases the prefill worker's hold server-side, so a fully streamed
handoff never touches the legacy pull path at all.

Failure at ANY point — cursor timeout, severed window, import refusal —
returns False: the caller runs the reply-gated legacy pull (which
re-imports idempotently; already-landed blocks are skipped by hash), and
failing that degrades to local recompute. Both are bit-identical by the
quantize-once packed-buffer contract.
"""

from __future__ import annotations

import asyncio
import logging
from dataclasses import dataclass

from dynamo_tpu_torch import knobs

log = logging.getLogger("dynamo_tpu.disagg_pool.handoff")


@dataclass
class HandoffStats:
    """disagg_* gauge payload (status_server.bind_disagg_gauges); one
    shape for the jax backend and the mocker mirror."""

    handoffs_started: int = 0
    handoffs_streamed: int = 0      # fully streamed, legacy pull skipped
    handoffs_fallback: int = 0      # degraded to the reply-gated pull
    chunks_pulled: int = 0
    early_chunks: int = 0           # pulled BEFORE the final cursor
    blocks_streamed: int = 0
    cursor_timeouts: int = 0

    def as_dict(self) -> dict:
        return {
            "handoffs_started": self.handoffs_started,
            "handoffs_streamed": self.handoffs_streamed,
            "handoffs_fallback": self.handoffs_fallback,
            "chunks_pulled": self.chunks_pulled,
            "early_chunks": self.early_chunks,
            "blocks_streamed": self.blocks_streamed,
            "cursor_timeouts": self.cursor_timeouts,
        }


class StreamingHandoff:
    def __init__(
        self,
        peer_kv,
        watcher,
        transfer_client,
        chunk_blocks: int | None = None,
        cursor_timeout_s: float | None = None,
    ):
        self.peer_kv = peer_kv
        self.watcher = watcher
        self.transfer_client = transfer_client
        self.chunk_blocks = max(1, (
            chunk_blocks
            if chunk_blocks is not None
            else knobs.get_int("DYN_DISAGG_CHUNK_BLOCKS")
        ))
        self.cursor_timeout_s = (
            cursor_timeout_s
            if cursor_timeout_s is not None
            else knobs.get_float("DYN_DISAGG_CURSOR_TIMEOUT_S")
        )
        self.stats = HandoffStats()

    async def run(self, request_id: str) -> bool:
        """Stream the request's committed KV as the cursor advances.
        Returns True only when EVERYTHING landed and the final window
        released the hold — the caller may then skip the legacy pull.
        Never raises: any failure logs, counts, and returns False."""
        st = self.stats
        st.handoffs_started += 1
        pulled = 0
        try:
            while True:
                worker, committed, done = await self.watcher.wait_advance(
                    request_id, pulled, self.cursor_timeout_s
                )
                if committed < pulled:
                    # Cursor regressed: the prefill was preempted and is
                    # re-committing. Already-pulled windows re-match by
                    # hash (identical content), so just wait for the
                    # cursor to pass our high-water mark again.
                    continue
                while pulled < committed or (done and pulled == committed):
                    n = min(self.chunk_blocks, committed - pulled)
                    final = done and pulled + n >= committed
                    await self.peer_kv.pull_held_window(
                        self.transfer_client, worker, request_id,
                        pulled, n, final=final,
                    )
                    st.chunks_pulled += 1
                    if not done:
                        st.early_chunks += 1
                    st.blocks_streamed += n
                    pulled += n
                    if final:
                        st.handoffs_streamed += 1
                        return True
        except asyncio.TimeoutError:
            st.cursor_timeouts += 1
            st.handoffs_fallback += 1
            log.debug(
                "no cursor advance for %s within %.1fs; using the "
                "reply-gated pull", request_id, self.cursor_timeout_s,
            )
            return False
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001 — the legacy pull/recompute is always correct
            st.handoffs_fallback += 1
            log.warning(
                "streaming handoff for %s failed mid-window; degrading "
                "to the reply-gated pull", request_id, exc_info=True,
            )
            return False
        finally:
            self.watcher.forget(request_id)
