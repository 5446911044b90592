"""Worker→worker KV block pull: the cluster pool's transfer path.

The port's copy of ``dynamo_tpu/llm/kv_pool/peer_client.py``, held to it by
``tests/test_torch_copies.py``.

``PeerKvClient.pull_prefix`` streams the reusable prefix blocks of a
request from the peer the router hinted at (``kv_transfer_params.
peer_prefix``) into the local cache, through ``EngineCore.import_blocks``
— the same packed-buffer path disagg transfers and host-tier onboarding
use, so pulled bytes are bit-identical to local recompute by
construction (quantize-once, PR 8).

Degradation contract (the part chaos tests pin):

- The dial rides the dataplane ``EgressClient`` — per-address circuit
  breakers and connect deadlines apply before a single byte moves; an
  OPEN breaker fails the pull in microseconds (``breaker_fast_fails``).
- Every frame wait is bounded by ``frame_timeout_s`` and the whole pull
  by ``total_timeout_s`` (env: ``DYN_KV_POOL_FRAME_TIMEOUT_S`` /
  ``DYN_KV_POOL_PULL_TIMEOUT_S``) — a peer that stalls mid-stream costs
  at most one frame budget, not a wedged request.
- ANY failure — sever, stall, dtype mismatch, dead peer — falls back to
  local recompute, which is always correct (the pull is a latency
  optimization, never a correctness dependency). Already-imported blocks
  from a partial pull still prefix-hit.

Counters surface as ``kv_pool_*`` gauges (status_server.
bind_kv_pool_gauges) on both backends.
"""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass, field

from dynamo_tpu_torch import knobs
from dynamo_tpu_torch.runtime import chaos, wire
from dynamo_tpu_torch.runtime.dataplane import BreakerOpenError
from dynamo_tpu_torch.tokens import compute_seq_hashes

log = logging.getLogger("dynamo_tpu.kv_pool.peer")


# EWMA weight for per-peer cost samples: heavy enough that a peer
# turning slow is noticed within a few pulls, light enough that one
# outlier frame doesn't condemn a healthy peer.
NET_EWMA_ALPHA = 0.3


@dataclass
class PeerPullStats:
    """Shared counter shape for the jax client and the mocker mirror
    (identical /metrics series on both backends)."""

    pulls_attempted: int = 0
    pulls_succeeded: int = 0
    pulls_fallback: int = 0
    blocks_pulled: int = 0
    bytes_pulled: int = 0
    pull_ms_total: float = 0.0
    last_pull_ms: float = 0.0
    breaker_fast_fails: int = 0
    dtype_mismatches: int = 0
    # Per-peer MEASURED transfer cost (NetKV, ISSUE 14): worker_id of the
    # pull source -> {"pulls", "failures", "blocks", "ms_per_block"}
    # where ms_per_block is an EWMA of observed per-block pull latency.
    # Published in ForwardPassMetrics.net so routers can weigh decode
    # placement and peer-prefix hints by what transfers actually cost,
    # per address, instead of assuming the network is uniform.
    per_peer: dict[int, dict] = field(default_factory=dict)

    def note_pull(
        self, peer_id: int, blocks: int, elapsed_ms: float, ok: bool
    ) -> None:
        """Fold one pull outcome into the peer's measured cost. A failed
        pull charges its whole elapsed wall-clock as if it moved one
        block — a stalled/severed peer's EWMA absorbs the frame-timeout
        budget it burned, which is exactly the cost routing should avoid."""
        st = self.per_peer.setdefault(
            int(peer_id),
            {"pulls": 0, "failures": 0, "blocks": 0, "ms_per_block": 0.0},
        )
        st["pulls"] += 1
        if ok:
            st["blocks"] += blocks
            sample = elapsed_ms / max(1, blocks)
        else:
            st["failures"] += 1
            sample = elapsed_ms
        prev = st["ms_per_block"]
        st["ms_per_block"] = (
            sample
            if st["pulls"] == 1
            else (1 - NET_EWMA_ALPHA) * prev + NET_EWMA_ALPHA * sample
        )

    def net_dict(self) -> dict[int, dict]:
        """Wire shape for ForwardPassMetrics.net (value copies — the
        publisher must not race live mutation)."""
        return {p: dict(st) for p, st in self.per_peer.items()}

    def as_dict(self) -> dict:
        return {
            "pulls_attempted": self.pulls_attempted,
            "pulls_succeeded": self.pulls_succeeded,
            "pulls_fallback": self.pulls_fallback,
            "blocks_pulled": self.blocks_pulled,
            "bytes_pulled": self.bytes_pulled,
            "pull_ms_total": round(self.pull_ms_total, 3),
            "last_pull_ms": round(self.last_pull_ms, 3),
            "breaker_fast_fails": self.breaker_fast_fails,
            "dtype_mismatches": self.dtype_mismatches,
        }


class PeerKvClient:
    def __init__(
        self,
        core,
        fetch_client,
        frame_timeout_s: float | None = None,
        total_timeout_s: float | None = None,
        chunk_blocks: int = 32,
    ):
        self.core = core
        self.fetch_client = fetch_client
        self.frame_timeout_s = (
            frame_timeout_s
            if frame_timeout_s is not None
            else knobs.get_float("DYN_KV_POOL_FRAME_TIMEOUT_S")
        )
        self.total_timeout_s = (
            total_timeout_s
            if total_timeout_s is not None
            else knobs.get_float("DYN_KV_POOL_PULL_TIMEOUT_S")
        )
        self.chunk_blocks = chunk_blocks
        self.stats = PeerPullStats()
        # Publish this worker's measured per-peer pull costs through the
        # engine's ForwardPassMetrics (the network-aware router's feed).
        core.net_stats_source = self.stats.net_dict

    async def pull_prefix(self, hint: dict, token_ids: list[int]) -> int:
        """Pull the peer's cached prefix of ``token_ids`` that this worker
        is missing; returns blocks imported. Best-effort by contract —
        every failure path logs, counts, and returns what landed so the
        caller proceeds to (partial) local recompute."""
        core = self.core
        bs = core.engine.block_size
        hashes = compute_seq_hashes(token_ids, bs)
        cached = await asyncio.to_thread(core.cached_prefix_tokens, token_ids)
        start = cached // bs
        want = hashes[start:]
        if not want:
            return 0
        st = self.stats
        st.pulls_attempted += 1
        t0 = time.monotonic()
        deadline = t0 + self.total_timeout_s
        # Defaults overridden by the server's geometry frame (a peer on a
        # different float precision reports its own dtype; import_blocks
        # casts floats — an int8-vs-float mismatch fails the import FAST
        # per the PR 8 contract and the pull degrades to recompute).
        shape = [
            core.cfg.num_layers, bs, 2 * core.cfg.num_kv_heads, core.cfg.head_dim,
        ]
        dtype = core.kv_wire_dtype
        imported = 0
        ok = False
        try:
            if chaos.active():
                await chaos.inject("kv_transfer.pull", str(hint.get("worker_id")))
            stream = await self.fetch_client.direct(
                hint["worker_id"],
                {wire.KV_HASHES: want, wire.KV_CHUNK_BLOCKS: self.chunk_blocks},
            )
            while True:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise asyncio.TimeoutError(
                        f"peer pull exceeded {self.total_timeout_s:.1f}s"
                    )
                try:
                    frame = await asyncio.wait_for(
                        stream.__anext__(),
                        min(self.frame_timeout_s, remaining),
                    )
                except StopAsyncIteration:
                    break
                if wire.KV_SHAPE in frame:
                    shape = list(frame[wire.KV_SHAPE])
                    dtype = frame[wire.KV_DTYPE]
                if wire.KV_DONE in frame:
                    break  # trailer: the peer sent everything it holds
                if wire.KV_PAGES not in frame:
                    continue
                s = frame[wire.KV_START]
                blocks = []
                for j, kv in enumerate(frame[wire.KV_PAGES]):
                    gi = start + s + j
                    blocks.append({
                        wire.IMP_HASH: hashes[gi],
                        wire.IMP_PARENT: hashes[gi - 1] if gi > 0 else None,
                        wire.IMP_SHAPE: shape,
                        wire.IMP_DTYPE: dtype,
                        wire.IMP_KV: kv,
                    })
                    st.bytes_pulled += len(kv)
                res = await asyncio.to_thread(core.import_blocks, blocks)
                imported += res.imported
            ok = True
        except BreakerOpenError:
            # The breaker already knows this peer is bad: fail in
            # microseconds, recompute locally, let the half-open probe
            # decide when pulls resume.
            st.breaker_fast_fails += 1
            log.info(
                "peer pull from worker %s skipped: circuit breaker open",
                hint.get("worker_id"),
            )
        except ValueError as e:
            # import_blocks' fail-fast contract (dtype/geometry mismatch):
            # re-quantizing or resegmenting would break bit-stability, so
            # a mixed-dtype fleet pull degrades to recompute immediately.
            st.dtype_mismatches += 1
            log.warning(
                "peer pull from worker %s refused by import contract: %s",
                hint.get("worker_id"), e,
            )
        except Exception:  # noqa: BLE001 — recompute is always correct
            log.warning(
                "peer prefix pull from worker %s failed; recomputing locally",
                hint.get("worker_id"), exc_info=True,
            )
        elapsed_ms = (time.monotonic() - t0) * 1e3
        st.pull_ms_total += elapsed_ms
        st.last_pull_ms = elapsed_ms
        st.blocks_pulled += imported
        peer = hint.get("worker_id")
        if peer is not None:
            # Per-peer measured cost (NetKV): success charges elapsed /
            # blocks, failure charges the whole elapsed budget — the
            # router's network-aware scoring reads this via
            # ForwardPassMetrics.net.
            st.note_pull(int(peer), imported, elapsed_ms, ok)
        if ok:
            st.pulls_succeeded += 1
            log.debug(
                "pulled %d prefix blocks from peer worker %s in %.1f ms",
                imported, hint.get("worker_id"), elapsed_ms,
            )
        else:
            st.pulls_fallback += 1
        return imported

    async def pull_held_window(
        self,
        transfer_client,
        worker_id: int,
        request_id: str,
        start: int,
        count: int,
        final: bool = False,
    ) -> int:
        """Pull ONE committed window ``[start, start+count)`` of a held or
        still-running prefill through the ``kv_transfer`` endpoint (the
        streaming-handoff data path, ISSUE 17); returns blocks imported.

        Same protections as :meth:`pull_prefix` — dataplane breakers on
        the dial, per-frame and whole-window deadlines, chaos sever point
        — but failures RAISE instead of swallowing: the streaming handoff
        must abort the stream and degrade to the reply-gated pull, not
        silently continue with a hole. ``final`` releases the server-side
        hold after the window (sent exactly once, on the last window of a
        finished prefill)."""
        st = self.stats
        st.pulls_attempted += 1
        t0 = time.monotonic()
        deadline = t0 + self.total_timeout_s
        imported = 0
        ok = False
        try:
            if chaos.active():
                await chaos.inject("kv_transfer.pull", str(worker_id))
            stream = await transfer_client.direct(
                worker_id,
                {
                    wire.KV_REQUEST_ID: request_id,
                    wire.KV_WINDOW_START: start,
                    wire.KV_WINDOW_COUNT: count,
                    wire.KV_WINDOW_FINAL: final,
                    wire.KV_CHUNK_BLOCKS: self.chunk_blocks,
                },
            )
            descs: list[dict] | None = None
            received = 0
            while True:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise asyncio.TimeoutError(
                        f"handoff window exceeded {self.total_timeout_s:.1f}s"
                    )
                try:
                    frame = await asyncio.wait_for(
                        stream.__anext__(),
                        min(self.frame_timeout_s, remaining),
                    )
                except StopAsyncIteration:
                    break
                if wire.KV_ERROR in frame:
                    # The hold is gone (released, swept, or preempted):
                    # the stream is over, the caller falls back.
                    raise ConnectionError(
                        f"handoff window refused: {frame[wire.KV_ERROR]}"
                    )
                ver = frame.get(wire.KV_VERSION)
                if ver != 2:
                    raise ConnectionError(
                        f"unsupported KV transfer wire version {ver!r}"
                    )
                if wire.KV_BLOCKS in frame:
                    descs = frame[wire.KV_BLOCKS]
                    if len(descs) < count:
                        # The server's committed prefix is SHORTER than
                        # the cursor advertised (preempted prefill re-
                        # committing): advancing past it would leave a
                        # hole, so abort and let the caller fall back.
                        raise ConnectionError(
                            f"handoff window short: {len(descs)}/{count} "
                            "blocks committed server-side"
                        )
                    continue
                if descs is None:
                    raise ConnectionError(
                        "handoff data frame before descriptors"
                    )
                s = frame[wire.KV_START]
                batch = [
                    {**descs[s + j], wire.IMP_KV: kv}
                    for j, kv in enumerate(frame[wire.KV_PAGES])
                ]
                for b in batch:
                    st.bytes_pulled += len(b[wire.IMP_KV])
                received += len(batch)
                res = await asyncio.to_thread(self.core.import_blocks, batch)
                imported += res.imported
            if descs is None or received < len(descs):
                # The server died mid-window AFTER descriptors (its
                # stream just ends): a short window must not pass for a
                # complete one, or the handoff would continue with a
                # hole in the prefix.
                raise ConnectionError(
                    f"handoff window truncated: {received}/"
                    f"{len(descs or [])} pages"
                )
            ok = True
            return imported
        finally:
            elapsed_ms = (time.monotonic() - t0) * 1e3
            st.pull_ms_total += elapsed_ms
            st.last_pull_ms = elapsed_ms
            st.blocks_pulled += imported
            # Window pulls feed the same per-peer NetKV cost EWMAs as
            # prefix pulls — the router's decode-placement scoring should
            # price the links the handoff actually uses.
            st.note_pull(int(worker_id), imported, elapsed_ms, ok)
            if ok:
                st.pulls_succeeded += 1
            else:
                st.pulls_fallback += 1

    def pool_stats(self) -> dict:
        """kv_pool_* gauge payload for this worker's pull side."""
        return self.stats.as_dict()
