"""Router replica synchronization: N frontends, one coherent view.

The port's copy of ``dynamo_tpu/llm/kv_router/replica_sync.py``, held to it by
``tests/test_torch_copies.py``.

Two routers serving the same component would otherwise route blind to
each other's in-flight load (the radix trees converge automatically —
worker KV events broadcast to every subscriber — but ActiveSequences is
router-local state). Parity: reference ActiveSequencesMultiWorker +
replica-sync subjects (`lib/llm/src/kv_router/sequence.rs:225`,
`kv_router.rs:58-65`) and the late-joiner radix bootstrap
(`indexer.rs:445` dump_tree_as_events).

Mechanics, all over the store's pub/sub plane (msgpack payloads):

- **Active-sequence deltas**: every routing decision / prefill-done /
  free publishes a delta tagged with the origin router id; replicas apply
  deltas whose origin is not their own.
- **Bootstrap**: a starting router publishes a state request with a
  unique reply subject; any established replica answers with its radix
  dump (per-worker stored events) plus an active-sequence snapshot.
  Radix events are idempotent, so multiple replies are safe.
"""

from __future__ import annotations

import asyncio
import logging
import uuid
from typing import TYPE_CHECKING

import msgpack

from dynamo_tpu_torch.runtime.tasks import spawn_logged

if TYPE_CHECKING:  # pragma: no cover
    from dynamo_tpu_torch.llm.kv_router.router import KvRouter

log = logging.getLogger("dynamo_tpu.kv_router.sync")


def sync_subject(namespace: str, component: str) -> str:
    return f"kv_router_sync:{namespace}:{component}"


def bootstrap_subject(namespace: str, component: str) -> str:
    return f"kv_router_bootstrap:{namespace}:{component}"


class ReplicaSync:
    def __init__(self, store, namespace: str, component: str, router: "KvRouter"):
        self.store = store
        self.router = router
        self.router_id = uuid.uuid4().hex
        self._delta_subject = sync_subject(namespace, component)
        self._boot_subject = bootstrap_subject(namespace, component)
        self._tasks: list[asyncio.Task] = []
        self._subs: list = []

    # -- lifecycle ---------------------------------------------------------

    async def start(self, bootstrap_timeout: float = 0.5) -> None:
        delta_sub = await self.store.subscribe(self._delta_subject)
        boot_sub = await self.store.subscribe(self._boot_subject)
        self._subs = [delta_sub, boot_sub]
        # spawn_logged: if a loop dies on an unexpected message shape the
        # failure is logged immediately, not discovered via a frozen
        # replica view (the handles still go in _tasks for stop()).
        self._tasks = [
            spawn_logged(self._delta_loop(delta_sub),
                         name="replica-sync-delta-loop", logger=log),
            spawn_logged(self._bootstrap_serve_loop(boot_sub),
                         name="replica-sync-bootstrap-loop", logger=log),
        ]
        await self._bootstrap(bootstrap_timeout)

    async def stop(self) -> None:
        for t in self._tasks:
            t.cancel()
        for s in self._subs:
            try:
                await s.unsubscribe()
            except Exception:  # noqa: BLE001 — store may already be gone
                log.debug("unsubscribe failed during stop", exc_info=True)

    # -- delta publication (called by KvRouter on every decision) ----------

    def publish_add(
        self, request_id: str, worker_id: int, prompt_tokens: int, overlap_blocks: int
    ) -> None:
        self._publish(
            {
                "op": "add",
                "rid": request_id,
                "w": worker_id,
                "n": prompt_tokens,
                "o": overlap_blocks,
            }
        )

    def publish_prefill_done(self, request_id: str) -> None:
        self._publish({"op": "prefill_done", "rid": request_id})

    def publish_free(self, request_id: str) -> None:
        self._publish({"op": "free", "rid": request_id})

    def _publish(self, delta: dict) -> None:
        delta["origin"] = self.router_id
        payload = msgpack.packb(delta, use_bin_type=True)

        async def _send() -> None:
            try:
                await self.store.publish(self._delta_subject, payload)
            except Exception:  # noqa: BLE001 — sync is best-effort
                log.warning("replica-sync publish failed", exc_info=True)

        spawn_logged(_send(), name="replica-sync-publish", logger=log)

    # -- delta application -------------------------------------------------

    async def _delta_loop(self, sub) -> None:
        async for msg in sub:
            try:
                d = msgpack.unpackb(msg["p"], raw=False)
            except (TypeError, ValueError, msgpack.UnpackException):
                log.warning("dropping malformed replica-sync delta")
                continue
            if not isinstance(d, dict):
                log.warning("dropping non-dict replica-sync delta %r", d)
                continue
            if d.get("origin") == self.router_id:
                continue
            try:
                self._apply(d)
            except Exception:  # noqa: BLE001 — one bad delta must not kill sync
                log.warning("dropping unapplicable replica-sync delta %r",
                            d, exc_info=True)

    def _apply(self, d: dict) -> None:
        active = self.router.active
        op = d.get("op")
        if op == "add":
            active.add_request(d["rid"], d["w"], d["n"], d["o"])
        elif op == "prefill_done":
            active.mark_prefill_done(d["rid"])
        elif op == "free":
            active.free(d["rid"])

    # -- bootstrap ---------------------------------------------------------

    def _snapshot(self) -> bytes:
        """Radix dump + active sequences, for a late-joining replica."""
        tree = self.router.indexer_tree()
        radix = []
        if tree is not None:
            for w in self.router.known_workers():
                for ev in tree.dump_as_events(w):
                    radix.append(ev.to_wire())
        active = [
            {
                "rid": rid,
                "w": seq.worker_id,
                "pf": seq.prefill_tokens,
                "db": seq.decode_blocks,
            }
            for rid, seq in self.router.active.items()
        ]
        return msgpack.packb({"radix": radix, "active": active}, use_bin_type=True)

    async def _bootstrap_serve_loop(self, sub) -> None:
        async for msg in sub:
            try:
                req = msgpack.unpackb(msg["p"], raw=False)
            except (TypeError, ValueError, msgpack.UnpackException):
                log.warning("dropping malformed bootstrap request")
                continue
            if not isinstance(req, dict):
                log.warning("dropping non-dict bootstrap request %r", req)
                continue
            if req.get("origin") == self.router_id:
                continue
            try:
                await self.store.publish(req["reply"], self._snapshot())
            except Exception:  # noqa: BLE001
                log.warning("bootstrap reply failed", exc_info=True)

    async def _bootstrap(self, timeout: float) -> None:
        from dynamo_tpu_torch.llm.kv_router.protocols import RouterEvent

        reply = f"kv_router_bootstrap_rep:{self.router_id}"
        rep_sub = await self.store.subscribe(reply)
        try:
            await self.store.publish(
                self._boot_subject,
                msgpack.packb(
                    {"origin": self.router_id, "reply": reply}, use_bin_type=True
                ),
            )
            try:
                msg = await rep_sub.get(timeout=timeout)
            except (asyncio.TimeoutError, TimeoutError):
                return  # first replica up: nothing to inherit
            snap = msgpack.unpackb(msg["p"], raw=False)
            for raw in snap.get("radix", []):
                self.router.apply_radix_event(RouterEvent.from_wire(raw))
            for e in snap.get("active", []):
                self.router.active.add_raw(e["rid"], e["w"], e["pf"], e["db"])
            log.info(
                "replica bootstrap: %d radix events, %d active sequences",
                len(snap.get("radix", [])),
                len(snap.get("active", [])),
            )
        finally:
            await rep_sub.unsubscribe()
