"""Model discovery: workers announce models, frontends react.

The port's copy of ``dynamo_tpu/llm/discovery.py``, held to it by
``tests/test_torch_copies.py``.

A worker serving a model writes a :class:`ModelEntry` into the control-plane
KV under its lease (key: ``/dynamo/models/{name}/{instance_id}``); the entry
points at the serving endpoint and the MDC checksum. Frontends run a
:class:`ModelWatcher` over the prefix and add/remove models from their
:class:`ModelManager` as workers come and go — including pulling the MDC
from the object store on first sight.

Capability parity: reference `lib/llm/src/discovery/{model_entry.rs:22,
watcher.rs:41-46, model_manager.rs}` and the `register_llm` flow
(`lib/bindings/python/rust/lib.rs:143`).
"""

from __future__ import annotations

import asyncio
import logging
from dataclasses import dataclass
from typing import Awaitable, Callable

import msgpack

from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.runtime import wire
from dynamo_tpu_torch.runtime.component import Endpoint, discovery_stale_grace
from dynamo_tpu_torch.runtime.store import StoreClient, Subscription

log = logging.getLogger("dynamo_tpu.llm.discovery")

MODEL_ROOT = "/dynamo/models"


@dataclass(frozen=True)
class ModelEntry:
    name: str
    namespace: str
    component: str
    endpoint: str
    instance_id: int
    mdc_checksum: str

    @property
    def endpoint_path(self) -> str:
        return f"{self.namespace}/{self.component}/{self.endpoint}"

    def to_wire(self) -> bytes:
        return msgpack.packb(
            {
                "name": self.name,
                "ns": self.namespace,
                "comp": self.component,
                "ep": self.endpoint,
                "id": self.instance_id,
                "mdc": self.mdc_checksum,
            }
        )

    @classmethod
    def from_wire(cls, raw: bytes) -> "ModelEntry":
        d = msgpack.unpackb(raw, raw=False)
        return cls(
            name=d["name"],
            namespace=d["ns"],
            component=d["comp"],
            endpoint=d["ep"],
            instance_id=d["id"],
            mdc_checksum=d["mdc"],
        )


async def register_llm(
    endpoint: Endpoint,
    mdc: ModelDeploymentCard,
    instance_id: int | None = None,
) -> ModelEntry:
    """Publish the MDC + model entry for an endpoint already being served."""
    runtime = endpoint.runtime
    checksum = await mdc.publish(runtime.store)
    entry = ModelEntry(
        name=mdc.name,
        namespace=endpoint.namespace,
        component=endpoint.component,
        endpoint=endpoint.name,
        instance_id=instance_id if instance_id is not None else runtime.primary_lease_id,
        mdc_checksum=checksum,
    )
    await runtime.store.kv_put(
        f"{MODEL_ROOT}/{mdc.name}/{entry.instance_id:016x}",
        entry.to_wire(),
        lease=runtime.primary_lease_id,
    )
    log.info("registered model %r → %s (mdc %s)", mdc.name, entry.endpoint_path, checksum)
    return entry


class ModelWatcher:
    """Watches MODEL_ROOT; fires add/remove callbacks with entry + card.

    A model is *added* on its first live instance and *removed* when its
    last instance disappears (frontends keep serving while any worker
    remains, parity watcher.rs prune semantics).

    Degraded mode (ISSUE 15): when ``data_plane_live`` is wired (the
    ModelManager points it at the model's EndpointClient instance cache)
    and ``stale_grace_s > 0``, a last-instance LEASE-EXPIRY delete whose
    data plane still answers defers the remove for the grace window — a
    worker that merely lost its store session re-registers within a TTL
    of the store's recovery and the frontend never flaps the model.
    Explicit deregistrations (graceful drain) are never deferred.
    """

    def __init__(
        self,
        store: StoreClient,
        stale_grace_s: float | None = None,
        data_plane_live: Callable[[str], bool] | None = None,
    ):
        self._store = store
        self._instances: dict[str, ModelEntry] = {}  # key → entry
        self._counts: dict[str, int] = {}  # model name → live instances
        self.on_model_added: list[
            Callable[[ModelEntry, ModelDeploymentCard], Awaitable[None]]
        ] = []
        self.on_model_removed: list[Callable[[str], Awaitable[None]]] = []
        self._task: asyncio.Task | None = None
        self._watch: Subscription | None = None
        # Deferred last-instance removals: model name -> monotonic
        # deadline. Loop-affine (watch loop + sweep task, one event loop).
        self.stale_grace_s = (
            discovery_stale_grace() if stale_grace_s is None else stale_grace_s
        )
        self.data_plane_live = data_plane_live
        self._deferred: dict[str, float] = {}
        self._defer_task: asyncio.Task | None = None
        self.deferred_removals_total = 0
        self.flaps_avoided_total = 0

    async def start(self) -> None:
        self._watch = await self._store.kv_watch(MODEL_ROOT + "/")
        self._task = asyncio.create_task(self._loop())
        self._store.on_reconnect.append(self._reconcile)

    async def stop(self) -> None:
        """Idempotent; awaits task cancellation so no watcher coroutine
        outlives the stop (the pre-ISSUE-15 stop fired cancel and
        returned, leaving the task to die during teardown)."""
        try:
            self._store.on_reconnect.remove(self._reconcile)
        except ValueError:
            pass
        tasks = [t for t in (self._task, self._defer_task) if t is not None]
        self._task = self._defer_task = None
        for t in tasks:
            t.cancel()
        for t in tasks:
            try:
                await t
            except asyncio.CancelledError:
                pass
            except Exception:  # noqa: BLE001 — teardown must not raise
                log.exception("model watcher task failed during stop")
        watch, self._watch = self._watch, None
        if watch:
            await watch.unsubscribe()

    async def _loop(self) -> None:
        assert self._watch is not None
        async for ev in self._watch:
            event = StoreClient.as_watch_event(ev)
            try:
                if event.type == wire.EV_PUT:
                    await self._on_put(event)
                else:
                    await self._on_delete(event)
            except Exception:  # noqa: BLE001 — a bad entry must not kill the watcher
                log.exception("model watcher event failed: %s", event.key)

    async def _on_put(self, event) -> None:
        entry = ModelEntry.from_wire(event.value)
        known = event.key in self._instances
        self._instances[event.key] = entry
        if known:
            # Session-rebuild replay (or an entry refresh) — counts must
            # not double, add callbacks must not re-fire.
            return
        self._counts[entry.name] = self._counts.get(entry.name, 0) + 1
        if self._deferred.pop(entry.name, None) is not None:
            # Re-registered within the grace window: the remove never
            # fired, so the manager never tore down — zero flap.
            self.flaps_avoided_total += 1
            log.info(
                "model %r re-registered within grace; removal cancelled",
                entry.name,
            )
            return
        if self._counts[entry.name] == 1:
            mdc = await ModelDeploymentCard.fetch(self._store, entry.mdc_checksum)
            for cb in self.on_model_added:
                await cb(entry, mdc)

    async def _on_delete(self, event) -> None:
        entry = self._instances.pop(event.key, None)
        if entry is None:
            return
        count = self._counts.get(entry.name, 0)
        if count <= 0:
            # Duplicate/late delete racing a removal already processed:
            # underflowing the count here would make the NEXT put of this
            # model invisible (0 -> 1 transition never seen again).
            log.warning(
                "duplicate delete for model %r (count already %d); skipping",
                entry.name, count,
            )
            self._counts.pop(entry.name, None)
            return
        self._counts[entry.name] = count - 1
        if self._counts[entry.name] > 0:
            return
        del self._counts[entry.name]
        if (
            event.reason == "lease"
            and self.stale_grace_s > 0
            and self.data_plane_live is not None
            and self.data_plane_live(entry.name)
        ):
            self._deferred[entry.name] = (
                asyncio.get_running_loop().time() + self.stale_grace_s
            )
            self.deferred_removals_total += 1
            log.warning(
                "model %r lost its last lease but its data plane answers; "
                "deferring removal %.1fs", entry.name, self.stale_grace_s,
            )
            self._ensure_defer_sweep()
            return
        await self._fire_removed(entry.name)

    async def _fire_removed(self, name: str) -> None:
        for cb in self.on_model_removed:
            await cb(name)

    def _ensure_defer_sweep(self) -> None:
        if self._defer_task is None or self._defer_task.done():
            self._defer_task = asyncio.create_task(self._sweep_deferred())

    async def _sweep_deferred(self) -> None:
        loop = asyncio.get_running_loop()
        while self._deferred:
            due = min(self._deferred.values())
            await asyncio.sleep(max(0.05, due - loop.time()))
            now = loop.time()
            for name, deadline in list(self._deferred.items()):
                if deadline > now:
                    continue
                self._deferred.pop(name, None)
                if name in self._counts:
                    continue  # an instance came back through a fresh key
                if self.data_plane_live is not None and self.data_plane_live(name):
                    # Still answering on the data plane: keep deferring —
                    # during an outage the data plane IS the authority.
                    self._deferred[name] = now + self.stale_grace_s
                    continue
                log.warning(
                    "deferred removal of model %r firing (grace expired, "
                    "data plane dark)", name,
                )
                try:
                    await self._fire_removed(name)
                except Exception:  # noqa: BLE001 — one bad callback must not kill the sweep
                    log.exception("deferred model removal failed: %s", name)

    async def _reconcile(self) -> None:
        """Post-reconnect anti-entropy: keys that vanished during the
        outage produced no delete event (the session replay only re-puts
        current state) — synthesize lease-reason deletes for them so the
        same degraded-mode judgment applies."""
        listed = await self._store.kv_get_prefix(MODEL_ROOT + "/")
        for key in [k for k in self._instances if k not in listed]:
            await self._on_delete(
                StoreClient.as_watch_event(
                    {"t": "delete", "k": key, "v": b"", "rev": 0, "r": "lease"}
                )
            )
