"""Component model: Namespace → Component → Endpoint → Instance.

The port's copy of ``dynamo_tpu/runtime/component.py``, held to it by
``tests/test_torch_copies.py``.

Every deployable process attaches to the distributed runtime, carves out
endpoints under a namespace/component path, serves them on its ingress
server, and registers each endpoint instance in the control-plane KV under
its primary lease — so instances vanish from discovery the moment the
process dies.

Addressing scheme: ``dynamo://{namespace}/{component}/{endpoint}`` with
instances at ``/dynamo/instances/{ns}/{component}/{endpoint}/{instance_id}``.

Capability parity: reference `lib/runtime/src/component.rs:98-520`
(Component/Endpoint/Namespace/Instance, ETCD_ROOT_PATH scheme),
`distributed.rs:53` (DistributedRuntime), `pipeline/network/egress/
push_router.rs:30-179` (round_robin/random/direct routing modes).
"""

from __future__ import annotations

import asyncio
import logging
import os
import random as _random
import time
from dataclasses import dataclass
from typing import Any, AsyncIterator, Callable

import msgpack

from dynamo_tpu_torch import knobs
from dynamo_tpu_torch.runtime import wire
from dynamo_tpu_torch.runtime.dataplane import EgressClient, Handler, IngressServer, ResponseStream
from dynamo_tpu_torch.runtime.store import StoreClient, Subscription
from dynamo_tpu_torch.runtime.store.client import StoreError
from dynamo_tpu_torch.runtime.tasks import spawn_logged

log = logging.getLogger("dynamo_tpu.runtime")

INSTANCE_ROOT = "/dynamo/instances"
DEFAULT_STORE_ADDRESS = knobs.get_str("DYN_STORE_ADDRESS")

# Degraded-mode discovery (ISSUE 15): how long a consumer may keep
# serving on a cached instance whose lease the control plane declared
# dead, while the DATA PLANE says the instance is alive (breaker closed /
# pooled conn / direct probe). 0 disables degraded mode: every
# lease-expiry delete is honored immediately (the pre-ISSUE-15 behavior,
# where a store blackout collapses routing a TTL later).
DISCOVERY_STALE_GRACE_ENV = "DYN_DISCOVERY_STALE_GRACE_S"
# One quarantine liveness probe's dial budget.
DISCOVERY_PROBE_TIMEOUT_S = 1.0
# First re-judgment delay for a lease-expiry delete the egress pool has
# no opinion on: the instance stays provisionally routable for this long
# and the quarantine sweep's off-loop probe decides — the watch loop
# itself never dials, so a mass lease expiry cannot stall discovery
# event processing behind serialized probe timeouts.
DISCOVERY_PROBE_SOON_S = 0.2


def discovery_stale_grace() -> float:
    return knobs.get_float(DISCOVERY_STALE_GRACE_ENV)


@dataclass(frozen=True)
class Instance:
    namespace: str
    component: str
    endpoint: str
    instance_id: int
    address: str  # data-plane host:port
    metadata: dict | None = None

    @property
    def path(self) -> str:
        return f"{self.namespace}/{self.component}/{self.endpoint}"

    def to_wire(self) -> bytes:
        return msgpack.packb(
            {
                wire.INST_NS: self.namespace,
                wire.INST_COMPONENT: self.component,
                wire.INST_ENDPOINT: self.endpoint,
                wire.INST_ID: self.instance_id,
                wire.INST_ADDR: self.address,
                wire.INST_META: self.metadata,
            }
        )

    @classmethod
    def from_wire(cls, raw: bytes) -> "Instance":
        d = msgpack.unpackb(raw, raw=False)
        return cls(
            namespace=d[wire.INST_NS],
            component=d[wire.INST_COMPONENT],
            endpoint=d[wire.INST_ENDPOINT],
            instance_id=d[wire.INST_ID],
            address=d[wire.INST_ADDR],
            metadata=d.get(wire.INST_META),
        )


class DistributedRuntime:
    """A process's handle on the distributed system.

    Bundles the control-plane client, the primary lease (process liveness),
    the ingress server (data-plane listener), and the egress client pool.
    """

    def __init__(self, store: StoreClient, lease_id: int, ingress_host: str = "127.0.0.1"):
        self.store = store
        self.primary_lease_id = lease_id
        self.ingress = IngressServer(host=ingress_host)
        self.egress = EgressClient()
        # Optional per-process status server (worker.py starts it from
        # DYN_SYSTEM_* config); endpoints report health into it on serve.
        self.status = None
        self._ingress_started = False
        self._ingress_lock = asyncio.Lock()
        self._shutdown = asyncio.Event()
        # Instances this process registered (Endpoint.serve) — the drain
        # path deregisters them from discovery before anything else.
        self._served: list[tuple["Endpoint", int]] = []
        self._draining = False
        # Drain-time retraction hooks (async callables), run right after
        # discovery deregistration: workers append their published-state
        # retractions here — e.g. the KV inventory `cleared` event — so
        # routers stop serving stale hints NOW instead of at lease expiry
        # (ISSUE 11 satellite: drain used to leave the KV index stale).
        self.on_drain: list[Callable[[], Any]] = []

    @classmethod
    async def create(
        cls,
        store_address: str | None = None,
        lease_ttl: float = 10.0,
        ingress_host: str = "127.0.0.1",
    ) -> "DistributedRuntime":
        store = await StoreClient.open(store_address or DEFAULT_STORE_ADDRESS)
        lease_id = await store.lease_grant(ttl=lease_ttl)
        return cls(store, lease_id, ingress_host=ingress_host)

    def namespace(self, name: str) -> "Namespace":
        return Namespace(self, name)

    async def ensure_ingress(self) -> IngressServer:
        async with self._ingress_lock:
            if not self._ingress_started:
                await self.ingress.start()
                self._ingress_started = True
        return self.ingress

    async def shutdown(self) -> None:
        self._shutdown.set()
        if self._ingress_started:
            await self.ingress.stop()
        self.egress.close()
        await self.store.close()

    async def drain(self, timeout: float = 30.0) -> bool:
        """Graceful worker drain (SIGTERM path), in containment order:

        1. deregister every served instance from discovery — routers stop
           picking this worker the moment the watch event lands;
        2. stop admitting on the ingress (late arrivals racing the watch
           get a retryable "draining" err → migration replays elsewhere);
        3. let in-flight streams finish within ``timeout`` (stragglers
           are killed by the subsequent shutdown, which peers see as
           worker death → token-replay migration — no request is lost);
        4. revoke the primary lease so lease-bound state (model cards,
           KV inventories) vanishes now rather than at TTL expiry;
        5. release the shutdown waiter so the worker main exits.

        Returns True when all in-flight work completed within budget.
        Parity: reference graceful-shutdown flow (PAPER.md §L1 —
        deregister first, drain, then exit).
        """
        if self._draining:
            await self._shutdown.wait()
            return True
        self._draining = True
        log.info("draining: deregistering %d instance(s)", len(self._served))
        for ep, instance_id in self._served:
            try:
                await ep.deregister(instance_id)
            except (ConnectionError, StoreError):
                log.warning("drain: deregister %s failed", ep.path, exc_info=True)
        # Published-state retraction (KV inventory `cleared`, ...): after
        # deregistration so no new routes target us, before the lease
        # revoke so the events still reach the store.
        for cb in list(self.on_drain):
            try:
                await cb()
            except Exception:  # noqa: BLE001 — retraction is best-effort; lease expiry is the backstop
                log.warning("drain: retraction hook failed", exc_info=True)
        # Flight-recorder post-mortem (ISSUE 13): every engine ring in
        # this process dumps a redacted artifact before the lease goes —
        # the SIGTERM twin of the chaos-kill dump. Off the loop: the
        # dump is file I/O.
        from dynamo_tpu_torch.obs import flight_recorder

        if flight_recorder.enabled():
            try:
                await asyncio.to_thread(
                    flight_recorder.dump_all, "sigterm_drain"
                )
            except Exception:  # noqa: BLE001 — a failed dump must not block the drain
                log.warning("drain: flight-recorder dump failed", exc_info=True)
        completed = True
        if self._ingress_started:
            completed = await self.ingress.drain(timeout)
        try:
            await self.store.lease_revoke(self.primary_lease_id)
        except (ConnectionError, StoreError):
            log.warning("drain: lease revoke failed", exc_info=True)
        self._shutdown.set()
        return completed

    @property
    def draining(self) -> bool:
        """True once a graceful drain began: health surfaces go dark and
        frontends answer new requests with a retryable 503."""
        return self._draining

    def signal_shutdown(self) -> None:
        self._shutdown.set()

    def request_drain(self, timeout: float = 30.0) -> None:
        """Signal-handler-safe drain entry: schedules :meth:`drain` on
        the running loop (SIGTERM → graceful; SIGINT stays immediate via
        :meth:`signal_shutdown`)."""
        spawn_logged(self.drain(timeout), name="graceful-drain", logger=log)

    async def wait_for_shutdown(self) -> None:
        await self._shutdown.wait()


class Namespace:
    def __init__(self, runtime: DistributedRuntime, name: str):
        self.runtime = runtime
        self.name = name

    def component(self, name: str) -> "Component":
        return Component(self.runtime, self.name, name)


class Component:
    def __init__(self, runtime: DistributedRuntime, namespace: str, name: str):
        self.runtime = runtime
        self.namespace = namespace
        self.name = name

    def endpoint(self, name: str) -> "Endpoint":
        return Endpoint(self.runtime, self.namespace, self.name, name)

    @property
    def path(self) -> str:
        return f"{self.namespace}/{self.name}"


class Endpoint:
    def __init__(self, runtime: DistributedRuntime, namespace: str, component: str, name: str):
        self.runtime = runtime
        self.namespace = namespace
        self.component = component
        self.name = name

    @property
    def path(self) -> str:
        return f"{self.namespace}/{self.component}/{self.name}"

    @property
    def instance_prefix(self) -> str:
        return f"{INSTANCE_ROOT}/{self.path}/"

    async def serve(
        self,
        handler: Handler,
        metadata: dict | None = None,
        instance_id: int | None = None,
    ) -> Instance:
        """Serve this endpoint on the process ingress + register the instance.

        Parity: reference `serve_endpoint` (bindings lib.rs:519 →
        endpoint.rs:65) — graceful-deregistration on shutdown is the caller's
        job via `deregister`; process death handles it via lease expiry.
        """
        ingress = await self.runtime.ensure_ingress()
        ingress.register(self.path, handler)
        if self.runtime.status is not None:
            self.runtime.status.set_endpoint_health(self.path, True)
        inst = Instance(
            namespace=self.namespace,
            component=self.component,
            endpoint=self.name,
            instance_id=instance_id
            if instance_id is not None
            else self.runtime.primary_lease_id,
            address=ingress.address,
            metadata=metadata,
        )
        await self.runtime.store.kv_put(
            f"{self.instance_prefix}{inst.instance_id:016x}",
            inst.to_wire(),
            lease=self.runtime.primary_lease_id,
        )
        self.runtime._served.append((self, inst.instance_id))
        log.info("serving %s as instance %d at %s", self.path, inst.instance_id, inst.address)
        return inst

    async def deregister(self, instance_id: int) -> None:
        await self.runtime.store.kv_del(f"{self.instance_prefix}{instance_id:016x}")
        self.runtime.ingress.unregister(self.path)
        self.runtime._served = [
            (ep, iid)
            for ep, iid in self.runtime._served
            if not (iid == instance_id and ep.path == self.path)
        ]

    async def client(self) -> "EndpointClient":
        client = EndpointClient(self)
        await client.start()
        return client


class EndpointClient:
    """Watches an endpoint's instances and routes requests to them.

    Routing modes (parity: reference PushRouter `push_router.rs:138-179`):
    ``round_robin`` | ``random`` | ``direct(instance_id)``.
    """

    def __init__(self, endpoint: Endpoint, stale_grace_s: float | None = None):
        self.endpoint = endpoint
        self.runtime = endpoint.runtime
        self.instances: dict[int, Instance] = {}
        self._watch: Subscription | None = None
        self._watch_task: asyncio.Task | None = None
        self._rr_counter = 0
        self._instances_changed = asyncio.Event()
        self.on_instance_added: list[Callable[[Instance], None]] = []
        self.on_instance_removed: list[Callable[[int], None]] = []
        # Degraded-mode state (ISSUE 15): lease-expiry deletes for
        # instances the data plane still reaches are QUARANTINED (kept
        # routable, probe-rechecked) instead of dropped — the instance
        # snapshot above is last-known-good through a store blackout.
        # Loop-affine: mutated only by the watch loop, the quarantine
        # sweep, and the reconnect reconcile, all on one event loop.
        self.stale_grace_s = (
            discovery_stale_grace() if stale_grace_s is None else stale_grace_s
        )
        self.probe_timeout_s = DISCOVERY_PROBE_TIMEOUT_S
        self._quarantine: dict[int, float] = {}  # id -> monotonic deadline
        self._quarantine_task: asyncio.Task | None = None
        self.quarantined_total = 0
        self.quarantine_recovered_total = 0  # re-registered within grace
        self.quarantine_expired_total = 0    # probe failed; delete applied

    async def start(self) -> None:
        self._watch = await self.runtime.store.kv_watch(self.endpoint.instance_prefix)
        self._watch_task = asyncio.create_task(self._watch_loop())
        # After a store-session rebuild the watch replays current state
        # as puts, but keys that vanished DURING the outage produce no
        # delete — reconcile against the authoritative listing, routing
        # the misses through the same quarantine judgment.
        self.runtime.store.on_reconnect.append(self._reconcile)

    async def stop(self) -> None:
        """Idempotent; awaits task cancellation (same contract as
        ModelWatcher.stop) so no watcher/sweep coroutine outlives it."""
        try:
            self.runtime.store.on_reconnect.remove(self._reconcile)
        except ValueError:
            pass
        tasks = [
            t for t in (self._watch_task, self._quarantine_task) if t is not None
        ]
        self._watch_task = self._quarantine_task = None
        for task in tasks:
            task.cancel()
        for task in tasks:
            try:
                await task
            except asyncio.CancelledError:
                pass
            except Exception:  # noqa: BLE001 — teardown must not raise
                log.exception("endpoint client task failed during stop")
        watch, self._watch = self._watch, None
        if watch:
            await watch.unsubscribe()

    async def _watch_loop(self) -> None:
        assert self._watch is not None
        async for ev in self._watch:
            event = StoreClient.as_watch_event(ev)
            instance_id = int(event.key.rsplit("/", 1)[-1], 16)
            if event.type == wire.EV_PUT:
                inst = Instance.from_wire(event.value)
                known = instance_id in self.instances
                self.instances[instance_id] = inst
                if self._quarantine.pop(instance_id, None) is not None:
                    self.quarantine_recovered_total += 1
                    log.info(
                        "instance %d re-registered within grace on %s",
                        instance_id, self.endpoint.path,
                    )
                if not known:
                    # Replay puts for already-known instances (session
                    # rebuild) must not re-fire add callbacks.
                    for cb in self.on_instance_added:
                        cb(inst)
            else:
                inst = self.instances.get(instance_id)
                if inst is None:
                    continue  # duplicate delete — nothing to retire
                if event.reason == wire.EV_R_LEASE and self.stale_grace_s > 0:
                    # Synchronous judgment only — the watch loop must
                    # never dial (a mass lease expiry would serialize
                    # probe timeouts ahead of replacement-worker puts).
                    judged = self._judge_sync(inst)
                    if judged is not False:
                        # Known-alive: full grace. Unknown: provisional
                        # quarantine; the sweep's off-loop probe decides
                        # within DISCOVERY_PROBE_SOON_S.
                        delay = (
                            self.stale_grace_s
                            if judged
                            else DISCOVERY_PROBE_SOON_S
                        )
                        self._quarantine[instance_id] = time.monotonic() + delay
                        self.quarantined_total += 1
                        log.warning(
                            "instance %d lease-expired on %s; quarantining "
                            "(%s) instead of dropping",
                            instance_id, self.endpoint.path,
                            "data plane alive" if judged else "probe pending",
                        )
                        self._ensure_quarantine_sweep()
                        continue
                self._remove_instance(instance_id)
            self._instances_changed.set()
            self._instances_changed = asyncio.Event()

    def _remove_instance(self, instance_id: int) -> None:
        if self.instances.pop(instance_id, None) is not None:
            log.info(
                "instance %d removed from %s", instance_id, self.endpoint.path
            )
            for cb in self.on_instance_removed:
                cb(instance_id)
        self._quarantine.pop(instance_id, None)
        self._instances_changed.set()
        self._instances_changed = asyncio.Event()

    def _judge_sync(self, inst: Instance) -> bool | None:
        """The egress pool's opinion of an address, without dialing:
        open breaker → False (dead), pooled live connection → True
        (alive), no opinion → None (a probe must decide)."""
        st = self.runtime.egress.stats().get(inst.address)
        if st is not None:
            if st["state"] == "open":
                return False
            if st["connected"]:
                return True
        return None

    async def _should_quarantine(self, inst: Instance) -> bool:
        """Degraded-mode judgment: the control plane said this lease
        died, but lease expiry during a store outage (or a worker↔store
        partition) says nothing about the WORKER. Believe the data plane:
        open breaker → dead; pooled live connection → alive; otherwise
        one cheap direct dial decides."""
        if self.stale_grace_s <= 0:
            return False
        judged = self._judge_sync(inst)
        if judged is not None:
            return judged
        return await self._probe(inst.address)

    async def _probe(self, address: str) -> bool:
        host, _, port = address.rpartition(":")
        try:
            _r, w = await asyncio.wait_for(
                asyncio.open_connection(host or "127.0.0.1", int(port)),
                self.probe_timeout_s,
            )
        except (OSError, asyncio.TimeoutError, ValueError):
            return False
        w.close()
        return True

    def _ensure_quarantine_sweep(self) -> None:
        if self._quarantine_task is None or self._quarantine_task.done():
            self._quarantine_task = asyncio.create_task(self._sweep_quarantine())

    async def _sweep_quarantine(self) -> None:
        """Re-judge quarantined instances at their grace deadlines: a
        data plane that still answers extends the quarantine (liveness is
        the data plane's call during an outage); one that stopped
        answering applies the original delete."""
        while self._quarantine:
            now = time.monotonic()
            due = min(self._quarantine.values())
            # Sleep in DISCOVERY_PROBE_SOON_S-bounded slices: a
            # provisional (probe-pending) entry added mid-sleep must be
            # judged at ITS deadline, not after the earliest pre-existing
            # grace deadline — an uncapped sleep would keep a dead
            # address routable for up to a full grace window.
            await asyncio.sleep(
                max(0.05, min(due - now, DISCOVERY_PROBE_SOON_S))
            )
            now = time.monotonic()
            for iid, deadline in list(self._quarantine.items()):
                if deadline > now:
                    continue
                inst = self.instances.get(iid)
                if inst is None:
                    self._quarantine.pop(iid, None)
                    continue
                # Full judgment, breaker state included: a hung worker
                # whose socket still accepts dials has an OPEN breaker —
                # the raw probe alone would re-quarantine it forever.
                if await self._should_quarantine(inst):
                    self._quarantine[iid] = now + self.stale_grace_s
                else:
                    self.quarantine_expired_total += 1
                    log.warning(
                        "quarantined instance %d on %s stopped answering; "
                        "applying the deferred delete",
                        iid, self.endpoint.path,
                    )
                    self._remove_instance(iid)

    async def _reconcile(self) -> None:
        listed = await self.runtime.store.kv_get_prefix(
            self.endpoint.instance_prefix
        )
        live_ids = {
            int(k.rsplit("/", 1)[-1], 16) for k in listed
        }
        for iid in [i for i in self.instances if i not in live_ids]:
            # .get: a concurrent quarantine-sweep removal between the
            # awaits here must skip the id, not KeyError out of the
            # whole reconcile (stale keys would then stay routable
            # forever — no real delete event is ever coming for them).
            inst = self.instances.get(iid)
            if inst is None:
                continue
            if await self._should_quarantine(inst):
                if iid not in self._quarantine:
                    self._quarantine[iid] = time.monotonic() + self.stale_grace_s
                    self.quarantined_total += 1
                self._ensure_quarantine_sweep()
            else:
                self._remove_instance(iid)

    def degraded_stats(self) -> dict:
        """Quarantine counters + store connectivity for /metrics and
        /health export."""
        return {
            "cached_instances": len(self.instances),
            "quarantined": len(self._quarantine),
            "quarantined_total": self.quarantined_total,
            "quarantine_recovered_total": self.quarantine_recovered_total,
            "quarantine_expired_total": self.quarantine_expired_total,
            "store_connected": getattr(self.runtime.store, "connected", True),
        }

    def instance_ids(self) -> list[int]:
        return sorted(self.instances)

    async def wait_for_instances(self, n: int = 1, timeout: float = 30.0) -> list[int]:
        async def _wait() -> list[int]:
            while len(self.instances) < n:
                await self._instances_changed.wait()
            return self.instance_ids()

        return await asyncio.wait_for(_wait(), timeout)

    # -- routing -----------------------------------------------------------

    def _eligible(self, exclude: set[int] | None) -> list[int]:
        ids = self.instance_ids()
        if exclude:
            filtered = [i for i in ids if i not in exclude]
            # All excluded (e.g. every worker failed once): retry the full
            # set rather than dead-ending — instances may have recovered.
            ids = filtered or ids
        if not ids:
            raise NoInstancesError(self.endpoint.path)
        return ids

    def _pick_round_robin(self, exclude: set[int] | None = None) -> Instance:
        ids = self._eligible(exclude)
        inst = self.instances[ids[self._rr_counter % len(ids)]]
        self._rr_counter += 1
        return inst

    def _pick_random(self, exclude: set[int] | None = None) -> Instance:
        ids = self._eligible(exclude)
        return self.instances[_random.choice(ids)]

    def pick_instance(self, mode: str = "round_robin", exclude: set[int] | None = None) -> int:
        """Choose a live instance id without dispatching (migration uses
        this to know which worker a later stream failure belongs to)."""
        picker = self._pick_random if mode == "random" else self._pick_round_robin
        return picker(exclude).instance_id

    async def direct(
        self, instance_id: int, payload: Any, headers: dict[str, str] | None = None
    ) -> ResponseStream:
        inst = self.instances.get(instance_id)
        if inst is None:
            raise NoInstancesError(f"{self.endpoint.path} instance {instance_id}")
        # Failure attribution: errors the stream synthesizes (conn death,
        # stall deadline, drain refusal) carry the instance id so the
        # migration layer excludes the right worker on replay.
        return await self.runtime.egress.request(
            inst.address, inst.path, payload, headers, worker_id=instance_id
        )

    async def round_robin(self, payload: Any, headers: dict[str, str] | None = None) -> ResponseStream:
        inst = self._pick_round_robin()
        return await self.runtime.egress.request(
            inst.address, inst.path, payload, headers, worker_id=inst.instance_id
        )

    async def random(self, payload: Any, headers: dict[str, str] | None = None) -> ResponseStream:
        inst = self._pick_random()
        return await self.runtime.egress.request(
            inst.address, inst.path, payload, headers, worker_id=inst.instance_id
        )

    async def generate(self, payload: Any, headers: dict[str, str] | None = None) -> ResponseStream:
        return await self.round_robin(payload, headers)


class NoInstancesError(RuntimeError):
    def __init__(self, path: str):
        super().__init__(f"no live instances for endpoint {path}")
