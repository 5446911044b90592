"""The control-plane store: discovery + messaging for the whole framework.

The port's copy of ``dynamo_tpu/runtime/store/server.py``, held to it by
``tests/test_torch_copies.py``.

One asyncio TCP server providing the services the reference sources from two
external systems (SURVEY.md §1 L0):

- **KV with leases and prefix watches** (etcd-equivalent): service discovery,
  instance registration under leases, config hot-reload, barriers.
  Parity: reference `lib/runtime/src/transports/etcd.rs:46-309`.
- **Pub/sub subjects, work queues, object store** (NATS-equivalent):
  KV events, metrics fan-out, the prefill work queue, model-card storage.
  Parity: reference `lib/runtime/src/transports/nats.rs:58-253,433-600`.

Design notes (TPU build): the reference assumes operators run etcd + NATS
next to the cluster. We ship the control plane in-tree instead — it is
hardware-neutral asyncio code, one process, zero external dependencies —
while keeping etcd's *semantics* (leases expire → instances vanish from
discovery; watches see PUT/DELETE with revisions) so every layer above
(discovery, router, disagg, planner) behaves like the reference's.

Failure detection: a lease dies when its TTL lapses without keepalive OR
when the owning connection drops — the latter gives sub-second worker-death
detection (faster than etcd's TTL-only model) and is what request migration
keys off.

Wire protocol (framing.py; key constants in runtime/wire.py, schemas
``store`` + ``store.event`` — checked by dynacheck's wire-contract
rule): requests ``{"i": id, "op": str, ...}`` → responses
``{"i": id, "ok": bool, "r"/"err": ...}``; server-push events
``{"s": sub_id, "ev": {...}}``.
"""

from __future__ import annotations

import asyncio
import logging
import time
from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import Any

from dynamo_tpu_torch.runtime import framing, wire

log = logging.getLogger("dynamo_tpu.store")

SWEEP_INTERVAL_S = 0.5
SUB_QUEUE_LIMIT = 16384


@dataclass
class _KvEntry:
    value: bytes
    lease_id: int
    create_rev: int
    mod_rev: int


@dataclass
class _Lease:
    lease_id: int
    ttl_s: float
    deadline: float
    conn_id: int  # owning connection; 0 = detached
    keys: set[str] = field(default_factory=set)


@dataclass
class _Sub:
    sub_id: int
    conn: "_Conn"
    kind: str  # "watch" | "sub"
    pattern: str


def subject_matches(pattern: str, subject: str) -> bool:
    """NATS-style subject matching: '.' tokens, '*' one token, '>' tail."""
    p_toks = pattern.split(".")
    s_toks = subject.split(".")
    for i, p in enumerate(p_toks):
        if p == ">":  # '>' requires at least one remaining subject token
            return len(s_toks) > i
        if i >= len(s_toks):
            return False
        if p != "*" and p != s_toks[i]:
            return False
    return len(p_toks) == len(s_toks)


class _Conn:
    def __init__(self, conn_id: int, writer: asyncio.StreamWriter):
        self.conn_id = conn_id
        self.writer = writer
        self.queue: asyncio.Queue[bytes | None] = asyncio.Queue(maxsize=SUB_QUEUE_LIMIT)
        self.closed = False

    def push(self, msg: Any) -> None:
        """Enqueue an outbound frame; drops (with a log) if the peer is slow."""
        if self.closed:
            return
        try:
            self.queue.put_nowait(framing.pack(msg))
        except asyncio.QueueFull:
            log.warning("conn %d slow consumer, dropping frame", self.conn_id)


class StoreServer:
    """In-process control-plane server. ``async with`` or start()/stop()."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.host = host
        self.port = port
        self._server: asyncio.Server | None = None
        self._rev = 0
        self._next_id = 1
        self._kv: dict[str, _KvEntry] = {}
        self._leases: dict[int, _Lease] = {}
        self._subs: dict[int, _Sub] = {}
        self._conns: dict[int, _Conn] = {}
        self._queues: dict[str, deque[bytes]] = defaultdict(deque)
        self._queue_waiters: dict[str, deque[asyncio.Future[bytes]]] = defaultdict(deque)
        self._objects: dict[str, dict[str, bytes]] = defaultdict(dict)
        self._sweeper: asyncio.Task | None = None

    # -- lifecycle ---------------------------------------------------------

    async def start(self) -> None:
        self._server = await asyncio.start_server(self._on_conn, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        self._sweeper = asyncio.create_task(self._sweep_loop())
        log.info("store server listening on %s:%d", self.host, self.port)

    async def stop(self) -> None:
        if self._sweeper:
            self._sweeper.cancel()
        # Close live connections BEFORE wait_closed(): since 3.12 it waits
        # for every connection handler, so a connected client (e.g. one
        # about to exercise reconnect) would hang shutdown forever.
        for conn in list(self._conns.values()):
            conn.closed = True
            conn.writer.close()
        if self._server:
            self._server.close()
            await self._server.wait_closed()

    async def __aenter__(self) -> "StoreServer":
        await self.start()
        return self

    async def __aexit__(self, *exc) -> None:
        await self.stop()

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    # -- connection handling ----------------------------------------------

    async def _on_conn(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        conn = _Conn(self._new_id(), writer)
        self._conns[conn.conn_id] = conn
        sender = asyncio.create_task(self._send_loop(conn))
        try:
            while True:
                # dynalint: unbounded-ok — server read loop idles between requests
                msg = await framing.read_frame(reader)
                try:
                    result = await self._dispatch(conn, msg)
                    conn.push({wire.ST_ID: msg[wire.ST_ID], wire.ST_OK: True,
                               wire.ST_RESULT: result})
                except Exception as e:  # noqa: BLE001 — report op errors to client
                    conn.push({wire.ST_ID: msg[wire.ST_ID], wire.ST_OK: False,
                               wire.ST_ERR: str(e)})
        except (asyncio.IncompleteReadError, ConnectionError, ValueError):
            pass
        finally:
            self._drop_conn(conn)
            sender.cancel()

    async def _send_loop(self, conn: _Conn) -> None:
        try:
            while True:
                # dynalint: unbounded-ok — local outbound queue, fed in-process
                frame = await conn.queue.get()
                if frame is None:
                    break
                conn.writer.write(frame)
                await conn.writer.drain()
        except (ConnectionError, asyncio.CancelledError):
            pass

    def _drop_conn(self, conn: _Conn) -> None:
        conn.closed = True
        self._conns.pop(conn.conn_id, None)
        for sub_id in [s for s, sub in self._subs.items() if sub.conn is conn]:
            self._subs.pop(sub_id, None)
        # Connection death revokes its leases → fast failure detection.
        for lease in [l for l in self._leases.values() if l.conn_id == conn.conn_id]:
            self._revoke_lease(lease.lease_id)
        conn.writer.close()

    # -- op dispatch -------------------------------------------------------

    async def _dispatch(self, conn: _Conn, msg: dict) -> Any:
        op = msg[wire.ST_OP]
        handler = getattr(self, f"_op_{op}", None)
        if handler is None:
            raise ValueError(f"unknown op {op!r}")
        return await handler(conn, msg)

    # -- KV ----------------------------------------------------------------

    def _notify_kv(
        self, event: str, key: str, value: bytes, rev: int, reason: str = ""
    ) -> None:
        for sub in self._subs.values():
            if sub.kind == "watch" and key.startswith(sub.pattern):
                ev = {wire.EV_TYPE: event, wire.EV_KEY: key,
                      wire.EV_VALUE: value, wire.EV_REV: rev}
                if reason:
                    # Delete provenance: "lease" (expiry / conn-death
                    # revoke — a liveness *judgment* degraded-mode
                    # consumers may second-guess against the data plane)
                    # vs "del" (an explicit retraction, always honored).
                    ev[wire.EV_REASON] = reason
                sub.conn.push({wire.ST_PUSH_SUB: sub.sub_id, wire.ST_EVENT: ev})

    async def _op_kv_put(self, conn: _Conn, msg: dict) -> dict:
        key, value = msg[wire.ST_KEY], msg[wire.ST_VALUE]
        lease_id = msg.get(wire.ST_LEASE, 0)
        existing = self._kv.get(key)
        if msg.get(wire.ST_CREATE_ONLY) and existing is not None:
            raise ValueError(f"key exists: {key}")
        if lease_id:
            lease = self._leases.get(lease_id)
            if lease is None:
                raise ValueError(f"no such lease {lease_id}")
            lease.keys.add(key)
        self._rev += 1
        self._kv[key] = _KvEntry(
            value=value,
            lease_id=lease_id,
            create_rev=existing.create_rev if existing else self._rev,
            mod_rev=self._rev,
        )
        self._notify_kv(wire.EV_PUT, key, value, self._rev)
        return {wire.ST_REV: self._rev}

    async def _op_kv_get(self, conn: _Conn, msg: dict) -> dict | None:
        entry = self._kv.get(msg[wire.ST_KEY])
        if entry is None:
            return None
        return {wire.ST_VALUE: entry.value, wire.ST_REV: entry.mod_rev,
                wire.ST_LEASE: entry.lease_id}

    async def _op_kv_del(self, conn: _Conn, msg: dict) -> int:
        return self._delete_key(msg[wire.ST_KEY])

    def _delete_key(self, key: str, reason: str = wire.EV_R_DEL) -> int:
        entry = self._kv.pop(key, None)
        if entry is None:
            return 0
        if entry.lease_id and entry.lease_id in self._leases:
            self._leases[entry.lease_id].keys.discard(key)
        self._rev += 1
        self._notify_kv(wire.EV_DELETE, key, b"", self._rev, reason=reason)
        return 1

    async def _op_kv_get_prefix(self, conn: _Conn, msg: dict) -> list:
        prefix = msg[wire.ST_KEY]
        return [
            {wire.ST_KEY: k, wire.ST_VALUE: e.value, wire.ST_REV: e.mod_rev}
            for k, e in sorted(self._kv.items())
            if k.startswith(prefix)
        ]

    async def _op_kv_watch(self, conn: _Conn, msg: dict) -> dict:
        sub_id = self._new_id()
        self._subs[sub_id] = _Sub(sub_id, conn, "watch", msg[wire.ST_KEY])
        initial = []
        if msg.get(wire.ST_WITH_INITIAL, True):
            initial = [
                {wire.EV_TYPE: wire.EV_PUT, wire.EV_KEY: k,
                 wire.EV_VALUE: e.value, wire.EV_REV: e.mod_rev}
                for k, e in sorted(self._kv.items())
                if k.startswith(msg[wire.ST_KEY])
            ]
        return {wire.ST_SUB: sub_id, wire.ST_INITIAL: initial}

    async def _op_unsub(self, conn: _Conn, msg: dict) -> bool:
        return self._subs.pop(msg[wire.ST_SUB], None) is not None

    # -- leases ------------------------------------------------------------

    def _new_id(self) -> int:
        i = self._next_id
        self._next_id += 1
        return i

    async def _op_lease_grant(self, conn: _Conn, msg: dict) -> dict:
        ttl = float(msg.get(wire.ST_TTL, 10.0))
        conn_bound = bool(msg.get(wire.ST_CONN_BOUND, True))
        want = msg.get(wire.ST_WANT)
        if want:
            # Reconnect re-attach: adopt an existing lease (connection
            # blip) or recreate it under the same id (server restart) —
            # higher layers key worker identity on the lease id, so a
            # fresh id would orphan every registration that embeds it.
            lease_id = int(want)
            self._next_id = max(self._next_id, lease_id + 1)
            existing = self._leases.get(lease_id)
            if existing is not None:
                existing.conn_id = conn.conn_id if conn_bound else 0
                existing.deadline = time.monotonic() + existing.ttl_s
                return {wire.ST_LEASE: lease_id, wire.ST_TTL: existing.ttl_s}
        else:
            lease_id = self._new_id()
        self._leases[lease_id] = _Lease(
            lease_id=lease_id,
            ttl_s=ttl,
            deadline=time.monotonic() + ttl,
            conn_id=conn.conn_id if conn_bound else 0,
        )
        return {wire.ST_LEASE: lease_id, wire.ST_TTL: ttl}

    async def _op_lease_keepalive(self, conn: _Conn, msg: dict) -> dict:
        lease = self._leases.get(msg[wire.ST_LEASE])
        if lease is None:
            raise ValueError(f"no such lease {msg[wire.ST_LEASE]}")
        lease.deadline = time.monotonic() + lease.ttl_s
        return {wire.ST_TTL: lease.ttl_s}

    async def _op_lease_revoke(self, conn: _Conn, msg: dict) -> bool:
        return self._revoke_lease(msg[wire.ST_LEASE])

    def _revoke_lease(self, lease_id: int) -> bool:
        lease = self._leases.pop(lease_id, None)
        if lease is None:
            return False
        for key in list(lease.keys):
            self._delete_key(key, reason=wire.EV_R_LEASE)
        return True

    async def _sweep_loop(self) -> None:
        while True:
            await asyncio.sleep(SWEEP_INTERVAL_S)
            now = time.monotonic()
            for lease_id in [l.lease_id for l in self._leases.values() if l.deadline < now]:
                log.info("lease %d expired", lease_id)
                self._revoke_lease(lease_id)

    # -- pub/sub -----------------------------------------------------------

    async def _op_sub(self, conn: _Conn, msg: dict) -> dict:
        sub_id = self._new_id()
        self._subs[sub_id] = _Sub(sub_id, conn, "sub", msg[wire.ST_SUBJECT])
        return {wire.ST_SUB: sub_id}

    async def _op_pub(self, conn: _Conn, msg: dict) -> int:
        subject, payload = msg[wire.ST_SUBJECT], msg[wire.ST_PAYLOAD]
        n = 0
        for sub in self._subs.values():
            if sub.kind == "sub" and subject_matches(sub.pattern, subject):
                sub.conn.push({
                    wire.ST_PUSH_SUB: sub.sub_id,
                    wire.ST_EVENT: {wire.EV_SUBJECT: subject,
                                    wire.EV_PAYLOAD: payload},
                })
                n += 1
        return n

    # -- work queues -------------------------------------------------------

    async def _op_q_push(self, conn: _Conn, msg: dict) -> int:
        name, payload = msg[wire.ST_QUEUE], msg[wire.ST_PAYLOAD]
        waiters = self._queue_waiters[name]
        while waiters:
            fut = waiters.popleft()
            if not fut.done():
                fut.set_result(payload)
                return 0
        self._queues[name].append(payload)
        return len(self._queues[name])

    async def _op_q_pop(self, conn: _Conn, msg: dict) -> bytes | None:
        name = msg[wire.ST_QUEUE]
        timeout = msg.get(wire.ST_TIMEOUT, 0.0)
        queue = self._queues[name]
        if queue:
            return queue.popleft()
        if timeout <= 0:
            return None
        fut: asyncio.Future[bytes] = asyncio.get_running_loop().create_future()
        self._queue_waiters[name].append(fut)
        try:
            return await asyncio.wait_for(fut, timeout)
        except asyncio.TimeoutError:
            return None

    async def _op_q_len(self, conn: _Conn, msg: dict) -> int:
        return len(self._queues[msg[wire.ST_QUEUE]])

    # -- object store ------------------------------------------------------

    async def _op_obj_put(self, conn: _Conn, msg: dict) -> bool:
        self._objects[msg[wire.ST_BUCKET]][msg[wire.ST_NAME]] = msg[wire.ST_PAYLOAD]
        return True

    async def _op_obj_get(self, conn: _Conn, msg: dict) -> bytes | None:
        return self._objects.get(msg[wire.ST_BUCKET], {}).get(msg[wire.ST_NAME])

    async def _op_obj_del(self, conn: _Conn, msg: dict) -> bool:
        return self._objects.get(msg[wire.ST_BUCKET], {}).pop(msg[wire.ST_NAME], None) is not None

    async def _op_obj_list(self, conn: _Conn, msg: dict) -> list[str]:
        return sorted(self._objects.get(msg[wire.ST_BUCKET], {}).keys())

    async def _op_ping(self, conn: _Conn, msg: dict) -> str:
        return "pong"


async def _amain(host: str, port: int) -> None:
    server = StoreServer(host, port)
    await server.start()
    print(f"dynamo-tpu store listening on {server.address}", flush=True)
    await asyncio.Event().wait()


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser(description="dynamo-tpu control-plane store server")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=6650)
    args = ap.parse_args()
    logging.basicConfig(level=logging.INFO)
    asyncio.run(_amain(args.host, args.port))


if __name__ == "__main__":
    main()
