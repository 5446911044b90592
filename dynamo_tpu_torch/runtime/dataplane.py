"""Request/response data plane: direct TCP streaming between processes.

The port's copy of ``dynamo_tpu/runtime/dataplane.py``, held to it by
``tests/test_torch_copies.py``.

The reference pushes requests over NATS and streams responses back over a
separate raw TCP channel (`lib/runtime/src/pipeline/network.rs:246-284`,
`tcp/server.rs`, `tcp/client.rs`). We collapse both hops into one
multiplexed TCP connection per (client, worker) pair: the client pushes a
request frame carrying a control header + payload (the two-part codec,
`codec/two_part.rs`) and response frames stream back on the same socket.
One fewer network hop and no broker on the hot path — on TPU pods the
request plane is latency-critical for disaggregation handoffs.

Frames (framing.py codec; key constants in runtime/wire.py, schema
``dataplane`` — checked by dynacheck's wire-contract rule):
  client→server:  {"t":"req","i":id,"m":"ns/comp/ep","h":{...},"p":payload}
                  {"t":"stop","i":id}            (graceful cancel)
                  {"t":"kill","i":id}            (hard cancel)
  server→client:  {"t":"rsp","i":id,"p":payload} (zero or more)
                  {"t":"end","i":id}             (stream complete)
                  {"t":"err","i":id,"err":msg}   (stream failed)

Backpressure: response writes go through ``drain()``; a slow client
throttles the producing engine naturally through TCP flow control.

Header contract: the ``h`` map on a request frame carries per-request
metadata end to end — at minimum ``x-request-id`` (log/trace correlation)
and ``traceparent`` (W3C ``00-<32 hex trace id>-<16 hex span id>-01``).
The server hands ``h`` to the handler as ``Context.headers`` untouched;
dynamo_tpu/tracing parses ``traceparent`` there so spans recorded in the
receiving process parent to the sender's span and the whole request
stitches into one trace across disagg and migration hops. Intermediaries
must forward both keys verbatim (mint a child traceparent only when
starting a new span of their own).

Failure containment (the availability contract request migration builds
on, reference RetryManager `lib/llm/src/migration.rs:26`):

* **Deadlines.** Dials are bounded by ``EgressPolicy.connect_s``;
  consumer waits on a response stream are bounded by the per-token
  STALL deadline ``EgressPolicy.stall_s`` — a wedged-but-connected
  worker (engine loop dead, socket alive) surfaces as a synthesized
  ``ConnectionError`` carrying ``worker_id``, which the migration layer
  treats exactly like worker death: replay on another instance.
* **Circuit breaker.** Consecutive connect failures / connection deaths
  per address open a breaker; while open, dials fail fast (no connect
  timeout burned per attempt); after ``breaker_reset_s`` a single
  half-open probe decides. State exports on ``/metrics``
  (status_server.bind_egress_gauges).
* **Eager eviction.** A dead connection is removed from the pool the
  moment its reader loop exits — not at the next ``_get_conn`` — so
  every routing decision sees live pool state.
* **Drain-aware errors.** A draining server (graceful SIGTERM) answers
  new requests with a distinguished err frame that the client surfaces
  as ``ConnectionError`` — i.e. "retry elsewhere", not "request failed".

KV-page payload contract (the ``kv_transfer``/``kv_fetch`` endpoints
that ride this plane): a block's page bytes are OPAQUE to the transport
but self-describing at the endpoint layer — every stream opens with a
geometry/descriptor frame carrying ``shape``, ``dtype``, and (for
kv_transfer) a ``layout`` map with ``kv_dtype``. ``dtype == "int8"``
(quantized KV cache, engine/kv_quant.py) means each block is the
canonical packed buffer: int8 kv bytes ``[L, bs, 2kv, d]`` followed by
f32 per-slot-per-head scales ``[L, bs, 2kv]``. Consumers import the
buffer verbatim (quantize-once bit-stability); a dtype mismatch where
either side is int8 fails the import fast instead of re-quantizing.
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import time
from dataclasses import dataclass
from typing import Any, AsyncIterator, Callable

from dynamo_tpu_torch import knobs
from dynamo_tpu_torch.runtime import chaos, framing, wire
from dynamo_tpu_torch.runtime import engine as _engine_errors
from dynamo_tpu_torch.runtime.engine import Context, DeadlineExceededError
from dynamo_tpu_torch.runtime.tasks import spawn_logged

log = logging.getLogger("dynamo_tpu.dataplane")


def _flight_dump(reason: str, detail: str) -> None:
    """Failure-path flight-recorder dump (stall deadline / breaker open).

    These sites fire INSIDE the containment path, on the event loop —
    serializing + writing every ring synchronously here would delay the
    very eviction/failover the dump is documenting (and starve lease
    keepalives in single-process deployments). So when a loop is running
    the dump is handed to the default executor; the rings keep recording
    and the wedged victim's ring is static anyway, so a few milliseconds
    of deferral loses nothing. dump_all is budgeted per reason with a
    cooldown. No-op when nothing records."""
    from dynamo_tpu_torch.obs import flight_recorder

    if not flight_recorder.enabled():
        return

    def _dump() -> None:
        try:
            flight_recorder.dump_all(reason, detail)
        except Exception:  # noqa: BLE001 — a failed dump must not change containment behavior
            log.exception("flight dump failed (%s)", reason)

    try:
        loop = asyncio.get_running_loop()
    except RuntimeError:
        _dump()
        return
    loop.run_in_executor(None, _dump)

Handler = Callable[[Any, Context], AsyncIterator[Any]]

# Distinguished err payload a draining server answers new requests with;
# clients map it to ConnectionError so migration replays elsewhere.
DRAINING_ERR = "worker draining"

# Typed overload markers (runtime/engine.py): an engine-side
# EngineOverloadedError/DeadlineExceededError serializes as an err frame
# whose payload starts with its ``wire`` marker; the client maps the
# marker back (shed -> retryable ConnectionError like DRAINING_ERR,
# deadline -> client-side DeadlineExceededError, never migrated).
SHED_WIRE = _engine_errors.SHED_WIRE
DEADLINE_WIRE = _engine_errors.DEADLINE_WIRE


@dataclass
class EgressPolicy:
    """Client-side containment knobs (env-overridable per process).
    Defaults live in the central knob registry (dynamo_tpu/knobs.py)."""

    # Dial deadline for one egress connect.
    connect_s: float = knobs.default("DYN_DATAPLANE_CONNECT_TIMEOUT_S")
    # Per-frame stall deadline on a response stream: maximum time a
    # consumer waits for the NEXT frame before the stream is declared
    # stalled and synthesized into a ConnectionError. <= 0 disables.
    stall_s: float | None = knobs.default("DYN_DATAPLANE_STALL_TIMEOUT_S")
    # Circuit breaker: consecutive failures to open; cooldown before the
    # half-open probe.
    breaker_threshold: int = knobs.default("DYN_DATAPLANE_BREAKER_THRESHOLD")
    breaker_reset_s: float = knobs.default("DYN_DATAPLANE_BREAKER_RESET_S")

    @classmethod
    def from_env(cls) -> "EgressPolicy":
        stall = knobs.get_float("DYN_DATAPLANE_STALL_TIMEOUT_S")
        return cls(
            connect_s=knobs.get_float("DYN_DATAPLANE_CONNECT_TIMEOUT_S"),
            stall_s=None if stall <= 0 else stall,
            breaker_threshold=knobs.get_int("DYN_DATAPLANE_BREAKER_THRESHOLD"),
            breaker_reset_s=knobs.get_float("DYN_DATAPLANE_BREAKER_RESET_S"),
        )


class CircuitBreaker:
    """Per-address three-state breaker (closed → open → half-open).

    Closed: all dials pass. After ``threshold`` consecutive failures the
    breaker opens and dials fail fast for ``reset_s``; then exactly one
    probe is let through (half-open) — its outcome closes or re-opens.
    Parity: the availability pattern the reference delegates to its NATS
    client; our dataplane owns its own connections so it owns this too.
    """

    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half-open"

    def __init__(
        self,
        threshold: int = 5,
        reset_s: float = 2.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.threshold = max(1, threshold)
        self.reset_s = reset_s
        self._clock = clock
        self.state = self.CLOSED
        self.consecutive_failures = 0
        self.opens_total = 0
        self._opened_at = 0.0
        self._probe_at = 0.0
        # Optional closed->open notification (the flight recorder's
        # breaker_open dump trigger). None = no observer (the dynacheck
        # model and unit tests drive the breaker bare).
        self.on_open: Callable[[], None] | None = None

    def allow(self) -> bool:
        if self.state == self.CLOSED:
            return True
        now = self._clock()
        if self.state == self.OPEN:
            if now - self._opened_at >= self.reset_s:
                self.state = self.HALF_OPEN
                self._probe_at = now
                return True  # the single probe
            return False
        # Half-open: a probe is in flight — hold further dials, UNLESS
        # the probe went stale (its task was cancelled mid-dial and never
        # reported back); re-arm rather than wedging the address forever.
        if now - self._probe_at >= self.reset_s:
            self._probe_at = now
            return True
        return False

    def record_success(self) -> None:
        self.state = self.CLOSED
        self.consecutive_failures = 0

    def record_failure(self) -> None:
        self.consecutive_failures += 1
        if (
            self.state == self.HALF_OPEN
            or self.consecutive_failures >= self.threshold
        ):
            opened = self.state != self.OPEN
            if opened:
                self.opens_total += 1
            self.state = self.OPEN
            self._opened_at = self._clock()
            if opened and self.on_open is not None:
                try:
                    self.on_open()
                except Exception:  # noqa: BLE001 — observability must not change breaker behavior
                    log.exception("breaker on_open hook failed")

    def stats(self) -> dict:
        return {
            "state": self.state,
            "consecutive_failures": self.consecutive_failures,
            "opens_total": self.opens_total,
        }


class BreakerOpenError(ConnectionError):
    """Dial rejected fast: the address's circuit breaker is open."""

    def __init__(self, address: str):
        super().__init__(f"circuit breaker open for {address}")
        self.address = address


class IngressServer:
    """Per-process TCP listener dispatching requests to registered engines.

    Parity: reference `PushEndpoint` worker loop
    (`pipeline/network/ingress/push_endpoint.rs:18`).
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.host = host
        self.port = port
        self._routes: dict[str, Handler] = {}
        self._server: asyncio.Server | None = None
        self._inflight: dict[tuple[int, int], tuple[asyncio.Task, Context]] = {}
        self._conn_ids = itertools.count(1)
        self._writers: set[asyncio.StreamWriter] = set()
        # Graceful drain: while True, new requests are refused with a
        # retryable err frame; _idle signals the in-flight set emptied.
        self.draining = False
        self._idle = asyncio.Event()
        self._idle.set()

    def register(self, route: str, handler: Handler) -> None:
        self._routes[route] = handler

    def unregister(self, route: str) -> None:
        self._routes.pop(route, None)

    @property
    def num_inflight(self) -> int:
        return len(self._inflight)

    async def start(self) -> None:
        self._server = await asyncio.start_server(self._on_conn, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]

    async def drain(self, timeout: float = 30.0) -> bool:
        """Stop admitting new requests and wait for in-flight handlers
        to finish. Returns True when everything completed within the
        deadline, False when stragglers remain (the caller's stop() will
        kill them, which surfaces to peers as worker death → migration)."""
        self.draining = True
        if not self._inflight:
            return True
        try:
            await asyncio.wait_for(self._idle.wait(), timeout)
            return True
        except asyncio.TimeoutError:
            log.warning(
                "drain deadline passed with %d request(s) still in flight",
                len(self._inflight),
            )
            return False

    async def stop(self) -> None:
        for task, ctx in self._inflight.values():
            ctx.kill()
            task.cancel()
        # Close live connections too, so peers see worker death immediately
        # (the signal request migration keys off).
        for writer in list(self._writers):
            writer.close()
        if self._server:
            self._server.close()
            await self._server.wait_closed()

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    async def _on_conn(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        conn_id = next(self._conn_ids)
        write_lock = asyncio.Lock()
        self._writers.add(writer)
        try:
            while True:
                # Server side waits indefinitely for client traffic by
                # design: an idle multiplexed conn is healthy, and conn
                # death surfaces as EOF.
                # dynalint: unbounded-ok — server read loop idles between frames
                msg = await framing.read_frame(reader)
                kind = msg.get(wire.DP_TYPE)
                if kind == wire.DP_T_REQ:
                    if self.draining:
                        async with write_lock:
                            await framing.send_frame(
                                writer,
                                {wire.DP_TYPE: wire.DP_T_ERR, wire.DP_ID: msg[wire.DP_ID],
                                 wire.DP_ERR: DRAINING_ERR},
                            )
                        continue
                    key = (conn_id, msg[wire.DP_ID])
                    ctx = Context(
                        request_id=msg.get(wire.DP_HEADERS, {}).get("x-request-id"),
                        headers=msg.get(wire.DP_HEADERS, {}),
                    )
                    task = asyncio.create_task(
                        self._serve_one(writer, write_lock, key, msg, ctx)
                    )
                    self._inflight[key] = (task, ctx)
                    self._idle.clear()
                elif kind in (wire.DP_T_STOP, wire.DP_T_KILL):
                    entry = self._inflight.get((conn_id, msg[wire.DP_ID]))
                    if entry is not None:
                        task, ctx = entry
                        if kind == wire.DP_T_KILL:
                            ctx.kill()
                            task.cancel()
                        else:
                            ctx.stop_generating()
        except (asyncio.IncompleteReadError, ConnectionError, ValueError):
            pass
        finally:
            # Peer gone: kill everything it had in flight on this connection.
            for key in [k for k in self._inflight if k[0] == conn_id]:
                task, ctx = self._inflight.pop(key)
                ctx.kill()
                task.cancel()
            if not self._inflight:
                self._idle.set()
            self._writers.discard(writer)
            writer.close()

    async def _serve_one(
        self,
        writer: asyncio.StreamWriter,
        write_lock: asyncio.Lock,
        key: tuple[int, int],
        msg: dict,
        ctx: Context,
    ) -> None:
        req_id = msg[wire.DP_ID]

        async def send(frame: dict) -> None:
            async with write_lock:
                await framing.send_frame(writer, frame)

        try:
            handler = self._routes.get(msg[wire.DP_ROUTE])
            if handler is None:
                await send({wire.DP_TYPE: wire.DP_T_ERR, wire.DP_ID: req_id,
                            wire.DP_ERR: f"no route {msg[wire.DP_ROUTE]!r}"})
                return
            async for item in handler(msg.get(wire.DP_PAYLOAD), ctx):
                await send({wire.DP_TYPE: wire.DP_T_RSP, wire.DP_ID: req_id,
                            wire.DP_PAYLOAD: item})
            await send({wire.DP_TYPE: wire.DP_T_END, wire.DP_ID: req_id})
        except asyncio.CancelledError:
            raise
        except ConnectionError:
            pass
        except Exception as e:  # noqa: BLE001 — stream errors go to the peer
            # Typed overload rejections (EngineOverloadedError /
            # DeadlineExceededError) serialize their canonical wire
            # marker so the client maps them back; they are expected
            # load-shedding behavior, logged at info, not exception.
            wire_code = getattr(e, "wire", None)
            if wire_code:
                log.info("handler %s shed request: %s", msg.get(wire.DP_ROUTE), e)
                payload = f"{wire_code}: {e}"
            else:
                log.exception("handler %s failed", msg.get(wire.DP_ROUTE))
                payload = f"{type(e).__name__}: {e}"
            try:
                await send({wire.DP_TYPE: wire.DP_T_ERR, wire.DP_ID: req_id,
                            wire.DP_ERR: payload})
            except ConnectionError:
                pass
        finally:
            self._inflight.pop(key, None)
            if not self._inflight:
                self._idle.set()


class ResponseStream:
    """Client-side view of one in-flight streamed response.

    ``worker_id`` (set by EndpointClient.direct) rides every failure this
    stream synthesizes, so the migration layer knows WHICH instance to
    exclude on replay — including the stall case, where no transport
    error ever fires.
    """

    _END = object()

    def __init__(self, conn: "_EgressConn", req_id: int, stall_s: float | None = None):
        self._conn = conn
        self._req_id = req_id
        self._queue: asyncio.Queue[Any] = asyncio.Queue()
        self._done = False
        self._stall_s = stall_s
        self.worker_id: int | None = None

    def _push(self, item: Any) -> None:
        self._queue.put_nowait(item)

    def __aiter__(self) -> "ResponseStream":
        return self

    async def __anext__(self) -> Any:
        if self._done:
            raise StopAsyncIteration
        try:
            # Fast path: a frame is already buffered — no deadline task.
            item = self._queue.get_nowait()
        except asyncio.QueueEmpty:
            try:
                item = await asyncio.wait_for(self._queue.get(), self._stall_s)
            except asyncio.TimeoutError:
                # Stalled-but-connected worker: the socket is alive but no
                # frame arrived within the stall budget. Synthesize the
                # same failure shape as worker death so migration replays
                # the request elsewhere, and abandon the stream so a
                # late-reviving worker cannot double-deliver.
                self._done = True
                self._conn.abandon(self._req_id)
                err = ConnectionError(
                    f"stream from {self._conn.address} stalled for "
                    f"{self._stall_s:.1f}s (req {self._req_id})"
                )
                err.worker_id = self.worker_id  # type: ignore[attr-defined]
                raise err from None
        if item is self._END:
            self._done = True
            raise StopAsyncIteration
        if isinstance(item, Exception):
            self._done = True
            raise item
        return item

    async def stop(self) -> None:
        """Graceful cancel: worker finishes current state and ends stream."""
        await self._conn.send({wire.DP_TYPE: wire.DP_T_STOP, wire.DP_ID: self._req_id})

    async def kill(self) -> None:
        # Deregister first: a killed server task sends no end frame, so
        # leaving the entry would leak one registry slot per kill (and a
        # late frame racing the kill must be discarded, not delivered).
        self._conn._streams.pop(self._req_id, None)
        await self._conn.send({wire.DP_TYPE: wire.DP_T_KILL, wire.DP_ID: self._req_id})
        self._push(self._END)

    async def kill_quietly(self) -> None:
        """Best-effort kill for fire-and-forget callers (consumer-
        abandonment cleanup): a connection that died first means the
        server already reaped the request — nothing to report."""
        try:
            await self.kill()
        except (ConnectionError, OSError):
            pass


class _EgressConn:
    def __init__(
        self,
        address: str,
        policy: EgressPolicy | None = None,
        on_dead: Callable[["_EgressConn"], None] | None = None,
        on_stall: Callable[[], None] | None = None,
    ):
        self.address = address
        host, _, port = address.rpartition(":")
        self._host, self._port = host or "127.0.0.1", int(port)
        self.policy = policy or EgressPolicy()
        self._writer: asyncio.StreamWriter | None = None
        self._streams: dict[int, ResponseStream] = {}
        self._ids = itertools.count(1)
        self._lock = asyncio.Lock()
        self._reader_task: asyncio.Task | None = None
        self.healthy = True
        self._on_dead = on_dead
        self._on_stall = on_stall

    async def connect(self) -> None:
        if chaos.active():
            await chaos.inject("dataplane.connect", self.address)
        reader, self._writer = await asyncio.wait_for(
            asyncio.open_connection(self._host, self._port),
            self.policy.connect_s,
        )
        self._reader_task = asyncio.create_task(self._recv_loop(reader))

    async def send(self, frame: dict) -> None:
        if self._writer is None:
            raise ConnectionError("egress not connected")
        if chaos.active() and not await chaos.inject("dataplane.send", self.address):
            return  # frame dropped by the active chaos plan
        async with self._lock:
            await framing.send_frame(self._writer, frame)

    async def request(
        self,
        route: str,
        payload: Any,
        headers: dict[str, str],
        worker_id: int | None = None,
    ) -> ResponseStream:
        req_id = next(self._ids)
        stream = ResponseStream(self, req_id, stall_s=self.policy.stall_s)
        # Attribution BEFORE the frame is written: a refusal/death raced
        # against the send must already carry the instance id.
        stream.worker_id = worker_id
        self._streams[req_id] = stream
        await self.send({
            wire.DP_TYPE: wire.DP_T_REQ, wire.DP_ID: req_id,
            wire.DP_ROUTE: route, wire.DP_HEADERS: headers,
            wire.DP_PAYLOAD: payload,
        })
        return stream

    def abandon(self, req_id: int) -> None:
        """Forget one stream (stall eviction): deregister it so late
        frames are discarded, and best-effort kill the server side."""
        if self._streams.pop(req_id, None) is None:
            return
        if self._on_stall is not None:
            self._on_stall()
        if self._writer is not None and self.healthy:
            spawn_logged(
                self._kill_quietly(req_id),
                name=f"dataplane-kill-{req_id}",
                logger=log,
            )

    async def _kill_quietly(self, req_id: int) -> None:
        try:
            await self.send({wire.DP_TYPE: wire.DP_T_KILL, wire.DP_ID: req_id})
        except (ConnectionError, OSError):
            pass  # the conn died under us; the server reaps on EOF

    async def _recv_loop(self, reader: asyncio.StreamReader) -> None:
        try:
            while True:
                # Idle multiplexed conn between streams is healthy; the
                # consumer-facing bound is the per-stream stall deadline
                # in ResponseStream.
                # dynalint: unbounded-ok — bounded per stream by the stall deadline
                msg = await framing.read_frame(reader)
                if chaos.active() and not await chaos.inject(
                    "dataplane.recv", self.address
                ):
                    continue  # frame dropped by the active chaos plan
                stream = self._streams.get(msg[wire.DP_ID])
                if stream is None:
                    continue
                kind = msg[wire.DP_TYPE]
                if kind == wire.DP_T_RSP:
                    stream._push(msg[wire.DP_PAYLOAD])
                elif kind == wire.DP_T_END:
                    stream._push(ResponseStream._END)
                    self._streams.pop(msg[wire.DP_ID], None)
                elif kind == wire.DP_T_ERR:
                    if msg[wire.DP_ERR] == DRAINING_ERR:
                        # Graceful drain refusal: retryable, not a
                        # request failure — migration replays elsewhere.
                        err: Exception = ConnectionError(
                            f"worker at {self.address} is draining"
                        )
                        err.worker_id = stream.worker_id  # type: ignore[attr-defined]
                    elif msg[wire.DP_ERR].startswith(SHED_WIRE):
                        # Overload shed: same retryable shape as the
                        # drain refusal — migration retries the request
                        # on a less-loaded instance.
                        err = ConnectionError(
                            f"worker at {self.address} shed the request: "
                            f"{msg['err']}"
                        )
                        err.worker_id = stream.worker_id  # type: ignore[attr-defined]
                    elif msg[wire.DP_ERR].startswith(DEADLINE_WIRE):
                        # Deadline expiry is typed but NOT retryable via
                        # migration — the budget is already spent.
                        err = DeadlineExceededError(msg[wire.DP_ERR])
                    else:
                        err = EngineStreamError(msg[wire.DP_ERR])
                    stream._push(err)
                    self._streams.pop(msg[wire.DP_ID], None)
        except (asyncio.IncompleteReadError, ConnectionError, asyncio.CancelledError):
            pass
        finally:
            self.healthy = False
            # Exactly-once failure delivery: drain the registry FIRST so
            # no other path can push to these streams again, then hand
            # each its own tagged error.
            streams = list(self._streams.values())
            self._streams.clear()
            for stream in streams:
                err = ConnectionError(f"connection to {self.address} lost")
                err.worker_id = stream.worker_id  # type: ignore[attr-defined]
                stream._push(err)
            if self._on_dead is not None:
                self._on_dead(self)

    def close(self) -> None:
        self.healthy = False
        if self._reader_task:
            self._reader_task.cancel()
        if self._writer:
            self._writer.close()


class EgressClient:
    """Connection pool to worker ingress servers, keyed by address.

    Parity: reference `pipeline/network/egress/addressed_router.rs` +
    `tcp/client.rs` (addressed request push + response registration).
    """

    def __init__(self, policy: EgressPolicy | None = None) -> None:
        self.policy = policy or EgressPolicy.from_env()
        self._conns: dict[str, _EgressConn] = {}
        self._locks: dict[str, asyncio.Lock] = {}
        self._breakers: dict[str, CircuitBreaker] = {}
        self._stalls: dict[str, int] = {}

    def _breaker(self, address: str) -> CircuitBreaker:
        br = self._breakers.get(address)
        if br is None:
            br = self._breakers[address] = CircuitBreaker(
                threshold=self.policy.breaker_threshold,
                reset_s=self.policy.breaker_reset_s,
            )
            # Flight-recorder trigger (ISSUE 13): a breaker opening is a
            # containment event worth a post-mortem — dump every engine
            # ring in this process (budgeted + cooldown inside dump_all).
            br.on_open = lambda addr=address: _flight_dump(
                "breaker_open", addr
            )
        return br

    def _on_conn_dead(self, conn: _EgressConn) -> None:
        """Eager eviction: the reader loop saw the conn die — remove it
        from the pool NOW (not at the next dial) and count the failure.
        A conn no longer pooled (replaced, or already evicted by the
        stall path) is not re-debited."""
        if self._conns.get(conn.address) is conn:
            del self._conns[conn.address]
            self._breaker(conn.address).record_failure()

    def _note_stall(self, address: str) -> None:
        """A stall counts against the breaker (a wedged worker is as
        unroutable as a dead one), and the stalled conn is evicted AND
        closed: its socket is alive but its worker is not answering, so
        leaving it pooled would route fresh requests into the same
        stall_s black hole, and its other in-flight streams are doomed
        anyway — closing fails them over NOW instead of one stall budget
        each."""
        self._stalls[address] = self._stalls.get(address, 0) + 1
        # Flight-recorder trigger (ISSUE 13): the stall deadline firing
        # means a worker wedged mid-stream — dump every engine ring in
        # this process (in single-process deployments the victim's
        # recorder lives here too; its ring is static while wedged, so
        # the dump riding the executor loses nothing).
        _flight_dump("stall_deadline", address)
        self._breaker(address).record_failure()
        conn = self._conns.pop(address, None)
        if conn is not None:
            conn.close()

    async def _get_conn(self, address: str) -> _EgressConn:
        conn = self._conns.get(address)
        if conn is not None and conn.healthy:
            return conn
        lock = self._locks.setdefault(address, asyncio.Lock())
        async with lock:
            conn = self._conns.get(address)
            if conn is not None and conn.healthy:
                return conn
            breaker = self._breaker(address)
            if not breaker.allow():
                raise BreakerOpenError(address)
            conn = _EgressConn(
                address,
                policy=self.policy,
                on_dead=self._on_conn_dead,
                on_stall=lambda addr=address: self._note_stall(addr),
            )
            try:
                await conn.connect()
            except (OSError, asyncio.TimeoutError) as e:
                breaker.record_failure()
                raise ConnectionError(f"connect to {address} failed: {e}") from e
            breaker.record_success()
            self._conns[address] = conn
            return conn

    async def request(
        self,
        address: str,
        route: str,
        payload: Any,
        headers: dict[str, str] | None = None,
        worker_id: int | None = None,
    ) -> ResponseStream:
        conn = await self._get_conn(address)
        return await conn.request(route, payload, headers or {}, worker_id=worker_id)

    def stats(self) -> dict[str, dict]:
        """Per-address containment state (breaker + stall counters) for
        /metrics export and operator introspection."""
        out: dict[str, dict] = {}
        for address, br in self._breakers.items():
            st = br.stats()
            conn = self._conns.get(address)
            st["connected"] = bool(conn is not None and conn.healthy)
            st["stalls_total"] = self._stalls.get(address, 0)
            out[address] = st
        return out

    def close(self) -> None:
        for conn in self._conns.values():
            conn.close()
        self._conns.clear()
        self._locks.clear()


class EngineStreamError(RuntimeError):
    """The remote engine reported a failure mid-stream."""
