"""The universal streaming-engine abstraction.

The port's copy of ``dynamo_tpu/runtime/engine.py``, held to it by
``tests/test_torch_copies.py``.

Every request-serving unit in the framework — preprocessor, router, network
egress, model worker, mock engine — is an *async engine*: a callable taking
one request plus a :class:`Context` and yielding a stream of responses.
Engines compose into pipelines by wrapping each other.

Capability parity: reference `lib/runtime/src/engine.rs:90-219`
(`AsyncEngine<SingleIn<Req>, ManyOut<Resp>>`, `AsyncEngineContext`) and
`lib/runtime/src/protocols/annotated.rs:21` (`Annotated<R>` envelope).
Re-designed: Python async generators *are* ManyOut streams, so the trait
collapses to a protocol with one method; context propagation rides
contextvars-free explicit argument passing (explicit beats implicit in a
codebase with process boundaries).
"""

from __future__ import annotations

import asyncio
import uuid
from dataclasses import dataclass, field
from typing import Any, AsyncIterator, Protocol, runtime_checkable


class Context:
    """Per-request context: identity, tracing, and two-stage cancellation.

    ``stop`` asks the engine to finish gracefully (emit what it has);
    ``kill`` demands immediate abandonment. Mirrors AsyncEngineContext's
    stop/kill semantics (reference engine.rs:124-180).
    """

    def __init__(self, request_id: str | None = None, headers: dict[str, str] | None = None):
        self.id = request_id or uuid.uuid4().hex
        self.headers: dict[str, str] = headers or {}
        # Open per-request scratch for pipeline operators (runtime/
        # pipeline.py) to pass hints to downstream nodes — e.g. the
        # migration operator's exclude-list for the router egress.
        self.meta: dict[str, Any] = {}
        self._stopped = asyncio.Event()
        self._killed = asyncio.Event()

    @property
    def is_stopped(self) -> bool:
        return self._stopped.is_set()

    @property
    def is_killed(self) -> bool:
        return self._killed.is_set()

    def stop_generating(self) -> None:
        self._stopped.set()

    def kill(self) -> None:
        self._killed.set()
        self._stopped.set()

    async def wait_stopped(self) -> None:
        await self._stopped.wait()

    def child(self) -> "Context":
        """A context sharing identity+cancellation with its parent."""
        child = Context.__new__(Context)
        child.id = self.id
        child.headers = self.headers
        # Copied, not aliased: a child scopes one downstream attempt, and
        # its hints (e.g. migration's exclude list) must not leak back
        # into the parent or into sibling attempts.
        child.meta = dict(self.meta)
        child._stopped = self._stopped
        child._killed = self._killed
        return child


@runtime_checkable
class AsyncEngine(Protocol):
    """Anything that turns one request into a stream of responses."""

    def generate(self, request: Any, context: Context) -> AsyncIterator[Any]:
        ...


# -- typed overload errors (the shed/deadline contract) ----------------------
#
# Graceful degradation under overload (ISSUE 10) needs REJECTIONS to be
# typed end to end: an engine that cannot take a request raises one of
# these, the ingress server serializes the exception's ``wire`` marker as
# the err-frame payload (dataplane.IngressServer._serve_one), and the
# egress client maps the marker back to the right client-side behavior
# (dataplane._EgressConn._recv_loop):
#
#   EngineOverloadedError -> ConnectionError carrying worker_id
#       ("retry elsewhere"): migration replays the request on another
#       instance, exactly like the PR 6 "draining" refusal — a shed
#       worker is a worker you route around, not a failed request.
#   DeadlineExceededError -> DeadlineExceededError on the client
#       (NOT retried by migration: the deadline has already passed, so
#       replaying elsewhere burns capacity to miss it again). The HTTP
#       frontend maps it to a clean, retryable 503 with Retry-After.
#
# The markers live here (not in dataplane.py) because engines raise these
# without importing the dataplane; dataplane imports this module already.

SHED_WIRE = "worker overloaded (shed)"
DEADLINE_WIRE = "deadline exceeded"


class EngineOverloadedError(ValueError):
    """Admission refused: the engine's bounded queue is full (or the
    frontend's in-flight ceiling is hit). Retryable — on the data plane
    this surfaces to peers as a ConnectionError so the migration layer
    retries on another instance. Subclasses ValueError so a multihost
    follower replaying a leader-rejected add swallows the symmetric
    rejection the same way it swallows validation errors."""

    wire = SHED_WIRE


class DeadlineExceededError(RuntimeError):
    """The request's deadline passed while it was still queued (never
    admitted, nothing streamed). Typed and clean — the client can retry
    with a fresh deadline — but never replayed by migration."""

    wire = DEADLINE_WIRE


@dataclass
class Annotated:
    """SSE-shaped event envelope flowing through LLM pipelines.

    Exactly one of ``data`` (a payload chunk) or ``event``+``comment``
    (a named signal, e.g. ``error`` or an annotation) is typically set.
    """

    data: Any = None
    event: str | None = None
    comment: list[str] = field(default_factory=list)
    id: str | None = None

    @classmethod
    def from_data(cls, data: Any) -> "Annotated":
        return cls(data=data)

    @classmethod
    def from_error(cls, message: str) -> "Annotated":
        return cls(event="error", comment=[message])

    @property
    def is_error(self) -> bool:
        return self.event == "error"

    def error_message(self) -> str | None:
        return "; ".join(self.comment) if self.is_error else None

    def to_wire(self) -> dict:
        out: dict[str, Any] = {}
        if self.data is not None:
            out["d"] = self.data
        if self.event is not None:
            out["e"] = self.event
        if self.comment:
            out["c"] = self.comment
        if self.id is not None:
            out["id"] = self.id
        return out

    @classmethod
    def from_wire(cls, msg: dict) -> "Annotated":
        return cls(
            data=msg.get("d"),
            event=msg.get("e"),
            comment=msg.get("c", []),
            id=msg.get("id"),
        )
