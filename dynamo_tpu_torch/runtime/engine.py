"""Request context and typed overload errors for the engine facade.

The port's copy of the pieces of ``dynamo_tpu/runtime/engine.py`` that the
serving engine uses: :class:`Context` (identity, headers and two-stage
cancellation) and the two typed rejections with their wire markers. The
rest of the runtime (store, data plane, pipelines) is the control-plane
slice of the port (``ROADMAP.md`` A6).
"""

from __future__ import annotations

import asyncio
import uuid
from typing import Any


class Context:
    """Per-request context: identity, tracing, and two-stage cancellation.

    ``stop`` asks the engine to finish gracefully (emit what it has);
    ``kill`` demands immediate abandonment.
    """

    def __init__(self, request_id: str | None = None, headers: dict[str, str] | None = None):
        self.id = request_id or uuid.uuid4().hex
        self.headers: dict[str, str] = headers or {}
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
        child.meta = dict(self.meta)
        child._stopped = self._stopped
        child._killed = self._killed
        return child


SHED_WIRE = "worker overloaded (shed)"
DEADLINE_WIRE = "deadline exceeded"


class EngineOverloadedError(ValueError):
    """Admission refused: the engine's bounded queue is full. Retryable on
    another instance."""

    wire = SHED_WIRE


class DeadlineExceededError(RuntimeError):
    """The request's deadline passed while it was still queued (never
    admitted, nothing streamed). Typed and clean, never replayed."""

    wire = DEADLINE_WIRE
