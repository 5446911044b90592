"""Background-task hygiene: spawn asyncio tasks without losing exceptions.

The port's copy of ``dynamo_tpu/runtime/tasks.py``, held to it by
``tests/test_torch_copies.py``.

The event loop keeps only weak references to tasks, so a bare
``asyncio.create_task(coro())`` can be garbage-collected mid-flight, and
its exception surfaces (if ever) only as an "exception was never
retrieved" message at gc time. ``spawn_logged`` keeps a strong reference
until completion and logs unexpected failures — the pattern dynalint's
``fire-and-forget-task`` rule pushes call sites toward.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Any, Coroutine

log = logging.getLogger("dynamo_tpu.runtime.tasks")

# Strong refs: a spawned task must not be collectable before it finishes.
_BACKGROUND: set[asyncio.Task] = set()


def spawn_logged(
    coro: Coroutine[Any, Any, Any],
    *,
    name: str | None = None,
    logger: logging.Logger | None = None,
) -> asyncio.Task:
    """``create_task`` + strong reference + failure logging.

    Cancellation is normal shutdown and stays silent; any other exception
    is logged with its traceback. Returns the task so callers that want a
    handle (to cancel on shutdown) can keep one — but unlike a bare
    ``create_task`` they don't have to.
    """
    task = asyncio.get_running_loop().create_task(coro, name=name)
    _BACKGROUND.add(task)
    lg = logger or log

    def _done(t: asyncio.Task) -> None:
        _BACKGROUND.discard(t)
        if t.cancelled():
            return
        exc = t.exception()
        if exc is not None:
            lg.error("background task %r failed", t.get_name(), exc_info=exc)

    task.add_done_callback(_done)
    return task
