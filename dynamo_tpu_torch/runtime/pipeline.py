"""Composable service-pipeline graph: operators over streaming engines.

The port's copy of ``dynamo_tpu/runtime/pipeline.py``, held to it by
``tests/test_torch_copies.py``.

Capability parity: reference `lib/runtime/src/pipeline/nodes.rs` — a
ServicePipeline is a directed chain where each node acts on BOTH paths:
the forward/request direction and the backward/response direction. The
reference builds this from Source/Sink traits, typed edges, and
`PipelineOperator::forward_edge`/`backward_edge` plumbing; in Python the
whole construction collapses onto async generators (a node that receives
the request, may rewrite it, calls downstream, and transforms the yielded
stream IS both edges), so the graph machinery reduces to one protocol and
a linker. What survives the redesign is the load-bearing property the
reference calls out: an :class:`Operator` sees the forward path AND the
backward path of the same request, so it can carry state from one to the
other (retry-with-replay, usage accounting, tracing) — which a plain
"map over requests" or "map over responses" middleware cannot.

Assembly (reference `ServiceFrontend::link` chains):

    pipe = (
        PipelineBuilder()
        .link(TraceOperator())
        .link(MigrationOperator(limit=3))
        .backend(RouterEgress(client, router))
    )
    async for out in pipe.generate(request, Context()): ...

The assembled :class:`ServicePipeline` is itself an AsyncEngine, so
pipelines nest as nodes of larger pipelines (`lib/runtime/src/pipeline/
network.rs` achieves the same by making a remote segment look like a
local sink; here the data plane's client is just another backend).
"""

from __future__ import annotations

from typing import Any, AsyncIterator, Callable, Protocol, runtime_checkable

from dynamo_tpu_torch.runtime.engine import AsyncEngine, Context

# The downstream continuation an operator drives: "send this (possibly
# rewritten) request onward, stream me the responses".
NextFn = Callable[[Any, Context], AsyncIterator[Any]]


@runtime_checkable
class Operator(Protocol):
    """A node that transforms the forward and/or backward path.

    ``generate`` receives the request, the per-request context, and the
    downstream continuation. It may rewrite the request before invoking
    ``next``, transform or annotate the items the downstream yields,
    re-invoke ``next`` (retries), or short-circuit without calling it at
    all (caches, guards). Reference: `pipeline/nodes.rs` Operator trait.
    """

    def generate(
        self, request: Any, context: Context, next: NextFn
    ) -> AsyncIterator[Any]:
        ...


class FunctionOperator:
    """Adapter lifting plain functions into an :class:`Operator`:
    ``forward`` rewrites the request, ``backward`` maps each response
    item. Either may be ``None`` (identity)."""

    def __init__(
        self,
        forward: Callable[[Any, Context], Any] | None = None,
        backward: Callable[[Any, Context], Any] | None = None,
    ):
        self._forward = forward
        self._backward = backward

    async def generate(self, request: Any, context: Context, next: NextFn):
        if self._forward is not None:
            request = self._forward(request, context)
        async for item in next(request, context):
            yield self._backward(item, context) if self._backward else item


class ServicePipeline:
    """A linked operator chain terminating in a backend engine. The
    pipeline is itself an :class:`AsyncEngine` (nestable as a node)."""

    def __init__(self, operators: list[Operator], backend: AsyncEngine):
        self.operators = list(operators)
        self.backend = backend

    def generate(self, request: Any, context: Context) -> AsyncIterator[Any]:
        return self._stage(0)(request, context)

    def _stage(self, i: int) -> NextFn:
        if i == len(self.operators):
            return self.backend.generate
        op = self.operators[i]

        def run(request: Any, context: Context) -> AsyncIterator[Any]:
            return op.generate(request, context, self._stage(i + 1))

        return run


class PipelineBuilder:
    """`link()` operators in forward order, close with `backend()`.
    Reference: `ServiceFrontend::link(...).link(...)` chains
    (`pipeline/nodes.rs`), minus the typed-edge ceremony."""

    def __init__(self) -> None:
        self._operators: list[Operator] = []

    def link(self, operator: Operator) -> "PipelineBuilder":
        self._operators.append(operator)
        return self

    def backend(self, engine: AsyncEngine | Callable) -> ServicePipeline:
        if not isinstance(engine, AsyncEngine):
            engine = _CallableEngine(engine)
        return ServicePipeline(self._operators, engine)


class _CallableEngine:
    """Wrap a bare async-generator function as the terminal engine."""

    def __init__(self, fn: Callable[[Any, Context], AsyncIterator[Any]]):
        self._fn = fn

    def generate(self, request: Any, context: Context) -> AsyncIterator[Any]:
        return self._fn(request, context)
