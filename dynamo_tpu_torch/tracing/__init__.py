"""dynamo_tpu.tracing — distributed request tracing with per-phase
latency attribution.

The port's copy of ``dynamo_tpu/tracing/__init__.py``, held to it by
``tests/test_torch_copies.py``.

See :mod:`dynamo_tpu.tracing.core` for the model. Quick tour::

    from dynamo_tpu_torch import tracing

    tracer = tracing.get_tracer("frontend")
    with tracer.span("http", headers=request.headers) as root:
        with tracer.span("tokenize", parent=root) as t:
            ids = tok.encode(prompt)
            t.set("tokens", len(ids))
        headers = tracing.inject_headers(root, {"x-request-id": rid})
        ...  # downstream processes parent to `root` via the header

    tracing.get_collector().traces(limit=10)   # what /traces serves
"""

from dynamo_tpu_torch.tracing.core import (
    NOOP_SPAN,
    Span,
    SpanContext,
    TraceCollector,
    Tracer,
    configure,
    extract_context,
    get_collector,
    get_tracer,
    inject_headers,
    phase_order,
    trace_enabled,
)

__all__ = [
    "NOOP_SPAN",
    "Span",
    "SpanContext",
    "TraceCollector",
    "Tracer",
    "configure",
    "extract_context",
    "get_collector",
    "get_tracer",
    "inject_headers",
    "phase_order",
    "trace_enabled",
]
