"""Structured logging + W3C trace-context propagation.

The port's copy of ``dynamo_tpu/runtime/logging_setup.py``, held to it by
``tests/test_torch_copies.py``.

JSONL log records and per-request ``traceparent`` generation/extraction so
worker spans parent to frontend spans across process boundaries — the
headers dict on every data-plane request carries the traceparent.

Capability parity: reference `lib/runtime/src/logging.rs:111-253`
(trace-id generation, header extraction into NATS headers, JSONL via
DYN_LOGGING_JSONL).
"""

from __future__ import annotations

import json
import logging
import secrets
import sys
import time

TRACEPARENT_HEADER = "traceparent"


def make_traceparent(trace_id: str | None = None, span_id: str | None = None) -> str:
    return "00-{}-{}-01".format(
        trace_id or secrets.token_hex(16), span_id or secrets.token_hex(8)
    )


def parse_traceparent(value: str) -> tuple[str, str] | None:
    """Returns (trace_id, parent_span_id) or None if malformed."""
    parts = value.split("-")
    if len(parts) != 4 or len(parts[1]) != 32 or len(parts[2]) != 16:
        return None
    return parts[1], parts[2]


def child_traceparent(parent: str | None) -> str:
    """New span under the same trace (or a brand-new trace)."""
    if parent:
        parsed = parse_traceparent(parent)
        if parsed:
            return make_traceparent(trace_id=parsed[0])
    return make_traceparent()


class JsonlFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        out = {
            "ts": round(time.time(), 6),
            "level": record.levelname,
            "target": record.name,
            "msg": record.getMessage(),
        }
        for attr in ("trace_id", "span_id", "request_id"):
            val = getattr(record, attr, None)
            if val is not None:
                out[attr] = val
        if record.exc_info:
            out["exception"] = self.formatException(record.exc_info)
        return json.dumps(out)


def setup_logging(level: str = "INFO", jsonl: bool = False) -> None:
    handler = logging.StreamHandler(sys.stderr)
    if jsonl:
        handler.setFormatter(JsonlFormatter())
    else:
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
        )
    root = logging.getLogger()
    root.handlers.clear()
    root.addHandler(handler)
    root.setLevel(level.upper())
