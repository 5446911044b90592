"""Central registry of every environment knob the tree reads.

The port's copy of ``dynamo_tpu/knobs.py``, held to it by
``tests/test_torch_copies.py``.

One table owns every ``DYN_*`` / ``DYNAMO_TPU_*`` environment variable:
its single default, its parse kind, the README section documenting it,
and a one-line operator-facing description. Call sites read through
:func:`get` (or the typed ``get_*`` helpers) so a knob's default exists
in exactly one place; ``tools/dynacheck``'s ``config-knob`` rule fails
the build on any env read outside this registry, any registered knob
nobody reads, and any inline literal default that re-states (or
contradicts) the registry.

``python -m tools.dynacheck --knobs-md`` emits the README table from
this registry; CI diffs the two so doc rot fails the build.

Import discipline: stdlib only. This module sits at the bottom of the
package import graph (``dynamo_tpu/__init__`` is docstring-only), so
kernels, tracing, runtime, and planner code can all read it without
cycles.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

# Recognized knob name prefixes. The dynacheck knob rule treats any env
# read whose (statically resolved) name starts with one of these as a
# knob read that must resolve into KNOBS.
PREFIXES = ("DYN_", "DYNAMO_TPU_")


@dataclass(frozen=True)
class Knob:
    name: str
    default: object            # the ONE default, typed per `kind`
    kind: str                  # "str" | "int" | "float" | "bool"
    section: str               # grouping header in the README knob table
    doc: str                   # one-line operator-facing description


def _freeze(*knobs: Knob) -> dict[str, Knob]:
    table: dict[str, Knob] = {}
    for k in knobs:
        if k.name in table:
            raise ValueError(f"duplicate knob registration: {k.name}")
        table[k.name] = k
    return table


KNOBS: dict[str, Knob] = _freeze(
    # -- control-plane store & runtime ----------------------------------
    Knob("DYN_STORE_ADDRESS", "127.0.0.1:6650", "str", "runtime",
         "control-plane store `host:port` every component dials"),
    Knob("DYN_RUNTIME_CONFIG", "", "str", "runtime",
         "optional JSON config file overlaying `RuntimeConfig` defaults"),
    Knob("DYN_RUNTIME_LEASE_TTL_S", 10.0, "float", "runtime",
         "discovery lease TTL; keepalives beat at ttl/3"),
    Knob("DYN_RUNTIME_INGRESS_HOST", "127.0.0.1", "str", "runtime",
         "bind host for per-worker dataplane ingress servers"),
    Knob("DYN_NAMESPACE", "dynamo", "str", "runtime",
         "default discovery namespace"),
    Knob("DYN_SYSTEM_ENABLED", True, "bool", "runtime",
         "serve the per-process system status server (/health, /metrics)"),
    Knob("DYN_SYSTEM_PORT", 0, "int", "runtime",
         "system status server port (0 = ephemeral)"),
    Knob("DYN_LOGGING_JSONL", False, "bool", "runtime",
         "emit JSONL structured logs instead of human-readable lines"),
    Knob("DYN_LOG_LEVEL", "INFO", "str", "runtime",
         "root log level"),
    Knob("DYN_WORKER_DRAIN_TIMEOUT_S", 30.0, "float", "runtime",
         "graceful-drain budget on SIGTERM; the planner connector "
         "escalates after +5 s slack"),
    Knob("DYN_DISCOVERY_STALE_GRACE_S", 30.0, "float", "runtime",
         "how long a lease-expiry keeps an instance routable "
         "(quarantined + probed) before removal; 0 disables"),
    Knob("DYN_CHAOS_PLAN", "", "str", "runtime",
         "fault-injection plan: inline JSON or `@path`; empty disables"),
    # -- dataplane egress -----------------------------------------------
    Knob("DYN_DATAPLANE_CONNECT_TIMEOUT_S", 5.0, "float", "dataplane",
         "egress dial deadline per attempt"),
    Knob("DYN_DATAPLANE_STALL_TIMEOUT_S", 60.0, "float", "dataplane",
         "per-token stall deadline on a response stream; 0 disables"),
    Knob("DYN_DATAPLANE_BREAKER_THRESHOLD", 5, "int", "dataplane",
         "consecutive failures that open a per-address circuit breaker"),
    Knob("DYN_DATAPLANE_BREAKER_RESET_S", 2.0, "float", "dataplane",
         "open-breaker window before a half-open probe is admitted"),
    # -- tracing --------------------------------------------------------
    Knob("DYN_TRACE_ENABLED", True, "bool", "tracing",
         "master switch for span recording (off = <1 µs no-op)"),
    Knob("DYN_TRACE_SAMPLE", 1.0, "float", "tracing",
         "head-sampling rate, deterministic on the trace id"),
    Knob("DYN_TRACE_BUFFER", 4096, "int", "tracing",
         "per-process span ring-buffer capacity"),
    # -- SLOs, planner, flight recorder ---------------------------------
    Knob("DYN_SLO_TTFT_MS", 200.0, "float", "slo",
         "time-to-first-token SLO target, milliseconds (one spelling "
         "across SLO attribution and autoscaling)"),
    Knob("DYN_SLO_TPOT_MS", 50.0, "float", "slo",
         "per-output-token SLO target, milliseconds"),
    Knob("DYN_FLIGHT_STEPS", 256, "int", "slo",
         "flight-recorder ring capacity in steps (0 disables)"),
    Knob("DYN_FLIGHT_DIR", "", "str", "slo",
         "flight-recorder artifact directory (empty = $TMPDIR/dynamo_flight)"),
    # -- cluster KV pool ------------------------------------------------
    Knob("DYN_KV_POOL_FRAME_TIMEOUT_S", 10.0, "float", "kv-pool",
         "per-frame deadline on a peer KV pull stream"),
    Knob("DYN_KV_POOL_PULL_TIMEOUT_S", 30.0, "float", "kv-pool",
         "whole-pull deadline on a peer KV prefix fetch"),
    # -- disaggregated serving ------------------------------------------
    Knob("DYN_DISAGG_STREAMING", True, "bool", "disagg",
         "chunk-pipelined KV handoff: pull committed prefill chunks "
         "while prefill is still running (off = legacy pull-after-prefill)"),
    Knob("DYN_DISAGG_CHUNK_BLOCKS", 16, "int", "disagg",
         "KV blocks pulled per streaming-handoff window"),
    Knob("DYN_DISAGG_CURSOR_TIMEOUT_S", 30.0, "float", "disagg",
         "max wait for the first chunk-cursor event before the handoff "
         "degrades to the reply-gated legacy pull"),
    Knob("DYN_DISAGG_CHUNK_US_PER_BLOCK", 20.0, "float", "disagg",
         "mocker virtual-clock price per handoff block (chunk-pipelined "
         "transfer cost in the deterministic fleet A/B)"),
    # -- speculative decoding -------------------------------------------
    Knob("DYN_SPEC_DRAFT_ROUND_US", 10.0, "float", "spec",
         "mocker virtual-clock price per on-device draft round (ring "
         "match + gather between megastep inner iterations)"),
    # -- pipeline parallelism -------------------------------------------
    Knob("DYN_PP_HOP_US", 200.0, "float", "pp",
         "mocker virtual-clock price per pipeline stage hop (one "
         "lax.ppermute boundary crossing; the fused-megastep A/B prices "
         "k*pp + pp-1 hops per dispatch against pp hops per token on the "
         "host-rollback baseline)"),
    # -- TPU kernels ----------------------------------------------------
    Knob("DYNAMO_TPU_PAGED_ATTN", "xla", "str", "kernels",
         "paged-attention backend: `xla` or `pallas`"),
    Knob("DYNAMO_TPU_ATTN_PAGES_PER_BLOCK", 8, "int", "kernels",
         "ragged-attention kernel: KV pages fetched per grid block"),
    Knob("DYNAMO_TPU_ATTN_QUERIES_PER_BLOCK", 8, "int", "kernels",
         "ragged-attention kernel: decode queries per grid block"),
    Knob("DYNAMO_TPU_ATTN_PREFILL_QUERIES_PER_BLOCK", 128, "int", "kernels",
         "ragged-attention kernel: prefill queries per grid block"),
    Knob("DYNAMO_TPU_NO_NATIVE", "", "str", "kernels",
         "non-empty disables the C++ radix-trie indexer (pure-Python "
         "fallback)"),
)

_TRUTHY = ("1", "true", "yes", "on")


def raw(name: str) -> str | None:
    """The raw env string for a REGISTERED knob, or None if unset."""
    knob = KNOBS[name]  # KeyError = unregistered knob: register it first
    return os.environ.get(knob.name)


def get(name: str):
    """Parsed value of a registered knob: env if set and parseable,
    else the registry default."""
    knob = KNOBS[name]
    value = os.environ.get(name)
    if value is None:
        return knob.default
    try:
        if knob.kind == "int":
            return int(value)
        if knob.kind == "float":
            return float(value)
        if knob.kind == "bool":
            return value.strip().lower() in _TRUTHY
        return value
    except ValueError:
        return knob.default


def get_str(name: str) -> str:
    return str(get(name))


def get_int(name: str) -> int:
    return int(get(name))


def get_float(name: str) -> float:
    return float(get(name))


def get_bool(name: str) -> bool:
    return bool(get(name))


def default(name: str):
    """The registry default — the one place it is defined. Dataclass
    field defaults that mirror a knob source from here."""
    return KNOBS[name].default
