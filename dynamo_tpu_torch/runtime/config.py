"""Runtime configuration from environment (+ optional file overlay).

The port's copy of ``dynamo_tpu/runtime/config.py``, held to it by
``tests/test_torch_copies.py``.

Env prefix scheme mirrors the reference's figment config
(`lib/runtime/src/config.rs:37,69-181`): ``DYN_RUNTIME_*`` for runtime
knobs, ``DYN_SYSTEM_*`` for the status server, ``DYN_WORKER_*`` for worker
behavior. Values: env beats file beats defaults.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field, fields

from dynamo_tpu_torch import knobs


def _env(name: str, default, cast=None):
    # Fallbacks here are non-literal (file-overlaid RuntimeConfig field
    # values), which is exactly why this wrapper survives next to
    # dynamo_tpu.knobs: env beats file beats registry default.
    raw = os.environ.get(name)
    if raw is None:
        return default
    cast = cast or type(default)
    if cast is bool:
        return raw.lower() in ("1", "true", "yes", "on")
    return cast(raw)


@dataclass
class RuntimeConfig:
    store_address: str = knobs.default("DYN_STORE_ADDRESS")
    lease_ttl_s: float = knobs.default("DYN_RUNTIME_LEASE_TTL_S")
    ingress_host: str = knobs.default("DYN_RUNTIME_INGRESS_HOST")
    namespace: str = knobs.default("DYN_NAMESPACE")
    # System status server (health/metrics), 0 port = ephemeral, None = off
    system_enabled: bool = knobs.default("DYN_SYSTEM_ENABLED")
    system_port: int = knobs.default("DYN_SYSTEM_PORT")
    # Logging
    logging_jsonl: bool = knobs.default("DYN_LOGGING_JSONL")
    log_level: str = knobs.default("DYN_LOG_LEVEL")
    # Request tracing (dynamo_tpu/tracing): DYN_TRACE_* prefix
    trace_enabled: bool = knobs.default("DYN_TRACE_ENABLED")
    trace_sample: float = knobs.default("DYN_TRACE_SAMPLE")
    trace_buffer: int = knobs.default("DYN_TRACE_BUFFER")
    # Graceful drain budget on SIGTERM: how long in-flight streams get
    # to finish after the worker deregisters from discovery. Stragglers
    # past the budget are killed (peers migrate them by token replay).
    drain_timeout_s: float = knobs.default("DYN_WORKER_DRAIN_TIMEOUT_S")

    @classmethod
    def from_env(cls, config_file: str | None = None) -> "RuntimeConfig":
        base: dict = {}
        path = config_file or knobs.raw("DYN_RUNTIME_CONFIG")
        if path and os.path.exists(path):
            with open(path) as f:
                base = json.load(f)
        cfg = cls(**{k: v for k, v in base.items() if k in {f.name for f in fields(cls)}})
        cfg.store_address = _env("DYN_STORE_ADDRESS", cfg.store_address)
        cfg.lease_ttl_s = _env("DYN_RUNTIME_LEASE_TTL_S", cfg.lease_ttl_s)
        cfg.ingress_host = _env("DYN_RUNTIME_INGRESS_HOST", cfg.ingress_host)
        cfg.namespace = _env("DYN_NAMESPACE", cfg.namespace)
        cfg.system_enabled = _env("DYN_SYSTEM_ENABLED", cfg.system_enabled)
        cfg.system_port = _env("DYN_SYSTEM_PORT", cfg.system_port)
        cfg.logging_jsonl = _env("DYN_LOGGING_JSONL", cfg.logging_jsonl)
        cfg.log_level = _env("DYN_LOG_LEVEL", cfg.log_level)
        cfg.trace_enabled = _env("DYN_TRACE_ENABLED", cfg.trace_enabled)
        cfg.trace_sample = _env("DYN_TRACE_SAMPLE", cfg.trace_sample)
        cfg.trace_buffer = _env("DYN_TRACE_BUFFER", cfg.trace_buffer)
        cfg.drain_timeout_s = _env("DYN_WORKER_DRAIN_TIMEOUT_S", cfg.drain_timeout_s)
        return cfg
