"""Worker process entrypoint helpers.

The port's copy of ``dynamo_tpu/runtime/worker.py``, held to it by
``tests/test_torch_copies.py``.

``@dynamo_worker`` turns an ``async def main(runtime, ...)`` into a process
entry: builds the DistributedRuntime from env/config, installs SIGINT/SIGTERM
→ graceful shutdown, runs the coroutine, and tears the runtime down.

Capability parity: reference `lib/runtime/src/worker.rs` (`Worker::execute`)
and the Python `@dynamo_worker` decorator
(`lib/bindings/python/src/dynamo/runtime`).
"""

from __future__ import annotations

import asyncio
import functools
import logging
import signal
from typing import Any, Awaitable, Callable

from dynamo_tpu_torch.runtime.component import DistributedRuntime
from dynamo_tpu_torch.runtime.config import RuntimeConfig
from dynamo_tpu_torch.runtime.logging_setup import setup_logging

log = logging.getLogger("dynamo_tpu.worker")


def dynamo_worker(
    config: RuntimeConfig | None = None,
) -> Callable[[Callable[..., Awaitable[Any]]], Callable[..., Any]]:
    def decorator(fn: Callable[..., Awaitable[Any]]) -> Callable[..., Any]:
        @functools.wraps(fn)
        def entry(*args: Any, **kwargs: Any) -> Any:
            cfg = config or RuntimeConfig.from_env()
            setup_logging(cfg.log_level, cfg.logging_jsonl)
            return asyncio.run(_run(fn, cfg, *args, **kwargs))

        return entry

    return decorator


async def _run(fn: Callable[..., Awaitable[Any]], cfg: RuntimeConfig, *args, **kwargs) -> Any:
    from dynamo_tpu_torch import tracing
    from dynamo_tpu_torch.runtime import chaos

    # Config-file overlays can differ from the env the tracing module
    # read at import — re-apply the resolved values.
    tracing.configure(
        enabled=cfg.trace_enabled, sample=cfg.trace_sample, buffer=cfg.trace_buffer
    )
    # Fault injection (DYN_CHAOS_PLAN): armed before any connection
    # exists so even the first store dial is under the plan.
    chaos.install_from_env()
    runtime = await DistributedRuntime.create(
        cfg.store_address, lease_ttl=cfg.lease_ttl_s, ingress_host=cfg.ingress_host
    )
    if cfg.system_enabled:
        from dynamo_tpu_torch.runtime.status_server import SystemStatusServer, bind_egress_gauges

        runtime.status = SystemStatusServer(port=cfg.system_port)
        await runtime.status.start()
        bind_egress_gauges(runtime.status, runtime.egress)
    loop = asyncio.get_running_loop()
    # SIGINT: immediate shutdown. SIGTERM: graceful drain — deregister
    # from discovery, stop admitting, finish (or migrate) in-flight
    # streams within the drain budget, release the lease, then exit.
    try:
        loop.add_signal_handler(signal.SIGINT, runtime.signal_shutdown)
        loop.add_signal_handler(
            signal.SIGTERM, runtime.request_drain, cfg.drain_timeout_s
        )
    except NotImplementedError:  # non-main thread
        pass
    try:
        return await fn(runtime, *args, **kwargs)
    finally:
        if runtime.status is not None:
            await runtime.status.stop()
        await runtime.shutdown()
