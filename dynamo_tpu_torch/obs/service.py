"""The aggregator as a service: standalone process or embedded helper.

The port's copy of ``dynamo_tpu/obs/service.py``, held to it by
``tests/test_torch_copies.py``.

Standalone (``python -m dynamo_tpu_torch.obs --namespace dynamo``): one process
that subscribes to the namespace's snapshot subject and serves the fleet
``/metrics`` + ``/fleet`` on its own status server — the reference's
``components/metrics`` service shape.

Embedded: the HTTP frontend calls :func:`attach_aggregator` so its own
``/metrics`` carries the fleet series and ``/fleet`` renders without a
second process (the common single-frontend deployment).
"""

from __future__ import annotations

import asyncio
import logging

from aiohttp import web

from dynamo_tpu_torch.obs.aggregator import FleetAggregator
from dynamo_tpu_torch.runtime.component import DistributedRuntime
from dynamo_tpu_torch.runtime.status_server import SystemStatusServer

log = logging.getLogger("dynamo_tpu.obs.service")


async def run_aggregator(
    runtime: DistributedRuntime,
    namespace: str = "dynamo",
    host: str = "0.0.0.0",
    port: int = 8082,
    stale_after_s: float = 10.0,
    ready_event: asyncio.Event | None = None,
    aggregator_out: list | None = None,
    status_out: list | None = None,
) -> None:
    """The standalone aggregator service loop (mirrors run_frontend's
    shape: create, serve, wait for shutdown, tear down)."""
    aggregator = FleetAggregator(
        runtime.store, namespace=namespace, stale_after_s=stale_after_s
    )
    status = SystemStatusServer(host=host, port=port)
    aggregator.bind(status.metrics, status.before_render)
    aggregator.slo.bind_metrics(status.metrics)

    async def fleet(request: web.Request) -> web.Response:
        return web.json_response(aggregator.fleet_payload())

    # Route added before start() — aiohttp freezes the router on setup.
    status.app.router.add_get("/fleet", fleet)
    await status.start()
    await aggregator.start()
    if aggregator_out is not None:
        aggregator_out.append(aggregator)
    if status_out is not None:
        status_out.append(status)
    log.info(
        "fleet aggregator serving namespace %r on http://%s:%d",
        namespace, host, status.port,
    )
    if ready_event is not None:
        ready_event.set()
    try:
        await runtime.wait_for_shutdown()
    finally:
        await aggregator.stop()
        await status.stop()


async def attach_aggregator(
    runtime: DistributedRuntime,
    manager,
    service,
    stale_after_s: float = 10.0,
    out: dict | None = None,
) -> dict[str, FleetAggregator]:
    """Embed a fleet aggregator in a running frontend: one aggregator per
    discovered namespace, bound to the frontend's own metrics registry
    (fleet series appear on the frontend's ``/metrics``; ``/fleet`` is
    served by the HTTP service). Worker retirement wires through each
    served model's discovery watch (lease loss) on top of the
    retired-snapshot and staleness paths.

    Returns the live ``{namespace: aggregator}`` map (it grows as models
    are discovered; pass ``out`` to share the live map with the caller)."""
    aggregators: dict[str, FleetAggregator] = out if out is not None else {}

    async def on_added(entry, mdc) -> None:
        agg = aggregators.get(entry.namespace)
        if agg is None:
            agg = FleetAggregator(
                runtime.store,
                namespace=entry.namespace,
                stale_after_s=stale_after_s,
            )
            agg.bind(service.metrics, service.before_metrics)
            agg.slo.bind_metrics(service.metrics)
            aggregators[entry.namespace] = agg
            await agg.start()
        served = manager.get(entry.name)
        if served is not None:
            # Lease-loss retirement: the same instance watch the router
            # uses to drop dead workers.
            agg.attach_client(served.client)

    # Runs after the manager's own _on_added (registration order), so the
    # ServedModel (and its client watch) already exists.
    manager.watcher.on_model_added.append(on_added)
    # Models discovered BEFORE the attach (workers registered first)
    # never fire the callback — sweep them now.
    for served in manager.list_models():
        await on_added(served.entry, served.mdc)
    service.fleet_fn = lambda: {
        ns: agg.fleet_payload() for ns, agg in aggregators.items()
    }
    return aggregators
