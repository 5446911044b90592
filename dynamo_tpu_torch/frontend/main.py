"""Frontend process: OpenAI HTTP server + model discovery + router.

The port's copy of ``dynamo_tpu/frontend/main.py``, held to it by
``tests/test_torch_copies.py``.

``python -m dynamo_tpu_torch.frontend --http-port 8000 --router-mode kv``
auto-discovers workers via the control plane and serves every registered
model. Capability parity: reference
`components/frontend/src/dynamo/frontend/main.py:1-120`.
"""

from __future__ import annotations

import argparse
import asyncio

from dynamo_tpu_torch.llm.admission import AdmissionConfig
from dynamo_tpu_torch.llm.http_service import HttpService
from dynamo_tpu_torch.llm.kv_router.protocols import RouterConfig
from dynamo_tpu_torch.llm.model_manager import ModelManager
from dynamo_tpu_torch.runtime import DistributedRuntime
from dynamo_tpu_torch.runtime.worker import dynamo_worker


async def run_frontend(
    runtime: DistributedRuntime,
    http_host: str = "0.0.0.0",
    http_port: int = 8000,
    router_mode: str = "kv",
    router_config: RouterConfig | None = None,
    ready_event: asyncio.Event | None = None,
    service_out: list | None = None,
    tls_cert: str | None = None,
    tls_key: str | None = None,
    admission: AdmissionConfig | None = None,
    fleet_obs: bool = True,
    obs_namespace: str = "dynamo",
    obs_interval_s: float = 1.0,
    aggregators_out: dict | None = None,
) -> None:
    manager = ModelManager(runtime, router_mode=router_mode, router_config=router_config)
    await manager.start()
    service = HttpService(
        manager, host=http_host, port=http_port, tls_cert=tls_cert, tls_key=tls_key,
        admission=admission,
        # Drain visibility: the SIGTERM drain flips /health to 503 and
        # refuses new LLM requests with a retryable shed error.
        draining_fn=lambda: runtime.draining,
    )
    # Control-plane outage visibility (ISSUE 15): /health shows degraded
    # (200, still routable) while the store session is down; store_*
    # gauges ride this frontend's /metrics.
    service.bind_store(runtime.store)
    aggregators: dict = {}
    snap_pub = None
    if fleet_obs:
        # Fleet observability (ISSUE 13), embedded mode: per-namespace
        # aggregators compose worker snapshots into the frontend's own
        # /metrics (worker_id labels + rollups) and serve /fleet; the
        # frontend publishes its OWN snapshot (request/latency counters,
        # http/tokenize/route phase records) so a standalone aggregator
        # and the planner's fleet observer see the full picture too.
        from dynamo_tpu_torch import tracing
        from dynamo_tpu_torch.obs.service import attach_aggregator
        from dynamo_tpu_torch.obs.slo import (
            FRONTEND_COMPLETE_ON,
            FRONTEND_PHASES,
            PhaseScanner,
        )
        from dynamo_tpu_torch.obs.snapshot import SnapshotPublisher, frontend_totals

        aggregators = await attach_aggregator(
            runtime, manager, service, out=aggregators_out
        )
        snap_pub = SnapshotPublisher(
            runtime.store, obs_namespace, runtime.primary_lease_id,
            role="frontend", component="frontend",
            interval_s=obs_interval_s,
        )
        snap_pub.collectors = {
            "frontend": lambda: frontend_totals(service.metrics)
        }
        _collector = tracing.get_collector()
        snap_pub.phase_source = _collector.phase_totals
        snap_pub.request_source = PhaseScanner(
            _collector, names=FRONTEND_PHASES,
            complete_on=FRONTEND_COMPLETE_ON,
        ).scan
        await snap_pub.start()

        async def _retire_snapshot() -> None:
            await snap_pub.retire(timeout=5.0)

        runtime.on_drain.append(_retire_snapshot)
    await service.start()
    if service_out is not None:
        service_out.append(service)
    if ready_event is not None:
        ready_event.set()
    try:
        await runtime.wait_for_shutdown()
    finally:
        if snap_pub is not None:
            await snap_pub.stop()
        for agg in aggregators.values():
            await agg.stop()
        await service.stop()
        await manager.stop()


def main() -> None:
    ap = argparse.ArgumentParser(description="dynamo-tpu OpenAI frontend")
    ap.add_argument("--http-host", default="0.0.0.0")
    ap.add_argument("--http-port", type=int, default=8000)
    ap.add_argument(
        "--router-mode", choices=["kv", "round_robin", "random"], default="kv"
    )
    ap.add_argument("--kv-overlap-weight", type=float, default=1.0)
    ap.add_argument("--tls-cert-path", default=None, help="serve HTTPS with this cert")
    ap.add_argument("--tls-key-path", default=None)
    ap.add_argument(
        "--kv-replica-sync",
        action="store_true",
        help="synchronize router state across frontend replicas",
    )
    ap.add_argument("--router-temperature", type=float, default=0.0)
    ap.add_argument(
        "--kv-cache-block-size",
        type=int,
        default=None,
        help="override the model card's KV block size (must match workers)",
    )
    ap.add_argument(
        "--busy-threshold", type=float, default=None,
        help="route around workers whose KV usage (or queue saturation) "
             "is at/above this fraction while alternatives exist",
    )
    ap.add_argument(
        "--queue-threshold", type=int, default=None,
        help="route around workers with at least this many queued "
             "requests (saturation-aware routing; workers exporting a "
             "queue limit are skipped at that limit automatically)",
    )
    ap.add_argument(
        "--network-aware-routing", default="off", choices=["on", "off"],
        help="extend KV routing cost beyond prefix overlap: candidates "
             "are charged their queue depth, and the prefill a candidate "
             "could skip by pulling a peer's cached prefix is discounted "
             "by that peer's MEASURED per-block transfer cost "
             "(ForwardPassMetrics.net) — decode placement and "
             "peer-prefix pulls both shift away from slow/loaded peers. "
             "Streams are bit-identical on or off",
    )
    ap.add_argument(
        "--queue-weight", type=float, default=1.0,
        help="blocks-equivalent routing cost per queued request on a "
             "candidate (network-aware routing's load term)",
    )
    ap.add_argument(
        "--recompute-ms-per-block", type=float, default=2.0,
        help="local prefill recompute cost per KV block in ms — the "
             "yardstick a MEASURED peer pull must beat before "
             "network-aware routing counts the pull as relief; set from "
             "the engine profile (block_size * prefill us/token / 1000)",
    )
    ap.add_argument(
        "--tenant-rate-limit", type=float, default=0.0,
        help="per-tenant sustained requests/second (x-tenant-id header "
             "keys the bucket); over-limit answers 429 + Retry-After. "
             "0 = off",
    )
    ap.add_argument(
        "--tenant-burst", type=int, default=0,
        help="per-tenant burst allowance (token-bucket capacity); "
             "0 = auto from the rate",
    )
    ap.add_argument(
        "--fleet-obs", default="on", choices=["on", "off"],
        help="embed the fleet metrics aggregator: worker snapshots from "
             "the event plane compose onto this frontend's /metrics "
             "(worker_id labels + rollups) and /fleet renders the "
             "per-tenant SLO breakdown",
    )
    ap.add_argument(
        "--obs-interval-s", type=float, default=1.0,
        help="this frontend's own metric-snapshot publish interval",
    )
    ap.add_argument(
        "--obs-namespace", default="dynamo",
        help="namespace this frontend publishes its OWN snapshot under "
             "(request/latency counters + http/tokenize/route phase "
             "records); must match the workers' --namespace or the "
             "aggregator never merges the frontend side",
    )
    ap.add_argument(
        "--max-inflight-requests", type=int, default=0,
        help="concurrently admitted LLM requests across all tenants; at "
             "the ceiling new requests get a retryable 503. 0 = unbounded",
    )
    args = ap.parse_args()

    config = RouterConfig(
        overlap_weight=args.kv_overlap_weight,
        temperature=args.router_temperature,
        block_size=args.kv_cache_block_size,
        replica_sync=args.kv_replica_sync,
        busy_threshold=args.busy_threshold,
        queue_threshold=args.queue_threshold,
        network_aware=args.network_aware_routing == "on",
        queue_weight=args.queue_weight,
        recompute_ms_per_block=args.recompute_ms_per_block,
    )
    admission = AdmissionConfig(
        tenant_rate=args.tenant_rate_limit,
        tenant_burst=args.tenant_burst,
        max_inflight=args.max_inflight_requests,
    )

    @dynamo_worker()
    async def entry(runtime: DistributedRuntime) -> None:
        await run_frontend(
            runtime,
            http_host=args.http_host,
            http_port=args.http_port,
            router_mode=args.router_mode,
            router_config=config,
            tls_cert=args.tls_cert_path,
            tls_key=args.tls_key_path,
            admission=admission,
            fleet_obs=args.fleet_obs == "on",
            obs_namespace=args.obs_namespace,
            obs_interval_s=args.obs_interval_s,
        )

    entry()


if __name__ == "__main__":
    main()
