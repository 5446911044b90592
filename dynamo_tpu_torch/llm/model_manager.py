"""Per-model serving state on a frontend: preprocessor + routed pipeline.

The port's copy of ``dynamo_tpu/llm/model_manager.py``, held to it by
``tests/test_torch_copies.py``.

The :class:`ModelManager` reacts to discovery events: when a model gains
its first worker it builds the preprocessor (tokenizer from the MDC), the
endpoint client, the KV router (in ``kv`` mode), and the routed pipeline
segment ``MigrationOperator → RouterEgress`` (a runtime/pipeline.py
ServicePipeline — further operators compose in front via
``Migration.build_pipeline``); when its last worker leaves, everything is
torn down. Request handlers look models up here.

Capability parity: reference `lib/llm/src/discovery/model_manager.rs` +
`entrypoint/input/common.rs:216` (build_routed_pipeline: the per-model
pipeline SegmentSource→Preprocessor→Backend→Migration→Router assembled on
model-add; the operator-graph machinery is `runtime/src/pipeline/nodes.rs`).
"""

from __future__ import annotations

import asyncio
import logging
from dataclasses import dataclass
from typing import Any, AsyncIterator

from dynamo_tpu_torch.llm.discovery import ModelEntry, ModelWatcher
from dynamo_tpu_torch.llm.kv_router.protocols import RouterConfig
from dynamo_tpu_torch.llm.kv_router.publisher import MetricsAggregator
from dynamo_tpu_torch.runtime.worker_monitor import WorkerMonitor
from dynamo_tpu_torch.llm.kv_router.router import KvPushRouter, KvRouter
from dynamo_tpu_torch.llm.migration import Migration
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
from dynamo_tpu_torch.llm.protocols.common import LLMEngineOutput, PreprocessedRequest
from dynamo_tpu_torch.runtime import DistributedRuntime
from dynamo_tpu_torch.runtime.component import EndpointClient

log = logging.getLogger("dynamo_tpu.model_manager")


@dataclass
class ServedModel:
    entry: ModelEntry
    mdc: ModelDeploymentCard
    preprocessor: OpenAIPreprocessor
    client: EndpointClient
    kv_router: KvRouter | None
    push_router: KvPushRouter | None
    migration: Migration
    # Live fleet load (ForwardPassMetrics per worker; ProcessedEndpoints
    # snapshots) — busy-aware routing + planner observation source.
    aggregator: MetricsAggregator | None = None

    async def generate(
        self, pre: PreprocessedRequest, headers: dict[str, str] | None = None
    ) -> AsyncIterator[LLMEngineOutput]:
        """Route a preprocessed request and decode wire chunks, with
        mid-stream migration on worker failure."""
        async for out in self.migration.generate(pre, headers):
            yield out


class ModelManager:
    def __init__(
        self,
        runtime: DistributedRuntime,
        router_mode: str = "kv",  # "kv" | "round_robin" | "random"
        router_config: RouterConfig | None = None,
    ):
        self.runtime = runtime
        self.router_mode = router_mode
        self.router_config = router_config
        self.models: dict[str, ServedModel] = {}
        # Degraded-mode wiring (ISSUE 15): a last-instance lease expiry
        # only defers the model teardown while the model's endpoint
        # client still holds routable instances — quarantine keeps those
        # cached exactly when the DATA plane answered, so "the router can
        # still place requests" is the liveness judgment here.
        self.watcher = ModelWatcher(
            runtime.store, data_plane_live=self._data_plane_live
        )
        self.watcher.on_model_added.append(self._on_added)
        self.watcher.on_model_removed.append(self._on_removed)
        self._model_event = asyncio.Event()

    def _data_plane_live(self, name: str) -> bool:
        served = self.models.get(name)
        return bool(served is not None and served.client.instances)

    async def start(self) -> None:
        await self.watcher.start()

    async def stop(self) -> None:
        await self.watcher.stop()
        for served in self.models.values():
            await served.client.stop()
            if served.kv_router:
                await served.kv_router.stop()
            if served.aggregator:
                await served.aggregator.stop()

    async def _on_added(self, entry: ModelEntry, mdc: ModelDeploymentCard) -> None:
        endpoint = (
            self.runtime.namespace(entry.namespace)
            .component(entry.component)
            .endpoint(entry.endpoint)
        )
        client = await endpoint.client()
        kv_router = None
        push_router = None
        aggregator = None
        if self.router_mode == "kv":
            from dataclasses import replace as _replace

            config = (
                _replace(self.router_config) if self.router_config else RouterConfig()
            )
            if config.block_size is None:
                config.block_size = mdc.kv_block_size
            kv_router = KvRouter(
                self.runtime.store, entry.namespace, entry.component, config
            )
            await kv_router.start()
            monitor = WorkerMonitor(
                self.runtime.store,
                entry.namespace,
                entry.component,
                busy_threshold=config.busy_threshold or 0.95,
                queue_threshold=config.queue_threshold,
            )
            await monitor.start()
            aggregator = monitor.aggregator
            push_router = KvPushRouter(client, kv_router, monitor=monitor)
        migration = Migration(
            client=client,
            push_router=push_router,
            mode=self.router_mode,
            limit=mdc.migration_limit,
        )
        self.models[entry.name] = ServedModel(
            entry=entry,
            mdc=mdc,
            preprocessor=OpenAIPreprocessor(mdc),
            client=client,
            kv_router=kv_router,
            push_router=push_router,
            migration=migration,
            aggregator=aggregator,
        )
        self._model_event.set()
        self._model_event = asyncio.Event()
        log.info("model %r ready (router=%s)", entry.name, self.router_mode)

    async def _on_removed(self, name: str) -> None:
        served = self.models.pop(name, None)
        if served:
            await served.client.stop()
            if served.kv_router:
                await served.kv_router.stop()
            if served.aggregator:
                await served.aggregator.stop()
        log.info("model %r removed", name)

    def get(self, name: str) -> ServedModel | None:
        return self.models.get(name)

    def list_models(self) -> list[ServedModel]:
        return list(self.models.values())

    async def wait_for_model(self, name: str, timeout: float = 30.0) -> ServedModel:
        async def _wait() -> ServedModel:
            while name not in self.models:
                await self._model_event.wait()
            return self.models[name]

        return await asyncio.wait_for(_wait(), timeout)
