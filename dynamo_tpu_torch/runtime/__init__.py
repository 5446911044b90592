"""The distributed runtime: store client, data plane, components, workers.

The port's copy of ``dynamo_tpu/runtime/__init__.py`` with its exports
except ``MetricsRegistry``: the Prometheus registry and the status server
wait for ``ROADMAP.md`` A6b.
"""

from dynamo_tpu_torch.runtime.component import (
    Component,
    DistributedRuntime,
    Endpoint,
    EndpointClient,
    Instance,
    Namespace,
    NoInstancesError,
)
from dynamo_tpu_torch.runtime.engine import Annotated, AsyncEngine, Context
from dynamo_tpu_torch.runtime.config import RuntimeConfig
from dynamo_tpu_torch.runtime.worker import dynamo_worker

__all__ = [
    "Annotated",
    "AsyncEngine",
    "Component",
    "Context",
    "DistributedRuntime",
    "Endpoint",
    "EndpointClient",
    "Instance",
    "Namespace",
    "NoInstancesError",
    "RuntimeConfig",
    "dynamo_worker",
]
