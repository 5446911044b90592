"""The distributed runtime: store client, data plane, components, workers.

The port's copy of ``dynamo_tpu/runtime/__init__.py``, held to it by
``tests/test_torch_copies.py``.
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
from dynamo_tpu_torch.runtime.metrics import MetricsRegistry
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
    "MetricsRegistry",
    "Namespace",
    "NoInstancesError",
    "RuntimeConfig",
    "dynamo_worker",
]
