"""The port's copy of ``dynamo_tpu/runtime/store/__init__.py``, held to it by
``tests/test_torch_copies.py``."""

from dynamo_tpu_torch.runtime.store.client import StoreClient, WatchEvent, Subscription
from dynamo_tpu_torch.runtime.store.server import StoreServer

__all__ = ["StoreClient", "StoreServer", "WatchEvent", "Subscription"]
