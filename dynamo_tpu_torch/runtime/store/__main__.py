"""The port's copy of ``dynamo_tpu/runtime/store/__main__.py``, held to it by
``tests/test_torch_copies.py``."""

from dynamo_tpu_torch.runtime.store.server import main

main()
