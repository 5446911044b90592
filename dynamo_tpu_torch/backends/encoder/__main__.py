"""``python -m dynamo_tpu_torch.backends.encoder``.

The port's copy of ``dynamo_tpu/backends/encoder/__main__.py``, held to it
by ``tests/test_torch_copies.py``.
"""

from dynamo_tpu_torch.backends.encoder.main import main

main()
