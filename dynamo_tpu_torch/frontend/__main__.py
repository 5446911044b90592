"""``python -m dynamo_tpu_torch.frontend``.

The port's copy of ``dynamo_tpu/frontend/__main__.py``, held to it by
``tests/test_torch_copies.py``.
"""

from dynamo_tpu_torch.frontend.main import main

main()
