"""The OpenAI frontend process (``python -m dynamo_tpu_torch.frontend``).

The port's copy of ``dynamo_tpu/frontend/__init__.py``, held to it by
``tests/test_torch_copies.py``.
"""
