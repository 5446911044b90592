"""Disaggregated prefill/decode: decision, target choice, hot-reload.

The port's copy of ``dynamo_tpu/llm/disagg/__init__.py``, held to it by
``tests/test_torch_copies.py``.

The local-vs-remote prefill decision and store-watched config live in
``router``, the NetCost-priced decode-target choice in ``target``. The
streaming chunk-pipelined handoff itself is the sibling
``llm/disagg_pool`` package.
"""

from dynamo_tpu_torch.llm.disagg.router import (  # noqa: F401
    DISAGG_CONFIG_KEY,
    DisaggConfig,
    DisaggRouter,
)
from dynamo_tpu_torch.llm.disagg.target import (  # noqa: F401
    choose_decode_target,
)
