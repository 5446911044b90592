"""Tool-call and reasoning parsers (parity: reference lib/parsers).

The port's copy of ``dynamo_tpu/llm/parsers/__init__.py``, held to it by
``tests/test_torch_copies.py``.
"""

from dynamo_tpu_torch.llm.parsers.reasoning import (
    GptOssChannelParser,
    REASONING_PARSERS,
    ReasoningSplit,
    StreamingThinkParser,
    ThinkTagParser,
    parse_reasoning,
)
from dynamo_tpu_torch.llm.parsers.tool_calls import (
    PARSERS,
    ParsedMessage,
    ToolCall,
    detect_format,
    parse_tool_calls,
)

__all__ = [
    "GptOssChannelParser",
    "PARSERS",
    "ParsedMessage",
    "REASONING_PARSERS",
    "ReasoningSplit",
    "StreamingThinkParser",
    "ThinkTagParser",
    "ToolCall",
    "detect_format",
    "parse_reasoning",
    "parse_tool_calls",
]
