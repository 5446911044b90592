"""OpenAI-compatible API types (requests, responses, SSE chunks).

The port's copy of ``dynamo_tpu/llm/protocols/openai.py``, held to it by
``tests/test_torch_copies.py``.

Pydantic models for the HTTP surface: `/v1/chat/completions`,
`/v1/completions`, `/v1/models`. Extension fields beyond the OpenAI schema
live under ``dyn`` (parity with the reference's ``nvext``,
`lib/llm/src/protocols/openai/nvext.rs:247`): ignore_eos, min_tokens,
per-request router overrides, annotations.

Capability parity: reference `lib/llm/src/protocols/openai/*` +
vendored async-openai types.
"""

from __future__ import annotations

import time
import uuid
from typing import Any, Literal, Union

from pydantic import BaseModel, ConfigDict, Field

from dynamo_tpu_torch.llm.protocols.common import (
    OutputOptions,
    SamplingOptions,
    StopConditions,
)


class DynExt(BaseModel):
    """dynamo_tpu request extensions (the reference's nvext equivalent)."""

    model_config = ConfigDict(extra="allow")
    ignore_eos: bool = False
    min_tokens: int = 0
    annotations: list[str] = Field(default_factory=list)
    # Router overrides: {"backend_instance_id": int} pins a worker;
    # {"overlap_weight": float, "router_temperature": float} tune scoring.
    router: dict[str, Any] = Field(default_factory=dict)
    # Speculative-decoding override: {"method": "ngram"|"off", "k": int,
    # ...} — rides PreprocessedRequest.spec_decode to the worker engine
    # (greedy output is bit-identical with or without it).
    spec_decode: dict[str, Any] | None = None
    # Overload robustness (ISSUE 10): completion deadline budget in ms
    # (the x-request-deadline-ms header overrides it) — a request still
    # queued past its deadline gets a typed retryable error instead of
    # late tokens. priority orders requests WITHIN the caller's tenant
    # queue (higher first); tenancy itself comes from the validated
    # x-tenant-id header, never the request body.
    deadline_ms: float | None = None
    priority: int = 0


class FunctionCall(BaseModel):
    name: str
    arguments: str


class ToolCall(BaseModel):
    id: str
    type: Literal["function"] = "function"
    function: FunctionCall


class ContentPart(BaseModel):
    model_config = ConfigDict(extra="allow")
    type: str
    text: str | None = None
    image_url: dict | None = None


class ChatMessage(BaseModel):
    model_config = ConfigDict(extra="allow")
    role: str
    content: Union[str, list[ContentPart], None] = None
    name: str | None = None
    tool_calls: list[ToolCall] | None = None
    tool_call_id: str | None = None
    reasoning_content: str | None = None

    def text_content(self) -> str:
        if self.content is None:
            return ""
        if isinstance(self.content, str):
            return self.content
        return "".join(p.text or "" for p in self.content if p.type == "text")


class StreamOptions(BaseModel):
    include_usage: bool = False


class ResponseFormat(BaseModel):
    model_config = ConfigDict(extra="allow")
    type: str = "text"


class _CommonRequest(BaseModel):
    model_config = ConfigDict(extra="allow")
    model: str
    max_tokens: int | None = None
    temperature: float | None = None
    top_p: float | None = None
    top_k: int | None = None
    n: int = 1
    stream: bool = False
    stream_options: StreamOptions | None = None
    stop: Union[str, list[str], None] = None
    seed: int | None = None
    frequency_penalty: float | None = None
    presence_penalty: float | None = None
    repetition_penalty: float | None = None
    logprobs: Any = None
    user: str | None = None
    dyn: DynExt = Field(default_factory=DynExt)

    def sampling_options(self) -> SamplingOptions:
        return SamplingOptions(
            temperature=self.temperature if self.temperature is not None else 1.0,
            top_p=self.top_p if self.top_p is not None else 1.0,
            top_k=self.top_k if self.top_k is not None else -1,
            seed=self.seed,
            frequency_penalty=self.frequency_penalty or 0.0,
            presence_penalty=self.presence_penalty or 0.0,
            repetition_penalty=self.repetition_penalty or 1.0,
            n=self.n,
        )

    def stop_conditions(self, default_max_tokens: int | None = None) -> StopConditions:
        stop = self.stop if isinstance(self.stop, list) else ([self.stop] if self.stop else [])
        return StopConditions(
            max_tokens=self.max_tokens or default_max_tokens,
            min_tokens=self.dyn.min_tokens,
            stop=stop,
            ignore_eos=self.dyn.ignore_eos,
        )


class ChatCompletionRequest(_CommonRequest):
    messages: list[ChatMessage]
    max_completion_tokens: int | None = None
    tools: list[dict] | None = None
    tool_choice: Any = None
    response_format: ResponseFormat | None = None
    top_logprobs: int | None = None

    def stop_conditions(self, default_max_tokens: int | None = None) -> StopConditions:
        sc = super().stop_conditions(default_max_tokens)
        if self.max_completion_tokens is not None:
            sc.max_tokens = self.max_completion_tokens
        return sc

    def output_options(self) -> OutputOptions:
        want = bool(self.logprobs)
        return OutputOptions(logprobs=(self.top_logprobs or 1) if want else None)


class CompletionRequest(_CommonRequest):
    prompt: Union[str, list[str], list[int], list[list[int]]]
    echo: bool = False
    best_of: int | None = None

    def output_options(self) -> OutputOptions:
        k = self.logprobs if isinstance(self.logprobs, int) else None
        return OutputOptions(logprobs=k, echo=self.echo)


class EmbeddingRequest(BaseModel):
    model_config = ConfigDict(extra="allow")
    model: str
    input: Union[str, list[str], list[int], list[list[int]]]
    encoding_format: str = "float"


# -- responses ---------------------------------------------------------------


class Usage(BaseModel):
    prompt_tokens: int = 0
    completion_tokens: int = 0
    total_tokens: int = 0
    prompt_tokens_details: dict | None = None


class ChatDelta(BaseModel):
    role: str | None = None
    content: str | None = None
    reasoning_content: str | None = None
    tool_calls: list[dict] | None = None


class ChatChunkChoice(BaseModel):
    index: int = 0
    delta: ChatDelta
    finish_reason: str | None = None
    logprobs: dict | None = None


class ChatCompletionChunk(BaseModel):
    id: str
    object: Literal["chat.completion.chunk"] = "chat.completion.chunk"
    created: int
    model: str
    choices: list[ChatChunkChoice]
    usage: Usage | None = None


class ChatChoice(BaseModel):
    index: int = 0
    message: ChatMessage
    finish_reason: str | None = None
    logprobs: dict | None = None


class ChatCompletionResponse(BaseModel):
    id: str
    object: Literal["chat.completion"] = "chat.completion"
    created: int
    model: str
    choices: list[ChatChoice]
    usage: Usage | None = None


class CompletionChoice(BaseModel):
    index: int = 0
    text: str
    finish_reason: str | None = None
    logprobs: dict | None = None


class CompletionResponse(BaseModel):
    id: str
    object: Literal["text_completion"] = "text_completion"
    created: int
    model: str
    choices: list[CompletionChoice]
    usage: Usage | None = None


class ModelInfo(BaseModel):
    id: str
    object: Literal["model"] = "model"
    created: int = Field(default_factory=lambda: int(time.time()))
    owned_by: str = "dynamo-tpu"
    max_model_len: int | None = None


class ModelList(BaseModel):
    object: Literal["list"] = "list"
    data: list[ModelInfo] = Field(default_factory=list)


def new_request_id(prefix: str = "cmpl") -> str:
    return f"{prefix}-{uuid.uuid4().hex}"
