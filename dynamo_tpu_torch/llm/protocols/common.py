"""Internal LLM pipeline types: what flows between preprocessor, router,
workers, and the response path.

The port's copy of ``dynamo_tpu/llm/protocols/common.py``: the same
dataclasses and the same wire dicts, so a request and its output chunks
mean the same thing to either engine.

Everything here is msgpack-friendly (plain dicts on the wire via
``to_wire``/``from_wire``) because these cross process boundaries on the
data plane.

Capability parity: reference `lib/llm/src/protocols/common/llm_backend.rs`
(PreprocessedRequest / LLMEngineOutput) and `protocols/common/*` (sampling
and stop-condition extraction).
"""

from __future__ import annotations

import enum
from dataclasses import asdict, dataclass, field
from typing import Any


class FinishReason(str, enum.Enum):
    STOP = "stop"           # stop token / stop string hit
    LENGTH = "length"       # max_tokens reached
    EOS = "eos"             # model emitted EOS (maps to "stop" in OpenAI)
    CANCELLED = "cancelled"
    ERROR = "error"

    def as_openai(self) -> str:
        return "stop" if self in (FinishReason.EOS, FinishReason.STOP) else self.value


@dataclass
class SamplingOptions:
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = -1          # -1 = disabled
    seed: int | None = None
    frequency_penalty: float = 0.0
    presence_penalty: float = 0.0
    repetition_penalty: float = 1.0
    n: int = 1

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0


@dataclass
class StopConditions:
    max_tokens: int | None = None
    min_tokens: int = 0
    stop: list[str] = field(default_factory=list)
    stop_token_ids: list[int] = field(default_factory=list)
    ignore_eos: bool = False

    def check_token(
        self, token: int, n_generated: int, eos_token_ids
    ) -> str | None:
        """Token-level stop trigger: the single source of the eos > stop >
        length precedence used by the engine, the mocker, and the disagg
        first-token check (reference backend.rs:316 StopTrigger). String
        ``stop`` sequences are text-level and live in the detokenizer.
        ``n_generated`` includes ``token``."""
        if token in eos_token_ids and not self.ignore_eos and n_generated >= self.min_tokens:
            return FinishReason.EOS.value
        if token in self.stop_token_ids and n_generated >= self.min_tokens:
            return FinishReason.STOP.value
        if self.max_tokens is not None and n_generated >= self.max_tokens:
            return FinishReason.LENGTH.value
        return None

    def after_replay(self, n_emitted: int) -> "StopConditions":
        """Stop conditions for a token-replay continuation (migration /
        disagg fallback): ``n_emitted`` tokens already reached the client,
        so both the generation budget and the minimum shrink."""
        return StopConditions(
            max_tokens=(
                None if self.max_tokens is None else self.max_tokens - n_emitted
            ),
            min_tokens=max(0, self.min_tokens - n_emitted),
            stop=list(self.stop),
            stop_token_ids=list(self.stop_token_ids),
            ignore_eos=self.ignore_eos,
        )


@dataclass
class OutputOptions:
    logprobs: int | None = None   # top-k logprobs per token, None = off
    echo: bool = False
    skip_special_tokens: bool = True


@dataclass
class PreprocessedRequest:
    """A tokenized request, ready to route to any worker."""

    model: str
    token_ids: list[int]
    sampling: SamplingOptions = field(default_factory=SamplingOptions)
    stop: StopConditions = field(default_factory=StopConditions)
    output: OutputOptions = field(default_factory=OutputOptions)
    # Router hints / overrides (per-request, parity kv_router.rs:79)
    router: dict[str, Any] = field(default_factory=dict)
    # Disaggregation handoff (set by decode worker → prefill worker)
    kv_transfer_params: dict[str, Any] | None = None
    annotations: list[str] = field(default_factory=list)
    request_id: str | None = None
    # Multimodal: {"images": [ref, ...], "positions": [[start, count],
    # ...]} — token_ids carry content-fingerprint pseudo ids at those
    # positions; the worker resolves refs to embeddings (encoder fleet)
    # and the engine splices them over the placeholder rows
    # (llm/multimodal.py; reference examples/multimodal pipeline).
    mm: dict[str, Any] | None = None
    # Per-request speculative-decoding override (dynamo_tpu/spec):
    # {"method": "ngram"|"off", "k": int, "ngram_min": int, "ngram_max":
    # int, "window": int}. None = the worker engine's default policy.
    # Set from the OpenAI dyn.spec_decode extension by the preprocessor
    # and resolved at engine admission.
    spec_decode: dict[str, Any] | None = None
    # Token-replay continuation marker (migration / disagg fallback):
    # the trailing `replayed_tokens` entries of token_ids were GENERATED
    # by a previous attempt and already reached the client. A real model
    # conditions on them naturally (they are prompt now); the mocker uses
    # the count to keep its synthetic token function bit-identical across
    # a replay. 0 on every fresh request.
    replayed_tokens: int = 0
    # -- overload robustness (ISSUE 10) ---------------------------------
    # Fairness identity: the validated x-tenant-id header (frontend) or
    # "" for the default tenant. The scheduler's per-tenant DRR queues
    # key on this; it also labels the per-tenant /metrics gauges.
    tenant_id: str = ""
    # Ordering hint WITHIN a tenant's queue (higher admits first, FIFO
    # among equals). Never a cross-tenant bandwidth grant.
    priority: int = 0
    # Client-requested completion budget in milliseconds (dyn.deadline_ms
    # or x-request-deadline-ms) — observability + the source for
    # deadline_epoch when the frontend did not stamp one.
    deadline_ms: float | None = None
    # Absolute wall-clock deadline (time.time() domain), stamped by the
    # frontend at admission so downstream queue time counts against the
    # budget. A request still queued past this expires with a typed
    # DeadlineExceededError — never a broken stream.
    deadline_epoch: float | None = None

    def to_wire(self) -> dict:
        return asdict(self)

    @classmethod
    def from_wire(cls, d: dict) -> "PreprocessedRequest":
        return cls(
            model=d["model"],
            token_ids=list(d["token_ids"]),
            sampling=SamplingOptions(**d.get("sampling", {})),
            stop=StopConditions(**d.get("stop", {})),
            output=OutputOptions(**d.get("output", {})),
            router=d.get("router", {}),
            kv_transfer_params=d.get("kv_transfer_params"),
            annotations=d.get("annotations", []),
            request_id=d.get("request_id"),
            mm=d.get("mm"),
            spec_decode=d.get("spec_decode"),
            replayed_tokens=d.get("replayed_tokens", 0),
            tenant_id=d.get("tenant_id", ""),
            priority=d.get("priority", 0),
            deadline_ms=d.get("deadline_ms"),
            deadline_epoch=d.get("deadline_epoch"),
        )


@dataclass
class TokenLogProb:
    token_id: int
    logprob: float
    top: dict[int, float] = field(default_factory=dict)


@dataclass
class LLMEngineOutput:
    """One streamed chunk from a worker engine: newly generated tokens."""

    token_ids: list[int] = field(default_factory=list)
    finish_reason: str | None = None  # FinishReason value
    logprobs: list[dict] | None = None
    kv_transfer_params: dict[str, Any] | None = None
    # usage accounting (cumulative, present on final chunk)
    prompt_tokens: int | None = None
    completion_tokens: int | None = None
    # worker-reported metadata (e.g. cached_tokens for prefix-cache hits)
    meta: dict[str, Any] = field(default_factory=dict)

    def to_wire(self) -> dict:
        out: dict[str, Any] = {"token_ids": self.token_ids}
        if self.finish_reason is not None:
            out["finish_reason"] = self.finish_reason
        if self.logprobs is not None:
            out["logprobs"] = self.logprobs
        if self.kv_transfer_params is not None:
            out["kv_transfer_params"] = self.kv_transfer_params
        if self.prompt_tokens is not None:
            out["prompt_tokens"] = self.prompt_tokens
        if self.completion_tokens is not None:
            out["completion_tokens"] = self.completion_tokens
        if self.meta:
            out["meta"] = self.meta
        return out

    @classmethod
    def from_wire(cls, d: dict) -> "LLMEngineOutput":
        return cls(
            token_ids=list(d.get("token_ids", [])),
            finish_reason=d.get("finish_reason"),
            logprobs=d.get("logprobs"),
            kv_transfer_params=d.get("kv_transfer_params"),
            prompt_tokens=d.get("prompt_tokens"),
            completion_tokens=d.get("completion_tokens"),
            meta=d.get("meta", {}),
        )
