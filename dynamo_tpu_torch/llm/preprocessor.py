"""OpenAI request preprocessing and response postprocessing.

The port's copy of ``dynamo_tpu/llm/preprocessor.py``, held to it by
``tests/test_torch_copies.py``.

Request path: OpenAI chat/completion request → chat-template render →
tokenize → :class:`PreprocessedRequest` (sampling + stop conditions
extracted, default max_tokens fitted to context length).

Response path: stream of :class:`LLMEngineOutput` chunks → incremental
detokenize + stop engine (:mod:`dynamo_tpu.llm.detokenizer`) → OpenAI SSE
chunk objects with TTFT-correct first-chunk role delta and final usage.

Capability parity: reference `lib/llm/src/preprocessor.rs:92-328`
(OpenAIPreprocessor: preprocess_request + response transform) and
`preprocessor/prompt.rs` (template render).
"""

from __future__ import annotations

import time
from typing import Any, AsyncIterator

from dynamo_tpu_torch.llm.detokenizer import Decoder
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.llm.protocols.common import LLMEngineOutput, PreprocessedRequest
from dynamo_tpu_torch.llm.protocols.openai import (
    ChatChunkChoice,
    ChatCompletionChunk,
    ChatCompletionRequest,
    ChatDelta,
    CompletionChoice,
    CompletionRequest,
    CompletionResponse,
    Usage,
    new_request_id,
)
from dynamo_tpu_torch.llm.tokenizer import Tokenizer, load_tokenizer


class OpenAIPreprocessor:
    def __init__(self, mdc: ModelDeploymentCard, tokenizer: Tokenizer | None = None):
        self.mdc = mdc
        self.tokenizer = tokenizer or load_tokenizer(mdc.tokenizer)

    # -- request side ------------------------------------------------------

    def preprocess_chat(self, request: ChatCompletionRequest) -> PreprocessedRequest:
        from dynamo_tpu_torch.llm.multimodal import split_images, splice_pseudo_tokens

        messages = [m.model_dump(exclude_none=True) for m in request.messages]
        vocab = getattr(self.tokenizer, "vocab_size", 32000)
        messages, image_refs = split_images(messages)
        prompt = self.tokenizer.apply_chat_template(
            messages, add_generation_prompt=True
        )
        token_ids = self.tokenizer.encode(prompt)
        mm = None
        if image_refs:
            token_ids, positions = splice_pseudo_tokens(
                token_ids, image_refs, vocab, self.tokenizer.encode
            )
            mm = {"images": image_refs, "positions": positions}
        pre = self._build(request, token_ids)
        pre.mm = mm
        return pre

    def preprocess_completion(self, request: CompletionRequest) -> PreprocessedRequest:
        prompt = request.prompt
        if isinstance(prompt, list) and prompt and isinstance(prompt[0], int):
            token_ids = list(prompt)  # pre-tokenized
        elif isinstance(prompt, list):
            token_ids = self.tokenizer.encode("".join(prompt))
        else:
            token_ids = self.tokenizer.encode(prompt)
        return self._build(request, token_ids)

    def _build(self, request: Any, token_ids: list[int]) -> PreprocessedRequest:
        budget = max(1, self.mdc.context_length - len(token_ids))
        stop = request.stop_conditions(default_max_tokens=budget)
        if stop.max_tokens is not None:
            stop.max_tokens = min(stop.max_tokens, budget)
        return PreprocessedRequest(
            model=request.model,
            token_ids=token_ids,
            sampling=request.sampling_options(),
            stop=stop,
            output=request.output_options(),
            router=dict(request.dyn.router),
            annotations=list(request.dyn.annotations),
            spec_decode=(
                dict(request.dyn.spec_decode)
                if request.dyn.spec_decode is not None
                else None
            ),
            priority=request.dyn.priority,
            deadline_ms=request.dyn.deadline_ms,
        )

    def make_decoder(self, pre: PreprocessedRequest) -> Decoder:
        return Decoder(
            self.tokenizer,
            prompt_token_ids=pre.token_ids,
            stop=pre.stop.stop,
            stop_token_ids=pre.stop.stop_token_ids,
            ignore_eos=pre.stop.ignore_eos,
            max_tokens=pre.stop.max_tokens,
            min_tokens=pre.stop.min_tokens,
            skip_special_tokens=pre.output.skip_special_tokens,
        )

    # -- logprob formatting ------------------------------------------------

    def _tok_str(self, tid: int) -> str:
        return self.tokenizer.decode([tid], skip_special_tokens=False)

    def _chat_logprobs(self, entries: list[dict]) -> dict:
        """Engine logprob records -> OpenAI chat ``choices[].logprobs``
        (reference protocol shape: protocols/openai, perf/logprobs.rs)."""
        content = []
        for e in entries:
            s = self._tok_str(e["token_id"])
            content.append(
                {
                    "token": s,
                    "logprob": e["logprob"],
                    "bytes": list(s.encode()),
                    "top_logprobs": [
                        {"token": self._tok_str(t), "logprob": lp}
                        for t, lp in e.get("top", [])
                    ],
                }
            )
        return {"content": content}

    def _completion_logprobs(self, entries: list[dict], text_offset: int) -> dict:
        """OpenAI completions ``logprobs`` block (tokens / token_logprobs /
        top_logprobs / text_offset)."""
        tokens, tlps, tops, offs = [], [], [], []
        for e in entries:
            s = self._tok_str(e["token_id"])
            tokens.append(s)
            tlps.append(e["logprob"])
            tops.append({self._tok_str(t): lp for t, lp in e.get("top", [])})
            offs.append(text_offset)
            text_offset += len(s)
        return {
            "tokens": tokens,
            "token_logprobs": tlps,
            "top_logprobs": tops,
            "text_offset": offs,
        }

    # -- response side -----------------------------------------------------

    async def postprocess_chat_stream(
        self,
        pre: PreprocessedRequest,
        engine_stream: AsyncIterator[LLMEngineOutput],
        request_id: str | None = None,
        include_usage: bool = False,
        on_complete=None,  # called with completion_tokens at stream end
    ) -> AsyncIterator[ChatCompletionChunk]:
        """Engine chunks → OpenAI chat chunks. Ends the moment a stop
        condition fires, even if the engine keeps streaming."""
        rid = request_id or new_request_id("chatcmpl")
        created = int(time.time())
        decoder = self.make_decoder(pre)
        sent_role = False
        finish: str | None = None
        completion_tokens = 0
        cached = 0

        def chunk(
            delta: ChatDelta, finish_reason: str | None = None, logprobs: dict | None = None
        ) -> ChatCompletionChunk:
            return ChatCompletionChunk(
                id=rid,
                created=created,
                model=pre.model,
                choices=[
                    ChatChunkChoice(
                        index=0, delta=delta, finish_reason=finish_reason, logprobs=logprobs
                    )
                ],
            )

        async for out in engine_stream:
            if not sent_role:
                sent_role = True
                yield chunk(ChatDelta(role="assistant", content=""))
            completion_tokens += len(out.token_ids)
            cached = out.meta.get("cached_tokens", cached)
            step = decoder.step_many(out.token_ids)
            lp = self._chat_logprobs(out.logprobs) if out.logprobs else None
            if step.text or lp:
                yield chunk(ChatDelta(content=step.text or ""), logprobs=lp)
            finish = step.finish_reason or out.finish_reason
            if step.finish_reason:
                break
        if not sent_role:
            yield chunk(ChatDelta(role="assistant", content=""))

        from dynamo_tpu_torch.llm.protocols.common import FinishReason

        reason = FinishReason(finish).as_openai() if finish else "stop"
        final = chunk(ChatDelta(), finish_reason=reason)
        if include_usage:
            final.usage = Usage(
                prompt_tokens=len(pre.token_ids),
                completion_tokens=completion_tokens,
                total_tokens=len(pre.token_ids) + completion_tokens,
                prompt_tokens_details={"cached_tokens": cached} if cached else None,
            )
        if on_complete is not None:
            on_complete(completion_tokens)
        yield final

    async def postprocess_completion(
        self,
        pre: PreprocessedRequest,
        engine_stream: AsyncIterator[LLMEngineOutput],
        request_id: str | None = None,
        stream: bool = False,
        on_complete=None,  # called with completion_tokens at stream end
    ) -> AsyncIterator[CompletionResponse]:
        """Engine chunks → completion responses (stream chunks or one final)."""
        rid = request_id or new_request_id("cmpl")
        created = int(time.time())
        decoder = self.make_decoder(pre)
        pieces: list[str] = []
        finish: str | None = None
        completion_tokens = 0
        lp_entries: list[dict] = []
        text_len = 0

        async for out in engine_stream:
            completion_tokens += len(out.token_ids)
            step = decoder.step_many(out.token_ids)
            lp = None
            if out.logprobs:
                lp_entries.extend(out.logprobs)
                lp = self._completion_logprobs(out.logprobs, text_len)
            text_len += len(step.text)
            if step.text or lp:
                if stream:
                    yield CompletionResponse(
                        id=rid,
                        created=created,
                        model=pre.model,
                        choices=[CompletionChoice(text=step.text, logprobs=lp)],
                    )
                else:
                    pieces.append(step.text)
            finish = step.finish_reason or out.finish_reason
            if step.finish_reason:
                break

        from dynamo_tpu_torch.llm.protocols.common import FinishReason

        reason = FinishReason(finish).as_openai() if finish else "stop"
        usage = Usage(
            prompt_tokens=len(pre.token_ids),
            completion_tokens=completion_tokens,
            total_tokens=len(pre.token_ids) + completion_tokens,
        )
        if on_complete is not None:
            on_complete(completion_tokens)
        yield CompletionResponse(
            id=rid,
            created=created,
            model=pre.model,
            choices=[
                CompletionChoice(
                    text="" if stream else "".join(pieces),
                    finish_reason=reason,
                    logprobs=(
                        self._completion_logprobs(lp_entries, 0)
                        if lp_entries and not stream
                        else None
                    ),
                )
            ],
            usage=usage,
        )
