"""Reasoning parsers: split chain-of-thought from the final answer.

The port's copy of ``dynamo_tpu/llm/parsers/reasoning.py``, held to it by
``tests/test_torch_copies.py``.

Capability parity: reference `lib/parsers/src/reasoning/*` (deepseek-r1
``<think>`` tags, gpt-oss channel markers). The streaming parser carves an
incremental text stream into (reasoning_delta, content_delta) pairs so the
frontend can emit OpenAI ``reasoning_content`` deltas live.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class ReasoningSplit:
    reasoning_content: str | None
    content: str | None


class ThinkTagParser:
    """DeepSeek-R1 family: ``<think> ... </think> answer``.

    Models sometimes omit the opening tag (the template pre-opens it), so
    a stream that hits ``</think>`` without ``<think>`` counts everything
    before it as reasoning.
    """

    OPEN = "<think>"
    CLOSE = "</think>"

    def parse(self, text: str) -> ReasoningSplit:
        close = text.find(self.CLOSE)
        if close < 0:
            if text.lstrip().startswith(self.OPEN):
                body = text.lstrip()[len(self.OPEN):]
                return ReasoningSplit(reasoning_content=body.strip() or None, content=None)
            return ReasoningSplit(reasoning_content=None, content=text.strip() or None)
        head = text[:close]
        open_idx = head.find(self.OPEN)
        reasoning = head[open_idx + len(self.OPEN):] if open_idx >= 0 else head
        content = text[close + len(self.CLOSE):]
        return ReasoningSplit(
            reasoning_content=reasoning.strip() or None,
            content=content.strip() or None,
        )


class GptOssChannelParser:
    """gpt-oss: ``<|channel|>analysis ...<|channel|>final ...`` — analysis
    channels are reasoning, the final channel is the answer."""

    MARK = "<|channel|>"

    def parse(self, text: str) -> ReasoningSplit:
        if self.MARK not in text:
            return ReasoningSplit(reasoning_content=None, content=text.strip() or None)
        reasoning_parts: list[str] = []
        content_parts: list[str] = []
        for segment in text.split(self.MARK):
            if not segment:
                continue
            name, _, body = segment.partition("\n")
            name = name.strip().lower()
            if name.startswith("final"):
                content_parts.append(body)
            else:
                reasoning_parts.append(body)
        return ReasoningSplit(
            reasoning_content="\n".join(p.strip() for p in reasoning_parts) or None,
            content="\n".join(p.strip() for p in content_parts) or None,
        )


class StreamingThinkParser:
    """Incremental ``<think>`` splitter: feed deltas, get
    (reasoning_delta, content_delta) back without waiting for the end."""

    def __init__(self) -> None:
        self._buf = ""
        self._in_reasoning: bool | None = None  # unknown until tags seen
        self._done_reasoning = False

    def feed(self, delta: str) -> tuple[str, str]:
        self._buf += delta
        reasoning_out: list[str] = []
        content_out: list[str] = []
        while self._buf:
            if self._done_reasoning:
                content_out.append(self._buf)
                self._buf = ""
                break
            if self._in_reasoning is None:
                stripped = self._buf.lstrip()
                if ThinkTagParser.OPEN.startswith(stripped[: len(ThinkTagParser.OPEN)]) and len(
                    stripped
                ) < len(ThinkTagParser.OPEN):
                    break  # maybe a partial "<think"
                if stripped.startswith(ThinkTagParser.OPEN):
                    self._in_reasoning = True
                    self._buf = stripped[len(ThinkTagParser.OPEN):]
                    continue
                self._in_reasoning = False
            if self._in_reasoning:
                close = self._buf.find(ThinkTagParser.CLOSE)
                if close >= 0:
                    reasoning_out.append(self._buf[:close])
                    self._buf = self._buf[close + len(ThinkTagParser.CLOSE):]
                    self._done_reasoning = True
                    continue
                # Hold back a possible partial close tag.
                safe = max(0, len(self._buf) - len(ThinkTagParser.CLOSE) + 1)
                reasoning_out.append(self._buf[:safe])
                self._buf = self._buf[safe:]
                break
            content_out.append(self._buf)
            self._buf = ""
        return "".join(reasoning_out), "".join(content_out)

    def flush(self) -> tuple[str, str]:
        buf, self._buf = self._buf, ""
        if self._done_reasoning or self._in_reasoning is False or self._in_reasoning is None:
            return "", buf
        return buf, ""


REASONING_PARSERS = {
    "deepseek_r1": ThinkTagParser,
    "gpt_oss": GptOssChannelParser,
}


def parse_reasoning(text: str, parser: str) -> ReasoningSplit:
    try:
        return REASONING_PARSERS[parser]().parse(text)
    except KeyError:
        raise ValueError(
            f"unknown reasoning parser {parser!r}; have {sorted(REASONING_PARSERS)}"
        )
