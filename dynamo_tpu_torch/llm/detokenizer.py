"""Incremental detokenization + stop-condition state machine.

The port's copy of ``dynamo_tpu/llm/detokenizer.py``, held to it by
``tests/test_torch_copies.py``.

Turning a token stream into a text stream has two subtleties this module
owns:

1. **Incremental decode** — multi-byte characters and merge-sensitive
   tokenizers mean you cannot decode tokens one at a time; we keep a
   sliding (prefix_offset, read_offset) window and only emit text once it
   is stable (the standard incremental-detokenization algorithm).
2. **Hidden stop sequences** — stop strings must never appear in output,
   including across chunk boundaries, so text that could be the prefix of a
   stop string is *jailed* (held back) until disambiguated.

Capability parity: reference `lib/llm/src/backend.rs:285-407` (`Decoder`,
`StopTrigger`, jail protection, `step`).
"""

from __future__ import annotations

from dataclasses import dataclass

from dynamo_tpu_torch.llm.tokenizer import Tokenizer

_REPLACEMENT = "�"


class IncrementalDetokenizer:
    def __init__(
        self,
        tokenizer: Tokenizer,
        prompt_token_ids: list[int] | None = None,
        skip_special_tokens: bool = True,
    ):
        self._tok = tokenizer
        self._skip_special = skip_special_tokens
        self._ids: list[int] = list(prompt_token_ids or [])
        self._prefix_offset = max(0, len(self._ids) - 6)
        self._read_offset = len(self._ids)

    def step(self, token_ids: list[int] | int) -> str:
        """Feed newly generated token(s); returns newly stable text."""
        if isinstance(token_ids, int):
            token_ids = [token_ids]
        self._ids.extend(token_ids)
        prefix_text = self._tok.decode(
            self._ids[self._prefix_offset : self._read_offset],
            skip_special_tokens=self._skip_special,
        )
        full_text = self._tok.decode(
            self._ids[self._prefix_offset :], skip_special_tokens=self._skip_special
        )
        if len(full_text) <= len(prefix_text) or full_text.endswith(_REPLACEMENT):
            # No stable new text yet (mid-merge or mid-codepoint).
            return ""
        new_text = full_text[len(prefix_text) :]
        self._prefix_offset = self._read_offset
        self._read_offset = len(self._ids)
        return new_text


class StopStringChecker:
    """Jails text that could still become a stop string.

    ``step`` returns (text safe to emit now, stopped). Once a stop string
    is found, everything from its first character on is suppressed.
    """

    def __init__(self, stop_strings: list[str]):
        self.stops = [s for s in stop_strings if s]
        self._jail = ""
        self.stopped = False

    def step(self, text: str) -> tuple[str, bool]:
        if self.stopped:
            return "", True
        if not self.stops:
            return text, False
        buf = self._jail + text
        earliest = -1
        for s in self.stops:
            idx = buf.find(s)
            if idx != -1 and (earliest == -1 or idx < earliest):
                earliest = idx
        if earliest != -1:
            self.stopped = True
            self._jail = ""
            return buf[:earliest], True
        # Hold back the longest tail that is a proper prefix of any stop.
        holdback = 0
        for s in self.stops:
            for k in range(min(len(s) - 1, len(buf)), 0, -1):
                if buf.endswith(s[:k]):
                    holdback = max(holdback, k)
                    break
        if holdback:
            self._jail = buf[-holdback:]
            return buf[:-holdback], False
        self._jail = ""
        return buf, False

    def flush(self) -> str:
        """Release any jailed text at end-of-stream (no stop ever matched)."""
        out, self._jail = self._jail, ""
        return out


@dataclass
class DecodeStep:
    text: str
    finish_reason: str | None  # FinishReason value or None


class Decoder:
    """Token stream → text stream with full stop handling.

    Checks, in order: stop token ids (hidden — their text is never shown),
    EOS (unless ignore_eos), stop strings (hidden via jail), max_tokens.
    """

    def __init__(
        self,
        tokenizer: Tokenizer,
        prompt_token_ids: list[int] | None = None,
        stop: list[str] | None = None,
        stop_token_ids: list[int] | None = None,
        eos_token_id: int | None = None,
        ignore_eos: bool = False,
        max_tokens: int | None = None,
        min_tokens: int = 0,
        skip_special_tokens: bool = True,
    ):
        self._detok = IncrementalDetokenizer(tokenizer, prompt_token_ids, skip_special_tokens)
        self._stop_checker = StopStringChecker(stop or [])
        self._stop_ids = set(stop_token_ids or [])
        self._eos = eos_token_id if eos_token_id is not None else tokenizer.eos_token_id
        self._ignore_eos = ignore_eos
        self._max_tokens = max_tokens
        self._min_tokens = min_tokens
        self.generated = 0
        self.finished: str | None = None

    def step(self, token_id: int) -> DecodeStep:
        if self.finished:
            return DecodeStep("", self.finished)
        self.generated += 1
        past_min = self.generated > self._min_tokens

        if past_min and token_id in self._stop_ids:
            self.finished = "stop"
            return DecodeStep(self._stop_checker.flush(), self.finished)
        if past_min and not self._ignore_eos and token_id == self._eos:
            self.finished = "eos"
            return DecodeStep(self._stop_checker.flush(), self.finished)

        text = self._detok.step(token_id)
        emit, hit = self._stop_checker.step(text)
        if hit:
            self.finished = "stop"
            return DecodeStep(emit, self.finished)
        if self._max_tokens is not None and self.generated >= self._max_tokens:
            self.finished = "length"
            return DecodeStep(emit + self._stop_checker.flush(), self.finished)
        return DecodeStep(emit, None)

    def step_many(self, token_ids: list[int]) -> DecodeStep:
        texts: list[str] = []
        for t in token_ids:
            s = self.step(t)
            texts.append(s.text)
            if s.finish_reason:
                return DecodeStep("".join(texts), s.finish_reason)
        return DecodeStep("".join(texts), None)
