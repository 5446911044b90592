"""Tokenizer abstraction: HF tokenizers for real models, a dependency-free
byte-level tokenizer for tests/mocker.

The port's copy of ``dynamo_tpu/llm/tokenizer.py``, held to it by
``tests/test_torch_copies.py``.

Capability parity: reference `lib/llm/src/tokenizers.rs:576` (HF + GGUF
tokenizer wrappers behind one trait). The byte tokenizer replaces the
reference's reliance on downloaded test models — encode/decode are exact
inverses over UTF-8, which incremental detokenization tests exploit.
"""

from __future__ import annotations

import functools
import logging
from typing import Protocol, Sequence, runtime_checkable

log = logging.getLogger("dynamo_tpu.tokenizer")


@runtime_checkable
class Tokenizer(Protocol):
    eos_token_id: int
    vocab_size: int

    def encode(self, text: str) -> list[int]: ...
    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str: ...
    def apply_chat_template(self, messages: list[dict], add_generation_prompt: bool = True) -> str: ...


class ByteTokenizer:
    """Tokens 0..255 are raw UTF-8 bytes; specials sit above.

    Deterministic, zero-asset, and reversible — the workhorse of the test
    suite and the mocker engine.
    """

    BOS = 256
    EOS = 257
    PAD = 258

    def __init__(self) -> None:
        self.eos_token_id = self.EOS
        self.bos_token_id = self.BOS
        self.pad_token_id = self.PAD
        self.vocab_size = 259

    def encode(self, text: str) -> list[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        data = bytes(i for i in ids if i < 256)
        return data.decode("utf-8", errors="replace")

    def apply_chat_template(self, messages: list[dict], add_generation_prompt: bool = True) -> str:
        parts = [f"<|{m['role']}|>{m.get('content') or ''}" for m in messages]
        if add_generation_prompt:
            parts.append("<|assistant|>")
        return "\n".join(parts)


class HFTokenizer:
    """transformers.AutoTokenizer wrapper (local paths only — zero egress)."""

    def __init__(self, path: str):
        from transformers import AutoTokenizer

        self._tok = AutoTokenizer.from_pretrained(path, local_files_only=True)
        self.eos_token_id = self._tok.eos_token_id
        self.bos_token_id = getattr(self._tok, "bos_token_id", None)
        self.pad_token_id = getattr(self._tok, "pad_token_id", None)
        self.vocab_size = len(self._tok)

    def encode(self, text: str) -> list[int]:
        return self._tok.encode(text, add_special_tokens=False)

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        return self._tok.decode(list(ids), skip_special_tokens=skip_special_tokens)

    def apply_chat_template(self, messages: list[dict], add_generation_prompt: bool = True) -> str:
        if getattr(self._tok, "chat_template", None):
            return self._tok.apply_chat_template(
                messages, tokenize=False, add_generation_prompt=add_generation_prompt
            )
        # Fallback template for models shipping without one.
        parts = [f"<|{m['role']}|>\n{m.get('content') or ''}" for m in messages]
        if add_generation_prompt:
            parts.append("<|assistant|>\n")
        return "\n".join(parts)


@functools.lru_cache(maxsize=8)
def _load_cached(spec: str) -> Tokenizer:
    if spec.endswith(".gguf"):
        from dynamo_tpu_torch.engine.gguf import GGUFTokenizer, read_gguf

        return GGUFTokenizer.from_gguf(read_gguf(spec))
    return HFTokenizer(spec)


def load_tokenizer(spec: str) -> Tokenizer:
    """``"byte"`` → ByteTokenizer; ``*.gguf`` → the checkpoint's embedded
    tokenizer (engine/gguf.py); anything else is a local HF path. A
    checkpoint directory without tokenizer files serves byte-level with a
    warning instead of killing worker startup (weights-only checkpoints
    are common in tests and conversions). Successful loads are cached per
    spec (eos resolution and the preprocessor would otherwise parse the
    same multi-MB tokenizer.json twice at startup; tokenizers are
    read-only after construction) — the byte-level FALLBACK is not, so a
    tokenizer that appears later is picked up."""
    if spec == "byte":
        return ByteTokenizer()
    try:
        return _load_cached(spec)
    except Exception:  # noqa: BLE001 — see the narrowing below
        from pathlib import Path

        p = Path(spec)
        tok_files = (
            "tokenizer.json", "tokenizer_config.json", "vocab.json",
            "tokenizer.model",
        )
        if p.is_dir() and not any((p / f).exists() for f in tok_files):
            # Weights-only checkpoint directory: degrade, loudly. A
            # mistyped path or a CORRUPT tokenizer still fails fast — only
            # the genuinely-absent case falls back.
            log.warning(
                "checkpoint %r has no tokenizer files; serving byte-level",
                spec,
            )
            return ByteTokenizer()
        raise
