"""Tool-call parsers: extract structured function calls from model output.

The port's copy of ``dynamo_tpu/llm/parsers/tool_calls.py``, held to it by
``tests/test_torch_copies.py``.

Capability parity: reference `lib/parsers/src/tool_calling/parsers.rs`
(hermes / mistral / llama3-json / pythonic / nemotron formats behind one
registry). Each parser splits a completed message into plain content plus
zero or more :class:`ToolCall`s; ``detect_format`` sniffs which family a
model's output uses when the model card doesn't say.
"""

from __future__ import annotations

import ast
import json
import re
import uuid
from dataclasses import dataclass, field


@dataclass
class ToolCall:
    name: str
    arguments: dict
    id: str = field(default_factory=lambda: f"call_{uuid.uuid4().hex[:24]}")

    def to_openai(self) -> dict:
        return {
            "id": self.id,
            "type": "function",
            "function": {"name": self.name, "arguments": json.dumps(self.arguments)},
        }


@dataclass
class ParsedMessage:
    content: str | None
    tool_calls: list[ToolCall] = field(default_factory=list)


def _norm_args(obj: dict) -> dict:
    args = obj.get("arguments", obj.get("parameters", {}))
    if isinstance(args, str):
        try:
            args = json.loads(args)
        except json.JSONDecodeError:
            args = {"_raw": args}
    return args if isinstance(args, dict) else {"_value": args}


def _calls_from_json(value) -> list[ToolCall]:
    items = value if isinstance(value, list) else [value]
    out = []
    for it in items:
        if isinstance(it, dict) and "name" in it:
            out.append(ToolCall(name=it["name"], arguments=_norm_args(it)))
    return out


# -- formats ---------------------------------------------------------------

_HERMES_RE = re.compile(r"<tool_call>\s*(.*?)\s*</tool_call>", re.DOTALL)


def parse_hermes(text: str) -> ParsedMessage:
    """``<tool_call>{"name": ..., "arguments": ...}</tool_call>`` blocks."""
    calls: list[ToolCall] = []
    for m in _HERMES_RE.finditer(text):
        try:
            calls.extend(_calls_from_json(json.loads(m.group(1))))
        except json.JSONDecodeError:
            continue
    content = _HERMES_RE.sub("", text).strip()
    return ParsedMessage(content=content or None, tool_calls=calls)


_MISTRAL_TAG = "[TOOL_CALLS]"


def parse_mistral(text: str) -> ParsedMessage:
    """``[TOOL_CALLS][{...}, ...]`` (mistral/mixtral instruct)."""
    idx = text.find(_MISTRAL_TAG)
    if idx < 0:
        return ParsedMessage(content=text.strip() or None)
    payload = text[idx + len(_MISTRAL_TAG):].strip()
    content = text[:idx].strip()
    try:
        calls = _calls_from_json(json.loads(payload))
    except json.JSONDecodeError:
        return ParsedMessage(content=text.strip() or None)
    return ParsedMessage(content=content or None, tool_calls=calls)


_PYTHON_TAG = "<|python_tag|>"


def parse_llama3_json(text: str) -> ParsedMessage:
    """Llama-3 style: optional ``<|python_tag|>`` then a bare JSON object
    ``{"name": ..., "parameters": ...}`` (possibly ``;``-separated)."""
    body = text
    if _PYTHON_TAG in body:
        body = body.split(_PYTHON_TAG, 1)[1]
    body = body.strip()
    calls: list[ToolCall] = []
    for part in body.split(";"):
        part = part.strip()
        if not part.startswith("{"):
            continue
        try:
            calls.extend(_calls_from_json(json.loads(part)))
        except json.JSONDecodeError:
            continue
    if calls:
        return ParsedMessage(content=None, tool_calls=calls)
    return ParsedMessage(content=text.strip() or None)


_PYTHONIC_RE = re.compile(r"^\s*\[(.+)\]\s*$", re.DOTALL)


def parse_pythonic(text: str) -> ParsedMessage:
    """``[get_weather(city="SF"), search(q="x")]`` (llama-4 / pythonic)."""
    m = _PYTHONIC_RE.match(text.strip())
    if not m:
        return ParsedMessage(content=text.strip() or None)
    try:
        tree = ast.parse(text.strip(), mode="eval")
    except SyntaxError:
        return ParsedMessage(content=text.strip() or None)
    if not isinstance(tree.body, ast.List):
        return ParsedMessage(content=text.strip() or None)
    calls: list[ToolCall] = []
    for el in tree.body.elts:
        if not (isinstance(el, ast.Call) and isinstance(el.func, ast.Name)):
            return ParsedMessage(content=text.strip() or None)
        try:
            args = {kw.arg: ast.literal_eval(kw.value) for kw in el.keywords if kw.arg}
        except ValueError:
            return ParsedMessage(content=text.strip() or None)
        calls.append(ToolCall(name=el.func.id, arguments=args))
    return ParsedMessage(content=None, tool_calls=calls)


_NEMOTRON_RE = re.compile(r"<TOOLCALL>\s*(.*?)\s*</TOOLCALL>", re.DOTALL)


def parse_nemotron(text: str) -> ParsedMessage:
    calls: list[ToolCall] = []
    for m in _NEMOTRON_RE.finditer(text):
        try:
            calls.extend(_calls_from_json(json.loads(m.group(1))))
        except json.JSONDecodeError:
            continue
    content = _NEMOTRON_RE.sub("", text).strip()
    return ParsedMessage(content=content or None, tool_calls=calls)


def parse_json(text: str) -> ParsedMessage:
    """The whole message is one JSON tool call (or a list of them)."""
    body = text.strip()
    try:
        calls = _calls_from_json(json.loads(body))
    except json.JSONDecodeError:
        return ParsedMessage(content=body or None)
    if calls:
        return ParsedMessage(content=None, tool_calls=calls)
    return ParsedMessage(content=body or None)


PARSERS = {
    "hermes": parse_hermes,
    "mistral": parse_mistral,
    "llama3_json": parse_llama3_json,
    "pythonic": parse_pythonic,
    "nemotron": parse_nemotron,
    "json": parse_json,
}


def parse_tool_calls(text: str, parser: str) -> ParsedMessage:
    try:
        return PARSERS[parser](text)
    except KeyError:
        raise ValueError(f"unknown tool parser {parser!r}; have {sorted(PARSERS)}")


def detect_format(text: str) -> str | None:
    """Sniff the tool-call format of a completed message, if any."""
    if "<tool_call>" in text:
        return "hermes"
    if _MISTRAL_TAG in text:
        return "mistral"
    if "<TOOLCALL>" in text:
        return "nemotron"
    if _PYTHON_TAG in text:
        return "llama3_json"
    stripped = text.strip()
    if stripped.startswith("{") and '"name"' in stripped:
        return "json"
    if _PYTHONIC_RE.match(stripped) and "(" in stripped:
        return "pythonic"
    return None
