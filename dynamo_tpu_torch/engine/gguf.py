"""GGUF checkpoint reader: metadata, tensor index, config, tokenizer.

Counterpart of ``dynamo_tpu/engine/gguf.py``. The header parser, the
tokenizer and the tables are held to the JAX package's definitions by
``tests/test_torch_copies.py``; what differs is the payload reader and the
config class:

- :meth:`GGUFFile.load_tensor` returns a CPU ``torch.Tensor`` for every
  payload type it reads (F32, F16, BF16, F64 and the integer types). BF16
  payloads are read as ``uint16`` and reinterpreted as ``torch.bfloat16``
  bit for bit, so the reader needs no ``ml_dtypes``.
- :func:`config_from_gguf` builds the port's ``ModelConfig``.

Block-quantized ggml types (Q4_K etc.) are indexed but not dequantized,
and raise the JAX package's message. As in the JAX package, no weights are
served from GGUF: a GGUF file gives a tokenizer (``llm/tokenizer.py``),
a model config and tensors.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, BinaryIO

import numpy as np
import torch

GGUF_MAGIC = 0x46554747  # "GGUF" little-endian

# metadata value types
_U8, _I8, _U16, _I16, _U32, _I32, _F32, _BOOL, _STRING, _ARRAY, _U64, _I64, _F64 = range(13)

_SCALARS = {
    _U8: ("<B", 1), _I8: ("<b", 1), _U16: ("<H", 2), _I16: ("<h", 2),
    _U32: ("<I", 4), _I32: ("<i", 4), _F32: ("<f", 4), _BOOL: ("<?", 1),
    _U64: ("<Q", 8), _I64: ("<q", 8), _F64: ("<d", 8),
}

# ggml tensor dtypes we materialize (block-quantized types are index-only).
GGML_F32, GGML_F16 = 0, 1
GGML_BF16 = 30
_GGML_NUMPY = {
    GGML_F32: np.float32, GGML_F16: np.float16,
    24: np.int8, 25: np.int16, 26: np.int32, 27: np.int64, 28: np.float64,
}

GGML_TYPE_NAMES = {
    0: "F32", 1: "F16", 2: "Q4_0", 3: "Q4_1", 6: "Q5_0", 7: "Q5_1",
    8: "Q8_0", 9: "Q8_1", 10: "Q2_K", 11: "Q3_K", 12: "Q4_K", 13: "Q5_K",
    14: "Q6_K", 15: "Q8_K", 16: "IQ2_XXS", 24: "I8", 25: "I16", 26: "I32",
    27: "I64", 28: "F64", 30: "BF16",
}


@dataclass
class GGUFTensorInfo:
    name: str
    shape: tuple[int, ...]   # logical shape (row-major, reversed from file)
    ggml_type: int
    offset: int              # relative to the aligned data section

    @property
    def type_name(self) -> str:
        return GGML_TYPE_NAMES.get(self.ggml_type, f"type{self.ggml_type}")


@dataclass
class GGUFFile:
    path: Path
    version: int
    metadata: dict[str, Any]
    tensors: dict[str, GGUFTensorInfo]
    data_start: int
    alignment: int = 32

    # -- tensor loading ----------------------------------------------------

    def load_tensor(self, name: str) -> torch.Tensor:
        """One tensor's payload as a CPU tensor of its logical shape (a
        copy: it does not keep the file mapped)."""
        info = self.tensors[name]
        if info.ggml_type == GGML_BF16:
            dtype: Any = np.uint16  # the bf16 bits; reinterpreted below
        elif info.ggml_type in _GGML_NUMPY:
            dtype = _GGML_NUMPY[info.ggml_type]
        else:
            raise NotImplementedError(
                f"tensor {name!r} is block-quantized ggml {info.type_name}; "
                "dequantization is not implemented — use an HF checkpoint or "
                "the framework's int8 path (model.quantize_params)"
            )
        count = int(np.prod(info.shape)) if info.shape else 1
        # One lazily-created memmap serves every tensor read (a per-tensor
        # open/seek/close cycle is needlessly slow on networked storage).
        if getattr(self, "_mm", None) is None:
            self._mm = np.memmap(self.path, mode="r", dtype=np.uint8)
        start = self.data_start + info.offset
        nbytes = count * np.dtype(dtype).itemsize
        raw = bytearray(self._mm[start : start + nbytes])
        t = torch.from_numpy(np.frombuffer(raw, dtype=dtype).reshape(info.shape))
        return t.view(torch.bfloat16) if info.ggml_type == GGML_BF16 else t

    def close(self) -> None:
        """Release the checkpoint mapping (a multi-GB file should not stay
        mapped for the object's lifetime)."""
        mm = getattr(self, "_mm", None)
        if mm is not None:
            del self._mm
        self._mm = None


def _read_string(f: BinaryIO) -> str:
    (n,) = struct.unpack("<Q", f.read(8))
    return f.read(n).decode("utf-8", errors="replace")


def _read_value(f: BinaryIO, vtype: int) -> Any:
    if vtype in _SCALARS:
        fmt, size = _SCALARS[vtype]
        return struct.unpack(fmt, f.read(size))[0]
    if vtype == _STRING:
        return _read_string(f)
    if vtype == _ARRAY:
        (item_type,) = struct.unpack("<I", f.read(4))
        (count,) = struct.unpack("<Q", f.read(8))
        return [_read_value(f, item_type) for _ in range(count)]
    raise ValueError(f"unknown GGUF metadata value type {vtype}")


def read_gguf(path: str | Path) -> GGUFFile:
    path = Path(path)
    with open(path, "rb") as f:
        magic, version = struct.unpack("<II", f.read(8))
        if magic != GGUF_MAGIC:
            raise ValueError(f"{path} is not a GGUF file (magic {magic:#x})")
        if version > 0xFFFF:
            raise ValueError(
                f"{path} looks byte-swapped (version field {version:#x}) — "
                "big-endian GGUF files are not supported"
            )
        if version < 2:
            raise ValueError(f"GGUF v{version} not supported (need >= 2)")
        n_tensors, n_kv = struct.unpack("<QQ", f.read(16))
        metadata: dict[str, Any] = {}
        for _ in range(n_kv):
            key = _read_string(f)
            (vtype,) = struct.unpack("<I", f.read(4))
            metadata[key] = _read_value(f, vtype)
        tensors: dict[str, GGUFTensorInfo] = {}
        for _ in range(n_tensors):
            name = _read_string(f)
            (n_dims,) = struct.unpack("<I", f.read(4))
            dims = struct.unpack(f"<{n_dims}Q", f.read(8 * n_dims))
            gtype, offset = struct.unpack("<IQ", f.read(12))
            # GGUF stores dims innermost-first; numpy wants outermost-first.
            tensors[name] = GGUFTensorInfo(name, tuple(reversed(dims)), gtype, offset)
        alignment = int(metadata.get("general.alignment", 32))
        pos = f.tell()
        data_start = (pos + alignment - 1) // alignment * alignment
    return GGUFFile(
        path=path, version=version, metadata=metadata, tensors=tensors,
        data_start=data_start, alignment=alignment,
    )


def config_from_gguf(g: GGUFFile):
    """Map llama-family GGUF metadata onto the port's :class:`ModelConfig`,
    field for field as the JAX package maps it."""
    from dynamo_tpu_torch.engine.config import ModelConfig

    md = g.metadata
    arch = md.get("general.architecture", "llama")

    def key(suffix: str, default=None):
        return md.get(f"{arch}.{suffix}", default)

    heads = int(key("attention.head_count", 32))
    embed = int(key("embedding_length", 4096))
    head_dim = int(key("attention.key_length", embed // heads))
    vocab = md.get("tokenizer.ggml.tokens")
    vocab_size = len(vocab) if vocab else int(key("vocab_size", 32000))
    return ModelConfig(
        name=md.get("general.name", arch),
        vocab_size=vocab_size,
        hidden_size=embed,
        intermediate_size=int(key("feed_forward_length", 4 * embed)),
        num_layers=int(key("block_count", 32)),
        num_heads=heads,
        num_kv_heads=int(key("attention.head_count_kv", heads)),
        head_dim=head_dim,
        rope_theta=float(key("rope.freq_base", 10000.0)),
        rms_norm_eps=float(key("attention.layer_norm_rms_epsilon", 1e-5)),
    )


@dataclass
class GGUFTokenizer:
    """Tokenizer from GGUF metadata (tokenizer.ggml.* keys).

    Decode is exact (token table + <0xXX> byte tokens). Encode is greedy
    longest-match over the vocabulary — correct for round-tripping and
    tests; production serving should point the model card at an HF
    tokenizer (reference gguf_tokenizer.rs carries the same caveat by
    delegating merges to the tokenizers crate).
    """

    tokens: list[str]
    bos_id: int | None = None
    eos_id: int | None = None
    unk_id: int | None = None
    _index: dict[str, int] = field(default_factory=dict)
    _max_token_len: int = 1

    @classmethod
    def from_gguf(cls, g: GGUFFile) -> "GGUFTokenizer":
        md = g.metadata
        model = md.get("tokenizer.ggml.model", "llama")
        if model not in ("llama", "spm"):
            # BPE-style vocabularies use different space markers (Ġ)
            # and no <0xXX> byte fallback — decoding them with
            # SentencePiece conventions would be silently wrong.
            raise NotImplementedError(
                f"GGUF tokenizer model {model!r} is not supported "
                "(SentencePiece-style 'llama' only); point the model card "
                "at an HF tokenizer instead"
            )
        tokens = md.get("tokenizer.ggml.tokens")
        if not tokens:
            raise ValueError("GGUF file carries no tokenizer.ggml.tokens")
        return cls(
            tokens=list(tokens),
            bos_id=md.get("tokenizer.ggml.bos_token_id"),
            eos_id=md.get("tokenizer.ggml.eos_token_id"),
            unk_id=md.get("tokenizer.ggml.unknown_token_id"),
            _index={t: i for i, t in enumerate(tokens)},
            _max_token_len=max((len(t) for t in tokens), default=1),
        )

    # Tokenizer-protocol surface (llm/tokenizer.py) — the detokenizer and
    # stop engine read these.
    @property
    def eos_token_id(self) -> int | None:
        return self.eos_id

    @property
    def bos_token_id(self) -> int | None:
        return self.bos_id

    @property
    def vocab_size(self) -> int:
        return len(self.tokens)

    @staticmethod
    def _byte_token(t: str) -> int | None:
        if len(t) == 6 and t.startswith("<0x") and t.endswith(">"):
            return int(t[3:5], 16)
        return None

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        # <0xXX> tokens carry raw UTF-8 BYTES (SentencePiece byte
        # fallback), not code points: accumulate everything as bytes and
        # decode once.
        buf = bytearray()
        for i in ids:
            if i < 0 or i >= len(self.tokens):
                continue
            if skip_special_tokens and i in (self.bos_id, self.eos_id):
                continue
            t = self.tokens[i]
            b = self._byte_token(t)
            if b is not None:
                buf.append(b)
            else:
                buf.extend(t.replace("▁", " ").encode("utf-8"))
        return buf.decode("utf-8", errors="replace")

    def encode(self, text: str) -> list[int]:
        text = text.replace(" ", "▁")
        ids: list[int] = []
        i = 0
        while i < len(text):
            for ln in range(min(self._max_token_len, len(text) - i), 0, -1):
                tid = self._index.get(text[i : i + ln])
                if tid is not None:
                    ids.append(tid)
                    i += ln
                    break
            else:
                # Unknown character: SentencePiece byte fallback — one
                # <0xXX> token per UTF-8 byte, all-or-nothing. A vocab
                # missing any needed byte token emits ONE unk for the
                # whole character (SentencePiece unknown-piece semantics),
                # or raises if there is no unk either.
                byte_toks = [
                    self._index.get(f"<0x{b:02X}>")
                    for b in text[i].encode("utf-8")
                ]
                if all(t is not None for t in byte_toks):
                    ids.extend(byte_toks)  # type: ignore[arg-type]
                elif self.unk_id is not None:
                    ids.append(self.unk_id)
                else:
                    raise ValueError(
                        f"character {text[i]!r} is not encodable: the "
                        "vocabulary has no byte-fallback or unk token"
                    )
                i += 1
        return ids

    def apply_chat_template(self, messages, add_generation_prompt: bool = True) -> str:
        parts = [f"{m.get('role', 'user')}: {m.get('content', '')}" for m in messages]
        if add_generation_prompt:
            parts.append("assistant:")
        return "\n".join(parts)
