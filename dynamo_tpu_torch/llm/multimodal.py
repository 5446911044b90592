"""Multimodal serving: image parts -> placeholder tokens -> patch
embeddings spliced into the prompt.

The port's copy of ``dynamo_tpu/llm/multimodal.py``, held to it by
``tests/test_torch_copies.py``.

Reference parity: the encoder->LLM pipeline in
`examples/multimodal/components/{processor,encode_worker,
worker}.py` — a processor splits image refs out of the chat request, a
separate encode worker turns each image into an embedding tensor handed
to the LLM worker by descriptor, and the engine consumes embeddings in
place of the image's prompt positions. TPU-native shape of each piece:

- **Processor** (`split_images`, used by OpenAIPreprocessor): replaces
  each image content-part with MM_PATCHES placeholder tokens whose ids
  are CONTENT-FINGERPRINT pseudo-tokens (sha256 of the image ref folded
  into the vocab). The ids never reach the embedding table — the engine
  overrides those rows — but they make prefix caching, KV routing, and
  migration work unchanged: two prompts with different images hash to
  different block chains, identical images prefix-hit.
- **Encoder** (`patch_embed`): a deterministic patch-embedding
  projection — bytes -> fixed [MM_PATCHES, patch_dim] patch grid -> a
  seeded Gaussian projection to the model's hidden size. This proves the
  pipeline end to end with zero extra dependencies; a real deployment
  replaces this one function with a vision tower (the surrounding
  descriptor flow is already production-shaped).
- **Transport**: data: URLs carry content inline (the zero-egress
  environment's image source); other refs are fingerprinted as opaque
  bytes. The encode worker holds the tensor and serves it by id
  (backends/encoder), mirroring the reference's NIXL descriptor handoff.
"""

from __future__ import annotations

import base64
import functools
import hashlib

import numpy as np

# Placeholder tokens per image: one fixed-size patch grid (static shapes
# under jit — every image costs the same prompt length).
MM_PATCHES = 16
# Flattened pixels per patch fed to the projection.
PATCH_DIM = 256


def image_ref_fingerprint(ref: str) -> bytes:
    """Stable content fingerprint of an image reference. data: URLs are
    content-addressed by construction; other refs fingerprint the ref
    string itself (a stable proxy — the encoder resolves actual bytes)."""
    return hashlib.sha256(ref.encode()).digest()


def pseudo_tokens(ref: str, vocab_size: int) -> list[int]:
    """MM_PATCHES content-derived placeholder ids (never id 0: the
    engine treats 0 as padding in some buffers)."""
    fp = image_ref_fingerprint(ref)
    out = []
    for i in range(MM_PATCHES):
        h = hashlib.sha256(fp + i.to_bytes(2, "little")).digest()
        out.append(1 + int.from_bytes(h[:8], "little") % (vocab_size - 1))
    return out


def image_bytes(ref: str) -> bytes:
    """Resolve an image ref to raw bytes. Supports inline data: URLs
    (any media type; the payload bytes are what the patch grid folds);
    anything else deterministically expands its fingerprint (zero-egress
    environment — a deployment with network plugs an HTTP fetch here)."""
    if ref.startswith("data:"):
        try:
            _, payload = ref.split(",", 1)
            return base64.b64decode(payload + "=" * (-len(payload) % 4))
        except ValueError:  # malformed data URL (binascii.Error included)
            pass
    return image_ref_fingerprint(ref)


def patch_grid(raw: bytes) -> np.ndarray:
    """Fold arbitrary image bytes into a fixed [MM_PATCHES, PATCH_DIM]
    float grid in [-1, 1] (deterministic; length-independent)."""
    need = MM_PATCHES * PATCH_DIM
    buf = np.zeros(need, np.uint8)
    if raw:
        arr = np.frombuffer(raw, np.uint8)
        reps = -(-need // len(arr))
        buf = np.tile(arr, reps)[:need].copy()
        # Mix in position so repeated byte patterns stay distinguishable.
        buf ^= (np.arange(need) * 131).astype(np.uint8)
    return (buf.astype(np.float32) / 127.5 - 1.0).reshape(MM_PATCHES, PATCH_DIM)


@functools.lru_cache(maxsize=8)
def _projection(hidden_size: int, seed: int) -> np.ndarray:
    """The fixed [PATCH_DIM, h]/sqrt(d) Gaussian — depends only on
    (hidden_size, seed), so it is cached, not re-drawn per request."""
    rng = np.random.RandomState(seed)
    w = rng.standard_normal((PATCH_DIM, hidden_size)).astype(np.float32)
    w /= np.sqrt(PATCH_DIM)  # in place: float32 survives NEP-50 promotion
    w.setflags(write=False)  # cached — callers must not mutate
    return w


def patch_embed(raw: bytes, hidden_size: int, seed: int = 0) -> np.ndarray:
    """The stand-in vision tower: project the patch grid to the model's
    hidden size with a fixed seeded Gaussian ([PATCH_DIM, h] / sqrt(d)).
    float32 [MM_PATCHES, hidden_size]."""
    return patch_grid(raw) @ _projection(hidden_size, seed)


def split_images(messages: list[dict]) -> tuple[list[dict], list[str]]:
    """Processor step: strip image parts out of chat messages, returning
    (text-only messages with inline markers, image refs in order). The
    marker ``\x00img{i}\x00`` survives any tokenizer byte-exactly and is
    later replaced by pseudo-token runs (`splice_pseudo_tokens`)."""
    refs: list[str] = []
    out = []
    for m in messages:
        content = m.get("content")
        if not isinstance(content, list):
            out.append(m)
            continue
        pieces = []
        for part in content:
            ptype = part.get("type")
            if ptype == "image_url" or part.get("image_url"):
                url = (part.get("image_url") or {}).get("url", "")
                pieces.append(f"\x00img{len(refs)}\x00")
                refs.append(url)
            elif part.get("text"):
                pieces.append(part["text"])
        out.append(dict(m, content="".join(pieces)))
    return out, refs


def splice_pseudo_tokens(
    token_ids: list[int],
    refs: list[str],
    vocab_size: int,
    encode,
) -> tuple[list[int], list[list[int]]]:
    """Replace each marker's token run with that image's pseudo tokens;
    returns (token_ids, positions) where positions[i] = [start, count]
    for image i. ``encode`` is the tokenizer's encode callable (markers
    are located by exact token-subsequence search)."""
    positions: list[list[int]] = []
    for i, ref in enumerate(refs):
        marker = encode(f"\x00img{i}\x00")
        start = _find_subseq(token_ids, marker)
        if start < 0:
            raise ValueError(f"image marker {i} lost in tokenization")
        pseudo = pseudo_tokens(ref, vocab_size)
        token_ids = token_ids[:start] + pseudo + token_ids[start + len(marker):]
        positions.append([start, len(pseudo)])
    return token_ids, positions


def _find_subseq(haystack: list[int], needle: list[int]) -> int:
    if not needle:
        return -1
    for i in range(len(haystack) - len(needle) + 1):
        if haystack[i : i + len(needle)] == needle:
            return i
    return -1
