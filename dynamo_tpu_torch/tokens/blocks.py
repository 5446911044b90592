"""Block-aligned token sequences with chained content hashes.

The port's copy of ``dynamo_tpu/tokens/blocks.py``: the hashing scheme
shared by the KV router's radix indexer, the KV block manager's registry,
the mocker engine, and both engines' prefix caches. The hashes are part of
the KV-event wire contract, so this copy uses the same seed and the same
``xxhash.xxh3_64`` as the original.

A sequence of tokens is chunked into fixed-size blocks; each complete
block gets a 64-bit hash chained through its parent:

    seq_hash[0] = xxh3_64(le_bytes(tokens[0:B]),      seed=SALT)
    seq_hash[i] = xxh3_64(le_bytes(tokens[iB:(i+1)B]), seed=seq_hash[i-1])

Two sequences share a prefix of k blocks iff their first k seq hashes agree,
so a radix tree over hashes *is* a prefix tree over token content.

Capability parity: reference `lib/llm/src/tokens.rs:56,196,400,491` (Tokens /
PartialTokenBlock / TokenBlock / TokenBlockSequence, chained xxh3 with salt).
Re-designed: we hash little-endian u32 token bytes with xxhash's xxh3_64 and
use the parent hash directly as the seed rather than splicing it into the
payload — same chaining semantics, one fewer copy.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Iterable, Sequence

import xxhash

# Salt seeding the root of every hash chain. Changing it invalidates every
# cached block everywhere, so it is part of the on-the-wire contract.
BLOCK_HASH_SEED: int = 0x6AE2_D7C3_11F0_51B7

_U32 = struct.Struct("<I")


def _tokens_bytes(tokens: Sequence[int]) -> bytes:
    return b"".join(_U32.pack(t & 0xFFFFFFFF) for t in tokens)


def compute_block_hash(tokens: Sequence[int], parent_hash: int | None = None) -> int:
    """Chained 64-bit hash of one block of tokens.

    ``parent_hash=None`` marks the first block of a sequence (seeded by
    BLOCK_HASH_SEED); otherwise the parent block's hash seeds the chain.
    """
    seed = BLOCK_HASH_SEED if parent_hash is None else parent_hash
    return xxhash.xxh3_64_intdigest(_tokens_bytes(tokens), seed=seed)


def compute_seq_hashes(tokens: Sequence[int], block_size: int) -> list[int]:
    """Hashes of every *complete* block of ``tokens`` (trailing partial block
    excluded), chained left to right."""
    hashes: list[int] = []
    parent: int | None = None
    for start in range(0, len(tokens) - len(tokens) % block_size, block_size):
        parent = compute_block_hash(tokens[start : start + block_size], parent)
        hashes.append(parent)
    return hashes


@dataclass(frozen=True)
class TokenBlock:
    """An immutable, complete, hash-addressed block of tokens."""

    tokens: tuple[int, ...]
    block_hash: int
    parent_hash: int | None
    position: int  # block index within its sequence

    @property
    def block_size(self) -> int:
        return len(self.tokens)


@dataclass
class PartialTokenBlock:
    """The mutable tail of a sequence: fewer than ``block_size`` tokens."""

    block_size: int
    parent_hash: int | None = None
    position: int = 0
    tokens: list[int] = field(default_factory=list)

    @property
    def remaining(self) -> int:
        return self.block_size - len(self.tokens)

    def push(self, token: int) -> TokenBlock | None:
        """Append one token; returns the completed TokenBlock when full."""
        self.tokens.append(token)
        if len(self.tokens) < self.block_size:
            return None
        block = TokenBlock(
            tokens=tuple(self.tokens),
            block_hash=compute_block_hash(self.tokens, self.parent_hash),
            parent_hash=self.parent_hash,
            position=self.position,
        )
        self.parent_hash = block.block_hash
        self.position += 1
        self.tokens = []
        return block


class TokenBlockSequence:
    """A growing token sequence maintaining its complete blocks + hash chain.

    The incremental counterpart of :func:`compute_seq_hashes`: append tokens
    one at a time (decode) or in bulk (prefill) and read back the chained
    hashes of all complete blocks in O(1) per token.
    """

    def __init__(self, tokens: Iterable[int] = (), block_size: int = 32):
        if block_size <= 0:
            raise ValueError(f"block_size must be positive, got {block_size}")
        self.block_size = block_size
        self.blocks: list[TokenBlock] = []
        self._tail = PartialTokenBlock(block_size=block_size)
        self.extend(tokens)

    def __len__(self) -> int:
        return len(self.blocks) * self.block_size + len(self._tail.tokens)

    @property
    def total_tokens(self) -> int:
        return len(self)

    @property
    def partial_tokens(self) -> list[int]:
        return list(self._tail.tokens)

    @property
    def block_hashes(self) -> list[int]:
        return [b.block_hash for b in self.blocks]

    @property
    def last_hash(self) -> int | None:
        return self.blocks[-1].block_hash if self.blocks else None

    def append(self, token: int) -> TokenBlock | None:
        """Append one token; returns a TokenBlock if one was completed."""
        block = self._tail.push(token)
        if block is not None:
            self.blocks.append(block)
        return block

    def extend(self, tokens: Iterable[int]) -> list[TokenBlock]:
        """Append many tokens; returns the blocks completed along the way."""
        completed: list[TokenBlock] = []
        for t in tokens:
            block = self.append(t)
            if block is not None:
                completed.append(block)
        return completed

    def all_tokens(self) -> list[int]:
        out: list[int] = []
        for b in self.blocks:
            out.extend(b.tokens)
        out.extend(self._tail.tokens)
        return out

    def truncate(self, num_tokens: int) -> None:
        """Truncate to the first ``num_tokens`` tokens (migration replay)."""
        if num_tokens > len(self):
            raise ValueError(f"cannot truncate {len(self)} tokens to {num_tokens}")
        tokens = self.all_tokens()[:num_tokens]
        self.blocks = []
        self._tail = PartialTokenBlock(block_size=self.block_size)
        self.extend(tokens)


def tokens_to_blocks(
    tokens: Sequence[int], block_size: int
) -> tuple[list[TokenBlock], list[int]]:
    """One-shot chunking: (complete blocks, leftover partial tokens)."""
    seq = TokenBlockSequence(tokens, block_size)
    return seq.blocks, seq.partial_tokens
