from dynamo_tpu_torch.tokens.blocks import (
    BLOCK_HASH_SEED,
    PartialTokenBlock,
    TokenBlock,
    TokenBlockSequence,
    compute_block_hash,
    compute_seq_hashes,
    tokens_to_blocks,
)

__all__ = [
    "BLOCK_HASH_SEED",
    "PartialTokenBlock",
    "TokenBlock",
    "TokenBlockSequence",
    "compute_block_hash",
    "compute_seq_hashes",
    "tokens_to_blocks",
]
