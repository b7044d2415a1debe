"""Content-addressed token blocks (blocks.py) over XXH3-64 (xxh3.py)."""

from dynamo_tpu_torch.tokens.blocks import (
    BLOCK_HASH_SEED,
    DEFAULT_BLOCK_SIZE,
    PartialTokenBlock,
    SaltHash,
    SequenceHash,
    TokenBlock,
    TokenBlockSequence,
    compute_block_hash,
    compute_salt_hash,
    compute_seq_hash,
    hash_token_blocks,
)
from dynamo_tpu_torch.tokens.xxh3 import xxh3_64

__all__ = [
    "BLOCK_HASH_SEED",
    "DEFAULT_BLOCK_SIZE",
    "PartialTokenBlock",
    "SaltHash",
    "SequenceHash",
    "TokenBlock",
    "TokenBlockSequence",
    "compute_block_hash",
    "compute_salt_hash",
    "compute_seq_hash",
    "hash_token_blocks",
    "xxh3_64",
]
