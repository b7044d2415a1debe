"""Content-addressed token blocks.

Counterpart of dynamo_tpu/tokens/blocks.py (its pure-Python chain; there
is no native bulk path here). A token stream is cut into blocks of
`block_size` tokens; each full block gets a *sequence hash* chained from
its parent's, so an identical prefix always gives an identical chain of
hashes, whichever worker computed it. The engine's prefix cache
(engine/page_table.py) addresses pages by these hashes, and the KV events
it emits carry them, so they must equal the JAX package's bit for bit:
XXH3-64 (tokens/xxh3.py) over little-endian u32 tokens, seeded by the
parent's sequence hash, or by the salt's hash at the root; a sequence
hash is XXH3-64 of (parent, block hash) as two u64, seeded by
BLOCK_HASH_SEED.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Iterable, Optional, Sequence

from dynamo_tpu_torch.tokens.xxh3 import xxh3_64

Token = int
SequenceHash = int  # u64
SaltHash = int  # u64

#: seed of the salt's hash and of every sequence hash
BLOCK_HASH_SEED = 1337

#: default block size: one block is one KV page of 64 tokens
DEFAULT_BLOCK_SIZE = 64

_U64_MASK = (1 << 64) - 1
_PAIR = struct.Struct("<QQ")


def compute_salt_hash(salt: str = "") -> SaltHash:
    """Hash a namespace salt (the model's name), so chains of different
    models never collide in a shared index."""
    return xxh3_64(salt.encode("utf-8"), BLOCK_HASH_SEED)


def _pack_tokens(tokens: Sequence[Token]) -> bytes:
    return struct.pack(f"<{len(tokens)}I", *[t & 0xFFFFFFFF for t in tokens])


def compute_block_hash(tokens: Sequence[Token], seed: int) -> int:
    """Hash one block's tokens under a chaining seed (parent hash or salt)."""
    return xxh3_64(_pack_tokens(tokens), seed & _U64_MASK)


def compute_seq_hash(parent: Optional[SequenceHash], block_hash: int) -> SequenceHash:
    """Chain a block hash onto its parent to get the block's sequence hash."""
    if parent is None:
        return block_hash & _U64_MASK
    return xxh3_64(_PAIR.pack(parent & _U64_MASK, block_hash & _U64_MASK), BLOCK_HASH_SEED)


@dataclass(frozen=True)
class TokenBlock:
    """An immutable, full block of tokens with its chained identity."""

    tokens: tuple[Token, ...]
    block_hash: int
    sequence_hash: SequenceHash
    parent_sequence_hash: Optional[SequenceHash]
    block_index: int

    def __len__(self) -> int:
        return len(self.tokens)


@dataclass
class PartialTokenBlock:
    """The mutable tail of a sequence: gathers tokens until it is full."""

    block_size: int
    salt_hash: SaltHash
    parent_sequence_hash: Optional[SequenceHash]
    block_index: int
    tokens: list[Token] = field(default_factory=list)

    def push_token(self, token: Token) -> Optional[TokenBlock]:
        """Append one token; returns the committed TokenBlock when it fills."""
        self.tokens.append(token)
        if len(self.tokens) == self.block_size:
            return self._commit()
        return None

    def _commit(self) -> TokenBlock:
        parent = self.parent_sequence_hash
        block_hash = compute_block_hash(self.tokens, self.salt_hash if parent is None else parent)
        return TokenBlock(
            tokens=tuple(self.tokens),
            block_hash=block_hash,
            sequence_hash=compute_seq_hash(parent, block_hash),
            parent_sequence_hash=parent,
            block_index=self.block_index,
        )


class TokenBlockSequence:
    """A token stream cut into content-addressed blocks: `blocks` holds the
    committed full blocks, `partial` the tail. Appending commits a block
    as soon as it fills; `truncate` cuts the stream back."""

    def __init__(self, tokens: Iterable[Token] = (), block_size: int = DEFAULT_BLOCK_SIZE,
                 salt: str = ""):
        if block_size <= 0:
            raise ValueError(f"block_size must be positive, got {block_size}")
        self.block_size = block_size
        self.salt_hash = compute_salt_hash(salt)
        self.blocks: list[TokenBlock] = []
        self.partial = PartialTokenBlock(block_size, self.salt_hash, None, 0)
        self.extend(tokens)

    # -- mutation ----------------------------------------------------------

    def append(self, token: Token) -> Optional[TokenBlock]:
        committed = self.partial.push_token(token)
        if committed is not None:
            self.blocks.append(committed)
            self.partial = PartialTokenBlock(self.block_size, self.salt_hash,
                                             committed.sequence_hash, committed.block_index + 1)
        return committed

    def extend(self, tokens: Iterable[Token]) -> list[TokenBlock]:
        out = []
        for t in tokens:
            b = self.append(t)
            if b is not None:
                out.append(b)
        return out

    def truncate(self, num_tokens: int) -> None:
        """Keep only the first `num_tokens` tokens. Full blocks before the
        cut keep their hashes; only the new tail is rebuilt."""
        if num_tokens > len(self):
            raise ValueError(f"cannot truncate to {num_tokens}, have {len(self)}")
        keep_blocks = num_tokens // self.block_size
        tail = self.tokens[keep_blocks * self.block_size : num_tokens]
        self.blocks = self.blocks[:keep_blocks]
        parent = self.blocks[-1].sequence_hash if self.blocks else None
        self.partial = PartialTokenBlock(self.block_size, self.salt_hash, parent, keep_blocks,
                                         list(tail))

    # -- views -------------------------------------------------------------

    @property
    def tokens(self) -> list[Token]:
        out: list[Token] = []
        for b in self.blocks:
            out.extend(b.tokens)
        out.extend(self.partial.tokens)
        return out

    def __len__(self) -> int:
        return len(self.blocks) * self.block_size + len(self.partial.tokens)

    def sequence_hashes(self) -> list[SequenceHash]:
        """The chained hash of each full block: the cache's identity."""
        return [b.sequence_hash for b in self.blocks]


def hash_token_blocks(tokens: Sequence[Token], block_size: int = DEFAULT_BLOCK_SIZE,
                      salt: str = "") -> list[SequenceHash]:
    """Sequence hashes of every *full* block of `tokens`."""
    return TokenBlockSequence(tokens, block_size=block_size, salt=salt).sequence_hashes()
