"""The port's XXH3-64 and token-block chain against xxhash and the JAX package.

`dynamo_tpu_torch.tokens.xxh3.xxh3_64` must equal
`xxhash.xxh3_64_intdigest` bit for bit in every length class (0, 1-3,
4-8, 9-16, 17-128, 129-240 and the long path, across the 1,024-byte
scramble block) and for seeds at the edges of u64 and random ones; the
block chain built on it must equal `dynamo_tpu.tokens` on random token
streams at block sizes 4, 16, 64 and 128. A mismatch fails: nothing
stands in for the hash.
"""

import random

import numpy as np
import pytest
import xxhash

from dynamo_tpu import tokens as ref
from dynamo_tpu_torch import tokens
from dynamo_tpu_torch.tokens.xxh3 import BLOCK_LEN, xxh3_64

#: every length to 600 bytes, then lengths across the scramble block (1,024
#: bytes) up to 4,200, its edges among them
LENGTHS = list(range(601)) + sorted(
    set(range(1000, 4201, 37)) | {b * BLOCK_LEN + d for b in (1, 2, 3, 4) for d in (-1, 0, 1)})
SEEDS = [0, 1, tokens.BLOCK_HASH_SEED, 2**63 + 5, 2**64 - 1] + [
    random.Random(i).getrandbits(64) for i in range(3)]


@pytest.mark.parametrize("seed", SEEDS)
def test_xxh3_64_is_bit_equal_to_xxhash(seed):
    rng = random.Random(seed)
    for n in LENGTHS:
        data = rng.randbytes(n)
        assert xxh3_64(data, seed) == xxhash.xxh3_64_intdigest(data, seed=seed), (n, seed)


def test_xxh3_64_takes_the_seed_modulo_2_64():
    data = b"0123456789abcdef" * 20
    for seed in (-1, 2**64, 2**64 + 1337):
        assert xxh3_64(data, seed) == xxhash.xxh3_64_intdigest(data, seed=seed % 2**64)


def _stream(rng, n):
    # ids of a 128k vocabulary, a few past u32 (both packers mask them)
    out = rng.integers(0, 128_256, n).tolist()
    out[::97] = [2**32 + 5] * len(out[::97])
    return out


@pytest.mark.parametrize("block_size", [4, 16, 64, 128])
def test_hash_functions_equal_the_jax_packages(block_size):
    rng = np.random.default_rng(block_size)
    for salt in ("", "llama3-1b", "tiny"):
        assert tokens.compute_salt_hash(salt) == ref.blocks.compute_salt_hash(salt)
    for _ in range(20):
        block = _stream(rng, block_size)
        seed = int(rng.integers(0, 2**63)) * 2 + 1
        h = tokens.compute_block_hash(block, seed)
        assert h == ref.compute_block_hash(block, seed)
        assert tokens.compute_seq_hash(None, h) == ref.compute_seq_hash(None, h)
        assert tokens.compute_seq_hash(seed, h) == ref.compute_seq_hash(seed, h)


def _view(seq):
    return ([(b.tokens, b.block_hash, b.sequence_hash, b.parent_sequence_hash, b.block_index)
             for b in seq.blocks],
            (seq.partial.tokens, seq.partial.parent_sequence_hash, seq.partial.block_index),
            len(seq), seq.tokens, seq.sequence_hashes())


@pytest.mark.parametrize("block_size", [4, 16, 64, 128])
def test_token_block_sequence_equals_the_jax_packages(block_size):
    """Init from a prompt (the JAX package may take its native bulk path
    there), then append, extend and truncate: blocks, the partial tail and
    every hash stay equal."""
    rng = np.random.default_rng(100 + block_size)
    for n in (0, 1, block_size - 1, block_size, 3 * block_size + 5, 1140):
        prompt = _stream(rng, n)
        got = tokens.TokenBlockSequence(prompt, block_size=block_size, salt="llama3-1b")
        want = ref.TokenBlockSequence(prompt, block_size=block_size, salt="llama3-1b")
        assert _view(got) == _view(want)
        more = _stream(rng, 2 * block_size + 3)
        for t in more[:block_size + 1]:
            assert (got.append(t) is None) == (want.append(t) is None)
        assert [b.sequence_hash for b in got.extend(more[block_size + 1:])] == [
            b.sequence_hash for b in want.extend(more[block_size + 1:])]
        assert _view(got) == _view(want)
        for cut in (len(got), len(got) - 1, block_size, 0):
            got.truncate(max(cut, 0))
            want.truncate(max(cut, 0))
            assert _view(got) == _view(want)
        assert tokens.hash_token_blocks(prompt, block_size, "x") == ref.hash_token_blocks(
            prompt, block_size, "x")


def test_token_block_sequence_refuses_what_the_jax_one_refuses():
    with pytest.raises(ValueError):
        tokens.TokenBlockSequence(block_size=0)
    seq = tokens.TokenBlockSequence([1, 2, 3], block_size=2)
    with pytest.raises(ValueError):
        seq.truncate(4)


def test_the_import_guard_covers_the_token_modules():
    from tests.test_torch_guard import BLOCKED, _port_modules

    assert {"dynamo_tpu_torch.tokens", "dynamo_tpu_torch.tokens.xxh3",
            "dynamo_tpu_torch.tokens.blocks"} <= set(_port_modules())
    assert "xxhash" in BLOCKED
