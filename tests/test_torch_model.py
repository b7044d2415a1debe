"""The port's llama forward against dynamo_tpu.models.llama.forward.

Tiny config in float32, weights made by the JAX package and carried over
with params_from_jax. The JAX side runs attention_impl="pallas" (its
kernels in interpret mode on the CPU, KV lane-padded to 128); the port
runs its kernels' plain versions (CPU tensors). A first prefill chunk with
ragged lengths, then 4 teacher-forced decode steps: logits and the K/V
of every token in each sequence's history agree within 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.models import llama as jllama
from dynamo_tpu_torch.models import llama as tllama
from dynamo_tpu_torch.ops import COUNTS, reset_counts

ATOL = 1e-4


def _tiny_pair():
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), attention_impl="pallas")
    tcfg = tllama.LlamaConfig.tiny()
    np_params = jax.tree.map(np.asarray, jllama.init_params(jax.random.key(3), jcfg))
    return jcfg, tcfg, np_params


def _assert_pages_match(tkv, jkv, tcfg, pt, lengths):
    """The K/V of every token in each sequence's history agree. Slots past
    a history are unspecified: the port's write lands whole page runs
    (padding tails included), the JAX CPU scatter only valid tokens."""
    ref = tllama.kv_pages_from_jax(np.asarray(jkv.k), np.asarray(jkv.v), tcfg, device="cpu")
    s = tkv.page_size
    for i, n in enumerate(lengths):
        pos = np.arange(n)
        pages, slots = pt[i, pos // s], pos % s
        for got, want in ((tkv.k, ref.k), (tkv.v, ref.v)):
            np.testing.assert_allclose(
                got[:, pages, slots].numpy(), want[:, pages, slots].numpy(), atol=ATOL
            )


def test_params_from_jax_keeps_names_layouts_and_values():
    jcfg, tcfg, np_params = _tiny_pair()
    params = tllama.params_from_jax(np_params, tcfg, device="cpu")
    assert set(params) == {"embed", "layers", "final_norm", "lm_head"}  # tiny is untied
    for name, arr in np_params["layers"].items():
        np.testing.assert_array_equal(params["layers"][name].numpy(), arr)
    for name in ("embed", "final_norm", "lm_head"):
        np.testing.assert_array_equal(params[name].numpy(), np_params[name])
    # tied presets carry no lm_head: logits read the embedding
    tied = {k: v for k, v in np_params.items() if k != "lm_head"}
    assert "lm_head" not in tllama.params_from_jax(tied, tcfg, device="cpu")


@pytest.mark.parametrize("lens", [(16, 9, 1), (13, 16)])
def test_prefill_then_decode_matches_jax_forward(lens):
    jcfg, tcfg, np_params = _tiny_pair()
    tparams = tllama.params_from_jax(np_params, tcfg, device="cpu")
    jparams = jax.tree.map(jnp.asarray, np_params)
    b, t, s, mp, num_pages = len(lens), 16, 4, 6, 24
    rng = np.random.default_rng(sum(lens))
    pt = (1 + rng.permutation(num_pages - 1)[: b * mp]).reshape(b, mp).astype(np.int32)
    tokens = rng.integers(1, tcfg.vocab_size, (b, t)).astype(np.int32)
    positions = np.tile(np.arange(t, dtype=np.int32), (b, 1))
    valid = positions < np.asarray(lens)[:, None]

    jkv = jllama.init_kv_pages(jcfg, num_pages, s)
    tkv = tllama.init_kv_pages(tcfg, num_pages, s, device="cpu")
    jlogits, jkv = jllama.forward(
        jparams, jcfg, jnp.asarray(tokens), jnp.asarray(positions),
        jnp.asarray(valid), jkv, jnp.asarray(pt), first_chunk=True,
    )
    reset_counts()
    tlogits, tkv = tllama.forward(
        tparams, tcfg, torch.from_numpy(tokens).long(), torch.from_numpy(positions),
        torch.from_numpy(valid), tkv, torch.from_numpy(pt), first_chunk=True,
    )
    for i, n in enumerate(lens):  # rows past valid_len are unspecified
        np.testing.assert_allclose(tlogits[i, :n].numpy(), np.asarray(jlogits)[i, :n], atol=ATOL)
    _assert_pages_match(tkv, jkv, tcfg, pt, lens)

    # teacher-forced decode: both sides take the JAX side's greedy token
    nxt = np.asarray(jlogits)[np.arange(b), np.asarray(lens) - 1].argmax(-1).astype(np.int32)
    for step in range(4):
        pos = (np.asarray(lens) + step).astype(np.int32)[:, None]
        ones = np.ones((b, 1), bool)
        jlogits, jkv = jllama.forward(
            jparams, jcfg, jnp.asarray(nxt[:, None]), jnp.asarray(pos),
            jnp.asarray(ones), jkv, jnp.asarray(pt),
        )
        tlogits, tkv = tllama.forward(
            tparams, tcfg, torch.from_numpy(nxt[:, None]).long(), torch.from_numpy(pos),
            torch.from_numpy(ones), tkv, torch.from_numpy(pt),
        )
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=ATOL)
        nxt = np.asarray(jlogits)[:, 0].argmax(-1).astype(np.int32)
    _assert_pages_match(tkv, jkv, tcfg, pt, [n + 4 for n in lens])
    # the CPU run took each kernel's plain version, never a launch
    assert COUNTS["flash_prefill_attention"].plain_calls == tcfg.num_layers
    assert COUNTS["paged_decode_attention"].plain_calls == 4 * tcfg.num_layers
    assert COUNTS["paged_write"].plain_calls == 5
    assert all(c.launches == 0 for c in COUNTS.values())


def _run_chunks(steps, jparams, tparams, jcfg, tcfg, pt, num_pages, s):
    """Run each (tokens, positions, valid, first_chunk) step through both
    forwards over their own pools; returns the per-step logits pairs and
    the final pools."""
    jkv = jllama.init_kv_pages(jcfg, num_pages, s)
    tkv = tllama.init_kv_pages(tcfg, num_pages, s, device="cpu")
    out = []
    for tokens, positions, valid, first in steps:
        jlogits, jkv = jllama.forward(
            jparams, jcfg, jnp.asarray(tokens), jnp.asarray(positions), jnp.asarray(valid),
            jkv, jnp.asarray(pt), first_chunk=first,
        )
        tlogits, tkv = tllama.forward(
            tparams, tcfg, torch.from_numpy(tokens).long(), torch.from_numpy(positions),
            torch.from_numpy(valid), tkv, torch.from_numpy(pt), first_chunk=first,
        )
        out.append((tlogits.numpy(), np.asarray(jlogits)))
    return out, tkv, jkv


def _chunk(tokens, start, length, t):
    """Row inputs for `length` tokens from `start`, padded to T=t."""
    tok = np.zeros(t, np.int32)
    tok[:length] = tokens[start:start + length]
    return tok, np.arange(t, dtype=np.int32) + start, np.arange(t) < length


def test_chunk_with_history_is_refused():
    """(The name is kept from when the port refused a chunk with history.)
    A 40-token prompt forwarded in page-aligned chunks of 16, 16 and 8
    (T=16): every chunk's logits match the JAX forward over the same
    chunks within 1e-4, the pools agree on every written token, and a
    later chunk leaves the history slots of the pages bit for bit as
    they were."""
    jcfg, tcfg, np_params = _tiny_pair()
    tparams = tllama.params_from_jax(np_params, tcfg, device="cpu")
    jparams = jax.tree.map(jnp.asarray, np_params)
    s, t, num_pages, n = 4, 16, 16, 40
    rng = np.random.default_rng(40)
    prompt = rng.integers(1, tcfg.vocab_size, n).astype(np.int32)
    pt = (1 + rng.permutation(num_pages - 1)[:12])[None].astype(np.int32)
    pieces = [(0, 16), (16, 16), (32, 8)]
    steps = [tuple(x[None] for x in _chunk(prompt, a, m, t)) + (a == 0,) for a, m in pieces]
    reset_counts()
    logits, tkv, jkv = _run_chunks(steps, jparams, tparams, jcfg, tcfg, pt, num_pages, s)
    for (tl, jl), (_, m) in zip(logits, pieces):
        np.testing.assert_allclose(tl[0, :m], jl[0, :m], atol=ATOL)
    _assert_pages_match(tkv, jkv, tcfg, pt, [n])
    assert COUNTS["flash_prefill_attention"].plain_calls == tcfg.num_layers
    assert COUNTS["paged_prefill_attention"].plain_calls == 2 * tcfg.num_layers
    # the history's slots after the first two chunks, then the third chunk
    _, before, _ = _run_chunks(steps[:2], jparams, tparams, jcfg, tcfg, pt, num_pages, s)
    hist_pages = pt[0, : 32 // s]
    assert torch.equal(tkv.k[:, hist_pages], before.k[:, hist_pages])
    assert torch.equal(tkv.v[:, hist_pages], before.v[:, hist_pages])


def test_batch_mixing_a_first_chunk_and_a_chunk_with_history():
    """One batch whose row 0 starts a prompt at 0 and whose row 1 is the
    second chunk of another prompt (its first chunk ran before), plus a
    padding row: the batch runs the history path (hist_lens 0 for rows 0
    and 2) and matches the JAX forward within 1e-4."""
    jcfg, tcfg, np_params = _tiny_pair()
    tparams = tllama.params_from_jax(np_params, tcfg, device="cpu")
    jparams = jax.tree.map(jnp.asarray, np_params)
    s, t, num_pages = 4, 16, 32
    rng = np.random.default_rng(7)
    a = rng.integers(1, tcfg.vocab_size, 11).astype(np.int32)
    b = rng.integers(1, tcfg.vocab_size, 27).astype(np.int32)
    pt = (1 + rng.permutation(num_pages - 1)[:24]).reshape(3, 8).astype(np.int32)
    pad = (np.zeros(t, np.int32), np.arange(t, dtype=np.int32), np.zeros(t, bool))
    # step 1: b's first chunk alone (rows 0 and 2 padding)
    step1 = [pad, _chunk(b, 0, 16, t), pad]
    # step 2: a's whole prompt beside b's second chunk
    step2 = [_chunk(a, 0, 11, t), _chunk(b, 16, 11, t), pad]
    steps = [tuple(np.stack(c) for c in zip(*rows)) + (f,)
             for rows, f in ((step1, True), (step2, False))]
    reset_counts()
    logits, tkv, jkv = _run_chunks(steps, jparams, tparams, jcfg, tcfg, pt, num_pages, s)
    tl, jl = logits[1]
    np.testing.assert_allclose(tl[0, :11], jl[0, :11], atol=ATOL)
    np.testing.assert_allclose(tl[1, :11], jl[1, :11], atol=ATOL)
    _assert_pages_match(tkv, jkv, tcfg, pt, [11, 27, 0])
    assert COUNTS["paged_prefill_attention"].plain_calls == tcfg.num_layers
    assert COUNTS["flash_prefill_attention"].plain_calls == tcfg.num_layers


def test_rope_inv_freq_matches_jax_with_ntk_scaling():
    jcfg = jllama.LlamaConfig.llama3_1b()
    tcfg = tllama.LlamaConfig.llama3_1b()
    np.testing.assert_allclose(
        tllama._rope_inv_freq(tcfg, "cpu").numpy(), np.asarray(jllama._rope_inv_freq(jcfg)),
        rtol=1e-6,
    )
