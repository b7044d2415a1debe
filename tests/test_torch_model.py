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


def test_chunk_with_history_is_refused():
    _, tcfg, np_params = _tiny_pair()
    params = tllama.params_from_jax(np_params, tcfg, device="cpu")
    kv = tllama.init_kv_pages(tcfg, 8, 4, device="cpu")
    tokens = torch.ones((1, 4), dtype=torch.long)
    positions = torch.arange(4, 8, dtype=torch.int32)[None]
    with pytest.raises(NotImplementedError, match="paged_prefill_attention"):
        tllama.forward(params, tcfg, tokens, positions, torch.ones((1, 4), dtype=torch.bool),
                       kv, torch.tensor([[1, 2, 3]], dtype=torch.int32))


def test_rope_inv_freq_matches_jax_with_ntk_scaling():
    jcfg = jllama.LlamaConfig.llama3_1b()
    tcfg = tllama.LlamaConfig.llama3_1b()
    np.testing.assert_allclose(
        tllama._rope_inv_freq(tcfg, "cpu").numpy(), np.asarray(jllama._rope_inv_freq(jcfg)),
        rtol=1e-6,
    )
