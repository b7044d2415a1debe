"""The port's four plain kernel versions against the JAX Pallas kernels.

Inputs are made from a seed with numpy and go through both sides; the JAX
kernels run in interpret mode on the CPU, as the JAX package's own tests
run them, at D=128 (the Pallas kernels' lane width; one history case
takes D=64). Float32 throughout:
tolerance atol=rtol=2e-5 for the attention kernels (sums taken in another
order), bit-equality for the write.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dynamo_tpu.ops.flash_prefill import flash_prefill_attention as jax_flash_prefill
from dynamo_tpu.ops.flash_prefill import paged_prefill_attention as jax_paged_prefill
from dynamo_tpu.ops.kv_update import paged_write as jax_paged_write
from dynamo_tpu.ops.paged_attention import paged_decode_attention as jax_paged_decode
from dynamo_tpu_torch import ops
from dynamo_tpu_torch.ops import flash_prefill, kv_update, paged_attention
from helpers.torch_write_cases import write_params

TOL = dict(atol=2e-5, rtol=2e-5)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("b,t,s,valid_rows,hkv", write_params())
def test_paged_write_bit_equal_to_jax(b, t, s, valid_rows, hkv):
    rng = np.random.default_rng(17 * b + t)
    L, d = 2, 128
    mp = max(4, -(-t // s))
    P = max(16, 1 + b * mp)
    k_cache = rng.standard_normal((L, P, s, hkv, d)).astype(np.float32)
    v_cache = rng.standard_normal((L, P, s, hkv, d)).astype(np.float32)
    k_stage = rng.standard_normal((L, b, t, hkv, d)).astype(np.float32)
    v_stage = rng.standard_normal((L, b, t, hkv, d)).astype(np.float32)
    pt = (1 + rng.permutation(P - 1)[: b * mp]).reshape(b, mp).astype(np.int32)
    if t == 1:
        positions = rng.integers(0, mp * s, (b, 1)).astype(np.int32)
        valid = np.asarray(valid_rows, bool)[:, None]
    else:
        positions = np.tile(np.arange(t, dtype=np.int32), (b, 1))
        valid = positions < np.asarray(valid_rows)[:, None]
    jk, jv = jax_paged_write(
        jnp.asarray(k_cache), jnp.asarray(v_cache), jnp.asarray(k_stage),
        jnp.asarray(v_stage), jnp.asarray(pt), jnp.asarray(positions),
        jnp.asarray(valid), use_kernel=True,
    )
    tk, tv = _t(k_cache.copy()), _t(v_cache.copy())
    kv_update.paged_write(
        tk, tv, _t(k_stage), _t(v_stage), _t(pt), _t(positions), _t(valid)
    )
    # page 0 is the null page; its contents are unspecified
    np.testing.assert_array_equal(tk.numpy()[:, 1:], np.asarray(jk)[:, 1:])
    np.testing.assert_array_equal(tv.numpy()[:, 1:], np.asarray(jv)[:, 1:])
    # padding lanes never touch a real page: a sequence whose first token
    # is padding leaves all of its pages as they were
    for i, rows in enumerate(valid_rows):
        if rows == 0:
            np.testing.assert_array_equal(tk.numpy()[:, pt[i]], k_cache[:, pt[i]])
            if t == 1:  # a lone padding lane lands in the null page's slot 0
                np.testing.assert_array_equal(tk.numpy()[:, 0, 0], k_stage[:, i, 0])
                np.testing.assert_array_equal(tv.numpy()[:, 0, 0], v_stage[:, i, 0])


@pytest.mark.parametrize(
    "b,t,hq,hkv,valid",
    [
        (2, 128, 4, 4, (128, 100)),  # g=1, padding tail
        (1, 130, 8, 2, (130,)),      # g=4, ragged T
        (2, 64, 8, 2, (64, 17)),     # g=4, short valid prefix
        (3, 16, 2, 1, (16, 1, 9)),   # MQA, ragged valid_len down to one token
    ],
)
def test_flash_prefill_plain_matches_jax(b, t, hq, hkv, valid):
    d = 128
    rng = np.random.default_rng(b * 1000 + t)
    q = rng.standard_normal((b, t, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, t, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, t, hkv, d)).astype(np.float32)
    valid_len = np.asarray(valid, np.int32)
    ref = np.asarray(
        jax_flash_prefill(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(valid_len),
            scale_dim=d, interpret=True,
        )
    )
    got = flash_prefill.flash_prefill_attention(
        _t(q), _t(k), _t(v), _t(valid_len), scale_dim=d
    ).numpy()
    for i, n in enumerate(valid):  # rows at or past valid_len are unspecified
        np.testing.assert_allclose(got[i, :n], ref[i, :n], **TOL)


@pytest.mark.parametrize(
    "b,t,hq,hkv,d,hist,cur",
    [
        (2, 128, 4, 2, 128, (128, 65), (128, 90)),  # full chunk beside a ragged one
        (1, 256, 8, 2, 128, (192,), (256,)),        # GQA g=4, history of several pages
        (2, 128, 2, 2, 128, (64, 0), (128, 0)),     # one dead row
        (3, 64, 4, 1, 128, (65, 0, 130), (64, 33, 1)),  # partial last pages, a first chunk
        (2, 128, 8, 2, 64, (100, 64), (128, 77)),   # D=64
    ],
)
def test_paged_prefill_plain_matches_jax(b, t, hq, hkv, d, hist, cur):
    """The reference's three cases (tests/test_flash_prefill.py), plus a
    history that ends inside a page beside a first chunk (hist 0) and a
    D=64 case. Rows at or past cur_lens are unspecified."""
    _paged_prefill_case(b, t, hq, hkv, d, hist, cur, s=64, num_pages=16, mp=4)


@pytest.mark.parametrize(
    "s,num_pages,mp,b,t,hist,cur",
    [
        # pages of 16: histories over many pages, one ending mid-page
        (16, 24, 10, 2, 64, (150, 37), (64, 50)),
        (16, 24, 10, 2, 32, (16, 0), (32, 9)),
        # pages of 128: a history inside its first page, one over two pages
        (128, 6, 2, 2, 64, (100, 200), (64, 33)),
        (128, 6, 2, 1, 128, (256,), (128,)),
    ],
)
def test_paged_prefill_plain_matches_jax_page_sizes(s, num_pages, mp, b, t, hist, cur):
    """Page sizes smaller and larger than 64 (the CUDA kernel's key tile):
    the plain version against the Pallas kernel in interpret mode, GQA
    g=2 at D=64."""
    _paged_prefill_case(b, t, 4, 2, 64, hist, cur, s=s, num_pages=num_pages, mp=mp)


def _paged_prefill_case(b, t, hq, hkv, d, hist, cur, *, s, num_pages, mp):
    """One paged prefill case through the Pallas kernel (interpret mode)
    and the port's plain version, on a pool of `num_pages` pages of `s`
    slots and page tables of `mp` pages."""
    layers, layer = 2, 1
    rng = np.random.default_rng(1000 * b + t + d + (0 if s == 64 else s))
    q = rng.standard_normal((b, t, hq, d)).astype(np.float32)
    kc = rng.standard_normal((b, t, hkv, d)).astype(np.float32)
    vc = rng.standard_normal((b, t, hkv, d)).astype(np.float32)
    k_cache = rng.standard_normal((layers, num_pages, s, hkv, d)).astype(np.float32)
    v_cache = rng.standard_normal((layers, num_pages, s, hkv, d)).astype(np.float32)
    pt = (1 + rng.permutation(num_pages - 1)[: b * mp]).reshape(b, mp).astype(np.int32)
    hist_lens = np.asarray(hist, np.int32)
    cur_lens = np.asarray(cur, np.int32)
    ref = np.asarray(
        jax_paged_prefill(
            jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(k_cache),
            jnp.asarray(v_cache), jnp.int32(layer), jnp.asarray(pt), jnp.asarray(hist_lens),
            jnp.asarray(cur_lens), scale_dim=d, interpret=True,
        )
    )
    ops.reset_counts()
    got = flash_prefill.paged_prefill_attention(
        _t(q), _t(kc), _t(vc), _t(k_cache), _t(v_cache), layer, _t(pt), _t(hist_lens),
        _t(cur_lens), scale_dim=d,
    ).numpy()
    assert np.isfinite(got).all()
    for i, n in enumerate(cur):
        np.testing.assert_allclose(got[i, :n], ref[i, :n], **TOL)
    c = ops.COUNTS["paged_prefill_attention"]
    assert (c.launches, c.plain_calls) == (0, 1)


def test_paged_prefill_counts_only_needed_work():
    """flops and bytes count valid rows and history below hist_lens only:
    padding rows, dead sequences and unused page slots add nothing."""
    hq, hkv, d = 32, 8, 64
    hist, cur = torch.tensor([0, 512, 1536, 3072]), torch.tensor([512, 512, 300, 512])
    pairs = sum(int(c) * int(h) + int(c) * (int(c) + 1) // 2 for h, c in zip(hist, cur))
    assert pairs == 2_734_942
    assert flash_prefill.paged_flops(hist, cur, hq, d) == 4 * hq * d * pairs
    assert flash_prefill.paged_bytes_moved(hist, cur, hq, hkv, d, 2) == (
        1836 * (2 * hq + 2 * hkv) * d * 2 + 2 * 5120 * hkv * d * 2
    )
    # a dead row and an empty history add nothing; hist 0 is a first chunk
    more = torch.tensor([0, 0]), torch.tensor([64, 0])
    assert flash_prefill.paged_flops(*more, hq, d) == flash_prefill.flops(
        torch.tensor([64]), hq, d)
    assert flash_prefill.paged_bytes_moved(*more, hq, hkv, d, 2) == flash_prefill.bytes_moved(
        torch.tensor([64]), hq, hkv, d, 2)


@pytest.mark.parametrize(
    "hq,hkv,hist",
    [
        (4, 4, (0, 5, 16, 3)),    # g=1: zero history, partial and full pages
        (8, 2, (7, 0, 13, 1)),    # g=4
    ],
)
def test_paged_decode_plain_matches_jax(hq, hkv, hist):
    L, P, s, d, mp = 3, 24, 4, 128, 4
    b = len(hist)
    rng = np.random.default_rng(hq + 7 * hkv)
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    k_cache = rng.standard_normal((L, P, s, hkv, d)).astype(np.float32)
    v_cache = rng.standard_normal((L, P, s, hkv, d)).astype(np.float32)
    pt = (1 + rng.permutation(P - 1)[: b * mp]).reshape(b, mp).astype(np.int32)
    hist_lens = np.asarray(hist, np.int32)
    layer = 1
    racc, rm, rl = (
        np.asarray(x)
        for x in jax_paged_decode(
            jnp.asarray(q), jnp.asarray(k_cache), jnp.asarray(v_cache),
            jnp.int32(layer), jnp.asarray(pt), jnp.asarray(hist_lens),
            scale_dim=d, interpret=True,
        )
    )
    acc, m, l = paged_attention.paged_decode_attention(
        _t(q), _t(k_cache), _t(v_cache), layer, _t(pt), _t(hist_lens), scale_dim=d
    )
    np.testing.assert_allclose(acc.numpy(), racc, **TOL)
    np.testing.assert_allclose(m.numpy(), rm, **TOL)
    np.testing.assert_allclose(l.numpy(), rl, **TOL)
    empty = hist_lens == 0
    assert (acc.numpy()[empty] == 0).all() and (l.numpy()[empty] == 0).all()
    assert np.isneginf(m.numpy()[empty]).all()


@pytest.mark.parametrize("ctas_per_sm", [1, 2, 4])
@pytest.mark.parametrize("batch", [1, 3, 32, 64, 300])
@pytest.mark.parametrize("max_pages", [1, 7, 32, 64, 300])
def test_decode_split_plan_covers_every_page(batch, max_pages, ctas_per_sm):
    max_splits = 128  # the kernel's, from dyn_paged_decode_layout
    splits, per = paged_attention.decode_split_plan(batch, 8, max_pages, num_sms=132,
                                                    ctas_per_sm=ctas_per_sm,
                                                    max_splits=max_splits)
    assert 1 <= splits <= max_splits and per >= 1
    assert splits * per >= max_pages > (splits - 1) * per  # no empty tail split
    if batch * 8 < 132:  # small batch: the splits cover the SMs
        assert batch * 8 * splits >= min(132, batch * 8 * max_pages)
    if splits > 1:  # never more CTAs than the waves the plan fills
        assert batch * 8 * splits <= paged_attention.WAVES * 132 * ctas_per_sm


def test_cpu_tensors_take_the_plain_version_and_count_it():
    ops.reset_counts()
    q = torch.zeros((1, 4, 2, 64))
    kv = torch.zeros((1, 4, 1, 64))
    flash_prefill.flash_prefill_attention(q, kv, kv, torch.tensor([4], dtype=torch.int32))
    c = ops.COUNTS["flash_prefill_attention"]
    assert (c.launches, c.plain_calls) == (0, 1)
    ops.reset_counts()
    assert (c.launches, c.plain_calls) == (0, 0)


def test_wrappers_refuse_mixed_or_unsupported_devices():
    q = torch.zeros((1, 4, 2, 64), device="meta")
    kv = torch.zeros((1, 4, 1, 64))
    with pytest.raises(ValueError, match="devices"):
        flash_prefill.flash_prefill_attention(q, kv, kv, torch.tensor([4]))
    with pytest.raises(ValueError, match="unsupported device"):
        flash_prefill.flash_prefill_attention(
            q, kv.to("meta"), kv.to("meta"), torch.tensor([4], device="meta")
        )
