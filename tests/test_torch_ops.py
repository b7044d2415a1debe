"""The port's four plain kernel versions against the JAX Pallas kernels.

Inputs are made from a seed with numpy and go through both sides; the JAX
kernels run in interpret mode on the CPU, as the JAX package's own tests
run them, at D=128 (the Pallas kernels' lane width; one history case
takes D=64). Float32 throughout:
tolerance atol=rtol=2e-5 for the attention kernels (sums taken in another
order), bit-equality for the write. A speculative verify window, a chunk
that starts mid-page, lands through the write at run=1, held bit-equal
to the JAX write's token-granular scatter (its use_kernel=False branch)
in each pool mode.
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
from dynamo_tpu_torch.ops.kv_quant import variant
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


# -- a speculative verify window: a chunk that starts mid-page --------------------

#: (S, B, window starts, T): verify windows of T = spec_ngram + 1 tokens
#: at positions num_tokens - 1 on, starting mid-page and crossing one (or
#: two), beside a padding row (start -1)
VERIFY_WINDOWS = [
    (4, 3, (2, 7, -1), 5),     # pages of 4: a window over two pages, one over three
    (4, 2, (3, 1), 4),         # T == S, neither window page-aligned
    (64, 2, (62, 127), 5),     # the card's page size: crossing at 64 and at 128
]


def _verify_write_inputs(rng, s, b, starts, t, hkv=2, d=128, layers=2):
    """Staged rows, page tables and a window's positions and valid for
    each start (-1: a padding row, valid False)."""
    mp = 4
    p = 1 + b * mp
    k_stage = rng.standard_normal((layers, b, t, hkv, d)).astype(np.float32)
    v_stage = (3 * rng.standard_normal((layers, b, t, hkv, d))).astype(np.float32)
    pt = (1 + rng.permutation(p - 1)[: b * mp]).reshape(b, mp).astype(np.int32)
    positions = np.zeros((b, t), np.int32)
    valid = np.zeros((b, t), bool)
    for i, start in enumerate(starts):
        if start >= 0:
            positions[i] = np.arange(t) + start
            valid[i] = True
    return (layers, p, s, hkv, d), (k_stage, v_stage, pt, positions, valid)


@pytest.mark.parametrize("mode", [None, "int8", "fp8"])
@pytest.mark.parametrize("s,b,starts,t", VERIFY_WINDOWS)
def test_paged_write_run1_bit_equal_to_the_jax_scatter(s, b, starts, t, mode):
    """paged_write and paged_write_plain at run=1 land a window that starts
    mid-page token by token, bit-equal (narrow bytes and scale planes too)
    to the JAX paged_write(use_kernel=False), the reference's CPU scatter,
    on every page but the null page 0: the slots around each window keep
    their poison."""
    from tests.test_torch_kv_quant import _bytes, _jax_rows, _quantized_pool, _torch_rows

    rng = np.random.default_rng(7 * s + b + t)
    shape, (k_stage, v_stage, pt, positions, valid) = _verify_write_inputs(rng, s, b, starts, t)
    if mode is None:
        pools = [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]
        jax_pools, scales = [jnp.asarray(x) for x in pools], {}
    else:
        (k_raw, k_sc), (v_raw, v_sc) = (_quantized_pool(rng, shape, mode) for _ in range(2))
        pools = [k_raw, v_raw, k_sc, v_sc]
        jax_pools = [_jax_rows(k_raw, mode), _jax_rows(v_raw, mode)]
        scales = dict(k_scale=jnp.asarray(k_sc), v_scale=jnp.asarray(v_sc))
    want = jax_paged_write(*jax_pools, jnp.asarray(k_stage), jnp.asarray(v_stage),
                           jnp.asarray(pt), jnp.asarray(positions), jnp.asarray(valid),
                           use_kernel=False, **scales)
    for write in (kv_update.paged_write, kv_update.paged_write_plain):
        if mode is None:
            mine = [_t(x.copy()) for x in pools]
            planes = {}
        else:
            mine = [_torch_rows(pools[0].copy(), mode), _torch_rows(pools[1].copy(), mode),
                    _t(pools[2].copy()), _t(pools[3].copy())]
            planes = dict(k_scale=mine[2], v_scale=mine[3])
        ops.reset_counts()
        write(mine[0], mine[1], _t(k_stage), _t(v_stage), _t(pt), _t(positions), _t(valid),
              run=1, **planes)
        for g, w in zip(mine, want):
            np.testing.assert_array_equal(_bytes(g)[:, 1:], _bytes(w)[:, 1:])
        c = ops.COUNTS[variant("paged_write", mode)]
        assert (c.launches, c.plain_calls) == (0, 1)
    # the default run, min(T, S) = 4 here, places a crossing window by its
    # first token, so its slots run past the page (the reason for run=1)
    if s == 4 and t == 4 and mode is None:
        mine = [_t(x.copy()) for x in pools]
        with pytest.raises(IndexError):
            kv_update.paged_write(mine[0], mine[1], _t(k_stage), _t(v_stage), _t(pt),
                                  _t(positions), _t(valid))


def test_paged_write_refuses_a_run_that_does_not_fit():
    """A run must divide T and fit a page."""
    pool = torch.zeros((1, 3, 4, 1, 64))
    stage = torch.zeros((1, 1, 6, 1, 64))
    args = (torch.ones((1, 2), dtype=torch.int32), torch.zeros((1, 6), dtype=torch.int32),
            torch.ones((1, 6), dtype=torch.bool))
    with pytest.raises(ValueError, match="multiple of the run 4"):
        kv_update.paged_write(pool, pool, stage, stage, *args, run=4)
    with pytest.raises(ValueError, match="does not fit a page"):
        kv_update.paged_write(pool, pool, stage, stage, *args, run=6)
    with pytest.raises(ValueError, match="does not fit a page"):
        kv_update.paged_write(pool, pool, stage, stage, *args, run=0)


@pytest.mark.parametrize(
    "s,num_pages,mp,hist",
    [
        (4, 32, 6, (2, 7, 0, 13)),       # pages of 4: histories ending mid-page, a dead row
        (64, 12, 3, (63, 130, 1)),       # the card's page size: 63, past two pages, one token
    ],
)
def test_paged_prefill_plain_matches_jax_at_verify_windows(s, num_pages, mp, hist):
    """A verify window's shape: T = 5 (spec_ngram 4) over histories of any
    length, g=4 at D=64, against the Pallas kernel in interpret mode (a
    row with no history and no tokens is padding)."""
    cur = tuple(5 if h else 0 for h in hist)
    _paged_prefill_case(len(hist), 5, 8, 2, 64, hist, cur, s=s, num_pages=num_pages, mp=mp)
