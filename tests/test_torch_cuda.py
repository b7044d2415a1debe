"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`; each test decides inside itself whether a card is present
and skips when there is none (never at import, so every worker collects
the same tests). Run on the card with `python -m pytest -m cuda
tests/test_torch_cuda.py`. Shapes are llama3-1b's attention widths (Hq=32,
Hkv=8, D=64, page size 64) and a D=128 case; flash prefill also runs every
group size its 128-row tile takes up to 8 at D 64 and 128, and T around
its tile edges. The write is bit-equal off
the null page. Flash prefill and paged prefill (bf16 output) hold each
valid (token, head) row within 2^-6 of the row's largest |value|, 2-4 bf16
ulps there; paged decode (f32 output) holds acc/l and m within 1e-4.
Each holds for bf16 pools and for quantized (int8, fp8) pools, where the
write's narrow bytes and scales are bit-equal too.
"""

import pytest
import torch

from dynamo_tpu_torch import ops
from dynamo_tpu_torch.ops import flash_prefill, kv_quant, kv_update, paged_attention

pytestmark = pytest.mark.cuda


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("b,t", [(4, 1), (3, 128), (2, 64)])
def test_paged_write_bit_equal(b, t):
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(b * 100 + t)
    L, P, S, hkv, d, mp = 4, 1 + 8 * b, 64, 8, 64, 8
    bf = dict(dtype=torch.bfloat16, device=dev)
    k_cache, v_cache = (torch.randn((L, P, S, hkv, d), generator=gen, **bf) for _ in range(2))
    k_stage, v_stage = (torch.randn((L, b, t, hkv, d), generator=gen, **bf) for _ in range(2))
    pt = (1 + torch.randperm(P - 1, generator=gen, device=dev)[: b * mp]).reshape(b, mp)
    pt = pt.to(torch.int32)
    if t == 1:
        pos = torch.randint(0, mp * S, (b, 1), generator=gen, device=dev).to(torch.int32)
        valid = torch.tensor([[True]] * (b - 1) + [[False]], device=dev)
    else:
        pos = torch.arange(t, device=dev, dtype=torch.int32)[None].expand(b, t).contiguous()
        valid = pos < torch.tensor([t, t // 2 + 1, 1][:b], device=dev)[:, None]
    got = kv_update.paged_write(k_cache.clone(), v_cache.clone(), k_stage, v_stage, pt, pos, valid)
    want = kv_update.paged_write_plain(k_cache.clone(), v_cache.clone(), k_stage, v_stage,
                                       pt, pos, valid)
    for g, w, before in zip(got, want, (k_cache, v_cache)):
        assert torch.equal(g[:, 1:], w[:, 1:])  # page 0 is the null page
        assert torch.equal(g[:, 0], before[:, 0])  # the kernel skips padding runs


def _flash_lengths(t):
    """Eight sequences of a T-token chunk: lengths T, 0 and 1 in one batch,
    and a half, T-1, and three short ones."""
    return (t, 0, 1, max(1, t // 2), max(1, t - 1), min(t, 129), min(t, 65), min(t, 33))


#: (Hq, Hkv, D, T, valid lengths). The kernel's CTA holds 128 rows (128/g
#: tokens) and streams 64-key tiles through a two-stage ring, so a row past
#: 128 keys wraps the ring.
FLASH_CASES = [
    (32, 8, 64, 203, (200, 129, 64, 1)),
    (8, 8, 128, 133, (130, 7)),
    (16, 2, 64, 99, (96,)),
    # every group size at both head dims; lengths 0, 1 and T together, and
    # rows whose keys wrap the ring (257, 300)
    *[(2 * g, 2, d, 300, (300, 0, 1, 257, 129)) for g in (1, 2, 4, 8) for d in (64, 128)],
    # the tile edges: T around one and two CTAs of llama3-1b (32 tokens) and
    # around the key tile (64) and the ring (128)
    *[(32, 8, 64, t, _flash_lengths(t)) for t in (1, 31, 32, 33, 127, 128, 129, 512, 1000)],
]


@pytest.mark.parametrize("hq,hkv,d,t,lens", FLASH_CASES)
def test_flash_prefill_matches_plain(hq, hkv, d, t, lens):
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(hq + d + t)
    b = len(lens)
    bf = dict(dtype=torch.bfloat16, device=dev)
    q = torch.randn((b, t, hq, d), generator=gen, **bf)
    k, v = (torch.randn((b, t, hkv, d), generator=gen, **bf) for _ in range(2))
    vl = torch.tensor(lens, dtype=torch.int32, device=dev)
    got = flash_prefill.flash_prefill_attention(q, k, v, vl)
    want = flash_prefill.flash_prefill_attention_plain(q, k, v, vl)
    _assert_rows_close(got, want, lens)


def _assert_rows_close(got, want, lens):
    """Each valid (token, head) row within 2^-6 of its largest |value|."""
    assert torch.isfinite(got).all()
    for i, n in enumerate(lens):
        diff = (got[i, :n].float() - want[i, :n].float()).abs().amax(dim=-1)
        assert (diff <= 2.0**-6 * want[i, :n].float().abs().amax(dim=-1)).all()


@pytest.mark.parametrize("hq,hkv,d,t,hist,cur", [
    (32, 8, 64, 512, (0, 512, 1536, 3072), (512, 512, 300, 512)),
    (32, 8, 64, 96, (65, 1, 0, 700), (96, 17, 0, 95)),  # partial pages, a dead row
    (8, 8, 128, 130, (130, 64), (130, 7)),
    (16, 2, 128, 64, (257, 0), (64, 64)),
])
def test_paged_prefill_matches_plain(hq, hkv, d, t, hist, cur):
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(hq + d + t)
    b, L, S = len(hist), 3, 64
    mp = max(1, -(-max(hist) // S)) + 1
    P = 1 + b * mp
    bf = dict(dtype=torch.bfloat16, device=dev)
    q = torch.randn((b, t, hq, d), generator=gen, **bf)
    kc, vc = (torch.randn((b, t, hkv, d), generator=gen, **bf) for _ in range(2))
    k_cache, v_cache = (torch.randn((L, P, S, hkv, d), generator=gen, **bf) for _ in range(2))
    pt = (1 + torch.randperm(P - 1, generator=gen, device=dev)[: b * mp]).reshape(b, mp)
    pt = pt.to(torch.int32)
    hl = torch.tensor(hist, dtype=torch.int32, device=dev)
    cl = torch.tensor(cur, dtype=torch.int32, device=dev)
    args = (q, kc, vc, k_cache, v_cache, 2, pt, hl, cl)
    got = flash_prefill.paged_prefill_attention(*args)
    want = flash_prefill.paged_prefill_attention_plain(*args)
    _assert_rows_close(got, want, cur)


@pytest.mark.parametrize("b,hq,hkv,d", [(1, 32, 8, 64), (6, 32, 8, 64), (3, 8, 8, 128)])
def test_paged_decode_matches_plain(b, hq, hkv, d):
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(b * hq + d)
    L, S, mp = 3, 64, 12
    P = 1 + b * mp
    bf = dict(dtype=torch.bfloat16, device=dev)
    k_cache, v_cache = (torch.randn((L, P, S, hkv, d), generator=gen, **bf) for _ in range(2))
    q = torch.randn((b, hq, d), generator=gen, **bf)
    pt = (1 + torch.randperm(P - 1, generator=gen, device=dev)[: b * mp]).reshape(b, mp)
    pt = pt.to(torch.int32)
    hist = torch.tensor([mp * S - 5, 0, 1, 64, 65, 300][:b], dtype=torch.int32, device=dev)
    acc, m, l = paged_attention.paged_decode_attention(q, k_cache, v_cache, 1, pt, hist)
    racc, rm, rl = paged_attention.paged_decode_attention_plain(q, k_cache, v_cache, 1, pt, hist)
    some = hist > 0
    assert (acc[some] / l[some][..., None] - racc[some] / rl[some][..., None]).abs().max() <= 1e-4
    assert (m[some] - rm[some]).abs().max() <= 1e-4
    assert (acc[~some] == 0).all() and (l[~some] == 0).all() and torch.isneginf(m[~some]).all()


def test_launches_are_counted_and_bad_inputs_raise():
    dev = _card()
    ops.reset_counts()
    q = torch.zeros((1, 64, 32, 64), dtype=torch.bfloat16, device=dev)
    kv = torch.zeros((1, 64, 8, 64), dtype=torch.bfloat16, device=dev)
    vl = torch.tensor([64], dtype=torch.int32, device=dev)
    flash_prefill.flash_prefill_attention(q, kv, kv, vl)
    c = ops.COUNTS["flash_prefill_attention"]
    assert (c.launches, c.plain_calls) == (1, 0)
    with pytest.raises(ValueError, match="bfloat16"):
        flash_prefill.flash_prefill_attention(q.float(), kv.float(), kv.float(), vl)
    with pytest.raises(ValueError, match="head_dim"):
        flash_prefill.flash_prefill_attention(q[..., :32], kv[..., :32], kv[..., :32], vl)
    with pytest.raises(ValueError, match="must divide 128"):  # g = 3
        flash_prefill.flash_prefill_attention(q[:, :, :12], kv[:, :, :4], kv[:, :, :4], vl)
    assert c.launches == 1


def test_paged_prefill_launches_are_counted_and_bad_inputs_raise():
    dev = _card()
    ops.reset_counts()
    bf = dict(dtype=torch.bfloat16, device=dev)
    q = torch.zeros((1, 64, 32, 64), **bf)
    kv = torch.zeros((1, 64, 8, 64), **bf)
    pool = torch.zeros((2, 4, 64, 8, 64), **bf)
    pt = torch.tensor([[1, 2]], dtype=torch.int32, device=dev)
    lens = torch.tensor([64], dtype=torch.int32, device=dev)
    flash_prefill.paged_prefill_attention(q, kv, kv, pool, pool, 1, pt, lens, lens)
    c = ops.COUNTS["paged_prefill_attention"]
    assert (c.launches, c.plain_calls) == (1, 0)
    with pytest.raises(ValueError, match="bfloat16"):
        flash_prefill.paged_prefill_attention(q.float(), kv, kv, pool, pool, 1, pt, lens, lens)
    with pytest.raises(ValueError, match="int32"):
        flash_prefill.paged_prefill_attention(q, kv, kv, pool, pool, 1, pt.long(), lens, lens)
    with pytest.raises(ValueError, match="layer"):
        flash_prefill.paged_prefill_attention(q, kv, kv, pool, pool, 2, pt, lens, lens)
    with pytest.raises(ValueError, match="head_dim"):
        flash_prefill.paged_prefill_attention(
            q[..., :32], kv[..., :32], kv[..., :32], pool[..., :32], pool[..., :32], 1, pt,
            lens, lens)
    assert c.launches == 1


# -- quantized pools (int8, fp8) ----------------------------------------------------


def _quantized_pool(shape, mode, gen, dev):
    """Random rows quantized on the card, with their f32 scale planes."""
    x = torch.randn(shape, generator=gen, device=dev)
    x = x * (0.1 + 4 * torch.rand(shape[:-1] + (1,), generator=gen, device=dev))
    return kv_quant.quantize_kv_rows(x, mode)


def _stale_past_history(pools, pt, hist, page_size):
    """Slots past each history get the byte 0x7f (NaN in e4m3, 127 in
    int8) and a zero scale: the kernels must select them away."""
    pos = torch.arange(pt.shape[1] * page_size, device=pt.device)
    stale = pos[None, :] >= torch.tensor(hist, device=pt.device)[:, None]  # [B, MP*S]
    pages = pt.long().repeat_interleave(page_size, dim=1)[stale]
    slots = (pos % page_size).expand_as(stale)[stale]
    for rows in pools[:2]:
        rows.view(torch.uint8)[:, pages, slots] = 0x7F
    for plane in pools[2:]:
        plane[:, pages, slots] = 0.0


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("b,t", [(4, 1), (3, 128), (2, 64)])
def test_quantized_paged_write_bit_equal(b, t, mode):
    """Narrow bytes and scales bit-equal to the plain version off the null
    page; padding runs leave page 0 as it was."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(b * 100 + t + len(mode))
    L, P, S, hkv, d, mp = 4, 1 + 8 * b, 64, 8, 64, 8
    k_cache, k_scale = _quantized_pool((L, P, S, hkv, d), mode, gen, dev)
    v_cache, v_scale = _quantized_pool((L, P, S, hkv, d), mode, gen, dev)
    bf = dict(dtype=torch.bfloat16, device=dev)
    k_stage, v_stage = (3 * torch.randn((L, b, t, hkv, d), generator=gen, **bf)
                        for _ in range(2))
    k_stage[0, 0, 0, 0] = 0.0  # a zero row: the 1e-8 scale floor
    pt = (1 + torch.randperm(P - 1, generator=gen, device=dev)[: b * mp]).reshape(b, mp)
    pt = pt.to(torch.int32)
    if t == 1:
        pos = torch.randint(0, mp * S, (b, 1), generator=gen, device=dev).to(torch.int32)
        valid = torch.tensor([[True]] * (b - 1) + [[False]], device=dev)
    else:
        pos = torch.arange(t, device=dev, dtype=torch.int32)[None].expand(b, t).contiguous()
        valid = pos < torch.tensor([t, t // 2 + 1, 1][:b], device=dev)[:, None]
    before = (k_cache, v_cache, k_scale, v_scale)
    ops.reset_counts()
    got = kv_update.paged_write(*(x.clone() for x in before[:2]), k_stage, v_stage, pt, pos,
                                valid, k_scale=k_scale.clone(), v_scale=v_scale.clone())
    want = kv_update.paged_write_plain(*(x.clone() for x in before[:2]), k_stage, v_stage, pt,
                                       pos, valid, k_scale=k_scale.clone(),
                                       v_scale=v_scale.clone())
    for g, w, x in zip(got, want, before):
        g, w, x = (y.view(torch.uint8) if y.dtype == torch.float8_e4m3fn else y
                   for y in (g, w, x))
        assert torch.equal(g[:, 1:], w[:, 1:])  # page 0 is the null page
        assert torch.equal(g[:, 0], x[:, 0])  # the kernel skips padding runs
    c = ops.COUNTS[f"paged_write.{mode}"]
    assert (c.launches, c.plain_calls) == (1, 1)


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("b,hq,hkv,d", [(1, 32, 8, 64), (6, 32, 8, 64), (3, 8, 8, 128)])
def test_quantized_paged_decode_matches_plain(b, hq, hkv, d, mode):
    """acc/l and m within 1e-4 of the plain version over a quantized pool
    whose slots past each history hold NaN-encoding bytes and zero
    scales; zero history exactly (0, -inf, 0)."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(b * hq + d + len(mode))
    L, S, mp = 3, 64, 12
    P = 1 + b * mp
    pools = [*_quantized_pool((L, P, S, hkv, d), mode, gen, dev),
             *_quantized_pool((L, P, S, hkv, d), mode, gen, dev)]
    k_cache, k_scale, v_cache, v_scale = pools
    q = torch.randn((b, hq, d), generator=gen, dtype=torch.bfloat16, device=dev)
    pt = (1 + torch.randperm(P - 1, generator=gen, device=dev)[: b * mp]).reshape(b, mp)
    pt = pt.to(torch.int32)
    lens = [mp * S - 5, 0, 1, 64, 65, 300][:b]
    _stale_past_history((k_cache, v_cache, k_scale, v_scale), pt, lens, S)
    hist = torch.tensor(lens, dtype=torch.int32, device=dev)
    args = (q, k_cache, v_cache, 1, pt, hist)
    planes = dict(k_scale=k_scale, v_scale=v_scale)
    acc, m, l = paged_attention.paged_decode_attention(*args, **planes)
    racc, rm, rl = paged_attention.paged_decode_attention_plain(*args, **planes)
    some = hist > 0
    assert torch.isfinite(acc).all() and torch.isfinite(l).all()
    assert (acc[some] / l[some][..., None] - racc[some] / rl[some][..., None]).abs().max() <= 1e-4
    assert (m[some] - rm[some]).abs().max() <= 1e-4
    assert (acc[~some] == 0).all() and (l[~some] == 0).all() and torch.isneginf(m[~some]).all()


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("hq,hkv,d,t,hist,cur", [
    (32, 8, 64, 512, (0, 512, 1536, 3072), (512, 512, 300, 512)),
    (32, 8, 64, 96, (65, 1, 0, 700), (96, 17, 0, 95)),  # partial pages, a dead row
    (16, 2, 128, 64, (257, 0), (64, 64)),
])
def test_quantized_paged_prefill_matches_plain(hq, hkv, d, t, hist, cur, mode):
    """Each valid row within 2^-6 of its largest |value| over a quantized
    pool whose slots past each history hold NaN-encoding bytes and zero
    scales."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(hq + d + t + len(mode))
    b, L, S = len(hist), 3, 64
    mp = max(1, -(-max(hist) // S)) + 1
    P = 1 + b * mp
    bf = dict(dtype=torch.bfloat16, device=dev)
    q = torch.randn((b, t, hq, d), generator=gen, **bf)
    kc, vc = (torch.randn((b, t, hkv, d), generator=gen, **bf) for _ in range(2))
    k_cache, k_scale = _quantized_pool((L, P, S, hkv, d), mode, gen, dev)
    v_cache, v_scale = _quantized_pool((L, P, S, hkv, d), mode, gen, dev)
    pt = (1 + torch.randperm(P - 1, generator=gen, device=dev)[: b * mp]).reshape(b, mp)
    pt = pt.to(torch.int32)
    _stale_past_history((k_cache, v_cache, k_scale, v_scale), pt, hist, S)
    hl = torch.tensor(hist, dtype=torch.int32, device=dev)
    cl = torch.tensor(cur, dtype=torch.int32, device=dev)
    args = (q, kc, vc, k_cache, v_cache, 2, pt, hl, cl)
    planes = dict(k_scale=k_scale, v_scale=v_scale)
    got = flash_prefill.paged_prefill_attention(*args, **planes)
    want = flash_prefill.paged_prefill_attention_plain(*args, **planes)
    _assert_rows_close(got, want, cur)


def test_quantized_variants_are_counted_and_bad_inputs_raise():
    dev = _card()
    ops.reset_counts()
    bf = dict(dtype=torch.bfloat16, device=dev)
    q = torch.zeros((1, 32, 64), **bf)
    pool = torch.zeros((2, 4, 64, 8, 64), dtype=torch.int8, device=dev)
    planes = torch.zeros((2, 4, 64, 8), device=dev)
    pt = torch.tensor([[1, 2]], dtype=torch.int32, device=dev)
    hist = torch.tensor([70], dtype=torch.int32, device=dev)
    paged_attention.paged_decode_attention(q, pool, pool, 1, pt, hist,
                                           k_scale=planes, v_scale=planes)
    assert (ops.COUNTS["paged_decode_attention.int8"].launches,
            ops.COUNTS["paged_decode_attention"].launches) == (1, 0)
    with pytest.raises(ValueError, match="scale planes"):
        paged_attention.paged_decode_attention(q, pool, pool, 1, pt, hist)
    with pytest.raises(ValueError, match="float32"):
        paged_attention.paged_decode_attention(q, pool, pool, 1, pt, hist,
                                               k_scale=planes.bfloat16(),
                                               v_scale=planes.bfloat16())
    assert ops.COUNTS["paged_decode_attention.int8"].launches == 1
