"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`; each test decides inside itself whether a card is present
and skips when there is none (never at import, so every worker collects
the same tests). Run on the card with `python -m pytest -m cuda
tests/test_torch_cuda.py`. Shapes are llama3-1b's attention widths (Hq=32,
Hkv=8, D=64, page size 64) and a D=128 case; flash prefill also runs
groups of 1, 2, 4 and 8 at D 64 and 128, T around its tile edges, and
groups that do not divide its 128-row tile (7 at qwen2-7b's and
qwen2-0.5b's heads, with T around its 18-token edge, and 96); paged decode
runs groups of 1 to 32 heads (7 at both qwen2 shapes) at D 64 and 128,
histories around its 64-key stages, batches cut into one split and into
several, and calls on two streams at once; paged prefill runs page sizes
16, 64 and 128, groups of 1 to 32 heads (7 and 96 too) at D 64 and 128,
histories that end inside a key tile, a call captured in a CUDA graph and
replayed on new lengths (also at a group of 7, with flash prefill, at D
64 and 128), and two calls that must agree bit for bit. The wrappers
refuse head_dim 32 and 80 and a group over 128 heads, and serve a group of 3 and
head_dim 96. At head_dim 96 (phi3-mini) and 256 (gemma) every kernel
holds its plain version in every pool mode at groups of 1 and 8, with
lengths ragged across its tiles, and replays in a CUDA graph on new
inputs bit-equal to eager calls. The write is
bit-equal off the null page, also where its work units and grid can break
(more units than resident blocks, every run padding, one long prompt's
chunk, decode at B=64, D=128, 32 runs a sequence, Hkv 1 and 2), for rows
on the quantization's edges, and replayed in a CUDA graph. Paged decode
(several splits, so the ticket merge runs inside the graph, in every pool
mode) and flash prefill replay in a CUDA graph too, bit-equal to eager
calls. The engine's decode graphs give the eager loop's token streams bit
for bit, over each pool mode, count their captures, replays and
launches, and keep the decode workspace they were captured over; its
prefill graphs (first chunks, chunks with history, chunks that sample
nothing) do the same, and under overlapped decode a key replayed twice in
a row, and a prefill replayed between a speculated dispatch and its
readback, leave every id the eager loop's. With prefix caching on, graphs
and overlap, a wave that hits a warm request's pages leaves their bytes
(K, V, scale planes) unchanged, repeats bit for bit after
clear_cache() and gives its eager twin's streams, in each pool mode. Mixed
prefill+decode steps replayed as graphs give the eager loop's streams in
each pool mode, without and with overlapped decode, their graphs launch
every kernel variant of the pool and keep the decode workspace they
read, and a consumed speculation's ids reach the next speculation
intact across the pieces' replays. The sampling surface's keys (logprobs,
penalties, logit_bias with min_tokens) replayed as graphs give the eager
loop's ids, logprobs and alternatives bit for bit in each pool mode, with
and without overlapped decode, and a penalty key's graph replays right
on new histories and penalties. K-step windows (decode_kstep) replayed as
graphs give the eager loop's streams in each pool mode, with and without
overlapped decode, with a stop id, eos and a budget landing mid-window;
a window key replays on new prompts without a capture; and a row frozen
mid-window leaves the slots of its page past its stop as they were
poisoned, while the window's emitted counts equal the host's.
Prompt-lookup verify windows (spec_ngram): the write at run 1 lands
windows of 5 tokens that start mid-page bit-equal to its plain version
and leaves every poisoned slot outside them; paged prefill at T=5 over
unaligned histories holds its plain version, eager and replayed in a
CUDA graph on new inputs; the engine's verify graphs give the eager
loop's streams in each pool mode. Draft-model speculation
(spec_draft_model): the spec_fused and draft chunk graphs give the eager
loop's streams in each pool mode, without and with overlapped decode,
beside mixed steps, and a spec_fused key replays new prompts without a
capture, with a self-draft and with llama3-draft. Flash
prefill and paged prefill (bf16 output) hold each
valid (token, head) row within 2^-6 of the row's largest |value|, 2-4 bf16
ulps there; paged decode (f32 output) holds acc/l and m within 1e-4.
Each holds for bf16 pools and for quantized (int8, fp8) pools, where the
write's narrow bytes and scales are bit-equal too. The int8 weight product
holds each row within 2^-6 of the row's largest |value| at decode, chunk
and llama3-8b shapes, counts its launches, refuses what it does not serve,
replays in a CUDA graph, and an int8-weight engine's graphs give the eager
loop's streams. The logprob alternatives at a tie across the N-th place
follow (value descending, id ascending), stated in numpy (the card has no
JAX), eager and in a graph.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from dynamo_tpu_torch import ops
from dynamo_tpu_torch.engine import sampling
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import (
    DECODE_KINDS,
    PAGED_DECODE_KINDS,
    TorchEngine,
    key_field,
    key_has_surface,
)
from dynamo_tpu_torch.engine.request import FinishReason, SamplingParams
from dynamo_tpu_torch.engine.step_graph import StepGraph
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.models.registry import get_model
from dynamo_tpu_torch.ops import (
    _build,
    flash_prefill,
    int8_matmul,
    kv_quant,
    kv_update,
    paged_attention,
)

pytestmark = pytest.mark.cuda


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _bf(dev) -> dict:
    return dict(dtype=torch.bfloat16, device=dev)


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
    # groups that do not divide the 128-row tile: qwen2-7b's (28/4, D=128)
    # and qwen2-0.5b's (14/2, D=64), 18 tokens a CTA and 2 dead rows, with
    # T around that tile edge and rows whose keys wrap the ring; and 96
    # heads on one kv head (one token a CTA, 32 dead rows)
    (28, 4, 128, 300, (300, 0, 1, 257, 129)),
    (14, 2, 64, 300, (300, 0, 1, 257, 129)),
    *[(14, 2, 64, t, (t, max(1, t - 1), 1)) for t in (17, 18, 19, 36, 37)],
    (96, 1, 64, 70, (70, 3)),
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


def _prefill_cases(cases):
    """pytest params (Hq, Hkv, D, T, hist, cur, page size) from cases
    whose page size, when left out, is 64; a page size of 64 keeps the id
    the case had before page sizes were a parameter."""
    out = []
    for i, (hq, hkv, d, t, hist, cur, *s) in enumerate(cases):
        s = s[0] if s else 64
        tag = "" if s == 64 else f"-s{s}"
        out.append(pytest.param(hq, hkv, d, t, hist, cur, s,
                                id=f"{hq}-{hkv}-{d}-{t}-hist{i}-cur{i}{tag}"))
    return out


#: cases of both pool kinds: page sizes smaller and larger than the
#: kernel's 64-key tiles, every group size from 1 to 32 heads (g=32 leaves
#: 4 tokens a 128-row tile), and histories that end inside a tile, so the
#: chunk starts inside a page
PREFILL_MORE = [
    (32, 8, 64, 200, (0, 37, 300, 1000), (200, 150, 1, 77), 16),
    (32, 8, 64, 130, (129, 0, 400), (130, 64, 100), 128),
    (8, 8, 64, 100, (70, 200), (100, 3)),               # g=1
    (64, 8, 64, 96, (64, 129), (96, 40)),               # g=8
    (32, 2, 128, 70, (33, 0), (70, 70)),                # g=16
    (32, 1, 64, 45, (190, 5, 0), (45, 9, 45), 16),      # g=32
    (32, 1, 128, 40, (100,), (40,)),                    # g=32 at D=128
    (32, 8, 64, 160, (100, 1000, 29), (160, 97, 33)),   # histories end mid-tile
    (32, 8, 128, 96, (100, 191), (96, 50), 16),         # the same at D=128
    # a group of 7: 18 tokens a CTA, 2 dead rows (qwen2-7b, qwen2-0.5b)
    (28, 4, 128, 200, (0, 37, 300, 1000), (200, 150, 1, 77), 16),
    (14, 2, 64, 130, (129, 0, 400), (130, 36, 19)),
    (96, 1, 64, 40, (100, 7), (40, 9)),                  # g=96: 32 dead rows
]


def _seed(hq, d, t, s):
    """A case's seed; a page size of 64 keeps the seed it had before page
    sizes were a parameter."""
    return hq + d + t + (0 if s == 64 else s)


def _prefill_inputs(dev, hq, hkv, d, t, hist, cur, s, mode, seed, mp=None):
    """q, k_cur/v_cur, the pools (random, or quantized with their scale
    planes), page tables and lengths of one paged prefill case; a quantized
    pool's slots past each history hold NaN-encoding bytes and zero
    scales."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    b, L = len(hist), 3
    mp = mp or max(1, -(-max(hist) // s)) + 1
    P = 1 + b * mp
    bf = dict(dtype=torch.bfloat16, device=dev)
    q = torch.randn((b, t, hq, d), generator=gen, **bf)
    kc, vc = (torch.randn((b, t, hkv, d), generator=gen, **bf) for _ in range(2))
    planes = {}
    if mode is None:
        k_cache, v_cache = (torch.randn((L, P, s, hkv, d), generator=gen, **bf)
                            for _ in range(2))
    else:
        k_cache, k_scale = _quantized_pool((L, P, s, hkv, d), mode, gen, dev)
        v_cache, v_scale = _quantized_pool((L, P, s, hkv, d), mode, gen, dev)
        planes = dict(k_scale=k_scale, v_scale=v_scale)
    pt = (1 + torch.randperm(P - 1, generator=gen, device=dev)[: b * mp]).reshape(b, mp)
    pt = pt.to(torch.int32)
    if mode is not None:
        _stale_past_history((k_cache, v_cache, *planes.values()), pt, hist, s)
    hl = torch.tensor(hist, dtype=torch.int32, device=dev)
    cl = torch.tensor(cur, dtype=torch.int32, device=dev)
    return (q, kc, vc, k_cache, v_cache, 2, pt, hl, cl), planes


@pytest.mark.parametrize("hq,hkv,d,t,hist,cur,s", _prefill_cases([
    (32, 8, 64, 512, (0, 512, 1536, 3072), (512, 512, 300, 512)),
    (32, 8, 64, 96, (65, 1, 0, 700), (96, 17, 0, 95)),  # partial pages, a dead row
    (8, 8, 128, 130, (130, 64), (130, 7)),
    (16, 2, 128, 64, (257, 0), (64, 64)),
    *PREFILL_MORE,
]))
def test_paged_prefill_matches_plain(hq, hkv, d, t, hist, cur, s):
    dev = _card()
    args, _ = _prefill_inputs(dev, hq, hkv, d, t, hist, cur, s, None, seed=_seed(hq, d, t, s))
    got = flash_prefill.paged_prefill_attention(*args)
    want = flash_prefill.paged_prefill_attention_plain(*args)
    _assert_rows_close(got, want, cur)


@pytest.mark.parametrize("mode", [None, "int8", "fp8"])
def test_paged_prefill_is_deterministic(mode):
    """Two calls on the same inputs are bit-identical: no atomics, every
    row's keys are summed in one order."""
    dev = _card()
    args, planes = _prefill_inputs(dev, 32, 8, 64, 512, (0, 512, 1536, 3072),
                                   (512, 512, 300, 512), 64, mode, seed=13)
    first = flash_prefill.paged_prefill_attention(*args, **planes)
    second = flash_prefill.paged_prefill_attention(*args, **planes)
    assert torch.equal(first, second)


@pytest.mark.parametrize("mode", [None, "int8"])
def test_paged_prefill_replays_in_a_cuda_graph(mode):
    """One call captured in a CUDA graph, replayed after new inputs (other
    values, page tables and lengths, the same shapes) are copied into the
    captured buffers, gives what an eager call on them gives, bit for bit:
    the wrapper reads nothing from the device, so its launch holds for any
    lengths."""
    dev = _card()
    shape = (32, 8, 64, 256)
    args, planes = _prefill_inputs(dev, *shape, (0, 700, 64), (256, 100, 3), 64, mode,
                                   seed=17, mp=16)
    new_args, new_planes = _prefill_inputs(dev, *shape, (1000, 5, 0), (40, 256, 256), 64,
                                           mode, seed=18, mp=16)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):  # warm up: the build and first launch, outside the capture
        flash_prefill.paged_prefill_attention(*args, **planes)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = flash_prefill.paged_prefill_attention(*args, **planes)
    buffers = [x for x in args if torch.is_tensor(x)] + list(planes.values())
    news = [x for x in new_args if torch.is_tensor(x)] + list(new_planes.values())
    for dst, src in zip(buffers, news):
        dst.copy_(src)
    graph.replay()
    torch.cuda.synchronize(dev)
    eager = flash_prefill.paged_prefill_attention(*new_args, **new_planes)
    assert torch.equal(out, eager)
    _assert_rows_close(out, flash_prefill.paged_prefill_attention_plain(*new_args, **new_planes),
                       new_args[-1].tolist())


#: (Hq, Hkv): groups of 1, 4, 7, 8 and 32 query heads per kv head, and
#: qwen2-0.5b's 14 over 2 (g=7 at D 64)
DECODE_GROUPS = [(8, 8), (32, 8), (28, 4), (64, 8), (32, 1), (14, 2)]
#: pages per sequence in the decode tests' page tables (page size 64)
DECODE_MP = 12
#: zero, one token, around one page, a history that ends inside the ring's
#: fourth stage, a full page table
DECODE_HISTORIES = [0, 1, 63, 64, 65, 3 * 64 + 29, DECODE_MP * 64]


def _decode_batch(dev, hq, hkv, d, mode, splits):
    """A batch of DECODE_HISTORIES (cycled) that the split plan cuts into
    several splits, or the smallest power of two it gives one split."""
    if splits == "several":
        b = len(DECODE_HISTORIES)
        assert paged_attention.launch_plan(dev, b, hq, hkv, d, DECODE_MP, mode)[0] > 1
        return b
    b = len(DECODE_HISTORIES)
    while paged_attention.launch_plan(dev, b, hq, hkv, d, DECODE_MP, mode)[0] > 1:
        b *= 2
    return b


def _decode_inputs(dev, hq, hkv, d, mode, splits, seed, page_size=64, mp=DECODE_MP,
                   lens=None):
    """q, pools (and scale planes), page tables and history lengths
    (DECODE_HISTORIES cycled, or `lens`); a quantized pool's slots past
    each history hold NaN-encoding bytes and zero scales."""
    b = len(lens) if lens is not None else _decode_batch(dev, hq, hkv, d, mode, splits)
    gen = torch.Generator(device=dev).manual_seed(seed)
    L, S = 3, page_size
    P = 1 + b * mp
    planes = {}
    if mode is None:
        bf = dict(dtype=torch.bfloat16, device=dev)
        k_cache, v_cache = (torch.randn((L, P, S, hkv, d), generator=gen, **bf) for _ in range(2))
    else:
        k_cache, k_scale = _quantized_pool((L, P, S, hkv, d), mode, gen, dev)
        v_cache, v_scale = _quantized_pool((L, P, S, hkv, d), mode, gen, dev)
        planes = dict(k_scale=k_scale, v_scale=v_scale)
    q = torch.randn((b, hq, d), generator=gen, dtype=torch.bfloat16, device=dev)
    pt = (1 + torch.randperm(P - 1, generator=gen, device=dev)[: b * mp]).reshape(b, mp)
    pt = pt.to(torch.int32)
    if lens is None:
        lens = [DECODE_HISTORIES[i % len(DECODE_HISTORIES)] for i in range(b)]
    if mode is not None:
        _stale_past_history((k_cache, v_cache, *planes.values()), pt, lens, S)
    hist = torch.tensor(lens, dtype=torch.int32, device=dev)
    return (q, k_cache, v_cache, 1, pt, hist), planes


def _assert_decode_close(got, want, hist):
    """acc/l and m within 1e-4 where there is history; zero history
    exactly (0, -inf, 0)."""
    acc, m, l = got
    racc, rm, rl = want
    some = hist > 0
    assert torch.isfinite(acc).all() and torch.isfinite(l).all()
    assert (acc[some] / l[some][..., None] - racc[some] / rl[some][..., None]).abs().max() <= 1e-4
    assert (m[some] - rm[some]).abs().max() <= 1e-4
    assert (acc[~some] == 0).all() and (l[~some] == 0).all() and torch.isneginf(m[~some]).all()


@pytest.mark.parametrize("splits", ["several", "one"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("hq,hkv", DECODE_GROUPS)
def test_paged_decode_matches_plain(hq, hkv, d, splits):
    dev = _card()
    args, _ = _decode_inputs(dev, hq, hkv, d, None, splits, seed=hq * hkv + d)
    _assert_decode_close(paged_attention.paged_decode_attention(*args),
                         paged_attention.paged_decode_attention_plain(*args), args[-1])


@pytest.mark.parametrize("mode", [None, "int8"])
@pytest.mark.parametrize("page_size,mp", [(16, 300), (32, 9), (128, 5)])
def test_paged_decode_page_sizes(page_size, mp, mode):
    """Page sizes whose pages are smaller and larger than the kernel's
    64-key stages; 300 pages of 16 at B=1 cut into several pages a split."""
    dev = _card()
    full = page_size * mp
    lens = [full - 3] if mp > 100 else [0, full, full - page_size - 1, 1, page_size + 1]
    args, planes = _decode_inputs(dev, 32, 8, 64, mode, None, seed=page_size + mp,
                                  page_size=page_size, mp=mp, lens=lens)
    splits, per = paged_attention.launch_plan(dev, len(lens), 32, 8, 64, mp, mode)[:2]
    assert splits > 1 and (per > 1 or mp < 100)
    _assert_decode_close(paged_attention.paged_decode_attention(*args, **planes),
                         paged_attention.paged_decode_attention_plain(*args, **planes), args[-1])


@pytest.mark.parametrize("mode", [None, "int8", "fp8"])
def test_paged_decode_is_deterministic(mode):
    """Two calls on the same inputs are bit-identical: the last CTA of a
    sequence merges the splits in split order, whichever finished last."""
    dev = _card()
    args, planes = _decode_inputs(dev, 32, 8, 64, mode, "several", seed=11)
    first = paged_attention.paged_decode_attention(*args, **planes)
    second = paged_attention.paged_decode_attention(*args, **planes)
    for x, y in zip(first, second):
        assert torch.equal(x, y)


def test_paged_decode_on_two_streams():
    """Calls on two streams at once, each cut into several splits: each
    stream has its own ticket counters and partial states, so both merge
    their own splits."""
    dev = _card()
    cases = [_decode_inputs(dev, 32, 8, 64, mode, "several", seed=21 + i)
             for i, mode in enumerate((None, "int8"))]
    wants = [paged_attention.paged_decode_attention_plain(*a, **p) for a, p in cases]
    streams = [torch.cuda.Stream(dev) for _ in cases]
    torch.cuda.synchronize(dev)
    gots = []
    for stream, (args, planes) in zip(streams, cases):
        with torch.cuda.stream(stream):
            gots.append(paged_attention.paged_decode_attention(*args, **planes))
    torch.cuda.synchronize(dev)
    for got, want, (args, _) in zip(gots, wants, cases):
        _assert_decode_close(got, want, args[-1])


def test_paged_decode_refuses_a_small_workspace():
    """The C entry point checks the workspace against the layout it owns:
    one float or counter short is refused before any launch."""
    dev = _card()
    args, _ = _decode_inputs(dev, 32, 8, 64, None, "several", seed=5)
    q, k_cache, v_cache, layer, pt, hist = args
    b, hq, d = q.shape
    L, p, s, hkv, _ = k_cache.shape
    mp = pt.shape[1]
    splits, per, groups, floats = paged_attention.launch_plan(dev, b, hq, hkv, d, mp, None)
    assert splits > 1
    f32 = dict(dtype=torch.float32, device=dev)
    out = (torch.empty((b, hq, d), **f32), torch.empty((b, hq), **f32),
           torch.empty((b, hq), **f32))
    fn = _build.function("paged_attention", "dyn_paged_decode", paged_attention.DECODE_ARGTYPES)
    for n_floats, n_counters in ((floats - 1, b * groups), (floats, b * groups - 1)):
        partials = torch.empty(n_floats, **f32)
        counters = torch.zeros(n_counters, dtype=torch.int32, device=dev)
        err = fn(*map(_build.ptr, (q, k_cache, v_cache, None, None, pt, hist)),
                 _build.ptr(partials), n_floats,
                 _build.ptr(counters), n_counters,
                 *map(_build.ptr, out), 0, b, hq, hkv, d, layer, p, s, mp,
                 splits, per, 0.125, _build.stream(dev))
        assert err != 0
        assert (counters == 0).all()


def test_launches_are_counted_and_bad_inputs_raise():
    """Launches counted, plain calls not; refused: a dtype, head_dim 32
    and 80 (a D outside 64, 96, 128 and 256), a query group over the
    tile's 128 rows. A group of 3 and head_dim 96, once refused, are
    served."""
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
    with pytest.raises(ValueError, match="head_dim"):
        flash_prefill.flash_prefill_attention(
            torch.zeros((1, 64, 32, 80), **_bf(dev)), *[torch.zeros((1, 64, 8, 80), **_bf(dev))] * 2,
            vl)
    with pytest.raises(ValueError, match="at most 128 heads"):  # g = 130
        flash_prefill.flash_prefill_attention(
            torch.zeros((1, 64, 130, 64), **_bf(dev)), kv[:, :, :1], kv[:, :, :1], vl)
    assert c.launches == 1
    g3 = (q[:, :, :12].contiguous(), kv[:, :, :4].contiguous(), kv[:, :, :4].contiguous(), vl)
    _assert_rows_close(flash_prefill.flash_prefill_attention(*g3),
                       flash_prefill.flash_prefill_attention_plain(*g3), [64])
    assert c.launches == 2
    gen = torch.Generator(device=dev).manual_seed(96)
    d96 = (torch.randn((1, 64, 32, 96), generator=gen, **_bf(dev)),
           *[torch.randn((1, 64, 8, 96), generator=gen, **_bf(dev)) for _ in range(2)], vl)
    _assert_rows_close(flash_prefill.flash_prefill_attention(*d96),
                       flash_prefill.flash_prefill_attention_plain(*d96), [64])
    assert c.launches == 3


def test_paged_prefill_launches_are_counted_and_bad_inputs_raise():
    """Launches counted, plain calls not; refused: a dtype, page tables
    not int32, a layer out of range, head_dim 32 and 80 (a D outside 64,
    96, 128 and 256), a query group over the tile's 128 rows. A group of 3
    and head_dim 96, once refused, are served."""
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
    d80 = [torch.zeros(x.shape[:-1] + (80,), **bf) for x in (q, kv, pool)]
    with pytest.raises(ValueError, match="head_dim"):
        flash_prefill.paged_prefill_attention(d80[0], d80[1], d80[1], d80[2], d80[2], 1, pt,
                                              lens, lens)
    assert flash_prefill.paged_tile_rows() == 128  # the kernel's own row count
    with pytest.raises(ValueError, match="at most 128 heads"):  # g = 130
        flash_prefill.paged_prefill_attention(torch.zeros((1, 64, 130, 64), **bf),
                                              kv[:, :, :1], kv[:, :, :1], pool[..., :1, :],
                                              pool[..., :1, :], 1, pt, lens, lens)
    assert c.launches == 1
    g3 = (q[:, :, :12].contiguous(), kv[:, :, :4].contiguous(), kv[:, :, :4].contiguous(),
          pool[..., :4, :].contiguous(), pool[..., :4, :].contiguous(), 1, pt, lens, lens)
    _assert_rows_close(flash_prefill.paged_prefill_attention(*g3),
                       flash_prefill.paged_prefill_attention_plain(*g3), [64])
    assert c.launches == 2
    gen = torch.Generator(device=dev).manual_seed(96)
    d96 = [torch.randn(x.shape[:-1] + (96,), generator=gen, **bf) for x in (q, kv, kv, pool,
                                                                            pool)]
    d96 = (*d96, 1, pt, lens, lens)
    _assert_rows_close(flash_prefill.paged_prefill_attention(*d96),
                       flash_prefill.paged_prefill_attention_plain(*d96), [64])
    assert c.launches == 3


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
@pytest.mark.parametrize("splits", ["several", "one"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("hq,hkv", DECODE_GROUPS)
def test_quantized_paged_decode_matches_plain(hq, hkv, d, splits, mode):
    """acc/l and m within 1e-4 of the plain version over a quantized pool
    whose slots past each history hold NaN-encoding bytes and zero
    scales; zero history exactly (0, -inf, 0)."""
    dev = _card()
    args, planes = _decode_inputs(dev, hq, hkv, d, mode, splits, seed=hq * hkv + d + len(mode))
    _assert_decode_close(paged_attention.paged_decode_attention(*args, **planes),
                         paged_attention.paged_decode_attention_plain(*args, **planes), args[-1])


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("hq,hkv,d,t,hist,cur,s", _prefill_cases([
    (32, 8, 64, 512, (0, 512, 1536, 3072), (512, 512, 300, 512)),
    (32, 8, 64, 96, (65, 1, 0, 700), (96, 17, 0, 95)),  # partial pages, a dead row
    (16, 2, 128, 64, (257, 0), (64, 64)),
    *PREFILL_MORE,
]))
def test_quantized_paged_prefill_matches_plain(hq, hkv, d, t, hist, cur, s, mode):
    """Each valid row within 2^-6 of its largest |value| over a quantized
    pool whose slots past each history hold NaN-encoding bytes and zero
    scales."""
    dev = _card()
    args, planes = _prefill_inputs(dev, hq, hkv, d, t, hist, cur, s, mode,
                                   seed=_seed(hq, d, t, s) + len(mode))
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


# -- the write at the edges of its work units ----------------------------------------


def _write_inputs(dev, mode, L, b, t, s, hkv, d, lens, seed):
    """chip_smoke's write inputs at these widths: a page-aligned chunk whose
    first `lens[i]` tokens are valid, or at T=1 each sequence at its own
    position, valid where `lens[i]` is 1."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return chip_smoke.paged_write_inputs(dev, gen, b, t, mode, d, layers=L, page_size=s,
                                         hkv=hkv, lens=lens)


def _assert_write_bit_equal(pools, k_stage, v_stage, args, planes):
    """The kernel's pools (and scale planes) bit-equal to the plain
    version's on every page but the null page 0, which the kernel leaves
    as it was; returns the kernel's."""
    got = [x.clone() for x in pools]
    want = [x.clone() for x in pools]
    kv_update.paged_write(got[0], got[1], k_stage, v_stage, *args, **dict(zip(planes, got[2:])))
    kv_update.paged_write_plain(want[0], want[1], k_stage, v_stage, *args,
                                **dict(zip(planes, want[2:])))
    torch.cuda.synchronize()
    for g, w, x in zip(got, want, pools):
        g, w, x = (chip_smoke.as_bytes(y) for y in (g, w, x))
        assert torch.equal(g[:, 1:], w[:, 1:])
        assert torch.equal(g[:, 0], x[:, 0])  # the kernel skips padding runs
    return got


#: (L, B, T, S, Hkv, D, valid lengths): where the write's units and grid
#: can break
WRITE_EDGES = {
    # 5 x 13 x 8 runs of 8 units each: 4,160 units, more than the resident
    # blocks of any card of 132 SMs and no multiple of their count
    "more_units_than_blocks": (5, 13, 512, 64, 8, 64,
                               (512, 1, 64, 65, 300, 0, 512, 128, 129, 511, 2, 448, 200)),
    "all_padding": (2, 4, 128, 64, 8, 64, (0, 0, 0, 0)),
    "b1_t512_every_token": (16, 1, 512, 64, 8, 64, (512,)),
    "decode_b64": (4, 64, 1, 64, 8, 64, tuple(int(i % 7 != 3) for i in range(64))),
    "d128": (4, 3, 128, 64, 8, 128, (128, 70, 1)),
    "s16_t512": (3, 2, 512, 16, 8, 64, (512, 250)),  # 32 runs a sequence
    "hkv1": (3, 3, 64, 64, 1, 64, (64, 33, 1)),
    "hkv2": (3, 3, 64, 64, 2, 128, (64, 33, 1)),
    "hkv1_decode": (3, 5, 1, 64, 1, 64, (1, 1, 0, 1, 1)),
    "hkv2_s16": (2, 2, 64, 16, 2, 64, (64, 17)),
}


@pytest.mark.parametrize("mode", [None, "int8", "fp8"])
@pytest.mark.parametrize("edge", list(WRITE_EDGES))
def test_paged_write_edges_bit_equal(edge, mode):
    """Bit-equal to the plain version where the units and the grid can
    break: more units than resident blocks, every run padding (no page
    changes), one long prompt's chunk, a wide decode, D=128, many runs a
    sequence, and scale spans of 4 and 8 bytes (Hkv 1 and 2)."""
    dev = _card()
    L, b, t, s, hkv, d, lens = WRITE_EDGES[edge]
    pools, k_stage, v_stage, args, planes = _write_inputs(dev, mode, L, b, t, s, hkv, d, lens,
                                                          seed=len(edge) + 100 * b + t)
    got = _assert_write_bit_equal(pools, k_stage, v_stage, args, planes)
    if edge == "all_padding":
        for g, x in zip(got, pools):
            assert torch.equal(chip_smoke.as_bytes(g), chip_smoke.as_bytes(x))


def _edge_rows(mode, d):
    """Rows whose quantization sits on its edges, each exact in bf16: a zero
    row (the 1e-8 scale floor); for int8, rows whose values divide into
    exact halves (scales 1, 2 and 1/8, and a negative amax); for fp8, rows
    that reach +-448 (scale 1, and amax 3 where x / scale rounds near 448),
    ties between e4m3 neighbours and values that land among its
    subnormals."""
    half = torch.arange(d, dtype=torch.float32) - d // 2 + 0.5
    rows = [torch.zeros(d)]
    if mode == "int8":
        for amax, r in ((127.0, half), (254.0, 2 * half), (127 / 8, half / 8), (-127.0, half)):
            r = r.clone()
            r[0] = amax
            rows.append(r)
    else:
        r = torch.randn(d, generator=torch.Generator().manual_seed(d)).round()
        r[:12] = torch.tensor([448, -448, 8.5, 9.5, 10.5, 11.5, 272, -272, 304, 2 ** -8,
                               -3 * 2 ** -10, 15.5])
        rows.append(r)
        r = torch.full((d,), 2 ** -14)
        r[::2] = 3.0
        r[1::4] = -3.0
        rows.append(r)
    return torch.stack(rows)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quantized_paged_write_edge_rows(mode, d):
    """Narrow bytes and scales bit-equal to the plain version for rows on
    the quantization's edges, in K and in V, at several (token, kv head)
    places of a unit."""
    dev = _card()
    pools, k_stage, v_stage, args, planes = _write_inputs(dev, mode, 2, 2, 64, 64, 8, d,
                                                          (64, 40), seed=d + len(mode))
    rows = _edge_rows(mode, d).to(device=dev, dtype=torch.bfloat16)
    assert torch.equal(rows.float().cpu(), _edge_rows(mode, d))  # exact in bf16
    for i, row in enumerate(rows):
        for layer, stage in ((0, k_stage), (1, v_stage)):
            stage[layer, i % 2, (7 * i) % 40, i % 8] = row
            stage[1 - layer, 0, 63 - i, (3 * i) % 8] = -row
    _assert_write_bit_equal(pools, k_stage, v_stage, args, planes)


@pytest.mark.parametrize("mode", [None, "int8", "fp8"])
def test_paged_write_replays_in_a_cuda_graph(mode):
    """One write captured in a CUDA graph, replayed after new staged rows,
    positions, valid and page tables are copied into the captured
    buffers, lands what an eager call on them lands, bit for bit: the grid
    comes from the shapes and the card, so the launch holds for any data."""
    dev = _card()
    shape = (2, 3, 128, 64, 8, 64)
    pools, k_stage, v_stage, args, planes = _write_inputs(dev, mode, *shape, (128, 70, 1),
                                                          seed=21)
    _, k_new, v_new, new, _ = _write_inputs(dev, mode, *shape, (0, 128, 65), seed=22)
    new[1].add_(128)  # the second chunk of each sequence
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):  # warm up: the build and first launch, outside the capture
        scratch = [x.clone() for x in pools]
        kv_update.paged_write(scratch[0], scratch[1], k_stage, v_stage, *args,
                              **dict(zip(planes, scratch[2:])))
    torch.cuda.current_stream(dev).wait_stream(side)
    captured = [x.clone() for x in pools]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        kv_update.paged_write(captured[0], captured[1], k_stage, v_stage, *args,
                              **dict(zip(planes, captured[2:])))
    for dst, src in zip((k_stage, v_stage, *args), (k_new, v_new, *new)):
        dst.copy_(src)
    graph.replay()
    torch.cuda.synchronize(dev)
    eager = _assert_write_bit_equal(pools, k_new, v_new, new, planes)
    for g, e in zip(captured, eager):
        assert torch.equal(chip_smoke.as_bytes(g), chip_smoke.as_bytes(e))


# -- CUDA graphs ----------------------------------------------------------------


def _capture(dev, call):
    """call() warmed up on a side stream (the build, the first launch and
    that stream's decode workspace, outside the capture), then captured on
    the same stream; returns (graph, the captured call's output)."""
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = call()
    return graph, out


@pytest.mark.parametrize("mode", [None, "int8", "fp8"])
def test_paged_decode_replays_in_a_cuda_graph(mode):
    """One call cut into several splits, captured, replayed twice after new
    q, pools, page tables and history lengths (the same shapes) are copied
    into the captured buffers: both replays give what an eager call on the
    new inputs gives, bit for bit. The ticket merge runs inside the graph
    and leaves its counters at 0 for the next replay."""
    dev = _card()
    args, planes = _decode_inputs(dev, 32, 8, 64, mode, "several", seed=31)
    b = args[0].shape[0]
    assert paged_attention.launch_plan(dev, b, 32, 8, 64, DECODE_MP, mode)[0] > 1
    new_args, new_planes = _decode_inputs(dev, 32, 8, 64, mode, None, seed=32,
                                          lens=DECODE_HISTORIES[::-1])
    c = paged_attention.counts[mode]
    launches = c.launches
    graph, out = _capture(
        dev, lambda: paged_attention.paged_decode_attention(*args, **planes))
    assert c.launches == launches + 2  # the warm-up and the captured call
    for dst, src in zip([*args, *planes.values()], [*new_args, *new_planes.values()]):
        if torch.is_tensor(dst):
            dst.copy_(src)
    graph.replay()
    first = [x.clone() for x in out]
    graph.replay()
    torch.cuda.synchronize(dev)
    eager = paged_attention.paged_decode_attention(*new_args, **new_planes)
    for x, y, z in zip(first, out, eager):
        assert torch.equal(x, z) and torch.equal(y, z)
    _assert_decode_close(out, paged_attention.paged_decode_attention_plain(
        *new_args, **new_planes), new_args[-1])


def test_paged_decode_refuses_to_grow_its_workspace_in_a_capture():
    """A stream whose workspace was never sized raises inside a capture
    instead of allocating from the graph's pool."""
    dev = _card()
    args, _ = _decode_inputs(dev, 32, 8, 64, None, "several", seed=33)
    paged_attention.paged_decode_attention(*args)  # built, outside any capture
    fresh = torch.cuda.Stream(dev)
    paged_attention._workspace.pop((dev.index, fresh.cuda_stream), None)
    with pytest.raises(RuntimeError, match="sized before"):
        with torch.cuda.graph(torch.cuda.CUDAGraph(), stream=fresh):
            paged_attention.paged_decode_attention(*args)


def test_flash_prefill_replays_in_a_cuda_graph():
    """One ragged first chunk captured, replayed after new q, k, v and
    valid lengths are copied into the captured buffers: bit-equal to an
    eager call on them."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(41)
    bf = dict(dtype=torch.bfloat16, device=dev)

    def inputs(lens):
        q = torch.randn((4, 300, 32, 64), generator=gen, **bf)
        k, v = (torch.randn((4, 300, 8, 64), generator=gen, **bf) for _ in range(2))
        return q, k, v, torch.tensor(lens, dtype=torch.int32, device=dev)

    args, new = inputs((300, 1, 129, 64)), inputs((0, 300, 257, 33))
    graph, out = _capture(dev, lambda: flash_prefill.flash_prefill_attention(*args))
    for dst, src in zip(args, new):
        dst.copy_(src)
    graph.replay()
    torch.cuda.synchronize(dev)
    assert torch.equal(out, flash_prefill.flash_prefill_attention(*new))
    _assert_rows_close(out, flash_prefill.flash_prefill_attention_plain(*new),
                       new[-1].tolist())


@pytest.mark.parametrize("d", [64, 128])
def test_prefill_kernels_replay_in_a_cuda_graph_at_a_group_of_7(d):
    """Flash prefill and paged prefill (bf16 and int8 pools) at 14 query
    heads over 2 (18 tokens a CTA, 2 dead rows), each captured in a CUDA
    graph and replayed after new inputs are copied into the captured
    buffers: bit-equal to an eager call on them, and within the rows'
    tolerance of the plain version."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(43 + d)
    bf = _bf(dev)

    def flash_inputs(lens):
        q = torch.randn((3, 130, 14, d), generator=gen, **bf)
        k, v = (torch.randn((3, 130, 2, d), generator=gen, **bf) for _ in range(2))
        return q, k, v, torch.tensor(lens, dtype=torch.int32, device=dev)

    args, new = flash_inputs((130, 1, 37)), flash_inputs((0, 130, 18))
    graph, out = _capture(dev, lambda: flash_prefill.flash_prefill_attention(*args))
    for dst, src in zip(args, new):
        dst.copy_(src)
    graph.replay()
    torch.cuda.synchronize(dev)
    assert torch.equal(out, flash_prefill.flash_prefill_attention(*new))
    _assert_rows_close(out, flash_prefill.flash_prefill_attention_plain(*new),
                       new[-1].tolist())
    for mode in (None, "int8"):
        shape = (14, 2, d, 96)
        args, planes = _prefill_inputs(dev, *shape, (0, 700, 65), (96, 19, 3), 64, mode,
                                       seed=d + 1, mp=16)
        new_args, new_planes = _prefill_inputs(dev, *shape, (1000, 5, 0), (40, 96, 18), 64,
                                               mode, seed=d + 2, mp=16)
        graph, out = _capture(
            dev, lambda: flash_prefill.paged_prefill_attention(*args, **planes))
        buffers = [x for x in args if torch.is_tensor(x)] + list(planes.values())
        news = [x for x in new_args if torch.is_tensor(x)] + list(new_planes.values())
        for dst, src in zip(buffers, news):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize(dev)
        assert torch.equal(out, flash_prefill.paged_prefill_attention(*new_args, **new_planes))
        _assert_rows_close(
            out, flash_prefill.paged_prefill_attention_plain(*new_args, **new_planes),
            new_args[-1].tolist())


# -- head_dim 96 (phi3-mini) and 256 (gemma) ----------------------------------------

#: (Hq, Hkv) at the new head dims: a group of 1 (phi3-mini's, gemma-7b's)
#: and of 8 (gemma-2b's MQA)
NEW_D_GROUPS = [(8, 8), (8, 1)]


@pytest.mark.parametrize("mode", [None, "int8", "fp8"])
@pytest.mark.parametrize("hq,hkv", NEW_D_GROUPS)
@pytest.mark.parametrize("d", [96, 256])
def test_new_head_dims_match_plain(d, hq, hkv, mode):
    """Every kernel at head_dim 96 and 256 against its plain version in
    this pool mode: the write (a chunk and a decode step) bit-equal off the
    null page; flash prefill (with a bf16 pool's case) and paged prefill
    with each valid row within 2^-6 of its largest |value|, lengths ragged
    across the 64-key tiles and the 128-row tile's token edge; paged
    decode's acc/l and m within 1e-4, cut into one split and several."""
    dev = _card()
    seed = d + hq * hkv + len(mode or "")
    for t, lens in ((128, (128, 70, 1)), (1, (1, 0, 1))):
        pools, k_stage, v_stage, args, planes = _write_inputs(dev, mode, 2, 3, t, 64, hkv, d,
                                                              lens, seed=seed + t)
        _assert_write_bit_equal(pools, k_stage, v_stage, args, planes)
    if mode is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        lens = (130, 65, 64, 1, 129, 0)
        q = torch.randn((len(lens), 130, hq, d), generator=gen, **_bf(dev))
        k, v = (torch.randn((len(lens), 130, hkv, d), generator=gen, **_bf(dev))
                for _ in range(2))
        vl = torch.tensor(lens, dtype=torch.int32, device=dev)
        _assert_rows_close(flash_prefill.flash_prefill_attention(q, k, v, vl),
                           flash_prefill.flash_prefill_attention_plain(q, k, v, vl), lens)
    cur = (100, 64, 33, 1)
    args, planes = _prefill_inputs(dev, hq, hkv, d, 100, (0, 65, 191, 700), cur, 64, mode,
                                   seed=seed)
    _assert_rows_close(flash_prefill.paged_prefill_attention(*args, **planes),
                       flash_prefill.paged_prefill_attention_plain(*args, **planes), cur)
    for splits in ("several", "one"):
        args, planes = _decode_inputs(dev, hq, hkv, d, mode, splits, seed=seed)
        _assert_decode_close(paged_attention.paged_decode_attention(*args, **planes),
                             paged_attention.paged_decode_attention_plain(*args, **planes),
                             args[-1])


def _replays_like_eager(dev, call, buffers, news, eager):
    """call() captured, replayed after `news` are copied into `buffers`:
    returns the replay's output and an eager call's on the new inputs."""
    graph, out = _capture(dev, call)
    for dst, src in zip(buffers, news):
        dst.copy_(src)
    graph.replay()
    torch.cuda.synchronize(dev)
    return out, eager()


@pytest.mark.parametrize("mode", [None, "int8", "fp8"])
@pytest.mark.parametrize("d", [96, 256])
def test_new_head_dims_replay_in_a_cuda_graph(d, mode):
    """At head_dim 96 and 256 (8 query heads over 1), each kernel captured
    in a CUDA graph and replayed on new inputs copied into its buffers
    gives what an eager call on them gives, bit for bit: the write (its
    pools), flash prefill (with a bf16 pool's case), paged prefill and
    paged decode (cut into several splits, so the ticket merge replays)."""
    dev = _card()
    hq, hkv = 8, 1
    shape = (2, 3, 128, 64, hkv, d)
    pools, k_stage, v_stage, args, planes = _write_inputs(dev, mode, *shape, (128, 70, 1),
                                                          seed=d + 1)
    _, k_new, v_new, new, _ = _write_inputs(dev, mode, *shape, (0, 128, 65), seed=d + 2)
    new[1].add_(128)  # the second chunk of each sequence
    # the warm-up writes into a scratch copy, the capture into `captured`
    scratch, captured = [x.clone() for x in pools], [x.clone() for x in pools]
    into = iter((scratch, captured))

    def write():
        dst = next(into)
        kv_update.paged_write(dst[0], dst[1], k_stage, v_stage, *args,
                              **dict(zip(planes, dst[2:])))

    graph, _ = _capture(dev, write)
    for dst, src in zip((k_stage, v_stage, *args), (k_new, v_new, *new)):
        dst.copy_(src)
    graph.replay()
    torch.cuda.synchronize(dev)
    eager = _assert_write_bit_equal(pools, k_new, v_new, new, planes)
    for g, e in zip(captured, eager):
        assert torch.equal(chip_smoke.as_bytes(g), chip_smoke.as_bytes(e))
    if mode is None:
        gen = torch.Generator(device=dev).manual_seed(d)

        def flash_inputs(lens):
            q = torch.randn((3, 130, hq, d), generator=gen, **_bf(dev))
            k, v = (torch.randn((3, 130, hkv, d), generator=gen, **_bf(dev)) for _ in range(2))
            return q, k, v, torch.tensor(lens, dtype=torch.int32, device=dev)

        fargs, fnew = flash_inputs((130, 1, 37)), flash_inputs((0, 130, 64))
        out, eager = _replays_like_eager(
            dev, lambda: flash_prefill.flash_prefill_attention(*fargs), fargs, fnew,
            lambda: flash_prefill.flash_prefill_attention(*fnew))
        assert torch.equal(out, eager)
        _assert_rows_close(out, flash_prefill.flash_prefill_attention_plain(*fnew),
                           fnew[-1].tolist())
    pargs, pplanes = _prefill_inputs(dev, hq, hkv, d, 96, (0, 700, 65), (96, 19, 3), 64, mode,
                                     seed=d + 3, mp=16)
    pnew, pnew_planes = _prefill_inputs(dev, hq, hkv, d, 96, (1000, 5, 0), (40, 96, 18), 64,
                                        mode, seed=d + 4, mp=16)
    out, eager = _replays_like_eager(
        dev, lambda: flash_prefill.paged_prefill_attention(*pargs, **pplanes),
        [x for x in pargs if torch.is_tensor(x)] + list(pplanes.values()),
        [x for x in pnew if torch.is_tensor(x)] + list(pnew_planes.values()),
        lambda: flash_prefill.paged_prefill_attention(*pnew, **pnew_planes))
    assert torch.equal(out, eager)
    _assert_rows_close(out, flash_prefill.paged_prefill_attention_plain(*pnew, **pnew_planes),
                       pnew[-1].tolist())
    dargs, dplanes = _decode_inputs(dev, hq, hkv, d, mode, "several", seed=d + 5)
    assert paged_attention.launch_plan(dev, dargs[0].shape[0], hq, hkv, d, DECODE_MP,
                                       mode)[0] > 1
    dnew, dnew_planes = _decode_inputs(dev, hq, hkv, d, mode, None, seed=d + 6,
                                       lens=DECODE_HISTORIES[::-1])
    out, eager = _replays_like_eager(
        dev, lambda: paged_attention.paged_decode_attention(*dargs, **dplanes),
        [x for x in [*dargs, *dplanes.values()] if torch.is_tensor(x)],
        [x for x in [*dnew, *dnew_planes.values()] if torch.is_tensor(x)],
        lambda: paged_attention.paged_decode_attention(*dnew, **dnew_planes))
    for x, y in zip(out, eager):
        assert torch.equal(x, y)
    _assert_decode_close(out, paged_attention.paged_decode_attention_plain(
        *dnew, **dnew_planes), dnew[-1])


@pytest.fixture(scope="module")
def llama_params():
    """Random-init llama3-1b weights (bf16) from seed 0, shared by every
    engine of the graph tests."""
    dev = _card()
    return get_model("llama3-1b").init_params(torch.Generator(device=dev).manual_seed(0))


def _engines(params, mode, overlap=(False, False), **knobs):
    """(eager, graphs): two llama3-1b engines over one set of weights and
    pools of `mode`, buckets 1-8 and up to 8 fused steps, with overlapped
    decode as `overlap` says for each, and prefix caching and mixed steps
    off unless `knobs` turn them on (a wave run again would hit its own
    pages; the mixed tests below turn mixed steps on)."""
    cfg = dict(model="llama3-1b", num_pages=96, page_size=64, max_pages_per_seq=8,
               decode_buckets=(1, 2, 4, 8), max_seqs=8, decode_steps=8, kv_quantize=mode,
               eos_token_ids=(0,), enable_prefix_caching=False, mixed_steps=False)
    cfg.update(knobs)
    return [TorchEngine(EngineConfig(**cfg, overlap_decode=o), params=params, device="cuda",
                        cuda_graphs=g) for g, o in zip((False, True), overlap)]


#: waves of (requests, max_tokens): K of 8, 4, 2 and 1 over buckets 8, 4, 2
#: and 1, then four and three rows in bucket 4 (three after four, so a stale
#: row would show) and five rows in bucket 8 again
GRAPH_WAVES = [(5, 9), (3, 5), (2, 3), (1, 2), (4, 9), (3, 9), (5, 9)]


def _run_waves(eng, waves, sampling=None, tag="", length=lambda i: 20 + 30 * i):
    """Each wave's requests together (prompts of length(i) random tokens,
    20-140 by default, from a fixed seed); returns request id -> generated
    ids."""
    gen = torch.Generator().manual_seed(5)
    out = {}
    for w, (n, max_tokens) in enumerate(waves):
        for i in range(n):
            prompt = torch.randint(1, 128_000, (length(i),), generator=gen).tolist()
            sp = SamplingParams(max_tokens=max_tokens, ignore_eos=True, **(sampling or {}))
            eng.add_request(f"{tag}{w}-{i}", prompt, sp)
        out.update(eng.run_to_completion())
    return out


@pytest.mark.parametrize("mode", [None, "int8", "fp8"])
def test_decode_graphs_give_the_eager_streams(llama_params, mode):
    """Greedy streams with graphs on equal the eager loop's bit for bit,
    over K in {1, 2, 4, 8} and buckets 1-8, a smaller batch after a larger
    one in a bucket included; each key is captured once, every decode
    dispatch replays, and a wave run again with every key captured counts
    the eager loop's launches, pool variant by variant, and no plain call.
    (Overlap off in both: the prefill steps replay graphs too.)"""
    eager, graphs = _engines(llama_params, mode)
    want = _run_waves(eager, GRAPH_WAVES)
    got = _run_waves(graphs, GRAPH_WAVES)
    assert got == want
    keys = [k for k, fn in graphs._step_fns.items() if isinstance(fn, StepGraph)]
    assert sorted(keys) == sorted(eager.step_keys)
    decode = [k for k in keys if k[0] in DECODE_KINDS]
    assert {k[1] for k in decode} == {1, 2, 4, 8} and {k[2] for k in decode} == {1, 2, 4, 8}
    m = graphs.metrics
    assert m.compiles == len(keys) and m.compile_ms > 0
    assert m.decode_replays == m.decode_dispatches == eager.metrics.decode_dispatches
    assert sum(fn.replays for fn in graphs._step_fns.values()) == (
        m.decode_replays + m.prefill_replays) == graphs.dispatches
    assert eager.metrics.compiles == eager.metrics.decode_replays == 0
    counts = []
    for eng in (eager, graphs):
        ops.reset_counts()
        _run_waves(eng, GRAPH_WAVES[-1:], tag="again")
        torch.cuda.synchronize()
        counts.append({k: (c.launches, c.plain_calls) for k, c in ops.COUNTS.items()})
    assert counts[0] == counts[1]
    decode = kv_quant.variant("paged_decode_attention", mode)
    assert counts[1][decode][0] > 0 and all(p == 0 for _, p in counts[1].values())
    assert graphs.metrics.compiles == len(keys)  # no key was captured again


def test_decode_graphs_hold_their_workspace(llama_params):
    """A graph keeps the decode workspace it was captured over. The capture
    stream's entry is replaced by a larger one (as a later user of a stream
    with the same handle would grow it), the old tensors' memory is handed
    out again and filled with garbage, and the replays still give the
    eager loop's streams (one sequence: several splits, so the ticket
    counters and partials are read)."""
    eager, graphs = _engines(llama_params, None)
    waves = [(1, 9)]
    want = _run_waves(eager, waves)
    assert _run_waves(graphs, waves) == want
    dev, counters, partials = graphs._workspace_size
    with torch.cuda.stream(graphs._graph_stream):
        old = paged_attention.workspace(dev, 0, 0)
        assert old[1].numel() > 1  # the captured plan splits its pages
        paged_attention.workspace(dev, counters + 1, partials + 1)
    shapes = [(t.numel(), t.dtype) for t in old]
    del old
    junk = [torch.full((n,), 3, dtype=dtype, device=dev) for n, dtype in shapes]
    got = _run_waves(graphs, waves, tag="again")
    assert {k[len("again"):]: v for k, v in got.items()} == want
    # one prefill key and one decode key
    assert graphs.metrics.compiles == 2 and graphs.metrics.decode_replays == 2
    del junk


def test_decode_graphs_give_the_eager_seeded_samples(llama_params):
    """Seeded sampled requests (the sampled variant of each key, its noise
    made on the host) draw the same ids with graphs on and off."""
    eager, graphs = _engines(llama_params, None)
    sampling = dict(temperature=0.8, top_p=0.95, top_k=40, seed=7)
    waves = [(3, 9), (1, 3)]
    want = _run_waves(eager, waves, sampling)
    assert _run_waves(graphs, waves, sampling) == want
    # the sampled variants
    assert all(not k[3] for k in graphs.step_keys if k[0] in ("prefill",) + DECODE_KINDS)
    assert graphs.metrics.compiles == len(graphs.step_keys)


#: prompts of 300, 170, 40 and 110 tokens at a chunk of 128: first chunks
#: and chunks with history in one step, and steps that sample nothing
PREFILL_LENGTH = (300, 170, 40, 110).__getitem__


@pytest.mark.parametrize("mode", [None, "int8", "fp8"])
def test_prefill_graphs_give_the_eager_streams(llama_params, mode):
    """Prefill chunk steps replayed as graphs give the eager streams bit for
    bit, greedy and seeded sampled: first chunks, chunks with history and
    chunks that sample nothing, with every dispatch a replay."""
    eager, graphs = _engines(llama_params, mode, prefill_chunk=128)
    sampling = dict(temperature=0.8, top_p=0.95, seed=7)
    for eng in (eager, graphs):
        ops.reset_counts()
        eng.streams = (_run_waves(eng, [(4, 5), (1, 3)], length=PREFILL_LENGTH),
                       _run_waves(eng, [(3, 4)], sampling, "s", length=PREFILL_LENGTH))
        torch.cuda.synchronize()
        # the graph engine's warm-ups launch too
        eng.counts = {k: (c.launches, c.plain_calls) for k, c in ops.COUNTS.items()}
    assert graphs.streams == eager.streams
    keys = set(graphs.step_keys)
    assert keys == set(eager.step_keys)
    prefill = {(k[0], key_field(k, "first_chunk")) for k in keys if k[0] not in DECODE_KINDS}
    assert prefill == {(kind, first) for kind in ("prefill", "prefill_nosample")
                       for first in (True, False)}
    m = graphs.metrics
    assert m.prefill_replays >= m.prefill_dispatches == eager.metrics.prefill_dispatches > 0
    assert m.prefill_replays + m.decode_replays == graphs.dispatches == eager.dispatches
    assert m.compiles == len(keys)
    for name in ("paged_prefill_attention", "flash_prefill_attention"):
        assert graphs.counts[kv_quant.variant(name, mode if "paged" in name else None)][0] > 0
    assert all(plain == 0 for _, plain in graphs.counts.values())


def test_overlap_replays_one_decode_key_twice_in_a_row(llama_params):
    """One step at a time with overlap on: each speculated dispatch replays
    the key its predecessor just replayed, its tokens copied from that
    replay's output before it is overwritten; the ids equal the eager
    loop's without overlap."""
    eager, graphs = _engines(llama_params, None, overlap=(False, True), decode_steps=1)
    waves = [(3, 12), (1, 9)]
    want = _run_waves(eager, waves)
    assert _run_waves(graphs, waves) == want
    m = graphs.metrics
    assert m.overlap_hits > 10 and m.overlap_hits + m.overlap_rollbacks == m.overlap_dispatches
    decode = [k for k in graphs.step_keys if k[0] in DECODE_KINDS]
    assert {k[:3] for k in decode} == {("decode", 4, 1), ("decode", 1, 1)}
    assert m.decode_replays == m.decode_dispatches + m.overlap_rollbacks


def test_a_prefill_replay_before_a_readback_changes_no_id(llama_params):
    """A speculated decode replay is in flight when a request arrives: its
    prefill (a 500-token chunk, whose graph shares the pool) replays before
    the speculation's ids are read. The ids read then are the tokens the
    eager loop without overlap generates at those positions, in the same
    batch. (Later ids are not compared: the late request changes the
    batch's bucket, and bf16 GEMMs round differently at another size.)"""
    eager, graphs = _engines(llama_params, None, overlap=(False, True), decode_steps=1)
    want = _run_waves(eager, [(2, 12)])
    late = torch.randint(1, 128_000, (500,), generator=torch.Generator().manual_seed(9))
    gen = torch.Generator().manual_seed(5)
    for i in range(2):
        prompt = torch.randint(1, 128_000, (20 + 30 * i,), generator=gen).tolist()
        graphs.add_request(f"0-{i}", prompt, SamplingParams(max_tokens=12, ignore_eos=True))
    got: dict[str, list[int]] = {}
    while graphs._inflight is None or min(map(len, got.values())) < 4:
        for o in graphs.step():
            got.setdefault(o.request_id, []).extend(o.new_token_ids)
    inflight = graphs._inflight
    at = {r.request_id: len(r.output_tokens) for r in inflight.reqs}
    replays = graphs.metrics.prefill_replays
    graphs.add_request("late", late.tolist(), SamplingParams(max_tokens=4, ignore_eos=True))
    graphs.step()  # the prefill: rolls the speculation back
    assert graphs._inflight is None and graphs.metrics.prefill_replays == replays + 1
    assert graphs.metrics.overlap_rollbacks == 1
    ids = inflight.ids.numpy()  # read after the prefill replay
    for row, (rid, n) in enumerate(at.items()):
        assert got[rid] == want[rid][:n] and ids[0, row] == want[rid][n], rid
    graphs.run_to_completion()


#: a shared prefix of 300 tokens (4 whole pages), then prompts that hit it:
#: tails of 1, 63 and 200 tokens, the prefix's 4 pages exactly (cached
#: whole: its last page recomputed) and a prompt that shares no page
PREFIX_TAILS = (1, 63, 200)


def _prefix_waves():
    gen = torch.Generator().manual_seed(21)
    draw = lambda n: torch.randint(1, 128_000, (n,), generator=gen).tolist()  # noqa: E731
    prefix = draw(300)
    warm = [("w", prefix + draw(20))]
    wave = [(f"t{n}", prefix + draw(n)) for n in PREFIX_TAILS]
    wave += [("whole", prefix[:256]), ("cold", draw(90))]
    return warm, wave


@pytest.mark.parametrize("mode", [None, "int8", "fp8"])
def test_prefix_hits_with_graphs_and_overlap(llama_params, mode):
    """One engine with graphs, overlapped decode and prefix caching: a warm
    request registers the shared prefix's pages; a wave that hits them
    (three tails, a prompt cached whole, a cold prompt) leaves every
    registered page's bytes as they were, K, V and the scale planes; after
    clear_cache(), which returns every cached page, the warm request and
    the wave again give the same streams bit for bit; and its eager twin
    (caching and overlap on, no graphs) gives the same streams and
    cached_tokens, so a replayed chunk key with history is held against
    the eager loop."""
    eager, eng = _engines(llama_params, mode, overlap=(True, True),
                          enable_prefix_caching=True, max_pages_per_seq=16)
    warm, wave = (dict(w) for w in _prefix_waves())
    runs = []
    for _ in range(2):
        first = chip_smoke.serve_requests(eng, warm, 12)
        pages = list(eng.allocator._page_meta)
        before = chip_smoke.page_bytes(eng, pages)
        runs.append((first, chip_smoke.serve_requests(eng, wave, 12)))
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(before, chip_smoke.page_bytes(eng, pages)))
        cached = len(eng.allocator._page_meta)
        assert eng.allocator.clear_cache() == cached > len(pages)
        assert eng.allocator.num_free == eng.config.num_pages - 1
    assert runs[0] == runs[1]
    assert runs[0][1][1] == {"t1": 256, "t63": 256, "t200": 256, "whole": 192, "cold": 0}
    m = eng.metrics
    assert m.overlap_hits > 0 and m.compiles == len(eng.step_keys)
    assert m.prefill_replays + m.decode_replays == eng.dispatches
    assert any(k[0].startswith("prefill") and not key_field(k, "first_chunk")
               for k in eng.step_keys)
    assert (chip_smoke.serve_requests(eager, warm, 12),
            chip_smoke.serve_requests(eager, wave, 12)) == runs[0]


def _run_late(eng, tag="", arrivals=((3, (300, 200)),), max_tokens=24, late_tokens=6):
    """A request of 40 random tokens decoding `max_tokens`, joined after
    each arrival's count of steps by prompts of its lengths (at a chunk of
    128, 3 and 2 chunks for 300 and 200) decoding `late_tokens`; returns
    request id -> generated ids. Without overlap each step with prefill work is one fused mixed
    step; the first is all first chunks, the later ones chunks with
    history, and the 200-token prompt's last piece is sampled beside the
    decode rows."""
    gen = torch.Generator().manual_seed(6)
    draw = lambda n: torch.randint(1, 128_000, (n,), generator=gen).tolist()  # noqa: E731
    eng.add_request(f"{tag}w", draw(40), SamplingParams(max_tokens=max_tokens, ignore_eos=True))
    out: dict[str, list[int]] = {}
    steps = 0
    for a, (at, lengths) in enumerate(arrivals):
        while steps < at:
            for o in eng.step():
                out.setdefault(o.request_id, []).extend(o.new_token_ids)
            steps += 1
        for i, n in enumerate(lengths):
            eng.add_request(f"{tag}l{a}-{i}", draw(n),
                            SamplingParams(max_tokens=late_tokens, ignore_eos=True))
    for rid, ids in eng.run_to_completion().items():
        out.setdefault(rid, []).extend(ids)
    return out


@pytest.mark.parametrize("mode", [None, "int8", "fp8"])
def test_mixed_graphs_give_the_eager_streams(llama_params, mode):
    """Mixed steps replayed as graphs give the eager loop's streams bit for
    bit, without overlapped decode (every mixed step one fused dispatch,
    which replays its key's graph) and with it in both engines (decode
    halves that are consumed speculations); the fused mixed graphs launch
    every kernel variant of the pool (first chunks, chunks with history,
    the writes, paged decode), and nothing runs a plain version."""
    for overlap in (False, True):
        eager, graphs = _engines(llama_params, mode, overlap=(overlap, overlap),
                                 mixed_steps=True, prefill_chunk=128)
        ops.reset_counts()
        want = _run_late(eager)
        assert _run_late(graphs) == want
        assert all(c.plain_calls == 0 for c in ops.COUNTS.values())
        m = graphs.metrics
        assert m.mixed_dispatches == eager.metrics.mixed_dispatches > 1
        assert m.prefill_replays + m.decode_replays + m.mixed_replays == graphs.dispatches
        assert m.decode_replays + m.mixed_replays == (m.decode_dispatches + m.mixed_dispatches
                                                      + m.overlap_rollbacks)
        if overlap:
            assert m.overlap_hits > 0
            continue
        assert m.mixed_replays == m.mixed_dispatches
        assert {key_field(k, "first_chunk") for k in graphs.step_keys
                if k[0] == "mixed"} == {True, False}
        launched = {name for k, g in graphs._step_fns.items() if k[0] == "mixed"
                    for name, (n, plain) in g.launches.items() if n and not plain}
        assert launched == set(chip_smoke.serve_variants(mode))


def test_mixed_graphs_hold_their_workspace(llama_params):
    """A mixed graph runs paged decode for its decode half, so it keeps
    the workspace it was captured over, as a decode graph does: after the
    capture stream's entry is replaced and the old memory filled with
    garbage, the replays still give the eager loop's streams."""
    eager, graphs = _engines(llama_params, None, mixed_steps=True, prefill_chunk=128)
    want = _run_late(eager)
    assert _run_late(graphs) == want
    assert all(g.keep for k, g in graphs._step_fns.items() if k[0] in PAGED_DECODE_KINDS)
    assert any(k[0] == "mixed" for k in graphs.step_keys)
    dev, counters, partials = graphs._workspace_size
    with torch.cuda.stream(graphs._graph_stream):
        old = paged_attention.workspace(dev, 0, 0)
        paged_attention.workspace(dev, counters + 1, partials + 1)
    shapes = [(t.numel(), t.dtype) for t in old]
    del old
    junk = [torch.full((n,), 3, dtype=dtype, device=dev) for n, dtype in shapes]
    compiles = graphs.metrics.compiles
    got = _run_late(graphs, tag="again")
    assert {k[len("again"):]: v for k, v in got.items()} == want
    assert graphs.metrics.compiles == compiles  # every key replayed, none captured
    del junk


def test_a_split_mixed_step_feeds_its_speculation_the_right_ids(llama_params):
    """With overlap, a mixed step whose decode half is a consumed
    speculation replays the pieces' prefill graph before the next
    speculation copies the consumed one's ids on the device. A second
    arrival replays a prefill key captured before the decode key that
    speculates, so that replay may overwrite the decode graph's output
    (graphs share a pool): the ids the next speculation is fed must be
    the consumed ones all the same, and the streams the eager twin's. (The
    first arrival's prompts decode 40 tokens, so the second finds three
    rows speculating under a decode key captured after that prefill key.)"""
    eager, graphs = _engines(llama_params, None, overlap=(True, True), mixed_steps=True,
                             prefill_chunk=128)
    kw = dict(arrivals=((3, (300, 200)), (9, (300, 200))), max_tokens=120, late_tokens=40)
    want = _run_late(eager, **kw)
    assert _run_late(graphs, **kw) == want
    m = graphs.metrics
    assert m.overlap_hits > 0 and m.mixed_dispatches > m.mixed_replays


#: waves of (requests, max_tokens, sampling knobs) over the sampling
#: surface's keys: logprobs 5, the three penalties, and logit_bias beside
#: min_tokens with +100 on eos (so those rows end on their sixth token)
SURFACE_WAVES = [
    (3, 17, dict(logprobs=5)),
    (2, 9, dict(frequency_penalty=1.0, presence_penalty=0.5, repetition_penalty=1.3,
                logprobs=0)),
    (2, 9, dict(logit_bias=((4242, 5.0), (0, 100.0)), min_tokens=5, ignore_eos=False)),
]


def _run_surface(eng, waves, tag="", seed=8):
    """Each wave's requests together (prompts of 20-80 random tokens from
    `seed`): request id -> (ids, logprobs, top alternatives, finish)."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for w, (n, max_tokens, knobs) in enumerate(waves):
        for i in range(n):
            prompt = torch.randint(1, 128_000, (20 + 30 * i,), generator=gen).tolist()
            eng.add_request(f"{tag}{w}-{i}", prompt, SamplingParams(
                max_tokens=max_tokens, **{"ignore_eos": True, **knobs}))
        while eng.has_work:
            for o in eng.step():
                ids, lps, tops, _ = out.get(o.request_id, ((), (), (), None))
                out[o.request_id] = (ids + o.new_token_ids, lps + (o.logprobs or ()),
                                     tops + (o.top_logprobs or ()), o.finish_reason)
    return out


@pytest.mark.parametrize("mode", [None, "int8", "fp8"])
def test_sampling_surface_graphs_give_the_eager_outputs(llama_params, mode):
    """Logprob, penalty and bias keys replayed as graphs give the eager
    loop's ids, logprobs and top alternatives bit for bit, without and with
    overlapped decode (bias and logprob rows speculate, penalized ones do
    not; the logprob rows outlive a dispatch of 8, so one speculates); each
    such key is captured once and replayed, and nothing runs a plain
    version. The min_tokens rows end on eos at their sixth token."""
    for overlap in (False, True):
        eager, graphs = _engines(llama_params, mode, overlap=(overlap, overlap))
        ops.reset_counts()
        want = _run_surface(eager, SURFACE_WAVES)
        got = _run_surface(graphs, SURFACE_WAVES)
        assert got == want
        assert all(c.plain_calls == 0 for c in ops.COUNTS.values())
        for rid in ("2-0", "2-1"):
            assert len(got[rid][0]) == 6 and got[rid][0][-1] == 0
        keys = [k for k in graphs.step_keys if key_has_surface(k)]
        assert {k[0] for k in keys} >= {"prefill", "decode_multi"}
        assert all(isinstance(graphs._step_fns[k], StepGraph) and graphs._step_fns[k].replays
                   for k in keys)
        m = graphs.metrics
        assert m.compiles == len(graphs.step_keys)
        assert m.prefill_replays + m.decode_replays + m.mixed_replays == graphs.dispatches
        if overlap:
            assert m.overlap_hits > 0


def test_a_penalty_graph_replays_on_new_histories(llama_params):
    """A penalty key's graph, captured over one wave, replays a second wave
    of other prompts and other penalties under the same keys (no capture)
    to the eager loop's ids; the penalties change the greedy stream."""
    eager, graphs = _engines(llama_params, None)
    first = [(2, 17, dict(frequency_penalty=1.0))]
    second = [(2, 17, dict(presence_penalty=2.0, repetition_penalty=1.8))]
    for eng in (eager, graphs):
        _run_surface(eng, first, tag="a")
    compiles = graphs.metrics.compiles
    want = _run_surface(eager, second, tag="b", seed=9)
    assert _run_surface(graphs, second, tag="b", seed=9) == want
    assert graphs.metrics.compiles == compiles
    assert any(key_field(k, "pen") > 1 for k in graphs.step_keys if k[0] in DECODE_KINDS)
    plain = _run_surface(eager, [(2, 17, {})], tag="b", seed=9)
    assert plain != want


# -- K-step decode windows (decode_kstep) -------------------------------------------

#: one batch of (max_tokens, knobs): rows that outlive a window of 8, one
#: whose budget ends mid-window, one that emits its stop id 4242 as its
#: fifth token (min_tokens 4 bans it, then +100 makes it), one that emits
#: eos (0) as its seventh
KSTEP_ROWS = (
    (20, {}), (20, {}), (13, {}),
    (12, dict(logit_bias=((4242, 100.0),), min_tokens=4, stop_token_ids=(4242,),
              ignore_eos=False)),
    (9, dict(logit_bias=((0, 100.0),), min_tokens=6, ignore_eos=False)),
)
#: a second batch that outlives several windows (chained under overlap)
KSTEP_LONG = ((40, {}), (40, {}))


def _run_kstep(eng, rows=KSTEP_ROWS, tag="", seed=11):
    """The rows together (prompts of 20-140 random tokens from `seed`), to
    completion: request id -> (ids, finish reason)."""
    gen = torch.Generator().manual_seed(seed)
    for i, (max_tokens, knobs) in enumerate(rows):
        prompt = torch.randint(1, 128_000, (20 + 30 * i,), generator=gen).tolist()
        eng.add_request(f"{tag}{i}", prompt,
                        SamplingParams(max_tokens=max_tokens, **{"ignore_eos": True, **knobs}))
    out = {}
    while eng.has_work:
        for o in eng.step():
            ids, _ = out.get(o.request_id, ((), None))
            out[o.request_id] = (ids + o.new_token_ids, o.finish_reason)
    return out


@pytest.mark.parametrize("mode", [None, "int8", "fp8"])
def test_kstep_graphs_give_the_eager_streams(llama_params, mode):
    """K-step windows replayed as graphs give the eager loop's streams bit
    for bit, without and with overlapped decode in both engines (chained
    windows consumed): a stop id and eos emitted mid-window end their rows
    there, a budget ends another mid-window; each window key is captured
    once and replayed, the window graphs launch the pool's write and paged
    decode, and nothing runs a plain version."""
    for overlap in (False, True):
        eager, graphs = _engines(llama_params, mode, overlap=(overlap, overlap),
                                 decode_kstep=8)
        ops.reset_counts()
        want = [_run_kstep(eager), _run_kstep(eager, KSTEP_LONG, "l")]
        got = [_run_kstep(graphs), _run_kstep(graphs, KSTEP_LONG, "l")]
        assert got == want
        assert all(c.plain_calls == 0 for c in ops.COUNTS.values())
        rows = got[0]
        assert rows["3"] == (rows["3"][0][:4] + (4242,), FinishReason.STOP)
        assert len(rows["4"][0]) == 7 and rows["4"][0][-1] == 0
        assert len(rows["2"][0]) == 13 and len(rows["0"][0]) == 20
        m = graphs.metrics
        windows = [k for k in graphs.step_keys if k[0] == "decode_kstep"]
        assert windows and all(graphs._step_fns[k].replays for k in windows)
        assert m.compiles == len(graphs.step_keys)
        assert m.kstep_windows == eager.metrics.kstep_windows > 0
        assert m.prefill_replays + m.decode_replays + m.mixed_replays == graphs.dispatches
        assert m.decode_replays == m.decode_dispatches + m.overlap_rollbacks
        launched = {name for k in windows for name, (n, _) in graphs._step_fns[k].launches.items()
                    if n}
        assert launched == {kv_quant.variant(n, mode)
                            for n in ("paged_write", "paged_decode_attention")}
        if overlap:
            assert m.overlap_hits > 0 and m.kstep_windows > m.decode_dispatches - m.overlap_hits


def test_a_window_graph_replays_on_new_inputs(llama_params):
    """Window keys captured over one batch replay a second batch of other
    prompts (same lengths, budgets and stops) without a capture, to the
    eager loop's streams."""
    eager, graphs = _engines(llama_params, None, decode_kstep=8)
    for eng in (eager, graphs):
        _run_kstep(eng, tag="a")
    compiles = graphs.metrics.compiles
    want = _run_kstep(eager, tag="b", seed=12)
    assert _run_kstep(graphs, tag="b", seed=12) == want
    assert graphs.metrics.compiles == compiles
    assert any(k[0] == "decode_kstep" for k in graphs.step_keys)


@pytest.mark.parametrize("mode", [None, "int8", "fp8"])
def test_a_frozen_row_writes_no_kv_past_its_stop(llama_params, mode):
    """A row that emits its stop id at the window's fourth step is frozen
    for the other four: every slot of its page from its position after the
    stop on keeps the bytes poisoned into it before the window (K, V and
    scale planes), while the slots the live steps wrote changed; the
    window's emitted counts equal the tokens the host accepted."""
    eng = _engines(llama_params, mode, decode_kstep=8)[1]
    _run_kstep(eng, ((20, {}), KSTEP_ROWS[3]), tag="warm")  # captures
    _run_kstep(eng, ((20, {}), KSTEP_ROWS[3]), tag="w")
    seen = []
    post = eng._decode_postprocess

    def spy(reqs, k_steps, ids, kstep=False):
        outs = post(reqs, k_steps, ids, kstep)
        if kstep:
            seen.append((ids.extras()[0][: len(reqs)].tolist(),
                         [len(o.new_token_ids) for o in outs]))
        return outs

    eng._decode_postprocess = spy
    gen = torch.Generator().manual_seed(13)
    for i, (max_tokens, knobs) in enumerate(((20, {}), KSTEP_ROWS[3])):
        prompt = torch.randint(1, 128_000, (20 + 30 * i,), generator=gen).tolist()
        eng.add_request(f"p{i}", prompt,
                        SamplingParams(max_tokens=max_tokens, **{"ignore_eos": True, **knobs}))
    eng.step()  # the prefill: both rows decode from here
    req = next(r for r in eng.scheduler.running if r.request_id == "p1")
    n, page = req.num_tokens, req.pages[0]  # 51 tokens: the window stays in page 0
    planes = [x for x in (eng.kv.k, eng.kv.v, eng.kv.k_scale, eng.kv.v_scale) if x is not None]
    for x in planes:
        x[:, page, n - 1:].view(torch.uint8).fill_(0x5A)
    poisoned = [x[:, page].clone() for x in planes]
    outs = {o.request_id: o for o in eng.step()}
    torch.cuda.synchronize()
    assert outs["p1"].new_token_ids[-1] == 4242 and len(outs["p1"].new_token_ids) == 4
    assert outs["p1"].finish_reason == FinishReason.STOP
    # the live steps wrote positions n-1 .. n+2; the frozen ones nothing
    for x, before in zip(planes, poisoned):
        assert torch.equal(x[:, page, n + 3:], before[:, n + 3:])
        for slot in range(n - 1, n + 3):
            assert not torch.equal(x[:, page, slot], before[:, slot])
    assert seen and seen[0][0] == seen[0][1] == [8, 4]
    eng.run_to_completion()
    del eng._decode_postprocess  # no reference cycle keeps the engine's graphs


# -- int8 weights (--quantize int8) ---------------------------------------------------


def _int8_inputs(dev, m, k, n, seed):
    """bf16 x [M, K], an int8 weight [K, N] quantized from N(0, 1/K) draws
    with its [1, N] scale, on the card."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    w = torch.randn((k, n), generator=gen, device=dev) / k**0.5
    q, scale = llama.quantize_channelwise_int8(w)
    return x, q, scale


def _assert_int8_rows_close(got, want):
    """Each row within 2^-6 of the row's largest |plain value|: the plain
    version rounds the product and the scaled product to bf16 apart, the
    kernel once."""
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert torch.isfinite(got).all()
    diff = (got.float() - want.float()).abs().amax(dim=-1)
    assert (diff <= 2.0**-6 * want.float().abs().amax(dim=-1)).all()


#: (M, K, N): a decode row, split over K; 17 rows (a ragged 16-row tile);
#: 64 rows over llama3-1b's widest K; a 300-token chunk (64-row tiles, one
#: ragged); llama3-8b's down projection
INT8_CASES = [(1, 2048, 2048), (17, 2048, 512), (64, 8192, 2048), (300, 2048, 8192),
              (8, 14336, 4096)]


@pytest.mark.parametrize("m,k,n", INT8_CASES)
def test_int8_matmul_matches_plain(m, k, n):
    dev = _card()
    x, w, scale = _int8_inputs(dev, m, k, n, seed=m + k + n)
    _assert_int8_rows_close(int8_matmul.int8_matmul(x, w, scale),
                            int8_matmul.int8_matmul_plain(x, w, scale))


def test_int8_matmul_launches_are_counted_and_bad_inputs_raise():
    dev = _card()
    ops.reset_counts()
    x, w, scale = _int8_inputs(dev, 4, 256, 256, seed=1)
    int8_matmul.int8_matmul(x, w, scale)
    c = ops.COUNTS["int8_matmul"]
    assert (c.launches, c.plain_calls) == (1, 0)
    with pytest.raises(ValueError, match="bfloat16"):
        int8_matmul.int8_matmul(x.float(), w, scale)
    with pytest.raises(ValueError, match="multiple of 128"):  # N = 200
        int8_matmul.int8_matmul(x, w[:, :200].contiguous(), scale[:, :200].contiguous())
    with pytest.raises(ValueError, match="multiple of 128"):  # K = 96
        int8_matmul.int8_matmul(x[:, :96].contiguous(), w[:96].contiguous(), scale)
    with pytest.raises(ValueError, match="span devices"):
        int8_matmul.int8_matmul(x, w.cpu(), scale)
    with pytest.raises(ValueError, match="contiguous"):
        int8_matmul.int8_matmul(x, w.t().contiguous().t(), scale)
    assert (c.launches, c.plain_calls) == (1, 0)


@pytest.mark.parametrize("m", [2, 256])
def test_int8_matmul_replays_in_a_cuda_graph(m):
    """A call (split over K at M=2, one pass at M=256) captured, replayed
    after new x, weight and scale are copied into the captured buffers:
    bit-equal to an eager call on them, twice, and within the gate of the
    plain version."""
    dev = _card()
    args = _int8_inputs(dev, m, 2048, 2048, seed=50 + m)
    new = _int8_inputs(dev, m, 2048, 2048, seed=60 + m)
    graph, out = _capture(dev, lambda: int8_matmul.int8_matmul(*args))
    for dst, src in zip(args, new):
        dst.copy_(src)
    graph.replay()
    first = out.clone()
    graph.replay()
    torch.cuda.synchronize(dev)
    eager = int8_matmul.int8_matmul(*new)
    assert torch.equal(first, eager) and torch.equal(out, eager)
    _assert_int8_rows_close(out, int8_matmul.int8_matmul_plain(*new))


def test_int8_weight_graphs_give_the_eager_streams(llama_params):
    """Engines with quantize="int8" (llama3-1b; each quantizes the shared
    bf16 weights): decode, chunk and mixed graphs with overlap on give the
    eager loop's streams bit for bit, the graphs launch int8_matmul, and
    nothing runs a plain version."""
    eager, graphs = _engines(llama_params, None, overlap=(True, True), mixed_steps=True,
                             prefill_chunk=128, quantize="int8")
    assert graphs.params["layers"]["wq"].dtype == torch.int8
    ops.reset_counts()
    want = _run_late(eager) | _run_waves(eager, GRAPH_WAVES[:3], tag="w")
    got = _run_late(graphs) | _run_waves(graphs, GRAPH_WAVES[:3], tag="w")
    assert got == want
    assert all(c.plain_calls == 0 for c in ops.COUNTS.values())
    assert ops.COUNTS["int8_matmul"].launches > 0
    kinds = {k[0] for k in graphs.step_keys}
    assert {"mixed", "prefill"} <= kinds and kinds & set(DECODE_KINDS)
    m = graphs.metrics
    assert m.compiles == len(graphs.step_keys) and m.overlap_hits > 0
    assert m.prefill_replays + m.decode_replays + m.mixed_replays == graphs.dispatches
    assert all("int8_matmul" in g.launches for g in graphs._step_fns.values())


# -- logprob alternatives at a tie ----------------------------------------------------


def _top_ids_rule(logits, k):
    """XLA's top_k rule in numpy: ids by (value descending, id ascending),
    the first k."""
    return np.stack([np.lexsort((np.arange(row.size), -row))[:k] for row in logits])


@pytest.mark.parametrize("k", [1, 5, 20])
def test_token_logprobs_ties_across_the_nth_place_follow_the_rule(k):
    """bf16-valued logits over llama3's vocabulary with ties planted across
    the k-th place, at the top, and a row of one value, on the card: the
    top ids equal (value descending, id ascending) in numpy, the values
    are the sorted logits, and the call captures and replays in a CUDA
    graph to the same ids."""
    dev = _card()
    rng = np.random.default_rng(70 + k)
    v = 128_256
    logits = rng.standard_normal((4, v)).astype(np.float32)
    for row, tie_at in ((0, k - 1), (1, 0), (2, max(k - 2, 0))):
        order = np.argsort(-logits[row], kind="stable")
        value = logits[row, order[tie_at]]
        logits[row, order[tie_at:tie_at + 3]] = value
        logits[row, rng.choice(v, 40, replace=False)] = value
    logits[3] = 0.5
    # bf16-representable values, as the model's logits are
    logits = torch.from_numpy(logits).to(torch.bfloat16).float().numpy()
    x = torch.from_numpy(logits).to(dev)
    ids = x.argmax(dim=-1)
    _, top_ids, top_lps = sampling.token_logprobs(x, ids, k)
    want = _top_ids_rule(logits, k)
    np.testing.assert_array_equal(top_ids.cpu().numpy(), want)
    lse = torch.logsumexp(x, dim=-1, keepdim=True)
    torch.testing.assert_close(top_lps, torch.gather(x, 1, top_ids) - lse)
    graph, out = _capture(dev, lambda: sampling.token_logprobs(x, ids, k))
    graph.replay()
    torch.cuda.synchronize(dev)
    np.testing.assert_array_equal(out[1].cpu().numpy(), want)


# -- prompt-lookup verify windows (spec_ngram) ------------------------------------------


@pytest.mark.parametrize("mode", [None, "int8", "fp8"])
@pytest.mark.parametrize("b", [1, 8, 64])
def test_paged_write_at_run_1_lands_verify_windows(b, mode):
    """Verify windows of 5 tokens from unaligned positions (63 to 2,031,
    across pages) landed in runs of one slot: bit-equal to the plain
    version off the null page, and every slot outside the windows, its
    bytes and scales poisoned first, keeps them."""
    dev = _card()
    starts = chip_smoke.verify_hist(60 + b, b)
    gen = torch.Generator(device=dev).manual_seed(b)
    pools, k_stage, v_stage, args, planes = chip_smoke.paged_write_inputs(
        dev, gen, b, 5, mode, starts=starts)
    for x in pools:
        chip_smoke.as_bytes(x).view(torch.uint8).fill_(0x7F)
    got = [x.clone() for x in pools]
    want = [x.clone() for x in pools]
    kv_update.paged_write(got[0], got[1], k_stage, v_stage, *args, run=1,
                          **dict(zip(planes, got[2:])))
    kv_update.paged_write_plain(want[0], want[1], k_stage, v_stage, *args, run=1,
                                **dict(zip(planes, want[2:])))
    torch.cuda.synchronize()
    pt, pos = args[0].long(), args[1].long()
    window = torch.zeros(pools[0].shape[1:3], dtype=torch.bool, device=dev)
    window[torch.gather(pt, 1, pos // 64), pos % 64] = True
    assert int(window.sum()) == 5 * b
    for g, w, x in zip(got, want, pools):
        g, w, x = (chip_smoke.as_bytes(y) for y in (g, w, x))
        assert torch.equal(g[:, 1:], w[:, 1:])
        assert torch.equal(g[:, ~window], x[:, ~window])
        assert not torch.equal(g[:, window], x[:, window])


@pytest.mark.parametrize("mode", [None, "int8", "fp8"])
@pytest.mark.parametrize("b", [1, 8, 64])
def test_paged_prefill_at_verify_windows_eager_and_in_a_graph(b, mode):
    """A verify window's chunk, T = 5 (20 of a CTA's 128 query rows at g=4),
    over histories of 1,087, 2,031 and 63 tokens (ends inside a page):
    within 2^-6 of each row's largest value against the plain version; one
    call captured in a CUDA graph and replayed on new inputs (the
    histories in another order, other values and page tables) gives the
    eager call's output bit for bit."""
    dev = _card()
    hist = ([1087, 2031, 63] * 22)[:b]
    shape = (32, 8, 64, 5)
    args, planes = _prefill_inputs(dev, *shape, hist, [5] * b, 64, mode, seed=70 + b, mp=33)
    new_hist = hist[1:] + hist[:1]
    new_args, new_planes = _prefill_inputs(dev, *shape, new_hist, [5] * b, 64, mode,
                                           seed=71 + b, mp=33)
    got = flash_prefill.paged_prefill_attention(*args, **planes)
    _assert_rows_close(got, flash_prefill.paged_prefill_attention_plain(*args, **planes),
                       [5] * b)
    graph, out = _capture(dev, lambda: flash_prefill.paged_prefill_attention(*args, **planes))
    buffers = [x for x in args if torch.is_tensor(x)] + list(planes.values())
    news = [x for x in new_args if torch.is_tensor(x)] + list(new_planes.values())
    for dst, src in zip(buffers, news):
        dst.copy_(src)
    graph.replay()
    torch.cuda.synchronize(dev)
    eager = flash_prefill.paged_prefill_attention(*new_args, **new_planes)
    assert torch.equal(out, eager)
    _assert_rows_close(out, flash_prefill.paged_prefill_attention_plain(*new_args, **new_planes),
                       [5] * b)


@pytest.mark.parametrize("mode", [None, "int8", "fp8"])
def test_verify_graphs_give_the_eager_streams(llama_params, mode):
    """--spec-ngram 4 with the cooldown off (spec_min_accept_rate 0), so
    every decode dispatch of the greedy waves verifies: the verify graphs
    give the eager loop's streams and drafts bit for bit, each verify key
    (one a decode bucket) is captured once and replayed, its graph
    launches the pool's write and paged prefill only, and nothing runs a
    plain version."""
    eager, graphs = _engines(llama_params, mode, spec_ngram=4, spec_min_accept_rate=0.0)
    assert not graphs._overlap_enabled and not graphs.scheduler.mixed_enabled
    ops.reset_counts()
    waves = [(5, 24), (3, 17), (1, 9)]
    want = _run_waves(eager, waves)
    assert _run_waves(graphs, waves) == want
    assert all(c.plain_calls == 0 for c in ops.COUNTS.values())
    m = graphs.metrics
    assert (m.spec_drafted, m.spec_accepted) == (eager.metrics.spec_drafted,
                                                 eager.metrics.spec_accepted)
    verifies = [k for k in graphs.step_keys if k[0] == "spec_verify"]
    assert {key_field(k, "bucket") for k in verifies} >= {8, 4, 1}
    assert all(graphs._step_fns[k].replays for k in verifies)
    assert m.compiles == len(graphs.step_keys)
    assert m.prefill_replays + m.decode_replays + m.mixed_replays == graphs.dispatches
    assert m.decode_replays == m.decode_dispatches
    launched = {name for k in verifies for name, (n, _) in graphs._step_fns[k].launches.items()
                if n}
    assert launched == {kv_quant.variant(n, mode)
                        for n in ("paged_write", "paged_prefill_attention")}


#: the draft-model tests' greedy waves (buckets 8, 4 and 1)
DRAFT_WAVES = [(5, 24), (3, 17), (1, 9)]
#: their engines' knobs beside _engines' own: a self-draft with no
#: cooldown, chunks of 128 (the late prompts prefill in chunks with
#: history, which the draft's chunk steps follow) and mixed steps
DRAFT_KNOBS = dict(spec_draft_model="llama3-1b", spec_min_accept_rate=0.0, prefill_chunk=128,
                   mixed_steps=True)


def _run_draft(eng, tag="", late=(300, 200)):
    """DRAFT_WAVES, a seeded sampled wave of two rows (temperature 0.7,
    top-p 0.9) and _run_late (prompts of `late` tokens join a decoding
    row; split mixed steps): request id -> generated ids."""
    out = _run_waves(eng, DRAFT_WAVES, tag=tag)
    out.update(_run_waves(eng, [(2, 17)], tag=f"{tag}s",
                          sampling=dict(temperature=0.7, top_p=0.9, seed=3)))
    out.update(_run_late(eng, tag=f"{tag}late", arrivals=((3, late),)))
    return out


def _draft_launches(graphs, kind) -> set:
    return {name for k in graphs.step_keys if k[0] == kind
            for name, (n, _) in graphs._step_fns[k].launches.items() if n}


@pytest.mark.parametrize("mode", [None, "int8", "fp8"])
def test_draft_graphs_give_the_eager_streams(llama_params, mode):
    """--spec-draft with a self-draft of llama3-1b (its own weights), the
    cooldown off (spec_min_accept_rate 0), mixed steps on: the spec_fused
    and spec_draft_prefill graphs give the eager loop's streams, drafts
    and acceptance bit for bit, without and with overlapped decode in both
    engines (chained dispatches consumed); two graph engines with overlap
    on and one decode bucket, mixed steps on and off, give each other's
    streams (each prefill step runs apart from the draft-model dispatches
    in the second); each key is captured once and replayed; a spec_fused
    graph launches the pool's write and paged
    prefill (the verify) and the draft pool's (bf16) write, paged prefill
    and paged decode (catch-up and proposals); the draft's chunk graphs
    launch the bf16 write with flash prefill or paged prefill; nothing
    runs a plain version."""
    for overlap in (False, True):
        eager, graphs = _engines(llama_params, mode, overlap=(overlap, overlap), **DRAFT_KNOBS)
        assert graphs.draft_params is graphs.params and graphs.draft_kv.k.dtype == torch.bfloat16
        ops.reset_counts()
        want = _run_draft(eager)
        assert _run_draft(graphs) == want
        assert all(c.plain_calls == 0 for c in ops.COUNTS.values())
        m, e = graphs.metrics, eager.metrics
        for c in ("spec_drafted", "spec_accepted", "overlap_hits", "overlap_rollbacks",
                  "mixed_dispatches"):
            assert getattr(m, c) == getattr(e, c), c
        assert m.spec_drafted > 0 and m.spec_accepted > 0 and m.mixed_dispatches > 0
        assert (m.overlap_hits > 0) == overlap
        fused = [k for k in graphs.step_keys if k[0] == "spec_fused"]
        drafts = [k for k in graphs.step_keys if k[0] == "spec_draft_prefill"]
        assert fused and drafts and all(graphs._step_fns[k].replays for k in fused + drafts)
        assert all(graphs._step_fns[k].keep for k in fused)
        assert m.compiles == len(graphs.step_keys)
        assert m.prefill_replays + m.decode_replays + m.mixed_replays == graphs.dispatches
        assert m.decode_replays + m.mixed_replays == (m.decode_dispatches + m.mixed_dispatches
                                                      + m.overlap_rollbacks)
        assert _draft_launches(graphs, "spec_fused") == (
            {kv_quant.variant(n, mode) for n in ("paged_write", "paged_prefill_attention")}
            | {"paged_write", "paged_prefill_attention", "paged_decode_attention"})
        assert _draft_launches(graphs, "spec_draft_prefill") == {
            "paged_write", "flash_prefill_attention", "paged_prefill_attention"}
        del eager, graphs
        torch.cuda.empty_cache()
    # the toggle changes which rows share a dispatch, and a row's logits
    # depend in their last bits on its dispatch's bucket (up to 0.0625
    # between buckets 1 and 4, where random weights tie), so the pair
    # decodes in one bucket and one late prompt arrives (the two would
    # prefill apart beside the decode bucket and together without it):
    # every row then runs the same shapes either way
    runs = []
    for mixed in (True, False):
        eng = _engines(llama_params, mode, overlap=(True, True),
                       **{**DRAFT_KNOBS, "mixed_steps": mixed, "decode_buckets": (8,)})[1]
        runs.append(_run_draft(eng, late=(300,)))
        m = eng.metrics
        assert (m.mixed_dispatches > 0) == mixed and m.overlap_hits > 0 and m.spec_accepted > 0
        del eng
        torch.cuda.empty_cache()
    assert runs[0] == runs[1]


def test_a_spec_fused_graph_replays_on_new_inputs(llama_params):
    """spec_fused and spec_draft_prefill keys captured over one run replay
    a second run of other prompts (the same lengths) to the eager loop's
    streams: every key of the first run's first dispatches (bucket 8) and
    chunk steps replays again, none is captured twice (rows finish at
    other steps, so the second run may reach a bucket the first did not);
    and a llama3-draft draft (Hq 8, Hkv 4, random weights: its acceptance
    sits at chance, so the cooldown engages) gives the eager loop's
    streams with graphs and overlap."""
    eager, graphs = _engines(llama_params, None, **DRAFT_KNOBS)
    for eng in (eager, graphs):
        _run_waves(eng, DRAFT_WAVES, tag="a")
    first = {k: g.replays for k, g in graphs._step_fns.items()
             if k[0] == "spec_draft_prefill"
             or (k[0] == "spec_fused" and key_field(k, "bucket") == 8)}
    assert any(k[0] == "spec_fused" for k in first)
    other = dict(tag="b", length=lambda i: 21 + 30 * i)  # other tokens, the same buckets
    want = _run_waves(eager, DRAFT_WAVES, **other)
    assert _run_waves(graphs, DRAFT_WAVES, **other) == want
    assert all(graphs._step_fns[k].replays > n for k, n in first.items())
    assert graphs.metrics.compiles == len(graphs.step_keys)
    del eager, graphs
    eager, graphs = _engines(llama_params, None, overlap=(True, True),
                             **{**DRAFT_KNOBS, "spec_draft_model": "llama3-draft",
                                "spec_min_accept_rate": 0.2})
    assert graphs.draft_adapter.config.num_kv_heads == 4
    want = _run_draft(eager)
    assert _run_draft(graphs) == want
    m = graphs.metrics
    assert m.spec_drafted == eager.metrics.spec_drafted > 0
    assert m.spec_skipped_cooldown > 0 and m.spec_accepted < m.spec_drafted * 0.2
