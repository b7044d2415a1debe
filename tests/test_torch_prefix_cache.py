"""Prefix caching in the port: the allocator, and TorchEngine against JaxEngine.

The allocator (engine/page_table.py) runs the JAX package's allocator
cases and a seeded random workload beside the JAX allocator (its native
pool where built; the JAX package holds that pool to its Python path):
the same page ids, free counts, KV events and stats. The engines run the
tiny config in float32 on the JAX engine's weights, caching on in both
(page size 4, chunk 16), JaxEngine with attention_impl="pallas" (its
kernels in interpret mode) and mixed steps off, at 1 and 4 fused decode
steps, overlap on and off: partial hits, a prompt cached whole (its last
page recomputed), a hit whose rest spans two chunks, a pool small enough
to evict, and a preemption whose recompute hits its own pages. Greedy
streams, KV events, cached_tokens on first outputs, step keys and
prefix_hit_rate must be identical. The bytes of every registered page,
K, V and the scale planes of int8 and fp8 pools, must not change over a
wave that hits them, with overlap on and 8 fused steps.
"""

import random

import jax
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.engine import JaxEngine
from dynamo_tpu.engine.page_table import PageAllocator as JaxAllocator
from dynamo_tpu.engine.request import SamplingParams as JaxSampling
from dynamo_tpu_torch.cli import run as cli_run
from dynamo_tpu_torch.engine.config import UNPORTED, EngineConfig
from dynamo_tpu_torch.engine.engine import DECODE_KINDS, TorchEngine
from dynamo_tpu_torch.engine.page_table import KvEvent, PageAllocator
from dynamo_tpu_torch.engine.request import SamplingParams
from dynamo_tpu_torch.models.llama import LlamaConfig, params_from_jax

# -- the allocator: the JAX package's cases (tests/test_page_allocator.py) -----


def test_basic_allocate_free():
    a = PageAllocator(num_pages=8, page_size=4)
    assert a.num_free == 7  # page 0 reserved
    pages = a.allocate(3)
    assert pages is not None and 0 not in pages
    assert a.num_free == 4
    a.free(pages)
    assert a.num_free == 7


def test_allocate_exhaustion_returns_none_and_double_free_raises():
    a = PageAllocator(num_pages=4, page_size=4)
    pages = a.allocate(3)
    assert pages is not None and a.allocate(1) is None
    a.free(pages[:1])
    with pytest.raises(ValueError, match="double free"):
        a.free(pages[:1])


def test_prefix_cache_share_and_refcount():
    a = PageAllocator(num_pages=8, page_size=4)
    (p,) = a.allocate(1)
    a.register(p, seq_hash=111, parent_hash=None, tokens=(1, 2, 3, 4))
    assert a.lookup([111, 222]) == [p]  # the second holder: two references
    a.free([p])  # the first owner leaves; still referenced
    assert a.lookup([111]) == [p]
    a.free([p])
    a.free([p])
    # no reference left: reclaimable, still matchable, counted free
    assert a.match_length([111]) == 1
    assert a.num_free == 7


def test_lru_eviction_emits_removed_event():
    events: list[KvEvent] = []
    a = PageAllocator(num_pages=4, page_size=4, on_event=events.append)
    pages = a.allocate(3)
    for i, p in enumerate(pages):
        a.register(p, seq_hash=100 + i, parent_hash=None, tokens=(i,) * 4)
    a.free(pages)  # all reclaimable, LRU order 100, 101, 102
    assert a.allocate(2) is not None  # evicts 100, then 101
    assert [e.block_hashes[0] for e in events if e.kind == "removed"] == [100, 101]
    assert a.match_length([102]) == 1 and a.match_length([100]) == 0


def test_stored_events_carry_chain_info():
    events: list[KvEvent] = []
    a = PageAllocator(num_pages=4, page_size=2, on_event=events.append)
    (p1,) = a.allocate(1)
    a.register(p1, seq_hash=7, parent_hash=None, tokens=(1, 2))
    (p2,) = a.allocate(1)
    a.register(p2, seq_hash=8, parent_hash=7, tokens=(3, 4))
    assert events[0].kind == "stored" and events[0].parent_hash is None
    assert events[1].parent_hash == 7
    assert events[1].token_blocks == ((3, 4),)


def test_clear_cache():
    a = PageAllocator(num_pages=6, page_size=4)
    pages = a.allocate(2)
    for i, p in enumerate(pages):
        a.register(p, seq_hash=50 + i, parent_hash=None, tokens=(i,) * 4)
    a.free(pages)
    assert a.clear_cache() == 2
    assert a.match_length([50]) == 0
    assert a.num_free == 5


def _event(e):
    return (e.kind, e.block_hashes, e.parent_hash, e.token_blocks)


STAT_FIELDS = ("queries", "hit_tokens", "query_tokens", "stored_blocks", "evicted_blocks",
               "hit_rate")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_workload_equals_the_jax_allocator(seed):
    """Allocate, free, register (a small universe of hashes, so lookups hit,
    content lands twice and chains break), lookup, match_length and
    clear_cache over a pool small enough to evict: every result, free
    count, event and stat equal the JAX allocator's."""
    ev_got, ev_want = [], []
    got = PageAllocator(num_pages=17, page_size=4, on_event=ev_got.append)
    want = JaxAllocator(num_pages=17, page_size=4, on_event=ev_want.append)
    rng = random.Random(seed)
    universe = [rng.getrandbits(64) for _ in range(12)]
    held: list[list[int]] = []
    for step in range(1500):
        op = rng.random()
        if op < 0.3:
            n = rng.randrange(1, 5)
            pages = got.allocate(n)
            assert pages == want.allocate(n), step
            if pages is not None:
                held.append(pages)
        elif op < 0.5 and held:
            pages = held.pop(rng.randrange(len(held)))
            got.free(pages)
            want.free(pages)
        elif op < 0.75 and held:
            pages = held[rng.randrange(len(held))]
            page = pages[rng.randrange(len(pages))]
            h = rng.choice(universe)
            parent = rng.choice([None] + universe)
            toks = tuple(rng.randrange(100) for _ in range(4))
            got.register(page, h, parent, toks)
            want.register(page, h, parent, toks)
        elif op < 0.95:
            chain = [rng.choice(universe) for _ in range(rng.randrange(1, 6))]
            assert got.match_length(chain) == want.match_length(chain), step
            pages = got.lookup(chain)
            assert pages == want.lookup(chain), step
            if pages:
                held.append(pages)
        else:
            assert got.clear_cache() == want.clear_cache(), step
        assert (got.num_free, got.num_active) == (want.num_free, want.num_active), step
    assert [_event(e) for e in ev_got] == [_event(e) for e in ev_want]
    assert {"stored", "removed"} <= {e.kind for e in ev_got}
    assert got.stats.hit_tokens > 0 and got.stats.evicted_blocks > 0
    assert {f: getattr(got.stats, f) for f in STAT_FIELDS} == {
        f: getattr(want.stats, f) for f in STAT_FIELDS}
    assert got.watermark == want.watermark and got.usage() == want.usage()
    for pages in held:
        got.free(pages)
        want.free(pages)
    assert got.clear_cache() == want.clear_cache()
    assert got.num_free == 16


# -- the engines ---------------------------------------------------------------

_rng = np.random.default_rng(11)
BASE = _rng.integers(1, 256, 40).tolist()
#: waves of (request id, prompt, max_tokens), each served to completion
#: before the next: a warm request of 7 full pages; then a partial hit, a
#: prompt cached whole (4 pages, its last page recomputed), a hit of 7
#: pages whose 20 uncached tokens span two chunks of 16, and a cold
#: prompt; then a hit on the warm request's chain and a cold prompt. At 18
#: pages the pool evicts (a chain partly evicted hits less).
HIT_WAVES = [
    [("w", BASE[:30], 5)],
    [("partial", BASE[:13] + [3, 1, 4], 6), ("full", BASE[:16], 5),
     ("long", BASE[:28] + _rng.integers(1, 256, 20).tolist(), 4),
     ("cold", _rng.integers(1, 256, 9).tolist(), 7)],
    [("again", BASE[:30] + [9, 9], 4), ("other", _rng.integers(1, 256, 26).tolist(), 6)],
]
#: 7 usable pages (tests/test_torch_engine.py SMALL_POOL_WORK): the
#: younger request's growth preempts the older, whose recompute of 17
#: tokens hits the one page of its own that stayed cached
PREEMPT_WAVES = [[("long", list(range(1, 15)), 12), ("short", list(range(1, 7)), 16)]]


def _engines(**knobs):
    """(JaxEngine, TorchEngine, their KV events): caching on in both, one
    set of weights, mixed steps off in both unless `knobs` turn them on."""
    kw = dict(dict(enable_prefix_caching=True, max_pages_per_seq=16, admission_watermark=0.0,
                   mixed_steps=False), **knobs)
    jax_ev, torch_ev = [], []
    jax_eng = JaxEngine(JaxEngineConfig.for_tests(attention_impl="pallas", **kw),
                        on_kv_event=jax_ev.append)
    params = params_from_jax(jax.tree.map(np.asarray, jax_eng.params), LlamaConfig.tiny(),
                             device="cpu")
    torch_eng = TorchEngine(EngineConfig.for_tests(**kw), params=params, device="cpu",
                            on_kv_event=torch_ev.append)
    return jax_eng, torch_eng, jax_ev, torch_ev


def _serve(eng, waves, sampling_cls):
    """Each wave to completion: (request id -> generated ids, request id ->
    cached_tokens of each first output, in order)."""
    streams: dict[str, list[int]] = {}
    firsts: dict[str, list] = {}
    for wave in waves:
        for rid, prompt, n in wave:
            eng.add_request(rid, prompt, sampling_cls(max_tokens=n, ignore_eos=True))
        while eng.has_work:
            for o in eng.step():
                streams.setdefault(o.request_id, []).extend(o.new_token_ids)
                if o.cached_tokens is not None:
                    firsts.setdefault(o.request_id, []).append(o.cached_tokens)
    return streams, firsts


def _jax_keys(eng) -> set:
    """JaxEngine's step keys projected onto the port's key fields."""
    out = set()
    for k in eng._jit_cache:
        if k[0] == "mixed":
            out.add((k[0], k[1], k[2], k[9], k[3], k[5], k[10], k[6], k[7], k[8]))
        elif k[0] == "prefill":
            out.add((k[0], k[1], k[2], k[3], k[5], k[6], k[7], k[8]))
        elif k[0] == "prefill_nosample":
            out.add((k[0], k[1], k[2], k[5]))
        elif k[0] in DECODE_KINDS:
            out.add((*k[:4], k[6], k[7], k[8]))
    return out


def _assert_engines_agree(waves, **knobs):
    jax_eng, torch_eng, jax_ev, torch_ev = _engines(**knobs)
    want = _serve(jax_eng, waves, JaxSampling)
    got = _serve(torch_eng, waves, SamplingParams)
    assert got == want
    assert [_event(e) for e in torch_ev] == [_event(e) for e in jax_ev]
    assert set(torch_eng.step_keys) == _jax_keys(jax_eng)
    assert torch_eng.metrics.prefix_hit_rate == jax_eng.metrics.prefix_hit_rate > 0
    assert torch_eng.scheduler.preemptions == jax_eng.scheduler.preemptions
    assert torch_eng.allocator.num_active == 0 and not torch_eng.scheduler.chains
    return got, torch_eng, torch_ev


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("decode_steps", [1, 4])
def test_prefix_hits_equal_the_jax_engines(decode_steps, overlap):
    (streams, firsts), eng, events = _assert_engines_agree(
        HIT_WAVES, num_pages=18, decode_steps=decode_steps, overlap_decode=overlap)
    assert firsts == {"w": [0], "partial": [12], "full": [12], "long": [28], "cold": [0],
                      "again": [12], "other": [0]}
    assert any(e.kind == "removed" for e in events)  # the pool evicted
    # the long hit's 20 uncached tokens ran as two pieces with history, the
    # first of which samples nothing
    assert any(k[0] == "prefill_nosample" and not k[-1] for k in eng.step_keys)
    assert {rid: len(s) for rid, s in streams.items()} == {
        rid: n for wave in HIT_WAVES for rid, _, n in wave}


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("decode_steps", [1, 4])
def test_preempted_recompute_hits_its_own_pages(decode_steps, overlap):
    (streams, firsts), eng, events = _assert_engines_agree(
        PREEMPT_WAVES, num_pages=8, decode_steps=decode_steps, overlap_decode=overlap)
    assert eng.scheduler.preemptions >= 1
    # the victim's first output after its recompute: a hit on its own page
    assert firsts["long"][0] == 0 and firsts["long"][-1] > 0
    assert {rid: len(s) for rid, s in streams.items()} == {"long": 12, "short": 16}


def _snapshot(eng, pages) -> list[torch.Tensor]:
    idx = torch.tensor(sorted(pages))
    return [x[:, idx].clone() for x in eng.kv if x is not None]


@pytest.mark.parametrize("mode,mixed", [
    pytest.param(None, False, id="None"), pytest.param("int8", False, id="int8"),
    pytest.param("fp8", False, id="fp8"), pytest.param(None, True, id="None-mixed"),
    pytest.param("int8", True, id="int8-mixed"), pytest.param("fp8", True, id="fp8-mixed"),
])
def test_a_wave_that_hits_writes_no_registered_page(mode, mixed):
    """Every page registered by the warm request keeps its bytes (K, V and
    the scale planes) through a wave of hits at 8 fused steps with overlap
    on: every write lands at or past num_computed_tokens. With mixed steps
    on, the long hit's last piece runs in a mixed step beside the rows
    that finished their prefill, whose decode writes land there too."""
    events: list[KvEvent] = []
    eng = TorchEngine(EngineConfig.for_tests(max_pages_per_seq=32, decode_steps=8,
                                             kv_quantize=mode, mixed_steps=mixed),
                      device="cpu", on_kv_event=events.append)
    # 20 tokens a request: dispatches of 8 fused steps that speculate
    waves = [[(rid, prompt, 20) for rid, prompt, _ in wave] for wave in HIT_WAVES]
    _serve(eng, waves[:1], SamplingParams)
    pages = list(eng.allocator._page_meta)
    assert len(pages) == 11  # 30 + 20 tokens: 12 pages, the last not registered
    before = _snapshot(eng, pages)
    _, firsts = _serve(eng, waves[1:], SamplingParams)
    assert firsts["long"] == [28] and firsts["again"] == [28]
    assert eng.metrics.overlap_hits > 0
    assert (eng.metrics.mixed_dispatches > 0) == mixed
    assert not any(e.kind == "removed" for e in events)
    for a, b in zip(before, _snapshot(eng, pages)):
        assert torch.equal(a.view(torch.uint8) if a.dtype == torch.float8_e4m3fn else a,
                           b.view(torch.uint8) if b.dtype == torch.float8_e4m3fn else b)


def test_prefix_caching_is_on_by_default_and_the_cli_has_no_switch():
    assert EngineConfig().enable_prefix_caching is True
    assert "enable_prefix_caching" not in UNPORTED
    args = cli_run._parse(["run", "--device", "cpu"])
    assert cli_run.engine_config(args, ()).enable_prefix_caching is True
    flags = [a for act in cli_run.build_parser()._subparsers._group_actions
             for p in act.choices.values() for x in p._actions for a in x.option_strings]
    assert "--max-context" in flags and not any("prefix" in f or "cach" in f for f in flags)
    off = EngineConfig.for_tests(enable_prefix_caching=False)
    eng = TorchEngine(off, device="cpu")
    for rid in ("a", "b"):
        eng.add_request(rid, BASE[:30], SamplingParams(max_tokens=3, ignore_eos=True))
        eng.run_to_completion()
    assert eng.allocator.stats.queries == 0 and not eng.allocator._page_meta
