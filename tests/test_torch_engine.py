"""TorchEngine against JaxEngine, and the cases the port refuses.

Both engines run the tiny config in float32 with the same weights (the JAX
engine's, carried over with params_from_jax). The JAX engine runs
attention_impl="pallas" (its kernels in interpret mode on the CPU) with
prefix caching, overlap and mixed steps off; the port runs its kernels'
plain versions on CPU tensors, with prefix caching and mixed steps as the
JAX engine has them (off unless a test asks; tests/test_torch_prefix_cache.py
serves hits, tests/test_torch_mixed.py mixed steps). Prompts up to
prefill_chunk=16 tokens are one first chunk; longer ones, and recomputes after a preemption, prefill
in page-aligned chunks. Greedy token streams must be identical.
"""

import jax
import numpy as np
import pytest

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.engine import JaxEngine
from dynamo_tpu.engine.request import SamplingParams as JaxSampling
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import TorchEngine, key_field
from dynamo_tpu_torch.engine.request import SamplingParams
from dynamo_tpu_torch.models.llama import LlamaConfig, params_from_jax

PROMPTS = {
    "a": [5, 17, 42, 9, 3, 7, 11, 2],
    "b": list(range(1, 17)),  # exactly one chunk
    "c": [200],
    "d": [9, 8, 7, 6, 5, 4, 3],
    "e": [33, 44, 55, 66, 77, 88, 99, 111, 122, 133, 144, 155, 166],
}
MAX_TOKENS = {"a": 9, "b": 6, "c": 12, "d": 3, "e": 7}


def _jax_engine(**overrides):
    return JaxEngine(JaxEngineConfig.for_tests(**{
        "attention_impl": "pallas", "enable_prefix_caching": False, "overlap_decode": False,
        "mixed_steps": False, **overrides,
    }))


def _torch_engine(jax_engine=None, **overrides):
    """The port's engine on the JAX engine's weights and with its prefix
    caching and mixed steps knobs, or on random weights with both off (as
    _jax_engine has them) unless `overrides` say otherwise."""
    params = None
    caching = mixed = False
    if jax_engine is not None:
        np_params = jax.tree.map(np.asarray, jax_engine.params)
        params = params_from_jax(np_params, LlamaConfig.tiny(), device="cpu")
        caching = jax_engine.config.enable_prefix_caching
        mixed = jax_engine.config.mixed_steps
    overrides = {"enable_prefix_caching": caching, "mixed_steps": mixed, **overrides}
    return TorchEngine(EngineConfig.for_tests(**overrides), params=params, device="cpu")


@pytest.mark.parametrize("decode_steps", [1, 4])
def test_greedy_streams_identical_to_jax_engine(decode_steps):
    jax_eng = _jax_engine(decode_steps=decode_steps)
    torch_eng = _torch_engine(jax_eng, decode_steps=decode_steps)
    for rid, prompt in PROMPTS.items():
        jax_eng.add_request(rid, prompt, JaxSampling(max_tokens=MAX_TOKENS[rid], ignore_eos=True))
        torch_eng.add_request(rid, prompt, SamplingParams(max_tokens=MAX_TOKENS[rid], ignore_eos=True))
    want = jax_eng.run_to_completion()
    got = torch_eng.run_to_completion()
    assert got == want
    assert {rid: len(t) for rid, t in got.items()} == MAX_TOKENS
    assert torch_eng.allocator.num_active == 0  # every page came back


def test_stop_token_drops_fused_overshoot():
    """A stop token mid-window ends the stream there, as with one step per
    sync: the fused steps past it are computed and dropped."""
    ref = _torch_engine(decode_steps=1)
    ref.add_request("r", PROMPTS["a"], SamplingParams(max_tokens=12, ignore_eos=True))
    stream = ref.run_to_completion()["r"]
    stop = stream[5]
    cut = stream[: stream.index(stop) + 1]
    for k in (1, 8):
        eng = _torch_engine(decode_steps=k)
        eng.add_request("r", PROMPTS["a"], SamplingParams(max_tokens=12, stop_token_ids=(stop,)))
        assert eng.run_to_completion()["r"] == cut


def test_seeded_sampling_is_repeatable_whatever_the_batch():
    sp = SamplingParams(max_tokens=10, temperature=0.9, top_k=20, top_p=0.9, seed=1234,
                        ignore_eos=True)
    alone = _torch_engine(decode_steps=4)
    alone.add_request("s", PROMPTS["a"], sp)
    first = alone.run_to_completion()["s"]
    crowded = _torch_engine(decode_steps=1)
    crowded.add_request("x", PROMPTS["d"], SamplingParams(max_tokens=5, temperature=1.0))
    crowded.add_request("s", PROMPTS["a"], sp)
    assert crowded.run_to_completion()["s"] == first
    other = _torch_engine(decode_steps=4)
    other.add_request("s", PROMPTS["a"], SamplingParams(**{**vars(sp), "seed": 99}))
    assert other.run_to_completion()["s"] != first


@pytest.mark.parametrize("temperature,top_k,top_p", [(1.0, 0, 1.0), (0.7, 5, 0.9)])
def test_sampler_draws_from_the_jax_samplers_distribution(temperature, top_k, top_p):
    """The two PRNGs differ, so both samplers are held to the distribution
    they are meant to draw from: the temperature-scaled softmax over the
    top-64 candidates, cut by top-k and top-p and renormalized. 4000 draws
    each over one logit row; every token's count lies within 4.5 standard
    deviations (binomial) of its expected count."""
    import jax.numpy as jnp
    import torch

    from dynamo_tpu.engine.sampling import sample as jax_sample
    from dynamo_tpu_torch.engine.sampling import DEFAULT_K_CAP, gumbel_noise, sample

    n, v = 4000, 96
    logits = np.random.default_rng(0).standard_normal(v).astype(np.float32) * 2.0
    scaled = logits.astype(np.float64) / temperature
    order = np.argsort(-scaled)[:DEFAULT_K_CAP]
    full = np.exp(scaled - scaled.max())
    full /= full.sum()
    cand = full[order]
    keep = ((np.cumsum(cand) - cand) < top_p) & (np.arange(len(order)) < (top_k or DEFAULT_K_CAP))
    p = np.zeros(v)
    p[order[keep]] = cand[keep] / cand[keep].sum()
    rows = np.tile(logits, (n, 1))
    full = lambda x, dt: np.full(n, x, dt)  # noqa: E731
    want = np.asarray(jax_sample(
        jnp.asarray(rows), jnp.asarray(full(temperature, np.float32)),
        jnp.asarray(full(top_p, np.float32)), jnp.asarray(full(top_k, np.int32)),
        jnp.asarray(full(7, np.uint32)), jnp.arange(n, dtype=jnp.int32),
    ))
    got = sample(
        torch.from_numpy(rows), torch.full((n,), temperature), torch.full((n,), top_p),
        torch.full((n,), top_k), gumbel_noise([7] * n, range(n), DEFAULT_K_CAP)[0],
    ).numpy()
    bound = 4.5 * np.sqrt(n * p * (1 - p)) + 1
    for draws in (got, want):
        assert (np.abs(np.bincount(draws, minlength=v) - n * p) <= bound).all()
        assert p[draws].min() > 0  # nothing outside the kept candidates


#: prompts of 17 to 60 tokens: two to four chunks of at most 16
LONG_PROMPTS = {
    f"p{n}": np.random.default_rng(n).integers(1, 256, n).tolist() for n in (17, 24, 33, 47, 60)
}


def _serve_long_prompts(decode_steps, **overrides):
    """Greedy streams of LONG_PROMPTS from both engines (a context of 64)."""
    kw = dict(decode_steps=decode_steps, max_pages_per_seq=16, **overrides)
    jax_eng = _jax_engine(**kw)
    torch_eng = _torch_engine(jax_eng, **kw)
    for rid, prompt in LONG_PROMPTS.items():
        jax_eng.add_request(rid, prompt, JaxSampling(max_tokens=3, ignore_eos=True))
        torch_eng.add_request(rid, prompt, SamplingParams(max_tokens=3, ignore_eos=True))
    return jax_eng.run_to_completion(), torch_eng.run_to_completion(), torch_eng


def test_prompt_longer_than_one_chunk_is_refused():
    """(The name is kept from when the port refused such prompts.) Prompts
    longer than one chunk prefill in page-aligned chunks, some of them in
    batches beside other prompts' first chunks; the greedy streams equal
    JaxEngine's with one and with four fused decode steps."""
    for decode_steps in (1, 4):
        want, got, eng = _serve_long_prompts(decode_steps)
        assert got == want
        assert {rid: len(t) for rid, t in got.items()} == {rid: 3 for rid in LONG_PROMPTS}
        # 181 prompt tokens went through the prefill path, in more steps
        # than the one a single budget of 64 tokens would take
        assert eng.metrics.prefill_tokens == sum(map(len, LONG_PROMPTS.values()))
        assert eng.metrics.prefill_dispatches > 3
        assert eng.allocator.num_active == 0


@pytest.mark.parametrize(
    "knob", [
        {"enable_prefix_caching": True}, {"overlap_decode": True}, {"mixed_steps": True},
        {"decode_kstep": 4}, {"quantize": "int8"}, {"tp": 2}, {"fleet_telemetry": True},
        {"attention_impl": "xla"}, {"spec_draft_tokens": 8},
    ],
)
def test_unported_knob_is_refused_by_name(knob):
    """(overlap_decode=True, enable_prefix_caching=True, mixed_steps=True,
    decode_kstep=4, quantize="int8" and spec_draft_tokens=8 keep their
    cases from when the port refused them; each case now checks that the
    knob is served.)"""
    (name,) = knob
    if name in ("overlap_decode", "enable_prefix_caching", "mixed_steps"):
        assert getattr(EngineConfig.for_tests(**knob), name) is True
        assert getattr(EngineConfig.for_tests(**{name: False}), name) is False
        return
    if name == "decode_kstep":
        assert EngineConfig.for_tests(**knob).decode_kstep == 4
        assert EngineConfig.for_tests().decode_kstep == 1
        eng = _torch_engine(**knob)
        eng.add_request("k", [5, 17, 42], SamplingParams(max_tokens=9, ignore_eos=True))
        assert len(eng.run_to_completion()["k"]) == 9
        assert eng.metrics.kstep_windows > 0
        return
    if name == "spec_draft_tokens":
        assert EngineConfig.for_tests(**knob).spec_draft_tokens == 8
        assert EngineConfig.for_tests().spec_draft_tokens == 4
        eng = _torch_engine(spec_draft_model="tiny", **knob)
        eng.add_request("d", [5, 17, 42], SamplingParams(max_tokens=9, ignore_eos=True))
        assert len(eng.run_to_completion()["d"]) == 9
        assert eng.metrics.spec_drafted > 0
        assert any(k[0] == "spec_fused" and key_field(k, "t") == 9 for k in eng.step_keys)
        return
    if name == "quantize":
        assert EngineConfig.for_tests(**knob).quantize == "int8"
        assert EngineConfig.for_tests().quantize is None
        return
    with pytest.raises(NotImplementedError, match=name):
        EngineConfig.for_tests(**knob)


def test_every_knob_of_the_jax_config_is_ported_or_refused():
    """The port's config takes the JAX config's knob names: each is a
    field here or an UNPORTED knob, and the JAX test config with the
    unported features off goes through as it is."""
    import dataclasses

    from dynamo_tpu_torch.engine.config import UNPORTED

    jax_knobs = {f.name for f in dataclasses.fields(JaxEngineConfig)}
    ported = {f.name for f in dataclasses.fields(EngineConfig)}
    assert jax_knobs == ported | UNPORTED.keys()
    assert not ported & UNPORTED.keys()
    off = dict(fleet_telemetry=False, flight_recorder=False, stall_watchdog=False)
    cfg = EngineConfig(**dataclasses.asdict(JaxEngineConfig.for_tests(**off)))
    assert cfg == EngineConfig.for_tests()
    assert dataclasses.replace(cfg, decode_steps=2).decode_steps == 2


#: 7 usable pages of 4 slots: the 14-token prompt takes 4, the 6-token one
#: 2. Both outgrow their pages on the same step; the older takes the last
#: free page, so the younger's growth must evict the older, which then
#: holds 17 tokens and recomputes them as two chunks once the younger has
#: finished (its 26 tokens then fill all 7 pages)
SMALL_POOL = dict(num_pages=8, decode_steps=1, admission_watermark=0.0)
SMALL_POOL_WORK = {"long": (list(range(1, 15)), 12), "short": (list(range(1, 7)), 16)}


@pytest.mark.parametrize("knobs", [
    dict(prefill_token_budget=4), dict(prefill_token_budget=3),
    dict(prefill_token_budget=8, prefill_budget_policy="adaptive"),
    dict(prefill_budget_policy="greedy"), dict(prefill_budget_max=32),
    dict(prefill_budget_max=100, prefill_budget_policy="adaptive"),
])
def test_prefill_budget_knobs_follow_the_jax_config(knobs):
    """The step budget may be below the chunk (down to one page), as in the
    reference; the policy and its ceiling are validated the same way."""
    try:
        want = JaxEngineConfig.for_tests(**knobs)
    except ValueError:
        with pytest.raises(ValueError):
            EngineConfig.for_tests(**knobs)
        return
    got = EngineConfig.for_tests(**knobs)
    assert got.effective_prefill_budget == want.effective_prefill_budget
    assert got.effective_prefill_budget_max == want.effective_prefill_budget_max


def test_preemption_past_one_chunk_is_refused():
    """(The name is kept from when the port refused this preemption.) The
    victim of a preemption that holds more than one chunk of tokens
    recomputes through chunked prefill: both requests are served, with
    streams identical to JaxEngine's on the same pool."""
    jax_eng = _jax_engine(**SMALL_POOL)
    torch_eng = _torch_engine(jax_eng, **SMALL_POOL)
    for rid, (prompt, n) in SMALL_POOL_WORK.items():
        jax_eng.add_request(rid, prompt, JaxSampling(max_tokens=n, ignore_eos=True))
        torch_eng.add_request(rid, prompt, SamplingParams(max_tokens=n, ignore_eos=True))
    want = jax_eng.run_to_completion()
    got = torch_eng.run_to_completion()
    assert got == want
    assert {rid: len(t) for rid, t in got.items()} == {"long": 12, "short": 16}
    assert torch_eng.scheduler.preemptions >= 1
    assert torch_eng.scheduler.preemptions == jax_eng.scheduler.preemptions
    # the victim recomputed its 17 tokens: longer than one chunk of 16
    assert torch_eng.metrics.prefill_tokens == 14 + 6 + 17


def test_runner_serves_every_stream_through_a_long_preemption():
    """Two streams through AsyncEngineRunner on the small pool: the
    preemption of the longer one recomputes through chunked prefill, and
    both streams finish with every token (no stream fails)."""
    import threading
    import time

    from dynamo_tpu_torch.engine.async_engine import AsyncEngineRunner
    from dynamo_tpu_torch.preprocessor.preprocessor import PreprocessedRequest

    eng = _torch_engine(**SMALL_POOL)
    runner = AsyncEngineRunner(eng)
    got: dict[str, list] = {}

    def stream(rid, prompt, n):
        items = runner.generate(PreprocessedRequest(
            request_id=rid, token_ids=prompt, max_tokens=n, ignore_eos=True))
        got[rid] = list(items)

    def pending() -> int:
        with runner._lock:
            return len(runner._pending)

    # both requests wait in the runner's queue, "long" first, before its
    # loop starts, so the engine admits them in one step in that order
    threads = []
    for rid, work in SMALL_POOL_WORK.items():
        threads.append(threading.Thread(target=stream, args=(rid, *work), daemon=True))
        threads[-1].start()
        deadline = time.monotonic() + 30
        while pending() < len(threads) and time.monotonic() < deadline:
            time.sleep(0.01)
    assert pending() == 2
    runner.start()
    try:
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        runner.stop()
    for rid, (_, n) in SMALL_POOL_WORK.items():
        items = got[rid]
        assert sum(len(i["token_ids"]) for i in items) == n
        assert items[-1]["finish_reason"] == "length"
    assert eng.scheduler.preemptions >= 1
    assert eng.metrics.prefill_tokens == 14 + 6 + 17  # "long" recomputed 17 tokens


def test_runner_submit_runs_on_the_engine_thread_and_clears_as_the_jax_engine():
    """submit(fn) runs fn(engine) on the engine thread and returns its
    result or raises its error: a prefix-cache clear after a served prompt
    evicts as many pages as the JAX engine's clear after the same prompt,
    and the prompt served again has no cached tokens; after stop() a
    submit raises."""
    import threading

    from dynamo_tpu_torch.engine.async_engine import AsyncEngineRunner
    from dynamo_tpu_torch.preprocessor.preprocessor import PreprocessedRequest

    prompt = list(range(1, 15))
    jax_eng = _jax_engine(enable_prefix_caching=True)
    jax_eng.add_request("a", prompt, JaxSampling(max_tokens=4, ignore_eos=True))
    jax_eng.run_to_completion()
    want = jax_eng.allocator.clear_cache()
    assert want > 0
    runner = AsyncEngineRunner(_torch_engine(enable_prefix_caching=True))

    def serve(rid):
        return list(runner.generate(PreprocessedRequest(
            request_id=rid, token_ids=prompt, max_tokens=4, ignore_eos=True)))

    runner.start()
    try:
        assert runner.submit(lambda eng: threading.current_thread()) is runner._thread
        with pytest.raises(ZeroDivisionError):
            runner.submit(lambda eng: 1 // 0)
        serve("a")
        assert runner.submit(lambda eng: eng.allocator.clear_cache()) == want
        assert not serve("b")[0].get("cached_tokens")
    finally:
        runner.stop()
    with pytest.raises(RuntimeError, match="stopped"):
        runner.submit(lambda eng: None)


def test_no_card_without_asking_for_the_cpu_raises():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchEngine(EngineConfig.for_tests())


@pytest.mark.parametrize("num_pages,seed,caching,mixed", [
    pytest.param(40, 0, False, False, id="40-0"), pytest.param(9, 1, False, False, id="9-1"),
    pytest.param(9, 2, False, False, id="9-2"),
    pytest.param(40, 0, True, False, id="40-0-caching"),
    pytest.param(9, 1, True, False, id="9-1-caching"),
    pytest.param(40, 0, False, True, id="40-0-mixed"),
    pytest.param(9, 1, False, True, id="9-1-mixed"), pytest.param(9, 2, False, True, id="9-2-mixed"),
    pytest.param(9, 1, True, True, id="9-1-caching-mixed"),
])
def test_scheduler_matches_the_jax_scheduler_step_by_step(num_pages, seed, caching, mixed):
    """The same request stream through both schedulers (mixed steps and
    prefix caching as `mixed` and `caching` say), with a stand-in token
    per sampled row: the same batches, pieces, page counts, preemptions
    and finishes, step by step. Prompts run up to 24 tokens, so some
    prefill in chunks of at most 16; each stream runs under the default
    budget, and under a budget of 8 tokens with the fixed and with the
    adaptive policy; with mixed steps also under an adaptive budget of 4
    tokens growing to 96 beside decode buckets up to 4, where the mixed
    piece cap and its clamp of the grown budget bind. 9 pages force
    preemption, and recomputes past one chunk. With caching, odd requests
    share a prefix of 1 to 4 pages, one prompt is cached whole, full pages
    are registered as the engine registers them, and the KV events and
    cache stats must be equal too."""
    from dynamo_tpu.engine.page_table import PageAllocator as JaxAllocator
    from dynamo_tpu.engine.request import Request as JaxRequest
    from dynamo_tpu.engine.scheduler import Scheduler as JaxScheduler
    from dynamo_tpu_torch.engine.page_table import PageAllocator
    from dynamo_tpu_torch.engine.request import Request
    from dynamo_tpu_torch.engine.scheduler import Scheduler

    rng = np.random.default_rng(seed)
    work = [(f"r{i}", rng.integers(1, 200, rng.integers(1, 25)).tolist(), int(rng.integers(1, 9)))
            for i in range(10)]
    if caching:
        shared = rng.integers(1, 200, 16).tolist()
        work = [(rid, shared[: 4 + 3 * (i // 2)] + p[:6] if i % 2 else p, n)
                for i, (rid, p, n) in enumerate(work)]
        work[8] = ("r8", shared[:12], work[8][2])  # cached whole once r5 registered it

    def register(sched, r):
        """The engine's _register_pages: full pages below num_computed."""
        chain = sched.chains.get(r.request_id)
        if caching and chain is not None:
            full = min(r.num_computed_tokens, len(chain)) // 4
            for page, b in zip(r.pages[:full], chain.blocks):
                sched.allocator.register(page, b.sequence_hash, b.parent_sequence_hash,
                                         b.tokens)

    def drive(sched, make):
        reqs = [make(rid, prompt, n) for rid, prompt, n in work]
        for r in reqs:
            sched.add_request(r)
        trace = []
        while sched.has_work and len(trace) < 400:
            batch = sched.schedule()
            done = [(r.request_id, why) for r, why, _ in sched.doomed]
            sched.doomed.clear()
            if batch is None:
                trace.append(("idle", done))
                continue
            rows = list(batch.decode)
            for r in rows:
                r.num_computed_tokens += 1
            for p in batch.prefill:
                p.request.num_computed_tokens += p.length
                register(sched, p.request)
                if p.request.num_computed_tokens >= len(p.request.prompt_tokens):
                    p.request.state = type(p.request.state)("decode")
                    rows.append(p.request)
            trace.append((batch.kind, [(p.request.request_id, p.start, p.length)
                                       for p in batch.prefill],
                          [(r.request_id, len(r.pages)) for r in rows], done,
                          sched.preemptions))
            for r in rows:
                r.output_tokens.append(7)
                if r.request_id in sched.chains:
                    sched.chains[r.request_id].append(7)
                if len(r.output_tokens) + r.num_emitted >= r.sampling.max_tokens:
                    sched.finish(r)
                register(sched, r)
        stats = sched.allocator.stats
        return trace, (stats.queries, stats.hit_tokens, stats.stored_blocks, stats.evicted_blocks)

    budgets = [{}, dict(prefill_token_budget=8),
               dict(prefill_token_budget=8, prefill_budget_policy="adaptive")]
    if mixed:
        budgets.append(dict(prefill_token_budget=4, prefill_budget_policy="adaptive",
                            prefill_budget_max=96, decode_buckets=(1, 2, 4)))
    for budget in budgets:
        kw = dict(num_pages=num_pages, max_seqs=4, admission_watermark=0.0,
                  enable_prefix_caching=caching, mixed_steps=mixed, **budget)
        jax_ev, torch_ev = [], []
        want, want_stats = drive(
            JaxScheduler(JaxEngineConfig.for_tests(**kw),
                         JaxAllocator(num_pages, 4, on_event=jax_ev.append)),
            lambda rid, p, n: JaxRequest(rid, p, JaxSampling(max_tokens=n)),
        )
        got, got_stats = drive(
            Scheduler(EngineConfig.for_tests(**kw), PageAllocator(num_pages, 4, torch_ev.append)),
            lambda rid, p, n: Request(rid, p, SamplingParams(max_tokens=n)))
        assert got == want
        assert len(want) < 400
        assert got_stats == want_stats
        assert [(e.kind, e.block_hashes, e.parent_hash, e.token_blocks) for e in torch_ev] == [
            (e.kind, e.block_hashes, e.parent_hash, e.token_blocks) for e in jax_ev]
        assert (want_stats[1] > 0) == caching  # the cache served some prompt
        assert any(start > 0 for step in want if step[0] != "idle" for _, start, _ in step[1])
        if num_pages == 9:  # the small pool did preempt
            assert max(step[-1] for step in want if step[0] != "idle") > 0
        assert any(step[0] == "mixed" for step in want) == mixed
