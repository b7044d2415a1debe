"""The port's mixed prefill+decode steps (EngineConfig.mixed_steps), on the CPU.

While prompts prefill beside running decodes, one step carries both: the
largest-T group of pieces and the decode batch (K=1) run as one "mixed"
step function, and a matching speculation in flight is consumed as the
decode half with the pieces dispatched beside it. The workloads are the
JAX package's (tests/test_engine_mixed.py): chunked prompts arriving
against a decode wave, pieces in different T buckets, a preemption and
its recompute. Both engines run the tiny config in float32 on the JAX
engine's weights, the JAX engine with attention_impl="pallas" (its
kernels in interpret mode), and greedy streams must be identical: to
JaxEngine's with mixed steps on, and to the port's own with them off.
"""

import dataclasses

import numpy as np
import pytest

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.engine import EngineMetrics as JaxEngineMetrics
from dynamo_tpu.engine.engine import JaxEngine
from dynamo_tpu.engine.request import SamplingParams as JaxSampling
from dynamo_tpu_torch.cli import run as cli_run
from dynamo_tpu_torch.engine.config import UNPORTED, EngineConfig
from dynamo_tpu_torch.engine.engine import DECODE_KINDS, EngineMetrics
from dynamo_tpu_torch.engine.request import SamplingParams
from tests.test_torch_engine import _torch_engine

COUNTERS = ("mixed_dispatches", "prefill_dispatches", "decode_dispatches",
            "overlap_dispatches", "overlap_hits", "overlap_rollbacks")


def _jax_engine(**knobs):
    return JaxEngine(JaxEngineConfig.for_tests(**{
        "attention_impl": "pallas", "enable_prefix_caching": False, "mixed_steps": True,
        **knobs}))


def _drive(eng, sampling_cls, base, late=(), late_at=5):
    """`base` requests, then `late` ones after `late_at` steps (the shape
    that makes mixed steps, or XOR prefill steps, against a running
    decode wave); returns request id -> generated ids."""
    for rid, prompt, kw in base:
        eng.add_request(rid, prompt, sampling_cls(**kw))
    out: dict[str, list[int]] = {}
    steps = 0
    added = not late
    while eng.has_work or not added:
        for o in eng.step():
            out.setdefault(o.request_id, []).extend(o.new_token_ids)
        steps += 1
        if steps == late_at and not added:
            for rid, prompt, kw in late:
                eng.add_request(rid, prompt, sampling_cls(**kw))
            added = True
    return out


def _chunked_late(seed: int, n: int = 2, max_tokens: int = 6):
    """Prompts of 24 + 2i tokens from `seed`, longer than the chunk of 16,
    so each prefills in two pieces (tests/test_engine_mixed.py:46-56)."""
    rng = np.random.default_rng(seed)
    return [(f"late{i}", [int(x) for x in rng.integers(1, 200, 24 + 2 * i)],
             dict(max_tokens=max_tokens, ignore_eos=True)) for i in range(n)]


WAVE = [("a", [1, 2, 3], dict(max_tokens=20, ignore_eos=True)),
        ("b", [4, 5, 6, 7], dict(max_tokens=20, ignore_eos=True))]


def _project(jax_eng) -> set:
    """JaxEngine._jit_cache's step keys projected onto the port's fields:
    mixed (kind, b, t, b_pre, greedy, first_chunk, psamp, lp, pen, bias)
    from JAX fields 0, 1, 2, 9, 3, 5, 10, 6, 7, 8; prefill and decode as
    the port keys them (tests/test_torch_step_graph.py); a prompt-lookup
    verify as (kind, b, t); a draft-model dispatch as (kind, b, t, greedy,
    pen, bias) from JAX fields 0-3, 7, 8, and a draft chunk step as (kind,
    b, t, first_chunk)."""
    out = set()
    for k in jax_eng._jit_cache:
        if k[0] == "mixed":
            out.add((k[0], k[1], k[2], k[9], k[3], k[5], k[10], k[6], k[7], k[8]))
        elif k[0] == "prefill":
            out.add((k[0], k[1], k[2], k[3], k[5], k[6], k[7], k[8]))
        elif k[0] == "prefill_nosample":
            out.add((k[0], k[1], k[2], k[5]))
        elif k[0] in DECODE_KINDS:
            out.add((*k[:4], k[6], k[7], k[8]))
        elif k[0] == "spec_verify":
            out.add(k[:3])
        elif k[0] == "spec_fused":
            out.add((*k[:4], k[7], k[8]))
        elif k[0] == "spec_draft_prefill":
            out.add((*k[:3], k[5]))
    return out


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("decode_steps", [1, 8])
def test_greedy_streams_counters_and_keys_equal_the_jax_engines(decode_steps, overlap):
    """Chunked prompts arrive against a decode wave: the port's greedy
    streams, dispatch counts, overlap counters and step keys equal
    JaxEngine's with mixed steps on, and its streams equal its own with
    mixed steps off."""
    late_at = 5 if decode_steps == 1 else 2  # the wave is still decoding
    late = _chunked_late(5)
    jax_eng = _jax_engine(decode_steps=decode_steps, overlap_decode=overlap)
    port = _torch_engine(jax_eng, decode_steps=decode_steps, overlap_decode=overlap)
    xor = _torch_engine(jax_eng, decode_steps=decode_steps, overlap_decode=overlap,
                        mixed_steps=False)
    want = _drive(jax_eng, JaxSampling, WAVE, late, late_at)
    got = _drive(port, SamplingParams, WAVE, late, late_at)
    assert got == want
    assert _drive(xor, SamplingParams, WAVE, late, late_at) == got
    m = port.metrics
    assert {c: getattr(m, c) for c in COUNTERS} == {c: getattr(jax_eng.metrics, c)
                                                    for c in COUNTERS}
    assert m.mixed_dispatches > 0 and xor.metrics.mixed_dispatches == 0
    assert set(port.step_keys) == _project(jax_eng)
    assert not any(k[0] == "mixed" for k in xor.step_keys)
    if overlap:
        assert m.overlap_hits > 0
        assert m.overlap_dispatches == m.overlap_hits + m.overlap_rollbacks
    assert port._inflight is None and port.allocator.num_active == 0


def test_mixed_step_keys_stay_finite():
    """Every mixed key is (decode bucket, T bucket, piece bucket) of the
    bucket families, the keys equal JaxEngine's, and a second wave of the
    same shapes with new requests adds no key
    (tests/test_engine_mixed.py:295-344; overlap off, so every mixed step
    is one fused dispatch)."""
    jax_eng = _jax_engine(decode_steps=1, overlap_decode=False)
    port = _torch_engine(jax_eng, decode_steps=1, overlap_decode=False)
    rng = np.random.default_rng(17)
    waves = []
    for tag in "xy":
        base = [(f"{tag}w{i}", [int(x) for x in rng.integers(1, 200, 2 + i)],
                 dict(max_tokens=14, ignore_eos=True)) for i in range(3)]
        late = [(f"{tag}l{i}", [int(x) for x in rng.integers(1, 200, 18 + 3 * i)],
                 dict(max_tokens=4, ignore_eos=True)) for i in range(3)]
        waves.append((base, late))
    keys = []
    for base, late in waves:
        want = _drive(jax_eng, JaxSampling, base, late)
        assert _drive(port, SamplingParams, base, late) == want
        keys.append(set(port.step_keys))
    assert keys[0] == keys[1] == _project(jax_eng)
    cfg = port.config
    mixed = [k for k in keys[0] if k[0] == "mixed"]
    assert mixed and port.metrics.mixed_dispatches == jax_eng.metrics.mixed_dispatches
    for _, b_dec, t, b_pre, *_ in mixed:
        assert b_dec in cfg.decode_buckets
        assert t in (32, 64, 128, 256, 512) and t <= max(cfg.prefill_chunk, 32)
        assert b_pre in (1, 2, 4, 8) and b_pre + b_dec <= cfg.decode_buckets[-1]


def test_seeded_sampled_streams_whatever_shares_the_step():
    """A seeded sampled request draws the same stream alone and as a row
    of mixed steps: a decode row beside a late prompt's pieces, and a late
    prompt whose last piece is sampled beside decode rows; every stream,
    sampled ones included, is the same with mixed steps on and off."""
    sampled = dict(temperature=0.9, top_p=0.9, top_k=20, seed=1234, max_tokens=12,
                   ignore_eos=True)
    base = [("s", [5, 6, 7], sampled), *WAVE]
    late = [*_chunked_late(9), ("ls", list(range(30, 52)), {**sampled, "seed": 77})]
    streams = []
    for mixed in (True, False):
        eng = _torch_engine(decode_steps=1, mixed_steps=mixed)
        streams.append(_drive(eng, SamplingParams, base, late, late_at=3))
        assert (eng.metrics.mixed_dispatches > 0) == mixed
    assert streams[0] == streams[1]
    for rid, prompt, kw in (base[0], late[-1]):
        alone = _torch_engine(decode_steps=4)
        alone.add_request(rid, prompt, SamplingParams(**kw))
        assert alone.run_to_completion()[rid] == streams[0][rid], rid


@pytest.mark.parametrize("overlap", [False, True])
def test_pieces_in_different_t_buckets(overlap):
    """A 64-token chunk beside a 26-token tail and a 50-token prompt: the
    largest-T group is fused with the decode batch and the other group
    dispatches beside it, each under the key the XOR policy gives it
    (tests/test_engine_mixed.py:162-198, chunk 64)."""
    rng = np.random.default_rng(41)
    late = [("two-chunk", [int(x) for x in rng.integers(1, 200, 90)],
             dict(max_tokens=4, ignore_eos=True)),
            ("one-piece", [int(x) for x in rng.integers(1, 200, 50)],
             dict(max_tokens=4, ignore_eos=True))]
    base = [("w", [1, 2, 3], dict(max_tokens=24, ignore_eos=True))]
    knobs = dict(decode_steps=1, overlap_decode=overlap, prefill_chunk=64,
                 max_pages_per_seq=32, num_pages=128)
    jax_eng = _jax_engine(**knobs)
    port = _torch_engine(jax_eng, **knobs)
    want = _drive(jax_eng, JaxSampling, base, late)
    assert _drive(port, SamplingParams, base, late) == want
    xor = _torch_engine(jax_eng, **knobs, mixed_steps=False)
    assert _drive(xor, SamplingParams, base, late) == want
    assert {c: getattr(port.metrics, c) for c in COUNTERS} == {
        c: getattr(jax_eng.metrics, c) for c in COUNTERS}
    assert port.metrics.mixed_dispatches > 0
    assert set(port.step_keys) == _project(jax_eng)
    if not overlap:  # with overlap the speculations are the decode halves
        assert any(k[0] == "mixed" and k[2] == 64 for k in port.step_keys)


def test_preemption_resume_through_mixed_steps():
    """Page pressure preempts mid-wave; a victim is admitted again once the
    shortest request has finished and recomputes in a mixed step beside
    the row still decoding, and the streams equal JaxEngine's and the XOR
    policy's (tests/test_engine_mixed.py:200-216, with a third request so
    that the recompute meets a decode row)."""
    knobs = dict(decode_steps=1, num_pages=12, max_pages_per_seq=8)
    base = [("p1", list(range(1, 9)), dict(max_tokens=6, ignore_eos=True)),
            ("p2", list(range(9, 17)), dict(max_tokens=16, ignore_eos=True)),
            ("p3", list(range(17, 25)), dict(max_tokens=16, ignore_eos=True))]
    jax_eng = _jax_engine(**knobs)
    port = _torch_engine(jax_eng, **knobs)
    want = _drive(jax_eng, JaxSampling, base)
    assert _drive(port, SamplingParams, base) == want
    assert _drive(_torch_engine(jax_eng, **knobs, mixed_steps=False), SamplingParams,
                  base) == want
    assert port.scheduler.preemptions == jax_eng.scheduler.preemptions >= 1
    assert port.metrics.mixed_dispatches == jax_eng.metrics.mixed_dispatches > 0


def test_speculation_rides_through_a_backlog():
    """While a long prompt drains chunk by chunk, the decode rows hold, so
    the overlapped loop keeps speculating: overlap hits grow during the
    mixed steps, and the wave's stream is the synchronous engine's
    (tests/test_engine_mixed.py:248-280)."""
    eng = _torch_engine(decode_steps=1, mixed_steps=True, overlap_decode=True)
    eng.add_request("w", [1, 2, 3], SamplingParams(max_tokens=30, ignore_eos=True))
    out: dict[str, list[int]] = {}
    for _ in range(4):
        for o in eng.step():
            out.setdefault(o.request_id, []).extend(o.new_token_ids)
    hits = eng.metrics.overlap_hits
    rng = np.random.default_rng(2)
    eng.add_request("long", [int(x) for x in rng.integers(1, 200, 28)],
                    SamplingParams(max_tokens=4, ignore_eos=True))
    mixed_hits = 0
    while eng.has_work:
        before = (eng.metrics.mixed_dispatches, eng.metrics.overlap_hits)
        for o in eng.step():
            out.setdefault(o.request_id, []).extend(o.new_token_ids)
        if eng.metrics.mixed_dispatches > before[0]:
            mixed_hits += eng.metrics.overlap_hits - before[1]
    assert mixed_hits > 0 and eng.metrics.overlap_hits > hits
    sync = _torch_engine(decode_steps=1, mixed_steps=True, overlap_decode=False)
    sync.add_request("w", [1, 2, 3], SamplingParams(max_tokens=30, ignore_eos=True))
    assert out["w"] == sync.run_to_completion()["w"]


@pytest.mark.parametrize("decode_steps", [1, 8])
def test_overlap_with_mixed_steps_on_the_rollback_workload(decode_steps):
    """tests/test_torch_overlap.py's workload (greedy and seeded sampled
    rows, stop tokens, late arrivals, a pool that preempts) with mixed
    steps on: every stream is the same with overlap on and off, and on
    its all-greedy form the streams and the dispatch and overlap counters
    equal JaxEngine's, where arrivals run as mixed steps whose decode
    halves consume the speculations."""
    from tests.test_torch_overlap import POOL, _drive as drive_overlap

    knobs = dict(decode_steps=decode_steps, decode_kstep=1, **POOL)
    jax_eng = _jax_engine(**knobs)
    port = _torch_engine(jax_eng, decode_steps=decode_steps, **POOL)
    want = drive_overlap(jax_eng, JaxSampling, greedy_only=True)
    assert drive_overlap(port, SamplingParams, greedy_only=True) == want
    assert {c: getattr(port.metrics, c) for c in COUNTERS} == {
        c: getattr(jax_eng.metrics, c) for c in COUNTERS}
    assert port.metrics.mixed_dispatches > 0 and port.metrics.overlap_hits > 0
    on = _torch_engine(jax_eng, decode_steps=decode_steps, **POOL)
    off = _torch_engine(jax_eng, decode_steps=decode_steps, overlap_decode=False, **POOL)
    assert drive_overlap(on, SamplingParams) == drive_overlap(off, SamplingParams)
    assert on.scheduler.preemptions > 0 and on.metrics.mixed_dispatches > 0
    m = on.metrics
    assert m.overlap_dispatches == m.overlap_hits + m.overlap_rollbacks


def test_prefix_hits_through_mixed_steps_equal_the_jax_engines():
    """Caching on in both: a wave whose prompts hit a warm request's pages
    prefills their uncached pieces in mixed steps beside the rows that
    finished theirs; streams, cached tokens, KV events, step keys and hit
    rate equal JaxEngine's."""
    from tests.test_torch_prefix_cache import HIT_WAVES, _assert_engines_agree

    (streams, firsts), eng, _ = _assert_engines_agree(
        HIT_WAVES, num_pages=18, decode_steps=1, overlap_decode=True, mixed_steps=True)
    assert eng.metrics.mixed_dispatches > 0
    assert firsts["long"] == [28]


def test_mixed_piece_cap_matches_the_jax_scheduler():
    """With two rows decoding and eight short prompts waiting, the
    adaptive budget would pack many pieces; the mixed cap (largest decode
    bucket 4, less the decode bucket 2) holds the step to two, in the JAX
    scheduler and in the port's, batch for batch
    (tests/test_scheduler_mixed.py:150)."""
    from dynamo_tpu.engine.page_table import PageAllocator as JaxAllocator
    from dynamo_tpu.engine.request import Request as JaxRequest
    from dynamo_tpu.engine.scheduler import Scheduler as JaxScheduler
    from dynamo_tpu_torch.engine.page_table import PageAllocator
    from dynamo_tpu_torch.engine.request import Request
    from dynamo_tpu_torch.engine.scheduler import Scheduler

    kw = dict(model="tiny", num_pages=128, page_size=4, max_pages_per_seq=8,
              decode_buckets=(1, 2, 4), prefill_chunk=8, max_seqs=16, prefill_token_budget=8,
              prefill_budget_policy="adaptive", prefill_budget_max=96,
              admission_watermark=0.0, dtype="float32", enable_prefix_caching=False,
              mixed_steps=True)

    def trace(sched, make):
        for i in range(2):
            sched.add_request(make(f"d{i}", [1, 2, 3], 32))
        batch = sched.schedule()
        for piece in batch.prefill:
            piece.request.num_computed_tokens += piece.length
            piece.request.state = type(piece.request.state)("decode")
            piece.request.output_tokens.append(0)
        for i in range(8):
            sched.add_request(make(f"p{i}", [1, 2, 3, 4, 5], 4))
        out = []
        for _ in range(3):
            batch = sched.schedule()
            n_tokens = sum(p.length for p in batch.prefill) + len(batch.decode)
            out.append((batch.kind, n_tokens,
                        [(p.request.request_id, p.start, p.length) for p in batch.prefill],
                        [r.request_id for r in batch.decode]))
            for piece in batch.prefill:
                piece.request.num_computed_tokens += piece.length
            for r in batch.decode:
                r.num_computed_tokens += 1
                r.output_tokens.append(0)
        return out

    want = trace(JaxScheduler(JaxEngineConfig(**kw), JaxAllocator(128, 4)),
                 lambda rid, p, n: JaxRequest(rid, p, JaxSampling(max_tokens=n)))
    got = trace(Scheduler(EngineConfig(**kw), PageAllocator(128, 4)),
                lambda rid, p, n: Request(rid, p, SamplingParams(max_tokens=n)))
    assert got == want
    kind, n_tokens, pieces, rows = got[0]
    assert kind == "mixed" and len(pieces) == 2 and len(rows) == 2
    assert n_tokens == sum(p[2] for p in pieces) + 2


def test_mixed_steps_are_on_by_default_and_the_cli_switch_reaches_the_engine():
    """EngineConfig and the CLI serve mixed steps with no flag, as the JAX
    package does; --no-mixed-steps gives the XOR policy, whose engine
    schedules no mixed step and dispatches no mixed key."""
    assert EngineConfig().mixed_steps is True and "mixed_steps" not in UNPORTED
    assert EngineConfig().mixed_steps == JaxEngineConfig().mixed_steps
    for argv, want in ((["run"], True), (["run", "--no-mixed-steps"], False)):
        args = cli_run._parse(argv + ["--device", "cpu"])
        assert cli_run.engine_config(args, ()).mixed_steps is want
    eng = _torch_engine(decode_steps=1, mixed_steps=False)
    assert not eng.scheduler.mixed_enabled
    _drive(eng, SamplingParams, WAVE, _chunked_late(8))
    assert eng.metrics.mixed_dispatches == 0 and eng.metrics.time_mixed_ms == 0.0
    assert not any(k[0] == "mixed" for k in eng.step_keys)


def test_engine_metrics_carry_the_jax_engines_mixed_fields():
    names = {f.name: f.type for f in dataclasses.fields(EngineMetrics)}
    jax_names = {f.name: f.type for f in dataclasses.fields(JaxEngineMetrics)}
    for name in ("mixed_dispatches", "time_mixed_ms"):
        assert names[name] == jax_names[name]
    eng = _torch_engine(decode_steps=1, mixed_steps=True)
    _drive(eng, SamplingParams, WAVE, _chunked_late(3))
    m = eng.metrics
    assert m.mixed_dispatches > 0 and m.time_mixed_ms > 0.0
    assert m.mixed_replays == 0  # the CPU captures nothing
