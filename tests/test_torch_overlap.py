"""The port's overlapped decode loop (EngineConfig.overlap_decode), on the CPU.

The next decode step is dispatched on speculation, its tokens fed from the
pending step's ids on the device, before those ids are read; the next
step consumes it or rolls it back. Streams must not depend on it. The
workload is the JAX package's rollback-heavy one
(tests/test_engine_overlap.py::_mixed_workload, rebuilt here from its
seed): greedy and seeded sampled rows, stop tokens, staggered max_tokens,
with requests admitted mid-wave and a pool small enough to preempt.
Both engines run the tiny config in float32 on the JAX engine's weights,
with the same prefix caching knob (the port takes the JAX engine's).
"""

import numpy as np
import pytest

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.engine import JaxEngine
from dynamo_tpu.engine.request import SamplingParams as JaxSampling
from dynamo_tpu_torch.cli import run as cli_run
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.request import SamplingParams
from tests.test_torch_engine import _torch_engine

#: 13 pages of 4 slots (12 usable): the six requests and the late ones
#: outgrow them, so the youngest is preempted and recomputes
POOL = dict(num_pages=13, admission_watermark=0.0)
#: step index -> a request added before that step, while a speculated
#: decode dispatch is in flight: its admission rolls the speculation back
LATE = {6: ("late0", [3, 1, 4, 1, 5], 6), 10: ("late1", [2, 7, 1, 8], 5)}
COUNTERS = ("overlap_dispatches", "overlap_hits", "overlap_rollbacks")


def _workload(greedy_only: bool = False) -> list[tuple[str, list[int], dict]]:
    """Six requests, prompts of 3-6 tokens from seed 7, odd ones seeded
    sampled (unless greedy_only), max_tokens 4/7/10, stop token 13 on two."""
    rng = np.random.default_rng(7)
    work = []
    for i in range(6):
        prompt = [int(x) for x in rng.integers(1, 200, 3 + (i % 4))]
        sampled = i % 2 == 1 and not greedy_only
        work.append((f"r{i}", prompt, dict(
            temperature=0.8 if sampled else 0.0, top_p=0.9 if sampled else 1.0, seed=100 + i,
            max_tokens=4 + 3 * (i % 3), stop_token_ids=(13,) if i in (2, 5) else ())))
    return work


def _drive(eng, sampling_cls, greedy_only: bool = False) -> dict[str, list[int]]:
    """The workload, then LATE's requests before their steps; request id ->
    generated ids."""
    for rid, prompt, p in _workload(greedy_only):
        eng.add_request(rid, prompt, sampling_cls(**p))
    out: dict[str, list[int]] = {}
    step = 0
    while eng.has_work or step <= max(LATE):
        if step in LATE:
            rid, prompt, n = LATE[step]
            eng.add_request(rid, prompt, sampling_cls(max_tokens=n, ignore_eos=True))
        for o in eng.step():
            out.setdefault(o.request_id, []).extend(o.new_token_ids)
        step += 1
    return out


def _jax_engine(**knobs):
    return JaxEngine(JaxEngineConfig.for_tests(**POOL, **knobs))


def _port(jax_eng, **knobs):
    return _torch_engine(jax_eng, **POOL, **knobs)


@pytest.fixture(scope="module")
def jax_greedy():
    """JaxEngine at its test config's defaults (overlap on, 8 fused steps)
    and its streams over the workload."""
    eng = _jax_engine()
    return eng, _drive(eng, JaxSampling)


@pytest.mark.parametrize("decode_steps", [1, 2, 8])
def test_streams_with_overlap_equal_streams_without(jax_greedy, decode_steps):
    """Every stream, greedy and seeded sampled, is the same with overlap on
    and off, to the token; the workload rolls speculations back and
    preempts. The greedy streams equal JaxEngine's (overlap on), which do
    not depend on the fused steps a dispatch runs. The port runs the XOR
    policy here (mixed steps off), under which each arrival rolls the
    speculation back; tests/test_torch_mixed.py runs this workload with
    mixed steps, whose decode halves consume the speculations instead."""
    jax_eng, ref = jax_greedy
    off = _port(jax_eng, decode_steps=decode_steps, overlap_decode=False, mixed_steps=False)
    on = _port(jax_eng, decode_steps=decode_steps, mixed_steps=False)
    want, got = _drive(off, SamplingParams), _drive(on, SamplingParams)
    assert got == want
    assert off.metrics.overlap_dispatches == 0
    m = on.metrics
    assert m.overlap_hits > 0 and m.overlap_rollbacks > 0
    assert on.scheduler.preemptions > 0
    assert m.overlap_dispatches == m.overlap_hits + m.overlap_rollbacks
    assert on._inflight is None and on.allocator.num_active == 0
    greedy = [rid for rid, _, p in _workload() if p["temperature"] == 0.0]
    greedy += [rid for rid, _, _ in LATE.values()]
    assert {r: got[r] for r in greedy} == {r: ref[r] for r in greedy}


@pytest.mark.parametrize("decode_steps", [1, 8])
def test_overlap_counters_equal_the_jax_engines(decode_steps):
    """On the all-greedy workload the port speculates, consumes and rolls
    back where JaxEngine does, at the configuration bench.py times (mixed
    steps off, decode_kstep 1) with prefix caching off in both (the port
    takes the JAX engine's knob)."""
    jax_eng = _jax_engine(decode_steps=decode_steps, mixed_steps=False, decode_kstep=1,
                          enable_prefix_caching=False)
    port = _port(jax_eng, decode_steps=decode_steps)
    want = _drive(jax_eng, JaxSampling, greedy_only=True)
    assert _drive(port, SamplingParams, greedy_only=True) == want
    got = {c: getattr(port.metrics, c) for c in COUNTERS}
    assert got == {c: getattr(jax_eng.metrics, c) for c in COUNTERS}
    assert got["overlap_hits"] > 0 and got["overlap_rollbacks"] > 0


def test_drain_overlap_leaves_nothing_in_flight():
    eng = _torch_engine(decode_steps=1)
    eng.drain_overlap()  # nothing in flight: nothing to count
    assert eng.metrics.overlap_rollbacks == 0
    eng.add_request("d", [1, 2, 3], SamplingParams(max_tokens=6, ignore_eos=True))
    toks = [t for _ in range(2) for o in eng.step() for t in o.new_token_ids]
    assert eng._inflight is not None  # prefill, then a decode step and its speculation
    eng.drain_overlap()
    assert eng._inflight is None and eng.metrics.overlap_rollbacks == 1
    toks += eng.run_to_completion()["d"]
    ref = _torch_engine(decode_steps=1, overlap_decode=False)
    ref.add_request("d", [1, 2, 3], SamplingParams(max_tokens=6, ignore_eos=True))
    assert toks == ref.run_to_completion()["d"]


def test_abort_between_steps_leaves_a_speculation_for_drain_overlap():
    """step() discards a speculation when work runs out, but an abort
    between steps empties the engine with one still in flight: the engine
    thread's drain_overlap is what rolls it back."""
    eng = _torch_engine(decode_steps=1)
    eng.add_request("a", [1, 2, 3], SamplingParams(max_tokens=6, ignore_eos=True))
    eng.step()
    eng.step()
    assert eng._inflight is not None
    assert eng.abort_request("a") and not eng.has_work
    assert eng._inflight is not None
    eng.drain_overlap()
    assert eng._inflight is None and eng.metrics.overlap_rollbacks == 1


def test_overlap_is_on_by_default_and_both_switches_reach_the_engine():
    assert EngineConfig().overlap_decode is True
    parse = cli_run._parse
    for argv, want in ((["run"], True), (["run", "--no-overlap-decode"], False)):
        args = parse(argv + ["--device", "cpu"])
        assert cli_run.engine_config(args, ()).overlap_decode is want
    eng = _torch_engine(decode_steps=1, overlap_decode=False)
    eng.add_request("x", [4, 5, 6], SamplingParams(max_tokens=8, ignore_eos=True))
    eng.run_to_completion()
    assert eng.metrics.decode_dispatches > 1 and eng.metrics.overlap_dispatches == 0
