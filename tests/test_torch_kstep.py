"""The port's K-step decode windows (EngineConfig.decode_kstep), on the CPU.

A window runs K decode iterations in one step function, key kind
"decode_kstep", with each row's stop ids and budget judged on the device:
a row that emits a stop id or its last allowed token freezes for the rest
of the window. Streams must not depend on K. The cases are the JAX
package's (tests/test_engine_kstep.py) whose features the port has; both
engines run the tiny config in float32 on the JAX engine's weights, the
JAX engine as its own kstep tests run it. In every case against
JaxEngine, greedy streams, step keys (projected by name through
KEY_FIELDS) and the kstep, dispatch and overlap counters must be equal;
seeded streams must equal the port's own at K=1.
"""

import numpy as np
import pytest

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.engine import JaxEngine
from dynamo_tpu.engine.request import SamplingParams as JaxSampling
from dynamo_tpu_torch.cli import run as cli_run
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import key_field
from dynamo_tpu_torch.engine.request import SamplingParams
from dynamo_tpu_torch.engine.sampling import STOP_SLOTS
from tests.test_torch_engine import _torch_engine
from tests.test_torch_mixed import _project

COUNTERS = ("kstep_windows", "kstep_steps", "kstep_window_size", "kstep_fallbacks",
            "prefill_dispatches", "decode_dispatches", "mixed_dispatches",
            "overlap_dispatches", "overlap_hits", "overlap_rollbacks")
#: a context of 64 tokens, room for the long rows below
GEOM = dict(max_pages_per_seq=16)


def _engines(**knobs):
    """JaxEngine at its test config with `knobs` and the port on its
    weights with the same knobs."""
    jax_eng = JaxEngine(JaxEngineConfig.for_tests(**knobs))
    return jax_eng, _torch_engine(jax_eng, **knobs)


def _drive(eng, sampling_cls, work, late=(), late_at=2):
    """`work` (request id, prompt, SamplingParams knobs), then `late`
    ones after `late_at` steps; request id -> generated ids."""
    for rid, prompt, kw in work:
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


def _counters(eng) -> dict:
    return {c: getattr(eng.metrics, c) for c in COUNTERS}


def _assert_like_jax(port, jax_eng, got, want):
    """Streams, projected step keys and counters equal JaxEngine's, and
    the port ends idle with every page back."""
    assert got == want
    assert set(port.step_keys) == _project(jax_eng)
    assert _counters(port) == _counters(jax_eng)
    assert port._inflight is None and port.allocator.num_active == 0


def _workload(styles=("greedy", "sampled")):
    """Six rows of the JAX package's kstep workload
    (tests/test_engine_kstep.py:32-62, rebuilt from its seed): per-row
    sampling styles, max_tokens 5/9/13 so finishes land mid-window."""
    rng = np.random.default_rng(11)
    mk = {
        "greedy": lambda i: dict(max_tokens=5 + 4 * (i % 3), ignore_eos=True),
        "sampled": lambda i: dict(temperature=0.8, top_p=0.9, top_k=20, seed=300 + i,
                                  max_tokens=5 + 4 * (i % 3), ignore_eos=True),
        "penalty": lambda i: dict(temperature=0.7, seed=400 + i, repetition_penalty=1.3,
                                  frequency_penalty=0.2, max_tokens=6 + 3 * (i % 2),
                                  ignore_eos=True),
        "greedy_penalty": lambda i: dict(repetition_penalty=1.3, frequency_penalty=0.2,
                                         presence_penalty=0.1, max_tokens=6 + 3 * (i % 2),
                                         ignore_eos=True),
        "bias": lambda i: dict(logit_bias=((3, 4.0), (7, -2.0)), max_tokens=6 + 3 * (i % 2),
                               ignore_eos=True),
        "min_tokens": lambda i: dict(min_tokens=6, max_tokens=9),
    }
    work = []
    for i in range(6):
        style = styles[i % len(styles)]
        prompt = [int(x) for x in rng.integers(1, 200, 3 + (i % 4))]
        work.append((f"{style}{i}", prompt, mk[style](i)))
    return work


@pytest.fixture(scope="module")
def wave():
    """Four greedy rows of 9 to 40 tokens (a context of 64) with, on the
    second, a stop id its K=1 stream emits at its 12th token, and a late
    prompt of 24 tokens (two chunks): request lists for _drive."""
    rng = np.random.default_rng(5)
    prompts = [[int(x) for x in rng.integers(1, 200, 3 + i)] for i in range(4)]
    probe = _engines(decode_kstep=1, overlap_decode=False, **GEOM)[1]
    probe.add_request("p", prompts[1], SamplingParams(max_tokens=23, ignore_eos=True))
    stop = probe.run_to_completion()["p"][11]
    work = [(f"w{i}", p, dict(max_tokens=n, ignore_eos=True))
            for i, (p, n) in enumerate(zip(prompts, (40, 23, 9, 30)))]
    work[1] = ("w1", prompts[1], dict(max_tokens=23, stop_token_ids=(stop,)))
    late = [("late", [int(x) for x in rng.integers(1, 200, 24)],
             dict(max_tokens=6, ignore_eos=True))]
    return work, late


# -- K=1, the default: the engine dispatches what it dispatched without windows --


def test_default_is_off_and_pinned(wave):
    """decode_kstep defaults to 1 (the config and the CLI): no window is
    dispatched, no window key exists, and streams, keys and counters equal
    JaxEngine's and the port's with an explicit K=1."""
    assert EngineConfig.for_tests().decode_kstep == 1
    assert cli_run.engine_config(cli_run._parse(["run"]), ()).decode_kstep == 1
    work, late = wave
    jax_eng, port = _engines(**GEOM)
    want = _drive(jax_eng, JaxSampling, work, late)
    got = _drive(port, SamplingParams, work, late)
    _assert_like_jax(port, jax_eng, got, want)
    assert port.metrics.kstep_windows == 0
    assert not any(k[0] == "decode_kstep" for k in port.step_keys)
    explicit = _torch_engine(jax_eng, decode_kstep=1, **GEOM)
    assert _drive(explicit, SamplingParams, work, late) == got
    assert explicit.step_keys == port.step_keys


# -- K > 1 against JaxEngine and the port's K=1, overlap and mixed on and off --


@pytest.mark.parametrize("mixed", [False, True], ids=["xor", "mixed"])
@pytest.mark.parametrize("overlap", [False, True], ids=["sync", "overlap"])
@pytest.mark.parametrize("kstep", [4, 16])
def test_greedy_windows_equal_the_jax_engines(wave, kstep, overlap, mixed):
    """The wave, a stop mid-window and a late chunked prompt: streams, keys
    and counters equal JaxEngine's at the same decode_kstep, and streams
    equal the port's at K=1."""
    work, late = wave
    knobs = dict(decode_kstep=kstep, overlap_decode=overlap, mixed_steps=mixed, **GEOM)
    jax_eng, port = _engines(**knobs)
    want = _drive(jax_eng, JaxSampling, work, late)
    got = _drive(port, SamplingParams, work, late)
    _assert_like_jax(port, jax_eng, got, want)
    k1 = _torch_engine(jax_eng, **{**knobs, "decode_kstep": 1})
    assert _drive(k1, SamplingParams, work, late) == got
    m = port.metrics
    assert m.kstep_windows > 0 and m.kstep_steps >= 2 * m.kstep_windows
    assert m.time_kstep_ms > 0
    assert len(got["w1"]) < 23 and got["w1"][-1] == work[1][2]["stop_token_ids"][0]
    assert (m.mixed_dispatches > 0) == mixed
    # a mixed step whose decode rows may run as a window splits
    assert not any(k[0] == "mixed" for k in port.step_keys)


@pytest.mark.parametrize(
    "styles",
    [("sampled",), ("penalty",), ("bias", "min_tokens"), ("greedy", "sampled", "penalty", "bias")],
    ids=["sampled", "penalty", "bias_min_tokens", "mixed_rows"],
)
def test_seeded_windows_equal_the_ports_k1(styles):
    """Seeded, penalized, biased and min_tokens rows at K=8 equal the
    port's own K=1 streams (a live row's noise, draw counter and output
    counts advance as one step a dispatch advances them)."""
    work = _workload(styles)
    ref = _drive(_torch_engine(decode_kstep=1, overlap_decode=False), SamplingParams, work)
    eng = _torch_engine(decode_kstep=8, overlap_decode=False)
    assert _drive(eng, SamplingParams, work) == ref
    m = eng.metrics
    assert m.kstep_windows > 0 and m.kstep_window_size in (2, 4, 8)


def test_greedy_and_bias_rows_equal_the_jax_engines():
    """The JAX package's greedy and bias/min_tokens rows, overlap off: the
    same streams, keys and counters as JaxEngine at K=8 (min_tokens' eos
    ban and the bias slots gate on a live row's count)."""
    work = _workload(("greedy", "bias", "min_tokens"))
    jax_eng, port = _engines(decode_kstep=8, overlap_decode=False)
    _assert_like_jax(port, jax_eng, _drive(port, SamplingParams, work),
                     _drive(jax_eng, JaxSampling, work))
    assert any(k[0] == "decode_kstep" and k[-1] for k in port.step_keys)


@pytest.mark.parametrize("overlap", [False, True], ids=["sync", "overlap"])
def test_greedy_penalized_rows_equal_the_jax_engines(overlap):
    """Greedy rows with repetition, frequency and presence penalties beside
    plain greedy rows, budgets of 6 and 9 landing mid-window: the same
    streams, keys and counters as JaxEngine at K=8 (each step penalizes
    the counts a live row's earlier steps extended; a penalty batch never
    speculates, so overlap changes nothing)."""
    work = _workload(("greedy_penalty", "greedy"))
    jax_eng, port = _engines(decode_kstep=8, overlap_decode=overlap)
    _assert_like_jax(port, jax_eng, _drive(port, SamplingParams, work),
                     _drive(jax_eng, JaxSampling, work))
    assert any(k[0] == "decode_kstep" and key_field(k, "pen") for k in port.step_keys)
    assert port.metrics.overlap_dispatches == 0


def test_k16_long_wave():
    """One greedy row of 48 tokens at K=16: windows of 16 and the same
    stream as K=1 and JaxEngine."""
    work = [("w", [5, 17, 42], dict(max_tokens=48, ignore_eos=True))]
    knobs = dict(decode_kstep=16, overlap_decode=False, num_pages=128, **GEOM)
    jax_eng, port = _engines(**knobs)
    got = _drive(port, SamplingParams, work)
    _assert_like_jax(port, jax_eng, got, _drive(jax_eng, JaxSampling, work))
    k1 = _torch_engine(jax_eng, **{**knobs, "decode_kstep": 1})
    assert _drive(k1, SamplingParams, work) == got
    assert port.metrics.kstep_window_size == 16 and port.metrics.kstep_steps >= 32


# -- finishes judged on the device ------------------------------------------------


def test_stop_token_freezes_a_row_mid_window():
    """A stop id the row's greedy stream emits at its 11th token (in the
    same batch, with no stop): the window emits it and freezes the row at
    its first occurrence; the other row runs on. Same streams as K=1 and
    JaxEngine."""
    rows = [("s", [9, 9, 9]), ("other", [4, 4, 2])]
    jax_eng, port = _engines(decode_kstep=8, overlap_decode=False)
    probe = _drive(_torch_engine(jax_eng, decode_kstep=1, overlap_decode=False), SamplingParams,
                   [(rid, p, dict(max_tokens=24, ignore_eos=True)) for rid, p in rows])["s"]
    stop = probe[10]
    work = [("s", rows[0][1], dict(max_tokens=24, stop_token_ids=(stop,))),
            ("other", rows[1][1], dict(max_tokens=24, ignore_eos=True))]
    got = _drive(port, SamplingParams, work)
    _assert_like_jax(port, jax_eng, got, _drive(jax_eng, JaxSampling, work))
    assert got["s"] == probe[: probe.index(stop) + 1] and len(got["other"]) == 24
    k1 = _torch_engine(jax_eng, decode_kstep=1, overlap_decode=False)
    assert _drive(k1, SamplingParams, work) == got


def test_max_tokens_budget_lands_mid_window():
    """max_tokens of 5 and 13 at K=8: each row ends at its own count."""
    work = [("a", [1, 2, 3], dict(max_tokens=5, ignore_eos=True)),
            ("b", [4, 5, 6], dict(max_tokens=13, ignore_eos=True))]
    jax_eng, port = _engines(decode_kstep=8, overlap_decode=False)
    got = _drive(port, SamplingParams, work)
    _assert_like_jax(port, jax_eng, got, _drive(jax_eng, JaxSampling, work))
    assert (len(got["a"]), len(got["b"])) == (5, 13)


def test_oversized_stop_set_falls_back():
    """More stop ids than STOP_SLOTS: no window, each decode dispatch
    counts a fallback, as in JaxEngine; streams as K=1."""
    stops = tuple(range(1000, 1000 + STOP_SLOTS + 3))
    work = [("f", [1, 2, 3], dict(max_tokens=6, stop_token_ids=stops))]
    jax_eng, port = _engines(decode_kstep=8, overlap_decode=False)
    got = _drive(port, SamplingParams, work)
    _assert_like_jax(port, jax_eng, got, _drive(jax_eng, JaxSampling, work))
    assert port.metrics.kstep_windows == 0 and port.metrics.kstep_fallbacks > 0


def test_logprobs_rows_fall_back():
    """A logprob row takes the fused-steps path: no window, fallbacks
    counted as in JaxEngine, and tokens and logprobs equal K=1's."""

    def run(eng, sampling_cls):
        eng.add_request("lp", [5, 6, 7], sampling_cls(max_tokens=8, ignore_eos=True,
                                                      logprobs=2))
        toks, lps = [], []
        while eng.has_work:
            for o in eng.step():
                toks.extend(o.new_token_ids)
                lps.extend(o.logprobs or ())
        return toks, lps

    jax_eng, port = _engines(decode_kstep=8, overlap_decode=False)
    want, _ = run(jax_eng, JaxSampling)
    got = run(port, SamplingParams)
    _assert_like_jax(port, jax_eng, {"lp": got[0]}, {"lp": want})
    assert got == run(_torch_engine(jax_eng, decode_kstep=1, overlap_decode=False), SamplingParams)
    assert port.metrics.kstep_windows == 0 and port.metrics.kstep_fallbacks > 0


# -- composition: overlap, admissions, preemption, mixed steps ---------------------


def test_overlap_chains_windows():
    """With overlap on, the next window is dispatched on speculation off
    the pending one's ids and consumed: streams as with overlap off and as
    K=1, keys and counters as JaxEngine's."""
    work = [(f"c{i}", [3 + i, 9, 27, 81 - i], dict(max_tokens=40, ignore_eos=True))
            for i in range(3)]
    jax_eng, port = _engines(decode_kstep=8, **GEOM)
    got = _drive(port, SamplingParams, work)
    _assert_like_jax(port, jax_eng, got, _drive(jax_eng, JaxSampling, work))
    m = port.metrics
    assert m.overlap_hits > 0 and m.kstep_windows > m.decode_dispatches - m.overlap_hits
    sync = _torch_engine(jax_eng, decode_kstep=8, overlap_decode=False, **GEOM)
    assert _drive(sync, SamplingParams, work) == got
    assert _drive(_torch_engine(jax_eng, decode_kstep=1, **GEOM), SamplingParams, work) == got


def test_overlap_rollback_on_a_midwave_admission():
    """A request admitted while a chained window is in flight rolls it
    back; streams equal the synchronous K=1 engine's."""
    work = [("a", [1, 2, 3, 4], dict(max_tokens=24, ignore_eos=True)),
            ("b", [9, 8, 7], dict(max_tokens=24, ignore_eos=True))]
    late = [("late", [3, 1, 4, 1, 5], dict(max_tokens=8, ignore_eos=True))]
    jax_eng, port = _engines(decode_kstep=8)
    got = _drive(port, SamplingParams, work, late)
    _assert_like_jax(port, jax_eng, got, _drive(jax_eng, JaxSampling, work, late))
    assert port.metrics.kstep_windows > 0 and port.metrics.overlap_rollbacks > 0
    ref = _torch_engine(jax_eng, decode_kstep=1, overlap_decode=False)
    assert _drive(ref, SamplingParams, work, late) == got


def test_windows_under_preemption():
    """Page pressure preempts a row mid-wave: the windows (their runway
    reserved up front) recover the K=1 streams."""
    work = [("p1", list(range(1, 9)), dict(max_tokens=16, ignore_eos=True)),
            ("p2", list(range(9, 17)), dict(max_tokens=16, ignore_eos=True))]
    knobs = dict(decode_kstep=8, overlap_decode=False, num_pages=12)
    jax_eng, port = _engines(**knobs)
    got = _drive(port, SamplingParams, work)
    _assert_like_jax(port, jax_eng, got, _drive(jax_eng, JaxSampling, work))
    assert port.scheduler.preemptions > 0 and port.metrics.kstep_windows > 0
    k1 = _torch_engine(jax_eng, **{**knobs, "decode_kstep": 1})
    assert _drive(k1, SamplingParams, work) == got


def test_mixed_step_runs_the_window_as_its_decode_leg():
    """With mixed steps on, a late prompt's pieces dispatch as a prefill
    step beside the decode rows' window (no fused mixed key): streams
    equal K=1's, keys and counters JaxEngine's."""
    work = [("d1", [1, 2, 3], dict(max_tokens=20, ignore_eos=True)),
            ("d2", [4, 5, 6], dict(max_tokens=20, ignore_eos=True))]
    late = [("late", list(range(1, 20)), dict(max_tokens=8, ignore_eos=True))]
    knobs = dict(decode_kstep=8, overlap_decode=False, mixed_steps=True)
    jax_eng, port = _engines(**knobs)
    got = _drive(port, SamplingParams, work, late)
    _assert_like_jax(port, jax_eng, got, _drive(jax_eng, JaxSampling, work, late))
    m = port.metrics
    assert m.mixed_dispatches > 0 and m.kstep_windows > 0
    assert m.prefill_dispatches >= m.mixed_dispatches + 1
    # the late prompt's first piece samples nothing, its second does
    assert {k[0] for k in port.step_keys} == {"prefill_nosample", "prefill", "decode_kstep"}
    ref = _torch_engine(jax_eng, **{**knobs, "decode_kstep": 1})
    assert _drive(ref, SamplingParams, work, late) == got


# -- the scheduler's page runway --------------------------------------------------


def test_clamp_kstep_window_runway():
    """Scheduler.clamp_kstep_window halves K until the window's page
    growth fits the free pool, as the JAX scheduler does on the same
    state; a starved pool gives a K needing no new page."""
    knobs = dict(decode_kstep=8, overlap_decode=False, num_pages=16)
    jax_eng, port = _engines(**knobs)
    for eng, cls in ((jax_eng, JaxSampling), (port, SamplingParams)):
        eng.add_request("c1", [1, 2, 3, 4, 5, 6], cls(max_tokens=32, ignore_eos=True))
        eng.add_request("c2", [9, 8, 7, 6, 5, 4], cls(max_tokens=32, ignore_eos=True))
        while eng.has_work and not eng.scheduler.running:
            eng.step()
        eng.step()  # the prefill: both rows decode from here
    ps = port.config.page_size

    def need(reqs, k):
        return sum(max(0, -(-(r.num_tokens + k - 1) // ps) - len(r.pages)) for r in reqs)

    sched, reqs = port.scheduler, list(port.scheduler.running)
    jax_reqs = list(jax_eng.scheduler.running)
    for ask in (16, 8, 4):
        k = sched.clamp_kstep_window(reqs, ask)
        assert k == jax_eng.scheduler.clamp_kstep_window(jax_reqs, ask)
        assert 1 <= k <= ask and (k == 1 or need(reqs, k) <= sched.allocator.num_free)
    taken = sched.allocator.allocate(sched.allocator.num_free)
    jax_taken = jax_eng.scheduler.allocator.allocate(jax_eng.scheduler.allocator.num_free)
    k0 = sched.clamp_kstep_window(reqs, 8)
    assert k0 == jax_eng.scheduler.clamp_kstep_window(jax_reqs, 8)
    assert k0 < 8 and need(reqs, k0) == 0
    sched.allocator.free(taken)
    jax_eng.scheduler.allocator.free(jax_taken)
    assert port.run_to_completion() == jax_eng.run_to_completion()
