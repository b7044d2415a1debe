"""The port's prompt-lookup speculation (EngineConfig.spec_ngram), on the CPU.

A greedy decode batch proposes S drafts a row from the last earlier
occurrence of its trailing n-gram and verifies them in one dispatch, key
("spec_verify", bucket, S + 1): the window [last token, drafts] runs as a
chunk with history whose K/V land token by token, and each row accepts
its matching drafts plus the model's token at the first mismatch. The
cases are the JAX package's (tests/test_spec_decode.py, and
tests/test_engine_kstep.py's test_spec_ngram_disables_kstep), plus the
policy (overlap and mixed steps off), a preemption that folds outputs into
the prompt, windows that cross a page and a row at its context limit.
Both engines run the tiny config in float32 on the JAX engine's weights;
prompts come from numpy seeds. In every case against JaxEngine, greedy
streams, step keys (JaxEngine's projected onto the port's fields,
tests/test_torch_mixed.py::_project) and the spec and dispatch counters
must be equal; greedy streams with speculation equal
the port's own without it (an fp32 property: speculation changes the
dispatches, never the tokens).
"""

import numpy as np
import pytest

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.engine import JaxEngine
from dynamo_tpu.engine.request import Request as JaxRequest
from dynamo_tpu.engine.request import SamplingParams as JaxSampling
from dynamo_tpu_torch.cli import run as cli_run
from dynamo_tpu_torch.engine.config import UNPORTED, EngineConfig
from dynamo_tpu_torch.engine.engine import key_field
from dynamo_tpu_torch.engine.request import Request, SamplingParams
from tests.test_torch_engine import _torch_engine
from tests.test_torch_kstep import _drive, _engines
from tests.test_torch_mixed import _project

COUNTERS = ("spec_drafted", "spec_accepted", "spec_skipped_ineligible", "spec_skipped_cooldown",
            "prefill_dispatches", "decode_dispatches", "mixed_dispatches",
            "overlap_dispatches", "overlap_hits", "overlap_rollbacks", "kstep_windows")
#: the JAX package's prompts (tests/test_spec_decode.py): one that repeats,
#: one that does not, one short
PROMPTS = [[1, 2, 3, 4, 1, 2, 3, 4, 1, 2], [9, 8, 7, 6, 5], [3, 3]]


def _repeating(seed: int, rows: int = 4) -> list[list[int]]:
    """Prompts that repeat a random block of 3-6 tokens two or three times
    (the case prompt lookup is for), from a numpy seed."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(rows):
        block = [int(x) for x in rng.integers(1, 250, 3 + i % 4)]
        out.append(block * (2 + i % 2))
    return out


def _greedy(prompts, max_tokens=12, tag="r"):
    return [(f"{tag}{i}", p, dict(max_tokens=max_tokens)) for i, p in enumerate(prompts)]


def _counters(eng) -> dict:
    return {c: getattr(eng.metrics, c) for c in COUNTERS}


def _assert_like_jax(port, jax_eng, got, want):
    """Streams, projected step keys and counters equal JaxEngine's, and
    the port ends idle with every page back."""
    assert got == want
    assert set(port.step_keys) == _project(jax_eng)
    assert _counters(port) == _counters(jax_eng)
    assert port.allocator.num_active == 0


# -- off by default, and the knobs -------------------------------------------------


def test_default_is_off_and_the_knobs_are_served():
    """spec_ngram defaults to 0 in the config and the CLI, and at 0 no
    verify key exists; --spec-ngram S reaches the config; the four
    prompt-lookup knobs are ported, and so are the draft-model ones (this
    case kept its name from when the port refused them)."""
    assert EngineConfig.for_tests().spec_ngram == 0
    assert cli_run.engine_config(cli_run._parse(["run"]), ()).spec_ngram == 0
    assert cli_run.engine_config(cli_run._parse(["run", "--spec-ngram", "4"]), ()).spec_ngram == 4
    cfg = EngineConfig.for_tests(spec_ngram=3, spec_ngram_match=3, spec_min_accept_rate=0.5,
                                 spec_cooldown_steps=2)
    assert (cfg.spec_ngram, cfg.spec_ngram_match, cfg.spec_min_accept_rate,
            cfg.spec_cooldown_steps) == (3, 3, 0.5, 2)
    assert not {"spec_ngram", "spec_ngram_match", "spec_min_accept_rate",
                "spec_cooldown_steps"} & UNPORTED.keys()
    draft = EngineConfig.for_tests(spec_draft_model="llama3-draft", spec_draft_tokens=3)
    assert (draft.spec_draft_model, draft.spec_draft_tokens) == ("llama3-draft", 3)
    assert not {"spec_draft_model", "spec_draft_tokens"} & UNPORTED.keys()
    jax_eng, port = _engines()
    work = _greedy(PROMPTS)
    _assert_like_jax(port, jax_eng, _drive(port, SamplingParams, work),
                     _drive(jax_eng, JaxSampling, work))
    assert not any(k[0] == "spec_verify" for k in port.step_keys)
    assert port.metrics.spec_drafted == port.metrics.spec_skipped_ineligible == 0


# -- greedy streams against JaxEngine and the port without speculation ------------


@pytest.mark.parametrize("spec", [3, 4])
def test_greedy_streams_equal_the_jax_engines(spec):
    """The JAX package's prompts and seeded repeating ones: streams, keys
    and counters equal JaxEngine's at the same spec_ngram, streams equal
    the port's without speculation, and the drafts were verified."""
    work = _greedy(PROMPTS) + _greedy(_repeating(spec), max_tokens=16, tag="rep")
    jax_eng, port = _engines(spec_ngram=spec)
    got = _drive(port, SamplingParams, work)
    _assert_like_jax(port, jax_eng, got, _drive(jax_eng, JaxSampling, work))
    plain = _torch_engine(jax_eng, spec_ngram=0)
    assert _drive(plain, SamplingParams, work) == got
    assert any(k[0] == "spec_verify" and key_field(k, "t") == spec + 1
               for k in port.step_keys)


def test_stats_advance_and_the_window_rate():
    """The counters advance (drafts verified, 0 <= accepted <= drafted)
    and the windowed acceptance rate is accepted / drafted over the
    window, as the JAX engine reports it."""
    jax_eng, port = _engines(spec_ngram=4)
    work = _greedy(PROMPTS) + _greedy(_repeating(11), max_tokens=16, tag="rep")
    _assert_like_jax(port, jax_eng, _drive(port, SamplingParams, work),
                     _drive(jax_eng, JaxSampling, work))
    m = port.metrics
    assert m.spec_drafted > 0 and 0 <= m.spec_accepted <= m.spec_drafted
    assert m.spec_window_drafted == m.spec_drafted
    assert m.spec_accept_rate == round(m.spec_accepted / m.spec_drafted, 4)
    assert m.spec_accept_rate == jax_eng.metrics.spec_accept_rate
    assert m.time_spec_host_ms > 0


# -- rows that make a batch ineligible ---------------------------------------------


@pytest.mark.parametrize("knobs", [
    dict(temperature=0.7, seed=1), dict(logprobs=0), dict(frequency_penalty=0.5),
    dict(presence_penalty=0.5), dict(repetition_penalty=1.3), dict(logit_bias=((7, 2.0),)),
    dict(min_tokens=2),
], ids=["sampled", "logprobs", "frequency", "presence", "repetition", "logit_bias",
        "min_tokens"])
def test_a_row_that_samples_or_shapes_its_logits_is_ineligible(knobs):
    """Beside a greedy repeating row, one row that samples, asks for
    logprobs or carries a penalty, logit_bias or min_tokens keeps the
    batch from speculating: no draft, the skip counted as ineligible,
    never as cooldown; streams, keys and counters equal JaxEngine's."""
    jax_eng, port = _engines(spec_ngram=4)
    work = [("g", PROMPTS[0], dict(max_tokens=6)),
            ("x", [1, 2, 3], dict(max_tokens=4, **knobs))]
    assert not port._spec_eligible([Request("x", [1, 2, 3], SamplingParams(**knobs))])
    want = _drive(jax_eng, JaxSampling, work)
    got = _drive(port, SamplingParams, work)
    if "temperature" in knobs:
        got.pop("x"), want.pop("x")  # seeded draws: the port keeps its own generator
    _assert_like_jax(port, jax_eng, got, want)
    m = port.metrics
    assert m.spec_skipped_ineligible > 0 and m.spec_skipped_cooldown == 0
    # the greedy row speculates once the other has finished
    assert m.spec_drafted == jax_eng.metrics.spec_drafted


# -- prefix caching and chunked prefill ---------------------------------------------


def test_prefix_cache_and_chunked_prefill():
    """A 22-token prompt prefilled in chunks of 8, then again onto its
    cached pages: speculation continues from the cache hit, both streams
    equal, and equal JaxEngine's."""
    knobs = dict(spec_ngram=3, enable_prefix_caching=True, prefill_chunk=8)
    long_prompt = list(range(1, 12)) + list(range(1, 12))
    jax_eng, port = _engines(**knobs)
    outs = []
    for eng, cls in ((jax_eng, JaxSampling), (port, SamplingParams)):
        first = _drive(eng, cls, [("r0", long_prompt, dict(max_tokens=8))])["r0"]
        again = _drive(eng, cls, [("again", long_prompt, dict(max_tokens=8))])["again"]
        assert again == first
        outs.append(first)
    assert outs[0] == outs[1]
    assert set(port.step_keys) == _project(jax_eng)
    assert _counters(port) == _counters(jax_eng)
    assert port.allocator.stats.hit_rate > 0


# -- the lookup ------------------------------------------------------------------------


def test_propose_drafts_lookup():
    """The trailing 2-gram's last earlier occurrence gives the drafts,
    zero-padded past the sequence or without a match, as JaxEngine's."""
    jax_eng, port = _engines(spec_ngram=3)
    cases = [([5, 6, 7, 8, 5, 6], [7, 8, 5]), ([1, 2, 3, 4], [0, 0, 0]),
             ([4, 9, 4, 9, 4], [9, 4, 0]), ([2, 7, 1, 2, 7], [1, 2, 7]),
             ([3, 1, 3], [0, 0, 0]), ([8, 8], [0, 0, 0]), ([6, 6, 6], [6, 0, 0])]
    for prompt, drafts in cases:
        req, jreq = Request("x", list(prompt)), JaxRequest("x", list(prompt))
        assert port._propose_drafts(req, 3) == jax_eng._propose_drafts(jreq, 3) == drafts


def test_the_ngram_index_follows_outputs_and_a_preemption():
    """The index grows with each accepted token (each n-gram start indexed
    once), and after a preemption folds outputs into the prompt it is
    rebuilt from the whole sequence, as JaxEngine's."""
    jax_eng, port = _engines(spec_ngram=3)
    req, jreq = Request("x", [5, 6, 7, 5, 6]), JaxRequest("x", [5, 6, 7, 5, 6])
    steps = [[7, 5], [6], [9, 9, 5, 6]]
    for new in steps:
        assert port._propose_drafts(req, 3) == jax_eng._propose_drafts(jreq, 3)
        for r in (req, jreq):
            r.output_tokens.extend(new)
    # a preemption: the outputs become prompt, the index is stale
    for r in (req, jreq):
        r.num_emitted += len(r.output_tokens)
        r.prompt_tokens = r.prompt_tokens + r.output_tokens
        r.output_tokens = [8]
    assert port._propose_drafts(req, 3) == jax_eng._propose_drafts(jreq, 3)
    assert req.spec_ctx == req.all_tokens and req.spec_indexed_upto == req.num_tokens - 2
    fresh = Request("y", req.all_tokens)
    port._propose_drafts(fresh, 3)
    assert req.spec_index == fresh.spec_index


def test_preemption_rebuilds_the_index_mid_stream():
    """A pool of 13 pages for three growing rows: one row is preempted
    with outputs, recomputed, and speculates again over an index rebuilt
    from its folded prompt; streams equal JaxEngine's and the port's
    without speculation."""
    knobs = dict(spec_ngram=3, num_pages=14, enable_prefix_caching=False,
                 spec_min_accept_rate=0.0)
    work = [(f"r{i}", p[:4] * 3, dict(max_tokens=14, ignore_eos=True))
            for i, p in enumerate(_repeating(0, rows=3))]
    jax_eng, port = _engines(**knobs)
    seen = []
    propose = port._propose_drafts

    def spy(req, s):
        seen.append((req.num_emitted, req.spec_index is not None,
                     req.num_tokens - len(req.spec_ctx or ()), len(req.output_tokens)))
        return propose(req, s)

    port._propose_drafts = spy
    got = _drive(port, SamplingParams, work)
    _assert_like_jax(port, jax_eng, got, _drive(jax_eng, JaxSampling, work))
    assert port.scheduler.preemptions == jax_eng.scheduler.preemptions > 0
    # a recomputed row found its stale index and rebuilt it
    assert any(emitted and stale and behind > outs for emitted, stale, behind, outs in seen)
    assert _drive(_torch_engine(jax_eng, **{**knobs, "spec_ngram": 0}), SamplingParams,
                  work) == got


# -- stops ------------------------------------------------------------------------------


def test_stops_at_eos_stop_ids_and_max_tokens():
    """max_tokens 3 inside the first window, a stop id (the plain stream's
    6th token) and, in a second engine, eos as well (its last token): each
    stream ends where the plain one ends on the same stops, and equals
    JaxEngine's."""
    p = [2, 4, 6, 8, 2, 4, 6, 8]
    probe = _torch_engine(JaxEngine(JaxEngineConfig.for_tests()))
    stream = _drive(probe, SamplingParams, [("a", p, dict(max_tokens=12))])["a"]
    stop, eos = stream[5], stream[-1]

    def cut(n, *ids):
        """The plain stream cut at n tokens or at the first of `ids`."""
        return stream[: min([n] + [stream.index(i) + 1 for i in ids])]

    work = [("len", p, dict(max_tokens=3)),
            ("stop", p, dict(max_tokens=12, stop_token_ids=(stop,)))]
    for knobs in (dict(spec_ngram=4), dict(spec_ngram=4, eos_token_ids=(eos,))):
        jax_eng, port = _engines(**knobs)
        got = _drive(port, SamplingParams, work)
        _assert_like_jax(port, jax_eng, got, _drive(jax_eng, JaxSampling, work))
        eos_ids = knobs.get("eos_token_ids", ())
        assert got == {"len": cut(3, *eos_ids), "stop": cut(12, stop, *eos_ids)}
        assert len(got["stop"]) < 12


# -- the cooldown -----------------------------------------------------------------------


def test_cooldown_on_lookup_miss():
    """A step under spec_min_accept_rate sets the cooldown, the next
    decode dispatches run the plain path (no draft, counted as cooldown),
    then speculation is probed again; as JaxEngine's, step by step (one
    decode step a plain dispatch, so the probe comes before the end)."""
    knobs = dict(spec_ngram=4, spec_cooldown_steps=3, decode_steps=1)
    jax_eng, port = _engines(**knobs)
    for eng, cls in ((jax_eng, JaxSampling), (port, SamplingParams)):
        eng.add_request("m", [11, 7, 23, 5, 17], cls(max_tokens=12))
    trace = {}
    for name, eng in (("jax", jax_eng), ("port", port)):
        trace[name] = []
        while eng.has_work:
            eng.step()
            trace[name].append((eng._spec_cooldown, *_counters(eng).values()))
    assert trace["port"] == trace["jax"]
    assert set(port.step_keys) == _project(jax_eng)
    # the non-repeating prompt's lookup misses: a verify, three plain
    # dispatches in the cooldown, then a probe
    cooldown, drafted = [t[0] for t in trace["port"]], [t[1] for t in trace["port"]]
    assert cooldown[1:5] == [3, 2, 1, 0] and drafted[1:5] == [4] * 4 and drafted[5] == 8
    assert port.metrics.spec_skipped_cooldown >= 3


# -- the policy: overlap, mixed steps and K-step windows off ----------------------------


def test_overlap_and_mixed_steps_auto_off():
    """With overlap and mixed steps on (the defaults) and a late chunked
    prompt arriving mid-decode, spec_ngram turns both off, as in the JAX
    engine: no speculated dispatch, no mixed step; streams, keys and
    counters equal JaxEngine's."""
    jax_eng, port = _engines(spec_ngram=4)
    assert port.config.overlap_decode and port.config.mixed_steps
    assert not port._overlap_enabled and not port.scheduler.mixed_enabled
    assert (jax_eng._overlap_enabled, jax_eng._mixed_enabled) == (False, False)
    late = _greedy([list(range(30, 54))], max_tokens=6, tag="late")
    work = _greedy(_repeating(5, rows=3), max_tokens=14)
    got = _drive(port, SamplingParams, work, late, late_at=3)
    _assert_like_jax(port, jax_eng, got, _drive(jax_eng, JaxSampling, work, late, late_at=3))
    m = port.metrics
    assert m.overlap_dispatches == m.mixed_dispatches == 0 and m.spec_drafted > 0
    off = _torch_engine(jax_eng, spec_ngram=0)
    assert off._overlap_enabled and off.scheduler.mixed_enabled
    assert _drive(off, SamplingParams, work, late, late_at=3) == got


def test_spec_ngram_disables_kstep():
    """Prompt-lookup speculation owns the decode batch: decode_kstep
    auto-disables with streams unchanged (tests/test_engine_kstep.py's
    case), as JaxEngine's."""
    knobs = dict(decode_kstep=8, spec_ngram=4, overlap_decode=False)
    jax_eng, port = _engines(**knobs)
    assert not port._kstep_enabled and not jax_eng._kstep_enabled
    work = [("g", [7, 8, 9, 7, 8], dict(max_tokens=8, ignore_eos=True))]
    got = _drive(port, SamplingParams, work)
    _assert_like_jax(port, jax_eng, got, _drive(jax_eng, JaxSampling, work))
    assert port.metrics.kstep_windows == 0
    k1 = _torch_engine(jax_eng, **{**knobs, "decode_kstep": 1})
    assert _drive(k1, SamplingParams, work) == got


# -- windows that cross a page, and rows at their context limit -------------------------


@pytest.mark.parametrize("spec", [3, 4])
def test_verify_windows_across_pages_land_the_jax_engines_kv(spec):
    """Pages of 4 tokens: a window of S + 1 starts mid-page and crosses one
    (S = 4 always; S = 3 unless it starts on a page). After each verify
    step, every slot below each row's num_computed_tokens holds the K/V
    JaxEngine's pool holds there (the same pages), and streams, keys and
    counters equal JaxEngine's."""
    jax_eng, port = _engines(spec_ngram=spec, enable_prefix_caching=False)
    work = _greedy(_repeating(7, rows=3), max_tokens=14)
    for eng, cls in ((jax_eng, JaxSampling), (port, SamplingParams)):
        for rid, prompt, kw in work:
            eng.add_request(rid, prompt, cls(**kw))
    got, want, crossed = {}, {}, 0
    ps = port.config.page_size
    while port.has_work:
        verifies = port.metrics.spec_drafted
        for eng, out in ((jax_eng, want), (port, got)):
            for o in eng.step():
                out.setdefault(o.request_id, []).extend(o.new_token_ids)
        if port.metrics.spec_drafted == verifies:
            continue
        for r, jr in zip(port.scheduler.running, jax_eng.scheduler.running):
            assert r.pages == jr.pages and r.num_computed_tokens == jr.num_computed_tokens
            n = r.num_computed_tokens
            pos = np.arange(n)
            pages = np.asarray(r.pages)[pos // ps]
            for mine, theirs in ((port.kv.k, jax_eng.kv.k), (port.kv.v, jax_eng.kv.v)):
                np.testing.assert_allclose(
                    mine.numpy()[:, pages, pos % ps],
                    np.asarray(theirs)[:, pages, pos % ps][..., : mine.shape[-1]],
                    atol=1e-5, rtol=1e-5)
            crossed += 1
    assert crossed > 0
    _assert_like_jax(port, jax_eng, got, want)


def test_a_row_at_its_context_limit_falls_back():
    """A context of 32 tokens: once a row's num_tokens + S passes it, its
    batch runs the plain decode dispatch (fused steps capped by the
    context), and the row ends at the limit; as JaxEngine's."""
    jax_eng, port = _engines(spec_ngram=4, spec_min_accept_rate=0.0)
    work = [("full", _repeating(2, rows=1)[0] * 3, dict(max_tokens=40, ignore_eos=True)),
            ("short", [4, 5, 4, 5], dict(max_tokens=6, ignore_eos=True))]
    got = _drive(port, SamplingParams, work)
    _assert_like_jax(port, jax_eng, got, _drive(jax_eng, JaxSampling, work))
    assert len(work[0][1]) + len(got["full"]) == port.config.max_context
    kinds = {k[0] for k in port.step_keys}
    assert "spec_verify" in kinds and kinds & {"decode", "decode_multi"}
