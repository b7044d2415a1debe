"""The port's sampling surface against the JAX package's, on the CPU.

The sampler's functions (build_output_counts, apply_penalties,
apply_logit_bias, token_logprobs) are held to dynamo_tpu/engine/sampling.py
on the same seeded inputs, within 1e-6. Then TorchEngine is held to
JaxEngine on the tiny config in float32 with the JAX engine's weights:
greedy streams (and seeded sampled ones whose every token a +100 bias
forces) must be identical, and the chosen and top logprobs within 1e-4
with identical top ids, over logprobs, frequency, presence and repetition
penalties, logit_bias and min_tokens; at 1 and 8 fused steps, overlap and
mixed steps on and off, prefix hits, a preemption, each pool mode, and the
step keys with their `lp`, `pen` and `bias` fields. The JAX engine runs its
XLA attention, the plain reference of its Pallas kernels. The cases mirror
the JAX package's tests/test_logprobs.py, tests/test_logit_bias.py,
test_engine_mixed.py::test_mixed_parity_with_penalties and
test_engine_overlap.py::test_penalties_fall_back_to_sync.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import sampling as jax_sampling
from dynamo_tpu.engine.engine import JaxEngine
from dynamo_tpu.engine.request import SamplingParams as JaxSampling
from dynamo_tpu_torch.engine import sampling
from dynamo_tpu_torch.engine.engine import key_field
from dynamo_tpu_torch.engine.request import SamplingParams
from tests.test_torch_engine import _torch_engine
from tests.test_torch_mixed import _project

#: a logprob gap to the JAX engine's and the sampler functions' tolerance
LP_TOL, FN_TOL = 1e-4, 1e-6
#: every eos/stop case stops on this id, which a +100 bias makes the argmax
STOP = 91


def _jax_engine(**knobs):
    return JaxEngine(JaxEngineConfig.for_tests(**{
        "attention_impl": "xla", "enable_prefix_caching": False, "overlap_decode": False,
        "mixed_steps": False, **knobs}))


# -- the sampler's functions ---------------------------------------------------


def _rng_logits(rng, b=5, v=97):
    return (rng.standard_normal((b, v)) * 3).astype(np.float32)


def test_build_output_counts_equals_the_references():
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 97, (5, 12))
    valid = rng.random((5, 12)) < 0.7
    want = np.asarray(jax_sampling.build_output_counts(jnp.asarray(toks, jnp.int32),
                                                       jnp.asarray(valid), 97))
    got = sampling.build_output_counts(torch.from_numpy(toks), torch.from_numpy(valid), 97)
    np.testing.assert_array_equal(got.numpy(), want)
    ids = torch.from_numpy(rng.integers(0, 97, 5))
    np.testing.assert_array_equal(sampling.count_tokens(got, ids).numpy(),
                                  want + np.eye(97, dtype=np.float32)[ids.numpy()])


@pytest.mark.parametrize("rep", [None, 1.0, "rows"])
def test_apply_penalties_equals_the_references(rep):
    rng = np.random.default_rng(1)
    logits = _rng_logits(rng)
    counts = (rng.integers(0, 3, logits.shape) * (rng.random(logits.shape) < 0.2)).astype(
        np.float32)
    freq = rng.random(5).astype(np.float32)
    pres = rng.random(5).astype(np.float32)
    reps = {None: None, 1.0: np.ones(5, np.float32),
            "rows": np.array([1.0, 1.3, 0.7, 2.0, 1.5], np.float32)}[rep]
    want = jax_sampling.apply_penalties(*(None if a is None else jnp.asarray(a)
                                          for a in (logits, counts, freq, pres, reps)))
    got = sampling.apply_penalties(*(None if a is None else torch.from_numpy(a)
                                     for a in (logits, counts, freq, pres, reps)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=FN_TOL)
    if rep == 1.0:  # a repetition penalty of 1 changes nothing
        np.testing.assert_array_equal(
            got.numpy(), sampling.apply_penalties(*(torch.from_numpy(a) for a in (
                logits, counts, freq, pres))).numpy())


def test_apply_logit_bias_equals_the_references():
    """Gated slots (a ban while the counter is under min_tokens), repeated
    ids in a row, zero padding slots, counters on both sides of the gate."""
    rng = np.random.default_rng(2)
    logits = _rng_logits(rng)
    ids = rng.integers(0, 97, (5, sampling.BIAS_SLOTS))
    ids[:, 1] = ids[:, 0]  # a repeated id
    vals = (rng.standard_normal(ids.shape) * 10).astype(np.float32)
    vals[:, 10:] = 0.0  # padding
    gated = np.zeros(ids.shape, bool)
    gated[:, 6:9] = True
    vals[:, 6:9] = -1e30
    counters = np.array([0, 3, 4, 5, 9])
    mins = np.array([4, 4, 4, 4, 0])
    want = jax_sampling.apply_logit_bias(
        jnp.asarray(logits), jnp.asarray(ids, jnp.int32), jnp.asarray(vals),
        jnp.asarray(gated), jnp.asarray(counters, jnp.int32), jnp.asarray(mins, jnp.int32))
    got = sampling.apply_logit_bias(*(torch.from_numpy(a) for a in (
        logits, ids, vals, gated, counters, mins)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=FN_TOL)
    assert (got.numpy() < -1e29).any(axis=1).tolist() == [True, True, False, False, False]


@pytest.mark.parametrize("k", [0, 5, 20])
def test_token_logprobs_equals_the_references(k):
    rng = np.random.default_rng(3 + k)
    logits = _rng_logits(rng)
    ids = rng.integers(0, 97, 5)
    want = jax_sampling.token_logprobs(jnp.asarray(logits), jnp.asarray(ids, jnp.int32), k)
    got = sampling.token_logprobs(torch.from_numpy(logits), torch.from_numpy(ids), k)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=FN_TOL)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=0, atol=FN_TOL)
    assert got[1].shape == (5, max(k, 1))


def test_token_logprobs_lists_ties_in_id_order_with_the_argmax_first():
    """Equal logits (frequent in a bf16 product) list in id order, and the
    first alternative is the argmax, the id greedy sampling picks, even
    where torch.topk keeps other ids of the tie."""
    logits = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0], [0.0] * 5, [5.0, 1.0, 2.0, 3.0, 4.0]])
    ids = torch.argmax(logits, dim=-1)
    got = {k: sampling.token_logprobs(logits, ids, k)[1].tolist() for k in (1, 3, 5)}
    assert got[1] == [[1], [0], [0]]
    assert got[5] == [[1, 2, 4, 3, 0], [0, 1, 2, 3, 4], [0, 4, 3, 2, 1]]
    assert [row[0] for row in got[3]] == ids.tolist()
    assert got[3][0] == [1, 2, 4] and got[3][2] == [0, 4, 3]


@pytest.mark.parametrize("k", [1, 3, 5, 20])
def test_token_logprobs_keeps_the_lower_ids_of_a_tie_across_the_nth_place(k):
    """Ties planted across the k-th place (some of the tied ids make the
    cut, some do not), at the top, and a row of one value: the ids equal
    jax.lax.top_k's (value descending, id ascending), the values too."""
    rng = np.random.default_rng(40 + k)
    v = 300
    logits = (rng.standard_normal((4, v)) * 4).astype(np.float32)
    for row, tie_at in ((0, k - 1), (1, 0), (2, max(k - 2, 0))):
        order = np.argsort(-logits[row], kind="stable")
        # the value at the tie's place, copied onto that place and five
        # ids past it spread over the vocabulary, below and above it
        value = logits[row, order[tie_at]]
        logits[row, order[tie_at:tie_at + 3]] = value
        logits[row, rng.choice(v, 3, replace=False)] = value
    logits[3] = 1.5
    ids = logits.argmax(axis=1)
    want = jax_sampling.token_logprobs(jnp.asarray(logits), jnp.asarray(ids, jnp.int32), k)
    got = sampling.token_logprobs(torch.from_numpy(logits), torch.from_numpy(ids), k)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=0, atol=FN_TOL)
    assert got[1][:, 0].tolist() == ids.tolist()
    assert got[1][3].tolist() == list(range(k))


# -- TorchEngine against JaxEngine -------------------------------------------------


def _wave():
    """(id, prompt, sampling knobs): logprobs 20 and 0, a logit_bias row,
    min_tokens with a +100 bias on its stop id (exactly 6 tokens, then
    `stop`), a plain row, and a seeded sampled row whose every token a
    +100 bias forces (so both PRNGs give one stream)."""
    return [
        ("lp20", [5, 17, 42, 9, 3, 7, 11, 2], dict(max_tokens=9, logprobs=20, ignore_eos=True)),
        ("lp0", [9, 8, 7], dict(max_tokens=6, logprobs=0, ignore_eos=True)),
        ("bias", [200, 13, 1], dict(max_tokens=8, logit_bias=((77, 5.0), (13, -2.0)),
                                    logprobs=2, ignore_eos=True)),
        ("min", [33, 44, 55], dict(max_tokens=12, min_tokens=5, stop_token_ids=(STOP,),
                                   logit_bias=((STOP, 100.0),))),
        ("plain", [1, 2, 3, 4], dict(max_tokens=7, ignore_eos=True)),
        ("forced", [6, 5, 4], dict(max_tokens=7, temperature=0.8, seed=3, logprobs=1,
                                   logit_bias=((50, 100.0),), ignore_eos=True)),
    ]


def _late():
    """Prompts longer than the chunk of 16 (two pieces each): one
    penalized, one with logprobs 5."""
    rng = np.random.default_rng(5)
    return [
        ("pen", [int(x) for x in rng.integers(1, 200, 22)],
         dict(max_tokens=8, frequency_penalty=0.4, presence_penalty=0.3,
              repetition_penalty=1.5, logprobs=3, ignore_eos=True)),
        ("lp5", [int(x) for x in rng.integers(1, 200, 20)],
         dict(max_tokens=6, logprobs=5, ignore_eos=True)),
    ]


def _drive(eng, cls, base, late=(), late_at=3):
    """Run `base`, then `late` after `late_at` steps; returns request id ->
    {tokens, logprobs, tops, finish}."""
    for rid, prompt, kw in base:
        eng.add_request(rid, prompt, cls(**kw))
    out: dict = {}
    steps, added = 0, not late
    while eng.has_work or not added:
        for o in eng.step():
            d = out.setdefault(o.request_id, {"tokens": [], "lps": [], "tops": [],
                                              "finish": None})
            d["tokens"] += o.new_token_ids
            d["lps"] += o.logprobs or ()
            d["tops"] += o.top_logprobs or ()
            if o.finish_reason is not None:
                d["finish"] = o.finish_reason.value
        steps += 1
        if steps == late_at and not added:
            for rid, prompt, kw in late:
                eng.add_request(rid, prompt, cls(**kw))
            added = True
    return out


def _assert_same(got: dict, want: dict) -> None:
    """Streams and finishes identical; logprobs as many as tokens (for a
    request that asked), within LP_TOL, with identical top ids."""
    assert got.keys() == want.keys()
    for rid, w in want.items():
        g = got[rid]
        assert (g["tokens"], g["finish"]) == (w["tokens"], w["finish"]), rid
        assert len(g["lps"]) == len(w["lps"]) and len(g["tops"]) == len(w["tops"]), rid
        np.testing.assert_allclose(g["lps"], w["lps"], rtol=0, atol=LP_TOL, err_msg=rid)
        for gt, wt in zip(g["tops"], w["tops"]):
            assert [t for t, _ in gt] == [t for t, _ in wt], rid
            np.testing.assert_allclose([x for _, x in gt], [x for _, x in wt], rtol=0,
                                       atol=LP_TOL, err_msg=rid)


def _pair(**knobs):
    jax_eng = _jax_engine(**knobs)
    return jax_eng, _torch_engine(jax_eng, **knobs)


def _pallas_pair(**knobs):
    """The pair with the JAX engine's Pallas kernels in interpret mode, for
    the quantized pools, whose readers the XLA attention dequantizes in
    another order."""
    jax_eng = _jax_engine(attention_impl="pallas", **knobs)
    return jax_eng, _torch_engine(jax_eng, **knobs)


@pytest.mark.parametrize("decode_steps,overlap,mixed", [
    (1, False, False), (1, True, True), (8, False, True), (8, True, False)])
def test_streams_logprobs_and_keys_equal_the_jax_engines(decode_steps, overlap, mixed):
    """The wave, then two chunked prompts (one penalized) arriving while
    it decodes: streams, logprobs, finishes, overlap counters and step keys
    equal JaxEngine's. The min_tokens row stops exactly at its sixth token,
    inside a fused window at 8 steps and on a speculation with overlap."""
    jax_eng, port = _pair(decode_steps=decode_steps, overlap_decode=overlap,
                          mixed_steps=mixed)
    late_at = 3 if decode_steps == 1 else 1  # the wave is still decoding
    want = _drive(jax_eng, JaxSampling, _wave(), _late(), late_at)
    got = _drive(port, SamplingParams, _wave(), _late(), late_at)
    _assert_same(got, want)
    assert got["min"]["tokens"][-1] == STOP and len(got["min"]["tokens"]) == 6
    assert got["min"]["finish"] == "stop" and STOP not in got["min"]["tokens"][:5]
    assert got["forced"]["tokens"] == [50] * 7 and got["bias"]["lps"]
    assert not got["plain"]["lps"] and not got["lp0"]["tops"]
    assert len(got["lp20"]["tops"][0]) == 20 and len(got["pen"]["tops"][0]) == 3
    m, jm = port.metrics, jax_eng.metrics
    for name in ("overlap_dispatches", "overlap_hits", "overlap_rollbacks",
                 "mixed_dispatches", "decode_dispatches", "prefill_dispatches"):
        assert getattr(m, name) == getattr(jm, name), name
    # (at 8 steps a dispatch no short row outlives the next: nothing speculates)
    assert (m.overlap_hits > 0) == (overlap and decode_steps == 1)
    assert (m.mixed_dispatches > 0) == mixed
    keys = set(port.step_keys)
    assert keys == _project(jax_eng)
    # the keys' sampling fields: lp 20 over the wave, a penalty bucket and
    # the bias slots, each in some dispatch
    assert 20 in {key_field(k, "lp") for k in keys}
    assert any(key_field(k, "pen", 0) > 0 for k in keys)
    assert any(key_field(k, "bias") for k in keys)
    assert port._inflight is None and port.allocator.num_active == 0


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_every_pool_mode_equals_the_jax_engines(mode):
    """The wave and the late prompts over each quantized pool (the test
    above serves the model-dtype pool), with overlap and mixed steps on and
    4 fused steps."""
    jax_eng, port = _pallas_pair(decode_steps=4, overlap_decode=True, mixed_steps=True,
                                 kv_quantize=mode)
    _assert_same(_drive(port, SamplingParams, _wave(), _late()),
                 _drive(jax_eng, JaxSampling, _wave(), _late()))
    assert set(port.step_keys) == _project(jax_eng)


def test_prefix_hits_serve_logprobs_bias_and_penalties():
    """Caching on: a second wave over the first's prompts (extended past
    their pages) samples its first tokens from chunks with history under
    lp, pen and bias keys; everything equals JaxEngine's."""
    jax_eng, port = _pair(decode_steps=4, overlap_decode=True, mixed_steps=True,
                          enable_prefix_caching=True)
    first = [(rid, p + p, kw) for rid, p, kw in _wave()]
    again = [(f"{rid}2", p + [7, 7], {**kw, "frequency_penalty": 0.5}) for rid, p, kw in first]
    results = []
    for eng, cls in ((jax_eng, JaxSampling), (port, SamplingParams)):
        results.append({**_drive(eng, cls, first), **_drive(eng, cls, again)})
    _assert_same(results[1], results[0])
    assert port.metrics.prefix_hit_rate == jax_eng.metrics.prefix_hit_rate > 0
    assert set(port.step_keys) == _project(jax_eng)
    assert any(k[0] == "prefill" and not key_field(k, "first_chunk") and key_field(k, "lp") >= 0
               for k in port.step_keys)


def _preempted(eng, cls):
    """A penalized request preempted by hand after 4 steps (the
    scheduler's recompute path takes the youngest), then run to its end
    beside an older one."""
    eng.add_request("q", [8, 9], cls(max_tokens=10, presence_penalty=0.7, ignore_eos=True))
    eng.add_request("pp", [5, 6, 7], cls(max_tokens=12, frequency_penalty=500.0, logprobs=2))
    for _ in range(4):
        eng.step()
    req = next(r for r in eng.scheduler.running if r.request_id == "pp")
    n = len(req.output_tokens)
    eng.scheduler._preempt_youngest(excluding=None)
    assert req.num_emitted == n >= 1 and req.output_tokens == []
    out = _drive(eng, cls, [])
    return req.prompt_tokens[3:] + out["pp"]["tokens"], out


def test_penalty_history_survives_a_preemption():
    """The penalty history counts the tokens a preemption folded into the
    prompt (num_emitted): under a frequency penalty of 500 every token ever
    generated is distinct, and the resumed run equals JaxEngine's (its
    prefill samples under a penalty key)."""
    jax_eng, port = _pair(decode_steps=1)
    want_hist, want = _preempted(jax_eng, JaxSampling)
    got_hist, got = _preempted(port, SamplingParams)
    assert got_hist == want_hist and len(set(got_hist)) == len(got_hist)
    _assert_same(got, want)
    assert any(k[0] == "prefill" and key_field(k, "pen") > 0 for k in port.step_keys)
    assert set(port.step_keys) == _project(jax_eng)


def test_mixed_parity_with_penalties():
    """Penalty counts over both halves' rows of a mixed step
    (test_engine_mixed.py::test_mixed_parity_with_penalties): mixed on
    equals mixed off and JaxEngine's."""
    rng = np.random.default_rng(13)
    base = [("pen", [5, 6, 7], dict(max_tokens=14, ignore_eos=True, repetition_penalty=1.5,
                                    frequency_penalty=0.4))]
    late = [("late-pen", [int(x) for x in rng.integers(1, 200, 22)],
             dict(max_tokens=4, ignore_eos=True, presence_penalty=0.7))]
    jax_eng, port = _pair(decode_steps=1, mixed_steps=True)
    want = _drive(jax_eng, JaxSampling, base, late, late_at=4)
    got = _drive(port, SamplingParams, base, late, late_at=4)
    _assert_same(got, want)
    xor = _torch_engine(jax_eng, decode_steps=1, mixed_steps=False)
    assert _drive(xor, SamplingParams, base, late, late_at=4) == got
    assert port.metrics.mixed_dispatches > 0
    assert any(k[0] == "mixed" and key_field(k, "pen") > 0 for k in port.step_keys)


def test_penalties_fall_back_to_sync_and_logprobs_and_bias_speculate():
    """A penalized batch never speculates (its history needs the pending
    step's tokens on the host; test_penalties_fall_back_to_sync), and its
    stream is overlap's as without; logprob and bias batches speculate."""
    pen = SamplingParams(max_tokens=8, ignore_eos=True, repetition_penalty=1.5)
    streams = []
    for overlap in (False, True):
        eng = _torch_engine(decode_steps=1, overlap_decode=overlap)
        eng.add_request("pen", [5, 6, 7], pen)
        streams.append(eng.run_to_completion())
        assert eng.metrics.overlap_dispatches == 0
    assert streams[0] == streams[1]
    for kw in (dict(logprobs=3), dict(logit_bias=((4, 1.0),))):
        eng = _torch_engine(decode_steps=1, overlap_decode=True)
        eng.add_request("x", [5, 6, 7], SamplingParams(max_tokens=8, ignore_eos=True, **kw))
        eng.run_to_completion()
        assert eng.metrics.overlap_hits > 0, kw


def test_bias_refusals_at_admission_equal_the_jax_engines():
    """More slots than BIAS_SLOTS (logit_bias entries plus min_tokens'
    bans) and an id outside the vocabulary are refused by add_request, as
    JaxEngine refuses them; nothing was queued."""
    cases = [
        ("slots", dict(logit_bias=tuple((i, 1.0) for i in range(sampling.BIAS_SLOTS + 1)))),
        ("slots", dict(min_tokens=2, stop_token_ids=tuple(range(1, 18)))),
        ("vocab", dict(logit_bias=((99999, 1.0),))),
    ]
    jax_eng = _jax_engine()
    port = _torch_engine(jax_eng)
    for match, kw in cases:
        with pytest.raises(ValueError, match=match):
            jax_eng.add_request("x", [1, 2], JaxSampling(**kw))
        with pytest.raises(ValueError, match=match):
            port.add_request("x", [1, 2], SamplingParams(**kw))
    assert not port.has_work and port.metrics.requests_received == 0


# -- the port's engine alone (tests/test_logprobs.py, tests/test_logit_bias.py) ---


@pytest.fixture(scope="module")
def engine():
    return _torch_engine(decode_steps=4)


def _collect(eng, rid, prompt, sp):
    eng.add_request(rid, prompt, sp)
    return _drive(eng, SamplingParams, [])[rid]


def test_greedy_logprobs_describe_the_model(engine):
    """Greedy: each token is its own top-1 alternative with the same
    logprob; alternatives sorted; their mass at most 1."""
    out = _collect(engine, "g", [5, 17, 42, 99, 3], SamplingParams(max_tokens=6, logprobs=3))
    assert len(out["lps"]) == len(out["tops"]) == len(out["tokens"]) == 6
    for tok, lp, alts in zip(out["tokens"], out["lps"], out["tops"]):
        assert lp <= 1e-5 and len(alts) == 3
        assert alts[0] == (tok, lp)
        lps = [x for _, x in alts]
        assert lps == sorted(lps, reverse=True)
        assert sum(math.exp(x) for x in lps) <= 1.0 + 1e-4


def test_logprobs_off_chosen_only_and_only_for_requesters(engine):
    off = _collect(engine, "off", [1, 2, 3], SamplingParams(max_tokens=3))
    assert len(off["tokens"]) == 3 and off["lps"] == off["tops"] == []
    chosen = _collect(engine, "c", [9, 9, 9], SamplingParams(max_tokens=3, logprobs=0))
    assert len(chosen["lps"]) == 3 and chosen["tops"] == []
    engine.add_request("a", [4, 4, 4, 4], SamplingParams(max_tokens=3, logprobs=1))
    engine.add_request("b", [6, 6, 6, 6], SamplingParams(max_tokens=3))
    both = _drive(engine, SamplingParams, [])
    assert len(both["a"]["lps"]) == 3 and both["b"]["lps"] == []


def test_sampled_logprobs_are_unscaled(engine):
    """The temperature shapes the draw, not the reported logprob: top_k=1
    draws the greedy token, with the greedy run's logprob."""
    g = _collect(engine, "g1", [7, 8, 9, 10], SamplingParams(max_tokens=1, logprobs=0))
    s = _collect(engine, "s1", [7, 8, 9, 10], SamplingParams(max_tokens=1, logprobs=0,
                                                             temperature=0.5, seed=1, top_k=1))
    assert s["tokens"] == g["tokens"] and abs(s["lps"][0] - g["lps"][0]) < LP_TOL


def test_a_ban_changes_the_greedy_token_and_a_bias_free_row_keeps_it(engine):
    """-100 on greedy's first choice changes it; a row beside it without a
    bias keeps its own (tests/test_logit_bias.py::test_logit_bias_ban_changes_output)."""
    prompt = [5, 17, 42, 9, 3, 8]
    first = _collect(engine, "ref", prompt, SamplingParams(max_tokens=1, ignore_eos=True))
    engine.add_request("ban", prompt, SamplingParams(max_tokens=1, ignore_eos=True,
                                                     logit_bias=((first["tokens"][0], -100.0),)))
    engine.add_request("plain", prompt, SamplingParams(max_tokens=1, ignore_eos=True))
    both = _drive(engine, SamplingParams, [])
    assert both["ban"]["tokens"] != first["tokens"] == both["plain"]["tokens"]


@pytest.mark.parametrize("decode_steps", [1, 8])
def test_repetition_and_frequency_penalties_break_repetition(decode_steps):
    """A greedy run that repeats never repeats under a repetition penalty
    of 1e9 or a frequency penalty of 500, through fused steps too; a
    penalty of 1 is no penalty."""
    def run(**kw):
        eng = _torch_engine(decode_steps=decode_steps)
        eng.add_request("r", [3, 1, 4, 1, 5], SamplingParams(max_tokens=12, **kw))
        return eng.run_to_completion()["r"]

    base = run()
    assert len(set(base)) < len(base)
    for kw in (dict(repetition_penalty=1e9), dict(frequency_penalty=500.0)):
        toks = run(**kw)
        assert len(toks) == 12 and len(set(toks)) == 12, kw
    assert run(repetition_penalty=1.0) == base
