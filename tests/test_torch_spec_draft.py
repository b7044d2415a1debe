"""The port's draft-model speculation (EngineConfig.spec_draft_model), on the CPU.

A decode dispatch, key ("spec_fused", bucket, S + 1, greedy, pen, bias),
runs the draft's catch-up over the tokens accepted since its last
dispatch, S greedy proposals, the target's verify and the acceptance scan
in one step function; the draft keeps a KV pool of its own, brought up to
each prefill piece's end by chunk steps ("spec_draft_prefill", B, T,
first_chunk). The cases are the JAX package's (tests/test_spec_draft.py),
plus the policy (K-step windows off, the CLI flags, a draft checkpoint
reaching the config), windows that start mid-page in both pools, and a
prefix hit, whose cached pages the draft's cover writes again in the
draft pool only. Both engines run the tiny config in float32 on the JAX
engine's weights; a distinct draft is a second tiny tree drawn from
another key, given to both engines (the JAX engine's `draft_params` after
construction, the port's `draft_params=`). In every greedy case against
JaxEngine, streams, step keys (projected by
tests/test_torch_mixed.py::_project) and the spec, dispatch and overlap
counters must be equal, and greedy streams equal the port's own without
speculation. Sampled streams are the port's own (its noise is not JAX's
PRNG): seeded streams must not depend on overlap or mixed steps, and the
accept step must keep the sampler's distribution.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.engine import JaxEngine
from dynamo_tpu.engine.request import SamplingParams as JaxSampling
from dynamo_tpu.models import llama as jllama
from dynamo_tpu_torch.cli import run as cli_run
from dynamo_tpu_torch.engine.config import UNPORTED, EngineConfig
from dynamo_tpu_torch.engine.engine import TorchEngine, key_field
from dynamo_tpu_torch.engine.request import Request, SamplingParams
from dynamo_tpu_torch.engine.sampling import (
    DEFAULT_K_CAP,
    accept_uniforms,
    gumbel_noise,
    sample,
    spec_accept_step,
)
from dynamo_tpu_torch.models import llama as tllama
from dynamo_tpu_torch.models.registry import get_model
from tests.test_spec_draft import _exact_p_eff
from tests.test_torch_kstep import _drive
from tests.test_torch_mixed import _project

COUNTERS = ("spec_drafted", "spec_accepted", "spec_skipped_ineligible", "spec_skipped_cooldown",
            "prefill_dispatches", "decode_dispatches", "mixed_dispatches",
            "overlap_dispatches", "overlap_hits", "overlap_rollbacks", "kstep_windows")
#: the JAX package's draft knobs (tests/test_spec_draft.py::_mk_spec)
SPEC = dict(spec_draft_model="tiny", spec_draft_tokens=3)
#: the JAX package's prompts: one that repeats, one that does not, one short
PROMPTS = [[1, 2, 3, 4, 1, 2, 3, 4, 1, 2], [9, 8, 7, 6, 5], [3, 3]]
DRAFTS = ["self", "other"]


def _tree(jax_tree) -> dict:
    return tllama.params_from_jax(jax.tree.map(np.asarray, jax_tree), tllama.LlamaConfig.tiny(),
                                  device="cpu")


def _engines(draft: str = "self", **knobs):
    """JaxEngine at its test config with SPEC and `knobs`, and the port on
    its weights with the same knobs (prefix caching and mixed steps as
    the JAX config has them). Draft "other": both engines draft with a
    second tiny tree, drawn from another key."""
    knobs = {**SPEC, **knobs}
    jax_eng = JaxEngine(JaxEngineConfig.for_tests(**knobs))
    draft_params = None
    if draft == "other":
        jax_eng.draft_params = jax_eng.draft_adapter.init_params(jax.random.key(7))
        draft_params = _tree(jax_eng.draft_params)
    cfg = EngineConfig.for_tests(**{"enable_prefix_caching": jax_eng.config.enable_prefix_caching,
                                    "mixed_steps": jax_eng.config.mixed_steps, **knobs})
    return jax_eng, TorchEngine(cfg, params=_tree(jax_eng.params), device="cpu",
                                draft_params=draft_params)


def _plain(jax_eng, **knobs) -> TorchEngine:
    """The port without speculation on the JAX engine's weights."""
    cfg = dataclasses.replace(EngineConfig.for_tests(**{**SPEC, **knobs}), spec_draft_model=None,
                              enable_prefix_caching=jax_eng.config.enable_prefix_caching)
    return TorchEngine(cfg, params=_tree(jax_eng.params), device="cpu")


def _greedy(prompts, max_tokens=12, tag="r", **kw):
    return [(f"{tag}{i}", p, dict(max_tokens=max_tokens, **kw)) for i, p in enumerate(prompts)]


def _counters(eng) -> dict:
    return {c: getattr(eng.metrics, c) for c in COUNTERS}


def _assert_like_jax(port, jax_eng, got, want):
    """Streams, projected step keys and counters equal JaxEngine's, and
    the port ends idle with nothing in flight and every page back."""
    assert got == want
    assert set(port.step_keys) == _project(jax_eng)
    assert _counters(port) == _counters(jax_eng)
    assert port._inflight is None and port._inflight_spec is None
    assert port.allocator.num_active == 0


def _staggered():
    """The JAX package's composition workload (tests/test_spec_draft.py::
    _drive_staggered): two rows, then two more after three steps (mixed
    steps where on)."""
    work = [("r0", [1, 2, 3, 4, 1, 2, 3, 4], dict(max_tokens=14)),
            ("r1", [9, 8, 7], dict(max_tokens=14))]
    late = [("r2", list(range(1, 14)), dict(max_tokens=10)),
            ("r3", [4, 4, 4, 4, 2], dict(max_tokens=10))]
    return work, late


# -- the knobs, the preset and the policy -------------------------------------------


def test_knobs_reach_the_config_and_the_checkpoint_is_refused():
    """spec_draft_model, spec_draft_tokens and spec_draft_checkpoint are
    ported (defaults None, 4 and None), and the CLI's --spec-draft,
    --spec-draft-tokens and --spec-draft-checkpoint reach them (the
    checkpoint's loading is tests/test_torch_checkpoint.py's); no draft
    knob is refused any more. The name is kept from when the draft
    checkpoint had no loader and was refused: the test now checks that
    it reaches the config."""
    cfg = EngineConfig.for_tests()
    assert (cfg.spec_draft_model, cfg.spec_draft_tokens, cfg.spec_draft_checkpoint) == \
        (None, 4, None)
    assert not {"spec_draft_model", "spec_draft_tokens", "spec_draft_checkpoint"} \
        & UNPORTED.keys()
    args = cli_run._parse(["run", "--spec-draft", "llama3-draft", "--spec-draft-tokens", "3"])
    cfg = cli_run.engine_config(args, ())
    assert (cfg.spec_draft_model, cfg.spec_draft_tokens) == ("llama3-draft", 3)
    default = cli_run.engine_config(cli_run._parse(["run"]), ())
    assert (default.spec_draft_model, default.spec_draft_tokens) == (None, 4)
    assert EngineConfig.for_tests(spec_draft_model="tiny", spec_draft_checkpoint="/ckpt") \
        .spec_draft_checkpoint == "/ckpt"
    cfg = cli_run.engine_config(cli_run._parse(["run", "--spec-draft", "tiny",
                                                "--spec-draft-checkpoint", "/ckpt"]), ())
    assert cfg.spec_draft_checkpoint == "/ckpt"


def test_spec_modes_mutually_exclusive():
    with pytest.raises(ValueError, match="mutually exclusive"):
        EngineConfig.for_tests(spec_draft_model="tiny", spec_ngram=4)
    with pytest.raises(ValueError, match="spec_draft_tokens"):
        EngineConfig.for_tests(spec_draft_model="tiny", spec_draft_tokens=0)


def test_spec_draft_vocab_mismatch_refused():
    """llama3-draft (128,256 ids) cannot draft for tiny (256), in either
    engine; the port refuses before it draws the draft's weights."""
    with pytest.raises(ValueError, match="vocab"):
        JaxEngine(JaxEngineConfig.for_tests(spec_draft_model="llama3-draft"))
    with pytest.raises(ValueError, match="vocab"):
        TorchEngine(EngineConfig.for_tests(spec_draft_model="llama3-draft"), device="cpu")


def test_the_llama3_draft_preset_matches_the_jax_one():
    """The preset's fields are the JAX package's (dtype aside), and its
    shapes (8 query heads over 4 KV heads of 64, tied embeddings) run the
    port's forward on a tree carried over by params_from_jax, at a vocab
    of 256: a first chunk, then a chunk whose rows start on a page and
    mid-page, landed token by token (write_run=1): logits and each history's K/V
    within 1e-4 of the JAX forward's."""
    j = jllama.LlamaConfig.llama3_draft()
    t = get_model("llama3-draft").config
    assert get_model("llama3-draft").vocab_size == 128256
    for f in dataclasses.fields(t):
        if f.name != "dtype":
            assert getattr(t, f.name) == getattr(j, f.name), f.name
    jcfg = dataclasses.replace(j, vocab_size=256, dtype=jnp.float32)
    tcfg = dataclasses.replace(t, vocab_size=256, dtype=torch.float32)
    np_params = jax.tree.map(np.asarray, jllama.init_params(jax.random.key(5), jcfg))
    params = tllama.params_from_jax(np_params, tcfg, device="cpu")
    assert set(params) == {"embed", "layers", "final_norm"}  # tied
    jparams = jax.tree.map(jnp.asarray, np_params)
    b, s, mp, num_pages = 2, 4, 8, 20
    rng = np.random.default_rng(8)
    pt = (1 + rng.permutation(num_pages - 1)[: b * mp]).reshape(b, mp).astype(np.int32)
    starts = np.asarray([8, 6], np.int32)  # the second chunk on a page, mid-page
    jkv = jllama.init_kv_pages(jcfg, num_pages, s)
    tkv = tllama.init_kv_pages(tcfg, num_pages, s, device="cpu")
    for first, t_len, start, n in ((True, 16, np.zeros(b, np.int32), starts),
                                   (False, 8, starts, np.full(b, 5))):
        tokens = rng.integers(1, 256, (b, t_len))
        positions = (start[:, None] + np.arange(t_len, dtype=np.int32)).astype(np.int32)
        valid = np.arange(t_len)[None] < n[:, None]
        jlogits, jkv = jllama.forward(jparams, jcfg, *map(jnp.asarray, (tokens, positions, valid)),
                                      jkv, jnp.asarray(pt), first_chunk=first)
        tlogits, tkv = tllama.forward(params, tcfg, *map(torch.from_numpy,
                                                          (tokens, positions, valid)),
                                      tkv, torch.from_numpy(pt), first_chunk=first,
                                      write_run=None if first else 1)
        np.testing.assert_allclose(tlogits.numpy()[valid], np.asarray(jlogits)[valid], atol=1e-4)
    ref = tllama.kv_pages_from_jax(np.asarray(jkv.k), np.asarray(jkv.v), tcfg, device="cpu")
    for i, n in enumerate(starts + 5):
        pos = np.arange(n)
        pages, slots = pt[i, pos // s], pos % s
        for got, want in ((tkv.k, ref.k), (tkv.v, ref.v)):
            np.testing.assert_allclose(got[:, pages, slots].numpy(),
                                       want[:, pages, slots].numpy(), atol=1e-4)


def test_spec_draft_disables_kstep():
    """The draft-model mode batches steps per dispatch already:
    decode_kstep auto-disables with streams unchanged, as in JaxEngine;
    overlap and mixed steps stay on."""
    jax_eng, port = _engines(decode_kstep=8)
    assert not port._kstep_enabled and not jax_eng._kstep_enabled
    assert port._overlap_enabled and port.scheduler.mixed_enabled
    work = [("g", [7, 8, 9, 7, 8], dict(max_tokens=8, ignore_eos=True))]
    got = _drive(port, SamplingParams, work)
    _assert_like_jax(port, jax_eng, got, _drive(jax_eng, JaxSampling, work))
    assert port.metrics.kstep_windows == 0 and port.metrics.spec_drafted > 0


def test_pools_and_weights_under_quantization():
    """The draft pool is the model dtype under kv_quantize, its bytes in
    kv_pool_bytes; under quantize="int8" a self-draft shares the int8
    tree and a given draft tree stays as given; both serve."""
    eng = TorchEngine(EngineConfig.for_tests(kv_quantize="int8", **SPEC), device="cpu")
    assert eng.draft_kv.k.dtype == torch.float32 and eng.kv.k.dtype == torch.int8
    draft_bytes = sum(x.numel() * x.element_size() for x in eng.draft_kv if x is not None)
    target_bytes = sum(x.numel() * x.element_size() for x in eng.kv if x is not None)
    assert eng.metrics.kv_pool_bytes == target_bytes + draft_bytes
    own = TorchEngine(EngineConfig.for_tests(quantize="int8", **SPEC), device="cpu")
    assert own.draft_params is own.params
    assert own.draft_params["layers"]["wq"].dtype == torch.int8
    tree = _tree(jllama.init_params(jax.random.key(7), jllama.LlamaConfig.tiny()))
    given = TorchEngine(EngineConfig.for_tests(quantize="int8", **SPEC), device="cpu",
                        draft_params=tree)
    assert given.draft_params is tree and tree["layers"]["wq"].dtype == torch.float32
    for e in (eng, own, given):
        e.add_request("q", [5, 6, 7, 8, 5], SamplingParams(max_tokens=6, ignore_eos=True))
        assert len(e.run_to_completion()["q"]) == 6
        assert e.metrics.spec_drafted > 0
    with pytest.raises(ValueError, match="draft_params"):
        TorchEngine(EngineConfig.for_tests(), device="cpu", draft_params=tree)


# -- greedy streams against JaxEngine and the port without speculation -------------


@pytest.mark.parametrize("draft", DRAFTS)
def test_spec_draft_matches_plain_greedy_exactly(draft):
    """The JAX package's prompts: streams, keys and counters equal
    JaxEngine's, streams equal the port's without speculation; a
    self-draft accepts more than half its drafts."""
    work = _greedy(PROMPTS)
    jax_eng, port = _engines(draft)
    got = _drive(port, SamplingParams, work)
    _assert_like_jax(port, jax_eng, got, _drive(jax_eng, JaxSampling, work))
    assert _drive(_plain(jax_eng), SamplingParams, work) == got
    m = port.metrics
    assert m.spec_drafted > 0
    if draft == "self":
        assert m.spec_accepted > m.spec_drafted // 2
    assert any(k[0] == "spec_fused" and key_field(k, "t") == 4 for k in port.step_keys)


def test_spec_draft_greedy_with_penalties_and_bias_bit_exact():
    """Greedy rows with frequency, presence and repetition penalties,
    logit_bias and min_tokens speculate (none is ineligible), and their
    streams equal JaxEngine's and the port's without speculation."""
    sp = dict(max_tokens=10, frequency_penalty=0.5, presence_penalty=0.2,
              repetition_penalty=1.2, logit_bias=((5, 3.0),), min_tokens=3)
    work = [("p", [1, 2, 3, 4], sp), ("q", [6, 2, 6, 2, 6], dict(max_tokens=9, min_tokens=4))]
    jax_eng, port = _engines()
    got = _drive(port, SamplingParams, work)
    _assert_like_jax(port, jax_eng, got, _drive(jax_eng, JaxSampling, work))
    assert _drive(_plain(jax_eng), SamplingParams, work) == got
    m = port.metrics
    assert m.spec_drafted > 0 and m.spec_skipped_ineligible == 0
    assert any(k[0] == "spec_fused" and key_field(k, "pen") and key_field(k, "bias")
               for k in port.step_keys)


def test_spec_draft_stops_at_eos_and_max_tokens():
    """max_tokens 3 inside the first window, a stop id (the plain stream's
    6th token) and, in a second engine, eos as well: each stream ends where
    the plain one ends, and equals JaxEngine's."""
    p = [2, 4, 6, 8, 2, 4, 6, 8]
    probe = _plain(JaxEngine(JaxEngineConfig.for_tests()))
    stream = _drive(probe, SamplingParams, [("a", p, dict(max_tokens=12))])["a"]
    stop, eos = stream[5], stream[-1]

    def cut(n, *ids):
        return stream[: min([n] + [stream.index(i) + 1 for i in ids])]

    work = [("len", p, dict(max_tokens=3)),
            ("stop", p, dict(max_tokens=12, stop_token_ids=(stop,)))]
    for knobs in ({}, dict(eos_token_ids=(eos,))):
        jax_eng, port = _engines(**knobs)
        got = _drive(port, SamplingParams, work)
        _assert_like_jax(port, jax_eng, got, _drive(jax_eng, JaxSampling, work))
        eos_ids = knobs.get("eos_token_ids", ())
        assert got == {"len": cut(3, *eos_ids), "stop": cut(12, stop, *eos_ids)}
        assert len(got["len"]) == 3 and len(got["stop"]) < 12


def test_spec_draft_logprobs_fall_back_plain():
    """A logprob row makes its batch ineligible: plain decode dispatches,
    no draft; then the greedy row alone speculates; as JaxEngine's."""
    work = [("l", [1, 2, 3], dict(max_tokens=4, logprobs=0)),
            ("g", PROMPTS[0], dict(max_tokens=10))]
    jax_eng, port = _engines()
    assert not port._spec_eligible([Request("x", [1], SamplingParams(logprobs=2))])
    assert port._spec_eligible([Request("y", [1], SamplingParams(
        temperature=0.7, frequency_penalty=0.5, logit_bias=((3, 1.0),), min_tokens=2))])
    got = _drive(port, SamplingParams, work)
    _assert_like_jax(port, jax_eng, got, _drive(jax_eng, JaxSampling, work))
    assert len(got["l"]) == 4 and port.metrics.spec_skipped_ineligible > 0


# -- the accept step: the sampler's distribution ----------------------------------


@pytest.mark.parametrize("draft_tok", [0, 3, 11])
def test_rejection_sampling_preserves_target_distribution(draft_tok):
    """The emitted token's marginal over 20,000 seeded draws equals the
    exact numpy p_eff (temperature, top-k_cap candidates, top-p/top-k),
    within 5 standard errors + 2e-3, for a draft in the mass (0), mid-mass
    (3) and outside the kept set (11); acceptance equals p_eff(draft)
    within 0.02, and tokens of no mass never come."""
    rng = np.random.default_rng(1)
    v, n = 12, 20000
    row_logits = np.asarray(sorted(rng.normal(0, 2.0, v), reverse=True), np.float32)
    temp, top_p, top_k = 0.9, 0.85, 8
    p_exact = _exact_p_eff(row_logits, temp, top_p, top_k)
    seeds, counters = list(range(n)), [0] * n
    chosen, accept = spec_accept_step(
        torch.from_numpy(row_logits).expand(n, v), torch.full((n,), draft_tok), True,
        torch.full((n,), temp), torch.full((n,), top_p), torch.full((n,), top_k),
        gumbel_noise(seeds, counters, DEFAULT_K_CAP)[0], accept_uniforms(seeds, counters)[0])
    emp = np.bincount(chosen.numpy(), minlength=v) / n
    tol = 5 * np.sqrt(p_exact * (1 - p_exact) / n) + 2e-3
    assert np.all(np.abs(emp - p_exact) < tol), (emp, p_exact)
    assert abs(accept.float().mean().item() - p_exact[draft_tok]) < 0.02
    if p_exact[draft_tok] == 0.0:
        assert not np.any(chosen.numpy() == draft_tok)
    assert emp[p_exact == 0.0].sum() == 0.0


def test_bonus_position_draw_is_bit_identical_to_plain_sampler():
    """Without a draft the accept step draws `sample`'s token with the
    same noise, bit for bit, and accepts; greedy rows take the argmax
    and accept iff it is the draft; the accept uniforms are not the
    Gumbel stream's."""
    rng = np.random.default_rng(2)
    b, v = 64, 32
    logits = torch.from_numpy(rng.normal(0, 2.0, (b, v)).astype(np.float32))
    temps = torch.full((b,), 0.8).masked_fill(torch.arange(b) % 8 == 0, 0.0)
    top_ps, top_ks = torch.full((b,), 0.9), torch.zeros(b, dtype=torch.int64)
    seeds, counters = list(range(b)), [3 * i for i in range(b)]
    noise = gumbel_noise(seeds, counters, DEFAULT_K_CAP)[0]
    plain = sample(logits, temps, top_ps, top_ks, noise)
    bonus, acc = spec_accept_step(logits, torch.zeros(b, dtype=torch.int64), False, temps,
                                  top_ps, top_ks, noise, torch.zeros(b))
    assert torch.equal(plain, bonus) and bool(acc.all())
    greedy = temps <= 0
    argmax = logits.argmax(-1)
    draft = torch.where(torch.arange(b) % 16 == 0, argmax, (argmax + 1) % v)
    chosen, acc = spec_accept_step(logits, draft, True, temps, top_ps, top_ks, noise,
                                   accept_uniforms(seeds, counters)[0])
    assert torch.equal(chosen[greedy], argmax[greedy])
    assert torch.equal(acc[greedy], (draft == argmax)[greedy])
    # the Gumbel stream's first uniforms, rebuilt from its noise
    assert not torch.allclose(accept_uniforms(seeds, counters)[0],
                              torch.exp(-torch.exp(-noise[:, 0])))


# -- seeded sampled streams ----------------------------------------------------------


def test_spec_draft_sampled_deterministic_per_seed():
    outs = []
    for _ in range(2):
        _, port = _engines()
        outs.append(_drive(port, SamplingParams,
                           _greedy(PROMPTS, max_tokens=10, temperature=0.8, seed=11)))
    assert outs[0] == outs[1]


@pytest.mark.parametrize("always", [False, True], ids=["reference", "always"])
def test_spec_sampled_stream_invariant_across_pipeline_toggles(always):
    """Seeded sampled streams are the same with overlap and mixed steps on
    and off: the chained dispatch's noise, picked on the device by the
    pending one's accepted count, is the noise a host-fed dispatch uses.
    "reference": the JAX package's case (its prompts together, the
    defaults). "always": spec_min_accept_rate 0, so no cooldown runs and
    every decode dispatch is a draft-model one, over sampled rows, a
    greedy one and two late arrivals (mixed steps where on), and the
    chained dispatches land. (With the cooldown on, late arrivals move
    which counters a plain draw takes, and a plain draw is not the accept
    step's, so that case is not invariant, in the JAX engine either.)"""
    knobs = dict(spec_min_accept_rate=0.0) if always else {}
    work = _greedy(PROMPTS, max_tokens=10, temperature=0.7, seed=5)
    late = ()
    if always:
        work = _greedy(PROMPTS, max_tokens=12, temperature=0.7, seed=5, ignore_eos=True)
        work += [("g", [5, 9, 5, 9], dict(max_tokens=12, ignore_eos=True)),
                 ("cool", [3, 1, 3, 1, 3], dict(max_tokens=12, temperature=0.2, seed=9,
                                                ignore_eos=True))]
        late = _greedy([list(range(20, 38)), [7, 7, 8]], max_tokens=8, tag="late",
                       temperature=0.9, top_p=0.9, top_k=20, seed=21, ignore_eos=True)
    outs = {}
    for overlap in (False, True):
        for mixed in (False, True):
            _, port = _engines(overlap_decode=overlap, mixed_steps=mixed, **knobs)
            outs[(overlap, mixed)] = _drive(port, SamplingParams, work, late, late_at=3)
            m = port.metrics
            assert m.spec_drafted > 0 and port.allocator.num_active == 0
            if always:
                # rows accept drafts, so chained dispatches pick their noise
                # at varied offsets
                assert m.spec_accepted > 0 and (m.overlap_hits > 0) == overlap
            if mixed and always:
                assert m.mixed_dispatches > 0
    vals = list(outs.values())
    assert all(v == vals[0] for v in vals), outs


# -- composition: overlap x mixed x preemption x prefix caching ----------------------


@pytest.mark.parametrize("mixed", [False, True], ids=["xor", "mixed"])
@pytest.mark.parametrize("overlap", [False, True], ids=["sync", "overlap"])
@pytest.mark.parametrize("draft", DRAFTS)
def test_spec_composition_matrix_bit_exact_and_pages_clean(draft, overlap, mixed):
    """The staggered workload: streams, keys and counters equal
    JaxEngine's in every cell, streams equal the port's without
    speculation, every page comes back; mixed steps ran where on, chained
    dispatches landed under overlap with the self-draft, and the
    disagreeing draft cooled down."""
    work, late = _staggered()
    jax_eng, port = _engines(draft, overlap_decode=overlap, mixed_steps=mixed)
    got = _drive(port, SamplingParams, work, late, late_at=3)
    _assert_like_jax(port, jax_eng, got, _drive(jax_eng, JaxSampling, work, late, late_at=3))
    plain = _plain(jax_eng, overlap_decode=False, mixed_steps=False)
    assert _drive(plain, SamplingParams, work, late, late_at=3) == got
    m = port.metrics
    assert m.spec_drafted > 0
    if mixed:
        assert m.mixed_dispatches > 0
    if draft == "other":
        assert m.spec_skipped_cooldown > 0
    elif overlap:
        assert m.overlap_hits > 0


def test_spec_draft_preemption_resume_matches_plain():
    """Page pressure preempts by recompute: the draft pool is covered again
    from 0 on re-admission (spec_draft_pos reset), and streams equal
    JaxEngine's and the port's without speculation under the same
    pressure."""
    over = dict(num_pages=12, max_pages_per_seq=8, max_seqs=4)
    work = _greedy([[1, 2, 3, 4, 5, 6], [7, 8, 9, 1], [2, 4, 6, 8]])
    jax_eng, port = _engines(**over)
    resets = []
    preempt = port.scheduler._preempt_youngest

    def spy(*a, **kw):
        ok = preempt(*a, **kw)
        resets.extend(r.spec_draft_pos for r in port.scheduler.waiting)
        return ok

    port.scheduler._preempt_youngest = spy
    got = _drive(port, SamplingParams, work)
    _assert_like_jax(port, jax_eng, got, _drive(jax_eng, JaxSampling, work))
    assert _drive(_plain(jax_eng, **over), SamplingParams, work) == got
    assert port.scheduler.preemptions == jax_eng.scheduler.preemptions > 0
    assert resets and set(resets) == {0}


def test_spec_draft_with_prefix_cache_and_chunked_prefill():
    """A 22-token prompt in chunks of 8, then again onto its cached pages:
    the draft's cover runs over the cached region the target skipped, both
    streams are equal, and equal JaxEngine's."""
    knobs = dict(enable_prefix_caching=True, prefill_chunk=8)
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


def test_a_hit_rewrites_the_draft_pools_cached_pages_only():
    """Queue 3's difference to know: a prefix hit's draft cover writes its
    cached pages again in the draft pool (the same tokens at the same
    positions; the pages hold the target's KV only), from position 0,
    while the target pool's registered pages keep their bytes (the
    invariant that no target write lands in a cached page)."""
    knobs = dict(enable_prefix_caching=True, prefill_chunk=8)
    prompt = list(range(1, 12)) + list(range(1, 12))
    _, port = _engines(**knobs)
    _drive(port, SamplingParams, [("warm", prompt, dict(max_tokens=4))])
    cached = sorted(port.allocator._page_meta)
    assert len(cached) == 5  # the prompt's whole pages (a finished row registers no more)
    before = [x[:, cached].clone() for x in (port.kv.k, port.kv.v)]
    draft_before = [x[:, cached].clone() for x in (port.draft_kv.k, port.draft_kv.v)]
    covers = []
    cover = port._spec_draft_cover

    def spy(spans):
        covers.extend((r, r.spec_draft_pos, upto) for r, upto in spans)
        cover(spans)

    port._spec_draft_cover = spy
    _drive(port, SamplingParams, [("hit", prompt, dict(max_tokens=4))])
    hit = [(r, pos, upto) for r, pos, upto in covers if r.request_id == "hit"]
    cached_tokens = hit[0][0].num_cached_prompt_tokens
    assert cached_tokens == 20 and hit[0][1:] == (0, 22)  # from 0, over the hit
    for x, b in zip((port.kv.k, port.kv.v), before):
        assert torch.equal(x[:, cached], b)
    # the rewrite lands the same K/V (same tokens, positions, weights)
    for x, b in zip((port.draft_kv.k, port.draft_kv.v), draft_before):
        torch.testing.assert_close(x[:, cached], b, atol=1e-5, rtol=1e-5)


# -- windows that start mid-page, in both pools ---------------------------------------


@pytest.mark.parametrize("draft", DRAFTS)
def test_windows_across_pages_land_the_jax_engines_kv_in_both_pools(draft):
    """Pages of 4 tokens, S = 3: catch-up windows start at spec_draft_pos,
    verifies at num_tokens - 1, both mid-page and crossing pages; a
    disagreeing draft cools down, and its pool is then brought up to date
    in decode from a position inside a page. After every step, each
    committed slot holds JaxEngine's K/V: the target's below
    num_computed_tokens, the draft's below spec_draft_pos."""
    jax_eng, port = _engines(draft, enable_prefix_caching=False, spec_cooldown_steps=4,
                             overlap_decode=False, decode_steps=1)
    rng = np.random.default_rng(7)
    work = _greedy([[int(x) for x in rng.integers(1, 250, 5 + 2 * i)] for i in range(3)],
                   max_tokens=20, ignore_eos=True)
    for eng, cls in ((jax_eng, JaxSampling), (port, SamplingParams)):
        for rid, prompt, kw in work:
            eng.add_request(rid, prompt, cls(**kw))
    mid_covers = []
    cover = port._spec_draft_cover

    def spy(spans):
        mid_covers.extend(r.spec_draft_pos % 4 for r, _ in spans
                          if r.state.value == "decode" and r.spec_draft_pos % 4)
        cover(spans)

    port._spec_draft_cover = spy
    got, want = {}, {}
    ps = port.config.page_size
    while port.has_work:
        for eng, out in ((jax_eng, want), (port, got)):
            for o in eng.step():
                out.setdefault(o.request_id, []).extend(o.new_token_ids)
        for r, jr in zip(port.scheduler.running, jax_eng.scheduler.running):
            assert r.pages == jr.pages and r.spec_draft_pos == jr.spec_draft_pos
            for pool, jpool, n in ((port.kv, jax_eng.kv, r.num_computed_tokens),
                                   (port.draft_kv, jax_eng.draft_kv, r.spec_draft_pos)):
                pos = np.arange(n)
                pages = np.asarray(r.pages)[pos // ps]
                for mine, theirs in ((pool.k, jpool.k), (pool.v, jpool.v)):
                    np.testing.assert_allclose(
                        mine.numpy()[:, pages, pos % ps],
                        np.asarray(theirs)[:, pages, pos % ps][..., : mine.shape[-1]],
                        atol=1e-5, rtol=1e-5)
    _assert_like_jax(port, jax_eng, got, want)
    if draft == "other":
        assert port.metrics.spec_skipped_cooldown > 0 and mid_covers


# -- the cooldown and the counters ------------------------------------------------------


def test_spec_draft_cooldown_on_disagreeing_draft():
    """A draft of other weights accepts at chance: a dispatch under
    spec_min_accept_rate sets the cooldown, the next decode dispatches run
    the plain path (counted as cooldown), then the draft is probed again;
    as JaxEngine's, step by step, and the stream equals the plain one."""
    knobs = dict(spec_cooldown_steps=4, decode_steps=1)
    jax_eng, port = _engines("other", **knobs)
    for eng, cls in ((jax_eng, JaxSampling), (port, SamplingParams)):
        eng.add_request("m", [11, 7, 23, 5, 17, 3, 9], cls(max_tokens=16))
    trace = {}
    out = {}
    for name, eng in (("jax", jax_eng), ("port", port)):
        trace[name] = []
        while eng.has_work:
            for o in eng.step():
                out.setdefault(name, []).extend(o.new_token_ids)
            trace[name].append((eng._spec_cooldown, *_counters(eng).values()))
    assert trace["port"] == trace["jax"] and out["port"] == out["jax"]
    assert set(port.step_keys) == _project(jax_eng)
    plain = _plain(jax_eng, decode_steps=1)
    assert _drive(plain, SamplingParams, [("m", [11, 7, 23, 5, 17, 3, 9],
                                           dict(max_tokens=16))])["m"] == out["port"]
    m = port.metrics
    assert m.spec_accepted / m.spec_drafted < port.config.spec_min_accept_rate
    assert m.spec_skipped_cooldown > 0
    cooldown = [t[0] for t in trace["port"]]
    assert 4 in cooldown and 0 in cooldown[cooldown.index(4):]


def test_spec_counters_and_gauge_surface():
    """The counters advance (0 <= accepted <= drafted), the windowed rate
    is accepted / drafted and equals JaxEngine's, and each dispatch key
    was captured as a step function and counted in the replays' kinds."""
    jax_eng, port = _engines()
    work = _greedy(PROMPTS)
    _assert_like_jax(port, jax_eng, _drive(port, SamplingParams, work),
                     _drive(jax_eng, JaxSampling, work))
    m = port.metrics
    assert 0 < m.spec_accepted <= m.spec_drafted
    assert 0.0 < m.spec_accept_rate <= 1.0
    assert m.spec_accept_rate == round(m.spec_accepted / m.spec_drafted, 4)
    assert m.spec_accept_rate == jax_eng.metrics.spec_accept_rate
    assert m.time_spec_host_ms > 0
    d = m.to_dict()
    for k in ("spec_drafted", "spec_accepted", "spec_skipped_ineligible",
              "spec_skipped_cooldown", "spec_accept_rate"):
        assert k in d
