"""The Qwen2, Qwen3, Phi-3, Phi-4, Gemma and Llama-3-70B presets in the port, against the reference.

Each family's preset is shrunk as tests/test_model_qwen3.py shrinks its
config (2 layers of width 64, a 256-id vocabulary, float32), keeping its
query group and its flags: the Qwen2 shape has 14 query heads over 2 (a
group of 7, which divides neither prefill kernel's 128-row tile), q/k/v
biases and tied embeddings; Qwen3 a group of 4 and per-head q/k RMSNorm;
Phi-4 a group of 4 and its 250k rope base; Llama-3-70B a group of 8; these
at head_dim 16. Phi-3-mini keeps its head_dim 96 (2 query heads over 2,
the reference's pool lane-padded to 128) and Gemma its head_dim 256 with
GeGLU, the (1 + w) RMSNorm and scaled embeddings: gemma-2b 8 query heads
over 1, gemma-7b 2 over 2. The reference's params are drawn from a seed
and made live (biases N(0, 0.1), q/k norm weights 1 + N(0, 0.2), a Gemma
norm's weights N(0, 0.2) around the unit offset, from numpy) and carried
over with params_from_jax. The reference runs attention_impl="pallas"
(its kernels in interpret mode), the port its kernels' plain versions.

- `forward` over a first chunk, a chunk with history and teacher-forced
  decode steps, for every family but gemma-7b (on the CPU it differs
  from gemma-2b only in its group, which the plain versions take alike):
  logits within 1e-4, and the K/V of every token in each history
  (tests/test_torch_model.py::_assert_pages_match); for the Qwen2 and
  gemma-2b shapes also with int8 weights (the reference's
  quantize_params_int8 on the same params); for the Phi-3 shape also over
  int8 and fp8 pools (the 96-wide narrow rows equal the reference's
  padded ones byte for byte, and their scales).
- JaxEngine and TorchEngine at the Qwen2 and gemma-2b shapes at the CLI's
  defaults (prefix caching, mixed steps, overlap, chunked prefill, 8
  fused steps): greedy streams, step keys, cached tokens and dispatch
  counters equal.
- Every preset the port registers equals the reference's constructor
  field for field, and every field of the reference's config that the
  port lacks stands at its default there; params_from_jax refuses a layer
  leaf the config's forward does not read; an unknown hidden_act raises.
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
from dynamo_tpu.models import registry as jregistry
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.engine.request import SamplingParams
from dynamo_tpu_torch.models import llama as tllama
from dynamo_tpu_torch.models import registry as tregistry
from dynamo_tpu_torch.ops import COUNTS, reset_counts
from tests.test_torch_mixed import COUNTERS, _project
from tests.test_torch_kv_quant import SCALE_RTOL, _bytes
from tests.test_torch_model import ATOL, _assert_pages_match

#: the widths every family is shrunk to (tests/test_model_qwen3.py:22-24)
SHRINK = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_layers=2)
#: family -> (preset, query heads, KV heads, head_dim): each preset's query
#: group; head_dim 16 where the preset's is 64 or 128, its own where the
#: kernels took it later (96, 256)
FAMILIES = {
    "qwen2": ("qwen2-0.5b", 14, 2, 16),
    "qwen3": ("qwen3-8b", 8, 2, 16),
    "phi4": ("phi4", 8, 2, 16),
    "llama3-70b": ("llama3-70b", 16, 2, 16),
    "phi3": ("phi3-mini", 2, 2, 96),
    "gemma-2b": ("gemma-2b", 8, 1, 256),
    "gemma-7b": ("gemma-7b", 2, 2, 256),
}


def _configs(family: str):
    """(reference config on its Pallas path, the port's config): the
    preset's own constructor in each package, shrunk alike, in float32."""
    preset, hq, hkv, d = FAMILIES[family]
    shrink = dict(SHRINK, num_heads=hq, num_kv_heads=hkv, head_dim=d)
    jcfg = dataclasses.replace(jregistry._LLAMA_PRESETS[preset](), **shrink,
                               dtype=jnp.float32, attention_impl="pallas")
    tcfg = dataclasses.replace(tregistry._LLAMA_PRESETS[preset](), **shrink, dtype=torch.float32)
    return jcfg, tcfg


def _live_params(jcfg, seed: int) -> dict:
    """The reference's random init (numpy leaves) with nonzero q/k/v biases
    and q/k norm weights away from 1, so both flags change the logits; a
    (1 + w) RMSNorm's weights N(0, 0.2), so its offset is not the whole
    scale."""
    np_params = jax.tree.map(np.asarray, jllama.init_params(jax.random.key(seed), jcfg))
    rng = np.random.default_rng(seed)
    layers = dict(np_params["layers"])
    for name in ("bq", "bk", "bv"):
        if name in layers:
            layers[name] = rng.normal(0.0, 0.1, layers[name].shape).astype(np.float32)
    for name in ("q_norm", "k_norm"):
        if name in layers:
            layers[name] = (1.0 + rng.normal(0.0, 0.2, layers[name].shape)).astype(np.float32)
    out = {**np_params, "layers": layers}
    if jcfg.rms_norm_unit_offset:
        for tree, name in ((layers, "attn_norm"), (layers, "mlp_norm"), (out, "final_norm")):
            tree[name] = rng.normal(0.0, 0.2, tree[name].shape).astype(np.float32)
    return out


def _forward_pair(jparams, tparams, jcfg, tcfg, tokens, positions, valid, jkv, tkv, pt,
                  first):
    jlogits, jkv = jllama.forward(
        jparams, jcfg, jnp.asarray(tokens), jnp.asarray(positions), jnp.asarray(valid),
        jkv, jnp.asarray(pt), first_chunk=first)
    tlogits, tkv = tllama.forward(
        tparams, tcfg, torch.from_numpy(tokens).long(), torch.from_numpy(positions),
        torch.from_numpy(valid), tkv, torch.from_numpy(pt), first_chunk=first)
    return tlogits.numpy(), np.asarray(jlogits), jkv, tkv


def _assert_quantized_pages_match(tkv, jkv, tcfg, pt, lengths):
    """A quantized pool's narrow bytes equal on every token of each
    history, and its scales within SCALE_RTOL (tests/test_torch_kv_quant.py:
    the two sides' f32 matmuls sum in another order); the reference's
    padding lanes are stripped."""
    ref = tllama.kv_pages_from_jax(_bytes(jkv.k), _bytes(jkv.v), tcfg, device="cpu",
                                   k_scale=np.asarray(jkv.k_scale),
                                   v_scale=np.asarray(jkv.v_scale))
    s = tkv.page_size
    for i, n in enumerate(lengths):
        pos = np.arange(n)
        pages, slots = pt[i, pos // s], pos % s
        for got, want in ((tkv.k, ref.k), (tkv.v, ref.v)):
            np.testing.assert_array_equal(_bytes(got[:, pages, slots]),
                                          _bytes(want[:, pages, slots]))
        for got, want in ((tkv.k_scale, ref.k_scale), (tkv.v_scale, ref.v_scale)):
            np.testing.assert_allclose(got[:, pages, slots].numpy(),
                                       want[:, pages, slots].numpy(), rtol=SCALE_RTOL)


@pytest.mark.parametrize("family,quantize,kv_quantize", [
    pytest.param(*case, id="-".join(map(str, case if case[2] else case[:2])))
    for case in (
        ("qwen2", None, None), ("qwen2", "int8", None), ("qwen3", None, None),
        ("phi4", None, None), ("llama3-70b", None, None),
        ("phi3", None, None), ("phi3", None, "int8"), ("phi3", None, "fp8"),
        ("gemma-2b", None, None), ("gemma-2b", "int8", None),
    )
])
def test_forward_matches_the_reference(family, quantize, kv_quantize):
    """Two prompts (32 and 27 tokens) prefilled in a first chunk of 16 and
    a chunk with history, then 2 teacher-forced decode steps: every valid
    row's logits within 1e-4 of the reference's, and the pools agree on
    every token of each history (a quantized pool byte for byte, with its
    scales). The port runs each kernel's plain version."""
    jcfg, tcfg = _configs(family)
    np_params = _live_params(jcfg, seed=len(family))
    if quantize:
        np_params = jax.tree.map(np.asarray, jllama.quantize_params_int8(
            jax.tree.map(jnp.asarray, np_params)))
    tparams = tllama.params_from_jax(np_params, tcfg, device="cpu")
    assert set(tparams["layers"]) == set(np_params["layers"])
    jparams = jax.tree.map(jnp.asarray, np_params)
    lens, t, s, mp, num_pages = (32, 27), 16, 4, 10, 24
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, tcfg.vocab_size, n).astype(np.int32) for n in lens]
    pt = (1 + rng.permutation(num_pages - 1)[: 2 * mp]).reshape(2, mp).astype(np.int32)
    jkv = jllama.init_kv_pages(jcfg, num_pages, s, kv_quantize=kv_quantize)
    tkv = tllama.init_kv_pages(tcfg, num_pages, s, device="cpu", kv_quantize=kv_quantize)
    reset_counts()
    for start in (0, t):  # a first chunk, then a chunk with history
        n = [min(t, m - start) for m in lens]
        tokens = np.zeros((2, t), np.int32)
        for i, p in enumerate(prompts):
            tokens[i, :n[i]] = p[start:start + n[i]]
        positions = np.tile(np.arange(start, start + t, dtype=np.int32), (2, 1))
        valid = np.arange(t)[None, :] < np.asarray(n)[:, None]
        tl, jl, jkv, tkv = _forward_pair(jparams, tparams, jcfg, tcfg, tokens, positions,
                                         valid, jkv, tkv, pt, start == 0)
        for i in range(2):  # rows past a prompt are unspecified
            np.testing.assert_allclose(tl[i, :n[i]], jl[i, :n[i]], atol=ATOL)
    nxt = np.array([jl[i, n[i] - 1].argmax() for i in range(2)], np.int32)
    for step in range(2):  # teacher forcing: both take the reference's greedy token
        pos = (np.asarray(lens) + step).astype(np.int32)[:, None]
        tl, jl, jkv, tkv = _forward_pair(jparams, tparams, jcfg, tcfg, nxt[:, None], pos,
                                         np.ones((2, 1), bool), jkv, tkv, pt, False)
        np.testing.assert_allclose(tl, jl, atol=ATOL)
        nxt = jl[:, 0].argmax(-1).astype(np.int32)
    if kv_quantize:
        _assert_quantized_pages_match(tkv, jkv, tcfg, pt, [n + 2 for n in lens])
    else:
        _assert_pages_match(tkv, jkv, tcfg, pt, [n + 2 for n in lens])
    L = tcfg.num_layers
    mode = f".{kv_quantize}" if kv_quantize else ""
    assert COUNTS["flash_prefill_attention"].plain_calls == L
    assert COUNTS[f"paged_prefill_attention{mode}"].plain_calls == L
    assert COUNTS[f"paged_decode_attention{mode}"].plain_calls == 2 * L
    assert COUNTS[f"paged_write{mode}"].plain_calls == 4
    assert COUNTS["int8_matmul"].plain_calls == (7 * L * 4 if quantize else 0)
    assert all(c.launches == 0 for c in COUNTS.values())


#: the engine workload: a 30-token prompt (two chunks of 16), then, while
#: it decodes, a prompt that shares its first 24 tokens (6 cached pages of
#: 4) and a cold one of 21 tokens (two pieces, beside the decoding row)
_rng = np.random.default_rng(26)
WARM = _rng.integers(1, 256, 30).tolist()
BASE = [("warm", WARM, 24)]
LATE = [("hit", WARM[:24] + _rng.integers(1, 256, 9).tolist(), 10),
        ("cold", _rng.integers(1, 256, 21).tolist(), 10)]


def _drive(eng, sampling_cls, late_at: int = 3):
    """BASE, then LATE after `late_at` steps: (request id -> ids, request
    id -> cached_tokens of its first output)."""
    for rid, prompt, n in BASE:
        eng.add_request(rid, prompt, sampling_cls(max_tokens=n, ignore_eos=True))
    streams: dict[str, list[int]] = {}
    cached: dict[str, int] = {}
    steps = 0
    while eng.has_work or steps < late_at:
        for o in eng.step():
            streams.setdefault(o.request_id, []).extend(o.new_token_ids)
            if o.cached_tokens is not None:
                cached.setdefault(o.request_id, o.cached_tokens)
        steps += 1
        if steps == late_at:
            for rid, prompt, n in LATE:
                eng.add_request(rid, prompt, sampling_cls(max_tokens=n, ignore_eos=True))
    return streams, cached


def _engines_agree(family: str, monkeypatch):
    """The family's shrunk shape served by JaxEngine and TorchEngine at the
    CLI's defaults: prefix caching, mixed steps, overlapped decode, 8 fused
    steps, chunks of 16. Greedy streams, cached_tokens, step keys and
    dispatch counters equal; the port's run made mixed steps, overlap hits
    and a prefix hit. The shrunk config is registered in both registries
    for the test alone."""
    jcfg, tcfg = _configs(family)
    name = f"{family}-shrunk"
    monkeypatch.setitem(jregistry._LLAMA_PRESETS, name, lambda: jcfg)
    monkeypatch.setitem(tregistry._LLAMA_PRESETS, name, lambda: tcfg)
    np_params = _live_params(jcfg, seed=5)
    knobs = dict(model=name, max_pages_per_seq=16, decode_steps=8)
    port_cfg = EngineConfig.for_tests(**knobs)
    assert port_cfg.enable_prefix_caching and port_cfg.mixed_steps and port_cfg.overlap_decode
    jax_eng = JaxEngine(JaxEngineConfig.for_tests(attention_impl="pallas", **knobs),
                        params=jax.tree.map(jnp.asarray, np_params))
    port = TorchEngine(port_cfg, params=tllama.params_from_jax(np_params, tcfg, device="cpu"),
                       device="cpu")
    want = _drive(jax_eng, JaxSampling)
    got = _drive(port, SamplingParams)
    assert got == want
    assert got[1] == {"warm": 0, "hit": 24, "cold": 0}
    assert set(port.step_keys) == _project(jax_eng)
    m = port.metrics
    assert {c: getattr(m, c) for c in COUNTERS} == {c: getattr(jax_eng.metrics, c)
                                                    for c in COUNTERS}
    assert m.mixed_dispatches > 0 and m.overlap_hits > 0


def test_qwen2_engine_equals_the_jax_engine(monkeypatch):
    """The Qwen2 shape (a group of 7, live biases): see _engines_agree."""
    _engines_agree("qwen2", monkeypatch)


def test_gemma_engine_equals_the_jax_engine(monkeypatch):
    """The gemma-2b shape (8 query heads over one KV head of 256, GeGLU,
    live (1 + w) norms, scaled embeddings): see _engines_agree."""
    _engines_agree("gemma-2b", monkeypatch)


@pytest.mark.parametrize("name", sorted(tregistry._LLAMA_PRESETS))
def test_presets_equal_the_reference_constructors(name):
    """Every field of the port's config equals the reference's (dtype by
    name), and every field the port lacks stands at the reference's
    default: no preset drops a window, a softcap, GeGLU or a flag."""
    port = tregistry.get_model(name).config
    ref = jregistry._LLAMA_PRESETS[name]()  # a LlamaConfig constructor for each
    ported = {f.name for f in dataclasses.fields(tllama.LlamaConfig)}
    for f in dataclasses.fields(tllama.LlamaConfig):
        got, want = getattr(port, f.name), getattr(ref, f.name)
        if f.name == "dtype":
            got, want = str(got).removeprefix("torch."), jnp.dtype(want).name
        assert got == want, f.name
    for f in dataclasses.fields(jllama.LlamaConfig):
        if f.name not in ported:
            assert getattr(ref, f.name) == f.default, f.name


def test_params_from_jax_refuses_a_leaf_it_does_not_read():
    """A layer leaf the config's forward does not read (a Gemma2 norm, or
    Qwen2 biases under a config without attention_bias), or a leaf it
    reads that is missing, raises ValueError instead of being dropped."""
    jcfg, tcfg = _configs("qwen2")
    np_params = _live_params(jcfg, seed=1)
    params = tllama.params_from_jax(np_params, tcfg, device="cpu")
    assert {"bq", "bk", "bv"} <= set(params["layers"])
    np.testing.assert_array_equal(params["layers"]["bq"].numpy(), np_params["layers"]["bq"])
    extra = {**np_params, "layers": {**np_params["layers"],
                                     "post_attn_norm": np_params["layers"]["attn_norm"]}}
    with pytest.raises(ValueError, match="post_attn_norm"):
        tllama.params_from_jax(extra, tcfg, device="cpu")
    with pytest.raises(ValueError, match="bq"):
        tllama.params_from_jax(np_params, dataclasses.replace(tcfg, attention_bias=False),
                               device="cpu")
    with pytest.raises(ValueError, match="q_norm"):
        tllama.params_from_jax(np_params, dataclasses.replace(tcfg, qk_norm=True),
                               device="cpu")


def test_unknown_hidden_act_raises():
    """hidden_act is checked when the config is made, as the reference's
    forward checks it: only "silu" and "gelu_tanh" are served."""
    assert tllama.LlamaConfig.tiny().hidden_act == "silu"
    dataclasses.replace(tllama.LlamaConfig.tiny(), hidden_act="gelu_tanh")
    with pytest.raises(ValueError, match="hidden_act 'relu'"):
        dataclasses.replace(tllama.LlamaConfig.tiny(), hidden_act="relu")


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_random_init_makes_the_references_leaves(family):
    """init_params and init_params_int8 make the reference's layer leaves,
    shapes and dtypes (biases zero, q/k norms one, in the model dtype;
    int8 only for the seven dense weights)."""
    jcfg, tcfg = _configs(family)
    want = jax.tree.map(np.asarray, jllama.init_params(jax.random.key(0), jcfg))["layers"]
    want_q = jax.tree.map(np.asarray, jllama.init_params_int8(jax.random.key(0), jcfg))["layers"]
    gen = torch.Generator().manual_seed(0)
    for got, ref in ((tllama.init_params(gen, tcfg)["layers"], want),
                     (tllama.init_params_int8(gen, tcfg)["layers"], want_q)):
        assert set(got) == set(ref)
        for k, x in got.items():
            assert tuple(x.shape) == ref[k].shape and str(x.dtype).removeprefix("torch.") == \
                ref[k].dtype.name, k
        for k in ("bq", "bk", "bv"):
            if k in got:
                assert not got[k].any()
        for k in ("q_norm", "k_norm"):
            if k in got:
                assert (got[k] == 1).all()
