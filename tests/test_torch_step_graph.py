"""The host side of the port's step graphs, on the CPU.

A CUDA graph needs the card (tests/test_torch_cuda.py captures and replays
them there). What runs here: the static buffers' fill, which must write
every row of every buffer, padding included, from host arrays or device
tensors; the step keys, decode and prefill, which must be the JAX engine's
key fields for the same dispatches; and a CPU engine, which must capture
nothing.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.engine import EngineMetrics as JaxEngineMetrics
from dynamo_tpu.engine.engine import JaxEngine
from dynamo_tpu.engine.request import SamplingParams as JaxSampling
from dynamo_tpu_torch.cli import run as cli_run
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import (
    DECODE_KINDS,
    KEY_FIELDS,
    EngineMetrics,
    TorchEngine,
    key_field,
)
from dynamo_tpu_torch.engine.request import SamplingParams
from dynamo_tpu_torch.engine.step_graph import Readback, StaticInputs, StepGraph
from tests.test_torch_engine import MAX_TOKENS, PROMPTS, _jax_engine, _torch_engine
from tests.test_torch_guard import _port_modules

#: a sampled dispatch's buffers at B=4, K=2 (tiny's page table of 8 pages)
SPECS = {
    "tokens": ((4, 1), torch.int64), "positions": ((4, 1), torch.int32),
    "valid": ((4, 1), torch.bool), "page_tables": ((4, 8), torch.int32),
    "temps": ((4,), torch.float32), "top_ps": ((4,), torch.float32),
    "top_ks": ((4,), torch.int64), "noise": ((2, 4, 64), torch.float32),
}


def _arrays(rng, live: int) -> dict[str, np.ndarray]:
    """Random arrays for SPECS whose rows past `live` are padding, as
    _run_decode pads them (zero ids, positions, pages, temps and noise,
    valid False, top_p 1)."""
    out = {}
    for name, (shape, dtype) in SPECS.items():
        np_dtype = torch.empty(0, dtype=dtype).numpy().dtype
        if np_dtype == bool:
            a = np.ones(shape, bool)
        else:
            a = (rng.integers(1, 1000, shape) if np_dtype.kind == "i"
                 else rng.random(shape) + 0.5).astype(np_dtype)
        pad = (slice(None), slice(live, None)) if name == "noise" else slice(live, None)
        a[pad] = 1 if name == "top_ps" else 0
        out[name] = a
    return out


def test_fill_writes_every_row_of_every_buffer():
    """A full batch, then one live row: every buffer equals the second
    dispatch's arrays whole, so no padding row keeps the first's values."""
    rng = np.random.default_rng(0)
    inputs = StaticInputs(SPECS, torch.device("cpu"))
    for live in (4, 1, 3):
        arrays = _arrays(rng, live)
        inputs.fill(arrays)
        for name, (shape, dtype) in SPECS.items():
            got = inputs.device[name]
            assert got.shape == shape and got.dtype == dtype
            assert np.array_equal(got.numpy(), arrays[name]), name


def test_fill_refuses_a_missing_buffer_or_a_wrong_shape():
    inputs = StaticInputs(SPECS, torch.device("cpu"))
    arrays = _arrays(np.random.default_rng(1), 2)
    with pytest.raises(ValueError, match="names"):
        inputs.fill({k: v for k, v in arrays.items() if k != "noise"})
    with pytest.raises(ValueError, match="shape"):
        inputs.fill({**arrays, "page_tables": np.zeros((4, 7), np.int32)})


@pytest.mark.parametrize("decode_steps", [1, 4])
def test_step_keys_are_the_jax_engines_decode_keys(decode_steps):
    """The same requests (greedy and seeded sampled ones, whose lengths do
    not depend on the ids drawn) dispatch the same decode keys in both
    engines: (kind, batch bucket, fused steps, all-greedy), the first four
    fields of JaxEngine._get_step_fn's cache key."""
    jax_eng = _jax_engine(decode_steps=decode_steps)
    torch_eng = _torch_engine(decode_steps=decode_steps)
    for i, (rid, prompt) in enumerate(PROMPTS.items()):
        temp = 0.8 if i % 2 else 0.0
        jax_eng.add_request(rid, prompt, JaxSampling(max_tokens=MAX_TOKENS[rid],
                                                     temperature=temp, seed=i, ignore_eos=True))
        torch_eng.add_request(rid, prompt, SamplingParams(max_tokens=MAX_TOKENS[rid],
                                                          temperature=temp, seed=i,
                                                          ignore_eos=True))
    jax_eng.run_to_completion()
    torch_eng.run_to_completion()
    want = {(*k[:4], k[6], k[7], k[8]) for k in jax_eng._jit_cache if k[0] in DECODE_KINDS}
    assert {k for k in torch_eng.step_keys if k[0] in DECODE_KINDS} == want
    assert {k[3] for k in want} == {True, False}  # both sampler variants ran


def test_fill_takes_a_device_tensor_and_refuses_a_wrong_dtype():
    """A speculated decode dispatch's tokens come from the last dispatch's
    ids on the device: a tensor input is copied whole like an array, and
    one of another dtype (or shape) than its buffer is refused."""
    inputs = StaticInputs(SPECS, torch.device("cpu"))
    arrays = _arrays(np.random.default_rng(2), 3)
    ids = torch.arange(7, 11, dtype=torch.int64)[:, None]
    inputs.fill({**arrays, "tokens": ids})
    assert torch.equal(inputs.device["tokens"], ids)
    assert np.array_equal(inputs.device["noise"].numpy(), arrays["noise"])
    with pytest.raises(ValueError, match="int32"):
        inputs.fill({**arrays, "tokens": ids.to(torch.int32)})
    with pytest.raises(ValueError, match="shape"):
        inputs.fill({**arrays, "tokens": ids[:3]})


def test_readback_of_a_cpu_tensor_is_the_tensor():
    ids = torch.tensor([[3, 4], [5, 6]])
    got = Readback(ids)
    assert got.device is ids and np.array_equal(got.numpy(), ids.numpy())
    assert got.extras() == ()


def test_readback_carries_a_logprob_bodys_outputs():
    """A logprob body's outputs: the ids first (what a speculation reads on
    the device), then chosen logprobs, top ids and top logprobs; keep()
    copies them all."""
    outs = (torch.tensor([[3, 4]]), torch.tensor([[-0.5, -1.0]]),
            torch.tensor([[[3, 1], [4, 2]]]), torch.tensor([[[-0.5, -2.0], [-1.0, -1.5]]]))
    got = Readback(outs)
    assert got.device is outs[0] and np.array_equal(got.numpy(), outs[0].numpy())
    assert [a.tolist() for a in got.extras()] == [o.tolist() for o in outs[1:]]
    got.keep()
    assert all(a is not b and torch.equal(a, b) for a, b in zip(got.outputs, outs))


@pytest.mark.parametrize("decode_steps", [1, 4])
def test_sampling_surface_key_fields_are_the_jax_engines(decode_steps):
    """Requests that each ask for one part of the sampling surface, one at
    a time (logprobs 3, then 20; a penalty; logit_bias with min_tokens),
    then together: the prefill and decode keys' lp, pen and bias fields are
    JaxEngine._get_step_fn's (fields 6, 7 and 8 of its key). (The keys do
    not depend on the JAX engine's attention: it runs its XLA one.)"""
    knobs = dict(decode_steps=decode_steps, overlap_decode=False)
    jax_eng = _jax_engine(attention_impl="xla", **knobs)
    torch_eng = _torch_engine(jax_eng, **knobs)
    alone = [dict(logprobs=3), dict(logprobs=20), dict(repetition_penalty=1.2),
             dict(logit_bias=((7, 2.0),), min_tokens=3, stop_token_ids=(9,))]
    for eng, sampling in ((jax_eng, JaxSampling), (torch_eng, SamplingParams)):
        for i, kw in enumerate(alone):
            eng.add_request(f"r{i}", PROMPTS["a"], sampling(max_tokens=7, ignore_eos=True, **kw))
            eng.run_to_completion()
        for i, kw in enumerate(alone):
            eng.add_request(f"t{i}", PROMPTS["d"], sampling(max_tokens=5, ignore_eos=True, **kw))
        eng.run_to_completion()
    want = {(*k[:4], k[6], k[7], k[8]) if k[0] in DECODE_KINDS
            else (k[0], k[1], k[2], k[3], k[5], k[6], k[7], k[8])
            for k in jax_eng._jit_cache if k[0] in DECODE_KINDS or k[0] == "prefill"}
    assert set(torch_eng.step_keys) == want
    assert all(len(k) == len(KEY_FIELDS[k[0]]) for k in want)
    decode = [k for k in want if k[0] in DECODE_KINDS]
    assert {key_field(k, "lp") for k in decode} == {-1, 3, 20}
    assert {key_field(k, "pen") for k in decode} >= {0, 1}
    assert {key_field(k, "bias") for k in decode} == {True, False}


#: a prompt of three chunks of 16 (two that sample nothing), one of two,
#: and two short ones, then one long prompt alone (a first chunk that
#: samples nothing); odd requests seeded sampled
KEY_PROMPTS = {"long": list(range(1, 49)), "mid": list(range(3, 23)), "s0": [9, 8, 7],
               "s1": [5, 6, 7, 8, 9, 10]}
ALONE = {"alone": list(range(2, 42))}


@pytest.mark.parametrize("decode_steps", [1, 4])
def test_prefill_step_keys_are_the_jax_engines_prefill_keys(decode_steps):
    """The same requests dispatch the same prefill keys in both engines:
    JaxEngine._get_step_fn's cache key projected onto (kind, B bucket, T
    bucket, all-greedy, first chunk) for "prefill", and onto (kind, B, T,
    first chunk) for "prefill_nosample", whose key has no sampler kind.
    The workload runs first chunks, chunks with history and chunks that
    sample nothing, greedy and sampled. (The keys do not depend on the JAX
    engine's attention, so it runs its quicker XLA one here.)"""
    jax_cfg = JaxEngineConfig.for_tests(attention_impl="xla", enable_prefix_caching=False,
                                        mixed_steps=False, decode_steps=decode_steps,
                                        max_pages_per_seq=16)
    engines = (JaxEngine(jax_cfg),
               _torch_engine(decode_steps=decode_steps, max_pages_per_seq=16))
    for eng, sampling in zip(engines, (JaxSampling, SamplingParams)):
        for wave in (KEY_PROMPTS, ALONE):
            for i, (rid, prompt) in enumerate(wave.items()):
                eng.add_request(rid, prompt, sampling(max_tokens=3, temperature=0.8 * (i % 2),
                                                      seed=i, ignore_eos=True))
            eng.run_to_completion()
    jax_eng, torch_eng = engines
    want = {(k[0], k[1], k[2], k[3], k[5], k[6], k[7], k[8]) if k[0] == "prefill"
            else (k[0], k[1], k[2], k[5]) for k in jax_eng._jit_cache if k[0].startswith("prefill")}
    got = {k for k in torch_eng.step_keys if k[0] not in DECODE_KINDS}
    assert got == want
    sampled = {k for k in got if k[0] == "prefill"}
    assert {key_field(k, "greedy") for k in sampled} == {True, False}
    assert {key_field(k, "first_chunk") for k in sampled} == {True, False}
    nosample = {k for k in got if k[0] == "prefill_nosample"}
    assert {key_field(k, "first_chunk") for k in nosample} == {True, False}
    assert all(len(k) == len(KEY_FIELDS[k[0]]) for k in got)


def test_a_cpu_engine_captures_nothing():
    eng = _torch_engine(decode_steps=4)
    for rid, prompt in PROMPTS.items():
        eng.add_request(rid, prompt, SamplingParams(max_tokens=MAX_TOKENS[rid], ignore_eos=True))
    eng.run_to_completion()
    assert eng.metrics.decode_dispatches > 0 and eng.step_keys
    assert not any(isinstance(fn, StepGraph) for fn in eng._step_fns.values())
    assert eng.metrics.compiles == 0 and eng.metrics.compile_ms == 0.0
    assert eng.metrics.decode_replays == eng.metrics.prefill_replays == 0
    assert eng._graph_stream is None  # no stream, pool or workspace was made


def test_cuda_graphs_is_a_constructor_keyword_only():
    """The eager loop on the card is asked for by the constructor alone:
    no config knob and no CLI flag names graphs."""
    eng = TorchEngine(EngineConfig.for_tests(), device="cpu", cuda_graphs=False)
    assert not eng._graphs
    assert not any("graph" in f.name for f in dataclasses.fields(EngineConfig))
    assert "graph" not in (Path(cli_run.__file__).read_text())


def test_engine_metrics_carry_the_jax_engines_compile_fields():
    names = {f.name: f.type for f in dataclasses.fields(EngineMetrics)}
    jax_names = {f.name: f.type for f in dataclasses.fields(JaxEngineMetrics)}
    for name in ("compiles", "compile_ms"):
        assert names[name] == jax_names[name]
    for name in ("overlap_dispatches", "overlap_hits", "overlap_rollbacks"):
        assert names[name] == jax_names[name]
    assert {"compiles", "compile_ms", "decode_replays", "prefill_replays"} <= (
        EngineMetrics().to_dict().keys())


def test_the_import_guard_covers_the_step_graph_module():
    assert "dynamo_tpu_torch.engine.step_graph" in _port_modules()
