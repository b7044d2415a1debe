"""The port's weight-only int8 (`quantize="int8"`) against the JAX package's.

Inputs come from numpy seeds (or from the JAX package's own random init)
and go through both sides. The port runs its kernels' plain versions (CPU
tensors); the JAX forward runs attention_impl="pallas" (its kernels in
interpret mode) and the JAX engine its test config. Tolerances, each with
its reason:
- quantize_channelwise_int8 and quantize_params_int8: bit-equal (the same
  f32 max, product by the f32 reciprocal of 127, IEEE division and
  round-half-even on both sides). The JAX scheme is taken compiled, as
  the JAX package runs it (quantize_params_int8 and init_params_int8 map
  it under XLA, which turns its division by the constant 127 into that
  product; op by op it divides, one ulp apart on some columns);
- the plain `_mm` in float32: 1e-5 (sums taken in another order);
- the tiny forward's logits in float32: 1e-4, as the other forward tests;
- engine streams: identical, greedy and seeded (rows sampled at
  temperature 0.8 under top_k=1, so the sampled path runs and its draw is
  determined; JAX's PRNG cannot be matched otherwise).
"""

import dataclasses
import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.engine import JaxEngine
from dynamo_tpu.engine.request import SamplingParams as JaxSampling
from dynamo_tpu.models import llama as jllama
from dynamo_tpu_torch import ops
from dynamo_tpu_torch.cli import run as cli_run
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.engine.request import SamplingParams
from dynamo_tpu_torch.models import llama as tllama
from dynamo_tpu_torch.models.registry import get_model
from dynamo_tpu_torch.ops import int8_matmul

ATOL_MM, ATOL_FWD = 1e-5, 1e-4


def _np_tree(params) -> dict:
    return jax.tree.map(np.asarray, params)


def _assert_trees_equal(got: dict, want: dict) -> None:
    """Port params (torch) bit-equal to JAX params (numpy), leaf by leaf."""
    assert set(got["layers"]) == set(want["layers"])
    for name, x in got["layers"].items():
        np.testing.assert_array_equal(x.numpy(), want["layers"][name], err_msg=name)
    for name in ("embed", "final_norm"):
        np.testing.assert_array_equal(got[name].numpy(), want[name])


# -- the scheme -----------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(64, 128), (128, 32), (7, 5)])
def test_quantize_channelwise_int8_bit_equal_to_jax(shape, dtype):
    """Columns of several magnitudes, one all zero (the 1e-8 floor) and
    values on the rounding's half-way points, against the JAX scheme
    compiled (as quantize_params_int8 runs it)."""
    rng = np.random.default_rng(shape[0] + shape[1])
    w = (rng.standard_normal(shape) * rng.choice([1e-3, 0.05, 1.0, 30.0], shape[1])).astype(
        np.float32)
    w[:, 0] = 0.0
    w[:4, 1] = [127.0, -63.5, 0.5, -1.5]  # scale 1: ties round half to even
    jw = jnp.asarray(w, dtype)
    tw = torch.from_numpy(np.array(jw.astype(jnp.float32))).to(getattr(torch, dtype))
    jq, js = jax.jit(jllama.quantize_channelwise_int8)(jw)
    tq, ts = tllama.quantize_channelwise_int8(tw)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert tuple(ts.shape) == (1, shape[1])
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts[0, 0].item() == np.float32(1e-8) and (tq[:, 0] == 0).all()
    assert tq[:4, 1].tolist() == [127, -64, 0, -2]


def _jax_float_params(tie: bool = False):
    cfg = jllama.LlamaConfig.tiny()
    if tie:
        cfg = dataclasses.replace(cfg, tie_word_embeddings=True)
    return cfg, jllama.init_params(jax.random.key(0), cfg)


@pytest.mark.parametrize("tie", [False, True])
def test_quantize_params_int8_bit_equal_to_jax_and_refuses_twice(tie):
    """The port quantizes the JAX package's float params to the JAX
    package's int8 params bit for bit; quantized params are refused with
    the reference's error, and the float params are left as they were."""
    jcfg, jparams = _jax_float_params(tie)
    tcfg = tllama.LlamaConfig.tiny()
    tparams = tllama.params_from_jax(_np_tree(jparams), tcfg, device="cpu")
    before = {k: v.clone() for k, v in tparams["layers"].items()}
    got = tllama.quantize_params_int8(tparams)
    _assert_trees_equal(got, _np_tree(jllama.quantize_params_int8(jparams)))
    assert all(torch.equal(tparams["layers"][k], v) for k, v in before.items())
    with pytest.raises(ValueError, match="already int8-quantized"):
        tllama.quantize_params_int8(got)


def _layout(params) -> dict:
    """name -> (dtype, shape) of every leaf."""
    out = {k: (v.dtype, tuple(v.shape)) for k, v in params.items() if k != "layers"}
    out.update({f"layers.{k}": (v.dtype, tuple(v.shape)) for k, v in params["layers"].items()})
    return out


@pytest.mark.parametrize("tie", [False, True])
def test_init_params_int8_layout_equals_quantize_params_int8s(tie):
    """Names, dtypes and shapes; the quantized weights are the int8 view of
    N(0, 1/fan_in) draws (each column's largest |value| is 127)."""
    cfg = dataclasses.replace(tllama.LlamaConfig.tiny(), tie_word_embeddings=tie)
    gen = torch.Generator().manual_seed(0)
    direct = tllama.init_params_int8(gen, cfg)
    via = tllama.quantize_params_int8(tllama.init_params(torch.Generator().manual_seed(0), cfg))
    assert _layout(direct) == _layout(via)
    assert ("lm_head" in direct) == (not tie)
    for name in tllama.QUANTIZED_DENSE_NAMES:
        q = direct["layers"][name]
        assert q.dtype == torch.int8
        assert (q.abs().amax(dim=1) == 127).all()
        s = direct["layers"][name + "_scale"]
        assert (s > 0).all() and (s < 1).all()


# -- the product ----------------------------------------------------------------


@pytest.mark.parametrize("lead", [(1,), (3, 5), (2, 1, 4)])
def test_plain_mm_matches_jax_mm(lead):
    """`_mm` of an int8 weight over leading dims of any rank, through the
    plain path and through the kernels' wrapper (which runs the plain
    version on CPU tensors), against the JAX package's `_mm` in float32."""
    rng = np.random.default_rng(len(lead))
    k, n = 48, 40
    x = rng.standard_normal((*lead, k)).astype(np.float32)
    w = rng.integers(-127, 128, (2, k, n)).astype(np.int8)
    s = (rng.random((2, 1, n)) * 0.02 + 1e-3).astype(np.float32)
    want = jllama._mm(jnp.asarray(x), {"wq": jnp.asarray(w[1]), "wq_scale": jnp.asarray(s[1])},
                      "wq", jnp.float32)
    lp = {"wq": torch.from_numpy(w), "wq_scale": torch.from_numpy(s)}
    ops.reset_counts()
    for path in (ops.PLAIN, ops.KERNELS):
        got = tllama._mm(torch.from_numpy(x), lp, "wq", 1, path)
        assert got.shape == (*lead, n)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL_MM)
    c = ops.COUNTS["int8_matmul"]
    assert (c.launches, c.plain_calls) == (0, 2)
    # a float weight takes the plain product, not the int8 path
    lp_f = {"wq": torch.from_numpy(w.astype(np.float32))}
    torch.testing.assert_close(tllama._mm(torch.from_numpy(x), lp_f, "wq", 0, ops.KERNELS),
                               torch.from_numpy(x) @ lp_f["wq"][0])
    assert c.plain_calls == 2


@pytest.mark.parametrize("m,k,n,sms,plan", [
    (1, 2048, 2048, 132, (1, 16, 2)),  # decode: 16 N tiles, split to 256 CTAs
    (64, 2048, 2048, 132, (4, 16, 2)),  # one 64-row tile, split the same way
    (1, 8192, 2048, 132, (1, 16, 8)),  # 17 splits wanted: 128 slices in 16 of 8
    (2048, 2048, 8192, 132, (4, 1, 32)),  # a prefill chunk: 2048 CTAs, no split
    (512, 2048, 2048, 132, (4, 3, 11)),  # a chunk of 512: 12 MB of partials
    (64, 4096, 14336, 132, (4, 3, 22)),  # partials would pass 16 MB at 4 splits
    (8, 64, 128, 132, (1, 1, 1)),  # one slice of K
])
def test_split_plan(m, k, n, sms, plan):
    assert int8_matmul.split_plan(m, k, n, sms) == plan


# -- the forward ----------------------------------------------------------------


def _forward_pair(mode):
    """A first chunk of 8, a chunk of 8 with history, then 4 decode steps,
    B=2, over `mode` pools (None or "int8"), with the JAX package's tiny
    params quantized by each side. Yields (step, port logits, JAX logits)."""
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), attention_impl="pallas")
    tcfg = tllama.LlamaConfig.tiny()
    jfloat = jllama.init_params(jax.random.key(0), jcfg)
    jparams = jllama.quantize_params_int8(jfloat)
    tparams = tllama.quantize_params_int8(
        tllama.params_from_jax(_np_tree(jfloat), tcfg, device="cpu"))
    toks = np.random.default_rng(5).integers(1, 200, (2, 16)).astype(np.int32)
    b, t, s = 2, 8, 4
    pt = np.stack([np.arange(1, 9), np.arange(9, 17)]).astype(np.int32)
    jkv = jllama.init_kv_pages(jcfg, 32, s, kv_quantize=mode)
    tkv = tllama.init_kv_pages(tcfg, 32, s, "cpu", kv_quantize=mode)
    pos1 = np.tile(np.arange(t, dtype=np.int32), (b, 1))
    steps = [(toks[:, :t], pos1, True), (toks[:, t:], pos1 + t, False)]
    steps += [(np.asarray([[3], [4]], np.int32), np.full((b, 1), 2 * t + i, np.int32), False)
              for i in range(4)]
    for i, (tok, pos, first) in enumerate(steps):
        valid = np.ones(tok.shape, bool)
        jl, jkv = jllama.forward(jparams, jcfg, jnp.asarray(tok), jnp.asarray(pos),
                                 jnp.asarray(valid), jkv, jnp.asarray(pt), first_chunk=first)
        tl, tkv = tllama.forward(tparams, tcfg, torch.from_numpy(tok).long(),
                                 torch.from_numpy(pos), torch.from_numpy(valid), tkv,
                                 torch.from_numpy(pt), first_chunk=first)
        yield i, tl.numpy(), np.asarray(jl)


@pytest.mark.parametrize("mode", [None, "int8"])
def test_int8_forward_matches_jax_forward(mode):
    """The tiny fp32 forward with int8 weights, over a bf16-free (f32) pool
    and an int8 pool: a first chunk, a later chunk and decode steps, logits
    within 1e-4 of JAX's `forward` at every step; each of the seven dense
    products of every layer went through int8_matmul (its plain version on
    CPU tensors)."""
    ops.reset_counts()
    steps = 0
    for step, tl, jl in _forward_pair(mode):
        np.testing.assert_allclose(tl, jl, rtol=0, atol=ATOL_FWD, err_msg=f"step {step}")
        steps += 1
    layers = tllama.LlamaConfig.tiny().num_layers
    assert ops.COUNTS["int8_matmul"].plain_calls == 7 * layers * steps


# -- the engine -----------------------------------------------------------------

PROMPTS = {
    "a": [5, 17, 42, 9, 3, 7, 11, 2],
    "b": list(range(1, 17)),  # exactly one chunk
    "c": [200],
    "d": np.random.default_rng(33).integers(1, 256, 33).tolist(),  # three chunks
}
MAX_TOKENS = {"a": 20, "b": 6, "c": 28, "d": 5}
#: rows sampled at temperature 0.8 under top_k=1, each with its seed
SEEDED = {"b", "d"}


def _drive(eng, sampling_cls) -> dict[str, list[int]]:
    for i, (rid, prompt) in enumerate(PROMPTS.items()):
        knobs = dict(temperature=0.8, top_k=1, seed=10 + i) if rid in SEEDED else {}
        eng.add_request(rid, prompt, sampling_cls(max_tokens=MAX_TOKENS[rid], ignore_eos=True,
                                                  **knobs))
    return eng.run_to_completion()


@pytest.fixture(scope="module")
def jax_int8():
    """JaxEngine(quantize="int8") on its own float params, given to it (so
    it quantizes them as the port will), and its streams at 1 and 8 fused
    steps."""
    _, jfloat = _jax_float_params()
    out = {}
    for steps in (1, 8):
        eng = JaxEngine(JaxEngineConfig.for_tests(
            quantize="int8", decode_steps=steps, max_pages_per_seq=16,
            enable_prefix_caching=False, overlap_decode=False, mixed_steps=False),
            params=jfloat)
        assert eng.params["layers"]["wq"].dtype == jnp.int8
        out[steps] = _drive(eng, JaxSampling)
    return _np_tree(jfloat), out


@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("decode_steps", [1, 8])
def test_int8_engine_streams_equal_jax_engines(jax_int8, decode_steps, overlap, mixed):
    """TorchEngine(quantize="int8") built from the same float params as the
    JAX engine quantizes them itself; greedy and seeded streams equal
    JaxEngine(quantize="int8")'s at 1 and 8 fused steps, with overlapped
    decode and mixed steps on and off, and every dense product went
    through int8_matmul."""
    np_float, want = jax_int8
    params = tllama.params_from_jax(np_float, tllama.LlamaConfig.tiny(), device="cpu")
    eng = TorchEngine(EngineConfig.for_tests(
        quantize="int8", decode_steps=decode_steps, overlap_decode=overlap, mixed_steps=mixed,
        max_pages_per_seq=16, enable_prefix_caching=False), params=params, device="cpu")
    assert eng.params["layers"]["wq"].dtype == torch.int8
    assert params["layers"]["wq"].dtype == torch.float32  # the caller's params untouched
    ops.reset_counts()
    got = _drive(eng, SamplingParams)
    assert got == want[decode_steps]
    assert ops.COUNTS["int8_matmul"].plain_calls > 0
    if overlap:
        assert eng.metrics.overlap_dispatches > 0


def test_engine_quantizes_random_params_in_the_int8_layout_and_refuses_int8_params():
    """With no params the engine draws them straight into the int8 layout;
    given params already int8, quantize="int8" raises the reference's
    error."""
    cfg = EngineConfig.for_tests(quantize="int8")
    eng = TorchEngine(cfg, device="cpu")
    adapter = get_model("tiny", dtype="float32")
    assert _layout(eng.params) == _layout(
        adapter.quantize_params(adapter.init_params(torch.Generator().manual_seed(0))))
    with pytest.raises(ValueError, match="already int8-quantized"):
        TorchEngine(cfg, params=eng.params, device="cpu")


@pytest.mark.parametrize("value", ["int4", "fp8", "INT8"])
def test_quantize_refuses_other_values(value):
    with pytest.raises(ValueError, match=f"unsupported quantize={value!r}; use int8"):
        EngineConfig.for_tests(quantize=value)


def test_cli_flag_reaches_the_engine_config_and_serves():
    """`--quantize int8` (beside `--kv-quantize int8`) reaches EngineConfig,
    and a server started with both answers a chat through int8 weights;
    the flag refuses other values and defaults to None."""
    argv = ["run", "in=http", "out=torch", "--model", "tiny", "--port", "0", "--device", "cpu",
            "--dtype", "float32", "--page-size", "4", "--max-context", "64",
            "--num-pages", "64", "--prefill-chunk", "16"]
    cfg = cli_run.engine_config(cli_run._parse(argv + ["--quantize", "int8",
                                                       "--kv-quantize", "int8"]), (0,))
    assert (cfg.quantize, cfg.kv_quantize) == ("int8", "int8")
    assert cli_run.engine_config(cli_run._parse(argv), (0,)).quantize is None
    with pytest.raises(SystemExit):
        cli_run._parse(argv + ["--quantize", "int4"])
    server = cli_run.start_server(argv + ["--quantize", "int8", "--kv-quantize", "int8"])
    try:
        assert server.runner.engine.params["layers"]["w_down"].dtype == torch.int8
        ops.reset_counts()
        req = urllib.request.Request(
            server.url + "/v1/chat/completions", headers={"Content-Type": "application/json"},
            data=json.dumps({"model": "tiny", "max_tokens": 4, "ext": {"ignore_eos": True},
                             "messages": [{"role": "user", "content": "hi"}]}).encode())
        with urllib.request.urlopen(req, timeout=120) as r:
            assert json.load(r)["usage"]["completion_tokens"] == 4
        assert ops.COUNTS["int8_matmul"].plain_calls > 0
    finally:
        server.stop()
