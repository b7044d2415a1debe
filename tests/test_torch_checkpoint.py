"""HF checkpoint directories in the port, against the reference.

Each served family's directory is written by transformers itself
(`save_pretrained` of a tiny model: 2 layers of width 64, head_dim 16, a
256-id vocabulary, float32), with its biases and norm weights moved off
their init so every flag changes the logits: Llama, Qwen2 (q/k/v bias),
Qwen3 (q/k norms), Phi-3 (fused qkv_proj and gate_up_proj) and Gemma
(GeGLU, the (1 + w) norm, scaled embeddings). The reference loads a
directory through transformers (`get_model(dir).load_params(dir)`) and
runs its Pallas kernels in interpret mode; the port reads the files with
models/checkpoint.py and runs its kernels' plain versions.

- the port's `get_model(dir)` config equals the reference's field for
  field (and every field the port lacks stands at its default there), and
  its forward over a first chunk, a chunk with history and a decode step
  is within 1e-4 of the reference's;
- the same model as 2 safetensors shards and as pytorch_model.bin loads
  bit-equal to the single file; a bf16 file loads bit-equal to the
  reference's bf16 tree;
- `from_hf_config` on each served preset's published config.json equals
  the preset; every refusal raises by name, and a shape the CUDA kernels
  cannot run is refused before a load onto the card;
- greedy streams of TorchEngine on a directory equal JaxEngine's, also
  with quantize="int8", and through the CLI's server; a draft given by
  spec_draft_checkpoint loads its own weights and keeps JaxEngine's
  streams.
"""

import dataclasses
import json
import os
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers
from safetensors.torch import save_file

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.engine import JaxEngine
from dynamo_tpu.engine.request import SamplingParams as JaxSampling
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models import registry as jregistry
from dynamo_tpu_torch.cli.run import start_server
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.engine.request import SamplingParams
from dynamo_tpu_torch.models import checkpoint
from dynamo_tpu_torch.models import llama as tllama
from dynamo_tpu_torch.models import registry as tregistry
from tests.test_torch_families import _forward_pair
from tests.test_torch_kstep import _drive
from tests.test_torch_model import ATOL

#: the tiny shape every family's directory is written at
SHAPE = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2, head_dim=16, rms_norm_eps=1e-5)
#: family -> (transformers config class, model class, extra config fields)
FAMILIES = {
    "llama": ("LlamaConfig", "LlamaForCausalLM", dict(rope_theta=10000.0)),
    "qwen2": ("Qwen2Config", "Qwen2ForCausalLM", dict(rope_theta=1e6, tie_word_embeddings=True)),
    "qwen3": ("Qwen3Config", "Qwen3ForCausalLM", dict(rope_theta=1e6)),
    "phi3": ("Phi3Config", "Phi3ForCausalLM", dict(pad_token_id=0)),
    "gemma": ("GemmaConfig", "GemmaForCausalLM", dict(hidden_act="gelu_pytorch_tanh",
                                                      hidden_activation="gelu_pytorch_tanh")),
}


def _hf_model(family: str, seed: int = 0, dtype=torch.float32):
    cfg_cls, model_cls, extra = FAMILIES[family]
    shape = dict(SHAPE)
    if family == "phi3":  # Phi-3 derives head_dim from the width
        shape.pop("head_dim")
    cfg = getattr(transformers, cfg_cls)(**shape, **extra)
    torch.manual_seed(seed)
    model = getattr(transformers, model_cls)(cfg).eval()
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():  # live biases and norms, so every flag shows in the logits
        for name, p in model.named_parameters():
            if name.endswith("bias") or "norm" in name:
                p.add_(0.2 * torch.randn(p.shape, generator=gen))
    return model.to(dtype)


@pytest.fixture(scope="module")
def hf_dirs(tmp_path_factory):
    """family -> a directory saved by transformers (model.safetensors)."""
    out = {}
    for family in FAMILIES:
        d = str(tmp_path_factory.mktemp(family))
        _hf_model(family).save_pretrained(d, safe_serialization=True)
        out[family] = d
    return out


def _jax_params(adapter, path) -> dict:
    return jax.tree.map(jnp.asarray, adapter.load_params(path))


def _assert_config_like_reference(tcfg, jcfg):
    """Every field of the port's config equals the reference's, and every
    field only the reference has stands at its default (attention_impl, the
    reference's kernel choice, aside, and the window period, which
    from_hf_config sets to 1 and no layer reads without a window)."""
    names = {f.name for f in dataclasses.fields(tcfg)}
    assert jcfg.sliding_window == 0
    for f in dataclasses.fields(jcfg):
        want = getattr(jcfg, f.name)
        if f.name in ("attention_impl", "sliding_window_every"):
            continue
        if f.name == "dtype":
            assert str(getattr(tcfg, f.name)).split(".")[-1] == jnp.dtype(want).name
        elif f.name in names:
            assert getattr(tcfg, f.name) == want, f.name
        else:
            assert want == f.default, f.name


@pytest.mark.parametrize("family", FAMILIES)
def test_directory_config_and_forward_match_the_reference(hf_dirs, family):
    """Two prompts (16 and 13 tokens) in a first chunk of 8 and a chunk
    with history, then a decode step each: logits within 1e-4."""
    d = hf_dirs[family]
    tad = tregistry.get_model(d, dtype="float32")
    jad = jregistry.get_model(d, dtype="float32", attention_impl="pallas")
    assert tad.default_checkpoint == jad.default_checkpoint == d
    _assert_config_like_reference(tad.config, jad.config)
    tparams = tad.load_params(d, device="cpu")
    jparams = _jax_params(jad, d)
    tcfg, jcfg = tad.config, jad.config
    lens, t, s, mp, num_pages = (16, 13), 8, 4, 6, 16
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, tcfg.vocab_size, n).astype(np.int32) for n in lens]
    pt = (1 + rng.permutation(num_pages - 1)[: 2 * mp]).reshape(2, mp).astype(np.int32)
    jkv = jllama.init_kv_pages(jcfg, num_pages, s)
    tkv = tllama.init_kv_pages(tcfg, num_pages, s, device="cpu")
    for start in (0, t):
        n = [min(t, m - start) for m in lens]
        tokens = np.zeros((2, t), np.int32)
        for i, p in enumerate(prompts):
            tokens[i, :n[i]] = p[start:start + n[i]]
        positions = np.tile(np.arange(start, start + t, dtype=np.int32), (2, 1))
        valid = np.arange(t)[None, :] < np.asarray(n)[:, None]
        tl, jl, jkv, tkv = _forward_pair(jparams, tparams, jcfg, tcfg, tokens, positions,
                                         valid, jkv, tkv, pt, start == 0)
        for i in range(2):
            np.testing.assert_allclose(tl[i, :n[i]], jl[i, :n[i]], atol=ATOL)
    nxt = jl[np.arange(2), np.asarray(n) - 1].argmax(-1).astype(np.int32)[:, None]
    tl, jl, _, _ = _forward_pair(jparams, tparams, jcfg, tcfg, nxt,
                                 np.asarray(lens, np.int32)[:, None], np.ones((2, 1), bool),
                                 jkv, tkv, pt, False)
    np.testing.assert_allclose(tl, jl, atol=ATOL)


def _leaves(params) -> dict:
    out = {k: v for k, v in params.items() if k != "layers"}
    out.update({f"layers.{k}": v for k, v in params["layers"].items()})
    return out


def test_shards_and_bin_load_bit_equal_to_the_single_file(hf_dirs, tmp_path):
    """The Phi-3 model (fused tensors) as 2 safetensors shards and as
    pytorch_model.bin gives the single file's params bit for bit."""
    model = _hf_model("phi3")
    total = sum(p.numel() * p.element_size() for p in model.parameters())
    sharded, binary = str(tmp_path / "sharded"), str(tmp_path / "bin")
    model.save_pretrained(sharded, max_shard_size=total // 2 + 1024)
    model.save_pretrained(binary, safe_serialization=False)
    assert os.path.exists(os.path.join(sharded, "model.safetensors.index.json"))
    with open(os.path.join(sharded, "model.safetensors.index.json")) as f:
        assert len(set(json.load(f)["weight_map"].values())) == 2
    assert os.listdir(binary).count("pytorch_model.bin") == 1
    adapter = tregistry.get_model(hf_dirs["phi3"], dtype="float32")
    want = _leaves(adapter.load_params(hf_dirs["phi3"], device="cpu"))
    for d in (sharded, binary):
        got = _leaves(adapter.load_params(d, device="cpu"))
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), (d, k)


@pytest.mark.parametrize("family", ["llama", "qwen2"])
def test_a_bf16_file_loads_bit_equal_to_the_reference(tmp_path, family):
    d = str(tmp_path / family)
    _hf_model(family, seed=5, dtype=torch.bfloat16).save_pretrained(d)
    tparams = _leaves(tregistry.get_model(d, dtype="bfloat16").load_params(d, device="cpu"))
    jparams = _leaves(jregistry.get_model(d, dtype="bfloat16").load_params(d))
    assert tparams.keys() == jparams.keys()
    for k, got in tparams.items():
        assert got.dtype == torch.bfloat16
        want = np.asarray(jparams[k]).view(np.uint16)
        np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16), want,
                                      err_msg=k)


# -- published configs and refusals ------------------------------------------------------

#: each served preset's published config.json (the fields from_hf_config
#: reads, and the ones that identify the family), by HF repository
PUBLISHED = {
    # meta-llama/Llama-3.2-1B
    "llama3-1b": dict(architectures=["LlamaForCausalLM"], model_type="llama", hidden_act="silu",
                      hidden_size=2048, intermediate_size=8192, num_hidden_layers=16,
                      num_attention_heads=32, num_key_value_heads=8, head_dim=64,
                      rms_norm_eps=1e-05, rope_theta=500000.0, vocab_size=128256,
                      tie_word_embeddings=True, attention_bias=False, mlp_bias=False,
                      rope_scaling=dict(factor=32.0, high_freq_factor=4.0, low_freq_factor=1.0,
                                        original_max_position_embeddings=8192,
                                        rope_type="llama3")),
    # meta-llama/Meta-Llama-3-8B
    "llama3-8b": dict(architectures=["LlamaForCausalLM"], model_type="llama", hidden_act="silu",
                      hidden_size=4096, intermediate_size=14336, num_hidden_layers=32,
                      num_attention_heads=32, num_key_value_heads=8, rms_norm_eps=1e-05,
                      rope_theta=500000.0, vocab_size=128256, tie_word_embeddings=False,
                      rope_scaling=None),
    # meta-llama/Meta-Llama-3-70B
    "llama3-70b": dict(architectures=["LlamaForCausalLM"], model_type="llama",
                       hidden_act="silu", hidden_size=8192, intermediate_size=28672,
                       num_hidden_layers=80, num_attention_heads=64, num_key_value_heads=8,
                       rms_norm_eps=1e-05, rope_theta=500000.0, vocab_size=128256,
                       tie_word_embeddings=False, rope_scaling=None),
    # Qwen/Qwen2-7B (the Qwen2 window keys are read by neither package)
    "qwen2-7b": dict(architectures=["Qwen2ForCausalLM"], model_type="qwen2", hidden_act="silu",
                     hidden_size=3584, intermediate_size=18944, num_hidden_layers=28,
                     num_attention_heads=28, num_key_value_heads=4, rms_norm_eps=1e-06,
                     rope_theta=1000000.0, vocab_size=152064, tie_word_embeddings=False,
                     sliding_window=131072, use_sliding_window=False, max_window_layers=28),
    # Qwen/Qwen2.5-0.5B
    "qwen2-0.5b": dict(architectures=["Qwen2ForCausalLM"], model_type="qwen2",
                       hidden_act="silu", hidden_size=896, intermediate_size=4864,
                       num_hidden_layers=24, num_attention_heads=14, num_key_value_heads=2,
                       rms_norm_eps=1e-06, rope_theta=1000000.0, vocab_size=151936,
                       tie_word_embeddings=True, sliding_window=32768,
                       use_sliding_window=False),
    # Qwen/Qwen3-8B
    "qwen3-8b": dict(architectures=["Qwen3ForCausalLM"], model_type="qwen3", hidden_act="silu",
                     hidden_size=4096, intermediate_size=12288, num_hidden_layers=36,
                     num_attention_heads=32, num_key_value_heads=8, head_dim=128,
                     rms_norm_eps=1e-06, rope_theta=1000000, vocab_size=151936,
                     tie_word_embeddings=False, attention_bias=False, rope_scaling=None),
    # microsoft/Phi-3-mini-4k-instruct (its sliding_window is read by neither)
    "phi3-mini": dict(architectures=["Phi3ForCausalLM"], model_type="phi3", hidden_act="silu",
                      hidden_size=3072, intermediate_size=8192, num_hidden_layers=32,
                      num_attention_heads=32, num_key_value_heads=32, rms_norm_eps=1e-05,
                      rope_theta=10000.0, vocab_size=32064, tie_word_embeddings=False,
                      rope_scaling=None, sliding_window=2047),
    # microsoft/phi-4
    "phi4": dict(architectures=["Phi3ForCausalLM"], model_type="phi3", hidden_act="silu",
                 hidden_size=5120, intermediate_size=17920, num_hidden_layers=40,
                 num_attention_heads=40, num_key_value_heads=10, rms_norm_eps=1e-05,
                 rope_theta=250000, vocab_size=100352, tie_word_embeddings=False,
                 rope_scaling=None),
    # google/gemma-2b
    "gemma-2b": dict(architectures=["GemmaForCausalLM"], model_type="gemma", hidden_act="gelu",
                     hidden_size=2048, intermediate_size=16384, num_hidden_layers=18,
                     num_attention_heads=8, num_key_value_heads=1, head_dim=256,
                     rms_norm_eps=1e-06, rope_theta=10000.0, vocab_size=256000),
    # google/gemma-7b
    "gemma-7b": dict(architectures=["GemmaForCausalLM"], model_type="gemma", hidden_act="gelu",
                     hidden_size=3072, intermediate_size=24576, num_hidden_layers=28,
                     num_attention_heads=16, num_key_value_heads=16, head_dim=256,
                     rms_norm_eps=1e-06, rope_theta=10000.0, vocab_size=256000),
}


@pytest.mark.parametrize("preset", PUBLISHED)
def test_published_configs_map_onto_the_presets(preset):
    cfg = tllama.LlamaConfig.from_hf_config(PUBLISHED[preset])
    assert cfg == tregistry._LLAMA_PRESETS[preset]()
    _assert_config_like_reference(cfg, jllama.LlamaConfig.from_hf_config(PUBLISHED[preset]))


def test_the_distill_preset_lacks_its_published_rope_scaling():
    """deepseek-ai/DeepSeek-R1-Distill-Llama-8B is Llama-3.1-8B: its
    config.json carries llama3 rope scaling (factor 8), which the preset
    (llama3_8b's config, in both packages) leaves out."""
    published = dict(PUBLISHED["llama3-8b"], rope_scaling=dict(
        factor=8.0, high_freq_factor=4.0, low_freq_factor=1.0,
        original_max_position_embeddings=8192, rope_type="llama3"))
    preset = tregistry._LLAMA_PRESETS["deepseek-r1-distill-llama-8b"]()
    assert tllama.LlamaConfig.from_hf_config(published) == dataclasses.replace(
        preset, rope_scaling_factor=8.0)
    assert jregistry._LLAMA_PRESETS["deepseek-r1-distill-llama-8b"]().rope_scaling_factor is None


_BASE = PUBLISHED["llama3-8b"]


@pytest.mark.parametrize("change,match", [
    (dict(architectures=["MistralForCausalLM"], model_type="mistral", sliding_window=4096),
     "sliding_window"),
    (dict(architectures=["Gemma2ForCausalLM"], model_type="gemma2"), "softcaps"),
    (dict(architectures=["Gemma3ForCausalLM"], model_type="gemma3_text"), "windows"),
    (dict(architectures=["Llama4ForCausalLM"], model_type="llama4_text"), "Llama-4"),
    (dict(architectures=["GptOssForCausalLM"], model_type="gpt_oss"), "GPT-OSS"),
    (dict(architectures=["MixtralForCausalLM"], model_type="mixtral"), "MoE"),
    (dict(architectures=["Qwen3MoeForCausalLM"], model_type="qwen3_moe"), "MoE"),
    (dict(architectures=["DeepseekV2ForCausalLM"], model_type="deepseek_v2"), "MLA"),
    (dict(architectures=["Qwen2VLForConditionalGeneration"], model_type="qwen2_vl"), "VL"),
    (dict(architectures=["GPT2LMHeadModel"], model_type="gpt2"), "unsupported architecture"),
    (dict(rope_scaling=dict(rope_type="yarn", factor=4.0)), "yarn"),
    (dict(rope_scaling=dict(type="linear", factor=2.0)), "linear"),
    (dict(rope_scaling=dict(type="longrope", short_factor=[1.0])), "longrope"),
    (dict(rope_scaling=dict(rope_type="dynamic", factor=2.0)), "dynamic"),
    (dict(hidden_act="relu"), "hidden_act"),
    (dict(partial_rotary_factor=0.75), "partial_rotary_factor"),
    (dict(quantization_config=dict(quant_method="gptq", bits=4)), "gptq"),
])
def test_configs_without_a_forward_are_refused_by_name(change, match):
    with pytest.raises(ValueError, match=match):
        tllama.LlamaConfig.from_hf_config({**_BASE, **change})


def test_files_the_forward_would_not_read_are_refused_by_name(hf_dirs, tmp_path):
    """An int8 tensor, a tensor the forward does not read (an o_proj bias)
    and a missing one are each refused, naming the tensor."""
    adapter = tregistry.get_model(hf_dirs["llama"], dtype="float32")
    sd = dict(checkpoint.load_state_dict(hf_dirs["llama"]))
    for name, tensors, match in (
            ("int8", {**sd, "model.layers.0.mlp.up_proj.weight":
                      torch.zeros((128, 64), dtype=torch.int8)}, "I8"),
            ("extra", {**sd, "model.layers.0.self_attn.o_proj.bias": torch.zeros(64)},
             "o_proj.bias"),
            ("missing", {k: v for k, v in sd.items() if "layers.1.mlp.down" not in k},
             "layers.1.mlp.down_proj.weight")):
        d = tmp_path / name
        d.mkdir()
        save_file({k: v.contiguous() for k, v in tensors.items()},
                  str(d / "model.safetensors"))
        with pytest.raises(ValueError, match=match):
            adapter.load_params(str(d), device="cpu")


@pytest.mark.parametrize("kind,change,match", [
    ("dir", dict(head_dim=80), "head_dim 80 is not served on the card"),
    ("dir", dict(num_attention_heads=130, num_key_value_heads=1, head_dim=64),
     "query group of 130 heads"),
    ("gguf", dict(head_dim=80), "head_dim 80 is not served on the card"),
])
def test_shapes_the_kernels_cannot_run_are_refused_before_a_load_to_the_card(
        tmp_path, kind, change, match):
    """A directory or GGUF file whose config maps, but whose head_dim no
    CUDA kernel takes or whose query group is over the prefill kernels'
    128 rows, is refused by name when it is loaded onto the card, before
    any weight is read (the files hold none). get_model and a load onto
    the CPU, whose plain versions take any shape, go on to the weights."""
    if kind == "dir":
        path = str(tmp_path)
        (tmp_path / "config.json").write_text(json.dumps({**_BASE, **change}))
        missing = (FileNotFoundError, None)
    else:
        from dynamo_tpu import gguf as jgguf
        from tests.test_torch_gguf import SHAPE as GSHAPE, _md

        path = str(tmp_path / "m.gguf")
        jgguf.write_gguf(path, _md("llama", {**GSHAPE, **change}), {})
        missing = (ValueError, "are missing")
    adapter = tregistry.get_model(path)
    with pytest.raises(ValueError, match=match):
        adapter.load_params(path, device="cuda")
    with pytest.raises(missing[0], match=missing[1]):
        adapter.load_params(path, device="cpu")


# -- engines -----------------------------------------------------------------------------

PROMPTS = [[5, 17, 42, 9, 88, 3, 200, 7, 7, 31, 64], [250, 1, 2, 3], [99] * 6]


def _greedy_streams(eng, sampling_cls, n=10) -> dict:
    return _drive(eng, sampling_cls, [(f"r{i}", p, dict(temperature=0.0, max_tokens=n,
                                                        ignore_eos=True))
                                      for i, p in enumerate(PROMPTS)])


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_engine_streams_on_a_directory_equal_jax(hf_dirs, quantize):
    d = hf_dirs["qwen2"]
    knobs = dict(model=d, quantize=quantize, enable_prefix_caching=False)
    jax_eng = JaxEngine(JaxEngineConfig.for_tests(**knobs))
    want = _greedy_streams(jax_eng, JaxSampling)
    eng = TorchEngine(EngineConfig.for_tests(**knobs, mixed_steps=jax_eng.config.mixed_steps),
                      device="cpu")
    assert eng.adapter.default_checkpoint == d
    assert (eng.params["layers"]["wq"].dtype == torch.int8) == (quantize == "int8")
    assert _greedy_streams(eng, SamplingParams) == want


def test_the_cli_serves_a_directory_as_its_engine_does(hf_dirs):
    """--model <dir>: the card serves the byte tokenizer (no
    tokenizer_config.json), and a greedy completion's ids equal an
    in-process engine's on the same files."""
    d = hf_dirs["llama"]
    server = start_server(["run", "in=http", "out=torch", "--model", d, "--port", "0",
                           "--device", "cpu", "--dtype", "float32", "--page-size", "4",
                           "--max-context", "64", "--num-pages", "48", "--prefill-chunk", "16"])
    try:
        body = {"model": d, "prompt": "hello checkpoint", "max_tokens": 6,
                "ext": {"ignore_eos": True, "return_token_ids": True}}
        req = urllib.request.Request(server.url + "/v1/completions",
                                     data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            got = json.load(r)["choices"][0]["token_ids"]
    finally:
        server.stop()
    eng = TorchEngine(EngineConfig.for_tests(model=d, max_pages_per_seq=16), device="cpu")
    want = _drive(eng, SamplingParams, [("r", list(b"hello checkpoint"),
                                         dict(temperature=0.0, max_tokens=6, ignore_eos=True))])
    assert got == want["r"]


def test_a_draft_checkpoint_loads_its_own_weights_and_keeps_jax_streams(hf_dirs, tmp_path):
    """Target: the Llama directory; draft: the `tiny` preset with
    spec_draft_checkpoint naming a second directory of tiny's shape. Both
    engines load the draft from the file: its params equal the file's, the
    greedy streams and spec counters equal JaxEngine's."""
    draft_dir = str(tmp_path / "draft")
    cfg = transformers.LlamaConfig(**{**SHAPE, "rope_theta": 10000.0})
    torch.manual_seed(11)
    transformers.LlamaForCausalLM(cfg).save_pretrained(draft_dir)
    knobs = dict(model=hf_dirs["llama"], spec_draft_model="tiny", spec_draft_tokens=3,
                 spec_draft_checkpoint=draft_dir, enable_prefix_caching=False)
    jax_eng = JaxEngine(JaxEngineConfig.for_tests(**knobs))
    want = _greedy_streams(jax_eng, JaxSampling)
    eng = TorchEngine(EngineConfig.for_tests(**knobs, mixed_steps=jax_eng.config.mixed_steps),
                      device="cpu")
    sd = checkpoint.load_state_dict(draft_dir)
    assert torch.equal(eng.draft_params["layers"]["wq"][1],
                       sd["model.layers.1.self_attn.q_proj.weight"].T)
    assert eng.draft_params["layers"]["wq"].data_ptr() != eng.params["layers"]["wq"].data_ptr()
    assert _greedy_streams(eng, SamplingParams) == want
    assert (eng.metrics.spec_drafted, eng.metrics.spec_accepted) == \
        (jax_eng.metrics.spec_drafted, jax_eng.metrics.spec_accepted)
    assert eng.metrics.spec_drafted > 0


def test_a_self_draft_named_by_its_directory_shares_the_targets_tree(hf_dirs):
    """The draft's name is the target's directory and no draft checkpoint
    is given: the draft is the target's own tree, not a second load."""
    d = hf_dirs["llama"]
    eng = TorchEngine(EngineConfig.for_tests(model=d, spec_draft_model=d), device="cpu")
    assert eng.draft_adapter.default_checkpoint == d
    assert eng.draft_params is eng.params
