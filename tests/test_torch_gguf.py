"""GGUF files in the port (dynamo_tpu_torch/gguf.py), against the reference.

The files are written here by the reference's `dynamo_tpu.gguf.write_gguf`:
- the reader: metadata of every value type, the tensor index and every
  tensor type (F32, F16, BF16, Q4_0, Q4_1, Q5_0, Q5_1, Q8_0, Q4_K, Q5_K,
  Q6_K) bit-equal to the reference's `load_tensor`;
- `to_llama_config` equal to the reference's for the llama, qwen2, qwen3
  and gemma architectures, gemma2/gemma3 and a linear rope refused by name;
- `params_from_gguf` on a `llama` file (q/k rows in llama.cpp's permuted
  order), a `qwen2` file (q/k/v biases, not permuted) and a `qwen3` file
  (q/k norms): the params equal the reference's, and the fp32 forward over
  a first chunk, a chunk with history and a decode step is within 1e-4 of
  the reference's Pallas path;
- `GgufTokenizer` ids, decode, token_bytes and DecodeStream deltas equal
  the reference's for both vocabulary styles (tests/test_gguf.py:190-287);
- the CLI's card for a .gguf model equals the reference's `_card`, and its
  server serves the file as an in-process engine does.
"""

import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu import gguf as jgguf
from dynamo_tpu.cli import run as jcli
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models import registry as jregistry
from dynamo_tpu.preprocessor.detokenize import DecodeStream as JaxDecodeStream
from dynamo_tpu.preprocessor.tokenizer import GgufTokenizer as JaxGgufTokenizer
from dynamo_tpu_torch import gguf
from dynamo_tpu_torch.cli import run as cli_run
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.engine.request import SamplingParams
from dynamo_tpu_torch.models import registry as tregistry
from dynamo_tpu_torch.preprocessor.detokenize import DecodeStream
from dynamo_tpu_torch.preprocessor.tokenizer import GgufTokenizer, load_tokenizer
from tests.test_torch_checkpoint import _leaves
from tests.test_torch_families import _forward_pair
from tests.test_torch_kstep import _drive
from tests.test_torch_model import ATOL
from tests.test_torch_tokenizer import CORPUS

#: the tiny shape of every model file
SHAPE = dict(vocab_size=300, hidden_size=64, intermediate_size=128, num_layers=2, num_heads=4,
             num_kv_heads=2, head_dim=16)


def _quant_payload(ggml_type: int, n: int, rng) -> bytes:
    """n elements of a quantized type: random bytes, every f16 scale a
    small finite value."""
    elts, nbytes = jgguf._QUANT_BLOCKS[ggml_type]
    b = rng.integers(0, 256, (n // elts, nbytes), dtype=np.uint8)
    scales = {2: (0,), 3: (0, 2), 6: (0,), 7: (0, 2), 8: (0,), 12: (0, 2), 13: (0, 2),
              14: (208,)}[ggml_type]
    for off in scales:
        b[:, off:off + 2] = rng.uniform(0.001, 0.1, (n // elts, 1)).astype("<f2").view(np.uint8)
    return b.tobytes()


def test_metadata_and_every_tensor_type_equal_the_reference(tmp_path):
    rng = np.random.default_rng(0)
    path = str(tmp_path / "types.gguf")
    md = {"general.architecture": "llama", "general.name": "types", "truthy": True,
          "neg": -7, "pi": 3.25, "ints": [1, 2, 3], "floats": [0.5, -1.5],
          "words": ["a", "▁b", "<0x0A>", "日本"], "flags": [True, False]}
    tensors = {
        "f32": rng.normal(size=(3, 64)).astype(np.float32),
        "f16": rng.normal(size=(2, 32)).astype(np.float16),
        "bf16": (30, (4, 8), (rng.normal(size=32).astype(np.float32).view(np.uint32) >> 16)
                 .astype(np.uint16).tobytes()),
        "q8_0_packed": (8, (2, 64), jgguf.quantize_q8_0(rng.normal(size=128))),
    }
    for t in (2, 3, 6, 7, 8, 12, 13, 14):
        tensors[f"type{t}"] = (t, (2, 256), _quant_payload(t, 512, rng))
    jgguf.write_gguf(path, md, tensors)
    ref, got = jgguf.read_gguf(path, use_cache=False), gguf.read_gguf(path)
    assert got.metadata == ref.metadata
    assert (got.version, got.data_start, got.alignment) == (ref.version, ref.data_start,
                                                            ref.alignment)
    assert {k: (v.shape, v.ggml_type, v.offset) for k, v in got.tensors.items()} == \
        {k: (v.shape, v.ggml_type, v.offset) for k, v in ref.tensors.items()}
    for name in tensors:
        want, have = ref.load_tensor(name), got.load_tensor(name)
        assert have.dtype == want.dtype and have.shape == want.shape, name
        np.testing.assert_array_equal(np.asarray(have).view(np.uint8),
                                      np.asarray(want).view(np.uint8), err_msg=name)
    with pytest.raises(KeyError):
        got.load_tensor("missing")
    x = rng.normal(size=(4, 96)).astype(np.float32)
    assert gguf.quantize_q8_0(x) == jgguf.quantize_q8_0(x)
    # the port's writer gives the reference's bytes
    mine = str(tmp_path / "mine.gguf")
    gguf.write_gguf(mine, md, tensors)
    with open(path, "rb") as a, open(mine, "rb") as b:
        assert a.read() == b.read()


def _md(arch: str, cfg, extra=()) -> dict:
    """A model file's metadata for `cfg` (tests/test_gguf.py::_family_md)."""
    md = {
        "general.architecture": arch,
        f"{arch}.block_count": cfg["num_layers"],
        f"{arch}.embedding_length": cfg["hidden_size"],
        f"{arch}.feed_forward_length": cfg["intermediate_size"],
        f"{arch}.attention.head_count": cfg["num_heads"],
        f"{arch}.attention.head_count_kv": cfg["num_kv_heads"],
        f"{arch}.attention.key_length": cfg["head_dim"],
        f"{arch}.attention.layer_norm_rms_epsilon": 1e-5,
        f"{arch}.rope.freq_base": 10000.0,
        f"{arch}.vocab_size": cfg["vocab_size"],
        f"{arch}.context_length": 48,
        "tokenizer.ggml.model": "gpt2",
        "tokenizer.ggml.tokens": _gpt2_vocab(cfg["vocab_size"]),
        "tokenizer.ggml.eos_token_id": 3,
    }
    md.update(extra)
    return md


@pytest.mark.parametrize("arch,extra", [
    ("llama", {"llama.rope.scaling.factor": 8.0}), ("qwen2", {}), ("qwen3", {}), ("gemma", {}),
])
def test_to_llama_config_equals_the_reference(tmp_path, arch, extra):
    from tests.test_torch_checkpoint import _assert_config_like_reference

    path = str(tmp_path / f"{arch}.gguf")
    jgguf.write_gguf(path, _md(arch, SHAPE, extra), {})
    g = gguf.read_gguf(path)
    _assert_config_like_reference(g.to_llama_config(),
                                  jgguf.read_gguf(path, use_cache=False).to_llama_config())
    assert g.context_length() == 48 and g.architecture() == arch


@pytest.mark.parametrize("arch,extra,match", [
    ("gemma2", {}, "softcaps"), ("gemma3", {}, "windows"), ("phi2", {}, "phi2"),
    ("llama", {"llama.rope.scaling.type": "linear"}, "linear"),
])
def test_unserved_files_are_refused_by_name(tmp_path, arch, extra, match):
    path = str(tmp_path / f"{arch}.gguf")
    jgguf.write_gguf(path, _md(arch, SHAPE, extra), {})
    with pytest.raises(ValueError, match=match):
        tregistry.get_model(path)


def _permute_rows(w: np.ndarray, n_head: int) -> np.ndarray:
    """llama.cpp's convert_hf_to_gguf permute of q/k rows [out, in]."""
    out, inn = w.shape
    return w.reshape(n_head, 2, out // n_head // 2, inn).swapaxes(1, 2).reshape(out, inn)


def _model_file(path: str, arch: str, seed: int) -> None:
    """A random model of SHAPE in `arch`'s tensors, f32 (the norms and
    biases f16), q/k rows permuted for `llama`, with a gpt2 vocabulary."""
    jcfg = jllama.LlamaConfig(**SHAPE, attention_bias=arch == "qwen2", qk_norm=arch == "qwen3",
                              rope_theta=10000.0, dtype=jnp.float32)
    params = jax.tree.map(np.asarray, jllama.init_params(jax.random.key(seed), jcfg))
    rng = np.random.default_rng(seed)
    lp = params["layers"]
    t = {"token_embd.weight": params["embed"],
         "output_norm.weight": (1 + 0.2 * rng.normal(size=64)).astype(np.float16),
         "output.weight": params["lm_head"].T.copy()}
    for li in range(SHAPE["num_layers"]):
        def put(name, w):
            t[f"blk.{li}.{name}"] = np.ascontiguousarray(w)
        wq, wk = lp["wq"][li].T, lp["wk"][li].T
        if arch == "llama":
            wq, wk = _permute_rows(wq, SHAPE["num_heads"]), _permute_rows(wk, SHAPE["num_kv_heads"])
        put("attn_q.weight", wq)
        put("attn_k.weight", wk)
        for name, leaf in (("attn_v", "wv"), ("attn_output", "wo"), ("ffn_gate", "w_gate"),
                           ("ffn_up", "w_up"), ("ffn_down", "w_down")):
            put(f"{name}.weight", lp[leaf][li].T)
        for name in ("attn_norm", "ffn_norm"):
            put(f"{name}.weight", (1 + 0.2 * rng.normal(size=64)).astype(np.float16))
        if arch == "qwen2":
            for name, width in (("attn_q", 64), ("attn_k", 32), ("attn_v", 32)):
                put(f"{name}.bias", (0.2 * rng.normal(size=width)).astype(np.float32))
        if arch == "qwen3":
            for name in ("attn_q_norm", "attn_k_norm"):
                put(f"{name}.weight", (1 + 0.2 * rng.normal(size=16)).astype(np.float32))
    jgguf.write_gguf(path, _md(arch, SHAPE), t)


@pytest.mark.parametrize("arch", ["llama", "qwen2", "qwen3"])
def test_params_and_forward_equal_the_reference(tmp_path, arch):
    path = str(tmp_path / f"{arch}.gguf")
    _model_file(path, arch, seed=len(arch))
    tad = tregistry.get_model(path, dtype="float32")
    jad = jregistry.get_model(path, dtype="float32", attention_impl="pallas")
    assert tad.default_checkpoint == path
    tparams = tad.load_params(path, device="cpu")
    jparams = jax.tree.map(jnp.asarray, jad.load_params(path))
    got, want = _leaves(tparams), _leaves(jparams)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    tcfg, jcfg = tad.config, jad.config
    lens, t, s, mp, num_pages = (16, 11), 8, 4, 6, 16
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, tcfg.vocab_size, n).astype(np.int32) for n in lens]
    pt = (1 + rng.permutation(num_pages - 1)[: 2 * mp]).reshape(2, mp).astype(np.int32)
    jkv = jllama.init_kv_pages(jcfg, num_pages, s)
    tkv = tad.init_kv(num_pages, s, "cpu")
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
    if arch == "llama":  # in bf16 too, bit for bit (f32 and f16 rounded once)
        bf = _leaves(tregistry.get_model(path).load_params(path, device="cpu"))
        jbf = _leaves(jregistry.get_model(path).load_params(path))
        for k in jbf:
            np.testing.assert_array_equal(bf[k].view(torch.int16).numpy().view(np.uint16),
                                          np.asarray(jbf[k]).view(np.uint16), err_msg=k)


# -- vocabularies ----------------------------------------------------------------------------


def _gpt2_vocab(n: int) -> list[str]:
    """A byte-level vocabulary: specials, the 256 byte-alphabet symbols,
    then pieces cut from the corpus's byte-mapped words."""
    b2u = jgguf_b2u()
    vocab = ["<unk>", "<|begin|>", "<|pad|>", "<|eot|>"] + [b2u[b] for b in range(256)]
    words = [w for text in CORPUS for w in text.split(" ") if w]
    for w in words:
        mapped = "".join(b2u[b] for b in (" " + w).encode())
        for piece in (mapped, mapped[:3], mapped[1:4], mapped[:-1]):
            if len(vocab) < n and piece and piece not in vocab:
                vocab.append(piece)
    return (vocab + [f"<extra{i}>" for i in range(n)])[:n]


def jgguf_b2u() -> dict[int, str]:
    from dynamo_tpu.preprocessor.tokenizer import _gpt2_byte_table

    return _gpt2_byte_table()


def _spm_vocab() -> list[str]:
    """A SentencePiece vocabulary: specials, the <0xNN> byte pieces, then
    ▁-prefixed words and their pieces from the corpus."""
    vocab = ["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)] + ["▁", "\n\n"]
    for text in CORPUS:
        for w in text.split(" "):
            for piece in ("▁" + w, w[:2], w[1:3], "▁" + w[:3]):
                if piece.strip("▁") and piece not in vocab:
                    vocab.append(piece)
    return vocab


@pytest.mark.parametrize("style", ["llama", "gpt2"])
def test_gguf_tokenizer_equals_the_reference(tmp_path, style):
    path = str(tmp_path / f"{style}.gguf")
    tokens = _spm_vocab() if style == "llama" else _gpt2_vocab(600)
    jgguf.write_gguf(path, {"general.architecture": "llama", "tokenizer.ggml.model": style,
                            "tokenizer.ggml.tokens": tokens, "tokenizer.ggml.eos_token_id": 2},
                     {})
    ref = JaxGgufTokenizer(path)
    tok = load_tokenizer({"kind": "gguf", "path": path})
    assert isinstance(tok, GgufTokenizer)
    assert (tok.kind, tok.vocab_size, tok.eos_token_ids) == (ref.kind, ref.vocab_size,
                                                             ref.eos_token_ids)
    for text in CORPUS + ["\n\nhi there", " leading space"]:
        ids = ref.encode(text)
        assert tok.encode(text) == ids, text
        assert tok.decode(ids) == ref.decode(ids), text
        jstream, tstream = JaxDecodeStream(ref), DecodeStream(tok)
        assert [tstream.step(i) for i in ids] == [jstream.step(i) for i in ids], text
    every = list(range(-1, len(tokens) + 2))
    assert [tok.token_bytes(i) for i in every] == [ref.token_bytes(i) for i in every]
    assert tok.decode(every[1:]) == ref.decode(every[1:])


def test_the_cli_card_and_server_on_a_gguf_file(tmp_path):
    """The card: the file's vocabulary, its EOS id and the context capped
    at the file's 48, as the reference's `_card`; the server answers a
    greedy completion with the ids an in-process engine gives for the
    GgufTokenizer's ids of the prompt."""
    path = str(tmp_path / "model.gguf")
    _model_file(path, "llama", seed=9)
    argv = ["run", "in=http", "out=torch", "--model", path, "--port", "0", "--device", "cpu",
            "--dtype", "float32", "--page-size", "4", "--max-context", "64", "--num-pages", "48",
            "--prefill-chunk", "16"]
    card = cli_run.model_card(cli_run._parse(argv))
    jcard = jcli._card(jcli.build_parser().parse_args(
        ["run", "--model", path, "--page-size", "4", "--max-context", "64"]))
    assert (card.tokenizer, card.context_length, card.eos_token_ids, card.kv_page_size) == \
        (jcard.tokenizer, jcard.context_length, jcard.eos_token_ids, jcard.kv_page_size) == \
        ({"kind": "gguf", "path": path}, 48, (3,), 4)
    server = cli_run.start_server(argv)
    try:
        body = {"model": path, "prompt": "hello world, it's", "max_tokens": 5,
                "ext": {"ignore_eos": True, "return_token_ids": True}}
        req = urllib.request.Request(server.url + "/v1/completions",
                                     data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            got = json.load(r)["choices"][0]["token_ids"]
    finally:
        server.stop()
    prompt = GgufTokenizer(path).encode("hello world, it's")
    eng = TorchEngine(EngineConfig.for_tests(model=path, max_pages_per_seq=12), device="cpu")
    want = _drive(eng, SamplingParams, [("r", prompt, dict(temperature=0.0, max_tokens=5,
                                                           ignore_eos=True))])
    assert got == want["r"]
