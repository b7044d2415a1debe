"""The port's HfTokenizer against the reference's, on tokenizer.json files
trained here with `tokenizers` and saved by transformers.

The kinds (each with "<|eot|>" added as the eos and an extra special
token, so special tokens inside text split out and decode drops them, a
special token that strips the whitespace beside it, and a normalized
non-special token matched as a single word only):
- `llama3`: byte-level BPE with Llama-3's `Split` pattern, `ByteLevel`
  without its regex, `ignore_merges`, the ByteLevel decoder;
- `gpt2_nfc`: the NFC normalizer before `ByteLevel` with GPT-2's regex;
- `spm`: SentencePiece-style BPE, the Prepend/Replace normalizer,
  `byte_fallback` over <0xNN> pieces, unk fusing, and the Replace,
  ByteFallback, Fuse, Strip decoders (Llama-2, Phi-3);
- `metaspace`: the same model under the `Metaspace` pre-tokenizer and
  decoder (prepend scheme "first");
- `wordlevel`: WordLevel with `Whitespace`, the reference's own fixture
  (tests/test_checkpoint_e2e.py:25-45), clean_up_tokenization_spaces on.

On a corpus of ASCII, contractions, digit runs, whitespace and newline
runs, accented Latin (composed and decomposed), CJK, emoji, '½²Ⅻ', other
marks and special tokens inside text: ids, decode, token_bytes over the
whole vocabulary, vocab_size, eos_token_ids and the DecodeStream deltas
equal the reference's. A tokenizer with a chat template renders it as the
reference does, through the HTTP server too, and one without serves the
structured fallback, as the reference does (the templates themselves:
tests/test_torch_chat_template.py).
"""

import json
import os
import shutil
import urllib.error
import urllib.request

import pytest
from tokenizers import (
    AddedToken,
    Regex,
    Tokenizer,
    decoders,
    models,
    normalizers,
    pre_tokenizers,
    trainers,
)
from transformers import PreTrainedTokenizerFast

from dynamo_tpu.preprocessor.detokenize import DecodeStream as JaxDecodeStream
from dynamo_tpu.preprocessor.tokenizer import HfTokenizer as JaxHfTokenizer
from dynamo_tpu_torch.cli.run import start_server
from dynamo_tpu_torch.preprocessor.detokenize import DecodeStream
from dynamo_tpu_torch.preprocessor.tokenizer import (
    HfTokenizer,
    load_tokenizer,
    render_fallback_template,
)

LLAMA3_SPLIT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}"
                r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
EOT, EXTRA = "<|eot|>", "<|tool|>"
CORPUS = [
    "Hello world, it's 2024 and 1234567 things. I'm sure you're right; we've seen they'll go.",
    "DON'T SHOUT 'S 'LL 'Ve",
    "caf\u00e9 na\u00efve r\u00e9sum\u00e9 \u00c5ngstr\u00f6m cr\u00e8me br\u00fbl\u00e9e",
    "cafe\u0301 nai\u0308ve",  # decomposed: combining marks
    "日本語のテキストと中文字符 한국어",
    "emoji 😀🎉👍🏽 👨‍👩‍👧",
    "½²Ⅻ ③ ٣ Ⓐ x²+y² ⅓",
    "  two leading\n\n\nnewlines\t\ttabs   \n  and\r\nCRLF   ",
    "numbers 3.14159 -42 1,000,000 0x1F",
    f"special{EOT}inside{EOT} text {EXTRA}here{EOT}",
    "<|end|>   after the end  <|end|>x\n<|end|>",
    "hello hellos xhello hello. (hello)",
    "",
    " ",
    "ünïcödé nbsp em　ideographic",
]
TRAIN = CORPUS * 20


def _spm_model(vocab_size: int = 320) -> models.BPE:
    """SentencePiece-style BPE: trained merges over ▁-joined words, then
    the 256 <0xNN> pieces appended to the model's vocabulary (not as added
    tokens), as a Llama-2 tokenizer.json holds them."""
    t = Tokenizer(models.BPE(unk_token="<unk>", fuse_unk=True))
    t.normalizer = normalizers.Sequence([normalizers.Prepend("▁"), normalizers.Replace(" ", "▁")])
    t.train_from_iterator(TRAIN, trainers.BpeTrainer(vocab_size=vocab_size,
                                                     special_tokens=["<unk>", "<s>", "</s>"]))
    trained = json.loads(t.to_str())["model"]
    vocab = dict(trained["vocab"])
    for b in range(256):
        vocab.setdefault(f"<0x{b:02X}>", len(vocab))
    return models.BPE(vocab=vocab, merges=[tuple(m) for m in trained["merges"]],
                      unk_token="<unk>", fuse_unk=True, byte_fallback=True)


def _build(kind: str) -> tuple[Tokenizer, dict]:
    """A tokenizer of `kind` and the extra tokenizer_config fields."""
    if kind in ("llama3", "gpt2_nfc"):
        t = Tokenizer(models.BPE(ignore_merges=kind == "llama3"))
        if kind == "llama3":
            t.pre_tokenizer = pre_tokenizers.Sequence([
                pre_tokenizers.Split(Regex(LLAMA3_SPLIT), behavior="isolated"),
                pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)])
        else:
            t.normalizer = normalizers.NFC()
            t.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
        t.decoder = decoders.ByteLevel()
        t.train_from_iterator(TRAIN, trainers.BpeTrainer(
            vocab_size=700, initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
            special_tokens=["<|begin|>"]))
        return t, {}
    if kind == "spm":
        t = Tokenizer(_spm_model())
        t.normalizer = normalizers.Sequence([normalizers.Prepend("▁"),
                                             normalizers.Replace(" ", "▁")])
        t.decoder = decoders.Sequence([decoders.Replace("▁", " "), decoders.ByteFallback(),
                                       decoders.Fuse(), decoders.Strip(" ", 1, 0)])
        return t, {"unk_token": "<unk>"}
    if kind == "metaspace":
        t = Tokenizer(_spm_model())
        t.pre_tokenizer = pre_tokenizers.Metaspace(replacement="▁", prepend_scheme="first")
        t.decoder = decoders.Sequence([decoders.ByteFallback(),
                                       decoders.Metaspace(replacement="▁", prepend_scheme="first")])
        return t, {"unk_token": "<unk>"}
    words = ["<unk>", "<s>", "</s>", "the", "quick", "brown", "fox", "hello", "world", ",",
             ".", "it", "'", "s", "2024", "café", "日本語のテキストと中文字符", "Ⅻ"]
    t = Tokenizer(models.WordLevel({w: i for i, w in enumerate(words)}, unk_token="<unk>"))
    t.pre_tokenizer = pre_tokenizers.Whitespace()
    return t, {"unk_token": "<unk>", "bos_token": "<s>", "clean_up_tokenization_spaces": True}


KINDS = ("llama3", "gpt2_nfc", "spm", "metaspace", "wordlevel")


@pytest.fixture(scope="module")
def tokenizer_dirs(tmp_path_factory):
    """kind -> a directory saved by transformers (tokenizer.json and
    tokenizer_config.json, no chat template)."""
    dirs = {}
    for kind in KINDS:
        t, extra = _build(kind)
        fast = PreTrainedTokenizerFast(tokenizer_object=t, eos_token=EOT,
                                       additional_special_tokens=[EXTRA], **extra)
        fast.add_tokens([AddedToken("<|end|>", lstrip=True, rstrip=True, special=True)],
                        special_tokens=True)
        fast.add_tokens([AddedToken("hello", single_word=True)])
        d = str(tmp_path_factory.mktemp(kind))
        fast.save_pretrained(d)
        dirs[kind] = d
    return dirs


@pytest.mark.parametrize("kind", KINDS)
def test_ids_text_and_bytes_equal_the_reference(tokenizer_dirs, kind):
    ref = JaxHfTokenizer(tokenizer_dirs[kind])
    tok = load_tokenizer({"kind": "hf", "path": tokenizer_dirs[kind]})
    assert isinstance(tok, HfTokenizer)
    assert tok.vocab_size == ref.vocab_size
    assert tok.eos_token_ids == ref.eos_token_ids and tok.eos_token_ids
    for text in CORPUS:
        ids = ref.encode(text)
        assert tok.encode(text) == ids, text
        assert tok.decode(ids) == ref.decode(ids), text
    every = list(range(ref.vocab_size + 3))  # past the vocabulary too
    assert [tok.token_bytes(i) for i in every] == [ref.token_bytes(i) for i in every]
    # decode of ids no text gives: specials between words, byte pieces alone
    window = every[::7] + every[1::11]
    assert tok.decode(window) == ref.decode(window)
    assert tok.decode(every) == ref.decode(every)


@pytest.mark.parametrize("kind", KINDS)
def test_decode_stream_deltas_equal_the_reference(tokenizer_dirs, kind):
    ref = JaxHfTokenizer(tokenizer_dirs[kind])
    tok = HfTokenizer(tokenizer_dirs[kind])
    for text in CORPUS:
        ids = ref.encode(text)
        jstream, tstream = JaxDecodeStream(ref), DecodeStream(tok)
        assert [tstream.step(i) for i in ids] == [jstream.step(i) for i in ids], text


def test_a_chat_template_is_refused_by_name_and_none_falls_back(tokenizer_dirs, tmp_path):
    """The name is kept from when a template was refused: now, with a
    template in chat_template.jinja, a chat renders it as the reference's
    HfTokenizer does, and the server's usage counts the render's tokens.
    Without one the structured format is served, as the reference's
    wrapper renders it, and /v1/completions is unaffected."""
    plain = tokenizer_dirs["wordlevel"]
    templated = str(tmp_path / "templated")
    shutil.copytree(plain, templated)
    with open(os.path.join(templated, "chat_template.jinja"), "w") as f:
        f.write("{{ bos_token }}{% for m in messages %}{{ m.content }}{% endfor %}")
    messages = [{"role": "user", "content": "hello world"}]
    rendered = JaxHfTokenizer(templated).apply_chat_template(messages)
    assert rendered == "<s>hello world"
    assert HfTokenizer(templated).apply_chat_template(messages) == rendered
    tok, ref = HfTokenizer(plain), JaxHfTokenizer(plain)
    assert tok.apply_chat_template(messages) == ref.apply_chat_template(messages) \
        == render_fallback_template(messages)
    base = ["run", "in=http", "out=torch", "--model", "tiny", "--port", "0", "--device", "cpu",
            "--dtype", "float32", "--page-size", "4", "--max-context", "64", "--num-pages", "32",
            "--prefill-chunk", "32"]

    def post(url, body):
        req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.load(r)

    chat = {"model": "tiny", "messages": messages, "max_tokens": 3,
            "ext": {"ignore_eos": True}}
    server = start_server(base + ["--tokenizer", templated])
    try:
        resp = post(server.url + "/v1/chat/completions", chat)
        assert resp["usage"]["prompt_tokens"] == len(JaxHfTokenizer(templated).encode(rendered))
        assert resp["usage"]["completion_tokens"] == 3
        done = post(server.url + "/v1/completions", {"model": "tiny", "prompt": "hello world",
                                                     "max_tokens": 2,
                                                     "ext": {"ignore_eos": True}})
        assert done["usage"]["completion_tokens"] == 2
    finally:
        server.stop()
    server = start_server(base + ["--tokenizer", plain])
    try:
        resp = post(server.url + "/v1/chat/completions", chat)
        assert resp["usage"]["prompt_tokens"] == len(ref.encode(render_fallback_template(messages)))
        assert resp["usage"]["completion_tokens"] == 3
    finally:
        server.stop()
