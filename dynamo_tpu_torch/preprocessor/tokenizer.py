"""Tokenizers: the reversible byte tokenizer, HF tokenizer.json
vocabularies and GGUF vocabularies, and the structured chat format.

Counterpart of dynamo_tpu/preprocessor/tokenizer.py with no
`transformers`: `HfTokenizer` reads tokenizer.json and
tokenizer_config.json itself (preprocessor/tokenizer_json.py) and gives
what the reference's transformers wrapper gives; `GgufTokenizer` is the
reference's, greedy longest-match encode included. Chat templates are not
rendered yet: an HfTokenizer that carries one refuses a chat by name (the
reference renders it through transformers' Jinja); one without falls back
to the structured format, as the reference's does.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Protocol, Sequence

from dynamo_tpu_torch import gguf
from dynamo_tpu_torch.preprocessor.tokenizer_json import TokenizerJson, bytes_to_unicode, \
    unicode_to_bytes


class Tokenizer(Protocol):
    name: str
    vocab_size: int
    eos_token_ids: tuple[int, ...]

    def encode(self, text: str) -> list[int]: ...

    def decode(self, ids: Sequence[int]) -> str: ...

    def token_bytes(self, tok: int) -> bytes:
        """The exact bytes one token adds to the output (the OpenAI
        logprobs `bytes` field): a partial UTF-8 sequence comes back as
        it is, not as a replacement character."""
        ...

    def apply_chat_template(
        self, messages: list[dict], tools: Optional[list[dict]] = None
    ) -> str: ...


_FALLBACK_TEMPLATE_SUFFIX = "assistant:"
FALLBACK_MESSAGE_SEP = "\n"


def fallback_role_prefix(message: dict) -> str:
    return f"{message.get('role', 'user')}: "


def render_fallback_template(messages: list[dict]) -> str:
    """The structured chat format: `role: content` lines, then
    `assistant:`."""
    parts = []
    for m in messages:
        content = m.get("content") or ""
        if isinstance(content, list):  # content parts: their text only
            content = " ".join(p.get("text", "") for p in content if isinstance(p, dict))
        parts.append(fallback_role_prefix(m) + content)
    parts.append(_FALLBACK_TEMPLATE_SUFFIX)
    return FALLBACK_MESSAGE_SEP.join(parts)


class ByteTokenizer:
    """UTF-8 bytes as token ids (0..255). Reversible, dependency-free."""

    def __init__(self, eos_token_ids: tuple[int, ...] = (0,)):
        self.name = "byte"
        self.vocab_size = 256
        self.eos_token_ids = eos_token_ids

    def encode(self, text: str) -> list[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids: Sequence[int]) -> str:
        return bytes(i for i in ids if 0 <= i < 256).decode("utf-8", errors="replace")

    def token_bytes(self, tok: int) -> bytes:
        return bytes([tok]) if 0 <= tok < 256 else b""

    def apply_chat_template(
        self, messages: list[dict], tools: Optional[list[dict]] = None
    ) -> str:
        return render_fallback_template(messages)


#: tokenizer_config.json's special-token fields, which transformers adds as
#: special tokens when the tokenizer lacks them
_SPECIAL_FIELDS = ("bos_token", "eos_token", "unk_token", "sep_token", "pad_token",
                   "cls_token", "mask_token")


def _token_content(tok) -> Optional[str]:
    """A tokenizer_config token field: a string or an AddedToken dict."""
    if isinstance(tok, dict):
        return tok.get("content")
    return tok


class HfTokenizer:
    """An HF tokenizer directory (tokenizer.json, tokenizer_config.json),
    read with the standard library: `encode` is transformers'
    `encode(text, add_special_tokens=False)`, `decode` its
    `decode(ids, skip_special_tokens=True)` (with
    clean_up_tokenization_spaces when the config sets it), `vocab_size` is
    `len(tokenizer)` (added tokens included) and `eos_token_ids` the
    config's eos token, as the reference's wrapper gives them."""

    def __init__(self, path: str):
        with open(os.path.join(path, "tokenizer.json"), encoding="utf-8") as f:
            spec = json.load(f)
        config = {}
        config_path = os.path.join(path, "tokenizer_config.json")
        if os.path.exists(config_path):
            with open(config_path, encoding="utf-8") as f:
                config = json.load(f)
        # what transformers adds: added_tokens_decoder's tokens, then the
        # special-token fields, each unless the tokenizer has it
        extra = [{**t, "id": int(i)} for i, t in sorted(
            (config.get("added_tokens_decoder") or {}).items(), key=lambda kv: int(kv[0]))]
        specials = [_token_content(config.get(k)) for k in _SPECIAL_FIELDS]
        specials += [_token_content(t) for t in config.get("additional_special_tokens") or ()]
        extra += [{"content": t, "special": True, "normalized": False, "id": None}
                  for t in specials if t]
        self._tok = TokenizerJson(spec, extra, add_prefix_space=config.get("add_prefix_space",
                                                                         False))
        self._cleanup = bool(config.get("clean_up_tokenization_spaces", False))
        self.name = os.path.basename(path.rstrip("/"))
        self.vocab_size = self._tok.vocab_size
        eos = _token_content(config.get("eos_token"))
        eos_id = self._tok.token_to_id(eos) if eos is not None else None
        self.eos_token_ids = (eos_id,) if eos_id is not None else ()
        self.chat_template = config.get("chat_template")
        jinja = os.path.join(path, "chat_template.jinja")
        if self.chat_template is None and os.path.exists(jinja):
            with open(jinja, encoding="utf-8") as f:
                self.chat_template = f.read()

    def encode(self, text: str) -> list[int]:
        return self._tok.encode(text)

    def decode(self, ids: Sequence[int]) -> str:
        text = self._tok.decode(ids, skip_special_tokens=True)
        if self._cleanup:  # transformers' clean_up_tokenization
            for old, new in ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","), (" ' ", "'"),
                             (" n't", "n't"), (" 'm", "'m"), (" 's", "'s"), (" 've", "'ve"),
                             (" 're", "'re")):
                text = text.replace(old, new)
        return text

    def token_bytes(self, tok: int) -> bytes:
        piece = self._tok.id_to_token(int(tok))
        if piece is None:
            return b""
        # sentencepiece byte token <0xNN>
        if len(piece) == 6 and piece.startswith("<0x") and piece.endswith(">"):
            try:
                return bytes([int(piece[3:5], 16)])
            except ValueError:
                pass
        # sentencepiece word-boundary marker
        if "▁" in piece:
            return piece.replace("▁", " ").encode()
        # byte-level BPE alphabet (GPT-2/llama3 style)
        u2b = unicode_to_bytes()
        try:
            return bytes(u2b[c] for c in piece)
        except KeyError:
            return piece.encode()

    def apply_chat_template(
        self, messages: list[dict], tools: Optional[list[dict]] = None
    ) -> str:
        if self.chat_template:
            raise NotImplementedError(
                f"{self.name}: chat templates are not rendered by dynamo_tpu_torch yet (a "
                "Jinja subset is ROADMAP item 11d-ii); send /v1/completions with a prompt "
                "rendered by the client")
        return render_fallback_template(messages)


class GgufTokenizer:
    """A GGUF file's embedded vocabulary, as the reference's GgufTokenizer:
    SentencePiece style ("llama": ▁-prefixed pieces and <0xNN> byte tokens)
    or byte-level BPE ("gpt2": GPT-2 byte-alphabet pieces). Decode joins
    pieces exactly (one SentencePiece dummy-prefix space stripped). Encode
    is greedy longest-match, the reference's approximation of the real
    merge search (unmatched input falls back to byte tokens or unk)."""

    def __init__(self, path: str):
        vocab = gguf.read_gguf(path).tokenizer_vocab()
        if vocab is None:
            raise ValueError(f"{path}: GGUF file has no embedded tokenizer")
        self.name = os.path.basename(path)
        self.kind = vocab.get("model") or "llama"  # "llama" | "gpt2"
        self._tokens: list[str] = list(vocab["tokens"])
        self.vocab_size = len(self._tokens)
        eos = vocab.get("eos_token_id")
        self.eos_token_ids = (int(eos),) if eos is not None else ()
        self._index = {t: i for i, t in enumerate(self._tokens)}
        self._max_len = max((len(t) for t in self._tokens), default=1)
        self._unk = self._index.get("<unk>", 0)
        if self.kind == "gpt2":
            self._b2u = bytes_to_unicode()
            self._u2b = unicode_to_bytes()
        else:
            self._byte_ids = {}
            for i, t in enumerate(self._tokens):
                if len(t) == 6 and t.startswith("<0x") and t.endswith(">"):
                    self._byte_ids[i] = int(t[3:5], 16)

    def _greedy(self, text: str, byte_fallback) -> list[int]:
        out: list[int] = []
        i = 0
        while i < len(text):
            for ln in range(min(self._max_len, len(text) - i), 0, -1):
                tid = self._index.get(text[i:i + ln])
                if tid is not None:
                    out.append(tid)
                    i += ln
                    break
            else:
                out.extend(byte_fallback(text[i]))
                i += 1
        return out

    def encode(self, text: str) -> list[int]:
        if self.kind == "gpt2":
            mapped = "".join(self._b2u[b] for b in text.encode("utf-8"))
            return self._greedy(mapped, lambda ch: [self._unk])
        spm = "▁" + text.replace(" ", "▁")

        def bytes_or_unk(ch: str) -> list[int]:
            ids = [self._index[f"<0x{byte:02X}>"] for byte in ch.encode("utf-8")
                   if f"<0x{byte:02X}>" in self._index]
            return ids or [self._unk]

        return self._greedy(spm, bytes_or_unk)

    def token_bytes(self, tok: int) -> bytes:
        if not 0 <= tok < len(self._tokens):
            return b""
        if self.kind == "gpt2":
            piece = self._tokens[tok]
            try:
                return bytes(self._u2b[c] for c in piece)
            except KeyError:  # a special token outside the byte alphabet: its own text
                return piece.encode()
        if tok in self._byte_ids:
            return bytes([self._byte_ids[tok]])
        return self._tokens[tok].replace("▁", " ").encode()

    def decode(self, ids: Sequence[int]) -> str:
        if self.kind == "gpt2":
            chars = "".join(self._tokens[i] for i in ids if 0 <= i < len(self._tokens))
            data = bytes(self._u2b.get(c, ord(" ") & 0xFF) for c in chars)
            return data.decode("utf-8", errors="replace")
        parts: list[bytes] = []
        for i in ids:
            if i in self._byte_ids:
                parts.append(bytes([self._byte_ids[i]]))
            elif 0 <= i < len(self._tokens):
                parts.append(self._tokens[i].replace("▁", " ").encode())
        text = b"".join(parts).decode("utf-8", errors="replace")
        # the SentencePiece dummy prefix: exactly one leading space, only
        # when the first piece carries the ▁ marker
        first = next(iter(ids), None)
        if (text.startswith(" ") and first is not None and 0 <= first < len(self._tokens)
                and self._tokens[first].startswith("▁")):
            text = text[1:]
        return text

    def apply_chat_template(
        self, messages: list[dict], tools: Optional[list[dict]] = None
    ) -> str:
        # the reference renders no GGUF template either: the structured format
        return render_fallback_template(messages)


def load_tokenizer(spec: dict | str) -> Tokenizer:
    """spec: "byte" | {"kind": "byte", "eos_token_ids": (...)}
    | {"kind": "hf", "path": dir} | {"kind": "gguf", "path": file.gguf}"""
    if isinstance(spec, str):
        spec = {"kind": spec}
    kind = spec.get("kind", "byte")
    if kind == "byte":
        return ByteTokenizer(tuple(spec.get("eos_token_ids", (0,))))
    if kind == "hf":
        return HfTokenizer(spec["path"])
    if kind == "gguf":
        return GgufTokenizer(spec["path"])
    raise ValueError(f"unknown tokenizer kind {kind!r}")
