"""The reversible byte-level tokenizer and its chat template.

Counterpart of dynamo_tpu/preprocessor/tokenizer.py, trimmed to the byte
tokenizer the served presets use (random-init weights need no vocabulary
files); HF and GGUF vocabularies wait for checkpoint loading.
"""

from __future__ import annotations

from typing import Optional, Protocol, Sequence


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


def load_tokenizer(spec: dict | str) -> Tokenizer:
    """spec: "byte" | {"kind": "byte", "eos_token_ids": (...)}"""
    if isinstance(spec, str):
        spec = {"kind": spec}
    kind = spec.get("kind", "byte")
    if kind == "byte":
        return ByteTokenizer(tuple(spec.get("eos_token_ids", (0,))))
    raise ValueError(f"unknown tokenizer kind {kind!r}")
