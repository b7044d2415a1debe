"""OpenAI-compatible protocol types (chat and completions) + SSE.

Counterpart of dynamo_tpu/protocols/openai.py as standard-library
dataclasses: each request type validates its JSON body explicitly in
`from_json` (a ValueError is a 400 at the frontend), and every type dumps
with None fields left out, as the JAX package's pydantic models do.
Request fields this package does not serve yet (logprobs, penalties,
logit_bias, tools, n > 1) are refused, not ignored; unknown fields are
ignored, as OpenAI clients send extra ones.
"""

from __future__ import annotations

import json
import time
import uuid
from dataclasses import asdict, dataclass, field, is_dataclass
from typing import Any, Optional, Union

_ROLES = ("system", "user", "assistant", "tool")
#: fields of the OpenAI API this package refuses until it serves them ->
#: the values that ask for nothing
_UNSERVED = {
    "logprobs": (None, False),
    "top_logprobs": (None,),
    "logit_bias": (None, {}),
    "frequency_penalty": (None, 0),
    "presence_penalty": (None, 0),
    "repetition_penalty": (None, 1),
    "tools": (None, []),
    "echo": (None, False),
}


def _drop_none(x):
    if isinstance(x, dict):
        return {k: _drop_none(v) for k, v in x.items() if v is not None}
    if isinstance(x, list):
        return [_drop_none(v) for v in x]
    return x


def dump(obj) -> dict:
    """A protocol object as a JSON-ready dict, None fields left out."""
    return _drop_none(asdict(obj) if is_dataclass(obj) else dict(obj))


def _get(body: dict, name: str, kinds, default=None):
    """body[name] checked against `kinds` (bool is never an int here)."""
    v = body.get(name)
    if v is None:
        return default
    if not isinstance(v, kinds) or (isinstance(v, bool) and kinds is not bool):
        raise ValueError(f"field {name!r} has the wrong type ({type(v).__name__})")
    return v


def _common(body: dict) -> dict:
    if not isinstance(body, dict):
        raise ValueError("request body must be a JSON object")
    for name, noop in _UNSERVED.items():
        if body.get(name) not in noop:
            raise ValueError(f"field {name!r} is not supported by dynamo_tpu_torch yet")
    n = _get(body, "n", int, 1)
    if n != 1:
        raise ValueError("n != 1 is not supported by dynamo_tpu_torch yet")
    model = _get(body, "model", str)
    if not model:
        raise ValueError("field 'model' is required")
    stop = body.get("stop")
    if stop is not None and not (
        isinstance(stop, str) or (isinstance(stop, list) and all(isinstance(s, str) for s in stop))
    ):
        raise ValueError("field 'stop' must be a string or a list of strings")
    so = body.get("stream_options")
    if so is not None and not isinstance(so, dict):
        raise ValueError("field 'stream_options' must be an object")
    ext = body.get("ext") or body.get("nvext")
    if ext is not None and not isinstance(ext, dict):
        raise ValueError("field 'ext' must be an object")
    temperature = _get(body, "temperature", (int, float))
    if temperature is not None and temperature < 0:
        raise ValueError("temperature must be >= 0")
    top_p = _get(body, "top_p", (int, float))
    if top_p is not None and not 0 < top_p <= 1:
        raise ValueError("top_p must be in (0, 1]")
    top_k = _get(body, "top_k", int)
    if top_k is not None and top_k < 0:
        raise ValueError("top_k must be >= 0")
    return dict(
        model=model,
        temperature=None if temperature is None else float(temperature),
        top_p=None if top_p is None else float(top_p),
        top_k=top_k,
        stream=bool(_get(body, "stream", bool, False)),
        stream_options=StreamOptions(
            include_usage=bool((so or {}).get("include_usage"))
        ) if so is not None else None,
        stop=stop,
        seed=_get(body, "seed", int),
        ext=Ext(
            ignore_eos=_get(ext, "ignore_eos", bool),
            return_token_ids=_get(ext, "return_token_ids", bool),
        ) if ext else None,
    )


@dataclass
class Ext:
    """Framework extensions (the reference's nvext)."""

    ignore_eos: Optional[bool] = None
    #: each choice carries the ids of the tokens it covers (`token_ids`,
    #: vLLM's `return_token_ids`): a stream sends one chunk per engine
    #: event, so a client sees every token as it is made
    return_token_ids: Optional[bool] = None


@dataclass
class ChatMessage:
    role: str = "user"
    content: Union[str, list, None] = None
    name: Optional[str] = None


@dataclass
class StreamOptions:
    include_usage: Optional[bool] = None


@dataclass
class ChatCompletionRequest:
    model: str
    messages: list[ChatMessage]
    max_tokens: Optional[int] = None
    max_completion_tokens: Optional[int] = None
    temperature: Optional[float] = None
    top_p: Optional[float] = None
    top_k: Optional[int] = None
    stream: bool = False
    stream_options: Optional[StreamOptions] = None
    stop: Union[str, list[str], None] = None
    seed: Optional[int] = None
    ext: Optional[Ext] = None

    @property
    def extension(self) -> Ext:
        return self.ext or Ext()

    @property
    def effective_max_tokens(self) -> Optional[int]:
        return self.max_completion_tokens or self.max_tokens

    @staticmethod
    def from_json(body: dict) -> "ChatCompletionRequest":
        common = _common(body)
        raw = body.get("messages")
        if not isinstance(raw, list) or not raw:
            raise ValueError("field 'messages' must be a non-empty list")
        messages = []
        for m in raw:
            if not isinstance(m, dict):
                raise ValueError("each message must be an object")
            role = m.get("role", "user")
            if role not in _ROLES:
                raise ValueError(f"unknown message role {role!r}")
            content = m.get("content")
            if content is not None and not isinstance(content, (str, list)):
                raise ValueError("message content must be a string or a list of parts")
            messages.append(ChatMessage(role=role, content=content, name=m.get("name")))
        max_tokens = _get(body, "max_tokens", int)
        max_completion = _get(body, "max_completion_tokens", int)
        for v in (max_tokens, max_completion):
            if v is not None and v < 1:
                raise ValueError("max_tokens must be >= 1")
        return ChatCompletionRequest(
            messages=messages, max_tokens=max_tokens,
            max_completion_tokens=max_completion, **common,
        )


@dataclass
class CompletionRequest:
    model: str
    prompt: Union[str, list[str], list[int]]
    max_tokens: Optional[int] = 16
    temperature: Optional[float] = None
    top_p: Optional[float] = None
    top_k: Optional[int] = None
    stream: bool = False
    stream_options: Optional[StreamOptions] = None
    stop: Union[str, list[str], None] = None
    seed: Optional[int] = None
    ext: Optional[Ext] = None

    @property
    def extension(self) -> Ext:
        return self.ext or Ext()

    @staticmethod
    def from_json(body: dict) -> "CompletionRequest":
        common = _common(body)
        prompt = body.get("prompt")
        ok = isinstance(prompt, str) or (
            isinstance(prompt, list) and prompt and (
                all(isinstance(p, str) for p in prompt)
                or all(isinstance(p, int) and not isinstance(p, bool) for p in prompt)
            )
        )
        if not ok:
            raise ValueError(
                "field 'prompt' must be a string, a list of strings or a list of token ids"
            )
        max_tokens = _get(body, "max_tokens", int, 16)
        if max_tokens < 1:
            raise ValueError("max_tokens must be >= 1")
        return CompletionRequest(prompt=prompt, max_tokens=max_tokens, **common)


@dataclass
class Usage:
    prompt_tokens: int = 0
    completion_tokens: int = 0
    total_tokens: int = 0
    #: OpenAI's detail block: {"cached_tokens": n} when the prompt hit the
    #: prefix cache, else absent
    prompt_tokens_details: Optional[dict[str, int]] = None


@dataclass
class ChatChoiceDelta:
    role: Optional[str] = None
    content: Optional[str] = None


@dataclass
class ChatStreamChoice:
    index: int = 0
    delta: ChatChoiceDelta = field(default_factory=ChatChoiceDelta)
    finish_reason: Optional[str] = None
    token_ids: Optional[list[int]] = None


@dataclass
class ChatCompletionChunk:
    id: str
    object: str = "chat.completion.chunk"
    created: int = 0
    model: str = ""
    choices: list[ChatStreamChoice] = field(default_factory=list)
    usage: Optional[Usage] = None


@dataclass
class ChatChoice:
    index: int = 0
    message: ChatMessage = field(default_factory=lambda: ChatMessage(role="assistant", content=""))
    finish_reason: Optional[str] = None
    token_ids: Optional[list[int]] = None


@dataclass
class ChatCompletionResponse:
    id: str
    object: str = "chat.completion"
    created: int = 0
    model: str = ""
    choices: list[ChatChoice] = field(default_factory=list)
    usage: Optional[Usage] = None


@dataclass
class CompletionChoice:
    index: int = 0
    text: str = ""
    finish_reason: Optional[str] = None
    token_ids: Optional[list[int]] = None


@dataclass
class CompletionResponse:
    id: str
    object: str = "text_completion"
    created: int = 0
    model: str = ""
    choices: list[CompletionChoice] = field(default_factory=list)
    usage: Optional[Usage] = None


@dataclass
class ModelInfo:
    id: str
    object: str = "model"
    created: int = 0
    owned_by: str = "dynamo-tpu"


@dataclass
class ModelList:
    object: str = "list"
    data: list[ModelInfo] = field(default_factory=list)


def new_request_id(prefix: str = "cmpl") -> str:
    return f"{prefix}-{uuid.uuid4().hex}"


def now() -> int:
    return int(time.time())


# -- SSE ---------------------------------------------------------------------


def sse_event(data: Any) -> bytes:
    return f"data: {json.dumps(dump(data))}\n\n".encode()


SSE_DONE = b"data: [DONE]\n\n"


def aggregate_chat_stream(chunks: list[ChatCompletionChunk], model: str,
                          request_id: str) -> ChatCompletionResponse:
    """Fold a one-choice chunk stream into a non-streaming response."""
    text: list[str] = []
    token_ids: Optional[list[int]] = None
    finish: Optional[str] = None
    usage: Optional[Usage] = None
    for ch in chunks:
        for choice in ch.choices:
            if choice.delta.content:
                text.append(choice.delta.content)
            if choice.token_ids is not None:
                token_ids = (token_ids or []) + choice.token_ids
            if choice.finish_reason:
                finish = choice.finish_reason
        if ch.usage is not None:
            usage = ch.usage
    return ChatCompletionResponse(
        id=request_id,
        created=now(),
        model=model,
        choices=[ChatChoice(
            message=ChatMessage(role="assistant", content="".join(text)),
            finish_reason=finish,
            token_ids=token_ids,
        )],
        usage=usage,
    )
