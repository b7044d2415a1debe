"""OpenAI-compatible protocol types (chat and completions) + SSE.

Counterpart of dynamo_tpu/protocols/openai.py as standard-library
dataclasses: each request type validates its JSON body explicitly in
`from_json` (a ValueError is a 400 at the frontend), and every type dumps
with None fields left out, as the JAX package's pydantic models do.
The sampling surface is served: logprobs and top_logprobs, the frequency,
presence and repetition penalties, logit_bias, n > 1 and the ext/nvext
min_tokens, repetition_penalty and greed_sampling; their ranges are
checked by the preprocessor, and a logit_bias over the engine's slots or
outside its vocabulary by the engine at admission (each a 400). A chat's
`tools` (a list of objects) go to the chat template as they are, and
tool-call outputs are not parsed, as in the JAX package; ext/nvext
`use_raw_prompt` skips the template. Request fields this package does not
serve (`echo`, which the JAX package declares and never reads) are
refused, not ignored; unknown fields are ignored, as OpenAI clients send
extra ones.
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
    "echo": (None, False),
}
#: OpenAI's largest `n`
MAX_CHOICES = 128


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
    if not 1 <= n <= MAX_CHOICES:
        raise ValueError(f"n must be between 1 and {MAX_CHOICES}; got {n}")
    bias = body.get("logit_bias")
    if bias is not None and not (isinstance(bias, dict) and all(
            isinstance(v, (int, float)) and not isinstance(v, bool) for v in bias.values())):
        raise ValueError("field 'logit_bias' must map token ids to numbers")
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
    penalties = {name: _get(body, name, (int, float))
                 for name in ("frequency_penalty", "presence_penalty", "repetition_penalty")}
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
        n=n,
        logit_bias=bias,
        **penalties,
        ext=Ext(
            ignore_eos=_get(ext, "ignore_eos", bool),
            return_token_ids=_get(ext, "return_token_ids", bool),
            min_tokens=_get(ext, "min_tokens", int),
            repetition_penalty=_get(ext, "repetition_penalty", (int, float)),
            greed_sampling=_get(ext, "greed_sampling", bool),
            use_raw_prompt=_get(ext, "use_raw_prompt", bool),
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
    #: eos/stop-token finishes are suppressed until this many output tokens
    min_tokens: Optional[int] = None
    #: multiplicative repetition penalty over generated tokens, in (0, 2.0]
    #: here (the top-level field accepts any value > 0)
    repetition_penalty: Optional[float] = None
    #: argmax decoding whatever the temperature
    greed_sampling: Optional[bool] = None
    #: skip the chat template: the message contents joined by "\n" are the
    #: prompt (the reference's nvext use_raw_prompt)
    use_raw_prompt: Optional[bool] = None


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
    n: int = 1
    frequency_penalty: Optional[float] = None
    presence_penalty: Optional[float] = None
    repetition_penalty: Optional[float] = None
    #: the chosen tokens' logprobs, with top_logprobs (0-20) alternatives
    logprobs: Optional[bool] = None
    top_logprobs: Optional[int] = None
    #: token id (a JSON string or an int) -> bias in [-100, 100]
    logit_bias: Optional[dict[Union[int, str], float]] = None
    #: OpenAI tool definitions, passed to the chat template as they are
    tools: Optional[list[dict]] = None
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
        tools = _get(body, "tools", list)
        if tools is not None and not all(isinstance(t, dict) for t in tools):
            raise ValueError("field 'tools' must be a list of objects")
        return ChatCompletionRequest(
            messages=messages, max_tokens=max_tokens, tools=tools,
            max_completion_tokens=max_completion,
            logprobs=_get(body, "logprobs", bool),
            top_logprobs=_get(body, "top_logprobs", int), **common,
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
    n: int = 1
    frequency_penalty: Optional[float] = None
    presence_penalty: Optional[float] = None
    repetition_penalty: Optional[float] = None
    #: legacy: N => the chosen token's logprob and the top N (0-5)
    logprobs: Optional[int] = None
    logit_bias: Optional[dict[Union[int, str], float]] = None
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
        return CompletionRequest(prompt=prompt, max_tokens=max_tokens,
                                 logprobs=_get(body, "logprobs", int), **common)


@dataclass
class Usage:
    prompt_tokens: int = 0
    completion_tokens: int = 0
    total_tokens: int = 0
    #: OpenAI's detail block: {"cached_tokens": n} when the prompt hit the
    #: prefix cache, else absent
    prompt_tokens_details: Optional[dict[str, int]] = None


def combine_usages(usages: list[Usage]) -> Optional[Usage]:
    """Fold the usage blocks of `n` choices into one: the shared prompt
    counts once, completion tokens sum, and the cached tokens are the
    largest any choice had (so the fold does not depend on which sibling
    prefilled first)."""
    if not usages:
        return None
    details = max((u.prompt_tokens_details for u in usages if u.prompt_tokens_details),
                  key=lambda d: d.get("cached_tokens", 0), default=None)
    completion = sum(u.completion_tokens for u in usages)
    return Usage(prompt_tokens=usages[0].prompt_tokens, completion_tokens=completion,
                 total_tokens=usages[0].prompt_tokens + completion,
                 prompt_tokens_details=details)


@dataclass
class TopLogprob:
    token: str = ""
    logprob: float = 0.0
    bytes: Optional[list[int]] = None


@dataclass
class TokenLogprob:
    token: str = ""
    logprob: float = 0.0
    bytes: Optional[list[int]] = None
    top_logprobs: list[TopLogprob] = field(default_factory=list)


@dataclass
class ChoiceLogprobs:
    """The chat API's logprobs block: one entry per emitted token."""

    content: list[TokenLogprob] = field(default_factory=list)


@dataclass
class CompletionLogprobs:
    """The legacy completions API's logprobs block (parallel arrays)."""

    tokens: list[str] = field(default_factory=list)
    token_logprobs: list[float] = field(default_factory=list)
    top_logprobs: list[dict[str, float]] = field(default_factory=list)
    text_offset: list[int] = field(default_factory=list)

    @staticmethod
    def from_entries(entries: list[TokenLogprob], offset: int = 0) -> "CompletionLogprobs":
        """The legacy block of chat entries whose text starts at `offset`
        characters into the choice's text."""
        offsets = []
        for e in entries:
            offsets.append(offset)
            offset += len(e.token)
        return CompletionLogprobs(
            tokens=[e.token for e in entries],
            token_logprobs=[e.logprob for e in entries],
            top_logprobs=[{t.token: t.logprob for t in e.top_logprobs} for e in entries],
            text_offset=offsets,
        )


@dataclass
class ChatChoiceDelta:
    role: Optional[str] = None
    content: Optional[str] = None


@dataclass
class ChatStreamChoice:
    index: int = 0
    delta: ChatChoiceDelta = field(default_factory=ChatChoiceDelta)
    logprobs: Optional[ChoiceLogprobs] = None
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
    logprobs: Optional[ChoiceLogprobs] = None
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
    logprobs: Optional[CompletionLogprobs] = None
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
    """Fold a chunk stream into a non-streaming response. Chunks may
    interleave several choice indices (`n` > 1): each folds into its own
    choice, and the usage blocks fold into one (combine_usages)."""
    text: dict[int, list[str]] = {}
    token_ids: dict[int, list[int]] = {}
    finish: dict[int, str] = {}
    entries: dict[int, list[TokenLogprob]] = {}
    usages: list[Usage] = []
    for ch in chunks:
        for choice in ch.choices:
            i = choice.index
            text.setdefault(i, [])
            if choice.delta.content:
                text[i].append(choice.delta.content)
            if choice.token_ids is not None:
                token_ids.setdefault(i, []).extend(choice.token_ids)
            if choice.logprobs is not None:
                entries.setdefault(i, []).extend(choice.logprobs.content)
            if choice.finish_reason:
                finish[i] = choice.finish_reason
        if ch.usage is not None:
            usages.append(ch.usage)
    return ChatCompletionResponse(
        id=request_id,
        created=now(),
        model=model,
        choices=[ChatChoice(
            index=i,
            message=ChatMessage(role="assistant", content="".join(text.get(i, []))),
            logprobs=ChoiceLogprobs(content=entries[i]) if i in entries else None,
            finish_reason=finish.get(i),
            token_ids=token_ids.get(i),
        ) for i in sorted(text) or [0]],
        usage=combine_usages(usages),
    )
