"""OpenAI request <-> engine tokens: the preprocessor + stream postprocessor.

Counterpart of dynamo_tpu/preprocessor/preprocessor.py, trimmed to the
chat/completions path. Forward: template render -> tokenize -> sampling
and stop defaults -> PreprocessedRequest. Backward: engine token stream ->
incremental detokenize -> stop strings -> OpenAI chunks. The backward half
is a plain generator: the engine stream it reads is the engine thread's
per-request queue (engine/async_engine.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator, Optional

from dynamo_tpu_torch.preprocessor.detokenize import DecodeStream
from dynamo_tpu_torch.preprocessor.stop import StopChecker
from dynamo_tpu_torch.preprocessor.tokenizer import Tokenizer
from dynamo_tpu_torch.protocols.openai import (
    ChatChoiceDelta,
    ChatCompletionChunk,
    ChatCompletionRequest,
    ChatStreamChoice,
    CompletionRequest,
    Ext,
    Usage,
    new_request_id,
    now,
)

DEFAULT_MAX_TOKENS = 512


@dataclass
class PreprocessedRequest:
    """Engine-facing request."""

    request_id: str
    token_ids: list[int]
    max_tokens: int = DEFAULT_MAX_TOKENS
    temperature: float = 0.0
    top_p: float = 1.0
    top_k: int = 0
    seed: Optional[int] = None
    stop_token_ids: list[int] = field(default_factory=list)
    stop_strings: list[str] = field(default_factory=list)
    ignore_eos: bool = False
    return_token_ids: bool = False


def _stop_list(stop) -> list[str]:
    if stop is None:
        return []
    if isinstance(stop, str):
        return [stop]
    return list(stop)


class OpenAIPreprocessor:
    def __init__(self, tokenizer: Tokenizer, model_name: str = ""):
        self.tokenizer = tokenizer
        self.model_name = model_name

    # -- forward -----------------------------------------------------------

    def preprocess_chat(self, request: ChatCompletionRequest) -> PreprocessedRequest:
        messages = [
            {k: v for k, v in vars(m).items() if v is not None} for m in request.messages
        ]
        ids = self.tokenizer.encode(self.tokenizer.apply_chat_template(messages))
        return self._common(ids, request.effective_max_tokens, request, request.extension)

    def preprocess_completion(self, request: CompletionRequest) -> PreprocessedRequest:
        prompt = request.prompt
        if isinstance(prompt, list) and prompt and isinstance(prompt[0], int):
            ids = list(prompt)
        elif isinstance(prompt, list):
            ids = self.tokenizer.encode("".join(prompt))
        else:
            ids = self.tokenizer.encode(prompt)
        return self._common(ids, request.max_tokens, request, request.extension)

    def _common(self, prompt_ids, max_tokens, request, ext: Ext) -> PreprocessedRequest:
        return PreprocessedRequest(
            request_id=new_request_id(),
            token_ids=prompt_ids,
            max_tokens=max_tokens or DEFAULT_MAX_TOKENS,
            temperature=request.temperature if request.temperature is not None else 0.0,
            top_p=request.top_p if request.top_p is not None else 1.0,
            top_k=request.top_k if request.top_k is not None else 0,
            seed=request.seed,
            stop_token_ids=list(self.tokenizer.eos_token_ids),
            stop_strings=_stop_list(request.stop),
            ignore_eos=bool(ext.ignore_eos),
            return_token_ids=bool(ext.return_token_ids),
        )

    # -- backward ----------------------------------------------------------

    def postprocess_chat_stream(
        self,
        engine_stream: Iterator[dict],
        preprocessed: PreprocessedRequest,
        include_usage: bool = False,
    ) -> Iterator[ChatCompletionChunk]:
        """Engine events {token_ids, finish_reason, cached_tokens on the
        first} -> OpenAI chunks; the usage chunk's prompt_tokens_details
        carries the cached tokens when the prompt hit the prefix cache.

        With `return_token_ids` each engine event that carries tokens gives
        one chunk holding their ids and whatever text they rendered, so the
        ids cover every token that usage counts.
        """
        request_id = preprocessed.request_id
        decode = DecodeStream(self.tokenizer)
        stop = StopChecker(preprocessed.stop_strings)
        created = now()
        completion_tokens = 0
        cached_tokens = 0
        first = True
        finish: Optional[str] = None

        def chunk(content=None, role=None, finish_reason=None, token_ids=None):
            return ChatCompletionChunk(
                id=request_id,
                created=created,
                model=self.model_name,
                choices=[ChatStreamChoice(
                    delta=ChatChoiceDelta(role=role, content=content),
                    finish_reason=finish_reason,
                    token_ids=token_ids,
                )],
            )

        stop_ids = set(preprocessed.stop_token_ids)
        with_ids = preprocessed.return_token_ids
        for event in engine_stream:
            if event.get("cached_tokens"):
                cached_tokens = int(event["cached_tokens"])
            ids: list[int] = []
            texts: list[str] = []
            for tok in event.get("token_ids", ()):
                completion_tokens += 1
                ids.append(tok)
                if tok in stop_ids and not preprocessed.ignore_eos:
                    finish = "stop"
                    break  # never render the stop/eos token itself
                text = stop.feed(decode.step(tok))
                if text and with_ids:
                    texts.append(text)
                elif text:
                    yield chunk(content=text, role="assistant" if first else None)
                    first = False
                if stop.stopped:
                    finish = "stop"
                    break
            if with_ids and ids:
                yield chunk(content="".join(texts) or None,
                            role="assistant" if first else None, token_ids=ids)
                first = False
            if finish == "stop":
                break
            if event.get("finish_reason"):
                finish = event["finish_reason"]
        if not stop.stopped:
            tail = stop.flush()
            if tail:
                yield chunk(content=tail, role="assistant" if first else None)
        yield chunk(finish_reason=finish or "stop")
        if include_usage:
            # OpenAI contract: usage rides its own trailing chunk with an
            # empty choices list, after the finish_reason chunk
            n_prompt = len(preprocessed.token_ids)
            yield ChatCompletionChunk(
                id=request_id,
                created=created,
                model=self.model_name,
                choices=[],
                usage=Usage(
                    prompt_tokens=n_prompt,
                    completion_tokens=completion_tokens,
                    total_tokens=n_prompt + completion_tokens,
                    prompt_tokens_details=(
                        {"cached_tokens": cached_tokens} if cached_tokens else None),
                ),
            )
