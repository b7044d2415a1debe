"""OpenAI request <-> engine tokens: the preprocessor + stream postprocessor.

Counterpart of dynamo_tpu/preprocessor/preprocessor.py, trimmed to the
chat/completions path. Forward: template render -> tokenize -> sampling
and stop defaults, the logprobs, penalty, logit_bias and ext/nvext knobs
checked -> PreprocessedRequest. Backward: engine token stream ->
incremental detokenize -> stop strings -> OpenAI chunks, each token's
logprob entry (exact bytes, top alternatives) riding the chunk that emits
its text. The backward half is a plain generator: the engine stream it
reads is the engine thread's per-request queue (engine/async_engine.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator, Optional

from dynamo_tpu_torch.engine.sampling import BIAS_SLOTS
from dynamo_tpu_torch.preprocessor.detokenize import DecodeStream
from dynamo_tpu_torch.preprocessor.stop import StopChecker
from dynamo_tpu_torch.preprocessor.tokenizer import Tokenizer
from dynamo_tpu_torch.protocols.openai import (
    ChatChoiceDelta,
    ChatCompletionChunk,
    ChatCompletionRequest,
    ChatStreamChoice,
    ChoiceLogprobs,
    CompletionRequest,
    Ext,
    TokenLogprob,
    TopLogprob,
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
    #: -1 = off; 0 = the chosen token's logprob; N = and the top N
    logprobs: int = -1
    frequency_penalty: float = 0.0
    presence_penalty: float = 0.0
    repetition_penalty: float = 1.0
    #: [[token id, bias], ...], biases clamped to [-100, 100]
    logit_bias: list = field(default_factory=list)
    min_tokens: int = 0


def _stop_list(stop) -> list[str]:
    if stop is None:
        return []
    if isinstance(stop, str):
        return [stop]
    return list(stop)


def _logit_bias_list(raw) -> list:
    """OpenAI logit_bias (JSON string or int keys) -> [[token id, bias],
    ...], biases clamped to OpenAI's [-100, 100]; more entries than the
    engine's slots, a key that is no token id, or a negative id is a 400
    (the engine refuses an id outside its vocabulary at admission)."""
    if not raw:
        return []
    if len(raw) > BIAS_SLOTS:
        raise ValueError(f"logit_bias supports at most {BIAS_SLOTS} entries; got {len(raw)}")
    out = []
    for k, v in raw.items():
        try:
            tid = int(k)
        except (TypeError, ValueError):
            raise ValueError(f"logit_bias keys must be token ids; got {k!r}") from None
        if tid < 0:
            raise ValueError(f"logit_bias token id must be >= 0; got {tid}")
        out.append([tid, max(-100.0, min(100.0, float(v)))])
    return out


def _chat_logprobs(request: ChatCompletionRequest) -> int:
    """The chat API's logprobs/top_logprobs as the engine's value, checked
    as OpenAI checks them (a 400, never a clamp)."""
    n = request.top_logprobs
    if n is not None and not 0 <= n <= 20:
        raise ValueError(f"top_logprobs must be between 0 and 20; got {n}")
    if not request.logprobs:
        if n is not None:
            raise ValueError("top_logprobs requires logprobs to be true")
        return -1
    return n or 0


def _completion_logprobs(request: CompletionRequest) -> int:
    """The legacy completions API's logprobs=N (at most 5, as upstream)."""
    n = request.logprobs
    if n is None:
        return -1
    if not 0 <= n <= 5:
        raise ValueError(f"logprobs must be between 0 and 5; got {n}")
    return n


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
        return self._common(ids, request.effective_max_tokens, request, request.extension,
                            _chat_logprobs(request))

    def preprocess_completion(self, request: CompletionRequest) -> PreprocessedRequest:
        prompt = request.prompt
        if isinstance(prompt, list) and prompt and isinstance(prompt[0], int):
            ids = list(prompt)
        elif isinstance(prompt, list):
            ids = self.tokenizer.encode("".join(prompt))
        else:
            ids = self.tokenizer.encode(prompt)
        return self._common(ids, request.max_tokens, request, request.extension,
                            _completion_logprobs(request))

    def _common(self, prompt_ids, max_tokens, request, ext: Ext,
                logprobs: int) -> PreprocessedRequest:
        min_tokens = ext.min_tokens or 0
        if min_tokens < 0:
            raise ValueError(f"min_tokens must be >= 0; got {min_tokens}")
        rep = request.repetition_penalty if request.repetition_penalty is not None else 1.0
        if ext.repetition_penalty is not None:
            # the nvext field keeps the reference's range; the top-level
            # one accepts any value > 0 as an extension
            rep = ext.repetition_penalty
            if not 0 < rep <= 2.0:
                raise ValueError(f"nvext repetition_penalty must be in (0, 2.0]; got {rep}")
        if rep <= 0:
            raise ValueError(f"repetition_penalty must be > 0; got {rep}")
        temperature = request.temperature if request.temperature is not None else 0.0
        if ext.greed_sampling:
            temperature = 0.0  # argmax whatever the temperature
        return PreprocessedRequest(
            request_id=new_request_id(),
            token_ids=prompt_ids,
            max_tokens=max_tokens or DEFAULT_MAX_TOKENS,
            temperature=temperature,
            top_p=request.top_p if request.top_p is not None else 1.0,
            top_k=request.top_k if request.top_k is not None else 0,
            seed=request.seed,
            stop_token_ids=list(self.tokenizer.eos_token_ids),
            stop_strings=_stop_list(request.stop),
            ignore_eos=bool(ext.ignore_eos),
            return_token_ids=bool(ext.return_token_ids),
            logprobs=logprobs,
            frequency_penalty=float(request.frequency_penalty or 0.0),
            presence_penalty=float(request.presence_penalty or 0.0),
            repetition_penalty=float(rep),
            logit_bias=_logit_bias_list(request.logit_bias),
            min_tokens=min_tokens,
        )

    # -- backward ----------------------------------------------------------

    def _token_repr(self, tok: int) -> tuple[str, list[int]]:
        """(display text, exact bytes) of one token: token_bytes keeps a
        partial UTF-8 sequence exact (the OpenAI `bytes` field), where the
        display text may show a replacement character."""
        raw = self.tokenizer.token_bytes(tok)
        return raw.decode("utf-8", errors="replace"), list(raw)

    def _entry(self, tok: int, logprob: float, alts) -> TokenLogprob:
        """One token's logprob entry, with its top (id, logprob) pairs."""
        text, raw = self._token_repr(tok)
        top = []
        for tid, lp in alts:
            alt_text, alt_raw = self._token_repr(int(tid))
            top.append(TopLogprob(token=alt_text, logprob=float(lp), bytes=alt_raw))
        return TokenLogprob(token=text, logprob=float(logprob), bytes=raw, top_logprobs=top)

    def postprocess_chat_stream(
        self,
        engine_stream: Iterator[dict],
        preprocessed: PreprocessedRequest,
        include_usage: bool = False,
    ) -> Iterator[ChatCompletionChunk]:
        """Engine events {token_ids, finish_reason, logprobs and
        top_logprobs when asked for, cached_tokens on the first} -> OpenAI
        chunks; the usage chunk's prompt_tokens_details carries the cached
        tokens when the prompt hit the prefix cache.

        Each token's logprob entry (its text, exact bytes and top
        alternatives) waits until its text is emitted and rides that
        chunk, so a token whose text is still buffered (a partial UTF-8
        glyph, a possible stop string) sends its entry later, in order;
        entries never emitted ride the finish chunk. A stop token gets no
        entry, as it gets no text. With `return_token_ids` each engine
        event that carries tokens gives one chunk holding their ids, their
        entries and whatever text they rendered, so the ids cover every
        token that usage counts.
        """
        request_id = preprocessed.request_id
        decode = DecodeStream(self.tokenizer)
        stop = StopChecker(preprocessed.stop_strings)
        created = now()
        completion_tokens = 0
        cached_tokens = 0
        first = True
        finish: Optional[str] = None
        #: entries of the tokens whose text has not been emitted yet
        pending: list[TokenLogprob] = []

        def chunk(content=None, role=None, finish_reason=None, token_ids=None):
            entries = ChoiceLogprobs(content=list(pending)) if pending else None
            pending.clear()
            return ChatCompletionChunk(
                id=request_id,
                created=created,
                model=self.model_name,
                choices=[ChatStreamChoice(
                    delta=ChatChoiceDelta(role=role, content=content),
                    logprobs=entries,
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
            lps = event.get("logprobs")
            tops = event.get("top_logprobs")
            for i, tok in enumerate(event.get("token_ids", ())):
                completion_tokens += 1
                ids.append(tok)
                if tok in stop_ids and not preprocessed.ignore_eos:
                    finish = "stop"
                    break  # never render the stop/eos token itself
                if lps is not None:
                    pending.append(self._entry(tok, lps[i], tops[i] if tops else ()))
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
        # entries whose text never rendered ride the finish chunk
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
