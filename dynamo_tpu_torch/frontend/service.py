"""ModelManager + ModelPipeline.

Counterpart of dynamo_tpu/frontend/service.py for one process: a
ModelPipeline is the serving chain of one model, OpenAI request ->
preprocess (template + tokenize) -> engine -> postprocess (detokenize +
stop strings + chunks); the ModelManager maps model names to pipelines.
A request with `n` > 1 fans out into n sibling generations whose chunks
come as they are made, under one id (`_choices_stream`).
"""

from __future__ import annotations

import dataclasses
import logging
import queue
import threading
from typing import Callable, Iterator, Optional

from dynamo_tpu_torch.model_card import ModelDeploymentCard
from dynamo_tpu_torch.preprocessor import OpenAIPreprocessor, load_tokenizer
from dynamo_tpu_torch.preprocessor.preprocessor import PreprocessedRequest
from dynamo_tpu_torch.protocols.openai import (
    ChatCompletionChunk,
    ChatCompletionRequest,
    CompletionRequest,
    combine_usages,
)

logger = logging.getLogger(__name__)


class ModelPipeline:
    def __init__(
        self,
        card: ModelDeploymentCard,
        engine_fn: Callable[[PreprocessedRequest], Iterator[dict]],
        close_fn: Optional[Callable[[], None]] = None,
        *,
        prefix_caching: bool,
    ):
        """`prefix_caching`: whether the engine behind `engine_fn` caches
        prompt pages (EngineConfig.enable_prefix_caching), so that `n` > 1
        siblings can share choice 0's prefill."""
        self.card = card
        self.prefix_caching = prefix_caching
        self.preprocessor = OpenAIPreprocessor(load_tokenizer(card.tokenizer), model_name=card.name)
        self.engine_fn = engine_fn
        self.close_fn = close_fn

    def chat_stream(self, request: ChatCompletionRequest) -> Iterator[ChatCompletionChunk]:
        pre = self.preprocessor.preprocess_chat(request)
        return self._stream(pre, request)

    def completion_stream(self, request: CompletionRequest) -> Iterator[ChatCompletionChunk]:
        pre = self.preprocessor.preprocess_completion(request)
        return self._stream(pre, request)

    def _stream(self, pre: PreprocessedRequest, request) -> Iterator[ChatCompletionChunk]:
        self._clamp(pre)
        include_usage = bool(
            request.stream_options and request.stream_options.include_usage
        ) or not request.stream
        if request.n <= 1:
            return self._one_choice(pre, include_usage)
        return self._choices_stream(pre, include_usage, request.n)

    def _one_choice(self, pre: PreprocessedRequest, include_usage: bool,
                    events: Optional[Iterator[dict]] = None) -> Iterator[ChatCompletionChunk]:
        return self.preprocessor.postprocess_chat_stream(
            self.engine_fn(pre) if events is None else events, pre, include_usage=include_usage
        )

    def _choices_stream(self, pre: PreprocessedRequest, include_usage: bool, n: int
                        ) -> Iterator[ChatCompletionChunk]:
        """OpenAI `n`: n sibling generations, choice i with seed + i (when
        seeded), their chunks delivered as they come with the parent's id
        and index i, and their usage blocks folded into one trailing
        chunk. Where the siblings can share choice 0's prefill (prefix
        caching on, and a prompt of more than one page, so that a whole
        page before its last can be cached), choice 0 goes first and the
        others are submitted together once its first engine event has
        come, after its prompt prefilled and its whole pages registered.
        Elsewhere waiting saves no prefill, and all n are submitted
        together, as the reference does. Each choice is pumped by a thread
        of its own, as the reference pumps each in a task. An error of any
        choice ends the stream; closing it aborts every sibling at its next
        event."""
        subs = [dataclasses.replace(pre, request_id=f"{pre.request_id}-{i}",
                                    seed=None if pre.seed is None else pre.seed + i)
                for i in range(n)]
        streams = []
        if self.prefix_caching and len(pre.token_ids) > self.card.kv_page_size:
            events = self.engine_fn(subs[0])
            head = next(events, None)
            streams.append(self._one_choice(
                subs[0], include_usage, events=iter(()) if head is None else _prepend(head, events)))
        # each is submitted at its pump thread's first read
        streams += [self._one_choice(sub, include_usage) for sub in subs[len(streams):]]
        chunks: queue.Queue = queue.Queue()
        closed = threading.Event()

        def pump(i: int, stream: Iterator[ChatCompletionChunk]) -> None:
            try:
                for chunk in stream:
                    chunks.put((i, chunk))
                    if closed.is_set():
                        break
            except Exception as e:  # raised on the caller's thread
                chunks.put((i, e))
            finally:
                stream.close()
                chunks.put((i, None))

        for i, stream in enumerate(streams):
            threading.Thread(target=pump, args=(i, stream), daemon=True,
                             name=f"choice-{pre.request_id}-{i}").start()
        try:
            usages = []
            live = n
            while live:
                i, chunk = chunks.get()
                if chunk is None:
                    live -= 1
                    continue
                if isinstance(chunk, Exception):
                    raise chunk
                chunk.id = pre.request_id
                if chunk.usage is not None:
                    usages.append(chunk.usage)
                    continue  # the usage-only trailer, folded below
                for c in chunk.choices:
                    c.index = i
                yield chunk
            usage = combine_usages(usages)
            if usage is not None:
                yield ChatCompletionChunk(id=pre.request_id, model=self.card.name, choices=[],
                                          usage=usage)
        finally:
            closed.set()

    def _clamp(self, pre: PreprocessedRequest) -> None:
        room = self.card.context_length - len(pre.token_ids) - 1
        if room < 0:
            raise ValueError(
                f"prompt of {len(pre.token_ids)} tokens exceeds context "
                f"window {self.card.context_length}"
            )
        pre.max_tokens = max(1, min(pre.max_tokens, room)) if room else 1

    def close(self) -> None:
        if self.close_fn:
            self.close_fn()


def _prepend(head: dict, rest: Iterator[dict]) -> Iterator[dict]:
    yield head
    yield from rest


def local_pipeline(card: ModelDeploymentCard, runner) -> ModelPipeline:
    """Single-process pipeline over an in-process engine runner."""
    return ModelPipeline(card, engine_fn=runner.generate, close_fn=runner.stop,
                         prefix_caching=runner.engine.config.enable_prefix_caching)


class ModelManager:
    def __init__(self):
        self.pipelines: dict[str, ModelPipeline] = {}

    def add(self, name: str, pipeline: ModelPipeline) -> None:
        self.pipelines[name] = pipeline
        logger.info("model attached: %s", name)

    def remove(self, name: str) -> None:
        p = self.pipelines.pop(name, None)
        if p is not None:
            p.close()
            logger.info("model detached: %s", name)

    def get(self, name: str) -> Optional[ModelPipeline]:
        return self.pipelines.get(name)

    def list_models(self) -> list[str]:
        return sorted(self.pipelines)
