"""ModelManager + ModelPipeline.

Counterpart of dynamo_tpu/frontend/service.py for one process: a
ModelPipeline is the serving chain of one model, OpenAI request ->
preprocess (template + tokenize) -> engine -> postprocess (detokenize +
stop strings + chunks); the ModelManager maps model names to pipelines.
"""

from __future__ import annotations

import logging
from typing import Callable, Iterator, Optional

from dynamo_tpu_torch.model_card import ModelDeploymentCard
from dynamo_tpu_torch.preprocessor import OpenAIPreprocessor, load_tokenizer
from dynamo_tpu_torch.preprocessor.preprocessor import PreprocessedRequest
from dynamo_tpu_torch.protocols.openai import (
    ChatCompletionChunk,
    ChatCompletionRequest,
    CompletionRequest,
)

logger = logging.getLogger(__name__)


class ModelPipeline:
    def __init__(
        self,
        card: ModelDeploymentCard,
        engine_fn: Callable[[PreprocessedRequest], Iterator[dict]],
        close_fn: Optional[Callable[[], None]] = None,
    ):
        self.card = card
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
        return self.preprocessor.postprocess_chat_stream(
            self.engine_fn(pre), pre, include_usage=include_usage
        )

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


def local_pipeline(card: ModelDeploymentCard, runner) -> ModelPipeline:
    """Single-process pipeline over an in-process engine runner."""
    return ModelPipeline(card, engine_fn=runner.generate, close_fn=runner.stop)


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
