"""Engine-facing request/response types.

Counterpart of dynamo_tpu/engine/request.py, trimmed to what this package
serves: tokens in, tokens out, with the sampling knobs it implements
(logprobs, penalties, logit_bias and min_tokens among them), the prompt
tokens the prefix cache served, the n-gram index of prompt-lookup
speculation and the draft model's committed position.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0  # 0 => greedy
    top_p: float = 1.0
    top_k: int = 0  # 0 => disabled
    max_tokens: int = 256
    stop_token_ids: tuple[int, ...] = ()
    ignore_eos: bool = False
    seed: Optional[int] = None
    #: -1 = off; 0 = the chosen token's logprob only; N > 0 = chosen + the
    #: top-N alternatives per emitted token (OpenAI logprobs/top_logprobs)
    logprobs: int = -1
    #: OpenAI penalties over the output-token history (0 = off)
    frequency_penalty: float = 0.0
    presence_penalty: float = 0.0
    #: multiplicative repetition penalty over GENERATED tokens only; prompt
    #: tokens are not penalized (1 = off; nvext repetition_penalty)
    repetition_penalty: float = 1.0
    #: OpenAI logit_bias: (token id, additive bias) pairs applied in the
    #: sampler before temperature, at most sampling.BIAS_SLOTS less the
    #: min_tokens ban slots
    logit_bias: tuple[tuple[int, float], ...] = ()
    #: eos/stop tokens are banned in the sampler until this many output
    #: tokens exist
    min_tokens: int = 0


class FinishReason(str, enum.Enum):
    STOP = "stop"  # eos / stop token
    LENGTH = "length"  # max_tokens or context limit
    CANCELLED = "cancelled"
    ERROR = "error"


class RequestState(str, enum.Enum):
    WAITING = "waiting"
    PREFILL = "prefill"
    DECODE = "decode"
    FINISHED = "finished"


@dataclass
class Request:
    """One in-flight generation inside the engine."""

    request_id: str
    prompt_tokens: list[int]
    sampling: SamplingParams = field(default_factory=SamplingParams)

    # -- engine-managed state ---------------------------------------------
    state: RequestState = RequestState.WAITING
    output_tokens: list[int] = field(default_factory=list)
    pages: list[int] = field(default_factory=list)
    #: tokens whose KV is already in pages (prefix-cache hits and prefilled)
    num_computed_tokens: int = 0
    #: prompt tokens served from the prefix cache at admission
    num_cached_prompt_tokens: int = 0
    #: tokens emitted before a preemption folded them into the prompt
    #: (keeps the max_tokens budget and the sampling counter right)
    num_emitted: int = 0
    finish_reason: Optional[FinishReason] = None
    #: prompt-lookup speculation (engine-managed): n-gram -> its last start
    #: position, a copy of the token sequence it indexes (all_tokens builds
    #: a new list each call) and the next n-gram start not indexed yet
    spec_index: Optional[dict] = None
    spec_ctx: Optional[list] = None
    spec_indexed_upto: int = 0
    #: draft-model speculation (engine-managed): the tokens whose draft KV
    #: is committed, positions [0, spec_draft_pos) of the draft's pool
    spec_draft_pos: int = 0

    @property
    def num_tokens(self) -> int:
        return len(self.prompt_tokens) + len(self.output_tokens)

    @property
    def all_tokens(self) -> list[int]:
        return self.prompt_tokens + self.output_tokens


@dataclass(frozen=True)
class StepOutput:
    """Per-request result of one engine step."""

    request_id: str
    new_token_ids: tuple[int, ...]
    finish_reason: Optional[FinishReason] = None
    #: each new token's logprob (when sampling.logprobs >= 0)
    logprobs: Optional[tuple[float, ...]] = None
    #: each new token's top-N alternatives ((token id, logprob), ...)
    top_logprobs: Optional[tuple[tuple[tuple[int, float], ...], ...]] = None
    #: prompt tokens served from the prefix cache, on the first output only
    #: (OpenAI usage.prompt_tokens_details.cached_tokens)
    cached_tokens: Optional[int] = None
