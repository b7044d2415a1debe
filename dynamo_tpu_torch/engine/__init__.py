"""The serving engine: config, scheduler, allocator, sampler, TorchEngine."""

from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.request import SamplingParams, StepOutput

__all__ = ["EngineConfig", "SamplingParams", "StepOutput"]
