"""Model deployment card: the metadata a frontend needs to serve a model.

Counterpart of dynamo_tpu/model_card.py::ModelDeploymentCard, without the
fabric publishing (this package serves one process).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class ModelDeploymentCard:
    name: str
    tokenizer: dict = field(default_factory=lambda: {"kind": "byte"})
    context_length: int = 4096
    eos_token_ids: tuple[int, ...] = (0,)
    kv_page_size: int = 64
