"""Model registry: a preset name -> the model's config and functions.

Counterpart of dynamo_tpu/models/registry.py::get_model for the llama
presets the port's kernels serve (head_dim 64, 96, 128 or 256): the
Llama-3 sizes, Qwen2 (q/k/v bias), Qwen3 (per-head q/k RMSNorm), Phi-3-mini
(head_dim 96), Phi-4 and Gemma-2B/7B (head_dim 256, GeGLU, the (1 + w)
RMSNorm, scaled embeddings). Other families, HF checkpoint directories and
GGUF files wait for later work and raise.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Optional

import torch

from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.models.llama import LlamaConfig

_LLAMA_PRESETS: dict[str, Callable[[], LlamaConfig]] = {
    "tiny": LlamaConfig.tiny,
    "llama3-1b": LlamaConfig.llama3_1b,
    # the speculation draft of the llama3 presets (their vocabulary);
    # served alone too, but meant for EngineConfig.spec_draft_model
    "llama3-draft": LlamaConfig.llama3_draft,
    "llama3-8b": LlamaConfig.llama3_8b,
    "llama3-70b": LlamaConfig.llama3_70b,
    # DeepSeek-R1-Distill-Llama-8B is architecturally Llama-3-8B
    "deepseek-r1-distill-llama-8b": LlamaConfig.llama3_8b,
    # Qwen2 family = Llama + qkv bias (a query group of 7)
    "qwen2-7b": LlamaConfig.qwen2_7b,
    "qwen2-0.5b": LlamaConfig.qwen2_05b,
    # Qwen3 = Llama + per-head q/k RMSNorm (no attention bias)
    "qwen3-8b": LlamaConfig.qwen3_8b,
    # Phi-3 / Phi-4 = Llama with fused qkv/gate_up in their checkpoints
    "phi3-mini": LlamaConfig.phi3_mini,
    "phi4": LlamaConfig.phi4,
    # Gemma = Llama + GeGLU, (1 + w) RMSNorm, sqrt(H)-scaled embeddings
    "gemma-2b": LlamaConfig.gemma_2b,
    "gemma-7b": LlamaConfig.gemma_7b,
}

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclass(frozen=True)
class ModelAdapter:
    name: str
    config: LlamaConfig

    @property
    def vocab_size(self) -> int:
        return self.config.vocab_size

    def init_params(self, generator: torch.Generator) -> dict:
        return llama.init_params(generator, self.config)

    def quantize_params(self, params: dict) -> dict:
        """Weight-only int8 (`quantize="int8"`) of model-dtype params."""
        return llama.quantize_params_int8(params)

    def init_params_quantized(self, generator: torch.Generator) -> dict:
        """Random params straight in the int8 weight-only layout."""
        return llama.init_params_int8(generator, self.config)

    def init_kv(self, num_pages: int, page_size: int, device,
                kv_quantize: Optional[str] = None) -> llama.KVPages:
        return llama.init_kv_pages(self.config, num_pages, page_size, device,
                                   kv_quantize=kv_quantize)

    def forward_hidden(self, params, tokens, positions, valid, kv, page_tables, **kw):
        return llama.forward_hidden(
            params, self.config, tokens, positions, valid, kv, page_tables, **kw
        )

    def compute_logits(self, params, hidden):
        return llama.compute_logits(params, self.config, hidden)


def get_model(name: str, dtype: Optional[str] = None) -> ModelAdapter:
    """Resolve a llama preset name; `dtype` ("bfloat16" | "float32")
    overrides the preset's."""
    key = name.lower()
    if key not in _LLAMA_PRESETS:
        raise ValueError(
            f"unknown model {name!r}; dynamo_tpu_torch serves the presets "
            f"{sorted(_LLAMA_PRESETS)}"
        )
    cfg = _LLAMA_PRESETS[key]()
    if dtype is not None:
        if dtype not in _DTYPES:
            raise ValueError(f"unknown dtype {dtype!r}; use one of {sorted(_DTYPES)}")
        cfg = replace(cfg, dtype=_DTYPES[dtype])
    return ModelAdapter(name=key, config=cfg)
