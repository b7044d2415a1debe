"""Model registry: a preset name, an HF checkpoint directory or a GGUF
file -> the model's config and functions.

Counterpart of dynamo_tpu/models/registry.py::get_model for the llama
family the port's kernels serve (head_dim 64, 96, 128 or 256): the
presets (the Llama-3 sizes, Qwen2 (q/k/v bias), Qwen3 (per-head q/k
RMSNorm), Phi-3-mini (head_dim 96), Phi-4 and Gemma-2B/7B (head_dim 256,
GeGLU, the (1 + w) RMSNorm, scaled embeddings)); a local directory whose
config.json LlamaConfig.from_hf_config accepts; and a `.gguf` file of an
architecture the reference accepts whose config the port serves. A
directory or file name is the adapter's `default_checkpoint`, which the
engine loads through `load_params`. Other families raise by name.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, replace
from typing import Callable, Optional

import torch

from dynamo_tpu_torch import gguf
from dynamo_tpu_torch.models import checkpoint, llama
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
    #: where the weights live when the model name itself names them (an HF
    #: checkpoint directory or a .gguf file); the engine loads from here
    #: when it is given no checkpoint_path
    default_checkpoint: Optional[str] = None

    @property
    def vocab_size(self) -> int:
        return self.config.vocab_size

    def init_params(self, generator: torch.Generator) -> dict:
        return llama.init_params(generator, self.config)

    def load_params(self, path: str, device=None) -> dict:
        """The weights of a checkpoint for this config: a `.gguf` file, or
        an HF directory (safetensors, sharded or not, or pytorch_model.bin).
        On `cuda` unless the caller asks for `cpu`; on the card a config its
        kernels cannot run is refused before any weight is read."""
        if torch.device(device or "cuda").type == "cuda":
            llama.refuse_unserved_kernel_shapes(self.config)
        if path.lower().endswith(".gguf"):
            return llama.params_from_gguf(gguf.read_gguf(path), self.config, device)
        return llama.params_from_torch_state_dict(checkpoint.load_state_dict(path),
                                                  self.config, device)

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
    """Resolve a llama preset name, a `.gguf` file or an HF checkpoint
    directory (config.json); `dtype` ("bfloat16" | "float32") overrides
    the config's."""
    key = name.lower()
    default_checkpoint = None
    if key in _LLAMA_PRESETS:
        cfg = _LLAMA_PRESETS[key]()
    elif key.endswith(".gguf") and os.path.isfile(name):
        cfg, key, default_checkpoint = gguf.read_gguf(name).to_llama_config(), name, name
    elif os.path.isdir(name) and os.path.exists(os.path.join(name, "config.json")):
        with open(os.path.join(name, "config.json")) as f:
            cfg = LlamaConfig.from_hf_config(json.load(f))
        key, default_checkpoint = name, name
    else:
        raise ValueError(
            f"unknown model {name!r}; dynamo_tpu_torch serves the presets "
            f"{sorted(_LLAMA_PRESETS)}, a local HF checkpoint directory or a .gguf file"
        )
    if dtype is not None:
        if dtype not in _DTYPES:
            raise ValueError(f"unknown dtype {dtype!r}; use one of {sorted(_DTYPES)}")
        cfg = replace(cfg, dtype=_DTYPES[dtype])
    return ModelAdapter(name=key, config=cfg, default_checkpoint=default_checkpoint)
