"""Llama-family decoder over a paged KV cache, in PyTorch.

Counterpart of dynamo_tpu/models/llama.py, trimmed to the llama fields and
the kernel write discipline: each layer reads the cache as history only,
stages its new (post-rope) K/V, and the step lands every layer's K/V in
the pools with one `paged_write` after the layer loop. A first prefill
chunk attends over itself with `flash_prefill_attention`; any other chunk
(a later chunk of a long prompt, in a batch that may also hold first
chunks) attends over its paged history and itself with
`paged_prefill_attention`; a decode step attends over its paged history
with `paged_decode_attention` and folds the current token in exactly.

Layouts match the JAX package at every public function: KV pools
[L, P, S, Hkv, D] with page 0 the null page, staged KV [L, B, T, Hkv, D],
q [B, T, Hq, D], weights [in, out] stacked over layers. The pools keep the
true head_dim (the JAX package pads it to 128 lanes for the TPU).

Quantized KV pages (`kv_quantize` "int8" or "fp8"): the pools hold narrow
rows with f32 scale planes [L, P, S, Hkv] (ops/kv_quant.py). Only the pool
is quantized: the layers stage K/V in the model dtype and the write
quantizes them; readers dequantize the history, while a decode step's own
token and a chunk's own K/V enter attention exact.

Weight-only int8 (`quantize_params_int8`, `init_params_int8`; the engine's
`quantize="int8"`): the seven dense weights of every layer are int8
[L, in, out] beside f32 scales [L, 1, out], one per output channel, the
reference's layout; embed, lm_head, norms and biases stay in the model
dtype. Each dense product goes through `_mm`, which hands an int8 weight
to `ops.int8_matmul`.

Family flags, as the reference's: `attention_bias` (Qwen2) adds the
q/k/v projection biases `bq`, `bk`, `bv` [L, Hq*D | Hkv*D] before the
heads are split; `qk_norm` (Qwen3) applies a head_dim-wide RMSNorm to q
and k (`q_norm`, `k_norm` [L, D]) after the split and before rope. Gemma
sets three: `hidden_act="gelu_tanh"` (the GeGLU MLP, gelu with the tanh
approximation in f32), `rms_norm_unit_offset` (every RMSNorm scales by
1 + w) and `scale_embeddings` (the embeddings times sqrt(H), the
normalizer rounded to the model dtype first). All are plain torch ops
between the kernels.

Checkpoints (`LlamaConfig.from_hf_config`, `params_from_torch_state_dict`,
`params_from_gguf`): an HF config.json or a GGUF file's metadata maps onto
the config as the reference maps it, and a config whose forward the port
lacks is refused by name; the weights arrive one tensor at a time from a
lazy state dict (models/checkpoint.py) or a GGUF file (gguf.py) and are
cast and transposed on the device into preallocated layer stacks.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from dynamo_tpu_torch.ops import KERNELS, Ops
from dynamo_tpu_torch.ops._counts import HEAD_DIMS
from dynamo_tpu_torch.ops.flash_prefill import TILE_ROWS
from dynamo_tpu_torch.ops.kv_quant import (  # noqa: F401 (the model's API, as the JAX package's)
    dequantize_kv_rows,
    kv_quant_spec,
    quantize_kv_rows,
)
from dynamo_tpu_torch.platform import resolve_device


#: the MLP's gate activations, by LlamaConfig.hidden_act: f32 in, f32 out
_ACTIVATIONS = {
    "silu": F.silu,
    "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
}


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    rope_theta: float = 500000.0
    rms_norm_eps: float = 1e-5
    tie_word_embeddings: bool = False
    #: Llama-3.1-style NTK rope scaling (None disables)
    rope_scaling_factor: Optional[float] = None
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0
    rope_original_max_position: int = 8192
    dtype: torch.dtype = torch.bfloat16
    #: q/k/v projection bias: the Qwen2 family's one architectural delta
    attention_bias: bool = False
    #: Qwen3: per-head RMSNorm on q and k (head_dim-wide), applied after
    #: the projections, before rope
    qk_norm: bool = False
    #: MLP activation: "silu" (Llama/Qwen GLU) or "gelu_tanh" (Gemma GeGLU)
    hidden_act: str = "silu"
    #: Gemma-style RMSNorm: scale by (1 + weight) instead of weight
    rms_norm_unit_offset: bool = False
    #: Gemma scales token embeddings by sqrt(hidden_size)
    scale_embeddings: bool = False

    def __post_init__(self):
        if self.hidden_act not in _ACTIVATIONS:
            raise ValueError(f"unknown hidden_act {self.hidden_act!r}; use one of "
                             f"{sorted(_ACTIVATIONS)}")

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    @staticmethod
    def llama3_8b() -> "LlamaConfig":
        return LlamaConfig()

    @staticmethod
    def llama3_70b() -> "LlamaConfig":
        """Llama-3-70B: 80 layers of width 8,192, 64 query and 8 KV heads
        (bf16 weights about 141 GB: more than one 80 GB card holds)."""
        return LlamaConfig(
            hidden_size=8192, intermediate_size=28672, num_layers=80,
            num_heads=64, num_kv_heads=8,
        )

    @staticmethod
    def llama3_1b() -> "LlamaConfig":
        """Llama-3.2-1B-shaped config."""
        return LlamaConfig(
            hidden_size=2048, intermediate_size=8192, num_layers=16,
            num_heads=32, num_kv_heads=8, head_dim=64,
            tie_word_embeddings=True, rope_scaling_factor=32.0,
        )

    @staticmethod
    def llama3_draft() -> "LlamaConfig":
        """A draft-sized llama on the Llama-3 vocabulary (128,256), the
        speculation draft for the llama3 targets
        (`EngineConfig.spec_draft_model="llama3-draft"`): 4 layers of
        width 512, 8 query and 4 KV heads of 64, tied embeddings. Random
        weights accept at chance, and the engine's acceptance cooldown
        keeps such a draft off the decode path."""
        return LlamaConfig(
            hidden_size=512, intermediate_size=2048, num_layers=4,
            num_heads=8, num_kv_heads=4, head_dim=64,
            tie_word_embeddings=True, rope_scaling_factor=32.0,
        )

    @staticmethod
    def qwen2_7b() -> "LlamaConfig":
        """Qwen2/2.5-7B: Llama architecture + qkv bias; 28 query heads over
        4 KV heads, a query group of 7."""
        return LlamaConfig(
            vocab_size=152064, hidden_size=3584, intermediate_size=18944,
            num_layers=28, num_heads=28, num_kv_heads=4, head_dim=128,
            rope_theta=1000000.0, rms_norm_eps=1e-6, attention_bias=True,
        )

    @staticmethod
    def qwen2_05b() -> "LlamaConfig":
        """Qwen2.5-0.5B: 14 query heads over 2 KV heads of 64 (a query
        group of 7), qkv bias, tied embeddings."""
        return LlamaConfig(
            vocab_size=151936, hidden_size=896, intermediate_size=4864,
            num_layers=24, num_heads=14, num_kv_heads=2, head_dim=64,
            rope_theta=1000000.0, rms_norm_eps=1e-6, attention_bias=True,
            tie_word_embeddings=True,
        )

    @staticmethod
    def qwen3_8b() -> "LlamaConfig":
        """Qwen3-8B: Llama architecture + per-head q/k RMSNorm, no bias."""
        return LlamaConfig(
            vocab_size=151936, hidden_size=4096, intermediate_size=12288,
            num_layers=36, num_heads=32, num_kv_heads=8, head_dim=128,
            rope_theta=1000000.0, rms_norm_eps=1e-6, qk_norm=True,
        )

    @staticmethod
    def gemma_2b() -> "LlamaConfig":
        """Gemma-2B: GeGLU MLP, (1 + w) RMSNorm, sqrt(H)-scaled embeddings,
        tied lm_head, 8 query heads over one KV head of 256 (MQA)."""
        return LlamaConfig(
            vocab_size=256000, hidden_size=2048, intermediate_size=16384,
            num_layers=18, num_heads=8, num_kv_heads=1, head_dim=256,
            rope_theta=10000.0, rms_norm_eps=1e-6, tie_word_embeddings=True,
            hidden_act="gelu_tanh", rms_norm_unit_offset=True,
            scale_embeddings=True,
        )

    @staticmethod
    def gemma_7b() -> "LlamaConfig":
        """Gemma-7B: gemma_2b's flags at 28 layers of width 3,072, 16
        query and 16 KV heads of 256."""
        return LlamaConfig(
            vocab_size=256000, hidden_size=3072, intermediate_size=24576,
            num_layers=28, num_heads=16, num_kv_heads=16, head_dim=256,
            rope_theta=10000.0, rms_norm_eps=1e-6, tie_word_embeddings=True,
            hidden_act="gelu_tanh", rms_norm_unit_offset=True,
            scale_embeddings=True,
        )

    @staticmethod
    def phi3_mini() -> "LlamaConfig":
        """Phi-3-mini-4k: plain Llama with 32 query and 32 KV heads of 96
        (its checkpoint's fused qkv/gate_up are split at load,
        params_from_torch_state_dict)."""
        return LlamaConfig(
            vocab_size=32064, hidden_size=3072, intermediate_size=8192,
            num_layers=32, num_heads=32, num_kv_heads=32, head_dim=96,
            rope_theta=10000.0, rms_norm_eps=1e-5,
        )

    @staticmethod
    def phi4() -> "LlamaConfig":
        """Phi-4 (14B): 40 layers, 40 query heads over 10 KV heads, a
        250k rope base (its checkpoint's fused qkv/gate_up are split at
        load, params_from_torch_state_dict)."""
        return LlamaConfig(
            vocab_size=100352, hidden_size=5120, intermediate_size=17920,
            num_layers=40, num_heads=40, num_kv_heads=10, head_dim=128,
            rope_theta=250000.0, rms_norm_eps=1e-5,
        )

    @staticmethod
    def from_hf_config(hf: dict) -> "LlamaConfig":
        """A HuggingFace `config.json` dict as LlamaConfig, each field mapped
        as the reference's from_hf_config maps it (Llama, Qwen2, Qwen3,
        Phi-3/Phi-4, Gemma, and Mistral without a window). A config whose
        forward the port lacks is refused by name (_refuse_hf_config)."""
        arch = (hf.get("architectures") or ["LlamaForCausalLM"])[0]
        model_type = hf.get("model_type")
        _refuse_hf_config(hf, arch, model_type)
        rope_scaling = hf.get("rope_scaling") or {}
        factor = None
        if rope_scaling.get("rope_type", rope_scaling.get("type")) == "llama3":
            factor = float(rope_scaling["factor"])
        gemma = model_type == "gemma" or arch == "GemmaForCausalLM"
        qwen3 = model_type == "qwen3" or arch == "Qwen3ForCausalLM"
        hidden_act = hf.get("hidden_activation") or hf.get("hidden_act", "silu")
        if hidden_act in ("gelu_pytorch_tanh", "gelu_tanh", "gelu"):
            hidden_act = "gelu_tanh"
        return LlamaConfig(
            attention_bias=bool(hf.get("attention_bias", arch == "Qwen2ForCausalLM")),
            qk_norm=qwen3,
            hidden_act=hidden_act,
            rms_norm_unit_offset=gemma,
            scale_embeddings=gemma,
            vocab_size=hf["vocab_size"],
            hidden_size=hf["hidden_size"],
            intermediate_size=hf["intermediate_size"],
            num_layers=hf["num_hidden_layers"],
            num_heads=hf["num_attention_heads"],
            num_kv_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
            head_dim=hf.get("head_dim") or hf["hidden_size"] // hf["num_attention_heads"],
            rope_theta=float(hf.get("rope_theta", 10000.0)),
            rms_norm_eps=float(hf.get("rms_norm_eps", 1e-5)),
            tie_word_embeddings=bool(hf.get("tie_word_embeddings", gemma)),
            rope_scaling_factor=factor,
            rope_low_freq_factor=float(rope_scaling.get("low_freq_factor", 1.0)),
            rope_high_freq_factor=float(rope_scaling.get("high_freq_factor", 4.0)),
            rope_original_max_position=int(
                rope_scaling.get("original_max_position_embeddings") or 8192),
        )

    @staticmethod
    def tiny(vocab_size: int = 256) -> "LlamaConfig":
        """For unit tests on the CPU."""
        return LlamaConfig(
            vocab_size=vocab_size, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
            rope_theta=10000.0, dtype=torch.float32,
        )


#: HF architectures and model types whose forward the port lacks -> why
_UNSERVED_HF = (
    (("Gemma2ForCausalLM", "Gemma3ForCausalLM"), ("gemma2", "gemma3_text", "gemma3"),
     "Gemma2/Gemma3 (sliding windows, logit softcaps, query_pre_attn_scalar, post-block "
     "norms)"),
    (("Llama4ForCausalLM",), ("llama4_text", "llama4"),
     "Llama-4 (chunked attention, NoPE layers, MoE)"),
    (("GptOssForCausalLM",), ("gpt_oss",), "GPT-OSS (sinks, windows, YaRN, MoE)"),
    (("MixtralForCausalLM", "Qwen3MoeForCausalLM", "Qwen2MoeForCausalLM"),
     ("mixtral", "qwen3_moe", "qwen2_moe"), "the MoE families"),
    (("DeepseekV2ForCausalLM", "DeepseekV3ForCausalLM"), ("deepseek_v2", "deepseek_v3"),
     "the MLA families (DeepSeek-V2/V3)"),
    (("Qwen2VLForConditionalGeneration", "Qwen2_5_VLForConditionalGeneration"),
     ("qwen2_vl", "qwen2_5_vl"), "the Qwen2-VL families (m-RoPE, a vision tower)"),
)


def _refuse_hf_config(hf: dict, arch: str, model_type: Optional[str]) -> None:
    """Raise ValueError, by name, for a config the port's forward does not
    serve yet: the families above, Mistral's sliding window, a yarn, linear
    or other non-llama3 rope scaling, a partial rotary factor, a quantized
    checkpoint, and (as the reference) an unknown hidden_act."""
    for archs, types, what in _UNSERVED_HF:
        if arch in archs or model_type in types:
            raise ValueError(f"{arch} ({model_type}): {what} is not served by "
                             "dynamo_tpu_torch yet")
    # the reference's llama-family test (dynamo_tpu/models/registry.py:396-407)
    if not ("llama" in arch.lower() or "qwen2" in arch.lower()
            or arch in ("GemmaForCausalLM", "MistralForCausalLM", "Qwen3ForCausalLM",
                        "Phi3ForCausalLM")
            or model_type in ("gemma", "mistral", "qwen3", "phi3")):
        raise ValueError(f"unsupported architecture {arch} ({model_type})")
    if (model_type == "mistral" or arch == "MistralForCausalLM") and hf.get("sliding_window"):
        raise ValueError(f"Mistral's sliding_window={hf['sliding_window']} is not served by "
                         "dynamo_tpu_torch yet (no window in its kernels)")
    rope_scaling = hf.get("rope_scaling") or {}
    rs_type = rope_scaling.get("rope_type", rope_scaling.get("type"))
    if rope_scaling and rs_type != "llama3":
        raise ValueError(f"unsupported rope_scaling type {rs_type!r}: dynamo_tpu_torch serves "
                         "llama3 NTK scaling only (yarn and linear are not ported yet)")
    if float(hf.get("partial_rotary_factor") or 1.0) != 1.0:
        raise ValueError(f"partial_rotary_factor={hf['partial_rotary_factor']} is not served "
                         "by dynamo_tpu_torch (rope covers the whole head)")
    if hf.get("quantization_config"):
        method = hf["quantization_config"].get("quant_method", "?")
        raise ValueError(f"quantization_config ({method}): quantized checkpoints are not "
                         "served by dynamo_tpu_torch (F32, F16 and BF16 weights only)")
    act = hf.get("hidden_activation") or hf.get("hidden_act", "silu")
    if act not in ("gelu_pytorch_tanh", "gelu_tanh", "gelu", "silu"):
        raise ValueError(f"unsupported hidden_act {act!r} in HF config")


def refuse_unserved_kernel_shapes(cfg: LlamaConfig) -> None:
    """Raise ValueError, naming the kernel limit, for a config the CUDA
    kernels cannot run: a head_dim outside ops/_counts.HEAD_DIMS (every
    attention kernel and the quantizing write), or a query group
    num_heads / num_kv_heads over the prefill kernels' 128 tile rows
    (ops/flash_prefill.TILE_ROWS). The plain versions take any shape, so
    only a load onto the card is refused."""
    if cfg.head_dim not in HEAD_DIMS:
        raise ValueError(f"head_dim {cfg.head_dim} is not served on the card: the CUDA "
                         f"attention kernels take head_dim {', '.join(map(str, HEAD_DIMS))}")
    if cfg.num_heads % cfg.num_kv_heads:
        raise ValueError(f"num_heads {cfg.num_heads} is not a multiple of num_kv_heads "
                         f"{cfg.num_kv_heads}")
    group = cfg.num_heads // cfg.num_kv_heads
    if group > TILE_ROWS:
        raise ValueError(f"a query group of {group} heads is not served on the card: the CUDA "
                         f"prefill kernels take at most {TILE_ROWS} (their tile's rows)")


class KVPages(NamedTuple):
    """Paged KV cache: k, v [L, P, S, Hkv, D]. Page 0 is the null page:
    padding writes land there and no page table names it. A quantized
    cache holds int8 or fp8 rows, and k_scale, v_scale [L, P, S, Hkv] f32
    hold one scale per row."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def num_pages(self) -> int:
        return self.k.shape[1]

    @property
    def page_size(self) -> int:
        return self.k.shape[2]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


def init_kv_pages(cfg: LlamaConfig, num_pages: int, page_size: int, device,
                  kv_quantize: Optional[str] = None) -> KVPages:
    """Zeroed pools of the model dtype, or of kv_quantize's narrow dtype
    with zeroed scale planes."""
    shape = (cfg.num_layers, num_pages, page_size, cfg.num_kv_heads, cfg.head_dim)
    if kv_quantize:
        qdtype, _ = kv_quant_spec(kv_quantize)
        return KVPages(
            k=torch.zeros(shape, dtype=qdtype, device=device),
            v=torch.zeros(shape, dtype=qdtype, device=device),
            k_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=device),
            v_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=device),
        )
    return KVPages(
        k=torch.zeros(shape, dtype=cfg.dtype, device=device),
        v=torch.zeros(shape, dtype=cfg.dtype, device=device),
    )


def kv_page_bytes(cfg: LlamaConfig, page_size: int, kv_quantize: Optional[str] = None,
                  dtype: Optional[torch.dtype] = None) -> int:
    """Bytes one page costs across all layers, K and V (and their scale
    planes when quantized: D narrow bytes and a 4-byte scale per row).
    The port's rows are head_dim wide (the JAX package counts its
    lane-padded kv_head_dim)."""
    rows = 2 * cfg.num_layers * page_size * cfg.num_kv_heads
    if kv_quantize:
        qdtype, _ = kv_quant_spec(kv_quantize)
        return rows * (cfg.head_dim * qdtype.itemsize + 4)
    return rows * cfg.head_dim * (dtype or cfg.dtype).itemsize


def kv_pages_from_jax(k: np.ndarray, v: np.ndarray, cfg: LlamaConfig, device=None,
                      k_scale: Optional[np.ndarray] = None,
                      v_scale: Optional[np.ndarray] = None) -> KVPages:
    """The JAX package's KVPages (as numpy, possibly lane-padded to 128)
    as the port's pools: the padding lanes are stripped. A quantized pool
    passes its scale planes too, its rows as int8, or as a uint8 view of
    float8_e4m3fn; padding lanes quantize to 0 and leave the scales as
    they are. On `cuda` unless the caller asks for `cpu`."""
    device = resolve_device(device)
    d = cfg.head_dim
    if k_scale is None:
        return KVPages(
            k=torch.tensor(np.asarray(k[..., :d], np.float32), dtype=cfg.dtype, device=device),
            v=torch.tensor(np.asarray(v[..., :d], np.float32), dtype=cfg.dtype, device=device),
        )

    def rows(x):
        x = np.ascontiguousarray(x[..., :d])
        if x.dtype == np.uint8:
            return torch.from_numpy(x).view(torch.float8_e4m3fn).to(device)
        if x.dtype != np.int8:
            raise ValueError(f"quantized rows arrive as int8 or uint8, not {x.dtype}")
        return torch.from_numpy(x).to(device)

    def plane(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)

    return KVPages(k=rows(k), v=rows(v), k_scale=plane(k_scale), v_scale=plane(v_scale))


# -- parameters -------------------------------------------------------------------


def init_params(generator: torch.Generator, cfg: LlamaConfig) -> dict:
    """Random-init params on the generator's device, layer-stacked like
    the JAX package's: N(0, 1/fan_in) weights, unit norms, zero biases."""
    return _random_params(generator, cfg, int8=False)


def init_params_int8(generator: torch.Generator, cfg: LlamaConfig) -> dict:
    """Random-init straight into the int8 weight-only layout (the same
    names, dtypes and shapes as quantize_params_int8's): each dense weight
    is drawn N(0, 1/fan_in) in f32 and quantized one layer at a time, so
    llama3-8b never holds its 16 GB of model-dtype weights; embed, lm_head,
    norms and biases as init_params makes them."""
    return _random_params(generator, cfg, int8=True)


def _random_params(generator: torch.Generator, cfg: LlamaConfig, int8: bool) -> dict:
    dev = generator.device
    h, i, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    qd, kvd = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    L = cfg.num_layers

    def draw(shape, fan_in):
        w = torch.randn(shape, generator=generator, device=dev, dtype=torch.float32)
        return w * (1.0 / math.sqrt(fan_in))

    def ones(shape):
        return torch.ones(shape, dtype=cfg.dtype, device=dev)

    embed = draw((v, h), h).to(cfg.dtype)
    layers = {"attn_norm": ones((L, h)), "mlp_norm": ones((L, h))}
    if cfg.attention_bias:
        for name, width in (("bq", qd), ("bk", kvd), ("bv", kvd)):
            layers[name] = torch.zeros((L, width), dtype=cfg.dtype, device=dev)
    if cfg.qk_norm:
        layers["q_norm"] = ones((L, cfg.head_dim))
        layers["k_norm"] = ones((L, cfg.head_dim))
    for name, din, dout in (("wq", h, qd), ("wk", h, kvd), ("wv", h, kvd), ("wo", qd, h),
                            ("w_gate", h, i), ("w_up", h, i), ("w_down", i, h)):
        if int8:
            layers[name], layers[name + "_scale"] = _int8_stack(
                (L, din, dout), lambda li: draw((din, dout), din), dev)
        else:
            layers[name] = draw((L, din, dout), din).to(cfg.dtype)
    params = {"embed": embed, "layers": layers, "final_norm": ones((h,))}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = draw((h, v), h).to(cfg.dtype)
    return params


_LAYER_KEYS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate", "w_up", "w_down")

#: the per-layer dense weights weight-only quantization covers
QUANTIZED_DENSE_NAMES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def _layer_keys(cfg: LlamaConfig) -> tuple[str, ...]:
    """The layer leaves of a model-dtype param tree of `cfg`: the norms and
    dense weights, the q/k/v biases with attention_bias, the q/k norms
    with qk_norm."""
    return (_LAYER_KEYS + (("bq", "bk", "bv") if cfg.attention_bias else ())
            + (("q_norm", "k_norm") if cfg.qk_norm else ()))


def quantize_channelwise_int8(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's int8 scheme: per-output-channel symmetric max-abs
    scales over a [in, out] weight, max|w| / 127 floored at 1e-8, values
    rounded half to even. Returns (int8 weight, [1, out] f32 scale).

    The scale is max|w| times the f32 reciprocal of 127, as the reference
    computes it wherever it quantizes (quantize_params_int8 and
    init_params_int8 run it compiled, and XLA turns the division by the
    constant into that product; dispatched op by op it divides, and a
    scale can differ by one ulp). The values divide by the scale tensor."""
    wf = w.float()
    amax = wf.abs().amax(dim=0, keepdim=True)
    scale = torch.maximum(amax * torch.tensor(1.0 / 127.0, dtype=torch.float32, device=w.device),
                          torch.tensor(1e-8, dtype=torch.float32, device=w.device))
    return torch.round(wf / scale).to(torch.int8), scale


def _int8_stack(shape: tuple[int, int, int], layer, device) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 [L, in, out] and f32 scales [L, 1, out], layer li quantized from
    layer(li) one at a time, so the f32 temporary stays one layer's size."""
    q = torch.empty(shape, dtype=torch.int8, device=device)
    scale = torch.empty((shape[0], 1, shape[2]), dtype=torch.float32, device=device)
    for li in range(shape[0]):
        q[li], scale[li] = quantize_channelwise_int8(layer(li))
    return q, scale


def quantize_params_int8(params: dict) -> dict:
    """Weight-only int8 with per-output-channel scales, applied to the
    seven layer weights (QUANTIZED_DENSE_NAMES): each becomes int8
    [L, in, out] beside its f32 `<name>_scale` [L, 1, out]; embed, lm_head
    and norms stay in the model dtype. Decode reads every weight on every
    step, and int8 halves those bytes against bf16. Refuses params that
    are already quantized, as the reference does."""
    layers = dict(params["layers"])
    if any(layers[n].dtype == torch.int8 for n in QUANTIZED_DENSE_NAMES):
        raise ValueError(
            "params are already int8-quantized; re-quantizing would "
            "recompute scales from quantized values and corrupt the model"
        )
    for name in QUANTIZED_DENSE_NAMES:
        w = layers[name]
        layers[name], layers[name + "_scale"] = _int8_stack(tuple(w.shape), w.__getitem__,
                                                            w.device)
    return {**params, "layers": layers}


def params_from_jax(np_params: dict, cfg: LlamaConfig, device=None) -> dict:
    """The JAX package's param tree (leaves as numpy arrays) as the port's
    params: the same names, layouts and layer stacking, cast to cfg.dtype;
    int8 weights stay int8 and their `<name>_scale` leaves f32 (the
    reference's int8 layout). Raises ValueError on a layer leaf that cfg's
    forward does not read, or on one it reads that is missing. On `cuda`
    unless the caller asks for `cpu`."""
    device = resolve_device(device)

    def conv(x):
        return torch.tensor(np.asarray(x, np.float32), dtype=cfg.dtype, device=device)

    keys = _layer_keys(cfg)
    scales = {name + "_scale" for name in QUANTIZED_DENSE_NAMES}
    unknown = sorted(set(np_params["layers"]) - set(keys) - scales)
    missing = sorted(set(keys) - set(np_params["layers"]))
    if unknown or missing:
        raise ValueError(f"params_from_jax: layer leaves {unknown} are not read by this "
                         f"config's forward and {missing} are missing (it reads {list(keys)} "
                         f"and the int8 scales)")
    layers = {}
    for k, x in np_params["layers"].items():
        x = np.asarray(x)
        if x.dtype == np.int8 and k in QUANTIZED_DENSE_NAMES:
            layers[k] = torch.from_numpy(np.ascontiguousarray(x)).to(device)
        elif k in scales:
            layers[k] = torch.tensor(np.asarray(x, np.float32), device=device)
        else:
            layers[k] = conv(x)
    params = {
        "embed": conv(np_params["embed"]),
        "layers": layers,
        "final_norm": conv(np_params["final_norm"]),
    }
    if np_params.get("lm_head") is not None:
        params["lm_head"] = conv(np_params["lm_head"])
    return params


# -- checkpoints ----------------------------------------------------------------

#: layer leaf -> (HF name under model.layers.{l}., transposed [out, in] -> [in, out])
_HF_LAYER = {
    "attn_norm": ("input_layernorm.weight", False),
    "wq": ("self_attn.q_proj.weight", True),
    "wk": ("self_attn.k_proj.weight", True),
    "wv": ("self_attn.v_proj.weight", True),
    "wo": ("self_attn.o_proj.weight", True),
    "mlp_norm": ("post_attention_layernorm.weight", False),
    "w_gate": ("mlp.gate_proj.weight", True),
    "w_up": ("mlp.up_proj.weight", True),
    "w_down": ("mlp.down_proj.weight", True),
    "bq": ("self_attn.q_proj.bias", False),
    "bk": ("self_attn.k_proj.bias", False),
    "bv": ("self_attn.v_proj.bias", False),
    "q_norm": ("self_attn.q_norm.weight", False),
    "k_norm": ("self_attn.k_norm.weight", False),
}
#: the same for a GGUF file's blk.{l}. tensors
_GGUF_LAYER = {
    "attn_norm": ("attn_norm.weight", False),
    "wq": ("attn_q.weight", True),
    "wk": ("attn_k.weight", True),
    "wv": ("attn_v.weight", True),
    "wo": ("attn_output.weight", True),
    "mlp_norm": ("ffn_norm.weight", False),
    "w_gate": ("ffn_gate.weight", True),
    "w_up": ("ffn_up.weight", True),
    "w_down": ("ffn_down.weight", True),
    "bq": ("attn_q.bias", False),
    "bk": ("attn_k.bias", False),
    "bv": ("attn_v.bias", False),
    "q_norm": ("attn_q_norm.weight", False),
    "k_norm": ("attn_k_norm.weight", False),
}


def _check_names(kind: str, have, want: set, optional: set) -> None:
    """Refuse a checkpoint with a tensor the forward would not read, or
    without one it reads, naming them."""
    unknown = sorted(set(have) - want - optional)
    missing = sorted(want - set(have))
    if unknown or missing:
        raise ValueError(f"{kind}: tensors {unknown[:8]}{' ...' if len(unknown) > 8 else ''} "
                         f"are not read by this config's forward and {missing[:8]}"
                         f"{' ...' if len(missing) > 8 else ''} are missing")


def _load_tree(cfg: LlamaConfig, device, layer, top: dict) -> dict:
    """The layer-stacked param tree, one tensor at a time: layer(leaf, li)
    gives (name, tensor, transposed) for a layer leaf, `top` maps "embed",
    "final_norm" and, untied, "lm_head" to (name, tensor); each tensor in
    the file's layout (numpy order, [out, in]) and dtype, on the CPU or the
    device. Each stack is preallocated [L, ...] in cfg.dtype on the device
    and filled by copy_, which casts and transposes there (the cast rounds
    f32 or f16 to the model dtype once, as the reference's f32 -> dtype)."""

    def put(dst: torch.Tensor, name: str, src: torch.Tensor, transpose: bool) -> None:
        want = tuple(dst.shape[::-1]) if transpose else tuple(dst.shape)
        if tuple(src.shape) != want:
            raise ValueError(f"tensor {name!r} has shape {tuple(src.shape)}, the config "
                             f"wants {want}")
        x = src.to(device)
        dst.copy_(x.T if transpose else x)

    h, i, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    qd, kvd = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    shapes = {"attn_norm": (h,), "mlp_norm": (h,), "wq": (h, qd), "wk": (h, kvd),
              "wv": (h, kvd), "wo": (qd, h), "w_gate": (h, i), "w_up": (h, i),
              "w_down": (i, h), "bq": (qd,), "bk": (kvd,), "bv": (kvd,),
              "q_norm": (cfg.head_dim,), "k_norm": (cfg.head_dim,),
              "embed": (v, h), "final_norm": (h,), "lm_head": (h, v)}

    def empty(key, layers=()):
        return torch.empty((*layers, *shapes[key]), dtype=cfg.dtype, device=device)

    params = {"layers": {}}
    for leaf in _layer_keys(cfg):
        stack = params["layers"][leaf] = empty(leaf, (cfg.num_layers,))
        for li in range(cfg.num_layers):
            put(stack[li], *layer(leaf, li))
    for key, (name, src) in top.items():
        params[key] = empty(key)
        put(params[key], name, src, key == "lm_head")
    return params


def params_from_torch_state_dict(state_dict, cfg: LlamaConfig, device=None) -> dict:
    """An HF Llama-family state dict (name -> CPU tensor; a lazy
    models/checkpoint.StateDict loads one tensor at a time) as the port's
    params, as the reference's params_from_torch_state_dict maps it: HF's
    [out, in] projections become [in, out], stacked along L; Phi-3/Phi-4's
    fused qkv_proj and gate_up_proj are split (q/k/v, then gate/up, as HF
    chunks them); q/k/v biases and q/k norms are carried for attention_bias
    and qk_norm; the embedding is tied when lm_head.weight is absent or
    the config ties it. Refuses a tensor the forward would not read and
    names one it lacks (rotary inv_freq buffers aside). On `cuda` unless
    the caller asks for `cpu`."""
    device = resolve_device(device)
    qd, kvd = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    i = cfg.intermediate_size
    #: fused leaf -> (HF name, its rows)
    splits = {"wq": ("self_attn.qkv_proj.weight", slice(0, qd)),
              "wk": ("self_attn.qkv_proj.weight", slice(qd, qd + kvd)),
              "wv": ("self_attn.qkv_proj.weight", slice(qd + kvd, qd + 2 * kvd)),
              "w_gate": ("mlp.gate_up_proj.weight", slice(0, i)),
              "w_up": ("mlp.gate_up_proj.weight", slice(i, 2 * i))} \
        if "model.layers.0.self_attn.qkv_proj.weight" in state_dict else {}

    def hf_name(leaf, li):
        return f"model.layers.{li}.{splits[leaf][0] if leaf in splits else _HF_LAYER[leaf][0]}"

    def layer(leaf, li):
        name = hf_name(leaf, li)
        if leaf in splits:
            return name, state_dict[name][splits[leaf][1]], True
        return name, state_dict[name], _HF_LAYER[leaf][1]

    want = {"model.embed_tokens.weight", "model.norm.weight"} | {
        hf_name(leaf, li) for li in range(cfg.num_layers) for leaf in _layer_keys(cfg)}
    optional = {"lm_head.weight"} | {k for k in state_dict if k.endswith("rotary_emb.inv_freq")}
    _check_names("params_from_torch_state_dict", state_dict, want, optional)
    top = {"embed": "model.embed_tokens.weight", "final_norm": "model.norm.weight"}
    if "lm_head.weight" in state_dict and not cfg.tie_word_embeddings:
        top["lm_head"] = "lm_head.weight"
    return _load_tree(cfg, device, layer, {k: (n, state_dict[n]) for k, n in top.items()})


def _unpermute_rows(w: torch.Tensor, n_head: int) -> torch.Tensor:
    """The inverse of llama.cpp's convert_hf_to_gguf permute of q/k rows
    (reshape(h, 2, d/2, in).swapaxes(1, 2)): back to HF's half-split rope
    pairing, which apply_rope uses."""
    out, inn = w.shape
    d = out // n_head
    return w.reshape(n_head, d // 2, 2, inn).transpose(1, 2).reshape(out, inn)


def params_from_gguf(gguf_file, cfg: LlamaConfig, device=None) -> dict:
    """A GGUF file's tensors (dynamo_tpu_torch/gguf.py's GgufFile) as the
    port's params, as the reference's params_from_gguf maps them:
    token_embd, blk.{l}.{attn_norm, attn_q, attn_k, attn_v, attn_output,
    ffn_norm, ffn_gate, ffn_up, ffn_down} (and the q/k/v biases or q/k
    norms of qwen2 and qwen3 files), output_norm, and output when the file
    has one (else the embedding is tied). F32/F16 load as they are,
    quantized types dequantized to f32; `llama`-arch q/k rows are
    un-permuted from llama.cpp's interleaved rope order, on the device
    (qwen2/qwen3 files are not permuted by the converter). Refuses a tensor
    the forward would not read (rope_freqs, say) and names one it lacks.
    On `cuda` unless the caller asks for `cpu`."""
    device = resolve_device(device)
    g = gguf_file
    permute = {"wq": cfg.num_heads, "wk": cfg.num_kv_heads} if g.architecture() == "llama" \
        else {}

    def tensor(name):
        return torch.from_numpy(g.load_tensor(name))

    def layer(leaf, li):
        name = f"blk.{li}.{_GGUF_LAYER[leaf][0]}"
        w = tensor(name)
        if leaf in permute:
            w = _unpermute_rows(w.to(device), permute[leaf])
        return name, w, _GGUF_LAYER[leaf][1]

    want = {"token_embd.weight", "output_norm.weight"} | {
        f"blk.{li}.{_GGUF_LAYER[leaf][0]}" for li in range(cfg.num_layers)
        for leaf in _layer_keys(cfg)}
    _check_names("params_from_gguf", g.tensors, want, {"output.weight"})
    top = {"embed": "token_embd.weight", "final_norm": "output_norm.weight"}
    if "output.weight" in g.tensors:
        top["lm_head"] = "output.weight"
    return _load_tree(cfg, device, layer, {k: (n, tensor(n)) for k, n in top.items()})


# -- blocks -----------------------------------------------------------------------


def _mm(x: torch.Tensor, lp: dict, name: str, li: int, ops: Ops) -> torch.Tensor:
    """x [..., in] @ layer li's weight `name` [in, out]: an int8 weight
    goes to ops.int8_matmul with its [1, out] scale, any other to `@`."""
    w = lp[name][li]
    if w.dtype == torch.int8:
        y = ops.int8_matmul(x.reshape(-1, x.shape[-1]), w, lp[name + "_scale"][li])
        return y.reshape(*x.shape[:-1], w.shape[1])
    return x @ w


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float,
             unit_offset: bool = False) -> torch.Tensor:
    """RMSNorm in f32; `unit_offset` (Gemma) scales by 1 + weight, the
    offset added in f32."""
    xf = x.float()
    out = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + eps)
    w = weight.float()
    if unit_offset:
        w = w + 1.0
    return (out * w).to(x.dtype)


def _rope_inv_freq(cfg: LlamaConfig, device) -> torch.Tensor:
    d = cfg.head_dim
    inv_freq = 1.0 / (
        cfg.rope_theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=device) / d)
    )
    if cfg.rope_scaling_factor is not None:
        # Llama-3.1 NTK-by-parts scaling
        low = cfg.rope_original_max_position / cfg.rope_low_freq_factor
        high = cfg.rope_original_max_position / cfg.rope_high_freq_factor
        wavelen = 2.0 * math.pi / inv_freq
        smooth = (cfg.rope_original_max_position / wavelen - cfg.rope_low_freq_factor) / (
            cfg.rope_high_freq_factor - cfg.rope_low_freq_factor
        )
        smooth = smooth.clamp(0.0, 1.0)
        scaled = inv_freq / cfg.rope_scaling_factor
        blended = (1.0 - smooth) * scaled + smooth * inv_freq
        inv_freq = torch.where(
            wavelen > low, scaled, torch.where(wavelen < high, inv_freq, blended)
        )
    return inv_freq


def rope_tables(positions: torch.Tensor, cfg: LlamaConfig):
    """cos, sin [B, T, 1, D/2] for absolute positions [B, T]."""
    angles = positions[..., None].float() * _rope_inv_freq(cfg, positions.device)
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, T, H, D], half-split pairing (HF convention)."""
    xf = x.float()
    x1, x2 = xf.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def attention_block(q, k, v, kv: KVPages, layer: int, page_tables, positions, valid,
                    cfg: LlamaConfig, cos, sin, first_chunk: bool, ops: Ops):
    """rope, then attention with the cache read as history only.

    q [B, T, Hq, D], k/v [B, T, Hkv, D] pre-rope. Returns (attn
    [B, T, Hq*D], (k, v) staged for this layer, post-rope)."""
    b, t = q.shape[0], q.shape[1]
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if t == 1:
        hist = positions[:, 0].contiguous()  # tokens already in the pages
        qd = q[:, 0].contiguous()
        acc, m, l = ops.paged_decode_attention(
            qd, kv.k, kv.v, layer, page_tables, hist, scale_dim=cfg.head_dim,
            k_scale=kv.k_scale, v_scale=kv.v_scale,
        )  # acc [B, Hq, D] unnormalized, m/l [B, Hq]
        # exact merge of the current (unwritten) token into the flash state
        kv_of = torch.arange(cfg.num_heads, device=q.device) // cfg.q_per_kv
        k_sel = k[:, 0, kv_of].float()
        v_sel = v[:, 0, kv_of].float()
        s_self = (qd.float() * k_sel).sum(dim=-1) * (1.0 / math.sqrt(cfg.head_dim))
        m_star = torch.maximum(m, s_self)
        alpha = torch.exp(m - m_star)
        beta = torch.exp(s_self - m_star)
        out = (alpha[..., None] * acc + beta[..., None] * v_sel) / (alpha * l + beta)[..., None]
        attn = out.to(cfg.dtype).reshape(b, 1, cfg.num_heads * cfg.head_dim)
    elif first_chunk:
        valid_len = valid.sum(dim=1, dtype=torch.int32)
        out = ops.flash_prefill_attention(
            q.contiguous(), k.contiguous(), v.contiguous(), valid_len, scale_dim=cfg.head_dim
        )
        attn = out.reshape(b, t, cfg.num_heads * cfg.head_dim).to(q.dtype)
    else:
        # a chunk with history: the pages hold positions < the chunk's
        # start; padding rows (first token invalid) have neither history
        # nor current tokens, and a row starting at 0 has no history
        hist_lens = torch.where(valid[:, 0], positions[:, 0], 0).to(torch.int32)
        cur_lens = valid.sum(dim=1, dtype=torch.int32)
        out = ops.paged_prefill_attention(
            q.contiguous(), k.contiguous(), v.contiguous(), kv.k, kv.v, layer,
            page_tables, hist_lens, cur_lens, scale_dim=cfg.head_dim,
            k_scale=kv.k_scale, v_scale=kv.v_scale,
        )
        attn = out.reshape(b, t, cfg.num_heads * cfg.head_dim).to(q.dtype)
    return attn, (k, v)


def forward_hidden(params: dict, cfg: LlamaConfig, tokens, positions, valid, kv: KVPages,
                   page_tables, first_chunk: bool = False, ops: Ops = KERNELS,
                   write_run: Optional[int] = None):
    """One model step over a token chunk; returns (hidden [B, T, H] after
    the final norm, kv). T=1 is a decode step. T>1 is a prefill chunk whose
    row b covers positions[b, 0] onwards: with first_chunk=True every row
    starts at position 0 and attends over the chunk alone; otherwise each
    row attends over its history (positions[b, 0] tokens already in its
    pages, 0 for a row that starts at 0 or is padding) and the chunk. The
    step's K/V land in the pools in place, in runs of `write_run` slots
    (paged_write's `run`: min(T, S) when None, for chunks that start on a
    page; 1 for a chunk that may start mid-page, a speculative verify
    window). `ops` selects the kernels (default) or the plain versions;
    the engine never passes it."""
    b, t = tokens.shape
    lp = params["layers"]
    h = params["embed"][tokens].to(cfg.dtype)  # [B, T, H]
    if cfg.scale_embeddings:  # Gemma: the normalizer rounds to the model dtype first
        h = h * torch.tensor(math.sqrt(cfg.hidden_size), dtype=cfg.dtype)
    off, act = cfg.rms_norm_unit_offset, _ACTIVATIONS[cfg.hidden_act]
    cos, sin = rope_tables(positions, cfg)
    stage_shape = (cfg.num_layers, b, t, cfg.num_kv_heads, cfg.head_dim)
    # the model dtype, also over a quantized pool: the write quantizes
    k_stage = torch.empty(stage_shape, dtype=cfg.dtype, device=h.device)
    v_stage = torch.empty(stage_shape, dtype=cfg.dtype, device=h.device)
    for li in range(cfg.num_layers):
        x = rms_norm(h, lp["attn_norm"][li], cfg.rms_norm_eps, off)
        q, k, v = (_mm(x, lp, name, li, ops) for name in ("wq", "wk", "wv"))
        if cfg.attention_bias:  # Qwen2: in the model dtype, before the split
            q, k, v = q + lp["bq"][li], k + lp["bk"][li], v + lp["bv"][li]
        q = q.reshape(b, t, cfg.num_heads, cfg.head_dim)
        k = k.reshape(b, t, cfg.num_kv_heads, cfg.head_dim)
        v = v.reshape(b, t, cfg.num_kv_heads, cfg.head_dim)
        if cfg.qk_norm:  # Qwen3: head_dim-wide RMSNorm, before rope
            q = rms_norm(q, lp["q_norm"][li], cfg.rms_norm_eps, off)
            k = rms_norm(k, lp["k_norm"][li], cfg.rms_norm_eps, off)
        attn, (k_new, v_new) = attention_block(
            q, k, v, kv, li, page_tables, positions, valid, cfg, cos, sin,
            first_chunk, ops,
        )
        k_stage[li] = k_new
        v_stage[li] = v_new
        h = h + _mm(attn, lp, "wo", li, ops)
        x = rms_norm(h, lp["mlp_norm"][li], cfg.rms_norm_eps, off)
        gate = act(_mm(x, lp, "w_gate", li, ops).float())
        up = _mm(x, lp, "w_up", li, ops).float()
        h = h + _mm((gate * up).to(cfg.dtype), lp, "w_down", li, ops)
    kv = land_staged_kv(kv, (k_stage, v_stage), page_tables, positions, valid, ops,
                        run=write_run)
    return rms_norm(h, params["final_norm"], cfg.rms_norm_eps, off), kv


def land_staged_kv(kv: KVPages, staged, page_tables, positions, valid, ops: Ops = KERNELS,
                   run: Optional[int] = None):
    """Land the layer loop's staged K/V in the pools with one write (which
    quantizes them for a quantized pool), in runs of `run` slots
    (paged_write)."""
    ops.paged_write(kv.k, kv.v, staged[0], staged[1], page_tables, positions, valid,
                    k_scale=kv.k_scale, v_scale=kv.v_scale, run=run)
    return kv


def compute_logits(params: dict, cfg: LlamaConfig, hidden: torch.Tensor) -> torch.Tensor:
    """Project hidden states [..., H] to vocab logits [..., V] in float32."""
    lm_head = params.get("lm_head")
    if lm_head is None:
        return (hidden @ params["embed"].T).float()
    return (hidden @ lm_head).float()


def forward(params, cfg, tokens, positions, valid, kv, page_tables, **kw):
    """forward_hidden + logits at every position (tests and tools; the
    engine takes logits only where it samples)."""
    h, kv = forward_hidden(params, cfg, tokens, positions, valid, kv, page_tables, **kw)
    return compute_logits(params, cfg, h), kv
