"""Engine configuration.

Counterpart of dynamo_tpu/engine/config.py. EngineConfig takes the JAX
package's knob names. The knobs this package honours are its fields, with
the JAX package's defaults (prefix caching, overlapped decode and mixed
steps on).
Every other knob of the JAX config (UNPORTED) is accepted only at a value
that leaves its feature off; any other value raises NotImplementedError
with the knob's name.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

#: knobs of the JAX engine's config this package does not port yet -> the
#: values that leave their feature off (tuning knobs of an unported
#: feature: the JAX default). "pallas" is the attention this package runs.
UNPORTED = {
    "max_waiting": (None,),
    "attention_impl": ("auto", "pallas"),
    "dp": (1,),
    "tp": (1,),
    "sp": (1,),
    "ep": (1,),
    "topology": ("",),
    "force_multihost": (False,),
    "fleet_telemetry": (False,),
    "flight_recorder": (False,),
    "flight_ring": (512,),
    "stall_watchdog": (False,),
    "stall_factor": (32.0,),
    "stall_min_s": (5.0,),
    "stall_queue_wait_s": (120.0,),
    "stall_hard_deadline_s": (None,),
    "host_kv_cache_bytes": (0,),
    "disk_kv_cache_bytes": (0,),
    "disk_kv_cache_dir": (None,),
}


@dataclass(frozen=True)
class _PortedKnobs:
    """The knobs this package honours (EngineConfig adds the refusals)."""

    model: str = "llama3-8b"
    #: KV pages on the device (page 0 reserved as the null page)
    num_pages: int = 2048
    #: tokens per page
    page_size: int = 64
    #: max pages a single sequence may hold (=> max context length)
    max_pages_per_seq: int = 64
    #: decode batch buckets (padded up to the next bucket)
    decode_buckets: tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64)
    #: most tokens of one prompt prefilled per step; a longer prompt runs
    #: as page-aligned chunks of at most this many tokens
    prefill_chunk: int = 512
    #: total prefill tokens per step across sequences (None => 4 x chunk)
    prefill_token_budget: Optional[int] = None
    #: "fixed" keeps the step budget at effective_prefill_budget;
    #: "adaptive" grows it toward the un-prefilled backlog, up to
    #: effective_prefill_budget_max, so a burst drains in fewer steps
    prefill_budget_policy: str = "fixed"
    #: the adaptive policy's ceiling (None => 4 x the effective budget)
    prefill_budget_max: Optional[int] = None
    #: max sequences resident (decode slots)
    max_seqs: int = 64
    #: decode steps fused per host sync: tokens feed back on the device
    #: and up to K-1 tokens past a stop are computed and dropped
    decode_steps: int = 8
    #: K-step decode windows: K decode iterations in one step function
    #: whose finish conditions (stop ids, max_tokens and context budgets)
    #: are judged on the device, so a finished row freezes mid-window and
    #: no token is computed past its stop; the host reads [K, B] ids and
    #: each row's emitted count once a window. Composes with the
    #: overlapped loop (the next window chains on speculation) and mixed
    #: steps (the window is the decode leg beside a prefill dispatch).
    #: Rows asking for logprobs, or with more than STOP_SLOTS stop ids,
    #: take the fused-steps path. 1 (default) = off; K may exceed
    #: decode_steps
    decode_kstep: int = 1
    #: overlapped decode: dispatch the next decode step on speculation
    #: (tokens fed back on the device) before the pending step's ids reach
    #: the host, and roll it back when the batch changes
    overlap_decode: bool = True
    #: content-addressed prefix caching: full pages are registered under
    #: their chained block hash and a new prompt reuses the longest cached
    #: prefix (at most all but its last page), with KV events for each
    #: page stored and evicted
    enable_prefix_caching: bool = True
    #: speculative decoding by prompt lookup: S draft tokens per decode
    #: step, the S that followed the last earlier occurrence of a row's
    #: trailing n-gram, verified in one forward over [last token, drafts]
    #: (one captured graph per decode bucket); the longest matching prefix
    #: lands, plus the model's token at the first mismatch. Greedy batches
    #: only: a row that samples, asks for logprobs or carries a penalty,
    #: logit_bias or min_tokens runs the batch's plain decode. Turns the
    #: overlapped loop, mixed steps and K-step windows off. 0 (default) = off
    spec_ngram: int = 0
    #: the n-gram length prompt lookup matches on
    spec_ngram_match: int = 2
    #: below this accepted/drafted share in a verify step, speculation
    #: backs off for spec_cooldown_steps decode dispatches (plain decode)
    spec_min_accept_rate: float = 0.2
    spec_cooldown_steps: int = 16
    #: speculative decoding with a draft model: a small model of the
    #: target's vocabulary (a preset name, e.g. "llama3-draft"; the target's
    #: own name shares its weights) proposes spec_draft_tokens greedy
    #: drafts a row, and one captured step function a dispatch runs the
    #: draft's catch-up, its proposals, the target's verify and the
    #: acceptance on the device: greedy rows accept exactly the plain
    #: stream, sampled rows by rejection sampling, which keeps the
    #: sampler's distribution. Penalties, logit_bias and min_tokens are
    #: served; a batch with a logprob row runs the plain decode. The
    #: overlapped loop chains the next dispatch off the pending one's
    #: device outputs, and beside prefill work the dispatch is the decode
    #: leg of a split mixed step; K-step windows are off under it. The
    #: draft keeps a KV pool of its own (model dtype) addressed by the
    #: target's page ids. Excludes spec_ngram. None (default) = off
    spec_draft_model: Optional[str] = None
    #: drafts proposed and verified per dispatch (the verify is S + 1 wide)
    spec_draft_tokens: int = 4
    #: where the draft's weights live (an HF checkpoint directory or a
    #: .gguf file) when its name is a preset; None: the draft name's own
    #: checkpoint if it names one, else the target's tree for a self-draft,
    #: else random weights
    spec_draft_checkpoint: Optional[str] = None
    #: mixed prefill+decode steps: while prefill work and running decodes
    #: coexist, the scheduler emits one `mixed` step carrying a bounded
    #: prefill chunk plus the decode batch, and the engine dispatches both
    #: as one step function, so decode rows emit a token every step while
    #: a prompt burst drains. Greedy streams equal the XOR (prefill first)
    #: policy's
    mixed_steps: bool = True
    #: admission watermark: keep this fraction of pages free when admitting
    admission_watermark: float = 0.02
    #: eos token ids (from the model card/tokenizer)
    eos_token_ids: tuple[int, ...] = ()
    #: dtype name for params/KV ("bfloat16" | "float32")
    dtype: str = "bfloat16"
    #: weight-only quantization: None | "int8" (per-output-channel scales):
    #: the seven dense weights of every layer are int8, about halving the
    #: weight bytes a decode step reads
    quantize: Optional[str] = None
    #: KV-cache page quantization: None | "int8" | "fp8". Pages store the
    #: narrow dtype with per-(page, slot, kv-head) f32 scale planes, about
    #: halving the bytes per cached token; the page write quantizes and
    #: the attention kernels dequantize the history
    kv_quantize: Optional[str] = None
    #: random seed for request seeds (sampling)
    seed: int = 0

    def __post_init__(self):
        if self.prefill_chunk % self.page_size != 0:
            raise ValueError(
                f"prefill_chunk ({self.prefill_chunk}) must be a multiple of "
                f"page_size ({self.page_size})"
            )
        if self.prefill_token_budget is not None and (
            self.prefill_token_budget < self.page_size
        ):
            raise ValueError(
                f"prefill_token_budget ({self.prefill_token_budget}) must be "
                f">= page_size ({self.page_size}): mid-prompt chunks round "
                "down to page boundaries, so a smaller budget could never "
                "schedule any prefill work"
            )
        if self.prefill_budget_policy not in ("fixed", "adaptive"):
            raise ValueError(
                "prefill_budget_policy must be 'fixed' or 'adaptive', got "
                f"{self.prefill_budget_policy!r}"
            )
        if (self.prefill_budget_max is not None
                and self.prefill_budget_max < self.effective_prefill_budget):
            raise ValueError(
                f"prefill_budget_max ({self.prefill_budget_max}) must be >= "
                f"the effective budget ({self.effective_prefill_budget}): "
                "the adaptive policy only ever grows the step budget"
            )
        if self.dtype not in ("bfloat16", "float32"):
            raise ValueError(f"dtype must be 'bfloat16' or 'float32', got {self.dtype!r}")
        if self.quantize not in (None, "int8"):
            raise ValueError(f"unsupported quantize={self.quantize!r}; use int8")
        if self.kv_quantize not in (None, "int8", "fp8"):
            raise ValueError(
                f"kv_quantize must be None, 'int8' or 'fp8', got {self.kv_quantize!r}"
            )
        if self.spec_draft_model is not None and self.spec_ngram > 0:
            raise ValueError(
                "spec_draft_model and spec_ngram are mutually exclusive speculation "
                "modes; configure one of them"
            )
        if self.spec_draft_model is not None and self.spec_draft_tokens < 1:
            raise ValueError(f"spec_draft_tokens must be >= 1, got {self.spec_draft_tokens}")

    @property
    def max_context(self) -> int:
        return self.max_pages_per_seq * self.page_size

    @property
    def effective_prefill_budget(self) -> int:
        return self.prefill_token_budget or 4 * self.prefill_chunk

    @property
    def effective_prefill_budget_max(self) -> int:
        """The adaptive policy's ceiling."""
        return self.prefill_budget_max or 4 * self.effective_prefill_budget

    def decode_bucket_for(self, n: int) -> int:
        for b in self.decode_buckets:
            if n <= b:
                return b
        return self.decode_buckets[-1]


class EngineConfig(_PortedKnobs):
    """Static configuration of one engine worker (keyword arguments, the
    JAX package's knob names)."""

    def __init__(self, **knobs):
        for name in sorted(knobs.keys() & UNPORTED.keys()):
            value = knobs.pop(name)
            if value not in UNPORTED[name]:
                raise NotImplementedError(
                    f"EngineConfig.{name}={value!r} is not ported to "
                    f"dynamo_tpu_torch yet (only {UNPORTED[name]!r})"
                )
        super().__init__(**knobs)

    @staticmethod
    def for_tests(**overrides) -> "EngineConfig":
        defaults = dict(
            model="tiny",
            num_pages=64,
            page_size=4,
            max_pages_per_seq=8,
            decode_buckets=(1, 2, 4, 8),
            prefill_chunk=16,
            max_seqs=8,
            dtype="float32",
        )
        defaults.update(overrides)
        return EngineConfig(**defaults)
