"""The five kernels of the serving path, each beside its plain version.

Every wrapper launches its hand-written CUDA kernel for CUDA tensors (or
raises) and calls its plain PyTorch version for CPU tensors. Launches and
plain calls are counted separately, so a run can show which one it used,
and so is each pool mode of the three kernels that read or write the
pools: `paged_write` (a model-dtype pool), `paged_write.int8` and
`paged_write.fp8` (quantized pools, ops/kv_quant.py). Four replace the
reference's Pallas kernels; `int8_matmul` is the dense product of int8
weights (`--quantize int8`), which the reference leaves to XLA.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

from dynamo_tpu_torch.ops import flash_prefill, int8_matmul, kv_update, paged_attention
from dynamo_tpu_torch.ops._counts import KernelCounts
from dynamo_tpu_torch.ops.kv_quant import POOL_MODES, variant


class Ops(NamedTuple):
    """The functions the model's forward calls for its five kernels.
    `paged_write`, `paged_decode_attention` and `paged_prefill_attention`
    take `k_scale=None, v_scale=None`: the scale planes of a quantized
    pool. `int8_matmul` is the dense product of an int8 weight."""

    paged_write: Callable
    flash_prefill_attention: Callable
    paged_decode_attention: Callable
    paged_prefill_attention: Callable
    int8_matmul: Callable


#: the serving path: kernels on CUDA tensors, plain versions on CPU tensors
KERNELS = Ops(
    kv_update.paged_write,
    flash_prefill.flash_prefill_attention,
    paged_attention.paged_decode_attention,
    flash_prefill.paged_prefill_attention,
    int8_matmul.int8_matmul,
)
#: the plain PyTorch versions on any device (reference runs only)
PLAIN = Ops(
    kv_update.paged_write_plain,
    flash_prefill.flash_prefill_attention_plain,
    paged_attention.paged_decode_attention_plain,
    flash_prefill.paged_prefill_attention_plain,
    int8_matmul.int8_matmul_plain,
)

#: kernel variant name (`paged_write`, `paged_write.int8`, ...) -> its counts
COUNTS: dict[str, KernelCounts] = {
    "flash_prefill_attention": flash_prefill.counts,
    "int8_matmul": int8_matmul.counts,
    **{
        variant(name, mode): per_mode[mode]
        for name, per_mode in (
            ("paged_write", kv_update.counts),
            ("paged_decode_attention", paged_attention.counts),
            ("paged_prefill_attention", flash_prefill.paged_counts),
        )
        for mode in POOL_MODES
    },
}


def reset_counts() -> None:
    for c in COUNTS.values():
        c.launches = 0
        c.plain_calls = 0


__all__ = ["COUNTS", "KERNELS", "KernelCounts", "Ops", "PLAIN", "reset_counts"]
