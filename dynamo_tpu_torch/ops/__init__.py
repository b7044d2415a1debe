"""The four kernels of the serving path, each beside its plain version.

Every wrapper launches its hand-written CUDA kernel for CUDA tensors (or
raises) and calls its plain PyTorch version for CPU tensors. Launches and
plain calls are counted separately, so a run can show which one it used.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

from dynamo_tpu_torch.ops import flash_prefill, kv_update, paged_attention
from dynamo_tpu_torch.ops._counts import KernelCounts


class Ops(NamedTuple):
    """The functions the model's forward calls for its four kernels."""

    paged_write: Callable
    flash_prefill_attention: Callable
    paged_decode_attention: Callable
    paged_prefill_attention: Callable


#: the serving path: kernels on CUDA tensors, plain versions on CPU tensors
KERNELS = Ops(
    kv_update.paged_write,
    flash_prefill.flash_prefill_attention,
    paged_attention.paged_decode_attention,
    flash_prefill.paged_prefill_attention,
)
#: the plain PyTorch versions on any device (reference runs only)
PLAIN = Ops(
    kv_update.paged_write_plain,
    flash_prefill.flash_prefill_attention_plain,
    paged_attention.paged_decode_attention_plain,
    flash_prefill.paged_prefill_attention_plain,
)

#: kernel name -> its counts
COUNTS: dict[str, KernelCounts] = {
    "paged_write": kv_update.counts,
    "flash_prefill_attention": flash_prefill.counts,
    "paged_decode_attention": paged_attention.counts,
    "paged_prefill_attention": flash_prefill.paged_counts,
}


def reset_counts() -> None:
    for c in COUNTS.values():
        c.launches = 0
        c.plain_calls = 0


__all__ = ["COUNTS", "KERNELS", "KernelCounts", "Ops", "PLAIN", "reset_counts"]
