"""Per-kernel call counts and the device dispatch every wrapper shares."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class KernelCounts:
    #: launches of the CUDA kernel (incremented only where it launches)
    launches: int = 0
    #: calls of the plain PyTorch version, on any device
    plain_calls: int = 0


def on_cuda(kernel: str, *tensors) -> bool:
    """True when every tensor lies on one CUDA device, False when every
    one lies on the CPU; anything else raises."""
    kinds = {t.device for t in tensors}
    if len(kinds) != 1:
        raise ValueError(f"{kernel}: tensors span devices {sorted(map(str, kinds))}")
    dev = next(iter(kinds))
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"{kernel}: unsupported device {dev}")


def require(cond: bool, kernel: str, what: str) -> None:
    if not cond:
        raise ValueError(f"{kernel}: {what}")


#: the head dims every attention kernel and the quantizing write serve
HEAD_DIMS = (64, 96, 128, 256)


def require_head_dim(d: int, kernel: str) -> None:
    require(d in HEAD_DIMS, kernel, f"the CUDA kernel takes head_dim 64, 96, 128 or 256, not {d}")
