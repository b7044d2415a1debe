"""Device choice and the card's published peaks.

Every entry point of the port runs on `cuda` unless its caller asks for
`cpu`. No card and no CPU request is an error, never a silent CPU run.
"""

from __future__ import annotations

import subprocess
from dataclasses import dataclass
from typing import Optional, Union

import torch


@dataclass(frozen=True)
class DevicePeaks:
    """Published dense peaks of one card (vendor data sheet)."""

    name: str
    bf16_flops: float  # tensor-core bf16/fp16, FLOP/s
    hbm_bytes_per_s: float
    hbm_bytes: float


#: NVIDIA H100 SXM data sheet, dense rates without sparsity, at the full
#: 700 W power limit.
H100 = DevicePeaks(
    name="NVIDIA H100",
    bf16_flops=989e12,
    hbm_bytes_per_s=3.35e12,
    hbm_bytes=80e9,
)


def resolve_device(device: Union[str, torch.device, None] = None) -> torch.device:
    """`cuda` unless the caller asks for `cpu`; raises when no card is
    found and the CPU was not asked for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r}; use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device found; dynamo_tpu_torch runs on an NVIDIA GPU "
            "unless device='cpu' (CLI: --device cpu) is asked for"
        )
    return dev


def device_peaks(name: Optional[str] = None) -> DevicePeaks:
    """Peaks for the named card (default: cuda:0). Only the H100 is in
    the table; any other card raises rather than borrow its numbers."""
    if name is None:
        name = torch.cuda.get_device_name(0)
    if name.startswith(H100.name):
        return H100
    raise KeyError(f"no peak table for {name!r} (only {H100.name} is known)")


def card_info() -> str:
    """The card's name and power limit as nvidia-smi reports them, e.g.
    'NVIDIA H100 80GB HBM3, 700.00 W'. Raises when nvidia-smi is absent
    or fails."""
    try:
        out = subprocess.run(
            [
                "nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader",
            ],
            capture_output=True, text=True, timeout=30, check=True,
        )
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"nvidia-smi failed: {e}") from e
    return out.stdout.strip().splitlines()[0]
