"""Weight-only int8 matrix product: (x @ w) * scale, the weight read as int8.

Counterpart of the int8 branch of dynamo_tpu/models/llama.py::_mm, which
computes (x @ w.astype(dtype)) * scale[0].astype(dtype) and leaves the
int8->bf16 convert and the scale to XLA, which streams them into the dot's
operand read. No Pallas kernel is involved there. In PyTorch the same line
writes a bf16 copy of every weight and reads it back on every call, so on
CUDA tensors the hand-written kernel in csrc/int8_matmul.cu runs: it loads
the int8 weight, widens it in registers, multiplies with f32 accumulation
and applies the f32 scale before it rounds to bf16 once. On CPU tensors
the plain version below, the reference's `_mm` step by step, does the work.

x [M, K] (bf16 on CUDA), w [K, N] int8 ([in, out]), scale [1, N] f32 ->
[M, N] in x's dtype. The kernel serves K a multiple of BK (64) and N of
BN (128), its tiles; any other shape, a non-bf16 CUDA `x`, or tensors on
two devices raise. Nothing falls back.
"""

from __future__ import annotations

import math

import torch

from dynamo_tpu_torch.ops import _build
from dynamo_tpu_torch.ops._counts import KernelCounts, on_cuda, require

counts = KernelCounts()

_NAME = "int8_matmul"
#: ctypes argument types of dyn_int8_matmul (csrc/int8_matmul.cu)
ARGTYPES = [_build.PTR] * 5 + [_build.INT] * 6 + [_build.PTR]
#: device index -> SM count
_sm_count: dict[int, int] = {}
#: the kernel's tiles, as csrc/int8_matmul.cu defines them
BN = 128
BK = 64


def int8_matmul_plain(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the reference's `_mm` for an int8 weight,
    (x @ w.astype(dtype)) * scale[0].astype(dtype), in x's dtype."""
    counts.plain_calls += 1
    return (x @ w.to(x.dtype)) * scale[0].to(x.dtype)


#: most bytes of f32 partials a call cut over K writes (and the reduce
#: reads back): they stay in the card's 50 MB L2
PARTIAL_BYTES = 16 << 20


def split_plan(m: int, k: int, n: int, num_sms: int) -> tuple[int, int, int]:
    """(mi, splits, k slices per split) of one call. CTA tiles are 16 rows
    (mi 1) up to M = 16 and 64 rows (mi 4) above, by 128 columns, so each
    weight slice is widened once for every 64 rows. K is cut into splits
    while the grid is short of two CTAs a SM, so long as the f32 partials
    stay within PARTIAL_BYTES and each split keeps 2 slices of K."""
    mi = 1 if m <= 16 else 4
    grid = math.ceil(m / (16 * mi)) * (n // BN)
    slices = k // BK
    splits = max(1, min(math.ceil(2 * num_sms / grid), PARTIAL_BYTES // (4 * m * n),
                        slices // 2))
    per = math.ceil(slices / splits)
    return mi, math.ceil(slices / per), per


def int8_matmul(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(x @ w) * scale with w int8 [K, N] and scale [1, N] f32; see the
    module docstring for the contract."""
    if not on_cuda(_NAME, x, w, scale):
        return int8_matmul_plain(x, w, scale)
    require(x.dtype == torch.bfloat16, _NAME, f"the CUDA kernel takes bfloat16 x, not {x.dtype}")
    require(w.dtype == torch.int8, _NAME, f"w must be int8, not {w.dtype}")
    require(scale.dtype == torch.float32, _NAME, f"scale must be float32, not {scale.dtype}")
    require(x.dim() == 2 and w.dim() == 2 and x.shape[1] == w.shape[0] and x.shape[0] > 0,
            _NAME, f"x {tuple(x.shape)} and w {tuple(w.shape)} are not [M, K] and [K, N]")
    m, k = x.shape
    n = w.shape[1]
    require(tuple(scale.shape) == (1, n), _NAME, f"scale must be [1, {n}], not "
            f"{tuple(scale.shape)}")
    require(n % BN == 0 and k % BK == 0, _NAME,
            f"the kernel serves N a multiple of {BN} and K of {BK}, not N={n}, K={k}")
    for t in (x, w, scale):
        require(t.is_contiguous() and t.data_ptr() % 16 == 0, _NAME,
                "x, w and scale must be contiguous and 16-byte aligned")
    dev = x.device
    if dev.index not in _sm_count:
        _sm_count[dev.index] = torch.cuda.get_device_properties(dev).multi_processor_count
    mi, splits, per = split_plan(m, k, n, _sm_count[dev.index])
    out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    partials = (torch.empty((splits, m, n), dtype=torch.float32, device=dev)
                if splits > 1 else None)
    fn = _build.function("int8_matmul", "dyn_int8_matmul", ARGTYPES)
    err = fn(x.data_ptr(), w.data_ptr(), scale.data_ptr(), out.data_ptr(),
             None if partials is None else partials.data_ptr(), m, k, n, mi, splits, per,
             _build.stream(dev))
    _build.check(err, _NAME)
    counts.launches += 1
    return out


def bytes_moved(m: int, k: int, n: int) -> int:
    """Least bytes the product must move: the int8 weight, x and the bf16
    output once each, and the f32 scale."""
    return k * n + 2 * m * k + 2 * m * n + 4 * n


def flops(m: int, k: int, n: int) -> int:
    return 2 * m * k * n
