"""Causal GQA flash attention over each sequence's first prefill chunk.

Counterpart of dynamo_tpu/ops/flash_prefill.py::flash_prefill_attention.
q [B, T, Hq, D], k/v [B, T, Hkv, D] (post-rope), valid_len [B] int32 ->
[B, T, Hq, D]. Query head j reads kv head j // (Hq/Hkv). Queries scale by
1/sqrt(scale_dim). Keys at or past valid_len are masked; rows at or past
valid_len are unspecified (the kernel writes finite values there).

On CUDA tensors the kernel in csrc/flash_prefill.cu runs (bf16, D of 64
or 128); on CPU tensors the plain version below does the same work.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from dynamo_tpu_torch.ops import _build
from dynamo_tpu_torch.ops._counts import KernelCounts, on_cuda, require

counts = KernelCounts()

_NAME = "flash_prefill_attention"
#: query rows per CTA in the kernel: tokens x the g heads of one kv group
TILE_ROWS = 64


def _check_shapes(q, k, v, valid_len):
    require(q.dim() == 4 and k.dim() == 4 and v.shape == k.shape,
            _NAME, "q must be [B, T, Hq, D], k/v [B, T, Hkv, D]")
    b, t, hq, d = q.shape
    require(k.shape[:2] == (b, t) and k.shape[3] == d, _NAME, "q and k/v disagree on B, T or D")
    require(hq % k.shape[2] == 0, _NAME, "Hq must be a multiple of Hkv")
    require(valid_len.shape == (b,), _NAME, "valid_len must be [B]")


def flash_prefill_attention_plain(q, k, v, valid_len, *, scale_dim: Optional[int] = None):
    """Plain PyTorch version of `flash_prefill_attention` (same contract),
    computed in float32."""
    counts.plain_calls += 1
    _check_shapes(q, k, v, valid_len)
    b, t, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    scale = 1.0 / math.sqrt(scale_dim or d)
    qf = q.float().reshape(b, t, hkv, g, d) * scale
    scores = torch.einsum("btkgd,bskd->bkgts", qf, k.float())
    pos = torch.arange(t, device=q.device)
    causal = pos[None, :] <= pos[:, None]  # [T(query), T(key)]
    live = pos[None, :] < valid_len[:, None].to(pos.dtype)  # [B, T(key)]
    mask = causal[None, None, None] & live[:, None, None, None, :]
    scores = scores.masked_fill(~mask, -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgts,bskd->btkgd", probs, v.float())
    return out.reshape(b, t, hq, d).to(q.dtype)


def flash_prefill_attention(q, k, v, valid_len, *, scale_dim: Optional[int] = None):
    """Causal flash attention over one first prefill chunk; see the module
    docstring for the contract."""
    if not on_cuda(_NAME, q, k, v, valid_len):
        return flash_prefill_attention_plain(q, k, v, valid_len, scale_dim=scale_dim)
    _check_shapes(q, k, v, valid_len)
    b, t, hq, d = q.shape
    hkv = k.shape[2]
    require(q.dtype == torch.bfloat16 and k.dtype == q.dtype and v.dtype == q.dtype,
            _NAME, "the CUDA kernel takes bfloat16 q/k/v")
    require(valid_len.dtype == torch.int32, _NAME, "valid_len must be int32")
    require(d in (64, 128), _NAME, f"the CUDA kernel takes head_dim 64 or 128, not {d}")
    require(TILE_ROWS % (hq // hkv) == 0, _NAME,
            f"the query group size {hq // hkv} must divide {TILE_ROWS}")
    require(all(x.is_contiguous() for x in (q, k, v, valid_len)),
            _NAME, "all tensors must be contiguous")
    out = torch.empty_like(q)
    fn = _build.function(
        "flash_prefill", "dyn_flash_prefill",
        [_build.PTR] * 5 + [_build.INT] * 5 + [_build.FLOAT, _build.PTR],
    )
    err = fn(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(valid_len),
        _build.ptr(out), b, t, hq, hkv, d,
        1.0 / math.sqrt(scale_dim or d), _build.stream(q.device),
    )
    _build.check(err, _NAME)
    counts.launches += 1
    return out


def flops(valid_len, hq: int, d: int) -> int:
    """Least multiply-adds (x2) causal attention needs for these valid
    lengths: QK^T and PV over the lower triangle, n(n+1)/2 pairs each."""
    n = torch.as_tensor(valid_len).long()
    pairs = int((n * (n + 1) // 2).sum())
    return 4 * hq * d * pairs


def bytes_moved(valid_len, hq: int, hkv: int, d: int, itemsize: int) -> int:
    """Least bytes one call must move: each valid token's q, k and v read
    once and its output rows written once (rows at or past valid_len are
    unspecified, so the function need not write them)."""
    tokens = int(torch.as_tensor(valid_len).long().sum())
    return tokens * (2 * hq + 2 * hkv) * d * itemsize
