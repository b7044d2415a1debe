"""Decode attention (T=1) over the paged KV history.

Counterpart of dynamo_tpu/ops/paged_attention.py::paged_decode_attention.
q [B, Hq, D] (post-rope, unscaled), pools [L, P, S, Hkv, D], the pools'
`layer`, page_tables [B, MP] int32, history_lens [B] int32 (tokens already
in the pages). Returns the UNNORMALIZED acc [B, Hq, D] f32 and the running
max m and denominator l [B, Hq] f32 over the history only; the caller
folds in the current token (models/llama.py). Zero history gives acc=0,
m=-inf, l=0. A quantized pool (int8 or fp8 rows) comes with its
`k_scale`/`v_scale` planes [L, P, S, Hkv] f32, and the history reads
dequantized.

On CUDA tensors the split-KV kernel in csrc/paged_attention.cu runs, one
launch per call (bf16 q, bf16 or quantized pools, D of 64, 96, 128 or
256, any group size); on CPU tensors the plain version below does the
same work.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from dynamo_tpu_torch.ops import _build
from dynamo_tpu_torch.ops._counts import on_cuda, require, require_head_dim
from dynamo_tpu_torch.ops.kv_quant import gather_history, kind, pool_mode, variants

#: pool mode (None, "int8", "fp8") -> counts
counts = variants()

_NAME = "paged_decode_attention"
#: waves of resident CTAs the split plan fills at large batch
WAVES = 4

#: dyn_paged_decode's arguments: q, the pools, the scale planes, the page
#: tables, the history lengths, partials and their length, counters and
#: their length, acc, m, l; the pool kind and ten sizes; the scale, the stream
DECODE_ARGTYPES = ([_build.PTR] * 8 + [_build.LONG, _build.PTR, _build.LONG]
                   + [_build.PTR] * 3 + [_build.INT] * 11 + [_build.FLOAT, _build.PTR])

_sm_count: dict[int, int] = {}
#: (device index, D, pool mode) -> the kernel's resident CTAs per SM
_occupancy: dict[tuple, int] = {}
#: (Hq, Hkv, D) -> the kernel's (groups, max splits, split floats)
_layout: dict[tuple, tuple[int, int, int]] = {}
#: (device index, stream) -> (ticket counters int32, all 0 between calls;
#: partials f32)
_workspace: dict[tuple, tuple[torch.Tensor, torch.Tensor]] = {}


def decode_split_plan(batch: int, num_kv_heads: int, max_pages: int, num_sms: int,
                      ctas_per_sm: int, max_splits: int):
    """(splits, pages_per_split) for the kernel's grid of (splits,
    num_kv_heads, batch) CTAs; the wrapper passes the kernel's groups (kv
    heads times the row tiles of a group) as `num_kv_heads`, and its
    `max_splits`.

    The TPU kernel walks a flattened (sequence, page) work list in one
    grid step (decode_work_list); on the card the grid is parallel, and
    (sequence, kv head) pairs alone leave most SMs idle at small batch.
    So each pair's page table is cut into splits of contiguous pages: as
    many as fill WAVES whole waves of the kernel's resident CTAs
    (num_sms * ctas_per_sm), at most one per page and at most max_splits.
    A large batch gets few splits, a batch of one a split per page, which
    covers every SM once the history has that many pages. Splits past a
    sequence's history exit at once; the last split of a pair to finish
    merges them."""
    pairs = max(1, batch * num_kv_heads)
    want = WAVES * max(1, num_sms * ctas_per_sm) // pairs
    splits = max(1, min(max_pages, max_splits, want))
    per = -(-max_pages // splits)
    return -(-max_pages // per), per


def ctas_per_sm(device: torch.device, d: int, mode) -> int:
    """The kernel's resident CTAs per SM on `device` for head dim `d` and
    the pool mode (cudaOccupancyMaxActiveBlocksPerMultiprocessor), cached."""
    key = (device.index, d, mode)
    if key not in _occupancy:
        fn = _build.function("paged_attention", "dyn_paged_decode_occupancy",
                             [_build.INT, _build.INT, ctypes.POINTER(ctypes.c_int)])
        out = ctypes.c_int(0)
        with torch.cuda.device(device):
            _build.check(fn(kind(mode), d, ctypes.byref(out)), _NAME)
        if out.value < 1:
            raise RuntimeError(f"{_NAME}: the kernel fits no CTA on an SM (D={d}, {mode})")
        _occupancy[key] = out.value
    return _occupancy[key]


def layout(hq: int, hkv: int, d: int) -> tuple[int, int, int]:
    """The kernel's workspace layout, from csrc/paged_attention.cu, which
    alone defines it (dyn_paged_decode_layout): its CTAs per (sequence,
    split) `groups`, the most splits a call may cut, and the f32 words of
    partial state per (sequence, group, split). Cached."""
    key = (hq, hkv, d)
    if key not in _layout:
        fn = _build.function("paged_attention", "dyn_paged_decode_layout",
                             [_build.INT] * 3 + [ctypes.POINTER(ctypes.c_int)] * 3)
        out = [ctypes.c_int(0) for _ in range(3)]
        _build.check(fn(hq, hkv, d, *map(ctypes.byref, out)), _NAME)
        _layout[key] = tuple(x.value for x in out)
    return _layout[key]


def launch_plan(device: torch.device, batch: int, hq: int, hkv: int, d: int,
                max_pages: int, mode) -> tuple[int, int, int, int]:
    """(splits, pages_per_split, groups, partial floats) of one call."""
    groups, max_splits, split_floats = layout(hq, hkv, d)
    if device.index not in _sm_count:
        _sm_count[device.index] = torch.cuda.get_device_properties(device).multi_processor_count
    splits, per = decode_split_plan(batch, groups, max_pages, _sm_count[device.index],
                                    ctas_per_sm(device, d, mode), max_splits)
    partials = batch * groups * splits * split_floats if splits > 1 else 0
    return splits, per, groups, partials


def workspace(device: torch.device, counters: int, partials: int):
    """The ticket counters (int32, zeroed once; the kernel leaves them 0)
    and partial-state buffer (f32) of the device's current stream, grown on
    demand outside a CUDA graph capture. Each stream has its own, so calls
    on two streams never share a counter; calls on one stream run in
    order. Growth replaces the stream's entry and frees the old tensors,
    and a stream's handle may be handed out again (PyTorch pools them), so
    a CUDA graph captured over a workspace must hold the tensors it got
    here for as long as it may replay."""
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    cnt, part = _workspace.get(key, (None, None))
    grow = cnt is None or cnt.numel() < counters or part is None or part.numel() < partials
    if grow and torch.cuda.is_current_stream_capturing():
        # memory allocated here would come from the graph's pool, and the
        # entry it replaces would be freed under graphs captured before
        raise RuntimeError(f"{_NAME}: a workspace must be sized before its stream captures")
    if cnt is None or cnt.numel() < counters:
        cnt = torch.zeros(max(counters, 1), dtype=torch.int32, device=device)
    if part is None or part.numel() < partials:
        part = torch.empty(max(partials, 1), dtype=torch.float32, device=device)
    _workspace[key] = (cnt, part)
    return cnt, part


def _check_shapes(q, k_cache, v_cache, layer, page_tables, history_lens):
    require(q.dim() == 3, _NAME, "q must be [B, Hq, D]")
    require(k_cache.dim() == 5 and v_cache.shape == k_cache.shape,
            _NAME, "pools must be [L, P, S, Hkv, D] and equal in shape")
    b, hq, d = q.shape
    require(k_cache.shape[4] == d and hq % k_cache.shape[3] == 0,
            _NAME, "q does not fit the pools' heads")
    require(0 <= int(layer) < k_cache.shape[0], _NAME, f"layer {int(layer)} out of range")
    require(page_tables.dim() == 2 and page_tables.shape[0] == b, _NAME, "page_tables must be [B, MP]")
    require(history_lens.shape == (b,), _NAME, "history_lens must be [B]")


def paged_decode_attention_plain(q, k_cache, v_cache, layer, page_tables, history_lens,
                                 *, scale_dim: Optional[int] = None, k_scale=None,
                                 v_scale=None):
    """Plain PyTorch version of `paged_decode_attention` (same contract):
    gathers (and dequantizes) the history densely, computed in float32."""
    counts[pool_mode(_NAME, k_cache, v_cache, k_scale, v_scale)].plain_calls += 1
    _check_shapes(q, k_cache, v_cache, layer, page_tables, history_lens)
    b, hq, d = q.shape
    s, hkv = k_cache.shape[2], k_cache.shape[3]
    g = hq // hkv
    mp = page_tables.shape[1]
    live = torch.arange(mp * s, device=q.device)[None, :] < history_lens[:, None].long()
    k = gather_history(k_cache, k_scale, layer, page_tables, live)
    v = gather_history(v_cache, v_scale, layer, page_tables, live)
    qf = q.float().reshape(b, hkv, g, d) * (1.0 / math.sqrt(scale_dim or d))
    scores = torch.einsum("bkgd,bskd->bkgs", qf, k)
    scores = scores.masked_fill(~live[:, None, None, :], float("-inf"))
    m = scores.amax(dim=-1)  # -inf where there is no history
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(scores - m_safe[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgs,bskd->bkgd", p, v)
    return acc.reshape(b, hq, d), m.reshape(b, hq), l.reshape(b, hq)


def paged_decode_attention(q, k_cache, v_cache, layer, page_tables, history_lens,
                           *, scale_dim: Optional[int] = None, k_scale=None, v_scale=None):
    """History-only flash decode attention; see the module docstring."""
    scales = tuple(x for x in (k_scale, v_scale) if x is not None)
    tensors = (q, k_cache, v_cache, page_tables, history_lens) + scales
    if not on_cuda(_NAME, *tensors):
        return paged_decode_attention_plain(
            q, k_cache, v_cache, layer, page_tables, history_lens, scale_dim=scale_dim,
            k_scale=k_scale, v_scale=v_scale,
        )
    mode = pool_mode(_NAME, k_cache, v_cache, k_scale, v_scale)
    _check_shapes(q, k_cache, v_cache, layer, page_tables, history_lens)
    b, hq, d = q.shape
    L, p, s, hkv, _ = k_cache.shape
    mp = page_tables.shape[1]
    require(q.dtype == torch.bfloat16 and (mode is not None or k_cache.dtype == q.dtype),
            _NAME, "the CUDA kernel takes bfloat16 q and bfloat16, int8 or fp8 pools")
    require(page_tables.dtype == torch.int32 and history_lens.dtype == torch.int32,
            _NAME, "page_tables and history_lens must be int32")
    require_head_dim(d, _NAME)
    require(all(x.is_contiguous() for x in tensors), _NAME, "all tensors must be contiguous")
    dev = q.device
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    splits, per, groups, n_partials = launch_plan(dev, b, hq, hkv, d, mp, mode)
    counters, partials = workspace(dev, b * groups, n_partials)
    f32 = dict(dtype=torch.float32, device=dev)
    acc = torch.empty((b, hq, d), **f32)
    m = torch.empty((b, hq), **f32)
    l = torch.empty((b, hq), **f32)
    fn = _build.function("paged_attention", "dyn_paged_decode", DECODE_ARGTYPES)
    err = fn(
        _build.ptr(q), _build.ptr(k_cache), _build.ptr(v_cache),
        _build.ptr(k_scale), _build.ptr(v_scale),
        _build.ptr(page_tables), _build.ptr(history_lens),
        _build.ptr(partials), partials.numel(), _build.ptr(counters), counters.numel(),
        _build.ptr(acc), _build.ptr(m), _build.ptr(l),
        kind(mode), b, hq, hkv, d, int(layer), p, s, mp, splits, per,
        1.0 / math.sqrt(scale_dim or d), _build.stream(dev),
    )
    _build.check(err, _NAME)
    counts[mode].launches += 1
    return acc, m, l


def bytes_moved(history_lens, hq: int, hkv: int, d: int, itemsize: int,
                kv_quantize=None) -> int:
    """Least bytes one call must move: each history row of K and V read
    once (a quantized row: d narrow bytes and its f32 scale), q read once,
    acc/m/l written once."""
    hist = int(torch.as_tensor(history_lens).long().sum())
    b = int(torch.as_tensor(history_lens).numel())
    row = d * itemsize if kv_quantize is None else d + 4
    return 2 * hist * hkv * row + b * hq * d * itemsize + b * hq * (d + 2) * 4
