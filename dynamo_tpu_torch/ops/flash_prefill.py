"""Flash attention for prefill chunks: first chunks, and chunks with history.

`flash_prefill_attention` is the counterpart of
dynamo_tpu/ops/flash_prefill.py::flash_prefill_attention: causal GQA
attention over each sequence's first chunk. q [B, T, Hq, D], k/v
[B, T, Hkv, D] (post-rope), valid_len [B] int32 -> [B, T, Hq, D]. Keys at
or past valid_len are masked; rows at or past valid_len are unspecified
(the kernel writes finite values there).

`paged_prefill_attention` is the counterpart of
dynamo_tpu/ops/flash_prefill.py::paged_prefill_attention: a chunk that
has history (chunked prefill). q [B, T, Hq, D], k_cur/v_cur [B, T, Hkv, D]
(post-rope), the pools [L, P, S, Hkv, D] and their `layer`, page_tables
[B, MP] int32, hist_lens and cur_lens [B] int32 -> [B, T, Hq, D]. Row t of
sequence b attends to history keys 0 .. hist_lens[b]-1 (read through the
page table; a partial last page is masked) and causally to current keys
0 .. t below cur_lens[b], under one softmax. Rows at or past cur_lens are
unspecified but finite. A quantized pool (int8 or fp8 rows) comes with its
`k_scale`/`v_scale` planes [L, P, S, Hkv] f32: the history reads
dequantized, and the chunk's own K/V (model dtype) as they are.

In both, query head j reads kv head j // (Hq/Hkv) and queries scale by
1/sqrt(scale_dim). On CUDA tensors the kernels in csrc/flash_prefill.cu
and csrc/paged_prefill.cu run (bf16 q/k/v, bf16 or quantized pools, D of
64, 96, 128 or 256, a query group of at most 128 heads: one kv group's
heads fold into a 128-row tile); on CPU tensors the plain versions below
do the same work.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from dynamo_tpu_torch.ops import _build
from dynamo_tpu_torch.ops._counts import KernelCounts, on_cuda, require, require_head_dim
from dynamo_tpu_torch.ops.kv_quant import gather_history, kind, pool_mode, variants

#: counts of flash_prefill_attention
counts = KernelCounts()
#: counts of paged_prefill_attention: pool mode (None, "int8", "fp8") -> counts
paged_counts = variants()

_NAME = "flash_prefill_attention"
_PAGED = "paged_prefill_attention"
#: query rows per CTA in the kernel (two wgmma warpgroups of 64): whole
#: tokens x the g heads of one kv group, so g may be at most this
TILE_ROWS = 128
#: ctypes argument types of dyn_paged_prefill (csrc/paged_prefill.cu)
PAGED_ARGTYPES = [_build.PTR] * 11 + [_build.INT] * 10 + [_build.FLOAT, _build.PTR]


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
    require_head_dim(d, _NAME)
    require(hq // hkv <= TILE_ROWS, _NAME, _group_message(hq // hkv, TILE_ROWS))
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


def _group_message(g: int, rows: int) -> str:
    return (f"the CUDA kernel takes a query group of at most {rows} heads (its tile's "
            f"rows), not {g}")


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


# -- chunks with history ----------------------------------------------------------


def _check_paged_shapes(q, k_cur, v_cur, k_cache, v_cache, layer, page_tables,
                        hist_lens, cur_lens):
    require(q.dim() == 4 and k_cur.dim() == 4 and v_cur.shape == k_cur.shape,
            _PAGED, "q must be [B, T, Hq, D], k_cur/v_cur [B, T, Hkv, D]")
    require(k_cache.dim() == 5 and v_cache.shape == k_cache.shape,
            _PAGED, "pools must be [L, P, S, Hkv, D] and equal in shape")
    b, t, hq, d = q.shape
    require(k_cur.shape == (b, t, k_cache.shape[3], d) and k_cache.shape[4] == d,
            _PAGED, "q, k_cur/v_cur and the pools disagree on B, T, Hkv or D")
    require(hq % k_cur.shape[2] == 0, _PAGED, "Hq must be a multiple of Hkv")
    require(0 <= int(layer) < k_cache.shape[0], _PAGED, f"layer {int(layer)} out of range")
    require(page_tables.dim() == 2 and page_tables.shape[0] == b,
            _PAGED, "page_tables must be [B, MP]")
    require(hist_lens.shape == (b,) and cur_lens.shape == (b,),
            _PAGED, "hist_lens and cur_lens must be [B]")


def paged_prefill_attention_plain(q, k_cur, v_cur, k_cache, v_cache, layer, page_tables,
                                  hist_lens, cur_lens, *, scale_dim: Optional[int] = None,
                                  k_scale=None, v_scale=None):
    """Plain PyTorch version of `paged_prefill_attention` (same contract):
    gathers (and dequantizes) each sequence's history densely and attends
    over it and the chunk under one mask, in float32."""
    paged_counts[pool_mode(_PAGED, k_cache, v_cache, k_scale, v_scale)].plain_calls += 1
    _check_paged_shapes(q, k_cur, v_cur, k_cache, v_cache, layer, page_tables,
                        hist_lens, cur_lens)
    b, t, hq, d = q.shape
    s, hkv = k_cache.shape[2], k_cache.shape[3]
    g = hq // hkv
    n_hist = page_tables.shape[1] * s
    hpos = torch.arange(n_hist, device=q.device)
    live = hpos[None, :] < hist_lens[:, None].long()  # [B, history]
    keys = torch.cat([gather_history(k_cache, k_scale, layer, page_tables, live),
                      k_cur.float()], dim=1)
    vals = torch.cat([gather_history(v_cache, v_scale, layer, page_tables, live),
                      v_cur.float()], dim=1)
    qf = q.float().reshape(b, t, hkv, g, d) * (1.0 / math.sqrt(scale_dim or d))
    scores = torch.einsum("btkgd,bskd->bkgts", qf, keys)
    pos = torch.arange(t, device=q.device)
    hist_live = live[:, None, :].expand(b, t, n_hist)
    causal = pos[None, :] <= pos[:, None]  # [T(query), T(key)]
    cur_live = causal[None] & (pos[None, None, :] < cur_lens[:, None, None].long())
    mask = torch.cat([hist_live, cur_live], dim=2)  # [B, T, history + T]
    scores = scores.masked_fill(~mask[:, None, None], -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgts,bskd->btkgd", probs, vals)
    return out.reshape(b, t, hq, d).to(q.dtype)


@functools.cache
def paged_tile_rows() -> int:
    """Query rows per CTA of the paged prefill kernel, from
    csrc/paged_prefill.cu, which alone defines them (dyn_paged_prefill_rows):
    whole tokens x the g heads of one kv group, so g may be at most this.
    Builds the kernel on first use."""
    return int(_build.function("paged_prefill", "dyn_paged_prefill_rows", [])())


def paged_prefill_attention(q, k_cur, v_cur, k_cache, v_cache, layer, page_tables,
                            hist_lens, cur_lens, *, scale_dim: Optional[int] = None,
                            k_scale=None, v_scale=None):
    """Attention for a chunk with history; see the module docstring for
    the contract."""
    scales = tuple(x for x in (k_scale, v_scale) if x is not None)
    tensors = (q, k_cur, v_cur, k_cache, v_cache, page_tables, hist_lens, cur_lens) + scales
    if not on_cuda(_PAGED, *tensors):
        return paged_prefill_attention_plain(
            q, k_cur, v_cur, k_cache, v_cache, layer, page_tables, hist_lens, cur_lens,
            scale_dim=scale_dim, k_scale=k_scale, v_scale=v_scale,
        )
    mode = pool_mode(_PAGED, k_cache, v_cache, k_scale, v_scale)
    _check_paged_shapes(q, k_cur, v_cur, k_cache, v_cache, layer, page_tables,
                        hist_lens, cur_lens)
    b, t, hq, d = q.shape
    _, p, s, hkv, _ = k_cache.shape
    pools = () if mode is not None else (k_cache, v_cache)
    require(all(x.dtype == torch.bfloat16 for x in (q, k_cur, v_cur) + pools),
            _PAGED, "the CUDA kernel takes bfloat16 q, k_cur/v_cur and bfloat16, int8 or "
                    "fp8 pools")
    require(all(x.dtype == torch.int32 for x in (page_tables, hist_lens, cur_lens)),
            _PAGED, "page_tables, hist_lens and cur_lens must be int32")
    require_head_dim(d, _PAGED)
    rows = paged_tile_rows()
    require(hq // hkv <= rows, _PAGED, _group_message(hq // hkv, rows))
    require(all(x.is_contiguous() for x in tensors), _PAGED, "all tensors must be contiguous")
    out = torch.empty_like(q)
    fn = _build.function("paged_prefill", "dyn_paged_prefill", PAGED_ARGTYPES)
    err = fn(
        _build.ptr(q), _build.ptr(k_cur), _build.ptr(v_cur), _build.ptr(k_cache),
        _build.ptr(v_cache), _build.ptr(k_scale), _build.ptr(v_scale),
        _build.ptr(page_tables), _build.ptr(hist_lens), _build.ptr(cur_lens), _build.ptr(out),
        kind(mode), b, t, hq, hkv, d, int(layer), p, s, page_tables.shape[1],
        1.0 / math.sqrt(scale_dim or d), _build.stream(q.device),
    )
    _build.check(err, _PAGED)
    paged_counts[mode].launches += 1
    return out


def paged_flops(hist_lens, cur_lens, hq: int, d: int) -> int:
    """Least multiply-adds (x2) a chunk with history needs: each valid row
    t < cur attends to the hist history keys and the t + 1 causal current
    keys, for QK^T and PV."""
    h = torch.as_tensor(hist_lens).long()
    n = torch.as_tensor(cur_lens).long()
    pairs = int((n * h + n * (n + 1) // 2).sum())
    return 4 * hq * d * pairs


def paged_bytes_moved(hist_lens, cur_lens, hq: int, hkv: int, d: int, itemsize: int,
                      kv_quantize=None) -> int:
    """Least bytes one call must move: each valid row's q, k_cur and v_cur
    read once and its output written once, and each history token's K and
    V read once (a quantized row: d narrow bytes and its f32 scale). Rows
    at or past cur_lens are unspecified, so the function need not write
    them."""
    tokens = int(torch.as_tensor(cur_lens).long().sum())
    hist = int(torch.as_tensor(hist_lens).long().sum())
    row = d * itemsize if kv_quantize is None else d + 4
    return tokens * (2 * hq + 2 * hkv) * d * itemsize + 2 * hist * hkv * row
