"""The paged KV write: one step's staged K/V for all layers lands in the pools.

Counterpart of dynamo_tpu/ops/kv_update.py::paged_write. The model stages
each layer's new K/V ([L, B, T, Hkv, D], model dtype) during its layer
loop and this lands them in the pools ([L, P, S, Hkv, D]) in place, once
per step. A quantized pool (int8 or fp8 rows, with `k_scale`/`v_scale`
planes [L, P, S, Hkv] f32) quantizes each staged row as it lands and
lands its scale beside it (ops/kv_quant.py::quantize_kv_rows).

Runs: each run is `run` consecutive slots of one (sequence, page),
placed by its first token: min(T, S) by default (decode runs are one
slot; prefill chunks start page-aligned, so such a run never crosses a
page). A chunk that starts mid-page (a speculative verify window at
position num_tokens - 1) passes run=1, which lands it token by token, as
the reference's scatter on the CPU does (dynamo_tpu/ops/kv_update.py,
its `use_kernel=False` branch). A run whose first token is
padding (valid=False) belongs to no page: the Pallas kernel and the plain
version below send it to the null page 0, slots [0, run), and the CUDA
kernel skips it; page 0's contents are unspecified, and no page table
names it. A run whose first token is valid but whose tail is padding
writes the tail rows too; those slots lie past the sequence's history and
are overwritten before they are read.

On CUDA tensors the kernel in csrc/kv_update.cu runs; on CPU tensors the
plain version below does the same work.
"""

from __future__ import annotations

import torch

from dynamo_tpu_torch.ops import _build
from dynamo_tpu_torch.ops._counts import on_cuda, require_head_dim
from dynamo_tpu_torch.ops.kv_quant import kind, pool_mode, quantize_kv_rows, variants

#: pool mode (None, "int8", "fp8") -> counts
counts = variants()

_NAME = "paged_write"
#: ctypes argument types of dyn_paged_write (csrc/kv_update.cu)
ARGTYPES = [_build.PTR] * 9 + [_build.INT] * 11 + [_build.PTR]


def _fail(what: str):
    raise ValueError(f"{_NAME}: {what}")


def _check_shapes(k_cache, v_cache, k_stage, v_stage, page_tables, positions, valid,
                  run=None):
    """The run (min(T, S) unless given); each shape is checked once, and a
    message is formatted only when its check fails."""
    if k_cache.dim() != 5 or v_cache.shape != k_cache.shape:
        _fail("pools must be [L, P, S, Hkv, D] and equal in shape")
    if k_stage.dim() != 5 or v_stage.shape != k_stage.shape:
        _fail("staged K/V must be [L, B, T, Hkv, D] and equal in shape")
    L, _, s, hkv, d = k_cache.shape
    L_, b, t, hkv_, d_ = k_stage.shape
    if (L_, hkv_, d_) != (L, hkv, d):
        _fail(f"staged {tuple(k_stage.shape)} does not fit pools {tuple(k_cache.shape)}")
    if positions.shape != (b, t) or valid.shape != (b, t):
        _fail("positions and valid must be [B, T]")
    if page_tables.dim() != 2 or page_tables.shape[0] != b:
        _fail("page_tables must be [B, MP]")
    if run is None:
        run = min(t, s)
    elif not 0 < run <= s:
        _fail(f"a run of {run} slots does not fit a page of {s}")
    if t % run:
        _fail(f"chunk T={t} must be a multiple of the run {run}")
    return run


def paged_write_plain(k_cache, v_cache, k_stage, v_stage, page_tables, positions, valid,
                      *, k_scale=None, v_scale=None, run=None):
    """Plain PyTorch version of `paged_write` (same contract)."""
    mode = pool_mode(_NAME, k_cache, v_cache, k_scale, v_scale)
    counts[mode].plain_calls += 1
    run = _check_shapes(k_cache, v_cache, k_stage, v_stage, page_tables, positions, valid, run)
    L, b, t = k_stage.shape[:3]
    s, mp = k_cache.shape[2], page_tables.shape[1]
    first_pos = positions[:, ::run].long()
    first_valid = valid[:, ::run]
    page_idx = torch.clamp(first_pos // s, 0, mp - 1)
    pages = torch.gather(page_tables.long(), 1, page_idx)
    pages = torch.where(first_valid, pages, torch.zeros_like(pages))
    slot0 = torch.where(first_valid, first_pos % s, torch.zeros_like(first_pos))
    lane = torch.arange(run, device=positions.device)
    page_ids = pages[:, :, None].expand(-1, -1, run).reshape(-1)
    slots = (slot0[:, :, None] + lane).reshape(-1)
    tail = k_stage.shape[3:]
    k_rows = k_stage.reshape(L, b * t, *tail)
    v_rows = v_stage.reshape(L, b * t, *tail)
    if mode is None:
        k_cache[:, page_ids, slots] = k_rows.to(k_cache.dtype)
        v_cache[:, page_ids, slots] = v_rows.to(v_cache.dtype)
        return k_cache, v_cache
    for rows, cache, scale in ((k_rows, k_cache, k_scale), (v_rows, v_cache, v_scale)):
        q, sc = quantize_kv_rows(rows, mode)
        cache[:, page_ids, slots] = q
        scale[:, page_ids, slots] = sc
    return k_cache, v_cache, k_scale, v_scale


def paged_write(k_cache, v_cache, k_stage, v_stage, page_tables, positions, valid,
                *, k_scale=None, v_scale=None, run=None):
    """Write one step's staged K/V for all layers into the pools in place.

    k_cache, v_cache: [L, P, S, Hkv, D]; k_stage, v_stage: [L, B, T, Hkv, D]
    (the pools' dtype, or the model dtype for a quantized pool);
    page_tables [B, MP] int32; positions [B, T] int32 (absolute); valid
    [B, T] bool; k_scale, v_scale [L, P, S, Hkv] f32 with an int8 or fp8
    pool; run: the slots each run lands, placed by its first token (a
    divisor of T, at most S; min(T, S) when None, 1 for a chunk that
    starts mid-page). Returns (k_cache, v_cache), and the scale planes
    after them when quantized.
    """
    args = (k_cache, v_cache, k_stage, v_stage, page_tables, positions, valid)
    scales = tuple(x for x in (k_scale, v_scale) if x is not None)
    if not on_cuda(_NAME, *args, *scales):
        return paged_write_plain(*args, k_scale=k_scale, v_scale=v_scale, run=run)
    mode = pool_mode(_NAME, k_cache, v_cache, k_scale, v_scale)
    run = _check_shapes(*args, run)
    if mode is None:
        if k_stage.dtype != k_cache.dtype or v_stage.dtype != v_cache.dtype:
            _fail("staged K/V must have the pools' dtype")
    elif k_stage.dtype != torch.bfloat16 or v_stage.dtype != torch.bfloat16:
        _fail("the quantizing CUDA kernel takes bfloat16 staged K/V")
    if page_tables.dtype != torch.int32 or positions.dtype != torch.int32:
        _fail("page_tables and positions must be int32")
    if valid.dtype != torch.bool:
        _fail("valid must be bool")
    for x in args + scales:
        if not x.is_contiguous():
            _fail("all tensors must be contiguous")
    L, p, s, hkv, d = k_cache.shape
    b, t = positions.shape
    row_bytes = hkv * d * k_cache.element_size()
    if mode is None:
        if row_bytes % 16:
            _fail(f"a token row of {row_bytes} bytes is not a multiple of 16")
    else:
        require_head_dim(d, _NAME)
    fn = _build.function("kv_update", "dyn_paged_write", ARGTYPES)
    err = fn(
        k_stage.data_ptr(), v_stage.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        None if mode is None else k_scale.data_ptr(),
        None if mode is None else v_scale.data_ptr(),
        page_tables.data_ptr(), positions.data_ptr(), valid.data_ptr(),
        kind(mode), L, p, s, b, t, page_tables.shape[1], run, hkv, d, row_bytes,
        _build.stream(k_cache.device),
    )
    _build.check(err, _NAME)
    counts[mode].launches += 1
    if mode is None:
        return k_cache, v_cache
    return k_cache, v_cache, k_scale, v_scale


def bytes_moved(k_stage, valid, page_size: int, kv_quantize=None, run=None) -> int:
    """Least bytes the write must move: each run that lands in a real page
    (its first token valid), K and V, read once and written once. A
    quantized pool writes each row's narrow values (one byte each) and its
    f32 scale."""
    run = run or min(k_stage.shape[2], page_size)
    rows = int(valid[:, ::run].sum()) * run * k_stage.shape[3]  # (token, kv head) rows
    d = k_stage.shape[4]
    row_in = d * k_stage.element_size()
    row_out = row_in if kv_quantize is None else d + 4
    return 2 * k_stage.shape[0] * rows * (row_in + row_out)
