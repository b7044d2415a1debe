"""Quantized KV rows: the int8 and fp8 storage of the paged pools.

Counterpart of kv_quant_spec, quantize_kv_rows and dequantize_kv_rows in
dynamo_tpu/models/llama.py. A quantized pool stores each token's row [D]
of each kv head in a narrow dtype (int8, or float8_e4m3fn) with one f32
scale, max(amax(|row|) / qmax, 1e-8), in a plane [L, P, S, Hkv] beside
the rows. Rows quantize on their own, so a page that fills one token at
a time never needs rescaling. The model stages its K/V in the model
dtype; the page write quantizes them and the readers dequantize.
"""

from __future__ import annotations

from typing import Optional

import torch

from dynamo_tpu_torch.ops._counts import KernelCounts, require

#: kv_quantize modes, in the order of the CUDA kernels' `kind` argument
#: (0 is an unquantized pool)
MODES = ("int8", "fp8")
#: the modes a pool may have: None (the model dtype) and MODES
POOL_MODES = (None,) + MODES


def kv_quant_spec(mode: str):
    """kv_quantize mode -> (storage dtype, the largest |value| it stores)."""
    if mode == "int8":
        return torch.int8, 127.0
    if mode == "fp8":
        return torch.float8_e4m3fn, 448.0
    raise ValueError(f"unknown kv_quantize mode {mode!r}; use int8|fp8")


def quantize_kv_rows(x: torch.Tensor, mode: str = "int8"):
    """x [..., D] -> (q [..., D] in the narrow dtype, scale [...] f32):
    symmetric per row, rounded half to even for int8."""
    dtype, qmax = kv_quant_spec(mode)
    xf = x.float()
    # qmax as a tensor: CUDA turns division by a Python scalar into a
    # multiply by its reciprocal, which can round the scale one ulp off
    qmax_t = torch.tensor(qmax, dtype=torch.float32, device=xf.device)
    scale = torch.clamp(xf.abs().amax(dim=-1) / qmax_t, min=1e-8)
    q = xf / scale[..., None]
    if dtype == torch.int8:
        q = torch.round(q)
    return q.to(dtype), scale


def dequantize_kv_rows(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """Inverse of quantize_kv_rows: q [..., D] x scale [...] -> dtype."""
    return (q.float() * scale[..., None]).to(dtype)


def pool_mode(kernel: str, k_cache, v_cache, k_scale, v_scale) -> Optional[str]:
    """The kv_quantize mode of a pool (None when it holds the model dtype),
    checking that the scale planes come with a narrow pool and only then."""
    if k_scale is None and v_scale is None:
        if k_cache.dtype in (torch.int8, torch.float8_e4m3fn):  # formatted only on failure
            raise ValueError(f"{kernel}: a {k_cache.dtype} pool needs its scale planes")
        return None
    require(k_scale is not None and v_scale is not None, kernel,
            "k_scale and v_scale come together")
    mode = {torch.int8: "int8", torch.float8_e4m3fn: "fp8"}.get(k_cache.dtype)
    if mode is None or v_cache.dtype != k_cache.dtype:
        raise ValueError(
            f"{kernel}: scale planes need an int8 or float8_e4m3fn pool, not {k_cache.dtype}")
    require(k_scale.shape == k_cache.shape[:-1] and v_scale.shape == k_scale.shape, kernel,
            "scale planes must be [L, P, S, Hkv] beside the pools")
    require(k_scale.dtype == torch.float32 and v_scale.dtype == torch.float32, kernel,
            "scale planes must be float32")
    return mode


def kind(mode: Optional[str]) -> int:
    """The CUDA kernels' `kind` argument: 0 unquantized, 1 int8, 2 fp8."""
    return 0 if mode is None else 1 + MODES.index(mode)


def variants() -> dict[Optional[str], KernelCounts]:
    """One count per pool mode of a kernel, so a run shows which variant
    it used."""
    return {mode: KernelCounts() for mode in POOL_MODES}


def variant(name: str, mode: Optional[str]) -> str:
    """A kernel's name for one pool mode: `paged_write`, `paged_write.int8`."""
    return name if mode is None else f"{name}.{mode}"


def gather_history(cache, scale, layer: int, page_tables, live) -> torch.Tensor:
    """Each sequence's history [B, MP*S, Hkv, D] in float32, read through
    its page table and dequantized when `scale` is given. Slots off `live`
    [B, MP*S] read as 0 by selection: a stale byte there may encode NaN,
    and a zero scale times NaN is NaN."""
    pt = page_tables.long()
    b, mp = pt.shape
    rows = cache[int(layer)][pt]  # [B, MP, S, Hkv, D]
    rows = rows.reshape(b, mp * rows.shape[2], *rows.shape[3:]).float()
    if scale is not None:
        s = scale[int(layer)][pt].reshape(b, rows.shape[1], rows.shape[2])
        rows = rows * s[..., None]
    return torch.where(live[:, :, None, None], rows, torch.zeros((), dtype=rows.dtype))
