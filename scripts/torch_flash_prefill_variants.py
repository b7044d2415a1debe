"""Time builds of the flash prefill kernel against each other and SDPA, on
one NVIDIA GPU.

    python3 scripts/torch_flash_prefill_variants.py [--source NAME=PATH ...]
        [--groups 2,4,7,8 | --head-dims 64,96,128,256]

Builds, one nvcc each and all started together, every source that exports
`dyn_flash_prefill` with the C signature of
dynamo_tpu_torch/csrc/flash_prefill.cu:
  - `committed`: csrc/flash_prefill.cu as it is (query tiles longest first);
  - `forward`: the same source with its grid walking query tiles first to
    last (shortest first), the one line of the order changed;
  - each `--source NAME=PATH`, e.g. an earlier design of the kernel from
    `git archive <commit> dynamo_tpu_torch/csrc | tar -x -C DIR`, compiled
    where it lies so that it includes the headers of its own commit.
Each case (bf16 q/k/v from a fixed seed, Hq 32, Hkv 8) is checked, every
build against `flash_prefill_attention_plain` (each row's max |diff| at
most 2^-6 of its largest |value|, finite everywhere), then timed in the
order A B C, C B A: first every build's `ms` (CUDA events around 20 warmed
calls, host work included), then its `device_ms` (the same calls under
torch.profiler, kernel time per call) and its `cold_device_ms` (the same
with a 256 MB read between calls, so that no input is left in the 50 MB
L2), beside SDPA over the whole padded chunk (`library_ms`,
`library_device_ms`). Each build is called through its C entry point
directly, with the output allocated once, so the builds pay the same host
work. With `--groups`, the cases are instead the ragged B=8 T=512 chunk at
D=64 and a full B=4 T=1024 chunk at D=128 for each query group g listed,
over Hkv 4 (Hq = 4 g: g=7 is qwen2-7b's 28/4, g=8 the same tokens with
one head more a group); a build that refuses a case (an earlier design
and a group that does not divide its tile) is reported `refused` and not
timed. With `--head-dims`, the cases are instead the ragged B=8 T=512
chunk and a full B=4 T=1024 chunk at each head dim listed, over Hq 32 and
Hkv 8 (the same tokens and heads at every D), and a build that refuses a
head dim (an earlier design at 96 or 256) is reported `refused`. Prints
one JSON line per (case, build), then the card's name and power limit.
With no card it raises.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from dynamo_tpu_torch import platform  # noqa: E402
from dynamo_tpu_torch.ops import _build, flash_prefill  # noqa: E402

HQ, HKV = 32, 8
RAGGED = [512, 500, 385, 256, 129, 64, 33, 1]
#: (name, B, T, D, valid lengths or None for every token valid)
CASES = (
    ("ragged", 8, 512, 64, RAGGED),
    ("full", 8, 512, 64, None),
    ("d128", 4, 1024, 128, None),
    ("long", 1, 4096, 64, None),
)
#: the KV heads of the `--groups` cases, and their (name, B, T, D, lengths)
GROUP_HKV = 4
GROUP_CASES = (("ragged", 8, 512, 64, RAGGED), ("d128", 4, 1024, 128, None))
#: the `--head-dims` cases at each head dim D: (name, B, T, lengths)
HEAD_DIM_CASES = (("ragged", 8, 512, RAGGED), ("full", 4, 1024, None))
#: bytes read between calls for `cold_device_ms`: five times the H100's L2
FLUSH_BYTES = 256 << 20
ORDER_LINE = "const int tile = tiles - 1 - (int)(blockIdx.x / (B * Hkv));"
FORWARD_LINE = "const int tile = (int)(blockIdx.x / (B * Hkv));"
OUT_DIR = ROOT / "build" / "torch_kernels" / "variants"


def build(srcs: dict[str, str | Path]) -> dict[str, tuple[object, list[str]]]:
    """Compile every source in parallel; name -> (entry point, ptxas lines)."""
    argtypes = [_build.PTR] * 5 + [_build.INT] * 5 + [_build.FLOAT, _build.PTR]
    return {name: (_build.entry(lib, "dyn_flash_prefill", argtypes),
                   [line.strip() for line in log.splitlines()
                    if "registers" in line or "spill" in line])
            for name, (lib, log) in _build.build_variants(srcs, OUT_DIR).items()}


def caller(fn, q, k, v, valid_len, out):
    b, t, hq, d = q.shape
    args = (_build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(valid_len),
            _build.ptr(out), b, t, hq, k.shape[2], d, 1.0 / math.sqrt(d),
            _build.stream(q.device))

    def call(keep=out):  # the kernel writes it through `args`' raw pointer
        _build.check(fn(*args), "dyn_flash_prefill")
    return call


def run_case(fns, peaks, flush, name, b, t, d, lens, dev, hq=HQ, hkv=HKV) -> list[dict]:
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = dict(dtype=torch.bfloat16, device=dev)
    q = torch.randn((b, t, hq, d), generator=gen, **bf)
    k = torch.randn((b, t, hkv, d), generator=gen, **bf)
    v = torch.randn((b, t, hkv, d), generator=gen, **bf)
    valid_len = torch.tensor(lens or [t] * b, dtype=torch.int32, device=dev)
    ref = flash_prefill.flash_prefill_attention_plain(q, k, v, valid_len, scale_dim=d)
    calls, rows, refused = {}, {}, []
    for vname, (fn, ptxas) in fns.items():
        out = torch.full_like(q, float("nan"))
        call = caller(fn, q, k, v, valid_len, out)
        try:
            call()
        except RuntimeError:  # a build that does not serve this group or head dim
            refused.append({"case": name, "build": vname, "Hq": hq, "Hkv": hkv, "D": d,
                            "refused": True})
            continue
        calls[vname] = call
        torch.cuda.synchronize()
        err, rel = chip_smoke.row_errors(out, ref, valid_len)
        if not (rel <= chip_smoke.PREFILL_ROW_RTOL) or not torch.isfinite(out).all():
            raise AssertionError(f"{vname} {name}: a row's max |diff| is {rel} of its "
                                 f"largest value (limit {chip_smoke.PREFILL_ROW_RTOL})")
        rows[vname] = {"case": name, "build": vname, "B": b, "T": t, "Hq": hq, "Hkv": hkv,
                       "D": d, "valid_len": valid_len.tolist(), "max_abs_err": err,
                       "max_row_rel_err": rel, "ptxas": ptxas, "ms": [], "device_ms": [],
                       "cold_device_ms": []}
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def sdpa():
        torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                         enable_gqa=True)
    order = list(calls) + list(reversed(calls))
    library = {"library_ms": [], "library_device_ms": []}
    for vname in order:
        rows[vname]["ms"].append(chip_smoke.cuda_ms(calls[vname]))
    library["library_ms"].append(chip_smoke.cuda_ms(sdpa))
    for vname in order:
        rows[vname]["device_ms"].append(chip_smoke.device_ms(calls[vname])[0])
    for vname in order:
        rows[vname]["cold_device_ms"].append(
            chip_smoke.device_ms(calls[vname], between=flush)[0])
    dms, kernels = chip_smoke.device_ms(sdpa)
    library["library_device_ms"].append(dms)
    nbytes = flash_prefill.bytes_moved(valid_len.cpu(), hq, hkv, d, 2)
    b_ms, by = chip_smoke.bound(nbytes, flash_prefill.flops(valid_len.cpu(), hq, d), peaks)
    return [{**r, **library, "library_kernels": kernels, "bytes": nbytes, "bound_ms": b_ms,
             "bound_by": by} for r in rows.values()] + refused


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", action="append", default=[], metavar="NAME=PATH")
    ap.add_argument("--groups", default=None, metavar="G,G,...",
                    help="query groups to run GROUP_CASES at, over Hkv 4, instead of CASES")
    ap.add_argument("--head-dims", default=None, metavar="D,D,...",
                    help="head dims to run HEAD_DIM_CASES at instead of CASES")
    args = ap.parse_args()
    if args.groups and args.head_dims:
        ap.error("--groups and --head-dims pick the cases each: give one")
    try:
        srcs = _build.variant_sources("flash_prefill", args.source)
    except ValueError as e:
        ap.error(str(e))
    if "forward" in srcs:
        ap.error("--source NAME may not be 'forward', the committed kernel's twin")
    committed = srcs["committed"].read_text()
    if committed.count(ORDER_LINE) != 1:
        raise RuntimeError("csrc/flash_prefill.cu: the grid order line is not found once")
    srcs = {"committed": srcs.pop("committed"),
            "forward": committed.replace(ORDER_LINE, FORWARD_LINE), **srcs}
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the kernel builds run only on the card")
    dev = torch.device("cuda", 0)
    peaks = platform.device_peaks(torch.cuda.get_device_name(0))
    fns = build(srcs)
    scratch = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    flush = scratch.sum
    if args.head_dims is not None:
        cases = [((f"{name}_d{d}", b, t, d, lens), {})
                 for d in map(int, args.head_dims.split(",")) for name, b, t, lens in HEAD_DIM_CASES]
    elif args.groups is None:
        cases = [(case, {}) for case in CASES]
    else:
        cases = [((f"{name}_g{g}", *rest), {"hq": GROUP_HKV * g, "hkv": GROUP_HKV})
                 for g in map(int, args.groups.split(",")) for name, *rest in GROUP_CASES]
    for case, heads in cases:
        for row in run_case(fns, peaks, flush, *case, dev, **heads):
            print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    print(platform.card_info(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
