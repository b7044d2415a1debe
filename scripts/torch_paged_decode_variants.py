"""Time builds of the paged decode kernel against each other and SDPA, on
one NVIDIA GPU.

    python3 scripts/torch_paged_decode_variants.py [--source NAME=PATH ...] [--head-dims 64,96,128,256]

Builds, one nvcc each and all started together, `committed`
(dynamo_tpu_torch/csrc/paged_attention.cu as it is) and each `--source
NAME=PATH`, e.g. an earlier design of the kernel from `git archive
<commit> dynamo_tpu_torch/csrc | tar -x -C DIR`, which is compiled where
it lies and so includes the headers of its own commit. A build that exports
`dyn_paged_decode_layout` takes the committed C signature (one launch; a
ticket-counter workspace laid out as the build says) and the committed
split plan over its own resident CTAs per SM; one that exports no
`dyn_paged_decode_occupancy` takes the earlier signature (a split kernel
and a combine kernel, partial buffers) and the earlier plan of 2 CTAs per
SM. Each build is called through its C entry point with its
outputs and workspace allocated once, so the builds pay the same host
work.

Cases, made exactly as chip_smoke.py makes its decode cases (Hq 32, Hkv 8,
page size 64): B=1 (history 2,031) and B=32 (33,849 history tokens) over
bf16, int8 and fp8 pools at D=64, and B=32 over a bf16 pool at D=128.
Each build is checked against `paged_decode_attention_plain` (max |acc/l
diff| and |m diff| at most 1e-4, zero history exactly (0, -inf, 0)), then
timed in the order A B C, C B A by `device_ms` (torch.profiler, kernel
time per call over 20 warmed calls), beside SDPA over a dense bf16 copy
of the history (`library_device_ms`), the package's wrapper around the
committed kernel (`wrapper_device_ms`: the served path, whose host work
paces the launches) and the byte bound. With `--head-dims`, the cases are
instead B=32 over a bf16, an int8 and an fp8 pool at each head dim listed
(Hq 32, Hkv 8: the same histories and heads at every D), and a build that
refuses a head dim (an earlier design at 96 or 256) is reported
`refused` and not timed. Prints one JSON line per (case,
build), with ptxas's registers for each kernel instance, then the card's
name and power limit. With no card it raises.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from dynamo_tpu_torch import platform  # noqa: E402
from dynamo_tpu_torch.ops import _build, kv_quant, paged_attention  # noqa: E402

#: (name, B, longest history, pool mode, D, seed): chip_smoke.py's decode cases
CASES = (
    ("b1", 1, 2048, None, 64, 3),
    ("b32", 32, 2048, None, 64, 4),
    ("b1", 1, 2048, "int8", 64, 3),
    ("b32", 32, 2048, "int8", 64, 4),
    ("b1", 1, 2048, "fp8", 64, 3),
    ("b32", 32, 2048, "fp8", 64, 4),
    ("b32_d128", 32, 2048, None, 128, 9),
)
#: the `--head-dims` cases' (name, B, longest history, seed), in every pool mode
HEAD_DIM_CASE = ("b32", 32, 2048, 4)
OUT_DIR = ROOT / "build" / "torch_kernels" / "decode_variants"
PTR, INT, FLOAT = _build.PTR, _build.INT, _build.FLOAT
INTP = ctypes.POINTER(ctypes.c_int)
#: the earlier design's fixed CTAs per SM for its split plan
EARLIER_CTAS_PER_SM = 2


def caller(lib, args, planes, mode, d, dev):
    """A call of one build's C entry point on fixed inputs, its outputs and
    workspace allocated here once; returns (call, (acc, m, l), plan)."""
    q, k_cache, v_cache, layer, pt, hist = args
    b, hq, _ = q.shape
    L, p, s, hkv, _ = k_cache.shape
    mp = pt.shape[1]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    f32 = dict(dtype=torch.float32, device=dev)
    acc, m, l = (torch.empty((b, hq, d), **f32), torch.empty((b, hq), **f32),
                 torch.empty((b, hq), **f32))
    head = (_build.ptr(q), _build.ptr(k_cache), _build.ptr(v_cache),
            _build.ptr(planes.get("k_scale")), _build.ptr(planes.get("v_scale")),
            _build.ptr(pt), _build.ptr(hist))
    if hasattr(lib, "dyn_paged_decode_layout"):
        occ = _build.entry(lib, "dyn_paged_decode_occupancy", [INT, INT, INTP])
        ctas = ctypes.c_int(0)
        _build.check(occ(kv_quant.kind(mode), d, ctypes.byref(ctas)), "occupancy")
        lay = _build.entry(lib, "dyn_paged_decode_layout", [INT] * 3 + [INTP] * 3)
        groups, max_splits, split_floats = (ctypes.c_int(0) for _ in range(3))
        _build.check(lay(hq, hkv, d, *map(ctypes.byref, (groups, max_splits, split_floats))),
                     "layout")
        splits, per = paged_attention.decode_split_plan(b, groups.value, mp, sms, ctas.value,
                                                        max_splits.value)
        partials = torch.empty(max(1, b * groups.value * splits * split_floats.value), **f32)
        counters = torch.zeros(b * groups.value, dtype=torch.int32, device=dev)
        work = (partials, counters)
        head += (_build.ptr(partials), partials.numel(), _build.ptr(counters), counters.numel())
        fn = _build.entry(lib, "dyn_paged_decode", paged_attention.DECODE_ARGTYPES)
        plan = {"ctas_per_sm": ctas.value, "splits": splits, "pages_per_split": per}
    else:
        pairs = max(1, b * hkv)
        want = -(-EARLIER_CTAS_PER_SM * sms // pairs)
        per = -(-mp // max(1, min(mp, want)))
        splits = -(-mp // per)
        g = hq // hkv
        work = (torch.empty((b, hkv, splits, g, d), **f32),
                torch.empty((b, hkv, splits, g), **f32), torch.empty((b, hkv, splits, g), **f32))
        head += tuple(_build.ptr(w) for w in work)
        fn = _build.entry(lib, "dyn_paged_decode", [PTR] * 13 + [INT] * 11 + [FLOAT, PTR])
        plan = {"ctas_per_sm": EARLIER_CTAS_PER_SM, "splits": splits, "pages_per_split": per}
    full = (*head, _build.ptr(acc), _build.ptr(m), _build.ptr(l),
            kv_quant.kind(mode), b, hq, hkv, d, int(layer), p, s, mp, splits, per,
            1.0 / math.sqrt(d), _build.stream(dev))

    def call(keep=(work, acc, m, l)):  # the kernel writes them through `full`'s raw pointers
        _build.check(fn(*full), "dyn_paged_decode")
    return call, (acc, m, l), plan


def run_case(builds, peaks, name, b, max_hist, mode, d, seed, dev) -> list[dict]:
    gen = torch.Generator(device=dev).manual_seed(seed)
    args, planes = chip_smoke.decode_inputs(dev, gen, b, max_hist, mode, d)
    hist = args[-1]
    ref = paged_attention.paged_decode_attention_plain(*args, scale_dim=d, **planes)
    calls, rows, refused = {}, {}, []
    # the kernel instance's template arguments <D, pool type> in its mangled name
    tag = f"ILi{d}E" + {None: "13__nv_bfloat16E", "int8": "aE", "fp8": "13__nv_fp8_e4m3E"}[mode]
    for bname, (lib, regs) in builds.items():
        try:
            call, out, plan = caller(lib, args, planes, mode, d, dev)
            call()
        except RuntimeError:  # a build that does not serve this head dim
            refused.append({"case": name, "build": bname, "mode": mode or "bf16", "D": d,
                            "refused": True})
            continue
        calls[bname] = call
        torch.cuda.synchronize()
        err, m_err, empty_ok = chip_smoke.decode_errors(out, ref, hist)
        if not (err <= chip_smoke.DECODE_ATOL and m_err <= chip_smoke.DECODE_ATOL) or not empty_ok:
            raise AssertionError(f"{bname} {name} {mode}: max |acc/l diff| {err}, |m diff| "
                                 f"{m_err} (limit {chip_smoke.DECODE_ATOL}), empty rows: {empty_ok}")
        ptxas = {k: v for k, v in regs.items() if tag in k or "combine" in k}
        rows[bname] = {"case": name, "build": bname, "mode": mode or "bf16", "B": b,
                       "Hq": chip_smoke.HQ, "Hkv": chip_smoke.HKV, "D": d, "S": chip_smoke.S,
                       "history_tokens": int(hist.long().sum()), "max_abs_err": err,
                       "max_m_err": m_err, "registers": ptxas, **plan, "device_ms": []}
    order = list(calls) + list(reversed(calls))
    for bname in order:
        rows[bname]["device_ms"].append(chip_smoke.device_ms(calls[bname])[0])
    # the served path: the committed kernel behind the package's wrapper
    wrapper_ms = chip_smoke.device_ms(
        lambda: paged_attention.paged_decode_attention(*args, scale_dim=d, **planes))[0]
    lib_ms, kernels = chip_smoke.device_ms(chip_smoke.decode_library(args, planes))
    nbytes = paged_attention.bytes_moved(hist.cpu(), chip_smoke.HQ, chip_smoke.HKV, d, 2, mode)
    flop = 4 * chip_smoke.HQ * d * int(hist.long().sum())
    b_ms, by = chip_smoke.bound(nbytes, flop, peaks)
    return [{**r, "wrapper_device_ms": wrapper_ms, "library_device_ms": lib_ms,
             "library_kernels": kernels, "bytes": nbytes, "bound_ms": b_ms, "bound_by": by}
            for r in rows.values()] + refused


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", action="append", default=[], metavar="NAME=PATH")
    ap.add_argument("--head-dims", default=None, metavar="D,D,...",
                    help="head dims to run B=32 at, in every pool mode, instead of CASES")
    args = ap.parse_args()
    try:
        srcs = _build.variant_sources("paged_attention", args.source)
    except ValueError as e:
        ap.error(str(e))
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the kernel builds run only on the card")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    peaks = platform.device_peaks(torch.cuda.get_device_name(0))
    builds = {name: (lib, _build.ptxas_registers(log))
              for name, (lib, log) in _build.build_variants(srcs, OUT_DIR).items()}
    cases = CASES
    if args.head_dims is not None:
        name, b, max_hist, seed = HEAD_DIM_CASE
        cases = [(f"{name}_d{d}", b, max_hist, mode, d, seed)
                 for d in map(int, args.head_dims.split(",")) for mode in kv_quant.POOL_MODES]
    for case in cases:
        for row in run_case(builds, peaks, *case, dev):
            print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    print(platform.card_info(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
