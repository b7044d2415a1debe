"""Time builds of the paged prefill kernel against each other and SDPA, on
one NVIDIA GPU.

    python3 scripts/torch_paged_prefill_variants.py [--source NAME=PATH ...]
        [--groups 2,4,7,8 | --head-dims 64,96,128,256]

Builds, one nvcc each and all started together, `committed`
(dynamo_tpu_torch/csrc/paged_prefill.cu as it is) and each `--source
NAME=PATH`, e.g. an earlier design of the kernel from `git archive
<commit> dynamo_tpu_torch/csrc | tar -x -C DIR`, which is compiled where
it lies and so includes the headers of its own commit. Every build takes the
same C signature (`dyn_paged_prefill`) and is called through it with its
output allocated once and held by its caller, so the builds pay the same
host work.

Cases, made exactly as chip_smoke.py makes its paged prefill cases (Hq 32,
Hkv 8, page size 64, T=512): B=4 with histories (0, 512, 1536, 3072) and
chunks (512, 512, 300, 512), and B=1 with history 2,560 and chunk 440 (one
long prompt's sixth chunk), over bf16, int8 and fp8 pools at D=64, and the
B=4 case over a bf16 pool at D=128. Each build is checked against
`paged_prefill_attention_plain` (each row below cur_lens within 2^-6 of
its largest |value|, finite output), then timed in the order A B, B A by
`device_ms` (torch.profiler, kernel time per call over 20 warmed calls)
and `cold_device_ms` (the same with a 256 MB read between calls, so that
no input is left in the 50 MB L2), beside SDPA over a dense bf16 copy of
each history and its chunk (`library_device_ms`), the package's wrapper
around the committed kernel (`wrapper_device_ms`: the served path) and
the operations bound. With `--groups`, the cases are instead the B=4 case
over a bf16 and an int8 pool at D=64 and over a bf16 pool at D=128, for
each query group g listed, over Hkv 4 (Hq = 4 g: g=7 is qwen2-7b's 28/4,
g=8 the same tokens with one head more a group); a build that refuses a
case (an earlier design and a group that does not divide its tile) is
reported `refused` and not timed. With `--head-dims`, the cases are
instead the B=4 case over a bf16, an int8 and an fp8 pool at each head
dim listed (Hq 32, Hkv 8: the same tokens and heads at every D), and a
build that refuses a head dim is reported `refused`. Prints one JSON line
per (case, build),
with ptxas's registers for the kernel instance, then the card's name and
power limit. With no card it raises.
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
from dynamo_tpu_torch.ops import _build, flash_prefill, kv_quant  # noqa: E402

#: (name, hist_lens, cur_lens, T, pool mode, D, seed): chip_smoke.py's cases
CASES = tuple(
    (name, hist, cur, t, mode, 64, seed)
    for mode in kv_quant.POOL_MODES
    for name, (hist, cur, t, seed) in zip(("b1", "b4"), chip_smoke.PAGED_PREFILL_CASES)
) + (("b4_d128", *chip_smoke.PAGED_PREFILL_CASES[-1][:3], None, 128, 11),)
#: the KV heads of the `--groups` cases, and their (name, pool mode, D, seed)
GROUP_HKV = 4
GROUP_CASES = (("b4", None, 64, 5), ("b4", "int8", 64, 5), ("b4_d128", None, 128, 11))
#: the seed of the `--head-dims` cases (the B=4 case in every pool mode)
HEAD_DIM_SEED = 5
OUT_DIR = ROOT / "build" / "torch_kernels" / "prefill_variants"
#: bytes read between calls for `cold_device_ms`: five times the H100's L2
FLUSH_BYTES = 256 << 20


def caller(lib, args, planes, mode, d):
    """A call of one build's C entry point on fixed inputs, its output
    allocated here once; returns (call, output)."""
    q, k_cur, v_cur, k_cache, v_cache, layer, pt, hist_lens, cur_lens = args
    b, t, hq, _ = q.shape
    _, p, s, hkv, _ = k_cache.shape
    out = torch.empty_like(q)
    fn = _build.entry(lib, "dyn_paged_prefill", flash_prefill.PAGED_ARGTYPES)
    full = (*map(_build.ptr, (q, k_cur, v_cur, k_cache, v_cache, planes.get("k_scale"),
                              planes.get("v_scale"), pt, hist_lens, cur_lens, out)),
            kv_quant.kind(mode), b, t, hq, hkv, d, int(layer), p, s, pt.shape[1],
            1.0 / math.sqrt(d), _build.stream(q.device))

    def call(keep=(args, planes, out)):  # the kernel reads and writes them through `full`
        _build.check(fn(*full), "dyn_paged_prefill")
    return call, out


def run_case(builds, peaks, flush, name, hist, cur, t, mode, d, seed, dev,
             heads=(chip_smoke.HQ, chip_smoke.HKV)) -> list[dict]:
    hq, hkv = heads
    gen = torch.Generator(device=dev).manual_seed(seed)
    args, planes = chip_smoke.paged_prefill_inputs(dev, gen, hist, cur, t, mode, d, heads)
    hist_lens, cur_lens = args[-2:]
    ref = flash_prefill.paged_prefill_attention_plain(*args, scale_dim=d, **planes)
    # the kernel instance's template arguments <D, pool type, ...> in its mangled name
    tag = f"ILi{d}E" + {None: "13__nv_bfloat16", "int8": "a", "fp8": "13__nv_fp8_e4m3"}[mode]
    calls, rows, refused = {}, {}, []
    for bname, (lib, regs) in builds.items():
        call, out = caller(lib, args, planes, mode, d)
        try:
            call()
        except RuntimeError:  # a build that does not serve this group or head dim
            refused.append({"case": name, "build": bname, "mode": mode or "bf16", "Hq": hq,
                            "Hkv": hkv, "D": d, "refused": True})
            continue
        calls[bname] = call
        torch.cuda.synchronize()
        err, rel = chip_smoke.row_errors(out, ref, cur_lens)
        if not (rel <= chip_smoke.PREFILL_ROW_RTOL) or not torch.isfinite(out).all():
            raise AssertionError(f"{bname} {name} {mode}: a row's max |diff| is {rel} of its "
                                 f"largest value (limit {chip_smoke.PREFILL_ROW_RTOL})")
        ptxas = {k: v for k, v in regs.items() if tag in k}
        rows[bname] = {"case": name, "build": bname, "mode": mode or "bf16", "B": len(hist),
                       "T": t, "Hq": hq, "Hkv": hkv, "D": d,
                       "S": chip_smoke.S, "hist_lens": hist, "cur_lens": cur,
                       "max_abs_err": err, "max_row_rel_err": rel, "registers": ptxas,
                       "device_ms": [], "cold_device_ms": []}
    order = list(calls) + list(reversed(calls))
    for bname in order:
        rows[bname]["device_ms"].append(chip_smoke.device_ms(calls[bname])[0])
    for bname in order:
        rows[bname]["cold_device_ms"].append(
            chip_smoke.device_ms(calls[bname], between=flush)[0])
    # the served path: the committed kernel behind the package's wrapper
    wrapper_ms = chip_smoke.device_ms(
        lambda: flash_prefill.paged_prefill_attention(*args, scale_dim=d, **planes))[0]
    lib_ms, kernels = chip_smoke.device_ms(chip_smoke.paged_prefill_library(args, planes))
    nbytes = flash_prefill.paged_bytes_moved(hist_lens.cpu(), cur_lens.cpu(), hq, hkv, d, 2,
                                             mode)
    flop = flash_prefill.paged_flops(hist_lens.cpu(), cur_lens.cpu(), hq, d)
    b_ms, by = chip_smoke.bound(nbytes, flop, peaks)
    return [{**r, "wrapper_device_ms": wrapper_ms, "library_device_ms": lib_ms,
             "library_kernels": kernels, "flop": flop, "bytes": nbytes, "bound_ms": b_ms,
             "bound_by": by} for r in rows.values()] + refused


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", action="append", default=[], metavar="NAME=PATH")
    ap.add_argument("--groups", default=None, metavar="G,G,...",
                    help="query groups to run GROUP_CASES at, over Hkv 4, instead of CASES")
    ap.add_argument("--head-dims", default=None, metavar="D,D,...",
                    help="head dims to run the B=4 case at, in every pool mode, instead of CASES")
    args = ap.parse_args()
    if args.groups and args.head_dims:
        ap.error("--groups and --head-dims pick the cases each: give one")
    try:
        srcs = _build.variant_sources("paged_prefill", args.source)
    except ValueError as e:
        ap.error(str(e))
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the kernel builds run only on the card")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    peaks = platform.device_peaks(torch.cuda.get_device_name(0))
    builds = {name: (lib, _build.ptxas_registers(log))
              for name, (lib, log) in _build.build_variants(srcs, OUT_DIR).items()}
    scratch = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    flush = scratch.sum
    main = chip_smoke.PAGED_PREFILL_CASES[-1][:3]  # the B=4 chunk beside histories
    if args.head_dims is not None:
        cases = [((f"b4_d{d}", *main, mode, d, HEAD_DIM_SEED), {})
                 for d in map(int, args.head_dims.split(",")) for mode in kv_quant.POOL_MODES]
    elif args.groups is None:
        cases = [(case, {}) for case in CASES]
    else:
        cases = [((f"{name}_g{g}", *main, mode, d, seed), {"heads": (GROUP_HKV * g, GROUP_HKV)})
                 for g in map(int, args.groups.split(",")) for name, mode, d, seed in GROUP_CASES]
    for case, heads in cases:
        for row in run_case(builds, peaks, flush, *case, dev, **heads):
            print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    print(platform.card_info(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
