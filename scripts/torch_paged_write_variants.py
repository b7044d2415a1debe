"""Time builds of the paged KV write against each other and index_copy_, on
one NVIDIA GPU.

    python3 scripts/torch_paged_write_variants.py [--source NAME=PATH ...] [--head-dims 64,96,128,256]

Builds, one nvcc each and all started together, `committed`
(dynamo_tpu_torch/csrc/kv_update.cu as it is), `bulk`
(scripts/write_variants/kv_update_bulk.cu: the same units moved by 1D
bulk copies through shared memory), each `--source NAME=PATH`,
e.g. an earlier design of the kernel from `git archive <commit>
dynamo_tpu_torch/csrc | tar -x -C DIR`, which is compiled where it lies
and so includes the headers of its own commit, and two empty kernels
behind the same C entry point (the floors below). Every build takes the
same C signature (`dyn_paged_write`) and is called through it with every
buffer it is handed allocated once and held by its caller, so the builds
pay the same host work.

Cases, made exactly as chip_smoke.py makes its write cases (Hkv 8, page
size 64, 16 layers): decode B=32 (the last row padding), prefill B=8
T=512 of random lengths, one long prompt's chunk (B=1, T=512, every token
valid), each at D=64, and B=8 T=512 at D=128, over bf16, int8 and fp8
pools. Each build is checked bit-equal to `paged_write_plain` on every
page but the null page 0 (narrow bytes and scale planes too), then timed
in the order A B ..., ... B A by `device_ms` (torch.profiler, kernel time
per call over 20 warmed calls; the calls after the first find their
inputs and destinations in L2 when those fit its 50 MB), then again in
that order with a read of 256 MB between calls (`cold_device_ms`: each
call starts with nothing of its own in L2, as a served step does), beside
the package's wrapper around the
committed kernel (`wrapper_device_ms`: the served path), `index_copy_` on
each pool over precomputed slot indices for a bf16 pool
(`library_device_ms`), the bytes bound, `floor_ms`, the device time of
an empty kernel of one block through the same path (the part of a small
write's time that no design of the kernel can remove), and
`floor_runs_ms`, the same empty kernel launched as one block per (layer,
run), the grid of the earlier design. With `--head-dims`, the cases are
instead decode B=32 and prefill B=8 T=512 at each head dim listed, over
each pool mode, and a build that refuses a case (a quantized pool at a
head dim it does not take) is reported `refused` and not timed. Prints
one JSON line per
(case, build), with ptxas's registers for the kernel instance, then the
card's name and power limit. With no card it raises.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from dynamo_tpu_torch import platform  # noqa: E402
from dynamo_tpu_torch.ops import _build, kv_quant, kv_update  # noqa: E402

#: (name, B, T, D, every token valid, seed): chip_smoke.py's write cases
SHAPES = (("decode_b32", 32, 1, 64, False, 1), ("prefill_b8", 8, 512, 64, False, 2),
          ("prefill_b1_full", 1, 512, 64, True, 12), ("prefill_b8_d128", 8, 512, 128, False, 13))
#: the `--head-dims` cases at each head dim D: (name, B, T, every token valid, seed)
HEAD_DIM_SHAPES = (("decode_b32", 32, 1, False, 1), ("prefill_b8", 8, 512, False, 13))
OUT_DIR = ROOT / "build" / "torch_kernels" / "write_variants"
#: the bulk-copy design, always built beside the committed kernel
BULK = ROOT / "scripts" / "write_variants" / "kv_update_bulk.cu"
#: bytes read between calls for `cold_device_ms`: five times the H100's L2
FLUSH_BYTES = 256 << 20
#: the floors: an empty kernel behind the write's C signature, launched as
#: one block (`empty`) and as one block per (layer, run) (`empty_runs`, the
#: grid of the earlier design)
EMPTY = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int dyn_paged_write(const void*, const void*, void*, void*, void*, void*,
                               const void*, const void*, const void*, int, int layers, int,
                               int, int batch, int tokens, int, int run, int, int, int,
                               void* stream) {
  empty_kernel<<<GRID, 128, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
"""
FLOORS = {"empty": EMPTY.replace("GRID", "1"),
          "empty_runs": EMPTY.replace("GRID", "dim3(batch * (tokens / run), layers)")}
#: a kernel instance's storage type in its mangled name
TYPE_TAG = {None: "13__nv_bfloat16", "int8": "a", "fp8": "13__nv_fp8_e4m3"}


def registers(regs: dict[str, int], mode, d: int) -> dict[str, int]:
    """ptxas's registers of the write kernel's instance for the pool mode
    and head dim (an instance without a head dim argument serves all)."""
    out = {}
    for name, n in regs.items():
        m = re.search(r"paged_write(?:_bulk)?_kernelI(13__nv_bfloat16|a|13__nv_fp8_e4m3)"
                      r"(?:Li(\d+)E)?", name)
        if m and m.group(1) == TYPE_TAG[mode] and m.group(2) in (None, "0", str(d)):
            out[name] = n
    return out


def caller(lib, pools, k_stage, v_stage, args, mode):
    """A call of one build's C entry point on fixed inputs, writing into
    `pools` (K, V and any scale planes) in place."""
    k_cache = pools[0]
    _, p, s, hkv, d = k_cache.shape
    pt, pos, _ = args
    b, t = pos.shape
    planes = pools[2:] if mode is not None else (None, None)
    fn = _build.entry(lib, "dyn_paged_write", kv_update.ARGTYPES)
    full = (*map(_build.ptr, (k_stage, v_stage, *pools[:2], *planes, *args)), kv_quant.kind(mode),
            k_cache.shape[0], p, s, b, t, pt.shape[1], min(t, s), hkv, d,
            hkv * d * k_cache.element_size(), _build.stream(k_cache.device))

    def call(keep=(pools, k_stage, v_stage, args)):  # the kernel uses them through `full`
        _build.check(fn(*full), "dyn_paged_write")
    return call


def run_case(builds, floors, peaks, flush, name, b, t, d, full, seed, mode,
             dev) -> list[dict]:
    gen = torch.Generator(device=dev).manual_seed(seed)
    before, k_stage, v_stage, args, planes = chip_smoke.paged_write_inputs(
        dev, gen, b, t, mode, d, full)
    want = [x.clone() for x in before]
    kv_update.paged_write_plain(want[0], want[1], k_stage, v_stage, *args,
                                **dict(zip(planes, want[2:])))
    calls, rows, refused = {}, {}, []
    for bname, (lib, regs) in builds.items():
        pools = [x.clone() for x in before]
        call = caller(lib, pools, k_stage, v_stage, args, mode)
        try:
            call()
        except RuntimeError:  # a build that does not serve this head dim
            refused.append({"case": name, "build": bname, "mode": mode or "bf16", "D": d,
                            "refused": True})
            continue
        calls[bname] = call
        torch.cuda.synchronize()
        for g, w in zip(pools, want):  # page 0 is the null page
            if not torch.equal(chip_smoke.as_bytes(g)[:, 1:], chip_smoke.as_bytes(w)[:, 1:]):
                raise AssertionError(f"{bname} {name} {mode or 'bf16'}: not bit-equal")
        rows[bname] = {"case": name, "build": bname, "mode": mode or "bf16", "B": b, "T": t,
                       "L": chip_smoke.L, "Hkv": chip_smoke.HKV, "D": d, "S": chip_smoke.S,
                       "every_token_valid": full, "max_abs_err": 0.0,
                       "registers": registers(regs, mode, d), "device_ms": [],
                       "cold_device_ms": []}
    order = list(calls) + list(reversed(calls))
    for bname in order:
        rows[bname]["device_ms"].append(chip_smoke.device_ms(calls[bname])[0])
    for bname in order:
        rows[bname]["cold_device_ms"].append(
            chip_smoke.device_ms(calls[bname], between=flush)[0])
    floor_ms = {name: chip_smoke.device_ms(
        caller(lib, [x.clone() for x in before], k_stage, v_stage, args, mode))[0]
        for name, lib in floors.items()}
    # the served path: the committed kernel behind the package's wrapper
    pools = [x.clone() for x in before]
    kp = dict(zip(planes, pools[2:]))
    wrapper_ms = chip_smoke.device_ms(
        lambda: kv_update.paged_write(pools[0], pools[1], k_stage, v_stage, *args, **kp))[0]
    lib_ms, kernels = None, []
    if mode is None:
        lib_ms, kernels = chip_smoke.device_ms(
            chip_smoke.index_copy_write(want, k_stage, v_stage, *args))
    nbytes = kv_update.bytes_moved(k_stage, args[2].cpu(), chip_smoke.S, mode)
    b_ms, by = chip_smoke.bound(nbytes, 0.0, peaks)
    return [{**r, "wrapper_device_ms": wrapper_ms, "floor_ms": floor_ms["empty"],
             "floor_runs_ms": floor_ms["empty_runs"],
             "library_device_ms": lib_ms, "library_kernels": kernels, "bytes": nbytes,
             "bound_ms": b_ms, "bound_by": by} for r in rows.values()] + refused


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", action="append", default=[], metavar="NAME=PATH")
    ap.add_argument("--head-dims", default=None, metavar="D,D,...",
                    help="head dims to run HEAD_DIM_SHAPES at instead of SHAPES")
    args = ap.parse_args()
    try:
        srcs = _build.variant_sources("kv_update", args.source)
    except ValueError as e:
        ap.error(str(e))
    if set(srcs) & {*FLOORS, "bulk"}:
        ap.error(f"--source NAMEs {sorted({*FLOORS, 'bulk'})} are the script's own builds")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the kernel builds run only on the card")
    dev = torch.device("cuda", 0)
    peaks = platform.device_peaks(torch.cuda.get_device_name(0))
    built = _build.build_variants({**srcs, "bulk": BULK, **FLOORS}, OUT_DIR)
    floors = {name: built.pop(name)[0] for name in FLOORS}
    builds = {name: (lib, _build.ptxas_registers(log)) for name, (lib, log) in built.items()}
    l2 = torch.zeros(FLUSH_BYTES // 4, device=dev)
    flush = l2.sum  # reads every line, so nothing dirty is left to write back
    shapes = SHAPES
    if args.head_dims is not None:
        shapes = [(f"{name}_d{d}", b, t, d, full, seed) for d in map(int, args.head_dims.split(","))
                  for name, b, t, full, seed in HEAD_DIM_SHAPES]
    for mode in kv_quant.POOL_MODES:
        for case in shapes:
            for row in run_case(builds, floors, peaks, flush, *case, mode, dev):
                print(json.dumps(row), flush=True)
            torch.cuda.empty_cache()
    print(platform.card_info(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
