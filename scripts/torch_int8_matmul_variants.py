"""Builds of the int8 weight product against each other, torch.matmul on a
bf16 weight and the card's bound, on one NVIDIA GPU.

    python3 scripts/torch_int8_matmul_variants.py [--source NAME=PATH ...]

One JSON line per (M, K, N) of chip_smoke.INT8_CASES (llama3-1b's and
llama3-8b's dense widths at a decode row, bucket 64 and a 2,048-token
chunk): `device_ms` of each build (the package's wrapper for `committed`,
each `--source` build called through the same C entry with the committed
split plan) in the order A B ..., then again reversed; the row error
against the plain version; `library_device_ms` (torch.matmul on a bf16
weight of the same shape, twice the bytes); `bound_ms` and its `by`; the
split plan. An earlier design is taken from a `git archive` of its
commit's csrc/ and compiled where it lies. To set one design's own split
plan against another's, run the script in each tree, in the order A B B A.
Then the card's name and power limit. With no card it raises.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from dynamo_tpu_torch import platform  # noqa: E402
from dynamo_tpu_torch.models.llama import quantize_channelwise_int8  # noqa: E402
from dynamo_tpu_torch.ops import _build, int8_matmul  # noqa: E402


def variant_call(lib, x, w, scale, plan):
    """A build's dyn_int8_matmul on (x, w, scale) under `plan`; the caller
    keeps the returned tensors alive until the launch has run."""
    fn = _build.entry(lib, "dyn_int8_matmul", int8_matmul.ARGTYPES)
    m, k = x.shape
    n = w.shape[1]
    mi, splits, per = plan
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    partials = torch.empty((splits, m, n), dtype=torch.float32, device=x.device)

    def call():
        _build.check(fn(x.data_ptr(), w.data_ptr(), scale.data_ptr(), out.data_ptr(),
                        partials.data_ptr(), m, k, n, mi, splits, per,
                        _build.stream(x.device)), "int8_matmul variant")
        return out

    return call


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[],
                    help="NAME=PATH of another int8_matmul.cu to build and time")
    args = ap.parse_args(argv)
    dev = platform.resolve_device("cuda")
    card = platform.card_info()
    peaks = platform.device_peaks(torch.cuda.get_device_name(0))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    srcs = _build.variant_sources("int8_matmul", args.source)
    del srcs["committed"]
    libs = {name: lib for name, (lib, _) in _build.build_variants(
        srcs, Path(_build.BUILD_DIR) / "int8_variants").items()}
    gen = torch.Generator(device=dev)
    for i, (m, k, n) in enumerate(chip_smoke.INT8_CASES):
        gen.manual_seed(20 + i)
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        w, scale = quantize_channelwise_int8(
            torch.randn((k, n), generator=gen, device=dev) / k**0.5)
        plan = int8_matmul.split_plan(m, k, n, sms)
        calls = {"committed": lambda: int8_matmul.int8_matmul(x, w, scale)}
        calls.update({name: variant_call(lib, x, w, scale, plan) for name, lib in libs.items()})
        ref = int8_matmul.int8_matmul_plain(x, w, scale).float()
        errors = {}
        for name, call in calls.items():
            got = call().float()
            torch.cuda.synchronize()
            errors[name] = ((got - ref).abs().amax(dim=-1) / ref.abs().amax(dim=-1)).max().item()
        order = list(calls) + list(calls)[::-1]
        times: dict[str, list[float]] = {name: [] for name in calls}
        for name in order:
            times[name].append(chip_smoke.device_ms(calls[name])[0])
        w_bf16 = (w.float() * scale).to(torch.bfloat16)
        b_ms, by = chip_smoke.bound(int8_matmul.bytes_moved(m, k, n),
                                    int8_matmul.flops(m, k, n), peaks)
        print(json.dumps({
            "M": m, "K": k, "N": n, "plan": list(plan), "order": order,
            "device_ms": times, "max_row_rel_err": errors,
            "library_device_ms": chip_smoke.device_ms(lambda: torch.matmul(x, w_bf16))[0],
            "bound_ms": b_ms, "bound_by": by}), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
