"""Where a TorchEngine step spends its time, on one NVIDIA GPU.

    python3 scripts/torch_profile_engine.py [--kv-quantize int8|fp8]

Drives dynamo_tpu_torch's engine directly (no HTTP) with llama3-1b in
bf16, random-init weights from a fixed seed, over a bf16 KV pool or, with
--kv-quantize, a quantized one: BATCH greedy requests of
PROMPT random tokens each and MAX_TOKENS output tokens, `decode_steps`
DECODE_STEPS. Prints JSON lines:
  - `steps`: per step kind, the count and the mean wall ms (host clock
    around `engine.step()`, which ends in a host sync), output tok/s and
    the engine's own metrics;
  - `forward`: one decode forward at the batch, host ms to enqueue it
    (no sync) against device ms (CUDA events), and the number of CUDA
    kernels it launches (torch.profiler);
  - `profile`: torch.profiler over two steady decode dispatches: device
    busy ms (sum of kernel time) against the window's wall ms, the idle
    share, and the ten kernels with the most device time;
  - `chunked`: one greedy request whose LONG_PROMPT tokens prefill in
    chunks of PREFILL_CHUNK (the CLI's default): its time to first token
    and each chunk step's wall ms (host clock, synced after every step),
    after one warm-up request; then the same request under torch.profiler:
    device busy ms, the idle share, and the ten kernels with the most
    device time.
With no card it raises.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from dynamo_tpu_torch import platform  # noqa: E402
from dynamo_tpu_torch.engine.config import EngineConfig  # noqa: E402
from dynamo_tpu_torch.engine.engine import TorchEngine  # noqa: E402
from dynamo_tpu_torch.engine.request import SamplingParams  # noqa: E402

MODEL, BATCH, PROMPT, MAX_TOKENS, DECODE_STEPS = "llama3-1b", 8, 128, 128, 8
PREFILL_CHUNK, LONG_PROMPT = 512, 3000


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kv-quantize", default=None, choices=("int8", "fp8"), dest="kv_quantize",
                    help="quantize the KV pages (the CLI's flag)")
    args = ap.parse_args(argv)
    dev = platform.resolve_device("cuda")
    card = platform.card_info()
    cfg = EngineConfig(model=MODEL, num_pages=256, page_size=64, max_pages_per_seq=64,
                       prefill_chunk=PREFILL_CHUNK, max_seqs=64, decode_steps=DECODE_STEPS,
                       kv_quantize=args.kv_quantize, eos_token_ids=(0,))
    eng = TorchEngine(cfg, device=dev)
    gen = torch.Generator().manual_seed(0)

    def add_batch(tag: str):
        for i in range(BATCH):
            prompt = torch.randint(1, eng.adapter.vocab_size, (PROMPT,), generator=gen)
            eng.add_request(f"{tag}{i}", prompt.tolist(),
                            SamplingParams(max_tokens=MAX_TOKENS, ignore_eos=True))

    # warm-up wave (first cuBLAS calls, kernel builds), then the timed wave
    add_batch("warm")
    eng.run_to_completion()
    # count the timed wave only (the pool's gauges stay)
    eng.metrics = type(eng.metrics)(
        kv_pool_bytes=eng.metrics.kv_pool_bytes,
        kv_pool_bytes_dense_equiv=eng.metrics.kv_pool_bytes_dense_equiv,
    )
    add_batch("r")
    per_kind: dict[str, list[float]] = {}
    tokens = 0
    t_all = time.perf_counter()
    while eng.has_work:
        kind = "prefill" if eng.scheduler.waiting else "decode"
        t0 = time.perf_counter()
        outs = eng.step()
        per_kind.setdefault(kind, []).append((time.perf_counter() - t0) * 1e3)
        tokens += sum(len(o.new_token_ids) for o in outs)
    wall = time.perf_counter() - t_all
    emit({"phase": "steps", "card": card, "model": MODEL, "kv_quantize": args.kv_quantize,
          "batch": BATCH,
          "prompt": PROMPT, "max_tokens": MAX_TOKENS, "decode_steps": DECODE_STEPS,
          "output_tokens": tokens, "wall_s": wall, "tok_s": tokens / wall,
          "by_kind": {k: {"count": len(v), "mean_ms": sum(v) / len(v)}
                      for k, v in per_kind.items()},
          "engine_metrics": eng.metrics.to_dict()})

    # one decode forward: host enqueue time against device time
    b = BATCH
    tok = torch.ones((b, 1), dtype=torch.long, device=dev)
    pos = torch.full((b, 1), PROMPT, dtype=torch.int32, device=dev)
    valid = torch.ones((b, 1), dtype=torch.bool, device=dev)
    pt = torch.arange(1, 1 + b * 4, dtype=torch.int32, device=dev).reshape(b, 4)

    def forward():
        h, _ = eng.adapter.forward_hidden(eng.params, tok, pos, valid, eng.kv, pt)
        return eng.adapter.compute_logits(eng.params, h[:, -1]).argmax(-1)

    with torch.no_grad():
        for _ in range(3):
            forward()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        for _ in range(10):
            forward()
        host_ms = (time.perf_counter() - t0) * 1e3 / 10
        end.record()
        torch.cuda.synchronize()
        wall_ms = start.elapsed_time(end) / 10
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            forward()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        dev_ms = sum(e.device_time for e in kernels) / 1e3
    emit({"phase": "forward", "batch": b, "host_enqueue_ms": host_ms,
          "events_ms": wall_ms, "device_kernel_ms": dev_ms, "cuda_kernels": len(kernels)})

    # two steady decode dispatches under the profiler
    add_batch("p")
    while eng.scheduler.waiting or any(r.state.value == "prefill" for r in eng.scheduler.running):
        eng.step()
    eng.step()  # one decode dispatch outside the window
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        eng.step()
        eng.step()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    emit({"phase": "profile", **device_time(prof, window_ms)})
    eng.run_to_completion()

    # one long prompt, prefilled in chunks
    long_prompt = torch.randint(1, eng.adapter.vocab_size, (LONG_PROMPT,), generator=gen)

    def long_request(rid: str):
        eng.add_request(rid, long_prompt.tolist(), SamplingParams(max_tokens=1, ignore_eos=True))
        steps_ms = []
        t_all = time.perf_counter()
        while eng.has_work:
            t0 = time.perf_counter()
            eng.step()
            torch.cuda.synchronize()
            steps_ms.append((time.perf_counter() - t0) * 1e3)
        return (time.perf_counter() - t_all) * 1e3, steps_ms

    long_request("long-warm")
    ttft_ms, steps_ms = long_request("long")
    with torch.profiler.profile(activities=acts) as prof:
        window_ms, _ = long_request("long-prof")
    emit({"phase": "chunked", "prompt": LONG_PROMPT, "prefill_chunk": PREFILL_CHUNK,
          "ttft_ms": ttft_ms, "chunk_step_ms": steps_ms, **device_time(prof, window_ms)})
    print(card, flush=True)
    return 0


def device_time(prof, window_ms: float) -> dict:
    """Device busy ms (sum of kernel time) in a profiled window, its idle
    share, and the ten kernels with the most device time."""
    busy = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0:
            busy[e.key] = busy.get(e.key, 0.0) + e.self_device_time_total / 1e3
    total = sum(busy.values())
    top = sorted(busy.items(), key=lambda kv: -kv[1])[:10]
    return {"window_ms": window_ms, "device_busy_ms": total,
            "idle_share": 1.0 - total / window_ms,
            "top_kernels_ms": [[k[:80], v] for k, v in top]}


if __name__ == "__main__":
    sys.exit(main())
