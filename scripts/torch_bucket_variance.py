"""Batch-shape numerics of the llama3-1b forward on the card, and what they
do to draft-model streams across the mixed-steps toggle.

1. One row's logits when it rides in decode buckets of 1, 4 and 8 (the
   other rows other tokens over the same history length), for a decode
   step (T=1) and a verify window (T=5): the largest |delta logit| between
   buckets, and the share of that row's positions whose top-2 gap is no
   larger than it (where a greedy pick may flip).
2. A self-draft engine (--spec-draft llama3-1b, no cooldown, eager,
   overlap off) with mixed steps on and off, over two workloads: one row
   decoding that a 300-token prompt joins after three steps, and five
   greedy rows and a seeded sampled row that the same prompt joins. With
   the default decode buckets (1, 2, 4, 8) the toggle changes which rows
   share a dispatch and so a row's bucket; with one bucket (8,) it does
   not. For each, whether the streams are equal, and where they part,
   the decode batch sizes of each toggle's dispatches up to there.

Usage (one card; prints one JSON object a line):
    python3 scripts/torch_bucket_variance.py
"""
from __future__ import annotations

import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dynamo_tpu_torch.engine.config import EngineConfig  # noqa: E402
from dynamo_tpu_torch.engine.engine import TorchEngine  # noqa: E402
from dynamo_tpu_torch.engine.request import SamplingParams  # noqa: E402
from dynamo_tpu_torch.models import llama  # noqa: E402
from dynamo_tpu_torch.models.registry import get_model  # noqa: E402

HIST, S = 100, 4


def row_in_buckets(adapter, params, dev) -> list[dict]:
    """Part 1: row 0's logits at buckets 1, 4 and 8."""
    cfg = adapter.config
    out = []
    with torch.no_grad():
        for t in (1, S + 1):
            logits = {}
            for b in (1, 4, 8):
                gen = torch.Generator().manual_seed(11)
                pool = adapter.init_kv(1 + 8 * 4, 64, dev)
                pt = (1 + torch.arange(32, dtype=torch.int32, device=dev)).reshape(8, 4)[:b]
                prompt = torch.randint(1, 128000, (8, 128), generator=gen).to(dev)[:b]
                pos = torch.arange(128, dtype=torch.int32, device=dev)[None].expand(b, 128)
                _, pool = llama.forward(params, cfg, prompt.contiguous(), pos.contiguous(),
                                        (pos < HIST).contiguous(), pool, pt.contiguous(),
                                        first_chunk=True)
                win = torch.randint(1, 128000, (8, t), generator=gen).to(dev)[:b].contiguous()
                wpos = (HIST + torch.arange(t, dtype=torch.int32, device=dev))[None]
                lg, _ = llama.forward(params, cfg, win, wpos.expand(b, t).contiguous(),
                                      torch.ones((b, t), dtype=torch.bool, device=dev), pool,
                                      pt.contiguous(), write_run=1 if t > 1 else None)
                logits[b] = lg[0].float()
            d = max((logits[4] - logits[1]).abs().max().item(),
                    (logits[8] - logits[1]).abs().max().item())
            top = torch.topk(logits[1], 2, dim=-1).values
            gap = top[:, 0] - top[:, 1]
            out.append({"part": "row_in_buckets", "t": t,
                        "b4_vs_b1": (logits[4] - logits[1]).abs().max().item(),
                        "b8_vs_b1": (logits[8] - logits[1]).abs().max().item(),
                        "b8_vs_b4": (logits[8] - logits[4]).abs().max().item(),
                        "top2_gaps_at_b1": gap.tolist(),
                        "positions_within_delta": int((gap <= d).sum())})
    return out


def workload(eng: TorchEngine, sampled: bool) -> dict[str, list[int]]:
    """One decoding row (or five greedy rows and a seeded sampled one); a
    300-token prompt joins after three steps."""
    gen = torch.Generator().manual_seed(6)
    draw = lambda n: torch.randint(1, 128_000, (n,), generator=gen).tolist()  # noqa: E731
    greedy = dict(max_tokens=24, ignore_eos=True)
    if sampled:
        for i in range(5):
            eng.add_request(f"w{i}", draw(40 + 7 * i), SamplingParams(**greedy))
        eng.add_request("s", draw(33), SamplingParams(max_tokens=20, ignore_eos=True,
                                                      temperature=0.7, top_p=0.9, seed=3))
    else:
        eng.add_request("w", draw(40), SamplingParams(**greedy))
    out: dict[str, list[int]] = {}
    for _ in range(3):
        for o in eng.step():
            out.setdefault(o.request_id, []).extend(o.new_token_ids)
    eng.add_request("late", draw(300), SamplingParams(max_tokens=6, ignore_eos=True))
    for rid, ids in eng.run_to_completion().items():
        out.setdefault(rid, []).extend(ids)
    return out


def toggle(params, buckets, sampled: bool) -> dict:
    """Part 2: one workload with mixed steps on and off."""
    runs = {}
    for mixed in (True, False):
        cfg = EngineConfig(model="llama3-1b", num_pages=96, page_size=64, max_pages_per_seq=8,
                           decode_buckets=buckets, max_seqs=8, eos_token_ids=(0,),
                           enable_prefix_caching=False, mixed_steps=mixed, prefill_chunk=128,
                           overlap_decode=False, spec_draft_model="llama3-1b",
                           spec_min_accept_rate=0.0)
        eng = TorchEngine(cfg, params=params, device="cuda", cuda_graphs=False)
        batches: list[list[str]] = []
        run = eng._run_decode_spec_draft

        def record(reqs, run=run, batches=batches):
            batches.append([r.request_id for r in reqs])
            return run(reqs)
        eng._run_decode_spec_draft = record
        runs[mixed] = (workload(eng, sampled), batches, eng.metrics.mixed_dispatches)
        del eng
        torch.cuda.empty_cache()
    (a, ba, ma), (b, bb, mb) = runs[True], runs[False]
    line = {"part": "mixed_toggle", "decode_buckets": list(buckets),
            "workload": "five greedy, one sampled" if sampled else "one row",
            "mixed_dispatches": [ma, mb], "equal": a == b}
    for rid in sorted(a):
        if a[rid] != b.get(rid):
            k = next((i for i, (x, y) in enumerate(zip(a[rid], b[rid])) if x != y),
                     min(len(a[rid]), len(b[rid])))
            line.setdefault("parted", []).append({
                "row": rid, "at_token": k,
                "batch_sizes_on": [len(x) for x in ba if rid in x],
                "batch_sizes_off": [len(x) for x in bb if rid in x]})
    return line


def main() -> int:
    dev = torch.device("cuda", 0)
    adapter = get_model("llama3-1b")
    params = adapter.init_params(torch.Generator(device=dev).manual_seed(0))
    for line in row_in_buckets(adapter, params, dev):
        print(json.dumps(line), flush=True)
    for buckets in ((1, 2, 4, 8), (8,)):
        for sampled in (False, True):
            print(json.dumps(toggle(params, buckets, sampled)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
