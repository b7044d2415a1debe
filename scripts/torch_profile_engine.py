"""Where a TorchEngine step spends its time, on one NVIDIA GPU: dispatches
run by the eager loop, replayed as captured CUDA graphs, and replayed with
the overlapped decode loop.

    python3 scripts/torch_profile_engine.py [--kv-quantize int8|fp8] [--no-mixed-steps]
    python3 scripts/torch_profile_engine.py --sampling [--kv-quantize int8|fp8]
    python3 scripts/torch_profile_engine.py --quantize int8 [--kv-quantize int8|fp8]
    python3 scripts/torch_profile_engine.py --decode-kstep K [--kv-quantize int8|fp8]
    python3 scripts/torch_profile_engine.py --spec-ngram S [--kv-quantize int8|fp8]
    python3 scripts/torch_profile_engine.py --spec-draft [--spec-draft-tokens S] [--kv-quantize int8|fp8]

Drives dynamo_tpu_torch's engine directly (no HTTP) with llama3-1b in
bf16, random-init weights from a fixed seed, over a bf16 KV pool or, with
--kv-quantize, a quantized one. Five engines share the weights: `eager`
(cuda_graphs=False, overlap_decode=False), `graphs` (prefill and decode
graphs, overlap_decode=False), `overlap` (graphs and overlapped decode,
the defaults, mixed steps among them), `xor` (`overlap` with mixed
steps off, --no-mixed-steps) and `uncached` (`overlap` with prefix
caching off). All but `uncached` cache prefixes, as the defaults do; the waves' random prompts
share no page, so caching costs them its host work (hashing, registering
pages) and saves nothing. A wave is B greedy requests of PROMPT random tokens each and
MAX_TOKENS output tokens, `decode_steps` DECODE_STEPS. Prints JSON lines:
  - `wave`, for B in BATCHES, ten waves in the order eager, graphs,
    overlap, xor, uncached, uncached, xor, overlap, graphs, eager, after
    one untimed wave on each engine
    (kernel builds, cuBLAS, the graph captures), and before any
    torch.profiler session in the process (a wave of 64 prefills in four
    steps of the 2,048-token budget under --no-mixed-steps; with mixed
    steps the rows that have finished theirs decode beside the rest, and
    once 33 rows decode, in the largest bucket, one prompt a step fits
    beside them): output tok/s over the wave and
    over its decode steps, host ms per decode dispatch (wall ms of a decode
    step less its wait for the ids, the engine's time_decode_ms and
    time_decode_sync_ms; under overlap it holds the speculated dispatch's
    host work), wall ms per decode step (host clock around
    `engine.step()`) and each decode step's, and the engine's metrics;
  - `burst`, mixed steps on (`overlap`) against off (`xor`): chip_smoke's
    run_burst, a greedy wave of 32 rows joined by prompts of 3,000, 700
    and 700 tokens once every row has 24 tokens, once untimed on each
    engine, then in the order mixed, xor, xor, mixed, also before any
    profiler session: the wave rows' largest host gap between token
    deliveries over the burst and the p95 of the delivering steps' gaps,
    the burst prompts' synced TTFT, the wave's tok/s and the dispatch
    counts;
  - `dispatch`, per engine and B: torch.profiler over two steady decode
    steps, from a synced device (a speculated dispatch made before ends
    before the window) to a sync after them: device busy ms per step (sum
    of kernel time) against the window's wall ms, the idle share, CUDA
    kernels per forward, and the ten kernels with the most device time;
  - `forward`: one eager decode forward at B=8, host ms to enqueue it
    (no sync) against device ms (CUDA events), and the number of CUDA
    kernels it launches (torch.profiler);
  - `chunked`, for the `eager` and `graphs` engines: one greedy request
    whose LONG_PROMPT tokens prefill in chunks of PREFILL_CHUNK (the CLI's
    default), after one warm-up request (builds and captures), each run
    after clear_cache() so that none hits the last one's pages: its time to
    first token (host clock from adding it to its first token, no other
    sync), then the same request with a sync after every step (each chunk
    step's wall ms), then under torch.profiler with no sync but the first
    token's: device busy ms against the time to that token, the idle
    share, and the ten kernels with the most device time.
With --no-mixed-steps every engine runs the XOR policy (the engines and
lines of the tree before mixed steps were ported): no `xor` engine and
no `burst` lines.

With --sampling only the sampling surface's case runs, on one engine at
the defaults (`overlap`): waves whose rows all ask for one of
chip_smoke.SAMPLING_KEYS (plain; logprobs 20; frequency, presence and
repetition penalties; logit_bias), at each B in BATCHES, each key once
untimed (its captures), then `sampling` lines in the order plain, lp20,
pen, bias, bias, pen, lp20, plain: host, sync and wall ms per decode
dispatch and per fused step (every dispatch here runs DECODE_STEPS
steps; a penalized wave does not speculate, so its wall holds its
device time); then `sampling_dispatch` lines, torch.profiler over two
steady decode dispatches of each key: device busy ms per dispatch and per
step, the idle share and the ten kernels with the most device time.

With --quantize int8 only the weights' case runs: int8 weights (the
CLI's --quantize int8) against bf16 weights, each on one engine at the
defaults (`overlap`), the int8 one quantizing the bf16 one's weights.
On llama3-1b, for B in BATCHES, one untimed wave on each, then `weights`
lines in the order bf16, int8, int8, bf16; then on llama3-8b (bf16
weights drawn from seed 0, then quantized), B=64 only, the same. Then
`weights_dispatch` lines, torch.profiler over two steady decode
dispatches of each engine and B: device ms per decode step, the idle
share, CUDA kernels per forward and the ten kernels with the most device
time.

With --decode-kstep K only the windows' case runs: the defaults
(`overlap`: K=8 fused steps, overlapped decode, mixed steps, prefix
caching) against the same engine with K-step windows of up to K decode
iterations (the CLI's --decode-kstep K), on one set of weights. For B in
BATCHES, one untimed wave on each (its captures: `compiles` and
`compile_ms` print in a `kstep_captures` line), then `kstep` lines in the
order defaults, kstep, kstep, defaults (as `wave`, with the window
counts); then `kstep_dispatch` lines, torch.profiler over two steady
decode dispatches of each engine and B: device ms per decode iteration
(a window's frozen steps included), the idle share, CUDA kernels per
forward and the ten kernels with the most device time; then `noise`
lines: host ms of the Gumbel noise a sampled dispatch makes
(engine/sampling.py gumbel_noise, one generator seed a row and step) at
K in (DECODE_STEPS, K) and B in BATCHES, the mean of five calls.

With --spec-ngram S only prompt lookup's case runs: the defaults
(`overlap`) against the same engine with the CLI's --spec-ngram S
(`spec`: overlapped decode and mixed steps off under it, the acceptance
cooldown on) and that engine with spec_min_accept_rate 0 (`always`: every
eligible decode dispatch verifies), on one set of weights, over two
prompt sets: `repeat`, each prompt a random block of PROMPT / 4 tokens
said four times (the case prompt lookup is for: code edits, quoting a
document), and `plain`, random prompts that do not repeat (where the
cooldown should engage). For B in BATCHES, one untimed wave of each set
on each engine (its captures: `compiles`, `compile_ms` and the verify
keys print in a `spec_captures` line, with the f32 logits bytes a verify
key's graph holds, B x (S + 1) x vocab x 4, computed from the shapes),
then `spec` lines for each set in the order defaults, spec, always,
always, spec, defaults (as `wave`, with the drafts, the accepted ones,
the acceptance rate, the cooldown and ineligible skips, and the host ms
a verify dispatch spends on its drafts, arrays and accept scan); then
`spec_dispatch` lines, torch.profiler over two steady decode dispatches
of `defaults` and `always` at each B over the repeating set: device ms
per dispatch and per forward (a verify is one forward of S + 1 tokens a
row), the idle share, CUDA kernels per forward and the ten kernels with
the most device time.

With --spec-draft only the draft model's case runs: the defaults
(`defaults`) against the CLI's --spec-draft llama3-draft (`draft`: random
draft weights, so acceptance sits at chance and the cooldown engages) and
--spec-draft llama3-1b (`self`: the target drafts for itself, so greedy
drafts are accepted where the verify's bf16 argmax agrees), each with
--spec-draft-tokens S (4) and the CLI's other defaults (overlap, mixed
steps, the cooldown), on one set of target weights, over random prompts.
For B in BATCHES, two untimed waves on each engine (the captures: a
draft-model engine captures the plain keys only once a cooldown has run;
they print in a `draft_captures` line: `compiles`, `compile_ms`, the
spec_fused and draft chunk keys), then `draft` lines in the order
defaults, draft, self, self, draft, defaults (as `wave`, with the drafts,
the accepted ones, the acceptance rate, the tokens a row a draft-model
dispatch emits, 1 + S x accepted / drafted, and the cooldown skips: a
wave's last dispatch, whose rows finish inside their windows, accepts
few drafts and may start a cooldown that the next wave pays); then
`draft_dispatch` lines, torch.profiler over two steady decode dispatches
of `defaults`, of `always` (`self` with spec_min_accept_rate 0, so that
no cooldown makes them plain) and of `draft_always` (`draft` so) at each
B (as `spec_dispatch`).

Then the card's name and power limit. With no card it raises.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from dataclasses import replace
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from dynamo_tpu_torch import platform  # noqa: E402
from dynamo_tpu_torch.engine.config import EngineConfig  # noqa: E402
from dynamo_tpu_torch.engine.engine import TorchEngine  # noqa: E402
from dynamo_tpu_torch.engine.request import SamplingParams  # noqa: E402
from dynamo_tpu_torch.engine.sampling import DEFAULT_K_CAP, gumbel_noise  # noqa: E402

MODEL, PROMPT, MAX_TOKENS, DECODE_STEPS = "llama3-1b", 128, 128, 8
#: the decode batches timed: 8, and 64, the largest decode bucket
BATCHES = (8, 64)
PREFILL_CHUNK, LONG_PROMPT = 512, 3000
ACTS = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def add_wave(eng: TorchEngine, tag: str, batch: int, gen: torch.Generator,
             knobs: dict | None = None, repeat: int = 1) -> None:
    """`batch` greedy requests of random prompts, each with the sampling
    `knobs`; with `repeat` > 1 each prompt is a random block of PROMPT //
    repeat tokens said `repeat` times."""
    for i in range(batch):
        prompt = torch.randint(1, eng.adapter.vocab_size, (PROMPT // repeat,),
                               generator=gen).repeat(repeat)
        eng.add_request(f"{tag}{i}", prompt.tolist(),
                        SamplingParams(max_tokens=MAX_TOKENS, ignore_eos=True, **(knobs or {})))


def timed_wave(eng: TorchEngine, tag: str, batch: int, gen: torch.Generator,
               knobs: dict | None = None, repeat: int = 1) -> dict:
    """One wave from an idle engine, counted on its own."""
    before = eng.metrics.to_dict()
    add_wave(eng, tag, batch, gen, knobs, repeat)
    decode_ms, tokens, decode_tokens = [], 0, 0
    # the engine's decode step time and its wait for ids, over the decode
    # steps alone (a mixed step's decode half waits for ids too)
    step_ms = sync_ms = 0.0
    t_all = time.perf_counter()
    while eng.has_work:
        decode = not eng.scheduler.waiting and all(
            r.state.value != "prefill" for r in eng.scheduler.running)
        m0 = (eng.metrics.time_decode_ms, eng.metrics.time_decode_sync_ms)
        t0 = time.perf_counter()
        outs = eng.step()
        n = sum(len(o.new_token_ids) for o in outs)
        tokens += n
        if decode:
            decode_ms.append((time.perf_counter() - t0) * 1e3)
            decode_tokens += n
            step_ms += eng.metrics.time_decode_ms - m0[0]
            sync_ms += eng.metrics.time_decode_sync_ms - m0[1]
    wall = time.perf_counter() - t_all
    m = {k: v - before[k] for k, v in eng.metrics.to_dict().items()}
    n = m["decode_dispatches"]
    return {"output_tokens": tokens, "wall_s": wall, "tok_s": tokens / wall,
            "decode_tok_s": decode_tokens / (sum(decode_ms) / 1e3),
            "decode_dispatches": n, "decode_steps_run": m["decode_steps_run"],
            "host_ms_per_dispatch": (step_ms - sync_ms) / n,
            "wall_ms_per_dispatch": sum(decode_ms) / len(decode_ms),
            "decode_step_ms": decode_ms,
            "sync_ms_per_dispatch": sync_ms / n,
            **{k: m[k] for k in ("compiles", "decode_replays", "prefill_replays",
                                 "mixed_dispatches", "mixed_replays", "overlap_dispatches",
                                 "overlap_hits", "overlap_rollbacks", "kstep_windows",
                                 "kstep_steps", "spec_drafted", "spec_accepted",
                                 "spec_skipped_cooldown", "spec_skipped_ineligible",
                                 "time_spec_host_ms")}}


def profile_dispatches(eng: TorchEngine, batch: int, gen: torch.Generator,
                       knobs: dict | None = None, repeat: int = 1) -> dict:
    """Two steady decode dispatches of a wave under torch.profiler."""
    add_wave(eng, "p", batch, gen, knobs, repeat)
    while eng.scheduler.waiting or any(r.state.value == "prefill" for r in eng.scheduler.running):
        eng.step()
    eng.step()  # one decode dispatch outside the window
    steps = eng.metrics.decode_steps_run
    with torch.profiler.profile(activities=ACTS) as prof:
        # a speculated dispatch made before the window ends before it, so
        # the window holds two dispatches' device work with overlap too
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.step()
        eng.step()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    forwards = eng.metrics.decode_steps_run - steps
    kernels = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
    eng.run_to_completion()
    out = device_time(prof, window_ms)
    return {**out, "device_ms_per_dispatch": out["device_busy_ms"] / 2, "forwards": forwards,
            "device_ms_per_step": out["device_busy_ms"] / forwards,
            "cuda_kernels_per_forward": kernels / forwards}


def sampling_case(dev, card: str, args) -> None:
    """The sampling surface's keys on one engine at the defaults: timed
    waves, then profiled dispatches (the module's --sampling)."""
    cfg = EngineConfig(model=MODEL, num_pages=320, page_size=64, max_pages_per_seq=64,
                       prefill_chunk=PREFILL_CHUNK, max_seqs=64, decode_steps=DECODE_STEPS,
                       kv_quantize=args.kv_quantize, eos_token_ids=(0,))
    eng = TorchEngine(cfg, device=dev)
    gen = torch.Generator().manual_seed(0)
    keys = chip_smoke.SAMPLING_KEYS
    head = {"card": card, "model": MODEL, "kv_quantize": args.kv_quantize, "prompt": PROMPT,
            "max_tokens": MAX_TOKENS, "decode_steps": DECODE_STEPS}
    for b in BATCHES:
        for name, knobs in keys.items():
            timed_wave(eng, f"warm-{name}{b}-", b, gen, knobs)
        for i, name in enumerate(list(keys) + list(keys)[::-1]):
            r = timed_wave(eng, f"{name}{b}-{i}-", b, gen, keys[name])
            per_step = {f"{k[:-len('_per_dispatch')]}_per_step": r[k] / DECODE_STEPS
                        for k in ("host_ms_per_dispatch", "sync_ms_per_dispatch",
                                  "wall_ms_per_dispatch")}
            emit({"phase": "sampling", **head, "batch": b, "key": name, "knobs": repr(keys[name]),
                  "order": i, **r, **per_step})
    for b in BATCHES:
        for name, knobs in keys.items():
            emit({"phase": "sampling_dispatch", **head, "batch": b, "key": name,
                  **profile_dispatches(eng, b, gen, knobs)})


def quantize_case(dev, card: str, args) -> None:
    """int8 weights against bf16 weights (the module's --quantize)."""
    for model, batches in ((MODEL, BATCHES), ("llama3-8b", (64,))):
        cfg = EngineConfig(model=model, num_pages=320, page_size=64, max_pages_per_seq=64,
                           prefill_chunk=PREFILL_CHUNK, max_seqs=64, decode_steps=DECODE_STEPS,
                           kv_quantize=args.kv_quantize, eos_token_ids=(0,))
        bf16 = TorchEngine(cfg, device=dev)
        engines = {"bf16": bf16, args.quantize: TorchEngine(replace(cfg, quantize=args.quantize),
                                                            params=bf16.params, device=dev)}
        gen = torch.Generator().manual_seed(0)
        head = {"card": card, "model": model, "kv_quantize": args.kv_quantize, "prompt": PROMPT,
                "max_tokens": MAX_TOKENS, "decode_steps": DECODE_STEPS,
                "param_bytes": {k: chip_smoke.param_bytes(e.params)[0]
                                for k, e in engines.items()}}
        for b in batches:
            for name, eng in engines.items():
                timed_wave(eng, f"warm-{name}{b}-", b, gen)
            for i, name in enumerate(("bf16", args.quantize, args.quantize, "bf16")):
                emit({"phase": "weights", **head, "batch": b, "weights": name, "order": i,
                      **timed_wave(engines[name], f"{name}{b}-{i}-", b, gen)})
        for b in batches:
            for name, eng in engines.items():
                emit({"phase": "weights_dispatch", **head, "batch": b, "weights": name,
                      **profile_dispatches(eng, b, gen)})
        del bf16, engines
        torch.cuda.empty_cache()


def kstep_case(dev, card: str, args) -> None:
    """The defaults against K-step windows (the module's --decode-kstep)."""
    cfg = EngineConfig(model=MODEL, num_pages=320, page_size=64, max_pages_per_seq=64,
                       prefill_chunk=PREFILL_CHUNK, max_seqs=64, decode_steps=DECODE_STEPS,
                       kv_quantize=args.kv_quantize, eos_token_ids=(0,))
    defaults = TorchEngine(cfg, device=dev)
    engines = {"defaults": defaults,
               "kstep": TorchEngine(replace(cfg, decode_kstep=args.decode_kstep),
                                    params=defaults.params, device=dev)}
    gen = torch.Generator().manual_seed(0)
    head = {"card": card, "model": MODEL, "kv_quantize": args.kv_quantize, "prompt": PROMPT,
            "max_tokens": MAX_TOKENS, "decode_steps": DECODE_STEPS,
            "decode_kstep": args.decode_kstep}
    for b in BATCHES:
        for name, eng in engines.items():
            timed_wave(eng, f"warm-{name}{b}-", b, gen)
    emit({"phase": "kstep_captures", **head,
          **{name: {"compiles": e.metrics.compiles, "compile_ms": e.metrics.compile_ms,
                    "keys": sorted([list(k) for k in e.step_keys], key=str)}
             for name, e in engines.items()}})
    for b in BATCHES:
        for i, name in enumerate(("defaults", "kstep", "kstep", "defaults")):
            emit({"phase": "kstep", **head, "batch": b, "engine": name, "order": i,
                  **timed_wave(engines[name], f"{name}{b}-{i}-", b, gen)})
    for b in BATCHES:
        for name, eng in engines.items():
            emit({"phase": "kstep_dispatch", **head, "batch": b, "engine": name,
                  **profile_dispatches(eng, b, gen)})
    for steps in (DECODE_STEPS, args.decode_kstep):
        for b in BATCHES:
            t0 = time.perf_counter()
            for i in range(5):
                gumbel_noise(range(b), [i] * b, DEFAULT_K_CAP, steps)
            emit({"phase": "noise", "steps": steps, "batch": b, "seeds": steps * b,
                  "host_ms": (time.perf_counter() - t0) * 1e3 / 5})


def verify_replays(eng: TorchEngine) -> int:
    """Replays of the engine's verify graphs so far (its verify dispatches)."""
    return sum(g.replays for k, g in eng._step_fns.items() if k[0] == "spec_verify")


def spec_case(dev, card: str, args) -> None:
    """The defaults against prompt lookup (the module's --spec-ngram)."""
    cfg = EngineConfig(model=MODEL, num_pages=320, page_size=64, max_pages_per_seq=64,
                       prefill_chunk=PREFILL_CHUNK, max_seqs=64, decode_steps=DECODE_STEPS,
                       kv_quantize=args.kv_quantize, eos_token_ids=(0,))
    defaults = TorchEngine(cfg, device=dev)
    spec = replace(cfg, spec_ngram=args.spec_ngram)
    engines = {"defaults": defaults,
               "spec": TorchEngine(spec, params=defaults.params, device=dev),
               "always": TorchEngine(replace(spec, spec_min_accept_rate=0.0),
                                     params=defaults.params, device=dev)}
    gen = torch.Generator().manual_seed(0)
    sets = {"repeat": 4, "plain": 1}
    head = {"card": card, "model": MODEL, "kv_quantize": args.kv_quantize, "prompt": PROMPT,
            "max_tokens": MAX_TOKENS, "decode_steps": DECODE_STEPS,
            "spec_ngram": args.spec_ngram}
    for b in BATCHES:
        for name, eng in engines.items():
            for prompts, repeat in sets.items():
                timed_wave(eng, f"warm-{name}{b}-{prompts}-", b, gen, repeat=repeat)
    vocab = defaults.adapter.vocab_size
    emit({"phase": "spec_captures", **head,
          **{name: {"compiles": e.metrics.compiles, "compile_ms": e.metrics.compile_ms,
                    "verify_keys": sorted([list(k) for k in e.step_keys
                                           if k[0] == "spec_verify"]),
                    "verify_logits_bytes": {k[1]: k[1] * k[2] * vocab * 4
                                            for k in e.step_keys if k[0] == "spec_verify"}}
             for name, e in engines.items()}})
    for b in BATCHES:
        for prompts, repeat in sets.items():
            order = ("defaults", "spec", "always", "always", "spec", "defaults")
            for i, name in enumerate(order):
                n0 = verify_replays(engines[name])
                r = timed_wave(engines[name], f"{name}{b}-{prompts}-{i}-", b, gen, repeat=repeat)
                verifies = verify_replays(engines[name]) - n0
                emit({"phase": "spec", **head, "batch": b, "prompts": prompts, "engine": name,
                      "order": i, **r, "verify_dispatches": verifies,
                      "accept_rate": (r["spec_accepted"] / r["spec_drafted"]
                                      if r["spec_drafted"] else None),
                      "spec_host_ms_per_verify": (r["time_spec_host_ms"] / verifies
                                                  if verifies else None)})
    for b in BATCHES:
        for name in ("defaults", "always"):
            emit({"phase": "spec_dispatch", **head, "batch": b, "engine": name,
                  "prompts": "repeat", **profile_dispatches(engines[name], b, gen, repeat=4)})


def draft_case(dev, card: str, args) -> None:
    """The defaults against draft-model speculation (the module's
    --spec-draft)."""
    cfg = EngineConfig(model=MODEL, num_pages=320, page_size=64, max_pages_per_seq=64,
                       prefill_chunk=PREFILL_CHUNK, max_seqs=64, decode_steps=DECODE_STEPS,
                       kv_quantize=args.kv_quantize, eos_token_ids=(0,))
    defaults = TorchEngine(cfg, device=dev)
    s = args.spec_draft_tokens
    engines = {"defaults": defaults}
    for name, draft in (("draft", "llama3-draft"), ("self", MODEL)):
        engines[name] = TorchEngine(replace(cfg, spec_draft_model=draft, spec_draft_tokens=s),
                                    params=defaults.params, device=dev)
    # no-cooldown twins for the profiles: every decode dispatch speculates
    twins = {label: TorchEngine(replace(engines[name].config, spec_min_accept_rate=0.0),
                                params=defaults.params, device=dev)
             for label, name in (("always", "self"), ("draft_always", "draft"))}
    gen = torch.Generator().manual_seed(0)
    head = {"card": card, "model": MODEL, "kv_quantize": args.kv_quantize, "prompt": PROMPT,
            "max_tokens": MAX_TOKENS, "decode_steps": DECODE_STEPS, "spec_draft_tokens": s}
    for b in BATCHES:
        for name, eng in engines.items():
            for w in range(2):
                timed_wave(eng, f"warm{w}-{name}{b}-", b, gen)
    emit({"phase": "draft_captures", **head,
          **{name: {"compiles": e.metrics.compiles, "compile_ms": e.metrics.compile_ms,
                    "kv_pool_bytes": e.metrics.kv_pool_bytes,
                    "spec_fused_keys": sorted([list(k) for k in e.step_keys
                                               if k[0] == "spec_fused"]),
                    "draft_prefill_keys": sorted([list(k) for k in e.step_keys
                                                  if k[0] == "spec_draft_prefill"])}
             for name, e in engines.items()}})
    for b in BATCHES:
        order = ("defaults", "draft", "self", "self", "draft", "defaults")
        for i, name in enumerate(order):
            r = timed_wave(engines[name], f"{name}{b}-{i}-", b, gen)
            drafted = r["spec_drafted"]
            emit({"phase": "draft", **head, "batch": b, "engine": name, "order": i, **r,
                  "accept_rate": r["spec_accepted"] / drafted if drafted else None,
                  "tokens_a_row_a_dispatch": (1 + s * r["spec_accepted"] / drafted
                                              if drafted else None)})
    for b in BATCHES:
        for name, eng in (("defaults", defaults), *twins.items()):
            emit({"phase": "draft_dispatch", **head, "batch": b, "engine": name,
                  **profile_dispatches(eng, b, gen)})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kv-quantize", default=None, choices=("int8", "fp8"), dest="kv_quantize",
                    help="quantize the KV pages (the CLI's flag)")
    ap.add_argument("--no-mixed-steps", action="store_false", dest="mixed_steps",
                    help="mixed steps off in every engine (the CLI's flag): no `xor` engine "
                         "and no `burst` lines")
    ap.add_argument("--sampling", action="store_true",
                    help="only the sampling surface's case: plain, lp20, pen and bias keys")
    ap.add_argument("--quantize", default=None, choices=("int8",),
                    help="only the weights' case: int8 weights (the CLI's flag) against bf16 "
                         "weights on llama3-1b and llama3-8b")
    ap.add_argument("--decode-kstep", type=int, default=1, dest="decode_kstep",
                    help="only the windows' case: the defaults against K-step windows of up "
                         "to K iterations (the CLI's flag)")
    ap.add_argument("--spec-ngram", type=int, default=0, dest="spec_ngram",
                    help="only prompt lookup's case: the defaults against --spec-ngram S (the "
                         "CLI's flag), and against it with the cooldown off")
    ap.add_argument("--spec-draft", action="store_true", dest="spec_draft",
                    help="only the draft model's case: the defaults against --spec-draft "
                         "llama3-draft and against a self-draft (the CLI's flag)")
    ap.add_argument("--spec-draft-tokens", type=int, default=4, dest="spec_draft_tokens",
                    help="drafts a draft-model dispatch proposes (the CLI's flag)")
    args = ap.parse_args(argv)
    dev = platform.resolve_device("cuda")
    card = platform.card_info()
    case = (quantize_case if args.quantize else sampling_case if args.sampling
            else kstep_case if args.decode_kstep > 1 else spec_case if args.spec_ngram > 0
            else draft_case if args.spec_draft else None)
    if case is not None:
        case(dev, card, args)
        print(card, flush=True)
        return 0
    # the largest wave holds 64 x (PROMPT + MAX_TOKENS) tokens: 256 pages
    cfg = EngineConfig(model=MODEL, num_pages=320, page_size=64, max_pages_per_seq=64,
                       prefill_chunk=PREFILL_CHUNK, max_seqs=64, decode_steps=DECODE_STEPS,
                       kv_quantize=args.kv_quantize, mixed_steps=args.mixed_steps,
                       eos_token_ids=(0,))
    eager = TorchEngine(replace(cfg, overlap_decode=False), device=dev, cuda_graphs=False)
    engines = {"eager": eager,
               "graphs": TorchEngine(replace(cfg, overlap_decode=False), params=eager.params,
                                     device=dev),
               "overlap": TorchEngine(cfg, params=eager.params, device=dev),
               "xor": TorchEngine(replace(cfg, mixed_steps=False), params=eager.params,
                                  device=dev),
               "uncached": TorchEngine(replace(cfg, enable_prefix_caching=False),
                                       params=eager.params, device=dev)}
    if not args.mixed_steps:
        del engines["xor"]
    gen = torch.Generator().manual_seed(0)
    head = {"card": card, "model": MODEL, "kv_quantize": args.kv_quantize,
            "mixed_steps": args.mixed_steps, "prompt": PROMPT, "max_tokens": MAX_TOKENS,
            "decode_steps": DECODE_STEPS}

    # untimed waves: builds, cuBLAS, every key's capture
    for name, eng in engines.items():
        for b in BATCHES:
            timed_wave(eng, f"warm{b}", b, gen)
    for b in BATCHES:
        order = ("eager", "graphs", "overlap", "xor", "uncached", "uncached", "xor", "overlap",
                 "graphs", "eager")
        for i, name in enumerate(n for n in order if n in engines):
            emit({"phase": "wave", **head, "batch": b, "engine": name, "order": i,
                  **timed_wave(engines[name], f"{name}{b}-{i}", b, gen)})

    # the burst, mixed steps on against off
    arms = {"mixed": engines["overlap"], "xor": engines["xor"]} if args.mixed_steps else {}
    for name, eng in arms.items():
        chip_smoke.run_burst(eng, f"burst-warm-{name}")
    for i, name in enumerate(("mixed", "xor", "xor", "mixed") if arms else ()):
        r = chip_smoke.run_burst(arms[name], f"burst-{name}-{i}")
        r.pop("streams")
        emit({"phase": "burst", **head, "engine": name, "order": i, **r})

    # profiler sessions only from here on
    for b in BATCHES:
        for name, eng in engines.items():
            emit({"phase": "dispatch", **head, "batch": b, "engine": name,
                  **profile_dispatches(eng, b, gen)})

    # one eager decode forward: host enqueue time against device time
    b = BATCHES[0]
    tok = torch.ones((b, 1), dtype=torch.long, device=dev)
    pos = torch.full((b, 1), PROMPT, dtype=torch.int32, device=dev)
    valid = torch.ones((b, 1), dtype=torch.bool, device=dev)
    pt = torch.arange(1, 1 + b * 4, dtype=torch.int32, device=dev).reshape(b, 4)

    def forward():
        h, _ = eager.adapter.forward_hidden(eager.params, tok, pos, valid, eager.kv, pt)
        return eager.adapter.compute_logits(eager.params, h[:, -1]).argmax(-1)

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
        with torch.profiler.profile(activities=ACTS) as prof:
            forward()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        dev_ms = sum(e.device_time for e in kernels) / 1e3
    emit({"phase": "forward", "batch": b, "host_enqueue_ms": host_ms,
          "events_ms": wall_ms, "device_kernel_ms": dev_ms, "cuda_kernels": len(kernels)})

    # one long prompt, prefilled in chunks: eager, and replayed as graphs
    long_prompt = torch.randint(1, eager.adapter.vocab_size, (LONG_PROMPT,), generator=gen)

    def long_request(eng: TorchEngine, rid: str, sync: bool):
        """(ms to the first token, each step's wall ms): a sync after every
        step only when `sync`. Cold: the cache is cleared first."""
        eng.allocator.clear_cache()
        eng.add_request(rid, long_prompt.tolist(), SamplingParams(max_tokens=1, ignore_eos=True))
        steps_ms, ttft_ms = [], None
        t_all = time.perf_counter()
        while eng.has_work:
            t0 = time.perf_counter()
            outs = eng.step()
            if sync:
                torch.cuda.synchronize()
            steps_ms.append((time.perf_counter() - t0) * 1e3)
            if ttft_ms is None and any(o.new_token_ids for o in outs):
                ttft_ms = (time.perf_counter() - t_all) * 1e3
        return ttft_ms, steps_ms

    for name in ("eager", "graphs"):
        eng = engines[name]
        long_request(eng, f"long-warm-{name}", True)
        ttft_ms, _ = long_request(eng, f"long-{name}", False)
        synced_ttft_ms, steps_ms = long_request(eng, f"long-sync-{name}", True)
        with torch.profiler.profile(activities=ACTS) as prof:
            window_ms, _ = long_request(eng, f"long-prof-{name}", False)
        emit({"phase": "chunked", "engine": name, "prompt": LONG_PROMPT,
              "prefill_chunk": PREFILL_CHUNK, "ttft_ms": ttft_ms,
              "synced_ttft_ms": synced_ttft_ms, "chunk_step_ms": steps_ms,
              "prefill_replays": eng.metrics.prefill_replays, "compiles": eng.metrics.compiles,
              **device_time(prof, window_ms)})
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
