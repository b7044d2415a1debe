"""Smoke run of dynamo_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. card: name and power limit (nvidia-smi) and torch's device name;
  2. build: every CUDA kernel of the serving path, from dynamo_tpu_torch/csrc,
     one nvcc per source, all started together;
  3. kernels: each kernel against its plain PyTorch version at llama3-1b
     widths (page size 64; flash prefill, bf16 paged decode, bf16 paged
     prefill and the write in every pool mode also at llama3-8b's head dim
     of 128, flash prefill at a 4,096-token chunk, paged prefill also at
     one long prompt's late chunk and at a prefix-cache hit's piece (B=1,
     T=256, 1,088 cached tokens of history, 200 new), the write at one
     long prompt's chunk of 512 tokens),
     over bf16 pools and over quantized (int8, fp8)
     pools for the three kernels that read or write them, with its time,
     the plain version's, one library call's where one computes the same
     function (each by CUDA events around 20 back-to-back calls, so the
     host's work between launches is in it), and the card's least time for
     the work (bound, from bytes or operations over the H100's peaks); and
     at a query group of 7 (GROUP7_HEADS: qwen2-7b's 28/4 heads at D 128,
     qwen2-0.5b's 14/2 at D 64) flash prefill over the ragged chunk, paged
     prefill over a bf16 and an int8 pool, and bf16 paged decode; and
     the int8 weight product (`--quantize int8`) against its plain version
     at llama3-1b's and llama3-8b's dense widths (INT8_CASES: a decode row,
     bucket 64 and a 2,048-token chunk), each row within 2^-6 of its
     largest value, beside torch.matmul on a bf16 weight of the same shape;
     and at llama3-draft's widths (4 layers, Hq 8, Hkv 4, D 64, a bf16
     pool) at buckets 8 and 64: paged decode at a proposal, paged prefill
     and the write at run 1 over catch-up windows of 1 to 5 tokens from
     unaligned positions; and at the head dims the kernels took for
     phi3-mini and gemma (NEW_D_HEADS): every kernel in every pool mode
     at phi3-mini's heads (32/32, D=96) and gemma-2b's (8/1, D=256), and
     paged decode in every pool mode at gemma-7b's (16/16, D=256);
  4. model: random-init llama3-1b in bf16, the kernel path against the
     plain path, teacher-forced over a 256-token prompt and 32 decode steps,
     and over a 1,280-token prompt prefilled in chunks of 512, 512 and 256
     and 32 decode steps, over a bf16 pool, an int8 pool and an fp8 pool:
     per-step max |delta logit| < 0.25 and argmax agreement >= 90 %; the
     quantized kernel path is also held against the bf16 kernel path, and
     reported without a gate; then with int8 weights (the same weights,
     quantize_params_int8) over a 768-token prompt in chunks of 512 and 256
     and 16 decode steps, over a bf16 pool and an int8 pool, with the same
     gate, and the int8-weight kernel path against the bf16-weight one
     reported without a gate;
  4'. families (run right after the build, on an empty card, for phi4's
     29 GB of weights and its 15 GB f32 temporary at init): the same gate
     for qwen2-0.5b, qwen2-7b (a query group of
     7, q/k/v biases), qwen3-8b (per-head q/k RMSNorm), phi4, phi3-mini
     (head_dim 96), gemma-2b and gemma-7b (head_dim 256, GeGLU, the
     (1 + w) RMSNorm, scaled embeddings) at full width and depth, random
     bf16 weights with biases drawn N(0, 0.02), q/k norm weights 1 + N(0,
     0.1) and a Gemma norm's weights N(0, 0.1), one model at a time, over
     a first chunk of 512, a chunk of 256 with history and 16 decode
     steps, over a bf16 pool (qwen2-7b and gemma-2b also over an int8
     pool): max |delta logit| < 0.25, argmax >= 90 %, and the pool's
     kernel variants launched; a line that llama3-70b (about 141 GB of
     bf16 weights) is not served on one card; then qwen2-7b and gemma-2b
     through the CLI's server at its defaults: a short chat, a chat of two
     chunks and a prefix hit one at a time, held against an eager twin to
     the id and cached token (`same_streams`), then three chats and a
     prompt of three chunks together (mixed steps); every dispatch a
     replay, the bf16 pool's variants launched, no plain version; then
     qwen2-0.5b, qwen3-8b, phi4, deepseek-r1-distill-llama-8b, phi3-mini
     and gemma-7b, each through the CLI's server at its defaults (its pool
     bytes printed), one chat of two chunks and 16 tokens; the phase
     prints its seconds;
  4b. graphs: three llama3-1b engines on one set of random weights, over
     a bf16, an int8 and an fp8 pool: the eager loop (cuda_graphs=False,
     no overlap), step graphs without overlapped decode, and step graphs
     with it (the defaults). Waves of greedy requests that reach buckets
     1-16 and 1, 2, 4 and 8 fused steps, a smaller batch after a larger
     one in a bucket, prompts of 1,100 tokens (three chunks of 512: a
     first chunk and a chunk with history that sample nothing, then one
     that samples) and of 700 beside 100, then seeded sampled waves, one
     with a 600-token prompt, and four requests joined by a fifth after
     their fourth step (prefix caching off: the 700- and 600-token prompts
     repeat the 1,100-token one's first tokens and would hit its pages;
     mixed steps off, the XOR policy of --no-mixed-steps: phase "mixed"
     holds mixed steps against the eager loop).
     Every stream must be identical in all three; each graph engine must capture each key it dispatched once
     (`compiles`), replay every prefill and decode dispatch (the replays
     sum to the engine's step-function calls; the long prompt alone:
     prefill_replays == prefill_dispatches == 3), and only the overlap
     engine may speculate, with overlap_hits > 0, overlap_rollbacks > 0
     (the fifth request's prefill) and decode replays that count its
     rollbacks (`replays_match`, the identities every phase below keeps
     too, with mixed replays); its run (counts set to 0 just before it) must
     launch every kernel variant of its pool, counted through replays,
     and no plain version;
  4b'. int8_graphs: two llama3-1b engines with quantize="int8" and no
     params (int8 weights drawn from seed 0), overlapped decode and mixed
     steps on: the eager loop and step graphs, over greedy waves, the
     1,100-token prompt and 700 beside 100 (a mixed step with a chunk with
     history) and the late arrival: every stream identical, every key
     captured once and replayed, int8_matmul launched, no plain version;
  4c. prefix: one llama3-1b engine a pool mode (bf16, int8, fp8), built
     as the CLI builds it with no flags but the model, the pool and the
     serve's context: prefix caching, graphs and overlapped decode on,
     chunk 512, page 64. A warm request (a 1,100-token prefix and a
     40-token tail, 16 tokens) registers the prefix's 17 whole pages,
     whose bytes (K, V, scale planes) are copied; then one wave of six
     greedy requests of 24 tokens: the prefix with tails of 1, 63, 200 and
     700 tokens, the prefix's 17 pages exactly, and a prompt that shares
     no page. cached_tokens on each first output must be 1,088, 1,024 for
     the prompt cached whole (its last page recomputed) and 0 for the
     unrelated one; the copied pages' bytes must be unchanged; only the
     uncached tokens prefill, and paged prefill launches once a layer for
     each replay of a chunk key with history, prefill or mixed (the
     700-token tail's second piece runs beside the decoding rows); no
     page is evicted; the dispatch counts keep phase 4b's identities. clear_cache() must
     return every cached page, and the warm request and the wave again
     must give the same streams bit for bit. An eager twin (the same
     config, cuda_graphs=False, caching on) must serve the warm request
     and the wave to the same streams and cached_tokens bit for bit, so a
     graph replay of a chunk key with history that read a wrong page table
     would show. The model gate on the hit
     path: the 200-token tail's piece over the prefix's pages written by
     the warm prompt's own forward, against a cold forward of the whole
     prompt in chunks of 512 into fresh pages, kernel and plain paths
     (max |delta logit| < 0.25, argmax >= 90 %). Printed only: the host ms
     of hashing the 1,140-token prompt's chain and a decode wave's
     appends, and the synced engine TTFT of a 1,300-token prompt with
     1,088 tokens cached against the same prompt cold;
  4d. mixed: one llama3-1b engine a pool mode built as the CLI builds it
     with no flags but the model, the pool and --max-seqs 64 (mixed
     steps, graphs, overlap and caching on, context 4,096, chunk 512,
     page 64, 8 fused steps), against the same engine with
     --no-mixed-steps. A greedy wave of 32 rows (128-token prompts, 160
     tokens each), then prompts of 3,000, 700 and 700 tokens arriving
     together once every row has 24 tokens (`run_burst`); each engine
     runs it once untimed (every key captured), then mixed, XOR, XOR,
     mixed. The mixed engine must run mixed steps, fused ones replayed as
     mixed graphs (the wave's second prefill step, of first chunks, and a
     chunk of the long prompt with history once the 700-token prompts
     have joined the rows); every engine keeps the dispatch identities
     and captures no key in a timed run; the mixed graphs launch every
     kernel variant of the pool, no plain version runs; an eager twin
     (cuda_graphs=False, the same config) gives the mixed engine's
     streams bit for bit; and the model gate holds on one mixed step's
     inputs, the prefill half's logits (the long prompt's third chunk)
     and the decode half's (32 rows), kernel path against plain path.
     Printed beside the card's name and power limit, each run: the wave
     rows' largest host gap between token deliveries over the burst and
     the p95 of the delivering steps' gaps (each step once), the burst
     prompts' synced TTFT and the wave's tok/s;
  4e. sampling: one llama3-1b engine built as the CLI builds it with no
     flags but the model and --max-seqs 64 (graphs, overlap, mixed steps,
     prefix caching, bf16 pool) serves, wave after wave: 8 greedy rows of
     128 + 64 tokens with logprobs 20; the same with frequency 1.0,
     presence 0.5 and repetition 1.3 penalties; a row with +100 on one id,
     which must be that id throughout, beside a row with min_tokens 5 and
     +100 on eos, which must be exactly 6 tokens ending on eos with
     `stop`; a 1,300-token prompt with logprobs 5, whose last chunk
     samples with history under an lp key. An eager twin (cuda_graphs=False,
     the same config) must give the same ids, logprobs and alternatives
     bit for bit; every key with an lp, pen or bias field must be captured
     once and replayed, and those graphs must launch all four kernel
     variants of the pool, no plain version; each greedy row's token must
     be its own top-1 alternative with the same logprob; and the logprob
     gate: the logprob rows' prompts and tokens through the plain path
     (teacher forcing), whose log_softmax must lie within 0.5 (twice the
     model gate's logit bound) of every chosen logprob, with the top-1 ids
     agreeing at >= 90 % of positions. Printed beside the card's name and
     power limit: the engine ms per decode dispatch of waves of 8 and 64
     rows under the plain, lp=20, pen and bias keys;
  4f. kstep: K-step decode windows, engines built as the CLI builds them
     with no flags but the model, the pool and --decode-kstep 16 (graphs,
     overlap, mixed steps, prefix caching): in each pool mode phase 4b's
     three engines (the eager loop and graphs with --no-overlap-decode,
     graphs with overlap), and with --quantize int8 the eager loop and
     graphs with overlap, each over one wave of six rows of 40 tokens:
     five short prompts, of which one stops on a forced stop id at its
     7th token, one on eos at its 10th and one at a budget of 12, all in
     the first window, and a 700-token prompt whose second chunk rides
     beside that window in a split mixed step. Every stream identical in
     an arm's engines; every key captured once, phase 4b's identities, a
     split mixed step and chained windows consumed under overlap; the
     window graphs launch the write and paged decode of the pool (and
     int8_matmul), the run every kernel variant, and nothing a plain
     version. The kernels line's `kstep_launches` and `window_launches`
     are the CLI engine's launches in this phase (counts set to 0 just
     before) and those made by window replays; the phase prints its
     seconds;
  4g. spec: prompt-lookup speculation, engines built as the CLI builds
     them with no flags but the model, the pool and --spec-ngram 4
     (graphs, prefix caching; overlap, mixed steps and windows off under
     it), arm "cli", and the same with spec_min_accept_rate 0, arm
     "always" (no cooldown: every eligible decode dispatch verifies), in
     each pool mode: the eager loop and step graphs over eight prompts
     that repeat a block four times, then eight that do not, then two
     rows beside a logprobs row (an ineligible batch: plain decode
     dispatches). Every stream identical in an arm's engines; every key
     captured once, every verify key replayed, phase 4b's identities;
     the verify graphs launch the pool's write and paged prefill, the run
     every kernel variant, and nothing a plain version; and the verify
     gate: a window of 5 tokens over histories of 63-447 tokens (ends
     inside a page, on one, across 64 and 128) through the verify path
     against the T=1 decode path over the same tokens, kernels on both
     (max |delta logit| < 0.25, argmax >= 90 %). The kernels line's
     `spec_launches` and `verify_launches` are the cli arm's launches
     (counts set to 0 just before its graph engine's run) and those made
     by its verify replays; the phase prints each wave's acceptance rate
     and its seconds;
  4h. draft: draft-model speculation, engines built as the CLI builds
     them with no flags but the model, the pool and --spec-draft llama3-1b
     (a self-draft: the target's own weights; graphs, overlap, mixed
     steps, prefix caching), with spec_min_accept_rate 0 so that every
     decode dispatch is a draft-model one: in each pool mode phase 4b's
     three engines (the eager loop and graphs without overlap, graphs
     with it) and a fourth, graphs with overlap and mixed steps off, all
     decoding in one bucket of 8, over eight greedy rows of 24 tokens, a
     seeded sampled pair and four rows joined by a fifth prompt (split
     mixed steps where they are on). Every stream identical in the four;
     every key captured once, every spec_fused and draft chunk key
     replayed, phase 4b's identities, chained dispatches consumed under
     overlap, the spec counters of the mixed engines equal the eager
     loop's; the spec_fused graphs launch the pool's write and
     paged prefill and the draft pool's bf16 write, paged prefill and
     paged decode, the run every kernel variant of the pool, and nothing a
     plain version; and the self-draft gate: the S proposals by T=1
     greedy steps, then the window [last token, proposals] through the
     verify path against the T=1 decode path (max |delta logit| < 0.25,
     argmax >= 90 %), with the share of proposals accepted printed. Then
     the llama3-draft arm (--spec-draft llama3-draft over an int8 pool,
     the CLI's cooldown): acceptance under spec_min_accept_rate, the
     cooldown engaged, the draft's bf16 kernels launched; the device ms of
     a spec_fused dispatch against the defaults' fused dispatch at
     buckets 8 and 64 (each graph replayed 10 times, CUDA events), with
     wave tok/s and tokens a row a dispatch; and one streamed chat through
     the CLI's server with --spec-draft llama3-draft. The kernels line's
     `draft_launches` and `spec_fused_launches` are the bf16 overlap
     engine's launches (counts set to 0 just before its run) and those
     made by its spec_fused replays;
  4i. checkpoint: files at llama3-1b's full width, written by the phase
     into a temporary directory and removed after their part
     (phase_checkpoint): an HF directory (Llama-3.2-1B's published
     config.json, bf16 safetensors of seeded random weights, a synthetic
     byte-level BPE tokenizer.json of Llama-3's 128,256 entries, a
     tokenizer_config.json with the transcribed Llama-3.1-8B-Instruct chat
     template), a llama3-draft-shaped directory, and an F16 `llama`-arch
     GGUF of the same weights (q/k rows permuted, a gpt2-style
     vocabulary). Each loaded tree must equal what was written bit for bit
     (after f16 rounding for the GGUF), both tokenizers must decode their
     encode of a 3,000-character prompt back to it, the CLI's server on
     each file must answer a streamed completion of that prompt with the
     ids of an eager in-process engine on the written tensors, the
     directory under --quantize int8 must pass the model gate, and
     --spec-draft llama3-draft --spec-draft-checkpoint <draft dir> must
     serve with the draft's written weights. The chat template: the
     render of a chat with a system message, three turns and two tools
     must have the committed SHA-256 (CHAT_RENDER_SHA256, which a CPU test
     recomputes through transformers) and hold Llama-3's header and turn
     specials as their ids; the directory's server must answer that chat,
     streamed, with usage counting the render's tokens and an eager
     engine's ids on them, and a completion of the render must do the
     same. The kernels line's `checkpoint_launches` are the directory's
     server's launches over its completion (counts set to 0 just before).
     Printed beside the card: load and write seconds, the tokenizer's
     encode ms of the prompt (first and warm) and each server's TTFT, the
     render ms of a 32-turn, four-tool conversation under each of
     CHAT_TEMPLATES, the chat's encode ms, and its TTFT beside the
     completion's of the same render (each on a cleared prefix cache);
  5. serve: the CLI's HTTP server in-process with llama3-1b in bf16 at the
     CLI's default chunk of 512 tokens, and ten requests (three streaming
     chats, a streaming chat whose prompt is over 1,200 tokens and so
     prefills in three chunks, a unary chat and a completion together,
     then two streaming chats that share a system message of about 1,100
     bytes, then a streamed greedy pair and a streamed seeded sampled pair,
     one request at a time); then the same server with --kv-quantize int8
     and with --kv-quantize fp8, each with the long prompt and three
     streaming chats together, then the shared-system pair and the greedy
     pair one request at a time. The first of the shared-system pair must
     have no usage.prompt_tokens_details, the second cached_tokens of the
     prompts' common whole pages (at most all but its last page). Each
     request asks for its token ids in its choices (ext.return_token_ids):
     usage must count exactly the ids served, each pair's ids must be
     identical, every kernel variant of the server's pool must launch
     while serving, no other pool variant may, and no plain version may
     run; the server runs as the CLI does with no flags, with overlapped
     decode and mixed steps (mixed_dispatches > 0: the long prompt's
     later chunks run beside the decoding chats), and every prefill,
     decode and mixed dispatch must replay a captured graph (phase 4b's
     identities); the server's captures (`compiles`, `compile_ms`),
     replays and mixed and overlap counts print with its line. TTFT is taken at the client, from sending a streaming request to
     its first chunk that carries a token. After the mix's counts are
     read, the bf16 server answers, one at a time, a streamed chat with
     logprobs and top_logprobs 5, a completion with logprobs 3 (the legacy
     arrays), n = 3 with a seed, whose choices must equal three lone
     requests with seeds s, s + 1 and s + 2, unary and streamed, and a
     penalized chat; then, twice, on the short prompt and on fresh
     prompts of 1,116 tokens, n = 3 streamed, three lone requests sent
     together and one lone request, whose first-token seconds print per
     choice (`n3_schedules`). These requests' launches
     print apart, in the line's `sampling`, and must run no plain version
     and replay graphs only; last, a server with --quantize int8 (bf16
     pool) answers the long prompt and a streaming chat together, then the
     greedy pair one at a time, launching int8_matmul beside the bf16 pool's
     variants; every server prints its params' bytes on the device beside
     the same model's in bf16;
  6. device times: each phase-3 case's kernel and library call again, 20
     calls under torch.profiler: `device_ms` and `library_device_ms` are
     the device time of the CUDA kernels one call launches (each kernel's
     mean over the launches recorded, times its launches in one call
     profiled apart), without the host's work;
     `library_kernels` names the kernels the library call ran (its
     backend). It runs last so that no profiler
     session precedes the serve phase. The phase-3 lines print here.
Then the `kernels` JSON line (one entry per kernel variant), the card line
and, last, the contract line {"ok": true, "device": {...}}. With no card
it exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import gc
import hashlib
import json
import os
import shutil
import statistics
import sys
import tempfile
import threading
import time
import urllib.request

import torch

from dynamo_tpu_torch import ops, platform
from dynamo_tpu_torch.preprocessor.tokenizer import ByteTokenizer
from dynamo_tpu_torch.ops import (
    _build,
    flash_prefill,
    int8_matmul,
    kv_quant,
    kv_update,
    paged_attention,
)

#: llama3-1b attention widths (LlamaConfig.llama3_1b), page size 64
L, HQ, HKV, D, S = 16, 32, 8, 64, 64
#: llama3-draft's (LlamaConfig.llama3_draft): layers, query and KV heads
DRAFT_L, DRAFT_HQ, DRAFT_HKV = 4, 8, 4
#: pool modes: bf16 (None) and the two quantized ones
MODES = kv_quant.POOL_MODES
SOURCE = {
    "paged_write": ("dynamo_tpu_torch/csrc/kv_update.cu", "dynamo_tpu/ops/kv_update.py:266"),
    "flash_prefill_attention": (
        "dynamo_tpu_torch/csrc/flash_prefill.cu", "dynamo_tpu/ops/flash_prefill.py:484"),
    "paged_decode_attention": (
        "dynamo_tpu_torch/csrc/paged_attention.cu", "dynamo_tpu/ops/paged_attention.py:369"),
    "paged_prefill_attention": (
        "dynamo_tpu_torch/csrc/paged_prefill.cu", "dynamo_tpu/ops/flash_prefill.py:389"),
    # no pallas_call: the reference's `_mm` leaves the int8 convert and the
    # scale to XLA, which fuses them into the dot's operand read
    "int8_matmul": ("dynamo_tpu_torch/csrc/int8_matmul.cu",
                    "dynamo_tpu/models/llama.py:1043 (_mm, int8 weights; XLA-fused, no "
                    "pallas_call)"),
}
#: the `quantized` branch of each Pallas kernel that has one
QUANT_BRANCH = {
    "paged_write": "dynamo_tpu/ops/kv_update.py:56",
    "paged_decode_attention": "dynamo_tpu/ops/paged_attention.py:142",
    "paged_prefill_attention": "dynamo_tpu/ops/flash_prefill.py:185",
}
#: flash and paged prefill (bf16 output): each row's max |diff| against the
#: plain version, as a share of the row's largest |value|; 2^-6 is 2-4 bf16
#: ulps there, so a dropped key tile or a wrong mask fails on long rows too
PREFILL_ROW_RTOL = 2.0**-6
#: the int8 weight product (bf16 output): each row's max |diff| against the
#: plain version as a share of the row's largest |value|; the plain version
#: rounds the product and the scaled product to bf16 apart, the kernel once
INT8_ROW_RTOL = 2.0**-6
#: (M, K, N) of the int8 product: llama3-1b's up/gate projection at a
#: decode row, a 2,048-token chunk and bucket 64, its down and k/v
#: projections at bucket 64, llama3-8b's up and down projections at bucket
#: 64; the last, llama3-1b's up projection at bucket 64, is the kernels
#: line's
INT8_CASES = ((1, 2048, 8192), (2048, 2048, 8192), (64, 8192, 2048), (64, 2048, 512),
              (64, 4096, 14336), (64, 14336, 4096), (64, 2048, 8192))
#: paged decode (f32 output): max |acc/l diff| and |m diff|
DECODE_ATOL = 1e-4
#: the model gate (the reference's bf16 gate)
GATE_MAX_DLOGIT, GATE_ARGMAX = 0.25, 0.90


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over `iters` launches, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _kernel_times(fn, calls: int, between=None) -> dict[str, list[float]]:
    """Device time (us) of each kernel launch torch.profiler recorded over
    `calls` calls of fn(), by kernel name, each call after one of
    `between()` where given. A spin kernel before and after the calls
    (left out of the result) keeps a launch the profiler drops at a
    session's edge from being one of fn's."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda._sleep(1000)
        for _ in range(calls):
            if between is not None:
                between()
            fn()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    times: dict[str, list[float]] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and "spin_kernel" not in e.name:
            times.setdefault(e.name, []).append(e.device_time)
    return times


def device_ms(fn, iters: int = 20, warmup: int = 3, tries: int = 3,
              between=None) -> tuple[float, list[str]]:
    """Device time of fn() per call, and the names of the kernels it ran.
    One call profiled on its own gives each kernel's launches per call;
    the same warmed loop of `iters` calls as `cuda_ms`, under
    torch.profiler, gives each kernel's mean device time over the launches
    recorded; per call is the sum over kernels of mean x launches. The
    profiler can miss a launch of the loop (it recorded 19 of 20 on the
    H100), so neither the loop's sum over `iters` nor its count of
    launches is exact. Unlike `cuda_ms` it leaves out the host's work
    between launches (a wrapper's checks, allocation, the ctypes call),
    which sets `cuda_ms` for a kernel shorter than that work. The launches
    per call are the most any one-call session recorded; a try whose loop
    and one-call sessions name different kernels is made again, up to
    `tries`. With `between`, each call comes after one of `between()`
    (e.g. a pass over a buffer larger than L2, so that fn starts cold),
    whose kernels are left out; it raises if fn runs one of them."""
    skip: set[str] = set()
    if between is not None:
        between()
        skip = set(_kernel_times(between, 1))
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    launches: dict[str, int] = {}
    for _ in range(tries):
        for name, t in _kernel_times(fn, 1).items():
            if name in skip:
                raise ValueError(f"fn runs {name}, a kernel of `between`")
            launches[name] = max(launches.get(name, 0), len(t))
        times = {k: t for k, t in _kernel_times(fn, iters, between).items() if k not in skip}
        if times and set(times) == set(launches):
            per_call = sum(statistics.fmean(times[k]) * n for k, n in launches.items())
            return per_call / 1e3, sorted(launches)
    raise AssertionError(f"torch.profiler recorded no launches of one call that agree with "
                         f"those of {iters} in {tries} tries")


def timings(kernel, plain, library=None) -> dict:
    """A kernel's times beside its plain version's and, where one PyTorch
    call computes the same function, that call's, by CUDA events around
    the loop (host work included): `ms`, `plain_ms`, `library_ms`. The
    kernel and library calls are kept under "calls" for
    `phase_device_times`, which profiles them after the servers have run,
    so that no profiler session comes before the serve phase's timings."""
    return {"ms": cuda_ms(kernel), "plain_ms": cuda_ms(plain),
            "library_ms": None if library is None else cuda_ms(library),
            "calls": (kernel, library)}


def phase_device_times(cases: list[dict]) -> None:
    """Each case's `device_ms` and `library_device_ms` (the profiler's
    kernel time per call) and the kernels each call launched."""
    for c in cases:
        kernel, library = c.pop("calls")
        c["device_ms"], c["device_kernels"] = device_ms(kernel)
        c["library_device_ms"], c["library_kernels"] = (
            (None, []) if library is None else device_ms(library))


def bound(nbytes: float, flop: float, peaks) -> tuple[float, str]:
    """The card's least time (ms) for the work: bytes over the memory rate
    or bf16 operations over the tensor-core rate, whichever is larger."""
    t_bytes = nbytes / peaks.hbm_bytes_per_s * 1e3
    t_ops = flop / peaks.bf16_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- phase 3: kernels against their plain versions ------------------------------


def make_pools(shape, mode, gen, dev) -> tuple[list, dict]:
    """Random K and V pools: bf16 normals, or normals quantized to `mode`
    (rows of several magnitudes) with their scale planes as keywords."""
    if mode is None:
        return [torch.randn(shape, generator=gen, dtype=torch.bfloat16, device=dev)
                for _ in range(2)], {}
    pools, planes = [], []
    for _ in range(2):
        x = torch.randn(shape, generator=gen, device=dev)
        x *= 0.1 + 4 * torch.rand(shape[:-1] + (1,), generator=gen, device=dev)
        q, s = kv_quant.quantize_kv_rows(x, mode)
        pools.append(q)
        planes.append(s)
        del x
    return pools, {"k_scale": planes[0], "v_scale": planes[1]}


def poison_past_history(pools, planes, pt, hist):
    """Slots past each history get the byte 0x7f (NaN in e4m3, 127 in int8)
    and a zero scale: the kernels must select them away, never multiply."""
    pos = torch.arange(pt.shape[1] * S, device=pt.device)
    stale = pos[None, :] >= hist.long()[:, None]
    pages = pt.long().repeat_interleave(S, dim=1)[stale]
    slots = (pos % S).expand_as(stale)[stale]
    for rows in pools:
        rows.view(torch.uint8)[:, pages, slots] = 0x7F
    for plane in planes.values():
        plane[:, pages, slots] = 0.0


def dense_history(cache, scale, layer, pt, hist) -> torch.Tensor:
    """A bf16 copy of each history [B, MP*S, Hkv, D], dequantized, for the
    library yardstick (made before timing, never timed)."""
    live = torch.arange(pt.shape[1] * S, device=pt.device)[None, :] < hist.long()[:, None]
    return kv_quant.gather_history(cache, scale, layer, pt, live).to(torch.bfloat16)


def as_bytes(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.uint8) if x.dtype == torch.float8_e4m3fn else x


def paged_write_inputs(dev, gen, b: int, t: int, mode, d: int = D, full: bool = False, *,
                       layers: int = L, page_size: int = S, hkv: int = HKV, lens=None,
                       starts=None):
    """A write's inputs, at llama3-1b's widths unless `d`, `layers`,
    `page_size` or `hkv` say otherwise: page tables, positions and valid
    [B, T] (decode at T=1, each sequence at its own position and the last
    row padding; else page-aligned chunks of random lengths, or every
    token valid with `full`; `lens` gives each sequence's valid tokens
    instead, 1 or 0 at T=1; `starts` makes each row a verify window, every
    token valid from position starts[i] on, which may start mid-page),
    staged K/V and random pools. Returns (pools and scale planes before
    the write, k_stage, v_stage, (pt, pos, valid), the scale planes'
    keywords)."""
    span = t if starts is None else max(starts) + t
    pages_per_seq = max(1, -(-span // page_size)) + 2
    num_pages = 1 + b * pages_per_seq
    # the page tables and lengths first: every pool mode gets the same ones
    pt = 1 + torch.randperm(num_pages - 1, generator=gen, device=dev)[: b * pages_per_seq]
    pt = pt.reshape(b, pages_per_seq).to(torch.int32)
    if t == 1:
        pos = torch.randint(0, (pages_per_seq - 1) * page_size, (b, 1), generator=gen,
                            device=dev)
        if lens is None:
            lens = [1] * (b - 1) + [0]
    elif starts is not None:
        pos = torch.tensor(starts, device=dev)[:, None] + torch.arange(t, device=dev)
        lens = [t] * b
    else:
        pos = torch.arange(t, device=dev)[None, :].expand(b, t)
        if lens is None:
            lens = (torch.full((b,), t, device=dev) if full
                    else torch.randint(1, t + 1, (b,), generator=gen, device=dev))
    valid = torch.arange(t, device=dev)[None, :] < torch.as_tensor(lens, device=dev)[:, None]
    bf = dict(dtype=torch.bfloat16, device=dev)
    k_stage = torch.randn((layers, b, t, hkv, d), generator=gen, **bf)
    v_stage = torch.randn((layers, b, t, hkv, d), generator=gen, **bf)
    (k_cache, v_cache), planes = make_pools((layers, num_pages, page_size, hkv, d), mode, gen,
                                            dev)
    args = (pt, pos.to(torch.int32).contiguous(), valid.contiguous())
    return [k_cache, v_cache, *planes.values()], k_stage, v_stage, args, planes


def check_paged_write(dev, peaks, gen, b: int, t: int, mode, d: int = D,
                      full: bool = False, starts=None, layers: int = L,
                      hkv: int = HKV) -> dict:
    """The write against its plain version, bit for bit; with `starts`, a
    verify window a row (paged_write_inputs) landed in runs of one slot,
    whose every slot outside the windows must keep its bytes. At
    llama3-1b's layers and KV heads unless `layers` and `hkv` say
    otherwise (the draft's)."""
    before, k_stage, v_stage, args, planes = paged_write_inputs(
        dev, gen, b, t, mode, d, full, starts=starts, layers=layers, hkv=hkv)
    valid = args[2]
    run = None if starts is None else 1
    kern = [x.clone() for x in before]
    plain = [x.clone() for x in before]
    kp = dict(zip(planes, kern[2:]), run=run)  # the scale planes as keywords, if any
    pp = dict(zip(planes, plain[2:]), run=run)
    kv_update.paged_write(kern[0], kern[1], k_stage, v_stage, *args, **kp)
    kv_update.paged_write_plain(plain[0], plain[1], k_stage, v_stage, *args, **pp)
    torch.cuda.synchronize()
    # page 0 is the null page: its contents are unspecified by contract
    for g, w in zip(kern, plain):
        if not torch.equal(as_bytes(g)[:, 1:], as_bytes(w)[:, 1:]):
            n = int((as_bytes(g)[:, 1:] != as_bytes(w)[:, 1:]).sum())
            raise AssertionError(f"paged_write {mode or 'bf16'} B={b} T={t} D={d}: not "
                                 f"bit-equal ({n} elements differ)")
    if starts is not None:
        pt, pos = args[0].long(), args[1].long()
        window = torch.zeros(before[0].shape[1:3], dtype=torch.bool, device=dev)
        window[torch.gather(pt, 1, pos // S), pos % S] = True
        window[0] = True  # the null page
        for g, x in zip(kern, before):
            if not torch.equal(as_bytes(g)[:, ~window], as_bytes(x)[:, ~window]):
                raise AssertionError(f"paged_write {mode or 'bf16'} at run 1: a slot outside "
                                     f"the windows changed")
    # both now hold the same bytes: the plain version is timed on the
    # kernel's pools, so a case holds one copy of them
    del plain, pp, before
    library_call, library = None, "none: no single PyTorch call quantizes and lands the rows"
    if mode is None:
        library_call = index_copy_write(kern, k_stage, v_stage, *args, run=run)
        library = ("Tensor.index_copy_ on each pool viewed as [L, P*S, Hkv*D] over "
                   "precomputed flat slot indices (K and V, timed together)")
    times = timings(
        lambda: kv_update.paged_write(kern[0], kern[1], k_stage, v_stage, *args, **kp),
        lambda: kv_update.paged_write_plain(kern[0], kern[1], k_stage, v_stage, *args, **kp),
        library_call)
    nbytes = kv_update.bytes_moved(k_stage, valid.cpu(), S, mode, run=run)
    b_ms, by = bound(nbytes, 0.0, peaks)
    return {"kernel": kv_quant.variant("paged_write", mode), "B": b, "T": t, "L": layers,
            "Hkv": hkv, "D": d, "S": S, "every_token_valid": full,
            "run": run or min(t, S), "starts": starts,
            "tolerance": "bit-equal on every page but the null page 0"
                         + ("" if mode is None else ", narrow bytes and scale planes"),
            "max_abs_err": 0.0, **times,
            "library": library, "bytes": nbytes, "bound_ms": b_ms, "bound_by": by}


def index_copy_write(pools, k_stage, v_stage, pt, pos, valid, run=None):
    """The bf16 write as one index_copy_ per pool (the library yardstick),
    in runs of `run` slots (min(T, S) when None), checked to land what the
    kernel landed; returns the call to time."""
    b, t = pos.shape
    row = k_stage.shape[3] * k_stage.shape[4]
    run = run or min(t, S)
    first_pos = pos[:, ::run].long()
    first_valid = valid[:, ::run]
    pages = torch.gather(pt.long(), 1, (first_pos // S).clamp(0, pt.shape[1] - 1))
    pages = torch.where(first_valid, pages, 0)
    slot0 = torch.where(first_valid, first_pos % S, 0)
    idx = ((pages * S + slot0)[:, :, None] + torch.arange(run, device=pos.device)).reshape(-1)
    layers = k_stage.shape[0]
    flat = [x.clone().view(layers, -1, row) for x in pools[:2]]
    src = [x.view(layers, b * t, row) for x in (k_stage, v_stage)]

    def call():
        for dst, s in zip(flat, src):
            dst.index_copy_(1, idx, s)

    call()
    for dst, want in zip(flat, pools[:2]):
        if not torch.equal(dst.view(want.shape)[:, 1:], want[:, 1:]):
            raise AssertionError("paged_write: the index_copy_ yardstick lands other rows")
    return call


def row_errors(got, ref, lens) -> tuple[float, float]:
    """(max |diff|, the largest row's max |diff| over its largest |value|)
    over the (token, head) rows below each sequence's length."""
    t = got.shape[1]
    rows = torch.arange(t, device=got.device)[None, :] < lens[:, None]
    diff = (got.float() - ref.float()).abs().amax(dim=-1)[rows]  # [tokens, Hq]
    scale = ref.float().abs().amax(dim=-1)[rows]
    return diff.max().item(), (diff / scale).max().item()


def check_flash_prefill(dev, peaks, gen, b: int, t: int, ragged: bool = True,
                        d: int = D, heads: tuple = (HQ, HKV)) -> dict:
    hq, hkv = heads
    bf = dict(dtype=torch.bfloat16, device=dev)
    q = torch.randn((b, t, hq, d), generator=gen, **bf)
    k = torch.randn((b, t, hkv, d), generator=gen, **bf)
    v = torch.randn((b, t, hkv, d), generator=gen, **bf)
    lens = [t, t - 12, (3 * t) // 4 + 1, t // 2, t // 4 + 1, 64, 33, 1][:b] if ragged else []
    valid_len = torch.tensor(lens + [t] * (b - len(lens)), dtype=torch.int32, device=dev)
    got = flash_prefill.flash_prefill_attention(q, k, v, valid_len, scale_dim=d)
    ref = flash_prefill.flash_prefill_attention_plain(q, k, v, valid_len, scale_dim=d)
    torch.cuda.synchronize()
    err, rel = row_errors(got, ref, valid_len)
    if not (rel <= PREFILL_ROW_RTOL) or not torch.isfinite(got).all():
        raise AssertionError(f"flash_prefill_attention B={b} T={t} D={d}: a row's max |diff| is "
                             f"{rel} of its largest value (limit {PREFILL_ROW_RTOL})")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    times = timings(
        lambda: flash_prefill.flash_prefill_attention(q, k, v, valid_len, scale_dim=d),
        lambda: flash_prefill.flash_prefill_attention_plain(q, k, v, valid_len, scale_dim=d),
        lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True))
    nbytes = flash_prefill.bytes_moved(valid_len.cpu(), hq, hkv, d, 2)
    b_ms, by = bound(nbytes, flash_prefill.flops(valid_len.cpu(), hq, d), peaks)
    return {"kernel": "flash_prefill_attention", "B": b, "T": t, "Hq": hq, "Hkv": hkv, "D": d,
            "valid_len": valid_len.tolist(),
            "tolerance": f"bf16, each (token, head) row below valid_len: max |diff| <= "
                         f"{PREFILL_ROW_RTOL} x the row's largest |value| (2-4 bf16 ulps)",
            "max_abs_err": err, "max_row_rel_err": rel, **times,
            "library": "F.scaled_dot_product_attention(is_causal=True, enable_gqa=True) "
                       "over the whole padded chunk",
            "bound_ms": b_ms, "bound_by": by}


def paged_prefill_inputs(dev, gen, hist: list[int], cur: list[int], t: int, mode,
                         d: int = D, heads: tuple = (HQ, HKV), layers: int = L
                         ) -> tuple[tuple, dict]:
    """A paged prefill case's arguments (q, k_cur, v_cur, pools, layer, page
    tables, history and chunk lengths) and, for a quantized pool, its scale
    planes as keywords; slots past each quantized history are poisoned.
    At llama3-1b's heads and layers unless `heads` (Hq, Hkv) and `layers`
    say otherwise."""
    hq, hkv = heads
    b = len(hist)
    mp = max(1, -(-max(hist) // S))
    num_pages = 1 + b * mp
    pt = 1 + torch.randperm(num_pages - 1, generator=gen, device=dev)[: b * mp]
    pt = pt.reshape(b, mp).to(torch.int32)
    bf = dict(dtype=torch.bfloat16, device=dev)
    q = torch.randn((b, t, hq, d), generator=gen, **bf)
    k_cur = torch.randn((b, t, hkv, d), generator=gen, **bf)
    v_cur = torch.randn((b, t, hkv, d), generator=gen, **bf)
    (k_cache, v_cache), planes = make_pools((layers, num_pages, S, hkv, d), mode, gen, dev)
    hist_lens = torch.tensor(hist, dtype=torch.int32, device=dev)
    cur_lens = torch.tensor(cur, dtype=torch.int32, device=dev)
    if mode is not None:
        poison_past_history((k_cache, v_cache), planes, pt, hist_lens)
    return (q, k_cur, v_cur, k_cache, v_cache, layers - 2, pt, hist_lens, cur_lens), planes


def paged_prefill_library(args, planes):
    """The library yardstick: one SDPA call over a bf16 copy of each
    (dequantized) history followed by its chunk (the copy is made here and
    not timed), with the same mask: history below hist_lens, the chunk
    causally below cur_lens."""
    q, k_cur, v_cur, k_cache, v_cache, layer, pt, hist_lens, cur_lens = args
    b, t = q.shape[:2]
    n_hist = pt.shape[1] * S
    dense_k = torch.cat([dense_history(k_cache, planes.get("k_scale"), layer, pt, hist_lens),
                         k_cur], 1)
    dense_v = torch.cat([dense_history(v_cache, planes.get("v_scale"), layer, pt, hist_lens),
                         v_cur], 1)
    pos = torch.arange(t, device=q.device)
    hist_live = (torch.arange(n_hist, device=q.device)[None, :] < hist_lens[:, None])
    cur_live = (pos[None, :] <= pos[:, None])[None] & (pos[None, None, :] < cur_lens[:, None, None])
    mask = torch.cat([hist_live[:, None, :].expand(b, t, n_hist), cur_live], 2)[:, None]
    qt, kt, vt = q.transpose(1, 2), dense_k.transpose(1, 2), dense_v.transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True)


def check_paged_prefill(dev, peaks, gen, hist: list[int], cur: list[int], t: int,
                        mode, d: int = D, heads: tuple = (HQ, HKV), layers: int = L) -> dict:
    hq, hkv = heads
    args, planes = paged_prefill_inputs(dev, gen, hist, cur, t, mode, d, heads, layers)
    hist_lens, cur_lens = args[-2:]
    b = len(hist)
    got = flash_prefill.paged_prefill_attention(*args, scale_dim=d, **planes)
    ref = flash_prefill.paged_prefill_attention_plain(*args, scale_dim=d, **planes)
    torch.cuda.synchronize()
    name = kv_quant.variant("paged_prefill_attention", mode)
    err, rel = row_errors(got, ref, cur_lens)
    if not (rel <= PREFILL_ROW_RTOL) or not torch.isfinite(got).all():
        raise AssertionError(f"{name} B={b} T={t} D={d}: a row's max |diff| is "
                             f"{rel} of its largest value (limit {PREFILL_ROW_RTOL})")
    times = timings(
        lambda: flash_prefill.paged_prefill_attention(*args, scale_dim=d, **planes),
        lambda: flash_prefill.paged_prefill_attention_plain(*args, scale_dim=d, **planes),
        paged_prefill_library(args, planes))
    nbytes = flash_prefill.paged_bytes_moved(hist_lens.cpu(), cur_lens.cpu(), hq, hkv, d, 2,
                                             mode)
    flop = flash_prefill.paged_flops(hist_lens.cpu(), cur_lens.cpu(), hq, d)
    b_ms, by = bound(nbytes, flop, peaks)
    return {"kernel": name, "B": b, "T": t, "Hq": hq, "Hkv": hkv, "L": layers, "D": d,
            "S": S, "hist_lens": hist, "cur_lens": cur,
            "tolerance": f"bf16, each (token, head) row below cur_lens: max |diff| <= "
                         f"{PREFILL_ROW_RTOL} x the row's largest |value| (2-4 bf16 ulps)"
                         + ("" if mode is None else "; slots past each history hold "
                            "byte 0x7f and scale 0"),
            "max_abs_err": err, "max_row_rel_err": rel, **times,
            "library": "F.scaled_dot_product_attention(attn_mask, enable_gqa=True) over a "
                       "dense bf16 copy of each (dequantized) history followed by its chunk",
            "flop": flop, "bytes": nbytes, "bound_ms": b_ms, "bound_by": by}


#: paged prefill cases (hist_lens, cur_lens, T, seed): one long prompt's
#: sixth 512-token chunk (3,000 tokens in all, under one wave of CTAs), a
#: prefix-cache hit's piece (17 cached pages of 64, then a 200-token tail
#: in the T bucket of 256), then the main case, a first chunk beside
#: chunks with long histories, last so the kernels line reports it
PAGED_PREFILL_CASES = (([2560], [440], 512, 10), ([1088], [200], 256, 14),
                       ([0, 512, 1536, 3072], [512, 512, 300, 512], 512, 5))


def decode_inputs(dev, gen, b: int, max_hist: int, mode, d: int = D, heads: tuple = (HQ, HKV),
                  layers: int = L) -> tuple[tuple, dict]:
    """A decode case's arguments (q, pools, layer, page tables, history
    lengths) and, for a quantized pool, its scale planes as keywords; at
    llama3-1b's heads and layers unless `heads` and `layers` say
    otherwise."""
    hq, hkv = heads
    mp = max_hist // S
    num_pages = 1 + b * mp
    # the page tables and lengths first: every pool mode gets the same ones
    pt = 1 + torch.randperm(num_pages - 1, generator=gen, device=dev)[: b * mp]
    pt = pt.reshape(b, mp).to(torch.int32)
    hist = torch.randint(1, max_hist + 1, (b,), generator=gen, device=dev)
    hist[0] = max_hist - 17  # a partial last page
    if b > 2:
        hist[1] = 0  # no history: (acc, m, l) = (0, -inf, 0)
        hist[2] = max_hist
    hist = hist.to(torch.int32)
    q = torch.randn((b, hq, d), generator=gen, dtype=torch.bfloat16, device=dev)
    (k_cache, v_cache), planes = make_pools((layers, num_pages, S, hkv, d), mode, gen, dev)
    if mode is not None:
        poison_past_history((k_cache, v_cache), planes, pt, hist)
    return (q, k_cache, v_cache, layers - 3, pt, hist), planes


def decode_errors(got, ref, hist) -> tuple[float, float, bool]:
    """Max |acc/l diff| and |m diff| where there is history, and whether
    every row with none is exactly (0, -inf, 0)."""
    (acc, m, l), (racc, rm, rl) = got, ref
    some = hist > 0
    err = (acc / l[..., None] - racc / rl[..., None])[some].abs().max().item()
    m_err = (m - rm)[some].abs().max().item()
    empty_ok = bool(
        (acc[~some] == 0).all() and (l[~some] == 0).all() and torch.isneginf(m[~some]).all()
    )
    return err, m_err, empty_ok


def decode_library(args, planes):
    """The library yardstick: one SDPA call with a length mask over a bf16
    copy of each (dequantized) history, made here and not timed."""
    q, k_cache, v_cache, layer, pt, hist = args
    dense_k = dense_history(k_cache, planes.get("k_scale"), layer, pt, hist).transpose(1, 2)
    dense_v = dense_history(v_cache, planes.get("v_scale"), layer, pt, hist).transpose(1, 2)
    live = (torch.arange(pt.shape[1] * S, device=q.device)[None, :] < hist[:, None])
    live = live[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(q[:, :, None], dense_k, dense_v, attn_mask=live, enable_gqa=True)


def check_paged_decode(dev, peaks, gen, b: int, max_hist: int, mode, d: int = D,
                       heads: tuple = (HQ, HKV), layers: int = L) -> dict:
    hq, hkv = heads
    args, planes = decode_inputs(dev, gen, b, max_hist, mode, d, heads, layers)
    hist = args[-1]
    kernel = lambda: paged_attention.paged_decode_attention(*args, scale_dim=d, **planes)  # noqa: E731
    plain = lambda: paged_attention.paged_decode_attention_plain(*args, scale_dim=d, **planes)  # noqa: E731
    got, ref = kernel(), plain()
    torch.cuda.synchronize()
    name = kv_quant.variant("paged_decode_attention", mode)
    err, m_err, empty_ok = decode_errors(got, ref, hist)
    if not (err <= DECODE_ATOL and m_err <= DECODE_ATOL) or not empty_ok:
        raise AssertionError(
            f"{name} B={b} D={d}: max |acc/l diff| {err}, max |m diff| {m_err} "
            f"(limit {DECODE_ATOL}), empty rows right: {empty_ok}")
    times = timings(kernel, plain, decode_library(args, planes))
    nbytes = paged_attention.bytes_moved(hist.cpu(), hq, hkv, d, 2, mode)
    flop = 4 * hq * d * int(hist.long().sum())
    b_ms, by = bound(nbytes, flop, peaks)
    return {"kernel": name, "B": b, "Hq": hq, "Hkv": hkv, "L": layers, "D": d, "S": S,
            "history_tokens": int(hist.long().sum()), "max_history": int(hist.max()),
            "tolerance": f"f32, max |acc/l diff| and |m diff| <= {DECODE_ATOL}; "
                         "zero history exactly (0, -inf, 0)"
                         + ("" if mode is None else "; slots past each history hold "
                            "byte 0x7f and scale 0"),
            "max_abs_err": err, **times,
            "library": "F.scaled_dot_product_attention(attn_mask, enable_gqa=True) over a "
                       "dense bf16 copy of the (dequantized) history, normalized output",
            "bytes": nbytes, "bound_ms": b_ms, "bound_by": by}


def check_int8_matmul(dev, peaks, gen, m: int, k: int, n: int) -> dict:
    """The int8 weight product against its plain version, a weight of
    N(0, 1/K) draws quantized per output channel; the library yardstick is
    torch.matmul on a bf16 weight of the same shape (no PyTorch call
    computes the int8 product without writing the weight out in bf16 first,
    and the unquantized product is what the int8 model has to beat)."""
    from dynamo_tpu_torch.models.llama import quantize_channelwise_int8

    x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    w, scale = quantize_channelwise_int8(torch.randn((k, n), generator=gen, device=dev) / k**0.5)
    got = int8_matmul.int8_matmul(x, w, scale)
    ref = int8_matmul.int8_matmul_plain(x, w, scale)
    torch.cuda.synchronize()
    diff = (got.float() - ref.float()).abs().amax(dim=-1)
    rel = (diff / ref.float().abs().amax(dim=-1)).max().item()
    if not (rel <= INT8_ROW_RTOL) or not torch.isfinite(got).all():
        raise AssertionError(f"int8_matmul M={m} K={k} N={n}: a row's max |diff| is {rel} of "
                             f"its largest value (limit {INT8_ROW_RTOL})")
    w_bf16 = (w.float() * scale).to(torch.bfloat16)
    times = timings(lambda: int8_matmul.int8_matmul(x, w, scale),
                    lambda: int8_matmul.int8_matmul_plain(x, w, scale),
                    lambda: torch.matmul(x, w_bf16))
    b_ms, by = bound(int8_matmul.bytes_moved(m, k, n), int8_matmul.flops(m, k, n), peaks)
    mi, splits, per = int8_matmul.split_plan(
        m, k, n, torch.cuda.get_device_properties(dev).multi_processor_count)
    return {"kernel": "int8_matmul", "M": m, "K": k, "N": n, "mi": mi, "splits": splits,
            "tolerance": f"bf16, each row: max |diff| <= {INT8_ROW_RTOL} x the row's largest "
                         f"|value| (the plain version rounds twice, the kernel once)",
            "max_abs_err": diff.max().item(), "max_row_rel_err": rel, **times,
            "library": "torch.matmul(x, w_bf16): the same product on a bf16 weight",
            "bound_ms": b_ms, "bound_by": by}


#: verify windows (--spec-ngram 4: T = 5 at positions num_tokens - 1 on) at
#: decode buckets 8 and 64: histories of 63 to 2,031 tokens from a seed,
#: none a multiple of the page (seed -> B histories)
VERIFY_T = 5


def catchup_lens(seed: int, b: int) -> list[int]:
    """B catch-up windows' lengths (a draft-model dispatch's tokens
    accepted since the last one), 1 to VERIFY_T, from `seed` (the first
    is VERIFY_T)."""
    gen = torch.Generator().manual_seed(seed)
    lens = torch.randint(1, VERIFY_T + 1, (b,), generator=gen)
    lens[0] = VERIFY_T
    return lens.tolist()


def verify_hist(seed: int, b: int) -> list[int]:
    """B unaligned histories in [63, 2031] from `seed` (the first is 63)."""
    gen = torch.Generator().manual_seed(seed)
    hist = torch.randint(63, 2032, (b,), generator=gen)
    hist[0] = 63
    hist += (hist % S == 0).long()  # never on a page's first slot
    return hist.tolist()


#: the query group of 7 (it divides neither prefill kernel's 128-row
#: tile): (preset, (Hq, Hkv), D)
GROUP7_HEADS = (("qwen2-7b", (28, 4), 128), ("qwen2-0.5b", (14, 2), 64))
#: the head dims 96 and 256: (preset, (Hq, Hkv), D, every kernel or paged
#: decode alone)
NEW_D_HEADS = (("phi3-mini", (32, 32), 96, True), ("gemma-2b", (8, 1), 256, True),
               ("gemma-7b", (16, 16), 256, False))


def phase_preset_writes(dev, peaks) -> list[dict]:
    """The write at head_dim 96 (phi3-mini) and 256 (gemma-2b) over the
    preset's own layers and KV heads, as its served path lands them, in
    every pool mode: a decode step at B=32 and a chunk at B=8 T=512, each
    timed and profiled at once and freed before the next (phi3-mini's
    32-layer pools and stage do not fit beside the cases phase 3 holds
    until phase 6, so this runs after phase 6)."""
    from dynamo_tpu_torch.models.registry import get_model

    gen = torch.Generator(device=dev)
    cases = []
    for model, heads, d, every in NEW_D_HEADS:
        if not every:
            continue
        layers = get_model(model).config.num_layers
        for mode in MODES:
            for seed, b, t in ((94, 32, 1), (95, 8, 512)):
                c = check_paged_write(dev, peaks, gen.manual_seed(seed), b, t, mode, d=d,
                                      layers=layers, hkv=heads[1])
                phase_device_times([c])
                cases.append({**c, "model": model})
                free_memory()
    return cases


def phase_kernels(dev, peaks) -> dict:
    gen = torch.Generator(device=dev)
    cases = [
        check_int8_matmul(dev, peaks, gen.manual_seed(20 + i), *shape)
        for i, shape in enumerate(INT8_CASES)
    ]
    # a query group of 7 at qwen2-7b's and qwen2-0.5b's heads, before the
    # main path's cases so the kernels line reports those: flash prefill
    # over the ragged first chunk, paged prefill over the main chunk beside
    # histories in a bf16 and an int8 pool, paged decode at B=32; pools of
    # four layers (a call reads one), as every case's inputs stay held
    # until phase 6
    for model, heads, d in GROUP7_HEADS:
        g7 = dict(d=d, heads=heads)
        cases += [{**c, "model": model} for c in (
            check_flash_prefill(dev, peaks, gen.manual_seed(90), 8, 512, **g7),
            *(check_paged_prefill(dev, peaks, gen.manual_seed(91),
                                  *PAGED_PREFILL_CASES[-1][:3], mode, layers=4, **g7)
              for mode in (None, "int8")),
            check_paged_decode(dev, peaks, gen.manual_seed(92), 32, 2048, None, layers=4,
                               **g7),
        )]
    # head_dim 96 (phi3-mini) and 256 (gemma-2b, gemma-7b), before the main
    # path's cases so the kernels line reports those: flash prefill over
    # the ragged first chunk; in every pool mode paged prefill over the
    # main chunk beside histories and paged decode at B=8 over histories
    # of up to 2,048, in pools of two or three layers (a call reads one),
    # as every case's inputs stay held until phase 6 (the write, which
    # lands every layer, comes in phase_preset_writes)
    for model, heads, d, every in NEW_D_HEADS:
        nd = dict(d=d, heads=heads)
        picked = [check_flash_prefill(dev, peaks, gen.manual_seed(93), 8, 512, **nd)] if every else []
        for mode in MODES:
            if every:
                picked.append(check_paged_prefill(dev, peaks, gen.manual_seed(96),
                                                  *PAGED_PREFILL_CASES[-1][:3], mode, layers=2,
                                                  **nd))
            picked.append(check_paged_decode(dev, peaks, gen.manual_seed(97), 8, 2048, mode,
                                             layers=3, **nd))
        cases += [{**c, "model": model} for c in picked]
        torch.cuda.empty_cache()
    cases += [
        # every row valid: SDPA computes no more than the kernel needs; at
        # the main path's widths, at llama3-8b's head dim and at a long T
        check_flash_prefill(dev, peaks, gen.manual_seed(6), 8, 512, ragged=False),
        check_flash_prefill(dev, peaks, gen.manual_seed(7), 4, 1024, ragged=False, d=128),
        check_flash_prefill(dev, peaks, gen.manual_seed(8), 1, 4096, ragged=False),
        # the main path's ragged first chunk, last so the kernels line reports it
        check_flash_prefill(dev, peaks, gen.manual_seed(0), 8, 512),
        # decode at llama3-8b's widths (Hq 32, Hkv 8, D 128), before the D=64
        # cases so the kernels line reports the main path's shape
        check_paged_decode(dev, peaks, gen.manual_seed(9), 32, 2048, None, d=128),
        # the main paged prefill case at llama3-8b's head dim
        check_paged_prefill(dev, peaks, gen.manual_seed(11), *PAGED_PREFILL_CASES[-1][:3],
                            None, d=128),
    ]
    # llama3-draft's shapes in a draft-model dispatch (its pool is bf16
    # whatever the target's is), at buckets 8 and 64, before the main
    # path's cases so the kernels line reports those: paged decode at a
    # proposal, and over a catch-up window (T = VERIFY_T, 1 to VERIFY_T
    # tokens a row, from an unaligned position) paged prefill and the write
    # at run 1
    draft = dict(heads=(DRAFT_HQ, DRAFT_HKV), layers=DRAFT_L)
    for b in (8, 64):
        cases += [
            check_paged_decode(dev, peaks, gen.manual_seed(60 + b), b, 2048, None, **draft),
            check_paged_prefill(dev, peaks, gen.manual_seed(70 + b), verify_hist(70 + b, b),
                                catchup_lens(70 + b, b), VERIFY_T, None, **draft),
            check_paged_write(dev, peaks, gen.manual_seed(80 + b), b, VERIFY_T, None,
                              starts=verify_hist(80 + b, b), layers=DRAFT_L, hkv=DRAFT_HKV),
        ]
    for mode in MODES:
        # each shape from its own seed, so every pool mode sees the same
        # page tables, lengths and staged rows
        cases += [
            # verify windows at buckets 8 and 64 (runs of one slot, across
            # pages), then one long prompt's chunk (every token valid) and
            # llama3-8b's head dim, before the main path's two shapes so the
            # kernels line reports B=8 T=512 at D=64
            *(check_paged_write(dev, peaks, gen.manual_seed(40 + b), b, VERIFY_T, mode,
                                starts=verify_hist(40 + b, b)) for b in (8, 64)),
            check_paged_write(dev, peaks, gen.manual_seed(12), 1, 512, mode, full=True),
            check_paged_write(dev, peaks, gen.manual_seed(13), 8, 512, mode, d=128),
            check_paged_write(dev, peaks, gen.manual_seed(1), 32, 1, mode),
            check_paged_write(dev, peaks, gen.manual_seed(2), 8, 512, mode),
            check_paged_decode(dev, peaks, gen.manual_seed(3), 1, 2048, mode),
            check_paged_decode(dev, peaks, gen.manual_seed(4), 32, 2048, mode),
        ] + [
            # verify windows at buckets 8 and 64 over unaligned histories
            check_paged_prefill(dev, peaks, gen.manual_seed(50 + b), verify_hist(50 + b, b),
                                [VERIFY_T] * b, VERIFY_T, mode)
            for b in (8, 64)
        ] + [
            check_paged_prefill(dev, peaks, gen.manual_seed(seed), hist, cur, t, mode)
            for hist, cur, t, seed in PAGED_PREFILL_CASES
        ]
        torch.cuda.empty_cache()
    return cases


# -- phase 4: the model gate ------------------------------------------------------


def logit_gap(a: torch.Tensor, b: torch.Tensor) -> tuple[float, int, int]:
    """Two paths' logits [T, V] at the same positions: (max |delta logit|,
    positions whose argmax agrees, positions)."""
    d = (a.float() - b.float()).abs().amax(dim=-1)
    return d.max().item(), int((a.argmax(-1) == b.argmax(-1)).sum()), a.shape[0]


def other_argmax(a: torch.Tensor, b: torch.Tensor, fed: torch.Tensor) -> tuple[int, int]:
    """Two paths' logits [T, V] and the token fed at each position [T]:
    (positions whose argmax over every token but the fed one agrees,
    positions whose argmax in `b` is the fed token). Tied embeddings
    scaled by sqrt(H) (Gemma) under random weights leave the fed token's
    own embedding in the last hidden state, large enough that its logit
    is the largest whatever attention computed, so the plain argmax reads
    the input back; with the fed token left out, the argmax rests on what
    the layers added."""
    rows = torch.arange(a.shape[0], device=a.device)
    fed_top = int((b.argmax(-1) == fed).sum())
    a, b = a.float().clone(), b.float().clone()
    a[rows, fed] = b[rows, fed] = -torch.inf
    return int((a.argmax(-1) == b.argmax(-1)).sum()), fed_top


def rolled_heads(kernels):
    """The gate's control: `kernels` with every attention kernel's output
    heads rolled by one (query head h gets head h + 1's output, as a
    kernel reading the wrong head would), the write untouched."""
    def decode(*a, **k):  # acc [B, Hq, D], m and l [B, Hq]
        return tuple(torch.roll(x, 1, 1) for x in kernels.paged_decode_attention(*a, **k))

    return kernels._replace(  # out [B, T, Hq, D]
        flash_prefill_attention=lambda *a, **k: torch.roll(
            kernels.flash_prefill_attention(*a, **k), 1, 2),
        paged_prefill_attention=lambda *a, **k: torch.roll(
            kernels.paged_prefill_attention(*a, **k), 1, 2),
        paged_decode_attention=decode)


def gate_paths(dev, adapter, paths: dict, chunks: tuple, steps: int, label: str,
               controls: tuple = ()) -> dict:
    """The model gate's teacher-forced run: every path of `paths` (name ->
    (ops, params, pool mode)), each over a pool of its own, takes one
    random prompt of sum(chunks) tokens chunk by chunk (the first a first
    chunk, each later one over its history), then `steps` decode steps,
    every path taking the plain path's greedy token. Returns, for each
    other path but `controls`, ("kernel", path), and for each of
    `controls`, (control, "plain") -> [max |delta logit|, positions whose
    argmax agrees, positions, positions whose argmax but the fed token
    agrees, positions whose argmax in the second path is the fed token]
    (other_argmax); raises once the kernel path is GATE_MAX_DLOGIT or
    more from the plain path at a step."""
    from dynamo_tpu_torch.models import llama

    cfg = adapter.config
    prompt_len = sum(chunks)
    num_pages = 2 + (prompt_len + steps) // S
    pt = torch.arange(1, num_pages, dtype=torch.int32, device=dev)[None]
    pools = {name: adapter.init_kv(num_pages, S, dev, kv_quantize=m)
             for name, (_, _, m) in paths.items()}
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (1, prompt_len), generator=gen, device=dev)
    stats = {("kernel", name): [0.0, 0, 0, 0, 0] for name in paths
             if name != "kernel" and name not in controls}
    stats.update({(name, "plain"): [0.0, 0, 0, 0, 0] for name in controls})

    def run_all(tok, pos, first_chunk):
        out = {}
        val = torch.ones(tok.shape, dtype=torch.bool, device=dev)
        for name, (path_ops, path_params, _) in paths.items():
            out[name], _ = llama.forward(path_params, cfg, tok, pos, val, pools[name],
                                         pt, first_chunk=first_chunk, ops=path_ops)
        return {k: v[0] for k, v in out.items()}  # [T, V] each

    def gate(out, step, fed):
        for (a, b_), st in stats.items():
            worst, agree, rows = logit_gap(out[a], out[b_])
            other, fed_top = other_argmax(out[a], out[b_], fed)
            st[0] = max(st[0], worst)
            st[1] += agree
            st[2] += rows
            st[3] += other
            st[4] += fed_top
            if (a, b_) == ("kernel", "plain") and worst >= GATE_MAX_DLOGIT:
                raise AssertionError(f"{label}: step {step} max |dlogit| {worst}")

    with torch.no_grad():
        start = 0
        for i, n in enumerate(chunks):  # the prompt, chunk by chunk
            pos = torch.arange(start, start + n, dtype=torch.int32, device=dev)[None]
            out = run_all(tokens[:, start:start + n], pos, start == 0)
            gate(out, f"chunk {i}", tokens[0, start:start + n])
            start += n
        nxt = out["plain"][-1].argmax()
        for step in range(steps):
            # teacher forcing: every path takes the plain path's greedy token
            pos = torch.tensor([[prompt_len + step]], dtype=torch.int32, device=dev)
            out = run_all(nxt.view(1, 1), pos, False)
            gate(out, step, nxt.view(1))
            nxt = out["plain"][-1].argmax()
    return stats


def phase_model(dev) -> list[dict]:
    """The model gate over a prompt in one first chunk, and over a longer
    prompt in chunks whose later ones attend over their history, over a
    bf16 pool and over an int8 and an fp8 pool; then with int8 weights
    (quantize_params_int8 of the same weights) over a bf16 and an int8
    pool. Every path takes the plain path's greedy token (teacher
    forcing)."""
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.models.registry import get_model

    adapter = get_model("llama3-1b", dtype="bfloat16")
    weights = {None: adapter.init_params(torch.Generator(device=dev).manual_seed(0))}
    weights["int8"] = llama.quantize_params_int8(weights[None])
    # (weights, pool mode, chunks, decode steps)
    gates = [(None, None, (256,), 32), (None, None, (512, 512, 256), 32),
             (None, "int8", (512, 512, 256), 32), (None, "fp8", (512, 512, 256), 32),
             ("int8", None, (512, 256), 16), ("int8", "int8", (512, 256), 16)]
    results = []
    with torch.no_grad():
        for quantize, mode, chunks, steps in gates:
            params = weights[quantize]
            # path name -> (ops, params, pool mode): "bf16" is the kernel path
            # over a bf16 pool, "bf16_weights" over the unquantized weights
            paths = {"kernel": (ops.KERNELS, params, mode), "plain": (ops.PLAIN, params, mode)}
            if mode is not None:
                paths["bf16"] = (ops.KERNELS, params, None)
            if quantize is not None:
                paths["bf16_weights"] = (ops.KERNELS, weights[None], mode)
            label = (f"model gate, {quantize or 'bf16'} weights, {mode or 'bf16'} pool, "
                     f"chunks {chunks}")
            stats = gate_paths(dev, adapter, paths, chunks, steps, label)
            prompt_len = sum(chunks)
            worst, agree, rows = stats[("kernel", "plain")][:3]
            rate = agree / rows
            result = {"phase": "model", "model": "llama3-1b", "dtype": "bfloat16",
                      "quantize": quantize, "kv_quantize": mode, "prompt": prompt_len,
                      "chunks": list(chunks), "decode_steps": steps,
                      "max_abs_dlogit": worst, "argmax_agreement": rate,
                      "gate": f"kernel path against plain path: max |dlogit| < "
                              f"{GATE_MAX_DLOGIT}, argmax agreement >= {GATE_ARGMAX}"}
            if mode is not None:
                qw, qa, qr = stats[("kernel", "bf16")][:3]
                result.update({"vs_bf16_pool_max_abs_dlogit": qw,
                               "vs_bf16_pool_argmax_agreement": qa / qr,
                               "vs_bf16_pool": "the quantized kernel path against the bf16 "
                                               "kernel path, reported without a gate"})
            if quantize is not None:
                qw, qa, qr = stats[("kernel", "bf16_weights")][:3]
                result.update({"vs_bf16_weights_max_abs_dlogit": qw,
                               "vs_bf16_weights_argmax_agreement": qa / qr,
                               "vs_bf16_weights": "the int8-weight kernel path against the "
                                                  "bf16-weight kernel path over the same "
                                                  "pool mode, reported without a gate"})
            emit(result)
            if rate < GATE_ARGMAX:
                raise AssertionError(f"{label}: argmax agreement {rate} < {GATE_ARGMAX}")
            results.append(result)
    del weights, params
    torch.cuda.empty_cache()
    return results


# -- phase "families": Qwen2, Qwen3 and Phi-4 at full width --------------------

#: the presets the phase gates, in the order it loads them (one at a time)
FAMILY_PRESETS = ("qwen2-0.5b", "qwen2-7b", "qwen3-8b", "phi4", "phi3-mini", "gemma-2b",
                  "gemma-7b")
#: the presets the gate also runs over an int8 pool
FAMILY_INT8_POOL = ("qwen2-7b", "gemma-2b")
#: the presets whose bf16-pool gate also runs a kernel path that reads the
#: wrong head (rolled_heads), which the gate must fail: the scaled, tied
#: embeddings whose fed token tops the plain argmax (other_argmax)
FAMILY_CONTROL = ("gemma-2b", "gemma-7b")
#: the gate's prompt: a first chunk of 512 and a chunk with history of 256,
#: then 16 decode steps
FAMILY_CHUNKS, FAMILY_STEPS = (512, 256), 16
#: a preset the port registers but one card cannot hold
FAMILY_TOO_LARGE = "llama3-70b"
#: the CLI's servers for the phase's HTTP requests: the defaults but the
#: model and the port
FAMILY_SERVE_ARGV = ["run", "in=http", "out=torch", "--model", "qwen2-7b", "--port", "0"]
GEMMA_SERVE_ARGV = ["run", "in=http", "out=torch", "--model", "gemma-2b", "--port", "0"]
#: the other presets one card holds, each served one request through the CLI
FAMILY_CLI = ("qwen2-0.5b", "qwen3-8b", "phi4", "deepseek-r1-distill-llama-8b", "phi3-mini",
              "gemma-7b")


def live_params(params: dict, dev, seed: int, unit_offset: bool = False) -> dict:
    """Random init's zero q/k/v biases and unit q/k norm weights drawn from
    `seed` instead (biases N(0, 0.02), norms 1 + N(0, 0.1)), and with
    `unit_offset` (a Gemma norm scales by 1 + w) the attn, mlp and final
    norm weights N(0, 0.1), so both paths of the gate run the family's ops
    on values that change the logits."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    layers = dict(params["layers"])
    out = {**params, "layers": layers}
    draws = [(layers, "bq", 0.0, 0.02), (layers, "bk", 0.0, 0.02), (layers, "bv", 0.0, 0.02),
             (layers, "q_norm", 1.0, 0.1), (layers, "k_norm", 1.0, 0.1)]
    if unit_offset:
        draws += [(layers, "attn_norm", 0.0, 0.1), (layers, "mlp_norm", 0.0, 0.1),
                  (out, "final_norm", 0.0, 0.1)]
    for tree, name, mean, std in draws:
        if name in tree:
            x = tree[name]
            draw = torch.randn(x.shape, generator=gen, device=dev)
            tree[name] = (mean + std * draw).to(x.dtype)
    return out


def config_param_bytes(cfg) -> int:
    """Bytes of a llama config's params in bf16, from its shapes."""
    h, i, v, L = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size, cfg.num_layers
    qd, kvd = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    layer = 2 * h * qd + 2 * h * kvd + 3 * h * i + 2 * h
    layer += (qd + 2 * kvd) * cfg.attention_bias + 2 * cfg.head_dim * cfg.qk_norm
    return 2 * (L * layer + v * h * (1 if cfg.tie_word_embeddings else 2) + h)


def serve_family(dev, card: str, argv: list[str]) -> dict:
    """argv's model (qwen2-7b, gemma-2b) through the CLI's server at its
    defaults (graphs, overlap,
    mixed steps, prefix caching, chunk 512): one at a time, a short chat, a
    chat whose prompt takes two chunks and one that shares its first pages
    (a prefix hit), each held against an eager twin (the same config and
    weights, cuda_graphs=False) serving the same prompts one at a time;
    then three streaming chats and a prompt of three chunks together, which
    must run mixed steps. Every request answers 200 with usage counting the
    ids served; the served variants launch, no plain version runs, and
    every dispatch replays a graph."""
    from dynamo_tpu_torch.cli import run as cli_run
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.model_card import ModelDeploymentCard

    model = argv[argv.index("--model") + 1]
    args = cli_run._parse(argv)
    if not (args.prefill_chunk == 512 and args.page_size == S and args.dtype == "bfloat16"
            and args.overlap_decode and args.mixed_steps):
        raise AssertionError(f"families serve: the CLI's defaults changed: {args}")
    chat_url = "/v1/chat/completions"
    ext = {"ignore_eos": True, "return_token_ids": True}
    stream = {"stream": True, "stream_options": {"include_usage": True}}
    lead = "Explain what a paged KV cache is, page by page. " * 13  # 637 bytes
    held = {"short": ([{"role": "user", "content": "a short question"}], 24),
            "two_chunks": ([{"role": "user", "content": lead + "First answer."}], 16),
            "hit": ([{"role": "user", "content": lead + "Second answer, please."}], 16)}
    tok = ByteTokenizer()
    server = cli_run.start_server(argv)
    try:
        ops.reset_counts()
        served, cached = {}, {}
        for rid, (messages, n) in held.items():
            status, out, ids, _ = _post(server.url + chat_url, {
                "model": model, "messages": messages, "max_tokens": n, "temperature": 0,
                "ext": ext, **stream})
            use = out[-1]["usage"]
            prompt = tok.encode(tok.apply_chat_template(messages))
            if not (status == 200 and len(ids) == n == use["completion_tokens"]
                    and use["prompt_tokens"] == len(prompt)):
                raise AssertionError(f"families serve: {rid}: {status}, usage {use}, "
                                     f"{len(ids)} ids, {len(prompt)} prompt tokens")
            served[rid] = ids
            cached[rid] = (use.get("prompt_tokens_details") or {}).get("cached_tokens", 0)
        long_prompt = [{"role": "user", "content": "a long prompt: " + "abcdefgh " * 135}]
        wave = [{"model": model, "messages": [{"role": "user", "content": f"stream {i}"}],
                 "max_tokens": 64, "ext": ext, **stream} for i in range(3)]
        wave.append({"model": model, "messages": long_prompt, "max_tokens": 16, "ext": ext,
                     **stream})
        results = post_together([(server.url + chat_url, body) for body in wave])
        torch.cuda.synchronize()
        for body, (status, out, ids, _) in zip(wave, results):
            if not (status == 200 and len(ids) == body["max_tokens"]
                    == out[-1]["usage"]["completion_tokens"]):
                raise AssertionError(f"families serve: the wave: {status}, {len(ids)} ids")
        counts = {k: (c.launches, c.plain_calls) for k, c in ops.COUNTS.items()}
        engine = server.runner.engine
        m = engine.metrics
        graphs = {k: getattr(m, k) for k in ("compiles", "compile_ms", "prefill_dispatches",
                                             "decode_dispatches", "mixed_dispatches",
                                             "overlap_hits", "overlap_rollbacks")}
        if not (replays_match(m, engine.dispatches) and m.mixed_dispatches > 0
                and m.decode_replays > 0):
            raise AssertionError(f"families serve: dispatches did not all replay graphs, or "
                                 f"no mixed step ran: {m.to_dict()}")
        params, cfg = engine.params, engine.config
        del engine
    finally:
        server.stop()
        free_server(server)
        del server
    want = serve_variants(None)
    for name, (launches, plain) in counts.items():
        if plain != 0 or (launches == 0) == (name in want):
            raise AssertionError(f"families serve: {name} launched {launches} times, plain "
                                 f"ran {plain} (the bf16 pool's variants: {want})")
    if not (cached["short"] == 0 and cached["two_chunks"] == 0 and cached["hit"] >= 576):
        raise AssertionError(f"families serve: cached tokens {cached}")
    # the eager twin: the same prompts one at a time, greedy, over the
    # same weights and config
    eager = TorchEngine(cfg, params=params, device=dev, cuda_graphs=False)
    twin, twin_cached = {}, {}
    for rid, (messages, n) in held.items():
        prompt = tok.encode(tok.apply_chat_template(messages))
        streams, first = serve_requests(eager, {rid: prompt}, n)
        twin.update(streams)
        twin_cached.update(first)
    same_streams(f"families serve, {model}", twin, served, "the server's streams")
    if twin_cached != cached:
        raise AssertionError(f"families serve: cached tokens {cached}, eager twin "
                             f"{twin_cached}")
    del eager, params
    free_memory()
    return {"model": model, "argv": argv, "card": card,
            "eos_token_ids": list(ModelDeploymentCard(name=model).eos_token_ids),
            "held_prompt_tokens": {rid: len(tok.encode(tok.apply_chat_template(m)))
                                   for rid, (m, _) in held.items()},
            "cached_tokens": cached, "wave_requests": len(wave), **graphs,
            "launches": {k: v[0] for k, v in counts.items() if k in want},
            "identical": "the three held requests' streams and cached tokens, to the id, "
                         "in the server and in its eager twin"}


def free_memory() -> None:
    """Collect what earlier work left in reference cycles (an engine holds
    itself through its step functions and a server's handlers hold its
    runner, so an engine's weights, pools and graphs go at a collection,
    not when its last name does) and hand the memory back to the card."""
    gc.collect()
    torch.cuda.empty_cache()


def free_server(server) -> None:
    """Drop a stopped server's engine and free its memory (free_memory)."""
    server.runner.engine = None
    free_memory()


def serve_once(model: str) -> dict:
    """`model` through the CLI's server at its defaults: one streamed chat
    whose prompt takes two chunks, 16 greedy tokens. It must answer 200
    with usage counting the ids served, launch the bf16 pool's variants and
    no plain version, and replay a graph for every dispatch."""
    from dynamo_tpu_torch.cli.run import start_server

    server = start_server(["run", "in=http", "out=torch", "--model", model, "--port", "0"])
    try:
        pool_bytes = server.runner.engine.metrics.kv_pool_bytes
        ops.reset_counts()
        content = "Say what a prefill chunk is. " * 22  # 638 bytes: two chunks
        status, out, ids, ttft = _post(server.url + "/v1/chat/completions", {
            "model": model, "messages": [{"role": "user", "content": content}],
            "max_tokens": 16, "temperature": 0, "stream": True,
            "stream_options": {"include_usage": True},
            "ext": {"ignore_eos": True, "return_token_ids": True}})
        torch.cuda.synchronize()
        counts = {k: (c.launches, c.plain_calls) for k, c in ops.COUNTS.items()}
        engine = server.runner.engine
        m = engine.metrics
        line = {"model": model, "kv_pool_bytes": pool_bytes, "status": status,
                "tokens": len(ids),
                "prompt_tokens": out[-1]["usage"]["prompt_tokens"], "ttft_s": ttft,
                "compiles": m.compiles, "compile_ms": m.compile_ms,
                "prefill_dispatches": m.prefill_dispatches, "decode_replays": m.decode_replays}
        ok = (status == 200 and len(ids) == 16 == out[-1]["usage"]["completion_tokens"]
              and line["prompt_tokens"] > 512 and replays_match(m, engine.dispatches)
              and m.prefill_dispatches == 2)
        del engine
    finally:
        server.stop()
        free_server(server)
        del server
    want = serve_variants(None)
    if not ok or any(plain or (n == 0) == (name in want) for name, (n, plain) in counts.items()):
        raise AssertionError(f"families serve, {model}: {line}, launches {counts}")
    return line


def phase_families(dev, card: str) -> dict:
    """The model gate (gate_paths: kernel path against plain path) for each
    of FAMILY_PRESETS at full width and depth, random bf16 weights with
    live biases, q/k norms and Gemma norms, over a first chunk of 512, a
    chunk of 256 with history and 16 decode steps, over a bf16 pool (and,
    for FAMILY_INT8_POOL, an int8 pool), gated on max |dlogit| and on the
    argmax over every token and over every token but the fed one; for
    FAMILY_CONTROL, a kernel path that reads the wrong head must fail the
    gate on both limits; each model freed before the next.
    Prints that llama3-70b is not served on one card, each gate's line,
    the serves' (serve_family: qwen2-7b, gemma-2b), each of FAMILY_CLI's
    one request through the CLI (serve_once) and the phase's seconds.
    Returns the serves' lines by model."""
    from dynamo_tpu_torch.models.registry import get_model

    t_phase = time.perf_counter()
    too_large = get_model(FAMILY_TOO_LARGE).config
    emit({"phase": "families", "model": FAMILY_TOO_LARGE, "served": False,
          "param_bytes_bf16": config_param_bytes(too_large),
          "reason": "its bf16 weights do not fit one card's memory (sized from its config)"})
    for i, name in enumerate(FAMILY_PRESETS):
        t0 = time.perf_counter()
        adapter = get_model(name, dtype="bfloat16")
        cfg = adapter.config
        params = live_params(adapter.init_params(torch.Generator(device=dev).manual_seed(0)),
                             dev, seed=100 + i, unit_offset=cfg.rms_norm_unit_offset)
        held, bf16_bytes = param_bytes(params)
        if bf16_bytes != config_param_bytes(cfg):
            raise AssertionError(f"families: {name} holds {bf16_bytes} bf16 bytes of params, "
                                 f"its config {config_param_bytes(cfg)}")
        for mode in (None, "int8") if name in FAMILY_INT8_POOL else (None,):
            label = f"families gate, {name}, {mode or 'bf16'} pool"
            paths = {"kernel": (ops.KERNELS, params, mode), "plain": (ops.PLAIN, params, mode)}
            controls = ("rolled_heads",) if name in FAMILY_CONTROL and mode is None else ()
            if controls:
                paths["rolled_heads"] = (rolled_heads(ops.KERNELS), params, mode)
            ops.reset_counts()
            stats = gate_paths(dev, adapter, paths, FAMILY_CHUNKS, FAMILY_STEPS, label,
                               controls)
            worst, agree, rows, other, fed_top = stats[("kernel", "plain")]
            launched = {k: c.launches for k, c in ops.COUNTS.items() if c.launches}
            want = serve_variants(mode)
            if sorted(launched) != sorted(want):
                raise AssertionError(f"{label}: launched {launched}, want {want}")
            emit({"phase": "families", "model": name, "dtype": "bfloat16", "kv_quantize": mode,
                  "group": cfg.q_per_kv, "head_dim": cfg.head_dim, "layers": cfg.num_layers,
                  "attention_bias": cfg.attention_bias, "qk_norm": cfg.qk_norm,
                  "hidden_act": cfg.hidden_act, "rms_norm_unit_offset": cfg.rms_norm_unit_offset,
                  "scale_embeddings": cfg.scale_embeddings,
                  "param_bytes": held, "prompt": sum(FAMILY_CHUNKS),
                  "chunks": list(FAMILY_CHUNKS), "decode_steps": FAMILY_STEPS,
                  "max_abs_dlogit": worst, "argmax_agreement": agree / rows,
                  "argmax_agreement_but_fed": other / rows,
                  "plain_argmax_is_fed_token": fed_top / rows,
                  "kernel_launches": launched,
                  "gate": f"kernel path against plain path: max |dlogit| < "
                          f"{GATE_MAX_DLOGIT}, argmax agreement over every token and over "
                          f"every token but the fed one >= {GATE_ARGMAX}",
                  "seconds": time.perf_counter() - t0})
            for what, n in (("argmax", agree), ("argmax but the fed token", other)):
                if n / rows < GATE_ARGMAX:
                    raise AssertionError(f"{label}: {what} agreement {n / rows} < "
                                         f"{GATE_ARGMAX}")
            for control in controls:
                # the gate must fail a kernel path that reads the wrong head,
                # on each limit
                cw, ca, cr, co, _ = stats[(control, "plain")]
                emit({"phase": "families_control", "model": name, "control": control,
                      "max_abs_dlogit": cw, "argmax_agreement": ca / cr,
                      "argmax_agreement_but_fed": co / cr,
                      "expect": f"max |dlogit| >= {GATE_MAX_DLOGIT} and argmax agreement but "
                                f"the fed token < {GATE_ARGMAX}: the gate fails it"})
                if cw < GATE_MAX_DLOGIT or co / cr >= GATE_ARGMAX:
                    raise AssertionError(f"{label}: the {control} control passes a limit of "
                                         f"the gate (max |dlogit| {cw}, argmax but the fed "
                                         f"token {co / cr})")
        del params, adapter, paths
        free_memory()
    serves = {}
    for argv in (FAMILY_SERVE_ARGV, GEMMA_SERVE_ARGV):
        t0 = time.perf_counter()
        serve = serve_family(dev, card, argv)
        emit({"phase": "families_serve", **serve, "seconds": time.perf_counter() - t0})
        serves[serve["model"]] = serve
    for model in FAMILY_CLI:
        t0 = time.perf_counter()
        emit({"phase": "families_cli", **serve_once(model), "card": card,
              "seconds": time.perf_counter() - t0})
    emit({"phase": "families_done", "seconds": time.perf_counter() - t_phase})
    return serves


def replays_match(m, dispatches: int) -> bool:
    """The dispatch identities of an engine whose every dispatch replays a
    captured graph (its EngineMetrics and step-function calls): the
    replays of the three kinds sum to the calls; a prefill step replays
    at least one graph; and each decode or mixed step replays one graph
    but for a step whose decode half was a consumed speculation (replayed
    as a decode graph when it was speculated), while each rolled-back
    speculation replayed one more."""
    return (m.prefill_replays + m.decode_replays + m.mixed_replays == dispatches
            and m.prefill_replays >= m.prefill_dispatches
            and m.decode_replays + m.mixed_replays
            == m.decode_dispatches + m.mixed_dispatches + m.overlap_rollbacks)


def same_streams(label: str, want: dict, got: dict, what: str) -> None:
    """The eager-twin check of every engine phase: raise unless `got`
    (request id -> generated ids) equals the eager loop's `want`, naming
    the requests that differ."""
    if got != want:
        bad = sorted(r for r in want if want[r] != got.get(r))
        raise AssertionError(f"{label}: {what} differ from the eager loop's in {bad}")


# -- phase 4b: step graphs and overlapped decode against the eager loop ----------

#: the served context (--max-context), whose page tables phase 4b's engines share
SERVE_CONTEXT = 2048
#: greedy waves of (requests, max_tokens): buckets 16, 8, 8, 4, 2, 1 and 8
#: at 8, 8, 4, 2, 1, 8 and 8 fused steps; five rows after six in bucket 8
GRAPH_WAVES = ((12, 17), (6, 9), (5, 5), (3, 3), (2, 2), (1, 9), (5, 9))
#: greedy waves of (prompt lengths, max_tokens) at the chunk of 512: one
#: prompt alone in three chunks (a first chunk and a chunk with history
#: that sample nothing, then one that samples), then a second chunk with
#: history beside a prompt's only chunk
LONG_WAVES = (((1100,), 9), ((700, 100), 9))
#: a wave of seeded sampled requests (temperature 0.8, top-p 0.95), the
#: last a prompt of two chunks
SAMPLED_WAVES = ((3, 9), (1, 3), ((600,), 5))
#: output tokens of run_late_arrival's first four requests: at 8 fused
#: steps a dispatch, speculations that are consumed, then one rolled back
LATE_TOKENS = 49
#: phase 4b's engines: (name, cuda_graphs, overlap_decode)
GRAPH_ENGINES = (("eager", False, False), ("graphs", True, False), ("overlap", True, True))


def run_waves(eng, waves, tag: str, repeat: int = 1, **sampling) -> dict[str, list[int]]:
    """Each wave's requests together, prompts of random tokens from a fixed
    seed (a wave's lengths, or 16-280 tokens for a count), greedy unless
    `sampling` says otherwise; a wave (n, max_tokens, rows) gives its i-th
    row the SamplingParams knobs rows[i] on top. With `repeat` > 1 each
    prompt is a random block of length // repeat tokens said `repeat`
    times (what prompt lookup is for). Returns request id -> generated
    ids."""
    from dynamo_tpu_torch.engine.request import SamplingParams

    gen = torch.Generator().manual_seed(3)
    out = {}
    for w, (n, max_tokens, *rows) in enumerate(waves):
        lengths = [16 + 24 * i for i in range(n)] if isinstance(n, int) else n
        for i, length in enumerate(lengths):
            prompt = torch.randint(1, eng.adapter.vocab_size, (length // repeat,),
                                   generator=gen).repeat(repeat)
            knobs = {"max_tokens": max_tokens, "ignore_eos": True, **sampling,
                     **(rows[0][i] if rows else {})}
            eng.add_request(f"{tag}{w}-{i}", prompt.tolist(), SamplingParams(**knobs))
        out.update(eng.run_to_completion())
    return out


def run_late_arrival(eng, tag: str) -> dict[str, list[int]]:
    """Four greedy requests of LATE_TOKENS, and one more added after their
    fourth step, while an overlapped engine has a speculated decode
    dispatch in flight: the newcomer's prefill rolls it back. Returns
    request id -> generated ids."""
    from dynamo_tpu_torch.engine.request import SamplingParams

    gen = torch.Generator().manual_seed(4)

    def add(i: int, max_tokens: int) -> None:
        prompt = torch.randint(1, eng.adapter.vocab_size, (40 + 30 * i,), generator=gen)
        eng.add_request(f"{tag}-{i}", prompt.tolist(),
                        SamplingParams(max_tokens=max_tokens, ignore_eos=True))

    for i in range(4):
        add(i, LATE_TOKENS)
    out: dict[str, list[int]] = {}
    for _ in range(4):
        for o in eng.step():
            out.setdefault(o.request_id, []).extend(o.new_token_ids)
    add(4, 9)
    for rid, ids in eng.run_to_completion().items():
        out.setdefault(rid, []).extend(ids)
    return out


def phase_graphs(dev) -> list[dict]:
    """Prefill and decode graphs, without and with overlapped decode, held
    against the eager loop, in every pool mode."""
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import TorchEngine, key_field
    from dynamo_tpu_torch.models.registry import get_model

    params = get_model("llama3-1b", dtype="bfloat16").init_params(
        torch.Generator(device=dev).manual_seed(0))
    results = []
    for mode in MODES:
        label = f"graphs, {mode or 'bf16'} pool"
        runs = {}
        for name, graphs, overlap in GRAPH_ENGINES:
            # the serve's page-table width (--max-context 2048 over pages of
            # S) and chunk: the split plans and the workspace the serve's
            # graphs run with; prefix caching off, as the 700- and 600-token
            # prompts repeat the 1,100-token one's first tokens and a hit
            # would change their chunks (phase "prefix" serves the hits);
            # mixed steps off: with them an overlapped engine's decode
            # halves run the speculation's K where the synchronous engines
            # run K=1 in the mixed step, so rows meet other decode buckets
            # and bf16 rounding may part the streams (phase "mixed" holds
            # mixed graphs against their eager twin)
            cfg = EngineConfig(model="llama3-1b", num_pages=256, page_size=S,
                               max_pages_per_seq=SERVE_CONTEXT // S, kv_quantize=mode,
                               eos_token_ids=(0,), overlap_decode=overlap,
                               enable_prefix_caching=False, mixed_steps=False)
            eng = TorchEngine(cfg, params=params, device=dev, cuda_graphs=graphs)
            ops.reset_counts()
            t0 = time.perf_counter()
            greedy = run_waves(eng, GRAPH_WAVES, "g")
            m = eng.metrics
            before = (m.prefill_dispatches, m.prefill_replays)
            greedy.update(run_waves(eng, LONG_WAVES[:1], "l"))
            alone = (m.prefill_dispatches - before[0], m.prefill_replays - before[1])
            greedy.update(run_waves(eng, LONG_WAVES[1:], "m"))
            greedy.update(run_late_arrival(eng, "late"))
            sampled = run_waves(eng, SAMPLED_WAVES, "s", temperature=0.8, top_p=0.95, seed=7)
            torch.cuda.synchronize()
            runs[name] = dict(
                eng=eng, streams=(greedy, sampled), alone=alone, s=time.perf_counter() - t0,
                counts={k: (c.launches, c.plain_calls) for k, c in ops.COUNTS.items()})
        want = runs["eager"]["streams"]
        for name in ("graphs", "overlap"):
            for kind, a, b in zip(("greedy", "seeded sampled"), want, runs[name]["streams"]):
                same_streams(label, a, b, f"{kind} streams with {name}")
        eager, graph = runs["eager"]["eng"], runs["graphs"]["eng"]
        if sorted(graph.step_keys) != sorted(eager.step_keys):
            raise AssertionError(f"{label}: graph keys {graph.step_keys}, eager {eager.step_keys}")
        lines = {}
        for name in ("graphs", "overlap"):
            eng, run = runs[name]["eng"], runs[name]
            m = eng.metrics
            prefill = [k for k in eng.step_keys if k[0].startswith("prefill")]
            kinds = {(k[0], key_field(k, "first_chunk")) for k in prefill}
            # every step-function call replayed a graph; with one T bucket a
            # step (the long prompt alone), one replay a prefill dispatch
            ok = (m.compiles == len(eng.step_keys) and replays_match(m, eng.dispatches)
                  and m.prefill_dispatches > 0 and m.decode_replays > 0
                  and m.mixed_dispatches == 0
                  and run["alone"][0] == run["alone"][1] == 3
                  and len(kinds) == 4 and (m.overlap_hits > 0) == (name == "overlap")
                  and (m.overlap_rollbacks > 0) == (name == "overlap"))
            lines[name] = {
                "keys": len(eng.step_keys), "prefill_keys": [list(k) for k in prefill],
                **{k: getattr(m, k) for k in (
                    "compiles", "compile_ms", "prefill_dispatches", "prefill_replays",
                    "decode_dispatches", "decode_replays", "mixed_dispatches",
                    "mixed_replays", "overlap_dispatches", "overlap_hits",
                    "overlap_rollbacks")},
                "dispatches": eng.dispatches, "long_prompt_alone": list(run["alone"]),
                "run_s": run["s"]}
            if not ok:
                raise AssertionError(f"{label}: {name}: captures, replays or overlap counts "
                                     f"wrong: {lines[name]}")
        # splits per decode bucket: above 1, the ticket merge ran in the graphs
        mc = graph.adapter.config
        splits = {k[1]: paged_attention.launch_plan(dev, k[1], mc.num_heads, mc.num_kv_heads,
                                                    mc.head_dim, cfg.max_pages_per_seq, mode)[0]
                  for k in graph.step_keys if k[0].startswith("decode")}
        if max(splits.values()) < 2:
            raise AssertionError(f"{label}: no decode bucket split its pages: {splits}")
        # the overlap run: every kernel variant of its pool, through replays
        counts = runs["overlap"]["counts"]
        want_launch = serve_variants(mode)
        for name, (launches, plain) in counts.items():
            if plain != 0 or (launches == 0) == (name in want_launch):
                raise AssertionError(f"{label}: {name} launched {launches} times, plain ran "
                                     f"{plain} (the pool's variants: {want_launch})")
        result = {"phase": "graphs", "model": "llama3-1b", "dtype": "bfloat16",
                  "kv_quantize": mode, "max_pages_per_seq": cfg.max_pages_per_seq,
                  "splits_by_bucket": splits, **lines,
                  "streams": len(want[0]) + len(want[1]),
                  "identical": "every greedy and seeded sampled stream, to the id, in the "
                               "eager loop, with graphs, and with graphs and overlap",
                  "launches": {k: v[0] for k, v in counts.items() if v[0]},
                  "eager_run_s": runs["eager"]["s"],
                  "run_s": "wall time of all waves, a graph run's captures included"}
        emit(result)
        results.append(result)
        del runs, eager, graph, eng
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    return results


def phase_int8_graphs(dev) -> dict:
    """Two llama3-1b engines with quantize="int8" and no params (each draws
    its int8 weights from seed 0: init_params_int8), overlapped decode and
    mixed steps on: the eager loop (cuda_graphs=False) and step graphs.
    Greedy waves, the 1,100-token prompt (a first chunk and chunks with
    history) and a late arrival, whose prefill joins the decoding rows in
    mixed steps: every stream identical; decode, chunk and mixed keys
    captured once and replayed (phase 4b's identities); int8_matmul
    launched through the replays, no plain version."""
    from dynamo_tpu_torch.engine.config import EngineConfig
    from dynamo_tpu_torch.engine.engine import DECODE_KINDS, TorchEngine, key_field

    label = "graphs, int8 weights"
    runs = {}
    for name, graphs in (("eager", False), ("graphs", True)):
        cfg = EngineConfig(model="llama3-1b", num_pages=256, page_size=S,
                           max_pages_per_seq=SERVE_CONTEXT // S, quantize="int8",
                           eos_token_ids=(0,), enable_prefix_caching=False)
        eng = TorchEngine(cfg, device=dev, cuda_graphs=graphs)
        ops.reset_counts()
        t0 = time.perf_counter()
        streams = run_waves(eng, GRAPH_WAVES[:4] + LONG_WAVES, "g")
        streams.update(run_late_arrival(eng, "late"))
        torch.cuda.synchronize()
        runs[name] = dict(eng=eng, streams=streams, s=time.perf_counter() - t0,
                          counts={k: (c.launches, c.plain_calls) for k, c in ops.COUNTS.items()})
    want = runs["eager"]["streams"]
    same_streams(label, want, runs["graphs"]["streams"], "streams with graphs")
    eng = runs["graphs"]["eng"]
    m = eng.metrics
    kinds = {(k[0], key_field(k, "first_chunk")) for k in eng.step_keys
             if k[0] not in DECODE_KINDS}
    counts = runs["graphs"]["counts"]
    line = {k: getattr(m, k) for k in (
        "compiles", "prefill_dispatches", "prefill_replays", "decode_dispatches",
        "decode_replays", "mixed_dispatches", "mixed_replays", "overlap_dispatches",
        "overlap_hits", "overlap_rollbacks")}
    ok = (m.compiles == len(eng.step_keys) and replays_match(m, eng.dispatches)
          and m.mixed_replays > 0 and m.decode_replays > 0 and m.overlap_hits > 0
          and any(kind.startswith("prefill") and first is False for kind, first in kinds)
          and eng.params["layers"]["wq"].dtype == torch.int8
          and counts["int8_matmul"][0] > 0
          and all(plain == 0 for _, plain in counts.values()))
    result = {"phase": "int8_graphs", "model": "llama3-1b", "dtype": "bfloat16",
              "quantize": "int8", **line, "dispatches": eng.dispatches,
              "keys": sorted({k[0] for k in eng.step_keys}), "streams": len(want),
              "identical": "every greedy stream, to the id, in the eager loop and with graphs, "
                           "both with overlapped decode and mixed steps",
              "launches": {k: v[0] for k, v in counts.items() if v[0]},
              "eager_run_s": runs["eager"]["s"], "run_s": runs["graphs"]["s"]}
    emit(result)
    if not ok:
        raise AssertionError(f"{label}: captures, replays, launches or counts wrong: {result}")
    del runs, eng
    torch.cuda.empty_cache()
    return result


# -- phase "prefix": prefix caching at the CLI's defaults -------------------------

#: the shared prefix (17 whole pages of 64 and 12 tokens of an 18th) and the
#: warm request's tail
PREFIX_LEN, WARM_TAIL = 1100, 40
#: the wave: tails after the shared prefix (the 700-token one's uncached
#: 712 tokens span two chunks of 512), beside a prompt of the prefix's 17
#: whole pages (cached whole: its last page is recomputed) and a prompt of
#: COLD_LEN tokens that shares no page
WAVE_TAILS = (1, 63, 200, 700)
COLD_LEN = 300
#: greedy tokens a request: the warm one's, then each wave request's
WARM_TOKENS, WAVE_TOKENS = 16, 24
#: the tail of the hit timed against the same prompt served cold
TIMED_TAIL = 200


def prefix_prompts(vocab: int) -> tuple[list[int], dict[str, list[int]], list[int]]:
    """(the warm request's prompt, the wave's prompts by request id, the
    shared prefix), random tokens from a fixed seed."""
    gen = torch.Generator().manual_seed(17)
    draw = lambda n: torch.randint(1, vocab, (n,), generator=gen).tolist()  # noqa: E731
    prefix = draw(PREFIX_LEN)
    warm = prefix + draw(WARM_TAIL)
    wave = {f"tail{n}": prefix + draw(n) for n in WAVE_TAILS}
    wave["whole"] = prefix[: (PREFIX_LEN // S) * S]
    wave["cold"] = draw(COLD_LEN)
    return warm, wave, prefix


def serve_requests(eng, prompts: dict[str, list[int]], max_tokens: int
                   ) -> tuple[dict[str, list[int]], dict[str, int]]:
    """The requests together, greedy, to completion: (request id -> ids,
    request id -> cached_tokens of its first output)."""
    from dynamo_tpu_torch.engine.request import SamplingParams

    for rid, prompt in prompts.items():
        eng.add_request(rid, prompt, SamplingParams(max_tokens=max_tokens, ignore_eos=True))
    streams: dict[str, list[int]] = {}
    cached: dict[str, int] = {}
    while eng.has_work:
        for o in eng.step():
            streams.setdefault(o.request_id, []).extend(o.new_token_ids)
            if o.cached_tokens is not None:
                cached.setdefault(o.request_id, o.cached_tokens)
    return streams, cached


def page_bytes(eng, pages) -> list[torch.Tensor]:
    """Copies of the pages' K and V rows and scale planes, every layer."""
    idx = torch.tensor(sorted(pages), device=eng.kv.k.device)
    return [as_bytes(x[:, idx]).clone() for x in eng.kv if x is not None]


def synced_ttft_ms(eng, rid: str, prompt: list[int]) -> tuple[float, int]:
    """(ms from a synced device and the request's arrival to its first
    token on the host, the prompt tokens the cache served) for one request
    alone."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, cached = serve_requests(eng, {rid: prompt}, 1)
    return (time.perf_counter() - t0) * 1e3, cached[rid]


def hash_ms(prompt: list[int], salt: str) -> dict:
    """Host ms of the chain of one prompt (its full blocks of S), and of
    appending a decode wave's tokens (WAVE_TOKENS to each of six chains)."""
    from dynamo_tpu_torch.tokens import TokenBlockSequence

    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        TokenBlockSequence(prompt, block_size=S, salt=salt)
    chain_ms = (time.perf_counter() - t0) * 1e3 / reps
    chains = [TokenBlockSequence(prompt[: S * 10 + 7 * i], block_size=S, salt=salt)
              for i in range(6)]
    t0 = time.perf_counter()
    for chain in chains:
        for t in range(WAVE_TOKENS):
            chain.append(t)
    wave_ms = (time.perf_counter() - t0) * 1e3
    return {"prompt_tokens": len(prompt), "chain_ms": chain_ms,
            "decode_wave_append_ms": wave_ms, "decode_wave_tokens": 6 * WAVE_TOKENS}


def prefix_gate(dev, adapter, params, mode, warm: list[int], hit: list[int]) -> dict:
    """The model gate on the hit path: the hit prompt's uncached tokens
    computed as a chunk with history over the pages the warm prompt's own
    forward wrote (its chunks of 512), against a cold forward of the whole
    hit prompt in chunks of 512 into fresh pages, by the kernel path and by
    the plain path, each at the positions of the hit's piece."""
    from dynamo_tpu_torch.models import llama

    cfg = adapter.config
    cached = PREFIX_LEN // S * S  # the hit prompt shares the warm one's prefix
    pages = -(-len(hit) // S) + -(-len(warm) // S) + 1

    def forward(pool, path_ops, tokens, start, pt):
        """Logits of tokens[start:], padded as the engine pads a piece (to
        its T bucket: a power of two from 32)."""
        n = len(tokens) - start
        t = 32
        while t < n:
            t *= 2
        tok = torch.zeros((1, t), dtype=torch.long, device=dev)
        tok[0, :n] = torch.tensor(tokens[start:], device=dev)
        pos = torch.arange(start, start + t, dtype=torch.int32, device=dev)[None]
        val = (torch.arange(t, device=dev) < n)[None]
        logits, _ = llama.forward(params, cfg, tok, pos, val, pool, pt,
                                  first_chunk=start == 0, ops=path_ops)
        return logits[0, :n]

    def chunked(pool, path_ops, tokens, pt):
        out = None
        for start in range(0, len(tokens), 512):
            out = forward(pool, path_ops, tokens[: start + 512], start, pt)
        return out

    with torch.no_grad():
        pool = adapter.init_kv(pages, S, dev, kv_quantize=mode)
        n_warm = -(-len(warm) // S)
        warm_pt = torch.arange(1, 1 + n_warm, dtype=torch.int32, device=dev)[None]
        chunked(pool, ops.KERNELS, warm, warm_pt)
        # the hit's table: the warm prompt's cached pages, then fresh ones
        fresh = torch.arange(1 + n_warm, pages, dtype=torch.int32, device=dev)
        hit_pt = torch.cat([warm_pt[0, : cached // S], fresh])[None]
        got = forward(pool, ops.KERNELS, hit, cached, hit_pt)
        result = {"cached_tokens": cached, "piece_tokens": len(hit) - cached}
        for name, path_ops in (("kernel", ops.KERNELS), ("plain", ops.PLAIN)):
            cold = adapter.init_kv(pages, S, dev, kv_quantize=mode)
            cold_pt = torch.arange(1, pages, dtype=torch.int32, device=dev)[None]
            want = chunked(cold, path_ops, hit, cold_pt)
            rows = len(hit) - cached
            worst, agree, n = logit_gap(got, want[-rows:])
            result[f"vs_cold_{name}"] = {"max_abs_dlogit": worst, "argmax_agreement": agree / n}
            if not (worst < GATE_MAX_DLOGIT and agree / n >= GATE_ARGMAX):
                raise AssertionError(f"prefix gate, {mode or 'bf16'} pool: the hit path against "
                                     f"the cold {name} path: max |dlogit| {worst}, argmax "
                                     f"agreement {agree / n}")
            del cold
        del pool
    return result


def phase_prefix(dev, card: str) -> list[dict]:
    """Prefix caching on one TorchEngine per pool mode, built as the CLI
    builds it with no flags but the model, the pool mode and the serve's
    context (caching, graphs and overlapped decode on, chunk 512, page 64).
    A warm request, then a wave that hits its pages: cached_tokens on each
    first output, the registered pages' bytes unchanged, the hits' pieces
    run through paged prefill, no eviction, the dispatch identities of
    phase 4b; then clear_cache() and the warm request and the wave again,
    bit for bit; the same on an eager twin (cuda_graphs=False), bit for
    bit; the model gate on the hit path; printed, not gated: the
    hash's host ms and a hit's synced engine TTFT against the same prompt
    served cold."""
    from dynamo_tpu_torch.cli import run as cli_run
    from dynamo_tpu_torch.engine.engine import TorchEngine, key_field
    from dynamo_tpu_torch.engine.step_graph import StepGraph
    from dynamo_tpu_torch.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.models.registry import get_model

    adapter = get_model("llama3-1b", dtype="bfloat16")
    params = adapter.init_params(torch.Generator(device=dev).manual_seed(0))
    warm, wave, prefix = prefix_prompts(adapter.vocab_size)
    full = PREFIX_LEN // S * S
    want_cached = {**{f"tail{n}": full for n in WAVE_TAILS}, "whole": full - S, "cold": 0}
    results = []
    for mode in MODES:
        label = f"prefix, {mode or 'bf16'} pool"
        t_mode = time.perf_counter()
        argv = ["run", "--model", "llama3-1b", "--max-context", str(SERVE_CONTEXT)]
        args = cli_run._parse(argv + (["--kv-quantize", mode] if mode else []))
        cfg = cli_run.engine_config(args, ModelDeploymentCard(name=args.model).eos_token_ids)
        events = []
        eng = TorchEngine(cfg, params=params, device=dev, on_kv_event=events.append)
        if not (cfg.enable_prefix_caching and cfg.overlap_decode and eng._graphs
                and cfg.prefill_chunk == 512 and cfg.page_size == S):
            raise AssertionError(f"{label}: the CLI's defaults changed: {cfg}")
        runs = []
        for round_ in range(2):
            warm_out = serve_requests(eng, {"warm": warm}, WARM_TOKENS)
            pages = sorted(eng.allocator._page_meta)
            if len(pages) != PREFIX_LEN // S:
                raise AssertionError(f"{label}: the warm request registered {len(pages)} pages")
            before = page_bytes(eng, pages)
            m = eng.metrics
            replays = {k: g.replays for k, g in eng._step_fns.items() if isinstance(g, StepGraph)}
            prefill_tokens = m.prefill_tokens
            n_events = len(events)  # clear_cache() emits `removed` too
            ops.reset_counts()
            out = serve_requests(eng, wave, WAVE_TOKENS)
            torch.cuda.synchronize()
            launches = {k: c.launches for k, c in ops.COUNTS.items() if c.launches}
            runs.append((warm_out, out))
            if out[1] != want_cached:
                raise AssertionError(f"{label}: cached_tokens {out[1]}, want {want_cached}")
            if not all(torch.equal(a, b) for a, b in zip(before, page_bytes(eng, pages))):
                raise AssertionError(f"{label}: a wave that hit the cached pages wrote them")
            uncached = sum(len(p) - out[1][rid] for rid, p in wave.items())
            if m.prefill_tokens - prefill_tokens != uncached:
                raise AssertionError(f"{label}: prefilled {m.prefill_tokens - prefill_tokens} "
                                     f"tokens, {uncached} uncached")
            # the hits' pieces all have history: paged prefill launches one
            # per layer for each replay (and capture warm-up) of a chunk
            # key with history, prefill or mixed, through the graphs
            paged = kv_quant.variant("paged_prefill_attention", mode)
            with_history = sum(
                (g.replays - replays.get(k, 0) + (k not in replays))
                * g.launches.get(paged, (0, 0))[0]
                for k, g in eng._step_fns.items()
                if isinstance(g, StepGraph) and k[0] not in ("decode", "decode_multi")
                and not key_field(k, "first_chunk"))
            if not launches.get(paged, 0) == with_history > 0:
                raise AssertionError(f"{label}: {paged} launched {launches.get(paged, 0)} times "
                                     f"in the wave, {with_history} by the chunk keys")
            if any(e.kind == "removed" for e in events[n_events:]):
                raise AssertionError(f"{label}: the pool evicted a cached page")
            ok = (m.compiles == len(eng.step_keys) and replays_match(m, eng.dispatches)
                  and m.prefill_dispatches > 0 and m.decode_replays > 0
                  and m.overlap_dispatches == m.overlap_hits + m.overlap_rollbacks
                  and m.overlap_hits > 0)
            if not ok:
                raise AssertionError(f"{label}: captures, replays or overlap counts wrong: "
                                     f"{m.to_dict()}")
            n_cached = len(eng.allocator._page_meta)
            if eng.allocator.clear_cache() != n_cached or eng.allocator._page_meta or (
                    eng.allocator.num_free != cfg.num_pages - 1):
                raise AssertionError(f"{label}: clear_cache() left cached pages")
            if round_ == 0:
                first_wave = {"launches": launches, "paged_prefill_by_chunk_keys": with_history,
                              "prefilled_tokens": uncached,
                              "wave_stored_events": len(events) - n_events,
                              "cached_pages_cleared": n_cached}
        if runs[0] != runs[1]:
            raise AssertionError(f"{label}: the repeat after clear_cache() differs")
        gate = prefix_gate(dev, adapter, params, mode, warm, wave[f"tail{TIMED_TAIL}"])
        # a hit (the prefix's pages cached by the warm request) against the
        # same prompt cold, each after one untimed run that captures its keys
        gen = torch.Generator().manual_seed(18)
        tails = [torch.randint(1, adapter.vocab_size, (TIMED_TAIL,), generator=gen).tolist()
                 for _ in range(2)]
        serve_requests(eng, {"warm": warm}, 1)
        synced_ttft_ms(eng, "hit0", prefix + tails[0])
        hit_ms, hit_cached = synced_ttft_ms(eng, "hit1", prefix + tails[1])
        eng.allocator.clear_cache()
        synced_ttft_ms(eng, "cold0", prefix + tails[1])
        eng.allocator.clear_cache()
        cold_ms, cold_cached = synced_ttft_ms(eng, "cold1", prefix + tails[1])
        if (hit_cached, cold_cached) != (full, 0):
            raise AssertionError(f"{label}: timed requests cached {hit_cached}, {cold_cached}")
        m, dispatches = eng.metrics, eng.dispatches
        del eng
        torch.cuda.empty_cache()
        # the eager twin: graphs replay every piece above, so only this
        # holds a replayed chunk key with history against the eager loop
        eager = TorchEngine(cfg, params=params, device=dev, cuda_graphs=False)
        eager_run = (serve_requests(eager, {"warm": warm}, WARM_TOKENS),
                     serve_requests(eager, wave, WAVE_TOKENS))
        if eager_run != runs[0]:
            raise AssertionError(f"{label}: the eager twin's streams or cached_tokens differ "
                                 f"from the graphs'")
        del eager
        result = {"phase": "prefix", "model": "llama3-1b", "dtype": "bfloat16",
                  "kv_quantize": mode, "card": card, "prefix_tokens": PREFIX_LEN,
                  "warm_prompt": len(warm), "wave_prompts": {k: len(v) for k, v in wave.items()},
                  "cached_tokens": runs[0][1][1], "registered_pages_snapshot": PREFIX_LEN // S,
                  "identical": "the warm request's and the wave's streams, to the id, before "
                               "and after clear_cache(); the snapshot pages' bytes (K, V and "
                               "scale planes) unchanged by the wave; the eager twin's "
                               "streams and cached_tokens equal to the graphs'",
                  **first_wave, "prefix_hit_rate": m.prefix_hit_rate,
                  **{k: getattr(m, k) for k in (
                      "compiles", "prefill_dispatches", "prefill_replays", "decode_dispatches",
                      "decode_replays", "mixed_dispatches", "mixed_replays",
                      "overlap_dispatches", "overlap_hits", "overlap_rollbacks")},
                  "dispatches": dispatches, "gate": gate,
                  "ttft_hit_ms": hit_ms, "ttft_cold_ms": cold_ms,
                  "ttft": f"synced engine time from arrival to the first token on the host, "
                          f"one request of {PREFIX_LEN + TIMED_TAIL} tokens alone: {full} "
                          "cached, against the same prompt after clear_cache()",
                  "hash": hash_ms(warm, args.model), "run_s": time.perf_counter() - t_mode}
        emit(result)
        results.append(result)
        del events
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    return results


# -- phase "mixed": mixed prefill+decode steps at the CLI's defaults ---------------

#: the decode wave: rows, prompt tokens and greedy output tokens each
MIXED_ROWS, MIXED_PROMPT, MIXED_TOKENS = 32, 128, 160
#: the burst: prompts of BURST tokens arrive together once every row has
#: BURST_AT tokens, BURST_TOKENS greedy tokens each. The wave's own
#: prompts take two steps of the prefill budget (2,048 tokens), so its
#: second is a fused mixed step of first chunks; in the burst, after the
#: 700-token prompts join the rows, the decode bucket is 64, one piece
#: fits beside it, and with no speculation matching the changed rows the
#: long prompt's next chunk runs fused, with history
BURST, BURST_AT, BURST_TOKENS = (3000, 700, 700), 24, 8
#: the argv the phase's engines are built from: the CLI's defaults (context
#: 4096, chunk 512, page 64, 8 fused steps, graphs, overlap, caching and
#: mixed steps) but for room for the burst beside the wave's 32 rows
MIXED_ARGV = ["run", "--model", "llama3-1b", "--max-seqs", "64"]


def run_burst(eng, tag: str) -> dict:
    """The decode wave and the burst on an idle engine (its prefix cache
    cleared first, so every run schedules alike), one step at a time as
    the engine thread drives it. Returns the streams and, by the host's
    clock: the gaps between one wave row's token deliveries that overlap
    the burst (from its arrival to the last burst prompt's first token),
    the burst prompts' TTFT from a synced device at their arrival to their
    first token on the host, the wave's output tok/s over the whole run,
    and the engine's counters over the run."""
    from dynamo_tpu_torch.engine.request import SamplingParams

    cuda = eng.device.type == "cuda"
    vocab = eng.adapter.vocab_size
    gen = torch.Generator().manual_seed(23)
    wave = {f"{tag}w{i}": torch.randint(1, vocab, (MIXED_PROMPT,), generator=gen).tolist()
            for i in range(MIXED_ROWS)}
    burst = [(f"{tag}b{i}", torch.randint(1, vocab, (n,), generator=gen).tolist())
             for i, n in enumerate(BURST)]
    eng.allocator.clear_cache()
    before = eng.metrics.to_dict()
    dispatches = eng.dispatches
    for rid, prompt in wave.items():
        eng.add_request(rid, prompt, SamplingParams(max_tokens=MIXED_TOKENS, ignore_eos=True))
    streams: dict[str, list[int]] = {}
    delivered: dict[str, list[float]] = {rid: [] for rid in wave}
    first: dict[str, float] = {}
    arrival = None
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    while eng.has_work or arrival is None:
        if arrival is None and min(len(streams.get(r, ())) for r in wave) >= BURST_AT:
            if cuda:
                torch.cuda.synchronize()  # the long prompt's TTFT is synced
            arrival = time.perf_counter()
            for rid, prompt in burst:
                eng.add_request(rid, prompt, SamplingParams(max_tokens=BURST_TOKENS,
                                                            ignore_eos=True))
        outs = eng.step()
        t = time.perf_counter()
        for o in outs:
            if not o.new_token_ids:
                continue
            streams.setdefault(o.request_id, []).extend(o.new_token_ids)
            if o.request_id in delivered:
                delivered[o.request_id].append(t)
            else:
                first.setdefault(o.request_id, t)
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    start, end = arrival, max(first.values())

    def gaps(times):
        return [(b - a) * 1e3 for a, b in zip(times, times[1:]) if b > start and a < end]

    # the rows share their delivery steps, so the p95 is taken over the
    # steps' gaps, each once (linear between ranks); the largest over every
    # row's own gaps, so that a row left out of a step shows
    steps = sorted(gaps(sorted({t for times in delivered.values() for t in times})))
    rank = 0.95 * (len(steps) - 1)
    lo = int(rank)
    p95 = steps[lo] + (rank - lo) * (steps[min(lo + 1, len(steps) - 1)] - steps[lo])
    m = {k: v - before[k] for k, v in eng.metrics.to_dict().items()
         if isinstance(v, (int, float)) and k in before}
    return {"streams": streams,
            "gap_max_ms": max(g for times in delivered.values() for g in gaps(times)),
            "gap_p95_ms": p95, "gaps": len(steps), "burst_ms": (end - start) * 1e3,
            "ttft_ms": (first[burst[0][0]] - start) * 1e3,
            "ttft_700_ms": [(first[rid] - start) * 1e3 for rid, _ in burst[1:]],
            "wave_tok_s": MIXED_ROWS * MIXED_TOKENS / wall, "wall_s": wall,
            "dispatches": eng.dispatches - dispatches,
            **{k: m[k] for k in ("mixed_dispatches", "prefill_dispatches", "decode_dispatches",
                                 "mixed_replays", "prefill_replays", "decode_replays",
                                 "overlap_dispatches", "overlap_hits", "overlap_rollbacks",
                                 "compiles")}}


def mixed_gate(dev, adapter, params, mode) -> dict:
    """The model gate on one mixed step's inputs, kernel path against plain
    path: each path writes the histories into a pool of its own (the
    wave's MIXED_ROWS prompts as one batch of first chunks, the long
    prompt's first two chunks of 512), then runs the step in the engine's
    order: the prefill half (the long prompt's third chunk, with 1,024
    tokens of history), then the decode half (one token a row after its
    prompt). The prefill half's logits at every token and the decode
    half's at every row must agree (max |delta logit| < 0.25, argmax
    >= 90 %)."""
    from dynamo_tpu_torch.models import llama

    cfg = adapter.config
    gen = torch.Generator().manual_seed(29)
    rows = [torch.randint(1, adapter.vocab_size, (MIXED_PROMPT + 1,), generator=gen)
            for _ in range(MIXED_ROWS)]
    long = torch.randint(1, adapter.vocab_size, (1536,), generator=gen)
    per_row = -(-(MIXED_PROMPT + 1) // S)
    long_pt = torch.arange(1, 1 + 1536 // S, dtype=torch.int32, device=dev)[None]
    dec_pt = (1 + long_pt.shape[1] + torch.arange(MIXED_ROWS * per_row, dtype=torch.int32,
                                                  device=dev)).reshape(MIXED_ROWS, per_row)
    pages = 1 + long_pt.shape[1] + MIXED_ROWS * per_row

    def chunk(tokens, start, t):
        n = tokens.shape[1]
        tok = torch.zeros((tokens.shape[0], t), dtype=torch.long, device=dev)
        tok[:, :n] = tokens.to(dev)
        pos = (start + torch.arange(t, dtype=torch.int32, device=dev))[None].expand(
            tokens.shape[0], t).contiguous()
        val = (torch.arange(t, device=dev) < n)[None].expand(tokens.shape[0], t).contiguous()
        return tok, pos, val

    out = {}
    with torch.no_grad():
        for name, path_ops in (("kernel", ops.KERNELS), ("plain", ops.PLAIN)):
            pool = adapter.init_kv(pages, S, dev, kv_quantize=mode)
            hist = torch.stack([r[:MIXED_PROMPT] for r in rows])
            _, pool = llama.forward(params, cfg, *chunk(hist, 0, MIXED_PROMPT), pool, dec_pt,
                                    first_chunk=True, ops=path_ops)
            for start in (0, 512):
                _, pool = llama.forward(params, cfg, *chunk(long[None, start:start + 512],
                                                            start, 512),
                                        pool, long_pt, first_chunk=start == 0, ops=path_ops)
            pre, pool = llama.forward(params, cfg, *chunk(long[None, 1024:], 1024, 512), pool,
                                      long_pt, ops=path_ops)
            last = torch.stack([r[MIXED_PROMPT:] for r in rows])
            dec, pool = llama.forward(params, cfg, *chunk(last, MIXED_PROMPT, 1), pool, dec_pt,
                                      ops=path_ops)
            out[name] = (pre[0], dec[:, 0])
            del pool
    result = {}
    for half, a, b in (("prefill", out["kernel"][0], out["plain"][0]),
                       ("decode", out["kernel"][1], out["plain"][1])):
        worst, agree, n = logit_gap(a, b)
        result[half] = {"max_abs_dlogit": worst, "argmax_agreement": agree / n, "rows": n}
        if not (worst < GATE_MAX_DLOGIT and agree / n >= GATE_ARGMAX):
            raise AssertionError(f"mixed gate, {mode or 'bf16'} pool, {half} half: max "
                                 f"|dlogit| {worst}, argmax agreement {agree / n}")
    return result


def phase_mixed(dev, card: str) -> list[dict]:
    """Mixed steps on one TorchEngine per pool mode built from MIXED_ARGV
    (mixed steps, graphs, overlap and caching on), against the same engine
    built with --no-mixed-steps (the XOR policy), over the wave and the
    burst (run_burst): each engine runs it once untimed (every key
    captured), then on, off, off, on. Checks: the mixed engine ran mixed
    steps, fused ones replayed as mixed graphs; every run keeps the
    dispatch identities; the mixed graphs launch every kernel variant of
    the pool, and nothing runs a plain version; an eager twin of the mixed
    engine (cuda_graphs=False) gives its streams bit for bit; the model
    gate on one mixed step's halves. Printed beside the card: each run's
    largest gap between a wave row's token deliveries during the burst,
    the p95 of the delivering steps' gaps, the burst prompts' synced TTFT
    and the wave's tok/s."""
    from dynamo_tpu_torch.cli import run as cli_run
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.engine.step_graph import StepGraph
    from dynamo_tpu_torch.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.models.registry import get_model

    adapter = get_model("llama3-1b", dtype="bfloat16")
    params = adapter.init_params(torch.Generator(device=dev).manual_seed(0))
    eos = ModelDeploymentCard(name="llama3-1b").eos_token_ids
    results = []
    for mode in MODES:
        label = f"mixed, {mode or 'bf16'} pool"
        t_mode = time.perf_counter()
        pool = ["--kv-quantize", mode] if mode else []
        engines = {}
        for arm, flags in (("mixed", []), ("xor", ["--no-mixed-steps"])):
            cfg = cli_run.engine_config(cli_run._parse(MIXED_ARGV + pool + flags), eos)
            engines[arm] = TorchEngine(cfg, params=params, device=dev)
        cfg = engines["mixed"].config
        if not (cfg.mixed_steps and cfg.overlap_decode and cfg.enable_prefix_caching
                and engines["mixed"]._graphs and cfg.prefill_chunk == 512
                and cfg.page_size == S and cfg.decode_steps == 8
                and not engines["xor"].config.mixed_steps):
            raise AssertionError(f"{label}: the CLI's defaults changed: {cfg}")
        warm = {arm: run_burst(eng, f"{arm}-warm") for arm, eng in engines.items()}
        ops.reset_counts()
        runs = {"mixed": [], "xor": []}
        for arm in ("mixed", "xor", "xor", "mixed"):
            runs[arm].append(run_burst(engines[arm], f"{arm}{len(runs[arm])}"))
        counts = {k: (c.launches, c.plain_calls) for k, c in ops.COUNTS.items()}
        eng = engines["mixed"]
        for arm, e in engines.items():
            m = e.metrics
            if not (m.compiles == len(e.step_keys) and replays_match(m, e.dispatches)
                    and m.overlap_dispatches == m.overlap_hits + m.overlap_rollbacks):
                raise AssertionError(f"{label}: {arm}: captures or replays wrong: "
                                     f"{m.to_dict()}")
            if any(r["compiles"] for r in runs[arm]):
                raise AssertionError(f"{label}: {arm}: a timed run captured a key")
        for r in runs["mixed"] + [warm["mixed"]]:
            if not (r["mixed_dispatches"] > 0 and r["mixed_replays"] > 0):
                raise AssertionError(f"{label}: the mixed arm ran no fused mixed step: {r}")
        if any(r["mixed_dispatches"] for r in runs["xor"]):
            raise AssertionError(f"{label}: --no-mixed-steps ran mixed steps")
        # every run of an arm schedules alike (greedy, cache cleared): the
        # same streams, request ids aside
        for arm, rs in runs.items():
            base = [{k[len(f"{arm}{i}"):]: v for k, v in r["streams"].items()}
                    for i, r in enumerate(rs)]
            if base[0] != base[1]:
                raise AssertionError(f"{label}: {arm}: two runs gave different streams")
        # the fused mixed graphs launch every kernel variant of the pool
        want = serve_variants(mode)
        mixed_launches = {}
        for k, g in eng._step_fns.items():
            if k[0] == "mixed" and isinstance(g, StepGraph) and g.replays:
                for name, (n, _) in g.launches.items():
                    mixed_launches[name] = mixed_launches.get(name, 0) + n * g.replays
        if sorted(mixed_launches) != sorted(want):
            raise AssertionError(f"{label}: the mixed graphs launched {mixed_launches}, want "
                                 f"every variant of {want}")
        for name, (launches, plain) in counts.items():
            if plain != 0 or (launches == 0) == (name in want):
                raise AssertionError(f"{label}: {name} launched {launches} times, plain ran "
                                     f"{plain} (the pool's variants: {want})")
        keys = sorted([list(k) for k in eng.step_keys if k[0] == "mixed"])
        stats = {arm: {k: [r[k] for r in rs] for k in (
            "gap_max_ms", "gap_p95_ms", "ttft_ms", "ttft_700_ms", "wave_tok_s", "burst_ms",
            "wall_s", "gaps", "dispatches", "mixed_dispatches", "mixed_replays",
            "prefill_dispatches", "decode_dispatches", "overlap_hits", "overlap_rollbacks")}
            for arm, rs in runs.items()}
        m = eng.metrics
        compile_ms = {arm: e.metrics.compile_ms for arm, e in engines.items()}
        del engines, eng
        torch.cuda.empty_cache()
        eager = TorchEngine(cfg, params=params, device=dev, cuda_graphs=False)
        twin = run_burst(eager, "mixed0")
        del eager
        torch.cuda.empty_cache()
        same_streams(label, twin["streams"], runs["mixed"][0]["streams"],
                     "the mixed graphs' streams")
        gate = mixed_gate(dev, adapter, params, mode)
        result = {"phase": "mixed", "model": "llama3-1b", "dtype": "bfloat16",
                  "kv_quantize": mode, "card": card, "argv": MIXED_ARGV + pool,
                  "wave": {"rows": MIXED_ROWS, "prompt": MIXED_PROMPT, "tokens": MIXED_TOKENS},
                  "burst": {"prompts": list(BURST), "at_tokens": BURST_AT,
                            "tokens": BURST_TOKENS},
                  "order": "each arm once untimed, then mixed, xor, xor, mixed",
                  "arms": stats, "mixed_keys": keys,
                  "mixed_graph_launches": mixed_launches, "gate": gate,
                  "compiles": m.compiles, "compile_ms": compile_ms,
                  "identical": "the eager twin's streams, to the id, equal the mixed "
                               "graphs'; each arm's two timed runs give the same streams",
                  "gaps": "host ms between deliveries of wave rows' tokens that overlap the "
                          "burst (the long prompt's arrival to the last burst prompt's first "
                          "token): the largest of any row's, the p95 over the steps that "
                          "delivered (each gap once; `gaps` counts them)",
                  "ttft": "host ms from a synced device at the long prompt's arrival to its "
                          "first token on the host",
                  "run_s": time.perf_counter() - t_mode}
        emit(result)
        results.append(result)
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    return results


# -- phase "sampling": the sampling surface at the CLI's defaults -------------------

#: the phase's waves: rows, prompt tokens and output tokens each
SAMPLING_ROWS, SAMPLING_PROMPT, SAMPLING_TOKENS = 8, 128, 64
#: the prompt whose later chunks run paged prefill, its last one under an lp key
SAMPLING_LONG = 1300
#: the penalized wave's knobs
PENALTIES = dict(frequency_penalty=1.0, presence_penalty=0.5, repetition_penalty=1.3)
#: the id a +100 bias forces at every position
FORCED_ID = 4242
#: the logprob gate: each chosen logprob within twice the model gate's
#: logit bound of the plain path's log_softmax, top-1 agreement
GATE_LOGPROB = 2 * GATE_MAX_DLOGIT
#: the timed keys: the knobs of each wave's rows, at each batch
SAMPLING_KEYS = {"plain": {}, "lp20": dict(logprobs=20), "pen": PENALTIES,
                 "bias": dict(logit_bias=((FORCED_ID, 5.0), (77, -3.0)))}
SAMPLING_BATCHES = (8, 64)
#: the argv the phase's engines are built from: the CLI's defaults (graphs,
#: overlap, mixed steps, prefix caching, context 4096, chunk 512, page 64,
#: 8 fused steps) but for room for 64 rows
SAMPLING_ARGV = ["run", "--model", "llama3-1b", "--max-seqs", "64"]


def sampling_requests(vocab: int, eos: int) -> list[list[tuple]]:
    """The phase's waves of (request id, prompt, SamplingParams knobs),
    random prompts from a fixed seed: 8 greedy rows with logprobs 20; 8
    penalized rows; a row with +100 on FORCED_ID; min_tokens 5 with +100
    on eos; a 1,300-token prompt with logprobs 5."""
    gen = torch.Generator().manual_seed(31)
    draw = lambda n: torch.randint(1, vocab, (n,), generator=gen).tolist()  # noqa: E731
    rows = dict(max_tokens=SAMPLING_TOKENS, ignore_eos=True)
    return [
        [(f"lp{i}", draw(SAMPLING_PROMPT), dict(logprobs=20, **rows))
         for i in range(SAMPLING_ROWS)],
        [(f"pen{i}", draw(SAMPLING_PROMPT), dict(**PENALTIES, **rows))
         for i in range(SAMPLING_ROWS)],
        [("forced", draw(SAMPLING_PROMPT), dict(max_tokens=16, ignore_eos=True,
                                                logit_bias=((FORCED_ID, 100.0),))),
         ("min", draw(SAMPLING_PROMPT), dict(max_tokens=16, min_tokens=5,
                                             logit_bias=((eos, 100.0),)))],
        [("long", draw(SAMPLING_LONG), dict(max_tokens=8, logprobs=5, ignore_eos=True))],
    ]


def run_sampling(eng, waves) -> dict[str, dict]:
    """Each wave to completion, one after the other: request id ->
    {prompt, tokens, lps, tops, finish}."""
    from dynamo_tpu_torch.engine.request import SamplingParams

    out: dict[str, dict] = {}
    for wave in waves:
        for rid, prompt, kw in wave:
            eng.add_request(rid, prompt, SamplingParams(**kw))
            out[rid] = {"prompt": prompt, "tokens": [], "lps": [], "tops": [], "finish": None}
        while eng.has_work:
            for o in eng.step():
                d = out[o.request_id]
                d["tokens"] += o.new_token_ids
                d["lps"] += o.logprobs or ()
                d["tops"] += o.top_logprobs or ()
                if o.finish_reason is not None:
                    d["finish"] = o.finish_reason.value
    return out


def logprob_gate(dev, adapter, params, rows: list[dict]) -> dict:
    """Teacher forcing: each row's prompt and emitted tokens through the
    plain path, in one first chunk; the engine's (kernel path's) chosen
    logprobs must lie within GATE_LOGPROB of the plain log_softmax at the
    same positions, and its top-1 ids agree with the plain argmax at
    GATE_ARGMAX of them."""
    from dynamo_tpu_torch.models import llama

    cfg = adapter.config
    seqs = torch.tensor([r["prompt"] + r["tokens"] for r in rows], device=dev)
    b, t = seqs.shape
    per_row = -(-t // S)
    pt = (1 + torch.arange(b * per_row, dtype=torch.int32, device=dev)).reshape(b, per_row)
    pos = torch.arange(t, dtype=torch.int32, device=dev)[None].expand(b, t).contiguous()
    valid = torch.ones((b, t), dtype=torch.bool, device=dev)
    with torch.no_grad():
        pool = adapter.init_kv(1 + b * per_row, S, dev)
        logits, _ = llama.forward(params, cfg, seqs, pos, valid, pool, pt, first_chunk=True,
                                  ops=ops.PLAIN)
        del pool
    n_prompt = len(rows[0]["prompt"])
    plain = torch.log_softmax(logits[:, n_prompt - 1:t - 1].float(), dim=-1)
    chosen = torch.tensor([r["tokens"] for r in rows], device=dev)
    want = plain.gather(2, chosen[..., None])[..., 0]
    got = torch.tensor([r["lps"] for r in rows], device=dev)
    top1 = torch.tensor([[alts[0][0] for alts in r["tops"]] for r in rows], device=dev)
    worst = float((got - want).abs().max())
    agree = float((plain.argmax(-1) == top1).float().mean())
    result = {"max_abs_dlogprob": worst, "top1_agreement": agree, "positions": got.numel()}
    if not (worst < GATE_LOGPROB and agree >= GATE_ARGMAX):
        raise AssertionError(f"sampling: the logprob gate failed: {result}")
    return result


def sampling_wave(eng, tag: str, batch: int, knobs: dict) -> dict:
    """One wave of `batch` greedy rows with `knobs` from an idle engine
    (random prompts, SAMPLING_PROMPT + SAMPLING_TOKENS), counted on its
    own: the engine ms per decode dispatch (time_decode_ms: host work and
    the wait for ids), and the wait for ids per dispatch that waits for
    them (a decode dispatch or a mixed step's decode half)."""
    from dynamo_tpu_torch.engine.request import SamplingParams

    gen = torch.Generator().manual_seed(37)
    before = eng.metrics.to_dict()
    eng.allocator.clear_cache()  # every wave's prompts are the same: none hits
    for i in range(batch):
        prompt = torch.randint(1, eng.adapter.vocab_size, (SAMPLING_PROMPT,), generator=gen)
        eng.add_request(f"{tag}{i}", prompt.tolist(),
                        SamplingParams(max_tokens=SAMPLING_TOKENS, ignore_eos=True, **knobs))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while eng.has_work:
        eng.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    m = {k: v - before[k] for k, v in eng.metrics.to_dict().items()
         if isinstance(v, (int, float))}
    n = m["decode_dispatches"]
    return {"batch": batch, "decode_dispatches": n, "mixed_dispatches": m["mixed_dispatches"],
            "decode_ms_per_dispatch": m["time_decode_ms"] / n,
            "sync_ms_per_dispatch": m["time_decode_sync_ms"] / (n + m["mixed_dispatches"]),
            "decode_steps_run": m["decode_steps_run"],
            "overlap_hits": m["overlap_hits"], "compiles": m["compiles"],
            "wave_tok_s": batch * SAMPLING_TOKENS / wall}


def phase_sampling(dev, card: str) -> dict:
    """The sampling surface on one TorchEngine built from SAMPLING_ARGV (the
    CLI's defaults: graphs, overlap, mixed steps, prefix caching) over a
    bf16 pool, running sampling_requests' waves. Checks: an eager twin
    (cuda_graphs=False, the same config) gives the same streams and
    logprobs bit for bit; every dispatch replayed a graph, and every key
    with an lp, pen or bias field was captured once and replayed; those
    graphs launched all four kernel variants of the pool and nothing ran
    a plain version; a greedy row without penalty or bias chose its top-1
    alternative, with its logprob; the forced row is FORCED_ID throughout;
    the min_tokens row is exactly 6 tokens, ending on eos with `stop`; the
    logprob gate. Printed beside the card: the wall ms per decode dispatch
    of waves of the plain, lp=20, pen and bias keys at B=8 and B=64, each
    key untimed once (captures) and then timed in the order plain, lp20,
    pen, bias, bias, pen, lp20, plain."""
    from dynamo_tpu_torch.cli import run as cli_run
    from dynamo_tpu_torch.engine.engine import (DECODE_KINDS, TorchEngine, key_field,
                                                key_has_surface)
    from dynamo_tpu_torch.engine.step_graph import StepGraph
    from dynamo_tpu_torch.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.models.registry import get_model

    t_phase = time.perf_counter()
    adapter = get_model("llama3-1b", dtype="bfloat16")
    params = adapter.init_params(torch.Generator(device=dev).manual_seed(0))
    eos = ModelDeploymentCard(name="llama3-1b").eos_token_ids
    cfg = cli_run.engine_config(cli_run._parse(SAMPLING_ARGV), eos)
    eng = TorchEngine(cfg, params=params, device=dev)
    if not (cfg.mixed_steps and cfg.overlap_decode and cfg.enable_prefix_caching
            and eng._graphs and cfg.decode_steps == 8 and cfg.prefill_chunk == 512):
        raise AssertionError(f"sampling: the CLI's defaults changed: {cfg}")
    waves = sampling_requests(adapter.vocab_size, eos[0])
    ops.reset_counts()
    got = run_sampling(eng, waves)
    counts = {k: (c.launches, c.plain_calls) for k, c in ops.COUNTS.items()}
    m = eng.metrics
    new = {k: g for k, g in eng._step_fns.items() if key_has_surface(k)}
    if not (m.compiles == len(eng.step_keys) and replays_match(m, eng.dispatches)
            and new and all(isinstance(g, StepGraph) and g.replays for g in new.values())):
        raise AssertionError(f"sampling: captures or replays wrong: {m.to_dict()}, "
                             f"{sorted(new)}")
    launched = {}
    for g in new.values():
        for name, (n, _) in g.launches.items():
            launched[name] = launched.get(name, 0) + n * g.replays
    want = serve_variants(None)
    if sorted(launched) != sorted(want) or any(p for _, p in counts.values()):
        raise AssertionError(f"sampling: the new keys' graphs launched {launched} (want every "
                             f"variant of {want}); plain calls {counts}")
    if not any(k[0] == "prefill" and not key_field(k, "first_chunk") and key_field(k, "lp") >= 0
               for k in new):
        raise AssertionError("sampling: no chunk with history sampled under an lp key")
    for rid, r in got.items():
        if rid.startswith("lp") and not all(
                alts[0] == (tok, lp) for tok, lp, alts in zip(r["tokens"], r["lps"], r["tops"])):
            raise AssertionError(f"sampling: {rid}: a greedy token is not its top-1 entry")
        if rid.startswith("lp") and not len(r["lps"]) == len(r["tops"]) == SAMPLING_TOKENS:
            raise AssertionError(f"sampling: {rid}: {len(r['lps'])} logprobs")
    if got["forced"]["tokens"] != [FORCED_ID] * 16:
        raise AssertionError(f"sampling: the forced row gave {got['forced']['tokens']}")
    mins = got["min"]
    if not (len(mins["tokens"]) == 6 and mins["tokens"][-1] == eos[0]
            and eos[0] not in mins["tokens"][:5] and mins["finish"] == "stop"):
        raise AssertionError(f"sampling: the min_tokens row gave {mins}")
    if len(got["long"]["lps"]) != 8:
        raise AssertionError(f"sampling: the long prompt's logprobs {got['long']['lps']}")
    keys = sorted([list(k) for k in new], key=str)
    compiles, compile_ms = m.compiles, m.compile_ms
    # the timed waves: each key once untimed, then in the order above
    timings = {}
    for b in SAMPLING_BATCHES:
        for name, knobs in SAMPLING_KEYS.items():
            sampling_wave(eng, f"warm-{name}{b}-", b, knobs)
        order = list(SAMPLING_KEYS) + list(SAMPLING_KEYS)[::-1]
        for i, name in enumerate(order):
            r = sampling_wave(eng, f"{name}{b}-{i}-", b, SAMPLING_KEYS[name])
            if r["compiles"]:
                raise AssertionError(f"sampling: a timed wave captured a key: {r}")
            timings.setdefault(f"{name}, B={b}", []).append(r)
    decode_keys = sorted({tuple(key_field(k, f) for f in ("bucket", "steps", "lp"))
                          + (key_field(k, "pen") > 0, key_field(k, "bias"))
                          for k in eng.step_keys if k[0] in DECODE_KINDS})
    del eng
    torch.cuda.empty_cache()
    eager = TorchEngine(cfg, params=params, device=dev, cuda_graphs=False)
    twin = run_sampling(eager, waves)
    del eager
    torch.cuda.empty_cache()
    for rid, r in got.items():
        if twin[rid] != r:  # tokens, logprobs and alternatives, to the bit
            raise AssertionError(f"sampling: the eager twin differs in {rid}")
    gate = logprob_gate(dev, adapter, params, [got[f"lp{i}"] for i in range(SAMPLING_ROWS)])
    del params
    torch.cuda.empty_cache()
    result = {"phase": "sampling", "model": "llama3-1b", "dtype": "bfloat16", "card": card,
              "argv": SAMPLING_ARGV, "keys": keys, "compiles": compiles,
              "compile_ms": compile_ms, "launches": launched, "gate": gate,
              "identical": "the eager twin's ids, logprobs and top alternatives equal the "
                           "graphs' to the bit",
              "decode_keys": [list(k) for k in decode_keys],
              "timings": {k: {f: [r[f] for r in rs] for f in rs[0]}
                          for k, rs in timings.items()},
              "timing": "engine ms per decode dispatch (time_decode_ms over "
                        "decode_dispatches: host work and the wait for ids) of a wave of "
                        f"{SAMPLING_PROMPT} + {SAMPLING_TOKENS} tokens a row, two runs a key",
              "run_s": time.perf_counter() - t_phase}
    emit(result)
    return result


# -- phase "kstep": K-step decode windows at the CLI's defaults plus --decode-kstep --

#: the argv the phase's engines are built from: the CLI's defaults (graphs,
#: overlap, mixed steps, prefix caching; context 4096, chunk 512, page 64,
#: 8 fused steps) plus windows of up to 16 decode iterations
KSTEP_ARGV = ["run", "--model", "llama3-1b", "--decode-kstep", "16"]
#: the id the stop row is forced to (logit_bias) once its min_tokens pass
KSTEP_STOP_ID = 4242


def kstep_waves(eos: int) -> tuple:
    """run_waves' one wave, rows of 40 tokens: five prompts of 80-120
    tokens (one first-chunk group, bucket 8) and one of 700, whose first
    chunk of 512 prefills beside them; its second chunk, with history,
    rides beside their first window of 16 in a split mixed step. In that
    window the third row's budget of 12, the fourth row's stop id (its
    7th token: min_tokens 6 bans it, then +100 makes it) and the fifth
    row's eos (its 10th) end them mid-window; the next window, over the
    two long rows and the 700-token one, chains under overlap and is
    consumed; the last windows end on budgets (16 and 8 iterations)."""
    stop = dict(min_tokens=6, logit_bias=((KSTEP_STOP_ID, 100.0),),
                stop_token_ids=(KSTEP_STOP_ID,), ignore_eos=False)
    ends = dict(min_tokens=9, logit_bias=((eos, 100.0),), ignore_eos=False)
    return (((120, 110, 100, 90, 80, 700), 40,
             ({}, {}, {"max_tokens": 12}, stop, ends, {})),)


def phase_kstep(dev, card: str) -> dict:
    """K-step windows on llama3-1b engines built from KSTEP_ARGV, in each
    pool mode: phase 4b's three engines (the eager loop with overlap off,
    graphs with overlap off, and graphs with overlap, the CLI's), each over
    kstep_waves; then, with --quantize int8, the eager loop and graphs
    with overlap over the same. Checks: every stream identical in an
    arm's engines; the stop and eos rows end on their ids mid-window and
    the budget row at 12 tokens; every graph engine
    captured each key once and keeps phase 4b's identities, ran a split
    mixed step (mixed_dispatches > 0, no fused mixed replay) and windows
    chained under overlap (hits); the window graphs launch the pool's
    write and paged decode (and int8_matmul), the run every kernel
    variant of the pool, and nothing a plain version. Returns, per kernel
    variant, its launches in the CLI engines' runs (counts set to 0 just
    before each) and those made by window replays."""
    from dynamo_tpu_torch.cli import run as cli_run
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.engine.step_graph import StepGraph
    from dynamo_tpu_torch.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.models.registry import get_model

    t_phase = time.perf_counter()
    params = get_model("llama3-1b", dtype="bfloat16").init_params(
        torch.Generator(device=dev).manual_seed(0))
    eos = ModelDeploymentCard(name="llama3-1b").eos_token_ids
    waves = kstep_waves(eos[0])
    launches: dict[str, int] = {}
    window_launches: dict[str, int] = {}
    arms = [(mode, None) for mode in MODES] + [(None, "int8")]
    for mode, quantize in arms:
        label = f"kstep, {mode or 'bf16'} pool" + (", int8 weights" if quantize else "")
        t_arm = time.perf_counter()
        flags = (["--kv-quantize", mode] if mode else []) + (
            ["--quantize", quantize] if quantize else [])
        engines = GRAPH_ENGINES[::2] if quantize else GRAPH_ENGINES
        runs = {}
        for name, graphs, overlap in engines:
            argv = KSTEP_ARGV + flags + ([] if overlap else ["--no-overlap-decode"])
            cfg = cli_run.engine_config(cli_run._parse(argv), eos)
            # int8 weights: drawn in the int8 layout from seed 0, as the CLI does
            eng = TorchEngine(cfg, params=None if quantize else params, device=dev,
                              cuda_graphs=graphs)
            ops.reset_counts()
            t0 = time.perf_counter()
            streams = run_waves(eng, waves, "k")
            torch.cuda.synchronize()
            runs[name] = dict(eng=eng, streams=streams, s=time.perf_counter() - t0,
                              counts={k: (c.launches, c.plain_calls)
                                      for k, c in ops.COUNTS.items()})
        cfg = runs["overlap"]["eng"].config
        if not (cfg.decode_kstep == 16 and cfg.mixed_steps and cfg.overlap_decode
                and cfg.enable_prefix_caching and cfg.decode_steps == 8
                and cfg.prefill_chunk == 512 and cfg.page_size == S):
            raise AssertionError(f"{label}: the CLI's defaults changed: {cfg}")
        want = runs["eager"]["streams"]
        for name, run in runs.items():
            same_streams(label, want, run["streams"], f"{name}'s streams")
        rows = {r: want[f"k0-{r}"] for r in range(6)}
        if not (len(rows[3]) == 7 and rows[3][-1] == KSTEP_STOP_ID
                and KSTEP_STOP_ID not in rows[3][:-1] and len(rows[4]) == 10
                and rows[4][-1] == eos[0] and len(rows[2]) == 12
                and len(rows[0]) == len(rows[5]) == 40):
            raise AssertionError(f"{label}: the stop, eos or budget rows ended wrong: "
                                 f"{ {r: len(v) for r, v in rows.items()} }")
        want_launch = serve_variants(mode, quantize)
        arm = {"eager_run_s": runs["eager"]["s"]}
        for name in ("graphs", "overlap") if not quantize else ("overlap",):
            eng, run = runs[name]["eng"], runs[name]
            m = eng.metrics
            windows = {k: g for k, g in eng._step_fns.items() if k[0] == "decode_kstep"}
            in_windows = {}
            for g in windows.values():
                for kernel, (n, _) in g.launches.items():
                    in_windows[kernel] = in_windows.get(kernel, 0) + n * g.replays
            ok = (m.compiles == len(eng.step_keys) and replays_match(m, eng.dispatches)
                  and bool(windows) and all(isinstance(g, StepGraph) and g.replays
                                            for g in windows.values())
                  and m.kstep_windows > 0 and m.kstep_window_size > 0
                  and m.mixed_dispatches > 0 and m.mixed_replays == 0
                  and (m.overlap_hits > 0) == (name == "overlap"))
            line = {k: getattr(m, k) for k in (
                "compiles", "compile_ms", "prefill_dispatches", "prefill_replays",
                "decode_dispatches", "decode_replays", "mixed_dispatches", "mixed_replays",
                "overlap_dispatches", "overlap_hits", "overlap_rollbacks", "kstep_windows",
                "kstep_steps", "kstep_fallbacks", "time_kstep_ms")}
            line.update(dispatches=eng.dispatches, run_s=run["s"],
                        window_keys=sorted([list(k) for k in windows]),
                        window_launches=in_windows)
            arm[name] = line
            if not ok:
                raise AssertionError(f"{label}: {name}: captures, replays, windows or split "
                                     f"mixed steps wrong: {line}")
            want_windows = {kv_quant.variant(n, mode)
                            for n in ("paged_write", "paged_decode_attention")}
            if quantize:
                want_windows.add("int8_matmul")
            if set(in_windows) != want_windows:
                raise AssertionError(f"{label}: {name}: the window graphs launched "
                                     f"{in_windows}, want {sorted(want_windows)}")
            for kernel, (n, plain) in run["counts"].items():
                if plain != 0 or (n == 0) == (kernel in want_launch):
                    raise AssertionError(f"{label}: {name}: {kernel} launched {n} times, "
                                         f"plain ran {plain} (want {want_launch})")
            if name == "overlap":
                for kernel, (n, _) in run["counts"].items():
                    if n:
                        launches.setdefault(kernel, n)
                for kernel, n in in_windows.items():
                    window_launches.setdefault(kernel, n)
        result = {"phase": "kstep", "model": "llama3-1b", "dtype": "bfloat16",
                  "kv_quantize": mode, "quantize": quantize, "card": card,
                  "argv": KSTEP_ARGV + flags, **arm, "streams": len(want),
                  "identical": "every stream, to the id, in the eager loop, with graphs"
                               + ("" if quantize else ", and with graphs and overlap"),
                  "run_s": time.perf_counter() - t_arm}
        emit(result)
        del runs, eng
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    emit({"phase": "kstep_done", "seconds": time.perf_counter() - t_phase})
    return {"launches": launches, "window_launches": window_launches}


# -- phase "spec": prompt-lookup speculation at the CLI's defaults plus --spec-ngram --

#: drafts a verify step proposes (the window is SPEC_NGRAM + 1 tokens)
SPEC_NGRAM = 4
#: the argv the phase's engines are built from: the CLI's defaults (graphs,
#: prefix caching; context 4096, chunk 512, page 64, 8 fused steps) plus
#: prompt lookup, which turns overlap, mixed steps and windows off
SPEC_ARGV = ["run", "--model", "llama3-1b", "--spec-ngram", str(SPEC_NGRAM)]
#: the phase's waves for run_waves: eight prompts of 16-184 tokens said
#: four times over (lookup has a block to copy), then eight that do not
#: repeat, each row 32 tokens, then two rows, one asking for logprobs,
#: which makes their batch ineligible (plain decode dispatches)
SPEC_WAVES = (((8, 32),), ((8, 32), (2, 24, ({}, {"logprobs": 0}))))
#: the verify gate's histories (num_tokens - 1 of a row): ends inside a
#: page, on one, and windows across 64 and 128 (page size 64)
SPEC_GATE_HIST = (63, 99, 128, 190, 257, 317, 383, 447)


def spec_gate(dev, adapter, params, mode) -> dict:
    """The model gate on a verify window, teacher-forced: each row's
    SPEC_GATE_HIST tokens prefilled into a pool, copied; then the same
    window of SPEC_NGRAM + 1 tokens at position hist on, through the
    verify path (one chunk with history, written in runs of one slot) on
    one copy and through the T=1 decode path (a step a token) on the
    other, kernels on both. The logits at every window position must
    agree (max |delta logit| < 0.25, argmax >= 90 %)."""
    from dynamo_tpu_torch.models import llama

    cfg = adapter.config
    gen = torch.Generator().manual_seed(31)
    b, t = len(SPEC_GATE_HIST), SPEC_NGRAM + 1
    hist = torch.tensor(SPEC_GATE_HIST, dtype=torch.int32, device=dev)
    per_row = -(-(max(SPEC_GATE_HIST) + t) // S)
    pt = (1 + torch.arange(b * per_row, dtype=torch.int32, device=dev)).reshape(b, per_row)
    width = 512
    prompt = torch.randint(1, adapter.vocab_size, (b, width), generator=gen).to(dev)
    window = torch.randint(1, adapter.vocab_size, (b, t), generator=gen).to(dev)
    pos = torch.arange(width, dtype=torch.int32, device=dev)[None].expand(b, width).contiguous()
    wpos = (hist[:, None] + torch.arange(t, dtype=torch.int32, device=dev)).contiguous()
    wval = torch.ones((b, t), dtype=torch.bool, device=dev)
    with torch.no_grad():
        pool = adapter.init_kv(1 + b * per_row, S, dev, kv_quantize=mode)
        _, pool = llama.forward(params, cfg, prompt, pos, pos < hist[:, None], pool, pt,
                                first_chunk=True)
        twin = llama.KVPages(*(None if x is None else x.clone() for x in pool))
        verify, _ = llama.forward(params, cfg, window, wpos, wval, pool, pt, write_run=1)
        steps = []
        for j in range(t):
            step = [x[:, j:j + 1].contiguous() for x in (window, wpos, wval)]
            logits, twin = llama.forward(params, cfg, *step, twin, pt)
            steps.append(logits[:, 0])
        decode = torch.stack(steps, dim=1)
    worst, agree, n = logit_gap(verify.reshape(b * t, -1), decode.reshape(b * t, -1))
    if not (worst < GATE_MAX_DLOGIT and agree / n >= GATE_ARGMAX):
        raise AssertionError(f"spec gate, {mode or 'bf16'} pool: max |dlogit| {worst}, argmax "
                             f"agreement {agree / n}")
    return {"max_abs_dlogit": worst, "argmax_agreement": agree / n, "positions": n,
            "hist": list(SPEC_GATE_HIST), "t": t}


def spec_arm(dev, params, cfg, label: str) -> dict:
    """One arm of phase "spec": the eager loop (cuda_graphs=False) and step
    graphs over SPEC_WAVES (the first set of prompts said four times),
    with counts set to 0 before each. Checks: every stream identical; the
    graph engine turned overlap and mixed steps off, captured each key
    once, every verify key among them, replayed every verify graph, keeps
    phase 4b's identities and ran no overlap, mixed step or window; the
    drafts equal the eager loop's; the
    verify graphs launch the pool's write and paged prefill and nothing
    else, the run every kernel variant of the pool, and nothing a plain
    version. Returns the graph engine's line, its launches and its verify
    graphs' launches."""
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.engine.step_graph import StepGraph

    mode = cfg.kv_quantize
    runs = {}
    for name, graphs in (("eager", False), ("graphs", True)):
        eng = TorchEngine(cfg, params=params, device=dev, cuda_graphs=graphs)
        ops.reset_counts()
        t0 = time.perf_counter()
        waves, streams = [], {}
        for w, (repeat, wave) in enumerate(zip((4, 1), SPEC_WAVES)):
            m0 = (eng.metrics.spec_drafted, eng.metrics.spec_accepted)
            streams.update(run_waves(eng, wave, f"s{w}-", repeat=repeat))
            d, a = (eng.metrics.spec_drafted - m0[0], eng.metrics.spec_accepted - m0[1])
            waves.append({"repeat": repeat, "drafted": d, "accepted": a,
                          "accept_rate": a / d if d else None})
        torch.cuda.synchronize()
        runs[name] = dict(eng=eng, streams=streams, waves=waves, s=time.perf_counter() - t0,
                          counts={k: (c.launches, c.plain_calls) for k, c in ops.COUNTS.items()})
    want = runs["eager"]["streams"]
    same_streams(label, want, runs["graphs"]["streams"], "the graphs' streams")
    eng = runs["graphs"]["eng"]
    m = eng.metrics
    verifies = {k: g for k, g in eng._step_fns.items() if k[0] == "spec_verify"}
    in_verifies: dict[str, int] = {}
    for g in verifies.values():
        for kernel, (n, _) in g.launches.items():
            in_verifies[kernel] = in_verifies.get(kernel, 0) + n * g.replays
    ok = (eng._graphs and not eng._overlap_enabled and not eng.scheduler.mixed_enabled
          and m.compiles == len(eng.step_keys) and replays_match(m, eng.dispatches)
          and bool(verifies) and all(isinstance(g, StepGraph) and g.replays
                                     for g in verifies.values())
          and m.spec_drafted > 0 and m.spec_skipped_ineligible > 0
          and m.overlap_dispatches == m.mixed_dispatches == m.kstep_windows == 0
          and runs["graphs"]["waves"] == runs["eager"]["waves"])
    line = {k: getattr(m, k) for k in (
        "compiles", "compile_ms", "prefill_dispatches", "prefill_replays", "decode_dispatches",
        "decode_replays", "spec_drafted", "spec_accepted", "spec_skipped_ineligible",
        "spec_skipped_cooldown", "spec_accept_rate", "time_spec_host_ms")}
    line.update(dispatches=eng.dispatches, run_s=runs["graphs"]["s"],
                eager_run_s=runs["eager"]["s"], waves=runs["graphs"]["waves"],
                streams=len(want), verify_keys=sorted([list(k) for k in verifies]),
                verify_replays=sum(g.replays for g in verifies.values()),
                verify_launches=in_verifies)
    if not ok:
        raise AssertionError(f"{label}: captures, replays or spec counts wrong: {line}")
    want_verify = {kv_quant.variant(n, mode) for n in ("paged_write", "paged_prefill_attention")}
    if set(in_verifies) != want_verify:
        raise AssertionError(f"{label}: the verify graphs launched {in_verifies}, want "
                             f"{sorted(want_verify)}")
    want_launch = serve_variants(mode)
    counts = runs["graphs"]["counts"]
    for kernel, (n, plain) in counts.items():
        if plain != 0 or (n == 0) == (kernel in want_launch):
            raise AssertionError(f"{label}: {kernel} launched {n} times, plain ran {plain} "
                                 f"(want {want_launch})")
    return {"line": line, "launches": {k: n for k, (n, _) in counts.items() if n},
            "verify_launches": in_verifies}


def phase_spec(dev, card: str) -> dict:
    """Prompt-lookup speculation on llama3-1b engines built from SPEC_ARGV
    (arm "cli"), and the same with spec_min_accept_rate 0 (arm "always":
    no cooldown, so every eligible decode dispatch verifies, in every
    bucket the wave's rows pass through), in each pool mode: spec_arm,
    then the verify gate (spec_gate). Also checks the CLI's defaults.
    Prints each arm's waves'
    drafts and acceptance rate, its captures, and the phase's seconds.
    Returns, per kernel variant, its launches in the cli arm's graph runs
    and those made by its verify replays."""
    from dynamo_tpu_torch.cli import run as cli_run
    from dynamo_tpu_torch.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.models.registry import get_model

    t_phase = time.perf_counter()
    adapter = get_model("llama3-1b", dtype="bfloat16")
    params = adapter.init_params(torch.Generator(device=dev).manual_seed(0))
    eos = ModelDeploymentCard(name="llama3-1b").eos_token_ids
    launches: dict[str, int] = {}
    verify_launches: dict[str, int] = {}
    for mode in MODES:
        label = f"spec, {mode or 'bf16'} pool"
        t_mode = time.perf_counter()
        argv = SPEC_ARGV + (["--kv-quantize", mode] if mode else [])
        cfg = cli_run.engine_config(cli_run._parse(argv), eos)
        if not (cfg.spec_ngram == SPEC_NGRAM and cfg.overlap_decode and cfg.mixed_steps
                and cfg.enable_prefix_caching and cfg.prefill_chunk == 512
                and cfg.page_size == S):
            raise AssertionError(f"{label}: the CLI's defaults changed: {cfg}")
        arms = {}
        for arm, arm_cfg in (("cli", cfg),
                             ("always", dataclasses.replace(cfg, spec_min_accept_rate=0.0))):
            arms[arm] = spec_arm(dev, params, arm_cfg, f"{label}, {arm}")
            torch.cuda.empty_cache()
        for kernel, n in arms["cli"]["launches"].items():
            launches.setdefault(kernel, n)
        for kernel, n in arms["cli"]["verify_launches"].items():
            verify_launches.setdefault(kernel, n)
        gate = spec_gate(dev, adapter, params, mode)
        emit({"phase": "spec", "model": "llama3-1b", "dtype": "bfloat16", "kv_quantize": mode,
              "card": card, "argv": argv, **{arm: a["line"] for arm, a in arms.items()},
              "always_launches": arms["always"]["launches"], "gate": gate,
              "identical": "every stream, to the id, in the eager loop and with graphs, in "
                           "each arm",
              "run_s": time.perf_counter() - t_mode})
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    emit({"phase": "spec_done", "seconds": time.perf_counter() - t_phase})
    return {"launches": launches, "verify_launches": verify_launches}


# -- phase "draft": draft-model speculation at the CLI's defaults plus --spec-draft --

#: the argv of the phase's self-draft engines: the CLI's defaults (graphs,
#: overlap, mixed steps, prefix caching; context 4096, chunk 512, page 64)
#: plus a draft that is the target itself (its own weights: greedy drafts
#: accept where the verify's bf16 argmax agrees)
DRAFT_ARGV = ["run", "--model", "llama3-1b", "--spec-draft", "llama3-1b"]
#: drafts a dispatch proposes: the CLI's --spec-draft-tokens default
#: (phase_draft checks it)
SPEC_DRAFT = 4
#: the llama3-draft arm's argv (random draft weights: the cooldown engages),
#: over an int8 target pool, so the bf16 variants are the draft's alone
DRAFT_ARM_ARGV = ["run", "--model", "llama3-1b", "--spec-draft", "llama3-draft",
                  "--kv-quantize", "int8"]
#: the phase's engines a pool mode: (name, cuda_graphs, overlap_decode,
#: mixed_steps)
DRAFT_ENGINES = (("eager", False, False, True), ("graphs", True, False, True),
                 ("overlap", True, True, True), ("unmixed", True, True, False))
#: the phase's waves for run_waves: eight greedy rows of 24 tokens, and a
#: seeded sampled pair (temperature 0.7, top-p 0.9)
DRAFT_WAVE, DRAFT_SAMPLED = ((8, 24),), ((2, 16),)
#: the dispatch timing's rows (decode buckets) and tokens a row
DRAFT_TIMED = ((8, 64), 32)


def draft_gate(dev, adapter, params, mode) -> dict:
    """The self-draft gate on the verify half, teacher-forced: each row's
    SPEC_GATE_HIST tokens prefilled into a pool, copied twice; the draft's
    S proposals from the last prompt token by T=1 greedy steps on one copy
    (a self-draft proposes the target's argmax); the window [last token,
    proposals] through the verify path (a chunk with history, landed in
    runs of one slot) on the second copy and through the T=1 decode path
    on the third, kernels on all. The logits at every window position
    must agree (max |delta logit| < 0.25, argmax >= 90 %); the share of
    proposals the verify's argmax accepts is printed."""
    from dynamo_tpu_torch.models import llama

    cfg = adapter.config
    gen = torch.Generator().manual_seed(41)
    s = SPEC_DRAFT
    b, t = len(SPEC_GATE_HIST), s + 1
    hist = torch.tensor(SPEC_GATE_HIST, dtype=torch.int32, device=dev)
    per_row = -(-(max(SPEC_GATE_HIST) + t) // S)
    pt = (1 + torch.arange(b * per_row, dtype=torch.int32, device=dev)).reshape(b, per_row)
    width = 512
    prompt = torch.randint(1, adapter.vocab_size, (b, width), generator=gen).to(dev)
    pos = torch.arange(width, dtype=torch.int32, device=dev)[None].expand(b, width).contiguous()
    ones = torch.ones((b, 1), dtype=torch.bool, device=dev)
    rows = torch.arange(b, device=dev)
    with torch.no_grad():
        pool = adapter.init_kv(1 + b * per_row, S, dev, kv_quantize=mode)
        _, pool = llama.forward(params, cfg, prompt, pos, pos < hist[:, None], pool, pt,
                                first_chunk=True)
        pools = [llama.KVPages(*(None if x is None else x.clone() for x in pool))
                 for _ in range(2)]
        # the last prompt token (position hist - 1) is rewritten by each
        # path at hist - 1 on: the window starts there, as a dispatch's does
        last = prompt[rows, hist.long() - 1]
        tok, proposals = last, []
        for j in range(s):
            p = (hist - 1 + j)[:, None].contiguous()
            logits, pools[0] = llama.forward(params, cfg, tok[:, None].contiguous(), p, ones,
                                             pools[0], pt)
            tok = logits[:, 0].argmax(-1)
            proposals.append(tok)
        window = torch.stack([last, *proposals], dim=1)
        wpos = (hist[:, None] - 1 + torch.arange(t, dtype=torch.int32, device=dev)).contiguous()
        wval = torch.ones((b, t), dtype=torch.bool, device=dev)
        verify, _ = llama.forward(params, cfg, window, wpos, wval, pool, pt, write_run=1)
        steps = []
        for j in range(t):
            step = [x[:, j:j + 1].contiguous() for x in (window, wpos, wval)]
            logits, pools[1] = llama.forward(params, cfg, *step, pools[1], pt)
            steps.append(logits[:, 0])
        decode = torch.stack(steps, dim=1)
    worst, agree, n = logit_gap(verify.reshape(b * t, -1), decode.reshape(b * t, -1))
    accepted = (verify[:, :s].argmax(-1) == window[:, 1:]).float().mean().item()
    if not (worst < GATE_MAX_DLOGIT and agree / n >= GATE_ARGMAX):
        raise AssertionError(f"draft gate, {mode or 'bf16'} pool: max |dlogit| {worst}, argmax "
                             f"agreement {agree / n}")
    return {"max_abs_dlogit": worst, "argmax_agreement": agree / n, "positions": n,
            "proposals_accepted": accepted, "hist": list(SPEC_GATE_HIST), "t": t}


def draft_run(eng) -> dict[str, list[int]]:
    """DRAFT_WAVE, DRAFT_SAMPLED, then run_late_arrival (a fifth prompt
    joins four decoding rows: split mixed steps)."""
    out = run_waves(eng, DRAFT_WAVE, "d0-")
    out.update(run_waves(eng, DRAFT_SAMPLED, "d1-", temperature=0.7, top_p=0.9, seed=3))
    out.update(run_late_arrival(eng, "dl"))
    return out


def draft_mode(dev, params, cfg, label: str) -> dict:
    """One pool mode of phase "draft": DRAFT_ENGINES over draft_run with
    spec_min_accept_rate 0 (no cooldown: every decode dispatch is a
    draft-model one, so overlap and mixed steps change no stream) and one
    decode bucket, 8 (mixed steps change which rows share a dispatch, and
    a row's logits depend in their last bits on its dispatch's bucket: up
    to 0.0625 between buckets 1 and 4, where random weights tie; with one
    bucket, and prompts of one chunk, every row runs the same shapes
    whatever the schedule), counts set to 0 before each. Checks: every
    stream identical in the four
    (the unmixed engine runs each prefill step apart from the decode
    dispatches, the others split mixed steps around them); each graph
    engine captured each key once, replayed every spec_fused and
    spec_draft_prefill key and keeps phase 4b's identities; the graphs
    and overlap engines ran split mixed steps with the eager loop's spec
    counters, the unmixed one none; the overlap and unmixed engines
    consumed chained dispatches; the spec_fused graphs launch the
    pool's write and paged prefill and the draft pool's bf16 write, paged
    prefill and paged decode; the overlap engine's run launches those and
    flash prefill (the pool's paged decode only where a plain dispatch
    runs: none here), and nothing a plain version. Returns the
    overlap engine's line, its launches and those of its spec_fused
    replays."""
    from dynamo_tpu_torch.engine.engine import TorchEngine

    mode = cfg.kv_quantize
    cfg = dataclasses.replace(cfg, spec_min_accept_rate=0.0, decode_buckets=(8,), max_seqs=8)
    runs = {}
    for name, graphs, overlap, mixed in DRAFT_ENGINES:
        eng = TorchEngine(dataclasses.replace(cfg, overlap_decode=overlap, mixed_steps=mixed),
                          params=params, device=dev, cuda_graphs=graphs)
        ops.reset_counts()
        t0 = time.perf_counter()
        streams = draft_run(eng)
        torch.cuda.synchronize()
        runs[name] = dict(eng=eng, streams=streams, s=time.perf_counter() - t0,
                          counts={k: (c.launches, c.plain_calls) for k, c in ops.COUNTS.items()})
    want = runs["eager"]["streams"]
    spec = ("spec_drafted", "spec_accepted", "spec_skipped_ineligible", "mixed_dispatches")
    lines = {}
    for name, _, overlap, mixed in DRAFT_ENGINES[1:]:
        same_streams(label, want, runs[name]["streams"], f"the {name} engine's streams")
        eng = runs[name]["eng"]
        m = eng.metrics
        fused = {k: g for k, g in eng._step_fns.items() if k[0] == "spec_fused"}
        covers = {k: g for k, g in eng._step_fns.items() if k[0] == "spec_draft_prefill"}
        in_fused: dict[str, int] = {}
        for g in fused.values():
            for kernel, (n, _) in g.launches.items():
                in_fused[kernel] = in_fused.get(kernel, 0) + n * g.replays
        ok = (m.compiles == len(eng.step_keys) and replays_match(m, eng.dispatches)
              and fused and covers and all(g.replays for g in (*fused.values(), *covers.values()))
              and all(g.keep for g in fused.values())
              and m.spec_drafted > 0 and m.spec_accepted > 0
              and (m.mixed_dispatches > 0) == mixed and (m.overlap_hits > 0) == overlap
              and (not mixed or all(getattr(m, c) == getattr(runs["eager"]["eng"].metrics, c)
                                    for c in spec)))
        line = {k: getattr(m, k) for k in (
            "compiles", "compile_ms", "prefill_dispatches", "prefill_replays",
            "decode_dispatches", "decode_replays", "mixed_dispatches", "overlap_dispatches",
            "overlap_hits", "overlap_rollbacks", "spec_drafted", "spec_accepted",
            "spec_accept_rate", "time_spec_host_ms", "kv_pool_bytes")}
        line.update(dispatches=eng.dispatches, run_s=runs[name]["s"],
                    spec_fused_keys=sorted([list(k) for k in fused]),
                    spec_fused_replays=sum(g.replays for g in fused.values()),
                    draft_prefill_keys=len(covers), spec_fused_launches=in_fused)
        lines[name] = line
        if not ok:
            raise AssertionError(f"{label}, {name}: captures, replays or spec counts wrong: "
                                 f"{line}")
        want_fused = ({kv_quant.variant(n, mode) for n in ("paged_write",
                                                            "paged_prefill_attention")}
                      | {"paged_write", "paged_prefill_attention", "paged_decode_attention"})
        if set(in_fused) != want_fused:
            raise AssertionError(f"{label}, {name}: the spec_fused graphs launched {in_fused}, "
                                 f"want {sorted(want_fused)}")
    want_launch = want_fused | {"flash_prefill_attention"}
    counts = runs["overlap"]["counts"]
    for kernel, (n, plain) in counts.items():
        if plain != 0 or (n == 0 and kernel in want_launch):
            raise AssertionError(f"{label}: {kernel} launched {n} times, plain ran {plain} "
                                 f"(want {sorted(want_launch)})")
    lines["eager_run_s"] = runs["eager"]["s"]
    return {"lines": lines, "launches": {k: n for k, (n, _) in counts.items() if n},
            "spec_fused_launches": lines["overlap"]["spec_fused_launches"]}


def draft_arm(dev, params, eos) -> dict:
    """The llama3-draft arm: a graph engine built from DRAFT_ARM_ARGV
    (random draft weights, the CLI's cooldown; an int8 target pool, so
    the bf16 variants' launches are the draft's), over DRAFT_WAVE, counts
    set to 0 before it. Checks: acceptance under
    spec_min_accept_rate, the cooldown engaged, the draft's kernels (the
    bf16 write, paged prefill, paged decode and flash prefill) launched
    and nothing ran a plain version."""
    from dynamo_tpu_torch.cli import run as cli_run
    from dynamo_tpu_torch.engine.engine import TorchEngine

    cfg = cli_run.engine_config(cli_run._parse(DRAFT_ARM_ARGV), eos)
    eng = TorchEngine(cfg, params=params, device=dev)
    ops.reset_counts()
    t0 = time.perf_counter()
    run_waves(eng, DRAFT_WAVE, "a-")
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    m = eng.metrics
    launches = {k: (c.launches, c.plain_calls) for k, c in ops.COUNTS.items()}
    draft_kernels = ("paged_write", "paged_prefill_attention", "paged_decode_attention",
                     "flash_prefill_attention")
    line = {k: getattr(m, k) for k in ("spec_drafted", "spec_accepted", "spec_accept_rate",
                                       "spec_skipped_cooldown", "decode_dispatches",
                                       "kv_pool_bytes", "compiles", "compile_ms")}
    line.update(run_s=run_s, draft=cfg.spec_draft_model,
                draft_heads=[eng.draft_adapter.config.num_heads,
                             eng.draft_adapter.config.num_kv_heads],
                launches={k: n for k, (n, _) in launches.items() if n})
    if not (m.spec_drafted > 0 and m.spec_accepted < cfg.spec_min_accept_rate * m.spec_drafted
            and m.spec_skipped_cooldown > 0
            and all(launches[k][0] > 0 for k in draft_kernels)
            and all(p == 0 for _, p in launches.values())):
        raise AssertionError(f"draft arm: acceptance, cooldown or launches wrong: {line}")
    return line


def draft_dispatch_times(dev, params, eos) -> list[dict]:
    """Device ms of a spec_fused dispatch against a fused step, at buckets
    DRAFT_TIMED: a graph engine from DRAFT_ARGV with no cooldown and one at
    the CLI's defaults each run a wave of B rows (128-token prompts,
    DRAFT_TIMED tokens a row) twice, the second timed (wave tok/s); then
    the bucket's spec_fused graph and the defaults' 8-step graph replay
    10 times each, by CUDA events (their buffers hold the last dispatch's
    inputs, whose pages are free by then)."""
    from dynamo_tpu_torch.cli import run as cli_run
    from dynamo_tpu_torch.engine.engine import TorchEngine, key_field
    from dynamo_tpu_torch.engine.request import SamplingParams

    buckets, tokens = DRAFT_TIMED
    out = []
    for b in buckets:
        row = {"B": b, "tokens_a_row": tokens}
        for arm, argv, knobs in (("spec_fused", DRAFT_ARGV, dict(spec_min_accept_rate=0.0)),
                                 ("defaults", ["run", "--model", "llama3-1b"], {})):
            cfg = dataclasses.replace(cli_run.engine_config(cli_run._parse(argv), eos),
                                      max_seqs=64, enable_prefix_caching=False, **knobs)
            eng = TorchEngine(cfg, params=params, device=dev)
            for rep in range(2):
                gen = torch.Generator().manual_seed(43)
                for i in range(b):
                    prompt = torch.randint(1, eng.adapter.vocab_size, (128,), generator=gen)
                    eng.add_request(f"t{rep}-{i}", prompt.tolist(),
                                    SamplingParams(max_tokens=tokens, ignore_eos=True))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                before = (eng.metrics.decode_dispatches, eng.metrics.spec_drafted,
                          eng.metrics.spec_accepted)
                eng.run_to_completion()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            m = eng.metrics
            # the bucket's key of the arm's kind with the most steps
            kinds = ("spec_fused",) if arm == "spec_fused" else ("decode", "decode_multi")
            key = max((k for k in eng.step_keys
                       if k[0] in kinds and key_field(k, "bucket") == b),
                      key=lambda k: key_field(k, "steps", 1))
            if arm == "spec_fused":
                drafted, accepted = m.spec_drafted - before[1], m.spec_accepted - before[2]
                row.update(spec_accept_rate=accepted / drafted,
                           tokens_a_row_a_dispatch=1 + accepted * SPEC_DRAFT / drafted)
            graph = eng._step_fns[key]
            ms = cuda_ms(graph.graph.replay, iters=10, warmup=2)
            row[arm] = {"device_ms_a_dispatch": ms, "wave_tok_s": b * tokens / wall,
                        "decode_dispatches": m.decode_dispatches - before[0],
                        "compiles": m.compiles, "compile_ms": m.compile_ms, "key": list(key)}
            if arm == "defaults":
                row[arm]["device_ms_a_step"] = ms / key_field(key, "steps")
            del eng, graph
            torch.cuda.empty_cache()
        out.append(row)
    return out


def serve_draft(card: str) -> dict:
    """One streamed chat through the CLI's server with --spec-draft
    llama3-draft: it must answer 200 with usage counting the ids served,
    and its engine must have run draft-model dispatches."""
    from dynamo_tpu_torch.cli.run import start_server

    server = start_server(["run", "in=http", "out=torch", "--model", "llama3-1b", "--port", "0",
                           "--dtype", "bfloat16", "--max-context", str(SERVE_CONTEXT),
                           "--spec-draft", "llama3-draft"])
    try:
        body = {"model": "llama3-1b", "max_tokens": 48, "stream": True,
                "stream_options": {"include_usage": True},
                "ext": {"ignore_eos": True, "return_token_ids": True},
                "messages": [{"role": "user", "content": "draft for me: " + "tell me " * 20}]}
        status, out, ids, ttft = _post(server.url + "/v1/chat/completions", body)
        m = server.runner.engine.metrics
        use = out[-1].get("usage") or {}
        line = {"status": status, "tokens": len(ids), "usage": use, "ttft_s": ttft,
                "spec_drafted": m.spec_drafted, "spec_accepted": m.spec_accepted,
                "spec_skipped_cooldown": m.spec_skipped_cooldown}
        if not (status == 200 and len(ids) == 48 == use.get("completion_tokens")
                and m.spec_drafted > 0):
            raise AssertionError(f"draft serve: {line}")
        return line
    finally:
        server.stop()


def phase_draft(dev, card: str) -> dict:
    """Draft-model speculation on llama3-1b engines built from DRAFT_ARGV
    (a self-draft), in each pool mode: draft_mode and the self-draft gate
    (draft_gate); then the llama3-draft arm (draft_arm), the device ms of
    a spec_fused dispatch against a fused step (draft_dispatch_times) and
    one request through the CLI's server with --spec-draft llama3-draft
    (serve_draft). Also checks the CLI's defaults under --spec-draft.
    Prints each pool mode's line, the arm's, the times' and the serve's,
    and the phase's seconds. Returns, per kernel variant, the bf16 overlap
    engine's launches and those of its spec_fused replays."""
    from dynamo_tpu_torch.cli import run as cli_run
    from dynamo_tpu_torch.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.models.registry import get_model

    t_phase = time.perf_counter()
    adapter = get_model("llama3-1b", dtype="bfloat16")
    params = adapter.init_params(torch.Generator(device=dev).manual_seed(0))
    eos = ModelDeploymentCard(name="llama3-1b").eos_token_ids
    result = {}
    for mode in MODES:
        label = f"draft, {mode or 'bf16'} pool"
        t_mode = time.perf_counter()
        argv = DRAFT_ARGV + (["--kv-quantize", mode] if mode else [])
        cfg = cli_run.engine_config(cli_run._parse(argv), eos)
        if not (cfg.spec_draft_model == "llama3-1b" and cfg.spec_draft_tokens == SPEC_DRAFT
                and cfg.overlap_decode and cfg.mixed_steps and cfg.enable_prefix_caching
                and cfg.decode_kstep == 1 and cfg.page_size == S):
            raise AssertionError(f"{label}: the CLI's defaults changed: {cfg}")
        r = draft_mode(dev, params, cfg, label)
        if mode is None:
            result = {"launches": r["launches"], "spec_fused_launches": r["spec_fused_launches"]}
        gate = draft_gate(dev, adapter, params, mode)
        emit({"phase": "draft", "model": "llama3-1b", "dtype": "bfloat16", "kv_quantize": mode,
              "card": card, "argv": argv, "spec_min_accept_rate": 0.0,
              "decode_buckets": [8], **r["lines"],
              "gate": gate,
              "identical": "every stream, to the id, in the eager loop and with graphs, "
                           "with overlap off and on, and with mixed steps off",
              "run_s": time.perf_counter() - t_mode})
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    arm = draft_arm(dev, params, eos)
    emit({"phase": "draft_arm", "card": card, "argv": DRAFT_ARM_ARGV, **arm,
          "seconds": time.perf_counter() - t0})
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    emit({"phase": "draft_times", "card": card, "rows": draft_dispatch_times(dev, params, eos),
          "seconds": time.perf_counter() - t0})
    del params
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    emit({"phase": "draft_serve", "card": card, **serve_draft(card),
          "seconds": time.perf_counter() - t0})
    emit({"phase": "draft_done", "seconds": time.perf_counter() - t_phase})
    return result


# -- phase "checkpoint": checkpoint directories and GGUF files at llama3-1b width ----------

#: Llama-3.2-1B's published config.json (meta-llama/Llama-3.2-1B), the
#: fields from_hf_config reads and those naming the family
LLAMA32_1B_CONFIG = {
    "architectures": ["LlamaForCausalLM"], "model_type": "llama", "hidden_act": "silu",
    "hidden_size": 2048, "intermediate_size": 8192, "num_hidden_layers": 16,
    "num_attention_heads": 32, "num_key_value_heads": 8, "head_dim": 64,
    "max_position_embeddings": 131072, "rms_norm_eps": 1e-05, "rope_theta": 500000.0,
    "rope_scaling": {"factor": 32.0, "high_freq_factor": 4.0, "low_freq_factor": 1.0,
                     "original_max_position_embeddings": 8192, "rope_type": "llama3"},
    "vocab_size": 128256, "tie_word_embeddings": True, "attention_bias": False,
    "mlp_bias": False, "bos_token_id": 128000, "eos_token_id": 128001,
    "torch_dtype": "bfloat16",
}
#: llama3-draft's shape (LlamaConfig.llama3_draft) in the same fields
DRAFT_CONFIG = {**LLAMA32_1B_CONFIG, "hidden_size": 512, "intermediate_size": 2048,
                "num_hidden_layers": 4, "num_attention_heads": 8, "num_key_value_heads": 4}
#: Llama-3's pre-tokenizer split (its tokenizer.json)
LLAMA3_SPLIT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}"
                r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
#: the words of the phase's prompts (each also becomes a token with and
#: without its leading space, as common words are in Llama-3's vocabulary)
CKPT_WORDS = (
    "the of and to in is that for it as was with be by on not he this are or his from at "
    "which but have an they you were her she there been one all we their has would when if "
    "so no will more can said who out up them some could time into only do new two may "
    "then these first any my now such like our over man me even most made after also did "
    "many before must through back years where much your way well down should because each "
    "just those people how too little state good very make world still own see men work "
    "long get here between both life being under never day same another know while last "
    "might us great old year off come since against go came right used take three kernel "
    "cache page prefill decode token model serve request batch graph stream chunk").split()
CKPT_PROMPT_CHARS = 3000
#: letters of the out-of-vocabulary words (lowercase ASCII, accented Latin)
CKPT_OOV_LATIN = "abcdefghijklmnopqrstuvwxyz", "àáâãäåæçèéêëìíîïñòóôõöøùúûüýÿœß"
#: the CLI's server on each file: the defaults, the model and port
CKPT_SERVE_TOKENS = 16

#: the served families' chat templates (each repo's tokenizer_config.json
#: `chat_template` on the Hugging Face Hub), transcribed; none is fetched.
#: Every check holds the port's render against transformers' render of the
#: same string (tests/test_torch_chat_template.py), so a transcription that
#: differs from the Hub's file weakens no check
_TPL_LLAMA31 = r"""{{- bos_token }}
{%- if custom_tools is defined %}
    {%- set tools = custom_tools %}
{%- endif %}
{%- if not tools_in_user_message is defined %}
    {%- set tools_in_user_message = true %}
{%- endif %}
{%- if not date_string is defined %}
    {%- set date_string = "26 Jul 2024" %}
{%- endif %}
{%- if not tools is defined %}
    {%- set tools = none %}
{%- endif %}

{#- This block extracts the system message, so we can slot it into the right place. #}
{%- if messages[0]['role'] == 'system' %}
    {%- set system_message = messages[0]['content']|trim %}
    {%- set messages = messages[1:] %}
{%- else %}
    {%- set system_message = "" %}
{%- endif %}

{#- System message + builtin tools #}
{{- "<|start_header_id|>system<|end_header_id|>\n\n" }}
{%- if builtin_tools is defined or tools is not none %}
    {{- "Environment: ipython\n" }}
{%- endif %}
{%- if builtin_tools is defined %}
    {{- "Tools: " + builtin_tools | reject('equalto', 'code_interpreter') | join(", ") + "\n\n"}}
{%- endif %}
{{- "Cutting Knowledge Date: December 2023\n" }}
{{- "Today Date: " + date_string + "\n\n" }}
{%- if tools is not none and not tools_in_user_message %}
    {{- "You have access to the following functions. To call a function, please respond with JSON for a function call." }}
    {{- 'Respond in the format {"name": function name, "parameters": dictionary of argument name and its value}.' }}
    {{- "Do not use variables.\n\n" }}
    {%- for t in tools %}
        {{- t | tojson(indent=4) }}
        {{- "\n\n" }}
    {%- endfor %}
{%- endif %}
{{- system_message }}
{{- "<|eot_id|>" }}

{#- Custom tools are passed in a user message with some extra guidance #}
{%- if tools_in_user_message and not tools is none %}
    {#- Extract the first user message so we can plug it in here #}
    {%- if messages | length != 0 %}
        {%- set first_user_message = messages[0]['content']|trim %}
        {%- set messages = messages[1:] %}
    {%- else %}
        {{- raise_exception("Cannot put tools in the first user message when there's no first user message!") }}
{%- endif %}
    {{- '<|start_header_id|>user<|end_header_id|>\n\n' -}}
    {{- "Given the following functions, please respond with a JSON for a function call " }}
    {{- "with its proper arguments that best answers the given prompt.\n\n" }}
    {{- 'Respond in the format {"name": function name, "parameters": dictionary of argument name and its value}.' }}
    {{- "Do not use variables.\n\n" }}
    {%- for t in tools %}
        {{- t | tojson(indent=4) }}
        {{- "\n\n" }}
    {%- endfor %}
    {{- first_user_message + "<|eot_id|>"}}
{%- endif %}

{%- for message in messages %}
    {%- if not (message.role == 'ipython' or message.role == 'tool' or 'tool_calls' in message) %}
        {{- '<|start_header_id|>' + message['role'] + '<|end_header_id|>\n\n'+ message['content'] | trim + '<|eot_id|>' }}
    {%- elif 'tool_calls' in message %}
        {%- if not message.tool_calls|length == 1 %}
            {{- raise_exception("This model only supports single tool-calls at once!") }}
        {%- endif %}
        {%- set tool_call = message.tool_calls[0].function %}
        {%- if builtin_tools is defined and tool_call.name in builtin_tools %}
            {{- '<|start_header_id|>assistant<|end_header_id|>\n\n' -}}
            {{- "<|python_tag|>" + tool_call.name + ".call(" }}
            {%- for arg_name, arg_val in tool_call.arguments | items %}
                {{- arg_name + '="' + arg_val + '"' }}
                {%- if not loop.last %}
                    {{- ", " }}
                {%- endif %}
                {%- endfor %}
            {{- ")" }}
        {%- else  %}
            {{- '<|start_header_id|>assistant<|end_header_id|>\n\n' -}}
            {{- '{"name": "' + tool_call.name + '", ' }}
            {{- '"parameters": ' }}
            {{- tool_call.arguments | tojson }}
            {{- "}" }}
        {%- endif %}
        {%- if builtin_tools is defined %}
            {#- This means we're in ipython mode #}
            {{- "<|eom_id|>" }}
        {%- else %}
            {{- "<|eot_id|>" }}
        {%- endif %}
    {%- elif message.role == "tool" or message.role == "ipython" %}
        {{- "<|start_header_id|>ipython<|end_header_id|>\n\n" }}
        {%- if message.content is mapping or message.content is iterable %}
            {{- message.content | tojson }}
        {%- else %}
            {{- message.content }}
        {%- endif %}
        {{- "<|eot_id|>" }}
    {%- endif %}
{%- endfor %}
{%- if add_generation_prompt %}
    {{- '<|start_header_id|>assistant<|end_header_id|>\n\n' }}
{%- endif %}
"""

_TPL_LLAMA32 = r"""{{- bos_token }}
{%- if custom_tools is defined %}
    {%- set tools = custom_tools %}
{%- endif %}
{%- if not tools_in_user_message is defined %}
    {%- set tools_in_user_message = true %}
{%- endif %}
{%- if not date_string is defined %}
    {%- if strftime_now is defined %}
        {%- set date_string = strftime_now("%d %b %Y") %}
    {%- else %}
        {%- set date_string = "26 Jul 2024" %}
    {%- endif %}
{%- endif %}
{%- if not tools is defined %}
    {%- set tools = none %}
{%- endif %}

{#- This block extracts the system message, so we can slot it into the right place. #}
{%- if messages[0]['role'] == 'system' %}
    {%- set system_message = messages[0]['content']|trim %}
    {%- set messages = messages[1:] %}
{%- else %}
    {%- set system_message = "" %}
{%- endif %}

{#- System message #}
{{- "<|start_header_id|>system<|end_header_id|>\n\n" }}
{%- if tools is not none %}
    {{- "Environment: ipython\n" }}
{%- endif %}
{{- "Cutting Knowledge Date: December 2023\n" }}
{{- "Today Date: " + date_string + "\n\n" }}
{%- if tools is not none and not tools_in_user_message %}
    {{- "You have access to the following functions. To call a function, please respond with JSON for a function call." }}
    {{- 'Respond in the format {"name": function name, "parameters": dictionary of argument name and its value}.' }}
    {{- "Do not use variables.\n\n" }}
    {%- for t in tools %}
        {{- t | tojson(indent=4) }}
        {{- "\n\n" }}
    {%- endfor %}
{%- endif %}
{{- system_message }}
{{- "<|eot_id|>" }}

{#- Custom tools are passed in a user message with some extra guidance #}
{%- if tools_in_user_message and not tools is none %}
    {#- Extract the first user message so we can plug it in here #}
    {%- if messages | length != 0 %}
        {%- set first_user_message = messages[0]['content']|trim %}
        {%- set messages = messages[1:] %}
    {%- else %}
        {{- raise_exception("Cannot put tools in the first user message when there's no first user message!") }}
{%- endif %}
    {{- '<|start_header_id|>user<|end_header_id|>\n\n' -}}
    {{- "Given the following functions, please respond with a JSON for a function call " }}
    {{- "with its proper arguments that best answers the given prompt.\n\n" }}
    {{- 'Respond in the format {"name": function name, "parameters": dictionary of argument name and its value}.' }}
    {{- "Do not use variables.\n\n" }}
    {%- for t in tools %}
        {{- t | tojson(indent=4) }}
        {{- "\n\n" }}
    {%- endfor %}
    {{- first_user_message + "<|eot_id|>"}}
{%- endif %}

{%- for message in messages %}
    {%- if not (message.role == 'ipython' or message.role == 'tool' or 'tool_calls' in message) %}
        {{- '<|start_header_id|>' + message['role'] + '<|end_header_id|>\n\n'+ message['content'] | trim + '<|eot_id|>' }}
    {%- elif 'tool_calls' in message %}
        {%- if not message.tool_calls|length == 1 %}
            {{- raise_exception("This model only supports single tool-calls at once!") }}
        {%- endif %}
        {%- set tool_call = message.tool_calls[0].function %}
        {{- '<|start_header_id|>assistant<|end_header_id|>\n\n' -}}
        {{- '{"name": "' + tool_call.name + '", ' }}
        {{- '"parameters": ' }}
        {{- tool_call.arguments | tojson }}
        {{- "}" }}
        {{- "<|eot_id|>" }}
    {%- elif message.role == "tool" or message.role == "ipython" %}
        {{- "<|start_header_id|>ipython<|end_header_id|>\n\n" }}
        {%- if message.content is mapping or message.content is iterable %}
            {{- message.content | tojson }}
        {%- else %}
            {{- message.content }}
        {%- endif %}
        {{- "<|eot_id|>" }}
    {%- endif %}
{%- endfor %}
{%- if add_generation_prompt %}
    {{- '<|start_header_id|>assistant<|end_header_id|>\n\n' }}
{%- endif %}
"""

_TPL_QWEN2 = r"""{% for message in messages %}{% if loop.first and messages[0]['role'] != 'system' %}{{ '<|im_start|>system
You are a helpful assistant.<|im_end|>
' }}{% endif %}{{'<|im_start|>' + message['role'] + '
' + message['content'] + '<|im_end|>' + '
'}}{% endfor %}{% if add_generation_prompt %}{{ '<|im_start|>assistant
' }}{% endif %}"""

_TPL_QWEN25 = r"""{%- if tools %}
    {{- '<|im_start|>system\n' }}
    {%- if messages[0]['role'] == 'system' %}
        {{- messages[0]['content'] }}
    {%- else %}
        {{- 'You are Qwen, created by Alibaba Cloud. You are a helpful assistant.' }}
    {%- endif %}
    {{- "\n\n# Tools\n\nYou may call one or more functions to assist with the user query.\n\nYou are provided with function signatures within <tools></tools> XML tags:\n<tools>" }}
    {%- for tool in tools %}
        {{- "\n" }}
        {{- tool | tojson }}
    {%- endfor %}
    {{- "\n</tools>\n\nFor each function call, return a json object with function name and arguments within <tool_call></tool_call> XML tags:\n<tool_call>\n{\"name\": <function-name>, \"arguments\": <args-json-object>}\n</tool_call><|im_end|>\n" }}
{%- else %}
    {%- if messages[0]['role'] == 'system' %}
        {{- '<|im_start|>system\n' + messages[0]['content'] + '<|im_end|>\n' }}
    {%- else %}
        {{- '<|im_start|>system\nYou are Qwen, created by Alibaba Cloud. You are a helpful assistant.<|im_end|>\n' }}
    {%- endif %}
{%- endif %}
{%- for message in messages %}
    {%- if (message.role == "user") or (message.role == "system" and not loop.first) or (message.role == "assistant" and not message.tool_calls) %}
        {{- '<|im_start|>' + message.role + '\n' + message.content + '<|im_end|>' + '\n' }}
    {%- elif message.role == "assistant" %}
        {{- '<|im_start|>' + message.role }}
        {%- if message.content %}
            {{- '\n' + message.content }}
        {%- endif %}
        {%- for tool_call in message.tool_calls %}
            {%- if tool_call.function is defined %}
                {%- set tool_call = tool_call.function %}
            {%- endif %}
            {{- '\n<tool_call>\n{"name": "' }}
            {{- tool_call.name }}
            {{- '", "arguments": ' }}
            {{- tool_call.arguments | tojson }}
            {{- '}\n</tool_call>' }}
        {%- endfor %}
        {{- '<|im_end|>\n' }}
    {%- elif message.role == "tool" %}
        {%- if (loop.index0 == 0) or (messages[loop.index0 - 1].role != "tool") %}
            {{- '<|im_start|>user' }}
        {%- endif %}
        {{- '\n<tool_response>\n' }}
        {{- message.content }}
        {{- '\n</tool_response>' }}
        {%- if loop.last or (messages[loop.index0 + 1].role != "tool") %}
            {{- '<|im_end|>\n' }}
        {%- endif %}
    {%- endif %}
{%- endfor %}
{%- if add_generation_prompt %}
    {{- '<|im_start|>assistant\n' }}
{%- endif %}
"""

_TPL_QWEN3 = r"""{%- if tools %}
    {{- '<|im_start|>system\n' }}
    {%- if messages[0].role == 'system' %}
        {{- messages[0].content + '\n\n' }}
    {%- endif %}
    {{- "# Tools\n\nYou may call one or more functions to assist with the user query.\n\nYou are provided with function signatures within <tools></tools> XML tags:\n<tools>" }}
    {%- for tool in tools %}
        {{- "\n" }}
        {{- tool | tojson }}
    {%- endfor %}
    {{- "\n</tools>\n\nFor each function call, return a json object with function name and arguments within <tool_call></tool_call> XML tags:\n<tool_call>\n{\"name\": <function-name>, \"arguments\": <args-json-object>}\n</tool_call><|im_end|>\n" }}
{%- else %}
    {%- if messages[0].role == 'system' %}
        {{- '<|im_start|>system\n' + messages[0].content + '<|im_end|>\n' }}
    {%- endif %}
{%- endif %}
{%- set ns = namespace(multi_step_tool=true, last_query_index=messages|length - 1) %}
{%- for message in messages[::-1] %}
    {%- set index = (messages|length - 1) - loop.index0 %}
    {%- if ns.multi_step_tool and message.role == "user" and message.content is string and not(message.content.startswith('<tool_response>') and message.content.endswith('</tool_response>')) %}
        {%- set ns.multi_step_tool = false %}
        {%- set ns.last_query_index = index %}
    {%- endif %}
{%- endfor %}
{%- for message in messages %}
    {%- if message.content is string %}
        {%- set content = message.content %}
    {%- else %}
        {%- set content = '' %}
    {%- endif %}
    {%- if (message.role == "user") or (message.role == "system" and not loop.first) %}
        {{- '<|im_start|>' + message.role + '\n' + content + '<|im_end|>' + '\n' }}
    {%- elif message.role == "assistant" %}
        {%- set reasoning_content = '' %}
        {%- if message.reasoning_content is string %}
            {%- set reasoning_content = message.reasoning_content %}
        {%- else %}
            {%- if '</think>' in content %}
                {%- set reasoning_content = content.split('</think>')[0].rstrip('\n').split('<think>')[-1].lstrip('\n') %}
                {%- set content = content.split('</think>')[-1].lstrip('\n') %}
            {%- endif %}
        {%- endif %}
        {%- if loop.index0 > ns.last_query_index %}
            {%- if loop.last or (not loop.last and reasoning_content) %}
                {{- '<|im_start|>' + message.role + '\n<think>\n' + reasoning_content.strip('\n') + '\n</think>\n\n' + content.lstrip('\n') }}
            {%- else %}
                {{- '<|im_start|>' + message.role + '\n' + content }}
            {%- endif %}
        {%- else %}
            {{- '<|im_start|>' + message.role + '\n' + content }}
        {%- endif %}
        {%- if message.tool_calls %}
            {%- for tool_call in message.tool_calls %}
                {%- if (loop.first and content) or (not loop.first) %}
                    {{- '\n' }}
                {%- endif %}
                {%- if tool_call.function %}
                    {%- set tool_call = tool_call.function %}
                {%- endif %}
                {{- '<tool_call>\n{"name": "' }}
                {{- tool_call.name }}
                {{- '", "arguments": ' }}
                {%- if tool_call.arguments is string %}
                    {{- tool_call.arguments }}
                {%- else %}
                    {{- tool_call.arguments | tojson }}
                {%- endif %}
                {{- '}\n</tool_call>' }}
            {%- endfor %}
        {%- endif %}
        {{- '<|im_end|>\n' }}
    {%- elif message.role == "tool" %}
        {%- if loop.first or (messages[loop.index0 - 1].role != "tool") %}
            {{- '<|im_start|>user' }}
        {%- endif %}
        {{- '\n<tool_response>\n' }}
        {{- content }}
        {{- '\n</tool_response>' }}
        {%- if loop.last or (messages[loop.index0 + 1].role != "tool") %}
            {{- '<|im_end|>\n' }}
        {%- endif %}
    {%- endif %}
{%- endfor %}
{%- if add_generation_prompt %}
    {{- '<|im_start|>assistant\n' }}
    {%- if enable_thinking is defined and enable_thinking is false %}
        {{- '<think>\n\n</think>\n\n' }}
    {%- endif %}
{%- endif %}"""

_TPL_PHI3 = r"""{% for message in messages %}{% if message['role'] == 'system' %}{{'<|system|>
' + message['content'] + '<|end|>
'}}{% elif message['role'] == 'user' %}{{'<|user|>
' + message['content'] + '<|end|>
'}}{% elif message['role'] == 'assistant' %}{{'<|assistant|>
' + message['content'] + '<|end|>
'}}{% endif %}{% endfor %}{% if add_generation_prompt %}{{ '<|assistant|>
' }}{% else %}{{ eos_token }}{% endif %}"""

_TPL_PHI4 = r"""{% for message in messages %}{% if (message['role'] == 'system') %}{{'<|im_start|>system<|im_sep|>' + message['content'] + '<|im_end|>'}}{% elif (message['role'] == 'user') %}{{'<|im_start|>user<|im_sep|>' + message['content'] + '<|im_end|>'}}{% elif (message['role'] == 'assistant') %}{{'<|im_start|>assistant<|im_sep|>' + message['content'] + '<|im_end|>'}}{% endif %}{% endfor %}{% if add_generation_prompt %}{{ '<|im_start|>assistant<|im_sep|>' }}{% endif %}"""

_TPL_GEMMA = r"""{{ bos_token }}{% if messages[0]['role'] == 'system' %}{{ raise_exception('System role not supported') }}{% endif %}{% for message in messages %}{% if (message['role'] == 'user') != (loop.index0 % 2 == 0) %}{{ raise_exception('Conversation roles must alternate user/assistant/user/assistant/...') }}{% endif %}{% if (message['role'] == 'assistant') %}{% set role = 'model' %}{% else %}{% set role = message['role'] %}{% endif %}{{ '<start_of_turn>' + role + '
' + message['content'] | trim + '<end_of_turn>
' }}{% endfor %}{% if add_generation_prompt %}{{'<start_of_turn>model
'}}{% endif %}"""

_TPL_DEEPSEEK = r"""{% if not add_generation_prompt is defined %}{% set add_generation_prompt = false %}{% endif %}{% set ns = namespace(is_first=false, is_tool=false, is_output_first=true, system_prompt='', is_first_sp=true) %}{%- for message in messages %}{%- if message['role'] == 'system' %}{%- if ns.is_first_sp %}{% set ns.system_prompt = ns.system_prompt + message['content'] %}{% set ns.is_first_sp = false %}{%- else %}{% set ns.system_prompt = ns.system_prompt + '\n\n' + message['content'] %}{%- endif %}{%- endif %}{%- endfor %}{{ bos_token }}{{ ns.system_prompt }}{%- for message in messages %}{%- if message['role'] == 'user' %}{%- set ns.is_tool = false -%}{{'<｜User｜>' + message['content']}}{%- endif %}{%- if message['role'] == 'assistant' and 'tool_calls' in message %}{%- set ns.is_tool = false -%}{%- for tool in message['tool_calls'] %}{%- if not ns.is_first %}{%- if message['content'] is none %}{{'<｜Assistant｜><｜tool▁calls▁begin｜><｜tool▁call▁begin｜>' + tool['type'] + '<｜tool▁sep｜>' + tool['function']['name'] + '\n' + '```json' + '\n' + tool['function']['arguments'] + '\n' + '```' + '<｜tool▁call▁end｜>'}}{%- else %}{{'<｜Assistant｜>' + message['content'] + '<｜tool▁calls▁begin｜><｜tool▁call▁begin｜>' + tool['type'] + '<｜tool▁sep｜>' + tool['function']['name'] + '\n' + '```json' + '\n' + tool['function']['arguments'] + '\n' + '```' + '<｜tool▁call▁end｜>'}}{%- endif %}{%- set ns.is_first = true -%}{%- else %}{{'\n' + '<｜tool▁call▁begin｜>' + tool['type'] + '<｜tool▁sep｜>' + tool['function']['name'] + '\n' + '```json' + '\n' + tool['function']['arguments'] + '\n' + '```' + '<｜tool▁call▁end｜>'}}{%- endif %}{%- endfor %}{{'<｜tool▁calls▁end｜><｜end▁of▁sentence｜>'}}{%- endif %}{%- if message['role'] == 'assistant' and 'tool_calls' not in message %}{%- if ns.is_tool %}{{'<｜tool▁outputs▁end｜>' + message['content'] + '<｜end▁of▁sentence｜>'}}{%- set ns.is_tool = false -%}{%- else %}{% set content = message['content'] %}{% if '</think>' in content %}{% set content = content.split('</think>')[-1] %}{% endif %}{{'<｜Assistant｜>' + content + '<｜end▁of▁sentence｜>'}}{%- endif %}{%- endif %}{%- if message['role'] == 'tool' %}{%- set ns.is_tool = true -%}{%- if ns.is_output_first %}{{'<｜tool▁outputs▁begin｜><｜tool▁output▁begin｜>' + message['content'] + '<｜tool▁output▁end｜>'}}{%- set ns.is_output_first = false %}{%- else %}{{'<｜tool▁output▁begin｜>' + message['content'] + '<｜tool▁output▁end｜>'}}{%- endif %}{%- endif %}{%- endfor -%}{% if ns.is_tool %}{{'<｜tool▁outputs▁end｜>'}}{% endif %}{% if add_generation_prompt and not ns.is_tool %}{{'<｜Assistant｜><think>\n'}}{% endif %}"""

CHAT_TEMPLATES = {
    "meta-llama/Llama-3.1-8B-Instruct": _TPL_LLAMA31,
    "meta-llama/Llama-3.2-1B-Instruct": _TPL_LLAMA32,
    "Qwen/Qwen2-7B-Instruct": _TPL_QWEN2,
    "Qwen/Qwen2.5-7B-Instruct": _TPL_QWEN25,
    "Qwen/Qwen3-8B": _TPL_QWEN3,
    "microsoft/Phi-3-mini-4k-instruct": _TPL_PHI3,
    "microsoft/phi-4": _TPL_PHI4,
    "google/gemma-2b-it": _TPL_GEMMA,
    "deepseek-ai/DeepSeek-R1-Distill-Llama-8B": _TPL_DEEPSEEK,
    "google/gemma-7b-it": _TPL_GEMMA,  # the same template as gemma-2b-it's
}
#: the phase's templated chat on the llama3-1b directory: Llama-3.1-8B-Instruct's
#: template (with its fixed date), a system message, three turns and two tools
CHAT_TEMPLATE_REPO = "meta-llama/Llama-3.1-8B-Instruct"
CHAT_TOOLS = [
    {"type": "function", "function": {
        "name": "get_page_size", "description": "The KV cache's page size of a model",
        "parameters": {"type": "object", "properties": {"model": {"type": "string"}},
                       "required": ["model"]}}},
    {"type": "function", "function": {
        "name": "count_tokens", "description": "Tokens of a text under a model's tokenizer",
        "parameters": {"type": "object", "properties": {
            "model": {"type": "string"}, "text": {"type": "string"}},
            "required": ["model", "text"]}}},
]
CHAT_MESSAGES = [
    {"role": "system", "content": "You are a careful assistant for a team that serves "
                                  "language models. Answer in one short paragraph."},
    {"role": "user", "content": "Which kernel reads the cached pages during decode?"},
    {"role": "assistant", "content": "The paged decode attention kernel reads them through "
                                     "the page table."},
    {"role": "user", "content": "How many tokens does one page hold for llama3-1b?"},
]
#: SHA-256 of the port's render of CHAT_MESSAGES and CHAT_TOOLS under
#: CHAT_TEMPLATE_REPO's template with the directory's special tokens;
#: tests/test_torch_chat_template.py recomputes it through transformers
CHAT_RENDER_SHA256 = "077d802d1a2bc5fcc58082b04b6508e2d162c2a592fa18a533d38c5ab39bd12b"
#: the render times' conversation: 32 turns and four tools
CHAT_RENDER_TURNS = 32


def chat_render_conversation() -> tuple[list[dict], list[dict]]:
    """32 alternating user and assistant turns (no system message, which
    Gemma's template refuses) of CKPT_WORDS, and four tools."""
    gen = torch.Generator().manual_seed(29)
    messages = []
    for i in range(CHAT_RENDER_TURNS):
        picks = torch.randint(0, len(CKPT_WORDS), (24,), generator=gen).tolist()
        messages.append({"role": "user" if i % 2 == 0 else "assistant",
                         "content": " ".join(CKPT_WORDS[j] for j in picks).capitalize() + "."})
    more = [{"type": "function", "function": {**t["function"], "name": t["function"]["name"]
                                              + "_v2"}} for t in CHAT_TOOLS]
    return messages, CHAT_TOOLS + more


def hf_tokenizer_config() -> dict:
    """The llama3-1b directory's tokenizer_config.json: Llama-3's specials and
    CHAT_TEMPLATE_REPO's chat template."""
    return {"bos_token": "<|begin_of_text|>", "eos_token": "<|end_of_text|>",
            "clean_up_tokenization_spaces": True, "model_max_length": 131072,
            "tokenizer_class": "PreTrainedTokenizerFast",
            "chat_template": CHAT_TEMPLATES[CHAT_TEMPLATE_REPO]}


def ckpt_prompt(seed: int, chars: int = CKPT_PROMPT_CHARS) -> str:
    """Seeded sentences of CKPT_WORDS, some with digits and punctuation,
    `chars` characters long."""
    gen = torch.Generator().manual_seed(seed)
    out, n = [], 0
    while n < chars:
        k = int(torch.randint(6, 16, (1,), generator=gen))
        idx = torch.randint(0, len(CKPT_WORDS), (k,), generator=gen).tolist()
        words = [CKPT_WORDS[i] for i in idx]
        if idx[0] % 5 == 0:
            words.append(str(int(torch.randint(0, 100000, (1,), generator=gen))))
        s = " ".join(words).capitalize() + (", " if idx[1] % 3 == 0 else ". ")
        out.append(s)
        n += len(s)
    return "".join(out)[:chars]


def ckpt_oov_prompt(seed: int, chars: int = CKPT_PROMPT_CHARS) -> str:
    """Seeded words that are not whole tokens of synthetic_llama3_vocab, so
    that BPE runs its merges: random lowercase strings, accented Latin and
    CJK ideographs, spaced and sometimes punctuated, `chars` characters."""
    gen = torch.Generator().manual_seed(seed)
    ascii_, accented = CKPT_OOV_LATIN
    out, n = [], 0
    while n < chars:
        kind, ln = torch.randint(0, 3, (1,), generator=gen).item(), \
            torch.randint(3, 11, (1,), generator=gen).item()
        if kind == 2:  # CJK: 1-4 ideographs of U+4E00-U+9FFF
            word = "".join(chr(0x4E00 + int(c)) for c in
                           torch.randint(0, 0x5200, (1 + ln % 4,), generator=gen))
        else:
            letters = ascii_ + (accented if kind == 1 else "")
            word = "".join(letters[int(c)] for c in
                           torch.randint(0, len(letters), (ln,), generator=gen))
        s = word + (". " if ln == 10 else ", " if ln == 9 else " ")
        out.append(s)
        n += len(s)
    return "".join(out)[:chars]


def synthetic_llama3_vocab(seed: int) -> tuple[list[str], list[str]]:
    """A byte-level BPE vocabulary of Llama-3's size: the 256 byte symbols,
    127,744 merges (first those that build CKPT_WORDS with and without a
    leading space, then seeded pairs of earlier tokens), then Llama-3.1's
    256 special tokens at 128000-128255 (<|eom_id|> at 128008 and
    <|python_tag|> at 128010, the rest reserved by number). Returns (the
    128,256 token strings, the merges as "a b")."""
    from dynamo_tpu_torch.preprocessor.tokenizer_json import bytes_to_unicode

    b2u = bytes_to_unicode()
    tokens = [b2u[b] for b in range(256)]
    index = {t: i for i, t in enumerate(tokens)}
    merges = []

    def add(a: str, b: str) -> None:
        if a + b not in index and len(tokens) < 128000:
            merges.append(f"{a} {b}")
            index[a + b] = len(tokens)
            tokens.append(a + b)

    for w in CKPT_WORDS:
        for form in (w, " " + w, w.capitalize(), " " + w.capitalize()):
            mapped = "".join(b2u[b] for b in form.encode())
            for i in range(1, len(mapped)):
                add(mapped[:i], mapped[i])
    gen = torch.Generator().manual_seed(seed)
    short = [t for t in tokens if len(t) <= 3]
    while len(tokens) < 128000:
        a, b = torch.randint(0, len(short), (2,), generator=gen).tolist()
        before = len(tokens)
        add(short[a], short[b])
        if len(tokens) > before and len(tokens[-1]) <= 3:
            short.append(tokens[-1])
    specials = ["<|begin_of_text|>", "<|end_of_text|>"] + [
        f"<|reserved_special_token_{i}|>" for i in range(4)] + [
        "<|start_header_id|>", "<|end_header_id|>", "<|eom_id|>", "<|eot_id|>",
        "<|python_tag|>"] + [f"<|reserved_special_token_{i}|>" for i in range(5, 250)]
    return tokens + specials, merges


def write_hf_tokenizer(d: str, tokens: list[str], merges: list[str]) -> None:
    """tokenizer.json (Llama-3's pipeline: the Split pattern, ByteLevel
    without its regex, BPE with ignore_merges, the ByteLevel decoder; the
    specials as added tokens) and hf_tokenizer_config()'s
    tokenizer_config.json, with CHAT_TEMPLATE_REPO's chat template."""
    added = [{"id": 128000 + i, "content": t, "single_word": False, "lstrip": False,
              "rstrip": False, "normalized": False, "special": True}
             for i, t in enumerate(tokens[128000:])]
    spec = {
        "version": "1.0", "truncation": None, "padding": None, "added_tokens": added,
        "normalizer": None,
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": LLAMA3_SPLIT}, "behavior": "Isolated",
             "invert": False},
            {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True,
             "use_regex": False}]},
        "post_processor": None,
        "decoder": {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": True,
                    "use_regex": True},
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": None, "end_of_word_suffix": None,
                  "fuse_unk": False, "byte_fallback": False, "ignore_merges": True,
                  "vocab": {t: i for i, t in enumerate(tokens[:128000])},
                  "merges": merges},
    }
    with open(os.path.join(d, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(spec, f, ensure_ascii=False)
    with open(os.path.join(d, "tokenizer_config.json"), "w", encoding="utf-8") as f:
        json.dump(hf_tokenizer_config(), f, ensure_ascii=False)


def hf_tensors(params: dict, cfg) -> dict:
    """The params as an HF Llama state dict: [in, out] stacks back to
    per-layer [out, in] tensors (on the device)."""
    lp = params["layers"]
    names = {"attn_norm": "input_layernorm", "mlp_norm": "post_attention_layernorm",
             "wq": "self_attn.q_proj", "wk": "self_attn.k_proj", "wv": "self_attn.v_proj",
             "wo": "self_attn.o_proj", "w_gate": "mlp.gate_proj", "w_up": "mlp.up_proj",
             "w_down": "mlp.down_proj"}
    out = {"model.embed_tokens.weight": params["embed"], "model.norm.weight": params["final_norm"]}
    for li in range(cfg.num_layers):
        for leaf, name in names.items():
            w = lp[leaf][li]
            out[f"model.layers.{li}.{name}.weight"] = (w.T if w.dim() == 2 else w).contiguous()
    if "lm_head" in params:
        out["lm_head.weight"] = params["lm_head"].T.contiguous()
    return out


def gguf_permute(w: torch.Tensor, n_head: int) -> torch.Tensor:
    """llama.cpp's convert_hf_to_gguf permute of q/k rows [out, in]."""
    out, inn = w.shape
    return w.reshape(n_head, 2, out // n_head // 2, inn).transpose(1, 2).reshape(out, inn)


def write_llama_gguf(path: str, params: dict, cfg, tokens: list[str], merges: list[str]):
    """An F16 `llama`-arch GGUF of the params (norms F32; q/k rows in
    llama.cpp's permuted order; tied: no output tensor) with a gpt2-style
    vocabulary. Returns the params as the file holds them, rounded through
    f16, in the model dtype."""
    from dynamo_tpu_torch import gguf

    lp = params["layers"]
    names = {"wq": "attn_q", "wk": "attn_k", "wv": "attn_v", "wo": "attn_output",
             "w_gate": "ffn_gate", "w_up": "ffn_up", "w_down": "ffn_down"}
    f16 = lambda w: w.to(torch.float16).cpu().numpy()  # noqa: E731
    f32 = lambda w: w.float().cpu().numpy()  # noqa: E731
    t = {"token_embd.weight": f16(params["embed"]), "output_norm.weight": f32(params["final_norm"])}
    for li in range(cfg.num_layers):
        t[f"blk.{li}.attn_norm.weight"] = f32(lp["attn_norm"][li])
        t[f"blk.{li}.ffn_norm.weight"] = f32(lp["mlp_norm"][li])
        for leaf, name in names.items():
            w = lp[leaf][li].T
            if leaf in ("wq", "wk"):
                w = gguf_permute(w, cfg.num_heads if leaf == "wq" else cfg.num_kv_heads)
            t[f"blk.{li}.{name}.weight"] = f16(w)
    md = {"general.architecture": "llama", "general.name": "llama3-1b-synthetic",
          "llama.block_count": cfg.num_layers, "llama.context_length": 131072,
          "llama.embedding_length": cfg.hidden_size,
          "llama.feed_forward_length": cfg.intermediate_size,
          "llama.attention.head_count": cfg.num_heads,
          "llama.attention.head_count_kv": cfg.num_kv_heads,
          "llama.attention.key_length": cfg.head_dim,
          "llama.attention.layer_norm_rms_epsilon": cfg.rms_norm_eps,
          "llama.rope.freq_base": cfg.rope_theta,
          "llama.rope.scaling.factor": cfg.rope_scaling_factor,
          "llama.vocab_size": cfg.vocab_size,
          "tokenizer.ggml.model": "gpt2", "tokenizer.ggml.tokens": tokens,
          "tokenizer.ggml.token_type": [1] * 128000 + [3] * 256,
          "tokenizer.ggml.merges": merges,
          "tokenizer.ggml.bos_token_id": 128000, "tokenizer.ggml.eos_token_id": 128001}
    gguf.write_gguf(path, md, t)
    rounded = lambda w: w.to(torch.float16).to(cfg.dtype)  # noqa: E731
    return {"embed": rounded(params["embed"]), "final_norm": params["final_norm"],
            "layers": {k: (v if k.endswith("norm") else rounded(v)) for k, v in lp.items()}}


def same_tree(label: str, got: dict, want: dict) -> None:
    """Raise unless two param trees hold the same leaves bit for bit."""
    flat = lambda p: {**{k: v for k, v in p.items() if k != "layers"},  # noqa: E731
                      **{f"layers.{k}": v for k, v in p["layers"].items()}}
    g, w = flat(got), flat(want)
    bad = sorted(k for k in w if k not in g or g[k].dtype != w[k].dtype
                 or not torch.equal(g[k], w[k]))
    if bad or g.keys() != w.keys():
        raise AssertionError(f"{label}: leaves {bad} differ (keys {sorted(g)} vs {sorted(w)})")


def live_norms(params: dict, dev, seed: int) -> dict:
    """Random init's unit norm weights drawn 1 + N(0, 0.1) from `seed`, so
    a loader that swapped or dropped a norm shows in the tree check."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    layers = dict(params["layers"])
    for name in ("attn_norm", "mlp_norm"):
        x = layers[name]
        layers[name] = (1 + 0.1 * torch.randn(x.shape, generator=gen, device=dev)).to(x.dtype)
    fn = params["final_norm"]
    fin = (1 + 0.1 * torch.randn(fn.shape, generator=gen, device=dev)).to(fn.dtype)
    return {**params, "layers": layers, "final_norm": fin}


def eager_stream(dev, params: dict, prompt: list[int], tokens: int, argv: tuple = (),
                 draft_params: dict | None = None) -> list[int]:
    """Greedy ids of one request through an eager in-process engine built
    as the CLI builds it for llama3-1b and `argv` (cuda_graphs=False), on
    `params` (and a speculation draft's `draft_params`)."""
    from dynamo_tpu_torch.cli import run as cli_run
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.engine.request import SamplingParams

    cfg = cli_run.engine_config(cli_run._parse(["run", "--model", "llama3-1b", *argv]),
                                (128001,))
    eng = TorchEngine(cfg, params=params, device=dev, cuda_graphs=False,
                      draft_params=draft_params)
    eng.add_request("r", prompt, SamplingParams(temperature=0.0, max_tokens=tokens,
                                                 ignore_eos=True))
    out = []
    while eng.has_work:
        for o in eng.step():
            out.extend(o.new_token_ids)
    del eng
    free_memory()
    return out


def greedy_gaps(dev, cfg, params: dict, prompt: list[int], served: list[int]) -> dict:
    """Teacher-forced check of a greedy stream: prompt + served[:-1] as one
    first chunk through the plain path; at each served token, the target's
    top logit less the served token's. Speculation must serve the target's
    greedy token at every position, so each gap must stay under
    GATE_LOGPROB: twice the model gate's bound, since the served logits
    came through the kernels and each of the two logits may part from the
    plain path's by GATE_MAX_DLOGIT. `control_gap`, the least gap at any
    position between the top logit and the median token's, shows that a
    token the target would not pick fails the bound."""
    from dynamo_tpu_torch.models import llama

    n = len(prompt) + len(served) - 1
    pages = -(-n // S)  # the chunk padded to whole pages, the pad not valid
    seq = torch.zeros((1, pages * S), dtype=torch.int32, device=dev)
    seq[0, :n] = torch.tensor(prompt + served[:-1], dtype=torch.int32)
    pos = torch.arange(pages * S, dtype=torch.int32, device=dev)[None]
    pt = torch.arange(1, 1 + pages, dtype=torch.int32, device=dev)[None]
    with torch.no_grad():
        kv = llama.init_kv_pages(cfg, 1 + pages, S, dev)
        logits, _ = llama.forward(params, cfg, seq, pos, pos < n, kv, pt, first_chunk=True,
                                  ops=ops.PLAIN)
        rows = logits[0, len(prompt) - 1:n].float()
        want = torch.tensor(served, device=dev)
        top = rows.max(-1).values
        gaps = top - rows.gather(1, want[:, None])[:, 0]
        control = top - rows.median(-1).values
    del kv, logits
    return {"max_gap": float(gaps.max()), "argmax_served": int((gaps == 0).sum()),
            "tokens": len(served), "control_gap": float(control.min())}


def idle_clear(eng):
    """Run on the engine's thread (AsyncEngineRunner.submit): None while a
    request has work; else the speculation in flight drained, as the idle
    runner drains it, the prefix cache cleared, and (the pages cleared,
    the graphs captured so far)."""
    if eng.has_work:
        return None
    eng.drain_overlap()
    return eng.allocator.clear_cache(), eng.metrics.compiles


def serve_file(argv: list[str], prompt: str, want: list[int], label: str,
               count: bool = False, chat: dict | None = None) -> dict:
    """argv through the CLI's server: one streamed greedy completion of
    `prompt`, CKPT_SERVE_TOKENS tokens, whose ids must be `want`; with
    `count`, the launches of the request (counts set to 0 just before),
    which must be the bf16 pool's variants and no plain version. With
    `chat` (the body, its render, its prompt ids and the eager engine's
    ids on them), then, each on a prefix cache cleared on the engine's
    thread (idle_clear), a streamed chat of that body, a streamed
    completion of the chat's render and the chat again: each must count
    the prompt ids in its usage, none cached, and give the eager engine's
    ids; their TTFTs and the graphs each captured (`compiles` before and
    after it) print."""
    from dynamo_tpu_torch.cli.run import start_server

    t0 = time.perf_counter()
    server = start_server(argv)
    start_s = time.perf_counter() - t0
    model = argv[argv.index("--model") + 1]

    def complete(text: str) -> tuple:
        return _post(server.url + "/v1/completions", {
            "model": model, "prompt": text, "max_tokens": CKPT_SERVE_TOKENS,
            "temperature": 0, "stream": True, "stream_options": {"include_usage": True},
            "ext": {"ignore_eos": True, "return_token_ids": True}})

    try:
        ops.reset_counts()
        status, out, ids, ttft = complete(prompt)
        torch.cuda.synchronize()
        counts = {k: (c.launches, c.plain_calls) for k, c in ops.COUNTS.items()}
        engine = server.runner.engine
        usage = out[-1].get("usage") or {}
        line = {"status": status, "start_s": start_s, "ttft_s": ttft, "tokens": len(ids),
                "usage": usage, "same_as_eager": ids == want,
                "replays_match": replays_match(engine.metrics, engine.dispatches)}
        if chat is not None:
            def cold(post):  # each request on a cold prefix cache
                while (idle := server.runner.submit(idle_clear)) is None:
                    time.sleep(0.01)
                status, out, ids, ttft = post()
                compiles = server.runner.submit(lambda eng: eng.metrics.compiles)
                return {"status": status, "ttft_s": ttft, "usage": out[-1].get("usage") or {},
                        "same_as_eager": ids == chat["want"], "cleared_pages": idle[0],
                        "captures": compiles - idle[1]}

            def chat_post():
                return _post(server.url + "/v1/chat/completions", {
                    **chat["body"], "model": model, "max_tokens": CKPT_SERVE_TOKENS,
                    "temperature": 0, "stream": True, "stream_options": {"include_usage": True},
                    "ext": {"ignore_eos": True, "return_token_ids": True}})

            # the first chat, the render as a completion, the chat again
            runs = {"chat_first": cold(chat_post),
                    "completion_of_render": cold(lambda: complete(chat["render"])),
                    "chat": cold(chat_post)}
            line["chat"] = runs
            if not all(r["status"] == 200 and r["same_as_eager"]
                       and r["usage"].get("prompt_tokens") == len(chat["prompt_ids"])
                       and not (r["usage"].get("prompt_tokens_details") or {}).get(
                           "cached_tokens") for r in runs.values()):
                raise AssertionError(f"{label} chat: {runs} against eager {chat['want']}")
        del engine
    finally:
        server.stop()
        free_server(server)
        del server
    if not (status == 200 and ids == want and usage.get("completion_tokens") == len(want)
            and line["replays_match"]):
        raise AssertionError(f"{label}: {line}, ids {ids} against eager {want}")
    if count:
        want_v = serve_variants(None)
        if any(plain or (n == 0) == (name in want_v) for name, (n, plain) in counts.items()):
            raise AssertionError(f"{label}: launches {counts}")
        line["launches"] = {k: n for k, (n, _) in counts.items()}
    return line


def chat_checks(tok) -> dict:
    """The directory's chat template (CHAT_TEMPLATE_REPO's) on the card
    machine: the render of CHAT_MESSAGES and CHAT_TOOLS must have the
    committed digest and encode Llama-3's header and turn specials as
    theirs; then the render ms of a 32-turn, four-tool conversation under
    each of CHAT_TEMPLATES (the median of 10 renders, each parsed once, as
    a tokenizer does at load) and the encode ms of the render and of the
    32-turn render under the directory's template. Returns the numbers,
    with the render and its ids for the server."""
    from dynamo_tpu_torch.preprocessor.chat_template import ChatTemplate

    t0 = time.perf_counter()
    render = tok.apply_chat_template(CHAT_MESSAGES, tools=CHAT_TOOLS)
    first_ms = 1e3 * (time.perf_counter() - t0)
    digest = hashlib.sha256(render.encode()).hexdigest()
    t0 = time.perf_counter()
    prompt_ids = tok.encode(render)
    encode_ms = 1e3 * (time.perf_counter() - t0)
    if digest != CHAT_RENDER_SHA256 or not {128000, 128006, 128007, 128009} <= set(prompt_ids):
        raise AssertionError(f"checkpoint chat: render digest {digest} against "
                             f"{CHAT_RENDER_SHA256}, {len(prompt_ids)} ids")
    messages, tools = chat_render_conversation()
    render_ms, renders = {}, {}
    for repo, source in CHAT_TEMPLATES.items():
        template, times = ChatTemplate(source), []
        for _ in range(10):
            t0 = time.perf_counter()
            renders[repo] = template.render(**tok.special_tokens_map, messages=messages,
                                            tools=tools, documents=None,
                                            add_generation_prompt=True)
            times.append(1e3 * (time.perf_counter() - t0))
        render_ms[repo] = statistics.median(times)
    t0 = time.perf_counter()
    long_ids = tok.encode(renders[CHAT_TEMPLATE_REPO])
    return {"render_sha256": digest, "render_chars": len(render), "render_ms_first": first_ms,
            "prompt_tokens": len(prompt_ids), "encode_ms": encode_ms,
            "render_ms_32_turns": render_ms,
            "render_chars_32_turns": {k: len(v) for k, v in renders.items()},
            "encode_ms_32_turns": 1e3 * (time.perf_counter() - t0),
            "tokens_32_turns": len(long_ids), "render": render, "prompt_ids": prompt_ids}


def phase_checkpoint(dev, card: str) -> dict:
    """Checkpoint files at llama3-1b's full width, each written by the phase
    into a temporary directory and removed after its part:
    - an HF directory: Llama-3.2-1B's published config.json, bf16
      safetensors of random weights (norms 1 + N(0, 0.1)) from a seed, a
      synthetic byte-level BPE tokenizer.json of Llama-3's 128,256 entries
      and a tokenizer_config.json with CHAT_TEMPLATE_REPO's chat template;
      a llama3-draft-shaped directory of bf16 weights beside it;
    - an F16 `llama`-arch GGUF of the same weights (q/k rows permuted, a
      gpt2-style vocabulary of the same tokens and merges).
    Checks: each loaded tree is bit-equal to what was written (after f16
    rounding for the GGUF; the draft through the engine's draft_params);
    tokenizer round trips (HfTokenizer and GgufTokenizer decode their own
    encode of the prompt); the CLI's server on each file answers a
    streamed completion of a 3,000-character prompt with the ids of an
    eager in-process engine on the written tensors (the directory's
    server's launches are the kernels line's `checkpoint_launches`), and
    the directory's server a streamed chat with tools (chat_checks,
    serve_file's `chat`); the
    directory under --quantize int8 passes the model gate (gate_paths);
    --spec-draft llama3-draft --spec-draft-checkpoint <draft dir> serves
    the ids of an eager engine of the same knobs on the written tensors,
    each a token the target picks (greedy_gaps). Prints load seconds,
    encode ms (of the prompt's words, which the vocabulary holds whole,
    and `encode_ms_merges` of words it lacks, so that the merges run) and
    TTFT beside the card."""
    from dynamo_tpu_torch import gguf
    from dynamo_tpu_torch.cli import run as cli_run
    from dynamo_tpu_torch.engine.engine import TorchEngine
    from dynamo_tpu_torch.models import checkpoint
    from dynamo_tpu_torch.models.llama import LlamaConfig
    from dynamo_tpu_torch.models.registry import get_model
    from dynamo_tpu_torch.preprocessor.tokenizer import GgufTokenizer, HfTokenizer

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="dyn_ckpt_")
    line = {"phase": "checkpoint", "model": "llama3-1b", "card": card}
    try:
        adapter = get_model("llama3-1b")
        cfg = adapter.config
        if LlamaConfig.from_hf_config(LLAMA32_1B_CONFIG) != cfg:
            raise AssertionError("checkpoint: Llama-3.2-1B's config does not map onto llama3-1b")
        params = live_norms(adapter.init_params(torch.Generator(device=dev).manual_seed(28)),
                            dev, 28)
        t0 = time.perf_counter()
        tokens, merges = synthetic_llama3_vocab(28)
        d, draft_dir = os.path.join(root, "llama3-1b"), os.path.join(root, "llama3-draft")
        os.makedirs(d)
        os.makedirs(draft_dir)
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(LLAMA32_1B_CONFIG, f)
        checkpoint.save_safetensors(os.path.join(d, "model.safetensors"),
                                    hf_tensors(params, cfg))
        write_hf_tokenizer(d, tokens, merges)
        draft_adapter = get_model("llama3-draft")
        draft = live_norms(draft_adapter.init_params(
            torch.Generator(device=dev).manual_seed(29)), dev, 29)
        with open(os.path.join(draft_dir, "config.json"), "w") as f:
            json.dump(DRAFT_CONFIG, f)
        checkpoint.save_safetensors(os.path.join(draft_dir, "model.safetensors"),
                                    hf_tensors(draft, draft_adapter.config))
        line["write_dir_s"] = time.perf_counter() - t0
        line["dir_bytes"] = sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
        # the directory's tree, bit for bit
        dir_adapter = get_model(d)
        if dir_adapter.config != cfg or dir_adapter.default_checkpoint != d:
            raise AssertionError(f"checkpoint: get_model(dir) gave {dir_adapter}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loaded = dir_adapter.load_params(d, dev)
        torch.cuda.synchronize()
        line["load_dir_s"] = time.perf_counter() - t0
        same_tree("checkpoint dir", loaded, params)
        del loaded
        # the tokenizer: encode ms of the 3,000-character prompt, round trips
        prompt = ckpt_prompt(28)
        t0 = time.perf_counter()
        tok = HfTokenizer(d)
        line["tokenizer_load_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ids = tok.encode(prompt)
        line["encode_ms_first"] = 1e3 * (time.perf_counter() - t0)
        times = []
        for i in range(5):  # each a prompt of other words' order: the word cache warm
            other = ckpt_prompt(100 + i)
            t0 = time.perf_counter()
            tok.encode(other)
            times.append(1e3 * (time.perf_counter() - t0))
        line["encode_ms"] = statistics.median(times)
        line["prompt_chars"], line["prompt_tokens"] = len(prompt), len(ids)
        # words the vocabulary lacks, so the merges run: each a new prompt
        times, oov_tokens = [], []
        for i in range(5):
            oov = ckpt_oov_prompt(200 + i)
            t0 = time.perf_counter()
            oov_ids = tok.encode(oov)
            times.append(1e3 * (time.perf_counter() - t0))
            oov_tokens.append(len(oov_ids))
            if tok.decode(oov_ids) != oov:
                raise AssertionError(f"checkpoint: HfTokenizer round trip of prompt {200 + i} "
                                     "of words out of the vocabulary failed")
        line["encode_ms_merges"] = statistics.median(times)
        line["encode_ms_merges_each"] = times
        line["merges_prompt_tokens"] = oov_tokens
        specials = tok.encode("<|begin_of_text|>hi<|eot_id|><|eom_id|><|python_tag|>")
        if not (tok.vocab_size == 128256 and tok.eos_token_ids == (128001,)
                and tok.decode(ids) == prompt and 128000 > max(ids)
                and (specials[0], specials[-3:]) == (128000, [128009, 128008, 128010])):
            raise AssertionError(f"checkpoint: HfTokenizer round trip failed: {line}")
        line["chat"] = chat = chat_checks(tok)
        # the CLI's server on the directory against the eager engine
        want = eager_stream(dev, params, ids, CKPT_SERVE_TOKENS)
        chat_serve = {"body": {"messages": CHAT_MESSAGES, "tools": CHAT_TOOLS},
                      "render": chat.pop("render"), "prompt_ids": chat.pop("prompt_ids")}
        chat_serve["want"] = eager_stream(dev, params, chat_serve["prompt_ids"],
                                          CKPT_SERVE_TOKENS)
        serve = serve_file(["run", "in=http", "out=torch", "--model", d, "--port", "0"],
                           prompt, want, "checkpoint dir serve", count=True, chat=chat_serve)
        launches = serve.pop("launches")
        line["serve_dir"] = serve
        # --quantize int8 on the directory: the CLI's engine, then the model gate
        t0 = time.perf_counter()
        argv = ["run", "--model", d, "--quantize", "int8"]
        eng = TorchEngine(cli_run.engine_config(cli_run._parse(argv), (128001,)), device=dev)
        qparams = eng.params
        del eng
        free_memory()
        if qparams["layers"]["wq"].dtype != torch.int8:
            raise AssertionError("checkpoint: --quantize int8 left the weights unquantized")
        stats = gate_paths(dev, dir_adapter, {"kernel": (ops.KERNELS, qparams, None),
                                              "plain": (ops.PLAIN, qparams, None)},
                           (512, 256), 16, "checkpoint dir, --quantize int8")
        worst, agree, rows = stats[("kernel", "plain")][:3]
        line["int8_gate"] = {"max_abs_dlogit": worst, "argmax_agreement": agree / rows,
                             "seconds": time.perf_counter() - t0}
        if agree / rows < GATE_ARGMAX:
            raise AssertionError(f"checkpoint int8 gate: {line['int8_gate']}")
        del qparams
        free_memory()
        # --spec-draft llama3-draft --spec-draft-checkpoint <draft dir>
        t0 = time.perf_counter()
        spec_argv = ["run", "in=http", "out=torch", "--model", d, "--port", "0",
                     "--spec-draft", "llama3-draft", "--spec-draft-checkpoint", draft_dir]
        from dynamo_tpu_torch.cli.run import start_server

        server = start_server(spec_argv)
        try:
            same_tree("checkpoint draft", server.runner.engine.draft_params, draft)
            status, out, sids, ttft = _post(server.url + "/v1/completions", {
                "model": d, "prompt": prompt[:600], "max_tokens": 32, "temperature": 0,
                "stream": True, "ext": {"ignore_eos": True, "return_token_ids": True}})
            m = server.runner.engine.metrics
            line["serve_spec"] = {"status": status, "tokens": len(sids), "ttft_s": ttft,
                                  "spec_drafted": m.spec_drafted,
                                  "spec_accepted": m.spec_accepted,
                                  "seconds": time.perf_counter() - t0}
        finally:
            server.stop()
            free_server(server)
            del server
        # the served stream against the eager engine of the same knobs on
        # the written tensors, each token against the target's greedy
        # choice, and (reported) the target's own decode without a draft
        spec_ids = tok.encode(prompt[:600])
        spec_want = eager_stream(dev, params, spec_ids, 32, ("--spec-draft", "llama3-draft"),
                                 draft)
        plain = eager_stream(dev, params, spec_ids, 32)
        gaps = greedy_gaps(dev, cfg, params, spec_ids, sids)
        line["serve_spec"].update(
            same_as_eager_spec=sids == spec_want, greedy_gaps=gaps,
            leading_equal_to_decode=next((i for i, (a, b) in enumerate(zip(sids, plain))
                                          if a != b), len(plain)))
        if not (status == 200 and len(sids) == 32 and line["serve_spec"]["spec_drafted"] > 0
                and sids == spec_want and gaps["max_gap"] < GATE_LOGPROB
                and gaps["control_gap"] > GATE_LOGPROB):
            raise AssertionError(f"checkpoint spec serve: {line['serve_spec']}, ids {sids} "
                                 f"against eager {spec_want}")
        shutil.rmtree(d)
        shutil.rmtree(draft_dir)
        del draft
        # the GGUF of the same weights
        path = os.path.join(root, "llama3-1b-f16.gguf")
        t0 = time.perf_counter()
        rounded = write_llama_gguf(path, params, cfg, tokens, merges)
        line["write_gguf_s"] = time.perf_counter() - t0
        line["gguf_bytes"] = os.path.getsize(path)
        t0 = time.perf_counter()
        g_adapter = get_model(path)
        line["gguf_parse_s"] = time.perf_counter() - t0
        # GGUF metadata has no tie flag (the reference's mapping leaves it
        # False): the file's missing output tensor ties the embedding
        if g_adapter.config != dataclasses.replace(cfg, tie_word_embeddings=False):
            raise AssertionError(f"checkpoint: get_model(gguf) gave {g_adapter.config}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loaded = g_adapter.load_params(path, dev)
        torch.cuda.synchronize()
        line["load_gguf_s"] = time.perf_counter() - t0
        same_tree("checkpoint gguf", loaded, rounded)
        del loaded
        gtok = GgufTokenizer(path)
        gids = gtok.encode(prompt)
        if not (gtok.decode(gids) == prompt and gtok.eos_token_ids == (128001,)
                and gtok.vocab_size == 128256):
            raise AssertionError("checkpoint: GgufTokenizer round trip failed")
        line["gguf_prompt_tokens"] = len(gids)
        want = eager_stream(dev, rounded, gids, CKPT_SERVE_TOKENS)
        gguf._PARSE_CACHE.clear()  # the server's start parses the file once, as a fresh one
        line["serve_gguf"] = serve_file(["run", "in=http", "out=torch", "--model", path,
                                         "--port", "0"], prompt, want, "checkpoint gguf serve")
        del rounded, params
    finally:
        shutil.rmtree(root, ignore_errors=True)
        free_memory()
    line["seconds"] = time.perf_counter() - t_phase
    emit(line)
    return {"launches": launches}


# -- phase 5: serve ---------------------------------------------------------------


def _post(url, body, first_by_choice: dict | None = None
          ) -> tuple[int, list, list[int], float | None]:
    """(status, the response's objects, the token ids its choices carry,
    seconds from sending the request to the first chunk with a token).

    A stream's objects are its SSE events before [DONE]; a unary response
    is one object (and no first-token time). A stream fills
    `first_by_choice`, where given, with each choice index's first-token
    seconds."""
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    ttft = None
    with urllib.request.urlopen(req, timeout=600) as resp:
        status = resp.status
        if not body.get("stream"):
            out = [json.load(resp)]
        else:
            out = []
            for raw in resp:
                line = raw.decode().strip()
                if not line:
                    continue
                if line == "data: [DONE]":
                    break
                event = json.loads(line[len("data: "):])
                if ttft is None and any(c.get("token_ids") for c in event["choices"]):
                    ttft = time.perf_counter() - t0
                if first_by_choice is not None:
                    for c in event["choices"]:
                        if c.get("token_ids"):
                            first_by_choice.setdefault(c["index"], time.perf_counter() - t0)
                out.append(event)
            else:
                raise AssertionError(f"{url}: stream did not end in [DONE]")
    ids = [t for o in out for c in o["choices"] for t in c.get("token_ids", [])]
    return status, out, ids, ttft


def post_together(jobs: list) -> list:
    """_post(url, body) for every (url, body) of `jobs` at once, each on a
    thread of its own: their results in order; a request that raised
    raises here, on the caller's thread."""
    results: list = [None] * len(jobs)

    def run(i):
        try:
            results[i] = _post(*jobs[i])
        except Exception as e:  # re-raised below, on the main thread
            results[i] = e

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(jobs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for res in results:
        if isinstance(res, Exception):
            raise res
    return results


#: a system message of about 1,100 bytes (one token a byte) two chats share
SYSTEM_MESSAGE = ("You are a careful assistant for a team that runs language models on "
                  "GPUs. Answer in plain words, name every number's source, and say so "
                  "when you do not know. ") * 7
SYSTEM_QUESTIONS = ("Which kernel reads the cached pages?", "How large is one page?")


#: the n = 3 request: seeded, its draws confined to three ids whose +33,
#: +66 and +99 biases keep their order whatever a batch's rounding does
#: (temperature 33 spaces them one apart, top_k 3 drops every other id),
#: so each choice equals a lone request with seed s + i to the id
N_CHOICES = dict(n=3, seed=5, temperature=33.0, top_k=3, max_tokens=6,
                 logit_bias={"1000": 33, "2000": 66, "3000": 99})


def _n3_prompt(tag: str) -> list[dict]:
    """A fresh prompt of about 1,100 bytes, apart in its first page from
    another tag's: each misses the prefix cache on its first request."""
    return [{"role": "user", "content": f"choices {tag}: " + "a long question " * 68}]


def serve_sampling(url: str) -> dict:
    """The sampling surface through the bf16 server, one request at a time:
    a streamed chat with logprobs and top_logprobs 5, a completion with
    logprobs 3, n = 3 (N_CHOICES) against three lone requests with seeds
    s, s + 1 and s + 2, the n = 3 request streamed (the same choices),
    first-token seconds of n = 3 against other schedules (choices 1 and 2
    are submitted once choice 0's first token came, so that they hit its
    cached prompt), and a penalized chat. Each must answer 200 in the
    reference's shapes, with usage counting every token."""
    chat = url + "/v1/chat/completions"
    ext = {"ignore_eos": True, "return_token_ids": True}
    msg = [{"role": "user", "content": "sampling surface"}]
    out = {}
    status, events, ids, _ = _post(chat, {
        "model": "llama3-1b", "messages": msg, "max_tokens": 16, "logprobs": True,
        "top_logprobs": 5, "stream": True, "stream_options": {"include_usage": True},
        "ext": ext})
    entries = [e for ev in events for c in ev["choices"]
               for e in (c.get("logprobs") or {}).get("content", [])]
    if not (status == 200 and len(entries) == len(ids) == 16
            and events[-1]["usage"]["completion_tokens"] == 16
            and all(len(e["top_logprobs"]) == 5 and e["top_logprobs"][0]["logprob"]
                    == e["logprob"] for e in entries)):
        raise AssertionError(f"serve: chat logprobs: {status}, {len(entries)} entries")
    out["chat_logprobs"] = [e["logprob"] for e in entries]
    status, resp, ids, _ = _post(url + "/v1/completions", {
        "model": "llama3-1b", "prompt": "Once upon a time", "max_tokens": 12, "logprobs": 3,
        "ext": ext})
    lp = resp[0]["choices"][0]["logprobs"]
    if not (status == 200 and len(lp["tokens"]) == len(lp["token_logprobs"]) == len(ids) == 12
            and set(lp) == {"tokens", "token_logprobs", "top_logprobs", "text_offset"}):
        raise AssertionError(f"serve: completion logprobs: {status}, {lp}")
    status, resp, _, _ = _post(chat, {"model": "llama3-1b", "messages": msg, "ext": ext,
                                      **N_CHOICES})
    choices = {c["index"]: c["token_ids"] for c in resp[0]["choices"]}
    alone = [_post(chat, {"model": "llama3-1b", "messages": msg, "ext": ext,
                          **{**N_CHOICES, "n": 1, "seed": N_CHOICES["seed"] + i}})[2]
             for i in range(3)]
    if not (status == 200 and sorted(choices) == [0, 1, 2]
            and [choices[i] for i in range(3)] == alone
            and resp[0]["usage"]["completion_tokens"] == 3 * N_CHOICES["max_tokens"]):
        raise AssertionError(f"serve: n = 3 gave {choices}, lone requests {alone}, "
                             f"usage {resp[0]['usage']}")
    out["n3"] = [choices[i] for i in range(3)]
    stream = {"stream": True, "stream_options": {"include_usage": True}}

    def n3_streamed(messages) -> tuple[list, list]:
        first: dict = {}
        status, events, _, _ = _post(chat, {"model": "llama3-1b", "messages": messages,
                                            "ext": ext, **stream, **N_CHOICES}, first)
        got = [[t for ev in events for c in ev["choices"] if c["index"] == i
                for t in c.get("token_ids", [])] for i in range(3)]
        if not (status == 200 and sorted(first) == [0, 1, 2]
                and events[-1]["usage"]["completion_tokens"] == 3 * N_CHOICES["max_tokens"]):
            raise AssertionError(f"serve: n = 3 streamed: {status}, {got}, {first}")
        return got, [first[i] for i in range(3)]

    if n3_streamed(msg)[0] != out["n3"]:
        raise AssertionError(f"serve: n = 3 streamed differs from unary {out['n3']}")

    def lone(messages, seed: int) -> float:
        return _post(chat, {"model": "llama3-1b", "messages": messages, "ext": ext, **stream,
                            **{**N_CHOICES, "n": 1, "seed": seed}})[3]

    def together(messages) -> list:
        got: list = [None] * 3

        def run(i):
            got[i] = lone(messages, N_CHOICES["seed"] + i)

        threads = [threading.Thread(target=run, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if None in got:
            raise AssertionError(f"serve: three lone requests together: {got}")
        return got

    # first-token seconds of n = 3's choices, of three lone requests with
    # seeds s, s + 1, s + 2 sent together (the schedule of siblings
    # submitted at once) and of one lone request; on the short prompt
    # (under a page: no hit) and on fresh prompts of 1,116 tokens (choices
    # 1 and 2 hit choice 0's pages); round 0 captures the arms' keys
    out["n3_schedules"] = [
        {"round": r, "prompt": name, "n3_ttft_s": n3_streamed(prompt(f"n{r}"))[1],
         "three_together_ttft_s": together(prompt(f"t{r}")),
         "lone_ttft_s": lone(prompt(f"l{r}"), N_CHOICES["seed"])}
        for r in range(2) for name, prompt in (("short", lambda tag: msg), ("long", _n3_prompt))]
    status, resp, ids, _ = _post(chat, {
        "model": "llama3-1b", "messages": msg, "max_tokens": 24, "frequency_penalty": 1.0,
        "presence_penalty": 0.5, "repetition_penalty": 1.3, "ext": ext})
    if not (status == 200 and len(ids) == resp[0]["usage"]["completion_tokens"] == 24):
        raise AssertionError(f"serve: the penalized chat: {status}, {len(ids)} ids")
    out["penalized_distinct_ids"] = len(set(ids))
    return out


def serve_variants(mode, quantize=None) -> list[str]:
    """The kernel variants a server over a `mode` pool (and, with quantize
    "int8", int8 weights) must launch."""
    return ["flash_prefill_attention"] + [
        kv_quant.variant(n, mode)
        for n in ("paged_write", "paged_decode_attention", "paged_prefill_attention")
    ] + (["int8_matmul"] if quantize else [])


def param_bytes(params: dict) -> tuple[int, int]:
    """(bytes the params hold on the device, bytes of the same model in
    bf16): every leaf but the int8 weights' scales at 2 bytes a value."""
    leaves = [(k, v) for k, v in params.items() if k != "layers"]
    leaves += list(params["layers"].items())
    held = sum(v.numel() * v.element_size() for _, v in leaves)
    return held, sum(2 * v.numel() for k, v in leaves if not k.endswith("_scale"))


def phase_serve(card: str, mode, quantize=None) -> dict:
    """Serve over a bf16 pool (mode None: the full request mix), a
    quantized one (the long prompt and three streaming chats together,
    then the shared-system pair and the greedy pair one at a time), or,
    with quantize "int8", int8 weights over a bf16 pool (the long prompt
    and a streaming chat together, then the greedy pair one at a time)."""
    from dynamo_tpu_torch.cli.run import start_server

    # no --prefill-chunk: the CLI's default chunk (512) is what is served
    argv = ["run", "in=http", "out=torch", "--model", "llama3-1b", "--port", "0",
            "--dtype", "bfloat16", "--max-context", str(SERVE_CONTEXT)]
    if mode is not None:
        argv += ["--kv-quantize", mode]
    if quantize is not None:
        argv += ["--quantize", quantize]
    server = start_server(argv)
    try:
        chat = server.url + "/v1/chat/completions"
        # every choice carries its token ids (random weights over a
        # 128,256-id vocabulary seldom pick one of the 256 byte tokens, so
        # the text alone says little)
        ext = {"ignore_eos": True, "return_token_ids": True}
        stream = {"stream": True, "stream_options": {"include_usage": True}}
        jobs = [
            (chat, {"model": "llama3-1b", "max_tokens": 96, "ext": ext, **stream,
                    "messages": [{"role": "user", "content": f"stream {i}: " + "tell me " * 8 * i}]})
            for i in range(1, 4)
        ] + [
            # the byte tokenizer makes one token per byte: over 1,200 prompt
            # tokens, so at least three chunks of 512
            (chat, {"model": "llama3-1b", "max_tokens": 32, "ext": ext, **stream,
                    "messages": [{"role": "user", "content": "a long prompt: " + "abcdefgh " * 135}]}),
        ]
        # the greedy pair's prompt is under one page: the prefix cache can
        # give its second request no hit, and so no other shapes
        greedy = (chat, {"model": "llama3-1b", "max_tokens": 40, "ext": ext, **stream,
                         "messages": [{"role": "user", "content": "greedy twice"}]})
        # two chats that share a system message of about 1,100 bytes, one
        # after the other: the second is served from the prefix cache
        system = {"role": "system", "content": SYSTEM_MESSAGE}
        shared = [(chat, {"model": "llama3-1b", "max_tokens": 8, "ext": ext, **stream,
                          "messages": [system, {"role": "user", "content": q}]})
                  for q in SYSTEM_QUESTIONS]
        first_wave = len(jobs)
        if quantize is not None:
            jobs = jobs[2:]  # a streaming chat and the long prompt
            first_wave = first = len(jobs)
            jobs += [greedy, greedy]
            pairs = ((first, first + 1),)
        elif mode is None:
            jobs += [
                (chat, {"model": "llama3-1b", "max_tokens": 64, "ext": ext,
                        "messages": [{"role": "user", "content": "a unary chat"}]}),
                (server.url + "/v1/completions",
                 {"model": "llama3-1b", "prompt": "Once upon a time", "max_tokens": 48,
                  "ext": ext}),
            ]
            seeded = (chat, {"model": "llama3-1b", "max_tokens": 40, "ext": ext, **stream,
                             "seed": 7, "temperature": 0.8, "top_p": 0.95,
                             "messages": [{"role": "user", "content": "sampled twice"}]})
            first_wave = len(jobs)
            jobs += shared
            first = len(jobs)
            jobs += [greedy, seeded, greedy, seeded]
            pairs = ((first, first + 2), (first + 1, first + 3))
        else:
            jobs += shared
            first = len(jobs)
            jobs += [greedy, greedy]
            pairs = ((first, first + 1),)
        results: list = []
        ops.reset_counts()
        t0 = time.perf_counter()
        # the first wave together; then the shared-system pair and each
        # pair's requests one at a time: alone, both of a pair run the same
        # shapes, so they must agree to the bit (other batch sizes round
        # bf16 GEMMs differently)
        for wave in [range(first_wave)] + [[i] for i in range(first_wave, len(jobs))]:
            results += post_together([jobs[i] for i in wave])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: (c.launches, c.plain_calls) for k, c in ops.COUNTS.items()}
        engine = server.runner.engine
        chunk = engine.config.prefill_chunk
        held, bf16_bytes = param_bytes(engine.params)
        pool = {"param_bytes": held, "param_bytes_bf16": bf16_bytes,
                "kv_pool_bytes": engine.metrics.kv_pool_bytes,
                "kv_pool_bytes_dense_equiv": engine.metrics.kv_pool_bytes_dense_equiv,
                "pool_dtype": str(engine.kv.k.dtype)}
        graphs = {k: getattr(engine.metrics, k) for k in
                  ("compiles", "compile_ms", "prefill_dispatches", "prefill_replays",
                   "decode_dispatches", "decode_replays", "mixed_dispatches", "mixed_replays",
                   "overlap_dispatches", "overlap_hits", "overlap_rollbacks")}
        graphs["dispatches"] = engine.dispatches
        graphs["overlap_decode"] = engine.config.overlap_decode
        graphs["mixed_steps"] = engine.config.mixed_steps
        replayed = replays_match(engine.metrics, engine.dispatches)
        sampled = None
        if mode is None and quantize is None:
            # after the request mix's counts are read, so that its launches
            # stay those of the mix alone
            ops.reset_counts()
            sampled = serve_sampling(server.url)
            torch.cuda.synchronize()
            sampled["launches"] = {k: c.launches for k, c in ops.COUNTS.items()}
            sampled["plain_calls"] = sum(c.plain_calls for c in ops.COUNTS.values())
            sampled["replays_match"] = replays_match(engine.metrics, engine.dispatches)
    finally:
        server.stop()
        del server
        torch.cuda.empty_cache()

    label = f"serve, {quantize or 'bf16'} weights, {mode or 'bf16'} pool"
    out_tokens = 0
    ttft = []
    prompt_tokens = []
    for (url, body), (status, out, ids, first_token) in zip(jobs, results):
        if status != 200:
            raise AssertionError(f"{label}: {url}: status {status}")
        use = out[-1]["usage"]
        if use["completion_tokens"] != len(ids) or len(ids) != body["max_tokens"]:
            raise AssertionError(f"{label}: {url}: usage {use} but {len(ids)} token ids served")
        prompt_tokens.append(use["prompt_tokens"])
        out_tokens += len(ids)
        if body.get("stream"):
            ttft.append(first_token)
    for a, b in pairs:  # the greedy pair (and the seeded pair)
        if results[a][2] != results[b][2]:
            raise AssertionError(f"{label}: requests {a} and {b} should be identical")
    # the shared-system pair: the second's cached tokens are the whole pages
    # of the two prompts' common prefix, all but the last page at most
    want_cached = None
    if quantize is None:
        tok = ByteTokenizer()
        a, b = (tok.encode(tok.apply_chat_template(body["messages"])) for _, body in shared)
        common = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        want_cached = min(common // S, (len(b) - 1) // S) * S
        usages = [results[i][1][-1]["usage"] for i in (first - 2, first - 1)]
        if "prompt_tokens_details" in usages[0] or usages[1].get("prompt_tokens_details") != {
                "cached_tokens": want_cached} or want_cached < 1024:
            raise AssertionError(f"{label}: the shared-system pair's usage {usages}, want "
                                 f"{want_cached} cached tokens on the second only")
    long_prompt = prompt_tokens[1 if quantize else 3]
    if long_prompt <= 1200 or chunk != 512:
        raise AssertionError(f"{label}: the long request's prompt is {long_prompt} "
                             f"tokens, served at a chunk of {chunk}")
    # served as the CLI serves with no flags: overlapped decode and mixed
    # steps, every prefill, decode and mixed dispatch a replay
    if not (graphs["overlap_decode"] and graphs["mixed_steps"] and graphs["compiles"]
            and replayed and graphs["prefill_dispatches"] > 0 and graphs["decode_replays"] > 0
            and graphs["mixed_dispatches"] > 0
            and graphs["overlap_dispatches"] == graphs["overlap_hits"]
            + graphs["overlap_rollbacks"]):
        raise AssertionError(f"{label}: dispatches did not all replay graphs: {graphs}")
    want = serve_variants(mode, quantize)
    for name, (launches, plain) in counts.items():
        if plain != 0 or (launches == 0) == (name in want):
            raise AssertionError(f"{label}: {name} launched {launches} times, plain ran "
                                 f"{plain} (the pool's variants: {want})")
    result = {"phase": "serve", "model": "llama3-1b", "dtype": "bfloat16",
              "quantize": quantize, "kv_quantize": mode, "card": card, "prefill_chunk": chunk,
              "requests": len(jobs), "prompt_tokens": prompt_tokens,
              "shared_system_cached_tokens": want_cached,
              "output_tokens": out_tokens, "wall_s": wall,
              "tok_s": out_tokens / wall, "ttft_p50_s": statistics.median(ttft),
              "ttft_s": ttft,
              "ttft": "at the client, from sending a streaming request to the first SSE "
                      "chunk that carries a token",
              **pool, **graphs,
              "dense_equiv_over_pool_bytes": pool["kv_pool_bytes_dense_equiv"]
              / pool["kv_pool_bytes"],
              "launches": {k: v[0] for k, v in counts.items() if k in want},
              "plain_calls": {k: v[1] for k, v in counts.items()}}
    if sampled is not None:
        if sampled["plain_calls"] or not sampled["replays_match"]:
            raise AssertionError(f"{label}: the sampling requests: {sampled}")
        result["sampling"] = sampled
    emit(result)
    return result


# -- main -------------------------------------------------------------------------


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = platform.card_info()
    kind = torch.cuda.get_device_name(0)
    peaks = platform.device_peaks(kind)
    emit({"phase": "card", "nvidia_smi": card, "torch_device": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    t0 = time.perf_counter()
    report = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "libraries": report})
    # first, on an empty card: phi4's 29 GB of weights and its 15 GB f32
    # temporary at init beside nothing the later phases hold
    families = phase_families(dev, card)
    free_memory()  # the families' engines and servers, before the kernel cases
    cases = phase_kernels(dev, peaks)
    # each engine phase starts with only the kernel cases' inputs held
    # (they stay for phase 6): free_memory() collects the engines an
    # earlier phase left in reference cycles
    for phase in (phase_model, phase_graphs, phase_int8_graphs):
        free_memory()
        phase(dev)
    for phase in (phase_prefix, phase_mixed, phase_sampling):
        free_memory()
        phase(dev, card)
    free_memory()
    kstep = phase_kstep(dev, card)
    free_memory()
    spec = phase_spec(dev, card)
    free_memory()
    draft = phase_draft(dev, card)
    free_memory()
    checkpoint = phase_checkpoint(dev, card)
    # each server's run is the main path of its pool's kernel variants
    launches = {}
    # flash_prefill_attention counts from the bf16 server, int8_matmul from
    # the int8-weight one
    for mode, quantize in [(m, None) for m in MODES] + [(None, "int8")]:
        free_memory()
        for name, n in phase_serve(card, mode, quantize)["launches"].items():
            launches.setdefault(name, n)
    phase_device_times(cases)
    free_memory()
    # first, so the kernels line reports the main path's write
    cases = phase_preset_writes(dev, peaks) + cases
    for c in cases:
        emit({"phase": "kernels", **c})
    # the kernels line reports each variant at its last shape above
    kernels = {c["kernel"]: c for c in cases}
    lines = []
    for name, (src, replaces) in SOURCE.items():
        for mode in MODES if name in QUANT_BRANCH else (None,):
            variant = kv_quant.variant(name, mode)
            c = kernels[variant]
            lines.append({
                "name": variant, "route": "cuda", "source": src,
                "replaces": replaces if mode is None
                else f"{replaces}; quantized branch {QUANT_BRANCH[name]}",
                "launches": launches[variant], "max_abs_err": c["max_abs_err"],
                "ms": c["ms"], "device_ms": c["device_ms"], "plain_ms": c["plain_ms"],
                "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
                "library_ms": c["library_ms"], "library_device_ms": c["library_device_ms"],
                # the CLI's engine with --decode-kstep 16 (phase "kstep"): all its
                # launches, and those made by replays of its window graphs
                "kstep_launches": kstep["launches"].get(variant, 0),
                "window_launches": kstep["window_launches"].get(variant, 0),
                # the CLI's engine with --spec-ngram 4 (phase "spec"): all its
                # launches, and those made by replays of its verify graphs
                "spec_launches": spec["launches"].get(variant, 0),
                "verify_launches": spec["verify_launches"].get(variant, 0),
                # the CLI's engine with --spec-draft llama3-1b, overlap on, no
                # cooldown (phase "draft", bf16 pool): all its launches, and
                # those made by replays of its spec_fused graphs
                "draft_launches": draft["launches"].get(variant, 0),
                "spec_fused_launches": draft["spec_fused_launches"].get(variant, 0),
                # qwen2-7b (a query group of 7) and gemma-2b (head_dim 256)
                # through the CLI's server, bf16 pool (phase "families")
                "families_launches": families["qwen2-7b"]["launches"].get(variant, 0),
                "gemma_launches": families["gemma-2b"]["launches"].get(variant, 0),
                # the CLI's server on a llama3-1b checkpoint directory (phase
                # "checkpoint", bf16 pool): one 3,000-character completion
                "checkpoint_launches": checkpoint["launches"].get(variant, 0),
            })
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    emit({"kernels": lines})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
