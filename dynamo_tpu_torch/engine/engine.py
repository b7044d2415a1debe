"""TorchEngine: continuous batching over the paged-KV llama model.

Counterpart of dynamo_tpu/engine/engine.py::JaxEngine for the main path:
batched chunked prefill, then decode with `decode_steps` fused steps per
host sync (sampled ids feed back on the device; tokens past a stop are
computed and dropped on the host, as the JAX engine drops them). Every
step runs the model's kernel path: the paged KV write, first-chunk flash
prefill, prefill over a chunk with history and paged decode attention
(dynamo_tpu_torch/ops).

On the card each dispatch, a prefill chunk step or a decode dispatch,
replays a CUDA graph captured for its step key at the key's first
dispatch (`_get_step_fn`, `_cache_graph`, engine/step_graph.py), as the
JAX engine runs a compiled program per key. The eager bodies serve the
CPU and an engine built with `cuda_graphs=False`.

Overlapped decode (config.overlap_decode, as in the JAX engine): after
dispatching decode step N the engine dispatches step N+1 on speculation
(same batch, positions advanced, tokens taken from step N's ids on the
device) before it reads step N's ids, whose copy to the host started at
the dispatch. The device computes N+1 while the host scans N. The next
`step()` consumes the speculation if its batch is the same requests,
each advanced by N's tokens; otherwise the speculation is rolled back
(its ids are overshoot, dropped like fused steps past a stop).

Mixed steps (config.mixed_steps, on by default as in the JAX engine):
while prefill work and running decodes coexist, the scheduler emits one
`mixed` batch, and `_run_mixed` dispatches its largest-T group of pieces
and the decode batch (one step, K=1) as one step function, the prefill
half first, through the same forward paths as the pure steps; so decode
rows emit a token every step while a prompt burst drains. Mixed steps
count as decode steps for the overlapped loop: a speculation that matches
the decode rows is consumed as the decode half, and the pieces dispatch
beside it as a prefill step.

K-step decode windows (config.decode_kstep, off by default as in the JAX
engine): a decode dispatch runs K iterations in one step function, key
kind "decode_kstep", whose stop ids and budgets are judged on the device
(`_decode_body`): a row that emits a stop id or its last allowed token
freezes for the rest of the window, writing no KV and advancing no
position, draw or output count, so streams equal one step a dispatch.
The host reads the ids [K, B] and each row's emitted count once a
window, and raises if its own finish scan accepts another count. The
pages the window needs are reserved before it is dispatched
(`_pick_kstep`). A batch with a logprob row, or a stop set over
STOP_SLOTS, takes the fused-steps path; under overlap the next window
chains on speculation; beside prefill work the window is the decode leg
of a split mixed step.

Prompt-lookup speculation (config.spec_ngram, off by default as in the
JAX engine): a greedy decode batch proposes S drafts a row, the S tokens
that followed the last earlier occurrence of its trailing n-gram
(`_propose_drafts`), and runs [last token, drafts] through the model in
one dispatch, key kind "spec_verify": a chunk of S + 1 tokens with
history, through paged_prefill_attention, whose K/V land token by token
(the window starts mid-page), with the argmax at every position
(`_verify_body`). The host accepts each row's longest matching prefix of
drafts and the model's token at the first mismatch (`_run_decode_spec`).
A batch with a row that samples or reports or shapes its logits, a
lookup that keeps missing (the cooldown), or a row near its context or a
pool that cannot cover the window runs the plain decode dispatch. The
overlapped loop, mixed steps and K-step windows are off under it, as in
the JAX engine.

Draft-model speculation (config.spec_draft_model, off by default as in
the JAX engine): a second, small model of the target's vocabulary keeps
a KV pool of its own, addressed by the same page ids (the allocator's
accounting covers it), which every prefill piece brings up to the
piece's end (`_spec_draft_cover`, key kind "spec_draft_prefill"). A
decode dispatch, key kind "spec_fused", runs in one step function
(`_spec_fused_body`): the draft's catch-up over the tokens accepted since
its last dispatch, S greedy proposals, the target's verify over [last
token, proposals], and the acceptance scan, exact for greedy rows and
rejection sampling for sampled ones (sampling.spec_accept_step), with
penalties and logit_bias threaded through each position. The host reads
the ids, the drafts and each row's accepted count once a dispatch
(`_spec_postprocess`). Under overlap the next dispatch chains off the
pending one's device outputs (`_maybe_chain_spec`); beside prefill work
it is the decode leg of a split mixed step; K-step windows are off.

Prefix caching (config.enable_prefix_caching, on by default as in the
JAX engine): the scheduler admits a prompt onto the longest cached chain
of its full pages, so its first piece is a chunk with history that starts
at the first uncached page and runs through paged_prefill_attention. The
engine registers each page once every token of it has its KV (after a
prefill piece, before its first token is accepted; after a decode
dispatch's tokens are accepted), emitting a `stored` KV event to
`on_kv_event`. Every write lands at or past num_computed_tokens, so a
registered page is never written again while it is cached.

The sampling surface (as in the JAX engine): a step key's `lp` field
(the largest top-N a row asks for, -1 when none asks), `pen` (the
power-of-two bucket of the longest generated history when a row carries
a frequency, presence or repetition penalty, else 0) and `bias` (a row
has logit_bias or min_tokens) select a body that, in every dispatch kind,
penalizes, then biases, then samples, and reports each sampled token's
logprob and top-N under the raw logits (`_pick`, `_logprobs`). The
outputs ride back with the ids (`Readback`); tokens dropped past a stop
drop their entries too.

Shapes follow the JAX engine's buckets (prefill T: powers of two from 32
up to the chunk; B: powers of two for prefill, `decode_buckets` for
decode), so both engines see the same padded batches.
"""

from __future__ import annotations

import functools
import logging
import time
import zlib
from collections import deque
from dataclasses import asdict, dataclass
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.page_table import KvEvent, PageAllocator
from dynamo_tpu_torch.engine.request import (
    FinishReason,
    Request,
    RequestState,
    SamplingParams,
    StepOutput,
)
from dynamo_tpu_torch.engine.sampling import (
    BIAS_SLOTS,
    DEFAULT_K_CAP,
    STOP_SLOTS,
    accept_uniforms,
    apply_logit_bias,
    apply_penalties,
    build_output_counts,
    count_tokens,
    gumbel_noise,
    sample,
    sample_greedy,
    spec_accept_step,
    stop_mask,
    token_logprobs,
)
from dynamo_tpu_torch.engine.scheduler import ScheduledBatch, Scheduler
from dynamo_tpu_torch.engine.step_graph import Readback, StepGraph
from dynamo_tpu_torch.models.registry import get_model
from dynamo_tpu_torch.ops import paged_attention
from dynamo_tpu_torch.platform import resolve_device

logger = logging.getLogger(__name__)

#: seconds of verify steps behind metrics.spec_accept_rate
_SPEC_WINDOW_S = 60.0
#: the step kinds of a decode dispatch (one step, fused steps, a K-step
#: window with on-device stop masks)
DECODE_KINDS = ("decode", "decode_multi", "decode_kstep")
#: the step kinds whose body runs paged decode attention: decode
#: dispatches, mixed steps, whose decode half is a K=1 decode step, and
#: the draft-model dispatch, whose proposals are T=1 draft steps
PAGED_DECODE_KINDS = (*DECODE_KINDS, "mixed", "spec_fused")
#: the step kinds a decode dispatch replays (metrics.decode_replays): the
#: decode kinds, the prompt-lookup verify and the draft-model dispatch
DECODE_DISPATCH_KINDS = (*DECODE_KINDS, "spec_verify", "spec_fused")
#: the step kinds a prefill piece replays (metrics.prefill_replays): the
#: target's chunk steps and the draft pool's
PREFILL_KINDS = ("prefill", "prefill_nosample", "spec_draft_prefill")
_DECODE_FIELDS = ("kind", "bucket", "steps", "greedy", "lp", "pen", "bias")
#: the fields of each kind of step key, in order (TorchEngine._get_step_fn)
KEY_FIELDS = {
    "decode": _DECODE_FIELDS,
    "decode_multi": _DECODE_FIELDS,
    "decode_kstep": _DECODE_FIELDS,
    "prefill": ("kind", "bucket", "t", "greedy", "first_chunk", "lp", "pen", "bias"),
    "prefill_nosample": ("kind", "bucket", "t", "first_chunk"),
    "mixed": ("kind", "bucket", "t", "pieces", "greedy", "first_chunk", "psamp",
              "lp", "pen", "bias"),
    "spec_verify": ("kind", "bucket", "t"),
    "spec_fused": ("kind", "bucket", "t", "greedy", "pen", "bias"),
    "spec_draft_prefill": ("kind", "bucket", "t", "first_chunk"),
}


def key_field(key: tuple, name: str, default=None):
    """The field `name` of a step key (KEY_FIELDS), or `default` where the
    key's kind has no such field."""
    names = KEY_FIELDS[key[0]]
    return key[names.index(name)] if name in names else default


def key_has_surface(key: tuple) -> bool:
    """Whether a step key's body reports logprobs, applies penalties or
    applies logit-bias slots."""
    return (key_field(key, "lp", -1) >= 0 or key_field(key, "pen", 0) > 0
            or bool(key_field(key, "bias", False)))


@dataclass
class EngineMetrics:
    requests_received: int = 0
    generated_tokens: int = 0
    prefill_tokens: int = 0
    steps: int = 0
    prefill_dispatches: int = 0
    decode_dispatches: int = 0
    #: fused decode steps of the dispatches whose ids were accepted (a
    #: dispatch runs 1..decode_steps of them, a verify one forward;
    #: rolled-back ones not counted)
    decode_steps_run: int = 0
    #: steps that carried both prefill pieces and the decode batch
    #: (config.mixed_steps; counted before the step runs), and their wall
    #: time. A mixed step is one dispatch of a "mixed" step function,
    #: unless a matching speculation is its decode half: then its pieces
    #: dispatch beside it, counted in prefill_dispatches too
    mixed_dispatches: int = 0
    time_prefill_ms: float = 0.0
    time_decode_ms: float = 0.0
    time_mixed_ms: float = 0.0
    #: time spent waiting for decode ids to reach the host (includes the
    #: device time of the steps not yet finished when the wait starts)
    time_decode_sync_ms: float = 0.0
    #: device bytes the KV pool occupies (quantized pages and their scale
    #: planes) and what the same pool costs in the model dtype: their
    #: ratio is the cache capacity kv_quantize buys
    kv_pool_bytes: int = 0
    kv_pool_bytes_dense_equiv: int = 0
    #: step graphs captured (one per step key, at its first dispatch; the
    #: JAX engine's compiles) and the wall ms of their warm-ups and captures
    compiles: int = 0
    compile_ms: float = 0.0
    #: replays of the captured decode, prefill and mixed graphs
    #: (StepGraph.replays summed over the keys of each kind)
    decode_replays: int = 0
    prefill_replays: int = 0
    mixed_replays: int = 0
    #: overlapped decode: speculated next-step dispatches issued, consumed
    #: as the real step, and rolled back (the batch changed under them)
    overlap_dispatches: int = 0
    overlap_hits: int = 0
    overlap_rollbacks: int = 0
    #: K-step decode windows (config.decode_kstep), as the JAX engine
    #: counts them: windows dispatched (chained speculations included),
    #: the decode iterations they ran, the last window's K, and decode
    #: dispatches where a K > 1 window fell back to the fused-steps path
    #: (a row asks for logprobs or has more than STOP_SLOTS stop ids)
    kstep_windows: int = 0
    kstep_steps: int = 0
    kstep_window_size: int = 0
    kstep_fallbacks: int = 0
    #: wall ms of the windows dispatched outside a speculation: their host
    #: arrays, dispatch, the wait for their ids and the host's scan
    time_kstep_ms: float = 0.0
    #: speculation (config.spec_ngram or spec_draft_model), as the JAX
    #: engine counts it: drafts proposed and accepted over the verify
    #: dispatches, and decode dispatches that did not speculate because a
    #: row was ineligible or the acceptance cooldown ran
    spec_drafted: int = 0
    spec_accepted: int = 0
    spec_skipped_ineligible: int = 0
    spec_skipped_cooldown: int = 0
    #: accepted / drafted over the verify steps of the last 60 s, and the
    #: drafts in that window (its weight; 0 with speculation idle)
    spec_accept_rate: float = 0.0
    spec_window_drafted: int = 0
    #: host ms of the verify dispatches' own work: the n-gram index and
    #: drafts (prompt lookup), the input arrays, and the accept scan after
    #: the ids arrive (on the critical path but for a chained dispatch's
    #: arrays)
    time_spec_host_ms: float = 0.0
    #: prompt tokens the prefix cache served over those it was asked for
    #: (PrefixCacheStats.hit_rate), refreshed every step
    prefix_hit_rate: float = 0.0

    def to_dict(self) -> dict:
        return asdict(self)


@dataclass
class _InflightDecode:
    """One speculated decode dispatch whose ids are on their way to the
    host (JaxEngine's _InflightDecode). It becomes the real step iff the
    next scheduled batch is the same requests in the same rows, each
    advanced by exactly the pending step's tokens."""

    reqs: tuple
    b_bucket: int
    k_steps: int
    greedy: bool
    ids: Readback
    #: per-request state the batch must show when this step is consumed
    expected_num_tokens: tuple
    expected_out_len: tuple
    #: a K-step window (its Readback carries the rows' emitted counts); a
    #: speculation chained off it stays a window
    kstep: bool = False


@dataclass
class _InflightSpec:
    """One draft-model dispatch chained off the pending one's device
    outputs (JaxEngine's _InflightSpec): its catch-up window is the
    pending dispatch's accepted tokens, out_ids cut at n_acc, read on the
    device. It becomes the real step iff the host's accept scan of the
    pending dispatch agreed with n_acc on every row with no finish (the
    device sees neither stops nor budgets), which fills the expected
    state, and the next decode batch is the same requests so advanced."""

    reqs: tuple
    b_bucket: int
    #: out_ids [B, S + 1], draft_ids [B, S] and n_acc [B], on their way
    #: to the host since the dispatch
    ids: Readback
    greedy: bool
    bias: bool
    #: filled once the pending dispatch's accept scan agreed; None: never
    #: consumed
    expected_num_tokens: Optional[tuple] = None
    expected_out_len: Optional[tuple] = None


class TorchEngine:
    def __init__(self, config: EngineConfig, params: Optional[dict] = None,
                 device=None, *, checkpoint_path: Optional[str] = None,
                 cuda_graphs: bool = True,
                 on_kv_event: Optional[Callable[[KvEvent], None]] = None,
                 draft_params: Optional[dict] = None):
        """With no `params` the weights load from `checkpoint_path`, else
        from the model name's own checkpoint (an HF directory or a .gguf
        file), else they are random from seed 0; `quantize="int8"` then
        quantizes them, as the JAX engine does. `cuda_graphs=False` runs
        every dispatch eagerly on the card, as the JAX engine runs under
        jax.disable_jit(); on the CPU dispatches are always eager.
        `on_kv_event` receives the prefix cache's `stored` and `removed`
        events, in order, on the engine's thread. `draft_params` are the
        speculation draft's weights (config.spec_draft_model; default:
        _init_draft_model's choice)."""
        self.config = config
        self.device = resolve_device(device)
        self._graphs = cuda_graphs and self.device.type == "cuda"
        #: step key -> its step function (a StepGraph on the card)
        self._step_fns: dict[tuple, object] = {}
        #: the capture stream and the graphs' shared memory pool (_graph_setup)
        self._graph_stream = self._graph_pool = None
        #: (device, counters, partials) of the decode graphs' workspace
        self._workspace_size: tuple = ()
        #: the one speculated decode dispatch in flight, or None
        self._inflight: Optional[_InflightDecode] = None
        #: step-function calls so far: prefill groups, decode dispatches and
        #: speculated ones (with graphs, each is one replay)
        self.dispatches = 0
        self.adapter = get_model(config.model, dtype=config.dtype)
        self.allocator = PageAllocator(config.num_pages, config.page_size, on_event=on_kv_event)
        self.scheduler = Scheduler(config, self.allocator)
        self.metrics = EngineMetrics()
        # prompt-lookup speculation owns the decode batch and needs each
        # step's tokens on the host for its drafts: the overlapped loop,
        # mixed steps and K-step windows are off under it; the draft-model
        # mode keeps the first two and turns windows off (the JAX engine's
        # policy: both modes already batch steps per dispatch)
        spec = config.spec_ngram > 0
        self._spec_draft = config.spec_draft_model is not None
        self._overlap_enabled = config.overlap_decode and not spec
        self.scheduler.mixed_enabled = config.mixed_steps and not spec
        self._kstep_enabled = config.decode_kstep > 1 and not spec and not self._spec_draft
        #: the draft-model dispatch chained in flight, or None
        self._inflight_spec: Optional[_InflightSpec] = None
        if config.decode_kstep > 1 and not self._kstep_enabled:
            logger.info("decode_kstep=%d auto-disabled: speculative decoding already batches "
                        "steps per dispatch", config.decode_kstep)
        #: decode dispatches left before prompt lookup is tried again
        self._spec_cooldown = 0
        #: (time, drafted, accepted) of the verify steps in the last
        #: _SPEC_WINDOW_S seconds, and their sums
        self._spec_window: deque = deque()
        self._spec_win_drafted = self._spec_win_accepted = 0
        # the reference's order: random params straight in the int8 layout,
        # or given params quantized (already-int8 params raise)
        pre_quantized = False
        checkpoint_path = checkpoint_path or self.adapter.default_checkpoint
        if params is None and checkpoint_path is not None:
            logger.info("loading %s from %s", config.model, checkpoint_path)
            params = self.adapter.load_params(checkpoint_path, self.device)
        elif params is None:
            gen = torch.Generator(device=self.device).manual_seed(0)
            if config.quantize == "int8":
                logger.info("initializing random int8 params for %s", config.model)
                params = self.adapter.init_params_quantized(gen)
                pre_quantized = True
            else:
                logger.info("initializing random params for %s", config.model)
                params = self.adapter.init_params(gen)
        if config.quantize and not pre_quantized:
            params = self.adapter.quantize_params(params)
        self.params = params
        self.kv = self.adapter.init_kv(
            config.num_pages, config.page_size, self.device, kv_quantize=config.kv_quantize
        )
        pool = [x for x in self.kv if x is not None]
        self.metrics.kv_pool_bytes = sum(x.numel() * x.element_size() for x in pool)
        self.metrics.kv_pool_bytes_dense_equiv = (
            (self.kv.k.numel() + self.kv.v.numel()) * self.adapter.config.dtype.itemsize
        )
        self.draft_adapter = self.draft_params = self.draft_kv = None
        if self._spec_draft:
            self._init_draft_model(draft_params)
        elif draft_params is not None:
            raise ValueError("draft_params given without config.spec_draft_model")

    # -- public API --------------------------------------------------------

    def add_request(self, request_id: str, prompt_tokens: Sequence[int],
                    sampling: Optional[SamplingParams] = None) -> Request:
        # refused here, to this caller: inside step() the error would fail
        # every request in flight
        self._validate_bias(sampling)
        req = Request(request_id, list(prompt_tokens), sampling or SamplingParams())
        self.scheduler.add_request(req)
        self.metrics.requests_received += 1
        return req

    def abort_request(self, request_id: str) -> bool:
        return self.scheduler.abort_request(request_id) is not None

    @property
    def has_work(self) -> bool:
        return self.scheduler.has_work

    @property
    def step_keys(self) -> list[tuple]:
        """The step keys dispatched so far, prefill and decode (_get_step_fn)."""
        return list(self._step_fns)

    def step(self) -> list[StepOutput]:
        batch = self.scheduler.schedule()
        outputs = self._drain_doomed()
        if batch is None or batch.kind not in ("decode", "mixed"):
            # a speculated decode step can only be the next decode step or
            # the decode half of a mixed step
            why = "no batch" if batch is None else "prefill scheduled"
            self._discard_inflight(why)
            self._discard_inflight_spec(why)
        if batch is not None:
            t0 = time.perf_counter()
            if batch.kind == "prefill":
                self.metrics.prefill_dispatches += 1
                outputs += self._run_prefill(batch)
                self.metrics.time_prefill_ms += (time.perf_counter() - t0) * 1e3
            elif batch.kind == "mixed":
                self.metrics.mixed_dispatches += 1
                outputs += self._run_mixed(batch)
                self.metrics.time_mixed_ms += (time.perf_counter() - t0) * 1e3
            else:
                self.metrics.decode_dispatches += 1
                outputs += self._run_decode(batch)
                self.metrics.time_decode_ms += (time.perf_counter() - t0) * 1e3
            self.metrics.steps += 1
        if not self.scheduler.has_work:
            # the wave ended on a stop the speculation could not foresee
            self._discard_inflight("idle")
            self._discard_inflight_spec("idle")
        # counted where the graphs replay, so a dispatch that did not replay shows
        graphs = [(k[0], g.replays) for k, g in self._step_fns.items() if isinstance(g, StepGraph)]
        self.metrics.decode_replays = sum(n for kind, n in graphs if kind in DECODE_DISPATCH_KINDS)
        self.metrics.mixed_replays = sum(n for kind, n in graphs if kind == "mixed")
        self.metrics.prefill_replays = sum(n for kind, n in graphs if kind in PREFILL_KINDS)
        self.metrics.prefix_hit_rate = self.allocator.stats.hit_rate
        if self.config.spec_ngram > 0 or self._spec_draft:
            self._refresh_spec_window()
        return outputs

    def run_to_completion(self) -> dict[str, list[int]]:
        """Drain all queued work; returns request_id -> generated tokens."""
        done: dict[str, list[int]] = {}
        while self.has_work:
            for out in self.step():
                done.setdefault(out.request_id, []).extend(out.new_token_ids)
        return done

    def drain_overlap(self) -> None:
        """Discard any speculated decode dispatch in flight (the engine
        thread calls it when idle)."""
        self._discard_inflight("drained")
        self._discard_inflight_spec("drained")

    def _drain_doomed(self) -> list[StepOutput]:
        """Finish requests the scheduler proved can never progress."""
        outputs = []
        for req, why, reason in self.scheduler.doomed:
            logger.error("request %s cannot progress: %s", req.request_id, why)
            req.state = RequestState.FINISHED
            req.finish_reason = reason
            outputs.append(StepOutput(req.request_id, (), finish_reason=reason))
        self.scheduler.doomed.clear()
        return outputs

    # -- host arrays -------------------------------------------------------

    def _bucket_t(self, n: int) -> int:
        cap = max(self.config.prefill_chunk, 32)
        if n > cap:
            raise ValueError(f"prefill piece of {n} tokens exceeds the T-bucket cap {cap}")
        t = 32
        while t < n:
            t *= 2
        return min(t, cap)

    @staticmethod
    def _bucket_b(n: int) -> int:
        b = 1
        while b < n:
            b *= 2
        return b

    def _request_seed(self, req: Request) -> int:
        if req.sampling.seed is not None:
            return req.sampling.seed & 0xFFFFFFFF
        return zlib.crc32(req.request_id.encode(), self.config.seed & 0xFFFFFFFF)

    def _sampling_arrays(self, reqs: list[Request], pad_to: int, steps: int, ahead: int = 0
                         ) -> Optional[dict[str, np.ndarray]]:
        """The sampler's rows for this dispatch (_sampler_rows), or None
        when every request is greedy (the argmax-only variant)."""
        if all(r.sampling.temperature <= 0.0 for r in reqs):
            return None
        return self._sampler_rows(reqs, pad_to, steps, ahead)

    def _sampler_rows(self, reqs: list[Request], pad_to: int, steps: int, ahead: int = 0
                      ) -> dict[str, np.ndarray]:
        """The sampler's rows, padded to pad_to: temps (0 for a greedy
        row, which takes the argmax), top_ps, top_ks and every fused
        step's noise [steps, pad_to, DEFAULT_K_CAP]. `ahead` advances each
        draw counter past the tokens of a dispatch not yet read (a
        speculated one's predecessor)."""
        temps = np.zeros(pad_to, np.float32)
        top_ps = np.ones(pad_to, np.float32)
        top_ks = np.zeros(pad_to, np.int64)
        for i, r in enumerate(reqs):
            temps[i] = r.sampling.temperature
            top_ps[i] = r.sampling.top_p
            top_ks[i] = r.sampling.top_k
        # num_emitted keeps the draw counter monotonic across preemption
        noise = np.zeros((steps, pad_to, DEFAULT_K_CAP), np.float32)
        noise[:, : len(reqs)] = gumbel_noise(
            [self._request_seed(r) for r in reqs],
            [r.num_emitted + len(r.output_tokens) + ahead for r in reqs],
            DEFAULT_K_CAP, steps,
        ).numpy()
        return {"temps": temps, "top_ps": top_ps, "top_ks": top_ks, "noise": noise}

    @staticmethod
    def _sample(logits: torch.Tensor, samp: Optional[dict], step: int) -> torch.Tensor:
        """ids [B] for logits [B, V]: the argmax without sampler rows, else
        a draw with step `step`'s noise (device tensors of _sampling_arrays)."""
        if samp is None:
            return sample_greedy(logits)
        return sample(logits, samp["temps"], samp["top_ps"], samp["top_ks"], samp["noise"][step])

    # -- the sampling surface (JaxEngine._batch_logprobs .. _bias_arrays) ----

    @staticmethod
    def _batch_logprobs(reqs: list[Request]) -> int:
        """The key's `lp`: -1 when no request wants logprobs, else the
        largest top-N asked for (the body takes one top-k, each request
        keeps its own N of it), snapped to OpenAI's 0..20."""
        return max([-1] + [min(r.sampling.logprobs, 20) for r in reqs])

    @staticmethod
    def _penalty_history(req: Request) -> list[int]:
        """Every token the request has generated, the history its penalties
        run over; a preemption folds generated tokens into the prompt, and
        num_emitted counts them, so they stay part of it."""
        if req.num_emitted:
            return req.prompt_tokens[-req.num_emitted:] + req.output_tokens
        return req.output_tokens

    def _batch_penalty_bucket(self, reqs: list[Request]) -> int:
        """The key's `pen`: 0 when no request carries a frequency, presence
        or repetition penalty, else the power-of-two bucket O of the
        longest generated history (the family grows log2(max_tokens) deep)."""
        if not any(r.sampling.frequency_penalty or r.sampling.presence_penalty
                   or r.sampling.repetition_penalty != 1.0 for r in reqs):
            return 0
        longest = max(len(self._penalty_history(r)) for r in reqs)
        o = 1
        while o < longest:
            o *= 2
        return o

    def _penalty_arrays(self, reqs: list[Request], pad_to: int, o_bucket: int
                        ) -> dict[str, np.ndarray]:
        """The penalties [pad_to] (padding rows: 0, 0 and a repetition
        penalty of 1) and each row's last o_bucket generated tokens
        [pad_to, O] with their valid mask."""
        freq = np.zeros(pad_to, np.float32)
        pres = np.zeros(pad_to, np.float32)
        rep = np.ones(pad_to, np.float32)
        out_tokens = np.zeros((pad_to, o_bucket), np.int64)
        out_valid = np.zeros((pad_to, o_bucket), bool)
        for i, r in enumerate(reqs):
            freq[i] = r.sampling.frequency_penalty
            pres[i] = r.sampling.presence_penalty
            rep[i] = r.sampling.repetition_penalty or 1.0
            hist = self._penalty_history(r)
            n = min(len(hist), o_bucket)
            if n:
                out_tokens[i, :n] = hist[-n:]
                out_valid[i, :n] = True
        return {"freq": freq, "pres": pres, "rep": rep, "out_tokens": out_tokens,
                "out_valid": out_valid}

    def _bans(self, s: SamplingParams) -> list[int]:
        """The ids min_tokens bans: the stop ids and, unless eos is
        ignored, the eos ids."""
        ban = set(s.stop_token_ids)
        if not s.ignore_eos:
            ban |= set(self.config.eos_token_ids)
        return sorted(ban)

    def _validate_bias(self, sampling: Optional[SamplingParams]) -> None:
        """Refuse a logit_bias over the slots or outside the vocabulary."""
        if sampling is None or not (sampling.logit_bias or sampling.min_tokens):
            return
        need = len(sampling.logit_bias)
        if sampling.min_tokens > 0:
            need += len(self._bans(sampling))
        if need > BIAS_SLOTS:
            raise ValueError(f"logit_bias entries + min_tokens eos/stop bans need {need} "
                             f"slots; at most {BIAS_SLOTS} supported")
        v = self.adapter.vocab_size
        for tid, _ in sampling.logit_bias:
            if not 0 <= tid < v:
                raise ValueError(f"logit_bias token id {tid} outside vocab [0,{v})")

    @staticmethod
    def _batch_bias(reqs: list[Request]) -> bool:
        """The key's `bias`: a request has logit_bias or min_tokens."""
        return any(r.sampling.logit_bias or r.sampling.min_tokens for r in reqs)

    def _bias_row(self, req: Request) -> tuple:
        """The request's slots (ids, values, gated, min_tokens): its
        logit_bias entries, repeats of an id merged into one slot, then a
        gated -1e30 ban on each id min_tokens bans."""
        ids = np.zeros(BIAS_SLOTS, np.int64)
        vals = np.zeros(BIAS_SLOTS, np.float32)
        gated = np.zeros(BIAS_SLOTS, bool)
        s = req.sampling
        merged: dict[int, float] = {}
        for tid, bv in s.logit_bias:
            merged[tid] = merged.get(tid, 0.0) + bv
        entries = [(tid, bv, False) for tid, bv in merged.items()]
        if s.min_tokens > 0:
            entries += [(tid, -1e30, True) for tid in self._bans(s)]
        for slot, (tid, bv, g) in enumerate(entries[:BIAS_SLOTS]):  # bounded at admission
            ids[slot], vals[slot], gated[slot] = tid, bv, g
        return ids, vals, gated, s.min_tokens

    def _bias_arrays(self, reqs: list[Request], pad_to: int, ahead: int = 0
                     ) -> dict[str, np.ndarray]:
        """The bias slots [pad_to, BIAS_SLOTS], min_tokens [pad_to] and each
        row's output count [pad_to], which the min_tokens gate reads. The
        all-greedy body has no draw counters, so the count rides here:
        `ahead` advances it past the tokens of a dispatch not yet read (a
        speculation's predecessor), and a fused step adds its index."""
        ids = np.zeros((pad_to, BIAS_SLOTS), np.int64)
        vals = np.zeros((pad_to, BIAS_SLOTS), np.float32)
        gated = np.zeros((pad_to, BIAS_SLOTS), bool)
        mins = np.zeros(pad_to, np.int64)
        count = np.zeros(pad_to, np.int64)
        for i, r in enumerate(reqs):
            ids[i], vals[i], gated[i], mins[i] = self._bias_row(r)
            count[i] = r.num_emitted + len(r.output_tokens) + ahead
        return {"bias_ids": ids, "bias_vals": vals, "bias_gated": gated, "min_toks": mins,
                "bias_count": count}

    def _surface_arrays(self, reqs: list[Request], pad_to: int, pen: int, bias: bool,
                        ahead: int = 0) -> dict[str, np.ndarray]:
        """The penalty arrays (pen > 0) and the bias arrays (bias) of a
        dispatch's rows, padded to pad_to."""
        arrays = self._penalty_arrays(reqs, pad_to, pen) if pen else {}
        if bias:
            arrays.update(self._bias_arrays(reqs, pad_to, ahead))
        return arrays

    def _pick(self, logits: torch.Tensor, bufs: dict[str, torch.Tensor], step: int,
              counts: Optional[torch.Tensor]) -> torch.Tensor:
        """The reference's pick: ids [B] from logits [B, V] penalized (with
        counts [B, V]), then biased (with `bias_ids` among the inputs; the
        min_tokens gate reads the row's output count at fused step
        `step`), then sampled."""
        if counts is not None:
            logits = apply_penalties(logits, counts, bufs["freq"], bufs["pres"], bufs["rep"])
        if "bias_ids" in bufs:
            logits = apply_logit_bias(logits, bufs["bias_ids"], bufs["bias_vals"],
                                      bufs["bias_gated"], bufs["bias_count"] + step,
                                      bufs["min_toks"])
        return self._sample(logits, bufs if "temps" in bufs else None, step)

    def _counts(self, bufs: dict[str, torch.Tensor]) -> Optional[torch.Tensor]:
        """The output-count table [B, V] of a body with penalty inputs."""
        if "out_tokens" not in bufs:
            return None
        return build_output_counts(bufs["out_tokens"], bufs["out_valid"],
                                   self.adapter.vocab_size)

    @staticmethod
    def _outputs(ids: list[torch.Tensor], lps: list[tuple]):
        """A body's outputs over its steps: the ids [steps, B] alone, or
        with logprobs (chosen [steps, B], top ids and top logprobs [steps,
        B, N]) as one tuple."""
        if not lps:
            return torch.stack(ids)
        return (torch.stack(ids), *(torch.stack(x) for x in zip(*lps)))

    @staticmethod
    def _row_logprobs(req: Request, lp: Optional[tuple], col: int, n: int
                      ) -> tuple[Optional[tuple], Optional[tuple]]:
        """(logprobs, top_logprobs) of the first n steps of column `col` of
        a dispatch's logprob arrays [steps, rows(, N)], or (None, None)
        when the request asked for none (or the dispatch computed none)."""
        nk = req.sampling.logprobs
        if lp is None or nk < 0:
            return None, None
        chosen, top_ids, top_lps = lp
        lps = tuple(chosen[:n, col].tolist())
        if nk == 0:
            return lps, None
        ids, vals = (a[:n, col, :nk].tolist() for a in (top_ids, top_lps))
        return lps, tuple(tuple(zip(i, v)) for i, v in zip(ids, vals))

    # -- prefill -----------------------------------------------------------

    def _run_prefill(self, batch: ScheduledBatch) -> list[StepOutput]:
        """Pieces grouped by T bucket run as one batched [B, T] dispatch. A
        group whose pieces all start at 0 runs as first chunks; any other
        group attends over each row's history (0 for a row that starts at
        0). A group with a piece that ends its prompt samples every row at
        its last token and keeps the ids of those pieces (and their
        logprobs); a group with none runs the forward alone (no logits, no
        sampler noise). Penalties apply at a prefill sample only once a
        row has generated history (a preempted request's recompute), as in
        the JAX engine. Every group is dispatched before any ids are read.
        Under draft-model speculation the draft pool is first brought up to
        each piece's end, a prefix hit's cached tokens included (the cached
        pages hold the target's KV only)."""
        if self._spec_draft:
            self._spec_draft_cover([(p.request, p.start + p.length) for p in batch.prefill])
        dispatched = []
        for t_bucket, pieces in sorted(self._group_pieces(batch.prefill).items()):
            b_bucket = self._bucket_b(len(pieces))
            arrays = self._prefill_arrays(pieces, b_bucket, t_bucket)
            last = arrays.pop("last")
            first_chunk = all(p.start == 0 for p in pieces)
            if any(self._completes(p) for p in pieces):
                reqs = [p.request for p in pieces]
                samp = self._sampling_arrays(reqs, b_bucket, 1)
                lp, bias = self._batch_logprobs(reqs), self._batch_bias(reqs)
                pen = self._batch_penalty_bucket(reqs)
                if pen and not any(self._penalty_history(r) for r in reqs):
                    pen = 0
                arrays.update(last=last, **(samp or {}),
                              **self._surface_arrays(reqs, b_bucket, pen, bias))
                key = ("prefill", b_bucket, t_bucket, samp is None, first_chunk, lp, pen, bias)
            else:
                key = ("prefill_nosample", b_bucket, t_bucket, first_chunk)
            dispatched.append((pieces, self._dispatch(key, arrays)))
        outputs: list[StepOutput] = []
        for pieces, readback in dispatched:
            if readback is None:
                outputs += self._prefill_postprocess(pieces, None)
                continue
            # the logprob arrays [rows(, N)] as one step's [1, rows(, N)]
            lp = tuple(a[None] for a in readback.extras())
            outputs += self._prefill_postprocess(pieces, readback.numpy(), lp or None)
        return outputs

    def _group_pieces(self, pieces) -> dict[int, list]:
        """Pieces by T bucket, each group in the batch's order."""
        groups: dict[int, list] = {}
        for piece in pieces:
            groups.setdefault(self._bucket_t(piece.length), []).append(piece)
        return groups

    @staticmethod
    def _completes(piece) -> bool:
        """Whether the piece ends its prompt (its last token is sampled)."""
        return piece.start + piece.length >= len(piece.request.prompt_tokens)

    def _prefill_arrays(self, pieces, b_bucket: int, t_bucket: int) -> dict[str, np.ndarray]:
        """Tokens, positions, valid and page tables of a [b_bucket,
        t_bucket] chunk step over the pieces, and each row's `last` token."""
        tokens = np.zeros((b_bucket, t_bucket), np.int64)
        positions = np.zeros((b_bucket, t_bucket), np.int32)
        valid = np.zeros((b_bucket, t_bucket), bool)
        pt = np.zeros((b_bucket, self.config.max_pages_per_seq), np.int32)
        last = np.zeros(b_bucket, np.int64)
        for i, piece in enumerate(pieces):
            req = piece.request
            tokens[i, : piece.length] = req.all_tokens[piece.start : piece.start + piece.length]
            positions[i] = np.arange(t_bucket, dtype=np.int32) + piece.start
            valid[i, : piece.length] = True
            pt[i, : len(req.pages)] = req.pages
            last[i] = piece.length - 1
        return {"tokens": tokens, "positions": positions, "valid": valid, "page_tables": pt,
                "last": last}

    def _prefill_postprocess(self, pieces, ids: Optional[np.ndarray],
                             lp: Optional[tuple] = None) -> list[StepOutput]:
        """Advance each piece's request past its tokens and register its
        full pages; a piece that ends its prompt joins decode with its
        row's id (ids [rows], the pieces' rows in order) and logprobs (lp:
        chosen [1, rows], top ids and logprobs [1, rows, N], or None)."""
        outputs: list[StepOutput] = []
        for i, piece in enumerate(pieces):
            req = piece.request
            req.num_computed_tokens += piece.length
            self.metrics.prefill_tokens += piece.length
            self._register_pages(req)
            if self._completes(piece):
                tok = int(ids[i])
                req.state = RequestState.DECODE
                lps, tops = self._row_logprobs(req, lp, i, 1)
                outputs.extend(self._accept_tokens(
                    req, [tok], self._finish_reason_for(req, tok, 1), first=True, lps=lps,
                    tops=tops))
        return outputs

    def _prefill_body(self, first_chunk: bool, sampled: bool, lp: int,
                      bufs: dict[str, torch.Tensor]):
        """One prefill chunk step over device inputs (the keys of
        _run_prefill's arrays); returns the ids [B] drawn at each row's
        `last` token (with lp >= 0, and their logprobs: chosen [B], top ids
        and logprobs [B, max(lp, 1)]), or None for a step that samples
        nothing."""
        hidden, self.kv = self.adapter.forward_hidden(
            self.params, bufs["tokens"], bufs["positions"], bufs["valid"], self.kv,
            bufs["page_tables"], first_chunk=first_chunk,
        )
        if not sampled:
            return None
        rows = torch.arange(hidden.shape[0], device=hidden.device)
        logits = self.adapter.compute_logits(self.params, hidden[rows, bufs["last"]])
        ids = self._pick(logits, bufs, 0, self._counts(bufs))
        if lp < 0:
            return ids
        return (ids, *token_logprobs(logits, ids, lp))

    # -- decode ------------------------------------------------------------

    @staticmethod
    def _pow2_floor(k: int) -> int:
        p = 1
        while p * 2 <= k:
            p *= 2
        return p

    def _pick_decode_steps(self, reqs: list[Request]) -> int:
        """Fused steps for this dispatch: capped by config and by context
        room, covering the longest remaining completion rounded up to a
        power of two; 1 when admission is pending or the pool cannot
        pre-grow every page table K tokens ahead."""
        k = self.config.decode_steps
        if k <= 1:
            return 1
        if self.scheduler.num_waiting() > 0 and self.scheduler.can_admit_head():
            return 1
        k = self._covering_steps(reqs, k)
        if k <= 1:
            return 1
        if not self._grow_pages_for(reqs, k - 1):
            return 1  # the single-step path handles pressure via preemption
        return k

    def _covering_steps(self, reqs: list[Request], k: int) -> int:
        """k capped by each row's context room and by the longest remaining
        completion rounded up to a power of two, snapped down to a power of
        two (the key family stays log-sized; rows that finish early drop
        their overshoot, or freeze in a window)."""
        for req in reqs:
            k = min(k, self.config.max_context - req.num_tokens + 1)
        rem_max = max(
            r.sampling.max_tokens - len(r.output_tokens) - r.num_emitted for r in reqs
        )
        p = 1
        while p < max(1, rem_max):
            p *= 2
        return self._pow2_floor(min(k, p))

    def _grow_pages_for(self, reqs: list[Request], ahead: int) -> bool:
        """Grow every page table to cover num_tokens + ahead, or nothing."""
        ps = self.config.page_size
        extra = [max(0, -(-(r.num_tokens + ahead) // ps) - len(r.pages)) for r in reqs]
        if sum(extra) > self.allocator.num_free:
            return False
        for req, n in zip(reqs, extra):
            if n:
                req.pages.extend(self.allocator.allocate(n))
        return True

    # -- K-step decode windows (config.decode_kstep; JaxEngine:
    # _kstep_stop_ids .. _kstep_arrays) ------------------------------------

    def _kstep_stop_ids(self, req: Request) -> Optional[tuple[int, ...]]:
        """The request's stop ids on the device (the eos ids, then its stop
        ids; none for an ignore_eos request, as _finish_reason_for ignores
        both sets for it), or None when they overflow STOP_SLOTS and the
        host must judge its stops."""
        s = req.sampling
        if s.ignore_eos:
            return ()
        ids = tuple(dict.fromkeys((*self.config.eos_token_ids, *s.stop_token_ids)))
        return ids if len(ids) <= STOP_SLOTS else None

    def _kstep_candidate(self, reqs: list[Request]) -> bool:
        """Whether these rows may run as a window: windows on, no row asks
        for logprobs (the window reports none), every stop set fits
        STOP_SLOTS. A mixed step splits when it holds (_run_mixed)."""
        if not self._kstep_enabled or self._batch_logprobs(reqs) >= 0:
            return False
        return all(self._kstep_stop_ids(r) is not None for r in reqs)

    def _pick_kstep(self, reqs: list[Request]) -> int:
        """The window's K for this decode dispatch, or 1 for the
        fused-steps path: 1 while an admissible request waits; else
        decode_kstep as _covering_steps caps it, clamped to the pool's
        page runway (Scheduler.clamp_kstep_window) and halved until every
        page table grows to cover the window (the device asks the host for
        no page mid-window). An ineligible batch counts a fallback."""
        if not self._kstep_enabled:
            return 1
        if not self._kstep_candidate(reqs):
            self.metrics.kstep_fallbacks += 1
            return 1
        if self.scheduler.num_waiting() > 0 and self.scheduler.can_admit_head():
            return 1  # new arrivals do not wait K steps
        k = self._covering_steps(reqs, self.config.decode_kstep)
        if k <= 1:
            return 1
        k = self.scheduler.clamp_kstep_window(reqs, k)
        while k > 1 and not self._grow_pages_for(reqs, k - 1):
            k //= 2  # the pool is smaller than the clamp saw
        return max(1, k)

    def _kstep_arrays(self, reqs: list[Request], pad_to: int, emitted_ahead: int = 0
                      ) -> dict[str, np.ndarray]:
        """The window's finish inputs, padded to pad_to: each row's stop ids
        [pad_to, STOP_SLOTS] (-1-padded) and budget [pad_to], the tokens
        _finish_reason_for lets it emit (its max_tokens and context room),
        less `emitted_ahead`, the tokens of a pending window a chained one
        follows. Padding rows: budget 0, no stop ids (never alive)."""
        stops = np.full((pad_to, STOP_SLOTS), -1, np.int64)
        budgets = np.zeros(pad_to, np.int32)
        for i, req in enumerate(reqs):
            ids = self._kstep_stop_ids(req)  # eligible: _kstep_candidate
            stops[i, : len(ids)] = ids
            room = min(req.sampling.max_tokens - len(req.output_tokens) - req.num_emitted,
                       self.config.max_context - req.num_tokens)
            budgets[i] = max(0, room - emitted_ahead)
        return {"stops": stops, "budgets": budgets}

    def _count_window(self, k_steps: int) -> None:
        """A window dispatched, speculated or not (the JAX engine's counts)."""
        m = self.metrics
        m.kstep_windows += 1
        m.kstep_steps += k_steps
        m.kstep_window_size = k_steps

    def _decode_arrays(self, reqs: list[Request], b_bucket: int, ahead: int
                       ) -> dict[str, np.ndarray]:
        """Positions, valid and page tables of a decode dispatch that starts
        `ahead` tokens past each request's last known token."""
        positions = np.zeros((b_bucket, 1), np.int32)
        valid = np.zeros((b_bucket, 1), bool)
        pt = np.zeros((b_bucket, self.config.max_pages_per_seq), np.int32)
        for i, req in enumerate(reqs):
            positions[i, 0] = req.num_tokens - 1 + ahead
            valid[i, 0] = True
            pt[i, : len(req.pages)] = req.pages
        return {"positions": positions, "valid": valid, "page_tables": pt}

    def _run_decode(self, batch: ScheduledBatch) -> list[StepOutput]:
        """A decode batch: a draft-model dispatch or a prompt-lookup
        verify when speculation is on for it (_spec_active), else the
        plain decode dispatch, where a chained draft-model dispatch cannot
        land."""
        reqs = list(batch.decode)
        if self._spec_active(reqs):
            if self._spec_draft:
                return self._run_decode_spec_draft(reqs)
            return self._run_decode_spec(reqs)
        self._discard_inflight_spec("speculation inactive")
        return self._run_decode_plain(reqs)

    def _run_decode_plain(self, reqs: list[Request]) -> list[StepOutput]:
        inflight, self._inflight = self._inflight, None
        if inflight is not None:
            if self._inflight_matches(inflight, reqs):
                return self._consume_inflight(inflight)
            self._inflight = inflight  # handed back for the count
            self._discard_inflight("decode batch changed")
        t0 = time.perf_counter()
        b_bucket = self.config.decode_bucket_for(len(reqs))
        # a K-step window first; at 1 the fused-steps path, as without windows
        k_win = self._pick_kstep(reqs)
        k_steps = k_win if k_win > 1 else self._pick_decode_steps(reqs)
        tokens = np.zeros((b_bucket, 1), np.int64)
        for i, req in enumerate(reqs):
            tokens[i, 0] = req.all_tokens[-1]
        arrays = {"tokens": tokens, **self._decode_arrays(reqs, b_bucket, 0)}
        samp = self._sampling_arrays(reqs, b_bucket, k_steps)
        lp, pen, bias = (self._batch_logprobs(reqs), self._batch_penalty_bucket(reqs),
                         self._batch_bias(reqs))
        arrays.update(**(samp or {}), **self._surface_arrays(reqs, b_bucket, pen, bias))
        if k_win > 1:
            arrays.update(self._kstep_arrays(reqs, b_bucket))
            kind = "decode_kstep"  # lp is -1: a logprob row falls back
            self._count_window(k_steps)
        else:
            # the JAX engine's kinds: one step is "decode", fused steps "decode_multi"
            kind = DECODE_KINDS[k_steps > 1]
        ids = self._dispatch((kind, b_bucket, k_steps, samp is None, lp, pen, bias), arrays)
        # keep the device busy past this step before waiting for its ids
        self._maybe_speculate(reqs, b_bucket, k_steps, samp is None, ids, kstep=k_win > 1)
        outputs = self._decode_postprocess(reqs, k_steps, ids, kstep=k_win > 1)
        if k_win > 1:
            self.metrics.time_kstep_ms += (time.perf_counter() - t0) * 1e3
        return outputs

    def _decode_postprocess(self, reqs: list[Request], k_steps: int, ids: Readback,
                            kstep: bool = False) -> list[StepOutput]:
        """Wait for a decode dispatch's ids [K, B] (copied to the host since
        it was dispatched), then scan them for finishes, dropping tokens
        past a stop and their logprobs, and accept the rest. A K-step
        window's rows froze on the device at the same finishes: the
        tokens accepted must be the counts it emitted, or it raises."""
        t1 = time.perf_counter()
        host = ids.numpy()
        lp = ids.extras() or None
        self.metrics.time_decode_sync_ms += (time.perf_counter() - t1) * 1e3
        if kstep:
            (n_emit,), lp = lp, None
        self.metrics.decode_steps_run += k_steps
        outputs: list[StepOutput] = []
        for i, req in enumerate(reqs):
            accepted: list[int] = []
            finish: Optional[FinishReason] = None
            for kk in range(k_steps):
                tok = int(host[kk, i])
                accepted.append(tok)
                finish = self._finish_reason_for(req, tok, len(accepted))
                if finish is not None:
                    break  # overshoot past a stop is dropped
            req.num_computed_tokens += len(accepted)
            lps, tops = self._row_logprobs(req, lp, i, len(accepted))
            outputs.extend(self._accept_tokens(req, accepted, finish, lps=lps, tops=tops))
            # a request that finished here has no chain left: its last
            # pages are not registered (as in the JAX engine)
            self._register_pages(req)
        if kstep:
            accepted = sum(len(o.new_token_ids) for o in outputs)
            emitted = int(n_emit[: len(reqs)].sum())
            if accepted != emitted:
                # the same arithmetic on both sides: a fault in the window
                # body or its inputs (the JAX engine logs it and goes on)
                raise RuntimeError(f"K-step window disagreement: the device emitted "
                                   f"{emitted} tokens, the host accepted {accepted} "
                                   f"(K={k_steps}, B={len(reqs)})")
        return outputs

    def _decode_body(self, k_steps: int, lp: int, bufs: dict[str, torch.Tensor]):
        """K fused decode steps over device inputs (the keys of
        _run_decode's arrays); returns the sampled ids [K, B] (with lp >= 0,
        and their logprobs: chosen [K, B], top ids and logprobs [K, B,
        max(lp, 1)]). Each step's sampled ids extend the output counts the
        next step penalizes, and the min_tokens gate reads the step's own
        output count.

        With `stops` and `budgets` among the inputs the steps are a K-step
        window, which returns the ids [K, B] and each row's emitted count
        [B]. A row is alive from its `valid` until it emits a stop id or
        its budget's last token (emitted first, as the host accepts a
        stop), then frozen: each step runs with valid & alive, so the write
        lands nothing for it, and its position, draw and output counts
        stop (a live row's step s draws noise s and gates min_tokens at
        count + s). Nothing here reads a device value on the host, so the
        window captures as one graph."""
        tokens, pos, valid = bufs["tokens"], bufs["positions"], bufs["valid"]
        counts = self._counts(bufs)
        window = "stops" in bufs
        alive = valid[:, 0] if window else None  # padding rows start frozen
        n_emit = torch.zeros_like(bufs["budgets"]) if window else None
        step_ids, step_lps = [], []
        for s in range(k_steps):
            hidden, self.kv = self.adapter.forward_hidden(
                self.params, tokens, pos, valid if alive is None else valid & alive[:, None],
                self.kv, bufs["page_tables"]
            )
            logits = self.adapter.compute_logits(self.params, hidden[:, -1])
            ids = self._pick(logits, bufs, s, counts)
            if counts is not None:
                counts = count_tokens(counts, ids, alive)
            if lp >= 0:
                step_lps.append(token_logprobs(logits, ids, lp))
            step_ids.append(ids)
            tokens = ids[:, None]  # fed back on the device
            if alive is None:
                pos = pos + 1
                continue
            n_emit = n_emit + alive.to(n_emit.dtype)
            # a frozen row's history stays where it stopped: positions
            # advance by the alive mask, so paged decode never reads past
            # the pages of a row frozen at its context budget
            pos = pos + alive[:, None].to(pos.dtype)
            alive = alive & ~stop_mask(ids, bufs["stops"]) & (n_emit < bufs["budgets"])
        if window:
            return torch.stack(step_ids), n_emit
        return self._outputs(step_ids, step_lps)

    # -- prompt-lookup speculation (config.spec_ngram; JaxEngine:
    # _spec_eligible .. _note_spec_step) ------------------------------------

    def _spec_eligible(self, reqs: list[Request]) -> bool:
        """Whether the batch may speculate. The draft-model dispatch
        threads sampling, penalties, logit_bias and min_tokens through its
        accept scan, but reports no logprobs: a row that asks for them
        makes the batch ineligible. The prompt-lookup verify has no
        sampler, so every row must be greedy with no logprobs, penalty,
        logit_bias or min_tokens."""
        if self._spec_draft:
            return not any(r.sampling.logprobs >= 0 for r in reqs)
        if self.config.spec_ngram <= 0:
            return False
        for r in reqs:
            s = r.sampling
            if (s.temperature > 0.0 or s.logprobs >= 0 or s.frequency_penalty
                    or s.presence_penalty or s.repetition_penalty != 1.0 or s.logit_bias
                    or s.min_tokens):
                return False
        return True

    def _spec_active(self, reqs: list[Request]) -> bool:
        """Whether this decode batch runs a verify: eligible and out of
        the acceptance cooldown, which this call counts down; a skip is
        counted by its reason. At most once a step (a mixed step asks
        before it splits the draft-model dispatch out as its decode leg)."""
        if not (self._spec_draft or self.config.spec_ngram > 0):
            return False
        if self._spec_eligible(reqs):
            if self._spec_cooldown <= 0:
                return True
            self._spec_cooldown -= 1
            self.metrics.spec_skipped_cooldown += 1
        else:
            self.metrics.spec_skipped_ineligible += 1
        return False

    def _propose_drafts(self, req: Request, s: int) -> list[int]:
        """The s tokens that followed the last earlier occurrence of the
        request's trailing n-gram (spec_ngram_match tokens), zero-padded
        past the sequence's end; all zeros without a match (they fail the
        verify, and the model's own token still lands). The index grows
        with the sequence, each n-gram start indexed once; after a
        preemption folded outputs into the prompt it is rebuilt."""
        n = self.config.spec_ngram_match
        if req.num_tokens <= n:
            return [0] * s
        if req.spec_index is not None and (
                req.num_tokens - len(req.spec_ctx) > len(req.output_tokens)):
            # the new tokens can no longer be read off output_tokens
            req.spec_index = None
        if req.spec_index is None:
            req.spec_index = {}
            req.spec_ctx = req.all_tokens  # one copy, then appended to
            req.spec_indexed_upto = 0
        elif len(req.spec_ctx) < req.num_tokens:
            req.spec_ctx.extend(req.output_tokens[len(req.spec_ctx) - req.num_tokens:])
        ctx = req.spec_ctx
        # every n-gram start but the trailing one: a tail matches an
        # earlier occurrence
        for j in range(req.spec_indexed_upto, len(ctx) - n):
            req.spec_index[tuple(ctx[j: j + n])] = j
        req.spec_indexed_upto = max(req.spec_indexed_upto, len(ctx) - n)
        j = req.spec_index.get(tuple(ctx[-n:]))
        if j is None:
            return [0] * s
        cont = ctx[j + n: j + n + s]
        return cont + [0] * (s - len(cont))

    def _run_decode_spec(self, reqs: list[Request]) -> list[StepOutput]:
        """One verify dispatch over [last token, d_0 .. d_{S-1}] a row, at
        positions num_tokens - 1 on: a chunk with history whose K/V land
        token by token; the ids are the argmax at every position. Each row
        accepts its drafts while they equal the model's tokens, and the
        model's token at the first mismatch: 1 to S + 1 tokens. The K/V of
        rejected drafts lie past the accepted tokens, in pages not yet
        registered, and are written again before they are read. A row
        whose window would pass its context, or a pool that cannot cover
        every window, runs the plain decode dispatch instead."""
        s = self.config.spec_ngram
        if any(r.num_tokens + s > self.config.max_context for r in reqs):
            return self._run_decode_plain(reqs)
        if not self._grow_pages_for(reqs, s):
            return self._run_decode_plain(reqs)
        t0 = time.perf_counter()
        b_bucket = self.config.decode_bucket_for(len(reqs))
        t = s + 1
        tokens = np.zeros((b_bucket, t), np.int64)
        positions = np.zeros((b_bucket, t), np.int32)
        valid = np.zeros((b_bucket, t), bool)
        pt = np.zeros((b_bucket, self.config.max_pages_per_seq), np.int32)
        drafts = np.zeros((b_bucket, s), np.int64)
        for i, req in enumerate(reqs):
            drafts[i] = self._propose_drafts(req, s)
            tokens[i, 0] = (req.output_tokens or req.prompt_tokens)[-1]
            tokens[i, 1:] = drafts[i]
            positions[i] = np.arange(t, dtype=np.int32) + req.num_tokens - 1
            valid[i] = True
            pt[i, : len(req.pages)] = req.pages
        host_ms = (time.perf_counter() - t0) * 1e3
        ids = self._dispatch(("spec_verify", b_bucket, t), {
            "tokens": tokens, "positions": positions, "valid": valid, "page_tables": pt})
        t1 = time.perf_counter()
        target = ids.numpy()  # [B, S + 1]
        t2 = time.perf_counter()
        self.metrics.time_decode_sync_ms += (t2 - t1) * 1e3
        self.metrics.decode_steps_run += 1
        outputs: list[StepOutput] = []
        drafted = accepted_drafts = 0
        for i, req in enumerate(reqs):
            accepted, finish = self._scan_window(req, target[i], drafts[i])
            drafted += s
            accepted_drafts += len(accepted) - 1
            req.num_computed_tokens += len(accepted)
            outputs.extend(self._accept_tokens(req, accepted, finish))
            self._register_pages(req)
        self._note_spec_step(drafted, accepted_drafts)
        if drafted and accepted_drafts / drafted < self.config.spec_min_accept_rate:
            # the lookup misses on this workload: decode plainly for a
            # while, then try again
            self._spec_cooldown = self.config.spec_cooldown_steps
        self.metrics.time_spec_host_ms += host_ms + (time.perf_counter() - t2) * 1e3
        return outputs

    def _scan_window(self, req: Request, ids: np.ndarray, drafts: np.ndarray
                     ) -> tuple[list[int], Optional[FinishReason]]:
        """One row of a verify window: the model's tokens ids [S + 1] at
        each position while they equal the drafts [S], and its token at
        the first mismatch (1 to S + 1 tokens), cut at a finish."""
        accepted: list[int] = []
        finish: Optional[FinishReason] = None
        for j, tok in enumerate(ids.tolist()):
            accepted.append(tok)
            finish = self._finish_reason_for(req, tok, len(accepted))
            if finish is not None or (j < len(drafts) and int(drafts[j]) != tok):
                break  # a finish, or the draft diverged: the model's token lands
        return accepted, finish

    def _verify_body(self, bufs: dict[str, torch.Tensor]) -> torch.Tensor:
        """The verify over device inputs (the keys of _run_decode_spec's
        arrays): the window through the model as a chunk with history,
        its K/V landed in runs of one slot, since it starts mid-page; the
        argmax ids [B, S + 1] (int32) at every position. Nothing here
        reads a device value on the host, so it captures as one graph."""
        hidden, self.kv = self.adapter.forward_hidden(
            self.params, bufs["tokens"], bufs["positions"], bufs["valid"], self.kv,
            bufs["page_tables"], write_run=1,
        )
        b, t, h = hidden.shape
        logits = self.adapter.compute_logits(self.params, hidden.reshape(b * t, h))
        return sample_greedy(logits).reshape(b, t).to(torch.int32)

    def _note_spec_step(self, drafted: int, accepted: int) -> None:
        """A verify step's drafts into the counters and the window behind
        spec_accept_rate."""
        self.metrics.spec_drafted += drafted
        self.metrics.spec_accepted += accepted
        self._spec_window.append((time.perf_counter(), drafted, accepted))
        self._spec_win_drafted += drafted
        self._spec_win_accepted += accepted

    def _refresh_spec_window(self) -> None:
        """Drop verify steps older than _SPEC_WINDOW_S from the window and
        publish its acceptance rate and drafts."""
        now = time.perf_counter()
        w = self._spec_window
        while w and now - w[0][0] > _SPEC_WINDOW_S:
            _, d, a = w.popleft()
            self._spec_win_drafted -= d
            self._spec_win_accepted -= a
        m = self.metrics
        m.spec_accept_rate = (round(self._spec_win_accepted / self._spec_win_drafted, 4)
                              if self._spec_win_drafted else 0.0)
        m.spec_window_drafted = self._spec_win_drafted

    # -- draft-model speculation (config.spec_draft_model; JaxEngine:
    # _init_draft_model, _spec_draft_cover .. _discard_inflight_spec) -------

    def _init_draft_model(self, params: Optional[dict]) -> None:
        """The draft's adapter, weights and KV pool. The pool has the
        target's page count and size, in the model dtype whatever
        kv_quantize says, and is addressed by the same page ids, so the
        allocator's accounting covers it; its bytes join kv_pool_bytes.
        The weights, as the JAX engine picks them: a self-draft (the
        target's own name and no spec_draft_checkpoint) shares the
        target's tree, int8 ones included, also when that name is a
        checkpoint; else spec_draft_checkpoint or the draft name's own
        checkpoint loads; with neither, random weights come from a seeded
        generator of the draft's own. A draft of its own is never quantized."""
        cfg = self.config
        self.draft_adapter = get_model(cfg.spec_draft_model, dtype=cfg.dtype)
        if self.draft_adapter.vocab_size != self.adapter.vocab_size:
            raise ValueError(
                f"draft model {cfg.spec_draft_model!r} has vocab "
                f"{self.draft_adapter.vocab_size} but target {cfg.model!r} has "
                f"{self.adapter.vocab_size}: speculation needs a shared vocabulary")
        ckpt = cfg.spec_draft_checkpoint or self.draft_adapter.default_checkpoint
        if params is None and cfg.spec_draft_model == cfg.model \
                and cfg.spec_draft_checkpoint is None:
            params = self.params
        elif params is None and ckpt is not None:
            logger.info("loading draft %s from %s", cfg.spec_draft_model, ckpt)
            params = self.draft_adapter.load_params(ckpt, self.device)
        elif params is None:
            logger.info("initializing random draft params for %s (acceptance sits at chance)",
                        cfg.spec_draft_model)
            params = self.draft_adapter.init_params(
                torch.Generator(device=self.device).manual_seed(0))
        self.draft_params = params
        self.draft_kv = self.draft_adapter.init_kv(cfg.num_pages, cfg.page_size, self.device)
        self.metrics.kv_pool_bytes += sum(x.numel() * x.element_size() for x in self.draft_kv
                                          if x is not None)

    @staticmethod
    def _tokens_from(req: Request, start: int) -> list[int]:
        """The request's tokens from position `start` on."""
        n = len(req.prompt_tokens)
        if start >= n:
            return req.output_tokens[start - n:]
        return req.prompt_tokens[start:] + req.output_tokens

    def _spec_draft_cover(self, spans) -> None:
        """Bring the draft pool up to date over `spans`, (request, upto)
        pairs: draft forwards that only write its KV, over positions
        [spec_draft_pos, upto) in chunks of at most prefill_chunk tokens,
        key ("spec_draft_prefill", B bucket, T bucket, first chunk). Chunk
        r of every span runs before chunk r + 1 of any (a later chunk
        reads the earlier one's KV); a round's chunks group by T bucket as
        a prefill step's pieces do. A prefill piece's chunks start on
        pages; one that brings a stale pool up in decode may start
        mid-page and lands by token (_draft_prefill_body)."""
        chunk = self.config.prefill_chunk
        rounds: list[list[tuple]] = []
        for req, upto in spans:
            start, r = req.spec_draft_pos, 0
            while start < upto:
                take = min(chunk, upto - start)
                if r == len(rounds):
                    rounds.append([])
                rounds[r].append((req, start, take))
                start += take
                r += 1
            req.spec_draft_pos = max(req.spec_draft_pos, upto)
        for items in rounds:
            groups: dict[int, list] = {}
            for item in items:
                groups.setdefault(self._bucket_t(item[2]), []).append(item)
            for t_bucket, group in sorted(groups.items()):
                b_bucket = self._bucket_b(len(group))
                tokens = np.zeros((b_bucket, t_bucket), np.int64)
                positions = np.zeros((b_bucket, t_bucket), np.int32)
                valid = np.zeros((b_bucket, t_bucket), bool)
                pt = np.zeros((b_bucket, self.config.max_pages_per_seq), np.int32)
                for i, (req, start, length) in enumerate(group):
                    tokens[i, :length] = self._tokens_from(req, start)[:length]
                    positions[i] = np.arange(t_bucket, dtype=np.int32) + start
                    valid[i, :length] = True
                    pt[i, : len(req.pages)] = req.pages
                first_chunk = all(start == 0 for _, start, _ in group)
                self._dispatch(("spec_draft_prefill", b_bucket, t_bucket, first_chunk),
                               {"tokens": tokens, "positions": positions, "valid": valid,
                                "page_tables": pt})

    def _draft_prefill_body(self, first_chunk: bool, bufs: dict[str, torch.Tensor]) -> None:
        """One chunk step of the draft over device inputs (the keys of
        _spec_draft_cover's arrays), landing its KV in the draft pool: a
        first chunk in runs, any other chunk token by token (write_run=1),
        since its rows may start mid-page. Returns nothing."""
        _, self.draft_kv = self.draft_adapter.forward_hidden(
            self.draft_params, bufs["tokens"], bufs["positions"], bufs["valid"], self.draft_kv,
            bufs["page_tables"], first_chunk=first_chunk,
            write_run=None if first_chunk else 1,
        )

    def _run_decode_spec_draft(self, reqs: list[Request]) -> list[StepOutput]:
        """One draft-model dispatch (_spec_fused_body): each row emits 1 to
        S + 1 tokens, its accepted drafts and the target's token after
        them. A row whose verify window would pass its context, or a pool
        that cannot cover every window, runs the plain decode dispatch
        instead. A row that reaches decode with a stale draft pool (its
        pieces ran in fused mixed steps, or plain dispatches ran in a
        cooldown) first has the pool brought up to its last token. A
        chained dispatch that matches the batch is this step: the next one
        chains off it before its outputs are read."""
        s = self.config.spec_draft_tokens
        w = s + 1
        if any(r.num_tokens + s > self.config.max_context for r in reqs):
            self._discard_inflight_spec("window over context cap")
            return self._run_decode_plain(reqs)
        if not self._grow_pages_for(reqs, s):
            self._discard_inflight_spec("page pressure")
            return self._run_decode_plain(reqs)
        # a plain speculation, dispatched in a cooldown, cannot be a verify
        self._discard_inflight("spec verify owns the decode batch")
        spans = [(r, r.num_tokens - 1) for r in reqs if r.num_tokens - r.spec_draft_pos > w]
        if spans:
            if self._inflight_spec is not None:
                self._inflight_spec.ids.keep()  # the cover replays come first
            self._spec_draft_cover(spans)
        b_bucket = self.config.decode_bucket_for(len(reqs))
        inflight, self._inflight_spec = self._inflight_spec, None
        if inflight is not None:
            if self._spec_inflight_matches(inflight, reqs):
                self.metrics.overlap_hits += 1
                self._maybe_chain_spec(reqs, b_bucket, inflight.ids, inflight.greedy,
                                       inflight.bias)
                return self._spec_postprocess(reqs, inflight.ids)
            self._inflight_spec = inflight  # handed back for the count
            self._discard_inflight_spec("decode batch changed")
        t0 = time.perf_counter()
        greedy = all(r.sampling.temperature <= 0.0 for r in reqs)
        pen, bias = self._batch_penalty_bucket(reqs), self._batch_bias(reqs)
        arrays = self._spec_arrays(reqs, b_bucket, greedy, pen, bias)
        self.metrics.time_spec_host_ms += (time.perf_counter() - t0) * 1e3
        ids = self._dispatch(("spec_fused", b_bucket, w, greedy, pen, bias), arrays)
        # keep the device busy past this dispatch before reading its outputs
        self._maybe_chain_spec(reqs, b_bucket, ids, greedy, bias)
        return self._spec_postprocess(reqs, ids)

    def _spec_arrays(self, reqs: list[Request], b_bucket: int, greedy: bool, pen: int,
                     bias: bool, prev: Optional[Readback] = None) -> dict:
        """The inputs of a draft-model dispatch, padded to b_bucket: the
        catch-up window's tokens [B, S + 1] and lengths win_len [B] (the
        tokens since spec_draft_pos; for a dispatch chained off `prev`,
        its out_ids and n_acc on the device), the window's first position
        pos0 [B], the page tables and draw0 [B]. Position j of a row whose
        window holds w tokens draws and gates min_tokens at counter draw0
        + w - 1 + j, from row w - 1 + j of the noise table [2S + 1, B, K]
        and the accept uniforms [2S + 1, B] (sampled keys): a host-fed
        dispatch fills the S + 1 rows its windows read, a chained one all
        2S + 1 that the pending dispatch's n_acc (1 to S + 1) may pick.
        Then the penalty and bias arrays (the bias gate reads draw0, so
        their output count is dropped)."""
        s = self.config.spec_draft_tokens
        pos0 = np.zeros(b_bucket, np.int32)
        pt = np.zeros((b_bucket, self.config.max_pages_per_seq), np.int32)
        draw0 = np.zeros(b_bucket, np.int64)
        first = []
        if prev is None:
            tokens = np.zeros((b_bucket, s + 1), np.int64)
            win_len = np.zeros(b_bucket, np.int64)
        else:
            tokens, _, win_len = prev.outputs
        ahead = int(prev is not None)
        for i, req in enumerate(reqs):
            pt[i, : len(req.pages)] = req.pages
            if prev is None:
                window = self._tokens_from(req, req.spec_draft_pos)
                tokens[i, : len(window)] = window
                win_len[i] = len(window)
                pos0[i] = req.spec_draft_pos
                first.append(len(window) - 1)
            else:
                # the pending dispatch's tokens land from num_tokens on
                pos0[i] = req.num_tokens
                first.append(0)
            draw0[i] = req.num_emitted + len(req.output_tokens) + ahead - first[i]
        arrays = {"tokens": tokens, "win_len": win_len, "pos0": pos0, "page_tables": pt,
                  "draw0": draw0}
        if not greedy:
            steps = s + 1 if prev is None else 2 * s + 1
            rows = self._sampler_rows(reqs, b_bucket, steps, ahead)
            uniforms = accept_uniforms(
                [self._request_seed(r) for r in reqs],
                [r.num_emitted + len(r.output_tokens) + ahead for r in reqs], steps).numpy()
            noise = np.zeros((2 * s + 1, b_bucket, DEFAULT_K_CAP), np.float32)
            unif = np.zeros((2 * s + 1, b_bucket), np.float32)
            for i, f in enumerate(first):
                noise[f: f + steps, i] = rows["noise"][:, i]
                unif[f: f + steps, i] = uniforms[:, i]
            arrays.update(rows, noise=noise, uniform=unif)
        arrays.update(self._surface_arrays(reqs, b_bucket, pen, bias))
        arrays.pop("bias_count", None)
        return arrays

    def _spec_fused_body(self, greedy: bool, bufs: dict[str, torch.Tensor]):
        """One draft-model dispatch over device inputs (_spec_arrays):
        (1) the draft's catch-up over each row's window [pos0, pos0 +
        win_len), landed in its pool by token (a window starts mid-page),
        whose last position proposes the first draft; (2) S - 1 more T=1
        draft steps, each proposing the argmax of the last; (3) the
        target's verify over [the window's last token, the S drafts] from
        that token's position on, landed by token; (4) the acceptance scan
        over the S + 1 positions, each penalized (the counts extended by
        every token emitted before it), biased (min_tokens gated at its own
        counter), then for a greedy key taken as the argmax and accepted
        iff it is the draft, else through spec_accept_step with its
        counter's noise and uniform; a row emits at j iff every earlier
        draft was accepted. Padding rows (win_len 0) write nothing.
        Returns out_ids [B, S + 1], draft_ids [B, S] and n_acc [B], the
        tokens each row emits; the draft's logits stay inside. Nothing
        here reads a device value on the host, so a dispatch captures as
        one graph."""
        s = self.config.spec_draft_tokens
        tokens, win_len, pos0, pt = (bufs[n] for n in ("tokens", "win_len", "pos0",
                                                        "page_tables"))
        b = tokens.shape[0]
        rows = torch.arange(b, device=tokens.device)
        window = torch.arange(s + 1, dtype=torch.int32, device=tokens.device)[None]
        live = win_len > 0
        last = (win_len - 1).clamp(min=0)
        pos_last = pos0 + last.to(torch.int32)  # num_tokens - 1 of each row
        dm, dp = self.draft_adapter, self.draft_params
        hidden, self.draft_kv = dm.forward_hidden(
            dp, tokens, (pos0[:, None] + window).contiguous(),
            (window < win_len[:, None]).contiguous(), self.draft_kv, pt, write_run=1,
        )
        draft = sample_greedy(dm.compute_logits(dp, hidden[rows, last]))
        drafts = [draft]
        for j in range(1, s):
            pos = torch.where(live, pos_last + j, 0)[:, None]  # padding rows: no history
            hidden, self.draft_kv = dm.forward_hidden(dp, draft[:, None], pos, live[:, None],
                                                      self.draft_kv, pt)
            draft = sample_greedy(dm.compute_logits(dp, hidden[:, -1]))
            drafts.append(draft)
        draft_ids = torch.stack(drafts, dim=1)
        verify = torch.cat([tokens[rows, last][:, None], draft_ids], dim=1)
        hidden, self.kv = self.adapter.forward_hidden(
            self.params, verify, (pos_last[:, None] + window).contiguous(),
            live[:, None].expand(b, s + 1).contiguous(), self.kv, pt, write_run=1,
        )
        logits = self.adapter.compute_logits(
            self.params, hidden.reshape(b * (s + 1), -1)).reshape(b, s + 1, -1)
        counts = self._counts(bufs)
        alive = live
        n_acc = torch.zeros_like(win_len)
        outs = []
        for j in range(s + 1):
            eff = logits[:, j]
            if counts is not None:
                eff = apply_penalties(eff, counts, bufs["freq"], bufs["pres"], bufs["rep"])
            idx = last + j  # the position's counter is draw0 + idx
            if "bias_ids" in bufs:
                eff = apply_logit_bias(eff, bufs["bias_ids"], bufs["bias_vals"],
                                       bufs["bias_gated"], bufs["draw0"] + idx,
                                       bufs["min_toks"])
            draft = draft_ids[:, min(j, s - 1)]  # the bonus position has none
            if greedy:
                chosen = sample_greedy(eff)
                acc = chosen == draft if j < s else torch.ones_like(alive)
            else:
                chosen, acc = spec_accept_step(
                    eff, draft, j < s, bufs["temps"], bufs["top_ps"], bufs["top_ks"],
                    bufs["noise"][idx, rows], bufs["uniform"][idx, rows])
            outs.append(chosen)
            n_acc = n_acc + alive.to(n_acc.dtype)
            if counts is not None:
                counts = count_tokens(counts, chosen, alive)
            alive = alive & acc
        return torch.stack(outs, dim=1), draft_ids, n_acc

    def _spec_postprocess(self, reqs: list[Request], ids: Readback) -> list[StepOutput]:
        """The host's half of a draft-model dispatch: wait for out_ids,
        draft_ids and n_acc (copied since the dispatch), then accept each
        row's drafts while they equal its tokens, and the token at the
        first mismatch, up to a finish, as the prompt-lookup verify does
        (out_ids already hold the accepted token at each position). The
        draft pool is committed up to the old last token. A finish, or a
        count other than n_acc, which the device could not foresee, rolls
        the chained dispatch back; else it gets the state the next batch
        must show. A dispatch under spec_min_accept_rate starts the
        cooldown and rolls the chain back."""
        t1 = time.perf_counter()
        out = ids.numpy()
        drafts, n_acc = ids.extras()
        t2 = time.perf_counter()
        self.metrics.time_decode_sync_ms += (t2 - t1) * 1e3
        self.metrics.decode_steps_run += 1
        s = self.config.spec_draft_tokens
        chain = self._inflight_spec  # chained for the next step
        chain_ok = chain is not None
        outputs: list[StepOutput] = []
        drafted = accepted_drafts = 0
        for i, req in enumerate(reqs):
            accepted, finish = self._scan_window(req, out[i], drafts[i])
            drafted += s
            accepted_drafts += len(accepted) - 1
            # the catch-up committed the draft's KV through the old last
            # token; the accepted tokens are the next window
            req.spec_draft_pos = req.num_tokens
            req.num_computed_tokens += len(accepted)
            if finish is not None or len(accepted) != int(n_acc[i]):
                chain_ok = False
            outputs.extend(self._accept_tokens(req, accepted, finish))
            self._register_pages(req)
        self._note_spec_step(drafted, accepted_drafts)
        if chain_ok:
            chain.expected_num_tokens = tuple(r.num_tokens for r in reqs)
            chain.expected_out_len = tuple(len(r.output_tokens) for r in reqs)
        elif chain is not None:
            self._discard_inflight_spec("acceptance diverged or finish")
        if drafted and accepted_drafts / drafted < self.config.spec_min_accept_rate:
            # the draft misses on this workload: decode plainly for a
            # while, then try again
            self._spec_cooldown = self.config.spec_cooldown_steps
            self._discard_inflight_spec("acceptance cooldown")
        self.metrics.time_spec_host_ms += (time.perf_counter() - t2) * 1e3
        return outputs

    def _maybe_chain_spec(self, reqs: list[Request], b_bucket: int, prev: Readback,
                          greedy: bool, bias: bool) -> None:
        """Dispatch the next draft-model step before the pending one's
        outputs reach the host: its catch-up window is the pending
        dispatch's accepted tokens, out_ids and n_acc read on the device,
        and its counters advance by n_acc there (_spec_arrays). As the
        plain speculation (_maybe_speculate): only with overlap on, the
        decode rows kept by the scheduler (a mixed step's rows count), no
        row with a penalty (its history is host state), none that may
        finish inside the pending window or pass its context inside both
        windows, and pages grown to cover both."""
        if not self._overlap_enabled or self._batch_penalty_bucket(reqs):
            return
        if not self.scheduler.decode_batch_stable() and not (
                self.scheduler.mixed_enabled and self.scheduler.decode_rows_stable(reqs)):
            return
        s = self.config.spec_draft_tokens
        for req in reqs:
            if len(req.output_tokens) + req.num_emitted + s + 1 >= req.sampling.max_tokens:
                return  # the pending dispatch may finish it
            if req.num_tokens + 2 * s + 1 > self.config.max_context:
                return
        if not self._grow_pages_for(reqs, 2 * s + 1):
            return
        arrays = self._spec_arrays(reqs, b_bucket, greedy, 0, bias, prev=prev)
        ids = self._dispatch(("spec_fused", b_bucket, s + 1, greedy, 0, bias), arrays)
        self.metrics.overlap_dispatches += 1
        self._inflight_spec = _InflightSpec(tuple(reqs), b_bucket, ids, greedy, bias)

    @staticmethod
    def _spec_inflight_matches(inflight: _InflightSpec, reqs: list[Request]) -> bool:
        """The chained dispatch is this step iff the pending one's accept
        scan agreed with it (expected state filled) and the batch is the
        same requests in the same rows, each advanced as that scan said."""
        if inflight.expected_num_tokens is None or len(reqs) != len(inflight.reqs):
            return False
        return all(
            r is spec and r.num_tokens == nt and len(r.output_tokens) == n_out
            for r, spec, nt, n_out in zip(reqs, inflight.reqs, inflight.expected_num_tokens,
                                          inflight.expected_out_len)
        )

    def _discard_inflight_spec(self, why: str) -> None:
        """Roll back a chained draft-model dispatch, as _discard_inflight
        does a plain one: its outputs are overshoot, and its writes to both
        pools lie past every surviving request's accepted tokens (written
        again before they are read) or in freed pages."""
        if self._inflight_spec is None:
            return
        self._inflight_spec = None
        self.metrics.overlap_rollbacks += 1
        logger.debug("spec chain rollback: %s", why)

    # -- mixed prefill+decode steps (JaxEngine._run_mixed) -----------------

    def _run_mixed(self, batch: ScheduledBatch) -> list[StepOutput]:
        """One step that carries prefill pieces and the decode batch. The
        decode rows run the [B, 1] path of a K=1 decode step and the
        pieces the [B, T] path of a prefill step; pages are the requests'
        own, so the halves read none of each other's writes, and greedy
        streams equal the XOR policy's.

        Three cases split the step into two dispatches, as in the JAX
        engine: decode rows that speculate with the draft model, a
        dispatch in flight that matches the decode rows (it is this step's
        decode half), and decode rows that may run as a K-step window
        (_kstep_candidate: the mixed step function has no window). The
        pieces then dispatch first, as a prefill step that also brings the
        draft pool up to them, and the decode leg is the draft-model
        dispatch (_run_decode_spec_draft) or the plain one
        (_run_decode_plain); the port has no multimodal pieces, the JAX
        engine's fourth case. Otherwise the pieces are
        grouped by T bucket, as a prefill step groups them, so each runs
        under the key the XOR policy would give it: the largest-T group is
        fused with the decode batch into one "mixed" step function, and
        the other groups dispatch beside it as a prefill step."""
        reqs_d = list(batch.decode)
        spec = self._spec_draft and self._spec_active(reqs_d)
        if not spec:
            self._discard_inflight_spec("speculation inactive")
        inflight = self._inflight_spec if spec else self._inflight
        use_inflight = inflight is not None and (spec or self._inflight_matches(inflight, reqs_d))
        if spec or use_inflight or self._kstep_candidate(reqs_d):
            if use_inflight:
                # the pieces' replays come before the next dispatch reads
                # this one's outputs on the device, and may overwrite them
                inflight.ids.keep()
            self.metrics.prefill_dispatches += 1
            outputs = self._run_prefill(ScheduledBatch(kind="prefill", prefill=batch.prefill))
            # the decode leg consumes the dispatch in flight (or rolls it
            # back) and chains or speculates again if the rows hold
            leg = self._run_decode_spec_draft if spec else self._run_decode_plain
            return outputs + leg(reqs_d)
        self._discard_inflight("mixed composition changed")
        groups = self._group_pieces(batch.prefill)
        t_bucket = max(groups)
        pieces = groups.pop(t_bucket)
        outputs: list[StepOutput] = []
        rest = tuple(p for g in groups.values() for p in g)
        if rest:
            self.metrics.prefill_dispatches += 1
            outputs = self._run_prefill(ScheduledBatch(kind="prefill", prefill=rest))
        b_dec = self.config.decode_bucket_for(len(reqs_d))
        b_pre = self._bucket_b(len(pieces))
        tokens = np.zeros((b_dec, 1), np.int64)
        for i, req in enumerate(reqs_d):
            tokens[i, 0] = req.all_tokens[-1]
        # the decode half's arrays are a K=1 decode step's
        arrays = {"tokens": tokens, **self._decode_arrays(reqs_d, b_dec, 0)}
        arrays.update({f"p_{n}": a for n, a in self._prefill_arrays(pieces, b_pre, t_bucket)
                       .items()})
        psamp = any(self._completes(p) for p in pieces)
        first_chunk = all(p.start == 0 for p in pieces)
        # the sampled rows: decode rows [0, b_dec), then, when a piece ends
        # its prompt, prefill rows [b_dec, b_dec + b_pre); each row's noise
        # comes from its own seed and counter, as in a pure step
        pre_reqs = [p.request for p in pieces] if psamp else []
        greedy_d = all(r.sampling.temperature <= 0.0 for r in reqs_d)
        greedy = greedy_d and all(r.sampling.temperature <= 0.0 for r in pre_reqs)
        if not psamp:
            del arrays["p_last"]
        if not greedy:
            halves = [self._sampler_rows(reqs_d, b_dec, 1)]
            if psamp:
                halves.append(self._sampler_rows(pre_reqs, b_pre, 1))
            arrays.update({n: np.concatenate([h[n] for h in halves], axis=int(n == "noise"))
                           for n in halves[0]})
        # penalties and bias over the sampled rows of both halves, as the
        # JAX engine keys them over its row space
        row_reqs = reqs_d + pre_reqs
        lp, pen, bias = (self._batch_logprobs(row_reqs), self._batch_penalty_bucket(row_reqs),
                         self._batch_bias(row_reqs))
        if pen or bias:
            halves = [self._surface_arrays(reqs_d, b_dec, pen, bias)]
            if psamp:
                halves.append(self._surface_arrays(pre_reqs, b_pre, pen, bias))
            arrays.update({n: np.concatenate([h[n] for h in halves]) for n in halves[0]})
        ids = self._dispatch(("mixed", b_dec, t_bucket, b_pre, greedy, first_chunk, psamp, lp,
                              pen, bias), arrays)
        if not psamp:
            # no piece joins decode, so the rows hold: the speculation
            # lands as the next mixed or decode step's decode half
            self._maybe_speculate(reqs_d, b_dec, 1, greedy_d, ids)
        outputs += self._decode_postprocess(reqs_d, 1, ids)
        if not psamp:
            return outputs + self._prefill_postprocess(pieces, None)
        lp_pre = tuple(a[:, b_dec:] for a in ids.extras())
        return outputs + self._prefill_postprocess(pieces, ids.numpy()[0, b_dec:],
                                                   lp_pre or None)

    def _mixed_body(self, first_chunk: bool, psamp: bool, lp: int,
                    bufs: dict[str, torch.Tensor]):
        """One mixed step over device inputs (the keys of _run_mixed's
        arrays): the prefill half's chunk step, then the decode half's
        step; returns the ids [1, rows] drawn for the decode rows and, with
        psamp, at each prefill row's `p_last` token after them (with lp >=
        0, and their logprobs [1, rows(, N)]); penalties and bias apply to
        the rows of both halves together. Each half's
        logits come from a product over its own rows, as in its pure step
        (the JAX engine takes one product over both): a bf16 GEMM rounds
        differently at another row count, and so a row's logits would
        depend on the other half's bucket."""
        hidden_p, self.kv = self.adapter.forward_hidden(
            self.params, bufs["p_tokens"], bufs["p_positions"], bufs["p_valid"], self.kv,
            bufs["p_page_tables"], first_chunk=first_chunk,
        )
        hidden_d, self.kv = self.adapter.forward_hidden(
            self.params, bufs["tokens"], bufs["positions"], bufs["valid"], self.kv,
            bufs["page_tables"],
        )
        logits = self.adapter.compute_logits(self.params, hidden_d[:, -1])
        if psamp:
            rows = torch.arange(hidden_p.shape[0], device=hidden_p.device)
            logits = torch.cat([logits, self.adapter.compute_logits(
                self.params, hidden_p[rows, bufs["p_last"]])])
        ids = self._pick(logits, bufs, 0, self._counts(bufs))
        return self._outputs([ids], [token_logprobs(logits, ids, lp)] if lp >= 0 else [])

    # -- overlapped decode (JaxEngine: _maybe_speculate .. drain_overlap) ---

    def _maybe_speculate(self, reqs: list[Request], b_bucket: int, k_prev: int,
                         greedy: bool, prev: Readback, kstep: bool = False) -> None:
        """Dispatch the next decode step before the pending one's ids reach
        the host: the same batch, positions advanced by k_prev, tokens the
        pending step's last ids, copied on the device. Only when the
        scheduler keeps the batch (no admissible waiting request, nothing
        mid-prefill), every request surely outlives the pending step's
        k_prev tokens, and the pages can pre-grow to cover the window.
        With mixed steps, pending prefill work does not stop it when the
        decode rows hold (decode_rows_stable): the speculation lands as
        the decode half of the next mixed step. Never when a row carries a
        penalty: its history needs the pending step's tokens on the host
        (logprob and bias batches speculate; a bias row's output count
        is advanced by k_prev). After a K-step window (`kstep`) the next
        window chains through the same kind, its budgets less k_prev; a
        row that stops inside the pending window changes the batch, and
        the chained window is rolled back."""
        if not self._overlap_enabled or self._batch_penalty_bucket(reqs):
            return
        if not self.scheduler.decode_batch_stable() and not (
                self.scheduler.mixed_enabled and self.scheduler.decode_rows_stable(reqs)):
            return
        k_next = k_prev
        for req in reqs:
            if len(req.output_tokens) + req.num_emitted + k_prev >= req.sampling.max_tokens:
                return  # the pending step finishes it: the batch will change
            if req.num_tokens + k_prev >= self.config.max_context:
                return
            # never write KV past the page table
            k_next = min(k_next, self.config.max_context - (req.num_tokens + k_prev) + 1)
        k_next = self._pow2_floor(k_next)  # reuse the key family
        if not self._grow_pages_for(reqs, k_prev + k_next - 1):
            return
        # the pending step's last ids over the decode rows (a mixed step's
        # ids [1, rows] hold the decode rows first)
        arrays = {"tokens": prev.device[-1][:b_bucket, None],
                  **self._decode_arrays(reqs, b_bucket, k_prev)}
        # the pending step advances every draw counter and output count by its k
        samp = self._sampling_arrays(reqs, b_bucket, k_next, ahead=k_prev)
        lp, bias = self._batch_logprobs(reqs), self._batch_bias(reqs)
        arrays.update(**(samp or {}), **self._surface_arrays(reqs, b_bucket, 0, bias,
                                                             ahead=k_prev))
        kstep = kstep and k_next > 1
        kind = DECODE_KINDS[k_next > 1]
        if kstep:
            arrays.update(self._kstep_arrays(reqs, b_bucket, emitted_ahead=k_prev))
            kind = "decode_kstep"
        ids = self._dispatch((kind, b_bucket, k_next, greedy, lp, 0, bias), arrays)
        if kstep:
            self._count_window(k_next)
        self.metrics.overlap_dispatches += 1
        self._inflight = _InflightDecode(
            reqs=tuple(reqs), b_bucket=b_bucket, k_steps=k_next, greedy=greedy, ids=ids,
            expected_num_tokens=tuple(r.num_tokens + k_prev for r in reqs),
            expected_out_len=tuple(len(r.output_tokens) + k_prev for r in reqs), kstep=kstep,
        )

    @staticmethod
    def _inflight_matches(inflight: _InflightDecode, reqs: list[Request]) -> bool:
        """The speculation is this step iff the batch is the same requests
        (identity: a resubmitted id is a new object) in the same rows, each
        advanced by exactly the pending step's tokens (a preemption resets
        output_tokens and fails here)."""
        if len(reqs) != len(inflight.reqs):
            return False
        return all(
            r is spec and r.num_tokens == nt and len(r.output_tokens) == n_out
            for r, spec, nt, n_out in zip(reqs, inflight.reqs, inflight.expected_num_tokens,
                                          inflight.expected_out_len)
        )

    def _consume_inflight(self, inflight: _InflightDecode) -> list[StepOutput]:
        """The speculated dispatch is this step: speculate the next one (so
        the device does not drain), then read its ids, whose copy to the
        host started when it was dispatched, and accept them."""
        self.metrics.overlap_hits += 1
        reqs = list(inflight.reqs)
        self._maybe_speculate(reqs, inflight.b_bucket, inflight.k_steps, inflight.greedy,
                              inflight.ids, kstep=inflight.kstep)
        return self._decode_postprocess(reqs, inflight.k_steps, inflight.ids,
                                        kstep=inflight.kstep)

    def _discard_inflight(self, why: str) -> None:
        """Roll back a speculated dispatch. Its ids are overshoot, dropped
        like fused steps past a stop. Its KV writes are harmless: for a
        request that goes on they hold the true tokens at the true
        positions, and the real dispatch writes them again before any
        read; for a finished or preempted request they sit in freed pages,
        which a next owner writes, later on the same stream, before it
        reads them. Pages grown for the window stay with their requests."""
        if self._inflight is None:
            return
        self._inflight = None
        self.metrics.overlap_rollbacks += 1
        logger.debug("overlap rollback: %s", why)

    # -- step functions ----------------------------------------------------

    def _dispatch(self, key: tuple, arrays: dict) -> Optional[Readback]:
        """Run one dispatch through its key's step function; returns the
        Readback of its ids and logprobs (None for a prefill step that
        samples nothing)."""
        self.dispatches += 1
        return self._get_step_fn(key)(arrays)

    def _body(self, key: tuple):
        """The body of a step key: a K-step window, K fused decode steps,
        a prompt-lookup verify, a draft-model dispatch, a draft chunk step,
        one mixed step, or one prefill chunk step that samples or not, over
        the dispatch's device inputs."""
        field = functools.partial(key_field, key)
        if key[0] == "spec_verify":
            return self._verify_body
        if key[0] == "spec_fused":
            return functools.partial(self._spec_fused_body, field("greedy"))
        if key[0] == "spec_draft_prefill":
            return functools.partial(self._draft_prefill_body, field("first_chunk"))
        if key[0] in DECODE_KINDS:
            return functools.partial(self._decode_body, field("steps"), field("lp"))
        if key[0] == "mixed":
            return functools.partial(self._mixed_body, field("first_chunk"), field("psamp"),
                                     field("lp"))
        return functools.partial(self._prefill_body, field("first_chunk"), key[0] == "prefill",
                                 field("lp", -1))

    def _get_step_fn(self, key: tuple):
        """The step function of a dispatch, fn(inputs) -> Readback, cached
        by the JAX engine's key fields (JaxEngine._get_step_fn): for decode
        (kind, batch bucket, steps, all-greedy, lp, pen, bias), where a
        K-step window's kind is "decode_kstep" and its lp -1, for a
        prompt-lookup verify ("spec_verify", batch bucket, S + 1), for a
        draft-model dispatch ("spec_fused", batch bucket, S + 1, all-greedy,
        pen, bias) and a draft chunk step ("spec_draft_prefill", B bucket,
        T bucket, first chunk), for prefill
        ("prefill", B bucket, T bucket, all-greedy, first chunk, lp, pen,
        bias) and ("prefill_nosample", B bucket, T bucket, first chunk),
        for mixed steps ("mixed", decode bucket, T bucket, piece bucket,
        all-greedy, first chunk, prefill rows sampled, lp, pen, bias). The
        sampling surface's fields: lp the top-N the body reports (-1: no
        logprobs), pen the generated-history bucket (0: no penalties),
        bias whether the body applies logit-bias slots. An input is a host array or a
        device tensor. On the card it is a CUDA graph captured at the
        key's first dispatch (_cache_graph); on the CPU, or with
        cuda_graphs=False, the eager body."""
        fn = self._step_fns.get(key)
        if fn is None:
            fn = functools.partial(self._cache_graph if self._graphs else self._run_eager, key)
            self._step_fns[key] = fn
        return fn

    def _run_eager(self, key: tuple, arrays: dict) -> Optional[Readback]:
        bufs = {n: a if isinstance(a, torch.Tensor) else torch.from_numpy(a).to(self.device)
                for n, a in arrays.items()}
        out = self._body(key)(bufs)
        return None if out is None else Readback(out)

    def _cache_graph(self, key: tuple, arrays: dict) -> Optional[Readback]:
        """Counterpart of JaxEngine._cache_jit: the key's first dispatch
        warms its body up and captures it as a StepGraph over buffers
        shaped like `arrays`, counted in metrics.compiles and timed in
        compile_ms, installs the graph as the key's step function and
        replays it. A failed capture raises; nothing falls back."""
        t0 = time.perf_counter()
        if self._graph_stream is None:
            self._graph_setup()
        specs = {n: (tuple(a.shape), a.dtype if isinstance(a, torch.Tensor)
                     else torch.from_numpy(a).dtype) for n, a in arrays.items()}
        graph = StepGraph(specs, self.device)
        if key[0] in PAGED_DECODE_KINDS:
            with torch.cuda.stream(self._graph_stream):
                # the workspace this capture reads, at its full size (grown
                # here, outside the capture, should another user of a stream
                # with the same handle have replaced it), held by the graph:
                # a later replacement in paged_attention's dict frees nothing
                # it reads
                graph.keep = paged_attention.workspace(*self._workspace_size)
        graph.capture(self._body(key), self._graph_pool, self._graph_stream)
        self._step_fns[key] = graph
        self.metrics.compiles += 1
        self.metrics.compile_ms += (time.perf_counter() - t0) * 1e3
        return graph(arrays)

    def _graph_setup(self) -> None:
        """Before the first capture: the capture stream, the pool every
        step graph shares (per decode bucket up to 4 values of K x 2
        sampler kinds, and with windows one more kind for each power of
        two up to decode_kstep; per prefill B and T bucket, 2 sampler kinds x 2
        chunk kinds and 2 non-sampling ones; per decode bucket, T bucket
        and piece bucket, 2 sampler kinds x 2 chunk kinds x prefill rows
        sampled or not, mixed ones; with prompt lookup, one verify key per
        decode bucket; with a draft model, per decode bucket 2 sampler
        kinds of its dispatch, and per B and T bucket 2 chunk kinds of the
        draft's chunk steps; each sampling one again for each lp
        (-1..20), pen bucket (0 or a power of two up to max_tokens) and
        bias a dispatch asks for, as in the JAX engine's key family; see
        StepGraph.capture) and the size of
        paged decode's workspace for the largest bucket's split plan (the
        target's and the draft's), which each decode, mixed and draft-model
        capture makes sure of on the capture
        stream, outside the capture (_cache_graph). Those graphs read one
        set of ticket counters and partials; replays run one at a time on
        the engine's stream, so no two of them use it at once."""
        # the decode wrapper keys its workspace by an indexed device
        dev = self.device
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self._graph_stream = torch.cuda.Stream(dev)
        self._graph_pool = torch.cuda.graph_pool_handle()
        models = [(self.adapter.config, self.config.kv_quantize)]
        if self._spec_draft:
            models.append((self.draft_adapter.config, None))  # the draft's proposals
        counters = partials = 0
        for cfg, mode in models:
            for b in self.config.decode_buckets:
                _, _, groups, n = paged_attention.launch_plan(
                    dev, b, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                    self.config.max_pages_per_seq, mode)
                counters, partials = max(counters, b * groups), max(partials, n)
        self._workspace_size = (dev, counters, partials)

    # -- acceptance --------------------------------------------------------

    def _finish_reason_for(self, req: Request, token: int, n_new: int
                           ) -> Optional[FinishReason]:
        """Finish check for the n_new'th newly-sampled token of this
        dispatch (token not yet appended to the request)."""
        s = req.sampling
        if not s.ignore_eos and (
            token in self.config.eos_token_ids or token in s.stop_token_ids
        ):
            return FinishReason.STOP
        if len(req.output_tokens) + n_new + req.num_emitted >= s.max_tokens:
            return FinishReason.LENGTH
        if req.num_tokens + n_new >= self.config.max_context:
            return FinishReason.LENGTH
        return None

    def _accept_tokens(self, req: Request, tokens: Sequence[int],
                       finish: Optional[FinishReason], first: bool = False,
                       lps: Optional[tuple] = None, tops: Optional[tuple] = None
                       ) -> list[StepOutput]:
        req.output_tokens.extend(tokens)
        chain = self.scheduler.chains.get(req.request_id)
        if chain is not None:
            chain.extend(tokens)
        self.metrics.generated_tokens += len(tokens)
        if finish is not None:
            self.scheduler.finish(req)
            req.finish_reason = finish
        # the prefix cache's share of the prompt rides the first output
        cached = req.num_cached_prompt_tokens if first else None
        return [StepOutput(req.request_id, tuple(tokens), finish, logprobs=lps,
                           top_logprobs=tops, cached_tokens=cached)]

    def _register_pages(self, req: Request) -> None:
        """Content-address each page of the request whose every token has
        its KV (below num_computed_tokens): a `stored` event for each page
        not registered yet."""
        chain = self.scheduler.chains.get(req.request_id)
        if chain is None:  # caching off, or the request has finished
            return
        full = min(req.num_computed_tokens, len(chain)) // self.config.page_size
        for page, block in zip(req.pages[:full], chain.blocks):
            self.allocator.register(page, block.sequence_hash, block.parent_sequence_hash,
                                    block.tokens)
