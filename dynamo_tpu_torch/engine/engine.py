"""TorchEngine: continuous batching over the paged-KV llama model.

Counterpart of dynamo_tpu/engine/engine.py::JaxEngine for the main path:
batched chunked prefill, then decode with `decode_steps` fused steps per
host sync (sampled ids feed back on the device; tokens past a stop are
computed and dropped on the host, as the JAX engine drops them). Every
step runs the model's kernel path: the paged KV write, first-chunk flash
prefill, prefill over a chunk with history and paged decode attention
(dynamo_tpu_torch/ops).

On the card each decode dispatch replays a CUDA graph captured for its
step key at the key's first dispatch (`_get_step_fn`, `_cache_graph`,
engine/step_graph.py), as the JAX engine runs a compiled program per key;
prefill runs eagerly. The eager decode loop serves the CPU and an engine
built with `cuda_graphs=False`.

Shapes follow the JAX engine's buckets (prefill T: powers of two from 32
up to the chunk; B: powers of two for prefill, `decode_buckets` for
decode), so both engines see the same padded batches.
"""

from __future__ import annotations

import functools
import logging
import time
import zlib
from dataclasses import asdict, dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.page_table import PageAllocator
from dynamo_tpu_torch.engine.request import (
    FinishReason,
    Request,
    RequestState,
    SamplingParams,
    StepOutput,
)
from dynamo_tpu_torch.engine.sampling import (
    DEFAULT_K_CAP,
    gumbel_noise,
    sample,
    sample_greedy,
)
from dynamo_tpu_torch.engine.scheduler import ScheduledBatch, Scheduler
from dynamo_tpu_torch.engine.step_graph import StepGraph
from dynamo_tpu_torch.models.registry import get_model
from dynamo_tpu_torch.ops import paged_attention
from dynamo_tpu_torch.platform import resolve_device

logger = logging.getLogger(__name__)


@dataclass
class EngineMetrics:
    requests_received: int = 0
    generated_tokens: int = 0
    prefill_tokens: int = 0
    steps: int = 0
    prefill_dispatches: int = 0
    decode_dispatches: int = 0
    #: fused decode steps run (a dispatch runs 1..decode_steps of them)
    decode_steps_run: int = 0
    time_prefill_ms: float = 0.0
    time_decode_ms: float = 0.0
    #: time spent waiting for decode ids to reach the host (includes the
    #: device time of the steps not yet finished when the wait starts)
    time_decode_sync_ms: float = 0.0
    #: device bytes the KV pool occupies (quantized pages and their scale
    #: planes) and what the same pool costs in the model dtype: their
    #: ratio is the cache capacity kv_quantize buys
    kv_pool_bytes: int = 0
    kv_pool_bytes_dense_equiv: int = 0
    #: decode step graphs captured (one per step key, at its first
    #: dispatch; the JAX engine's compiles) and the wall ms of their
    #: warm-ups and captures
    compiles: int = 0
    compile_ms: float = 0.0
    #: replays of the captured decode graphs (StepGraph.replays summed)
    decode_replays: int = 0

    def to_dict(self) -> dict:
        return asdict(self)


class TorchEngine:
    def __init__(self, config: EngineConfig, params: Optional[dict] = None,
                 device=None, *, cuda_graphs: bool = True):
        """`cuda_graphs=False` runs decode eagerly on the card, as the JAX
        engine runs under jax.disable_jit(); on the CPU decode is always
        eager."""
        self.config = config
        self.device = resolve_device(device)
        self._graphs = cuda_graphs and self.device.type == "cuda"
        #: step key -> its step function (a StepGraph on the card)
        self._step_fns: dict[tuple, object] = {}
        #: the capture stream and the decode graphs' shared memory pool
        #: (_graph_setup)
        self._graph_stream = self._graph_pool = None
        #: (device, counters, partials) of the decode graphs' workspace
        self._workspace_size: tuple = ()
        self.adapter = get_model(config.model, dtype=config.dtype)
        self.allocator = PageAllocator(config.num_pages, config.page_size)
        self.scheduler = Scheduler(config, self.allocator)
        self.metrics = EngineMetrics()
        if params is None:
            logger.info("initializing random params for %s", config.model)
            gen = torch.Generator(device=self.device).manual_seed(0)
            params = self.adapter.init_params(gen)
        self.params = params
        self.kv = self.adapter.init_kv(
            config.num_pages, config.page_size, self.device, kv_quantize=config.kv_quantize
        )
        pool = [x for x in self.kv if x is not None]
        self.metrics.kv_pool_bytes = sum(x.numel() * x.element_size() for x in pool)
        self.metrics.kv_pool_bytes_dense_equiv = (
            (self.kv.k.numel() + self.kv.v.numel()) * self.adapter.config.dtype.itemsize
        )

    # -- public API --------------------------------------------------------

    def add_request(self, request_id: str, prompt_tokens: Sequence[int],
                    sampling: Optional[SamplingParams] = None) -> Request:
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
        """The decode step keys dispatched so far (_get_step_fn)."""
        return list(self._step_fns)

    def step(self) -> list[StepOutput]:
        batch = self.scheduler.schedule()
        outputs = self._drain_doomed()
        if batch is None:
            return outputs
        t0 = time.perf_counter()
        if batch.kind == "prefill":
            self.metrics.prefill_dispatches += 1
            outputs += self._run_prefill(batch)
            self.metrics.time_prefill_ms += (time.perf_counter() - t0) * 1e3
        else:
            self.metrics.decode_dispatches += 1
            outputs += self._run_decode(batch)
            self.metrics.time_decode_ms += (time.perf_counter() - t0) * 1e3
        self.metrics.steps += 1
        return outputs

    def run_to_completion(self) -> dict[str, list[int]]:
        """Drain all queued work; returns request_id -> generated tokens."""
        done: dict[str, list[int]] = {}
        while self.has_work:
            for out in self.step():
                done.setdefault(out.request_id, []).extend(out.new_token_ids)
        return done

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

    def _to_device(self, *arrays: np.ndarray):
        return tuple(torch.from_numpy(a).to(self.device) for a in arrays)

    def _request_seed(self, req: Request) -> int:
        if req.sampling.seed is not None:
            return req.sampling.seed & 0xFFFFFFFF
        return zlib.crc32(req.request_id.encode(), self.config.seed & 0xFFFFFFFF)

    def _sampling_arrays(self, reqs: list[Request], pad_to: int, steps: int
                         ) -> Optional[dict[str, np.ndarray]]:
        """The sampler's rows for this dispatch, padded to pad_to: temps,
        top_ps, top_ks and every fused step's noise [steps, pad_to,
        DEFAULT_K_CAP]; None when every request is greedy (the argmax-only
        variant)."""
        if all(r.sampling.temperature <= 0.0 for r in reqs):
            return None
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
            [r.num_emitted + len(r.output_tokens) for r in reqs],
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

    # -- prefill -----------------------------------------------------------

    def _run_prefill(self, batch: ScheduledBatch) -> list[StepOutput]:
        """Pieces grouped by T bucket run as one batched [B, T] forward. A
        group whose pieces all start at 0 runs as first chunks; any other
        group attends over each row's history (0 for a row that starts at
        0). Only pieces that end their prompt are sampled; a group with
        none runs the forward alone (no logits, no sampler noise)."""
        outputs: list[StepOutput] = []
        groups: dict[int, list] = {}
        for piece in batch.prefill:
            groups.setdefault(self._bucket_t(piece.length), []).append(piece)
        mp = self.config.max_pages_per_seq
        for t_bucket, pieces in sorted(groups.items()):
            b_bucket = self._bucket_b(len(pieces))
            tokens = np.zeros((b_bucket, t_bucket), np.int64)
            positions = np.zeros((b_bucket, t_bucket), np.int32)
            valid = np.zeros((b_bucket, t_bucket), bool)
            pt = np.zeros((b_bucket, mp), np.int32)
            for i, piece in enumerate(pieces):
                req = piece.request
                tokens[i, : piece.length] = req.all_tokens[piece.start : piece.start + piece.length]
                positions[i] = np.arange(t_bucket, dtype=np.int32) + piece.start
                valid[i, : piece.length] = True
                pt[i, : len(req.pages)] = req.pages
            d_tokens, d_pos, d_valid, d_pt = self._to_device(tokens, positions, valid, pt)
            hidden, self.kv = self.adapter.forward_hidden(
                self.params, d_tokens, d_pos, d_valid, self.kv, d_pt,
                first_chunk=all(p.start == 0 for p in pieces),
            )
            rows = [i for i, p in enumerate(pieces)
                    if p.start + p.length >= len(p.request.prompt_tokens)]
            ids: dict[int, int] = {}
            if rows:
                last = [pieces[i].length - 1 for i in rows]
                d_rows, d_last = self._to_device(np.asarray(rows), np.asarray(last))
                samp = self._sampling_arrays([pieces[i].request for i in rows], len(rows), 1)
                if samp is not None:
                    samp = dict(zip(samp, self._to_device(*samp.values())))
                logits = self.adapter.compute_logits(self.params, hidden[d_rows, d_last])
                ids = dict(zip(rows, self._sample(logits, samp, 0).cpu().tolist()))
            for i, piece in enumerate(pieces):
                req = piece.request
                req.num_computed_tokens += piece.length
                self.metrics.prefill_tokens += piece.length
                if i in ids:
                    req.state = RequestState.DECODE
                    outputs.extend(self._accept_tokens(
                        req, [ids[i]], self._finish_reason_for(req, ids[i], 1)
                    ))
        return outputs

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
        for req in reqs:
            k = min(k, self.config.max_context - req.num_tokens + 1)
        rem_max = max(
            r.sampling.max_tokens - len(r.output_tokens) - r.num_emitted for r in reqs
        )
        p = 1
        while p < max(1, rem_max):
            p *= 2
        k = self._pow2_floor(min(k, p))
        if k <= 1:
            return 1
        if not self._grow_pages_for(reqs, k - 1):
            return 1  # the single-step path handles pressure via preemption
        return k

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

    def _run_decode(self, batch: ScheduledBatch) -> list[StepOutput]:
        reqs = list(batch.decode)
        b_bucket = self.config.decode_bucket_for(len(reqs))
        mp = self.config.max_pages_per_seq
        k_steps = self._pick_decode_steps(reqs)
        tokens = np.zeros((b_bucket, 1), np.int64)
        positions = np.zeros((b_bucket, 1), np.int32)
        valid = np.zeros((b_bucket, 1), bool)
        pt = np.zeros((b_bucket, mp), np.int32)
        for i, req in enumerate(reqs):
            tokens[i, 0] = req.all_tokens[-1]
            positions[i, 0] = req.num_tokens - 1
            valid[i, 0] = True
            pt[i, : len(req.pages)] = req.pages
        arrays = {"tokens": tokens, "positions": positions, "valid": valid, "page_tables": pt}
        samp = self._sampling_arrays(reqs, b_bucket, k_steps)
        arrays.update(samp or {})
        # the JAX engine's kinds: one step is "decode", fused steps "decode_multi"
        kind = "decode" if k_steps == 1 else "decode_multi"
        fn = self._get_step_fn(kind, b_bucket, k_steps, greedy=samp is None)
        out = fn(arrays)
        t1 = time.perf_counter()
        # [K, B]: the one host sync. A replay's ids leave its static output
        # here, before any other graph replays (StepGraph.capture)
        ids = out.cpu().numpy()
        self.metrics.time_decode_sync_ms += (time.perf_counter() - t1) * 1e3
        self.metrics.decode_steps_run += k_steps
        # counted where the graphs replay, so a dispatch that did not replay shows
        self.metrics.decode_replays = sum(
            g.replays for g in self._step_fns.values() if isinstance(g, StepGraph))
        outputs: list[StepOutput] = []
        for i, req in enumerate(reqs):
            accepted: list[int] = []
            finish: Optional[FinishReason] = None
            for kk in range(k_steps):
                tok = int(ids[kk, i])
                accepted.append(tok)
                finish = self._finish_reason_for(req, tok, len(accepted))
                if finish is not None:
                    break  # overshoot past a stop is dropped
            req.num_computed_tokens += len(accepted)
            outputs.extend(self._accept_tokens(req, accepted, finish))
        return outputs

    def _decode_body(self, k_steps: int, bufs: dict[str, torch.Tensor]) -> torch.Tensor:
        """K fused decode steps over device inputs (the keys of
        _run_decode's arrays); returns the sampled ids [K, B]."""
        samp = bufs if "temps" in bufs else None
        tokens, pos = bufs["tokens"], bufs["positions"]
        step_ids = []
        for s in range(k_steps):
            hidden, self.kv = self.adapter.forward_hidden(
                self.params, tokens, pos, bufs["valid"], self.kv, bufs["page_tables"]
            )
            ids = self._sample(self.adapter.compute_logits(self.params, hidden[:, -1]), samp, s)
            step_ids.append(ids)
            tokens = ids[:, None]  # fed back on the device
            pos = pos + 1
        return torch.stack(step_ids)

    def _decode_eager(self, k_steps: int, arrays: dict[str, np.ndarray]) -> torch.Tensor:
        return self._decode_body(k_steps, dict(zip(arrays, self._to_device(*arrays.values()))))

    def _get_step_fn(self, kind: str, b: int, k_steps: int, greedy: bool):
        """The step function of a decode dispatch, fn(host arrays) -> ids
        [K, B] on the device, cached by the JAX engine's key fields
        (JaxEngine._get_step_fn: kind, batch bucket, steps, all-greedy).
        On the card it is a CUDA graph captured at the key's first
        dispatch (_cache_graph); on the CPU, or with cuda_graphs=False,
        the eager loop."""
        key = (kind, b, k_steps, greedy)
        fn = self._step_fns.get(key)
        if fn is None:
            fn = (functools.partial(self._cache_graph, key) if self._graphs
                  else functools.partial(self._decode_eager, k_steps))
            self._step_fns[key] = fn
        return fn

    def _cache_graph(self, key: tuple, arrays: dict[str, np.ndarray]) -> torch.Tensor:
        """Counterpart of JaxEngine._cache_jit: the key's first dispatch
        warms its body up and captures it as a StepGraph over buffers
        shaped like `arrays`, counted in metrics.compiles and timed in
        compile_ms, installs the graph as the key's step function and
        replays it. A failed capture raises; nothing falls back."""
        t0 = time.perf_counter()
        if self._graph_stream is None:
            self._graph_setup()
        graph = StepGraph({n: (a.shape, torch.from_numpy(a).dtype) for n, a in arrays.items()},
                          self.device)
        with torch.cuda.stream(self._graph_stream):
            # the workspace this capture reads, at its full size (grown here,
            # outside the capture, should another user of a stream with the
            # same handle have replaced it), held by the graph: a later
            # replacement in paged_attention's dict frees nothing it reads
            graph.keep = paged_attention.workspace(*self._workspace_size)
        graph.capture(functools.partial(self._decode_body, key[2]), self._graph_pool,
                      self._graph_stream)
        self._step_fns[key] = graph
        self.metrics.compiles += 1
        self.metrics.compile_ms += (time.perf_counter() - t0) * 1e3
        return graph(arrays)

    def _graph_setup(self) -> None:
        """Before the first capture: the capture stream, the pool the decode
        graphs share (up to buckets x 4 values of K x 2 sampler kinds of
        them; see StepGraph.capture) and the size of paged decode's
        workspace for the largest bucket's split plan, which each capture
        makes sure of on the capture stream, outside the capture
        (_cache_graph). The decode graphs read one set of ticket counters
        and partials; replays run one at a time on the engine thread, so
        no two of them use it at once."""
        # the decode wrapper keys its workspace by an indexed device
        dev = self.device
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self._graph_stream = torch.cuda.Stream(dev)
        self._graph_pool = torch.cuda.graph_pool_handle()
        cfg = self.adapter.config
        counters = partials = 0
        for b in self.config.decode_buckets:
            _, _, groups, n = paged_attention.launch_plan(
                dev, b, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                self.config.max_pages_per_seq, self.config.kv_quantize)
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
                       finish: Optional[FinishReason]) -> list[StepOutput]:
        req.output_tokens.extend(tokens)
        self.metrics.generated_tokens += len(tokens)
        if finish is not None:
            self.scheduler.finish(req)
            req.finish_reason = finish
        return [StepOutput(req.request_id, tuple(tokens), finish)]
