"""The engine thread: continuous batching behind per-request output queues.

Counterpart of dynamo_tpu/engine/async_engine.py::AsyncEngineRunner. The
engine's step loop runs on one dedicated thread, the only thread that
touches the scheduler, allocator and KV pool. Callers on any other thread
submit a PreprocessedRequest and iterate its stream items
({token_ids, finish_reason}, and logprobs and top_logprobs when asked
for); an abandoned iteration aborts the request. A request the engine
refuses at admission (a logit_bias over its slots or outside the
vocabulary) gets the error on its own stream.
There is no watchdog, fault injection or overload plane here.

A step that raises fails every request in flight with that error (the
engine's state is not trusted past it), so a refused case reaches its
client instead of wedging the loop.
"""

from __future__ import annotations

import logging
import queue
import threading
from typing import Iterator, Optional

from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.engine.request import SamplingParams, StepOutput
from dynamo_tpu_torch.preprocessor.preprocessor import PreprocessedRequest

logger = logging.getLogger(__name__)


def output_to_dict(out: StepOutput) -> dict:
    """The one wire shape for engine stream items ({token_ids,
    finish_reason}, each token's logprob and top [id, logprob] pairs when
    the request asked for them, and cached_tokens on a first output)."""
    d = {
        "token_ids": list(out.new_token_ids),
        "finish_reason": out.finish_reason.value if out.finish_reason else None,
    }
    if out.logprobs is not None:
        d["logprobs"] = list(out.logprobs)
    if out.top_logprobs is not None:
        d["top_logprobs"] = [[[tid, lp] for tid, lp in alts] for alts in out.top_logprobs]
    if out.cached_tokens is not None:
        d["cached_tokens"] = out.cached_tokens
    return d


def sampling_from(req: PreprocessedRequest) -> SamplingParams:
    return SamplingParams(
        temperature=req.temperature,
        top_p=req.top_p,
        top_k=req.top_k,
        max_tokens=req.max_tokens,
        stop_token_ids=tuple(req.stop_token_ids),
        ignore_eos=req.ignore_eos,
        seed=req.seed,
        logprobs=req.logprobs,
        frequency_penalty=req.frequency_penalty,
        presence_penalty=req.presence_penalty,
        repetition_penalty=req.repetition_penalty,
        logit_bias=tuple((int(t), float(b)) for t, b in req.logit_bias),
        min_tokens=req.min_tokens,
    )


class AsyncEngineRunner:
    """Thread-backed continuous-batching loop around a TorchEngine."""

    def __init__(self, engine: TorchEngine):
        self.engine = engine
        self._queues: dict[str, queue.Queue] = {}
        self._pending: list[PreprocessedRequest] = []
        self._aborts: list[str] = []
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = False
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True, name="engine")
        self._thread.start()

    def stop(self) -> None:
        self._stop = True
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=30)

    # -- caller side -------------------------------------------------------

    def generate(self, request: PreprocessedRequest) -> Iterator[dict]:
        """Stream items for one request; raises the engine's error if it
        refused or failed the request."""
        q: queue.Queue = queue.Queue()
        rid = request.request_id
        with self._lock:
            self._queues[rid] = q
            self._pending.append(request)
        self._wake.set()
        finished = False
        try:
            while True:
                item = q.get()
                if item is None:
                    finished = True
                    return
                if isinstance(item, BaseException):
                    finished = True
                    raise item
                yield item
        finally:
            with self._lock:
                self._queues.pop(rid, None)
                if not finished:
                    self._aborts.append(rid)
            self._wake.set()

    @property
    def metrics(self):
        return self.engine.metrics

    # -- engine thread -----------------------------------------------------

    def _post(self, request_id: str, item) -> None:
        with self._lock:
            q = self._queues.get(request_id)
        if q is not None:
            q.put(item)

    def _run(self) -> None:
        eng = self.engine
        while not self._stop:
            with self._lock:
                pending, self._pending = self._pending, []
                aborts, self._aborts = self._aborts, []
            for req in pending:
                try:
                    eng.add_request(req.request_id, req.token_ids, sampling_from(req))
                except Exception as e:  # refused: the error goes to its client
                    self._post(req.request_id, e)
            for rid in aborts:
                eng.abort_request(rid)
            if not eng.has_work:
                # step() discards a speculation when work runs out, but an
                # abort between steps can empty the engine with one in flight
                eng.drain_overlap()
                self._wake.wait(timeout=0.05)
                self._wake.clear()
                continue
            try:
                outputs = eng.step()
            except Exception as e:
                logger.exception("engine step failed; failing every request in flight")
                self._fail_all(e)
                continue
            for out in outputs:
                self._post(out.request_id, output_to_dict(out))
                if out.finish_reason is not None:
                    self._post(out.request_id, None)

    def _fail_all(self, err: Exception) -> None:
        sched = self.engine.scheduler
        for req in list(sched.waiting) + list(sched.running):
            sched.abort_request(req.request_id)
            self._post(req.request_id, err)
