"""Continuous-batching scheduler.

Counterpart of dynamo_tpu/engine/scheduler.py. One `schedule()` call is
one engine step:

1. Admit waiting requests while pages and decode slots allow. With prefix
   caching on, a request's prompt is cut into content-addressed blocks
   (`chains`) at admission, its need is the pages the cache cannot
   serve, and it reuses the longest cached prefix (all but the prompt's
   last page at most, so there are logits to sample); its prefill
   starts at the first uncached page.
2. If any running request still needs prefill, schedule prefill work:
   pieces of at most `prefill_chunk` tokens from the running prompts, in
   order, up to the step's token budget. A piece that does not end its
   prompt ends on a page boundary, so every chunk starts page-aligned.
   A request stays in PREFILL until its last piece has run.
3. With mixed steps on (config.mixed_steps, the default) and running
   decodes beside that prefill work, the decode batch rides the same
   step: one `mixed` batch, so decode rows emit a token every step while
   a prompt backlog drains. The pieces are then capped so that the
   step's two halves, each padded to its bucket, fit the largest decode
   bucket (`_mixed_max_pieces`). With mixed steps off, prefill work
   stalls decoding until it has drained (the XOR policy).
4. Otherwise schedule a decode batch over the running sequences, growing
   page tables by one page where the next token would overflow and
   preempting the youngest sequences (recompute through chunked prefill)
   when pages run out. A mixed step's decode half is scheduled the same
   way, with the same side effects.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Literal, Optional

from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.page_table import PageAllocator
from dynamo_tpu_torch.engine.request import FinishReason, Request, RequestState
from dynamo_tpu_torch.tokens import TokenBlockSequence

logger = logging.getLogger(__name__)


@dataclass(frozen=True)
class PrefillPiece:
    """One request's token span inside a prefill step."""

    request: Request
    start: int  # absolute token index where this piece begins
    length: int


@dataclass(frozen=True)
class ScheduledBatch:
    """`mixed` carries both prefill pieces and the decode batch: one
    engine step in which every decode row emits a token while the prefill
    backlog drains (EngineConfig.mixed_steps)."""

    kind: Literal["prefill", "decode", "mixed"]
    prefill: tuple[PrefillPiece, ...] = ()
    decode: tuple[Request, ...] = ()


class Scheduler:
    def __init__(self, config: EngineConfig, allocator: PageAllocator):
        self.config = config
        self.allocator = allocator
        #: emit `mixed` steps when prefill work and running decodes coexist
        self.mixed_enabled = config.mixed_steps
        self.waiting: list[Request] = []
        self.running: list[Request] = []
        #: content chains of the live requests (prefix caching on): the
        #: engine appends each accepted token and registers full pages
        self.chains: dict[str, TokenBlockSequence] = {}
        #: requests that can never make progress (the engine finishes them
        #: with the given reason) instead of a silent busy-spin
        self.doomed: list[tuple[Request, str, FinishReason]] = []
        #: preemption-by-recompute count (page pressure)
        self.preemptions = 0

    # -- queue interface ---------------------------------------------------

    def add_request(self, request: Request) -> None:
        n = len(request.prompt_tokens)
        if n >= self.config.max_context:
            raise ValueError(
                f"prompt of {n} tokens exceeds max context "
                f"{self.config.max_context} (one slot is reserved for generation)"
            )
        if n == 0:
            raise ValueError("empty prompt")
        request.state = RequestState.WAITING
        self.waiting.append(request)

    def abort_request(self, request_id: str) -> Optional[Request]:
        for q in (self.waiting, self.running):
            for r in q:
                if r.request_id == request_id:
                    q.remove(r)
                    self._release(r)
                    self.chains.pop(request_id, None)
                    return r
        return None

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    def num_waiting(self) -> int:
        return len(self.waiting)

    def can_admit_head(self) -> bool:
        """Whether the waiting-queue head could be admitted right now (a
        page count that leaves cached blocks out, as in the JAX
        scheduler: decode_batch_stable rests on it)."""
        if not self.waiting or len(self.running) >= self.config.max_seqs:
            return False
        need = self._pages_for(self.waiting[0])
        return self.allocator.num_free - need >= self._watermark_pages()

    def clamp_kstep_window(self, reqs, k: int) -> int:
        """The page runway of a K-step decode window
        (EngineConfig.decode_kstep): the window writes up to K tokens of KV
        a row with no host between its steps, so every page it needs must
        exist before it is dispatched. Halve K until the pages covering
        num_tokens + K - 1 of every row, beyond those each holds, fit the
        free pool (as the JAX scheduler does); returns K >= 1."""
        ps = self.config.page_size
        while k > 1:
            need = sum(max(0, -(-(r.num_tokens + k - 1) // ps) - len(r.pages)) for r in reqs)
            if need <= self.allocator.num_free:
                return k
            k //= 2
        return 1

    def decode_batch_stable(self) -> bool:
        """The overlap contract (EngineConfig.overlap_decode): absent
        request-side events, the next `schedule()` returns the same decode
        batch iff no running request still needs prefill and no waiting
        request is admissible now. The engine checks the request side
        (finish, abort, preemption) per request when it consumes the
        speculation."""
        if any(r.state == RequestState.PREFILL for r in self.running):
            return False
        return not (self.waiting and self.can_admit_head())

    def decode_rows_stable(self, reqs) -> bool:
        """The overlap contract with mixed steps, which count as decode
        steps for the overlapped loop: a speculated decode dispatch can
        land as the decode half of the next mixed step iff no waiting
        request is admissible now and the DECODE-state requests are
        exactly `reqs`, in order (a piece that completes its prompt joins
        decode and changes the rows)."""
        if self.waiting and self.can_admit_head():
            return False
        decodable = [r for r in self.running if r.state == RequestState.DECODE]
        return len(decodable) == len(reqs) and all(a is b for a, b in zip(decodable, reqs))

    # -- the step ----------------------------------------------------------

    def schedule(self) -> Optional[ScheduledBatch]:
        self._admit()
        prefill = self._schedule_prefill()
        if prefill is not None and self.mixed_enabled:
            # the decode batch rides the prefill step; _schedule_decode's
            # side effects (page growth, preempting the youngest DECODE
            # victim) apply as on the decode step the XOR policy runs later
            decode = self._schedule_decode()
            if decode is not None:
                return ScheduledBatch(kind="mixed", prefill=prefill.prefill,
                                      decode=decode.decode)
        if prefill is not None:
            return prefill
        return self._schedule_decode()

    def _pages_for(self, req: Request) -> int:
        """Pages for the prompt plus the first generated token."""
        return -(-(len(req.prompt_tokens) + 1) // self.config.page_size)

    def _watermark_pages(self) -> int:
        return int(self.allocator.num_pages * self.config.admission_watermark)

    def _admit(self) -> None:
        ps = self.config.page_size
        caching = self.config.enable_prefix_caching
        while self.waiting and len(self.running) < self.config.max_seqs:
            req = self.waiting[0]
            total = self._pages_for(req)
            # a prompt that can never fit the pool would block the queue
            # head forever: doom it instead
            if total > (self.allocator.num_pages - 1) - self._watermark_pages():
                self.waiting.pop(0)
                self.doomed.append(
                    (req, f"prompt needs {total} pages; pool has "
                          f"{self.allocator.num_pages - 1}",
                     FinishReason.LENGTH)
                )
                continue
            hashes: list[int] = []
            if caching:
                chain = self.chains.get(req.request_id)
                if chain is None:
                    chain = TokenBlockSequence(req.prompt_tokens, block_size=ps,
                                               salt=self.config.model)
                    self.chains[req.request_id] = chain
                hashes = chain.sequence_hashes()
            # the true need leaves out the pages the cache serves
            need = total - self.allocator.match_length(hashes)
            if self.allocator.num_free - need < self._watermark_pages():
                break  # head-of-line blocking by design (FIFO fairness)
            cached = self.allocator.lookup(hashes) if caching else []
            # a prompt cached whole still recomputes its last page, so there
            # are logits to sample: cap the reuse
            while len(cached) > (len(req.prompt_tokens) - 1) // ps:
                self.allocator.free([cached.pop()])
            fresh = self.allocator.allocate(total - len(cached))
            if fresh is None:
                self.allocator.free(cached)
                break
            req.pages = cached + fresh
            req.num_cached_prompt_tokens = len(cached) * ps
            req.num_computed_tokens = req.num_cached_prompt_tokens
            req.state = RequestState.PREFILL
            self.waiting.pop(0)
            self.running.append(req)

    def _mixed_max_pieces(self) -> Optional[int]:
        """Piece cap of a step that carries the decode batch: the engine
        samples a mixed step over one row space of the two halves, each
        padded to its bucket, so the cap is the largest power-of-two piece
        bucket that fits beside the decode bucket inside the largest
        decode bucket (a cap on raw counts would let the piece bucket round
        up past it). At least 1, so a full decode bucket never starves
        prefill. None: mixed steps off, or no running decodes."""
        if not self.mixed_enabled:
            return None
        n_dec = sum(1 for r in self.running if r.state == RequestState.DECODE)
        if not n_dec:
            return None
        cap = self.config.decode_buckets[-1]
        b_dec = self.config.decode_bucket_for(n_dec)
        b_pre = 1
        while b_pre * 2 + b_dec <= cap:
            b_pre *= 2
        return b_pre

    def _prefill_step_budget(self) -> int:
        """Token budget for this prefill step. The adaptive policy grows it
        toward the whole un-prefilled backlog (capped), so a burst drains
        in a few large steps; beside running decodes the grown budget is
        clamped to what the mixed piece cap can pack (the base budget
        stays)."""
        base = self.config.effective_prefill_budget
        if self.config.prefill_budget_policy != "adaptive":
            return base
        pending = sum(
            len(r.prompt_tokens) - r.num_computed_tokens
            for r in self.running if r.state == RequestState.PREFILL
        )
        budget = max(base, min(pending, self.config.effective_prefill_budget_max))
        max_pieces = self._mixed_max_pieces()
        if max_pieces is not None:
            budget = min(budget, max(base, max_pieces * self.config.prefill_chunk))
        return budget

    def _schedule_prefill(self) -> Optional[ScheduledBatch]:
        # Each piece is capped at prefill_chunk tokens; the step budget
        # spans sequences, and beside running decodes the piece count is
        # capped too (_mixed_max_pieces)
        budget = self._prefill_step_budget()
        ps = self.config.page_size
        max_pieces = self._mixed_max_pieces()
        pieces: list[PrefillPiece] = []
        for req in self.running:
            if req.state != RequestState.PREFILL or budget <= 0:
                continue
            if max_pieces is not None and len(pieces) >= max_pieces:
                break
            remaining = len(req.prompt_tokens) - req.num_computed_tokens
            take = min(remaining, self.config.prefill_chunk, budget)
            if take < remaining:
                # mid-prompt pieces end on a page boundary, so the next
                # one starts page-aligned, as paged_write requires
                take = (take // ps) * ps
            if take <= 0:
                continue
            pieces.append(PrefillPiece(request=req, start=req.num_computed_tokens, length=take))
            budget -= take
        if not pieces:
            return None
        return ScheduledBatch(kind="prefill", prefill=tuple(pieces))

    def _schedule_decode(self) -> Optional[ScheduledBatch]:
        decodable = [r for r in self.running if r.state == RequestState.DECODE]
        if not decodable:
            return None
        ps = self.config.page_size
        scheduled: list[Request] = []
        # oldest first; preemption victims are taken from the youngest
        for req in decodable:
            if req.state != RequestState.DECODE:
                continue  # preempted by an earlier iteration of this loop
            # this step writes KV at position num_tokens-1
            if req.num_tokens > len(req.pages) * ps:
                got = self.allocator.allocate(1)
                if got is None:
                    if self._preempt_youngest(excluding=req, scheduled=scheduled):
                        got = self.allocator.allocate(1)
                    if got is None:
                        if not scheduled and len(self.running) == 1:
                            # sole sequence and the pool is exhausted: no
                            # future step can free pages
                            self.running.remove(req)
                            self._release(req)
                            self.chains.pop(req.request_id, None)
                            self.doomed.append(
                                (req, "kv pool exhausted with no preemption victim",
                                 FinishReason.LENGTH)
                            )
                        continue  # stalled this step; others may progress
                req.pages.extend(got)
            scheduled.append(req)
        if not scheduled:
            return None
        cap = self.config.decode_buckets[-1]
        return ScheduledBatch(kind="decode", decode=tuple(scheduled[:cap]))

    def _preempt_youngest(
        self, excluding: Request, scheduled: Optional[list[Request]] = None
    ) -> bool:
        victims = [
            r for r in self.running
            if r is not excluding and r.state == RequestState.DECODE
        ]
        if not victims:
            return False
        victim = victims[-1]
        if scheduled is not None and victim in scheduled:
            scheduled.remove(victim)
        logger.warning("preempting %s (recompute) under page pressure", victim.request_id)
        self.preemptions += 1
        self._release(victim)
        # recompute from scratch through chunked prefill: the prompt grows
        # to include generated tokens
        victim.state = RequestState.WAITING
        victim.num_emitted += len(victim.output_tokens)
        victim.prompt_tokens = victim.all_tokens
        victim.output_tokens = []
        victim.num_computed_tokens = 0
        victim.num_cached_prompt_tokens = 0
        # the draft pool's KV of the request lay in the released pages:
        # the recompute's prefill covers it again
        victim.spec_draft_pos = 0
        self.running.remove(victim)
        self.waiting.insert(0, victim)
        # its registered pages stay cached: the recompute may hit them
        self.chains.pop(victim.request_id, None)
        return True

    # -- completion --------------------------------------------------------

    def finish(self, request: Request) -> None:
        request.state = RequestState.FINISHED
        if request in self.running:
            self.running.remove(request)
        self._release(request)
        self.chains.pop(request.request_id, None)

    def _release(self, request: Request) -> None:
        if request.pages:
            self.allocator.free(request.pages)
            request.pages = []
