"""Batched sampling: temperature / top-k / top-p / greedy, penalties,
logit bias and logprobs.

Counterpart of dynamo_tpu/engine/sampling.py: sample, spec_accept_step,
sample_greedy, build_output_counts, apply_penalties, apply_logit_bias,
token_logprobs and stop_mask, in plain PyTorch on tensors of any device (the reference
computes the penalties, the bias, the logprobs and the stop masks in XLA
ops around its sampler, outside any Pallas kernel).
One call handles a heterogeneous batch (per-row parameters): greedy rows
take the argmax, sampling rows take a Gumbel draw over the top-k/top-p
masked, temperature-scaled distribution, truncated (as in the JAX
package) to the `k_cap` most likely tokens, with the top-p mass exact
under the full softmax.

Randomness: each row's Gumbel noise comes from a CPU `torch.Generator`
seeded from (request seed, draw counter), so a (prompt, seed) pair
reproduces exactly whatever else shares the batch. The noise is made on
the host before a dispatch (`gumbel_noise`, all fused steps at once) and
copied to the device in one transfer; the streams differ from JAX's
PRNG, so sampled output matches the reference in distribution only. The
draft-model verify's accept uniforms (`accept_uniforms`) come from a
stream of their own for the same (seed, counter).
"""

from __future__ import annotations

import hashlib
import struct
from typing import Sequence

import torch

_NEG_INF = -1e30

#: static candidate-set bound; per-request top_k is clamped to this
DEFAULT_K_CAP = 64

#: static per-row stop-id slots of a K-step decode window
#: (EngineConfig.decode_kstep): each row's eos and stop ids, -1-padded; a
#: request with more takes the fused-steps path, where the host judges stops
STOP_SLOTS = 8

#: static per-row sparse logit-bias slots (OpenAI logit_bias entries and
#: min_tokens' eos/stop bans share them); requests needing more are refused
#: at admission
BIAS_SLOTS = 16


#: the stream tag of the accept uniforms (the Gumbel stream has none)
ACCEPT_STREAM = 0x5BEC


def _draw_seed(seed: int, counter: int, stream: int = 0) -> int:
    """One generator seed per (request seed, draw counter), and per stream
    past the Gumbel one (stream 0). The CPU generator keeps 32 bits of a
    seed, so the key is hashed into 32."""
    key = struct.pack("<II", seed & 0xFFFFFFFF, counter & 0xFFFFFFFF)
    if stream:
        key += struct.pack("<I", stream)
    return int.from_bytes(hashlib.blake2b(key, digest_size=4).digest(), "little")


def gumbel_noise(seeds: Sequence[int], counters: Sequence[int], k_cap: int,
                 steps: int = 1) -> torch.Tensor:
    """Gumbel(0, 1) noise [steps, B, k_cap] (CPU, float32): row b of step
    s draws from a generator seeded by (seeds[b], counters[b] + s)."""
    out = torch.empty((steps, len(seeds), k_cap), dtype=torch.float32)
    gen = torch.Generator()
    for s in range(steps):
        for b, (seed, counter) in enumerate(zip(seeds, counters)):
            gen.manual_seed(_draw_seed(int(seed), int(counter) + s))
            u = torch.rand(k_cap, generator=gen).clamp_(min=1e-20)
            out[s, b] = -torch.log(-torch.log(u))
    return out


def accept_uniforms(seeds: Sequence[int], counters: Sequence[int], steps: int = 1
                    ) -> torch.Tensor:
    """U(0, 1) [steps, B] (CPU, float32): the accept uniform of row b at
    step s, from a generator seeded by (seeds[b], counters[b] + s) in the
    ACCEPT_STREAM, so it is independent of the Gumbel noise that shares
    the pair."""
    out = torch.empty((steps, len(seeds)), dtype=torch.float32)
    gen = torch.Generator()
    for s in range(steps):
        for b, (seed, counter) in enumerate(zip(seeds, counters)):
            gen.manual_seed(_draw_seed(int(seed), int(counter) + s, ACCEPT_STREAM))
            out[s, b] = torch.rand(1, generator=gen)[0]
    return out


def _kept_candidates(logits, temperature, top_p, top_k, k_cap: int):
    """The distribution `sample` draws from: the top-k_cap candidates of
    the temperature-scaled logits (ids [B, k_cap], descending), their
    logits with those outside the top-p/top-k set at -1e30, and the kept
    mask."""
    greedy = temperature <= 0.0
    safe_t = torch.where(greedy, torch.ones_like(temperature), temperature.clamp(min=1e-6))
    scaled = logits / safe_t[:, None]
    # top-k_cap candidates, descending: the only vocab-wide work besides
    # one reduction for the softmax denominator
    cand_logits, cand_idx = torch.topk(scaled, k_cap, dim=-1)
    lse = torch.logsumexp(scaled, dim=-1, keepdim=True)
    probs = torch.exp(cand_logits - lse)  # true full-softmax mass of candidates
    cum = torch.cumsum(probs, dim=-1)
    ranks = torch.arange(k_cap, device=logits.device)[None, :]
    # top-p: keep tokens whose preceding mass is < p (first always kept)
    keep_p = (cum - probs) < top_p[:, None]
    # top-k: keep the first k ranks (k == 0 disables => k_cap)
    eff_k = torch.where(top_k > 0, top_k.clamp(max=k_cap), torch.full_like(top_k, k_cap))
    keep = keep_p & (ranks < eff_k[:, None])
    masked = torch.where(keep, cand_logits, torch.full_like(cand_logits, _NEG_INF))
    return cand_idx, masked, keep


def sample(
    logits: torch.Tensor,  # [B, V] f32
    temperature: torch.Tensor,  # [B] f32 (<=0 => greedy)
    top_p: torch.Tensor,  # [B] f32 in (0, 1]
    top_k: torch.Tensor,  # [B] i64 (0 => disabled)
    gumbel: torch.Tensor,  # [B, k_cap] f32 noise (gumbel_noise)
) -> torch.Tensor:  # [B] i64 sampled token ids
    """Sample one token per row; k_cap is gumbel.shape[-1] (clamped to V)."""
    k_cap = min(gumbel.shape[-1], logits.shape[1])
    cand_idx, masked, _ = _kept_candidates(logits, temperature, top_p, top_k, k_cap)
    sampled_rank = torch.argmax(masked + gumbel[:, :k_cap], dim=-1)
    sampled = torch.gather(cand_idx, 1, sampled_rank[:, None])[:, 0]
    return torch.where(temperature <= 0.0, torch.argmax(logits, dim=-1), sampled)


def spec_accept_step(
    logits: torch.Tensor,  # [B, V] f32 (penalized and biased) target logits
    draft: torch.Tensor,  # [B] i64 proposed token (ignored without a draft)
    has_draft: bool,  # False at the bonus position: a plain draw
    temperature: torch.Tensor,  # [B] f32 (<=0 => greedy row)
    top_p: torch.Tensor,  # [B] f32
    top_k: torch.Tensor,  # [B] i64
    gumbel: torch.Tensor,  # [B, k_cap] f32 noise at this position's counter
    uniform: torch.Tensor,  # [B] f32 accept uniform at that counter
) -> tuple[torch.Tensor, torch.Tensor]:  # (chosen [B] i64, accept [B] bool)
    """One position of speculative rejection sampling against a
    deterministic draft (a point mass at the draft token): accept it with
    probability p_eff(draft), else draw from p_eff with the draft taken
    out, so the emitted token's marginal is p_eff, the distribution
    `sample` draws from (temperature, the top-k_cap candidates, the
    top-p/top-k mask). Greedy rows take the argmax and accept iff it is
    the draft. At the bonus position (has_draft=False) the draw is
    `sample`'s with the same noise, bit for bit."""
    k_cap = min(gumbel.shape[-1], logits.shape[1])
    greedy = temperature <= 0.0
    cand_idx, masked, keep = _kept_candidates(logits, temperature, top_p, top_k, k_cap)
    greedy_tok = torch.argmax(logits, dim=-1)
    g = gumbel[:, :k_cap]
    if not has_draft:
        rank = torch.argmax(masked + g, dim=-1)
        sampled = torch.gather(cand_idx, 1, rank[:, None])[:, 0]
        chosen = torch.where(greedy, greedy_tok, sampled)
        return chosen, torch.ones_like(greedy)
    # p_eff(draft): the draft's mass under the kept candidates' softmax
    kept_lse = torch.logsumexp(masked, dim=-1, keepdim=True)
    is_draft = cand_idx == draft[:, None]
    p_draft = torch.where(is_draft & keep, torch.exp(masked - kept_lse),
                          torch.zeros_like(masked)).sum(dim=-1)
    # the residual: a Gumbel argmax over the kept candidates but the draft
    masked_excl = torch.where(is_draft, torch.full_like(masked, _NEG_INF), masked)
    has_alt = (keep & ~is_draft).any(dim=-1)
    rank = torch.argmax(masked_excl + g, dim=-1)
    resampled = torch.gather(cand_idx, 1, rank[:, None])[:, 0]
    accept_s = (uniform < p_draft) | ~has_alt
    chosen = torch.where(greedy, greedy_tok, torch.where(accept_s, draft, resampled))
    return chosen, torch.where(greedy, greedy_tok == draft, accept_s)


def stop_mask(ids: torch.Tensor,  # [B] sampled ids
              stops: torch.Tensor,  # [B, STOP_SLOTS] stop ids, -1-padded
              ) -> torch.Tensor:  # [B] bool
    """Whether each row's sampled id is one of its stop ids (a K-step
    window freezes the row after emitting it). Padding slots are -1 and
    never match."""
    return ((ids[:, None] == stops) & (stops >= 0)).any(dim=1)


def sample_greedy(logits: torch.Tensor) -> torch.Tensor:
    """Argmax-only path for batches where every request is greedy."""
    return torch.argmax(logits, dim=-1)


def build_output_counts(out_tokens: torch.Tensor,  # [B, O] i64 output history (padded)
                        out_valid: torch.Tensor,  # [B, O] bool
                        vocab: int) -> torch.Tensor:  # [B, V] f32
    """Scatter the output-token history into a per-vocab count table, the
    state the OpenAI frequency/presence penalties are defined over. The
    scatter adds exact small integers, so the order of its adds cannot
    change the result."""
    counts = torch.zeros((out_tokens.shape[0], vocab), dtype=torch.float32,
                         device=out_tokens.device)
    return counts.scatter_add_(1, out_tokens, out_valid.to(torch.float32))


def count_tokens(counts: torch.Tensor, ids: torch.Tensor,
                 alive: torch.Tensor | None = None) -> torch.Tensor:
    """counts [B, V] with each row's sampled id [B] counted once more (a
    fused step extends the history the next step penalizes), or only the
    rows where `alive` [B] holds (a K-step window's frozen rows keep
    their counts); exact, as in build_output_counts."""
    add = (torch.ones_like(ids, dtype=torch.float32) if alive is None
           else alive.to(torch.float32))
    return counts.scatter_add(1, ids[:, None], add[:, None])


def apply_penalties(logits: torch.Tensor,  # [B, V] f32
                    counts: torch.Tensor,  # [B, V] f32 output-token frequency
                    freq_pen: torch.Tensor,  # [B] f32
                    pres_pen: torch.Tensor,  # [B] f32
                    rep_pen: torch.Tensor | None = None,  # [B] f32 (1 = off)
                    ) -> torch.Tensor:
    """The OpenAI rule, logit -= freq * count + pres * (count > 0), on the
    raw logits before temperature; `rep_pen` first divides a seen token's
    positive logit by r and multiplies a negative one by r. "Seen" means
    generated: prompt tokens are not penalized."""
    seen = counts > 0
    if rep_pen is not None:
        r = rep_pen[:, None]
        logits = torch.where(seen, torch.where(logits > 0, logits / r, logits * r), logits)
    return logits - freq_pen[:, None] * counts - pres_pen[:, None] * seen.to(logits.dtype)


def apply_logit_bias(logits: torch.Tensor,  # [B, V] f32
                     bias_ids: torch.Tensor,  # [B, K] i64 token ids (0-padded)
                     bias_vals: torch.Tensor,  # [B, K] f32 additive biases (0 = no-op)
                     bias_gated: torch.Tensor,  # [B, K] bool: active only before min_tokens
                     counters: torch.Tensor,  # [B] i64 output-token counter
                     min_toks: torch.Tensor,  # [B] i64 min_tokens per request
                     ) -> torch.Tensor:
    """Sparse additive logit bias (OpenAI `logit_bias`) whose gated slots
    (min_tokens' -1e30 bans on the eos/stop ids) act only while a row's
    counter is below its minimum. Padding and lifted slots add 0. A row's
    slots name each id with at most one user value (TorchEngine._bias_row
    merges repeats) beside at most one ban, which absorbs whatever is added
    before or after it, so the order of the scatter's adds cannot change
    the result."""
    active = ~bias_gated | (counters < min_toks)[:, None]
    vals = torch.where(active, bias_vals, torch.zeros_like(bias_vals))
    return logits.scatter_add(1, bias_ids, vals)


def token_logprobs(logits: torch.Tensor,  # [B, V] f32 raw logits
                   ids: torch.Tensor,  # [B] chosen token per row
                   k: int,  # top-k alternatives to report (0 => chosen only)
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Log-probabilities under the unscaled, unpenalized, unbiased
    distribution (OpenAI semantics: logprobs describe the model, not the
    sampler). Returns (chosen [B] f32, top ids [B, max(k, 1)] i64, top
    logprobs [B, max(k, 1)] f32); with k == 0 the top arrays hold one
    candidate, which the caller ignores.

    The alternatives follow XLA's top_k (the reference's): ids ordered by
    (value descending, id ascending), the first N taken. Equal logits are
    frequent in a bf16 product, and torch.topk leaves both their order and
    which of the ids tied at the N-th value it keeps unspecified. So the
    set is built by that rule on the device (no host read, so a step graph
    captures it): every logit above the N-th value is among topk's; the
    lowest ids of those equal to it come from a second topk, over the
    negated ids of the tied logits. The two lists, sorted by id, then
    stably by value, give the first N. The first alternative is then the
    argmax, the first id of the largest logit, as the greedy sampler picks
    it."""
    kk = max(k, 1)
    v = logits.shape[-1]
    lse = torch.logsumexp(logits, dim=-1)
    chosen = torch.gather(logits, 1, ids[:, None])[:, 0]
    top_vals, top_idx = torch.topk(logits, kk, dim=-1)
    nth = top_vals[:, kk - 1:]
    neg_ids = -torch.arange(v, dtype=torch.int32, device=logits.device)
    # the kk lowest ids equal to the N-th value, ascending (v: no more)
    tied_idx = -torch.topk(torch.where(logits == nth, neg_ids, -v), kk, dim=-1).values
    # id v marks a slot that holds no candidate: topk's own ties, which
    # tied_idx lists, and tied_idx's fill; it sorts after every real id
    cand_idx = torch.cat([torch.where(top_vals > nth, top_idx, v), tied_idx.long()], dim=1)
    cand_vals = torch.cat([top_vals, nth.expand(-1, kk)], dim=1)
    cand_vals = torch.where(cand_idx == v, float("-inf"), cand_vals)
    cand_idx, by_id = torch.sort(cand_idx, dim=-1)
    top_vals, by_value = torch.sort(torch.gather(cand_vals, 1, by_id), dim=-1, descending=True,
                                    stable=True)
    top_idx = torch.gather(cand_idx, 1, by_value[:, :kk])
    top_vals = top_vals[:, :kk]
    return chosen - lse, top_idx, top_vals - lse[:, None]
