"""Batched sampling: temperature / top-k / top-p / greedy.

Counterpart of dynamo_tpu/engine/sampling.py::sample and sample_greedy.
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
PRNG, so sampled output matches the reference in distribution only.
"""

from __future__ import annotations

import hashlib
import struct
from typing import Sequence

import torch

_NEG_INF = -1e30

#: static candidate-set bound; per-request top_k is clamped to this
DEFAULT_K_CAP = 64


def _draw_seed(seed: int, counter: int) -> int:
    """One generator seed per (request seed, draw counter). The CPU
    generator keeps 32 bits of a seed, so the pair is hashed into 32."""
    key = struct.pack("<II", seed & 0xFFFFFFFF, counter & 0xFFFFFFFF)
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


def sample(
    logits: torch.Tensor,  # [B, V] f32
    temperature: torch.Tensor,  # [B] f32 (<=0 => greedy)
    top_p: torch.Tensor,  # [B] f32 in (0, 1]
    top_k: torch.Tensor,  # [B] i64 (0 => disabled)
    gumbel: torch.Tensor,  # [B, k_cap] f32 noise (gumbel_noise)
) -> torch.Tensor:  # [B] i64 sampled token ids
    """Sample one token per row; k_cap is gumbel.shape[-1] (clamped to V)."""
    b, v = logits.shape
    k_cap = min(gumbel.shape[-1], v)
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
    sampled_rank = torch.argmax(masked + gumbel[:, :k_cap], dim=-1)
    sampled = torch.gather(cand_idx, 1, sampled_rank[:, None])[:, 0]
    return torch.where(greedy, torch.argmax(logits, dim=-1), sampled)


def sample_greedy(logits: torch.Tensor) -> torch.Tensor:
    """Argmax-only path for batches where every request is greedy."""
    return torch.argmax(logits, dim=-1)
