"""Incremental detokenization.

Counterpart of dynamo_tpu/preprocessor/detokenize.py: token-at-a-time
decode over a sliding window, emitting only the stable text delta so
multi-token glyphs render whole.
"""

from __future__ import annotations

from dynamo_tpu_torch.preprocessor.tokenizer import Tokenizer


class DecodeStream:
    def __init__(self, tokenizer: Tokenizer, window: int = 8):
        self.tokenizer = tokenizer
        self.window = window
        self.ids: list[int] = []
        self._emitted = ""

    def step(self, token_id: int) -> str:
        """Feed one token id; returns the newly-stable text delta ('' if the
        glyph is still incomplete)."""
        self.ids.append(token_id)
        tail = self.ids[-self.window:]
        prev_tail_text = self.tokenizer.decode(tail[:-1])
        tail_text = self.tokenizer.decode(tail)
        if tail_text.endswith("�"):
            return ""  # incomplete multi-byte glyph; hold
        if prev_tail_text.endswith("�"):
            # the previous call held text back: take the delta from a full decode
            full = self.tokenizer.decode(self.ids)
            delta = full[len(self._emitted):]
        else:
            delta = tail_text[len(prev_tail_text):]
        self._emitted += delta
        return delta
