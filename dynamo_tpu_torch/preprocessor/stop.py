"""Stop-sequence detection over streaming text.

Counterpart of dynamo_tpu/preprocessor/stop.py. Stop strings can straddle
token boundaries, so the checker holds back the longest suffix of emitted
text that could still begin a stop string.
"""

from __future__ import annotations


class StopChecker:
    def __init__(self, stop_strings: list[str]):
        self.stop_strings = [s for s in stop_strings if s]
        self._held = ""
        self.stopped = False

    def feed(self, delta: str) -> str:
        """Feed a text delta; returns text safe to emit. Sets .stopped when
        a stop string is seen (emitting only the text before it)."""
        if self.stopped:
            return ""
        if not self.stop_strings:
            return delta
        buf = self._held + delta
        first_hit = None
        for s in self.stop_strings:
            idx = buf.find(s)
            if idx != -1 and (first_hit is None or idx < first_hit):
                first_hit = idx
        if first_hit is not None:
            self.stopped = True
            self._held = ""
            return buf[:first_hit]
        # hold back the longest tail that is a proper prefix of a stop string
        hold = 0
        for s in self.stop_strings:
            for k in range(min(len(s) - 1, len(buf)), 0, -1):
                if buf.endswith(s[:k]):
                    hold = max(hold, k)
                    break
        if hold:
            self._held = buf[-hold:]
            return buf[:-hold]
        self._held = ""
        return buf

    def flush(self) -> str:
        """End of stream: release any held text (no stop matched)."""
        out, self._held = self._held, ""
        return out
