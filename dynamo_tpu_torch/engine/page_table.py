"""Host-side paged-KV allocator with content-addressed prefix caching.

Counterpart of dynamo_tpu/engine/page_table.py::PageAllocator (its
Python path, which the JAX package holds its native pool to). The device
holds one flat page pool; this module owns which page belongs to whom:

1. Ref-counted pages: a page backs every sequence that shares its
   prefix (the same chained block hash means the same KV bytes).
2. The prefix cache: full pages are registered under their sequence hash
   (tokens/blocks.py) and later requests reuse the longest cached chain.
   A registered page whose last owner lets go stays cached, in an LRU of
   reclaimable pages, until an allocation evicts it.
3. KV events: every registration emits a `stored` event and every
   eviction a `removed` one, to the `on_event` callback (the KV router's
   feed in the JAX package).

Page 0 is the null page (padding writes land there), never allocated.
The host and disk tiers of the JAX allocator are not ported.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Literal, Optional, Sequence


@dataclass(frozen=True)
class KvEvent:
    """A block stored in or removed from this worker's KV cache."""

    kind: Literal["stored", "removed"]
    #: chained sequence hashes, one per block
    block_hashes: tuple[int, ...]
    #: the parent's sequence hash for "stored" (None at the root)
    parent_hash: Optional[int] = None
    #: the blocks' tokens for "stored" (an indexer rebuilds chains from them)
    token_blocks: tuple[tuple[int, ...], ...] = ()


@dataclass
class PrefixCacheStats:
    queries: int = 0
    hit_tokens: int = 0
    query_tokens: int = 0
    stored_blocks: int = 0
    evicted_blocks: int = 0

    @property
    def hit_rate(self) -> float:
        return self.hit_tokens / self.query_tokens if self.query_tokens else 0.0


class PageAllocator:
    """Free list, refcounts and the prefix cache's LRU over a fixed pool."""

    def __init__(self, num_pages: int, page_size: int,
                 on_event: Optional[Callable[[KvEvent], None]] = None):
        if num_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is the null page)")
        self.num_pages = num_pages
        self.page_size = page_size
        self._on_event = on_event
        self.stats = PrefixCacheStats()
        #: most pages in use at once since boot (updated on each allocation)
        self.watermark = 0
        self._free: list[int] = list(range(num_pages - 1, 0, -1))
        self._refcount: dict[int, int] = {}
        #: registered pages: page -> (seq_hash, parent_hash, tokens)
        self._page_meta: dict[int, tuple[int, Optional[int], tuple[int, ...]]] = {}
        #: registered pages by content: seq_hash -> page
        self._by_hash: dict[int, int] = {}
        #: registered pages no sequence holds, oldest release first
        self._reclaimable: OrderedDict[int, None] = OrderedDict()

    # -- capacity ----------------------------------------------------------

    @property
    def num_free(self) -> int:
        """Pages allocatable now: the free list and the reclaimable cache."""
        return len(self._free) + len(self._reclaimable)

    @property
    def num_active(self) -> int:
        return (self.num_pages - 1) - self.num_free

    def usage(self) -> float:
        return self.num_active / (self.num_pages - 1)

    # -- allocation --------------------------------------------------------

    def allocate(self, n: int) -> Optional[list[int]]:
        """n fresh pages (from the free list, then evicting cached pages
        oldest first), or None when fewer are allocatable."""
        if n > self.num_free:
            return None
        out = []
        for _ in range(n):
            if self._free:
                page = self._free.pop()
            else:
                page, _ = self._reclaimable.popitem(last=False)
                self._evict(page)
            self._refcount[page] = 1
            out.append(page)
        self.watermark = max(self.watermark, self.num_active)
        return out

    def free(self, pages: Sequence[int]) -> None:
        """Drop one reference to each page: a registered page whose last
        reference goes becomes reclaimable (it stays cached), any other
        returns to the free list."""
        for page in pages:
            rc = self._refcount.get(page)
            if rc is None:
                raise ValueError(f"double free of page {page}")
            if rc > 1:
                self._refcount[page] = rc - 1
                continue
            del self._refcount[page]
            if page in self._page_meta:
                self._reclaimable[page] = None
            else:
                self._free.append(page)

    # -- prefix cache ------------------------------------------------------

    def register(self, page: int, seq_hash: int, parent_hash: Optional[int],
                 tokens: tuple[int, ...]) -> None:
        """Content-address a *full* page so later requests can share it.
        A page registered already, or content cached under another page
        (two sequences computed the same block at once), stays as it is."""
        if page in self._page_meta:
            return
        prev = self._by_hash.get(seq_hash)
        if prev is not None and prev != page:
            return
        self._by_hash[seq_hash] = page
        self._page_meta[page] = (seq_hash, parent_hash, tokens)
        self.stats.stored_blocks += 1
        self._emit(KvEvent("stored", (seq_hash,), parent_hash, (tokens,)))

    def lookup(self, seq_hashes: Sequence[int]) -> list[int]:
        """The pages of the longest cached prefix of `seq_hashes`, each
        with a reference acquired."""
        pages = []
        for h in seq_hashes:
            page = self._by_hash.get(h)
            if page is None:
                break
            self._acquire(page)
            pages.append(page)
        self.stats.queries += 1
        self.stats.query_tokens += len(seq_hashes) * self.page_size
        self.stats.hit_tokens += len(pages) * self.page_size
        return pages

    def match_length(self, seq_hashes: Sequence[int]) -> int:
        """The cached prefix's length in blocks, acquiring nothing."""
        n = 0
        for h in seq_hashes:
            if h not in self._by_hash:
                break
            n += 1
        return n

    def clear_cache(self) -> int:
        """Evict every reclaimable page (oldest first) to the free list;
        returns how many."""
        n = 0
        while self._reclaimable:
            page, _ = self._reclaimable.popitem(last=False)
            self._evict(page)
            self._free.append(page)
            n += 1
        return n

    # -- internals ---------------------------------------------------------

    def _acquire(self, page: int) -> None:
        rc = self._refcount.get(page, 0)
        if rc == 0:
            self._reclaimable.pop(page, None)
        self._refcount[page] = rc + 1

    def _evict(self, page: int) -> None:
        seq_hash, _, _ = self._page_meta.pop(page)
        del self._by_hash[seq_hash]
        self.stats.evicted_blocks += 1
        self._emit(KvEvent("removed", (seq_hash,)))

    def _emit(self, event: KvEvent) -> None:
        if self._on_event is not None:
            self._on_event(event)
