"""Host-side paged-KV allocator.

Counterpart of dynamo_tpu/engine/page_table.py::PageAllocator without the
prefix cache (prefix caching is not ported yet) and without the native
pool. With no shared prefixes every page has one owner, so a free list
and the set of pages in use are the whole state. Page 0 is the null page
(padding writes land there) and is never allocated.
"""

from __future__ import annotations

from typing import Optional, Sequence


class PageAllocator:
    """Free list over a fixed page pool."""

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is the null page)")
        self.num_pages = num_pages
        self.page_size = page_size
        self._free: list[int] = list(range(num_pages - 1, 0, -1))
        self._active: set[int] = set()

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_active(self) -> int:
        return len(self._active)

    def allocate(self, n: int) -> Optional[list[int]]:
        """n fresh pages, or None when the pool has fewer free."""
        if n > self.num_free:
            return None
        out = [self._free.pop() for _ in range(n)]
        self._active.update(out)
        return out

    def free(self, pages: Sequence[int]) -> None:
        """Return pages to the free list."""
        for page in pages:
            if page not in self._active:
                raise ValueError(f"double free of page {page}")
            self._active.remove(page)
            self._free.append(page)
