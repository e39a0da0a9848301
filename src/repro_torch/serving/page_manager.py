"""Paged KV-cache allocator (own copy of ``repro/serving/page_manager.py``;
DESIGN.md §Serving contract).

Host-side free-list allocator over a fixed pool of fixed-size KV pages
(the MaxText ``page_manager`` pattern).  The device-side cache is one big
``(L, num_pages, page_size, KH, Dh)`` buffer per K/V; each live request
owns a *page table* row — the list of physical page ids its logical
token positions map to (position ``t`` lives in page ``table[t // ps]``
at offset ``t % ps``).

Contract (pinned by tests/test_serving.py and tests/test_torch_serving.py):

  * page 0 is the NULL page — never allocated; unused page-table slots
    point at it, and writes from retired decode slots land there (it is
    never read as live data because reads are masked by ``kv_len``);
  * ``alloc`` is all-or-nothing: either the request gets every page it
    asked for or ``PageError`` is raised and the free list is untouched
    (the scheduler keeps the request queued instead of admitting it);
  * ``release`` returns ALL of a request's pages; after every request
    retires the pool is exactly full again (no leaks) — checked by
    ``check_invariants``.

Admission decisions are host-side control flow, and the page tables the
allocator produces are plain int32 arrays shipped to the decode step as
data.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

NULL_PAGE = 0


class PageError(RuntimeError):
    """Raised when an allocation cannot be satisfied (pool exhausted)."""


def pages_for(n_tokens: int, page_size: int) -> int:
    """Number of pages needed to hold ``n_tokens`` KV entries."""
    return max(1, -(-int(n_tokens) // int(page_size)))


class PageManager:
    """Free-list allocator over ``num_pages`` pages of ``page_size`` tokens.

    ``num_pages`` counts the whole pool INCLUDING the reserved null page,
    so ``num_pages - 1`` pages are actually allocatable.
    """

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 2:
            raise ValueError(f"need >= 2 pages (1 is the null page), "
                             f"got {num_pages}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        # LIFO free list => recently released (cache-warm) pages reused first
        self._free: List[int] = list(range(self.num_pages - 1, 0, -1))
        self._owned: Dict[int, List[int]] = {}

    # -- queries ----------------------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def live_requests(self) -> int:
        return len(self._owned)

    def can_alloc(self, n_tokens: int) -> bool:
        return pages_for(n_tokens, self.page_size) <= len(self._free)

    def pages_of(self, rid: int) -> List[int]:
        return list(self._owned[rid])

    # -- alloc / extend / release -----------------------------------------
    def alloc(self, rid: int, n_tokens: int) -> List[int]:
        """Allocate pages for ``n_tokens`` positions. All-or-nothing."""
        if rid in self._owned:
            raise ValueError(f"request {rid} already holds pages")
        n = pages_for(n_tokens, self.page_size)
        if n > len(self._free):
            raise PageError(f"need {n} pages, only {len(self._free)} free "
                            f"(pool {self.num_pages - 1})")
        pages = [self._free.pop() for _ in range(n)]
        self._owned[rid] = pages
        return list(pages)

    def extend(self, rid: int, new_len: int) -> List[int]:
        """Grow request ``rid`` to cover ``new_len`` tokens; returns the
        newly allocated pages (possibly empty).  All-or-nothing: on
        ``PageError`` the request keeps its current pages."""
        cur = self._owned[rid]
        need = pages_for(new_len, self.page_size) - len(cur)
        if need <= 0:
            return []
        if need > len(self._free):
            raise PageError(f"extend({rid}) needs {need} pages, "
                            f"{len(self._free)} free")
        new = [self._free.pop() for _ in range(need)]
        cur.extend(new)
        return list(new)

    def release(self, rid: int) -> None:
        """Return every page of ``rid`` to the free list."""
        self._free.extend(self._owned.pop(rid))

    # -- invariants --------------------------------------------------------
    def check_invariants(self) -> None:
        """Every non-null page is either free or owned by exactly one
        request; nothing is lost or duplicated."""
        seen = list(self._free)
        for pages in self._owned.values():
            seen.extend(pages)
        if sorted(seen) != list(range(1, self.num_pages)):
            raise AssertionError(
                f"page accounting broken: {sorted(seen)} != "
                f"[1..{self.num_pages - 1}]")

    def table_row(self, rid: int, width: int) -> np.ndarray:
        """Page table row of width ``width``, null-padded."""
        pages = self._owned[rid]
        if len(pages) > width:
            raise ValueError(f"request {rid} holds {len(pages)} pages, "
                             f"table width {width}")
        row = np.full((width,), NULL_PAGE, np.int32)
        row[:len(pages)] = pages
        return row
