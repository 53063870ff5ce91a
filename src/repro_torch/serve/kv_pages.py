"""Paged KV-cache bookkeeping: page allocator, block tables, and the
host-side continuous-batching scheduler.

KV memory is a pool of fixed-size **pages** (``page_size`` tokens each);
each live request holds a **block table** (its ordered page list), pages are
allocated lazily as decode advances and returned the moment a request
finishes, and capacity is measured in *tokens*.

Everything in this module is host-side numpy: the allocator and
scheduler are plain bookkeeping driven between fused decode chunks, which is
what makes them property-testable without touching a model.  The scheduler's
contract (the JAX package's ``tests/test_kv_pages.py`` pins it there;
``tests/test_torch_serve.py`` holds this copy to the same decisions):

* **no double allocation** — a page leaves the free list exactly once, and
  the reserved NULL/TRASH pages are never handed out;
* **FIFO admission** — requests enter service in submit order (preemption
  requeues at the front, so it can only *re*-order a victim earlier, never
  starve it);
* **pages always return** — eviction and preemption release the exact pages
  allocated, so a drained scheduler (with an empty prefix cache) always
  restores full capacity;
* **capacity is never exceeded** — admission + lazy decode growth never
  allocate past the pool.

Pages are **refcounted** so a prefix cache can pin prefilled prompt pages
while live rows share them read-only: ``alloc`` hands a page out at refcount 1, ``ref`` adds holders,
and ``free`` drops one holder — the page returns to the free list only when
the last holder lets go.  Under pool pressure the scheduler asks the cache
to give pages back first (the ``reclaim`` hook) and preempts live rows only
after the cache is dry, which preserves the pre-cache termination argument
("the oldest row always fits").

Two pages are reserved for the device-side gather/scatter encoding:

* page ``NULL_PAGE`` (0) stays all-zeros and backs every *read* of a column
  outside a row's content (pad columns, empty slots) — gathers from it are
  masked out by attention but must be finite;
* page ``TRASH_PAGE`` (1) absorbs every *write* with no allocated home
  (finished rows mid-chunk, empty slots).  Collisions are harmless because
  nothing ever reads it back.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

#: reserved page ids (see module docstring)
NULL_PAGE = 0
TRASH_PAGE = 1
RESERVED_PAGES = 2


class PagePoolExhausted(RuntimeError):
    """Raised when an allocation cannot be satisfied (caller preempts)."""


def pages_for(tokens: int, page_size: int) -> int:
    """Pages needed to hold ``tokens`` KV entries."""
    return -(-max(tokens, 0) // page_size)


class PageAllocator:
    """Fixed pool of KV pages with a free list and double-alloc guards.

    ``capacity_tokens`` is the *logical* capacity; the pool rounds it up to
    whole pages (plus the two reserved pages, which never count toward
    capacity).
    """

    def __init__(self, capacity_tokens: int, page_size: int):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if capacity_tokens < 1:
            raise ValueError(
                f"capacity_tokens must be >= 1, got {capacity_tokens}")
        self.page_size = int(page_size)
        self.capacity_tokens = int(capacity_tokens)
        self.usable_pages = pages_for(capacity_tokens, page_size)
        self.num_pages = RESERVED_PAGES + self.usable_pages
        self._free: List[int] = list(range(RESERVED_PAGES, self.num_pages))
        self._refs: Dict[int, int] = {}    # live page -> holder count
        self.alloc_count = 0
        self.free_count = 0
        self.high_water_pages = 0

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.usable_pages - len(self._free)

    def utilization(self) -> float:
        return self.used_pages / max(self.usable_pages, 1)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def alloc(self, n: int) -> List[int]:
        if n < 0:
            raise ValueError(f"cannot allocate {n} pages")
        if n > len(self._free):
            raise PagePoolExhausted(
                f"need {n} pages, {len(self._free)} free "
                f"(pool: {self.usable_pages} x {self.page_size} tokens)")
        pages, self._free = self._free[:n], self._free[n:]
        for p in pages:
            if p in self._refs or p < RESERVED_PAGES:
                raise RuntimeError(f"page {p} double-allocated")
            self._refs[p] = 1
        self.alloc_count += n
        self.high_water_pages = max(self.high_water_pages, self.used_pages)
        return pages

    def ref(self, pages: List[int]) -> None:
        """Add one holder to each (already-live) page — used when a row
        shares prefix-cache pages, or the cache pins a row's pages."""
        for p in pages:
            if p not in self._refs:
                raise RuntimeError(f"page {p} ref'd but not live")
            self._refs[p] += 1

    def refcount(self, page: int) -> int:
        return self._refs.get(page, 0)

    def free(self, pages: List[int]) -> None:
        """Drop one holder per page; pages return to the free list (and
        count toward ``free_count``) only when their last holder lets go."""
        released = []
        for p in pages:
            if p not in self._refs:
                raise RuntimeError(
                    f"page {p} freed but not live (double free or foreign)")
            self._refs[p] -= 1
            if self._refs[p] == 0:
                del self._refs[p]
                released.append(p)
        self._free.extend(released)
        self._free.sort()
        self.free_count += len(released)


@dataclasses.dataclass
class RowState:
    """One admitted request's paged-cache view (host bookkeeping only)."""
    rid: int
    slot: int
    length: int                 # tokens with real KV written (prompt + decoded)
    budget_left: int            # tokens still to emit
    pages: List[int]
    admit_seq: int              # admission order, for youngest-first preemption

    def covered(self, page_size: int) -> int:
        return len(self.pages) * page_size


class ContinuousScheduler:
    """Slot + page bookkeeping for continuous batching.

    Drives the policy between fused decode chunks: strict-FIFO admission
    (a queued request enters service only when a slot AND its prompt's pages
    are free), lazy page growth ahead of each chunk, youngest-first
    preemption when the pool runs dry, and eviction the moment a row
    finishes.  The engine consumes it; the property suite drives it with a
    simulated decode.
    """

    def __init__(self, n_slots: int, allocator: PageAllocator):
        self.alloc = allocator
        self.n_slots = n_slots
        self._free_slots = list(range(n_slots))
        self.rows: Dict[int, RowState] = {}      # slot -> RowState
        self._seq = 0
        self.admissions = 0
        self.evictions = 0
        self.preemptions = 0
        # Optional pool-pressure escape hatch: ``reclaim(need_pages)`` asks
        # an external pin holder (the prefix cache) to release pages; it
        # returns True iff it made progress.  Consulted before preemption.
        self.reclaim: Optional[object] = None

    # -- admission ------------------------------------------------------
    @property
    def free_slots(self) -> int:
        return len(self._free_slots)

    def can_admit(self, prompt_len: int, shared_pages: int = 0) -> bool:
        """Whether the queue head fits right now.  ``shared_pages`` counts
        block-table entries served by the prefix cache (already live, so
        they need a ref, not an allocation)."""
        need = pages_for(prompt_len, self.alloc.page_size) - shared_pages
        return bool(self._free_slots) and self.alloc.can_alloc(max(need, 0))

    def admit(self, rid: int, prompt_len: int, budget: int,
              shared_pages: Optional[List[int]] = None) -> RowState:
        """Admit one request.  ``shared_pages`` (prefix-cache hit) become
        the head of the row's block table with a ref taken on each; only
        the remainder is freshly allocated."""
        if not self._free_slots:
            raise RuntimeError("no free slot")
        shared = list(shared_pages or [])
        need = pages_for(prompt_len, self.alloc.page_size) - len(shared)
        if need < 0:
            raise ValueError(
                f"{len(shared)} shared pages exceed the "
                f"{pages_for(prompt_len, self.alloc.page_size)} the prompt needs")
        self.alloc.ref(shared)
        pages = shared + self.alloc.alloc(need)
        slot = self._free_slots.pop(0)
        row = RowState(rid=rid, slot=slot, length=prompt_len,
                       budget_left=budget, pages=pages, admit_seq=self._seq)
        self._seq += 1
        self.rows[slot] = row
        self.admissions += 1
        return row

    # -- decode-chunk growth + preemption --------------------------------
    def ensure_chunk_pages(self, chunk: int) -> List[RowState]:
        """Grow every live row's block table to cover its next ``chunk``
        tokens, preempting youngest-admitted rows when the pool runs dry.

        Returns the preempted rows (pages freed, removed from service) —
        the caller requeues them at the queue *front* so FIFO order over
        first admissions is preserved.  Under pressure the ``reclaim`` hook
        (prefix-cache eviction) runs first and preemption only starts once
        it stops making progress, so cached-but-idle pages are always
        sacrificed before live work.  Oldest-first service plus the
        submit-time capacity check guarantee the oldest row always fits
        once the cache is dry, so this terminates and nothing starves.
        """
        preempted: List[RowState] = []
        for row in sorted(self.rows.values(), key=lambda r: r.admit_seq):
            if row in preempted:
                continue
            while True:
                want = row.length + min(chunk, row.budget_left)
                need = (pages_for(want, self.alloc.page_size)
                        - len(row.pages))
                if need <= 0 or self.alloc.can_alloc(need):
                    if need > 0:
                        row.pages.extend(self.alloc.alloc(need))
                    break
                if self.reclaim is not None and self.reclaim(need):
                    continue
                victim = max(self.rows.values(), key=lambda r: r.admit_seq)
                self._preempt(victim)
                preempted.append(victim)
                if victim is row:
                    break
        return preempted

    def _preempt(self, row: RowState) -> None:
        self.alloc.free(row.pages)
        row.pages = []
        del self.rows[row.slot]
        self._free_slots.append(row.slot)
        self._free_slots.sort()
        self.preemptions += 1

    # -- eviction --------------------------------------------------------
    def evict(self, row: RowState) -> None:
        self.alloc.free(row.pages)
        row.pages = []
        del self.rows[row.slot]
        self._free_slots.append(row.slot)
        self._free_slots.sort()
        self.evictions += 1

    def evict_all(self) -> None:
        for row in list(self.rows.values()):
            self.evict(row)

    @property
    def live(self) -> List[RowState]:
        return sorted(self.rows.values(), key=lambda r: r.admit_seq)


# ---------------------------------------------------------------------------
# Flat gather/scatter index computation (host -> device, numpy int32)
# ---------------------------------------------------------------------------
# The fused chunk step sees the paged pool as one flat token axis of
# ``num_pages * page_size`` entries; these helpers translate block tables
# into per-chunk index arrays.  Columns outside a row's content read the
# NULL page (zeros, masked by attention); writes with no allocated home land
# in the TRASH page (never read back).

def gather_indices(rows: Dict[int, RowState], n_slots: int, width: int,
                   chunk: int, page_size: int) -> np.ndarray:
    """(n_slots, width) flat pool indices right-aligning each row's KV.

    Column ``c`` of slot ``b`` maps to the row's logical token
    ``c - kv_start_b`` where ``kv_start_b = (width - chunk) - length_b``, so
    all live content ends at the shared column ``width - chunk`` and the
    chunk's new columns land at ``[width - chunk, width)``.
    """
    idx = np.zeros((n_slots, width), np.int32)        # default: NULL page
    cols = np.arange(width)
    offset0 = width - chunk
    for slot, row in rows.items():
        logical = cols - (offset0 - row.length)
        valid = (logical >= 0) & (logical < row.length)
        pages = np.asarray(row.pages, np.int64)
        lv = logical[valid]
        idx[slot, valid] = pages[lv // page_size] * page_size + lv % page_size
    return idx


def scatter_indices(rows: Dict[int, RowState], n_slots: int, chunk: int,
                    page_size: int) -> np.ndarray:
    """(n_slots, chunk) flat pool indices for the chunk's new KV columns.

    New token ``j`` of slot ``b`` is logical position ``length_b + j``;
    positions beyond the row's allocated pages (i.e. past its remaining
    budget) and all positions of empty slots write to the TRASH page.
    """
    j = np.arange(chunk)
    idx = np.broadcast_to(TRASH_PAGE * page_size + j % page_size,
                          (n_slots, chunk)).astype(np.int32).copy()
    for slot, row in rows.items():
        logical = row.length + j
        covered = logical < row.covered(page_size)
        pages = np.asarray(row.pages, np.int64)
        lc = logical[covered]
        idx[slot, covered] = pages[lc // page_size] * page_size \
            + lc % page_size
    return idx
