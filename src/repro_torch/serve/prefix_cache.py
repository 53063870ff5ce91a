"""Prefix cache: shared-prefix KV reuse over the paged pool.

A host-side copy of the JAX package's ``serve/prefix_cache.py`` over the
port's :mod:`repro_torch.serve.kv_pages`; the logits snapshot it pins is a
torch tensor on the engine's device.

Multi-tenant traffic repeats prompt prefixes (system prompts, few-shot
headers, chat history).  The paged KV cache already decouples a request's
logical KV from physical placement, so sharing is pure bookkeeping: this
module pins prefilled prompt pages in the :class:`~repro_torch.serve.kv_pages
.PageAllocator` (refcounts) and hands them to later requests whose prompts
share the prefix — block tables point at shared read-only pages, and only
the page straddling the divergence point is copied (copy-on-write, see
:func:`repro_torch.kernels.paged.paged_copy`).

Structure: a **trie keyed by page-sized token chunks**.  Each non-root node
owns one pinned page holding the KV of exactly one full ``page_size`` token
chunk; a path from the root spells out a page-aligned prefix.  A node
additionally stores **full-prompt entries** keyed by the prompt's sub-page
tail: an entry pins the tail page plus the per-row device state needed to
skip prefill entirely (the sampled-from logits of the prompt's last
position, and the row's fixed cache leaves — SSM/conv state for hybrids).
Chunk keys are exact token tuples, not hashes, so there are no collision
cases to reason about.

Hit taxonomy (``Engine._admit_batch`` consumes this):

* **full** — the prompt equals a cached entry's prompt token-for-token.
  Admission skips prefill: shared full pages + a COW copy of the tail page
  + the entry's snapshot restore the row exactly; the first token is
  re-sampled from the cached logits (bit-identical under greedy decoding).
  This is the prefill-FLOPs saving.
* **partial** — a page-aligned prefix matches.  The row's block table
  points at the shared pages and prefill still runs over the whole prompt
  for exactness, but its writes for shared columns are redirected to the
  TRASH page — a pages-written saving that also dedups pool memory.
* **miss** — nothing shared; after prefill the prompt's pages and the
  full-prompt entry are inserted, so the *next* request pays less.

Eviction is **LRU under pool pressure**: the scheduler's ``reclaim`` hook
and admission both evict least-recently-used leaves (entries first, then
childless nodes) until the allocator can satisfy the demand — so the cache
never blocks live work, and composes with preemption (rows are preempted
only once the cache is dry).

Content addressing is host-side and cheap; the pinned device state per
entry is one logits row plus the fixed leaves — small next to the KV pages
themselves, which are shared rather than duplicated.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.serve.kv_pages import PageAllocator

#: provenance strings, re-exported for engine bookkeeping
HIT_FULL = "full"
HIT_PARTIAL = "partial"


@dataclasses.dataclass
class PrefixMatch:
    """One lookup's outcome: the shareable page chain (refs NOT yet taken —
    the scheduler takes them at admit) and, for full hits, the entry whose
    snapshot restores the row without prefill."""
    pages: List[int]                    # shared full pages, prefix order
    tokens: int                         # prompt tokens those pages cover
    full: bool = False
    entry: Optional["_Entry"] = None


class _Entry:
    """A cached full prompt: tail page + device snapshot to skip prefill."""
    __slots__ = ("prompt_len", "tail_page", "logits0", "fixed", "last_used")

    def __init__(self, prompt_len: int, tail_page: Optional[int],
                 logits0, fixed, last_used: int):
        self.prompt_len = prompt_len
        self.tail_page = tail_page      # None when the prompt is page-aligned
        self.logits0 = logits0          # (vocab,) last-position logits row
        #                                 (its own copy, not a batch view)
        self.fixed = fixed              # per-row fixed cache leaves (tree)
        self.last_used = last_used


class _Node:
    """One full page-sized chunk of cached prefix (root: chunk=page=None)."""
    __slots__ = ("chunk", "page", "parent", "children", "entries",
                 "last_used")

    def __init__(self, chunk: Optional[Tuple[int, ...]], page: Optional[int],
                 parent: Optional["_Node"], last_used: int):
        self.chunk = chunk
        self.page = page
        self.parent = parent
        self.children: Dict[Tuple[int, ...], _Node] = {}
        self.entries: Dict[Tuple[int, ...], _Entry] = {}
        self.last_used = last_used


class PrefixCache:
    """Trie of pinned prompt-prefix pages over one :class:`PageAllocator`.

    The engine owns the only references between chunk boundaries, so all
    methods are host-side, single-threaded bookkeeping.
    """

    def __init__(self, allocator: PageAllocator):
        self.alloc = allocator
        self.page_size = allocator.page_size
        self._root = _Node(None, None, None, 0)
        self._tick = 0
        self._nodes = 0
        self._entries = 0
        # counters surfaced via stats() — one admission decision each
        self.lookups = 0
        self.hits_full = 0
        self.hits_partial = 0
        self.misses = 0
        self.inserts = 0
        self.evictions = 0
        self.cached_tokens_served = 0
        self.prefill_tokens_saved = 0
        self.prefill_tokens_computed = 0
        self.pages_write_skipped = 0

    # -- internals -------------------------------------------------------
    def _touch(self) -> int:
        self._tick += 1
        return self._tick

    def _chunks(self, prompt: Sequence[int]):
        page = self.page_size
        toks = list(prompt)
        nfull = len(toks) // page
        full = [tuple(toks[i * page:(i + 1) * page]) for i in range(nfull)]
        return full, tuple(toks[nfull * page:])

    # -- lookup ----------------------------------------------------------
    def match(self, prompt: Sequence[int]) -> Optional[PrefixMatch]:
        """Longest cached page-aligned prefix of ``prompt`` (or the full
        entry).  Pure lookup: takes no refs and bumps no hit counters —
        admission may retry after evictions, so the engine records the
        decision once via :meth:`record_admit`."""
        full_chunks, tail = self._chunks(prompt)
        node, pages = self._root, []
        for chunk in full_chunks:
            child = node.children.get(chunk)
            if child is None:
                break
            node = child
            node.last_used = self._touch()
            pages.append(node.page)
        if len(pages) == len(full_chunks):
            entry = node.entries.get(tail)
            if entry is not None:
                entry.last_used = self._touch()
                return PrefixMatch(pages=pages, tokens=entry.prompt_len,
                                   full=True, entry=entry)
        if pages:
            return PrefixMatch(pages=pages,
                               tokens=len(pages) * self.page_size)
        return None

    def record_admit(self, match: Optional[PrefixMatch],
                     prompt_len: int) -> None:
        """Account one admission decision (exactly once per admitted row)."""
        self.lookups += 1
        if match is None:
            self.misses += 1
            self.prefill_tokens_computed += prompt_len
        elif match.full:
            self.hits_full += 1
            self.cached_tokens_served += prompt_len
            self.prefill_tokens_saved += prompt_len
        else:
            self.hits_partial += 1
            self.cached_tokens_served += match.tokens
            self.pages_write_skipped += len(match.pages)
            self.prefill_tokens_computed += prompt_len

    # -- insertion -------------------------------------------------------
    def insert(self, prompt: Sequence[int], row_pages: Sequence[int],
               logits0, fixed) -> bool:
        """Pin ``prompt``'s pages (taken from the freshly-prefilled row's
        block table) and store its full entry.  Existing chunks/entries are
        deduped — the row keeps its own pages either way.  Returns whether
        anything new was pinned."""
        full_chunks, tail = self._chunks(prompt)
        node, new = self._root, False
        for i, chunk in enumerate(full_chunks):
            child = node.children.get(chunk)
            if child is None:
                page = row_pages[i]
                self.alloc.ref([page])
                child = _Node(chunk, page, node, self._touch())
                node.children[chunk] = child
                self._nodes += 1
                new = True
            else:
                child.last_used = self._touch()
            node = child
        if tail not in node.entries:
            tail_page = None
            if tail:
                tail_page = row_pages[len(full_chunks)]
                self.alloc.ref([tail_page])
            node.entries[tail] = _Entry(len(prompt), tail_page, logits0,
                                        fixed, self._touch())
            self._entries += 1
            new = True
        else:
            node.entries[tail].last_used = self._touch()
        if new:
            self.inserts += 1
        return new

    # -- eviction --------------------------------------------------------
    def _candidates(self):
        """Evictable items: every entry, plus childless+entryless nodes
        (inner chunk pages stay pinned while anything below needs them)."""
        stack = [self._root]
        while stack:
            node = stack.pop()
            for tail, entry in node.entries.items():
                yield (entry.last_used, "entry", node, tail, entry)
            for child in node.children.values():
                if not child.children and not child.entries:
                    yield (child.last_used, "node", child, None, None)
                stack.append(child)

    def evict_one(self) -> bool:
        """Evict the least-recently-used evictable item (one entry or one
        leaf chunk node); returns False when the cache is empty."""
        best = min(self._candidates(), key=lambda c: c[0], default=None)
        if best is None:
            return False
        _, kind, node, tail, entry = best
        if kind == "entry":
            if entry.tail_page is not None:
                self.alloc.free([entry.tail_page])
            del node.entries[tail]
            self._entries -= 1
        else:
            self.alloc.free([node.page])
            del node.parent.children[node.chunk]
            self._nodes -= 1
        self.evictions += 1
        return True

    def reclaim(self, need_pages: int) -> bool:
        """Pool-pressure hook (scheduler + admission): evict LRU items
        until ``need_pages`` are allocatable or the cache is dry.  Returns
        whether any eviction happened (progress)."""
        progress = False
        while not self.alloc.can_alloc(need_pages) and self.evict_one():
            progress = True
        return progress

    def clear(self) -> None:
        """Release every pinned page (cold-cache reset; used by parity
        tests and benchmarks)."""
        while self.evict_one():
            pass

    # -- telemetry -------------------------------------------------------
    @property
    def pinned_pages(self) -> int:
        pinned = self._nodes
        stack = [self._root]
        while stack:
            node = stack.pop()
            pinned += sum(1 for e in node.entries.values()
                          if e.tail_page is not None)
            stack.extend(node.children.values())
        return pinned

    def stats(self) -> Dict[str, object]:
        return {
            "enabled": True,
            "lookups": self.lookups,
            "hits_full": self.hits_full,
            "hits_partial": self.hits_partial,
            "misses": self.misses,
            "inserts": self.inserts,
            "evictions": self.evictions,
            "entries": self._entries,
            "nodes": self._nodes,
            "pinned_pages": self.pinned_pages,
            "cached_tokens_served": self.cached_tokens_served,
            "prefill_tokens_saved": self.prefill_tokens_saved,
            "prefill_tokens_computed": self.prefill_tokens_computed,
            "pages_write_skipped": self.pages_write_skipped,
        }

    @staticmethod
    def disabled_stats() -> Dict[str, object]:
        """The same key set with zeros, for engines running without a
        cache (wave scheduler, ``prefix_cache=False``) — stats consumers
        never branch on key presence."""
        st = {k: 0 for k in PrefixCache(
            PageAllocator(1, 1)).stats()}
        st["enabled"] = False
        return st
