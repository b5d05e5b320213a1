"""Paged KV-cache bookkeeping: a fixed-size-page allocator + per-slot
page tables + the prefix cache (all host-side; the device-side page
*pool* arrays live in the model cache, see
``models.dense.init_paged_cache``).

Layout contract (shared with ``models.layers`` and
``kernels.paged_attention``):

- The pool holds ``n_pages`` pages of ``page_size`` token rows each,
  per layer: leaves are (L, n_pages, page_size, KV, hd) codes plus
  congruent per-token scale leaves when the cache is quantized.
- **Page 0 is the null page** — never allocated. Page-table entries
  default to 0, so dummy writes (free decode slots, padded prefill rows
  past a slot's table) land there inertly, and dummy reads are causally
  masked. A page is *written* only while exactly one slot maps it
  (refcount 1), so real scatter writes never collide.
- Logical position ``p`` of a slot lives at row ``p % page_size`` of
  physical page ``table[slot, p // page_size]``.

Pages are **refcounted** so they can be shared read-only across slots
(prefix caching, vLLM/SGLang-style): ``alloc`` hands a page out at
refcount 1, ``incref`` adds a mapping (another slot's table entry or a
:class:`PrefixCache` trie node), ``decref`` drops one and frees the page
when the count reaches 0. A shared page is never a scatter-write target:
the first write past a shared boundary goes through
``SlotPageTables.ensure_writable`` which allocates a private replacement
and reports the (src, dst) pair for a device-side page copy
(copy-on-write). Lifecycle: free → owned (rc 1) → shared (rc > 1) →
COW-split (writer gets a private copy, shared rc drops) → free (rc 0).

Pages are fixed-size, so "fragmentation" cannot strand capacity: any
free page satisfies any allocation (``tests/test_paged_cache.py`` pins
this as an allocator property). Allocation order is deterministic
(lowest free page id first) so paged engine runs are reproducible.
"""
from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Tuple

import numpy as np

NULL_PAGE = 0


class PagePool:
    """Host-side refcounting allocator over a fixed set of page ids
    [1, n_pages).

    Invariants (property-tested): a page is never handed out twice
    without an intervening free, frees are exactly-once and only at
    refcount 0, page 0 is never allocated, and
    ``available + in_use == n_pages - 1`` at all times (``in_use`` =
    pages with refcount >= 1).
    """

    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 2:
            raise ValueError(f"need >= 2 pages (page 0 is the reserved "
                             f"null page), got n_pages={n_pages}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.n_pages, self.page_size = n_pages, page_size
        self._free: List[int] = list(range(1, n_pages))  # heap, low id first
        heapq.heapify(self._free)
        self._refs: Dict[int, int] = {}     # page -> refcount (>= 1)
        self.peak_in_use = 0
        self.allocs = 0
        self.frees = 0

    @property
    def available(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return len(self._refs)

    @property
    def total_refs(self) -> int:
        """Sum of refcounts — equals (slot table mappings + prefix-cache
        residencies); pinned by tests/test_prefix_cache_properties.py."""
        return sum(self._refs.values())

    def refcount(self, page: int) -> int:
        return self._refs.get(page, 0)

    def alloc(self) -> int:
        if not self._free:
            raise RuntimeError(
                f"page pool exhausted ({self.n_pages - 1} allocatable "
                f"pages, all in use)")
        page = heapq.heappop(self._free)
        self._refs[page] = 1
        self.allocs += 1
        self.peak_in_use = max(self.peak_in_use, len(self._refs))
        return page

    def incref(self, page: int) -> None:
        """Add a mapping to an allocated page (read-only sharing)."""
        if page not in self._refs:
            raise RuntimeError(f"incref of page {page} that is not "
                               f"allocated")
        self._refs[page] += 1

    def decref(self, page: int) -> bool:
        """Drop one mapping; frees the page (returns True) at refcount 0.
        A page can never be freed while another mapping still references
        it — that is the whole safety argument for sharing."""
        if page not in self._refs:
            raise RuntimeError(f"decref of page {page} that is not "
                               f"allocated (double free or foreign id)")
        self._refs[page] -= 1
        if self._refs[page]:
            return False
        del self._refs[page]
        heapq.heappush(self._free, page)
        self.frees += 1
        return True

    def free(self, page: int) -> None:
        """Exclusive-owner free (the historical API): refcount must be
        exactly 1 — shared pages are released one mapping at a time via
        ``decref``."""
        if page not in self._refs:
            raise RuntimeError(f"freeing page {page} that is not allocated "
                               f"(double free or foreign id)")
        if self._refs[page] != 1:
            raise RuntimeError(
                f"freeing page {page} with refcount {self._refs[page]} "
                f"(still shared; drop mappings via decref)")
        self.decref(page)


class SlotPageTables:
    """Per-slot page tables over a shared ``PagePool``.

    ``table`` is the (n_slots, n_ptab) int32 host array the engine ships
    to the device each step (row per slot, ``NULL_PAGE`` for unallocated
    tail entries). Pages are allocated lazily: the prompt's pages at
    admission, then one page at a time as decode crosses page
    boundaries — resident KV bytes track actual sequence lengths instead
    of the slot-cache's ``n_slots × max_len`` worst case.

    Admission additionally *reserves* the request's worst-case page count
    (prompt + decode budget) without allocating it: ``can_admit`` only
    says yes when unreserved capacity covers the whole budget, so an
    admitted request can never strand mid-decode on an exhausted pool
    (there is no preemption — a stranded slot would deadlock the batch).
    On a prefix hit the reservation counts only the *missed* pages —
    ``pages_for(budget) - hit // page_size`` — since the hit's full
    shared pages arrive already allocated and the one partial shared
    page, if any, needs exactly one COW replacement (the worst-case
    formula would head-of-line block cache-hit requests an undersized
    pool can actually serve; regression-tested in
    ``tests/test_prefix_cache_properties.py``).
    """

    def __init__(self, pool: PagePool, n_slots: int, n_ptab: int):
        self.pool = pool
        self.n_ptab = n_ptab
        self.table = np.full((n_slots, n_ptab), NULL_PAGE, np.int32)
        self._owned: List[List[int]] = [[] for _ in range(n_slots)]
        self._reserved = [0] * n_slots
        # pages a slot maps but does not exclusively own (prefix-shared,
        # refcount > 1): never scatter-write targets until COW-split
        self._shared: List[set] = [set() for _ in range(n_slots)]
        # 1 while an admitted slot still owes a COW replacement page for
        # its partial shared page (counted against pool capacity until
        # ensure_writable allocates it)
        self._cow_pending = [0] * n_slots

    def n_owned(self, slot: int) -> int:
        return len(self._owned[slot])

    def owned_pages(self, slot: int) -> List[int]:
        return list(self._owned[slot])

    def n_shared(self, slot: int) -> int:
        return len(self._shared[slot])

    @property
    def slot_mapped_pages(self) -> int:
        """Distinct pages referenced by live slot tables — the actual
        serving footprint. Shared prefix pages count once; pages retained
        only by the prefix cache don't count at all (they are reported
        separately as cached pages)."""
        pages: set = set()
        for o in self._owned:
            pages.update(o)
        return len(pages)

    def pages_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.pool.page_size)

    @property
    def reserved_unallocated(self) -> int:
        """Pages promised to admitted slots but not yet allocated,
        including pending COW replacement pages."""
        return sum(max(0, r - len(o)) + c
                   for r, o, c in zip(self._reserved, self._owned,
                                      self._cow_pending))

    def can_admit(self, budget_tokens: int, hit_tokens: int = 0) -> bool:
        """Missed-pages admission test: a hit's ``hit_tokens // G`` full
        shared pages are already allocated, so only the remainder (which
        algebraically folds in the +1 COW page for a partial hit) needs
        unreserved pool capacity."""
        need = (self.pages_for(budget_tokens)
                - hit_tokens // self.pool.page_size)
        return self.pool.available - self.reserved_unallocated >= need

    def admit(self, slot: int, n_tokens: int,
              budget_tokens: int = 0) -> None:
        """Allocate the pages covering logical rows [0, n_tokens) and
        reserve enough for ``budget_tokens`` total."""
        self.admit_prefix(slot, [], 0, n_tokens,
                          budget_tokens=budget_tokens)

    def admit_prefix(self, slot: int, shared_pages: List[int],
                     hit_tokens: int, n_tokens: int,
                     budget_tokens: int = 0) -> None:
        """Prefix-aware admission: map ``shared_pages`` (the cached run
        covering prompt rows [0, hit_tokens), refcount-bumped, read-only)
        into the slot's table, then allocate fresh pages for the rest of
        [0, n_tokens). Reserves ``budget_tokens`` worth of pages counting
        only the missed ones (see class docstring)."""
        assert not self._owned[slot], f"slot {slot} already holds pages"
        G = self.pool.page_size
        assert len(shared_pages) == self.pages_for(hit_tokens), \
            (len(shared_pages), hit_tokens, G)
        assert n_tokens >= hit_tokens
        self._reserved[slot] = self.pages_for(max(budget_tokens, n_tokens))
        self._cow_pending[slot] = 1 if hit_tokens % G else 0
        for i, page in enumerate(shared_pages):
            self.pool.incref(page)
            self._owned[slot].append(page)
            self._shared[slot].add(page)
            self.table[slot, i] = page
        for i in range(len(shared_pages), self.pages_for(n_tokens)):
            page = self.pool.alloc()
            self._owned[slot].append(page)
            self.table[slot, i] = page

    def ensure_writable(self, slot: int, pos: int
                        ) -> List[Tuple[int, int]]:
        """Copy-on-write split: if the page holding logical row ``pos``
        is mapped shared, allocate a private replacement, remap the
        slot's table entry, drop the shared mapping, and return the
        [(src, dst)] pair the caller must turn into a device-side page
        copy *before* the step that writes the divergent rows. Returns
        [] when the page is already exclusively owned (or not yet
        allocated). Callers dispatch the copy before releasing any other
        work to the device, so a freed ``src`` reallocated in the same
        plan is still read before its new owner writes it."""
        idx = pos // self.pool.page_size
        if idx >= self.n_owned(slot):
            return []
        src = self._owned[slot][idx]
        if src not in self._shared[slot]:
            return []
        dst = self.pool.alloc()
        self._owned[slot][idx] = dst
        self.table[slot, idx] = dst
        self._shared[slot].discard(src)
        self._cow_pending[slot] = 0
        self.pool.decref(src)
        return [(src, dst)]

    def assert_writable(self, slot: int, start: int, end: int) -> None:
        """Scatter guard: every logical row in [start, end] must land in
        an exclusively-owned page (refcount 1) — a shared page reached
        here means a missing ``ensure_writable`` (COW) call. Unallocated
        tail pages are fine (their writes hit the null page)."""
        G = self.pool.page_size
        top = min(end // G, self.n_owned(slot) - 1)
        for idx in range(start // G, top + 1):
            page = self._owned[slot][idx]
            if (page in self._shared[slot]
                    or self.pool.refcount(page) != 1):
                raise RuntimeError(
                    f"slot {slot} write rows [{start}, {end}] target page "
                    f"{page} (table idx {idx}) with refcount "
                    f"{self.pool.refcount(page)} — shared pages are "
                    f"read-only until COW-split")

    def ensure(self, slot: int, pos: int) -> None:
        """Grow the slot's table so a write at logical row ``pos`` has a
        real page (decode calls this right before each step). Growth
        within the admission reservation cannot fail."""
        idx = pos // self.pool.page_size
        if idx >= self.n_ptab:
            raise RuntimeError(f"slot {slot} position {pos} exceeds the "
                               f"table ({self.n_ptab} pages)")
        if (idx < self.n_owned(slot)
                and self._owned[slot][idx] in self._shared[slot]):
            raise RuntimeError(
                f"slot {slot} write at pos {pos} targets shared page "
                f"{self._owned[slot][idx]} (needs ensure_writable/COW)")
        while self.n_owned(slot) <= idx:
            page = self.pool.alloc()
            self._owned[slot].append(page)
            self.table[slot, self.n_owned(slot) - 1] = page

    def shrink(self, slot: int, n_tokens: int) -> int:
        """Speculative-decode rewind: free owned pages lying wholly past
        logical rows [0, n_tokens) — the page-boundary part of discarding
        rejected draft positions. No device copy is needed for the rows
        themselves: stale KV past a slot's valid length is causally
        masked (q_pos >= kv_pos) and overwritten by the next cycle's
        scatter before it is ever attendable — only the page *table* must
        match a never-drafted run so pool accounting (refcounts,
        can_admit) stays exact. Keeps ``pages_for(n_tokens)`` pages;
        returns the number freed. Refuses to drop shared pages: the
        shrink boundary is always at or past the prompt end (drafts start
        at the last generated token), so prefix-shared prompt pages are
        structurally out of reach — hitting one means a bookkeeping bug."""
        keep = self.pages_for(n_tokens)
        freed = 0
        while self.n_owned(slot) > keep:
            page = self._owned[slot][-1]
            if page in self._shared[slot]:
                raise RuntimeError(
                    f"slot {slot} shrink to {n_tokens} tokens would drop "
                    f"shared page {page} — speculative rewind must never "
                    f"reach prefix-shared prompt pages")
            self._owned[slot].pop()
            self.table[slot, self.n_owned(slot)] = NULL_PAGE
            self.pool.decref(page)
            freed += 1
        return freed

    def release(self, slot: int) -> None:
        """Drop all of the slot's page mappings (exactly once; a page is
        freed only when its last mapping — another slot's or the prefix
        cache's — goes too), drop its reservation, and null its row."""
        for page in self._owned[slot]:
            self.pool.decref(page)
        self._owned[slot] = []
        self._shared[slot].clear()
        self._reserved[slot] = 0
        self._cow_pending[slot] = 0
        self.table[slot] = NULL_PAGE


# ------------------------------------------------------------ prefix cache

class _TrieNode:
    """One cached full page: ``key`` is its page_size-token id tuple,
    ``page`` the pool page holding those tokens' (quantized) KV. Children
    key on the next page's tokens, so a root-to-node path spells a token
    prefix at page granularity."""
    __slots__ = ("key", "page", "children", "parent", "last_used")

    def __init__(self, key, page, parent):
        self.key, self.page, self.parent = key, page, parent
        self.children: dict = {}
        self.last_used = 0


class PrefixCache:
    """Radix/trie index from token-id prefixes to cached page runs
    (vLLM/SGLang-style automatic prefix caching).

    Nodes are *full* pages keyed on their page_size-token chunk; lookup
    walks exact full-page matches and then the longest partial match
    into one child's key (so two prompts diverging mid-page still share
    the cached page up to the COW boundary). The whole trie is keyed on
    ``config_key`` (model/quant digest) so pages can never be served
    across incompatible quantization configs — one engine owns one
    cache, but the key makes the invariant structural.

    Residency: every node holds one pool refcount on its page, taken at
    ``register`` and dropped at eviction — a cached page outlives the
    slot that computed it, and a page a slot still maps can never be
    freed out from under it. Correctness of reuse is exactly the repo's
    golden-fixture concern: attention always reads the *stored*
    (post-quantization) page content, and identical tokens at identical
    positions produce identical codes/scales, so serving a cached page
    is bitwise identical to recomputing it
    (``tests/test_prefix_cache_golden.py``).
    """

    def __init__(self, pool: PagePool, page_size: int, config_key=()):
        if page_size != pool.page_size:
            raise ValueError(f"page_size {page_size} != pool.page_size "
                             f"{pool.page_size}")
        self.pool = pool
        self.page_size = page_size
        self.config_key = tuple(config_key)
        self._roots: Dict[tuple, dict] = {}   # config_key -> children dict
        self._tick = 0
        # metrics (admission-scoped: note() runs once per admitted
        # request, not per head-of-line retry)
        self.lookups = 0
        self.hits = 0
        self.hit_tokens = 0
        self.lookup_tokens = 0
        self.cow_copies = 0
        self.inserted_pages = 0
        self.evicted_pages = 0
        self.resident = 0                     # pages the trie holds a ref on

    # ------------------------------------------------------------- lookup

    def _root(self) -> dict:
        return self._roots.setdefault(self.config_key, {})

    @staticmethod
    def _common(a, b) -> int:
        n = 0
        for x, y in zip(a, b):
            if x != y:
                break
            n += 1
        return n

    def lookup(self, prompt) -> Tuple[int, List[int]]:
        """Longest cached prefix of ``prompt``: (hit_tokens, pages) where
        ``pages`` covers prompt rows [0, hit_tokens) (the last page
        partial when hit_tokens % page_size != 0 — the COW boundary).

        The hit is capped at len(prompt) - 1: at least one prompt token
        must be genuinely prefilled so the first-token logits come from a
        real forward row. Touches matched nodes' LRU stamps."""
        G = self.page_size
        toks = [int(t) for t in prompt]
        cap = len(toks) - 1
        self._tick += 1
        children = self._root()
        hit, pages = 0, []
        while hit + G <= cap:
            node = children.get(tuple(toks[hit:hit + G]))
            if node is None:
                break
            node.last_used = self._tick
            pages.append(node.page)
            hit += G
            children = node.children
        lim = min(cap - hit, G)
        if lim > 0:
            best, best_n = None, 0
            for key, node in children.items():
                n = self._common(key, toks[hit:hit + lim])
                if n > best_n:
                    best, best_n = node, n
            if best is not None:
                best.last_used = self._tick
                pages.append(best.page)
                hit += best_n
        return hit, pages

    def note(self, hit_tokens: int, prompt_tokens: int) -> None:
        """Record one admission's lookup outcome (hit-rate metrics)."""
        self.lookups += 1
        self.lookup_tokens += prompt_tokens
        if hit_tokens:
            self.hits += 1
            self.hit_tokens += hit_tokens

    @property
    def hit_rate(self) -> float:
        """Fraction of admitted prompt tokens served from cache."""
        return (self.hit_tokens / self.lookup_tokens
                if self.lookup_tokens else 0.0)

    # ----------------------------------------------------------- register

    def register(self, prompt, pages: List[int]) -> int:
        """Insert a finished prefill's *full* prompt pages (``pages`` is
        the slot's owned-page run; entries [0, len(prompt) // page_size)
        are used). Called only after the pages' content has landed on
        device (prefill completion), so a later hit reads real KV. The
        partial last prompt page and decode pages stay private — their
        owner keeps writing them. Where a node already exists (another
        request cached the same chunk first) the existing page wins and
        ours stays slot-private. Returns pages newly adopted."""
        G = self.page_size
        toks = [int(t) for t in prompt]
        self._tick += 1
        children = self._root()
        parent = None
        added = 0
        for i in range(len(toks) // G):
            key = tuple(toks[i * G:(i + 1) * G])
            node = children.get(key)
            if node is None:
                node = _TrieNode(key, pages[i], parent)
                children[key] = node
                self.pool.incref(pages[i])
                self.resident += 1
                self.inserted_pages += 1
                added += 1
            node.last_used = self._tick
            parent = node
            children = node.children
        return added

    # ------------------------------------------------------------ evict

    def _walk(self):
        stack = [n for root in self._roots.values()
                 for n in root.values()]
        while stack:
            n = stack.pop()
            yield n
            stack.extend(n.children.values())

    def _drop(self, node: _TrieNode) -> None:
        siblings = (node.parent.children if node.parent is not None
                    else self._root())
        del siblings[node.key]
        self.pool.decref(node.page)
        self.resident -= 1
        self.evicted_pages += 1

    def evict(self, need: int, protect=frozenset()) -> int:
        """Free up to ``need`` cache-only pages, LRU leaves first (leaf
        order keeps every remaining root-to-node path contiguous — a
        lookup never walks across a hole). Only pages whose sole mapping
        is the trie's (refcount 1) are candidates: pages still mapped by
        a live slot, and the ``protect`` set (the run the current
        admission is about to share), are skipped."""
        freed = 0
        while freed < need:
            leaves = [n for n in self._walk()
                      if not n.children
                      and self.pool.refcount(n.page) == 1
                      and n.page not in protect]
            if not leaves:
                break
            self._drop(min(leaves, key=lambda n: n.last_used))
            freed += 1
        return freed

    def make_room(self, tables: SlotPageTables, budget_tokens: int,
                  hit_tokens: int = 0, protect=()) -> bool:
        """Admission-time reclamation: evict cache-only pages until the
        missed-pages reservation fits (or nothing evictable remains).
        Returns the final ``can_admit`` verdict — False means genuine
        head-of-line wait (live slots hold the pages)."""
        if tables.can_admit(budget_tokens, hit_tokens=hit_tokens):
            return True
        need = (tables.pages_for(budget_tokens)
                - hit_tokens // self.page_size
                - (self.pool.available - tables.reserved_unallocated))
        self.evict(need, protect=frozenset(protect))
        return tables.can_admit(budget_tokens, hit_tokens=hit_tokens)

    def shorter_hit(self, tables: SlotPageTables, budget_tokens: int,
                    hit_tokens: int, pages) -> Tuple[int, List[int], bool]:
        """Admission fallback for when ``make_room`` fails while no slot
        is live: no page will ever be freed, and the pages the hit
        protects may be the very ones the reservation needs (a full page
        and a partial one in a pool of four, with three to reserve), so
        waiting would livelock. Retry with a shorter hit — first without
        the partial page, then with none — and return the first that
        fits: (hit_tokens, pages, ok)."""
        full = hit_tokens // self.page_size
        tries = [(0, [])]
        if 0 < full * self.page_size < hit_tokens:
            tries.insert(0, (full * self.page_size, list(pages[:full])))
        for hit, run in tries:
            if self.make_room(tables, budget_tokens, hit_tokens=hit,
                              protect=run):
                return hit, run, True
        return hit_tokens, list(pages), False

    def clear(self) -> int:
        """Drop every cached page (engine teardown / tests): each node's
        pool ref is returned, so a drained engine's pool goes back to
        empty. Returns the number of pages dropped."""
        n = 0
        for node in list(self._walk()):
            self.pool.decref(node.page)
            n += 1
        self._roots.clear()
        self.evicted_pages += n
        self.resident = 0
        return n

    # ------------------------------------------------------------ metrics

    def reset_stats(self) -> None:
        """Zero the counters without touching cache content (the engine's
        warmup/steady-state ``reset()`` hook: a warm cache is server
        state, like compiled code)."""
        self.lookups = self.hits = 0
        self.hit_tokens = self.lookup_tokens = 0
        self.cow_copies = 0
        self.inserted_pages = self.evicted_pages = 0

    def stats(self) -> dict:
        return {"prefix_lookups": self.lookups,
                "prefix_hits": self.hits,
                "prefix_hit_tokens": self.hit_tokens,
                "prefix_hit_rate": self.hit_rate,
                "cow_copies": self.cow_copies,
                "cached_pages": self.resident,
                "prefix_evicted_pages": self.evicted_pages}
