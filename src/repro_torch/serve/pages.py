"""Refcounted page-pool allocator with prefix sharing for the paged serve
path.

The paper's core move is ONE shared, quantized lookup structure serving
many flows with no accuracy trade-off; this module is the same idea one
level up the stack.  Requests whose prompts share a common token prefix
map their prefix pages to shared, read-only entries in the physical page
pool, so N requests with a common K-token prefix pin ~1x instead of Nx
prefix pages.

Two consumers share this allocator:

* ``ContinuousBatcher`` (host-driven) calls :meth:`PagePool.reserve` /
  :meth:`PagePool.release` directly — allocation happens on the host,
  synchronously with slot fill/evict.
* ``DeviceContinuousBatcher`` allocates *inside* its fused jitted step
  (the pool refcounts ride along as a donated ``pref`` array); the host
  side only runs :meth:`PagePool.plan` at wave build (trie lookup, COW
  planning, hold budgeting) and :meth:`PagePool.register_completed` at
  drain.  ``PagePool.ref`` is the host mirror of the device refcounts,
  synced back every ``run()``.

Invariants (pinned by ``tests/test_page_pool.py``):

* ``ref[p]`` equals the number of live reservations whose table contains
  ``p``, plus 1 if ``p`` is cached in the prefix trie — never negative.
* a page is handed out as a fresh ("own") page only while ``ref == 0``;
  own pages of concurrent reservations are disjoint (no double
  allocation).
* copy-on-write never targets a page another reservation or the trie
  can see: the COW destination is a freshly allocated page with
  ``ref == 1``, owned by exactly the reserving request.
* conservation: once every reservation is released,
  ``free + cached == n_pages``.

Sharing semantics:

* only *full* pages of a prompt are trie keys (key = the page's token
  tuple); a request shares the longest chain of full-page matches, but
  never its final prompt token — that token must be re-processed so the
  request's first output logits exist.
* a partial tail match (the next cached page agrees with the prompt for
  ``r < page_size`` more tokens) is taken by **copy-on-write**: the
  request gets a fresh page seeded with a copy of the cached page, skips
  those ``r`` tokens too, and writes its own tokens from offset ``r``
  onward.  Rows beyond ``r`` are stale until overwritten and masked by
  the causal term (see ``nn.attention.paged_decode_attention_block``).
* completed requests *register* their full prompt pages in the trie (a
  cache hold: +1 ref that outlives the request), bounded by
  ``hold_budget`` so cached prefixes can never starve admission;
  under pool pressure, cached leaf pages are released LRU-first.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np


class _Node:
    """One cached full page: its physical id + deeper cached pages."""
    __slots__ = ("pid", "children")

    def __init__(self, pid: int):
        self.pid = pid
        self.children: Dict[Tuple[int, ...], "_Node"] = {}


@dataclasses.dataclass
class PagePlan:
    """Trie-lookup result for one request (no allocation performed)."""
    shared: List[int]      # physical pages of matched full prefix pages
    start: int             # prompt tokens skipped (>= len(shared) * page)
    cow_src: Optional[int]  # cached page to copy for the partial tail
    own: int               # fresh pages the request must allocate
    reg: bool              # register full prompt pages on completion


@dataclasses.dataclass
class Reservation:
    """A host-side allocation: the block table plus its plan."""
    tbl: List[int]         # physical pages, logical order (shared first)
    n_shared: int
    start: int
    cow: Optional[Tuple[int, int]]  # (src cached page, dst own page)
    plen: int
    reg: bool


def page_demand(page_size: int, prompt_len: int, max_tokens: int) -> int:
    """Worst-case pages a request pins while live (reservation rule)."""
    return -(-(prompt_len + max_tokens) // page_size)


class PagePool:
    """Refcounted physical page allocator with optional prefix sharing."""

    def __init__(self, n_pages: int, page_size: int, *,
                 share_prefix: bool = False,
                 hold_budget: Optional[int] = None):
        self.n = int(n_pages)
        self.page = int(page_size)
        self.share_prefix = bool(share_prefix)
        # hard cap on cached pages, enforced at registration time.  The
        # pool doesn't know the slot geometry, so the fallback is only
        # "all but one page" — callers that do know it pass a tighter
        # cap (ServeConfig.hold_budget = pool minus one full slot, so
        # cache holds can never squeeze admission below one worst-case
        # reservation).
        self.hold_budget = (int(hold_budget) if hold_budget is not None
                            else max(0, self.n - 1))
        self.ref = np.zeros(self.n, np.int32)
        self._root: Dict[Tuple[int, ...], _Node] = {}
        # pid -> (parent children dict, key, node); insertion order = LRU
        self._cached: "collections.OrderedDict[int, tuple]" = \
            collections.OrderedDict()
        self._planned = 0  # new cache keys promised this wave
        self.metrics = None  # optional obs Metrics registry
        self.metrics_prefix = "pool"
        self.reset_stats()

    # ----------------------------------------------------------- metrics
    def bind_metrics(self, metrics, prefix: str = "pool") -> None:
        """Mirror allocator activity into an ``obs.Metrics``
        registry: occupancy gauges plus sharing counters (prefix hits,
        COW copies).  The router binds each shard's pool under its own
        prefix so gauges never collide across shards."""
        self.metrics = metrics
        self.metrics_prefix = prefix
        self.observe_occupancy()

    def observe_occupancy(self) -> None:
        """Refresh the occupancy gauges from the current refcounts
        (called after every reserve/release and after the device
        batcher syncs ``pref`` back at drain)."""
        if self.metrics is None:
            return
        p = self.metrics_prefix
        self.metrics.gauge(f"{p}.free_pages").set(self.free_count())
        self.metrics.gauge(f"{p}.cached_pages").set(self.n_cached)
        self.metrics.gauge(f"{p}.live_refs").set(int(self.ref.sum()))

    # ------------------------------------------------------------- stats
    def reset_stats(self):
        """Zero the sharing counters (bench: call after the warm wave)."""
        self.stats = {
            "prompt_page_tokens": 0,  # full-page prompt tokens planned
            "own_prompt_pages": 0,    # distinct non-shared prompt pages
            "shared_tokens": 0,       # prompt tokens skipped via sharing
            "cow_events": 0,
            "plans": 0,
        }
        self._shared_seen: Set[int] = set()

    def prefix_page_counts(self) -> Tuple[int, int]:
        """(full-page prompt tokens planned, distinct pool pages holding
        them) — the raw counts behind :meth:`prefix_tokens_per_page`,
        summable across shards."""
        return (self.stats["prompt_page_tokens"],
                len(self._shared_seen) + self.stats["own_prompt_pages"])

    def prefix_tokens_per_page(self) -> float:
        """Live full-page prompt tokens per distinct pool page holding
        them — 1.0 when nothing is shared, ~N when N requests share one
        prefix (the serve-bench acceptance metric)."""
        tokens, pages = self.prefix_page_counts()
        if pages == 0:
            return 1.0
        return tokens / (self.page * pages)

    # ------------------------------------------------------------- accounting
    def free_count(self) -> int:
        return int((self.ref == 0).sum())

    def page_accounting(self, live_tables=()) -> Dict[str, int]:
        """Partition the pool against external truth: ``free`` (ref 0),
        ``cached`` (held by the prefix trie, no live sharer), ``live``
        (referenced by at least one table in ``live_tables``).  The
        fault/eviction invariant ``free + cached + live == n_pages``
        only holds when every page is exactly one of the three — i.e.
        no reference leaked by a mid-flight eviction."""
        live: Set[int] = set()
        for tbl in live_tables:
            for p in tbl:
                if 0 <= int(p) < self.n:
                    live.add(int(p))
        cached = set(self._cached) - live
        free = {p for p in range(self.n) if self.ref[p] == 0}
        return {"free": len(free), "cached": len(cached),
                "live": len(live),
                "leaked": self.n - len(free) - len(cached) - len(live)}

    def hold_free_pages(self, k: Optional[int] = None) -> np.ndarray:
        """Take one phantom reference on up to ``k`` free pages (all of
        them by default) — the pool-exhaustion injection primitive:
        admission sees zero free pages until :meth:`release_held`.
        Host-side only; the device batcher applies the same +1 to its
        donated ``pref`` copy so the two views stay in sync."""
        free = np.where(self.ref == 0)[0]
        held = free if k is None else free[: int(k)]
        self.ref[held] += 1
        self.observe_occupancy()
        return held

    def release_held(self, pages: np.ndarray) -> None:
        """Drop phantom references taken by :meth:`hold_free_pages`."""
        self.ref[np.asarray(pages, np.int64)] -= 1
        if (self.ref < 0).any():
            raise AssertionError("exhaustion hold released twice")
        self.observe_occupancy()

    @property
    def n_cached(self) -> int:
        return len(self._cached)

    def cached_pages(self) -> Set[int]:
        return set(self._cached)

    def begin_wave(self):
        """Reset the per-wave hold-budget accounting."""
        self._planned = 0

    # ------------------------------------------------------------------ trie
    def _touch(self, pid: int):
        if pid in self._cached:
            self._cached.move_to_end(pid)

    def _lookup(self, prompt: Sequence[int]) -> Tuple[List[int], int,
                                                      Optional[int]]:
        """Longest cached chain for ``prompt`` -> (shared pids, start,
        cow src).  Sharing is clamped to ``plen - 1`` tokens: the final
        prompt token is always re-processed so its logits exist."""
        plen = len(prompt)
        limit = plen - 1
        children = self._root
        shared: List[int] = []
        m = 0
        while (m + 1) * self.page <= limit:
            child = children.get(tuple(prompt[m * self.page:
                                              (m + 1) * self.page]))
            if child is None:
                break
            shared.append(child.pid)
            self._touch(child.pid)
            children = child.children
            m += 1
        start = m * self.page
        rem = tuple(prompt[start:limit])
        best_r, best_pid = 0, None
        for key, child in children.items():
            r = 0
            for a, b in zip(key, rem):
                if a != b:
                    break
                r += 1
            if r > best_r or (r == best_r and r > 0
                              and (best_pid is None or child.pid < best_pid)):
                best_r, best_pid = r, child.pid
        if best_r > 0:
            self._touch(best_pid)
            return shared, start + best_r, best_pid
        return shared, start, None

    def _register(self, prompt: Sequence[int],
                  pages: Sequence[int]) -> List[int]:
        """Install ``prompt``'s full pages into the trie; returns the
        pids actually installed (new cache holds).  Pages whose key is
        already cached — by this request's own shared pages or by a
        same-prefix request that registered first — are left alone.
        ``hold_budget`` is enforced HERE, at the point of truth: the
        plan()-time ``reg`` verdict is only a hint (the host batcher
        re-plans across waves, so promised holds from in-flight
        requests are not always visible to it)."""
        children = self._root
        installed: List[int] = []
        nfp = len(prompt) // self.page
        for i in range(min(nfp, len(pages))):
            key = tuple(prompt[i * self.page:(i + 1) * self.page])
            child = children.get(key)
            if child is None:
                if len(self._cached) >= self.hold_budget:
                    break  # budget reached: deeper pages stay unheld
                child = _Node(int(pages[i]))
                children[key] = child
                self._cached[child.pid] = (children, key, child)
                installed.append(child.pid)
            children = child.children
        return installed

    def _pop_cached_leaf(self, keep: Set[int]) -> Optional[int]:
        """Drop the LRU cached *leaf* page (never a mid-chain page —
        that would orphan deeper cached pages) not in ``keep``."""
        for pid in list(self._cached):
            if pid in keep:
                continue
            parent, key, node = self._cached[pid]
            if node.children:
                continue
            del parent[key]
            del self._cached[pid]
            return pid
        return None

    def ensure_free(self, needed: int, keep: Optional[Set[int]] = None):
        """Release cached pages (LRU leaf-first) until ``needed`` pages
        are free or nothing releasable remains."""
        keep = keep or set()
        while self.free_count() < needed:
            pid = self._pop_cached_leaf(keep)
            if pid is None:
                return
            self.ref[pid] -= 1

    # ------------------------------------------------------------------ plan
    def plan(self, prompt: Sequence[int], max_tokens: int) -> PagePlan:
        """Trie lookup + hold budgeting for one request.  Takes no
        references — the device batcher executes the plan inside its
        fused step; the host path calls :meth:`reserve` instead."""
        plen = len(prompt)
        demand = page_demand(self.page, plen, max_tokens)
        if not self.share_prefix:
            return PagePlan([], 0, None, demand, False)
        shared, start, cow_src = self._lookup(prompt)
        nfp = plen // self.page
        new_keys = nfp - len(shared)
        reg = (len(self._cached) + self._planned + new_keys
               <= self.hold_budget)
        if reg:
            self._planned += new_keys
        own = demand - len(shared)
        return PagePlan(shared, start, cow_src, own, reg)

    def record_plan(self, plan: PagePlan, plen: int):
        """Accumulate the sharing stats for one ADMITTED request.

        Deliberately separate from :meth:`plan`: a FIFO-blocked queue
        head is re-planned on every retry (and re-enqueued entries are
        re-planned next run), so counting at plan time would inflate
        ``prefix_tokens_per_page`` — callers record exactly once, when
        the reservation actually lands in a slot."""
        nfp = plen // self.page
        s = self.stats
        s["plans"] += 1
        s["prompt_page_tokens"] += nfp * self.page
        s["own_prompt_pages"] += nfp - len(plan.shared)
        s["shared_tokens"] += plan.start
        s["cow_events"] += plan.cow_src is not None
        self._shared_seen.update(plan.shared)
        if self.metrics is not None:
            p = self.metrics_prefix
            self.metrics.counter(f"{p}.plans").inc()
            if plan.shared:
                self.metrics.counter(f"{p}.prefix_hits").inc()
                self.metrics.counter(
                    f"{p}.prefix_hit_pages").inc(len(plan.shared))
            if plan.start:
                self.metrics.counter(
                    f"{p}.shared_tokens").inc(plan.start)
            if plan.cow_src is not None:
                self.metrics.counter(f"{p}.cow_events").inc()

    # --------------------------------------------------------------- reserve
    def reserve(self, prompt: Sequence[int],
                max_tokens: int) -> Optional[Reservation]:
        """Allocate a request's whole worst-case footprint (host path).

        Returns ``None`` when the pool cannot cover the own-page demand
        even after releasing cached pages — the caller FIFO-blocks.
        Shared pages get +1 ref; own pages are taken from ``ref == 0``
        lowest-id-first (matching the device step's argsort order).
        """
        plan = self.plan(prompt, max_tokens)
        keep = set(plan.shared)
        if plan.cow_src is not None:
            keep.add(plan.cow_src)
        if self.free_count() < plan.own:
            self.ensure_free(plan.own, keep)
            if self.free_count() < plan.own:
                return None
        own = np.where(self.ref == 0)[0][:plan.own]
        self.ref[own] += 1
        for pid in plan.shared:
            self.ref[pid] += 1
        self.record_plan(plan, len(prompt))  # admitted: count it once
        tbl = plan.shared + [int(p) for p in own]
        cow = None
        if plan.cow_src is not None:
            cow = (plan.cow_src, int(own[0]))
        self.observe_occupancy()
        return Reservation(tbl=tbl, n_shared=len(plan.shared),
                           start=plan.start, cow=cow, plen=len(prompt),
                           reg=plan.reg)

    def release(self, res: Reservation, prompt: Sequence[int],
                register: bool = True):
        """Drop a reservation's references; optionally cache its full
        prompt pages.  Installed pages keep one reference (the trie
        hold); everything else frees when its count reaches zero."""
        tbl = np.asarray(res.tbl, np.int64)
        np.subtract.at(self.ref, tbl, 1)
        if register and res.reg and self.share_prefix:
            installed = self._register(prompt, res.tbl)
            self.ref[installed] += 1
        if (self.ref < 0).any():
            raise AssertionError("page refcount went negative "
                                 f"(tbl={res.tbl})")
        self.observe_occupancy()

    # ----------------------------------------------------- device-side hooks
    def register_completed(self, prompt: Sequence[int],
                           pages: Sequence[int]):
        """Drain-time registration for the device batcher.  The fused
        step already *kept* one reference on every full prompt page of a
        ``reg`` slot at eviction; pages that turn out to be already
        cached (same-prefix duplicates within a wave, or the request's
        own shared pages) get that extra hold released here."""
        if not self.share_prefix:
            return
        installed = set(self._register(prompt, pages))
        for pid in pages:
            if int(pid) not in installed:
                self.ref[int(pid)] -= 1
        if (self.ref < 0).any():
            raise AssertionError("device drain drove a refcount negative "
                                 f"(pages={list(pages)})")
        self.observe_occupancy()
