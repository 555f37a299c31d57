"""Paged KV cache manager: bookkeeping for a DEVICE-resident block pool.

The dense-era :class:`KVCacheManager` owns host numpy blocks and moves
bytes (H2D on hit, D2H on store).  This manager owns NO data at all —
the K/V pages live on device in the engine's preallocated
``[L, num_blocks, H, block_tokens, D]`` pool arrays (see
``ops/paged_attention.py``), and what lives here is everything the
device cannot do for itself:

- a free list over page ids (``alloc``/``free``), with LRU leaf eviction
  of unpinned radix-tree entries under pressure;
- the same block-keyed :class:`~.radix.RadixTree` as the dense manager,
  giving longest-partial-prefix matches — but a hit now returns page
  IDS for the caller's block table, not bytes (``dwt_kvcache_h2d_bytes``
  stays 0 by construction);
- copy-FREE stores: :meth:`store_shared` adopts a request's
  already-on-device full-prompt pages into the tree (ownership
  transfer, no copy), so the next shared-prefix request references the
  very same pages.

Ownership rule (the one invariant everything else hangs off): every
allocated page has exactly one owner — the radix tree (freed only by
eviction) or one request (freed at completion).  A request's table may
REFERENCE tree pages (its matched prefix, its adopted stores); those
references are protected by node pins (leases), never by ownership.
Tree pages are immutable: decode writes only land at positions >= the
prompt length, which sit in the request's own private pages.

Thread-safety matches the dense manager: one lock, mutations on the
scheduler thread, ``snapshot``/``debug_state`` from scrape threads.
"""

from __future__ import annotations

import threading
from typing import List, Optional

import numpy as np

from ...telemetry.flightrecorder import get_flight_recorder
from .manager import apply_byte_budget
from .radix import RadixTree


class PagedBlockLease:
    """A pin on a radix node protecting the pages a block table
    references — matched prefixes and adopted stores.  Unlike the dense
    lease (released the moment bytes are copied out), a paged lease
    lives as long as the referencing table does: release at request
    completion, or the evictor may hand the pages to someone else
    mid-decode."""

    def __init__(self, mgr: "PagedKVCacheManager", node,
                 block_ids: List[int], tokens: int):
        self._mgr = mgr
        self._node = node
        self.block_ids = block_ids
        self.tokens = tokens
        self._released = False

    def release(self) -> None:
        if not self._released:
            self._released = True
            self._mgr._release(self._node)


class PagedKVCacheManager:
    """Radix-tree prefix sharing + page-id allocation, zero data moved."""

    def __init__(self, num_layers: int, num_kv_heads: int, head_dim: int,
                 num_blocks: int, block_tokens: int, dtype,
                 kv_dtype: Optional[str] = None):
        from ...ops.quant import (kv_scale_token_head_bytes,
                                  kv_token_head_bytes, resolve_kv_dtype)
        bt = int(block_tokens)
        self.kv_dtype = resolve_kv_dtype(kv_dtype)
        # block_bytes accounts the ACTUAL page width incl. the quantized
        # layouts' scale sidecar — one owner (ops/quant.py) shared with
        # make_kv_backend's byte-budget admission
        token_heads = 2 * int(num_layers) * int(num_kv_heads) * bt
        self.block_bytes = token_heads * kv_token_head_bytes(
            int(head_dim), self.kv_dtype, dtype)
        self.scale_block_bytes = token_heads * kv_scale_token_head_bytes(
            self.kv_dtype)
        num_blocks = apply_byte_budget(int(num_blocks), self.block_bytes)
        if num_blocks < 1:
            raise ValueError(
                "PagedKVCacheManager needs >= 1 block (the paged layout "
                "has no cache-off mode: the pool IS the decode cache)")
        self.num_blocks = num_blocks
        self.block_tokens = bt
        self.tree = RadixTree()
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self._lock = threading.Lock()
        self.epoch = 0
        self.stats = {"hits": 0, "misses": 0, "partial_hit_tokens": 0,
                      "stores": 0, "stored_blocks": 0,
                      "evicted_blocks": 0, "promote_h2d_bytes": 0}
        self._flight = get_flight_recorder()
        # capacity tier below the pool (docs/DESIGN.md §21), installed
        # by the pool OWNER (only it can gather page bytes): the hook
        # receives each eviction victim's (full key path, freed ids)
        # BEFORE those ids are handed back out; ``tier`` makes the
        # tier's occupancy ride this manager's snapshot()/stats surface
        self.demote_hook = None
        self.tier = None

    @classmethod
    def for_model(cls, cfg, num_blocks: int, block_tokens: int,
                  dtype=None,
                  kv_dtype: Optional[str] = None) -> "PagedKVCacheManager":
        dtype = dtype if dtype is not None else cfg.dtype
        return cls(cfg.num_layers, cfg.num_kv_heads, cfg.head_dim,
                   num_blocks, block_tokens, dtype, kv_dtype=kv_dtype)

    # ------------------------------------------------------------------
    # lookup (same tree walk as the dense manager)

    def _block_keys(self, prompt, n_blocks: int):
        bt = self.block_tokens
        return [tuple(int(t) for t in prompt[i * bt:(i + 1) * bt])
                for i in range(n_blocks)]

    def match(self, prompt) -> Optional[PagedBlockLease]:
        """Longest cached block-prefix (capped at ``len(prompt) - 1``
        tokens) as a pinned lease of page IDS — zero bytes move; the
        caller writes the ids into its block table and holds the lease
        until the table dies."""
        prompt = np.asarray(prompt).reshape(-1)
        max_blocks = (len(prompt) - 1) // self.block_tokens
        if max_blocks < 1:
            return None
        with self._lock:
            ids, node = self.tree.match(
                self._block_keys(prompt, max_blocks))
            if not ids:
                self.stats["misses"] += 1
                return None
            self.tree.acquire(node)
            tokens = len(ids) * self.block_tokens
            self.stats["hits"] += 1
            self.stats["partial_hit_tokens"] += tokens
        self._flight.record("kvcache_hit", tokens=tokens,
                            blocks=len(ids), prompt_len=len(prompt),
                            layout="paged")
        return PagedBlockLease(self, node, list(ids), tokens)

    def peek(self, prompt) -> int:
        prompt = np.asarray(prompt).reshape(-1)
        max_blocks = (len(prompt) - 1) // self.block_tokens
        if max_blocks < 1:
            return 0
        with self._lock:
            ids, _ = self.tree.match(
                self._block_keys(prompt, max_blocks), touch=False)
            return len(ids) * self.block_tokens

    def _release(self, node) -> None:
        with self._lock:
            self.tree.release(node)

    # ------------------------------------------------------------------
    # allocation

    def _reclaimable_locked(self) -> int:
        """Tree blocks eviction could eventually free: everything except
        nodes that are pinned or have a pinned descendant (a pin keeps
        its whole ancestor chain non-childless, so those nodes can never
        become evictable leaves while the lease lives)."""
        protected = set()
        stack = [self.tree.root]
        pinned = []
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            if node.refs > 0:
                pinned.append(node)
        for node in pinned:
            while node is not None and id(node) not in protected:
                protected.add(id(node))
                node = node.parent
        out = 0
        stack = [self.tree.root]
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            if id(node) not in protected:
                out += len(node.blocks)
        return out

    def alloc(self, n: int) -> Optional[List[int]]:
        """``n`` free page ids, evicting LRU unpinned tree leaves under
        pressure; None (nothing allocated, nothing evicted) when the
        request is infeasible — feasibility is checked FIRST, so a
        pending admission that cannot be satisfied does not flush the
        prefix cache on every retry."""
        evicted = 0
        demote = []
        with self._lock:
            if len(self._free) + self._reclaimable_locked() < n:
                return None
            while len(self._free) < n:
                path, freed = self.tree.evict_lru_leaf_entry()
                assert freed, "feasibility check promised evictable blocks"
                self._free.extend(freed)
                evicted += len(freed)
                if self.demote_hook is not None:
                    demote.append((path, freed))
            out = [self._free.pop() for _ in range(n)]
            if evicted:
                self.stats["evicted_blocks"] += evicted
                self.epoch += 1
        # demote OUTSIDE the lock (the hook d2h-gathers page bytes and
        # may block) but BEFORE returning the allocation: the caller
        # has not seen the ids yet, so none of the freed pages — some
        # of which are being handed right back out — can be rewritten
        # before the gather dispatch reads them.  The hook never raises
        # (a failed demotion costs cache capacity, not admission).
        for path, freed in demote:
            self.demote_hook(path, freed)
        if evicted:
            self._flight.record("kvcache_evict", blocks=evicted,
                                layout="paged")
        return out

    def free(self, block_ids) -> None:
        """Return request-owned pages to the pool (never tree-owned ones
        — eviction is the only path that frees those)."""
        with self._lock:
            for bid in block_ids:
                if not 0 <= bid < self.num_blocks:
                    raise ValueError(f"bad block id {bid}")
                self._free.append(bid)
            if len(self._free) > self.num_blocks:
                raise RuntimeError("double free: pool over capacity")

    @property
    def used_blocks(self) -> int:
        return self.num_blocks - len(self._free)

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    # ------------------------------------------------------------------
    # store (ownership adoption, no copy)

    def store_shared(self, prompt, block_ids) -> tuple:
        """Insert the prompt's full blocks into the tree by ADOPTING the
        caller's pages: ``block_ids[j]`` must already hold block ``j``'s
        K/V on device.  Blocks the tree already covers are declined (the
        caller keeps owning its redundant copies); adopted ids become
        tree-owned.  ``block_ids[j]`` may be None for blocks the caller
        BELIEVES are already covered (it allocated no page for them —
        the backend's tail-only store): if the tree disagrees (an
        eviction raced the caller's coverage peek), insertion stops
        there — a stored proper prefix is still a valid cache entry,
        and adopting a nonexistent page would corrupt the pool.
        Returns ``(adopted_ids, lease)`` — the lease pins the stored
        path so eviction cannot free adopted (or prefix-matched) pages
        while the caller's table still references them; release it at
        request completion.
        """
        prompt = np.asarray(prompt).reshape(-1)
        bt = self.block_tokens
        n_blocks = len(prompt) // bt
        if n_blocks < 1:
            return [], None
        keys = self._block_keys(prompt, n_blocks)
        block_ids = list(block_ids)
        if len(block_ids) < n_blocks:
            raise ValueError(
                f"store_shared needs one page per full prompt block: "
                f"{len(block_ids)} ids for {n_blocks} blocks")
        adopted: List[int] = []

        with self._lock:
            def adopt(j):
                if block_ids[j] is None:
                    return None          # caller has no page: stop here
                adopted.append(block_ids[j])
                return block_ids[j]

            n_existing, added = self.tree.insert(keys, adopt)
            assert added == len(adopted)
            # pin the deepest node covering the stored prefix: the walk
            # is the same one `match` does, without stats or LRU touch
            ids, node = self.tree.match(keys, touch=False)
            lease = None
            if not node.is_root():
                self.tree.acquire(node)
                lease = PagedBlockLease(self, node, list(ids),
                                        len(ids) * bt)
            self.epoch += 1
            self.stats["stores"] += 1
            self.stats["stored_blocks"] += added
        if added:
            self._flight.record("kvcache_admit", blocks=added,
                                tokens=added * bt,
                                prompt_len=len(prompt), layout="paged")
        return adopted, lease

    # ------------------------------------------------------------------

    def note_promote_h2d(self, nbytes: int) -> None:
        """Count a tier promotion's adopt-scatter bytes: the ONE honest
        exception to the paged layout's h2d_bytes == 0 claim (docs/
        DESIGN.md §21) — the bytes really do cross host -> device."""
        with self._lock:
            self.stats["promote_h2d_bytes"] += int(nbytes)

    def reset_stats(self) -> None:
        with self._lock:
            for k in self.stats:
                self.stats[k] = 0
        if self.tier is not None:
            self.tier.reset_stats()

    def snapshot(self) -> dict:
        """Counters + occupancy for ``/stats`` and the ``dwt_kvcache_*``
        bridge.  ``h2d_bytes`` is 0 by construction on every lookup /
        store path (hits are block-table references, stores ownership
        adoptions); the ONE thing that can move bytes host -> device is
        a §21 tier promotion, counted honestly here.  ``resident_bytes``
        (host) stays 0 — the pool is device HBM, reported as
        ``device_resident_bytes``/``capacity_bytes``; the HOST tier
        reports its own bytes under the ``tier`` sub-dict."""
        with self._lock:
            used = self.num_blocks - len(self._free)
            out = dict(self.stats,
                       layout="paged",
                       h2d_bytes=self.stats["promote_h2d_bytes"],
                       block_tokens=self.block_tokens,
                       blocks_total=self.num_blocks,
                       blocks_used=used,
                       resident_bytes=0,
                       device_resident_bytes=used * self.block_bytes,
                       capacity_bytes=self.num_blocks * self.block_bytes,
                       page_dtype=self.kv_dtype,
                       quant_scale_bytes=used * self.scale_block_bytes,
                       tree_blocks=self.tree.block_count,
                       nodes=self.tree.node_count - 1)
        if self.tier is not None:
            # outside self._lock (lock order: manager -> tier, never
            # nested the other way).  The digest list is the gateway's
            # second-chance routing hint; it rides /stats so the
            # registry prober carries it for free.
            frag = self.tier.snapshot()
            frag["digest"] = self.tier.digest()["digests"]
            out["tier"] = frag
        return out

    def debug_state(self) -> dict:
        snap = self.snapshot()
        with self._lock:
            leaves = sorted(self.tree.evictable_leaves(),
                            key=lambda n: n.last_use)[:8]
            snap["lru_leaves"] = [
                {"blocks": len(n.blocks), "last_use": n.last_use}
                for n in leaves]
            snap["leased_nodes"] = sum(
                1 for n in self._iter_nodes() if n.refs > 0)
        return snap

    def _iter_nodes(self):
        stack = [self.tree.root]
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            yield node
