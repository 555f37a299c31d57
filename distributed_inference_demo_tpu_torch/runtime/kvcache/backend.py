"""The KV backend seam: one prefix-reuse surface over a device page pool.

Counterpart of ``distributed_inference_demo_tpu/runtime/kvcache/
backend.py``.  The two calls an engine makes around its prefill:

- ``seed(ids, cache) -> (start, cache)``: write the longest cached
  block prefix of the (batch-1) prompt into the working cache's leading
  columns, in place; ``start`` is how many positions are now exact, so
  the engine prefills only the suffix;
- ``store(ids, cache) -> None``: cache the prefilled prompt's full
  blocks for the next request that shares them; it reads the cache
  after the prefill and before the first decode step.

:class:`PagedKVBackend` owns a device page pool ``[L, N + 1, H, bt, D]``
(``N`` pages and the drop page, ``kvcache/device.py``) and the page-id
:class:`~.paged.PagedKVCacheManager`.  A seed gathers pages into the
cache on the device and a store scatters cache blocks into freshly
allocated pages: no byte crosses the host boundary either way, and two
prompts that share a prefix share its pages.  After every ``seed`` /
``store`` the leak invariant holds: ``used == tree.block_count`` with no
live lease.

The host / disk tiers below the pool (``tiered.py``) are not ported;
their knobs raise :data:`TIER_LATER`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...telemetry._env import env_int
from .manager import apply_byte_budget, resolve_kvcache_config
from .paged import PagedKVCacheManager

TIER_LATER = "tiered KV is ported in a later slice (ROADMAP A12)"


def refuse_tiers(kv_host_tier_bytes: Optional[int] = None,
                 kv_disk_tier_path: Optional[str] = None) -> None:
    """Raise :data:`TIER_LATER` where a host or disk tier is asked for,
    by argument or by ``DWT_KV_HOST_TIER_BYTES``."""
    if kv_host_tier_bytes is None:
        kv_host_tier_bytes = env_int("DWT_KV_HOST_TIER_BYTES", 0)
    if int(kv_host_tier_bytes) > 0 or kv_disk_tier_path:
        raise NotImplementedError(TIER_LATER)


def _prompt(ids) -> np.ndarray:
    """Row 0 of the prompt ids on the host (a device tensor is copied)."""
    if torch.is_tensor(ids):
        ids = ids.cpu()
    return np.asarray(ids[0])


class PagedKVBackend:
    """Device page pool behind the seam."""

    layout = "paged"

    def __init__(self, cfg, num_blocks: int, block_tokens: int,
                 dtype=None, kv_dtype=None, device=None,
                 kv_host_tier_bytes: Optional[int] = None,
                 kv_disk_tier_path: Optional[str] = None,
                 kv_disk_tier_bytes: Optional[int] = None):
        """``dtype``: the pages' storage cast (float8 e4m3), None for the
        model's dtype; ``kv_dtype``: the page width ("bf16", "int8",
        "int4"); ``device``: where the pool lives.  The tier knobs raise
        (``kv_disk_tier_bytes`` only sizes a disk tier)."""
        from ...ops.quant import alloc_kv_pages, resolve_kv_dtype
        refuse_tiers(kv_host_tier_bytes, kv_disk_tier_path)
        self.kv_dtype = resolve_kv_dtype(kv_dtype)
        self.mgr = PagedKVCacheManager.for_model(
            cfg, num_blocks, block_tokens, dtype=dtype,
            kv_dtype=self.kv_dtype)
        self.block_tokens = self.mgr.block_tokens
        self.num_blocks = self.mgr.num_blocks
        page_dtype = dtype if dtype is not None else cfg.dtype
        # N pages a table may name + the drop page N
        shape = (cfg.num_layers, self.num_blocks + 1, cfg.num_kv_heads,
                 self.block_tokens, cfg.head_dim)
        self._pk = alloc_kv_pages(shape, self.kv_dtype, page_dtype, device)
        self._pv = alloc_kv_pages(shape, self.kv_dtype, page_dtype, device)
        self.tier = None

    def seed(self, ids, cache):
        """Match, then gather out of the pool into ``cache``'s leading
        columns on the device, in place; returns ``(start, KVCache)``
        with the cache's length at ``start`` (0 and the cache as it was
        on a miss, or for a batch of more than one row).  The pin is
        released right after the gather is queued: later writes to those
        pages queue behind it on the same stream."""
        from ...models.base import KVCache
        from .device import seed_cache_from_pages
        if ids.shape[0] != 1:
            return 0, cache
        lease = self.mgr.match(_prompt(ids))
        if lease is None:
            return 0, cache
        m = lease.tokens
        seed_cache_from_pages(cache.keys, cache.values, self._pk, self._pv,
                              lease.block_ids)
        lease.release()
        return m, KVCache(cache.keys, cache.values, m)

    def store(self, ids, cache) -> None:
        """Allocate pages for the prompt's missing tail blocks, scatter
        the matching cache columns into them on the device, and hand them
        to the radix tree.  Blocks the tree already covers (``peek``)
        allocate and write nothing; pages the tree declines are freed
        here.  Caching less is always correct: with every evictable page
        pinned, nothing is stored."""
        from .device import store_cache_to_pages
        if ids.shape[0] != 1:
            return
        prompt = _prompt(ids)
        n_blocks = len(prompt) // self.block_tokens
        if n_blocks < 1:
            return
        covered = self.mgr.peek(prompt) // self.block_tokens
        missing = n_blocks - covered         # >= 1: peek caps at len-1
        block_ids = self.mgr.alloc(missing)
        if block_ids is None:
            return
        store_cache_to_pages(self._pk, self._pv, cache.keys, cache.values,
                             block_ids, covered)
        adopted, lease = self.mgr.store_shared(
            prompt, [None] * covered + list(block_ids))
        if lease is not None:
            lease.release()
        declined = set(block_ids) - set(adopted)
        if declined:
            self.mgr.free(sorted(declined))

    @property
    def pool(self):
        """The (K, V) page pools, ``[L, N + 1, H, bt, D]`` each."""
        return self._pk, self._pv

    @property
    def stats(self) -> dict:
        return self.mgr.stats

    def snapshot(self) -> dict:
        return self.mgr.snapshot()

    def debug_state(self) -> dict:
        return self.mgr.debug_state()

    def reset_stats(self) -> None:
        self.mgr.reset_stats()

    def close(self) -> None:
        """Nothing to release: there is no tier below the pool."""


def make_kv_backend(cfg, kv_cache_blocks: Optional[int],
                    kv_block_tokens: Optional[int], *, layout: str,
                    dtype=None, kv_dtype=None, default_blocks: int = 0,
                    device=None,
                    kv_host_tier_bytes: Optional[int] = None,
                    kv_disk_tier_path: Optional[str] = None,
                    kv_disk_tier_bytes: Optional[int] = None):
    """The one constructor every engine calls: resolve the block-count /
    block-tokens knobs (argument over env over ``default_blocks``) and
    build the pool, or None when it is off (0 blocks, or a
    ``DWT_KVCACHE_BYTES`` ceiling below one block).

    ``kv_dtype`` (argument over ``DWT_KV_DTYPE`` over bf16) picks the page
    width; it does not compose with a ``dtype`` storage cast.  The byte
    budget counts a block at its real page width, scales included."""
    from ...ops.quant import kv_token_head_bytes, resolve_kv_dtype
    if layout != "paged":
        raise ValueError(
            f"unknown kv layout {layout!r}: paged is the only layout "
            "(the dense backend was removed; docs/DESIGN.md §14)")
    kv_dtype = resolve_kv_dtype(kv_dtype)
    if kv_dtype != "bf16" and dtype is not None:
        raise ValueError(
            f"kv_dtype={kv_dtype!r} quantizes the page pool and cannot "
            "compose with a kv_cache_dtype storage cast "
            f"({str(dtype).replace('torch.', '')}); drop one of the two "
            "knobs")
    n_blocks, block_tokens = resolve_kvcache_config(
        kv_cache_blocks, kv_block_tokens, default_blocks=default_blocks)
    if n_blocks < 1:
        return None
    dtype_ = dtype if dtype is not None else cfg.dtype
    block_bytes = (2 * int(cfg.num_layers) * int(cfg.num_kv_heads)
                   * int(block_tokens)
                   * kv_token_head_bytes(int(cfg.head_dim), kv_dtype,
                                         dtype_))
    if apply_byte_budget(n_blocks, block_bytes) < 1:
        return None
    # (the manager applies the same budget to the count it keeps)
    return PagedKVBackend(cfg, n_blocks, block_tokens, dtype=dtype,
                          kv_dtype=kv_dtype, device=device,
                          kv_host_tier_bytes=kv_host_tier_bytes,
                          kv_disk_tier_path=kv_disk_tier_path,
                          kv_disk_tier_bytes=kv_disk_tier_bytes)
