"""The host KV cache manager, and the configuration the paged one shares.

Counterpart of ``distributed_inference_demo_tpu/runtime/kvcache/
manager.py``.  :class:`KVCacheManager` ties the host block pool
(``pool.py``) and the block radix tree (``radix.py``) into the
reference's surface:

- ``match(prompt) -> KVLease | None``: the longest cached block prefix,
  capped at ``len(prompt) - 1`` tokens, as a lease that pins the
  matched nodes against eviction until ``release`` (or the ``with``
  form); ``gather`` copies the run out.
- ``store(prompt, keys, values, row)``: a prefilled device cache row's
  full blocks into the pool, with one device-to-host copy for the
  missing tail (blocks already cached are recognized by key).
- ``peek(prompt)``: the match length with no stats, lease or LRU touch.

Eviction is LRU over unpinned leaves, under allocation pressure.  Host
blocks are numpy, as in the reference; numpy has no bfloat16, so a
bf16 (or float8) pool holds the values' bits (``uint16`` / ``uint8``)
and :meth:`KVLease.gather` hands them back as such (a bf16 run as
``comm.wire.Bf16Bits``).  No serving path of either package uses this
pool: the engines' prefix cache is the paged one (``paged.py``).

The default block granularity, the flag-over-env-over-default
resolution of a pool's size and the ``DWT_KVCACHE_BYTES`` ceiling are
shared with the paged manager.

Config knobs (CLI flags override env, 0 disables):
``DWT_KVCACHE_BLOCKS`` (pool size, blocks), ``DWT_KVCACHE_BLOCK_TOKENS``
(granularity, default 16), ``DWT_KVCACHE_BYTES`` (cap: shrinks BLOCKS
to fit when set).
"""

from __future__ import annotations

import threading
from typing import List, Optional

import numpy as np
import torch

from ...telemetry._env import env_int
from ...telemetry.flightrecorder import get_flight_recorder
from .pool import KVBlockPool
from .radix import RadixTree

DEFAULT_BLOCK_TOKENS = 16


def resolve_kvcache_config(num_blocks: Optional[int] = None,
                           block_tokens: Optional[int] = None,
                           default_blocks: int = 0):
    """(num_blocks, block_tokens) from explicit args over env knobs over
    ``default_blocks`` (each engine's own default — the batching
    scheduler defaults ON, the single-request engines default OFF).
    ``None`` means "not specified"; 0 blocks disables the subsystem."""
    if num_blocks is None:
        num_blocks = env_int("DWT_KVCACHE_BLOCKS", default_blocks)
    if block_tokens is None:
        block_tokens = env_int("DWT_KVCACHE_BLOCK_TOKENS",
                               DEFAULT_BLOCK_TOKENS)
    return num_blocks, block_tokens


def apply_byte_budget(num_blocks: int, block_bytes: int) -> int:
    """Shrink ``num_blocks`` to the DWT_KVCACHE_BYTES cap (0 = uncapped).
    Never rounds up — the env cap is a ceiling, not a target."""
    budget = env_int("DWT_KVCACHE_BYTES", 0)
    if budget > 0 and block_bytes > 0:
        num_blocks = min(num_blocks, budget // block_bytes)
    return num_blocks


def _host_dtype(dtype) -> np.dtype:
    """The numpy dtype a host block of ``dtype`` is stored in: its own,
    or the bits of a dtype numpy lacks (bfloat16, float8)."""
    if isinstance(dtype, torch.dtype):
        if dtype == torch.bfloat16:
            return np.dtype(np.uint16)
        if dtype.itemsize == 1 and dtype.is_floating_point:
            return np.dtype(np.uint8)
        return np.dtype(str(dtype).replace("torch.", ""))
    return np.dtype(dtype)


def _to_host(t, dtype) -> np.ndarray:
    """A device slice as a host array for a pool of ``dtype`` (one copy;
    a torch slice is cast to the pool's torch dtype first, as numpy's
    assignment casts a host array)."""
    if not torch.is_tensor(t):
        return np.asarray(t)
    if isinstance(dtype, torch.dtype):
        t = t.to(dtype)
    t = t.detach().contiguous()
    host = _host_dtype(t.dtype)
    if t.dtype == torch.bfloat16 or (t.element_size() == 1
                                     and t.is_floating_point()):
        t = t.view(torch.int16 if t.element_size() == 2 else torch.uint8)
    return t.cpu().numpy().view(host)


class KVLease:
    """A pinned prefix match: ``tokens`` positions of reusable KV.

    The pin (a refcount on the deepest matched radix node) keeps
    eviction from freeing the matched blocks before the caller copies
    them out; stored blocks are never mutated, so that copy is the
    copy-on-write snapshot.  Release promptly: an unreleased lease
    shrinks what eviction may reclaim."""

    def __init__(self, mgr: "KVCacheManager", node, block_ids: List[int],
                 tokens: int):
        self._mgr = mgr
        self._node = node
        self.block_ids = block_ids
        self.tokens = tokens
        self._released = False

    def gather(self):
        """Host ``[L, H, tokens, D]`` K/V run for the matched blocks (a
        bf16 pool's as ``comm.wire.Bf16Bits``).  The copy-out is destined
        for a device cache row, so its bytes count toward
        ``h2d_bytes``."""
        if self._released:
            raise RuntimeError("gather on a released lease")
        k, v = self._mgr.pool.gather(self.block_ids)
        k, v = k[:, :, :self.tokens], v[:, :, :self.tokens]
        if self._mgr.bf16:
            from ...comm.wire import bf16_view
            k, v = bf16_view(k), bf16_view(v)
        with self._mgr._lock:
            self._mgr.stats["h2d_bytes"] += k.nbytes + v.nbytes
        return k, v

    def release(self) -> None:
        if not self._released:
            self._released = True
            self._mgr._release(self._node)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()


def _block_bytes(num_layers, num_kv_heads, block_tokens, head_dim,
                 dtype) -> int:
    return (2 * int(num_layers) * int(num_kv_heads) * int(block_tokens)
            * int(head_dim) * _host_dtype(dtype).itemsize)


class KVCacheManager:
    """Block-level KV cache with radix-tree prefix sharing, host pool.

    ``dtype``: the device cache's dtype (a torch or numpy dtype)."""

    def __init__(self, num_layers: int, num_kv_heads: int, head_dim: int,
                 num_blocks: int, block_tokens: int, dtype):
        num_layers = int(num_layers)
        bt = int(block_tokens)
        num_blocks = apply_byte_budget(
            int(num_blocks),
            _block_bytes(num_layers, num_kv_heads, bt, head_dim, dtype))
        if num_blocks < 1:
            raise ValueError(
                "KVCacheManager needs >= 1 block (0 means: don't build "
                "a manager at all)")
        self.block_tokens = bt
        self.dtype = dtype
        self.bf16 = dtype == torch.bfloat16
        self.pool = KVBlockPool(num_blocks, num_layers, num_kv_heads,
                                bt, head_dim, _host_dtype(dtype))
        self.tree = RadixTree()
        # serializes tree/pool mutation: an engine's thread and /metrics
        # scrapes share one manager
        self._lock = threading.Lock()
        # content mutation epoch: memoized classifications revalidate
        # against it
        self.epoch = 0
        self.stats = {"hits": 0, "misses": 0, "partial_hit_tokens": 0,
                      "stores": 0, "stored_blocks": 0,
                      "evicted_blocks": 0, "h2d_bytes": 0}
        self._flight = get_flight_recorder()

    @classmethod
    def for_model(cls, cfg, num_blocks: int, block_tokens: int,
                  dtype=None) -> Optional["KVCacheManager"]:
        """Build from a ModelConfig (and an optional reduced cache
        dtype: blocks store what the cache holds, so a hit round-trips
        its exact bytes).  None when the ``DWT_KVCACHE_BYTES`` ceiling
        leaves room for less than one block: "cache off", never a
        failed start."""
        dtype = dtype if dtype is not None else cfg.dtype
        block_bytes = _block_bytes(cfg.num_layers, cfg.num_kv_heads,
                                   block_tokens, cfg.head_dim, dtype)
        if apply_byte_budget(int(num_blocks), block_bytes) < 1:
            return None
        return cls(cfg.num_layers, cfg.num_kv_heads, cfg.head_dim,
                   num_blocks, block_tokens, dtype)

    # ------------------------------------------------------------------

    def _block_keys(self, prompt, n_blocks: int):
        bt = self.block_tokens
        return [tuple(int(t) for t in prompt[i * bt:(i + 1) * bt])
                for i in range(n_blocks)]

    def match(self, prompt) -> Optional[KVLease]:
        """Longest cached block-prefix of ``prompt`` (capped at
        ``len(prompt) - 1`` tokens), as a pinned lease, or None."""
        prompt = np.asarray(prompt).reshape(-1)
        max_blocks = (len(prompt) - 1) // self.block_tokens
        if max_blocks < 1:
            # too short to ever reuse a whole block: not a lookup at all
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
                            blocks=len(ids), prompt_len=len(prompt))
        return KVLease(self, node, ids, tokens)

    def peek(self, prompt) -> int:
        """Matched token count with no stats, lease, or LRU touch (the
        walk of ``match``)."""
        prompt = np.asarray(prompt).reshape(-1)
        max_blocks = (len(prompt) - 1) // self.block_tokens
        if max_blocks < 1:
            return 0
        with self._lock:
            ids, _node = self.tree.match(
                self._block_keys(prompt, max_blocks), touch=False)
            return len(ids) * self.block_tokens

    def _release(self, node) -> None:
        with self._lock:
            self.tree.release(node)

    # ------------------------------------------------------------------

    def store(self, prompt, keys_dev, values_dev, row: int = 0) -> int:
        """Cache every full block of ``prompt`` from a prefilled cache
        ``[L, B, H, S, D]`` (row ``row``; torch tensors on any device, or
        host arrays); returns the blocks added.

        Only the missing tail is copied to the host (one slice a store);
        blocks already in the tree are recognized by key.  Under pool
        pressure LRU leaves are evicted to make room; when every leaf is
        leased the tail is not cached."""
        prompt = np.asarray(prompt).reshape(-1)
        bt = self.block_tokens
        n_blocks = len(prompt) // bt
        if n_blocks < 1:
            return 0
        keys = self._block_keys(prompt, n_blocks)
        with self._lock:
            existing_ids, _ = self.tree.match(keys)
            n_existing = len(existing_ids)
        if n_existing >= n_blocks:
            return 0
        # the copy runs outside the lock (it waits for the device), one
        # slice for the whole missing tail, split into blocks below
        lo, hi = n_existing * bt, n_blocks * bt
        k_tail = _to_host(keys_dev[:, row, :, lo:hi, :], self.dtype)
        v_tail = _to_host(values_dev[:, row, :, lo:hi, :], self.dtype)
        with self._lock:
            evicted = 0

            def alloc(j):
                nonlocal evicted
                if j < n_existing:
                    # a concurrent eviction removed blocks classified as
                    # existing (and not copied): cache less
                    return None
                bid = self.pool.alloc()
                while bid is None:
                    freed = self.tree.evict_lru_leaf()
                    if not freed:
                        return None          # everything left is leased
                    self.pool.free(freed)
                    evicted += len(freed)
                    bid = self.pool.alloc()
                o = (j - n_existing) * bt
                self.pool.write(bid, k_tail[:, :, o:o + bt],
                                v_tail[:, :, o:o + bt])
                return bid

            # insert re-walks under the lock: blocks another store added
            # meanwhile are recognized
            _, added = self.tree.insert(keys, alloc)
            self.epoch += 1
            self.stats["stores"] += 1
            self.stats["stored_blocks"] += added
            if evicted:
                self.stats["evicted_blocks"] += evicted
        if evicted:
            self._flight.record("kvcache_evict", blocks=evicted)
        if added:
            self._flight.record("kvcache_admit", blocks=added,
                                tokens=added * bt,
                                prompt_len=len(prompt))
        return added

    # ------------------------------------------------------------------

    def reset_stats(self) -> None:
        with self._lock:
            for k in self.stats:
                self.stats[k] = 0

    def snapshot(self) -> dict:
        """Counters and occupancy for ``/stats`` and the
        ``dwt_kvcache_*`` catalog bridge."""
        with self._lock:
            return dict(self.stats,
                        layout="dense",
                        block_tokens=self.block_tokens,
                        blocks_total=self.pool.num_blocks,
                        blocks_used=self.pool.used_blocks,
                        resident_bytes=self.pool.resident_bytes,
                        device_resident_bytes=0,   # host pool
                        capacity_bytes=self.pool.capacity_bytes,
                        nodes=self.tree.node_count - 1)   # excl. root

    def debug_state(self) -> dict:
        """``GET /debugz`` fragment: occupancy and the LRU picture (a few
        coldest evictable leaves), bounded and read-only."""
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
