"""Block-level KV cache with radix-tree prefix sharing, paged layout.

Counterpart of ``distributed_inference_demo_tpu/runtime/kvcache``: the
page-id manager (:class:`PagedKVCacheManager`, radix tree, LRU eviction,
adoption stores), the host block pool and radix tree it is built from,
the host-pool manager (:class:`KVCacheManager`, :class:`KVLease`),
and the config resolution, which do no device work and are copies of
the JAX package's; the device side of the seam (``device.py``: seeds,
stores, block export and adoption as torch index ops) and the
single-request engines' prefix pool behind it (``backend.py``:
:class:`PagedKVBackend`, :func:`make_kv_backend`).

The tiered host/disk store below the pool (``tiered.py``): demotion
on eviction, promotion at admission, chain digests for the gateway.

Layout selection: the ``kv_layout`` engine kwarg / ``--kv-layout`` flag
over the ``DWT_KV_LAYOUT`` env knob over the default ``paged`` — all
three funnel through :func:`resolve_kv_layout`.
"""

import os

from ...ops.quant import KV_DTYPES, resolve_kv_dtype
from .backend import PagedKVBackend, make_kv_backend
from .manager import (DEFAULT_BLOCK_TOKENS, KVCacheManager, KVLease,
                      apply_byte_budget, resolve_kvcache_config)
from .paged import PagedBlockLease, PagedKVCacheManager
from .pool import KVBlockPool
from .radix import RadixTree
from .tiered import (TieredKVStore, make_demote_hook, promote_prefix,
                     resolve_tier_config)

KV_LAYOUTS = ("paged",)

# The message every removed-layout path fails with (the JAX package
# removed the dense host-pool layout; the port never had it)
_DENSE_REMOVED_MSG = (
    "kv_layout='dense' was removed (docs/DESIGN.md §14): the paged "
    "layout is the only layout and needs no flag")


def resolve_kv_layout(kv_layout=None) -> str:
    """``kv_layout`` arg over ``DWT_KV_LAYOUT`` env over "paged"."""
    layout = kv_layout or os.environ.get("DWT_KV_LAYOUT", "") or "paged"
    if layout == "dense":
        raise ValueError(_DENSE_REMOVED_MSG)
    if layout not in KV_LAYOUTS:
        raise ValueError(
            f"unknown kv layout {layout!r}; expected one of {KV_LAYOUTS}")
    return layout


__all__ = ["KVBlockPool", "KVCacheManager", "KVLease", "PagedBlockLease", "PagedKVBackend",
           "PagedKVCacheManager", "RadixTree",
           "apply_byte_budget", "make_kv_backend",
           "resolve_kvcache_config", "resolve_kv_layout", "resolve_kv_dtype",
           "DEFAULT_BLOCK_TOKENS", "KV_LAYOUTS", "KV_DTYPES",
           "TieredKVStore", "make_demote_hook", "promote_prefix",
           "resolve_tier_config"]
