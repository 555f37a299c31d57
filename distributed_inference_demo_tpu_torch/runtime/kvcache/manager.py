"""KV-cache configuration shared by the paged manager.

The pieces of ``distributed_inference_demo_tpu/runtime/kvcache/
manager.py`` that the paged layout needs, copied: the default block
granularity, the flag-over-env-over-default resolution of the pool's
size, and the ``DWT_KVCACHE_BYTES`` ceiling.  The host-pool
``KVCacheManager`` itself serves the single-request engines' block
prefix cache and is ported with it, in a later slice.

Config knobs (CLI flags override env, 0 disables):
``DWT_KVCACHE_BLOCKS`` (pool size, blocks), ``DWT_KVCACHE_BLOCK_TOKENS``
(granularity, default 16), ``DWT_KVCACHE_BYTES`` (cap: shrinks BLOCKS
to fit when set).
"""

from __future__ import annotations

from typing import Optional

from ...telemetry._env import env_int

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
