"""Fixed-granularity KV block pool: the byte budget, made physical.

Every cached prefix is stored as whole blocks of ``block_tokens`` K/V
positions, host-side, in two preallocated numpy arrays of shape
``[num_blocks, num_layers, num_kv_heads, block_tokens, head_dim]``.
Fixed granularity is what makes sharing work (vLLM's PagedAttention
insight): two prompts that agree on their first N*block_tokens tokens
share the SAME N blocks, refcounted by the radix tree above this pool —
no per-prompt copies, no fragmentation, and the byte budget is exactly
``num_blocks * block_bytes``, enforced by construction rather than by
accounting.

Host-side on purpose: cached prefixes are cold capacity (HBM is the
scarce resource the decode batch and the weights already fight over),
and the device copies in and out ride the engines' existing
``load_prefix``-style programs (one H2D per hit, one D2H per store —
amortized over the prefill dispatches they replace).

The pool knows nothing about tokens or trees: it allocates, frees, and
moves bytes.  ``alloc`` returns ``None`` when empty — the caller (the
manager) decides whether to evict or to skip caching.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


class KVBlockPool:
    """Preallocated host store of fixed-size KV blocks."""

    def __init__(self, num_blocks: int, num_layers: int, num_kv_heads: int,
                 block_tokens: int, head_dim: int, dtype):
        if num_blocks < 1:
            raise ValueError("num_blocks must be >= 1")
        if block_tokens < 1:
            raise ValueError("block_tokens must be >= 1")
        self.num_blocks = num_blocks
        self.block_tokens = block_tokens
        shape = (num_blocks, num_layers, num_kv_heads, block_tokens,
                 head_dim)
        self.dtype = np.dtype(dtype)
        self.keys = np.zeros(shape, self.dtype)
        self.values = np.zeros(shape, self.dtype)
        # K + V for one block — the unit the byte budget counts in
        self.block_bytes = 2 * int(
            np.prod(shape[1:])) * self.dtype.itemsize
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))

    # ------------------------------------------------------------------

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return self.num_blocks - len(self._free)

    @property
    def resident_bytes(self) -> int:
        return self.used_blocks * self.block_bytes

    @property
    def capacity_bytes(self) -> int:
        return self.num_blocks * self.block_bytes

    def alloc(self) -> Optional[int]:
        """One free block id, or None when the pool is exhausted."""
        return self._free.pop() if self._free else None

    def free(self, block_ids) -> None:
        for bid in block_ids:
            if not 0 <= bid < self.num_blocks:
                raise ValueError(f"bad block id {bid}")
            self._free.append(bid)
        if len(self._free) > self.num_blocks:
            raise RuntimeError("double free: pool over capacity")

    # ------------------------------------------------------------------

    def write(self, block_id: int, k: np.ndarray, v: np.ndarray) -> None:
        """Fill one block with ``[L, H, block_tokens, D]`` K/V data."""
        self.keys[block_id] = k
        self.values[block_id] = v

    def gather(self, block_ids):
        """Contiguous ``[L, H, n*block_tokens, D]`` K/V run over blocks
        (the shape engines reshape into their cache rows)."""
        k = self.keys[block_ids]            # [n, L, H, bt, D]
        v = self.values[block_ids]
        n, L, H, bt, D = k.shape
        # [n, L, H, bt, D] -> [L, H, n*bt, D]
        k = np.ascontiguousarray(np.transpose(k, (1, 2, 0, 3, 4))
                                 ).reshape(L, H, n * bt, D)
        v = np.ascontiguousarray(np.transpose(v, (1, 2, 0, 3, 4))
                                 ).reshape(L, H, n * bt, D)
        return k, v
