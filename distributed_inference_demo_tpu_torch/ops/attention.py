"""KV-cached multi-head / grouped-query attention as a plain function.

Counterpart of ``distributed_inference_demo_tpu/ops/attention.py``:
``attention`` reads K/V from the caller's cache after the current chunk
was inserted, so prefill (chunk = prompt) and decode (chunk = 1 token) are
one code path.  Supports GQA by head-group broadcast and the bloom family's
ALiBi bias.  This is the path decode steps take (chunks below the flash
hook's ``min_chunk``), as XLA computes it in the reference.

Two forms of the same arithmetic.  With a host ``cache_len`` the read
stops at the valid length (O(length)).  The fixed-shape form
(:func:`attention_at`), which a captured CUDA graph replays, takes the
length as a device scalar: it writes at a device index and reads all
``max_seq`` columns under the causal mask, as the reference does.

A cache may be stored as float8 e4m3 (``kv_cache_dtype``): every write
casts the chunk as the reference does (``ops.quant.cast_kv``) and every
read upcasts to f32.
"""

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from .quant import as_bytes, cast_kv


def alibi_slopes(num_heads: int, device=None) -> torch.Tensor:
    """ALiBi per-head slopes (bloom family), shape [num_heads], float32.
    Made once per (heads, device) and shared read-only, so a forward pays
    no host-to-device copy for them."""
    return _alibi_slopes(num_heads, str(torch.device(device or "cpu")))


@functools.lru_cache(maxsize=None)
def _alibi_slopes(num_heads: int, device: str) -> torch.Tensor:
    def pow2_slopes(n):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start * (start ** i) for i in range(n)]
    if math.log2(num_heads).is_integer():
        slopes = pow2_slopes(num_heads)
    else:
        closest = 2 ** math.floor(math.log2(num_heads))
        slopes = pow2_slopes(closest)
        extra = pow2_slopes(2 * closest)
        slopes += extra[0::2][: num_heads - closest]
    return torch.tensor(slopes, dtype=torch.float32, device=device)


def attention(
    q: torch.Tensor,             # [batch, chunk, num_heads, head_dim]
    k_cache: torch.Tensor,       # [batch, num_kv_heads, max_seq, head_dim]
    v_cache: torch.Tensor,       # [batch, num_kv_heads, max_seq, head_dim]
    q_positions: torch.Tensor,   # [batch, chunk] absolute positions of q tokens
    cache_len: Optional[int],    # valid length, or None (fixed)
    slopes: Optional[torch.Tensor] = None,  # [num_heads] ALiBi, or None
) -> torch.Tensor:
    """Causal attention of the current chunk against the cache, in f32.

    Only the first ``cache_len`` cache columns are read: every column past
    it is masked in the reference, where its probability is exactly 0, so
    the result is the same and decode reads O(cache_len), not O(max_seq).

    ``cache_len`` None is the fixed-shape form: every column is read, and
    the columns past the row's last query position (stale ones, left by
    an earlier call on the same static cache) are masked.  Their scores
    are replaced, so a stale non-finite K cannot leak; a masked
    probability is an exact 0, but ``0 * NaN`` is NaN inside the P V
    product, so stale V columns are zeroed before it.
    Returns [batch, chunk, num_heads, head_dim] in q's dtype.
    """
    b, chunk, nh, hd = q.shape
    nkv = k_cache.shape[1]
    groups = nh // nkv
    fixed = cache_len is None
    if not fixed:
        cache_len = int(cache_len)
        k_cache = k_cache[:, :, :cache_len]
        v_cache = v_cache[:, :, :cache_len]
    cache_len = k_cache.shape[2]
    kf = k_cache.float()
    vf = v_cache.float()

    # 1/sqrt(hd) in f32 as the reference computes it; a Python scalar,
    # so no host-to-device copy (which would synchronize every layer)
    qf = q.float() * float(np.float32(1.0) / np.sqrt(np.float32(hd)))
    qf = qf.reshape(b, chunk, nkv, groups, hd)
    # scores: [b, nkv, groups, chunk, cache_len]
    scores = torch.einsum("bqkgh,bksh->bkgqs", qf, kf)

    kv_pos = torch.arange(cache_len, device=q.device)[None, None, :]
    qpos = q_positions[:, :, None]                               # [b, q, 1]
    # causal: a q token at position p attends to kv positions <= p
    valid = kv_pos <= qpos                                       # [b, q, s]
    mask = valid[:, None, None, :, :]                            # [b,1,1,q,s]
    if fixed:
        # a column no query of its row reaches is stale
        vf = vf.masked_fill(~valid.any(dim=1)[:, None, :, None], 0.0)

    if slopes is not None:
        # ALiBi: bias = -slope * (qpos - kvpos); shape [b, nh, q, s]
        dist = (qpos - kv_pos).float()                           # [b, q, s]
        bias = -slopes.float()[None, :, None, None] * dist[:, None, :, :]
        scores = scores + bias.reshape(b, nkv, groups, chunk, cache_len)

    scores = scores.masked_fill(~mask, -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bksh->bqkgh", probs, vf)
    return out.reshape(b, chunk, nh, hd).to(q.dtype)


def prepare_kv_chunk(k_new: torch.Tensor, v_new: torch.Tensor,
                     k_dtype, v_dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """Validate + cast a projection-layout ``[batch, chunk, nkv, hd]`` K/V
    chunk for a cache write (to float8 as the reference rounds,
    :func:`ops.quant.cast_kv`).  Write contract (the reference's stale-slot
    invariant): a write may land garbage at positions >= the row's valid
    length, provided every position is rewritten before any query attends
    it; it never touches a position below the valid length."""
    if k_new.ndim != 4 or k_new.shape != v_new.shape:
        raise ValueError(
            "KV chunk must be projection-layout [batch, chunk, nkv, hd]; "
            f"got {tuple(k_new.shape)} / {tuple(v_new.shape)}")
    return cast_kv(k_new, k_dtype), cast_kv(v_new, v_dtype)


def attention_at(q, k, v, k_cache, v_cache, positions, start: torch.Tensor,
                 slopes=None) -> torch.Tensor:
    """The fixed-shape cached attention of a decode step: insert the
    chunk's K/V in place at the DEVICE index ``start`` (a 0-d int64
    tensor; ``index_copy_`` along the sequence axis), then attend over
    every cache column (``attention`` with ``cache_len`` None).  No shape
    or host value depends on the length, so a CUDA graph can replay it.
    A float8 cache is written through its bytes (``ops.quant.as_bytes``:
    torch has no float8 ``index_copy_`` on the CPU).
    No host bounds check, unlike :func:`update_kv_cache`: the engine
    bounds every step before its loop (``check_capacity``), and on the
    card an index past the buffer is a device-side error."""
    k, v = prepare_kv_chunk(k, v, k_cache.dtype, v_cache.dtype)
    idx = start.reshape(1) + torch.arange(k.shape[1], device=k.device)
    as_bytes(k_cache).index_copy_(2, idx, as_bytes(k.transpose(1, 2)))
    as_bytes(v_cache).index_copy_(2, idx, as_bytes(v.transpose(1, 2)))
    return attention(q, k_cache, v_cache, positions, None, slopes)


def update_kv_cache(
    k_cache: torch.Tensor,  # [batch, nkv, max_seq, hd] (head-major)
    v_cache: torch.Tensor,
    k_new: torch.Tensor,    # [batch, chunk, nkv, hd] (projection layout)
    v_new: torch.Tensor,
    start: int,             # insert offset
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Insert the chunk's K/V at position ``start`` of every head's plane.

    Writes IN PLACE into the given cache tensors (views of the stacked
    cache, so the caller's ``KVCache`` sees the write) and returns them.
    The reference's ``dynamic_update_slice`` silently clamps an insert
    that runs past the buffer, overwriting valid entries; this raises."""
    k_new, v_new = prepare_kv_chunk(k_new, v_new, k_cache.dtype,
                                    v_cache.dtype)
    start = int(start)
    chunk, max_seq = k_new.shape[1], k_cache.shape[2]
    if start < 0 or start + chunk > max_seq:
        raise ValueError(
            f"KV insert of {chunk} positions at {start} overflows the "
            f"cache capacity {max_seq}")
    k_cache[:, :, start:start + chunk] = k_new.transpose(1, 2)
    v_cache[:, :, start:start + chunk] = v_new.transpose(1, 2)
    return k_cache, v_cache
