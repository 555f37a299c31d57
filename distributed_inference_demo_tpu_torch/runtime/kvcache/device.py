"""Device-side copy programs for the block KV cache.

Counterpart of ``distributed_inference_demo_tpu/runtime/kvcache/
device.py``: the row <-> pages seam the engines share, as torch index
ops on the device.  Pools are ``[L, N + 1, H, bt, D]``: ``N`` pages a
table may name, then the drop page (``ops/paged_attention``'s
convention): a write through a sentinel id (``>= N``) lands there,
where the reference's ``mode="drop"`` scatter drops it, and no read
reaches it.  ``num_pages`` (default: the pool's pages less one) is
``N``.

A pool is a full-width tensor (the model's dtype, or float8 e4m3 under
a ``kv_cache_dtype`` cast) or an ``ops.quant.QuantizedKVPages`` whose
leaves share the pool's leading ``[L, N + 1, H, bt]`` axes.  The
quantize / dequantize happens here, at the seam: a seed dequantizes a
quantized run to f32 and casts it to the working cache's dtype, a store
quantizes the full-width run once (``quantize_kv_like``; a float8 pool
takes ``cast_kv``'s rounding).  Both round as the reference's compiled
seam programs do (XLA's reciprocal scales, int4's fused multiply-add),
so the pages and caches are bit-equal to the reference's.  Float8
tensors are indexed through their bytes (``as_bytes``).

Every function writes its destination IN PLACE and returns it: the
working cache a seed fills is a captured CUDA graph's static state, so
its addresses must not change.  Nothing here synchronizes with the
host.
"""

from __future__ import annotations

from typing import Optional

import torch

from ...ops.quant import (FLOAT8, QuantizedKVPages, as_bytes, cast_kv,
                          quantize_kv_like, quantize_kv_pages)


def _leaves(pool):
    return pool.leaves() if isinstance(pool, QuantizedKVPages) else [pool]


def _num_pages(pool, num_pages: Optional[int]) -> int:
    return num_pages if num_pages is not None else pool.shape[1] - 1


def _ids(table, device) -> torch.Tensor:
    return torch.as_tensor(table, dtype=torch.long, device=device)


def _take(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``t[:, idx]``, through the bytes for float8."""
    out = as_bytes(t)[:, idx]
    return out.view(FLOAT8) if t.dtype == FLOAT8 else out


def _put(t: torch.Tensor, idx: torch.Tensor, src: torch.Tensor) -> None:
    """``t[:, idx] = src`` in place, through the bytes for float8."""
    as_bytes(t)[:, idx] = as_bytes(src)


def _drop_ids(table, pool, num_pages: Optional[int]) -> torch.Tensor:
    """The table as scatter targets: a sentinel (or negative) id goes to
    the drop page."""
    n = _num_pages(pool, num_pages)
    ids = _ids(table, _leaves(pool)[0].device)
    return torch.where((ids < 0) | (ids >= n), n, ids)


def _dequantize(g: QuantizedKVPages) -> torch.Tensor:
    """Gathered quantized pages in f32, as the reference's compiled seed
    programs compute them: XLA contracts int4's ``code * scale + zero``
    into one fused multiply-add, rounded once.  In f64 the product of a
    4-bit code and an f32 scale is exact, and so is the sum wherever it
    fits 53 bits (scale and zero within 2^25 of each other), so rounding
    it to f32 rounds once too."""
    if g.bits == 8:
        return g.dequantize(torch.float32)
    codes = torch.stack([g.data & 0xF, g.data >> 4], dim=-1)
    codes = codes.reshape(*codes.shape[:-2], -1).double()
    return (codes * g.scale.double() + g.zero.double()).float()


def _gather_run(pool, idx: torch.Tensor):
    """``[L, n, H, bt, D]`` block run for index row ``idx``: a full-width
    pool's own dtype, a quantized pool's narrow leaves gathered first and
    then dequantized to f32."""
    if isinstance(pool, QuantizedKVPages):
        return _dequantize(pool[:, idx])
    return _take(pool, idx)


def _scatter_run(pool, run: torch.Tensor, table,
                 num_pages: Optional[int]) -> None:
    """Scatter a full-width ``[L, n, H, bt, D]`` run into the pool at the
    table's ids, in place (sentinels drop), quantizing once, here, when
    the pool is narrow."""
    ids = _drop_ids(table, pool, num_pages)
    payload = quantize_kv_like(pool, run, compiled=True)
    for dst, src in zip(_leaves(pool), _leaves(payload)):
        _put(dst, ids, src)


def _to_blocks(cache: torch.Tensor, n: int, bt: int) -> torch.Tensor:
    """Cache columns ``[L, H, n*bt, D]`` as blocks ``[L, n, H, bt, D]``."""
    L, H, _, D = cache.shape
    return cache.reshape(L, H, n, bt, D).permute(0, 2, 1, 3, 4)


def _to_columns(run: torch.Tensor) -> torch.Tensor:
    """Blocks ``[L, n, H, bt, D]`` as cache columns ``[L, 1, H, n*bt, D]``."""
    L, n, H, bt, D = run.shape
    return run.permute(0, 2, 1, 3, 4).reshape(L, 1, H, n * bt, D)


def _write_columns(cache: torch.Tensor, cols: torch.Tensor) -> None:
    """Columns ``[0, m)`` of ``cache`` [L, b, H, S, D] := ``cols`` [L, b,
    H, m, D], cast to the cache's dtype, in place."""
    m = cols.shape[3]
    as_bytes(cache)[:, :, :, :m] = as_bytes(cast_kv(cols, cache.dtype))


def seed_prefix_cache(ck: torch.Tensor, cv: torch.Tensor, pk: torch.Tensor,
                      pv: torch.Tensor):
    """Write a ``[L, b, H, m, D]`` block run into the cache's columns
    ``[0, m)``.  The caller sets the cache's valid length to ``m``;
    columns past it are overwritten by the suffix prefill before any
    query attends them (stale-slot invariant)."""
    _write_columns(ck, pk)
    _write_columns(cv, pv)
    return ck, cv


def seed_row_from_pages(pk, pv, table, *, num_pages: Optional[int] = None):
    """Gather one slot's block table out of the pool into a dense row:
    pages ``[L, N + 1, H, bt, D]`` + table ``[W]`` -> row ``[L, 1, H,
    W*bt, D]`` (f32 for a quantized pool).  Sentinel entries clamp to
    page ``N - 1``, as the reference clamps them: the gathered garbage
    sits at columns past the matched prefix, which the suffix prefill
    rewrites before any query attends them."""
    n = _num_pages(pk, num_pages)
    safe = _ids(table, _leaves(pk)[0].device).clamp(0, n - 1)
    return (_to_columns(_gather_run(pk, safe)),
            _to_columns(_gather_run(pv, safe)))


def seed_cache_from_pages(ck: torch.Tensor, cv: torch.Tensor, pk, pv,
                          table):
    """Gather a matched block run (``table`` [n], real page ids) out of
    the pool into the cache's columns ``[0, n*bt)``, in place: cache
    ``[L, 1, H, S, D]``.  Device to device: a prefix hit moves no byte
    through the host."""
    idx = _ids(table, ck.device)
    _write_columns(ck, _to_columns(_gather_run(pk, idx)))
    _write_columns(cv, _to_columns(_gather_run(pv, idx)))
    return ck, cv


def store_cache_to_pages(pk, pv, ck: torch.Tensor, cv: torch.Tensor, table,
                         start: int, *, num_pages: Optional[int] = None):
    """Scatter the cache's full blocks ``[start, start + n)`` (cache
    ``[L, 1, H, S, D]``) into the pool at ``table``'s ``n`` ids, in
    place.  ``start`` (in blocks) is the tail-only store: blocks the
    radix tree already covers are not written again.  The cache is only
    read."""
    bt = _leaves(pk)[0].shape[3]
    n = len(table)
    cols = slice(start * bt, (start + n) * bt)
    _scatter_run(pk, _to_blocks(ck[:, 0, :, cols], n, bt), table, num_pages)
    _scatter_run(pv, _to_blocks(cv[:, 0, :, cols], n, bt), table, num_pages)
    return pk, pv


def adopt_blocks_into_pages(pk, pv, k_blocks, v_blocks, table, *,
                            num_pages: Optional[int] = None):
    """Scatter block payloads ``[n, L, H, bt, D]`` into the pool at
    ``table``'s ids, in place (sentinels drop).  Payloads of the pool's
    own kind adopt verbatim: a quantized export lands bit-identical
    pages.  A full-width payload into a quantized pool quantizes here;
    into a full-width pool it casts to the pool's dtype."""
    def adopt(pool, blocks):
        quant = isinstance(pool, QuantizedKVPages)
        if quant and not isinstance(blocks, QuantizedKVPages):
            blocks = quantize_kv_pages(blocks.float(), pool.bits,
                                       compiled=True)
        elif not quant and isinstance(blocks, QuantizedKVPages):
            raise ValueError("a quantized payload needs a quantized pool")
        ids = _drop_ids(table, pool, num_pages)
        for dst, src in zip(_leaves(pool), _leaves(blocks)):
            _put(dst, ids, cast_kv(src.movedim(0, 1), dst.dtype))

    adopt(pk, k_blocks)
    adopt(pv, v_blocks)
    return pk, pv


def export_blocks_from_pages(pk, pv, table):
    """Gather block payloads ``[n, L, H, bt, D]`` out of the pool at
    ``table``'s (real) ids: the inverse of :func:`adopt_blocks_into_pages`.
    A quantized pool's narrow leaves come verbatim, as a
    ``QuantizedKVPages`` with block-leading leaves."""
    def export(pool):
        idx = _ids(table, _leaves(pool)[0].device)
        if isinstance(pool, QuantizedKVPages):
            g = pool[:, idx]
            return QuantizedKVPages(
                *[None if t is None else t.movedim(1, 0).contiguous()
                  for t in (g.data, g.scale, g.zero)], bits=pool.bits)
        return _take(pool, idx).movedim(1, 0).contiguous()

    return export(pk), export(pv)


def write_row_to_pages(pk, pv, row_k: torch.Tensor, row_v: torch.Tensor,
                       table, *, num_pages: Optional[int] = None):
    """Scatter a dense row ``[L, 1, H, W*bt, D]`` into the pool at
    ``table``'s ``W`` ids, in place.  Sentinel entries drop their block:
    the caller sentinels the matched prefix (tree-owned, immutable
    pages) and the unallocated tail."""
    bt = _leaves(pk)[0].shape[3]
    W = len(table)
    _scatter_run(pk, _to_blocks(row_k[:, 0], W, bt), table, num_pages)
    _scatter_run(pv, _to_blocks(row_v[:, 0], W, bt), table, num_pages)
    return pk, pv
