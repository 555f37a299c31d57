"""Paged attention: per-sequence block tables over a device page pool.

Counterpart of ``distributed_inference_demo_tpu/ops/paged_attention.py``.
K/V live in a pool of fixed-size pages ``[pages, nkv, block_tokens, hd]``
(one pool per layer; the engine stacks a leading layer axis) and each
sequence addresses its pages through a block table ``[batch, W]`` of
page ids.  Two sequences sharing a prefix share the same pages.

Sentinel convention: a table entry ``>= num_pages`` means "no page".
Writes through a sentinel, or past the end of the table, DROP.  The
reference drops them with a scatter in ``mode="drop"``; here the pool
holds one page more than it hands out, page ``num_pages``, and dropped
writes land there, which no read reaches and which costs no host sync
(:func:`write_paged_kv`).  Reads CLAMP sentinels into the pool: the
clamped page is causally masked, and pool pages always hold finite
values, so it contributes exact zeros.

A pool is a tensor of the model's dtype (bf16 or f32), a float8 e4m3
tensor (``kv_cache_dtype``: writes cast as the reference rounds,
``ops.quant.cast_kv``, reads upcast to f32) or, for ``kv_dtype``
int8/int4, an ``ops.quant.QuantizedKVPages`` whose leaves share the page
layout: writes quantize once, per token over ``hd``, and every read
dequantizes ``code * scale (+ zero)`` in f32.

Three compute paths with the same numerics as ``ops.attention``:

- :func:`paged_gather_attention`: gather the table's pages into a linear
  view and run ``ops.attention``; the routing's fallback, the "plain"
  backend, and every int4 pool (the reference's deliberate gate);
- :func:`paged_flash_attention`: one query token per row (decode); the
  CUDA kernel ``paged_decode_fwd`` of ``csrc/paged_attention.cu``, which
  replaces the Pallas kernel ``_paged_kernel``;
- :func:`paged_prefill_attention`: a contiguous chunk of queries per row;
  the CUDA kernel ``paged_prefill_fwd``, which replaces
  ``_paged_prefill_kernel``.

Each kernel has three page types: full width (f32 or bf16 pages of q's
dtype), int8 (int8 pages with their f32 scales) and float8 e4m3 (under
f32 or bf16 q).  The two kernel wrappers launch their kernel for CUDA
tensors and raise on anything it does not take (int4 pages included);
for CPU tensors they run their plain PyTorch version
(``paged_flash_attention_plain``, ``paged_prefill_attention_plain``).
Each has integer counts of kernel launches: ``.launches`` (full-width
pages), ``.int8_launches`` and ``.fp8_launches``, one per wrapper call
(a decode call is two CUDA launches, the split pass and its merge); the
prefill wrapper's ``.f32_wide_launches`` counts its f32 launches of
64-row blocks (``ops.flash_attention.f32_rows_per_block`` picks them, as
it does for the flash kernel).

Under f32 and bf16 q alike the decode kernel splits each row's keys at
fixed positions ``KV_SPLIT`` apart (flash-decoding) and merges the
splits' partial softmax states in split order;
:func:`paged_decode_split_plain` is that arithmetic in plain PyTorch,
for the tests.
"""

import ctypes
import functools
import threading
from typing import Optional

import numpy as np
import torch

from .attention import attention, prepare_kv_chunk
from .flash_attention import _sm_count, f32_rows_per_block
from .quant import FLOAT8, QuantizedKVPages, as_bytes, quantize_kv_like

SOURCE = "paged_attention.cu"
# the head dims of the catalog's models, each an instance of the kernels
HEAD_DIMS = (64, 80, 96, 128, 256)
MAX_DECODE_GROUP = 16        # q heads per kv head the decode kernel takes
# keys per split of the decode kernel (both q dtypes), as KV_SPLIT in the
# source, which refuses a launch whose split count does not match it
KV_SPLIT = 128
# query rows a block of the bf16 prefill kernel (PREFILL_ROWS in the
# source; the f32 instances' rows come from f32_rows_per_block)
PREFILL_ROWS = 16
# one prefill kernel call's query rows = chunk * group, padded to 8; the
# reference's cap (its f32 VMEM accumulators crowd the page stream past
# it), kept off the card so the routing matches the reference's; the
# CUDA kernel has no such bound, and on the card the routing takes no
# cap (:func:`make_paged_attn_impl`)
PREFILL_KERNEL_MAX_ROWS = 512
BACKENDS = ("auto", "plain", "cuda")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the page types of the kernels' instances, each with its own entry
# points (paged_{decode,prefill}{"", _int8, _fp8}_fwd) and launch count
PAGE_TYPES = ("full", "int8", "fp8")
_SUFFIX = {"full": "", "int8": "_int8", "fp8": "_fp8"}
_COUNTER = {"full": "launches", "int8": "int8_launches",
            "fp8": "fp8_launches"}
_NEG = -1e30
_count_lock = threading.Lock()   # server threads may launch concurrently


# ---------------------------------------------------------------------------
# writes


def _write_slots(tables: torch.Tensor, positions: torch.Tensor, bt: int,
                 num_pages: int):
    """(page, offset) [b, s] of each chunk token's write: page
    ``tables[b, p // bt]`` at offset ``p % bt``, or the drop page
    ``num_pages`` for a sentinel entry or a position past the table."""
    W = tables.shape[1]
    pidx = positions // bt
    page = torch.gather(tables.long(), 1, pidx.clamp(0, W - 1))
    drop = (pidx < 0) | (pidx >= W) | (page < 0) | (page >= num_pages)
    page = torch.where(drop, num_pages, page)
    return page, positions % bt


def _scatter(k_pages, v_pages, k_new, v_new, page, off) -> None:
    """Advanced indices at dims (0, 2) around the head slice: the indexed
    layout [b, s, nkv, ·] is the projection layout the chunk arrives in.
    A quantized pool takes the chunk quantized ONCE, per token over hd,
    from f32; its data, scale and zero leaves take the same slots.  A
    float8 pool is written through its bytes (``ops.quant.as_bytes``)."""
    quant = isinstance(k_pages, QuantizedKVPages)
    k_new, v_new = prepare_kv_chunk(
        k_new, v_new, torch.float32 if quant else k_pages.dtype,
        torch.float32 if quant else v_pages.dtype)
    for pool, new in ((k_pages, k_new), (v_pages, v_new)):
        for dst, src in zip(_leaves(pool),
                            _leaves(quantize_kv_like(pool, new))):
            as_bytes(dst)[page, :, off] = as_bytes(src)


def write_paged_kv(k_pages, v_pages,
                   k_new: torch.Tensor, v_new: torch.Tensor,
                   tables: torch.Tensor, positions: torch.Tensor, *,
                   num_pages: int) -> None:
    """Scatter the chunk's K/V ([batch, chunk, nkv, hd]) into its pages,
    IN PLACE: the token at position ``p`` of row ``b`` lands in page
    ``tables[b, p // bt]`` at offset ``p % bt``.

    The pool ``[num_pages + 1, nkv, bt, hd]`` has ``num_pages`` pages a
    table may name and one drop page after them.  A sentinel entry
    (``>= num_pages``) and a position past the table (``p // bt >= W``,
    a padded prefill tail running off a full-width table) route the
    write to the drop page; every other page is left as it was, as the
    reference's ``mode="drop"`` scatter leaves it.  A quantized pool
    (``QuantizedKVPages``) is written quantized, every leaf alike.
    Write contract: :func:`ops.attention.prepare_kv_chunk`."""
    if (k_pages.shape[0] != num_pages + 1
            or tuple(v_pages.shape) != tuple(k_pages.shape)):
        raise ValueError(
            f"the page pools must hold num_pages + 1 = {num_pages + 1} "
            f"pages (the last is the drop page); got {tuple(k_pages.shape)}"
            f", {tuple(v_pages.shape)}")
    page, off = _write_slots(tables, positions, k_pages.shape[2], num_pages)
    _scatter(k_pages, v_pages, k_new, v_new, page, off)


# ---------------------------------------------------------------------------
# gather path and the plain versions of the kernels


def _linear_view(pages, tables: torch.Tensor) -> torch.Tensor:
    """[b, nkv, W*bt, hd]: each row's pages in table order, sentinels
    clamped into the pool.  A quantized pool gathers its narrow leaves
    through the table first, then dequantizes the gathered pages to f32
    (the kernels' per-element ``code * scale``)."""
    n, nkv, bt, hd = pages.shape
    b, W = tables.shape
    safe = tables.long().clamp(0, n - 1)
    if isinstance(pages, QuantizedKVPages):
        lin = pages[safe].dequantize(torch.float32)
    else:   # a float8 pool through its bytes
        lin = as_bytes(pages)[safe].view(pages.dtype)
    return lin.permute(0, 2, 1, 3, 4).reshape(b, nkv, W * bt, hd)


def paged_gather_attention(q: torch.Tensor, k_pages, v_pages,
                           tables: torch.Tensor,
                           q_positions: torch.Tensor,
                           slopes: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Gather each row's pages into a linear ``[b, nkv, W*bt, hd]`` view
    and run ``ops.attention`` (causal by ``q_positions`` [b, chunk]).
    Materializes the view (a cache copy per layer): the fallback for
    what the kernels do not take."""
    W, bt = tables.shape[1], k_pages.shape[2]
    return attention(q, _linear_view(k_pages, tables),
                     _linear_view(v_pages, tables), q_positions, W * bt,
                     slopes)


def _paged_plain(q, k_pages, v_pages, tables, q_pos, slopes):
    """The kernels' function in plain PyTorch: query (b, c) at position
    ``q_pos[b, c]`` attends to keys ``s <= q_pos`` of its row's table,
    f32 softmax with masked probabilities exactly 0 and a final division
    by max(l, 1e-30), as ``_paged_kernel`` / ``_paged_prefill_kernel``."""
    b, c, nh, hd = q.shape
    nkv = k_pages.shape[1]
    g = nh // nkv
    kf = _linear_view(k_pages, tables).float()
    vf = _linear_view(v_pages, tables).float()
    qf = q.float() * float(np.float32(1.0) / np.sqrt(np.float32(hd)))
    s = torch.einsum("bckgd,bksd->bkgcs", qf.reshape(b, c, nkv, g, hd), kf)
    kv_pos = torch.arange(kf.shape[2], device=q.device)
    dist = (q_pos.long()[:, :, None] - kv_pos).float()       # [b, c, S]
    valid = (dist >= 0)[:, None, None]                      # [b,1,1,c,S]
    if slopes is not None:
        s = s - (slopes.float().reshape(nkv, g)[None, :, :, None, None]
                 * dist[:, None, None])
    s = s.masked_fill(~valid, _NEG)
    p = torch.where(valid, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    out = torch.einsum("bkgcs,bksd->bckgd", p, vf)
    denom = p.sum(-1).clamp_min(1e-30).permute(0, 3, 1, 2)   # [b, c, k, g]
    return (out / denom[..., None]).reshape(b, c, nh, hd).to(q.dtype)


def paged_flash_attention_plain(q, k_pages, v_pages, tables, kv_lens,
                                slopes=None) -> torch.Tensor:
    """Plain version of the decode kernel: ``q`` [b, 1, nh, hd], each
    row's query at position ``kv_lens[b] - 1``."""
    return _paged_plain(q, k_pages, v_pages, tables,
                        kv_lens.long()[:, None] - 1, slopes)


def decode_splits(W: int, block_tokens: int, kv_split: int = KV_SPLIT
                  ) -> int:
    """The split count of a decode launch: ``ceil(W * bt / kv_split)``,
    from the table's shape alone (the host reads no ``kv_lens``).  Splits
    past a row's ``kv_len`` do no work."""
    if W <= 0 or block_tokens <= 0 or kv_split <= 0:
        raise ValueError(f"decode_splits needs positive W, block_tokens and "
                         f"kv_split; got {W}, {block_tokens}, {kv_split}")
    return -(-W * block_tokens // kv_split)


def paged_decode_split_plain(q, k_pages, v_pages, tables, kv_lens,
                             slopes=None, kv_split: int = KV_SPLIT
                             ) -> torch.Tensor:
    """The decode kernel's split arithmetic (f32 and bf16 q) in plain
    f32 PyTorch (tests only; no path calls it): split ``s`` of a row
    covers the positions ``[s * kv_split, (s + 1) * kv_split)`` below its
    ``kv_end = min(kv_len, W * bt)`` and keeps an unnormalised partial
    (acc, m, l); the live splits merge in split order, ``acc / max(l,
    1e-30)``, and a row with ``kv_end`` 0 gives 0.  Same contract as
    :func:`paged_flash_attention_plain`."""
    b, _, nh, hd = q.shape
    nkv, bt = k_pages.shape[1], k_pages.shape[2]
    g = nh // nkv
    W = tables.shape[1]
    ns = decode_splits(W, bt, kv_split)
    kf = _linear_view(k_pages, tables).float()          # [b, nkv, S, hd]
    vf = _linear_view(v_pages, tables).float()
    qf = q.float().reshape(b, nkv, g, hd) * _scale(hd)
    s = torch.einsum("bkgd,bksd->bkgs", qf, kf)
    pos = torch.arange(W * bt, device=q.device)
    kv_len = kv_lens.long()
    kv_end = kv_len.clamp(0, W * bt)
    if slopes is not None:
        dist = (kv_len[:, None] - 1 - pos).float()           # [b, S]
        s = s - (slopes.float().reshape(nkv, g)[None, :, :, None]
                 * dist[:, None, None])
    valid = (pos < kv_end[:, None])[:, None, None]          # [b,1,1,S]
    s = s.masked_fill(~valid, _NEG)
    acc = torch.zeros((b, nkv, g, hd), device=q.device)
    l_sum = torch.zeros((b, nkv, g), device=q.device)
    parts = []
    for i in range(ns):
        cols = slice(i * kv_split, (i + 1) * kv_split)
        m_i = s[..., cols].amax(-1)
        p = torch.where(valid[..., cols],
                        torch.exp(s[..., cols] - m_i[..., None]), 0.0)
        parts.append((torch.einsum("bkgs,bksd->bkgd", p, vf[:, :, cols]),
                      m_i, p.sum(-1)))
    live = [(i * kv_split < kv_end)[:, None, None] for i in range(ns)]
    m = torch.full((b, nkv, g), _NEG, device=q.device)
    for (_, m_i, _), ok in zip(parts, live):
        m = torch.where(ok, torch.maximum(m, m_i), m)
    for (acc_i, m_i, l_i), ok in zip(parts, live):
        w = torch.where(ok, torch.exp(m_i - m), 0.0)
        l_sum = l_sum + l_i * w
        acc = acc + acc_i * w[..., None]
    out = acc / l_sum.clamp_min(1e-30)[..., None]
    return out.reshape(b, 1, nh, hd).to(q.dtype)


def paged_prefill_attention_plain(q, k_pages, v_pages, tables, q_positions,
                                  slopes=None) -> torch.Tensor:
    """Plain version of the prefill kernel: ``q`` [b, chunk, nh, hd] at
    the contiguous positions ``q_positions[b, 0] + arange(chunk)``."""
    chunk = q.shape[1]
    starts = q_positions[:, :1].long()
    return _paged_plain(q, k_pages, v_pages, tables,
                        starts + torch.arange(chunk, device=q.device),
                        slopes)


# ---------------------------------------------------------------------------
# the CUDA kernels


@functools.cache
def _kernel_fns() -> dict:
    """The C functions, built and bound once: ``(kind, page)`` -> the
    launch function of that kernel instance ("decode" or "prefill", a
    page type of :data:`PAGE_TYPES`), "error" -> the error-string
    function."""
    from ._build import load
    lib = load(SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    tail = [ctypes.c_float, i32, ptr]
    fns = {}
    # decode: q, pages, tables, kv_lens, slopes, out, 2 scratch; b, nh,
    # nkv, hd, bt, num_pages, W, splits; scale, dtype.  prefill: q,
    # pages, tables, starts, slopes, out; b, chunk, nh, nkv, hd, bt,
    # num_pages, W; scale, dtype, rows_per_block
    for kind, n_ptr, n_int, n_tail in (("decode", 9, 8, 0),
                                       ("prefill", 7, 8, 1)):
        for page in PAGE_TYPES:
            fn = getattr(lib, f"paged_{kind}{_SUFFIX[page]}_fwd")
            n_scales = 2 if page == "int8" else 0
            fn.argtypes = ([ptr] * (n_ptr + n_scales) + [i32] * n_int
                           + tail[:2] + [i32] * n_tail + tail[2:])
            fn.restype = i32
            fns[kind, page] = fn
    lib.paged_attention_error_string.argtypes = [i32]
    lib.paged_attention_error_string.restype = ctypes.c_char_p
    fns["error"] = lib.paged_attention_error_string
    return fns


def _check_pages(k_pages, v_pages, q_dtype) -> bool:
    """Raise on page pools the kernels do not take; True for int8 pools
    (data int8 [N, nkv, bt, hd] + f32 scales [N, nkv, bt, 1]), False for
    full-width pools of q's dtype and for float8 e4m3 pools."""
    quant = isinstance(k_pages, QuantizedKVPages)
    if quant != isinstance(v_pages, QuantizedKVPages):
        raise ValueError("the K and V pools must both be quantized or "
                         "both full width")
    if not quant:
        if k_pages.dtype == v_pages.dtype == FLOAT8:
            return False
        if not q_dtype == k_pages.dtype == v_pages.dtype:
            raise ValueError(
                "the CUDA paged kernels take float32 or bfloat16 q and "
                f"pages of q's dtype or float8_e4m3fn; got {q_dtype}, "
                f"{k_pages.dtype}, {v_pages.dtype}")
        return False
    if k_pages.bits != 8 or v_pages.bits != 8:
        raise ValueError("the CUDA paged kernels stream full-width or int8 "
                         "pages; int4 KV takes the gather path")
    for p in (k_pages, v_pages):
        if (p.data.dtype != torch.int8 or p.scale.dtype != torch.float32
                or tuple(p.scale.shape) != (*p.data.shape[:-1], 1)):
            raise ValueError("int8 pages need int8 data [N, nkv, bt, hd] "
                             "and float32 scales [N, nkv, bt, 1]")
    return True


def _check_cuda_args(name, q, k_pages, v_pages, tables, per_row, slopes):
    """Raise on what the kernels do not take; return the page type, and
    the int32 tables and per-row vector the kernel reads."""
    if (q.ndim != 4 or len(k_pages.shape) != 4
            or tuple(k_pages.shape) != tuple(v_pages.shape)):
        raise ValueError(
            f"{name} needs q [b, chunk, nh, hd] and pages [N, nkv, bt, hd];"
            f" got {tuple(q.shape)}, {tuple(k_pages.shape)}, "
            f"{tuple(v_pages.shape)}")
    b, _, nh, hd = q.shape
    _, nkv, bt, khd = k_pages.shape
    if khd != hd or nkv == 0 or nh % nkv:
        raise ValueError(f"q {tuple(q.shape)} does not match the pages "
                         f"{tuple(k_pages.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"the CUDA paged kernels take head_dim in "
                         f"{HEAD_DIMS}, got {hd}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"the CUDA paged kernels take float32 or bfloat16 "
                         f"q, got {q.dtype}")
    page = ("int8" if _check_pages(k_pages, v_pages, q.dtype)
            else "fp8" if k_pages.dtype == FLOAT8 else "full")
    pools = ([("k_pages", t) for t in _leaves(k_pages)]
             + [("v_pages", t) for t in _leaves(v_pages)])
    if tables.ndim != 2 or tables.shape[0] != b or per_row.shape != (b,):
        raise ValueError(f"{name}: tables must be [{b}, W] and the per-row "
                         f"vector [{b}]; got {tuple(tables.shape)}, "
                         f"{tuple(per_row.shape)}")
    for what, t in [("q", q), *pools, ("tables", tables),
                    ("per-row vector", per_row)]:
        if t.device != q.device:
            raise ValueError(f"{what} is on {t.device}, q on {q.device}")
    for what, t in [("q", q), *pools]:
        if not t.is_contiguous():
            raise ValueError(f"{what} must be contiguous")
        # the kernels copy pages in 16-byte pieces and read q in pairs
        if t.data_ptr() % (16 if t is not q else 4):
            raise ValueError(f"{what} is not aligned for the kernels' "
                             "vector loads")
    if slopes is not None and (slopes.shape != (nh,)
                               or slopes.device != q.device):
        raise ValueError(f"slopes must be [{nh}] on {q.device}")
    return (page, tables.to(torch.int32).contiguous(),
            per_row.to(torch.int32).contiguous())


def _leaves(pages):
    return pages.leaves() if isinstance(pages, QuantizedKVPages) else [pages]


def _page_ptrs(k_pages, v_pages, page: str) -> tuple:
    """The page pointers of a launch: (k, v) for full-width and float8
    pages, (k data, k scale, v data, v scale) for int8 pages."""
    if page == "int8":
        return (k_pages.data.data_ptr(), k_pages.scale.data_ptr(),
                v_pages.data.data_ptr(), v_pages.scale.data_ptr())
    return k_pages.data_ptr(), v_pages.data_ptr()


def _launch(kind: str, page: str, q, args, fns: dict) -> None:
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fns[kind, page](*args, stream)
    if err != 0:
        raise RuntimeError("paged attention kernel launch failed: "
                           + fns["error"](err).decode())


def _count(wrapper, page: str) -> None:
    with _count_lock:
        name = _COUNTER[page]
        setattr(wrapper, name, getattr(wrapper, name) + 1)


def _scale(hd: int) -> float:
    return float(np.float32(1.0) / np.sqrt(np.float32(hd)))


def paged_flash_attention(q: torch.Tensor, k_pages, v_pages,
                          tables: torch.Tensor, kv_lens: torch.Tensor,
                          slopes: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Paged decode attention: ``q`` [b, 1, nh, hd], each row's query at
    position ``kv_lens[b] - 1`` (``kv_lens`` [b]: valid length including
    this token) over its table row of ``tables`` [b, W]; ``slopes`` [nh]
    adds ALiBi.  The pages are full width (q's dtype), float8 e4m3 or
    int8 ``QuantizedKVPages``.  Returns [b, 1, nh, hd] in q's dtype.

    CUDA tensors launch the kernel or raise; CPU tensors take the plain
    version."""
    if q.shape[1] != 1:
        raise ValueError(f"paged_flash_attention is decode-only (chunk=1), "
                         f"got chunk={q.shape[1]}")
    if q.device.type == "cpu":
        return paged_flash_attention_plain(q, k_pages, v_pages, tables,
                                           kv_lens, slopes)
    if q.device.type != "cuda":
        raise ValueError(f"paged_flash_attention: unsupported device "
                         f"{q.device}")
    page, tables, kv_lens = _check_cuda_args(
        "paged_flash_attention", q, k_pages, v_pages, tables, kv_lens,
        slopes)
    nh, nkv = q.shape[2], k_pages.shape[1]
    if nh // nkv > MAX_DECODE_GROUP:
        raise ValueError(f"the decode kernel takes at most "
                         f"{MAX_DECODE_GROUP} q heads per kv head, got "
                         f"{nh // nkv}")
    return _decode_launch(q, k_pages, v_pages, tables, kv_lens, slopes,
                          page)


def _decode_launch(q, k_pages, v_pages, tables, kv_lens, slopes,
                   page: str) -> torch.Tensor:
    """One decode launch of q's dtype's instance (its split pass, then
    the merge), the arguments checked by :func:`_check_cuda_args`;
    counts it."""
    b, _, nh, hd = q.shape
    num_pages, nkv, bt, _ = k_pages.shape
    if slopes is not None:
        slopes = slopes.float().contiguous()
    W = tables.shape[1]
    splits = decode_splits(W, bt)
    out = torch.empty_like(q)
    # the split pass's f32 partials in one buffer: acc [b, splits, nh,
    # hd], then (m, l) [2, b, splits, nh]
    n_acc = b * splits * nh * hd
    scratch = torch.empty(n_acc + 2 * b * splits * nh, dtype=torch.float32,
                          device=q.device)
    part_acc = scratch.data_ptr()
    _launch("decode", page, q, (
        q.data_ptr(), *_page_ptrs(k_pages, v_pages, page),
        tables.data_ptr(), kv_lens.data_ptr(),
        slopes.data_ptr() if slopes is not None else None, out.data_ptr(),
        part_acc, part_acc + 4 * n_acc, b, nh, nkv, hd, bt, num_pages, W,
        splits, _scale(hd), _DTYPE_CODE[q.dtype]), _kernel_fns())
    _count(paged_flash_attention, page)
    return out


paged_flash_attention.launches = 0
paged_flash_attention.int8_launches = 0
paged_flash_attention.fp8_launches = 0


def paged_prefill_attention(q: torch.Tensor, k_pages, v_pages,
                            tables: torch.Tensor, q_positions: torch.Tensor,
                            slopes: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Paged attention for a contiguous chunk per row: ``q`` [b, chunk,
    nh, hd] at positions ``q_positions[b, 0] + arange(chunk)`` (the
    callers' contract; only the first column is read) attends causally
    over its table row's pages, which already hold the chunk's own K/V.
    The pages are full width (q's dtype), float8 e4m3 or int8
    ``QuantizedKVPages``.
    Returns [b, chunk, nh, hd] in q's dtype.

    CUDA tensors launch the kernel or raise; CPU tensors take the plain
    version."""
    b, chunk, nh, hd = q.shape
    if q.device.type == "cpu":
        return paged_prefill_attention_plain(q, k_pages, v_pages, tables,
                                             q_positions, slopes)
    if q.device.type != "cuda":
        raise ValueError(f"paged_prefill_attention: unsupported device "
                         f"{q.device}")
    page, tables, starts = _check_cuda_args(
        "paged_prefill_attention", q, k_pages, v_pages, tables,
        q_positions[:, 0], slopes)
    nkv = k_pages.shape[1]
    rows = PREFILL_ROWS
    if q.dtype == torch.float32:
        rows = f32_rows_per_block(b, nkv, chunk * (nh // nkv), hd,
                                  _sm_count(q.device),
                                  full_width=page == "full")
    return _prefill_launch(q, k_pages, v_pages, tables, starts, slopes,
                           page, rows)


def _prefill_launch(q, k_pages, v_pages, tables, starts, slopes, page: str,
                    rows_per_block: int) -> torch.Tensor:
    """One prefill launch of q's dtype's instance with ``rows_per_block``
    rows a block (f32: 16 or 64; bf16 has one instance, PREFILL_ROWS),
    the arguments checked by :func:`_check_cuda_args`; counts it."""
    b, chunk, nh, hd = q.shape
    num_pages, nkv, bt, _ = k_pages.shape
    if slopes is not None:
        slopes = slopes.float().contiguous()
    out = torch.empty_like(q)
    _launch("prefill", page, q, (
        q.data_ptr(), *_page_ptrs(k_pages, v_pages, page),
        tables.data_ptr(), starts.data_ptr(),
        slopes.data_ptr() if slopes is not None else None, out.data_ptr(),
        b, chunk, nh, nkv, hd, bt, num_pages, tables.shape[1], _scale(hd),
        _DTYPE_CODE[q.dtype], rows_per_block), _kernel_fns())
    _count(paged_prefill_attention, page)
    if q.dtype == torch.float32 and rows_per_block == 64:
        with _count_lock:
            paged_prefill_attention.f32_wide_launches += 1
    return out


paged_prefill_attention.launches = 0
paged_prefill_attention.int8_launches = 0
paged_prefill_attention.fp8_launches = 0
paged_prefill_attention.f32_wide_launches = 0


# ---------------------------------------------------------------------------
# the attn_impl seam (models/decoder.py hook)


def resolve_paged_backend(backend: str, device_type: str,
                          head_dim: Optional[int] = None,
                          block_tokens: Optional[int] = None) -> bool:
    """Whether a paged engine routes through the kernel wrappers (True)
    or always gathers (False, the "plain" backend; the reference's
    "xla").  "auto" takes the kernels: on CUDA they launch, on the CPU
    their plain versions run.  "cuda" (the reference's "pallas") is the
    kernels on the card only.  On CUDA the kernels never give way to a
    plain path: a head dim they lack, or a page size the routing sends
    to the gather path (not a multiple of 8 tokens), raises, naming the
    "plain" backend, the explicit opt-in."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown paged attention backend {backend!r}; "
                         f"expected one of {BACKENDS}")
    if backend == "plain":
        return False
    if backend == "cuda" and device_type != "cuda":
        raise ValueError("the 'cuda' paged attention backend launches the "
                         "CUDA kernels; on the CPU use 'auto' or 'plain'")
    if (device_type == "cuda" and head_dim is not None
            and head_dim not in HEAD_DIMS):
        raise ValueError(
            f"the CUDA paged kernels take head_dim in {HEAD_DIMS}, not "
            f"{head_dim}; ask for the gather path on the card with the "
            "'plain' paged attention backend (--attn-backend plain)")
    if (device_type == "cuda" and block_tokens is not None
            and block_tokens % 8):
        raise ValueError(
            f"the paged kernels' routing takes pages of a multiple of 8 "
            f"tokens, not {block_tokens}; ask for the gather path on the "
            "card with the 'plain' paged attention backend "
            "(--attn-backend plain)")
    return True


def paged_route(use_kernels: bool, chunk: int, groups: int,
                block_tokens: int, kv_bits: Optional[int] = None,
                max_rows: Optional[int] = PREFILL_KERNEL_MAX_ROWS) -> str:
    """The reference's routing (``make_paged_attn_impl``), which follows
    the pool's own type: "decode" (the decode kernel) for a 1-token
    chunk, "prefill" (the prefill kernel) for a longer contiguous chunk
    of at most ``max_rows`` 8-padded query rows (None: any), "gather"
    otherwise.  The kernels need pages of a multiple of 8 tokens, full
    width, float8 or int8 (``kv_bits`` 8); int4 pools (``kv_bits`` 4)
    always gather.  The reference's extra rule for int8, pages of a
    multiple of 32 tokens off its forced backend, is the TPU's int8 tile
    and is not kept (ROADMAP C)."""
    if use_kernels and block_tokens % 8 == 0 and kv_bits != 4:
        if chunk == 1:
            return "decode"
        if max_rows is None or -(-(chunk * groups) // 8) * 8 <= max_rows:
            return "prefill"
    return "gather"


def make_paged_attn_impl(block_tokens: int, backend: str = "auto", *,
                         num_pages: Optional[int] = None,
                         head_dim: Optional[int] = None,
                         device_type: str = "cpu",
                         launches: Optional[dict] = None):
    """``(impl, bind)``: an attention hook for page-pool caches plus the
    binder that hands it the block tables.

    The decoder's ``attn_impl`` signature has no table slot, so the
    caller binds the dispatch's device tables (``bind(tables)``, [b, W]
    int32) before each forward; every layer of that forward reads them.
    The write slots and the kernels' per-row vectors are computed once
    per forward (the layers share ``positions``), so a layer adds no host
    sync and no table upload.

    ``num_pages``: the page ids a table may name; the pools the hook is
    given hold one drop page more (default: their size minus one).  The
    pools are full width or ``QuantizedKVPages``, and their type picks
    the route (:func:`paged_route`).
    ``backend``: see :func:`resolve_paged_backend`, which this calls with
    ``device_type``, ``head_dim`` and ``block_tokens``; the routing is
    :func:`paged_route`, with the reference's row cap off the card and
    none on it: there every contiguous chunk takes the prefill kernel, so
    the serialized admission's final chunk padded to its bucket (1024 rows
    at a 128-token bucket and g = 8) and the same tokens in a mixed slab
    share one arithmetic (ROADMAP C).

    ``launches``: a dict ``{"decode": n, "prefill": n}`` of this hook's
    own kernel launches, bumped after each wrapper call that launched
    (a CUDA query).  The wrappers' counters are process-wide; this one
    belongs to the hook, so stages sharing a process keep apart."""
    use_kernels = resolve_paged_backend(backend, device_type, head_dim,
                                        block_tokens)
    max_rows = None if device_type == "cuda" else PREFILL_KERNEL_MAX_ROWS
    bound = {}

    def bind(tables: torch.Tensor) -> None:
        bound.clear()
        bound["tables"] = tables

    def impl(q, k, v, k_pages, v_pages, positions, cache_start, slopes):
        tables = bound["tables"]
        plan = bound.get("plan")
        if plan is None or plan["positions"] is not positions:
            # one plan per forward, held with the positions tensor it was
            # made for (which also keeps that tensor's id from reuse):
            # the write slots, and the kernels' per-row int32 vectors
            n = num_pages if num_pages is not None else k_pages.shape[0] - 1
            plan = bound["plan"] = {
                "positions": positions,
                "slots": _write_slots(tables, positions, k_pages.shape[2],
                                      n),
                "kv_lens": (positions[:, -1] + 1).to(torch.int32),
                "starts": positions[:, :1].to(torch.int32)}
        page, off = plan["slots"]
        _scatter(k_pages, v_pages, k, v, page, off)
        route = paged_route(use_kernels, q.shape[1],
                            q.shape[2] // k.shape[2], k_pages.shape[2],
                            getattr(k_pages, "bits", None), max_rows)
        if route == "decode":
            out = paged_flash_attention(q.contiguous(), k_pages, v_pages,
                                        tables, plan["kv_lens"], slopes)
        elif route == "prefill":
            # [b, 1] starts stand for the contiguous positions
            out = paged_prefill_attention(q.contiguous(), k_pages, v_pages,
                                          tables, plan["starts"], slopes)
        else:
            out = paged_gather_attention(q, k_pages, v_pages, tables,
                                         positions, slopes)
        if launches is not None and route != "gather" \
                and q.device.type == "cuda":
            launches[route] += 1
        return out, k_pages, v_pages

    return impl, bind
