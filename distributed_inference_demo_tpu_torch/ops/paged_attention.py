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

Three compute paths with the same numerics as ``ops.attention``:

- :func:`paged_gather_attention`: gather the table's pages into a linear
  view and run ``ops.attention``; the routing's fallback, and the
  "plain" backend;
- :func:`paged_flash_attention`: one query token per row (decode); the
  CUDA kernel ``paged_decode_fwd`` of ``csrc/paged_attention.cu``, which
  replaces the Pallas kernel ``_paged_kernel``;
- :func:`paged_prefill_attention`: a contiguous chunk of queries per row;
  the CUDA kernel ``paged_prefill_fwd``, which replaces
  ``_paged_prefill_kernel``.

The two kernel wrappers launch their kernel for CUDA tensors and raise on
anything it does not take; for CPU tensors they run their plain PyTorch
version (``paged_flash_attention_plain``, ``paged_prefill_attention_plain``).
Each has an integer ``.launches`` count of kernel launches.
"""

import ctypes
import functools
import threading
from typing import Optional

import numpy as np
import torch

from .attention import attention, prepare_kv_chunk

SOURCE = "paged_attention.cu"
HEAD_DIMS = (64, 128)
MAX_DECODE_GROUP = 16        # q heads per kv head the decode kernel takes
# one prefill kernel call's query rows = chunk * group, padded to 8; the
# reference's cap (its f32 VMEM accumulators crowd the page stream past
# it), kept so the routing matches
PREFILL_KERNEL_MAX_ROWS = 512
BACKENDS = ("auto", "plain", "cuda")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
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
    layout [b, s, nkv, hd] is the projection layout the chunk arrives in."""
    k_new, v_new = prepare_kv_chunk(k_new, v_new, k_pages.dtype,
                                    v_pages.dtype)
    k_pages[page, :, off] = k_new
    v_pages[page, :, off] = v_new


def write_paged_kv(k_pages: torch.Tensor, v_pages: torch.Tensor,
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
    reference's ``mode="drop"`` scatter leaves it.  Write contract:
    :func:`ops.attention.prepare_kv_chunk`."""
    if k_pages.shape[0] != num_pages + 1 or v_pages.shape != k_pages.shape:
        raise ValueError(
            f"the page pools must hold num_pages + 1 = {num_pages + 1} "
            f"pages (the last is the drop page); got {tuple(k_pages.shape)}"
            f", {tuple(v_pages.shape)}")
    page, off = _write_slots(tables, positions, k_pages.shape[2], num_pages)
    _scatter(k_pages, v_pages, k_new, v_new, page, off)


# ---------------------------------------------------------------------------
# gather path and the plain versions of the kernels


def _linear_view(pages: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """[b, nkv, W*bt, hd]: each row's pages in table order, sentinels
    clamped into the pool."""
    n, nkv, bt, hd = pages.shape
    b, W = tables.shape
    safe = tables.long().clamp(0, n - 1)
    return pages[safe].permute(0, 2, 1, 3, 4).reshape(b, nkv, W * bt, hd)


def paged_gather_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, tables: torch.Tensor,
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
def _kernel_fns():
    """(decode, prefill, error-string) C functions, built and bound once."""
    from ._build import load
    lib = load(SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    dec = lib.paged_decode_fwd
    dec.argtypes = [ptr] * 7 + [i32] * 7 + [ctypes.c_float, i32, ptr]
    dec.restype = i32
    pre = lib.paged_prefill_fwd
    pre.argtypes = [ptr] * 7 + [i32] * 8 + [ctypes.c_float, i32, ptr]
    pre.restype = i32
    lib.paged_attention_error_string.argtypes = [i32]
    lib.paged_attention_error_string.restype = ctypes.c_char_p
    return dec, pre, lib.paged_attention_error_string


def _check_cuda_args(name, q, k_pages, v_pages, tables, per_row, slopes):
    """Raise on what the kernels do not take; return the int32 tables
    and per-row vector the kernel reads."""
    if q.ndim != 4 or k_pages.ndim != 4 or k_pages.shape != v_pages.shape:
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
    if q.dtype not in _DTYPE_CODE or not (q.dtype == k_pages.dtype
                                          == v_pages.dtype):
        raise ValueError(
            "the CUDA paged kernels take float32 or bfloat16 q and pages "
            f"of one dtype; got {q.dtype}, {k_pages.dtype}, "
            f"{v_pages.dtype}")
    if tables.ndim != 2 or tables.shape[0] != b or per_row.shape != (b,):
        raise ValueError(f"{name}: tables must be [{b}, W] and the per-row "
                         f"vector [{b}]; got {tuple(tables.shape)}, "
                         f"{tuple(per_row.shape)}")
    for what, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("tables", tables), ("per-row vector", per_row)):
        if t.device != q.device:
            raise ValueError(f"{what} is on {t.device}, q on {q.device}")
    for what, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if not t.is_contiguous():
            raise ValueError(f"{what} must be contiguous")
    if slopes is not None and (slopes.shape != (nh,)
                               or slopes.device != q.device):
        raise ValueError(f"slopes must be [{nh}] on {q.device}")
    return (tables.to(torch.int32).contiguous(),
            per_row.to(torch.int32).contiguous())


def _launch(fn, err_str, q, args) -> None:
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError("paged attention kernel launch failed: "
                           + err_str(err).decode())


def _scale(hd: int) -> float:
    return float(np.float32(1.0) / np.sqrt(np.float32(hd)))


def paged_flash_attention(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, tables: torch.Tensor,
                          kv_lens: torch.Tensor,
                          slopes: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Paged decode attention: ``q`` [b, 1, nh, hd], each row's query at
    position ``kv_lens[b] - 1`` (``kv_lens`` [b]: valid length including
    this token) over its table row of ``tables`` [b, W]; ``slopes`` [nh]
    adds ALiBi.  Returns [b, 1, nh, hd] in q's dtype.

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
    tables, kv_lens = _check_cuda_args("paged_flash_attention", q, k_pages,
                                       v_pages, tables, kv_lens, slopes)
    b, _, nh, hd = q.shape
    num_pages, nkv, bt, _ = k_pages.shape
    if nh // nkv > MAX_DECODE_GROUP:
        raise ValueError(f"the decode kernel takes at most "
                         f"{MAX_DECODE_GROUP} q heads per kv head, got "
                         f"{nh // nkv}")
    if slopes is not None:
        slopes = slopes.float().contiguous()
    out = torch.empty_like(q)
    dec, _, err_str = _kernel_fns()
    _launch(dec, err_str, q, (
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        tables.data_ptr(), kv_lens.data_ptr(),
        slopes.data_ptr() if slopes is not None else None, out.data_ptr(),
        b, nh, nkv, hd, bt, num_pages, tables.shape[1], _scale(hd),
        _DTYPE_CODE[q.dtype]))
    with _count_lock:
        paged_flash_attention.launches += 1
    return out


paged_flash_attention.launches = 0


def paged_prefill_attention(q: torch.Tensor, k_pages: torch.Tensor,
                            v_pages: torch.Tensor, tables: torch.Tensor,
                            q_positions: torch.Tensor,
                            slopes: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Paged attention for a contiguous chunk per row: ``q`` [b, chunk,
    nh, hd] at positions ``q_positions[b, 0] + arange(chunk)`` (the
    callers' contract; only the first column is read) attends causally
    over its table row's pages, which already hold the chunk's own K/V.
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
    tables, starts = _check_cuda_args("paged_prefill_attention", q,
                                      k_pages, v_pages, tables,
                                      q_positions[:, 0], slopes)
    num_pages, nkv, bt, _ = k_pages.shape
    if slopes is not None:
        slopes = slopes.float().contiguous()
    out = torch.empty_like(q)
    _, pre, err_str = _kernel_fns()
    _launch(pre, err_str, q, (
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        tables.data_ptr(), starts.data_ptr(),
        slopes.data_ptr() if slopes is not None else None, out.data_ptr(),
        b, chunk, nh, nkv, hd, bt, num_pages, tables.shape[1], _scale(hd),
        _DTYPE_CODE[q.dtype]))
    with _count_lock:
        paged_prefill_attention.launches += 1
    return out


paged_prefill_attention.launches = 0


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
                block_tokens: int) -> str:
    """The reference's routing (``make_paged_attn_impl``): "decode" (the
    decode kernel) for a 1-token chunk, "prefill" (the prefill kernel)
    for a longer contiguous chunk of at most ``PREFILL_KERNEL_MAX_ROWS``
    8-padded query rows, "gather" otherwise; the kernels need pages of a
    multiple of 8 tokens."""
    if use_kernels and block_tokens % 8 == 0:
        if chunk == 1:
            return "decode"
        if -(-(chunk * groups) // 8) * 8 <= PREFILL_KERNEL_MAX_ROWS:
            return "prefill"
    return "gather"


def make_paged_attn_impl(block_tokens: int, backend: str = "auto", *,
                         num_pages: Optional[int] = None,
                         head_dim: Optional[int] = None,
                         device_type: str = "cpu"):
    """``(impl, bind)``: an attention hook for page-pool caches plus the
    binder that hands it the block tables.

    The decoder's ``attn_impl`` signature has no table slot, so the
    caller binds the dispatch's device tables (``bind(tables)``, [b, W]
    int32) before each forward; every layer of that forward reads them.
    The write slots and the kernels' per-row vectors are computed once
    per forward (the layers share ``positions``), so a layer adds no host
    sync and no table upload.

    ``num_pages``: the page ids a table may name; the pools the hook is
    given hold one drop page more (default: their size minus one).
    ``backend``: see :func:`resolve_paged_backend`, which this calls with
    ``device_type``, ``head_dim`` and ``block_tokens``; the routing is
    :func:`paged_route`."""
    use_kernels = resolve_paged_backend(backend, device_type, head_dim,
                                        block_tokens)
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
                            q.shape[2] // k.shape[2], k_pages.shape[2])
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
        return out, k_pages, v_pages

    return impl, bind
