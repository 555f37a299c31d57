"""Dense-cache flash attention: the CUDA kernel, its plain version, the hook.

Counterpart of ``distributed_inference_demo_tpu/ops/flash_attention.py``.
The Pallas TPU kernel ``_kernel`` is rewritten by hand for Hopper in
``csrc/flash_attention.cu`` (its header gives the design and what bounds
it).  ``flash_attention`` launches it for CUDA tensors and raises on
anything it does not take; for CPU tensors it runs the plain PyTorch
version, which is ``ops.attention.attention`` at contiguous query
positions.  Its integer ``flash_attention.launches`` counts kernel
launches, so a run can show that it went through the kernel,
``flash_attention.wide_launches`` those of the bf16 kernel's 64-row
instance and ``flash_attention.f32_wide_launches`` those of the f32
kernel's, so a run can show which instance it took
(:func:`flash_rows_per_block` and :func:`f32_rows_per_block` pick them).
"""

import ctypes
import functools
import threading
from typing import Optional

import numpy as np
import torch

from .attention import attention, attention_at, update_kv_cache

SOURCE = "flash_attention.cu"
# the head dims of the catalog's models, each an instance of the kernels
HEAD_DIMS = (64, 80, 96, 128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_count_lock = threading.Lock()   # server threads may launch concurrently


def flash_attention_plain(q, k_cache, v_cache, q_start: int, kv_len: int,
                          slopes: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """The plain PyTorch version of the kernel: ``ops.attention`` with
    query positions ``q_start + arange(chunk)``."""
    b, chunk = q.shape[:2]
    pos = int(q_start) + torch.arange(chunk, device=q.device)
    return attention(q, k_cache, v_cache, pos.expand(b, chunk), kv_len,
                     slopes)


@functools.cache
def _kernel_fn():
    """(launch, error-string) C functions, built and bound once."""
    from ._build import load
    lib = load(SOURCE)
    fn = lib.flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return fn, lib.flash_attention_error_string


def flash_rows_per_block(b: int, nkv: int, rows: int, sm_count: int) -> int:
    """The bf16 kernel's instance for ``rows`` regrouped query rows
    (chunk x q heads per kv head) of ``b`` batch rows and ``nkv`` kv
    heads: 64 rows a block when those blocks alone fill at least one wave
    of the card's ``sm_count`` SMs (one K/V tile then feeds 64 rows), else
    16 (four times the blocks; a block's four warps split each tile's
    keys).  Near that line the two instances are within ~20% of each
    other and the faster one varies with the shape (PERF.md §6 lists
    the shapes where the rule picks the slower one)."""
    return 64 if b * nkv * -(-rows // 64) >= sm_count else 16


# the f32 kernel's 64-row instance exists for head dims up to this one
# (at 256 a lane's 128 accumulators leave no room for its 64-key scores)
F32_WIDE_MAX_HD = 128


def f32_rows_per_block(b: int, nkv: int, rows: int, hd: int, sm_count: int,
                       full_width: bool = True) -> int:
    """The f32 kernel's instance (``csrc/f32_tile.cuh``, shared with the
    paged prefill kernel) for ``rows`` regrouped query rows of ``b``
    batch rows and ``nkv`` kv heads: 64 rows a block, whose one K/V tile
    feeds 64 rows, when those blocks alone fill one and a half waves of
    the card's ``sm_count`` SMs, the head dim has that instance and the
    K/V are full-width f32 (``full_width``; byte pages take 16-row blocks
    only), else 16 (four times the blocks, a block's four warps split each
    tile's keys).  Below that line the 16-row blocks won on the card at
    132-150 64-row blocks of a causal chunk (257 tokens from 0, a tp=2
    rank's 600), the 64-row ones from 256 on (PERF.md §6)."""
    if hd > F32_WIDE_MAX_HD or not full_width:
        return 16
    return 64 if 2 * b * nkv * -(-rows // 64) >= 3 * sm_count else 16


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check_cuda_args(q, k_cache, v_cache, q_start, kv_len, slopes):
    if q.ndim != 4 or k_cache.ndim != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(
            "flash_attention needs q [b, chunk, nh, hd] and caches "
            f"[b, nkv, max_seq, hd]; got {tuple(q.shape)}, "
            f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    b, chunk, nh, hd = q.shape
    kb, nkv, max_seq, khd = k_cache.shape
    if kb != b or khd != hd or nkv == 0 or nh % nkv:
        raise ValueError(f"q {tuple(q.shape)} does not match the cache "
                         f"{tuple(k_cache.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"the CUDA flash kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {hd}")
    if q.dtype not in _DTYPE_CODE or not (q.dtype == k_cache.dtype
                                          == v_cache.dtype):
        raise ValueError(
            "the CUDA flash kernel takes float32 or bfloat16 q and caches "
            f"of one dtype; got {q.dtype}, {k_cache.dtype}, "
            f"{v_cache.dtype}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not (0 <= q_start and 0 <= kv_len <= max_seq):
        raise ValueError(f"q_start {q_start} / kv_len {kv_len} out of "
                         f"range for max_seq {max_seq}")
    if slopes is not None and (slopes.shape != (nh,)
                               or slopes.device != q.device):
        raise ValueError(f"slopes must be [{nh}] on {q.device}")
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
            if t.data_ptr() % 16:
                raise ValueError(f"{name} must be 16-byte aligned for the "
                                 "bf16 kernel's 16-byte copies")


def flash_attention(q: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, q_start: int, kv_len: int,
                    slopes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Causal GQA attention of ``q`` [b, chunk, nh, hd] (positions
    ``q_start + arange(chunk)``) over the head-major caches
    [b, nkv, max_seq, hd] valid up to ``kv_len``; ``slopes`` [nh] adds
    ALiBi.  Returns [b, chunk, nh, hd] in q's dtype.

    CUDA tensors launch the kernel or raise; CPU tensors take the plain
    version."""
    q_start, kv_len = int(q_start), int(kv_len)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k_cache, v_cache, q_start, kv_len,
                                     slopes)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check_cuda_args(q, k_cache, v_cache, q_start, kv_len, slopes)
    b, chunk, nh, hd = q.shape
    nkv = k_cache.shape[1]
    if q.dtype == torch.bfloat16:
        rows = flash_rows_per_block(b, nkv, chunk * (nh // nkv),
                                    _sm_count(q.device))
    else:
        rows = f32_rows_per_block(b, nkv, chunk * (nh // nkv), hd,
                                  _sm_count(q.device))
    return _launch(q, k_cache, v_cache, q_start, kv_len, slopes, rows)


def _launch(q, k_cache, v_cache, q_start: int, kv_len: int, slopes,
            rows_per_block: int) -> torch.Tensor:
    """One launch of q's dtype's instance with ``rows_per_block`` rows a
    block (arguments already checked); counts it."""
    b, chunk, nh, hd = q.shape
    nkv, max_seq = k_cache.shape[1], k_cache.shape[2]
    if slopes is not None:
        slopes = slopes.float().contiguous()
    out = torch.empty_like(q)
    scale = float(np.float32(1.0) / np.sqrt(np.float32(hd)))
    fn, err_str = _kernel_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                 slopes.data_ptr() if slopes is not None else None,
                 out.data_ptr(), b, chunk, nh, nkv, hd, max_seq, q_start,
                 kv_len, scale, _DTYPE_CODE[q.dtype], rows_per_block, stream)
    if err != 0:
        raise RuntimeError("flash_attention kernel launch failed: "
                           + err_str(err).decode())
    with _count_lock:
        flash_attention.launches += 1
        if rows_per_block == 64:
            if q.dtype == torch.bfloat16:
                flash_attention.wide_launches += 1
            else:
                flash_attention.f32_wide_launches += 1
    return out


flash_attention.launches = 0
flash_attention.wide_launches = 0
flash_attention.f32_wide_launches = 0


def make_flash_attn_impl(min_chunk: int = 16):
    """An ``attn_impl`` hook (models/decoder.py): the flash kernel for
    chunks of ``min_chunk`` tokens or more, ``ops.attention`` below
    (decode), as in the reference.  Assumes contiguous query positions
    (the engine's guarantee).  A ``cache_start`` held as a device tensor
    is the engine's fixed-shape decode step, which a CUDA graph replays:
    it takes ``ops.attention.attention_at``; the kernel, whose launch
    takes host offsets, is for host lengths only."""

    def impl(q, k, v, k_cache, v_cache, positions, cache_start, slopes):
        if torch.is_tensor(cache_start):
            if q.shape[1] >= min_chunk:
                raise ValueError(
                    f"a device cache length is the fixed-shape decode "
                    f"path; a {q.shape[1]}-token chunk needs a host "
                    "length for the flash kernel")
            return (attention_at(q, k, v, k_cache, v_cache, positions,
                                 cache_start, slopes), k_cache, v_cache)
        k_cache, v_cache = update_kv_cache(k_cache, v_cache, k, v,
                                           cache_start)
        kv_len = int(cache_start) + q.shape[1]
        if q.shape[1] >= min_chunk:
            out = flash_attention(q.contiguous(), k_cache, v_cache,
                                  cache_start, kv_len, slopes)
        else:
            out = attention(q, k_cache, v_cache, positions, kv_len, slopes)
        return out, k_cache, v_cache
    return impl
