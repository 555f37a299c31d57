"""The dense product with int8 / int4 weights: the CUDA kernels, their
plain version, the routing and split rules.

No Pallas kernel of the JAX package computes this: it stands for the XLA
fusion of ``distributed_inference_demo_tpu/ops/quant.py::dense``, which
dequantizes right at the einsum so that device memory sees only the
quantized bytes.  ``csrc/quant_dense.cu`` does that by hand (its header
gives the designs and what bounds them).  ``quant_dense`` launches one of
its kernels for CUDA tensors and raises on anything it does not take; for
CPU tensors it runs the plain PyTorch version, ``x @ w.dequantize(x.dtype)``.

Routing (``route``): bf16 activations with M <= ``DECODE_MAX_ROWS`` take
the decode kernel (weight streaming, ``mma.sync`` with swapped operands),
larger M the prefill kernel (``wgmma`` fed by TMA); f32 activations split
at the same M, full f32 on the CUDA cores: the f32 decode kernel (weight
streaming, dequantized into registers) and the f32 tile kernel (an SGEMM
tile over each step dequantized once a block).  ``quant_dense.launches``
counts every launch, ``quant_dense.decode_launches`` the bf16 decode
kernel's.

``w`` is an ``ops.quant.QuantizedArray`` (``bits`` 8: int8 ``q`` [K, N],
f32 ``scale`` [1, N]) or ``QuantizedArray4`` (``bits`` 4: uint8 ``q``
[K/2, N], f32 ``scale`` [K/group, 1, N]): one layer's 2-D view.
"""

import contextlib
import ctypes
import functools
import threading
from typing import Optional

import torch

SOURCE = "quant_dense.cu"
BLOCK_N = 128          # output columns a block, every kernel (csrc: BN)
BLOCK_K = 64           # K rows a step of the tile and prefill kernels (BK)
DECODE_STEP_K = 32     # K rows a step of the decode kernels (DEC_STEP)
DECODE_MAX_ROWS = 16   # products up to this M take a decode kernel
PREFILL_ROWS = 128     # rows a prefill block (PF_BM)
F32_TILE_ROWS = 128    # rows an f32 tile block (FT_BM)
COUNTERS = 1 << 16     # arrival counters a buffer (COUNTERS)
# the decode kernel's split aims at this many blocks an SM (four fit): two
# for a weight under DECODE_LARGE_BYTES (fewer splits to sum), three from
# there (more warps to hide each warp's latency; measured on the H100)
DECODE_BLOCKS_PER_SM = (2, 3)
DECODE_LARGE_BYTES = 24 << 20
DECODE_WARPS = 4       # warps a decode block, each its own steps (DEC_WARPS)
# the C entry's kernel codes
KERNELS = {"f32_tile": 0, "decode": 1, "prefill": 2, "f32_decode": 3}
DECODE_KERNELS = ("decode", "f32_decode")   # 32-row steps, M <= 16
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_count_lock = threading.Lock()   # server threads may launch concurrently


def quant_dense_plain(x: torch.Tensor, w) -> torch.Tensor:
    """The plain PyTorch version: ``x @ w.dequantize(x.dtype)``."""
    return x @ w.dequantize(x.dtype)


def route(m: int, dtype: torch.dtype) -> str:
    """The kernel a product of ``m`` rows of ``dtype`` activations takes."""
    if dtype == torch.float32:
        return "f32_decode" if m <= DECODE_MAX_ROWS else "f32_tile"
    return "decode" if m <= DECODE_MAX_ROWS else "prefill"


def _even_splits(steps: int, want: int) -> int:
    """``want`` rounded down so that every split holds at least one of
    ``steps`` steps (splits == ceil(steps / ceil(steps / splits)))."""
    per = -(-steps // max(1, min(want, steps)))
    return -(-steps // per)


def decode_splits(k: int, n: int, bits: int, sm_count: int) -> int:
    """The decode kernels' K split (bf16 and f32 x alike): as many
    blocks as DECODE_BLOCKS_PER_SM an SM give, never more (a second wave
    would run alone); few enough that every warp of a split has a 32-row
    step (more splits only add partials to sum) and that the f32
    partials at the kernel's most rows (16 x N x 4 bytes a split) stay
    under the weight's own bytes.  It depends on no M, so a row's result
    is the same at any M the kernel takes."""
    tiles = -(-n // BLOCK_N)
    per_sm = DECODE_BLOCKS_PER_SM[k * n * bits // 8 >= DECODE_LARGE_BYTES]
    steps = k // DECODE_STEP_K
    want = min(max(1, per_sm * sm_count // tiles),
               max(1, k * bits // (32 * DECODE_MAX_ROWS)),
               max(1, steps // DECODE_WARPS))
    return _even_splits(steps, want)


def prefill_splits(m: int, k: int, n: int, bits: int, sm_count: int) -> int:
    """The prefill kernel's K split: only where the output tiles leave
    SMs idle (one block an SM), no more splits than 64-row steps, and
    few enough that the partials (splits x M x N x 4 bytes) stay under the
    weight's own bytes."""
    tiles = -(-m // PREFILL_ROWS) * -(-n // BLOCK_N)
    want = min(max(1, sm_count // tiles), max(1, k * bits // (32 * m)))
    return _even_splits(k // BLOCK_K, want)


def f32_tile_splits(m: int, k: int, n: int, bits: int,
                    sm_count: int) -> int:
    """The f32 tile kernel's K split (one block an SM): the count that
    finishes first, taking a block's time as its 64-row steps and the
    blocks as waves over the SMs (the fewest splits among equals, so a
    product whose tiles fill the card whole is not split), and few enough
    that the partials (splits x M x N x 4 bytes) stay under the weight's
    own bytes."""
    tiles = -(-m // F32_TILE_ROWS) * -(-n // BLOCK_N)
    steps = k // BLOCK_K
    best = (None, 1)
    for want in range(1, min(steps, max(1, k * bits // (32 * m))) + 1):
        splits = _even_splits(steps, want)
        cost = -(-tiles * splits // sm_count) * -(-steps // splits)
        if best[0] is None or cost < best[0]:
            best = (cost, splits)
    return best[1]


def splits_for(kernel: str, m: int, k: int, n: int, bits: int,
               sm_count: int) -> int:
    if kernel in DECODE_KERNELS:
        return decode_splits(k, n, bits, sm_count)
    if kernel == "prefill":
        return prefill_splits(m, k, n, bits, sm_count)
    return f32_tile_splits(m, k, n, bits, sm_count)


@functools.cache
def _kernel_fn():
    """(launch, error-string) C functions, built and bound once."""
    from ._build import load
    lib = load(SOURCE)
    fn = lib.quant_dense_fwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.quant_dense_error_string.argtypes = [ctypes.c_int]
    lib.quant_dense_error_string.restype = ctypes.c_char_p
    return fn, lib.quant_dense_error_string


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


_counters_lock = threading.Lock()
_counters: dict = {}
_scope = threading.local()


def new_counters(device: torch.device) -> torch.Tensor:
    """A zeroed buffer of split-arrival counters on ``device``."""
    return torch.zeros(COUNTERS, dtype=torch.int32, device=device)


@contextlib.contextmanager
def counters_scope(counters: torch.Tensor):
    """This thread's products use ``counters`` while the block runs.  A
    graph capture runs in one: the graph keeps the buffer's address, and
    replays go to whatever stream is current then, so a buffer keyed by
    the capture stream could be shared with another graph replaying
    beside it.  The graph runner (``runtime/cuda_graph.StepGraphs``)
    gives each engine's graphs a buffer of their own, allocated before
    its first capture; one engine replays its graphs one at a time."""
    prev = getattr(_scope, "counters", None)
    _scope.counters = counters
    try:
        yield counters
    finally:
        _scope.counters = prev


def arrival_counters(device: torch.device,
                     stream: Optional[torch.cuda.Stream] = None
                     ) -> torch.Tensor:
    """The zeroed split-arrival counters a product on ``stream`` (None:
    the device's current stream) uses: those of the enclosing
    :func:`counters_scope`, else one buffer for each (device, stream),
    allocated at that stream's first product, so eager products running
    at once on two streams never share a counter (two streams with one
    handle are one stream, whose products run in order).  Each launch
    leaves its counters at 0.  A graph capture outside a scope raises:
    nothing may be allocated there, and the graph must own its buffer."""
    scoped = getattr(_scope, "counters", None)
    if scoped is not None:
        return scoped
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            "quant_dense: a graph capture needs arrival counters of its "
            "own (capture inside counters_scope(new_counters(device)))")
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    if stream is None:
        stream = torch.cuda.current_stream(index)
    key = (index, stream.cuda_stream)
    with _counters_lock:
        buf = _counters.get(key)
        if buf is None:
            buf = _counters[key] = new_counters(f"cuda:{index}")
        return buf


def _check_cuda_args(x, w):
    bits = getattr(w, "bits", None)
    if bits not in (8, 4):
        raise ValueError("quant_dense takes a QuantizedArray or "
                         f"QuantizedArray4, got {type(w).__name__}")
    if x.ndim != 2 or w.q.ndim != 2:
        raise ValueError(f"quant_dense takes x [M, K] and a 2-D weight; got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    k, n = w.shape
    if x.shape[1] != k:
        raise ValueError(f"x {tuple(x.shape)} does not match the weight "
                         f"{tuple(w.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError("the quant_dense kernel takes float32 or bfloat16 "
                         f"activations, got {x.dtype}")
    if n % 16 or k % BLOCK_K:
        raise ValueError(f"the quant_dense kernel needs N % 16 == 0 and K % "
                         f"{BLOCK_K} == 0; got K={k}, N={n}")
    want_q = torch.int8 if bits == 8 else torch.uint8
    scale_shape = ((1, n) if bits == 8 else (k // w.group, 1, n))
    if w.q.dtype != want_q or w.scale.dtype != torch.float32 or tuple(
            w.scale.shape) != scale_shape:
        raise ValueError(
            f"int{bits} weight needs {want_q} codes and f32 scales "
            f"{scale_shape}; got {w.q.dtype}, {w.scale.dtype} "
            f"{tuple(w.scale.shape)}")
    if bits == 4 and (w.group % BLOCK_K or k % w.group):
        raise ValueError(f"the quant_dense kernel takes int4 groups that "
                         f"are multiples of {BLOCK_K} and divide K={k}; got "
                         f"group {w.group}")
    for name, t in (("x", x), ("q", w.q), ("scale", w.scale)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned for the "
                             "kernel's 16-byte copies")


def quant_dense(x: torch.Tensor, w) -> torch.Tensor:
    """``x`` [M, K] @ ``w`` dequantized [K, N] -> [M, N] in x's dtype,
    with f32 accumulation.  CUDA tensors launch the kernel ``route``
    picks or raise; CPU tensors take the plain version."""
    if x.device.type == "cpu":
        return quant_dense_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"quant_dense: unsupported device {x.device}")
    x = x.contiguous()
    _check_cuda_args(x, w)
    m = x.shape[0]
    kernel = route(m, x.dtype)
    k, n = w.shape
    return _launch(x, w, kernel, splits_for(kernel, m, k, n, w.bits,
                                            _sm_count(x.device)))


def _launch(x, w, kernel: str, splits: int) -> torch.Tensor:
    """One launch of ``kernel`` over ``splits`` K splits (arguments
    already checked; the C entry point refuses a kernel the dtype or M
    does not fit and a split count that leaves a split empty); counts
    it."""
    m = x.shape[0]
    k, n = w.shape
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    part = (torch.empty((splits, m, n), dtype=torch.float32,
                        device=x.device) if splits > 1 else None)
    stream = torch.cuda.current_stream(x.device)
    counters = arrival_counters(x.device, stream)
    fn, err_str = _kernel_fn()
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w.q.data_ptr(), w.scale.data_ptr(),
                 out.data_ptr(),
                 part.data_ptr() if part is not None else None,
                 counters.data_ptr() if counters is not None else None,
                 m, n, k, w.bits, getattr(w, "group", 0),
                 _DTYPE_CODE[x.dtype], KERNELS[kernel], splits,
                 stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"quant_dense {kernel} kernel launch failed: "
                           + err_str(err).decode())
    with _count_lock:
        quant_dense.launches += 1
        if kernel == "decode":
            quant_dense.decode_launches += 1
    return out


quant_dense.launches = 0
quant_dense.decode_launches = 0
