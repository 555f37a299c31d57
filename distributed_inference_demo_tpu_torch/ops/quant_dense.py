"""The dense product with int8 / int4 weights: the CUDA kernel, its plain
version, the instance and split rules.

No Pallas kernel of the JAX package computes this: it stands for the XLA
fusion of ``distributed_inference_demo_tpu/ops/quant.py::dense``, which
dequantizes right at the einsum so that device memory sees only the
quantized bytes.  ``csrc/quant_dense.cu`` does that by hand (its header
gives the design and what bounds it).  ``quant_dense`` launches it for
CUDA tensors and raises on anything it does not take; for CPU tensors it
runs the plain PyTorch version, ``x @ w.dequantize(x.dtype)``.  Its
integer ``quant_dense.launches`` counts calls that launched the kernel.

``w`` is an ``ops.quant.QuantizedArray`` (``bits`` 8: int8 ``q`` [K, N],
f32 ``scale`` [1, N]) or ``QuantizedArray4`` (``bits`` 4: uint8 ``q``
[K/2, N], f32 ``scale`` [K/group, 1, N]): one layer's 2-D view.
"""

import ctypes
import functools
import threading

import torch

SOURCE = "quant_dense.cu"
BLOCK_N = 128     # output columns a block (csrc/quant_dense.cu: BN)
BLOCK_K = 64      # K rows a step (BK)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_count_lock = threading.Lock()   # server threads may launch concurrently


def quant_dense_plain(x: torch.Tensor, w) -> torch.Tensor:
    """The plain PyTorch version: ``x @ w.dequantize(x.dtype)``."""
    return x @ w.dequantize(x.dtype)


def block_rows(m: int, dtype: torch.dtype) -> int:
    """The kernel instance's rows a block: bf16 takes 16 up to 16 rows
    (decode) and 64 above; f32 has the 16-row instance only."""
    return 16 if dtype == torch.float32 or m <= 16 else 64


def k_splits(m: int, n: int, k: int, bits: int, rows: int,
             sm_count: int) -> int:
    """How many blocks share one output tile's K steps.  Enough splits
    that the blocks fill four to an SM (as many as the 16-row instance's
    registers and shared memory let one SM hold, so that the most weight
    bytes are in flight), no more than the K steps, and few enough that
    the f32 partials (splits x M x N x 4 bytes) stay under the weight's
    own bytes, so large M never splits.  Rounded so that every split
    holds at least one step."""
    steps = k // BLOCK_K
    tiles = -(-n // BLOCK_N) * -(-m // rows)
    want = min(-(-4 * sm_count // tiles), steps,
               max(1, k * bits // (32 * m)))
    per = -(-steps // max(1, want))
    return -(-steps // per)


@functools.cache
def _kernel_fn():
    """(launch, error-string) C functions, built and bound once."""
    from ._build import load
    lib = load(SOURCE)
    fn = lib.quant_dense_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.quant_dense_error_string.argtypes = [ctypes.c_int]
    lib.quant_dense_error_string.restype = ctypes.c_char_p
    return fn, lib.quant_dense_error_string


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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
    with f32 accumulation.  CUDA tensors launch the kernel or raise; CPU
    tensors take the plain version."""
    if x.device.type == "cpu":
        return quant_dense_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"quant_dense: unsupported device {x.device}")
    x = x.contiguous()
    _check_cuda_args(x, w)
    m = x.shape[0]
    rows = block_rows(m, x.dtype)
    k, n = w.shape
    splits = k_splits(m, n, k, w.bits, rows, _sm_count(x.device))
    return _launch(x, w, rows, splits)


def _launch(x, w, rows: int, splits: int) -> torch.Tensor:
    """One launch of the ``rows`` instance over ``splits`` K splits
    (arguments already checked); counts it."""
    m = x.shape[0]
    k, n = w.shape
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    part = (torch.empty((splits, m, n), dtype=torch.float32,
                        device=x.device) if splits > 1 else None)
    fn, err_str = _kernel_fn()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w.q.data_ptr(), w.scale.data_ptr(),
                 out.data_ptr(), part.data_ptr() if part is not None
                 else None, m, n, k, w.bits,
                 getattr(w, "group", 0), _DTYPE_CODE[x.dtype], rows, splits,
                 stream)
    if err != 0:
        raise RuntimeError("quant_dense kernel launch failed: "
                           + err_str(err).decode())
    with _count_lock:
        quant_dense.launches += 1
    return out


quant_dense.launches = 0
