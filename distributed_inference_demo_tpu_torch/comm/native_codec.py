"""ctypes bindings for the native wire codec (``native/codec.cc``).

Counterpart of ``distributed_inference_demo_tpu/comm/native_codec.py``:
frames byte-identical to the Python codec of ``wire.py``, bfloat16
included (a :class:`wire.Bf16Bits` array goes out under the bf16 code,
and a bf16 tensor decodes to one).  The library is built from the port's
own sources with g++ at first use (``native/build.py``).

``available()`` says whether the library built and loaded.  The codec
calls do not fall back: where the build failed they raise its error,
g++'s output included.
"""

from __future__ import annotations

import ctypes
import struct
import threading
from typing import List, Optional, Sequence

import numpy as np

from .wire import (_HEADER, _TO_NP, Bf16Bits, DType, TensorMessage,
                   WireError, _np_dtype_to_wire, payload_checksum,
                   verify_checksum)

_lib: Optional[ctypes.CDLL] = None
_load_error: Optional[Exception] = None
_lock = threading.Lock()

_U8P = ctypes.POINTER(ctypes.c_uint8)
_U64P = ctypes.POINTER(ctypes.c_uint64)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.dwt_serialized_size.restype = ctypes.c_uint64
    lib.dwt_serialized_size.argtypes = [
        ctypes.c_uint32, _U8P, _U8P, ctypes.POINTER(_U64P)]
    lib.dwt_serialize.restype = ctypes.c_uint64
    lib.dwt_serialize.argtypes = [
        ctypes.c_uint32, _U8P, _U8P, ctypes.POINTER(_U64P),
        ctypes.POINTER(_U8P), ctypes.c_uint8, _U8P, ctypes.c_uint64]
    lib.dwt_open.restype = ctypes.c_void_p
    lib.dwt_open.argtypes = [_U8P, ctypes.c_uint64]
    lib.dwt_ntensors.restype = ctypes.c_uint32
    lib.dwt_ntensors.argtypes = [ctypes.c_void_p]
    lib.dwt_flags.restype = ctypes.c_uint8
    lib.dwt_flags.argtypes = [ctypes.c_void_p]
    lib.dwt_tensor_info.restype = ctypes.c_int
    lib.dwt_tensor_info.argtypes = [
        ctypes.c_void_p, ctypes.c_uint32, _U8P, _U8P, _U64P, _U64P,
        ctypes.c_uint8]
    lib.dwt_tensor_data.restype = _U8P
    lib.dwt_tensor_data.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
    lib.dwt_close.restype = None
    lib.dwt_close.argtypes = [ctypes.c_void_p]
    return lib


def load() -> ctypes.CDLL:
    """The loaded library, built on first use.  A failed build raises
    (again on every call: the error is kept, not retried)."""
    global _lib, _load_error
    with _lock:
        if _lib is None and _load_error is None:
            try:
                from .native.build import build
                _lib = _bind(ctypes.CDLL(str(build())))
            except Exception as e:
                _load_error = e
        if _load_error is not None:
            raise RuntimeError(
                f"native codec unavailable: {_load_error}") from _load_error
        return _lib


def available() -> bool:
    try:
        load()
    except RuntimeError:
        return False
    return True


def _contig(x):
    """(array, wire dtype): C-contiguous little-endian, the bf16 mark
    read before any conversion could drop it."""
    bf16 = isinstance(x, Bf16Bits)
    x = np.asarray(x)
    wdt = _np_dtype_to_wire(x.dtype, bf16)
    if x.dtype.byteorder == ">":
        x = x.astype(x.dtype.newbyteorder("<"))
    # ascontiguousarray would promote 0-d to 1-d; 0-d is always contiguous
    return (x if x.flags["C_CONTIGUOUS"] else np.ascontiguousarray(x)), wdt


def serialize_tensors(arrays: Sequence[np.ndarray], flags: int = 0,
                      checksum: bool = True) -> bytes:
    lib = load()
    pairs = [_contig(a) for a in arrays]
    arrays = [a for a, _ in pairs]
    n = len(arrays)
    dtypes = (ctypes.c_uint8 * n)(*[int(w) for _, w in pairs])
    ndims = (ctypes.c_uint8 * n)(*[a.ndim for a in arrays])
    dim_arrays = [(ctypes.c_uint64 * a.ndim)(*a.shape) for a in arrays]
    dims = (_U64P * n)(*[ctypes.cast(d, _U64P) for d in dim_arrays])
    datas = (_U8P * n)(*[ctypes.cast(a.ctypes.data, _U8P) for a in arrays])
    size = lib.dwt_serialized_size(n, dtypes, ndims, dims)
    if size == 0 and n > 0:
        raise WireError("native serializer rejected input")
    out = ctypes.create_string_buffer(size)
    written = lib.dwt_serialize(n, dtypes, ndims, dims, datas, flags & 0xFF,
                                ctypes.cast(out, _U8P), size)
    if written != size:
        raise WireError(f"native serializer wrote {written}, expected {size}")
    if not checksum:
        return out.raw
    # the C codec writes 0 into the header's 16-bit field; the binding
    # stamps wire.payload_checksum (the one owner of the math), so native
    # and Python frames stay byte-identical
    buf = bytearray(out.raw)
    struct.pack_into("<H", buf, 6,
                     payload_checksum(memoryview(buf)[_HEADER.size:]))
    return bytes(buf)


def deserialize_tensors(data: bytes) -> TensorMessage:
    lib = load()
    data = bytes(data)
    # the integrity contract of wire.deserialize_tensors: a nonzero header
    # checksum is verified before the C decoder reads any tensor
    verify_checksum(data)
    # c_char_p keeps a reference to `data`; dwt_open copies it
    h = lib.dwt_open(ctypes.cast(ctypes.c_char_p(data), _U8P), len(data))
    if not h:
        raise WireError("native codec rejected message")
    try:
        out: List[np.ndarray] = []
        for i in range(lib.dwt_ntensors(h)):
            dt, nd = ctypes.c_uint8(), ctypes.c_uint8()
            nbytes = ctypes.c_uint64()
            dims = (ctypes.c_uint64 * 16)()
            ok = lib.dwt_tensor_info(h, i, ctypes.byref(dt), ctypes.byref(nd),
                                     ctypes.byref(nbytes), dims, 16)
            if not ok or nd.value > 16:
                raise WireError("native codec: bad tensor info")
            wdt = DType(dt.value)
            np_dt = np.dtype("<u2") if wdt == DType.BF16 else _TO_NP[wdt]
            arr = np.empty(tuple(dims[d] for d in range(nd.value)), np_dt)
            if nbytes.value:
                ctypes.memmove(arr.ctypes.data, lib.dwt_tensor_data(h, i),
                               nbytes.value)
            out.append(arr.view(Bf16Bits) if wdt == DType.BF16 else arr)
        return TensorMessage(tensors=out, flags=lib.dwt_flags(h))
    finally:
        lib.dwt_close(h)
