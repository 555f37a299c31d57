"""Versioned, endian-explicit tensor wire format.

Replaces the reference's cross-device serialization protocol
(``cpp/utils.cpp:124-368``): ``[numTensors: size_t][dtype, ndims, dims...,
raw]`` in *native* endianness with ``size_t`` fields — defect #9 in
SURVEY.md Appendix B (not portable across hosts).  This format fixes that:

- explicit little-endian for every header field and for raw data;
- fixed-width field types (no ``size_t``);
- a 4-byte magic + 1-byte version so the receiver can reject garbage and
  future revisions can evolve the layout;
- bfloat16 as a first-class dtype (the TPU-native activation dtype — the
  reference's ORT path had no bf16 at the wire, forcing f32 activations).

Layout (all little-endian):

    header:  magic "DWT1" | version:u8 | flags:u8 | checksum:u16 | ntensors:u32
    tensor:  dtype:u8 | ndims:u8 | reserved:u16 | nbytes:u64 | dims:u64*ndims
             | raw bytes (C-contiguous)

The message header's 16-bit field (once reserved) carries an
integrity checksum over everything after the header: CRC-32 of the
payload XOR-folded to 16 bits, with 0 remapped to 0xFFFF so the value 0
unambiguously means "no checksum" — frames from pre-checksum peers (and
``checksum=False`` senders) decode unchanged, while a corrupt frame
raises :class:`WireIntegrityError` instead of decoding garbage
activations into a wrong token.  The fold keeps CRC-32's guarantee for
single-bit flips and detects random corruption with 1 - 2^-16
probability; the native codec (``native_codec.py``) reads and writes the
same field, byte-identically.

Token ids travel as 4-byte little-endian ints (reference
``utils.cpp:11-25`` used native-endian).

numpy has no bfloat16 dtype and this package does not depend on
``ml_dtypes``, so a bfloat16 tensor travels as its ``uint16`` bit view
under :data:`DType.BF16`: :func:`bf16_view` marks an array that way
(``torch.Tensor.view(torch.uint16)`` gives the bits), and the decoder
hands code 3 back as a :class:`Bf16Bits` array of ``uint16``.  The frame
bytes are the same as for a true bfloat16 array.
"""

from __future__ import annotations

import enum
import struct
import zlib
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

MAGIC = b"DWT1"
VERSION = 1
_HEADER = struct.Struct("<4sBBHI")          # magic, version, flags, rsv, n
_TENSOR_HDR = struct.Struct("<BBHQ")        # dtype, ndims, rsv, nbytes

# flags bit 0: the message carries a trace-context trailer — the LAST
# tensor is a u64[2] of (trace_id, parent_span_id) appended by
# serialize_tensors_traced and stripped by split_trace_context.  The
# trailer is a perfectly ordinary tensor counted in ntensors, so decoders
# that predate the bit (including native/codec.cc, which returns flags
# verbatim and never interprets them) decode traced frames without
# change; frames without the bit are byte-identical to the pre-trace
# format.  Bits 1-7 stay reserved.
FLAG_TRACE_CONTEXT = 0x01


class DType(enum.IntEnum):
    """Wire dtype enum (stable across versions; extend, never renumber).

    Mirrors the 11-dtype table of the reference's ``CopyOrtValue``
    (``utils.cpp:49-113``) plus bfloat16.
    """

    F32 = 0
    F64 = 1
    F16 = 2
    BF16 = 3
    I8 = 4
    I16 = 5
    I32 = 6
    I64 = 7
    U8 = 8
    U16 = 9
    U32 = 10
    U64 = 11
    BOOL = 12


_TO_NP = {
    DType.F32: np.dtype("<f4"), DType.F64: np.dtype("<f8"),
    DType.F16: np.dtype("<f2"),
    DType.I8: np.dtype("i1"), DType.I16: np.dtype("<i2"),
    DType.I32: np.dtype("<i4"), DType.I64: np.dtype("<i8"),
    DType.U8: np.dtype("u1"), DType.U16: np.dtype("<u2"),
    DType.U32: np.dtype("<u4"), DType.U64: np.dtype("<u8"),
    DType.BOOL: np.dtype("bool"),
}
_FROM_NP = {v: k for k, v in _TO_NP.items()}


class Bf16Bits(np.ndarray):
    """A ``uint16`` array that holds bfloat16 bit patterns: it goes on
    the wire as :data:`DType.BF16` (code 3), and bf16 frames decode to
    it.  Views and slices keep the subclass."""


def bf16_view(a) -> np.ndarray:
    """``a`` (uint16 bit patterns, e.g. ``t.view(torch.uint16).numpy()``)
    marked as bfloat16 for the wire."""
    a = np.asarray(a)
    if a.dtype != np.uint16:
        raise WireError(f"bf16_view wants uint16 bits, got {a.dtype}")
    return a.view(Bf16Bits)


class WireError(ValueError):
    """Malformed or incompatible wire payload."""


class WireIntegrityError(WireError):
    """Checksum mismatch: the frame was corrupted in flight.  Receivers
    treat this as a droppable event (counted + flight-recorded) — the
    step-timeout/elastic-reshard path recovers, never a wrong token."""


def payload_checksum(payload) -> int:  # bytes or memoryview
    """CRC-32 of ``payload`` XOR-folded to 16 bits, never 0 (0 is the
    wire's "no checksum" sentinel).  One owner for the math — the native
    codec binding uses this exact function so both codecs stay
    byte-identical."""
    c = zlib.crc32(payload) & 0xFFFFFFFF
    folded = (c & 0xFFFF) ^ (c >> 16)
    return folded or 0xFFFF


def verify_checksum(data: bytes) -> None:
    """Raise :class:`WireIntegrityError` when ``data``'s header carries a
    nonzero checksum that does not match its payload.  Zero-checksum
    frames (pre-checksum peers) pass — version compat.  Shared by both
    codecs; structural validation stays the decoder's job."""
    if len(data) < _HEADER.size:
        return                     # the decoder's short-message error wins
    (claimed,) = struct.unpack_from("<H", data, 6)
    if claimed == 0:
        return
    # memoryview: CRC the payload in place — no full-frame copy on the
    # per-hop receive path
    actual = payload_checksum(memoryview(data)[_HEADER.size:])
    if actual != claimed:
        raise WireIntegrityError(
            f"wire checksum mismatch: header says 0x{claimed:04x}, "
            f"payload is 0x{actual:04x} ({len(data)} bytes) — frame "
            "corrupted in flight")


@dataclass
class TensorMessage:
    """A decoded wire payload: a list of ndarrays plus the header flags."""

    tensors: List[np.ndarray]
    flags: int = 0


def _np_dtype_to_wire(dt: np.dtype, bf16: bool = False) -> DType:
    if bf16:
        return DType.BF16
    dt = np.dtype(dt)
    # normalize endianness: the wire is little-endian
    key = dt.newbyteorder("<") if dt.byteorder == ">" else dt
    try:
        return _FROM_NP[key]
    except KeyError:
        raise WireError(f"unsupported dtype for wire: {dt}") from None


def serialize_tensors(arrays: Sequence[np.ndarray], flags: int = 0,
                      checksum: bool = True) -> bytes:
    """Encode a sequence of arrays into one wire message.

    Counterpart of ``SerializeTensorVectorToBytes`` (``utils.cpp:124-264``),
    including its total-size self-check — here the check is structural
    (we build the buffer piecewise and verify the final length).

    ``checksum=False`` emits the pre-checksum frame (header field 0) —
    the knob exists for compat tests and for peers that must talk to
    pre-checksum decoders, not for the hot path (the CRC costs ~1 GB/s-
    class zlib time, negligible next to serialization itself).
    """
    parts = []
    expected = 0
    for a in arrays:
        bf16 = isinstance(a, Bf16Bits)
        a = np.asarray(a)
        if not a.flags["C_CONTIGUOUS"]:  # 0-d arrays are always contiguous,
            a = np.ascontiguousarray(a)  # so this never promotes 0-d to 1-d

        wdt = _np_dtype_to_wire(a.dtype, bf16)
        if a.dtype.byteorder == ">":
            a = a.astype(a.dtype.newbyteorder("<"))
        raw = a.tobytes()
        parts.append(_TENSOR_HDR.pack(int(wdt), a.ndim, 0, len(raw)))
        parts.append(struct.pack(f"<{a.ndim}Q", *a.shape))
        parts.append(raw)
        expected += _TENSOR_HDR.size + 8 * a.ndim + len(raw)
    payload = b"".join(parts)
    if len(payload) != expected:  # structural self-check (utils.cpp:250-261)
        raise WireError(
            f"serializer size mismatch: {len(payload)} != {expected}")
    csum = payload_checksum(payload) if checksum else 0
    return _HEADER.pack(MAGIC, VERSION, flags & 0xFF, csum,
                        len(arrays)) + payload


def deserialize_tensors(data: bytes) -> TensorMessage:
    """Decode one wire message.  Counterpart of
    ``DeserializeTensorVectorFromBytes`` (``utils.cpp:266-368``)."""
    if len(data) < _HEADER.size:
        raise WireError(f"short message: {len(data)} bytes")
    magic, version, flags, csum, n = _HEADER.unpack_from(data, 0)
    if magic != MAGIC:
        raise WireError(f"bad magic {magic!r}")
    if version != VERSION:
        raise WireError(f"unsupported wire version {version}")
    if csum:
        # verified BEFORE any tensor parsing: a corrupt frame must raise
        # WireIntegrityError, never decode garbage (csum 0 = legacy peer)
        verify_checksum(data)
    off = _HEADER.size
    out: List[np.ndarray] = []
    for _ in range(n):
        if off + _TENSOR_HDR.size > len(data):
            raise WireError("truncated tensor header")
        dt_raw, ndims, _rsv, nbytes = _TENSOR_HDR.unpack_from(data, off)
        off += _TENSOR_HDR.size
        try:
            wdt = DType(dt_raw)
            np_dt = (np.dtype("<u2") if wdt == DType.BF16
                     else _TO_NP[wdt])
        except (ValueError, KeyError):
            raise WireError(f"unknown wire dtype {dt_raw}") from None
        if off + 8 * ndims > len(data):
            raise WireError("truncated dims")
        dims = struct.unpack_from(f"<{ndims}Q", data, off)
        off += 8 * ndims
        count = 1
        for d in dims:
            count *= d
        if count * np_dt.itemsize != nbytes:
            raise WireError(
                f"nbytes {nbytes} inconsistent with shape {dims} {np_dt}")
        if off + nbytes > len(data):
            raise WireError("truncated tensor data")
        arr = np.frombuffer(data, np_dt, count=count, offset=off)
        arr = arr.reshape(dims).copy()         # own the memory
        out.append(arr.view(Bf16Bits) if wdt == DType.BF16 else arr)
        off += nbytes
    if off != len(data):
        raise WireError(f"{len(data) - off} trailing bytes")
    return TensorMessage(tensors=out, flags=flags)


def serialize_tensors_traced(arrays: Sequence[np.ndarray],
                             trace_id: Optional[int],
                             parent_span_id: int = 0,
                             flags: int = 0) -> bytes:
    """Encode ``arrays`` with an optional trace-context trailer.

    ``trace_id=None`` is byte-identical to :func:`serialize_tensors`
    (tracing off costs nothing on the wire); otherwise a u64[2]
    ``[trace_id, parent_span_id]`` tensor is appended and
    :data:`FLAG_TRACE_CONTEXT` set so the receiver can strip it with
    :func:`split_trace_context`.
    """
    if trace_id is None:
        return serialize_tensors(arrays, flags)
    trailer = np.array([trace_id & _U64_MASK,
                        parent_span_id & _U64_MASK], dtype="<u8")
    return serialize_tensors(list(arrays) + [trailer],
                             flags | FLAG_TRACE_CONTEXT)


_U64_MASK = (1 << 64) - 1


def split_trace_context(msg: TensorMessage):
    """``(tensors, (trace_id, parent_span_id) | None)`` from a decoded
    message.  Messages without :data:`FLAG_TRACE_CONTEXT` pass through
    untouched; a set flag with a malformed trailer is a hard
    :class:`WireError` (a half-stripped payload would silently shift
    every tensor index downstream)."""
    if not (msg.flags & FLAG_TRACE_CONTEXT):
        return msg.tensors, None
    if not msg.tensors:
        raise WireError("trace-context flag set on an empty message")
    trailer = msg.tensors[-1]
    if trailer.dtype != np.dtype("<u8") or trailer.shape != (2,):
        raise WireError(
            f"malformed trace-context trailer: {trailer.dtype} "
            f"{trailer.shape}")
    return msg.tensors[:-1], (int(trailer[0]), int(trailer[1]))


def serialize_token(token_id: int) -> bytes:
    """4-byte little-endian token id (reference ``utils.cpp:11-17``)."""
    return struct.pack("<i", token_id)


def deserialize_token(data: bytes) -> int:
    """Counterpart of ``DeserializeInt`` (``utils.cpp:19-25``)."""
    if len(data) != 4:
        raise WireError(f"token message must be 4 bytes, got {len(data)}")
    return struct.unpack("<i", data)[0]
