"""SentencePiece ``.model`` support, from scratch (no sentencepiece dep).

The reference consumes SP protobuf blobs through its vendored C++ tree via
``FromBlobSentencePiece`` (``tokenizers_cpp.h:52-79``, used at
``cpp/inference.cpp:88-94``).  This module provides the same capability with
zero vendored code: a minimal protobuf **wire-format** parser for the three
ModelProto sections we need (pieces, TrainerSpec, NormalizerSpec), plus both
SP segmentation algorithms:

- **unigram** — Viterbi segmentation maximizing the sum of piece log-probs;
- **bpe** — score-driven greedy merging (highest-scoring merged piece first,
  NOT rank-ordered merges like HF BPE).

A matching encoder (``build_model_proto``) lets tests craft tiny ``.model``
files without the sentencepiece library and serves as the host-side
".model -> blob" lowering tool.

A copy of ``distributed_inference_demo_tpu/sp_tokenizer.py``.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union


# ---------------------------------------------------------------------------
# Minimal protobuf wire format (decode + encode)
# ---------------------------------------------------------------------------

def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("malformed varint")


def _write_varint(value: int) -> bytes:
    if value < 0:
        value += 1 << 64  # protobuf negative ints: two's complement 64-bit
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _signed(value: int) -> int:
    """Interpret a decoded varint as a signed 64-bit int."""
    return value - (1 << 64) if value >= (1 << 63) else value


def parse_message(buf: bytes) -> Dict[int, list]:
    """Decode one protobuf message into {field_number: [raw values]}.

    Values are ints for varint fields, bytes for length-delimited fields,
    and 4/8-byte structs left packed for fixed-width fields.
    """
    fields: Dict[int, list] = {}
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        fnum, wtype = tag >> 3, tag & 7
        if wtype == 0:      # varint
            val, pos = _read_varint(buf, pos)
        elif wtype == 1:    # 64-bit
            val, pos = buf[pos:pos + 8], pos + 8
        elif wtype == 2:    # length-delimited
            ln, pos = _read_varint(buf, pos)
            val, pos = buf[pos:pos + ln], pos + ln
        elif wtype == 5:    # 32-bit
            val, pos = buf[pos:pos + 4], pos + 4
        else:
            raise ValueError(f"unsupported wire type {wtype}")
        fields.setdefault(fnum, []).append(val)
    return fields


def _emit_field(fnum: int, wtype: int, payload: bytes) -> bytes:
    return _write_varint((fnum << 3) | wtype) + payload


def emit_varint_field(fnum: int, value: int) -> bytes:
    return _emit_field(fnum, 0, _write_varint(value))


def emit_bytes_field(fnum: int, value: bytes) -> bytes:
    return _emit_field(fnum, 2, _write_varint(len(value)) + value)


def emit_float_field(fnum: int, value: float) -> bytes:
    return _emit_field(fnum, 5, struct.pack("<f", value))


# ---------------------------------------------------------------------------
# ModelProto schema subset (sentencepiece_model.proto)
# ---------------------------------------------------------------------------

# SentencePiece.type enum
NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6
# TrainerSpec.model_type enum
UNIGRAM, BPE = 1, 2


@dataclass
class SPModel:
    """Parsed subset of a sentencepiece ModelProto."""

    pieces: List[Tuple[str, float, int]]  # (piece, score, type)
    model_type: int = UNIGRAM
    unk_id: int = 0
    bos_id: int = 1
    eos_id: int = 2
    add_dummy_prefix: bool = True
    escape_whitespaces: bool = True
    byte_fallback: bool = False


def parse_model_proto(data: Union[bytes, str, Path]) -> SPModel:
    """Parse a ``.model`` blob (or path) into an SPModel."""
    if isinstance(data, (str, Path)):
        data = Path(data).read_bytes()
    root = parse_message(data)

    pieces: List[Tuple[str, float, int]] = []
    for raw in root.get(1, []):          # repeated SentencePiece pieces = 1
        f = parse_message(raw)
        piece = f[1][0].decode("utf-8") if 1 in f else ""
        score = struct.unpack("<f", f[2][0])[0] if 2 in f else 0.0
        ptype = _signed(f[3][0]) if 3 in f else NORMAL
        pieces.append((piece, score, ptype))

    model = SPModel(pieces=pieces)
    if 2 in root:                        # TrainerSpec trainer_spec = 2
        t = parse_message(root[2][0])
        if 3 in t:
            model.model_type = _signed(t[3][0])
        if 35 in t:                      # byte_fallback = 35 (bool)
            model.byte_fallback = bool(t[35][0])
        if 40 in t:
            model.unk_id = _signed(t[40][0])
        if 41 in t:
            model.bos_id = _signed(t[41][0])
        if 42 in t:
            model.eos_id = _signed(t[42][0])
    if 3 in root:                        # NormalizerSpec normalizer_spec = 3
        nz = parse_message(root[3][0])
        if 3 in nz:
            model.add_dummy_prefix = bool(nz[3][0])
        if 5 in nz:
            model.escape_whitespaces = bool(nz[5][0])
    if not model.byte_fallback:
        model.byte_fallback = any(t == BYTE for _, _, t in pieces)
    return model


def build_model_proto(pieces: Sequence[Tuple[str, float, int]],
                      model_type: int = UNIGRAM,
                      unk_id: int = 0, bos_id: int = 1, eos_id: int = 2,
                      add_dummy_prefix: bool = True,
                      escape_whitespaces: bool = True) -> bytes:
    """Encode an SP ModelProto blob (test fixtures / lowering tool)."""
    out = bytearray()
    for piece, score, ptype in pieces:
        body = (emit_bytes_field(1, piece.encode("utf-8"))
                + emit_float_field(2, score)
                + emit_varint_field(3, ptype))
        out += emit_bytes_field(1, body)
    trainer = (emit_varint_field(3, model_type)
               + emit_varint_field(40, unk_id)
               + emit_varint_field(41, bos_id)
               + emit_varint_field(42, eos_id))
    out += emit_bytes_field(2, trainer)
    norm = (emit_varint_field(3, int(add_dummy_prefix))
            + emit_varint_field(5, int(escape_whitespaces)))
    out += emit_bytes_field(3, norm)
    return bytes(out)


# ---------------------------------------------------------------------------
# Segmentation
# ---------------------------------------------------------------------------

_META = "▁"  # ▁
_UNK_PENALTY = 10.0


class SPTokenizer:
    """Encode/Decode for a parsed SPModel (unigram Viterbi or score-BPE).

    Surface-compatible with the facade impls in ``tokenizer.py``
    (encode / decode / token_to_id / id_to_token / vocab_size).
    """

    def __init__(self, model: SPModel):
        self.model = model
        self.piece_to_id: Dict[str, int] = {}
        self.scores: Dict[str, float] = {}
        self.specials: Dict[str, int] = {}
        self.byte_pieces: Dict[int, int] = {}
        self.max_piece_len = 1
        for i, (piece, score, ptype) in enumerate(model.pieces):
            if piece not in self.piece_to_id:
                self.piece_to_id[piece] = i
            if ptype in (NORMAL, USER_DEFINED):
                self.scores[piece] = score
                self.max_piece_len = max(self.max_piece_len, len(piece))
            elif ptype == CONTROL:
                self.specials[piece] = i
            elif ptype == BYTE and len(piece) == 6:  # "<0xAB>"
                self.byte_pieces[int(piece[3:5], 16)] = i
        self.min_score = min(self.scores.values()) if self.scores else 0.0
        self._special_list = sorted(self.specials, key=len, reverse=True)

    # -- normalization ----------------------------------------------------
    def _normalize(self, text: str) -> str:
        if self.model.escape_whitespaces:
            text = text.replace(" ", _META)
        if self.model.add_dummy_prefix and text:
            # unconditional, like sentencepiece: ' ab' -> '▁▁ab'
            text = _META + text
        return text

    # -- unigram Viterbi --------------------------------------------------
    def _segment_unigram(self, s: str) -> List[str]:
        n = len(s)
        NEG = float("-inf")
        best = [NEG] * (n + 1)
        back = [0] * (n + 1)
        best[0] = 0.0
        unk_score = self.min_score - _UNK_PENALTY
        for i in range(1, n + 1):
            lo = max(0, i - self.max_piece_len)
            for j in range(lo, i):
                if best[j] == NEG:
                    continue
                sc = self.scores.get(s[j:i])
                if sc is None:
                    if i - j == 1:
                        sc = unk_score  # single-char unknown fallback
                    else:
                        continue
                if best[j] + sc > best[i]:
                    best[i] = best[j] + sc
                    back[i] = j
        out: List[str] = []
        i = n
        while i > 0:
            j = back[i]
            out.append(s[j:i])
            i = j
        out.reverse()
        return out

    # -- score-driven BPE -------------------------------------------------
    def _segment_bpe(self, s: str) -> List[str]:
        """Priority-queue merge, O(n log n): pop the highest-scoring live
        adjacent pair (leftmost on ties), merge, requeue the two pairs the
        merge created.  Stale heap entries are detected by snapshot
        comparison against the linked list."""
        import heapq

        n = len(s)
        if n <= 1:
            return list(s)
        sym = list(s)
        nxt = list(range(1, n)) + [-1]
        prv = [-1] + list(range(0, n - 1))
        alive = [True] * n
        heap: List[Tuple[float, int, int, str]] = []

        def push(i: int) -> None:
            j = nxt[i]
            if i == -1 or j == -1:
                return
            merged = sym[i] + sym[j]
            sc = self.scores.get(merged)
            if sc is not None:
                heapq.heappush(heap, (-sc, i, j, merged))

        for i in range(n - 1):
            push(i)
        while heap:
            _, i, j, merged = heapq.heappop(heap)
            if not (alive[i] and alive[j]) or nxt[i] != j \
                    or sym[i] + sym[j] != merged:
                continue  # stale entry
            sym[i] = merged
            alive[j] = False
            nxt[i] = nxt[j]
            if nxt[j] != -1:
                prv[nxt[j]] = i
            push(prv[i])
            push(i)
        out = []
        i = 0
        while i != -1:
            out.append(sym[i])
            i = nxt[i]
        return out

    # -- public surface ---------------------------------------------------
    def _encode_plain(self, text: str, out: List[int]) -> None:
        s = self._normalize(text)
        if not s:
            return
        seg = (self._segment_bpe(s) if self.model.model_type == BPE
               else self._segment_unigram(s))
        for piece in seg:
            i = self.piece_to_id.get(piece)
            if i is not None and piece in self.scores:
                out.append(i)
            elif self.model.byte_fallback and self.byte_pieces:
                for b in piece.encode("utf-8"):
                    out.append(self.byte_pieces.get(b, self.model.unk_id))
            else:
                out.append(self.model.unk_id)

    def encode(self, text: str) -> List[int]:
        out: List[int] = []
        pending: List[str] = []
        pos, n = 0, len(text)
        while pos < n:
            for spc in self._special_list:
                if text.startswith(spc, pos):
                    if pending:
                        self._encode_plain("".join(pending), out)
                        pending = []
                    out.append(self.specials[spc])
                    pos += len(spc)
                    break
            else:
                pending.append(text[pos])
                pos += 1
        if pending:
            self._encode_plain("".join(pending), out)
        return out

    def decode(self, ids: Sequence[int], skip_special: bool = True) -> str:
        pieces = self.model.pieces
        data = bytearray()
        for i in ids:
            i = int(i)
            if not 0 <= i < len(pieces):
                continue
            piece, _, ptype = pieces[i]
            if ptype == CONTROL or ptype == UNKNOWN:
                if not skip_special:
                    data += piece.encode("utf-8")
                continue
            if ptype == BYTE and len(piece) == 6:
                data.append(int(piece[3:5], 16))
                continue
            data += piece.encode("utf-8")
        s = data.decode("utf-8", errors="replace")
        s = s.replace(_META, " ")
        if self.model.add_dummy_prefix and s.startswith(" "):
            s = s[1:]
        return s

    def token_to_id(self, tok: str) -> int:
        return self.piece_to_id.get(tok, -1)

    def id_to_token(self, i: int) -> Optional[str]:
        i = int(i)
        if 0 <= i < len(self.model.pieces):
            return self.model.pieces[i][0]
        return None

    def vocab_size(self) -> int:
        return len(self.model.pieces)
