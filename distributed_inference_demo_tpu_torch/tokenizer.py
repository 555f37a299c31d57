"""Tokenizer facade: Encode/Decode/TokenToId/IdToToken/GetVocabSize.

A copy of ``distributed_inference_demo_tpu/tokenizer.py`` (the port keeps
its own: it imports nothing of the JAX package).  The backends:

- ``python``  -- a pure-Python BPE over the same spec (this file), the
  reference's executable specification of its schemes, and the port's
  default: the ids are the reference's;
- ``hf``      -- the HuggingFace ``tokenizers`` library when present, for
  exactness on exotic tokenizer.json configs;
- ``native``  -- the C++ BPE engine (the port's copy of
  ``comm/native/tokenizer.cc``, built with g++ at first use beside the
  native wire codec, ``comm/native/build.py``), through ``ctypes``: the
  same ids as ``python``.  Asked for explicitly, a failed build raises
  with the compiler's output; there is no fallback.

The port's default stays ``python`` where the reference's is ``native``
(a documented difference: the ids are the same, and the default needs
no compiler).  All consume standard HF ``tokenizer.json`` (lowered to a
line-based blob for the C++ engine); a sentencepiece ``.model``
goes through ``sp_tokenizer.py``.  Schemes covered (enough for the whole
model catalog, ``models/registry.py``): ``bytelevel`` (BLOOM/GPT-2
byte-level BPE) and ``metaspace`` (llama/mistral sentencepiece-style BPE
with <0xXX> byte fallback).
"""

from __future__ import annotations

import ctypes
import functools
import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

# ---------------------------------------------------------------------------
# GPT-2 byte <-> unicode alphabet (matches transformers bytes_to_unicode)
# ---------------------------------------------------------------------------

@functools.lru_cache()
def _byte_to_unicode() -> Dict[int, str]:
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


@functools.lru_cache()
def _unicode_to_byte() -> Dict[str, int]:
    return {v: k for k, v in _byte_to_unicode().items()}


# ---------------------------------------------------------------------------
# tokenizer.json -> spec
# ---------------------------------------------------------------------------

class TokenizerSpec:
    """Parsed tokenizer model: vocab, merges, scheme, specials."""

    def __init__(self, vocab: Dict[str, int], merges: List[Tuple[str, str]],
                 scheme: str, byte_fallback: bool = False,
                 prepend: bool = False, unk_id: int = -1,
                 specials: Optional[Dict[str, int]] = None,
                 bos_id: Optional[int] = None, eos_id: Optional[int] = None):
        self.vocab = vocab
        self.merges = merges
        self.scheme = scheme
        self.byte_fallback = byte_fallback
        self.prepend = prepend
        self.unk_id = unk_id
        self.specials = specials or {}
        self.bos_id = bos_id
        self.eos_id = eos_id
        self.id_to_tok: Dict[int, str] = {}
        for tok, i in vocab.items():
            self.id_to_tok[i] = tok
        for tok, i in self.specials.items():
            self.id_to_tok.setdefault(i, tok)

    @staticmethod
    def from_json(data: Union[str, dict]) -> "TokenizerSpec":
        """Lower an HF tokenizer.json into a spec.

        Scheme detection mirrors what the reference's blob factories switch
        on (FromBlobJSON vs FromBlobSentencePiece vs FromBlobByteLevelBPE,
        ``tokenizers_cpp.h:52-79``): the pre_tokenizer/decoder types.
        """
        if isinstance(data, str):
            data = json.loads(data)
        model = data.get("model", {})
        if model.get("type") not in (None, "BPE"):
            raise ValueError(f"unsupported model type {model.get('type')!r}")
        vocab = dict(model.get("vocab", {}))
        raw_merges = model.get("merges", [])
        merges: List[Tuple[str, str]] = []
        for m in raw_merges:
            if isinstance(m, str):
                left, _, right = m.partition(" ")
                merges.append((left, right))
            else:
                merges.append((m[0], m[1]))

        def _types(section) -> List[str]:
            if section is None:
                return []
            if section.get("type") == "Sequence":
                return [p.get("type") for p in
                        section.get("pretokenizers",
                                    section.get("processors",
                                                section.get("decoders", [])))]
            return [section.get("type")]

        pre = _types(data.get("pre_tokenizer"))
        scheme = "none"
        prepend = False
        if "ByteLevel" in pre:
            scheme = "bytelevel"
        elif "Metaspace" in pre:
            scheme = "metaspace"
            pt = data.get("pre_tokenizer", {})
            parts = ([pt] if pt.get("type") == "Metaspace"
                     else pt.get("pretokenizers", []))
            for p in parts:
                if p.get("type") == "Metaspace":
                    prepend = p.get("prepend_scheme", "always") != "never"
        elif model.get("byte_fallback"):
            scheme = "metaspace"
            prepend = True

        specials = {}
        for tok in data.get("added_tokens", []):
            if tok.get("special"):
                specials[tok["content"]] = tok["id"]
                vocab.setdefault(tok["content"], tok["id"])

        unk = model.get("unk_token")
        unk_id = vocab.get(unk, -1) if unk else -1
        bos_id = next((i for t, i in specials.items()
                       if t in ("<s>", "<|begin_of_text|>", "<bos>")), None)
        eos_id = next((i for t, i in specials.items()
                       if t in ("</s>", "<|end_of_text|>", "<eos>",
                                "<|endoftext|>")), None)
        return TokenizerSpec(vocab, merges, scheme,
                             byte_fallback=bool(model.get("byte_fallback")),
                             prepend=prepend, unk_id=unk_id,
                             specials=specials, bos_id=bos_id, eos_id=eos_id)

    def to_blob(self) -> str:
        """Serialize for the C++ engine (``tokenizer.cc``'s parse_blob)."""
        def esc(s: str) -> str:
            return (s.replace("\\", "\\\\").replace("\n", "\\n")
                    .replace("\t", "\\t"))

        lines = [
            f"scheme\t{self.scheme}",
            f"fallback\t{1 if self.byte_fallback else 0}",
            f"prepend\t{1 if self.prepend else 0}",
            f"unk\t{self.unk_id}",
            f"ntok\t{len(self.vocab)}",
        ]
        for tok, i in self.vocab.items():
            lines.append(f"{i}\t{esc(tok)}")
        lines.append(f"nmerge\t{len(self.merges)}")
        for left, right in self.merges:
            lines.append(f"{esc(left)}\t{esc(right)}")
        lines.append(f"nspecial\t{len(self.specials)}")
        for tok, i in self.specials.items():
            lines.append(f"{i}\t{esc(tok)}")
        return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# Pure-Python BPE (the reference's executable spec; the default backend)
# ---------------------------------------------------------------------------

_WS = set(" \t\n\r\x0b\x0c\xa0  ") | {chr(c) for c in
                                                range(0x2000, 0x200B)}


def _is_ws(c: str) -> bool:
    return c in _WS


def _is_digit(c: str) -> bool:
    return "0" <= c <= "9"


def _is_letter(c: str) -> bool:
    # identical simplification to tokenizer.cc is_letter()
    return ("a" <= c <= "z") or ("A" <= c <= "Z") or (
        ord(c) >= 0x80 and not _is_ws(c))


def pretok_gpt2(text: str) -> List[str]:
    """Simplified GPT-2 pre-tokenization (twin of tokenizer.cc pretok_gpt2)."""
    out: List[str] = []
    n = len(text)
    p = 0
    while p < n:
        c = text[p]
        if c == "'" and p + 1 < n:
            nxt = text[p + 1].lower()
            if nxt in "stmd":
                out.append(text[p:p + 2]); p += 2; continue
            if p + 2 < n and text[p + 1:p + 3].lower() in ("re", "ve", "ll"):
                out.append(text[p:p + 3]); p += 3; continue
        start = p
        lead_space = c == " " and p + 1 < n and not _is_ws(text[p + 1])
        q = p + (1 if lead_space else 0)
        if q < n and _is_letter(text[q]):
            while q < n and _is_letter(text[q]):
                q += 1
            out.append(text[start:q]); p = q; continue
        if q < n and _is_digit(text[q]):
            while q < n and _is_digit(text[q]):
                q += 1
            out.append(text[start:q]); p = q; continue
        if q < n and not _is_ws(text[q]):
            while (q < n and not _is_ws(text[q]) and not _is_letter(text[q])
                   and not _is_digit(text[q])):
                q += 1
            out.append(text[start:q]); p = q; continue
        w = p
        while w < n and _is_ws(text[w]):
            w += 1
        if w < n and w - p > 1:
            out.append(text[p:w - 1]); p = w - 1
        else:
            out.append(text[p:w]); p = w
    return out


def pretok_metaspace(text: str, prepend: bool) -> List[str]:
    meta = "▁"
    s = meta if (prepend and text and not text.startswith(" ")) else ""
    s += text.replace(" ", meta)
    pieces: List[str] = []
    cur = ""
    for ch in s:
        if ch == meta and cur:
            pieces.append(cur)
            cur = ""
        cur += ch
    if cur:
        pieces.append(cur)
    return pieces


class PyBPETokenizer:
    """Pure-Python BPE engine implementing the same spec as tokenizer.cc."""

    def __init__(self, spec: TokenizerSpec):
        self.spec = spec
        self.rank = {pair: i for i, pair in enumerate(spec.merges)}
        self._special_list = sorted(spec.specials, key=len, reverse=True)

    # -- BPE core --
    def _bpe(self, syms: List[str]) -> List[str]:
        while len(syms) > 1:
            best, best_i = None, -1
            for i in range(len(syms) - 1):
                r = self.rank.get((syms[i], syms[i + 1]))
                if r is not None and (best is None or r < best):
                    best, best_i = r, i
            if best is None:
                break
            syms = (syms[:best_i] + [syms[best_i] + syms[best_i + 1]]
                    + syms[best_i + 2:])
        return syms

    def _emit(self, toks: List[str], out: List[int]):
        sp = self.spec
        for tok in toks:
            i = sp.vocab.get(tok)
            if i is not None:
                out.append(i)
            elif sp.byte_fallback:
                for b in tok.encode("utf-8"):
                    fb = f"<0x{b:02X}>"
                    j = sp.vocab.get(fb)
                    if j is not None:
                        out.append(j)
                    elif sp.unk_id >= 0:
                        out.append(sp.unk_id)
            elif sp.unk_id >= 0:
                out.append(sp.unk_id)

    def _encode_plain(self, text: str, out: List[int]):
        sp = self.spec
        if sp.scheme == "bytelevel":
            b2u = _byte_to_unicode()
            for word in pretok_gpt2(text):
                syms = [b2u[b] for b in word.encode("utf-8")]
                self._emit(self._bpe(syms), out)
        elif sp.scheme == "metaspace":
            for word in pretok_metaspace(text, sp.prepend):
                self._emit(self._bpe(list(word)), out)
        else:
            self._emit(self._bpe(list(text)), out)

    # -- public surface --
    def encode(self, text: str) -> List[int]:
        out: List[int] = []
        pending = []
        pos = 0
        n = len(text)
        while pos < n:
            for spc in self._special_list:
                if text.startswith(spc, pos):
                    if pending:
                        self._encode_plain("".join(pending), out)
                        pending = []
                    out.append(self.spec.specials[spc])
                    pos += len(spc)
                    break
            else:
                pending.append(text[pos])
                pos += 1
        if pending:
            self._encode_plain("".join(pending), out)
        return out

    def decode(self, ids: Sequence[int], skip_special: bool = True) -> str:
        sp = self.spec
        special_toks = set(sp.specials)
        if sp.scheme == "bytelevel":
            u2b = _unicode_to_byte()
            data = bytearray()
            for i in ids:
                tok = sp.id_to_tok.get(int(i))
                if tok is None:
                    continue
                if tok in special_toks:
                    if not skip_special:
                        data += tok.encode("utf-8")
                    continue
                for ch in tok:
                    b = u2b.get(ch)
                    if b is not None:
                        data.append(b)
                    else:
                        data += ch.encode("utf-8")
            return data.decode("utf-8", errors="replace")
        data = bytearray()
        for i in ids:
            tok = sp.id_to_tok.get(int(i))
            if tok is None:
                continue
            if tok in special_toks:
                if not skip_special:
                    data += tok.encode("utf-8")
                continue
            if (len(tok) == 6 and tok.startswith("<0x") and tok.endswith(">")):
                try:
                    data.append(int(tok[3:5], 16))
                    continue
                except ValueError:
                    pass
            data += tok.encode("utf-8")
        s = data.decode("utf-8", errors="replace")
        if sp.scheme == "metaspace":
            s = s.replace("▁", " ")
            if sp.prepend and s.startswith(" "):
                s = s[1:]
        return s

    def token_to_id(self, tok: str) -> int:
        return self.spec.vocab.get(tok, -1)

    def id_to_token(self, i: int) -> Optional[str]:
        return self.spec.id_to_tok.get(int(i))

    def vocab_size(self) -> int:
        return max(self.spec.id_to_tok) + 1 if self.spec.id_to_tok else 0


# ---------------------------------------------------------------------------
# Native (C++) backend via ctypes
# ---------------------------------------------------------------------------

class NativeTokenizer:
    """ctypes wrapper over ``comm/native/tokenizer.cc`` (the same surface
    as :class:`PyBPETokenizer`)."""

    def __init__(self, spec: TokenizerSpec):
        from .comm.native.build import build
        self.spec = spec
        self._lib = lib = ctypes.CDLL(str(build()))
        lib.dwt_tok_new.restype = ctypes.c_void_p
        lib.dwt_tok_new.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.dwt_tok_free.argtypes = [ctypes.c_void_p]
        lib.dwt_tok_encode.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                       ctypes.c_uint64]
        lib.dwt_tok_ids_len.restype = ctypes.c_uint64
        lib.dwt_tok_ids_len.argtypes = [ctypes.c_void_p]
        lib.dwt_tok_ids.restype = ctypes.POINTER(ctypes.c_int32)
        lib.dwt_tok_ids.argtypes = [ctypes.c_void_p]
        lib.dwt_tok_decode.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_uint64,
            ctypes.c_int]
        lib.dwt_tok_str_len.restype = ctypes.c_uint64
        lib.dwt_tok_str_len.argtypes = [ctypes.c_void_p]
        lib.dwt_tok_str.restype = ctypes.c_void_p  # read with string_at
        lib.dwt_tok_str.argtypes = [ctypes.c_void_p]
        lib.dwt_tok_token_to_id.restype = ctypes.c_int32
        lib.dwt_tok_token_to_id.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                            ctypes.c_uint64]
        lib.dwt_tok_id_to_token.restype = ctypes.c_int
        lib.dwt_tok_id_to_token.argtypes = [ctypes.c_void_p, ctypes.c_int32]
        lib.dwt_tok_vocab_size.restype = ctypes.c_uint64
        lib.dwt_tok_vocab_size.argtypes = [ctypes.c_void_p]
        blob = spec.to_blob().encode("utf-8")
        self._h = lib.dwt_tok_new(blob, len(blob))
        if not self._h:
            raise ValueError("native tokenizer rejected blob")

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.dwt_tok_free(h)
            self._h = None

    def encode(self, text: str) -> List[int]:
        raw = text.encode("utf-8")
        self._lib.dwt_tok_encode(self._h, raw, len(raw))
        n = self._lib.dwt_tok_ids_len(self._h)
        ptr = self._lib.dwt_tok_ids(self._h)
        return ptr[:n] if n else []

    def decode(self, ids: Sequence[int], skip_special: bool = True) -> str:
        arr = (ctypes.c_int32 * len(ids))(*[int(i) for i in ids])
        self._lib.dwt_tok_decode(self._h, arr, len(ids),
                                 1 if skip_special else 0)
        n = self._lib.dwt_tok_str_len(self._h)
        ptr = self._lib.dwt_tok_str(self._h)
        if n == 0 or not ptr:
            return ""
        return ctypes.string_at(ptr, n).decode("utf-8", errors="replace")

    def token_to_id(self, tok: str) -> int:
        raw = tok.encode("utf-8")
        return self._lib.dwt_tok_token_to_id(self._h, raw, len(raw))

    def id_to_token(self, i: int) -> Optional[str]:
        if not self._lib.dwt_tok_id_to_token(self._h, int(i)):
            return None
        n = self._lib.dwt_tok_str_len(self._h)
        ptr = self._lib.dwt_tok_str(self._h)
        return ctypes.string_at(ptr, n).decode("utf-8") if ptr else ""

    def vocab_size(self) -> int:
        return self._lib.dwt_tok_vocab_size(self._h)


# ---------------------------------------------------------------------------
# Facade
# ---------------------------------------------------------------------------

class Tokenizer:
    """Unified tokenizer with backend selection + bos/eos convenience.

    ``backend``: "python" (the default), "native" (the C++ engine; a
    failed build raises), or "hf" (HuggingFace tokenizers passthrough).
    """

    def __init__(self, impl, spec: TokenizerSpec, backend: str):
        self._impl = impl
        self.spec = spec
        self.backend = backend

    @staticmethod
    def from_sentencepiece(data: Union[bytes, str, Path]) -> "Tokenizer":
        """Load a sentencepiece ``.model`` protobuf blob (reference:
        ``FromBlobSentencePiece``, ``tokenizers_cpp.h:52-79``).  Parsing and
        segmentation are from scratch — see ``sp_tokenizer.py``."""
        from .sp_tokenizer import SPTokenizer, parse_model_proto
        if isinstance(data, (str, Path)):
            data = Path(data).read_bytes()
        model = parse_model_proto(data)
        impl = SPTokenizer(model)
        nb = len(model.pieces)
        spec = TokenizerSpec(
            vocab=dict(impl.piece_to_id), merges=[], scheme="metaspace",
            byte_fallback=model.byte_fallback,
            prepend=model.add_dummy_prefix, unk_id=model.unk_id,
            specials=dict(impl.specials),
            bos_id=model.bos_id if 0 <= model.bos_id < nb else None,
            eos_id=model.eos_id if 0 <= model.eos_id < nb else None)
        return Tokenizer(impl, spec, "sentencepiece")

    @staticmethod
    def from_file(path: Union[str, Path],
                  backend: str = "python") -> "Tokenizer":
        """Auto-detect: ``.model`` protobuf -> sentencepiece;
        otherwise HF tokenizer.json."""
        p = Path(path)
        raw = p.read_bytes()
        text_head = raw.lstrip(b"\xef\xbb\xbf \t\r\n")[:1]
        if p.suffix == ".model" or text_head != b"{":
            return Tokenizer.from_sentencepiece(raw)
        return Tokenizer.from_json(raw.decode("utf-8-sig"), backend=backend)

    @staticmethod
    def from_json(data: Union[str, dict, Path],
                  backend: str = "python") -> "Tokenizer":
        if isinstance(data, Path) or (
                isinstance(data, str) and len(data) < 4096 and
                not data.lstrip().startswith("{") and Path(data).exists()):
            data = Path(data).read_text()
        if backend == "hf":
            try:
                from tokenizers import Tokenizer as HFTok
            except ImportError as e:  # pragma: no cover
                raise RuntimeError("hf backend unavailable") from e
            raw = data if isinstance(data, str) else json.dumps(data)
            spec = TokenizerSpec.from_json(raw)
            return Tokenizer(_HFAdapter(HFTok.from_str(raw)), spec, "hf")
        spec = TokenizerSpec.from_json(data)
        if backend == "native":
            return Tokenizer(NativeTokenizer(spec), spec, "native")
        if backend == "python":
            return Tokenizer(PyBPETokenizer(spec), spec, "python")
        raise ValueError(f"unknown backend {backend!r}")

    # tokenizers_cpp.h:25-48 surface
    def encode(self, text: str, add_bos: bool = False,
               add_eos: bool = False) -> List[int]:
        ids = list(self._impl.encode(text))
        if add_bos and self.spec.bos_id is not None:
            ids = [self.spec.bos_id] + ids
        if add_eos and self.spec.eos_id is not None:
            ids = ids + [self.spec.eos_id]
        return ids

    def decode(self, ids: Sequence[int], skip_special: bool = True) -> str:
        return self._impl.decode(ids, skip_special)

    def token_to_id(self, tok: str) -> int:
        return self._impl.token_to_id(tok)

    def id_to_token(self, i: int) -> Optional[str]:
        return self._impl.id_to_token(i)

    def vocab_size(self) -> int:
        return self._impl.vocab_size()

    @property
    def bos_id(self) -> Optional[int]:
        return self.spec.bos_id

    @property
    def eos_id(self) -> Optional[int]:
        return self.spec.eos_id

    def is_eos(self, token_id: int) -> bool:
        """EOS check by id (the reference compares the decoded string to
        "</s>" per token — ``native-lib.cpp:1485-1495``; comparing ids is
        both faster and correct for multi-eos vocabularies)."""
        return self.spec.eos_id is not None and token_id == self.spec.eos_id


class _HFAdapter:
    def __init__(self, tok):
        self._tok = tok

    def encode(self, text: str) -> List[int]:
        return self._tok.encode(text, add_special_tokens=False).ids

    def decode(self, ids, skip_special=True) -> str:
        return self._tok.decode(list(ids), skip_special_tokens=skip_special)

    def token_to_id(self, tok: str) -> int:
        i = self._tok.token_to_id(tok)
        return -1 if i is None else i

    def id_to_token(self, i: int):
        return self._tok.id_to_token(int(i))

    def vocab_size(self) -> int:
        return self._tok.get_vocab_size()


class StreamDetokenizer:
    """Incremental detokenization for streaming surfaces — ONE owner of
    the boundary rules (the HTTP server's per-row "text" deltas and the
    chat REPL both use it; a per-token ``decode([t])`` would garble
    multi-token UTF-8 and drop sentencepiece inter-token spaces).

    ``push(tok)`` returns the newly printable delta of the full-sequence
    decode, holding back a trailing U+FFFD (a split UTF-8 sequence still
    waiting for its continuation bytes).  ``flush()`` returns whatever
    the holdback kept once the stream ends — the final token may
    legitimately decode to a replacement char.  The re-decode is linear
    per step; a windowed delta would have to re-implement every scheme's
    boundary rules (metaspace strips position-0 spaces) for a cost that
    only matters far past chat lengths."""

    def __init__(self, tokenizer):
        self._tok = tokenizer
        self._ids = []
        self._emitted = ""

    def push(self, tok: int) -> str:
        self._ids.append(int(tok))
        full = self._tok.decode(self._ids)
        while full.endswith("�"):
            full = full[:-1]
        piece = full[len(self._emitted):]
        self._emitted = full
        return piece

    def flush(self) -> str:
        if not self._ids:
            return ""
        full = self._tok.decode(self._ids)
        piece = full[len(self._emitted):]
        self._emitted = full
        return piece
