"""The port's tokenizers against the JAX package's, on the same inputs.

Byte-level and metaspace ``tokenizer.json`` files (the first trained here
with the ``tokenizers`` library, the second built by hand, as
``tests/test_tokenizer.py`` makes them) and a crafted sentencepiece
``.model`` (as ``tests/test_text_e2e.py`` makes one, with byte pieces)
go through both packages' ``Tokenizer`` on every backend (python, hf and
the native C++ engine); ids, text and stream deltas must be equal.
"""

import json
import string

import pytest

from distributed_inference_demo_tpu import sp_tokenizer as ref_sp
from distributed_inference_demo_tpu.tokenizer import \
    StreamDetokenizer as RefStreamDetokenizer
from distributed_inference_demo_tpu.tokenizer import Tokenizer as RefTokenizer
from distributed_inference_demo_tpu_torch import sp_tokenizer as sp
from distributed_inference_demo_tpu_torch.tokenizer import (
    StreamDetokenizer, Tokenizer)

TEXTS = [
    "Hello world! This is a test.",
    "The year 2024's results weren't great...",
    "  leading spaces and\nnewlines\t tabs  ",
    "héllo wörld ünïcode ¡Ω≈ç√",
    "emoji 🙂 and 日本語",
    "<s>hello</s>",
    "x",
    "",
    "a  b   c",
]


@pytest.fixture(scope="module")
def bytelevel_json():
    from tokenizers import Tokenizer as HFTok
    from tokenizers import decoders, pre_tokenizers
    from tokenizers.models import BPE
    from tokenizers.trainers import BpeTrainer

    tok = HFTok(BPE(unk_token=None))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False,
                                                 use_regex=True)
    tok.decoder = decoders.ByteLevel()
    corpus = [t for t in TEXTS if t.strip()] * 50 + [
        "the quick brown fox jumps over the lazy dog"] * 50
    trainer = BpeTrainer(vocab_size=400, special_tokens=["<s>", "</s>"],
                         show_progress=False)
    tok.train_from_iterator(corpus, trainer)
    return tok.to_str()


@pytest.fixture(scope="module")
def metaspace_json():
    pieces = ["<unk>", "<s>", "</s>"]
    pieces += [f"<0x{b:02X}>" for b in range(256)]
    base = list("▁abcdefghijklmnopqrstuvwxyz.!?'")
    words = ["▁hello", "▁world", "▁the", "▁test", "hel", "llo", "wor",
             "ld", "th", "he", "st", "▁t", "▁w", "▁h", "es", "te"]
    vocab = {}
    for p in pieces + base + words:
        vocab.setdefault(p, len(vocab))
    merges = [["th", "e"], ["h", "e"], ["e", "s"], ["t", "e"],
              ["▁", "t"], ["▁", "w"], ["▁", "h"], ["he", "l"],
              ["l", "lo"], ["l", "o"], ["l", "l"], ["hel", "lo"],
              ["wor", "ld"], ["w", "or"], ["o", "r"], ["w", "o"]]
    merges = [m for m in merges
              if m[0] in vocab and m[1] in vocab and m[0] + m[1] in vocab]
    return json.dumps({
        "model": {"type": "BPE", "vocab": vocab,
                  "merges": [f"{a} {b}" for a, b in merges],
                  "unk_token": "<unk>", "byte_fallback": True},
        "pre_tokenizer": {"type": "Metaspace", "replacement": "▁",
                          "prepend_scheme": "always", "split": True},
        "decoder": {"type": "Sequence", "decoders": [
            {"type": "Replace", "pattern": {"String": "▁"}, "content": " "},
            {"type": "ByteFallback"}, {"type": "Fuse"},
            {"type": "Strip", "content": " ", "start": 1, "stop": 0}]},
        "added_tokens": [
            {"id": i, "content": c, "special": True, "single_word": False,
             "lstrip": False, "rstrip": False, "normalized": False}
            for i, c in ((0, "<unk>"), (1, "<s>"), (2, "</s>"))],
    })


def _sp_pieces(mod):
    """A unigram ``.model`` with control pieces, words, letters and the
    256 byte pieces (byte fallback), built by each package's writer."""
    pieces = [("<unk>", 0.0, mod.UNKNOWN), ("<s>", 0.0, mod.CONTROL),
              ("</s>", 0.0, mod.CONTROL)]
    pieces += [(f"<0x{b:02X}>", 0.0, mod.BYTE) for b in range(256)]
    words = ["hello", "world", "the", "cat", "sat", "on", "mat", "a"]
    pieces += [(f"▁{w}", -float(i + 1), mod.NORMAL)
               for i, w in enumerate(words)]
    pieces += [(c, -50.0, mod.NORMAL) for c in string.ascii_lowercase]
    pieces += [("▁", -60.0, mod.NORMAL)]
    return pieces


@pytest.fixture(scope="module")
def sp_model(tmp_path_factory):
    blob = sp.build_model_proto(_sp_pieces(sp))
    path = tmp_path_factory.mktemp("sp") / "tiny.model"
    path.write_bytes(blob)
    return path, blob


def _pair(kind, src, backend):
    if kind == "sp":
        return (Tokenizer.from_file(src[0]), RefTokenizer.from_file(src[0]))
    return (Tokenizer.from_json(src, backend=backend),
            RefTokenizer.from_json(src, backend=backend))


def test_model_proto_bytes_equal_reference():
    assert (sp.build_model_proto(_sp_pieces(sp))
            == ref_sp.build_model_proto(_sp_pieces(ref_sp)))


@pytest.mark.parametrize("backend", ["python", "hf", "native"])
@pytest.mark.parametrize("kind", ["bytelevel", "metaspace"])
def test_json_tokenizers_equal_reference(kind, backend, bytelevel_json,
                                         metaspace_json):
    src = bytelevel_json if kind == "bytelevel" else metaspace_json
    port, ref = _pair(kind, src, backend)
    assert port.backend == backend
    for text in TEXTS:
        ids = port.encode(text, add_bos=True, add_eos=True)
        assert ids == ref.encode(text, add_bos=True, add_eos=True), text
        for skip in (True, False):
            assert port.decode(ids, skip) == ref.decode(ids, skip), text
    assert port.vocab_size() == ref.vocab_size()
    assert (port.bos_id, port.eos_id) == (ref.bos_id, ref.eos_id)
    for i in (0, 1, 2, 5, 100, 10 ** 6):
        assert port.id_to_token(i) == ref.id_to_token(i)
        tok = ref.id_to_token(i)
        if tok is not None:
            assert port.token_to_id(tok) == ref.token_to_id(tok)


def test_sentencepiece_model_equal_reference(sp_model):
    port, ref = _pair("sp", sp_model, None)
    assert port.backend == ref.backend == "sentencepiece"
    # byte fallback: characters without a piece go through <0xXX> pieces
    texts = TEXTS + ["the cat sat on the mat", "hello ☃ world"]
    for text in texts:
        ids = port.encode(text)
        assert ids == ref.encode(text), text
        assert port.decode(ids) == ref.decode(ids), text
    assert any(3 <= i < 259 for i in port.encode("☃"))
    assert port.spec.eos_id == ref.spec.eos_id == 2


@pytest.mark.parametrize("kind", ["bytelevel", "metaspace", "sp"])
def test_stream_detokenizer_deltas_equal_reference(kind, bytelevel_json,
                                                   metaspace_json, sp_model):
    src = {"bytelevel": bytelevel_json, "metaspace": metaspace_json,
           "sp": sp_model}[kind]
    port, ref = _pair(kind, src, "python")
    ids = port.encode("héllo wörld 🙂 the cat sat, the test!")
    pd, rd = StreamDetokenizer(port), RefStreamDetokenizer(ref)
    deltas = [pd.push(t) for t in ids]
    assert deltas == [rd.push(t) for t in ids]
    assert pd.flush() == rd.flush()
    assert "".join(deltas) == port.decode(ids)


def test_native_backend_names_its_roadmap_item(metaspace_json, tmp_path):
    """The native backend is served (built from the port's own sources)
    and its ids equal the python backend's, from a string and a file."""
    path = tmp_path / "tokenizer.json"
    path.write_text(metaspace_json)
    python = Tokenizer.from_json(metaspace_json, backend="python")
    for native in (Tokenizer.from_json(metaspace_json, backend="native"),
                   Tokenizer.from_file(path, backend="native")):
        assert native.backend == "native"
        for text in TEXTS:
            assert native.encode(text) == python.encode(text), text
    # the default is the python backend, for a file and for a string
    assert Tokenizer.from_file(path).backend == "python"
    assert Tokenizer.from_json(metaspace_json).backend == "python"
