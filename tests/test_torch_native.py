"""The port's native comm library (``comm/native``): the wire codec
(``comm/native_codec.py``) and the C++ tokenizer backend, against the
port's ``comm/wire.py``, its python tokenizer and the JAX package's
native codec and tokenizer.

The library is built here with g++ from the port's own copies of the
sources, into ``build/native/`` under a name that hashes them.
"""

import ml_dtypes
import numpy as np
import pytest

from distributed_inference_demo_tpu.comm import native_codec as ref_native
from distributed_inference_demo_tpu.comm import wire as ref_wire
from distributed_inference_demo_tpu.tokenizer import Tokenizer as RefTokenizer
from distributed_inference_demo_tpu_torch.comm import native_codec as native
from distributed_inference_demo_tpu_torch.comm import wire
from distributed_inference_demo_tpu_torch.comm.native import build
from distributed_inference_demo_tpu_torch.tokenizer import Tokenizer
from test_torch_tokenizer import TEXTS, bytelevel_json, metaspace_json

__all__ = ["bytelevel_json", "metaspace_json"]
RS = np.random.RandomState(0)
ARRAYS = {
    "f32": RS.randn(3, 5).astype(np.float32),
    "f64": RS.randn(4).astype(np.float64),
    "f16": RS.randn(2, 2).astype(np.float16),
    "bf16": wire.bf16_view(RS.randint(0, 1 << 16, (2, 3, 4))
                           .astype(np.uint16)),
    "i8": RS.randint(-128, 127, 7).astype(np.int8),
    "i16": RS.randint(-999, 999, 5).astype(np.int16),
    "i32": RS.randint(0, 32000, (1, 9)).astype(np.int32),
    "i64": np.arange(6, dtype=np.int64).reshape(2, 3),
    "u8": RS.randint(0, 255, 11).astype(np.uint8),
    "u16": RS.randint(0, 1 << 16, 3).astype(np.uint16),
    "u32": RS.randint(0, 1 << 30, 3).astype(np.uint32),
    "u64": np.array([1, 1 << 63], dtype=np.uint64),
    "bool": np.array([True, False, True]),
    "scalar": np.array(7, np.int32),
    "empty": np.zeros((0, 4), np.float32),
    "strided": RS.randn(4, 6).astype(np.float32)[:, ::2],
    "big-endian": np.arange(5, dtype=">i4"),
}


def _for_reference(a):
    """The same tensor as the JAX package takes it (bf16 as
    ``ml_dtypes.bfloat16``)."""
    if isinstance(a, wire.Bf16Bits):
        return np.asarray(a, np.uint16).view(ml_dtypes.bfloat16)
    return a


@pytest.mark.parametrize("name", sorted(ARRAYS))
def test_frames_equal_wire_and_reference_native(name):
    arrays = [ARRAYS[name], ARRAYS["i32"]]
    for flags, checksum in ((0, True), (wire.FLAG_TRACE_CONTEXT, True),
                            (0, False)):
        frame = native.serialize_tensors(arrays, flags, checksum)
        assert frame == wire.serialize_tensors(arrays, flags, checksum)
        assert frame == ref_native.serialize_tensors(
            [_for_reference(a) for a in arrays], flags, checksum)
        msg = native.deserialize_tensors(frame)
        assert msg.flags == flags
        for got, want in zip(msg.tensors, wire.deserialize_tensors(
                frame).tensors):
            assert type(got) is type(want)
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want)


def test_bf16_decodes_to_marked_bits_both_ways():
    bits = ARRAYS["bf16"]
    frame = ref_wire.serialize_tensors([_for_reference(bits)])
    [got] = native.deserialize_tensors(frame).tensors
    assert isinstance(got, wire.Bf16Bits)
    np.testing.assert_array_equal(got, bits)
    [back] = ref_native.deserialize_tensors(native.serialize_tensors([got]))\
        .tensors
    assert back.dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(back.view(np.uint16), bits)


def test_corrupt_frame_rejected_by_its_checksum():
    frame = bytearray(native.serialize_tensors([ARRAYS["f32"]]))
    frame[-3] ^= 0x10
    for codec in (native, wire):
        with pytest.raises(wire.WireIntegrityError, match="checksum"):
            codec.deserialize_tensors(bytes(frame))
    # a frame without a checksum (a pre-checksum peer) is not verified
    plain = bytearray(native.serialize_tensors([ARRAYS["f32"]],
                                               checksum=False))
    plain[-3] ^= 0x10
    [got] = native.deserialize_tensors(bytes(plain)).tensors
    [want] = wire.deserialize_tensors(bytes(plain)).tensors
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cut", ["short", "magic", "truncated", "trailing"])
def test_malformed_frames_raise(cut):
    frame = native.serialize_tensors([ARRAYS["i64"]], checksum=False)
    bad = {"short": frame[:5], "magic": b"XXXX" + frame[4:],
           "truncated": frame[:-3], "trailing": frame + b"\0"}[cut]
    with pytest.raises(wire.WireError):
        native.deserialize_tensors(bad)
    with pytest.raises(wire.WireError):
        wire.deserialize_tensors(bad)


def test_library_is_built_under_build_named_by_its_sources(tmp_path,
                                                          monkeypatch):
    path = build.lib_path()
    assert path.parent == build.BUILD_DIR
    assert build.BUILD_DIR.parts[-2:] == ("build", "native")
    assert native.available() and path.exists()
    assert not list(build.SRC_DIR.glob("*.so"))
    for name in build.SOURCES:
        (tmp_path / name).write_bytes((build.SRC_DIR / name).read_bytes())
    monkeypatch.setattr(build, "SRC_DIR", tmp_path)
    assert build.lib_path() == path
    with open(tmp_path / "codec.cc", "a") as f:
        f.write("\n// edited\n")
    assert build.lib_path() != path


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    for name in build.SOURCES:
        (tmp_path / name).write_text("this is not C++ ;\n")
    monkeypatch.setattr(build, "SRC_DIR", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    with pytest.raises(RuntimeError, match="g\\+\\+ exit") as e:
        build.build()
    assert "error" in str(e.value)
    # the codec asked for explicitly raises the same error, every time;
    # available() says False
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_error", None)
    assert not native.available()
    with pytest.raises(RuntimeError, match="native codec unavailable"):
        native.serialize_tensors([ARRAYS["f32"]])
    with pytest.raises(RuntimeError, match="not C\\+\\+"):
        native.deserialize_tensors(b"DWT1")
    with pytest.raises(RuntimeError, match="g\\+\\+ exit"):
        Tokenizer.from_json('{"model": {"type": "BPE", "vocab": {}, '
                            '"merges": []}}', backend="native")


# ---------------------------------------------------------------------------
# the native tokenizer

EXTRA_TEXTS = ["<s>hello</s> the <s>test</s>", "hello ☃ world \x00\x7f",
               "the  hello\tworld\n\n", "🙂" * 3]


@pytest.mark.parametrize("kind", ["bytelevel", "metaspace"])
def test_native_tokenizer_equals_python_and_reference(kind, bytelevel_json,
                                                      metaspace_json):
    src = bytelevel_json if kind == "bytelevel" else metaspace_json
    mine = Tokenizer.from_json(src, backend="native")
    python = Tokenizer.from_json(src, backend="python")
    theirs = RefTokenizer.from_json(src, backend="native")
    assert mine.backend == theirs.backend == "native"
    for text in TEXTS + EXTRA_TEXTS:
        ids = mine.encode(text, add_bos=True)
        assert ids == python.encode(text, add_bos=True), text
        assert ids == theirs.encode(text, add_bos=True), text
        for skip in (True, False):
            assert mine.decode(ids, skip) == python.decode(ids, skip), text
            assert mine.decode(ids, skip) == theirs.decode(ids, skip), text
    assert mine.vocab_size() == python.vocab_size() == theirs.vocab_size()
    for i in (0, 1, 2, 5, 100, 10 ** 6):
        assert mine.id_to_token(i) == python.id_to_token(i)
        tok = python.id_to_token(i)
        if tok is not None:
            assert mine.token_to_id(tok) == python.token_to_id(tok)
    specials = mine.encode("<s>hello</s>")
    assert specials[0] == mine.token_to_id("<s>")
    assert specials[-1] == mine.token_to_id("</s>")
    if kind == "metaspace":
        # byte fallback: a character without a piece is its UTF-8 bytes
        snow = mine.encode("☃")
        assert [mine.id_to_token(i) for i in snow[1:]] == [
            "<0xE2>", "<0x98>", "<0x83>"]
        assert mine.decode(snow) == python.decode(snow)
