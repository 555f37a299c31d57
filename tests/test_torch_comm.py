"""The port's ``comm/`` (wire, transport, faults) against the JAX package's.

The wire codec must frame the same arrays into the same bytes: header,
dtype codes, CRC and the trace-context trailer.  The port has no
bfloat16 numpy dtype, so a bf16 tensor travels as its ``uint16`` bits
marked with ``wire.bf16_view``; its frame must equal the reference's
frame of the ``ml_dtypes`` bfloat16 array, and decode back to the same
bits.  The loopback transport and the fault plan are copies: the same
seeded plan makes the same decisions in both packages.  ``zmq`` is
imported only when a ``ZmqTransport`` is built.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

from distributed_inference_demo_tpu.comm import faults as ref_faults
from distributed_inference_demo_tpu.comm import transport as ref_transport
from distributed_inference_demo_tpu.comm import wire as ref_wire
from distributed_inference_demo_tpu.runtime import disagg as ref_disagg
from distributed_inference_demo_tpu_torch.comm import faults, transport, wire
from distributed_inference_demo_tpu_torch.runtime import disagg

RNG = np.random.RandomState(0)
ARRAYS = [
    RNG.randn(3, 4).astype(np.float32),
    RNG.randn(2, 2, 2).astype(np.float64),
    RNG.randn(5).astype(np.float16),
    RNG.randint(-128, 127, (4, 3)).astype(np.int8),
    RNG.randint(-9, 9, (2, 3)).astype(np.int16),
    RNG.randint(-9, 9, (7,)).astype(np.int32),
    RNG.randint(-9, 9, (1, 2)).astype(np.int64),
    RNG.randint(0, 255, (6,)).astype(np.uint8),
    RNG.randint(0, 9, (2,)).astype(np.uint16),
    RNG.randint(0, 9, (3,)).astype(np.uint32),
    RNG.randint(0, 9, (2, 1)).astype(np.uint64),
    RNG.rand(4) > 0.5,
    np.float32(3.5),
    np.zeros((0, 3), np.float32),
]


def _bf16_pair(shape, seed):
    """(reference ml_dtypes bf16 array, port bf16_view of its bits, the
    same values as a torch bf16 tensor)."""
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    ref = x.astype(ml_dtypes.bfloat16)
    t = torch.from_numpy(x).to(torch.bfloat16)
    return ref, wire.bf16_view(t.view(torch.uint16).numpy()), t


@pytest.mark.parametrize("checksum", [True, False])
def test_frames_byte_identical_for_every_dtype(checksum):
    got = wire.serialize_tensors(ARRAYS, checksum=checksum)
    assert got == ref_wire.serialize_tensors(ARRAYS, checksum=checksum)
    out = wire.deserialize_tensors(got)
    for a, b in zip(ARRAYS, out.tensors):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    # and the reference decodes the port's frame
    for a, b in zip(ARRAYS, ref_wire.deserialize_tensors(got).tensors):
        np.testing.assert_array_equal(a, b)


def test_bf16_travels_as_its_bits_under_code_3():
    ref, bits, t = _bf16_pair((2, 3, 4), 1)
    frame = wire.serialize_tensors([bits, np.arange(3, dtype=np.int32)])
    assert frame == ref_wire.serialize_tensors(
        [ref, np.arange(3, dtype=np.int32)])
    # dtype code 3 sits right after the 12-byte message header
    assert frame[12] == int(wire.DType.BF16) == 3
    back = wire.deserialize_tensors(frame).tensors[0]
    assert isinstance(back, wire.Bf16Bits) and back.dtype == np.uint16
    assert torch.equal(torch.from_numpy(np.asarray(back)).view(
        torch.bfloat16), t)
    # a reference bf16 frame decodes to the same bits in the port
    ref_back = wire.deserialize_tensors(ref_wire.serialize_tensors([ref]))
    np.testing.assert_array_equal(np.asarray(ref_back.tensors[0]),
                                  ref.view(np.uint16))
    # a plain uint16 array stays U16 (code 9): the mark is explicit
    plain = wire.serialize_tensors([bits.view(np.ndarray)])
    assert plain[12] == int(wire.DType.U16) == 9
    with pytest.raises(wire.WireError, match="uint16"):
        wire.bf16_view(np.zeros(2, np.float32))


def test_checksum_trace_trailer_and_tokens_equal_reference():
    for data in (b"", b"abc", bytes(range(256)) * 3):
        assert wire.payload_checksum(data) == ref_wire.payload_checksum(data)
    arrays = ARRAYS[:3]
    for tid, span in ((None, 0), (7, 3), ((1 << 64) - 1, 1 << 63), (-1, 5)):
        got = wire.serialize_tensors_traced(arrays, tid, span)
        assert got == ref_wire.serialize_tensors_traced(arrays, tid, span)
        tensors, ctx = wire.split_trace_context(wire.deserialize_tensors(got))
        rtensors, rctx = ref_wire.split_trace_context(
            ref_wire.deserialize_tensors(got))
        assert ctx == rctx and len(tensors) == len(rtensors) == 3
    for tok in (0, 1, 31999, -5, 2 ** 31 - 1):
        assert wire.serialize_token(tok) == ref_wire.serialize_token(tok)
        assert wire.deserialize_token(wire.serialize_token(tok)) == tok
    # a flipped payload bit is an integrity error in both
    frame = bytearray(wire.serialize_tensors(arrays))
    frame[-1] ^= 0x10
    for mod in (wire, ref_wire):
        with pytest.raises(mod.WireIntegrityError):
            mod.deserialize_tensors(bytes(frame))
    for bad in (b"xx", b"NOPE" + bytes(8)):
        with pytest.raises(wire.WireError):
            wire.deserialize_tensors(bad)


def test_page_frames_equal_reference_and_float8_is_refused():
    """The disaggregation page frame of a bf16 run and of int8 / int4
    runs is the reference's frame of the same bits; a float8 run is
    refused with the reference's error (the wire has no float8 code)."""
    from distributed_inference_demo_tpu.ops.quant import \
        QuantizedKVPages as RefQ
    from distributed_inference_demo_tpu_torch.ops.quant import \
        QuantizedKVPages
    ref, _, t = _bf16_pair((2, 3, 1, 4, 8), 2)
    ref_v, _, tv = _bf16_pair((2, 3, 1, 4, 8), 3)
    assert (disagg._page_frame(t, tv, 5, trace=(9, 2))
            == ref_disagg._page_frame(ref, ref_v, 5, trace=(9, 2)))
    data = RNG.randint(-127, 127, (2, 3, 1, 4, 8)).astype(np.int8)
    scale = RNG.rand(2, 3, 1, 4, 1).astype(np.float32)
    zero = RNG.randn(2, 3, 1, 4, 1).astype(np.float32)
    packed = RNG.randint(0, 255, (2, 3, 1, 4, 4)).astype(np.uint8)
    for port_q, ref_q in (
            (QuantizedKVPages(torch.from_numpy(data),
                              torch.from_numpy(scale), None, 8),
             RefQ(data, scale, None, 8)),
            (QuantizedKVPages(torch.from_numpy(packed),
                              torch.from_numpy(scale),
                              torch.from_numpy(zero), 4),
             RefQ(packed, scale, zero, 4))):
        frame = disagg._page_frame(port_q, port_q, 0)
        assert frame == ref_disagg._page_frame(ref_q, ref_q, 0)
        stager = disagg.PageStager("d")
        assert stager.stage_page("r", 0, 0, frame, "pg:r:0:0") == "staged"
        kb, vb = stager.concat_blocks(stager.staging("r", 0), 2)
        for a, b in zip(kb.leaves(), port_q.leaves()):
            assert torch.equal(a, b)
    f8 = t.float().to(torch.float8_e4m3fn)
    ref_f8 = np.asarray(ref, np.float32).astype(ml_dtypes.float8_e4m3fn)
    with pytest.raises(ref_wire.WireError) as ref_err:
        ref_disagg._page_frame(ref_f8, ref_f8, 0)
    with pytest.raises(wire.WireError) as err:
        disagg._page_frame(f8, f8, 0)
    assert str(err.value) == str(ref_err.value)


def test_loopback_transport_stash_and_timeout():
    net = transport.LoopbackNetwork()
    a = transport.LoopbackTransport("a", net)
    b = transport.LoopbackTransport("b", net)
    a.send("b", "x:1", b"one")
    a.send("b", "y:1", b"two")
    assert b.recv("y:1", timeout=1.0) == b"two"     # x:1 is stashed
    assert b.recv_any(timeout=1.0) == ("x:1", b"one")
    with pytest.raises(transport.TransportTimeout):
        b.recv("z", timeout=0.05)
    with pytest.raises(transport.TransportError):
        a.send("nobody", "t", b"")
    assert issubclass(transport.TransportTimeout, transport.TransportError)


def _decisions(mod, spec, sends=40):
    plan = mod.FaultPlan.from_spec(spec)
    out = []
    for i in range(sends):
        out.append(plan.on_send("dev", f"peer{i % 2}", f"pg:r:{i}",
                                100 + i))
    out.append(plan.on_recv("dev"))
    return out, plan.to_spec()


@pytest.mark.parametrize("spec", [
    {"seed": 3, "rules": [{"kind": "drop", "prob": 0.3},
                          {"kind": "duplicate", "prob": 0.2,
                           "peer": "peer1"}]},
    {"seed": 5, "rules": [{"kind": "corrupt", "after": 4, "max_count": 3},
                          {"kind": "delay", "prob": 0.5,
                           "tag_prefix": "pg:"}]},
    {"seed": 7, "rules": [{"kind": "crash_after", "n_msgs": 3,
                           "max_count": 1}]},
])
def test_fault_plans_decide_as_the_reference(spec):
    assert _decisions(faults, spec) == _decisions(ref_faults, spec)


def test_faulty_transport_crash_after_and_maybe_wrap():
    net = transport.LoopbackNetwork()
    a = transport.LoopbackTransport("a", net)
    transport.LoopbackTransport("b", net)
    assert faults.maybe_wrap(a, None) is a
    plan = faults.FaultPlan(seed=7, rules=[faults.FaultRule(
        kind="crash_after", n_msgs=2, max_count=1)])
    fa = faults.maybe_wrap(a, plan)
    assert isinstance(fa, faults.FaultyTransport)
    fa.send("b", "t:0", b"0")
    fa.send("b", "t:1", b"1")
    with pytest.raises(faults.InjectedCrash):
        fa.send("b", "t:2", b"2")
    assert [e["kind"] for e in plan.events] == ["crash_after"]
    with pytest.raises(faults.FaultConfigError):
        faults.load_fault_plan('{"rules": []}', chaos=False)


def test_zmq_is_imported_only_by_zmq_transport():
    import sys
    import zmq  # noqa: F401  (the sandbox has it; the card machine not)
    assert transport.zmq is None or transport.zmq is sys.modules["zmq"]
    src = open(transport.__file__).read()
    assert "\nimport zmq" not in src and "\nfrom zmq" not in src
    t = transport.ZmqTransport("z0")
    try:
        assert transport.zmq is sys.modules["zmq"]
        assert t.address.startswith("127.0.0.1:")
    finally:
        t.close()
    assert ref_transport.ZmqTransport.__name__ == "ZmqTransport"
