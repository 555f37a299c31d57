"""Communication layer: wire codec, transports, message schema.

The heterogeneous boundary of the framework: TPU mesh ranks talk to each
other via XLA collectives over ICI (parallel/), but CPU/edge workers and the
control plane talk over sockets.  This package owns that socket side —
replacing the reference's ZeroMQ + hand-rolled binary framing
(``utils.cpp:124-368``, ``Communication.java``).

Counterpart of ``distributed_inference_demo_tpu/comm/``, the native
codec (``native_codec.py`` over ``native/codec.cc``) included: the wire's
frames are byte for byte the JAX
package's, so the two packages' workers, replicas and gateways talk to
each other.
"""

from .wire import (Bf16Bits, DType, FLAG_TRACE_CONTEXT, TensorMessage,
                   WireError, WireIntegrityError,
                   deserialize_tensors, payload_checksum, serialize_tensors,
                   serialize_tensors_traced, split_trace_context,
                   bf16_view, deserialize_token, serialize_token)

__all__ = ["Bf16Bits", "DType", "bf16_view", "FLAG_TRACE_CONTEXT", "TensorMessage",
           "WireError", "WireIntegrityError", "payload_checksum",
           "serialize_tensors", "serialize_tensors_traced",
           "split_trace_context", "deserialize_tensors",
           "serialize_token", "deserialize_token"]
