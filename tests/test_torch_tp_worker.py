"""``worker --tp 2`` of the torch port as a process: a pipeline stage
tp-sharded over two local ranks (``runtime/worker_main.py`` spawns its
own follower), over ZMQ on the CPU.

As the tail of a two-stage chain under a port header (the head tp=1, in
process), it gives the JAX package's chain tokens for two interleaved
requests, answers the stats poll, and exits 0 on ``stop`` with its mesh
closed.  ``llama-test`` in f32 on the reference's weights
(``--weights-npz``).
"""

import numpy as np

from distributed_inference_demo_tpu_torch.comm.transport import ZmqTransport
from distributed_inference_demo_tpu_torch.models.base import (
    slice_stage, split_layer_ranges)
from distributed_inference_demo_tpu_torch.runtime.distributed import (
    PipelineHeader, StageRuntime)
from test_torch_chain_procs import PORT_WORKER, Proc, _stage_args, npz
from test_torch_ring import (GREEDY, PROMPT, _few_torch_threads,
                             ref_chain_tokens, weights)

__all__ = ["_few_torch_threads", "npz"]
MAX_SEQ = 64


def test_worker_tp2_process_in_a_chain(npz):
    """A ``worker --tp 2`` tail process under a port header (tp=1 head,
    in process) gives the reference chain's tokens and exits 0 on
    ``stop``."""
    _, _, cfg, full, _ = weights()
    specs = split_layer_ranges(cfg.num_layers, 2)
    want = ref_chain_tokens("llama-test", 2, [PROMPT, PROMPT], [10, 4],
                            pool_size=2)
    transport = ZmqTransport("header")
    proc = Proc(_stage_args(PORT_WORKER, specs[1], "w1", transport.address,
                            ["--device", "cpu", "--weights-npz", npz,
                             "--tp", "2"]))
    try:
        transport.connect("w1", proc.ready())
        header = PipelineHeader(
            StageRuntime(cfg, specs[0], slice_stage(full, cfg, specs[0]),
                         MAX_SEQ, GREEDY, device="cpu"),
            transport, next_id="w1", step_timeout=60)
        got = header.generate_many([PROMPT, PROMPT], [10, 4], pool_size=2)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        stats = header.collect_stats(2)
        assert stats[1]["device_id"] == "w1" and stats[1]["steps"] == 14
        header.shutdown_pipeline()
        assert proc.p.wait(timeout=60) == 0, "\n".join(proc.err[-20:])
    finally:
        proc.kill()
        transport.close()
