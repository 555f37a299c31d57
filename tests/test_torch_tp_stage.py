"""The torch port's pipeline stages over a tp=2 mesh (pipeline x tp)
against the JAX package's stages on its ``local_tp_mesh(2)`` (the
conftest's virtual devices).

- ``StageRuntime``: both stages of a 2-stage split at tp=2, their
  ``run_chunk`` outputs (the head's hidden rows, the tail's logits)
  within 2e-4 of the reference's tp=2 stages over a prompt chunk and
  three one-token hops, the tail's greedy tokens equal, and every page
  back on ``free``; the wire stays ``[b, s, H]``.
- ``ElasticStageRuntime`` at tp=2: a reassign to the whole model frees
  the old range's weights and pool on every rank and distributes the
  new range; its logits equal the reference's after the same reassign.

``worker --tp 2`` as a process is ``test_torch_tp_worker.py``'s.

``llama-test`` in f32 on the reference's weights.
"""

import numpy as np
import pytest
import torch

from distributed_inference_demo_tpu.models.base import \
    slice_stage as ref_slice_stage
from distributed_inference_demo_tpu.parallel.mesh import \
    local_tp_mesh as ref_local_tp_mesh
from distributed_inference_demo_tpu.runtime import distributed as ref_dist
from distributed_inference_demo_tpu.runtime import elastic as ref_elastic
from distributed_inference_demo_tpu_torch.models.base import (
    StageSpec, slice_stage, split_layer_ranges)
from distributed_inference_demo_tpu_torch.parallel.mesh import local_tp_mesh
from distributed_inference_demo_tpu_torch.parallel.tensor import fetch_tp
from distributed_inference_demo_tpu_torch.runtime.distributed import \
    StageRuntime
from distributed_inference_demo_tpu_torch.runtime.elastic import \
    ElasticStageRuntime
from test_torch_ring import (GREEDY, PROMPT, REF_GREEDY, _few_torch_threads,
                             weights)

__all__ = ["_few_torch_threads"]
MAX_SEQ = 64
TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def mesh():
    with local_tp_mesh(2, device="cpu", timeout_s=120) as m:
        yield m


@pytest.fixture(scope="module")
def rmesh(devices):
    return ref_local_tp_mesh(2)


def _np(x):
    return x.float().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def test_tp_stage_runtime_equals_reference(mesh, rmesh):
    rcfg, rp, cfg, full, _ = weights()
    specs = split_layer_ranges(cfg.num_layers, 2)
    mine = [StageRuntime(cfg, s, slice_stage(full, cfg, s), MAX_SEQ, GREEDY,
                         device="cpu", mesh=mesh) for s in specs]
    ref = [ref_dist.StageRuntime(rcfg, s, ref_slice_stage(rp, rcfg, s),
                                 MAX_SEQ, REF_GREEDY, mesh=rmesh)
           for s in specs]
    rid, x, rx = 7, PROMPT, PROMPT
    for step in range(4):
        h, rh = mine[0].run_chunk(rid, x), ref[0].run_chunk(rid, rx)
        assert tuple(h.shape) == (1, x.shape[1], cfg.hidden_size)
        np.testing.assert_allclose(_np(h), _np(rh), **TOL)
        logits = mine[1].run_chunk(rid, h.cpu().numpy())
        rlogits = ref[1].run_chunk(rid, np.asarray(rh))
        np.testing.assert_allclose(_np(logits), _np(rlogits), **TOL)
        tok = mine[1].sample_tokens(rid, step, logits)
        rtok = ref[1].sample_tokens(rid, step, rlogits)
        np.testing.assert_array_equal(tok, np.asarray(rtok))
        x = rx = tok[:, None].astype(np.int32)
    for rt in mine:
        # each rank holds its kv heads of the stage's pool
        assert [p.shape[2] for p in fetch_tp(mesh, rt._pk)] == [1, 1]
        rt.free(rid)
        assert rt.pages_free == rt.num_pages
        rt.free_tp()


def test_tp_elastic_reassign_equals_reference(mesh, rmesh):
    rcfg, rp, cfg, full, _ = weights()
    specs = split_layer_ranges(cfg.num_layers, 2)
    whole = StageSpec(0, 1, 0, cfg.num_layers)
    rt = ElasticStageRuntime(cfg, specs[0], full, MAX_SEQ, GREEDY,
                             device="cpu", mesh=mesh)
    rrt = ref_elastic.ElasticStageRuntime(rcfg, specs[0], rp, MAX_SEQ,
                                          REF_GREEDY, mesh=rmesh)
    np.testing.assert_allclose(_np(rt.run_chunk(1, PROMPT)),
                               _np(rrt.run_chunk(1, PROMPT)), **TOL)
    held = len(mesh.objects)
    rt.reassign(whole)
    rrt.reassign(whole)
    # the old range's weights and pool went on every rank: the table
    # holds what it held, for the new range
    assert len(mesh.objects) == held
    assert rt.pages_free == rt.num_pages
    np.testing.assert_allclose(_np(rt.run_chunk(2, PROMPT)),
                               _np(rrt.run_chunk(2, PROMPT)), **TOL)
    rt.free_tp()
