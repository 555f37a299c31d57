"""The torch port's batching proposers over a tp=2 mesh against the JAX
package's tp=2 batching engine on the conftest's virtual mesh.

``ContinuousBatchingEngine`` with a draft model (the target as its own
draft, its rows and page pool on kv-head shards) and with prompt
lookup (serialized, and mixed over int8 pages):
greedy tokens and the speculative counters equal the reference's; the
draft's pages hold nothing once the requests finish, on every rank.
One mesh serves the module; the CLI's proposers under ``--tp 2`` are
``test_torch_tp_proposers_cli.py``'s.
"""


import jax
import numpy as np
import pytest
import torch

from distributed_inference_demo_tpu.models import \
    get_model_config as ref_get_model_config
from distributed_inference_demo_tpu.models.decoder import \
    init_full_params as ref_init_full_params
from distributed_inference_demo_tpu.ops.sampling import \
    SamplingParams as RefSamplingParams
from distributed_inference_demo_tpu.parallel import MeshConfig as RefMesh
from distributed_inference_demo_tpu.parallel import make_mesh
from distributed_inference_demo_tpu.runtime.batching import \
    ContinuousBatchingEngine as RefBatching
from distributed_inference_demo_tpu.runtime.engine import \
    shard_engine_params as ref_shard
from distributed_inference_demo_tpu_torch.models import get_model_config
from distributed_inference_demo_tpu_torch.models.bridge import \
    params_from_numpy
from distributed_inference_demo_tpu_torch.ops.sampling import SamplingParams
from distributed_inference_demo_tpu_torch.parallel.mesh import local_tp_mesh
from distributed_inference_demo_tpu_torch.parallel.tensor import fetch_tp
from distributed_inference_demo_tpu_torch.runtime.batching import \
    ContinuousBatchingEngine

GREEDY = SamplingParams(greedy=True)
WAIT = 120
BASE = dict(max_seq=64, max_batch=2, prompt_buckets=(16, 32),
            kv_block_tokens=4, num_draft=3)
ASKS = [([7, 8, 9, 10, 11, 7, 8, 9, 10, 11, 7, 8], 9),
        ([3, 14, 15, 92, 65, 35, 89, 79, 32, 38], 7),
        (list(range(40, 61)), 6)]
MODES = {
    "draft": dict(),
    "prompt_lookup": dict(prompt_lookup=True),
    "prompt_lookup_mixed_int8": dict(prompt_lookup=True, kv_dtype="int8",
                                     prefill_chunk=8,
                                     mixed_token_budget=16),
}


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh():
    with local_tp_mesh(2, device="cpu", timeout_s=120) as m:
        yield m


def _bridge(rp, cfg):
    tree = {k: None if v is None else {n: np.asarray(a) for n, a in v.items()}
            for k, v in dict(layers=rp.layers, embed=rp.embed,
                             final_norm=rp.final_norm,
                             lm_head=rp.lm_head).items()}
    return params_from_numpy(tree, cfg, "cpu")


@pytest.fixture(scope="module")
def models(devices):
    rcfg = ref_get_model_config("llama-test")
    rp = ref_init_full_params(jax.random.PRNGKey(0), rcfg)
    cfg = get_model_config("llama-test")
    rmesh = make_mesh(RefMesh(tp=2), devices[:2])
    return dict(rcfg=rcfg, rmesh=rmesh, rp_tp=ref_shard(rp, rcfg, rmesh),
                cfg=cfg, p=_bridge(rp, cfg))


@pytest.mark.parametrize("mode", list(MODES))
def test_tp_proposers_equal_reference(models, mesh, mode):
    m = models
    kw = dict(BASE, **MODES[mode])
    rkw, pkw = dict(kw), dict(kw)
    if mode == "draft":
        # the target as its own draft: every draft is accepted, so the
        # bonus and the K+1 writes past a row's length are exercised
        rkw.update(draft_cfg=m["rcfg"], draft_params=m["rp_tp"])
        pkw.update(draft_cfg=m["cfg"], draft_params=m["p"])
    with RefBatching(m["rcfg"], m["rp_tp"], mesh=m["rmesh"],
                     sampling=RefSamplingParams(greedy=True), **rkw) as ref:
        want = [ref.submit(p, n).wait(timeout=WAIT).tolist()
                for p, n in ASKS]
        want_spec = dict(ref.spec_stats)
    with ContinuousBatchingEngine(m["cfg"], m["p"], sampling=GREEDY,
                                  device="cpu", mesh=mesh, **pkw) as eng:
        got = [eng.submit(p, n).wait(timeout=WAIT).tolist()
               for p, n in ASKS]
        assert got == want
        assert eng.spec_stats == want_spec
        assert eng.spec_stats["accepted"] > 0
        if mode == "draft":
            # the draft pool is per-request scratch: nothing held, and
            # every rank holds a plane of its own kv heads
            assert eng._dmgr.used_blocks == 0
            planes = fetch_tp(mesh, eng._dpk)
            assert [p.shape[2] for p in planes] == [1, 1]
        if "mixed" in mode:
            assert eng.stats()["mixed"]["dispatches"] > 0
