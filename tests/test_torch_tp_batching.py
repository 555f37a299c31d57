"""The torch port's ``ContinuousBatchingEngine`` over a tp=2 mesh against
the JAX package's tp=2 batching engine on the conftest's virtual mesh.

Rank 0 is this process, one spawned follower holds the other kv-head
plane of the page pool (gloo); one mesh serves the module.  ``llama-test``
in f32 on the reference's weights: requests one after another (a fixed
page allocation), greedy tokens equal the reference's, and after the run
each rank's plane of the pool equals the reference's pool shard on the
same device index; over full-width pages with a prefix hit, int8 pages,
float8 pages, and the mixed dispatch over int8 pages.  Then the
combinations a later slice ported under tp: a proposer and the tier
(tokens and counters equal the reference's tp=2 engine's), and the
fleet's calls (export / import, premigrated joins, resumes) answering
as the reference's tp=2 engine answers them.
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
    shard_engine_params as ref_shard_engine_params
from distributed_inference_demo_tpu_torch.models import get_model_config
from distributed_inference_demo_tpu_torch.models.bridge import \
    params_from_numpy
from distributed_inference_demo_tpu_torch.ops.sampling import SamplingParams
from distributed_inference_demo_tpu_torch.parallel.mesh import local_tp_mesh
from distributed_inference_demo_tpu_torch.parallel.tensor import fetch_tp
from distributed_inference_demo_tpu_torch.runtime.batching import \
    ContinuousBatchingEngine

GREEDY = SamplingParams(greedy=True)
TOL = dict(rtol=2e-4, atol=2e-4)
WAIT = 120
BASE = dict(max_seq=96, max_batch=2, prompt_buckets=(16, 48),
            kv_cache_blocks=24, kv_block_tokens=4)
# a prefix hit (the second shares two pages of the first), a chunked one
ASKS = [([3, 14, 15, 92, 65, 35, 89, 79], 8),
        ([3, 14, 15, 92, 65, 35, 89, 79, 32, 38], 6),
        (list(range(40, 69)), 5)]
CONFIGS = {
    "bf16": dict(),
    "int8": dict(kv_dtype="int8"),
    "fp8": dict(kv_cache_dtype="float8_e4m3fn"),
    "mixed_int8": dict(kv_dtype="int8", prefill_chunk=8, decode_block=2,
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


@pytest.fixture(scope="module")
def weights(devices):
    rcfg = ref_get_model_config("llama-test")
    rp = ref_init_full_params(jax.random.PRNGKey(0), rcfg)
    tree = {k: None if v is None else {n: np.asarray(a)
                                       for n, a in v.items()}
            for k, v in dict(layers=rp.layers, embed=rp.embed,
                             final_norm=rp.final_norm,
                             lm_head=rp.lm_head).items()}
    cfg = get_model_config("llama-test")
    rmesh = make_mesh(RefMesh(tp=2), devices[:2])
    return (rcfg, ref_shard_engine_params(rp, rcfg, rmesh), rmesh, cfg,
            params_from_numpy(tree, cfg, "cpu"))


def _leaves(pool):
    """A pool's tensors (a quantized pool's data, scale, zero)."""
    if torch.is_tensor(pool) or hasattr(pool, "addressable_shards"):
        return [pool]
    return [x for x in (pool.data, pool.scale, getattr(pool, "zero", None))
            if x is not None]


def _shard_on(arr, rmesh, rank):
    dev = rmesh.devices.reshape(-1)[rank]
    return next(np.asarray(s.data).astype(np.float32)
                for s in arr.addressable_shards if s.device == dev)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_tp_batching_equals_reference(name, weights, mesh):
    rcfg, rparams, rmesh, cfg, params = weights
    kw = dict(BASE, **CONFIGS[name])
    with RefBatching(rcfg, rparams, sampling=RefSamplingParams(greedy=True),
                     mesh=rmesh, **kw) as ref:
        want = [ref.submit(p, n).wait(timeout=WAIT).tolist()
                for p, n in ASKS]
        ref_stats = ref.kv_cache.stats
        ref_pool = (ref._pk, ref._pv)
        with ContinuousBatchingEngine(cfg, params, sampling=GREEDY,
                                      device="cpu", mesh=mesh, **kw) as eng:
            got = [eng.submit(p, n).wait(timeout=WAIT).tolist()
                   for p, n in ASKS]
            assert got == want
            assert eng.kv_cache.stats["hits"] == ref_stats["hits"] >= 1
            if "mixed" in name:
                assert eng.stats()["mixed"]["dispatches"] > 0
            N = eng.kv_cache.num_blocks
            for mine, theirs in zip((eng._pk, eng._pv), ref_pool):
                planes = fetch_tp(mesh, mine)
                for r, plane in enumerate(planes):
                    for a, b in zip(_leaves(plane), _leaves(theirs)):
                        # the port's pool has its drop page after the N
                        np.testing.assert_allclose(
                            a[:, :N].float().numpy(), _shard_on(b, rmesh, r),
                            **TOL)


@pytest.mark.parametrize("kw,what", [
    (dict(prompt_lookup=True), "speculative proposers"),
    (dict(kv_host_tier_bytes=1 << 20), "host / disk tier"),
])
def test_tp_batching_refuses_what_the_next_slice_ports(weights, mesh, kw,
                                                       what):
    """The two combinations a later slice ported under tp (``what``):
    tokens, the speculative counters and the kvcache fragment equal the
    reference's tp=2 engine's."""
    rcfg, rparams, rmesh, cfg, params = weights
    with RefBatching(rcfg, rparams, sampling=RefSamplingParams(greedy=True),
                     mesh=rmesh, **dict(BASE, **kw)) as ref:
        want = [ref.submit(p, n).wait(timeout=WAIT).tolist()
                for p, n in ASKS]
        ref_spec, ref_kv = dict(ref.spec_stats), ref.stats()["kvcache"]
    with ContinuousBatchingEngine(cfg, params, sampling=GREEDY,
                                  device="cpu", mesh=mesh,
                                  **dict(BASE, **kw)) as eng:
        got = [eng.submit(p, n).wait(timeout=WAIT).tolist()
               for p, n in ASKS]
        assert got == want, what
        assert eng.spec_stats == ref_spec
        kv = eng.stats()["kvcache"]
        assert ({k: v for k, v in kv.items() if "seconds" not in k}
                == {k: v for k, v in ref_kv.items() if "seconds" not in k})


def test_tp_batching_refuses_fleet_page_movement(weights, mesh):
    """The fleet's four calls under tp answer as the reference's tp=2
    engine answers them: an unknown rid's export and an empty
    checkpoint's import raise its errors, a premigrated join without
    blocks and a greedy resume give its tokens."""
    rcfg, rparams, rmesh, cfg, params = weights
    answers = []
    for make in (lambda: RefBatching(
                     rcfg, rparams, sampling=RefSamplingParams(greedy=True),
                     mesh=rmesh, **BASE),
                 lambda: ContinuousBatchingEngine(
                     cfg, params, sampling=GREEDY, device="cpu", mesh=mesh,
                     **BASE)):
        got = []
        with make() as eng:
            for call in (lambda: eng.export_request("r"),
                         lambda: eng.import_request({})):
                with pytest.raises(Exception) as err:
                    call()
                got.append(type(err.value).__name__)
            got.append(eng.submit_premigrated(
                [1, 2, 5], 4, None, None).wait(timeout=WAIT).tolist())
            got.append(eng.submit_resumed(
                [1, 2, 5], 4, got[-1][:2]).wait(timeout=WAIT).tolist())
            got.append(eng.submit([5, 4, 3], 3).wait(timeout=WAIT).size)
        answers.append(got)
    assert answers[1] == answers[0]
    assert answers[1][-1] == 3 and answers[1][0] == "KeyError"
