"""The torch port's fleet paths over a tp=2 mesh against the JAX
package's tp=2 batching engine on the conftest's virtual mesh.

- ``export_request`` at tp=2: the checkpoint's blocks hold every kv
  head (the tp=1 layout) and equal the reference's tp=2 export over
  the positions both hold (2e-4); it imports at tp=1, and a tp=1 export
  imports at tp=2, each stream equal to the unmigrated one.
- ``submit_premigrated`` and ``submit_resumed`` at tp=2 give the
  unmigrated stream.

The tier under tp is ``test_torch_tp_tier.py``'s.  One mesh (this
process and one spawned follower, gloo) serves the module; ``llama-test``
in f32 on the reference's weights.
"""

import time

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
from distributed_inference_demo_tpu_torch.ops.quant import QuantizedKVPages
from distributed_inference_demo_tpu_torch.ops.sampling import SamplingParams
from distributed_inference_demo_tpu_torch.parallel.mesh import local_tp_mesh
from distributed_inference_demo_tpu_torch.runtime.batching import \
    ContinuousBatchingEngine

GREEDY = SamplingParams(greedy=True)
RGREEDY = RefSamplingParams(greedy=True)
TOL = dict(rtol=2e-4, atol=2e-4)
WAIT = 120
PROMPT = (np.arange(17) % 50 + 3).astype(np.int32)
MAX_NEW = 24
KW = dict(max_seq=64, max_batch=2, kv_cache_blocks=24, kv_block_tokens=8)


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
    tree = {k: None if v is None else {n: np.asarray(a) for n, a in v.items()}
            for k, v in dict(layers=rp.layers, embed=rp.embed,
                             final_norm=rp.final_norm,
                             lm_head=rp.lm_head).items()}
    cfg = get_model_config("llama-test")
    rmesh = make_mesh(RefMesh(tp=2), devices[:2])
    return dict(rcfg=rcfg, rp=rp, rmesh=rmesh,
                rp_tp=ref_shard(rp, rcfg, rmesh), cfg=cfg,
                p=params_from_numpy(tree, cfg, "cpu"))


@pytest.fixture(scope="module")
def unmigrated(weights):
    """The reference's unmigrated greedy stream of PROMPT."""
    eng = RefBatching(weights["rcfg"], weights["rp"], sampling=RGREEDY, **KW)
    try:
        return eng.submit(PROMPT, MAX_NEW).wait(WAIT).tolist()
    finally:
        eng.close()


def _leaves(x):
    return x.leaves() if isinstance(x, QuantizedKVPages) else [x]


def _wait_tokens(req, n, timeout=30.0):
    deadline = time.monotonic() + timeout
    while len(req.tokens) < n:
        if time.monotonic() > deadline:
            raise AssertionError(f"only {len(req.tokens)}/{n} tokens")
        time.sleep(0.002)


def _seam(src, dst, rid, n=3):
    req = src.submit(PROMPT, MAX_NEW, request_id=rid)
    _wait_tokens(req, n)
    ckpt = src.export_request(rid, detach=True)
    assert src.get_request(rid) is None
    return ckpt, dst.import_request(ckpt).wait(WAIT).tolist()


def _ref_leaves(x):
    """A reference payload's arrays (a quantized one's data, scale[,
    zero])."""
    if hasattr(x, "scale"):
        return [a for a in (x.data, x.scale, getattr(x, "zero", None))
                if a is not None]
    return [x]


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_tp_export_import_across_tp(weights, mesh, unmigrated, kv_dtype):
    """A row exported mid-stream from the tp=2 engine imports at tp=1
    and the reverse, each stream equal to the unmigrated one; the tp=2
    checkpoint has every kv head and equals the reference's tp=2 export
    over the positions both checkpoints hold."""
    kw = dict(KW, kv_dtype=kv_dtype)
    if kv_dtype != "bf16":
        ref = RefBatching(weights["rcfg"], weights["rp"], sampling=RGREEDY,
                          **kw)
        want = ref.submit(PROMPT, MAX_NEW).wait(WAIT).tolist()
        ref.close()
    else:
        want = unmigrated
    two = ContinuousBatchingEngine(weights["cfg"], weights["p"],
                                   sampling=GREEDY, device="cpu", mesh=mesh,
                                   **kw)
    one = ContinuousBatchingEngine(weights["cfg"], weights["p"],
                                   sampling=GREEDY, device="cpu", **kw)
    rsrc, rdst = (RefBatching(weights["rcfg"], weights["rp_tp"],
                              mesh=weights["rmesh"], sampling=RGREEDY, **kw)
                  for _ in range(2))
    try:
        ckpt, got = _seam(two, one, "down")
        assert got == want
        rckpt, rgot = _seam(rsrc, rdst, "ref")
        assert rgot == want
        assert set(ckpt) == set(rckpt)
        assert ckpt["kv_dtype"] == rckpt["kv_dtype"] == kv_dtype
        n = min(ckpt["length"], rckpt["length"]) // 8   # whole blocks
        assert n >= 2
        for side in ("k", "v"):
            mine, theirs = ckpt[side], rckpt[side]
            assert _leaves(mine)[0].shape[2] == weights["cfg"].num_kv_heads
            for a, b in zip(_leaves(mine), _ref_leaves(theirs)):
                np.testing.assert_allclose(
                    a[:n].float().numpy(),
                    np.asarray(b[:n]).astype(np.float32), **TOL)
        back, got = _seam(one, two, "up")
        assert got == want
        assert two.migration_stats["imported_requests"] == 1
        assert two.migration_stats["exported_requests"] == 1
    finally:
        for e in (two, one, rsrc, rdst):
            e.close()


def test_tp_premigrated_and_resumed(weights, mesh, unmigrated):
    """At tp=2: a premigrated join (the prompt's whole blocks from a
    tp=1 export) and a greedy resume after five delivered tokens both
    continue the unmigrated stream; the adopt lands on every rank."""
    one = ContinuousBatchingEngine(weights["cfg"], weights["p"],
                                   sampling=GREEDY, device="cpu", **KW)
    two = ContinuousBatchingEngine(weights["cfg"], weights["p"],
                                   sampling=GREEDY, device="cpu", mesh=mesh,
                                   **KW)
    try:
        req = one.submit(PROMPT, MAX_NEW, request_id="pre")
        _wait_tokens(req, 2)
        ckpt = one.export_request("pre", detach=True)
        nb = len(PROMPT) // 8
        got = two.submit_premigrated(PROMPT, MAX_NEW, ckpt["k"][:nb],
                                     ckpt["v"][:nb]).wait(WAIT).tolist()
        assert got == unmigrated
        assert two.disagg_stats == {"premigrated_requests": 1,
                                    "adopted_pages": nb}
        res = two.submit_resumed(PROMPT, MAX_NEW, unmigrated[:5])
        # greedy: the last delivered token is re-derived (and checked),
        # then the suffix streams
        assert res.wait(WAIT).tolist() == unmigrated[4:]
        assert two.resume_stats["requests"] == 1
        assert two.resume_stats["diverged"] == 0
    finally:
        one.close()
        two.close()
