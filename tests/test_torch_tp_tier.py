"""The torch port's host tier over a tp=2 mesh against the JAX package's
tp=2 engines on the conftest's virtual mesh.

The batching engine (bf16 and int8 pages): admissions that
oversubscribe the pool demote, a re-submitted prompt promotes; tokens
and the kvcache fragment (tier counters, digest, h2d bytes) equal the
reference's tp=2 engine's; every promoted page on each rank is
bit-equal to its kv heads of the demoted entry, and the bytes scattered
to the ranks equal the promoted bytes.  ``InferenceEngine``'s prefix
pool does the same with its tier.  One mesh (this process and one
spawned follower, gloo) serves the module; ``llama-test`` in f32 on the
reference's weights.
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
from distributed_inference_demo_tpu.runtime import \
    InferenceEngine as RefEngine
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
from distributed_inference_demo_tpu_torch.parallel.tensor import (
    fetch_tp, free_tp)
from distributed_inference_demo_tpu_torch.runtime.batching import \
    ContinuousBatchingEngine
from distributed_inference_demo_tpu_torch.runtime.engine import \
    InferenceEngine
from distributed_inference_demo_tpu_torch.runtime.kvcache import device

GREEDY = SamplingParams(greedy=True)
RGREEDY = RefSamplingParams(greedy=True)
WAIT = 120


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


def _strip(snap: dict) -> dict:
    return {k: v for k, v in snap.items() if "seconds" not in k}


def _leaves(x):
    return x.leaves() if isinstance(x, QuantizedKVPages) else [x]


class _Recorder:
    """The blocks a tier demotes and the blocks (and page ids) promotion
    adopts, as host copies."""

    def __init__(self, monkeypatch, tier):
        self.demoted, self.adopted = [], []
        demote, adopt = tier.demote, device.adopt_blocks_into_pages

        def on_demote(path_keys, kb, vb):
            self.demoted.append([t.clone() for t in _leaves(kb)
                                 + _leaves(vb)])
            return demote(path_keys, kb, vb)

        def on_adopt(pk, pv, kb, vb, table, **kw):
            # the promotion's adopt carries the pool's ops; rank 0's
            # adopt of its own heads, inside the scatter, carries none
            if kw.get("ops") is not None:
                self.adopted.append(([t.clone() for t in _leaves(kb)],
                                     [t.clone() for t in _leaves(vb)],
                                     np.asarray(table).reshape(-1).copy()))
            return adopt(pk, pv, kb, vb, table, **kw)

        monkeypatch.setattr(tier, "demote", on_demote)
        monkeypatch.setattr(device, "adopt_blocks_into_pages", on_adopt)

    def check_pages(self, mesh, pk, pv):
        """Every promoted block is one the tier demoted, and each rank's
        pages at its ids hold that block's kv heads, bit for bit."""
        assert self.adopted
        demoted = {b"".join(t[j].numpy().tobytes() for t in d[:len(d) // 2])
                   for d in self.demoted for j in range(d[0].shape[0])}
        planes = [fetch_tp(mesh, pk), fetch_tp(mesh, pv)]
        for kb, vb, ids in self.adopted:
            for j in range(len(ids)):
                assert b"".join(t[j].numpy().tobytes() for t in kb) \
                    in demoted
            for side, blocks in ((0, kb), (1, vb)):
                for r, plane in enumerate(planes[side]):
                    for got, want in zip(_leaves(plane), blocks):
                        h = got.shape[2]
                        for j, pid in enumerate(ids):
                            assert torch.equal(
                                got[:, int(pid)],
                                want[j][:, r * h:(r + 1) * h]), (r, j)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_tp_batching_tier_equals_reference(weights, mesh, kv_dtype,
                                           monkeypatch):
    prompts = [[i + 1, i + 2, i + 3, i + 4, i + 5] for i in range(5)]
    kw = dict(max_seq=64, max_batch=4, prompt_buckets=(16,),
              kv_cache_blocks=8, kv_block_tokens=4, kv_dtype=kv_dtype,
              kv_host_tier_bytes=1 << 20)
    ref = RefBatching(weights["rcfg"], weights["rp_tp"], mesh=weights["rmesh"],
                      sampling=RGREEDY, **kw)
    port = ContinuousBatchingEngine(weights["cfg"], weights["p"],
                                    sampling=GREEDY, device="cpu", mesh=mesh,
                                    **kw)
    rec = _Recorder(monkeypatch, port._kv_tier)
    mesh.stats["scattered_bytes"] = 0
    try:
        outs = []
        for eng in (ref, port):
            reqs = [eng.submit(p, 14) for p in prompts]
            outs.append([r.wait(timeout=WAIT).tolist() for r in reqs])
            outs.append(eng.submit(prompts[0], 14).wait(
                timeout=WAIT).tolist())
        assert outs[0] == outs[2] and outs[1] == outs[3]
        tier = port._kv_tier
        assert tier.stats["demoted_blocks"] > 0
        assert tier.stats["promoted_blocks"] > 0
        rs, ps = ref.stats()["kvcache"], port.stats()["kvcache"]
        assert _strip(ps) == _strip(rs)
        assert ps["tier"]["digest"] == rs["tier"]["digest"]
        assert (ps["h2d_bytes"] == tier.stats["promoted_bytes"]
                == mesh.stats["scattered_bytes"] > 0)
        rec.check_pages(mesh, port._pk, port._pv)
        tier.check()
    finally:
        port.close()
        ref.close()


def test_tp_prefix_pool_tier_equals_reference(weights, mesh, monkeypatch):
    """``InferenceEngine``'s prefix pool over tp with its tier (the env
    knob): A stores, B evicts A's blocks into the tier, A again promotes
    them on every rank; tokens and pool snapshots equal the reference's
    tp=2 engine's after every call."""
    monkeypatch.setenv("DWT_KV_HOST_TIER_BYTES", str(1 << 22))
    kw = dict(max_seq=64, kv_cache_blocks=7, kv_block_tokens=4)
    ref = RefEngine(weights["rcfg"], weights["rp_tp"], mesh=weights["rmesh"],
                    sampling=RGREEDY, **kw)
    port = InferenceEngine(weights["cfg"], weights["p"], sampling=GREEDY,
                           device="cpu", mesh=mesh, **kw)
    rec = _Recorder(monkeypatch, port.kv_cache.tier)
    a = np.asarray([list(range(3, 23))])
    b = np.asarray([list(range(40, 60))])
    try:
        for prompt in (a, b, a):
            np.testing.assert_array_equal(port.generate(prompt, 6).tokens,
                                          ref.generate(prompt, 6).tokens)
            assert (_strip(port.kv_cache.snapshot())
                    == _strip(ref.kv_cache.snapshot()))
        assert port.kv_cache.tier.stats["promoted_blocks"] > 0
        assert port.kv_cache.tier.stats == ref.kv_cache.tier.stats
        rec.check_pages(mesh, port.kv_cache._pk, port.kv_cache._pv)
    finally:
        port.kv_cache.close()
        ref.kv_cache.close()
        free_tp(mesh, port.kv_cache._pk, port.kv_cache._pv, port.params)
