"""The torch port's single-request speculative engines over a tp=2 mesh
against the JAX package's tp=2 engines on the conftest's virtual mesh.

``SpeculativeEngine`` (target ``llama-test``, a 2-layer ``llama-test``
draft from another seed, both on the tp seam) and ``PromptLookupEngine``:
greedy tokens and ``SpecStats`` equal the reference's tp=2 engines',
with chunked prefill and with the target's prefix pool; the stream
equals the loop; a sampled run equals the port's tp=1 run on the same
seed; after a generate each rank's plane of the target's and the
draft's caches equals its kv heads of the tp=1 engine's caches (2e-4).
One mesh (this process and one spawned follower, gloo) serves the
module.
"""

import dataclasses

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
from distributed_inference_demo_tpu.runtime import speculative as ref_spec
from distributed_inference_demo_tpu.runtime.engine import \
    shard_engine_params as ref_shard
from distributed_inference_demo_tpu.runtime.prompt_lookup import \
    PromptLookupEngine as RefPLD
from distributed_inference_demo_tpu_torch.models import get_model_config
from distributed_inference_demo_tpu_torch.models.bridge import \
    params_from_numpy
from distributed_inference_demo_tpu_torch.ops.sampling import SamplingParams
from distributed_inference_demo_tpu_torch.parallel.mesh import local_tp_mesh
from distributed_inference_demo_tpu_torch.parallel.tensor import fetch_tp
from distributed_inference_demo_tpu_torch.runtime.prompt_lookup import \
    PromptLookupEngine
from distributed_inference_demo_tpu_torch.runtime.speculative import \
    SpeculativeEngine

MAX_SEQ = 64
GREEDY = SamplingParams(greedy=True)
RGREEDY = RefSamplingParams(greedy=True)
TOL = dict(rtol=2e-4, atol=2e-4)
PROMPT = np.asarray([[3, 14, 15, 92, 65], [1, 2, 3, 4, 5]])
# a repeated span, so that prompt lookup accepts
REPEAT = np.asarray([[7, 8, 9, 10, 11, 7, 8, 9, 10, 11, 7, 8, 9]])


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
    rdcfg = dataclasses.replace(rcfg, num_layers=2)
    rp = ref_init_full_params(jax.random.PRNGKey(0), rcfg)
    rdp = ref_init_full_params(jax.random.PRNGKey(1), rdcfg)
    cfg = get_model_config("llama-test")
    dcfg = dataclasses.replace(cfg, num_layers=2)
    rmesh = make_mesh(RefMesh(tp=2), devices[:2])
    return dict(rcfg=rcfg, rp=rp, rdcfg=rdcfg, rdp=rdp, rmesh=rmesh,
                rp_tp=ref_shard(rp, rcfg, rmesh),
                rdp_tp=ref_shard(rdp, rdcfg, rmesh),
                cfg=cfg, p=_bridge(rp, cfg), dcfg=dcfg, dp=_bridge(rdp, dcfg))


def _spec(m, mesh=None, **kw):
    return SpeculativeEngine(m["cfg"], m["p"], m["dcfg"], m["dp"],
                             max_seq=MAX_SEQ, sampling=kw.pop("sampling",
                                                              GREEDY),
                             num_draft=4, device="cpu", mesh=mesh, **kw)


def _ref_spec(m, **kw):
    return ref_spec.SpeculativeEngine(
        m["rcfg"], m["rp_tp"], m["rdcfg"], m["rdp_tp"], max_seq=MAX_SEQ,
        sampling=RGREEDY, num_draft=4, mesh=m["rmesh"], **kw)


@pytest.mark.parametrize("kw", [
    {"prefill_chunk": 8}, {"kv_cache_blocks": 16, "kv_block_tokens": 8}])
def test_tp_speculative_equals_reference(models, mesh, kw):
    """Greedy tokens and acceptance counters equal the reference's tp=2
    engine's; with the prefix pool a second prompt hits the target's
    pool on every rank."""
    ref, eng = _ref_spec(models, **kw), _spec(models, mesh, **kw)
    prompts = [PROMPT]
    if "kv_cache_blocks" in kw:
        a = np.arange(3, 23)[None, :]
        prompts = [a, np.concatenate([a[:, :16], [[7, 7, 9]]], axis=1)]
    for p in prompts:
        rres, rstats = ref.generate(p, 14)
        res, stats = eng.generate(p, 14)
        np.testing.assert_array_equal(res.tokens, rres.tokens)
        assert vars(stats) == vars(rstats)
    if "kv_cache_blocks" in kw:
        got, want = eng.kv_cache.snapshot(), ref.kv_cache.snapshot()
        assert got["hits"] == want["hits"] == 1
        assert got["partial_hit_tokens"] == want["partial_hit_tokens"]
    streamed = np.stack(list(eng.generate_stream(prompts[-1], 9)), 1)
    np.testing.assert_array_equal(streamed,
                                  eng.generate(prompts[-1], 9)[0].tokens)
    eng.free_tp()


def test_tp_prompt_lookup_equals_reference(models, mesh):
    m = models
    ref = RefPLD(m["rcfg"], m["rp_tp"], max_seq=MAX_SEQ, sampling=RGREEDY,
                 num_draft=4, mesh=m["rmesh"])
    eng = PromptLookupEngine(m["cfg"], m["p"], max_seq=MAX_SEQ,
                             sampling=GREEDY, num_draft=4, device="cpu",
                             mesh=mesh)
    for p in (REPEAT, PROMPT):
        rres, rstats = ref.generate(p, 16)
        res, stats = eng.generate(p, 16)
        np.testing.assert_array_equal(res.tokens, rres.tokens)
        assert vars(stats) == vars(rstats)
    streamed = np.stack(list(eng.generate_stream(REPEAT, 9)), 1)
    np.testing.assert_array_equal(streamed, eng.generate(REPEAT, 9)[0]
                                  .tokens)
    eng.free_tp()


def test_tp_caches_and_sampling_equal_tp1(models, mesh):
    """A sampled run at tp=2 draws the tp=1 run's tokens on the same
    seed, and afterwards each rank's plane of both caches equals its kv
    heads of the tp=1 engine's caches up to the valid length."""
    samp = SamplingParams(temperature=0.8, top_k=20)
    one = _spec(models, sampling=samp)
    two = _spec(models, mesh, sampling=samp)
    want, wstats = one.generate(PROMPT, 14, seed=5)
    got, gstats = two.generate(PROMPT, 14, seed=5)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert vars(gstats) == vars(wstats)
    s1, s2 = one._states[2], two._states[2]
    n = int(s1.length)
    assert int(s2.length) == n
    for c1, c2 in ((s1.tcache, s2.tcache), (s1.dcache, s2.dcache)):
        for full, mine in ((c1.keys, c2.keys), (c1.values, c2.values)):
            planes = fetch_tp(mesh, mine)
            assert len(planes) == 2
            for r, plane in enumerate(planes):
                np.testing.assert_allclose(
                    plane[:, :, :, :n].numpy(),
                    full[:, :, r:r + 1, :n].numpy(), **TOL)
    two.free_tp()
    assert not mesh.objects


def test_tp_draft_heads_must_divide(models, mesh):
    """A draft whose kv heads do not divide by tp is the reference's
    ValueError, with its text."""
    m = models
    bad = dataclasses.replace(m["dcfg"], num_heads=3, num_kv_heads=1,
                              hidden_size=48)
    rbad = dataclasses.replace(m["rdcfg"], num_heads=3, num_kv_heads=1,
                               hidden_size=48)
    rbp = ref_init_full_params(jax.random.PRNGKey(2), rbad)
    with pytest.raises(ValueError) as want:
        ref_spec.SpeculativeEngine(m["rcfg"], m["rp_tp"], rbad, rbp,
                                   max_seq=MAX_SEQ, mesh=m["rmesh"])
    with pytest.raises(ValueError) as got:
        SpeculativeEngine(m["cfg"], m["p"], bad, _bridge(rbp, bad),
                          max_seq=MAX_SEQ, device="cpu", mesh=mesh)
    assert str(got.value) == str(want.value)
    assert "not divisible by tp=2" in str(got.value)
