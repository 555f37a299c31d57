"""The torch port's Ulysses sequence parallelism (``parallel/ulysses.py``)
against the JAX package's on the conftest's virtual CPU mesh: sp=2 and
sp=4 ranks as processes (gloo); greedy tokens equal the single-device
engine's and the reference's Ulysses fn's (llama, and bloom with its
ALiBi slopes sliced by head block); the head-divisibility and prompt
refusals.  (The float8 cache twin sits in ``test_torch_sequence.py``.)
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
from distributed_inference_demo_tpu.parallel.ulysses import \
    make_ulysses_generate_fn as ref_make_ulysses_generate_fn
from distributed_inference_demo_tpu.runtime import \
    InferenceEngine as RefEngine
from distributed_inference_demo_tpu_torch.models import get_model_config
from distributed_inference_demo_tpu_torch.models.bridge import \
    params_from_numpy
from distributed_inference_demo_tpu_torch.ops.sampling import SamplingParams
from distributed_inference_demo_tpu_torch.parallel.mesh import local_sp_mesh
from distributed_inference_demo_tpu_torch.parallel.ulysses import \
    make_ulysses_generate_fn

RGREEDY = RefSamplingParams(greedy=True)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sp2():
    with local_sp_mesh(2, device="cpu", timeout_s=120) as mesh:
        yield mesh


@pytest.fixture(scope="module")
def sp4():
    with local_sp_mesh(4, device="cpu", timeout_s=120) as mesh:
        yield mesh


def _t(x):
    return torch.from_numpy(np.array(x))


def _weights(name):
    rcfg = ref_get_model_config(name)
    rp = ref_init_full_params(jax.random.PRNGKey(0), rcfg)
    tree = {k: None if v is None else {n: np.asarray(a)
                                       for n, a in v.items()}
            for k, v in dict(layers=rp.layers, embed=rp.embed,
                             final_norm=rp.final_norm,
                             lm_head=rp.lm_head).items()}
    cfg = get_model_config(name)
    return rcfg, rp, cfg, params_from_numpy(tree, cfg, "cpu")


@pytest.mark.parametrize("model", ["llama-test", "bloom-test"])
def test_ulysses_matches_reference(sp2, model, devices):
    rcfg, rp, cfg, params = _weights(model)
    prompt = np.random.RandomState(5).randint(0, rcfg.vocab_size,
                                              (2, 8)).astype(np.int32)
    want = RefEngine(rcfg, rp, max_seq=32, sampling=RGREEDY).generate(
        prompt, 6).tokens
    rmesh = make_mesh(RefMesh(sp=2), devices[:2])
    with rmesh:
        ref = np.asarray(ref_make_ulysses_generate_fn(
            rcfg, rmesh, max_seq=32, num_new_tokens=6, sampling=RGREEDY)(
                rp, prompt, jax.random.PRNGKey(0)))
    got = make_ulysses_generate_fn(
        cfg, sp2, max_seq=32, num_new_tokens=6,
        sampling=SamplingParams(greedy=True))(params, prompt, 0).numpy()
    np.testing.assert_array_equal(ref, want)
    np.testing.assert_array_equal(got, want)


def test_ulysses_sp4(sp4):
    """4-way: bloom-test (nkv = 4) splits its kv heads 4 ways."""
    rcfg, rp, cfg, params = _weights("bloom-test")
    prompt = np.random.RandomState(7).randint(0, rcfg.vocab_size,
                                              (1, 8)).astype(np.int32)
    want = RefEngine(rcfg, rp, max_seq=32, sampling=RGREEDY).generate(
        prompt, 4).tokens
    got = make_ulysses_generate_fn(cfg, sp4, max_seq=32, num_new_tokens=4)(
        params, prompt, 0).numpy()
    np.testing.assert_array_equal(got, want)


def test_ulysses_rejects_bad_configs(sp2, sp4, devices):
    rcfg = ref_get_model_config("llama-test")            # nkv = 2
    with pytest.raises(ValueError, match="divisible") as want:
        ref_make_ulysses_generate_fn(rcfg, make_mesh(RefMesh(sp=4),
                                                     devices[:4]),
                                     max_seq=32, num_new_tokens=2)
    cfg = get_model_config("llama-test")
    with pytest.raises(ValueError, match="divisible") as got:
        make_ulysses_generate_fn(cfg, sp4, max_seq=32, num_new_tokens=2)
    assert str(got.value) == str(want.value)
    gen = make_ulysses_generate_fn(cfg, sp2, max_seq=16, num_new_tokens=4)
    with pytest.raises(ValueError, match="not divisible"):
        gen(None, np.zeros((1, 7), np.int32))
    with pytest.raises(ValueError, match="max_seq"):
        gen(None, np.zeros((1, 14), np.int32))
