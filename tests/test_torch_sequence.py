"""The torch port's ring sequence parallelism (``ops/ring_attention.py``,
``parallel/sequence.py``) against the JAX package's on the conftest's
virtual CPU mesh.

The port's sp ranks are processes (gloo); one sp=2 and one sp=4 mesh
serve the module.  Blockwise ring attention equals the reference's ring
and dense causal attention (ALiBi too); decode over a sequence-sharded
cache merges exactly; ring generations (llama and bloom) give the
single-device engine's greedy tokens and the reference ring fn's; a
float8 cache (ring and Ulysses) gives the float8 engine's; bad shapes
are refused with the reference's texts.  Floats within 2e-5 for the
ops (the reference's), tokens exact.  Ulysses: ``test_torch_ulysses.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from distributed_inference_demo_tpu.models import \
    get_model_config as ref_get_model_config
from distributed_inference_demo_tpu.models.decoder import \
    init_full_params as ref_init_full_params
from distributed_inference_demo_tpu.ops.attention import \
    alibi_slopes as ref_alibi_slopes
from distributed_inference_demo_tpu.ops.attention import \
    attention as ref_attention
from distributed_inference_demo_tpu.ops.ring_attention import \
    ring_self_attention as ref_ring
from distributed_inference_demo_tpu.ops.sampling import \
    SamplingParams as RefSamplingParams
from distributed_inference_demo_tpu.parallel import MeshConfig as RefMesh
from distributed_inference_demo_tpu.parallel import make_mesh
from distributed_inference_demo_tpu.parallel.compat import shard_map
from distributed_inference_demo_tpu.parallel.sequence import \
    make_sp_generate_fn as ref_make_sp_generate_fn
from distributed_inference_demo_tpu.runtime import \
    InferenceEngine as RefEngine
from distributed_inference_demo_tpu_torch.models import get_model_config
from distributed_inference_demo_tpu_torch.models.bridge import \
    params_from_numpy
from distributed_inference_demo_tpu_torch.ops.attention import alibi_slopes
from distributed_inference_demo_tpu_torch.parallel.mesh import local_sp_mesh
from distributed_inference_demo_tpu_torch.parallel.sequence import (
    make_sp_generate_fn, run_ring_attention, run_sp_decode_attention)
from distributed_inference_demo_tpu_torch.parallel.ulysses import \
    make_ulysses_generate_fn
from distributed_inference_demo_tpu_torch.runtime.engine import \
    resolve_cache_dtype_backend

OPS_TOL = dict(rtol=2e-5, atol=2e-5)
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


def _dense_causal(q, k, v, slopes=None):
    L = q.shape[1]
    q_pos = jnp.broadcast_to(jnp.arange(L), (q.shape[0], L))
    return ref_attention(q, k.transpose(0, 2, 1, 3), v.transpose(0, 2, 1, 3),
                         q_pos, jnp.asarray(L, jnp.int32), slopes)


@pytest.mark.parametrize("alibi", [False, True])
def test_ring_self_attention_matches_reference(sp4, alibi, devices):
    """4 ranks x 6 tokens: the port's ring = the reference's ring = dense
    causal attention."""
    b, L, nh, nkv, hd = 2, 24, 4, 2, 8
    rng = np.random.RandomState(0)
    q, k, v = (rng.randn(b, L, h, hd).astype(np.float32)
               for h in (nh, nkv, nkv))
    slopes = ref_alibi_slopes(nh) if alibi else None
    dense = np.asarray(_dense_causal(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), slopes))
    rmesh = make_mesh(RefMesh(sp=4), devices[:4])
    seq = P(None, "sp")
    fn = shard_map(lambda q_, k_, v_: ref_ring(q_, k_, v_, "sp",
                                               slopes=slopes),
                   mesh=rmesh, in_specs=(seq, seq, seq), out_specs=seq,
                   check_vma=False)
    want = np.asarray(fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    got = run_ring_attention(sp4, _t(q), _t(k), _t(v),
                             alibi_slopes(nh) if alibi else None).numpy()
    np.testing.assert_allclose(got, want, **OPS_TOL)
    np.testing.assert_allclose(got, dense, **OPS_TOL)


def test_sp_decode_attention_matches_dense(sp4):
    """Decode vs a cache whose 20 valid positions are spread over 4
    shards of 8 slots (5 valid each), merged by log-sum-exp."""
    b, nh, nkv, hd, SP = 2, 4, 2, 8, 4
    s_loc, per = 8, 5
    L = SP * per
    rng = np.random.RandomState(1)
    k_dense = rng.randn(b, L, nkv, hd).astype(np.float32)
    v_dense = rng.randn(b, L, nkv, hd).astype(np.float32)
    q = rng.randn(b, 1, nh, hd).astype(np.float32)
    q_pos = np.full((b, 1), L, np.int64)
    want = np.asarray(ref_attention(
        jnp.asarray(q), jnp.asarray(k_dense.transpose(0, 2, 1, 3)),
        jnp.asarray(v_dense.transpose(0, 2, 1, 3)), jnp.asarray(q_pos),
        jnp.asarray(L, jnp.int32), None))
    k_shard = np.zeros((b, nkv, SP * s_loc, hd), np.float32)
    v_shard = np.zeros_like(k_shard)
    kv_pos = np.full((SP * s_loc,), -1, np.int64)
    for r in range(SP):
        for j in range(per):
            slot, pos = r * s_loc + j, r * per + j
            k_shard[:, :, slot] = k_dense[:, pos]
            v_shard[:, :, slot] = v_dense[:, pos]
            kv_pos[slot] = pos
    got = run_sp_decode_attention(sp4, _t(q), _t(k_shard), _t(v_shard),
                                  _t(kv_pos), _t(q_pos)).numpy()
    np.testing.assert_allclose(got, want, **OPS_TOL)


@pytest.mark.parametrize("model", ["llama-test", "bloom-test"])
def test_sp_generate_matches_reference(sp2, model, devices):
    """Ring sp=2 generation: the single-device engine's greedy tokens,
    and the reference's ring fn's (ALiBi on bloom)."""
    rcfg, rp, cfg, params = _weights(model)
    prompt = np.random.RandomState(2).randint(0, rcfg.vocab_size,
                                              (2, 16)).astype(np.int32)
    want = RefEngine(rcfg, rp, max_seq=32, sampling=RGREEDY).generate(
        prompt, 8).tokens
    rmesh = make_mesh(RefMesh(sp=2), devices[:2])
    with rmesh:
        ref = np.asarray(ref_make_sp_generate_fn(
            rcfg, rmesh, max_seq=32, num_new_tokens=8)(
                rp, jnp.asarray(prompt), jax.random.PRNGKey(3)))
    got = make_sp_generate_fn(cfg, sp2, max_seq=32, num_new_tokens=8)(
        params, prompt, 3).numpy()
    np.testing.assert_array_equal(ref, want)
    np.testing.assert_array_equal(got, want)


def test_sp_generate_rejects_bad_shapes(sp2, sp4):
    cfg = get_model_config("llama-test")
    gen = make_sp_generate_fn(cfg, sp4, max_seq=32, num_new_tokens=4)
    with pytest.raises(ValueError, match="prompt_len=18 not divisible"):
        gen(None, np.zeros((1, 18), np.int32))
    with pytest.raises(ValueError, match=r"prompt 32 \+ new 4 > max_seq"):
        gen(None, np.zeros((1, 32), np.int32))
    with pytest.raises(ValueError, match="max_seq=33 not divisible"):
        make_sp_generate_fn(cfg, sp2, max_seq=33, num_new_tokens=4)


@pytest.mark.parametrize("which", ["ring", "ulysses"])
def test_sp_generate_fp8_cache_matches_fp8_engine(sp2, which):
    """A float8 sequence- (or head-) sharded cache: greedy tokens equal
    the single-device engine's over the same cache dtype."""
    rcfg, rp, cfg, params = _weights("llama-test")
    prompt = np.random.RandomState(11).randint(0, rcfg.vocab_size,
                                               (2, 16)).astype(np.int32)
    want = RefEngine(rcfg, rp, max_seq=32, sampling=RGREEDY,
                     kv_cache_dtype="float8_e4m3fn").generate(
                         prompt, 8).tokens
    make = (make_sp_generate_fn if which == "ring"
            else make_ulysses_generate_fn)
    got = make(cfg, sp2, max_seq=32, num_new_tokens=8,
               kv_cache_dtype="float8_e4m3fn")(params, prompt, 3).numpy()
    np.testing.assert_array_equal(got, want)


def test_fp8_cache_rejects_the_kernel_backend():
    """The one reduced-precision rule guards the sp paths too: a float8
    cache with the kernel backend asked for raises before any program is
    built."""
    with pytest.raises(ValueError, match="attn_backend"):
        resolve_cache_dtype_backend("float8_e4m3fn", "flash")
