"""The torch port's expert parallelism (``parallel/expert.py``,
``decoder._moe_mlp_ep``) against the JAX package's on the conftest's
virtual CPU mesh, ep=2: the port's ranks are processes (one spawned
follower, gloo).

GShard capacity dispatch with two all-to-alls: with a generous capacity
it reproduces the dense MoE MLP; with a small one it drops exactly the
over-capacity tokens (zero output), as the reference does; the whole
mixtral stage E-sliced over ep (float, int8 and int4 expert stacks)
gives the reference's prefill logits and decode step; the refusals'
texts are the reference's.  Floats within 2e-4 (3e-4 for the stage, the
reference's own tolerance).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from distributed_inference_demo_tpu.models import KVCache as RefKVCache
from distributed_inference_demo_tpu.models import StageSpec as RefSpec
from distributed_inference_demo_tpu.models import \
    get_model_config as ref_get_model_config
from distributed_inference_demo_tpu.models.decoder import _moe_mlp as \
    ref_moe_mlp
from distributed_inference_demo_tpu.models.decoder import _moe_mlp_ep as \
    ref_moe_mlp_ep
from distributed_inference_demo_tpu.models.decoder import \
    init_full_params as ref_init_full_params
from distributed_inference_demo_tpu.ops import quant as ref_quant
from distributed_inference_demo_tpu.parallel import MeshConfig as RefMesh
from distributed_inference_demo_tpu.parallel import make_mesh
from distributed_inference_demo_tpu.parallel.compat import shard_map
from distributed_inference_demo_tpu.parallel.expert import \
    make_ep_stage_fn as ref_make_ep_stage_fn
from distributed_inference_demo_tpu_torch.models import get_model_config
from distributed_inference_demo_tpu_torch.models.base import StageSpec
from distributed_inference_demo_tpu_torch.models.bridge import \
    params_from_numpy
from distributed_inference_demo_tpu_torch.parallel.expert import (
    distribute_ep_params, make_ep_stage_fn, new_ep_cache, run_ep_mlp)
from distributed_inference_demo_tpu_torch.parallel.mesh import (MeshConfig,
                                                                local_mesh)

TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ep2():
    with local_mesh(MeshConfig(ep=2), device="cpu", timeout_s=120) as mesh:
        yield mesh


def _layer_moe_params(rng, cfg):
    """One layer's MoE weights (no stacked-L axis), float32: the
    reference test's draws."""
    E, H, I = cfg.num_experts, cfg.hidden_size, cfg.intermediate_size
    ks = jax.random.split(rng, 4)
    s = H ** -0.5
    return {
        "router": jax.random.normal(ks[0], (H, E), jnp.float32) * s,
        "w_gate": jax.random.normal(ks[1], (E, H, I), jnp.float32) * s,
        "w_up": jax.random.normal(ks[2], (E, H, I), jnp.float32) * s,
        "w_down": jax.random.normal(ks[3], (E, I, H), jnp.float32)
                  * I ** -0.5,
    }


def _ref_ep_mlp(cfg, lp, x, mesh):
    specs = {"router": P(), "w_gate": P("ep", None, None),
             "w_up": P("ep", None, None), "w_down": P("ep", None, None)}
    fn = shard_map(lambda lp_, x_: ref_moe_mlp_ep(cfg, lp_, x_, "ep"),
                   mesh=mesh, in_specs=(specs, P("ep")), out_specs=P("ep"),
                   check_vma=False)
    with mesh:
        return np.asarray(fn(lp, x))


def _torch(tree):
    return {k: torch.from_numpy(np.asarray(v).copy()) for k, v in
            tree.items()}


def test_ep_dispatch_matches_dense(ep2, devices):
    """Generous capacity: the all-to-all dispatch = the dense batched
    experts, and = the reference's dispatch."""
    rcfg = ref_get_model_config("mixtral-test").replace(
        moe_capacity_factor=4.0)
    cfg = get_model_config("mixtral-test").replace(moe_capacity_factor=4.0)
    lp = _layer_moe_params(jax.random.PRNGKey(0), rcfg)
    x = jax.random.normal(jax.random.PRNGKey(1), (2, 10, rcfg.hidden_size),
                          jnp.float32)
    dense = np.asarray(ref_moe_mlp(rcfg, lp, x))
    want = _ref_ep_mlp(rcfg, lp, x, make_mesh(RefMesh(ep=2), devices[:2]))
    got = run_ep_mlp(ep2, cfg, _torch(lp),
                     torch.from_numpy(np.array(x))).numpy()
    np.testing.assert_allclose(got, dense, **TOL)
    np.testing.assert_allclose(got, want, **TOL)


def test_ep_capacity_drop(ep2, devices):
    """factor < 1: tokens past each expert's capacity get exactly zero MoE
    output (the GShard drop), earlier tokens are untouched; the same
    tokens drop as in the reference."""
    rcfg = ref_get_model_config("mixtral-test").replace(
        moe_capacity_factor=0.5)
    cfg = get_model_config("mixtral-test").replace(moe_capacity_factor=0.5)
    lp = _layer_moe_params(jax.random.PRNGKey(0), rcfg)
    E = rcfg.num_experts
    router = jnp.zeros((rcfg.hidden_size, E), jnp.float32)
    lp = dict(lp, router=router.at[:, 0].set(1.0).at[:, 1].set(0.5))
    b, s = 2, 8
    x = jnp.abs(jax.random.normal(jax.random.PRNGKey(1),
                                  (b, s, rcfg.hidden_size), jnp.float32)) + 0.1
    T = (b // 2) * s
    C = int(np.ceil(T * rcfg.experts_per_token / E * 0.5))
    assert C < T
    y = run_ep_mlp(ep2, cfg, _torch(lp),
                   torch.from_numpy(np.array(x))).numpy()
    want = _ref_ep_mlp(rcfg, lp, x, make_mesh(RefMesh(ep=2), devices[:2]))
    np.testing.assert_allclose(y, want, **TOL)
    dense = np.asarray(ref_moe_mlp(rcfg, lp, x)).reshape(2, T, -1)
    y = y.reshape(2, T, -1)
    np.testing.assert_allclose(y[:, :C], dense[:, :C], **TOL)
    np.testing.assert_array_equal(y[:, C:], np.zeros_like(y[:, C:]))


def _leaf(v):
    if isinstance(v, ref_quant.QuantizedArray4):
        return {"q": np.asarray(v.q), "scale": np.asarray(v.scale),
                "group": v.group}
    if isinstance(v, ref_quant.QuantizedArray):
        return {"q": np.asarray(v.q), "scale": np.asarray(v.scale)}
    return np.asarray(v)


@pytest.mark.parametrize("quant", [False, "int8", "int4"])
def test_ep_stage_prefill_decode_parity(quant, ep2, devices):
    """The whole mixtral stage E-sliced over ep=2 (float, int8 and packed
    int4 expert stacks): prefill logits and one decode step on the
    batch-sharded cache equal the reference's ep stage."""
    name = "mixtral-test" + (f"-{quant}" if quant else "")
    rcfg = ref_get_model_config(name).replace(moe_capacity_factor=8.0)
    cfg = get_model_config(name).replace(moe_capacity_factor=8.0)
    rp = ref_init_full_params(jax.random.PRNGKey(0), rcfg, quantize=quant)
    tree = {k: None if v is None else {n: _leaf(a) for n, a in v.items()}
            for k, v in dict(layers=rp.layers, embed=rp.embed,
                             final_norm=rp.final_norm,
                             lm_head=rp.lm_head).items()}
    b, plen = 2, 8
    ids = (np.arange(b * plen, dtype=np.int32).reshape(b, plen)
           % rcfg.vocab_size)
    pos = np.broadcast_to(np.arange(plen), (b, plen))
    rmesh = make_mesh(RefMesh(ep=2), devices[:2])
    with rmesh:
        rfn = ref_make_ep_stage_fn(rcfg, RefSpec(0, 1, 0, rcfg.num_layers),
                                   rmesh, rp)
        want, rcache = rfn(rp, jnp.asarray(ids),
                           RefKVCache.create(rcfg, rcfg.num_layers, b, 32),
                           jnp.asarray(pos))
        nxt = jnp.argmax(want[:, -1, :], axis=-1).astype(jnp.int32)[:, None]
        want2, _ = rfn(rp, nxt, rcache, jnp.full((b, 1), plen))

    params = distribute_ep_params(params_from_numpy(tree, cfg, "cpu"), cfg,
                                  ep2)
    fn = make_ep_stage_fn(cfg, StageSpec(0, 1, 0, cfg.num_layers), ep2,
                          params)
    cache = new_ep_cache(cfg, ep2, cfg.num_layers, b, 32)
    got, cache = fn(params, torch.from_numpy(ids).long(), cache,
                    torch.from_numpy(np.ascontiguousarray(pos)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=3e-4, atol=3e-4)
    got2, cache = fn(params, torch.from_numpy(np.array(nxt)).long(), cache,
                     torch.full((b, 1), plen))
    assert cache.length == plen + 1
    np.testing.assert_allclose(got2.numpy(), np.asarray(want2),
                               rtol=3e-4, atol=3e-4)


def test_ep_rejects_bad_configs(ep2, devices):
    rmesh = make_mesh(RefMesh(ep=2), devices[:2])
    cases = [("llama-test", {}, "MoE", jax.random.PRNGKey(0)),
             ("mixtral-test", {"num_experts": 3}, "divisible",
              jax.random.PRNGKey(1))]
    for name, over, match, key in cases:
        rcfg = ref_get_model_config(name).replace(**over)
        with pytest.raises(ValueError, match=match) as want:
            ref_make_ep_stage_fn(rcfg, RefSpec(0, 1, 0, 2), rmesh,
                                 ref_init_full_params(key, rcfg))
        cfg = get_model_config(name).replace(**over)
        with pytest.raises(ValueError, match=match) as got:
            make_ep_stage_fn(cfg, StageSpec(0, 1, 0, 2), ep2, None)
        assert str(got.value) == str(want.value)
    cfg = get_model_config("mixtral-test")
    fn = make_ep_stage_fn(cfg, StageSpec(0, 1, 0, 2), ep2, None)
    with pytest.raises(ValueError, match="batch=3 not divisible by ep=2"):
        fn(None, torch.zeros((3, 4), dtype=torch.long), None, None)
