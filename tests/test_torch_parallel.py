"""The torch port's ``parallel/`` (meshes, sharding, tensor parallelism)
against the JAX package's on the conftest's virtual 8-device CPU mesh.

The port's ranks are processes: rank 0 is this test process, the
followers are spawned (gloo on the CPU).  One tp=2 and one tp=4 mesh
serve the whole module.  The same numpy weights (the reference's init,
carried across by ``models/bridge.py``) go through the reference's
``make_tp_stage_fn`` under ``shard_map`` and the port's over its ranks:
logits within 2e-4, and each rank's cache plane equal to the reference's
cache shard on the same device index.  Then the spec trees, the shard
placement (``bridge.shard_from_numpy`` against ``shard_params``), the
refusals' texts, ``init_multihost``, the collectives, and a dead
follower failing its caller.
"""

import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_inference_demo_tpu.models import KVCache as RefKVCache
from distributed_inference_demo_tpu.models import StageSpec as RefSpec
from distributed_inference_demo_tpu.models import \
    get_model_config as ref_get_model_config
from distributed_inference_demo_tpu.models.decoder import \
    init_full_params as ref_init_full_params
from distributed_inference_demo_tpu.ops import quant as ref_quant
from distributed_inference_demo_tpu.parallel import MeshConfig as RefMesh
from distributed_inference_demo_tpu.parallel import make_mesh
from distributed_inference_demo_tpu.parallel import \
    sharding as ref_sharding
from distributed_inference_demo_tpu.parallel.mesh import \
    init_multihost as ref_init_multihost
from distributed_inference_demo_tpu.parallel.tensor import \
    make_tp_stage_fn as ref_make_tp_stage_fn
from distributed_inference_demo_tpu_torch.models import get_model_config
from distributed_inference_demo_tpu_torch.models.base import StageSpec
from distributed_inference_demo_tpu_torch.models.bridge import (
    params_from_numpy, shard_from_numpy)
from distributed_inference_demo_tpu_torch.ops.quant import (
    QuantizedArray, QuantizedArray4)
from distributed_inference_demo_tpu_torch.parallel import sharding
from distributed_inference_demo_tpu_torch.parallel import tensor as tp_mod
from distributed_inference_demo_tpu_torch.parallel.mesh import (
    AXES, MeshConfig, collective_probe, init_multihost, local_mesh,
    local_tp_mesh)

TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tp2():
    with local_tp_mesh(2, device="cpu", timeout_s=120) as mesh:
        yield mesh


@pytest.fixture(scope="module")
def tp4():
    with local_tp_mesh(4, device="cpu", timeout_s=120) as mesh:
        yield mesh


def _leaf(v):
    if isinstance(v, ref_quant.QuantizedArray4):
        return {"q": np.asarray(v.q), "scale": np.asarray(v.scale),
                "group": v.group}
    if isinstance(v, ref_quant.QuantizedArray):
        return {"q": np.asarray(v.q), "scale": np.asarray(v.scale)}
    return np.asarray(v)


def numpy_tree(rp):
    return {k: None if v is None else {n: _leaf(a) for n, a in v.items()}
            for k, v in dict(layers=rp.layers, embed=rp.embed,
                             final_norm=rp.final_norm,
                             lm_head=rp.lm_head).items()}


def _weights(name, quantize=False):
    rcfg = ref_get_model_config(name)
    rp = ref_init_full_params(jax.random.PRNGKey(0), rcfg,
                              quantize=quantize)
    return rcfg, rp, numpy_tree(rp), get_model_config(name)


def _shard_on(arr, mesh, rank):
    """The reference array's shard on the mesh's device ``rank``."""
    dev = mesh.devices.reshape(-1)[rank]
    return next(np.asarray(s.data) for s in arr.addressable_shards
                if s.device == dev)


@pytest.mark.parametrize("name,quantize,tp", [
    ("llama-test", False, 2),
    ("llama-test-int8", True, 2),
    ("bloom-test", False, 2),
    ("mixtral-test", False, 2),
    ("bloom-test", False, 4),
])
def test_manual_tp_matches_reference(name, quantize, tp, devices, request):
    """tp ranks' forward = the reference's shard_map forward (logits
    within 2e-4; ALiBi slopes sliced by rank on bloom; experts sliced on
    mixtral), and every rank's kv-head cache plane equals the reference's
    cache shard on that device index."""
    mesh = request.getfixturevalue(f"tp{tp}")
    rcfg, rp, tree, cfg = _weights(name, quantize)
    rspec = RefSpec(0, 1, 0, rcfg.num_layers)
    ids = np.arange(10, dtype=np.int32).reshape(1, 10) % rcfg.vocab_size
    pos = np.arange(10)[None, :]
    rmesh = make_mesh(RefMesh(tp=tp), devices[:tp])
    with rmesh:
        fn = ref_make_tp_stage_fn(rcfg, rspec, rmesh, rp)
        want, rcache = fn(rp, jnp.asarray(ids),
                          RefKVCache.create(rcfg, rcfg.num_layers, 1, 32),
                          jnp.asarray(pos))

    params = tp_mod.distribute_params(params_from_numpy(tree, cfg, "cpu"),
                                      cfg, mesh)
    spec = StageSpec(0, 1, 0, cfg.num_layers)
    cache = tp_mod.new_tp_cache(cfg, mesh, cfg.num_layers, 1, 32)
    got, cache2 = tp_mod.make_tp_stage_fn(cfg, spec, mesh, params)(
        params, torch.from_numpy(ids).long(), cache,
        torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert cache2.length == int(rcache.length) == 10
    for which, obj in (("keys", cache.keys), ("values", cache.values)):
        planes = tp_mod.fetch_tp(mesh, obj)
        assert len(planes) == tp
        for r, plane in enumerate(planes):
            np.testing.assert_allclose(
                plane.numpy(), _shard_on(getattr(rcache, which), rmesh, r),
                **TOL)
    tp_mod.free_tp(mesh, params, cache.keys, cache.values)


def test_tp_rejects_indivisible_heads(tp4, devices):
    rcfg = ref_get_model_config("llama-test")        # nkv = 2
    rp = ref_init_full_params(jax.random.PRNGKey(0), rcfg)
    with pytest.raises(ValueError, match="num_kv_heads") as want:
        ref_make_tp_stage_fn(rcfg, RefSpec(0, 1, 0, rcfg.num_layers),
                             make_mesh(RefMesh(tp=4), devices[:4]), rp)
    cfg = get_model_config("llama-test")
    with pytest.raises(ValueError, match="num_kv_heads") as got:
        tp_mod.make_tp_stage_fn(cfg, StageSpec(0, 1, 0, cfg.num_layers),
                                tp4, None)
    assert str(got.value) == str(want.value)


def _as_tuples(tree):
    """A reference spec tree with PartitionSpecs as tuples."""
    def leaf(v):
        if isinstance(v, (ref_quant.QuantizedArray,
                          ref_quant.QuantizedArray4)):
            return (tuple(v.q), tuple(v.scale))
        return tuple(v)
    return {part: None if getattr(tree, part) is None else
            {k: leaf(v) for k, v in getattr(tree, part).items()}
            for part in ("layers", "embed", "final_norm", "lm_head")}


def _port_tuples(tree):
    def leaf(v):
        if isinstance(v, (QuantizedArray, QuantizedArray4)):
            return (v.q, v.scale)
        return v
    return {part: None if getattr(tree, part) is None else
            {k: leaf(v) for k, v in getattr(tree, part).items()}
            for part in ("layers", "embed", "final_norm", "lm_head")}


@pytest.mark.parametrize("name,quantize", [
    ("llama-test", False), ("llama-test-int8", True), ("bloom-test", False),
    ("mixtral-test", False), ("mixtral-test-int8", True),
    ("qwen2-test", False)])
def test_spec_trees_equal_reference(name, quantize):
    rcfg, rp, tree, cfg = _weights(name, quantize)
    params = params_from_numpy(tree, cfg, "cpu")
    for kw in (dict(vocab_parallel_embed=False),
               dict(vocab_parallel_embed=True),
               dict(use_tp=False), dict(pp_shard=True)):
        want = ref_sharding.stage_param_spec_tree(rp, rcfg, **kw)
        got = sharding.stage_param_spec_tree(params, cfg, **kw)
        assert _port_tuples(got) == _as_tuples(want), kw
    for key in params.layers:
        assert sharding.layer_spec(key, cfg) == tuple(
            ref_sharding.layer_spec(key, rcfg))
        q = sharding.layer_spec(key, cfg)
        assert sharding.quant_scale_spec(q) == tuple(
            ref_sharding.quant_scale_spec(jax.sharding.PartitionSpec(*q)))


def test_int4_under_tp_refusal_equals_reference():
    rcfg, rp, tree, cfg = _weights("llama-test-int4", "int4")
    with pytest.raises(ValueError, match="int4") as want:
        ref_sharding.stage_param_spec_tree(rp, rcfg)
    with pytest.raises(ValueError, match="int4") as got:
        sharding.stage_param_spec_tree(params_from_numpy(tree, cfg, "cpu"),
                                       cfg)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name,quantize,vpe", [
    ("llama-test", False, False), ("llama-test", False, True),
    ("llama-test-int8", True, False), ("mixtral-test", False, False),
    ("mixtral-test-int8", True, False)])
def test_shard_placement_equals_reference(name, quantize, vpe, devices):
    """For every leaf, rank r's slice (``bridge.shard_from_numpy``) equals
    the reference's ``shard_params`` shard on device r."""
    rcfg, rp, tree, cfg = _weights(name, quantize)
    rmesh = make_mesh(RefMesh(tp=2), devices[:2])
    placed = ref_sharding.shard_params(rp, rcfg, rmesh,
                                       vocab_parallel_embed=vpe)
    specs = sharding.stage_param_spec_tree(
        params_from_numpy(tree, cfg, "cpu"), cfg, vocab_parallel_embed=vpe)
    for r in range(2):
        mine = shard_from_numpy(tree, cfg, {"tp": 2}, r, "cpu", specs)
        for part in ("layers", "embed", "final_norm", "lm_head"):
            ref_part = getattr(placed, part)
            if ref_part is None:
                assert getattr(mine, part) is None
                continue
            for k, v in ref_part.items():
                m = getattr(mine, part)[k]
                if isinstance(v, ref_quant.QuantizedArray):
                    pairs = [(m.q, v.q), (m.scale, v.scale)]
                else:
                    pairs = [(m, v)]
                for t, a in pairs:
                    np.testing.assert_array_equal(
                        t.numpy(), _shard_on(a, rmesh, r), err_msg=k)


def test_init_multihost_single_process():
    """The reference's topology checks and texts; one process joins its
    own group (its store) and a one-rank mesh."""
    for args, kw, match in (((("127.0.0.1:1", 2, 5)), {}, "process topology"),
                            (("127.0.0.1:1", 1, 0),
                             {"local_device_count": 0},
                             "local_device_count")):
        with pytest.raises(ValueError, match=match) as want:
            ref_init_multihost(*args, **kw)
        with pytest.raises(ValueError, match=match) as got:
            init_multihost(*args, **kw)
        assert str(got.value) == str(want.value)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mh = init_multihost(f"127.0.0.1:{port}", 1, 0)
    assert (mh["process_id"], mh["num_processes"]) == (0, 1)
    from distributed_inference_demo_tpu_torch.parallel.mesh import \
        multihost_mesh
    mesh = multihost_mesh(MeshConfig(), mh, "cpu")
    assert mesh.rank == 0 and mesh.world == 1 and mesh.groups == {}
    mesh.close()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_collectives_over_gloo(tp4, dtype):
    got = collective_probe(tp4, "tp", dtype)
    n = 4
    for r, res in enumerate(got):
        f = {k: v.float().numpy() for k, v in res.items()}
        np.testing.assert_array_equal(f["sum"], np.full((2, 3), 10.0))
        np.testing.assert_array_equal(f["max"], np.full((2, 3), 4.0))
        np.testing.assert_array_equal(
            f["gather"], np.concatenate([np.arange(2) + 10 * s
                                         for s in range(n)]))
        np.testing.assert_array_equal(
            f["all_to_all"], np.stack([16 * s + np.arange(2) + 2 * r
                                       for s in range(n)]))
        np.testing.assert_array_equal(f["rotate"], [(r - 1) % n])
        np.testing.assert_array_equal(f["broadcast"], [1.0])


def test_mesh_layout_and_axes(tp2):
    assert AXES == ("dp", "pp", "ep", "sp", "tp")
    assert dict(tp2.shape) == {"dp": 1, "pp": 1, "ep": 1, "tp": 2, "sp": 1}
    assert tp2.rank == 0 and tp2.world == 2 and tp2.backend == "gloo"
    assert tp2.group("tp").size == 2 and tp2.group("sp") is None
    assert "tp=2 backend=gloo" in tp2.describe()
    assert local_tp_mesh(1) is None


def test_dead_follower_fails_the_caller_and_leaves_no_process():
    mesh = local_mesh(MeshConfig(sp=2), device="cpu", timeout_s=30)
    procs = list(mesh._procs)
    try:
        procs[0].kill()
        procs[0].join(timeout=30)
        with pytest.raises(RuntimeError, match="follower rank 1"):
            collective_probe(mesh, "sp")
    finally:
        mesh.close()
    assert not any(p.is_alive() for p in procs)
    with pytest.raises(RuntimeError, match="closed"):
        collective_probe(mesh, "sp")
