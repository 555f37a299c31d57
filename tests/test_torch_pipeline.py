"""The torch port's ``parallel/pipeline.py`` against the JAX package's on
the conftest's virtual 8-device CPU mesh.

The port's ranks are processes (rank 0 is this test process, gloo on
the CPU); one pp=2 and one tp=2 mesh serve the module.  The same numpy
weights (the reference's init, carried across by ``models/bridge.py``)
and the same numpy-seeded batches go through both packages: the
training form of ``stage_forward``, the pipeline's loss, one
``sgd(1.0)`` step's change of ``wq``, ``w_down`` and the embedding
against the reference's single-device gradient (the reference's own
tolerance), three Adam steps against optax's, the quantized forward,
the circular decode's greedy tokens, and the refusals' texts.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as RefP

from distributed_inference_demo_tpu.models import KVCache as RefKVCache
from distributed_inference_demo_tpu.models import StageSpec as RefSpec
from distributed_inference_demo_tpu.models import \
    get_model_config as ref_get_model_config
from distributed_inference_demo_tpu.models.decoder import \
    init_full_params as ref_init_full_params
from distributed_inference_demo_tpu.models.decoder import \
    stage_forward as ref_stage_forward
from distributed_inference_demo_tpu.ops import quant as ref_quant
from distributed_inference_demo_tpu.ops.sampling import \
    SamplingParams as RefSampling
from distributed_inference_demo_tpu.parallel import MeshConfig as RefMesh
from distributed_inference_demo_tpu.parallel import make_mesh
from distributed_inference_demo_tpu.parallel import pipeline as ref_pipe
from distributed_inference_demo_tpu.parallel.compat import shard_map
from distributed_inference_demo_tpu_torch.models import get_model_config
from distributed_inference_demo_tpu_torch.models.base import (KVCache,
                                                              StageSpec)
from distributed_inference_demo_tpu_torch.models.bridge import \
    params_from_numpy
from distributed_inference_demo_tpu_torch.models.decoder import \
    stage_forward
from distributed_inference_demo_tpu_torch.ops.sampling import SamplingParams
from distributed_inference_demo_tpu_torch.parallel import pipeline as pipe
from distributed_inference_demo_tpu_torch.parallel.mesh import (
    MeshConfig, collective_probe, local_mesh)
from distributed_inference_demo_tpu_torch.parallel.tensor import free_tp

LOSS_RTOL = 1e-4
GRAD_TOL = dict(rtol=2e-3, atol=2e-5)     # the reference's own, :171-181
ADAM_RTOL = 1e-3
LOGIT_TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pp2():
    with local_mesh(MeshConfig(pp=2), "cpu", timeout_s=120) as mesh:
        yield mesh


@pytest.fixture(scope="module")
def tp2():
    with local_mesh(MeshConfig(tp=2), "cpu", timeout_s=120) as mesh:
        yield mesh


def _leaf(v):
    if isinstance(v, ref_quant.QuantizedArray4):
        return {"q": np.asarray(v.q), "scale": np.asarray(v.scale),
                "group": v.group}
    if isinstance(v, ref_quant.QuantizedArray):
        return {"q": np.asarray(v.q), "scale": np.asarray(v.scale)}
    return np.asarray(v)


def _weights(name, quantize=False):
    rcfg = ref_get_model_config(name)
    rp = ref_init_full_params(jax.random.PRNGKey(0), rcfg,
                              quantize=quantize)
    tree = {k: None if v is None else {n: _leaf(a) for n, a in v.items()}
            for k, v in dict(layers=rp.layers, embed=rp.embed,
                             final_norm=rp.final_norm,
                             lm_head=rp.lm_head).items()}
    cfg = get_model_config(name)
    return rcfg, rp, cfg, params_from_numpy(tree, cfg, "cpu")


def _batch(vocab, shape=(4, 8), seed=3):
    ids = np.random.default_rng(seed).integers(0, vocab, shape,
                                               dtype=np.int32)
    targets = np.roll(ids, -1, axis=1)
    targets[:, -1] = -100
    return ids, targets


def _ref_loss_fn(rcfg, ids, targets):
    b, s = ids.shape
    spec = RefSpec(0, 1, 0, rcfg.num_layers)
    pos = jnp.broadcast_to(jnp.arange(s), (b, s))

    def loss_fn(p):
        logits, _ = ref_stage_forward(
            p, rcfg, spec, jnp.asarray(ids),
            RefKVCache.create(rcfg, rcfg.num_layers, b, s), pos)
        logp = jax.nn.log_softmax(logits.astype(jnp.float32), -1)
        mask = targets != -100
        ll = jnp.take_along_axis(logp, jnp.maximum(targets, 0)[..., None],
                                 -1)[..., 0]
        return -jnp.sum(jnp.where(mask, ll, 0)) / jnp.sum(mask)

    return loss_fn


@functools.lru_cache(maxsize=None)
def _ref_value_and_grad(name, seed=3):
    """The reference's single-device loss and gradient on ``_batch``'s
    batch (compiled once, shared by the tests that hold the port to it)."""
    rcfg, rp, _, _ = _weights(name)
    ids, targets = _batch(rcfg.vocab_size, seed=seed)
    loss, grads = jax.jit(jax.value_and_grad(
        _ref_loss_fn(rcfg, ids, targets)))(rp)
    return float(loss), grads


def _t(a):
    return torch.from_numpy(np.asarray(a)).long()


def test_training_form_runs_backward_where_cached_form_cannot():
    """The cached form writes every layer's K/V into one shared cache
    tensor, so ``backward()`` through it fails on autograd's version
    check; the training form (``cache=None``) gives the same logits as
    the reference's forward and runs ``backward()``."""
    rcfg, rp, cfg, params = _weights("llama-test")
    ids, _ = _batch(cfg.vocab_size)
    pos = torch.arange(8).expand(4, 8)
    spec = StageSpec(0, 1, 0, cfg.num_layers)
    want, _ = jax.jit(lambda p, i: ref_stage_forward(
        p, rcfg, RefSpec(0, 1, 0, rcfg.num_layers), i,
        RefKVCache.create(rcfg, rcfg.num_layers, 4, 8),
        jnp.broadcast_to(jnp.arange(8), (4, 8))))(rp, jnp.asarray(ids))
    for v in params.layers.values():
        v.requires_grad_(True)
    cached, _ = stage_forward(params, cfg, spec, _t(ids),
                              KVCache.create(cfg, cfg.num_layers, 4, 8,
                                             device="cpu"), pos)
    with pytest.raises(RuntimeError, match="inplace operation"):
        cached.sum().backward()
    out, cache = stage_forward(params, cfg, spec, _t(ids), None, pos)
    assert cache is None
    out.sum().backward()
    assert all(v.grad is not None and v.grad.abs().sum() > 0
               for v in params.layers.values())
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               **LOGIT_TOL)
    assert torch.equal(out.detach(), cached.detach())


@pytest.mark.parametrize("mesh_name", ["pp2", "tp2"])
def test_pipeline_loss_matches_reference(mesh_name, request):
    """``pipeline_apply``'s loss at step 0, through two microbatches,
    equals the reference's single-device loss and its own pipeline's."""
    mesh = request.getfixturevalue(mesh_name)
    rcfg, rp, cfg, params = _weights("llama-test")
    ids, targets = _batch(cfg.vocab_size)
    want = _ref_value_and_grad("llama-test")[0]
    got = pipe.pipeline_loss(params, cfg, mesh, _t(ids).reshape(2, 2, 8),
                             _t(targets).reshape(2, 2, 8))
    np.testing.assert_allclose(float(got), want, rtol=LOSS_RTOL)


def _sgd_update_check(mesh, name="llama-test"):
    rcfg, rp, cfg, params = _weights(name)
    ids, targets = _batch(cfg.vocab_size)
    ref_loss, ref_grads = _ref_value_and_grad(name)
    step = pipe.make_pipeline_train_step(
        cfg, mesh, functools.partial(torch.optim.SGD, lr=1.0), 2)
    new, opt, loss = step(params, None, _t(ids), _t(targets))
    got = pipe.gather_pipeline_params(new, cfg)     # every float leaf
    names = list(got)
    assert {("layers", "wq"), ("layers", "w_down"),
            ("embed", "tokens")} <= set(names)
    for part, key in names:
        delta = (getattr(params, part)[key] - got[(part, key)]).numpy()
        want = np.asarray(getattr(ref_grads, part)[key], np.float32)
        np.testing.assert_allclose(delta, want, **GRAD_TOL,
                                   err_msg=f"{part}/{key}")
    free_tp(mesh, new, opt)
    return float(loss), ref_loss


@pytest.mark.parametrize("mesh_name", ["pp2", "tp2"])
def test_sgd_update_matches_single_device_gradient(mesh_name, request):
    """With ``sgd(1.0)`` each leaf's change is its gradient: every leaf
    (``wq``, ``w_down``, the norms, the head, and the embedding, used on
    the first rank only and summed over pp) changes by the reference's
    single-device gradient, so no pp or tp factor is left over (module
    docstring)."""
    loss, want = _sgd_update_check(request.getfixturevalue(mesh_name))
    np.testing.assert_allclose(loss, want, rtol=LOSS_RTOL)


@pytest.mark.slow
@pytest.mark.parametrize("shape", [MeshConfig(pp=2, tp=2),
                                   MeshConfig(dp=2, pp=2, tp=2)])
def test_sgd_update_matches_single_device_gradient_wide(shape):
    with local_mesh(shape, "cpu", timeout_s=120) as mesh:
        loss, want = _sgd_update_check(mesh)
    np.testing.assert_allclose(loss, want, rtol=LOSS_RTOL)


def test_adam_steps_track_optax(pp2):
    """Three ``adam(1e-2)`` steps through the pp=2 pipeline track optax's
    Adam on the reference's single-device loss, loss for loss."""
    rcfg, rp, cfg, params = _weights("llama-test")
    ids, targets = _batch(cfg.vocab_size, seed=5)
    loss_fn = jax.jit(jax.value_and_grad(_ref_loss_fn(rcfg, ids, targets)))
    opt = optax.adam(1e-2)
    state, p, want = opt.init(rp), rp, []
    for _ in range(3):
        loss, g = loss_fn(p)
        upd, state = opt.update(g, state, p)
        p = optax.apply_updates(p, upd)
        want.append(float(loss))
    step = pipe.make_pipeline_train_step(
        cfg, pp2, functools.partial(torch.optim.Adam, lr=1e-2, eps=1e-8), 2)
    got, tree, o = [], params, None
    for _ in range(3):
        tree, o, loss = step(tree, o, _t(ids), _t(targets))
        got.append(float(loss))
    free_tp(pp2, tree, o)
    np.testing.assert_allclose(got, want, rtol=ADAM_RTOL)
    assert got[-1] < got[0]


def test_one_rank_state_resumes_on_pp2(pp2):
    """A one-rank run's tree and AdamW state (a checkpoint's pair)
    continue on the pp=2 mesh: each rank loads its slice of the
    optimizer's state, and the next step's loss and weights equal the
    one-rank run's next step."""
    import copy

    from distributed_inference_demo_tpu_torch.models.base import StageParams

    _, _, cfg, params = _weights("llama-test")
    ids, targets = (_t(a) for a in _batch(cfg.vocab_size, seed=6))
    adamw = functools.partial(torch.optim.AdamW, lr=1e-2, weight_decay=1e-4)
    with local_mesh(MeshConfig(), "cpu") as one:
        step = pipe.make_pipeline_train_step(cfg, one, adamw, 2)
        p1, o1, _ = step(params, None, ids, targets)
        tree = StageParams(**{n: {k: v.detach().clone()
                                  for k, v in getattr(p1, n).items()}
                              for n in ("layers", "embed", "final_norm",
                                        "lm_head")})
        state = adamw([v for _, _, v in pipe.trainable_leaves(tree)])
        state.load_state_dict(copy.deepcopy(o1.state_dict()))
        want_p, _, want = step(p1, o1, ids, targets)
    got_p, got_o, got = pipe.make_pipeline_train_step(cfg, pp2, adamw, 2)(
        tree, state, ids, targets)
    names = [("layers", "wq"), ("layers", "w_down"), ("embed", "tokens")]
    full = pipe.gather_pipeline_params(got_p, cfg, names)
    free_tp(pp2, got_p, got_o)
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)
    for part, key in names:
        np.testing.assert_allclose(
            full[(part, key)].numpy(),
            getattr(want_p, part)[key].detach().numpy(), rtol=1e-5,
            atol=1e-6, err_msg=f"{part}/{key}")


@pytest.mark.parametrize("name,quantize,mesh_name,shape", [
    ("llama-test-int8", True, "pp2tp2", RefMesh(pp=2, tp=2)),
    # int4 takes the same dense path; int4 has no tp slicing
    pytest.param("llama-test-int4", "int4", "pp2", RefMesh(pp=2),
                 marks=pytest.mark.slow)])
def test_quantized_forward_matches_reference(name, quantize, mesh_name,
                                             shape, devices, request):
    """A quantized tree's forward through the pipeline (``ops.quant.
    dense``: the dense kernel's plain version here) gives the reference's
    ``pipeline_apply`` loss under ``shard_map`` on the same codes, and
    the last rank's logits equal the reference's single-device forward's
    (the loss alone barely sees the layers: the final norm fixes the
    hidden state's scale)."""
    rcfg, rp, cfg, params = _weights(name, quantize)
    ids, targets = _batch(cfg.vocab_size, seed=4)
    ids_mb, targets_mb = ids.reshape(2, 2, 8), targets.reshape(2, 2, 8)
    use_tp = shape.tp > 1
    rmesh = make_mesh(shape, devices[:shape.pp * shape.tp])
    fwd = shard_map(
        lambda p, i, t: ref_pipe.pipeline_apply(rcfg, p, i, t,
                                                "tp" if use_tp else None),
        mesh=rmesh,
        in_specs=(ref_pipe._pp_in_specs(rp, rcfg, use_tp), RefP(), RefP()),
        out_specs=RefP(), check_vma=False)
    with rmesh:
        want = float(fwd(rp, jnp.asarray(ids_mb), jnp.asarray(targets_mb)))
    L, (b, s) = rcfg.num_layers, ids_mb.shape[1:]
    want_logits = np.stack([np.asarray(ref_stage_forward(
        rp, rcfg, RefSpec(0, 1, 0, L), jnp.asarray(x),
        RefKVCache.create(rcfg, L, b, s),
        jnp.broadcast_to(jnp.arange(s), (b, s)))[0]) for x in ids_mb])
    if mesh_name == "pp2tp2":
        with local_mesh(MeshConfig(pp=2, tp=2), "cpu",
                        timeout_s=120) as mesh:
            got, logits = pipe.pipeline_loss(
                params, cfg, mesh, _t(ids_mb), _t(targets_mb),
                return_logits=True)
    else:
        got, logits = pipe.pipeline_loss(
            params, cfg, request.getfixturevalue(mesh_name), _t(ids_mb),
            _t(targets_mb), return_logits=True)
    np.testing.assert_allclose(float(got), want, rtol=LOSS_RTOL)
    np.testing.assert_allclose(logits.float().numpy(), want_logits,
                               **LOGIT_TOL)


def test_train_step_refuses_quantized_as_reference(pp2, devices):
    """A train step over an ``-int8`` tree: the reference's
    ``value_and_grad`` raises a ``TypeError`` on the integer codes; the
    port raises the same, before any rank runs."""
    rcfg, rp, cfg, params = _weights("llama-test-int8", True)
    ids, targets = _batch(cfg.vocab_size)
    rmesh = make_mesh(RefMesh(pp=2), devices[:2])
    opt = optax.sgd(1.0)
    ref_step = ref_pipe.make_pipeline_train_step(rcfg, rmesh, opt, 2)
    with rmesh, pytest.raises(TypeError) as want:
        ref_step(rp, opt.init(rp), jnp.asarray(ids), jnp.asarray(targets))
    step = pipe.make_pipeline_train_step(
        cfg, pp2, functools.partial(torch.optim.SGD, lr=1.0), 2)
    with pytest.raises(TypeError) as got:
        step(params, None, _t(ids), _t(targets))
    assert str(got.value) == str(want.value)
    # refused on rank 0: the followers ran nothing and the mesh works
    assert [r["rotate"].tolist() for r in collective_probe(pp2, "pp")] == [
        [1.0], [0.0]]


@pytest.mark.parametrize("name,M", [("llama-test", 4), ("gemma-test", 2)])
def test_generate_greedy_equals_reference(name, M, pp2, devices):
    """The circular decode at pp=2: greedy tokens equal the reference's
    ``make_pipeline_generate_fn``'s exactly (gemma-test: its sqrt(H)
    embedding scale through ``decoder.embed_tokens``)."""
    rcfg, rp, cfg, params = _weights(name)
    new = 6 if M == 4 else 5
    ids = np.random.default_rng(7).integers(0, cfg.vocab_size, (M, 2, 8),
                                            dtype=np.int32)
    rmesh = make_mesh(RefMesh(pp=2), devices[:2])
    gen = ref_pipe.make_pipeline_generate_fn(
        rcfg, rmesh, max_seq=32, num_new_tokens=new,
        sampling=RefSampling(greedy=True))
    with rmesh:
        want = np.asarray(gen(rp, jnp.asarray(ids), jax.random.PRNGKey(0)))
    got = pipe.make_pipeline_generate_fn(
        cfg, pp2, max_seq=32, num_new_tokens=new,
        sampling=SamplingParams(greedy=True))(params, _t(ids))
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_sampled_follows_the_seed(pp2):
    """A sampled run draws from generators seeded per (seed, microbatch,
    step): one seed gives the same tokens twice, another seed others."""
    _, _, cfg, params = _weights("llama-test")
    ids = _t(np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 2, 8)))
    params = pipe.distribute_pipeline_params(params, cfg, pp2)
    gen = pipe.make_pipeline_generate_fn(cfg, pp2, max_seq=32,
                                         num_new_tokens=8,
                                         sampling=SamplingParams())
    a, b, c = gen(params, ids, 5), gen(params, ids, 5), gen(params, ids, 6)
    free_tp(pp2, params)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.shape == (2, 2, 8) and int(a.min()) >= 0


def test_bad_shapes_raise_reference_texts(pp2, tp2, devices):
    """pp < 2 and M < S are refused with the reference's texts."""
    rcfg, rp, cfg, params = _weights("llama-test")
    with pytest.raises(ValueError, match="pp >= 2") as want:
        ref_pipe.make_pipeline_generate_fn(
            rcfg, make_mesh(RefMesh(pp=1), devices[:1]), max_seq=32,
            num_new_tokens=4)
    with pytest.raises(ValueError, match="pp >= 2") as got:
        pipe.make_pipeline_generate_fn(cfg, tp2, max_seq=32,
                                       num_new_tokens=4)
    assert str(got.value) == str(want.value)
    rmesh = make_mesh(RefMesh(pp=2), devices[:2])
    gen = ref_pipe.make_pipeline_generate_fn(rcfg, rmesh, max_seq=32,
                                             num_new_tokens=4)
    with rmesh, pytest.raises(ValueError, match="microbatches") as want:
        gen(rp, jnp.zeros((1, 1, 8), jnp.int32), jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="microbatches") as got:
        pipe.make_pipeline_generate_fn(cfg, pp2, max_seq=32,
                                       num_new_tokens=4)(
            params, torch.zeros((1, 1, 8), dtype=torch.long))
    assert str(got.value) == str(want.value)
    assert not pp2.closed


@pytest.mark.parametrize("name,quantize", [
    ("llama-test", False), ("llama-test-int8", True), ("bloom-test", False),
    ("mixtral-test", False), ("gemma-test", False)])
def test_spec_and_sync_trees_equal_reference(name, quantize):
    """``_pp_in_specs`` and ``_grad_sync_axes`` give the reference's
    trees, leaf for leaf, with and without tp."""
    rcfg, rp, cfg, params = _weights(name, quantize)

    def tuples(tree, port):
        def leaf(v):
            if isinstance(v, (ref_quant.QuantizedArray,
                              ref_quant.QuantizedArray4, pipe.QuantizedArray,
                              pipe.QuantizedArray4)):
                return (tuple(v.q), tuple(v.scale))
            return tuple(v)
        return {part: None if getattr(tree, part) is None else
                {k: leaf(v) for k, v in getattr(tree, part).items()}
                for part in ("layers", "embed", "final_norm", "lm_head")}

    for use_tp in (False, True):
        assert tuples(pipe._pp_in_specs(params, cfg, use_tp), True) == \
            tuples(ref_pipe._pp_in_specs(rp, rcfg, use_tp), False)
        want = ref_pipe._grad_sync_axes(rp, rcfg, use_tp)
        got = pipe._grad_sync_axes(params, cfg, use_tp)
        assert tuples(got, True) == tuples(want, False)
