"""A multi-rank training run's checkpoint (ROADMAP C 7): the torch port's
``TrainCheckpointManager`` handed a pp=2 (or tp=2) run's pair, rank 0's
slice and rank 0's optimizer, writes the global pair.

It restores on one rank to the tree ``gather_pipeline_params``
assembles, bit for bit, with the optimizer state in the one-rank order;
the next step from it equals the one-rank run's next step; restored onto
the same mesh, the next loss equals the uninterrupted run's.  The
reference saves its global arrays through orbax (its
``checkpoint.py:114-120``), which is absent here, so the saved pair is
held against the pair its ``make_pipeline_train_step`` returns on the
same mesh shape, weights and batch (optax's ``adam(1e-2)``), with the
loss of the next step from each, at ``test_torch_pipeline.py``'s
tolerances.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_inference_demo_tpu.models import \
    get_model_config as ref_get_model_config
from distributed_inference_demo_tpu.models.decoder import \
    init_full_params as ref_init_full_params
from distributed_inference_demo_tpu.parallel import MeshConfig as RefMesh
from distributed_inference_demo_tpu.parallel import make_mesh
from distributed_inference_demo_tpu.parallel import pipeline as ref_pipe
from distributed_inference_demo_tpu_torch.checkpoint import (
    TrainCheckpointManager, load_params, save_params)
from distributed_inference_demo_tpu_torch.models import get_model_config
from distributed_inference_demo_tpu_torch.models.bridge import \
    params_from_numpy
from distributed_inference_demo_tpu_torch.parallel import pipeline as pipe
from distributed_inference_demo_tpu_torch.parallel.mesh import (MeshConfig,
                                                                 local_mesh)
from distributed_inference_demo_tpu_torch.parallel.tensor import free_tp

LOSS_RTOL = 1e-4          # test_torch_pipeline.py's
ADAM_RTOL = 1e-3
GRAD_TOL = dict(rtol=2e-3, atol=2e-5)
ADAMW = functools.partial(torch.optim.AdamW, lr=1e-2, weight_decay=1e-4)
# optax.adam(1e-2)'s, as test_torch_pipeline.py::test_adam_steps_track_optax
ADAM = functools.partial(torch.optim.Adam, lr=1e-2, eps=1e-8)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def meshes():
    with local_mesh(MeshConfig(pp=2), "cpu", timeout_s=120) as pp2, \
            local_mesh(MeshConfig(tp=2), "cpu", timeout_s=120) as tp2:
        yield {"pp2": pp2, "tp2": tp2}


@pytest.fixture(scope="module")
def weights():
    rcfg = ref_get_model_config("llama-test")
    rp = ref_init_full_params(jax.random.PRNGKey(0), rcfg)
    tree = {k: None if v is None else {n: np.asarray(a) for n, a in v.items()}
            for k, v in dict(layers=rp.layers, embed=rp.embed,
                             final_norm=rp.final_norm,
                             lm_head=rp.lm_head).items()}
    cfg = get_model_config("llama-test")
    return cfg, tree, rcfg, rp


def _params(weights):
    cfg, tree = weights[:2]
    return params_from_numpy(tree, cfg, "cpu")


def _batch(vocab, seed):
    ids = np.random.default_rng(seed).integers(0, vocab, (4, 8),
                                               dtype=np.int32)
    targets = np.roll(ids, -1, axis=1)
    targets[:, -1] = -100
    return torch.from_numpy(ids).long(), torch.from_numpy(targets).long()


def _leaves(tree):
    return {(p, k): v.detach() for p, k, v in pipe.trainable_leaves(tree)}


@pytest.mark.parametrize("which", ["pp2", "tp2"])
def test_multi_rank_pair_restores_whole(which, meshes, weights, tmp_path):
    """The saved pair is the global one: restored on one rank it equals
    the gathered tree bit for bit (every leaf at its full shape), its
    optimizer state is the one-rank run's within the Adam tolerance, and
    the next step from it equals the one-rank run's next step; restored
    onto the mesh, the next loss equals the uninterrupted run's."""
    cfg = weights[0]
    mesh = meshes[which]
    b1, b2 = _batch(cfg.vocab_size, 6), _batch(cfg.vocab_size, 7)
    step = pipe.make_pipeline_train_step(cfg, mesh, ADAMW, 2)
    p, o, _ = step(_params(weights), None, *b1)
    mgr = TrainCheckpointManager(str(tmp_path), cfg, ADAMW, device="cpu")
    mgr.save(1, p, o)
    gathered = pipe.gather_pipeline_params(p, cfg)

    tree, opt = mgr.restore()
    got = _leaves(tree)
    assert set(got) == set(gathered)
    for name, want in gathered.items():
        assert torch.equal(got[name], want), name

    with local_mesh(MeshConfig(), "cpu") as one:
        step1 = pipe.make_pipeline_train_step(cfg, one, ADAMW, 2)
        q1, o1, _ = step1(_params(weights), None, *b1)
        for name, want in _leaves(q1).items():
            np.testing.assert_allclose(got[name].numpy(), want.numpy(),
                                       rtol=ADAM_RTOL, atol=1e-6,
                                       err_msg=str(name))
        sd, sd1 = opt.state_dict()["state"], o1.state_dict()["state"]
        assert sorted(sd) == sorted(sd1)
        for i in sd:
            assert float(sd[i]["step"]) == float(sd1[i]["step"]) == 1.0
            for n in ("exp_avg", "exp_avg_sq"):
                want = sd1[i][n].numpy()
                # GRAD_TOL's form: tp sums each gradient in another order
                np.testing.assert_allclose(
                    sd[i][n].numpy(), want, rtol=ADAM_RTOL,
                    atol=1e-4 * float(np.abs(want).max()),
                    err_msg=f"{i}/{n}")
        _, _, want_one = step1(q1, o1, *b2)
        _, _, got_one = step1(tree, opt, *b2)
    np.testing.assert_allclose(float(got_one), float(want_one),
                               rtol=LOSS_RTOL)

    tree2, opt2 = mgr.restore()
    r, ro, resumed = step(tree2, opt2, *b2)
    _, _, uninterrupted = step(p, o, *b2)
    free_tp(mesh, p, o, r, ro)
    np.testing.assert_allclose(float(resumed), float(uninterrupted),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(resumed), float(got_one),
                               rtol=LOSS_RTOL)


def test_multi_rank_params_save_whole(meshes, weights, tmp_path):
    """``save_params`` of a pp=2 slice writes the gathered tree, which
    ``load_params`` restores at the config's shapes."""
    cfg = weights[0]
    mesh = meshes["pp2"]
    p = pipe.distribute_pipeline_params(_params(weights), cfg, mesh)
    save_params(str(tmp_path), p, cfg, "llama-test")
    gathered = pipe.gather_pipeline_params(p, cfg)
    free_tp(mesh, p)
    tree, meta = load_params(str(tmp_path), cfg, "llama-test", device="cpu")
    assert meta["model"] == "llama-test"
    got = _leaves(tree)
    for name, want in gathered.items():
        assert torch.equal(got[name], want), name
    for name, want in _leaves(_params(weights)).items():
        assert torch.equal(got[name], want), name


@pytest.mark.parametrize("which", ["pp2", "tp2"])
def test_multi_rank_pair_equals_reference_step(which, meshes, weights,
                                               devices, tmp_path):
    """The saved global pair against the reference's train step on the
    same mesh shape, weights and batch (optax's ``adam(1e-2)``): restored
    on one rank, every parameter leaf equals the reference's updated
    parameter, Adam's moments equal its ``mu`` and ``nu`` (the gradient's
    tolerance, scaled), and the next step from the restored pair gives
    the loss of the reference's next step."""
    cfg, _, rcfg, rp = weights
    mesh = meshes[which]
    b1, b2 = _batch(cfg.vocab_size, 6), _batch(cfg.vocab_size, 7)
    rmesh = make_mesh(RefMesh(**{which[:2]: 2}), devices[:2])
    opt = optax.adam(1e-2)
    ref_step = ref_pipe.make_pipeline_train_step(rcfg, rmesh, opt, 2)
    with rmesh:
        # the step donates its arguments: hand it copies
        rp0 = jax.tree.map(jnp.array, rp)
        rp1, rs1, _ = ref_step(rp0, opt.init(rp0),
                               *(jnp.asarray(t.numpy(), jnp.int32)
                                 for t in b1))
        adam = jax.tree.map(np.asarray, rs1[0])
        rp1 = jax.tree.map(np.asarray, rp1)
        _, _, ref_next = ref_step(jax.tree.map(jnp.asarray, rp1),
                                  jax.tree.map(jnp.asarray, rs1),
                                  *(jnp.asarray(t.numpy(), jnp.int32)
                                    for t in b2))

    step = pipe.make_pipeline_train_step(cfg, mesh, ADAM, 2)
    p, o, _ = step(_params(weights), None, *b1)
    mgr = TrainCheckpointManager(str(tmp_path), cfg, ADAM, device="cpu")
    mgr.save(1, p, o)
    free_tp(mesh, p, o)
    tree, state = mgr.restore()

    names = [(part, key) for part, key, _ in pipe.trainable_leaves(tree)]
    got = _leaves(tree)
    for part, key in names:
        np.testing.assert_allclose(
            got[(part, key)].numpy(), getattr(rp1, part)[key],
            rtol=ADAM_RTOL, atol=1e-6, err_msg=f"{part}/{key}")
    sd = state.state_dict()["state"]
    assert sorted(sd) == list(range(len(names)))
    for i, (part, key) in enumerate(names):
        assert float(sd[i]["step"]) == float(adam.count) == 1.0
        for n, moment in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
            want = getattr(moment, part)[key]
            np.testing.assert_allclose(
                sd[i][n].numpy(), want, rtol=GRAD_TOL["rtol"],
                atol=1e-4 * float(np.abs(want).max()),
                err_msg=f"{part}/{key}/{n}")
    with local_mesh(MeshConfig(), "cpu") as one:
        step1 = pipe.make_pipeline_train_step(cfg, one, ADAM, 2)
        _, _, got_next = step1(tree, state, *b2)
    np.testing.assert_allclose(float(got_next), float(ref_next),
                               rtol=LOSS_RTOL)
