"""The torch port's ``checkpoint.py`` against the JAX package's.

Parameter trees (the reference's init, carried across by
``models/bridge.py``, float and quantized) round-trip bit for bit
through the port's safetensors; the ``framework_meta.json`` sidecar
holds the reference's keys and values for the same config; the
identity and quantization refusals give the reference's texts;
``TrainCheckpointManager`` keeps the newest ``max_to_keep`` steps and
resumes a crashed run (float and int8) bit for bit, its AdamW state
included; ``load_or_init`` reads the port's checkpoint and still
refuses the reference's orbax directory.
"""

import functools
import json
import os

import jax
import numpy as np
import optax
import pytest
import torch

from distributed_inference_demo_tpu import checkpoint as ref_ckpt
from distributed_inference_demo_tpu.models import \
    get_model_config as ref_get_model_config
from distributed_inference_demo_tpu.models.decoder import \
    init_full_params as ref_init_full_params
from distributed_inference_demo_tpu.ops import quant as ref_quant
from distributed_inference_demo_tpu_torch import checkpoint as ckpt
from distributed_inference_demo_tpu_torch.models import get_model_config
from distributed_inference_demo_tpu_torch.models.bridge import \
    params_from_numpy
from distributed_inference_demo_tpu_torch.models.loader import load_or_init
from distributed_inference_demo_tpu_torch.parallel import pipeline as pipe
from distributed_inference_demo_tpu_torch.parallel.mesh import (MeshConfig,
                                                                local_mesh)

ADAMW = functools.partial(torch.optim.AdamW, lr=1e-3, weight_decay=1e-4)


def _leaf(v):
    if isinstance(v, ref_quant.QuantizedArray4):
        return {"q": np.asarray(v.q), "scale": np.asarray(v.scale),
                "group": v.group}
    if isinstance(v, ref_quant.QuantizedArray):
        return {"q": np.asarray(v.q), "scale": np.asarray(v.scale)}
    return np.asarray(v)


def _weights(name):
    rcfg = ref_get_model_config(name)
    rp = ref_quant.maybe_quantize(
        ref_init_full_params(jax.random.PRNGKey(0), rcfg), rcfg)
    tree = {k: None if v is None else {n: _leaf(a) for n, a in v.items()}
            for k, v in dict(layers=rp.layers, embed=rp.embed,
                             final_norm=rp.final_norm,
                             lm_head=rp.lm_head).items()}
    cfg = get_model_config(name)
    return rcfg, rp, cfg, params_from_numpy(tree, cfg, "cpu")


def _bits(t):
    return t.detach().contiguous().reshape(-1).view(torch.uint8)


def _tree_equal(a, b):
    fa, ga = ckpt._flatten(a)
    fb, gb = ckpt._flatten(b)
    assert fa.keys() == fb.keys() and ga == gb
    for k, x in fa.items():
        assert x.dtype == fb[k].dtype and x.shape == fb[k].shape, k
        assert torch.equal(_bits(x), _bits(fb[k])), k


def _state_equal(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    assert sa["state"].keys() == sb["state"].keys()
    for i, st in sa["state"].items():
        assert st.keys() == sb["state"][i].keys()
        for n, x in st.items():
            assert torch.equal(_bits(x), _bits(sb["state"][i][n])), (i, n)


@pytest.mark.parametrize("model", ["llama-test", "llama-test-int8",
                                   "llama-test-int4"])
def test_params_roundtrip(tmp_path, model):
    """The reference's tree, float or quantized (codes, scales, int4
    group), comes back bit for bit, on the port's skeleton; the sidecar
    equals the reference's for the same config, key for key."""
    rcfg, rp, cfg, params = _weights(model)
    path = str(tmp_path / "port")
    ckpt.save_params(path, params, cfg, model, metadata={"note": "r1"})
    got, meta = ckpt.load_params(path, cfg, model_name=model, device="cpu")
    _tree_equal(params, got)
    assert meta["metadata"]["note"] == "r1"
    ref_path = str(tmp_path / "ref")
    ref_ckpt.save_params(ref_path, rp, rcfg, model, metadata={"note": "r1"})
    with open(os.path.join(ref_path, "framework_meta.json")) as f:
        want = json.load(f)
    assert meta == want
    with open(os.path.join(path, "framework_meta.json")) as f:
        assert f.read() == open(os.path.join(
            ref_path, "framework_meta.json")).read()
    header = ckpt.read_safetensors(os.path.join(path, ckpt.PARAMS_FILE))
    if model.endswith("int4"):
        assert header["layers/wq/q"].dtype == torch.uint8
    elif not model.endswith("int8"):
        assert header["layers/wq"].dtype == params.layers["wq"].dtype


def test_bf16_leaves_stored_as_bf16(tmp_path):
    cfg = get_model_config("llama-test").replace(dtype_name="bfloat16")
    params = load_or_init("llama-test", cfg, seed=3, device="cpu")
    ckpt.save_params(str(tmp_path), params, cfg, "llama-test")
    with open(tmp_path / ckpt.PARAMS_FILE, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
    assert header["layers/wq"]["dtype"] == "BF16"
    _tree_equal(params, ckpt.load_params(str(tmp_path), cfg,
                                         device="cpu")[0])


def _refusal_pair(tmp_path, save_model, load_cfg_name, model_name):
    rcfg, rp, cfg, params = _weights(save_model)
    ref_path, path = str(tmp_path / "ref"), str(tmp_path / "port")
    ref_ckpt.save_params(ref_path, rp, rcfg, save_model)
    ckpt.save_params(path, params, cfg, save_model)
    with pytest.raises(ValueError) as want:
        ref_ckpt.load_params(ref_path, ref_get_model_config(load_cfg_name),
                             model_name=model_name)
    with pytest.raises(ValueError) as got:
        ckpt.load_params(path, get_model_config(load_cfg_name),
                         model_name=model_name, device="cpu")
    assert (str(got.value).replace(path, "P")
            == str(want.value).replace(ref_path, "P"))
    return str(got.value)


def test_params_identity_validation(tmp_path):
    text = _refusal_pair(tmp_path, "llama-test", "bloom-test", "bloom-test")
    assert "not 'bloom-test'" in text


def test_quantization_mismatch_rejected(tmp_path):
    text = _refusal_pair(tmp_path, "llama-test", "llama-test-int8", None)
    assert "quantization" in text


def _adamw_steps(params, opt, cfg, n, seed=1):
    """``n`` AdamW steps of the one-rank pipeline on a fixed batch, from
    ``params`` and the optimizer ``opt`` (its state loaded)."""
    ids = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (4, 8)))
    targets = torch.roll(ids, -1, 1)
    targets[:, -1] = -100
    losses = []
    with local_mesh(MeshConfig(), "cpu") as mesh:
        step = pipe.make_pipeline_train_step(cfg, mesh, ADAMW, 2)
        for _ in range(n):
            params, opt, loss = step(params, opt, ids, targets)
            losses.append(float(loss))
    return params, opt, losses


def test_train_manager_versioning_and_resume(tmp_path):
    """Three saves with ``max_to_keep=2`` leave steps [2, 3]; a fresh
    manager resumes at step 3 with the params and the AdamW state bit
    for bit, and a step from the restored state equals a step from the
    live one."""
    cfg = get_model_config("llama-test")
    mgr = ckpt.TrainCheckpointManager(str(tmp_path / "train"), cfg, ADAMW,
                                      max_to_keep=2, device="cpu")
    step, params, opt = mgr.restore_or_init(seed=0)
    assert step == 0 and mgr.latest_step is None
    for s in (1, 2, 3):
        params, opt, _ = _adamw_steps(params, opt, cfg, 1, seed=s)
        mgr.save(s, params, opt)
    assert mgr.latest_step == 3
    assert mgr.all_steps() == [2, 3]           # max_to_keep pruned step 1
    assert sorted(os.listdir(tmp_path / "train")) == ["2", "3"]

    os.makedirs(tmp_path / "train" / ".tmp-4-1")     # a save cut short
    mgr2 = ckpt.TrainCheckpointManager(str(tmp_path / "train"), cfg, ADAMW,
                                       max_to_keep=2, device="cpu")
    step2, params2, opt2 = mgr2.restore_or_init()
    assert step2 == 3
    _tree_equal(params, params2)
    _state_equal(opt, opt2)
    a, oa, la = _adamw_steps(params, opt, cfg, 1, seed=9)
    b, ob, lb = _adamw_steps(params2, opt2, cfg, 1, seed=9)
    assert la == lb
    _tree_equal(a, b)
    _state_equal(oa, ob)
    mgr.close()
    mgr2.close()


def test_train_manager_int8_crash_resume(tmp_path):
    """int8 configs: a fresh init is the quantized tree, so a saved state
    restores against the quantized skeleton."""
    cfg = get_model_config("llama-test-int8")
    opt = functools.partial(torch.optim.SGD, lr=1e-2)
    mgr = ckpt.TrainCheckpointManager(str(tmp_path / "t8"), cfg, opt,
                                      device="cpu")
    step, params, opt_state = mgr.restore_or_init(seed=0)
    assert isinstance(params.layers["wq"], ckpt.QuantizedArray)
    mgr.save(1, params, opt_state)
    mgr2 = ckpt.TrainCheckpointManager(str(tmp_path / "t8"), cfg, opt,
                                       device="cpu")
    step2, params2, opt2 = mgr2.restore_or_init()
    assert step2 == 1
    _tree_equal(params, params2)
    _state_equal(opt_state, opt2)


def test_restore_empty_dir_raises(tmp_path):
    """An empty directory raises the reference's ``FileNotFoundError``."""
    rcfg, cfg = ref_get_model_config("llama-test"), \
        get_model_config("llama-test")
    ref_mgr = ref_ckpt.TrainCheckpointManager(str(tmp_path / "ref"), rcfg,
                                              optax.sgd(1e-2))
    with pytest.raises(FileNotFoundError) as want:
        ref_mgr.restore()
    ref_mgr.close()
    mgr = ckpt.TrainCheckpointManager(str(tmp_path / "port"), cfg,
                                      functools.partial(torch.optim.SGD,
                                                        lr=1e-2),
                                      device="cpu")
    with pytest.raises(FileNotFoundError) as got:
        mgr.restore()
    assert (str(got.value).replace(str(tmp_path / "port"), "D")
            == str(want.value).replace(str(tmp_path / "ref"), "D"))


def test_load_or_init_reads_port_checkpoint_refuses_orbax(tmp_path):
    """``load_or_init`` (the CLI's ``--checkpoint``) loads the port's own
    checkpoint as saved, and still refuses the reference's orbax
    directory, whose sidecar is the same file."""
    rcfg, rp, cfg, params = _weights("llama-test-int8")
    path = str(tmp_path / "port")
    ckpt.save_params(path, params, cfg, "llama-test-int8")
    _tree_equal(params, load_or_init("llama-test-int8", cfg, path,
                                     device="cpu"))
    with pytest.raises(ValueError, match="not 'llama-test'"):
        load_or_init("llama-test", cfg, path, device="cpu")
    ref_path = str(tmp_path / "ref")
    ref_ckpt.save_params(ref_path, rp, rcfg, "llama-test-int8")
    with pytest.raises(ValueError, match="orbax"):
        load_or_init("llama-test-int8", cfg, ref_path, device="cpu")
