"""The torch port's decoder against the JAX package's ``stage_forward``.

Both run the reference's random weights (carried across as numpy by
``params_from_numpy``) on the same token ids: prefill logits and one
KV-cached decode step agree to rtol/atol 2e-4 for every dense family.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from distributed_inference_demo_tpu.models import (
    KVCache as RefKVCache, StageSpec as RefStageSpec,
    get_model_config as ref_get_model_config)
from distributed_inference_demo_tpu.models.decoder import (
    init_full_params as ref_init_full_params,
    stage_forward as ref_stage_forward)
from distributed_inference_demo_tpu_torch.models import (
    KVCache, StageSpec, get_model_config)
from distributed_inference_demo_tpu_torch.models.base import (
    slice_stage, split_layer_ranges)
from distributed_inference_demo_tpu_torch.models.bridge import (
    params_from_numpy, tensor_from_numpy)
from distributed_inference_demo_tpu_torch.models.decoder import (
    init_full_params, stage_forward)
from distributed_inference_demo_tpu_torch.models.loader import load_or_init

TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Tiny shapes gain nothing from many intra-op threads; cap them so
    parallel test workers do not oversubscribe the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _numpy_tree(rp):
    return {k: None if v is None else {n: np.asarray(a) for n, a in v.items()}
            for k, v in dict(layers=rp.layers, embed=rp.embed,
                             final_norm=rp.final_norm,
                             lm_head=rp.lm_head).items()}


@pytest.mark.parametrize("model", ["llama-test", "qwen2-test", "gemma-test",
                                   "bloom-test"])
def test_prefill_and_decode_step_match_reference(model):
    rcfg = ref_get_model_config(model)
    rp = ref_init_full_params(jax.random.PRNGKey(3), rcfg)
    cfg = get_model_config(model)
    params = params_from_numpy(_numpy_tree(rp), cfg, "cpu")
    b, s, max_seq = 2, 11, 24
    rng = np.random.RandomState(4)
    ids = rng.randint(0, cfg.vocab_size, (b, s))
    nxt = rng.randint(0, cfg.vocab_size, (b, 1))

    rspec = RefStageSpec(0, 1, 0, rcfg.num_layers)
    rcache = RefKVCache.create(rcfg, rcfg.num_layers, b, max_seq)
    rl1, rcache = ref_stage_forward(rp, rcfg, rspec, jnp.asarray(ids),
                                    rcache,
                                    jnp.broadcast_to(jnp.arange(s), (b, s)))
    rl2, rcache = ref_stage_forward(rp, rcfg, rspec, jnp.asarray(nxt),
                                    rcache, jnp.full((b, 1), s),
                                    last_logits_only=True)

    spec = StageSpec(0, 1, 0, cfg.num_layers)
    cache = KVCache.create(cfg, cfg.num_layers, b, max_seq)
    assert cache.keys.shape == rcache.keys.shape    # padded capacity too
    l1, cache = stage_forward(params, cfg, spec, torch.from_numpy(ids),
                              cache, torch.arange(s).expand(b, s))
    l2, cache = stage_forward(params, cfg, spec, torch.from_numpy(nxt),
                              cache, torch.full((b, 1), s),
                              last_logits_only=True)
    np.testing.assert_allclose(l1.numpy(), np.asarray(rl1), **TOL)
    np.testing.assert_allclose(l2.numpy(), np.asarray(rl2), **TOL)
    assert cache.length == int(rcache.length) == s + 1
    np.testing.assert_allclose(cache.keys.numpy(), np.asarray(rcache.keys),
                               **TOL)


def test_pipeline_split_matches_full_forward():
    """Two stages over split_layer_ranges/slice_stage = one full stage."""
    cfg = get_model_config("llama-test")
    params = init_full_params(torch.Generator().manual_seed(0), cfg, "cpu")
    ids = torch.randint(0, cfg.vocab_size, (1, 5),
                        generator=torch.Generator().manual_seed(1))
    pos = torch.arange(5)[None]
    full, _ = stage_forward(params, cfg, StageSpec(0, 1, 0, cfg.num_layers),
                            ids, KVCache.create(cfg, cfg.num_layers, 1, 16),
                            pos)
    x = ids
    for spec in split_layer_ranges(cfg.num_layers, 2):
        x, _ = stage_forward(slice_stage(params, cfg, spec), cfg, spec, x,
                             KVCache.create(cfg, spec.num_layers, 1, 16), pos)
    torch.testing.assert_close(x, full, rtol=1e-5, atol=1e-5)
    assert split_layer_ranges(10, 3, [1] * 8 + [4, 4])[-1].num_layers == 1


@pytest.mark.parametrize("model", ["tinyllama-1.1b", "bloom560m",
                                   "gemma-2b", "qwen2.5-0.5b"])
def test_init_shapes_match_reference(model):
    """The port's init makes the reference's tree (names, shapes, dtype),
    checked on abstract shapes so nothing full-size is materialized."""
    rcfg = ref_get_model_config(model)
    rshapes = jax.eval_shape(lambda k: ref_init_full_params(k, rcfg),
                             jax.random.PRNGKey(0))
    cfg = get_model_config(model).replace(num_layers=1, vocab_size=64)
    params = init_full_params(torch.Generator().manual_seed(0), cfg, "cpu")
    for part in ("layers", "embed", "final_norm", "lm_head"):
        ref_part = getattr(rshapes, part)
        got = getattr(params, part)
        assert sorted(got) == sorted(ref_part), part
        for name, ref_leaf in ref_part.items():
            shape = tuple(ref_leaf.shape)
            if part == "layers":
                shape = (1,) + shape[1:]
            shape = tuple(64 if d == rcfg.vocab_size else d for d in shape)
            assert tuple(got[name].shape) == shape, (part, name)
            assert got[name].dtype == torch.bfloat16


def test_bridge_carries_bf16_bits_and_refuses_what_is_not_ported(tmp_path):
    x = np.array([1.0, -2.5, 3.140625, 1e-3], dtype=ml_dtypes.bfloat16)
    t = tensor_from_numpy(x, "cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  x.view(np.int16))
    (tmp_path / "framework_meta.json").write_text("{}")
    with pytest.raises(ValueError, match="orbax"):
        load_or_init("llama-test-int8", get_model_config("llama-test-int8"),
                     str(tmp_path), device="cpu")
    # mixtral (ported since) initializes with the reference's leaves
    moe = init_full_params(torch.Generator(), get_model_config(
        "mixtral-test"), "cpu")
    want = jax.eval_shape(lambda k: ref_init_full_params(
        k, ref_get_model_config("mixtral-test")), jax.random.PRNGKey(0))
    assert sorted(moe.layers) == sorted(want.layers)
    for name, leaf in want.layers.items():
        assert tuple(moe.layers[name].shape) == tuple(leaf.shape), name
