"""The port's vision tower (``models/vision.py``), its bridge and its
CLIP / LLaVA loader against the JAX package's.

The same weights (the reference's ``init_vision_params``, carried across
with ``vision_params_from_numpy``) and the same seeded images go through
both ``vision_forward``s in f32 on the CPU, rtol/atol 2e-4: the
``clip-test`` tower (class token, pre-layernorm, quick_gelu) with either
``feature_layer``, and a plain gelu tower.  The loader reads a random HF
``CLIPVisionModel`` plus LLaVA's ``multi_modal_projector`` names from a
safetensors directory, as the reference's does; nothing is downloaded.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_inference_demo_tpu.models import vision as ref_vision
from distributed_inference_demo_tpu.models.loader import \
    load_vision_params as ref_load_vision_params
from distributed_inference_demo_tpu_torch import cli
from distributed_inference_demo_tpu_torch.comm.wire import Bf16Bits
from distributed_inference_demo_tpu_torch.models import vision
from distributed_inference_demo_tpu_torch.models.bridge import \
    vision_params_from_numpy
from distributed_inference_demo_tpu_torch.models.loader import (
    load_vision_params, vision_params_from_clip_state_dict)

TOL = dict(rtol=2e-4, atol=2e-4)
DECODER_HIDDEN = 64
CLIP_TEST = dict(image_size=28, patch_size=14, hidden_size=32, num_layers=3,
                 num_heads=4, intermediate_size=64, clip_arch=True,
                 hidden_act="quick_gelu")
TOWERS = {
    "clip-test": dict(CLIP_TEST, feature_layer=-2),
    "clip-test-full": dict(CLIP_TEST, feature_layer=-1),
    "plain-gelu": dict(image_size=32, patch_size=16, hidden_size=32,
                       num_layers=2, num_heads=2, intermediate_size=64),
}


def _numpy_tree(tree) -> dict:
    return jax.tree.map(np.asarray, tree)


def _pair(kw: dict, seed: int = 1):
    """(ref cfg, ref params, port cfg, port params) on the reference's
    weights."""
    rcfg = ref_vision.VisionConfig(**kw)
    rp = ref_vision.init_vision_params(jax.random.PRNGKey(seed), rcfg,
                                       DECODER_HIDDEN)
    return (rcfg, rp, vision.VisionConfig(**kw),
            vision_params_from_numpy(_numpy_tree(rp), "cpu"))


def _images(vcfg, b=2, seed=0):
    return np.random.RandomState(seed).randn(
        b, vcfg.image_size, vcfg.image_size, vcfg.channels).astype(np.float32)


@pytest.mark.parametrize("tower", sorted(TOWERS))
def test_vision_forward_matches_reference(tower):
    rcfg, rp, pcfg, pp = _pair(TOWERS[tower])
    img = _images(rcfg)
    want = np.asarray(ref_vision.vision_forward(rp, rcfg, jnp.asarray(img)))
    got = vision.vision_forward(pp, pcfg, torch.from_numpy(img))
    assert got.shape == (2, pcfg.num_patches, DECODER_HIDDEN)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_patchify_is_row_major():
    rcfg, _, pcfg, _ = _pair(TOWERS["plain-gelu"])
    img = _images(rcfg, b=1)
    want = np.asarray(ref_vision._patchify(jnp.asarray(img), rcfg))
    got = vision._patchify(torch.from_numpy(img), pcfg).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw,match", [
    (dict(hidden_act="relu"), "unknown hidden_act"),
    (dict(feature_layer=0), "feature_layer must be"),
    (dict(feature_layer=-2, num_layers=1), "needs >= 2"),
])
def test_config_checks_match_reference(kw, match):
    with pytest.raises(ValueError, match=match) as mine:
        vision.VisionConfig(**kw)
    with pytest.raises(ValueError) as theirs:
        ref_vision.VisionConfig(**kw)
    assert str(mine.value) == str(theirs.value)


def test_config_geometry_and_init_shapes_match_reference():
    for preset in ("small", "llava15", "clip-test"):
        pcfg = cli.vision_config(preset)
        assert pcfg.num_positions == pcfg.num_patches + pcfg.clip_arch
    kw = TOWERS["clip-test"]
    rcfg, rp, pcfg, _ = _pair(kw)
    mine = vision.init_vision_params(torch.Generator().manual_seed(1), pcfg,
                                     DECODER_HIDDEN, "cpu")
    theirs = _numpy_tree(rp)
    assert sorted(mine) == sorted(theirs)
    assert sorted(mine["layers"]) == sorted(theirs["layers"])
    for k, v in mine.items():
        pairs = (v.items() if isinstance(v, dict) else [(k, v)])
        ref = theirs[k]
        for n, t in pairs:
            r = ref[n] if isinstance(v, dict) else ref
            assert tuple(t.shape) == r.shape and t.dtype == torch.float32
    assert pcfg.num_patches == rcfg.num_patches == 4


def test_bridge_carries_bf16_bits():
    """A bfloat16 tower crosses the bridge bit for bit, and the bf16
    forward agrees with the reference's within bf16 noise."""
    import ml_dtypes
    kw = dict(TOWERS["clip-test"], dtype_name="bfloat16")
    rcfg, rp, pcfg, pp = _pair(kw)
    tree = _numpy_tree(rp)
    assert tree["patch_embed"].dtype == ml_dtypes.bfloat16
    for k, v in pp.items():
        if isinstance(v, dict):
            for n, t in v.items():
                assert t.dtype == torch.bfloat16
                np.testing.assert_array_equal(
                    t.view(torch.uint16).numpy(),
                    tree[k][n].view(np.uint16))
        else:
            np.testing.assert_array_equal(v.view(torch.uint16).numpy(),
                                          tree[k].view(np.uint16))
    # the wire's marked bits travel too
    bits = dict(tree, patch_embed=tree["patch_embed"].view(
        np.uint16).view(Bf16Bits))
    again = vision_params_from_numpy(bits, "cpu")
    assert torch.equal(again["patch_embed"], pp["patch_embed"])
    img = _images(rcfg)
    want = np.asarray(ref_vision.vision_forward(
        rp, rcfg, jnp.asarray(img))).astype(np.float32)
    got = vision.vision_forward(pp, pcfg, torch.from_numpy(img)).float()
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-2, atol=5e-2)


# ---------------------------------------------------------------------------
# the CLIP / LLaVA loader

def _clip_state_dict(rs) -> dict:
    """HF ``CLIPVisionModel`` names and shapes of the clip-test tower,
    random values, without importing transformers."""
    H, I, p = 32, 64, 14
    sd = {"embeddings.class_embedding": (H,),
          "embeddings.patch_embedding.weight": (H, 3, p, p),
          "embeddings.position_embedding.weight": (5, H),
          "pre_layrnorm.weight": (H,), "pre_layrnorm.bias": (H,),
          "post_layernorm.weight": (H,), "post_layernorm.bias": (H,)}
    for i in range(3):
        for name, shape in (
                ("layer_norm1", (H,)), ("layer_norm2", (H,)),
                ("self_attn.q_proj", (H, H)), ("self_attn.k_proj", (H, H)),
                ("self_attn.v_proj", (H, H)), ("self_attn.out_proj", (H, H)),
                ("mlp.fc1", (I, H)), ("mlp.fc2", (H, I))):
            sd[f"encoder.layers.{i}.{name}.weight"] = shape
            sd[f"encoder.layers.{i}.{name}.bias"] = shape[:1]
    return {"vision_model." + k: (rs.randn(*shape) * 0.1).astype(np.float32)
            for k, shape in sd.items()}


def _clip_checkpoint(tmp_path, with_projector: bool = True,
                     hf: bool = False):
    """A random CLIP tower of the clip-test geometry under LLaVA's
    ``vision_tower.`` prefix (``hf``: a transformers ``CLIPVisionModel``'s
    own state dict), plus LLaVA's projector names, saved as two
    safetensors shards (the second also holds a language-model tensor
    the loader must not read)."""
    from safetensors.numpy import save_file
    rs = np.random.RandomState(3)
    if hf:
        import transformers
        torch.manual_seed(0)
        hf_cfg = transformers.CLIPVisionConfig(
            image_size=28, patch_size=14, hidden_size=32,
            num_hidden_layers=3, num_attention_heads=4, intermediate_size=64,
            hidden_act="quick_gelu", layer_norm_eps=1e-5)
        model = transformers.CLIPVisionModel(hf_cfg).float().eval()
        sd = {k: v.detach().numpy().copy()
              for k, v in model.state_dict().items()}
    else:
        sd = _clip_state_dict(rs)
    sd = {"vision_tower." + k: v for k, v in sd.items()
          if not k.endswith("position_ids")}
    extra = {"language_model.model.embed_tokens.weight":
             rs.randn(8, DECODER_HIDDEN).astype(np.float32)}
    if with_projector:
        extra.update({
            "multi_modal_projector.linear_1.weight":
                rs.randn(DECODER_HIDDEN, 32).astype(np.float32) * 0.1,
            "multi_modal_projector.linear_1.bias":
                rs.randn(DECODER_HIDDEN).astype(np.float32) * 0.1,
            "multi_modal_projector.linear_2.weight":
                rs.randn(DECODER_HIDDEN, DECODER_HIDDEN).astype(np.float32)
                * 0.1,
            "multi_modal_projector.linear_2.bias":
                rs.randn(DECODER_HIDDEN).astype(np.float32) * 0.1})
    keys = sorted(sd)
    half = len(keys) // 2
    save_file({k: sd[k] for k in keys[:half]},
              str(tmp_path / "model-00001.safetensors"))
    save_file({**{k: sd[k] for k in keys[half:]}, **extra},
              str(tmp_path / "model-00002.safetensors"))
    return sd, extra


def test_load_vision_params_matches_reference_loader(tmp_path):
    _clip_checkpoint(tmp_path, hf=True)
    rcfg = ref_vision.VisionConfig(**TOWERS["clip-test"])
    pcfg = vision.VisionConfig(**TOWERS["clip-test"])
    theirs = _numpy_tree(ref_load_vision_params(str(tmp_path), rcfg,
                                                DECODER_HIDDEN))
    mine = load_vision_params(str(tmp_path), pcfg, DECODER_HIDDEN,
                              device="cpu")
    assert sorted(mine) == sorted(theirs)
    for k, v in mine.items():
        if isinstance(v, dict):
            for n, t in v.items():
                np.testing.assert_array_equal(t.numpy(), theirs[k][n])
        else:
            np.testing.assert_array_equal(v.numpy(), theirs[k])
    img = _images(rcfg)
    want = np.asarray(ref_vision.vision_forward(
        ref_load_vision_params(str(tmp_path), rcfg, DECODER_HIDDEN), rcfg,
        jnp.asarray(img)))
    got = vision.vision_forward(mine, pcfg, torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_loader_without_projector_keeps_the_seeded_one(tmp_path):
    sd, _ = _clip_checkpoint(tmp_path, with_projector=False)
    pcfg = vision.VisionConfig(**TOWERS["clip-test"])
    got = load_vision_params(str(tmp_path), pcfg, DECODER_HIDDEN, seed=5,
                             device="cpu")
    seeded = vision.init_vision_params(torch.Generator().manual_seed(5),
                                       pcfg, DECODER_HIDDEN, "cpu")
    for k in ("proj_w1", "proj_b1", "proj_w2", "proj_b2"):
        assert torch.equal(got[k], seeded[k])
    np.testing.assert_array_equal(
        got["pos_embed"].numpy(),
        sd["vision_tower.vision_model.embeddings.position_embedding.weight"])


def test_loader_refusals_match_reference(tmp_path):
    from distributed_inference_demo_tpu.models.loader import \
        vision_params_from_clip_state_dict as ref_from_sd
    sd, extra = _clip_checkpoint(tmp_path)
    raw = {**sd, **extra}
    plain = dict(TOWERS["clip-test"], clip_arch=False)
    wrong_size = dict(TOWERS["clip-test"], image_size=42)
    for kw, hidden in ((plain, DECODER_HIDDEN), (wrong_size, DECODER_HIDDEN),
                       (TOWERS["clip-test"], 16)):
        with pytest.raises(ValueError) as mine:
            vision_params_from_clip_state_dict(
                raw, vision.VisionConfig(**kw), hidden, device="cpu")
        with pytest.raises(ValueError) as theirs:
            ref_from_sd(raw, ref_vision.VisionConfig(**kw), hidden)
        assert str(mine.value) == str(theirs.value)
