"""Vision encoder + projector: the LLaVA-style multimodal stage 0.

Counterpart of ``distributed_inference_demo_tpu/models/vision.py``, with
the same arithmetic:

- a ViT over stacked-layer weights (the decoder's layout): patchify is a
  reshape and one ``[p*p*c, H]`` product, learned position embeddings,
  pre-norm bidirectional attention blocks (a Python loop over the
  layers, as ``models/decoder.py`` runs its stack), a GELU or quick-GELU
  MLP;
- the 2-layer projector (LLaVA-1.5's mlp2x_gelu) into the decoder's
  hidden size.

``vision_forward`` returns ``[batch, num_patches, decoder_hidden]``, ready
to be prepended to the token embeddings and fed to a first decoder stage
as a pre-embedded prefix (``decoder.stage_forward`` takes float inputs).

As in the reference, every GELU is the tanh form (``jax.nn.gelu``'s
default), the attention scores are made in the input dtype and upcast,
and softmax runs in f32.  The tower's products and softmax are plain
``torch`` ops: the reference computes them outside any Pallas kernel.
"""

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops.norms import layer_norm
from .decoder import _dense_init


@dataclass(frozen=True)
class VisionConfig:
    """ViT architecture description (defaults: a small CLIP-style tower;
    LLaVA-1.5's is image 336 / patch 14 / hidden 1024 / 24 layers).

    ``clip_arch``: the CLIP-ViT geometry HF checkpoints ship: a learned
    class token prepended to the patches (position embeddings gain one
    row), a layernorm over the embeddings before the encoder
    (``pre_layrnorm``), and q/k/v/out projection biases.

    ``feature_layer``: which encoder output feeds the projector.  -1 =
    all layers and the final layernorm (the plain tower).  -2 = LLaVA-1.5
    feature select: stop one layer early, no final layernorm, and (under
    ``clip_arch``) drop the class token from the features.  The
    projector sees ``num_patches`` positions either way."""

    image_size: int = 64
    patch_size: int = 16
    channels: int = 3
    hidden_size: int = 128
    num_layers: int = 4
    num_heads: int = 4
    intermediate_size: int = 512
    norm_eps: float = 1e-5
    dtype_name: str = "float32"
    clip_arch: bool = False
    feature_layer: int = -1
    hidden_act: str = "gelu"   # "gelu" | "quick_gelu" (original CLIP)

    def __post_init__(self):
        if self.hidden_act not in ("gelu", "quick_gelu"):
            raise ValueError(f"unknown hidden_act {self.hidden_act!r}")
        if self.feature_layer not in (-1, -2):
            raise ValueError("feature_layer must be -1 (full tower) or "
                             "-2 (LLaVA-1.5 feature select)")
        if self.feature_layer == -2 and self.num_layers < 2:
            raise ValueError("feature_layer=-2 needs >= 2 encoder layers")

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype_name)

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def num_positions(self) -> int:
        """Rows of the position table (the class token adds one under
        ``clip_arch``)."""
        return self.num_patches + (1 if self.clip_arch else 0)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def init_vision_params(generator: torch.Generator, vcfg: VisionConfig,
                       decoder_hidden: int, device=None) -> dict:
    """Stacked-layer ViT weights and the mlp2x projector into the
    decoder's embedding space, drawn from ``generator`` (which lives on
    ``device``) with the reference's shapes and scale rules."""
    device = resolve_device(device)
    H, I, L = vcfg.hidden_size, vcfg.intermediate_size, vcfg.num_layers
    p, c = vcfg.patch_size, vcfg.channels
    dt = vcfg.dtype

    def dense(shape, scale=None):
        return _dense_init(generator, shape, dt, device, scale=scale)

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=device)

    layers = {
        "norm1_w": ones(L, H), "norm1_b": zeros(L, H),
        "wq": dense((L, H, H)), "wk": dense((L, H, H)),
        "wv": dense((L, H, H)), "wo": dense((L, H, H)),
        # projection biases: zeros in the plain tower, loaded from the
        # checkpoint under clip_arch
        "bq": zeros(L, H), "bk": zeros(L, H), "bv": zeros(L, H),
        "bo": zeros(L, H),
        "norm2_w": ones(L, H), "norm2_b": zeros(L, H),
        "w_up": dense((L, H, I)), "b_up": zeros(L, I),
        "w_down": dense((L, I, H)), "b_down": zeros(L, H),
    }
    out = {
        "patch_embed": dense((p * p * c, H)),
        "pos_embed": dense((vcfg.num_positions, H), scale=0.02),
        "layers": layers,
        "post_norm_w": ones(H), "post_norm_b": zeros(H),
        "proj_w1": dense((H, decoder_hidden)),
        "proj_b1": zeros(decoder_hidden),
        "proj_w2": dense((decoder_hidden, decoder_hidden)),
        "proj_b2": zeros(decoder_hidden),
    }
    if vcfg.clip_arch:
        out["cls_embed"] = dense((H,), scale=0.02)
        out["pre_norm_w"] = ones(H)
        out["pre_norm_b"] = zeros(H)
    return out


def _patchify(images: torch.Tensor, vcfg: VisionConfig) -> torch.Tensor:
    """[b, H, W, C] -> [b, num_patches, p*p*C] (row-major patch order)."""
    b = images.shape[0]
    p = vcfg.patch_size
    n = vcfg.image_size // p
    x = images.reshape(b, n, p, n, p, vcfg.channels)
    x = x.permute(0, 1, 3, 2, 4, 5)            # [b, n, n, p, p, c]
    return x.reshape(b, n * n, p * p * vcfg.channels)


def _encoder_layer(vcfg: VisionConfig, lp: dict, x: torch.Tensor,
                   li: int) -> torch.Tensor:
    """Encoder layer ``li`` of the stacked weights ``lp``."""
    b, s, _ = x.shape
    nh, hd = vcfg.num_heads, vcfg.head_dim
    h = layer_norm(x, lp["norm1_w"][li], lp["norm1_b"][li], vcfg.norm_eps)
    q = (h @ lp["wq"][li] + lp["bq"][li]).reshape(b, s, nh, hd)
    k = (h @ lp["wk"][li] + lp["bk"][li]).reshape(b, s, nh, hd)
    v = (h @ lp["wv"][li] + lp["bv"][li]).reshape(b, s, nh, hd)
    # bidirectional attention: no mask; scores in the input dtype, then
    # an f32 softmax
    scores = torch.einsum("bqnd,bknd->bnqk", q, k).float()
    scores = scores / float(np.sqrt(np.float32(hd)))
    a = torch.softmax(scores, dim=-1).to(x.dtype)
    o = torch.einsum("bnqk,bknd->bqnd", a, v).reshape(b, s, nh * hd)
    x = x + o @ lp["wo"][li] + lp["bo"][li]
    h = layer_norm(x, lp["norm2_w"][li], lp["norm2_b"][li], vcfg.norm_eps)
    h = (h @ lp["w_up"][li] + lp["b_up"][li]).float()
    # original CLIP towers ship quick_gelu (x * sigmoid(1.702 x)); the
    # others the tanh gelu, as the reference's jax.nn.gelu computes it
    h = (h * torch.sigmoid(1.702 * h) if vcfg.hidden_act == "quick_gelu"
         else F.gelu(h, approximate="tanh"))
    return x + (h.to(x.dtype) @ lp["w_down"][li] + lp["b_down"][li])


def vision_forward(params: dict, vcfg: VisionConfig,
                   images: torch.Tensor) -> torch.Tensor:
    """ViT + projector: [b, H, W, C] images -> [b, num_patches, decoder_H]
    in the tower's dtype, on the weights' device.

    Under ``clip_arch`` the class token is prepended before the encoder
    and dropped from the features.  ``feature_layer=-2`` skips the last
    encoder layer (its weights stay loaded but never run) and the final
    layernorm (LLaVA-1.5 reads HF's ``hidden_states[-2]``)."""
    dev = params["patch_embed"].device
    x = _patchify(images.to(dev, vcfg.dtype), vcfg)
    x = x @ params["patch_embed"]
    if vcfg.clip_arch:
        cls = params["cls_embed"].expand(x.shape[0], 1, vcfg.hidden_size)
        x = torch.cat([cls.to(x.dtype), x], dim=1)
    x = x + params["pos_embed"][None]
    if vcfg.clip_arch:
        x = layer_norm(x, params["pre_norm_w"], params["pre_norm_b"],
                       vcfg.norm_eps)
    run = vcfg.num_layers - (1 if vcfg.feature_layer == -2 else 0)
    for li in range(run):
        x = _encoder_layer(vcfg, params["layers"], x, li)
    if vcfg.feature_layer == -1:
        x = layer_norm(x, params["post_norm_w"], params["post_norm_b"],
                       vcfg.norm_eps)
    if vcfg.clip_arch:
        x = x[:, 1:]                   # drop the class token's feature
    h = F.gelu((x @ params["proj_w1"] + params["proj_b1"]).float(),
               approximate="tanh").to(x.dtype)
    return h @ params["proj_w2"] + params["proj_b2"]
