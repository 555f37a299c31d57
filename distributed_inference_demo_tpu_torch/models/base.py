"""Core model abstractions: configs, KV cache, pipeline-stage parameter slices.

Counterpart of ``distributed_inference_demo_tpu/models/base.py``.  A model
is a function over a parameter tree whose per-layer weights are *stacked*
along a leading ``layer`` axis; a pipeline stage is a slice of that axis.

The KV cache keeps the reference's head-major layout
``[layers, batch, kv_heads, max_seq, head_dim]``: each kv head's cache is
a contiguous ``[seq, hd]`` plane, which is what the CUDA flash kernel
streams tile by tile.  PyTorch tensors are mutable, so the cache is
written in place (``ops.attention.update_kv_cache``) and its valid length
is a plain Python int, or a 0-d device tensor in the engine's fixed-shape
decode state, which a CUDA graph replays.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Union

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


@dataclass(frozen=True)
class ModelConfig:
    """Static, hashable architecture description shared by all families.

    ``family`` selects the block flavour ("llama", "qwen2", "gemma",
    "bloom", "mixtral"); the feature flags let one decoder cover them.
    """

    family: str = "llama"
    vocab_size: int = 32000
    hidden_size: int = 2048
    num_layers: int = 22
    num_heads: int = 32
    num_kv_heads: int = 4
    intermediate_size: int = 5632
    max_seq_len: int = 2048
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype_name: str = "bfloat16"
    tie_embeddings: bool = False
    # bloom-style ALiBi positional bias vs llama-style RoPE
    use_alibi: bool = False
    use_rope: bool = True
    # bloom uses LayerNorm (with bias); llama uses RMSNorm
    attn_layernorm: bool = False
    # qwen2-style: q/k/v projections carry biases
    attn_qkv_bias: bool = False
    # gemma: head_dim decoupled from hidden/heads (0 = derive), embedding
    # scaled by sqrt(hidden), and a non-silu gated-MLP activation
    head_dim_override: int = 0
    embed_scale: bool = False
    mlp_act: str = "silu"      # "silu" | "gelu_tanh" (gemma)
    # MoE (mixtral): 0 experts means dense MLP
    num_experts: int = 0
    experts_per_token: int = 2
    moe_capacity_factor: float = 2.0
    # weight-only quantization: "none" | "int8" | "int4"
    quantization: str = "none"

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype_name]

    @property
    def head_dim(self) -> int:
        return self.head_dim_override or self.hidden_size // self.num_heads

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class StageSpec:
    """A contiguous layer range assigned to one pipeline stage: the first
    stage owns the embedding, the last owns the final norm + LM head."""

    stage_id: int
    num_stages: int
    layer_start: int
    layer_end: int  # exclusive

    @property
    def is_first(self) -> bool:
        return self.stage_id == 0

    @property
    def is_last(self) -> bool:
        return self.stage_id == self.num_stages - 1

    @property
    def num_layers(self) -> int:
        return self.layer_end - self.layer_start


@dataclass
class KVCache:
    """Per-stage KV cache, stacked over the stage's layers.

    keys/values: ``[num_layers, batch, num_kv_heads, max_seq, head_dim]``
    (head-major).  ``length`` counts the filled positions (a Python int,
    or a 0-d int64 device tensor for the fixed-shape decode step).  Host
    writes past the buffer raise (``ops.attention.update_kv_cache``); the
    engine enforces the caller's ``max_seq`` before any write
    (``check_capacity``).
    """

    keys: torch.Tensor
    values: torch.Tensor
    length: Union[int, torch.Tensor] = 0

    @staticmethod
    def create(cfg: ModelConfig, num_layers: int, batch: int,
               max_seq: Optional[int] = None, dtype=None,
               device=None) -> "KVCache":
        # the requested capacity is a lower bound, padded like the
        # reference's so cache shapes match it (see pad_cache_capacity)
        max_seq = pad_cache_capacity(max_seq or cfg.max_seq_len)
        dtype = dtype or cfg.dtype
        shape = (num_layers, batch, cfg.num_kv_heads, max_seq, cfg.head_dim)
        return KVCache(
            keys=torch.zeros(shape, dtype=dtype, device=device),
            values=torch.zeros(shape, dtype=dtype, device=device),
            length=0)

    @property
    def max_seq(self) -> int:
        return self.keys.shape[3]


def pad_cache_capacity(n: int) -> int:
    """KV buffer capacity rounded up to a multiple of 8.

    The reference pads for the TPU's sublane granule; the CUDA kernel
    needs no such alignment, but the port keeps the rule so its cache
    shapes equal the reference's.  The extra slots sit beyond every valid
    length and stay masked."""
    return -(-n // 8) * 8


@dataclass
class StageParams:
    """Parameters owned by one pipeline stage.

    ``layers`` is a dict of stacked tensors with leading dim = the stage's
    layer count.  ``embed`` / ``final_norm`` / ``lm_head`` are present only
    on the stages that own them (first / last), else None.
    """

    layers: dict
    embed: Optional[dict] = None
    final_norm: Optional[dict] = None
    lm_head: Optional[dict] = None
    _layer_views: Optional[list] = field(default=None, repr=False,
                                         compare=False)

    def layer(self, i: int) -> dict:
        """Layer ``i``'s weights as views into the stacked tensors (built
        once, so a decode step does not re-slice every weight).  A
        quantized leaf (``ops.quant.QuantizedArray``/``QuantizedArray4``)
        indexes every leaf alike."""
        if self._layer_views is None:
            n = next(iter(self.layers.values())).shape[0]
            self._layer_views = [{k: v[j] for k, v in self.layers.items()}
                                 for j in range(n)]
        return self._layer_views[i]

    def nbytes(self) -> int:
        """Bytes of every leaf (a quantized leaf's codes and scales)."""
        return sum(t.nbytes
                   for part in (self.layers, self.embed, self.final_norm,
                                self.lm_head) if part for t in part.values())


def slice_stage(full: StageParams, cfg: ModelConfig,
                spec: StageSpec) -> StageParams:
    """Cut a full-model StageParams into the slice owned by ``spec``
    (views, no copy)."""
    layers = {k: v[spec.layer_start:spec.layer_end]
              for k, v in full.layers.items()}
    # tied embeddings: the last stage needs the token table for the LM head
    needs_embed = spec.is_first or (spec.is_last and cfg.tie_embeddings)
    return StageParams(
        layers=layers,
        embed=full.embed if needs_embed else None,
        final_norm=full.final_norm if spec.is_last else None,
        lm_head=full.lm_head if spec.is_last else None,
    )


def split_layer_ranges(num_layers: int, num_stages: int,
                       weights: Optional[list] = None) -> list:
    """Partition ``num_layers`` into ``num_stages`` contiguous ranges.

    With ``weights`` (per-layer cost), minimizes the most expensive stage
    by dynamic programming over cut points; otherwise an even split.
    Returns a list of StageSpec."""
    if num_stages > num_layers:
        raise ValueError(
            f"cannot split {num_layers} layers into {num_stages} stages")
    if weights is None:
        weights = [1.0] * num_layers
    if len(weights) != num_layers:
        raise ValueError("weights must have one entry per layer")

    prefix = [0.0]
    for w in weights:
        prefix.append(prefix[-1] + float(w))

    def cost(i, j):  # cost of layers [i, j)
        return prefix[j] - prefix[i]

    INF = float("inf")
    # best[s][j] = minimal max-stage-cost splitting layers [0, j) into s
    # stages of >= 1 layer each; cut[s][j] = the last cut position.
    best = [[INF] * (num_layers + 1) for _ in range(num_stages + 1)]
    cut = [[0] * (num_layers + 1) for _ in range(num_stages + 1)]
    best[0][0] = 0.0
    for s in range(1, num_stages + 1):
        for j in range(s, num_layers + 1):
            for i in range(s - 1, j):
                c = max(best[s - 1][i], cost(i, j))
                if c < best[s][j]:
                    best[s][j] = c
                    cut[s][j] = i
    bounds = [num_layers]
    j = num_layers
    for s in range(num_stages, 0, -1):
        j = cut[s][j]
        bounds.append(j)
    bounds.reverse()

    specs = [StageSpec(stage_id=s, num_stages=num_stages,
                       layer_start=bounds[s], layer_end=bounds[s + 1])
             for s in range(num_stages)]
    assert all(sp.num_layers >= 1 for sp in specs)
    return specs
