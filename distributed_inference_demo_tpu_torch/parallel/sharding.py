"""Sharding rules: which slice of every parameter a rank holds.

Counterpart of ``distributed_inference_demo_tpu/parallel/sharding.py``.
A spec is a tuple of mesh-axis names, one per tensor axis (None =
replicated along that axis; ``()`` = replicated), the reference's
``PartitionSpec`` as a tuple.  :func:`shard_params` cuts a full tree
into one rank's slice by its coordinates; the engines' path
(``runtime/engine.shard_engine_params``) sends each follower its slice.

Megatron-style TP layout (the reference's):
- wq/wk/wv  [L, H, heads*hd]   -> last axis over tp (column parallel)
- wo        [L, heads*hd, H]   -> first non-L axis over tp (row parallel)
- w_gate/up [L, H, I]          -> column parallel
- w_down    [L, I, H]          -> row parallel
- MoE experts [L, E, H, I]     -> E over tp (expert parallelism)
- embed [V, H] / lm_head [H, V]-> V over tp (vocab parallel); logits
                                  all-gather only at the sampling boundary
"""

from typing import Optional

import numpy as np

from ..models.base import ModelConfig, StageParams
from ..ops.quant import QuantizedArray, QuantizedArray4

P = tuple      # a spec, the reference's PartitionSpec

_LAYER_SPECS = {
    "attn_norm_w": (),
    "attn_norm_b": (),
    "mlp_norm_w": (),
    "mlp_norm_b": (),
    "wq": (None, None, "tp"),
    "wk": (None, None, "tp"),
    "wv": (None, None, "tp"),
    "bq": (None, "tp"),
    "bk": (None, "tp"),
    "bv": (None, "tp"),
    "wo": (None, "tp", None),
    "bo": (),
    "w_gate": (None, None, "tp"),
    "w_up": (None, None, "tp"),
    "b_up": (None, "tp"),
    "w_down": (None, "tp", None),
    "b_down": (),
    "router": (),
}

# MoE expert stacks carry an extra E axis at position 1: shard experts.
_MOE_SPECS = {
    "w_gate": (None, "tp", None, None),
    "w_up": (None, "tp", None, None),
    "w_down": (None, "tp", None, None),
}


def layer_spec(key: str, cfg: ModelConfig, pp_shard: bool = False) -> P:
    """Spec for one stacked-layer weight.  ``pp_shard`` additionally
    splits the leading layer axis over pp (SPMD pipeline layout)."""
    if cfg.num_experts > 0 and key in _MOE_SPECS:
        spec = _MOE_SPECS[key]
    else:
        spec = _LAYER_SPECS.get(key, ())
    if pp_shard:
        spec = ("pp", *spec[1:]) if len(spec) > 0 else ("pp",)
    return spec


def _embed_specs(cfg: ModelConfig) -> dict:
    # vocab-parallel embedding: the gather masks out-of-shard ids and psums.
    specs = {"tokens": ("tp", None)}
    if cfg.family == "bloom":
        specs["norm_w"] = ()
        specs["norm_b"] = ()
    return specs


def quant4_specs(v: QuantizedArray4, spec: P):
    """Spec tree for a packed-int4 weight given its dense spec.

    Nibble packing only changes SIZES along the input axis, so ``q``
    inherits the dense spec unchanged; the group-wise scale inserts a
    broadcast axis before the output axis (shape ``(..., in/g, 1,
    out)``) and its group axis stays replicated.  Slicing the input or
    output axes themselves (tp) would cut through nibble pairs and
    group boundaries — callers must reject tp before calling."""
    if any(s == "tp" for s in spec):
        raise ValueError(
            "int4 (nibble-packed) weights do not compose with tp meshes "
            "yet — tensor-parallel slicing would cut through the packed "
            "input axis; use int8 for tensor-parallel serving")
    scale = (*spec[:-2], None, None, spec[-1]) if len(spec) >= 2 else ()
    return QuantizedArray4(q=spec, scale=scale, group=v.group)


def quant_scale_spec(q_spec: P) -> P:
    """Scale spec matching the stacked quantization layout.

    The scale's shape is ``[L, 1, ..., out]``: only the leading layer
    axis and the final output axis are real, so only those can inherit
    the q array's sharding.  A row slice (``wo``, ``w_down``) keeps its
    per-output-column scale whole, so each rank's partial sum is exact
    before the all-reduce."""
    if len(q_spec) == 0:
        return ()
    if len(q_spec) == 1:
        return (q_spec[0],)
    return (q_spec[0], *([None] * (len(q_spec) - 2)), q_spec[-1])


def stage_param_spec_tree(params: StageParams, cfg: ModelConfig, *,
                          pp_shard: bool = False, use_tp: bool = True,
                          vocab_parallel_embed: bool = False) -> StageParams:
    """The spec tree of a params tree: quantized leaves get a spec of
    the same class (``QuantizedArray(q=spec, scale=spec)``).
    ``use_tp=False`` strips tp from layer specs; ``vocab_parallel_embed``
    shards the token table over tp, where the engines' path replicates
    it (the forward gathers by id locally)."""
    def strip_tp(spec):
        return tuple(s if s == "pp" else None for s in spec)

    def map_layers(layers):
        out = {}
        for k, v in layers.items():
            spec = layer_spec(k, cfg, pp_shard)
            if not use_tp:
                spec = strip_tp(spec)
            if isinstance(v, QuantizedArray):
                out[k] = QuantizedArray(q=spec, scale=quant_scale_spec(spec))
            elif isinstance(v, QuantizedArray4):
                out[k] = quant4_specs(v, spec)
            else:
                out[k] = spec
        return out

    embed = None
    if params.embed is not None:
        if vocab_parallel_embed and use_tp:
            embed = {k: s for k, s in _embed_specs(cfg).items()
                     if k in params.embed}
        else:
            embed = {k: () for k in params.embed}
    final_norm = None
    if params.final_norm is not None:
        final_norm = {k: () for k in params.final_norm}
    lm_head = None
    if params.lm_head is not None:
        lm_head = {k: ((None, "tp") if use_tp else ())
                   for k in params.lm_head}
    return StageParams(layers=map_layers(params.layers), embed=embed,
                       final_norm=final_norm, lm_head=lm_head)


def slice_leaf(x, spec: P, coords: dict, sizes: dict):
    """One rank's slice of a tensor or numpy array: every axis named in
    ``spec`` (with a size > 1) cut into equal parts, part
    ``coords[axis]`` kept."""
    for i, axis in enumerate(spec):
        n = sizes.get(axis, 1) if axis is not None else 1
        if n <= 1:
            continue
        if x.shape[i] % n:
            raise ValueError(f"axis {i} of {tuple(x.shape)} not divisible "
                             f"by {axis}={n}")
        step = x.shape[i] // n
        idx = [slice(None)] * x.ndim
        idx[i] = slice(coords[axis] * step, (coords[axis] + 1) * step)
        x = x[tuple(idx)]
    return x


def shard_tree(params: StageParams, specs: StageParams, coords: dict,
               sizes: dict, copy=None) -> StageParams:
    """Cut ``params`` by a spec tree of the same shape for the rank at
    ``coords``.  ``copy`` maps each slice (e.g. ``.contiguous()``); the
    slices are views otherwise."""
    copy = copy or (lambda x: x)

    def leaf(v, s):
        if isinstance(v, QuantizedArray):
            return QuantizedArray(
                q=copy(slice_leaf(v.q, s.q, coords, sizes)),
                scale=copy(slice_leaf(v.scale, s.scale, coords, sizes)))
        if isinstance(v, QuantizedArray4):
            return QuantizedArray4(
                q=copy(slice_leaf(v.q, s.q, coords, sizes)),
                scale=copy(slice_leaf(v.scale, s.scale, coords, sizes)),
                group=v.group)
        return copy(slice_leaf(v, s, coords, sizes))

    def part(p, s):
        if p is None:
            return None
        return {k: leaf(v, s[k]) for k, v in p.items()}

    return StageParams(layers=part(params.layers, specs.layers),
                       embed=part(params.embed, specs.embed),
                       final_norm=part(params.final_norm, specs.final_norm),
                       lm_head=part(params.lm_head, specs.lm_head))


def shard_params(params: StageParams, cfg: ModelConfig, mesh,
                 pp_shard: bool = False,
                 vocab_parallel_embed: bool = True,
                 rank: Optional[int] = None) -> StageParams:
    """One rank's slice of a full params tree (this mesh rank's, or
    ``rank``'s): the reference's placement, with the slices as views."""
    specs = stage_param_spec_tree(params, cfg, pp_shard=pp_shard,
                                  vocab_parallel_embed=vocab_parallel_embed)
    return shard_tree(params, specs, rank_coords(mesh.shape, rank
                                                 if rank is not None
                                                 else mesh.rank),
                      mesh.shape)


def rank_coords(shape: dict, rank: int) -> dict:
    """A rank's coordinates on a mesh of axis sizes ``shape`` (tp
    innermost, the reference's order)."""
    from .mesh import AXES
    dims = tuple(shape.get(a, 1) for a in AXES)
    return {a: int(c) for a, c in zip(AXES, np.unravel_index(rank, dims))}
